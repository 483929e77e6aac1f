"""Times the redesigned kernels at the shapes where ``chip_smoke.py``
reads them, for the port in any checkout, so that two commits are compared
on one card in one run: the dg kernels (#1 ``dg_rows_cuda``, #2
``dg1_rows_cuda``), the dgt kernels (#3 ``dgt_rows_cuda``, #4
``dgt_stream_rows_cuda``), the resident tile kernel (#5,
``tile_rows_cuda``), the span kernels (#7 ``span_rows_cuda``, #8
``span_stream_rows_cuda``), the radix
kernel (#9, ``radix_rows_cuda``), the stripe kernels (#10
``stripe_rows_cuda``, #11 ``stripe_nested_rows_cuda``), the N:M kernel
(#12, ``nm_rows_cuda``), the Block-ELL kernel (#13, ``bell_rows_cuda``)
and the SDDMM pair (#14 ``sddmm_rows_cuda``, #15 ``dx_rows_cuda``):

    python3 tpusparse_torch/bench/kernel_ab.py [--root DIR] [--only PREFIX]

``--root`` is the checkout whose ``tpusparse_torch`` is timed (default: the
one holding this file), for example an older commit unpacked with ``git
archive`` into an ignored directory; run it in turns (older, newer, newer,
older).  The timer is this checkout's ``harness.device_time_fn``, loaded by
path, so an older checkout that lacks it is timed the same way.  A
checkout whose dg, dg SpMV, dgt, dgt stream, span, span stream and radix
wrappers take a row walk gets the format's (built before the timing), one
whose stripe wrapper takes the live slots, whose Block-ELL wrapper takes
work items, whose SDDMM wrapper takes a tile index or whose transpose
apply takes a column index gets the format's;
an older one is called as it was.  ``--only`` keeps the shapes whose name
starts with one of its comma-separated prefixes ("#3", "#1,#4", "T1",
...); a prefix that ends in a digit does not take a longer number ("#1"
keeps "#1 ..." but not "#10 ...").

Shapes: config #1 (power-law 32768^2, alpha 1.8, seed 42) in the tile
format of rb 1024, ct 1024, g 512 at K = 8, 32 and 256 and of rb 1024, ct
512, g 256 at K = 8; ``SparseLinear.from_dense(k_hint=512)``'s format of
the 90 %-pruned 4096^2 weight (seed 3) at K = 512; config #1's
``stripe_nested`` format (work 4096, unroll 8) at K = 8 and 32.  #10:
config #1's ``stripe_total`` formats (merge path 2048 and 512) at K = 8
and 256 and its ``nnz_segment`` (2048) at K = 8; ``spmv_fn(mat,
"stripe")``'s format of the SpMV workload at the K its SpMV runs (one
column where the checkout's SpMV passes x as one, else 8) and that
whole SpMV call.  #12: P13's 2:4 4096^2 weight (seed 5) in bf16 at K =
128 and 512 and in fp32 at K = 128.  #13: P14's block-sparse 4096^2
weight (15 % of 128-blocks, seed 6) in bf16, fp32 and int8 at K = 256
(int8: X quantized per column as ``bell_int8`` does, and handed as that
checkout's ``bell_int8`` hands it), beside cuBLAS's dense product.  #3:
``spmv_fn(mat, "dgt8")``'s format of the SpMV workload (power-law
262144^2, avg 40, seed 9) at K = 1 and ``spmv_multi_fn(mat, 8)``'s at K =
8; config #1's ``dgt_span`` rb 512 nw 8 g 512 at K = 8.  #1: config #1's
``dg_span`` default at K = 8 (rb 1024 ns 8 g 512) and K = 64 (rb 512, kt
32) and the tune's rb 512 ns 8 g 512 row at K = 8.  #2: config #1's
default at K = 1 (rb 4096 ns 4 g 2048) and ``spmv_fn(mat, "auto")``'s
format of the SpMV workload.  #8 (``span_spmm(stream=True)``'s kernel):
config #1 in the tune's four span formats (``_span_configs``; the smoke's
P5 row is the one the tune found fastest) at K = 8, and the first
sub-format of the SpMV workload's K = 8 default (``span_colsplit``,
columns [0, 131072)).  #4 (``dgt_spmm(stream_x=True)``'s kernel): config
#1's ``dgt_span`` rb 512 nw 8 g 512 format at K = 8 and
``spmv_multi_fn(mat, 8)``'s at K = 8 and 64 (X of 64 MB, past the 50 MB
L2).  #9: the SpMV workload's ``radix_span`` default at K = 4 (P8),
``spmv_fn(mat, "radix")``'s format at K = 1 and ``brick_ell`` on the
banded 32768^2 (bandwidth 16, seed 3) at K = 8, and config #1's three
``radix_span`` tune formats at K = 8.  #7: the trainable layer's span
format of the pruned weight, (P, NC, G) = (8, 1639, 128), at K = 512; the
SpMV workload's default at K = 8 (``span_colsplit``, two launches).  #14
and #15 on that format at K = 512 (dY_slots and X random, both in fp32x2
and bf16; #15 on the masked value plane the layer hands it) beside
cuSPARSE (``sampled_addmm``; the SpMM of W^T) and, in fp32x2, cuBLAS's
dense fp32 product (dY . X^T; W^T . dY), TF32 off; #14 also with every
tile dense and with every slot on the per-slot path (where the checkout
has a tile index: the two paths' costs, which set the threshold); both
on config #1's span format (rb 512, ct 512, g 128) at K = 8 (#15 beside
cuSPARSE's SpMM of A^T).  Where the checkout's #15 takes a column index,
its bytes and first build time are printed.  T1: one training step of ``TrainableSparseLinear`` on that
weight, x [4, 128, 4096], Adam.  For each: the device time a call
(profiler, 20 calls: the wrapper's kernel and its zero fill), the
back-to-back time a call (``time_fn``, median of five, host included), the
largest error against the plain version relative to |A|·|X| and, for #1
to #4, #7 to #10, cuSPARSE's device and ``time_fn`` times for the same
product (``torch.sparse.mm`` on CSR), for #12 and #13 cuBLAS's dense
``torch.mm`` of the same weight (``torch._int_mm`` for int8).  A device
time the profiler cannot give (records dropped in every window) is a CUDA
graph's replay of 20 calls (``harness.graph_time_fn``, the shape listed
under ``graph_replay``), or null where the call cannot be captured, and
said.  Prints one JSON object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose tpusparse_torch is timed")
    ap.add_argument("--only", default="",
                    help="time only the shapes whose name starts so (comma-separated prefixes)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    spec = importlib.util.spec_from_file_location("kernel_ab_harness",
                                                  Path(__file__).with_name("harness.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from tpusparse_torch.format import pack_tile
    from tpusparse_torch.io import builder
    from tpusparse_torch.kernels import block_ell as be
    from tpusparse_torch.kernels import dg_gather as dg
    from tpusparse_torch.kernels import dgt_gather as dgt
    from tpusparse_torch.kernels import nm_structured as nm
    from tpusparse_torch.kernels import radix_gather as radix
    from tpusparse_torch.kernels import sddmm as sd
    from tpusparse_torch.kernels import span_gather as span
    from tpusparse_torch.kernels import stripe_gather as stripe
    from tpusparse_torch.kernels import tile_onehot as tile
    from tpusparse_torch.kernels.common import pad_dense_cols
    from tpusparse_torch.meta.set import create_init_metadata_set
    from tpusparse_torch.nn import TrainableSparseLinear
    from tpusparse_torch.schedule import Schedule, build_plan, default_schedule
    from tpusparse_torch.spmv import spmv_fn, spmv_multi_fn

    dev = torch.device("cuda", 0)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "power": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True).stdout.strip(), "shapes": {}}

    def record(name, kern, plain, scale, x, lib=None, lib_name="cuSPARSE"):
        got, want, den = kern(x), plain(x), scale([v.abs() for v in x] if isinstance(x, list)
                                                  else x.abs())
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want, den = [got], [want], [den]
        err = 0.0
        for g_, w_, d_ in zip(got, want, den):
            d_ = torch.maximum(d_.double(), torch.ones((), dtype=torch.float64, device=dev))
            err = max(err, float(((g_.double() - w_.double()).abs() / d_).max()))
        del got, want, den
        host = float(np.median([harness.time_fn(kern, x) for _ in range(5)])) * 1e3
        rec = {"device_ms": device_ms(name, kern, x), "time_fn_ms": host, "rel_err": err}
        if lib is not None:
            rec["library"] = lib_name
            rec["library_device_ms"] = device_ms(f"{name} {lib_name}", *lib)
            rec["library_time_fn_ms"] = harness.time_fn(*lib) * 1e3
        out["shapes"][name] = rec
        print(f"{name}: device {fmt_ms(rec['device_ms'])} ms a call, time_fn {host:.4f} ms, "
              f"rel err {err:.2e}"
              + (f", {lib_name} device {fmt_ms(rec['library_device_ms'])} ms, time_fn "
                 f"{rec['library_time_fn_ms']:.4f} ms" if lib else ""), flush=True)

    def device_ms(name, fn, x, tries=3):
        """The device time a call in ms: the profiler's, or where it dropped
        records in every window of ``tries`` readings, a CUDA graph's replay
        (``harness.graph_time_fn``; said in the output), or None where the
        call cannot be captured either."""
        for _ in range(tries):
            try:
                return harness.device_time_fn(fn, x) * 1e3
            except RuntimeError as e:
                err = e
        try:
            t = harness.graph_time_fn(fn, x) * 1e3
        except Exception as e:  # noqa: BLE001 - reported, time_fn stands
            print(f"{name}: {err}; no CUDA graph either ({type(e).__name__}: {e})", flush=True)
            return None
        print(f"{name}: {err}; CUDA graph replay {t:.4f} ms a call", flush=True)
        graph_read.add(name)
        return t

    graph_read = set()  # the shapes whose device time is a CUDA graph's replay

    def fmt_ms(v):
        return "n/a" if v is None else f"{v:.4f}"

    def wanted(name):
        # "#1" keeps "#1 ..." and not "#10 ...": a number is not cut short
        return any(name.startswith(p) and not (p[-1:].isdigit() and name[len(p):][:1].isdigit())
                   for p in args.only.split(","))

    def rand_x(n, k, kt):
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((n, k)),
                            dtype=torch.float32, device=dev)
        return pad_dense_cols(x, -(-k // kt) * kt).contiguous()

    def tile_shape(name, fmt, k):
        kt = tile.choose_kt(min(tile.default_ktile(k), 32))
        kw = dict(rb=fmt.rb, ct=fmt.ct, kt=kt, mode="fp32x2")
        args = (fmt.chunk_tile, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        record(name, lambda v: tile.tile_rows_cuda(*args, v, **kw),
               lambda v: tile.tile_rows_plain(*args, v, **kw),
               lambda v: tile.tile_rows_plain(fmt.chunk_tile, fmt.cols, fmt.lrow,
                                              fmt.vals.abs(), fmt.nc_p, v, **kw),
               rand_x(fmt.shape[1], k, kt))

    def nested_shape(name, fmt, k):
        kt = stripe.choose_kt(k)
        rb = fmt.max_rows_per_stripe
        args = (fmt.cols, fmt.lrow, fmt.vals, fmt.wnz, fmt.wrow)
        record(name, lambda v: stripe.stripe_nested_rows_cuda(*args, v, rb=rb, kt=kt),
               lambda v: stripe.stripe_nested_rows_plain(*args, v, rb=rb),
               lambda v: stripe.stripe_nested_rows_plain(fmt.cols, fmt.lrow, fmt.vals.abs(),
                                                         fmt.wnz, fmt.wrow, v, rb=rb),
               rand_x(fmt.shape[1], k, kt))

    def stripe_shape(name, fmt, a, k):
        """The stripe kernel on a stripe or segment format at K = k (X padded
        to the stripe K-tile, as ``stripe_spmm`` pads it)."""
        kt = stripe.choose_kt(min(k, 32))
        rb = getattr(fmt, "max_rows_per_stripe", None) or fmt.max_segments
        live = dict(live=fmt.live_p) if hasattr(fmt, "live_p") else {}
        args = (fmt.cols, fmt.lrow, fmt.vals)
        x = rand_x(fmt.shape[1], k, kt)
        record(name, lambda v: stripe.stripe_rows_cuda(*args, v, rb=rb, kt=kt, **live),
               lambda v: stripe.stripe_rows_plain(*args, v, rb=rb),
               lambda v: stripe.stripe_rows_plain(fmt.cols, fmt.lrow, fmt.vals.abs(), v, rb=rb),
               x, csr_lib(a, x[:, :k].contiguous()))

    def csr_lib(a, x):
        """cuSPARSE's product of A (CSR on the card) with x [N, K]."""
        csr = a.to_csr_tensor(device=dev)
        return (lambda v: torch.sparse.mm(csr, v)), x

    def takes_walk(wrapper, name="walk"):
        return name in inspect.signature(wrapper).parameters

    def dgt_shape(name, fmt, a, k, stream=False):
        """#3 or, with ``stream``, #4 on a dgt format at K = k."""
        x = rand_x(fmt.shape[1], k, fmt.kt)
        args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p)
        kw = dict(rb=fmt.rb, kt=fmt.kt, mode=fmt.mode, resid=fmt.resid)
        wrapper = dgt.dgt_stream_rows_cuda if stream else dgt.dgt_rows_cuda
        walk = dict(walk=dgt.dgt_row_walk(fmt), k=k) if takes_walk(wrapper) else {}
        kern_kw = dict(kw, **walk)
        if stream:
            del kern_kw["resid"]
            kern_kw["nw"] = fmt.nw
        record(name, lambda v: wrapper(*args, v, **kern_kw),
               lambda v: dgt.dgt_rows_plain(*args, v, **kw),
               lambda v: dgt.dgt_rows_plain(fmt.wins, fmt.cols, fmt.lrw, fmt.vals.abs(),
                                            fmt.nc_p, v, **kw),
               x, csr_lib(a, x[:, :k].contiguous()))

    def dg_shape(name, fmt, a, k):
        """#1 (K > 1) or #2 (K = 1, x [N]) on a dg format."""
        args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        abs_args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals.abs(), fmt.nc_p)
        if k == 1:
            x = rand_x(fmt.shape[1], 1, 1)[:, 0].contiguous()
            walk = dict(walk=dg.dg_row_walk(fmt)) if takes_walk(dg.dg1_rows_cuda) else {}
            record(name, lambda v: dg.dg1_rows_cuda(*args, v, rb=fmt.rb, **walk),
                   lambda v: dg.dg1_rows_plain(*args, v, rb=fmt.rb),
                   lambda v: dg.dg1_rows_plain(*abs_args, v, rb=fmt.rb), x,
                   csr_lib(a, x.view(-1, 1)))
            return
        x = rand_x(fmt.shape[1], k, fmt.kt)
        kw = dict(rb=fmt.rb, kt=fmt.kt, mode=fmt.mode)
        walk = dict(walk=dg.dg_row_walk(fmt), k=k) if takes_walk(dg.dg_rows_cuda) else {}
        record(name, lambda v: dg.dg_rows_cuda(*args, v, **kw, **walk),
               lambda v: dg.dg_rows_plain(*args, v, **kw),
               lambda v: dg.dg_rows_plain(*abs_args, v, **kw), x,
               csr_lib(a, x[:, :k].contiguous()))

    def radix_shape(name, fmt, a, k):
        """#9 on a radix format at K = k, X padded to the format's kt."""
        args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        kw = dict(rb=fmt.rb, kt=fmt.kt, mode=fmt.mode)
        x = rand_x(fmt.shape[1], k, fmt.kt)
        walk = (dict(walk=radix.radix_row_walk(fmt), k=k) if takes_walk(radix.radix_rows_cuda)
                else {})
        record(name, lambda v: radix.radix_rows_cuda(*args, v, **kw, **walk),
               lambda v: radix.radix_rows_plain(*args, v, **kw),
               lambda v: radix.radix_rows_plain(fmt.c0, fmt.cols, fmt.lrow, fmt.vals.abs(),
                                                fmt.nc_p, v, **kw),
               x, csr_lib(a, x[:, :k].contiguous()))

    def span_shape(name, parts, a, k, vals=None, stream=False):
        """The span kernel (#8 with ``stream``, else #7) over ``parts``
        [(format, first column of X)]: the launches of one product, X padded
        to span_spmm's K-tile."""
        kt = tile.choose_kt(min(tile.default_ktile(k), 32))
        x = rand_x(a.shape[1], k, kt)
        wrapper = span.span_stream_rows_cuda if stream else span.span_rows_cuda
        calls = []
        for f, lo in parts:
            v = f.vals if vals is None else vals
            kern_kw = dict(dict(ct=f.ct) if stream else {}, **(
                dict(walk=span.span_row_walk(f), k=k) if takes_walk(wrapper) else {}))
            calls.append(((f.c0, f.cols, f.lrow, v, f.nc_p), (f.c0, f.cols, f.lrow, v.abs(),
                                                               f.nc_p),
                          dict(rb=f.rb, kt=kt, mode="fp32x2"), kern_kw))
        xs = [x[lo:lo + f.shape[1]].contiguous() for f, lo in parts]

        def run(fn, kernel, absolute=False):
            return lambda v: [fn(*(ab if absolute else ar), xi, **kw, **(kk if kernel else {}))
                              for (ar, ab, kw, kk), xi in zip(calls, v)]

        record(name, run(wrapper, True), run(span.span_rows_plain, False),
               run(span.span_rows_plain, False, True), xs, csr_lib(a, x[:, :k].contiguous()))

    def sddmm_shapes(f1, a):
        """#14 and #15 on the trainable layer's format ``f1`` of the weight
        ``a`` at K = 512, and #14 on config #1's span format at K = 8."""
        gen = torch.Generator(device=dev).manual_seed(3)
        k = 512
        x = torch.randn((a.shape[1], k), generator=gen, device=dev)
        dy = torch.randn((f1.n_programs * f1.rb, k), generator=gen, device=dev)
        planes = (f1.c0, f1.cols, f1.lrow, f1.nc_p)
        abs_x = x.abs()
        dyk = torch.randn((a.shape[0], k), generator=gen, device=dev)   # dY in Y's row order
        w_csr, xt = a.to_csr_tensor(device=dev), x.T.contiguous()
        has_tiles = takes_walk(sd.sddmm_rows_cuda, "tiles")
        if wanted("#14"):
            for mode in ("fp32x2", "bf16"):
                kw = dict(rb=f1.rb, kt=32, mode=mode)
                tiles = dict(tiles=sd.sddmm_tiles(f1)) if has_tiles else {}
                record(f"#14 T1 (8, 1639, 128) K=512 {mode}",
                       lambda v, kw=kw, tiles=tiles: sd.sddmm_rows_cuda(*planes, v, x, **kw,
                                                                        **tiles),
                       lambda v, kw=kw: sd.sddmm_rows_plain(*planes, v, x, **kw),
                       lambda v, kw=kw: sd.sddmm_rows_plain(*planes, v, abs_x,
                                                            **dict(kw, mode="fp32")),
                       dy, (lambda m1: torch.sparse.sampled_addmm(w_csr, m1, xt, beta=0.0), dyk),
                       lib_name="cuSPARSE sampled_addmm")
                if mode == "fp32x2":
                    rec = out["shapes"][f"#14 T1 (8, 1639, 128) K=512 {mode}"]
                    mm = (functools.partial(torch.mm, dyk), xt)
                    rec["dense_fp32_mm_device_ms"] = device_ms("#14 cuBLAS dense fp32", *mm)
                    print(f"#14 T1 cuBLAS dense fp32 dY . X^T (TF32 off): device "
                          f"{fmt_ms(rec['dense_fp32_mm_device_ms'])} ms", flush=True)
                if has_tiles:  # each path over the whole pattern
                    for label, min_slots in (("every tile dense", 1),
                                             ("every slot per-slot", 2 ** 31 - 1)):
                        record(f"#14 T1 K=512 {mode}, {label}",
                               lambda v, kw=kw, m=min_slots: sd.sddmm_rows_cuda(
                                   *planes, v, x, **kw, tiles=sd.sddmm_tiles(f1), min_slots=m),
                               lambda v, kw=kw: sd.sddmm_rows_plain(*planes, v, x, **kw),
                               lambda v, kw=kw: sd.sddmm_rows_plain(*planes, v, abs_x,
                                                                    **dict(kw, mode="fp32")),
                               dy)
            fc = span.pack_span(mat, rb=512, ct=512, g=128, keep_perm=True, device=dev)
            pc = (fc.c0, fc.cols, fc.lrow, fc.nc_p)
            xc = rand_x(32768, 8, 8)
            dyc = rand_x(fc.n_programs * fc.rb, 8, 8)
            kw = dict(rb=fc.rb, kt=8, mode="fp32x2")
            tiles = dict(tiles=sd.sddmm_tiles(fc)) if has_tiles else {}
            record("#14 config #1 span rb512 ct512 g128 K=8",
                   lambda v: sd.sddmm_rows_cuda(*pc, v, xc, **kw, **tiles),
                   lambda v: sd.sddmm_rows_plain(*pc, v, xc, **kw),
                   lambda v: sd.sddmm_rows_plain(*pc, v, xc.abs(), **dict(kw, mode="fp32")),
                   dyc)
        if wanted("#15"):
            vals = (f1.vals.float() * torch.from_numpy(sd.occupancy_mask(f1)).to(dev)).contiguous()
            has_index = takes_walk(sd.dx_rows_cuda, "index")
            wt_csr = a.transpose().to_csr_tensor(device=dev)
            wt = wt_csr.to_dense()                                      # W^T [in, out]
            for mode in ("fp32x2", "bf16"):
                kw = dict(n=a.shape[1], rb=f1.rb, kt=32, mode=mode)
                index = dict(index=sd.dx_index(f1)) if has_index else {}
                args = (f1.c0, f1.cols, f1.lrow, vals, f1.nc_p)
                name = f"#15 T1 (8, 1639, 128) K=512 {mode}"
                record(name, lambda v, kw=kw, index=index: sd.dx_rows_cuda(*args, v, **kw, **index),
                       lambda v, kw=kw: sd.dx_rows_plain(*args, v, **kw),
                       lambda v, kw=kw: sd.dx_rows_plain(f1.c0, f1.cols, f1.lrow, vals.abs(),
                                                         f1.nc_p, v, **dict(kw, mode="fp32")),
                       dy, ((lambda m1: torch.sparse.mm(wt_csr, m1)), dyk),
                       lib_name="cuSPARSE SpMM of W^T")
                if mode == "fp32x2":
                    rec = out["shapes"][name]
                    mm = (functools.partial(torch.mm, wt), dyk)
                    rec["dense_fp32_mm_device_ms"] = device_ms("#15 cuBLAS dense fp32", *mm)
                    print(f"#15 T1 cuBLAS dense fp32 W^T . dY (TF32 off): device "
                          f"{fmt_ms(rec['dense_fp32_mm_device_ms'])} ms", flush=True)
                if has_index:
                    idx = sd.dx_index(f1)
                    out["shapes"][name]["index"] = dict(
                        bytes=idx.nbytes, build_ms=idx.build_seconds * 1e3, slots=idx.n_slots,
                        staged=idx.n_staged, pieces=idx.n_pieces)
                    print(f"#15 T1 column index: {idx.nbytes / 2**20:.2f} MiB, built in "
                          f"{idx.build_seconds * 1e3:.1f} ms (the first, cold), {idx.n_slots} "
                          f"slots, {idx.n_staged} staged in {idx.n_pieces} pieces", flush=True)
            fc = span.pack_span(mat, rb=512, ct=512, g=128, keep_perm=True, device=dev)
            vc = fc.vals.float().contiguous()
            dyc = rand_x(fc.n_programs * fc.rb, 8, 8)
            dyc_m = rand_x(mat.shape[0], 8, 8)                          # a dY in Y's row order
            kw = dict(n=mat.shape[1], rb=fc.rb, kt=8, mode="fp32x2")
            index = dict(index=sd.dx_index(fc)) if has_index else {}
            args = (fc.c0, fc.cols, fc.lrow, vc, fc.nc_p)
            record("#15 config #1 span rb512 ct512 g128 K=8",
                   lambda v: sd.dx_rows_cuda(*args, v, **kw, **index),
                   lambda v: sd.dx_rows_plain(*args, v, **kw),
                   lambda v: sd.dx_rows_plain(fc.c0, fc.cols, fc.lrow, vc.abs(), fc.nc_p, v,
                                              **dict(kw, mode="fp32")), dyc,
                   csr_lib(mat.transpose(), dyc_m), lib_name="cuSPARSE SpMM of A^T")

    mat = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    pw = builder.pruned_weight_coo(4096, 4096, 0.9, seed=3)
    if wanted("#5") or wanted("#11"):
        ms = create_init_metadata_set(mat)
        f1024 = pack_tile(ms, 0, out_rows=32768, rb=1024, ct=1024, g=512, device=dev)
        for k in (8, 32, 256):
            tile_shape(f"#5 config #1 rb1024 ct1024 g512 K={k}", f1024, k)
        tile_shape("#5 config #1 rb1024 ct512 g256 K=8",
                   pack_tile(ms, 0, out_rows=32768, rb=1024, ct=512, g=256, device=dev), 8)
        tile_shape("#5 P13 from_dense(k_hint=512) K=512",
                   build_plan(pw, default_schedule(pw, 512), device=dev).formats[0], 512)
        nested = build_plan(mat, Schedule(family="stripe_nested", work_per_block=4096,
                                          unroll=8), device=dev).formats[0]
        for k in (8, 32):
            nested_shape(f"#11 config #1 stripe_nested K={k}", nested, k)
    if wanted("#7") or wanted("T1"):
        f1 = span.pack_span(pw, rb=512, ct=512, g=128, keep_perm=True, device=dev)
        plane = (f1.vals.float() * torch.from_numpy(sd.occupancy_mask(f1)).to(dev)).contiguous()
        span_shape("#7 T1 forward (8, 1639, 128) K=512", [(f1, 0)], pw, 512, vals=plane)
        layer = TrainableSparseLinear(pw, device=dev)
        opt = torch.optim.Adam(layer.parameters(), lr=2e-2)
        rng = np.random.default_rng(17)
        x1 = torch.as_tensor(rng.standard_normal((4, 128, 4096)), dtype=torch.float32,
                             device=dev)
        t1 = torch.as_tensor(rng.standard_normal((4, 128, 4096)), dtype=torch.float32,
                             device=dev)

        def step(xb):
            xs = xb.detach().requires_grad_(True)
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.mse_loss(layer(xs), t1)
            loss.backward()
            opt.step()
            return loss.detach()

        host = float(np.median([harness.time_fn(step, x1, iters=10) for _ in range(5)])) * 1e3
        device = device_ms("T1 training step", step, x1)
        out["shapes"]["T1 training step"] = {"device_ms": device, "time_fn_ms": host}
        print(f"T1 training step: device {fmt_ms(device)} ms a step, time_fn {host:.4f} ms",
              flush=True)
    big = builder.power_law_coo(262144, 262144, avg_nnz_per_row=40.0, seed=9)
    if wanted("#7") or wanted("#8"):
        plan = build_plan(big, default_schedule(big, 8), device=dev)
    if wanted("#7"):
        span_shape("#7 262144^2 span_colsplit(2) K=8",
                   [(f, lo) for f, (lo, _) in zip(plan.formats, plan.meta["col_ranges"])],
                   big, 8)
    if wanted("#8"):
        from tpusparse_torch.io.mtx import CooMatrix
        from tpusparse_torch.tune import _span_configs

        for rb, ct, g in _span_configs(mat.density):
            span_shape(f"#8 config #1 span rb{rb} ct{ct} g{g} K=8",
                       [(span.pack_span(mat, rb=rb, ct=ct, g=g, device=dev), 0)], mat, 8,
                       stream=True)
        lo, hi = plan.meta["col_ranges"][0]
        keep = (big.cols >= lo) & (big.cols < hi)
        sub = CooMatrix(big.rows[keep], big.cols[keep] - lo, big.vals[keep],
                        (big.shape[0], hi - lo))
        span_shape(f"#8 262144^2 span_colsplit(2) sub-format [{lo}, {hi}) K=8",
                   [(plan.formats[0], 0)], sub, 8, stream=True)
    if wanted("#7") or wanted("#8"):
        del plan
    if wanted("#10"):
        for work in (2048, 512):
            f = build_plan(mat, Schedule(family="stripe_total", work_per_block=work, unroll=8),
                           device=dev).formats[0]
            for k in (8, 256):
                stripe_shape(f"#10 config #1 stripe_total merge path {work} K={k}", f, mat, k)
        f = build_plan(mat, Schedule(family="nnz_segment", work_per_block=2048, unroll=8),
                       device=dev).formats[0]
        stripe_shape("#10 config #1 nnz_segment 2048 K=8", f, mat, 8)
        del f
        fn = spmv_fn(big, "stripe")
        # the K the checkout's SpMV runs: x as one column since the stripe
        # wrapper walks live slots, widened to 8 before
        k_spmv = 1 if hasattr(fn.format, "live_p") else 8
        stripe_shape(f"#10 262144^2 spmv_fn('stripe') kernel K={k_spmv}", fn.format, big, k_spmv)
        xv = torch.as_tensor(np.random.default_rng(2).standard_normal(big.shape[1]),
                             dtype=torch.float32, device=dev)
        host = float(np.median([harness.time_fn(fn, xv) for _ in range(5)])) * 1e3
        device = device_ms("#10 SpMV call", fn, xv)
        out["shapes"]["#10 262144^2 spmv_fn('stripe') whole call"] = {"device_ms": device,
                                                                      "time_fn_ms": host}
        print(f"#10 262144^2 spmv_fn('stripe') whole call: device {fmt_ms(device)} ms, "
              f"time_fn {host:.4f} ms", flush=True)
        del fn
    if wanted("#12"):
        w13 = builder.nm_pruned_dense(4096, 4096, 2, 4, seed=5)
        for prec, dt, ks in (("bf16", torch.bfloat16, (128, 512)), ("fp32", torch.float32, (128,))):
            f = nm.pack_nm(w13, n_keep=2, group=4, dtype=dt, device=dev)
            kw = dict(group=4, packed_bits=f.packed_bits, mode=prec)
            wd = torch.as_tensor(w13, dtype=torch.float32, device=dev)
            for k in ks:
                x = rand_x(4096, k, 1)
                if prec == "bf16":
                    def mm(v, w=wd.bfloat16()):
                        return torch.mm(w, v.bfloat16(), out_dtype=torch.float32)
                else:
                    mm = functools.partial(torch.mm, wd)
                record(f"#12 P13 2:4 {prec} K={k}",
                       lambda v, f=f, kw=kw: nm.nm_rows_cuda(f.vals, f.offs, v, **kw),
                       lambda v, f=f, kw=kw: nm.nm_rows_plain(f.vals, f.offs, v, **kw),
                       lambda v, f=f, kw=kw: nm.nm_rows_plain(f.vals.abs(), f.offs, v, **kw),
                       x, (mm, x), lib_name=f"cuBLAS dense {prec}")
    if wanted("#13"):
        a14 = builder.block_sparse_coo(4096, 4096, 128, 0.15, seed=6)
        d14 = torch.as_tensor(a14.to_dense(np.float32), device=dev)
        x14 = rand_x(4096, 256, 1)
        for prec, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32), ("int8", torch.int8)):
            f = be.pack_block_ell(a14, dtype=dt, device=dev)
            bargs = (f.blkcol, f.blkvals, f.nb_p)
            work = dict(work=f.work) if hasattr(f, "work") else {}
            if prec == "int8":  # bell_int8's quantization, X^T's view where it hands that
                amax = x14.abs().amax(dim=0)
                xq = torch.clamp(torch.round(x14 / torch.where(amax > 0, amax / 127.0, 1.0)),
                                 -127, 127).to(torch.int8).contiguous()
                x = xq.t().contiguous().t() if work else xq
                dq = torch.zeros((4096, 4096), dtype=torch.int8, device=dev)
                q, bc, nb = (t.cpu().numpy() for t in (f.blkvals, f.blkcol, f.nb_p))
                for i in range(f.mb):
                    for j in range(nb[i]):
                        dq[i * 128:(i + 1) * 128, bc[i, j] * 128:(bc[i, j] + 1) * 128] = \
                            torch.from_numpy(q[i, j])
                lib, lib_name = (functools.partial(torch._int_mm, dq), xq), "torch._int_mm dense"
            else:
                x = x14
                wd = d14.bfloat16() if prec == "bf16" else d14
                lib = ((lambda v, w=wd: torch.mm(w, v.bfloat16(), out_dtype=torch.float32))
                       if prec == "bf16" else functools.partial(torch.mm, wd), x14)
                lib_name = f"cuBLAS dense {prec}"
            record(f"#13 P14 {prec} K=256",
                   lambda v, bargs=bargs, work=work, prec=prec:
                   be.bell_rows_cuda(*bargs, v, mode=prec, **work),
                   lambda v, bargs=bargs, prec=prec: be.bell_rows_plain(*bargs, v.contiguous(),
                                                                         mode=prec),
                   lambda v, f=f, prec=prec: be.bell_rows_plain(
                       f.blkcol, f.blkvals.abs(), f.nb_p, v.contiguous().abs(), mode=prec),
                   x, lib, lib_name=lib_name)
    if wanted("#1"):
        for k in (8, 64):
            dg_shape(f"#1 config #1 dg_span default K={k}",
                     build_plan(mat, default_schedule(mat, k), device=dev).formats[0], mat, k)
        sched = Schedule(family="dg_span", rb=512, ns=8, g=512, unroll=8, ktile=8)
        dg_shape("#1 config #1 dg_span rb512 ns8 g512 K=8",
                 build_plan(mat, sched, device=dev).formats[0], mat, 8)
    if wanted("#2"):
        dg_shape("#2 config #1 dg_span default K=1",
                 build_plan(mat, default_schedule(mat, 1), device=dev).formats[0], mat, 1)
        dg_shape("#2 262144^2 spmv_fn('auto') K=1", spmv_fn(big, "auto").format, big, 1)
    if wanted("#3") or wanted("#4"):
        sched = Schedule(family="dgt_span", rb=512, nw=8, g=512, unroll=8, ktile=8)
        f_h = build_plan(mat, sched, device=dev).formats[0]
        f_multi = spmv_multi_fn(big, 8).formats[0]
    if wanted("#3"):
        dgt_shape("#3 262144^2 spmv_fn('dgt8') K=1", spmv_fn(big, "dgt8").format, big, 1)
        dgt_shape("#3 262144^2 spmv_multi_fn(8) K=8", f_multi, big, 8)
        dgt_shape("#3 config #1 dgt_span rb512 nw8 g512 K=8", f_h, mat, 8)
    if wanted("#4"):
        dgt_shape("#4 config #1 dgt_span rb512 nw8 g512 stream_x K=8", f_h, mat, 8, stream=True)
        for k in (8, 64):
            dgt_shape(f"#4 262144^2 spmv_multi_fn(8) stream_x K={k}", f_multi, big, k,
                      stream=True)
    if wanted("#9"):
        radix_shape("#9 262144^2 radix_span default K=4 (P8)",
                    build_plan(big, default_schedule(big, 4), device=dev).formats[0], big, 4)
        radix_shape("#9 262144^2 spmv_fn('radix') K=1 (P12)", spmv_fn(big, "radix").format,
                    big, 1)
        band = builder.banded_coo(32768, 32768, bandwidth=16, seed=3)
        sched = Schedule(family="brick_ell", sort=True, rb=1024, sublanes=256, g=512, unroll=4,
                         ktile=8)
        radix_shape("#9 banded 32768^2 brick_ell K=8 (P11)",
                    build_plan(band, sched, device=dev).formats[0], band, 8)
        from tpusparse_torch.tune import _radix_configs

        for rb, s_, g in _radix_configs(mat.density, 8):  # config #1's radix_span tune rows
            sched = Schedule(family="radix_span", rb=rb, sublanes=s_, g=g, unroll=4, ktile=8)
            radix_shape(f"#9 config #1 radix_span rb{rb} S={s_} g{g} K=8",
                        build_plan(mat, sched, device=dev).formats[0], mat, 8)
    if wanted("#14") or wanted("#15"):
        sddmm_shapes(span.pack_span(pw, rb=512, ct=512, g=128, keep_perm=True, device=dev), pw)
    out["graph_replay"] = sorted(graph_read)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
