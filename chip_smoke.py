#!/usr/bin/env python3
"""Smoke run of tpusparse_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from tpusparse_torch/csrc, holds each against its
plain PyTorch version on the card, and drives the ported paths through the
entry points a user calls:

- ``tpusparse_torch.spmm`` at K = 8, 1 and 64 (the default ``dg_span``
  schedule) and with a ``dgt_span`` schedule at K = 8 and 32, then ``tune``
  over both families, at the headline size: a power-law 32768 x 32768
  matrix with about 1.0M nonzeros (alpha 1.8, seed 42);
- SpMV at the repo's SpMV size, a power-law 262144 x 262144 matrix with 40
  nonzeros per row on average (seed 9, about 10.2M nonzeros):
  ``spmv_fn(mat, "auto")`` (dg1), ``spmv_fn(mat, "dgt8")`` and
  ``spmv_multi_fn(mat, 8)``; ``spmv_multi_fn(..., col_split=2)`` at the
  headline size; ``dgt_spmm(..., stream_x=True)`` at both sizes.

Every result is checked against the host oracle; the kernels are timed
against their bound, their plain versions and cuSPARSE.  Any failure
raises and the exit code is not 0.  It exits non-zero before printing any
result when no CUDA device is present or the package cannot be imported.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists every ported kernel as JSON.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

M = N = 32768            # the headline matrix (bench.py:137-142)
AVG_NNZ_PER_ROW = 32.0
ALPHA = 1.8
SEED = 42
SPMV_N = 262144          # the SpMV workload (tpusparse/bench/suite.py:364-365)
SPMV_AVG = 40.0
SPMV_SEED = 9
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, published
REPS = 5                    # back-to-back readings per yardstick, interleaved


def log(*args):
    print(*args, flush=True)


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def rel_err(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor | None = None):
    """(max relative error, max absolute error); the denominator is
    max(|want|, 1), raised to ``scale`` (|A|·|x|) where given."""
    diff = (got.double() - want.double()).abs()
    denom = want.double().abs().clamp(min=1.0)
    if scale is not None:
        denom = torch.maximum(denom, scale.double())
    return float((diff / denom).max()), float(diff.max())


def bound_ms(nnz: int, m: int, n: int, k: int) -> tuple[float, str]:
    """Least time for Y = A X on the card: the CSR bytes of A (nnz values
    and column indices, M+1 row pointers), X and Y each moved once over HBM,
    against 2 nnz K fp32 flops at the fp32 peak."""
    t_bytes = (nnz * 8 + (m + 1) * 4 + n * k * 4 + m * k * 4) / HBM_BYTES_PER_S
    t_ops = 2.0 * nnz * k / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tpusparse_torch
        from tpusparse_torch.bench.harness import gflops, time_fn
        from tpusparse_torch.io import builder
        from tpusparse_torch.kernels import build
        from tpusparse_torch.kernels import dg_gather as dg
        from tpusparse_torch.kernels import dgt_gather as dgt
        from tpusparse_torch.oracle import check_result, spmm_reference
        from tpusparse_torch.schedule import Schedule, build_plan, default_schedule
        from tpusparse_torch.spmv import spmv_fn, spmv_multi_fn
        from tpusparse_torch.tune import tune
    except ImportError as e:
        print(f"chip_smoke: cannot import tpusparse_torch ({e}); run it from the repo root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dg_src, dgt_src = "tpusparse_torch/csrc/dg_gather.cu", "tpusparse_torch/csrc/dgt_gather.cu"
    kernels = {  # the ported kernels, by their wrapper
        "dg": {"wrapper": dg.dg_rows_cuda, "name": "dg_rows_cuda", "source": dg_src,
               "replaces": "tpusparse/kernels/dg_gather.py:318", "err": 0.0},
        "dg1": {"wrapper": dg.dg1_rows_cuda, "name": "dg1_rows_cuda", "source": dg_src,
                "replaces": "tpusparse/kernels/dg_gather.py:382", "err": 0.0},
        "dgt": {"wrapper": dgt.dgt_rows_cuda, "name": "dgt_rows_cuda", "source": dgt_src,
                "replaces": "tpusparse/kernels/dgt_gather.py:667", "err": 0.0},
        "dgt_stream": {"wrapper": dgt.dgt_stream_rows_cuda, "name": "dgt_stream_rows_cuda",
                       "source": dgt_src, "replaces": "tpusparse/kernels/dgt_gather.py:882",
                       "err": 0.0},
    }

    # ---- 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    power = power_line()
    log(f"[device] {kind} x{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {power}")

    # ---- 2. build (every source, nvcc processes started together)
    info = build.build()
    for name, rec in info.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "error", "warning")):
                log(f"[build]   {line.strip()}")

    # ---- 3. each kernel against its plain version, on the card
    def check_vs_plain(which, label, desc, got, want, scale, tol):
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want, scale)
        log(f"[kernel] {kernels[which]['name']} ({kernels[which]['replaces']}) {label} "
            f"{desc}: max rel err {rel:.2e} (tol {tol:g}), max abs err {ab:.2e}")
        if not rel <= tol:
            raise AssertionError(f"{kernels[which]['name']} disagrees with its plain version: "
                                 f"{rel:.3e}")
        if label != "small":  # max_abs_err: over the shapes of the main paths
            kernels[which]["err"] = max(kernels[which]["err"], ab)

    def rand_x(n, k):
        return torch.as_tensor(np.random.default_rng(1).standard_normal((n, k)),
                               dtype=torch.float32, device=dev)

    def vs_plain(label, fmt, k, kt, mode, tol):
        x = rand_x(fmt.shape[1], k)
        args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        abs_args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals.abs(), fmt.nc_p)
        if kt == 1:
            x = x[:, 0].contiguous()
            got = dg.dg1_rows_cuda(*args, x, rb=fmt.rb)
            want = dg.dg1_rows_plain(*args, x, rb=fmt.rb)
            scale = dg.dg1_rows_plain(*abs_args, x.abs(), rb=fmt.rb)
            which = "dg1"
        else:
            x = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
            got = dg.dg_rows_cuda(*args, x, rb=fmt.rb, kt=kt, mode=mode)
            want = dg.dg_rows_plain(*args, x, rb=fmt.rb, kt=kt, mode=mode)
            scale = dg.dg_rows_plain(*abs_args, x.abs(), rb=fmt.rb, kt=kt, mode="fp32x2")
            which = "dg"
        branch = ("shared tile" if kt == 1 or dg.dg_uses_shared_tile(fmt.rb, kt)
                  else "global atomics")
        check_vs_plain(which, label, f"kt={kt} {mode} K={k} rb={fmt.rb}, {branch}",
                       got, want, scale, tol)

    def dgt_vs_plain(label, fmt, k, tol, stream=False):
        x = rand_x(fmt.shape[1], k)
        x = dg.pad_dense_cols(x, -(-k // fmt.kt) * fmt.kt).contiguous()
        args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p)
        abs_args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals.abs(), fmt.nc_p)
        kw = dict(rb=fmt.rb, kt=fmt.kt, mode=fmt.mode)
        if stream:
            got = dgt.dgt_stream_rows_cuda(*args, x, nw=fmt.nw, **kw)
            want = dgt.dgt_stream_rows_plain(*args, x, nw=fmt.nw, **kw)
        else:
            got = dgt.dgt_rows_cuda(*args, x, resid=fmt.resid, **kw)
            want = dgt.dgt_rows_plain(*args, x, resid=fmt.resid, **kw)
        scale = dgt.dgt_rows_plain(*abs_args, x.abs(), resid=fmt.resid, **kw)
        branch = ("shared tile" if dgt.dgt_uses_shared_tile(fmt.rb, fmt.kt, stream=stream)
                  else "global atomics")
        check_vs_plain("dgt_stream" if stream else "dgt", label,
                       f"kt={fmt.kt} {fmt.mode} K={k} rb={fmt.rb} nw={fmt.nw} "
                       f"resid={fmt.resid} P={fmt.n_programs} NC={fmt.n_chunks}, {branch}",
                       got, want, scale, tol)

    small = builder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=0)
    mat = builder.power_law_coo(M, N, avg_nnz_per_row=AVG_NNZ_PER_ROW, alpha=ALPHA, seed=SEED)
    log(f"[matrix] headline: {M}x{N}, nnz={mat.nnz}, power law alpha={ALPHA} seed={SEED}")
    # A kernel and its plain version form the same products (bf16 rounds
    # each one identically in both) and differ only in the order of their
    # atomic fp32 sums.  That error grows with the sum of |terms|, not with
    # the result, and the headline's heaviest rows hold thousands of
    # nonzeros whose sums cancel; so the error is judged against |A|·|x|
    # (the denominator of tpusparse/tune.py:373-388).
    tol = 1e-5
    for label, m_ in (("small", small), ("headline", mat)):
        rb_big = 1024 if label == "headline" else 128
        fmt8 = dg.pack_dg(m_, rb=rb_big, ns=8, g=512, kt=8, device=dev)
        for kt in (8, 16, 32):
            for mode in ("fp32x2", "bf16"):
                vs_plain(label, fmt8, kt, kt, mode, tol)
        vs_plain(label, fmt8, 40, 16, "fp32x2", tol)       # K-tiling: 3 tiles of 16
        fmt64 = dg.pack_dg(m_, rb=rb_big // 2, ns=8, g=512, kt=32, device=dev)
        vs_plain(label, fmt64, 64, 32, "fp32x2", tol)      # the K=64 default
        fmt_g = dg.pack_dg(m_, rb=2048, ns=8, g=512, kt=32, device=dev)
        vs_plain(label, fmt_g, 32, 32, "fp32x2", tol)      # 256 KB tile: global branch
        fmt1 = dg.pack_dg(m_, rb=4096 if label == "headline" else 256, ns=4, g=2048,
                          kt=1, device=dev)
        vs_plain(label, fmt1, 1, 1, "fp32x2", tol)

    t0 = time.perf_counter()
    for label, m_ in (("small", small), ("headline", mat)):
        rb_t = 512 if label == "headline" else 128

        def pack(**kw):
            return dgt.pack_dgt(m_, **dict(dict(rb=rb_t, g=512, kt=8, nw=4), **kw), device=dev)

        for kt in (8, 16, 32):
            for mode in ("fp32x2", "bf16"):
                f = pack(kt=kt, mode=mode, nw=8 if (kt, mode) == (8, "fp32x2") else 4)
                dgt_vs_plain(label, f, kt, tol)
                if (kt, mode) == (8, "fp32x2"):
                    dgt_vs_plain(label, f, 8, tol, stream=True)          # kernel #4, nw 8
                if (kt, mode) == (16, "fp32x2"):
                    dgt_vs_plain(label, f, 40, tol)                      # K-tiling: 3 tiles
        f4 = pack(nw=4)
        dgt_vs_plain(label, f4, 8, tol)
        dgt_vs_plain(label, f4, 8, tol, stream=True)                      # kernel #4, nw 4
        dgt_vs_plain(label, pack(nw=1), 8, tol)
        dgt_vs_plain(label, pack(nw=8, resid=False), 8, tol)
        dgt_vs_plain(label, pack(rb=2048, kt=32), 32, tol)                # 256 KB: global
    log(f"[kernel] dgt checks (packing included): {time.perf_counter() - t0:.1f} s")

    # ---- 4. the main paths through the entry points.  Each path runs with
    # every count set to 0 just before it and read just after, so each
    # kernel's launches are known path by path.
    def zero_counts():
        for rec in kernels.values():
            rec["wrapper"].launches = 0

    def read_counts(path):
        for rec in kernels.values():
            rec["paths"][path] = rec["wrapper"].launches

    def need(path, which):
        n_l = kernels[which]["paths"][path]
        if n_l < 1:
            raise AssertionError(f"path {path} did not launch {kernels[which]['name']}")
        return n_l

    for rec in kernels.values():
        rec["paths"] = {}
    xs = {}
    for k, which in ((8, "dg"), (1, "dg1"), (64, "dg"), (32, "dg")):
        xs[k] = np.random.default_rng(0).standard_normal((N, k)).astype(np.float32)
        if k == 32:
            continue
        zero_counts()
        t0 = time.perf_counter()
        y = tpusparse_torch.spmm(mat, xs[k])      # no device given: the card
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        read_counts(f"spmm_k{k}")
        sched = default_schedule(mat, k)
        assert y.is_cuda and y.shape == (M, k) and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), spmm_reference(mat, xs[k].astype(np.float64)), rtol=2e-3)
        n_l = need(f"spmm_k{k}", which)
        log(f"[spmm] K={k}: {sched.family} rb={sched.rb} ns={sched.ns} g={sched.g} "
            f"ktile={sched.ktile}: oracle ok at rtol 2e-3, {n_l} launch(es) of "
            f"{kernels[which]['name']}, first call {dt:.2f} s (packing included)")

    dgt_scheds = {8: Schedule(family="dgt_span", rb=512, nw=8, g=512, unroll=8, ktile=8),
                  32: Schedule(family="dgt_span", rb=512, nw=8, g=512, unroll=8, ktile=32)}
    dgt_fmts = {}
    for k, sched in dgt_scheds.items():
        zero_counts()
        t0 = time.perf_counter()
        y = tpusparse_torch.spmm(mat, xs[k], schedule=sched)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        read_counts(f"spmm_dgt_k{k}")
        assert y.is_cuda and y.shape == (M, k) and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), spmm_reference(mat, xs[k].astype(np.float64)), rtol=2e-3)
        n_l = need(f"spmm_dgt_k{k}", "dgt")
        log(f"[spmm] K={k}: dgt_span rb={sched.rb} nw={sched.nw} g={sched.g} "
            f"ktile={sched.ktile}: oracle ok at rtol 2e-3, {n_l} launch(es) of dgt_rows_cuda, "
            f"first call {dt:.2f} s (packing included)")
        dgt_fmts[k] = build_plan(mat, sched).formats[0]
        dgt_vs_plain("headline", dgt_fmts[k], k, tol)  # at the path's own shape

    # ---- 5. tune over the dg and dgt candidates at the headline size
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpusparse_torch",
                         "_build", "tune_cache")
    with tpusparse_torch.config_override(cache_dir=cache):
        zero_counts()
        res = tune(mat, xs[8], use_cache=False)
        read_counts("tune_k8")
    best_by_family = {}
    for row in res.table:
        s = row["schedule"]
        if not row["ok"]:
            raise AssertionError(f"tune candidate failed: {row['error']}")
        geo = (f"ns={s['ns']}" if s["family"] == "dg_span" else
               f"nw={s['nw']} resid={s['resid']} u={s['unroll']} i8={s['rowhot_i8']}")
        log(f"[tune] {s['family']} rb={s['rb']} {geo} g={s['g']} kt={s['ktile']} "
            f"{s['precision']}: {row['seconds'] * 1e3:.4f} ms, {row['gflops']:.2f} GF/s, "
            f"pad {row['padding_rate']:.3f}, pack {row['pack_seconds']:.2f} s  ({power})"
            + ("  [same plan as an earlier row: not timed again]" if "same_plan_as" in row
               else ""))
        fam = s["family"]
        if fam not in best_by_family or row["seconds"] < best_by_family[fam]["seconds"]:
            best_by_family[fam] = row
    best = res.best_schedule
    log(f"[tune] winner: {best.family} rb={best.rb} g={best.g} kt={best.ktile}, "
        f"{res.best_seconds * 1e3:.4f} ms; launches {kernels['dg']['paths']['tune_k8']} "
        f"dg_rows_cuda, {kernels['dgt']['paths']['tune_k8']} dgt_rows_cuda")
    need("tune_k8", "dg")
    need("tune_k8", "dgt")
    # the tuner's winner, held against its plain version at its own geometry
    # (the best row of each family follows with the yardsticks)
    win = res.best
    wf = win.formats[0]
    if best.family == "dgt_span":
        dgt_vs_plain("headline", wf, 8, tol)
    else:
        vs_plain("headline", wf, 8, wf.kt, wf.mode, tol)

    # ---- 6. SpMV at the SpMV workload's size, and the column split and the
    # stream kernel through dgt_spmm
    big = builder.power_law_coo(SPMV_N, SPMV_N, avg_nnz_per_row=SPMV_AVG, seed=SPMV_SEED)
    log(f"[matrix] spmv: {SPMV_N}x{SPMV_N}, nnz={big.nnz}, power law seed={SPMV_SEED}")
    xv = np.random.default_rng(2).standard_normal(SPMV_N).astype(np.float32)
    xb8 = np.random.default_rng(3).standard_normal((SPMV_N, 8)).astype(np.float32)
    ref_v = spmm_reference(big, xv.astype(np.float64))
    ref_b8 = spmm_reference(big, xb8.astype(np.float64))
    ref_h8 = spmm_reference(mat, xs[8].astype(np.float64))
    spmv_fns, pack_s = {}, {}

    def run_path(path, which, make, x, want, shape):
        """Makes the entry point's fn (packing included) and calls it once,
        with every launch count set to 0 just before."""
        zero_counts()
        t0 = time.perf_counter()
        fn = make()
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        y = fn(x)
        torch.cuda.synchronize()
        read_counts(path)
        assert y.is_cuda and tuple(y.shape) == shape and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), want, rtol=2e-3)
        n_l = need(path, which)
        log(f"[spmv] {path}: oracle ok at rtol 2e-3, {n_l} launch(es) of "
            f"{kernels[which]['name']}, making the fn {t_pack:.2f} s (packing included)")
        spmv_fns[path], pack_s[path] = fn, t_pack
        return fn

    # each path's kernel is then held against its plain version at the
    # path's own format (the 80 KB opt-in row tile of rb = 2560 among them)
    run_path("spmv_auto_262k", "dg1", lambda: spmv_fn(big, "auto"), xv, ref_v, (SPMV_N,))
    fmt1 = spmv_fns["spmv_auto_262k"].format
    vs_plain("spmv", fmt1, 1, 1, "fp32x2", tol)
    run_path("spmv_dgt8_262k", "dgt", lambda: spmv_fn(big, "dgt8"), xv, ref_v, (SPMV_N,))
    fmt8 = spmv_fns["spmv_dgt8_262k"].format
    log(f"[spmv]   dgt8 format: rb={fmt8.rb} P={fmt8.n_programs} NC={fmt8.n_chunks} "
        f"pad={fmt8.padding_rate:.3f} {fmt8.memory_bytes / 2**20:.1f} MiB")
    dgt_vs_plain("spmv", fmt8, 1, tol)
    multi = run_path("spmv_multi_262k", "dgt", lambda: spmv_multi_fn(big, 8), xb8, ref_b8,
                     (SPMV_N, 8))
    assert multi.n_splits == 1
    dgt_vs_plain("spmv", multi.formats[0], 8, tol)
    split = run_path("spmv_multi_split2", "dgt", lambda: spmv_multi_fn(mat, 8, col_split=2),
                     xs[8], ref_h8, (M, 8))
    assert split.n_splits == 2 and kernels["dgt"]["paths"]["spmv_multi_split2"] == 2
    for f in split.formats:
        dgt_vs_plain("headline", f, 8, tol)
    fmt_s = dgt_fmts[8]
    stream_h = run_path("stream_headline", "dgt_stream",
                        lambda: functools.partial(dgt.dgt_spmm, fmt_s, stream_x=True),
                        xs[8], ref_h8, (M, 8))
    stream_b = run_path("stream_262k", "dgt_stream",
                        lambda: functools.partial(dgt.dgt_spmm, multi.formats[0], stream_x=True),
                        xb8, ref_b8, (SPMV_N, 8))
    dgt_vs_plain("headline", fmt_s, 8, tol, stream=True)
    dgt_vs_plain("spmv", multi.formats[0], 8, tol, stream=True)

    launches = {w: sum(rec["paths"].values()) for w, rec in kernels.items()}
    for w, n_l in launches.items():
        if n_l < 1:
            raise AssertionError(f"the main path never launched {kernels[w]['name']}")
    for rec in kernels.values():
        log(f"[path] launches of {rec['name']} by path: {rec['paths']}")

    # ---- 7. yardsticks: kernel, plain version, whole call, cuSPARSE, bound
    def csr_of(a, m, n):
        rows_t = torch.from_numpy(a.rows)
        crow = torch.zeros(m + 1, dtype=torch.int64)
        crow[1:] = torch.cumsum(torch.bincount(rows_t, minlength=m), 0)
        return torch.sparse_csr_tensor(crow, torch.from_numpy(a.cols),
                                       torch.from_numpy(a.vals.astype(np.float32)),
                                       size=(m, n)).to(dev)

    a_csr = {"headline": csr_of(mat, M, N), "spmv": csr_of(big, SPMV_N, SPMV_N)}

    def time_cold(fn, x, iters=20):
        """Median seconds of one call with L2 cold: a 1 GiB buffer, twenty
        times the 50 MB L2, is rewritten before each call, outside its
        events.  What an application sees that runs other work between
        products (a GNN layer's dense transform), so that A's format has
        left L2; a yardstick beside time_fn's back-to-back time only."""
        flush = torch.empty(2**28, dtype=torch.float32, device=dev)
        fn(x)
        times = []
        for _ in range(iters):
            flush.fill_(1.0)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(x)
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in times])) / 1e3

    def yardstick(which, label, fmt, size, k, x, whole, pack=None):
        """Times the kernel of ``which`` on ``fmt`` (kt-padded X of K
        columns), its plain version, cuSPARSE on the same product and the
        whole entry-point call ``whole(x)``."""
        a_ = a_csr[size]
        nnz, m, n = ((mat.nnz, M, N) if size == "headline" else (big.nnz, SPMV_N, SPMV_N))
        xd = torch.as_tensor(x, device=dev)
        x2 = xd.view(-1, 1) if xd.ndim == 1 else xd
        plain_fn = {"dg": dg.dg_rows_plain, "dg1": dg.dg1_rows_plain,
                    "dgt": dgt.dgt_rows_plain, "dgt_stream": dgt.dgt_stream_rows_plain}[which]
        if which in ("dg", "dg1"):
            args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        else:
            args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p)
        if which == "dg1":
            xk, kw = xd.contiguous(), {}
        else:
            xk = dg.pad_dense_cols(x2, -(-x2.shape[1] // fmt.kt) * fmt.kt).contiguous()
            kw = dict(kt=fmt.kt, mode=fmt.mode)
            if which == "dgt":
                kw["resid"] = fmt.resid
            elif which == "dgt_stream":
                kw["nw"] = fmt.nw
        kern = functools.partial(kernels[which]["wrapper"], *args, rb=fmt.rb, **kw)
        plain = functools.partial(plain_fn, *args, rb=fmt.rb, **kw)

        def lib(v):
            return torch.sparse.mm(a_, v)

        # REPS back-to-back readings each, interleaved; a number is their
        # median, since one reading of a call this short moves with the host
        runs = {"kernel": [], "plain": [], "library": [], "whole": []}
        for _ in range(REPS):
            for name, f, arg in (("kernel", kern, xk), ("plain", plain, xk),
                                 ("library", lib, x2), ("whole", whole, xd)):
                runs[name].append(time_fn(f, arg))
        t = {name: float(np.median(v)) for name, v in runs.items()}
        t["kernel_cold"] = time_cold(kern, xk)
        t["library_cold"] = time_cold(lib, x2)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        whole(xd)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        b_ms, b_by = bound_ms(nnz, m, n, k)
        k_ms = t["kernel"] * 1e3
        p_ms = t["plain"] * 1e3
        geo = (f"ns={fmt.ns}" if which in ("dg", "dg1") else
               f"nw={fmt.nw} resid={fmt.resid} P={fmt.n_programs} NC={fmt.n_chunks}")

        def readings(name):
            return " ".join(f"{v * 1e3:.4f}" for v in runs[name])

        log(f"[yardstick] {kernels[which]['name']} {label} K={k} rb={fmt.rb} {geo} "
            f"g={fmt.chunk_g} pad={fmt.padding_rate:.3f}  ({power})")
        log(f"[yardstick]   back to back, median of {REPS}: kernel {k_ms:.4f} ms "
            f"({gflops(nnz, k, k_ms / 1e3):.1f} GF/s, {nnz / k_ms / 1e6:.2f} Gnnz/s), "
            f"plain {p_ms:.4f} ms, whole call {t['whole'] * 1e3:.4f} ms, cuSPARSE "
            f"{t['library'] * 1e3:.4f} ms")
        log(f"[yardstick]   readings (ms): kernel {readings('kernel')}; plain "
            f"{readings('plain')}; whole {readings('whole')}; cuSPARSE {readings('library')}")
        log(f"[yardstick]   cold L2 (median of 20): kernel {t['kernel_cold'] * 1e3:.4f} ms, "
            f"cuSPARSE {t['library_cold'] * 1e3:.4f} ms")
        log(f"[yardstick]   bound {b_ms:.4f} ms ({b_by}); kernel at "
            f"{100 * b_ms / k_ms:.1f}% of it; format {fmt.memory_bytes / 2**20:.1f} MiB"
            + (f", pack {pack:.2f} s" if pack is not None else "")
            + f"; peak device memory of one call {peak / 2**20:.1f} MiB")
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": t["library"] * 1e3}

    def plan_of(row):
        sched = Schedule(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in row["schedule"].items()})
        return build_plan(mat, sched)

    best_dg, best_dgt = plan_of(best_by_family["dg_span"]), plan_of(best_by_family["dgt_span"])
    f_dg = best_dg.formats[0]
    vs_plain("headline", f_dg, 8, f_dg.kt, f_dg.mode, tol)
    dgt_vs_plain("headline", best_dgt.formats[0], 8, tol)
    plan1, plan64 = (build_plan(mat, default_schedule(mat, k)) for k in (1, 64))
    stats = {
        "dg": yardstick("dg", "headline, best dg tune row", best_dg.formats[0], "headline", 8,
                        xs[8], best_dg.fn, best_by_family["dg_span"]["pack_seconds"]),
        "dg1": yardstick("dg1", "headline, default schedule", plan1.formats[0], "headline", 1,
                         xs[1][:, 0].copy(), lambda v: plan1.fn(v.view(-1, 1))),
        "dgt": yardstick("dgt", "headline, best dgt tune row", best_dgt.formats[0], "headline",
                         8, xs[8], best_dgt.fn, best_by_family["dgt_span"]["pack_seconds"]),
        "dgt_stream": yardstick("dgt_stream", "headline, stream_x", fmt_s, "headline", 8,
                                xs[8], stream_h),
    }
    yardstick("dg", "headline, default schedule", plan64.formats[0], "headline", 64, xs[64],
              plan64.fn)
    yardstick("dgt", "spmv dgt8", fmt8, "spmv", 1, xv, spmv_fns["spmv_dgt8_262k"],
              pack_s["spmv_dgt8_262k"])
    yardstick("dgt", "spmv_multi_fn(8)", multi.formats[0], "spmv", 8, xb8, multi,
              pack_s["spmv_multi_262k"])
    yardstick("dgt_stream", "spmv size, stream_x", multi.formats[0], "spmv", 8, xb8,
              stream_b)
    yardstick("dg1", "spmv auto", spmv_fns["spmv_auto_262k"].format, "spmv", 1, xv,
              spmv_fns["spmv_auto_262k"], pack_s["spmv_auto_262k"])

    # ---- 8. where the time of one spmm call goes (the tuner's winner, K=8)
    from torch.profiler import ProfilerActivity, profile

    x8 = torch.as_tensor(xs[8], device=dev)
    calls = 20

    def back_to_back():
        t0 = time.perf_counter()
        for _ in range(calls):
            win.fn(x8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / calls

    back_to_back()
    plain_wall_us = back_to_back()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_us = back_to_back()
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops carry their kernels' time too: count kernels once
        t_dev = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t_dev > 0:
            dev_us[e.key] = (t_dev / calls, e.count / calls)
    busy = sum(t for t, _ in dev_us.values())
    log(f"[profile] spmm K=8 winner ({best.family}), {calls} calls back to back (warm L2), "
        f"per call: host wall {plain_wall_us:.1f} us ({wall_us:.1f} us under the profiler), "
        f"device busy {busy:.1f} us"
        + (f", device idle share {max(0.0, 1 - busy / plain_wall_us):.2f}" if busy else
           " (the profiler saw no device time: not measured)"))
    for key, (t_dev, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {t_dev:8.2f} us  x{n:g}  {key[:90]}")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    line = {"kernels": [
        {"name": rec["name"], "route": "cuda", "source": rec["source"],
         "replaces": rec["replaces"], "launches": launches[w],
         "launches_by_path": rec["paths"], "max_abs_err": rec["err"], **stats[w]}
        for w, rec in kernels.items()]}
    log(power)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
