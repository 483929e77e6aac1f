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
  headline size; ``dgt_spmm(..., stream_x=True)`` at both sizes (K = 8,
  and K = 64 at the SpMV size, where X outgrows the 50 MB L2);
- the wide-K and large-N paths: ``spmm`` at the headline size with K = 256
  (``tile_onehot``, the stream kernel) and at the SpMV size with K = 8
  (the card's default, one ``dg_span`` format, beside the TPU's decision,
  ``span_colsplit``: two span launches), ``tune`` at the headline size at
  K = 8 (now with span and tile rows) and K = 256 (tile rows),
  ``span_spmm(stream=True)`` at both sizes and ``tile_spmm`` resident at
  K = 32;
- the radix, stripe and segment families: ``spmm`` at the SpMV size with
  K = 4 (P8: the ``radix_span`` default of both records, ``dg_span`` timed
  beside it), ``tune`` at the headline size at
  K = 8 with the JAX package's 25 candidates in its order (P9: radix,
  brick-ELL, stripe, segment and bucketed rows too), ``build_plan`` with
  ``stripe_total``, ``stripe_nested``, ``nnz_segment``, ``segment_span``
  and ``bucketed`` at the headline size and ``build_stripe_plan`` (P10),
  ``brick_ell`` on a banded 32768 x 32768 matrix (P11), and
  ``spmv_fn(mat, "radix")`` and ``spmv_fn(mat, "stripe")`` at the SpMV
  size (P12);
- the dense-tile families for pruned weights at a 7B-class projection's
  4096 x 4096: ``SparseLinear.from_nm`` (2:4, seed 5) in bf16, fp32 and
  int8 and in ``mode="throughput"``, ``nm_spmm`` and ``batched_spmm``,
  and ``SparseLinear.from_dense`` of a 90 %-pruned weight (P13);
  ``SparseLinear.from_block`` (15 % of 128-blocks, seed 6) in bf16, fp32
  and int8 (each on the Block-ELL kernel, the card's default method) and
  ``block_ell_spmm(method="pallas")`` (P14); ``build_plan``
  with ``dense`` at the headline, K = 256, ``block_ell`` and
  ``hybrid_cols`` (panel widths 2048 and 512 on a column-skewed 32768 x
  32768 matrix, alpha 1.6, seed 9) (P15); ``tune`` on that matrix at K = 8
  with the JAX package's 26 candidates, the hybrid rows first (P16);
- training: the SDDMM value-gradient and transpose-apply kernels against
  their plain versions at the JAX tests' 300 x 260 and, with the forward's
  span kernel on the masked value plane, at the trainable layer's format,
  and the value gradient on a 4096 x 4096 pattern whose tiles take both of
  its paths and on the headline matrix's (T0); ``TrainableSparseLinear`` on the 90 %-pruned 4096 x 4096 weight
  (seed 3) with bias, five Adam steps on x [4, 128, 4096] (K = 512)
  against a fixed target, the first step's output and both gradients held
  against the dense fp32 ones (T1); the differentiable
  ``SparseLinear.from_coo`` at the headline size (K = 8), each of its two
  plans' kernels held against its plain version at the plan's format, and
  ``from_block`` on P14's weight (K = 256), backward included (T2); one
  whole training step timed against the same step on the dense weight.

- the multi-device layer (phase D, after B1-B5) on virtual ranks of the
  card, at the headline size: the sharded stripe SpMM on a 2 x 2 mesh
  (D1); the five halo rings at D = 4 on ``["cuda:0"] * 4`` and the span,
  radix, dg and dgt rings on a 4 x 2 mesh, each against the oracle and one
  bucket of each against its kernel's plain version, each ring's launches
  a path of the kernels line (D2); one profiled call of each ring: device
  busy, shift time and the share of it beside a kernel on another stream,
  failing on a shift on the kernels' stream or a host sync inside the ring
  (D3); ``dryrun_multichip(4)`` with its train step (D4); the scaling
  harness and the projection's quick run (D5); each port example once (D6).

- past the TPU limits the port does not enforce (phase S, after D):
  ``spmv_fn(mat, "dgt8")`` at web-Google's shape, a power-law 916428 x
  916428 matrix with about 5.1M nonzeros (S1; the JAX package refuses
  dgt8 past 294,912 columns); ``spmv_fn(mat, "span")`` at the SpMV size
  with x as one column through the one-column walk (S2);
  ``TrainableSparseLinear`` at ogbn-arxiv's shape, a power-law 169343 x
  169343 pattern with about 1.17M nonzeros and x [128, 169343], three Adam
  steps with the first step's output and both gradients held to float64
  formulas on the host (S3; the JAX package refuses in_features past
  131,072); ``measured_stream_bandwidth_gbs()`` beside the probe's stream
  (S4); the flagship ``entry()`` (S5).

- the card's own schedule gates (phase L, after S;
  ``tpusparse_torch.gates``): ``spmm`` at ogbn-arxiv's shape, K = 128, one
  dg format beside the TPU's 21 span column ranges (L1); ogbn-products'
  shape, a power-law 2449029 x 2449029 matrix with about 61.9M nonzeros:
  ``spmm`` at K = 100 against scipy's float64 product, ``spmv_fn('auto')``
  on the dg SpMV kernel beside the segment reduction, 20 PageRank
  iterations and BFS (L2); ``tune`` at the SpMV size, K = 8, on the card's
  candidate list (L3; P2 and P8 run the card's defaults in phase 6); the
  ``block_ell`` plan and ``from_block`` on the Block-ELL kernel (L4, in
  P14, P15 and T2).

Every result is checked against the host oracle; the kernels are timed
against their bound, their plain versions and cuSPARSE (the kernels line's
``ms``, ``plain_ms`` and ``library_ms`` are device times a call from the
profiler, ``time_fn_ms`` the wrapper's back-to-back time, host included),
and the tile, stripe, dg, dgt, span, radix, Block-ELL and SDDMM libraries'
SASS is read kernel by kernel: the tile kernel (#5, #6), the stripe
kernels (#10, #11) and the row walk kernel of #1, #3, #4, #7, #8 and #9
must add by float4 reductions, the one-column walk of #2 and #9 by scalar
ones, and hold no shared atomic, and the dgt, span and radix libraries
must hold no kernel but the walks; the N:M (#12), Block-ELL (#13) and
SDDMM tile (#14) kernels must run on the tensor cores (HGMMA for wgmma,
HMMA for mma.sync), and no kernel of #14 may hold an atomic.  Any failure raises and the exit code is
not 0.  It exits non-zero before printing any
result when no CUDA device is present or the package cannot be imported.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists every ported kernel as JSON, with the CUDA kernel
its wrapper launches.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
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
REPS = 5                    # back-to-back readings per yardstick, interleaved
# P9: the JAX package's default_candidates(headline, 8), all 25 rows in its
# order (tpusparse/tune.py:90-313), by family and as a digest of every
# row's describe() (tests/test_torch_slice.py holds both to the JAX list)
TUNE_K8_FAMILIES = (["dg_span"] * 3 + ["dgt_span"] * 6 + ["radix_span"] * 3 + ["brick_ell"]
                    + ["span_onehot"] * 4 + ["tile_onehot"] * 3 + ["stripe_total"] * 2
                    + ["segment_span", "nnz_segment", "bucketed"])
TUNE_K8_DIGEST = "732d834f35bea5d0"
# P4 and P16: the JAX package's lists at the headline, K = 256 (8 rows, the
# dense row last) and at the column-skewed headline, K = 8 (26 rows, the
# three hybrid_cols rows first), as digests (tests/test_torch_slice.py)
TUNE_K256_DIGEST = "9fb84dc28e3a4f01"
TUNE_COLSKEW_K8_DIGEST = "dd00bb2181d7e2a7"
# phase S: web-Google's shape (SNAP web-Google: 916,428 nodes, 5,105,039
# edges) and ogbn-arxiv's (169,343 nodes, 1,166,243 edges, 128 features),
# synthetic power laws of the same size (power_law_coo floors each row's
# length, so the averages are those that give the published counts:
# 5,104,512 and 1,166,753 nonzeros)
WEB_N, WEB_AVG, WEB_SEED = 916428, 6.155, 3
ARXIV_N, ARXIV_AVG, ARXIV_K, ARXIV_SEED = 169343, 7.592, 128, 4
# phase L2: ogbn-products' shape (2,449,029 nodes, 61,859,140 edges, 100
# features), a synthetic power law (seed 5) whose average gives about the
# published count (61.86M nonzeros)
PRODUCTS_N, PRODUCTS_AVG, PRODUCTS_K, PRODUCTS_SEED = 2449029, 25.494, 100, 5


# the CUDA kernel each wrapper launches (the kernels line's "kernel"): the
# row walks of csrc/row_walk.cuh serve #1-#4 and #7-#9 (#7's one-column
# walk: the span SpMV)
KERNEL_OF = {"dg": "walk_kernel", "dg1": "walk1_kernel", "dgt": "walk_kernel",
             "dgt_stream": "walk_kernel", "tile": "tile_stream_kernel",
             "tile_stream": "tile_stream_kernel", "span": "walk_kernel, walk1_kernel",
             "span_stream": "walk_kernel", "radix": "walk_kernel, walk1_kernel",
             "stripe": "stripe_kernel", "stripe_nested": "stripe_nested_kernel",
             "nm": "nm_kernel", "bell": "bell_wgmma_kernel, bell_tf32_kernel",
             "sddmm": "sddmm_tf32_tile_kernel, sddmm_bf16_tile_kernel, sddmm_slot_kernel",
             "dx": "dx_walk_kernel, dx_prep_kernel"}


def candidates_digest(described) -> str:
    """A digest of a candidate list's describe() dicts, in order."""
    import hashlib

    return hashlib.sha256(json.dumps(list(described), sort_keys=True).encode()).hexdigest()[:16]


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


def grad_errors(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor):
    """A gradient against its dense fp32 reference: (tests/test_sddmm.py's
    relative error, floor 1e-3; the error over the condition scale).  The
    bounds: < 3e-2 for the first, as there, and < 1e-4 for the second,
    tighter where fp32 allows it (each side sums up to 512 fp32 terms, at
    most 512 * 2^-24 = 3.1e-5 of the scale)."""
    diff = (got.double() - want.double()).abs()
    rel = float((diff / (want.double().abs() + 1e-3)).max())
    cond = float((diff / scale.double().clamp(min=1e-30)).max())
    return rel, cond


def pagerank64(mat, iters: int, damping: float = 0.85) -> np.ndarray:
    """Float64 power iteration in push orientation with the drivers' rule:
    a vertex of out-degree 0 spreads its rank uniformly."""
    import scipy.sparse as sp

    n = mat.shape[0]
    deg = np.bincount(mat.cols, minlength=n).astype(np.float64)
    w = sp.csr_matrix((1.0 / deg[mat.cols], (mat.rows, mat.cols)), shape=(n, n))
    dangling = deg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = (1.0 - damping) / n + damping * (w @ r + r[dangling].sum() / n)
    return r


@contextlib.contextmanager
def numpy_walks():
    """The packers' native walks swapped for their numpy versions (the
    plain versions the tests hold them to) inside the block."""
    from tpusparse_torch import native
    from tpusparse_torch.kernels import dg_gather as dg
    from tpusparse_torch.kernels import dgt_gather as dgt
    from tpusparse_torch.kernels import span_gather as span

    swap = {"span_pack": span.span_chunk_numpy, "span_pack_aligned": dg._aligned_chunk_numpy,
            "dgt_runs_multi": dgt.dgt_runs_multi_numpy, "dgt_runs": dgt.dgt_runs_numpy}
    saved = {k: getattr(native, k) for k in swap}
    for k, v in swap.items():
        setattr(native, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(native, k, v)


def format_on_cpu(fmt):
    """A copy of a packed format with every tensor on the CPU (its row walk
    and other derived indexes left to be built there)."""
    import dataclasses

    moved = {}
    for f in dataclasses.fields(fmt):
        v = getattr(fmt, f.name)
        if isinstance(v, torch.Tensor):
            moved[f.name] = v.cpu()
        elif f.name in ("walk", "tiles", "dx_index"):
            moved[f.name] = None
    return dataclasses.replace(fmt, **moved)


def same_format(a, b) -> None:
    """Raises unless every field of formats a (native walks) and b (numpy
    walks) is equal."""
    import dataclasses

    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "walk":
            continue
        if isinstance(va, torch.Tensor):
            if va.dtype != vb.dtype or not torch.equal(va, vb):
                raise AssertionError(f"{type(a).__name__}.{f.name} differs")
        elif isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(va, vb):
                raise AssertionError(f"{type(a).__name__}.{f.name} differs")
        elif va != vb:
            raise AssertionError(f"{type(a).__name__}.{f.name}: {va} != {vb}")


# phase D: each halo ring on config #1 (packer kwargs, builder kwargs, its
# kernel by wrapper key, the oracle tolerance of tests/test_dist.py)
RINGS_D = {
    "stripe": ("pack_halo_stripe", {"rows_per_stripe": 64}, "build_halo_spmm", {}, "stripe",
               1e-4),
    "span": ("pack_halo_span", {}, "build_halo_span_spmm", {}, "span", 1e-3),
    "radix": ("pack_halo_radix", {"rows_per_program": 1024, "S": 128, "g": 256, "kt": 8},
              "build_halo_radix_spmm", {"kt": 8}, "radix", 2e-3),
    "dg": ("pack_halo_dg", {}, "build_halo_dg_spmm", {"kt": 8}, "dg", 5e-4),
    "dgt": ("pack_halo_dgt", {"rows_per_program": 512, "g": 256, "kt": 8, "resid": True,
                              "nw": 8, "walk": "multi"},
            "build_halo_dgt_spmm", {"scatter": "select"}, "dgt", 1e-3),
}


def phase_d(mat, dev, power, kernels, zero_counts, read_counts, need, root):
    """D1-D6: the sharded stripe SpMM and the five halo rings on config #1
    over virtual ranks of the card (``["cuda:0"] * 4``; the ranks share its
    bandwidth, so no number here is a scaling figure), each against the
    oracle and one bucket of each against its kernel's plain version; one
    profiled call of each ring (its shifts off the kernels' stream, no host
    sync inside it); the dry run; the scaling harness and the projection;
    each port example once."""
    from tpusparse_torch.bench import projection, scaling
    from tpusparse_torch.bench.harness import time_fn
    from tpusparse_torch.bench.ring_profile import check_ring_overlap, ring_graph, ring_overlap
    from tpusparse_torch.dist import build_sharded_stripe_spmm, make_mesh
    from tpusparse_torch.dist import overlap as ov
    from tpusparse_torch.dist.dryrun import dryrun_multichip
    from tpusparse_torch.generator import prepare_stripe_format
    from tpusparse_torch.io.mtx import CooMatrix
    from tpusparse_torch.oracle import check_result, spmm_reference

    t_d = time.perf_counter()
    name = f"cuda:{dev.index}"
    abs_mat = CooMatrix(mat.rows, mat.cols, np.abs(np.asarray(mat.vals)), mat.shape)
    xd = {k: np.random.default_rng(0).standard_normal((N, k)).astype(np.float32)
          for k in (8, 16)}
    want = {k: spmm_reference(mat, v.astype(np.float64)) for k, v in xd.items()}
    scale = {k: spmm_reference(abs_mat, np.abs(v).astype(np.float64)) for k, v in xd.items()}

    def oracle(label, y, k, tol):
        """Y against the oracle at ``tol``, the denominator max(|Y|, 1, |A|.|x|):
        fp32 sums over config #1's hub rows (up to 4471 entries) round by up
        to 1e-4 of a Y near 1 in any order of adds (B3); the plain relative
        error is logged beside it."""
        got = y.cpu().numpy()
        assert y.is_cuda and got.shape == (M, k) and np.isfinite(got).all()
        check_result(got, want[k], rtol=tol, scale=scale[k], what=label)
        plain = float((np.abs(got - want[k]) / np.maximum(np.abs(want[k]), 1.0)).max())
        cond = float((np.abs(got - want[k]) / np.maximum(np.maximum(np.abs(want[k]), 1.0),
                                                          scale[k])).max())
        return plain, cond

    # D1: the sharded stripe SpMM on a 2 x 2 mesh of the card, K = 16
    fmt_s, _ = prepare_stripe_format(mat, work_per_stripe=1024, nnz_multiple=8, device=dev)
    fn_s, put_s = build_sharded_stripe_spmm(fmt_s, make_mesh(2, 2, [name] * 4))
    args_s = put_s(xd[16])
    zero_counts()
    y = fn_s(*args_s)
    torch.cuda.synchronize()
    read_counts("sharded_stripe_2x2")
    plain, cond = oracle("D1 sharded stripe", y, 16, 1e-4)
    log(f"[ring] D1 sharded stripe SpMM, 2 x 2 mesh of {name}, K=16: oracle ok at 1e-4 "
        f"(rel err {plain:.2e}, over |A|.|x| {cond:.2e}), "
        f"{need('sharded_stripe_2x2', 'stripe')} launches of stripe_rows_cuda, "
        f"{time_fn(lambda a: fn_s(*a), args_s) * 1e3:.4f} ms a call (time_fn)  ({power})")

    # D2: the five rings at D = 4, and four of them on a 4 x 2 mesh (K = 16)
    rings = {}
    for kind, (pack, pkw, build, bkw, which, tol) in RINGS_D.items():
        t0 = time.perf_counter()
        fmt = getattr(ov, pack)(mat, 4, device=dev, **pkw)
        t_pack = time.perf_counter() - t0
        for n_k, k in ((1, 8), (2, 16)):
            if n_k == 2 and kind == "stripe":
                continue            # the stripe ring does not shard K (JAX allow_k_shard=False)
            path = f"ring_{kind}_d4" if n_k == 1 else f"ring_{kind}_4x2"
            t0 = time.perf_counter()
            fn, put = getattr(ov, build)(fmt, make_mesh(4, n_k, [name] * (4 * n_k)), **bkw)
            args = put(xd[k])
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            zero_counts()
            y = fn(*args)
            torch.cuda.synchronize()
            read_counts(path)
            plain, cond = oracle(path, y, k, tol)
            n_l = need(path, which)
            assert n_l == 4 * n_k * 4, (path, n_l)
            ms = time_fn(lambda a, fn=fn: fn(*a), args) * 1e3
            rings[path] = (fn, args, which, n_l)
            log(f"[ring] D2 {path}: oracle ok at {tol:g} (rel err {plain:.2e}, over |A|.|x| "
                f"{cond:.2e}), {n_l} launches of {kernels[which]['name']}, pad "
                f"{fmt.padding_rate:.3f}, pack {t_pack:.2f} s, build (placing, walks) "
                f"{t_build:.2f} s, {ms:.4f} ms a call (time_fn)  ({power})")
        # one bucket (rank 0, chunk 0) against its kernel's plain version
        fn, args, which, _ = rings[f"ring_{kind}_d4"]
        run = fn.buckets[(0, dev)][0]
        x0 = args[2][0][(0, 0)]
        kl, kt = args[2][2], args[2][1]
        got = torch.zeros((run.planes[0].shape[0] * fmt.rb, x0.shape[1]), device=dev)
        run(x0, got, kt, kl)
        planes = run.planes
        vals_i = 2 if kind == "stripe" else 3
        abs_planes = tuple(p.abs() if i == vals_i else p for i, p in enumerate(planes))
        want_b = torch.zeros_like(got)
        scale_b = torch.zeros_like(got)
        plain_fn = (stripe_plain_of(fmt) if kind == "stripe" else plain_of(kind, fmt, bkw))
        want_b += plain_fn(planes, x0)
        scale_b += plain_fn(abs_planes, x0.abs())
        rel, err = rel_err(got, want_b, scale_b)
        assert rel <= 1e-5, (kind, rel)
        kernels[which]["err"] = max(kernels[which]["err"], err)
        log(f"[ring] D2 ring_{kind}_d4 bucket (rank 0, chunk 0) against "
            f"{kernels[which]['name']}'s plain version: {rel:.2e} of |A|.|x| (max abs {err:.2e})")

    log(f"[ring] D1-D2: {time.perf_counter() - t_d:.1f} s")

    # D3: one profiled call of each ring: device busy, shift time and the
    # share of it that runs beside a kernel on another stream; then the
    # same call captured into a CUDA graph and replayed, the host out of
    # the way
    t0 = time.perf_counter()
    for path, (fn, args, which, n_l) in rings.items():
        prof = ring_overlap(fn, args, expect=n_l, shifts=n_l // 4 * 3)
        check_ring_overlap(prof, path)
        log(f"[ring] D3 {path}: device busy {prof['busy_us']:.1f} us, bucket kernels "
            f"{prof['kernel_us']:.1f} us ({prof['n_kernels']}), shifts {prof['shift_us']:.1f} us "
            f"({prof['n_shifts']} copies), overlap share {prof['overlap_share']:.3f}, kernel "
            f"streams {prof['kernel_streams']}, shift streams {prof['shift_streams']}, no host "
            f"sync inside  ({power})")
        try:
            g = ring_graph(fn, args, shifts=n_l // 4 * 3)
        except Exception as e:  # noqa: BLE001 - a reading, said in the log
            log(f"[ring] D3 {path} in a CUDA graph: not measured ({type(e).__name__}: {e})")
            continue
        share = ("not measured (" + g["graph_note"] + ")" if g["graph_overlap_share"] is None
                 else f"{g['graph_overlap_share']:.3f}")
        shift = "-" if g["graph_shift_us"] is None else f"{g['graph_shift_us']:.1f}"
        log(f"[ring] D3 {path} in a CUDA graph: {g['graph_ms']:.4f} ms a replay, device busy "
            f"{g['graph_busy_us']:.1f} us, shifts {shift} us, overlap share {share}  ({power})")
    log(f"[ring] D3: {time.perf_counter() - t0:.1f} s")

    # D4: the dry run on four virtual ranks of the card, the train step included
    zero_counts()
    t0 = time.perf_counter()
    out_dr = dryrun_multichip(4, device=name)
    torch.cuda.synchronize()
    read_counts("dryrun_d4")
    for which in ("stripe", "span", "radix", "dg", "dgt", "sddmm", "dx"):
        need("dryrun_d4", which)
    log(f"[ring] D4 dryrun_multichip(4) on {name}: losses {out_dr['losses']}, "
        f"{time.perf_counter() - t0:.1f} s")

    # D5: the scaling harness (8192^2, avg 32, K = 32, D = 1, 2, 4, radix ring)
    # on virtual ranks of the card, and the projection's quick run
    t0 = time.perf_counter()
    zero_counts()
    for r in scaling.measure_scaling(device=name):
        assert "efficiency" not in r
        log(f"[scaling] {json.dumps(r)}  ({power})")
    read_counts("scaling")
    res = projection.run(quick=True, device=name, probe=False)
    for r in res["ring_bucket_ab"] + res["projection"]:
        log(f"[projection] {json.dumps(r)}  ({power})")
    log(f"[projection] T1 {res['t1_d1_ring_bucket_us']} us, single-card dgt "
        f"{res['t1_single_card_dgt_spmm_us']} us, shift in a CUDA graph (lower bound for "
        f"NCCL) {res['shift_us_lower_bound_for_nccl']} us, issued from Python "
        f"{res['shift_us_issued_from_python']} us  ({power})")
    log(f"[ring] D5: {time.perf_counter() - t0:.1f} s")

    # D6: each port example once on the card, the six processes started together
    home = tempfile.mkdtemp(prefix="examples_home_", dir=os.path.join(root, "tpusparse_torch",
                                                                       "_build"))
    env = dict(os.environ, HOME=home)
    t0 = time.perf_counter()
    procs = {p: subprocess.Popen([sys.executable, os.path.join(root, "examples", p)], cwd=root,
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
             for p in sorted(os.listdir(os.path.join(root, "examples")))
             if p.startswith("torch_0") and p.endswith(".py")}
    assert len(procs) == 6, sorted(procs)
    for p, proc in procs.items():
        out_p, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"examples/{p} exited {proc.returncode}: {out_p[-3000:]}")
        log(f"[example] {p}: exit 0; {out_p.strip().splitlines()[-1][:160]}")
    log(f"[example] six examples on the card in {time.perf_counter() - t0:.1f} s (together)")
    log(f"[ring] phase D: {time.perf_counter() - t_d:.1f} s  ({power})")


def plain_of(kind, fmt, bkw):
    """The plain version of a window ring's bucket kernel: (planes, x) ->
    y_rows."""
    from tpusparse_torch.kernels import dg_gather as dg
    from tpusparse_torch.kernels import dgt_gather as dgt
    from tpusparse_torch.kernels import radix_gather as radix
    from tpusparse_torch.kernels import span_gather as span

    if kind == "dgt":
        return lambda planes, x: dgt.dgt_rows_plain(*planes, x, rb=fmt.rb, kt=fmt.kt,
                                                    mode=fmt.mode, resid=fmt.resid)
    plain = {"span": span.span_rows_plain, "radix": radix.radix_rows_plain,
             "dg": dg.dg_rows_plain}[kind]
    return lambda planes, x: plain(*planes, x, rb=fmt.rb, kt=bkw.get("kt", 8), mode="fp32x2")


def stripe_plain_of(fmt):
    from tpusparse_torch.kernels import stripe_gather as stripe

    return lambda planes, x: stripe.stripe_rows_plain(*planes[:3], x, rb=fmt.rb)


CARD_MS_PROFILER = "device, profiler"


def card_ms(fn, x, graph=False):
    """(ms, how) for one call of ``fn(x)`` on the card: the profiler's
    device time (``device_time_fn``), else (with ``graph``, for a call
    that never waits for the card) a CUDA graph's replay of 20 calls, else
    ``time_fn``'s back-to-back reading, host included."""
    from tpusparse_torch.bench.harness import device_time_fn, graph_time_fn, time_fn

    try:
        return device_time_fn(fn, x) * 1e3, CARD_MS_PROFILER
    except RuntimeError:
        pass
    if graph:
        try:
            return graph_time_fn(fn, x) * 1e3, "device, a CUDA graph's replay"
        except Exception:  # noqa: BLE001 - the reading that stands in is named
            pass
    return time_fn(fn, x) * 1e3, "time_fn, back to back, host included"


def phase_s(big, xv, ref_v, stream_gbs, dev, power, kernels, zero_counts, read_counts, need):
    """S1-S5: the paths past the TPU limits the port no longer enforces, at
    the published sizes: the dgt8 SpMV at web-Google's shape (S1), the span
    SpMV with x as one column at the SpMV workload's size (S2),
    ``TrainableSparseLinear`` at ogbn-arxiv's shape for three steps (S3),
    ``measured_stream_bandwidth_gbs`` beside the probe's stream (S4) and
    the flagship ``entry()`` (S5).  Each kernel launch of a path is held
    against its plain version at 1e-5 of |A|.|x|; every time carries the
    card's name and power limit.  Returns the calls for phase 8's
    profile, {label: (fn, x, calls)}, and S1's and S2's products for
    phase 7's yardsticks, {"s1"/"s2": (format, A, x, whole call, pack
    seconds)}."""
    import scipy.sparse as sp

    from tpusparse_torch.bench import measured_stream_bandwidth_gbs
    from tpusparse_torch.bench.harness import time_fn
    from tpusparse_torch.bench.microbench import PROBE_BOUNDS
    from tpusparse_torch import entry
    from tpusparse_torch.io import builder
    from tpusparse_torch.kernels import dg_gather as dg
    from tpusparse_torch.kernels import dgt_gather as dgt
    from tpusparse_torch.kernels import row_walk
    from tpusparse_torch.kernels import sddmm as sd
    from tpusparse_torch.kernels import span_gather as span
    from tpusparse_torch.nn import TrainableSparseLinear
    from tpusparse_torch.oracle import check_result, spmm_reference
    from tpusparse_torch.spmv import spmv_fn

    t_s = time.perf_counter()

    def vs_plain(which, label, got, want, scale):
        rel, err = rel_err(got, want, scale)
        log(f"[s] {kernels[which]['name']} at {label}: {rel:.2e} of |A|.|x| against its plain "
            f"version (tol 1e-5), max abs err {err:.2e}")
        if not rel <= 1e-5:
            raise AssertionError(f"{kernels[which]['name']} at {label} disagrees with its plain "
                                 f"version: {rel:.3e}")
        kernels[which]["err"] = max(kernels[which]["err"], err)

    def spmv_path(path, which, make, a, x, want, tag):
        """Makes an SpMV entry point's fn and calls it once with the counts
        at 0; Y against the oracle at 2e-3; returns (fn, pack seconds)."""
        zero_counts()
        t0 = time.perf_counter()
        fn = make()
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        y = fn(x)
        torch.cuda.synchronize()
        read_counts(path)
        assert y.is_cuda and tuple(y.shape) == (a.shape[0],) and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), want, rtol=2e-3)
        log(f"[{tag}] {path}: {a.shape[0]}x{a.shape[1]}, nnz {a.nnz}: oracle ok at rtol 2e-3, "
            f"{need(path, which)} launch(es) of {kernels[which]['name']}, making the fn "
            f"{t_pack:.2f} s (packing included)")
        return fn, t_pack

    # S1: the dgt8 SpMV at web-Google's shape (SNAP: 916,428 nodes, 5,105,039
    # edges), synthetic: past the JAX package's 294,912-column gate
    t0 = time.perf_counter()
    web = builder.power_law_coo(WEB_N, WEB_N, avg_nnz_per_row=WEB_AVG, seed=WEB_SEED)
    xw = np.random.default_rng(5).standard_normal(WEB_N).astype(np.float32)
    want_w = spmm_reference(web, xw.astype(np.float64))
    log(f"[s1] web-Google shape: {WEB_N}x{WEB_N}, nnz {web.nnz}, power law seed {WEB_SEED}; "
        f"made with its oracle in {time.perf_counter() - t0:.1f} s")
    fn_w, pack_w = spmv_path("spmv_dgt8_webgoogle", "dgt", lambda: spmv_fn(web, "dgt8"), web,
                             xw, want_w, "s1")
    f = fn_w.format
    walk = dgt.dgt_row_walk(f)
    xwd = torch.as_tensor(xw, device=dev)
    xp = dg.pad_dense_cols(xwd.view(-1, 1), f.kt).contiguous()
    args = (f.wins, f.cols, f.lrw, f.vals, f.nc_p)
    kw = dict(rb=f.rb, kt=f.kt, mode=f.mode, resid=f.resid)
    kern = functools.partial(dgt.dgt_rows_cuda, *args, walk=walk, k=1, **kw)
    plain = functools.partial(dgt.dgt_rows_plain, *args, **kw)
    vs_plain("dgt", "S1 web-Google dgt8", kern(xp), plain(xp),
             dgt.dgt_rows_plain(f.wins, f.cols, f.lrw, f.vals.abs(), f.nc_p, xp.abs(), **kw))
    log(f"[s1] dgt8 format: rb={f.rb} P={f.n_programs} NC={f.n_chunks} G={f.chunk_g} "
        f"pad={f.padding_rate:.3f} {f.memory_bytes / 2**20:.1f} MiB, pack {pack_w:.2f} s; row "
        f"walk {walk.n_slots} live slots, {walk.runs} row runs, {walk.nbytes / 2**20:.1f} MiB, "
        f"built in {walk.build_seconds * 1e3:.1f} ms")
    profiles = {"S1 web-Google dgt8 SpMV, spmv_fn('dgt8') (#3)": (fn_w, xwd, 10)}
    sticks = {"s1": (f, web, xw, fn_w, pack_w)}
    del f, walk, kern, plain, xp

    # S2: the span SpMV at the SpMV workload's size, x as one column through
    # the one-column walk (timed in phase 7 beside the launch at x widened
    # to 8 columns, the JAX package's 8-sublane rule)
    fn_v, pack_v = spmv_path("spmv_span_262k", "span", lambda: spmv_fn(big, "span"), big, xv,
                             ref_v, "s2")
    f = fn_v.format
    walk = span.span_row_walk(f)
    xvd = torch.as_tensor(xv, device=dev)
    x1 = xvd.view(-1, 1).contiguous()
    args = (f.c0, f.cols, f.lrow, f.vals, f.nc_p)
    kern = functools.partial(span.span_rows_cuda, *args, rb=f.rb, kt=1, mode="fp32x2",
                             walk=walk)
    plain = functools.partial(span.span_rows_plain, *args, rb=f.rb, kt=1, mode="fp32x2")
    scale = span.span_rows_plain(f.c0, f.cols, f.lrow, f.vals.abs(), f.nc_p, x1.abs(),
                                 rb=f.rb, kt=1, mode="fp32")
    vs_plain("span", "S2 SpMV 262144^2, one column", kern(x1), plain(x1), scale)
    vs_plain("span", "S2 SpMV 262144^2, one column, against walk_rows_plain", kern(x1),
             row_walk.walk_rows_plain(walk, f.vals, x1), scale)
    spw, wpb, steps = row_walk.WALK1_GEOMETRY
    info = span.span_walk1_info("fp32x2")
    log(f"[s2] span format: rb={f.rb} ct={f.ct} g={f.chunk_g} P={f.n_programs} "
        f"NC={f.n_chunks} pad={f.padding_rate:.3f} {f.memory_bytes / 2**20:.1f} MiB, pack "
        f"{pack_v:.2f} s; one-column walk: {spw} slots a warp, {wpb} warps a block, {steps} "
        f"steps, {max(-(-walk.n_slots // (spw * wpb)), 1)} blocks; {info['registers']} "
        f"registers, {info['spill_bytes']} spill bytes, {info['blocks_per_sm']} blocks an SM; "
        f"{walk.runs} row runs for {walk.n_slots} live slots")
    profiles["S2 SpMV 262144^2, spmv_fn('span') (#7, x as one column)"] = (fn_v, xvd, 10)
    sticks["s2"] = (f, big, xv, fn_v, pack_v)
    del f, walk, kern, plain, scale

    # S3: TrainableSparseLinear at ogbn-arxiv's shape (169,343 nodes,
    # 1,166,243 edges, 128 features): three Adam steps, the first checked
    # against float64 formulas on the host
    t0 = time.perf_counter()
    arx = builder.power_law_coo(ARXIV_N, ARXIV_N, avg_nnz_per_row=ARXIV_AVG, seed=ARXIV_SEED)
    layer = TrainableSparseLinear(arx, device=dev)   # rb 512, ct 512, g 128, fp32x2
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    f = layer.fmt
    mask = torch.from_numpy(sd.occupancy_mask(f)).to(dev)
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((ARXIV_K, ARXIV_N)).astype(np.float32), device=dev)
    tgt = torch.as_tensor(rng.standard_normal((ARXIV_K, ARXIV_N)).astype(np.float32),
                          device=dev)
    log(f"[s3] TrainableSparseLinear(power law {ARXIV_N}x{ARXIV_N}, nnz {arx.nnz}, seed "
        f"{ARXIV_SEED}, bias): planes (P, NC, G) = ({f.n_programs}, {f.n_chunks}, "
        f"{f.chunk_g}), pad {f.padding_rate:.3f}, {f.memory_bytes / 2**20:.1f} MiB, made in "
        f"{t_make:.2f} s; x [{ARXIV_K}, {ARXIV_N}]: K = {ARXIV_K}")
    # #7 on the masked plane the layer hands it, #14 and #15 at the layer's
    # format and K, each against its plain version
    kt = sd._k_tile(ARXIV_K, None)
    gen = torch.Generator(device=dev).manual_seed(7)
    xr = torch.randn((ARXIV_N, ARXIV_K), generator=gen, device=dev)
    dyr = torch.randn((f.n_programs * f.rb, ARXIV_K), generator=gen, device=dev)
    planes = (f.c0, f.cols, f.lrow)
    plane = (layer.vals.detach() * mask).contiguous()
    kw = dict(rb=f.rb, kt=kt, mode="fp32x2")
    vs_plain("span", "S3 forward",
             span.span_rows_cuda(*planes, plane, f.nc_p, xr, walk=span.span_row_walk(f),
                                 k=ARXIV_K, **kw),
             span.span_rows_plain(*planes, plane, f.nc_p, xr, **kw),
             span.span_rows_plain(*planes, plane.abs(), f.nc_p, xr.abs(), **kw))
    vs_plain("sddmm", "S3 value gradient",
             sd.sddmm_rows_cuda(*planes, f.nc_p, dyr, xr, tiles=sd.sddmm_tiles(f), **kw),
             sd.sddmm_rows_plain(*planes, f.nc_p, dyr, xr, **kw),
             sd.sddmm_rows_plain(*planes, f.nc_p, dyr.abs(), xr.abs(), **kw))
    vs_plain("dx", "S3 transpose apply",
             sd.dx_rows_cuda(*planes, plane, f.nc_p, dyr, n=ARXIV_N, index=sd.dx_index(f), **kw),
             sd.dx_rows_plain(*planes, plane, f.nc_p, dyr, n=ARXIV_N, **kw),
             sd.dx_rows_plain(*planes, plane.abs(), f.nc_p, dyr.abs(), n=ARXIV_N, **kw))
    del xr, dyr
    torch.cuda.empty_cache()

    a64 = sp.csr_matrix((arx.vals.astype(np.float64), (arx.rows, arx.cols)), shape=arx.shape)
    opt = torch.optim.Adam(layer.parameters(), lr=1e-2)
    losses = []
    zero_counts()
    for step in range(3):
        xg = x.detach().requires_grad_(True)
        opt.zero_grad(set_to_none=True)
        y = layer(xg)
        y.retain_grad()
        loss = 0.5 * ((y - tgt) ** 2).sum()
        loss.backward()
        if step == 0:  # the output and both gradients against float64 formulas
            xt = x.T.double().cpu().numpy()                     # X [N, K]
            dyt = y.grad.T.double().cpu().numpy()               # dY [N, K]
            want = {"y (span forward)": a64 @ xt,
                    "x.grad (transpose apply)": a64.T @ dyt}
            want_dv = np.empty(arx.nnz)
            for lo in range(0, arx.nnz, 1 << 17):               # sum_k dY[r,k] X[c,k]
                hi = min(lo + (1 << 17), arx.nnz)
                want_dv[lo:hi] = np.einsum("ik,ik->i", dyt[arx.rows[lo:hi]],
                                           xt[arx.cols[lo:hi]])
            got = {"y (span forward)": y.detach().T.double().cpu().numpy(),
                   "x.grad (transpose apply)": xg.grad.T.double().cpu().numpy()}
            rel = np.abs(got["y (span forward)"] - want["y (span forward)"]).max() / max(
                np.abs(want["y (span forward)"]).max(), 1.0)
            log(f"[s3] step 0 y against scipy A.X in float64: {rel:.2e} of max(|Y|, 1) "
                f"(< 1e-3)")
            if not rel < 1e-3:
                raise AssertionError(f"S3 y off scipy's: {rel:.3e}")
            got_dv = sd.packed_to_nz(f, layer.vals.grad).double().cpu().numpy()
            for name, g_, w_ in (("vals.grad (SDDMM)", got_dv, want_dv),
                                 ("x.grad (transpose apply)", got["x.grad (transpose apply)"],
                                  want["x.grad (transpose apply)"])):
                rel = float((np.abs(g_ - w_) / (np.abs(w_) + 1e-3)).max())
                log(f"[s3] step 0 {name} against float64 on the host: rel err {rel:.2e} "
                    f"(< 3e-2, floor 1e-3)")
                if not rel < 3e-2:
                    raise AssertionError(f"S3 {name} off its float64 reference: {rel:.3e}")
            del xt, dyt, want, want_dv, got, got_dv
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    read_counts("trainable_arxiv")
    for which in ("span", "sddmm", "dx"):
        if need("trainable_arxiv", which) != 3:
            raise AssertionError(f"S3: 3 steps launched {which} "
                                 f"{kernels[which]['paths']['trainable_arxiv']} times")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"S3: the loss did not fall: {losses}")

    def step_fn(xb):
        xs = xb.detach().requires_grad_(True)
        opt.zero_grad(set_to_none=True)
        loss = 0.5 * ((layer(xs) - tgt) ** 2).sum()
        loss.backward()
        opt.step()
        return loss.detach()

    ms, how = card_ms(step_fn, x)
    log(f"[s3] 3 Adam steps (lr 1e-2, half the squared error against a fixed target): loss "
        f"{losses[0]:.1f} -> {losses[-1]:.1f}; a launch each of span_rows_cuda, "
        f"sddmm_rows_cuda and dx_rows_cuda a step; a step {ms:.4f} ms ({how}), "
        f"{time_fn(step_fn, x, iters=5) * 1e3:.4f} ms by time_fn  ({power})")
    profiles["S3 TrainableSparseLinear step, ogbn-arxiv shape, K = 128"] = (step_fn, x, 5)
    del y, xg, a64, plane
    torch.cuda.empty_cache()

    # S4: the JAX package's stream reading beside the probe's
    gbs = measured_stream_bandwidth_gbs()
    lo, hi = PROBE_BOUNDS["stream_gbs"]
    log(f"[s4] measured_stream_bandwidth_gbs() {gbs:.1f} GB/s (x * 1.0000001 over 1 GiB, "
        f"time_fn), session_probe's stream_gbs {stream_gbs:.1f}; bounds [{lo}, {hi}]  "
        f"({power})")
    if not lo <= gbs <= hi:
        raise AssertionError(f"measured_stream_bandwidth_gbs {gbs} outside [{lo}, {hi}]")

    # S5: the flagship entry() on the card
    zero_counts()
    fn_e, (x_e,) = entry()
    y = fn_e(x_e)
    torch.cuda.synchronize()
    read_counts("entry")
    assert y.is_cuda and tuple(y.shape) == (512, 16) and bool(torch.isfinite(y).all())
    check_result(y.cpu().numpy(), spmm_reference(fn_e.matrix, x_e.cpu().double().numpy()),
                 rtol=2e-3)
    log(f"[s5] entry(): Y {tuple(y.shape)} against the oracle ok at rtol 2e-3, "
        f"{need('entry', 'dgt')} launch of dgt_rows_cuda, {time_fn(fn_e, x_e) * 1e3:.4f} ms a "
        f"call (time_fn)  ({power})")
    log(f"[s] phase S: {time.perf_counter() - t_s:.1f} s  ({power})")
    return profiles, sticks


def scipy_product(a, x64):
    """A . X in float64 by scipy's CSR product (the host reference of phase L:
    the oracle's np.add.at would hold nnz x K float64 products at once); A
    a CooMatrix or a scipy matrix already made from one."""
    import scipy.sparse as sp

    if not sp.issparse(a):
        a = sp.csr_matrix((np.asarray(a.vals, np.float64), (a.rows, a.cols)), shape=a.shape)
    return a @ x64


def phase_l(big, xb8, dev, power, kernels, zero_counts, read_counts, need, fmt_vs_plain,
            run_tune, gate_calls):
    """L1-L3: the card's own gates (``tpusparse_torch.gates.CARD_GATES``)
    where the TPU's (``TPU_GATES``) part from them, each beside the TPU's
    decision in the same run: ``spmm`` at ogbn-arxiv's shape, K = 128, one
    dg format against the TPU's 21 span column ranges (L1); ogbn-products'
    shape (2,449,029 nodes, 61,859,140 edges, 100 features): ``spmm`` at K =
    100, ``spmv_fn('auto')`` on the dg SpMV kernel (#2) beside the segment
    route, 20 PageRank iterations on #2 and BFS (L2); ``tune`` at the SpMV
    workload, K = 8, its table (L3; P2 and P8 run the card's defaults in
    phase 6, L4 the Block-ELL kernel in P14-P15 and T2; ``gate_calls``,
    their (tag, label, fn, x, A, K), are timed here).  Every time carries
    the card's name and power limit.  Returns the calls for phase 8's
    profile, {label: (fn, x, calls)}."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    import tpusparse_torch
    from tpusparse_torch import graph
    from tpusparse_torch.bench.baselines import csr_spmm_fn
    from tpusparse_torch.bench.harness import time_fn
    from tpusparse_torch.bench.sol import csr_bound_ms
    from tpusparse_torch.gates import TPU_GATES
    from tpusparse_torch.io import builder
    from tpusparse_torch.oracle import check_result
    from tpusparse_torch.schedule import build_plan, default_schedule
    from tpusparse_torch.spmv import spmv_fn

    t_l = time.perf_counter()
    profiles = {}

    def times(tag, label, fn, x, a, k):
        """The whole call by time_fn and its device time, one line."""
        ms_dev, how = card_ms(fn, x, graph=True)
        ms = time_fn(fn, x) * 1e3
        log(f"[{tag}] {label}: whole call {ms:.4f} ms by time_fn, {ms_dev:.4f} ms ({how}), "
            f"{2.0 * a.nnz * k / (ms * 1e-3) / 1e9:.1f} GF/s  ({power})")
        return ms, ms_dev

    def path(name, which, fn, x, want, rtol=2e-3):
        """One call with the counts at 0 just before and read just after; Y
        against the float64 product; returns (Y, launches of ``which``)."""
        zero_counts()
        y = fn(x)
        torch.cuda.synchronize()
        read_counts(name)
        assert y.is_cuda and tuple(y.shape) == want.shape and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), want, rtol=rtol)
        return y, need(name, which)

    for tag, label, fn, x, a, k in gate_calls:   # P2, P8 and P14's decisions
        times(tag, label, fn, x, a, k)

    # L1: ogbn-arxiv's shape at K = 128 (S3's matrix): the card's default
    # is one dg format, the TPU's splits X into 21 column ranges of span
    arx = builder.power_law_coo(ARXIV_N, ARXIV_N, avg_nnz_per_row=ARXIV_AVG, seed=ARXIV_SEED)
    x64 = np.random.default_rng(11).standard_normal((ARXIV_N, ARXIV_K))
    want = scipy_product(arx, x64)
    xa = torch.as_tensor(x64, dtype=torch.float32, device=dev)
    card = default_schedule(arx, ARXIV_K)
    tpu = default_schedule(arx, ARXIV_K, gates=TPU_GATES)
    assert (card.family, card.ktile) == ("dg_span", 32), card
    assert (tpu.family, tpu.col_split) == ("span_colsplit", 21), tpu
    _, n_card = path("spmm_arxiv_k128", "dg", lambda v: tpusparse_torch.spmm(arx, v), xa, want)
    _, n_tpu = path("spmm_arxiv_k128_tpu", "span",
                    lambda v: tpusparse_torch.spmm(arx, v, gates=TPU_GATES), xa, want)
    assert (n_card, n_tpu) == (1, 21), (n_card, n_tpu)
    t0 = time.perf_counter()
    plan_c = build_plan(arx, card)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_t = build_plan(arx, tpu, gates=TPU_GATES)
    t_tpu = time.perf_counter() - t0
    f = plan_c.formats[0]
    log(f"[l1] ogbn-arxiv shape {ARXIV_N}^2, nnz {arx.nnz}, K={ARXIV_K}: the card's default "
        f"dg_span rb={f.rb} ns={f.ns} g={f.chunk_g} kt={f.kt} pad {f.padding_rate:.3f}, "
        f"{f.memory_bytes / 2**20:.1f} MiB, pack {t_card:.2f} s: {n_card} launch of "
        f"dg_rows_cuda a call; the TPU's span_colsplit(21): pad {plan_t.meta['padding_rate']:.3f}"
        f", {sum(g.memory_bytes for g in plan_t.formats) / 2**20:.1f} MiB, pack {t_tpu:.2f} s, "
        f"{n_tpu} launches of span_rows_cuda a call; both against scipy's float64 A.X at 2e-3")
    fmt_vs_plain("L1 ogbn-arxiv K=128", f, ARXIV_K)
    fmt_vs_plain("L1 ogbn-arxiv, the TPU's first range", plan_t.formats[0], ARXIV_K)
    times("l1", "the card's default (dg_span)", plan_c.fn, xa, arx, ARXIV_K)
    times("l1", "the TPU's decision (span_colsplit(21))", plan_t.fn, xa, arx, ARXIV_K)
    csr = csr_spmm_fn(arx, device=dev)
    times("l1", "cuSPARSE (torch.sparse.mm of CSR)", csr, xa, arx, ARXIV_K)
    bound, by = csr_bound_ms(arx.nnz, ARXIV_N, ARXIV_N, ARXIV_K)
    log(f"[l1] the CSR bound {bound:.4f} ms ({by})")
    profiles["L1 ogbn-arxiv K=128, the card's default (dg_span)"] = (plan_c.fn, xa, 10)
    profiles["L1 ogbn-arxiv K=128, the TPU's decision (span_colsplit(21))"] = (plan_t.fn, xa, 5)
    del plan_t, csr, want, x64

    # L2: ogbn-products' shape (2,449,029 nodes, 61,859,140 edges, 100
    # features), a synthetic power law whose average gives the published
    # count; past the JAX package's 1,572,864-column gate of the SpMV and
    # graph drivers
    t0 = time.perf_counter()
    prod = builder.power_law_coo(PRODUCTS_N, PRODUCTS_N, avg_nnz_per_row=PRODUCTS_AVG,
                                 seed=PRODUCTS_SEED)
    n, k = PRODUCTS_N, PRODUCTS_K
    log(f"[l2] ogbn-products shape {n}^2: nnz {prod.nnz} (published 61,859,140), made in "
        f"{time.perf_counter() - t0:.1f} s; host COO {prod.nnz * 24 / 2**30:.2f} GiB; on the "
        f"card X and Y {n * k * 4 / 2**30:.2f} GiB each, the row walk "
        f"{prod.nnz * 16 / 2**30:.2f} GiB")
    rng = np.random.default_rng(12)
    xp_host = rng.standard_normal((n, k), dtype=np.float32)
    xp = torch.as_tensor(xp_host, device=dev)
    t0 = time.perf_counter()
    prod_csr = sp.csr_matrix((np.asarray(prod.vals, np.float64), (prod.rows, prod.cols)),
                             shape=prod.shape)
    want = scipy_product(prod_csr, xp_host.astype(np.float64))
    t_ref = time.perf_counter() - t0
    sched_p = default_schedule(prod, k)
    assert (sched_p.family, sched_p.ktile) == ("dg_span", 32), sched_p
    t0 = time.perf_counter()
    plan_p = build_plan(prod, sched_p)
    t_pack = time.perf_counter() - t0
    _, n_l = path("spmm_products_k100", "dg", plan_p.fn, xp, want)
    fp = plan_p.formats[0]
    log(f"[l2] spmm K={k}, the card's default dg_span rb={fp.rb} ns={fp.ns} g={fp.chunk_g} "
        f"kt={fp.kt} pad {fp.padding_rate:.3f}, {fp.memory_bytes / 2**30:.2f} GiB, pack "
        f"{t_pack:.1f} s: {n_l} launch of dg_rows_cuda, every row at all {k} columns within "
        f"2e-3 of scipy's float64 A.X ({t_ref:.1f} s on the host)")
    times("l2", f"spmm K={k}, the card's default (dg_span)", plan_p.fn, xp, prod, k)
    csr = csr_spmm_fn(prod, device=dev)
    times("l2", f"spmm K={k}, cuSPARSE", csr, xp, prod, k)
    bound, by = csr_bound_ms(prod.nnz, n, n, k)
    log(f"[l2] the CSR bound at K={k}: {bound:.4f} ms ({by}); the TPU's decision "
        f"({default_schedule(prod, k, gates=TPU_GATES).family}, "
        f"{default_schedule(prod, k, gates=TPU_GATES).col_split} ranges) not run: its span "
        "formats pad past the card's memory at this density")
    profiles[f"L2 ogbn-products spmm K={k}, the card's default (dg_span)"] = (plan_p.fn, xp, 5)
    del csr, want, xp_host

    # the SpMV: 'auto' takes the dg SpMV kernel (#2) at any N on the card;
    # the TPU's 'auto' takes the segment reduction past 1,572,864 columns
    xv_host = rng.standard_normal(n).astype(np.float32)
    xv = torch.as_tensor(xv_host, device=dev)
    want_v = scipy_product(prod_csr, xv_host.astype(np.float64))
    del prod_csr
    t0 = time.perf_counter()
    fn_auto = spmv_fn(prod, "auto")
    t_pack = time.perf_counter() - t0
    _, n_l = path("spmv_auto_products", "dg1", fn_auto, xv, want_v)
    assert n_l == 1
    fmt_vs_plain("L2 ogbn-products spmv_fn('auto')", fn_auto.format, 1)
    fa = fn_auto.format
    log(f"[l2] spmv_fn('auto'): dg kt=1 rb={fa.rb} ns={fa.ns} g={fa.chunk_g} pad "
        f"{fa.padding_rate:.3f}, pack {t_pack:.1f} s: {n_l} launch of dg1_rows_cuda, oracle "
        "ok at 2e-3")
    fn_seg = spmv_fn(prod, "segment")
    check_result(fn_seg(xv).cpu().numpy(), want_v, rtol=2e-3)
    times("l2", "spmv_fn('auto') (#2)", fn_auto, xv, prod, 1)
    times("l2", "spmv_fn('segment') (index_add_, the TPU's 'auto' here)", fn_seg, xv, prod, 1)
    csr_v = csr_spmm_fn(prod, device=dev)
    times("l2", "SpMV by cuSPARSE", lambda v: csr_v(v[:, None])[:, 0], xv, prod, 1)
    bound, by = csr_bound_ms(prod.nnz, n, n, 1)
    log(f"[l2] the SpMV CSR bound {bound:.4f} ms ({by})")
    profiles["L2 ogbn-products spmv_fn('auto') (#2)"] = (fn_auto, xv, 10)
    profiles["L2 ogbn-products spmv_fn('segment')"] = (fn_seg, xv, 10)
    del csr_v, want_v

    # PageRank, 20 iterations, one launch of #2 each, against float64; BFS
    # against scipy's csgraph on A^T (push orientation)
    t0 = time.perf_counter()
    pr_run = graph.pagerank_fn(prod, tol=0.0, max_iter=20)
    t_pack = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    r_pr, it_pr = pr_run()
    torch.cuda.synchronize()
    t_pr = time.perf_counter() - t0
    read_counts("graph_pagerank_products")
    assert it_pr == 20 and need("graph_pagerank_products", "dg1") == 20
    assert pr_run.matvec.meta["method"] == "dg"
    l1 = float(np.abs(r_pr.cpu().double().numpy() - pagerank64(prod, 20)).sum())
    if not l1 <= 1e-5:
        raise AssertionError(f"L2 PageRank: L1 distance {l1:.3e} to float64 > 1e-5")
    log(f"[l2] pagerank_fn(tol=0, max_iter=20): {it_pr} iterations in {t_pr:.3f} s (the row "
        f"walk built; plan packed in {t_pack:.1f} s), 20 launches of dg1_rows_cuda; L1 "
        f"distance to a float64 power iteration {l1:.2e} (<= 1e-5)  ({power})")
    del pr_run, r_pr
    t0 = time.perf_counter()
    bfs_run = graph.bfs_fn(prod, max_iter=32)
    t_pack = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    level, it_bfs = bfs_run(0)
    torch.cuda.synchronize()
    t_bfs = time.perf_counter() - t0
    read_counts("graph_bfs_products")
    assert need("graph_bfs_products", "dg1") == it_bfs
    at_csr = sp.csr_matrix((np.ones(prod.nnz), (prod.cols, prod.rows)), shape=(n, n))
    dist = csgraph.shortest_path(at_csr, unweighted=True, indices=0)
    want_level = np.where(dist <= 32, dist, -1).astype(np.int32)
    if not np.array_equal(level.cpu().numpy(), want_level):
        raise AssertionError("L2 BFS levels differ from scipy's shortest_path")
    log(f"[l2] bfs_fn(max_iter=32) from 0: {it_bfs} levels in {t_bfs:.3f} s (packed in "
        f"{t_pack:.1f} s), {int((want_level >= 0).sum())} vertices reached; levels equal "
        f"scipy's unweighted shortest_path on A^T; {it_bfs} launches of dg1_rows_cuda  "
        f"({power})")
    del bfs_run, at_csr, dist, prod
    torch.cuda.empty_cache()

    # L3: tune at the SpMV workload, K = 8, under the card's record: the dg,
    # dgt and radix rows the TPU's gates cut, span_onehot for span_colsplit,
    # brick_ell; its table (P2 and P8 run the card's defaults in phase 6)
    t0 = time.perf_counter()
    res, best_of = run_tune("tune_p2_k8", xb8, a=big)
    for which in ("dg", "dgt", "radix", "span"):
        need("tune_p2_k8", which)
    b = res.best_schedule
    log(f"[l3] tune at 262144^2, K=8: {len(res.table)} rows in {time.perf_counter() - t0:.1f} "
        f"s, winner {b.family} {res.best_seconds * 1e3:.4f} ms by the tuner's time_fn  "
        f"({power})")
    del res, best_of
    log(f"[l] phase L: {time.perf_counter() - t_l:.1f} s  ({power})")
    return profiles


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tpusparse_torch
        from tpusparse_torch.bench.harness import gflops, time_fn
        # the published peaks and the CSR floor of the kernels line's bound,
        # one with bench/sol.py's table
        from tpusparse_torch.bench.sol import (BF16_TC_FLOPS_PER_S, FP32_FLOPS_PER_S,
                                               HBM_BYTES_PER_S)
        from tpusparse_torch.bench.sol import csr_bound_ms as bound_ms
        from tpusparse_torch.format import pack_tile
        from tpusparse_torch.gates import TPU_GATES
        from tpusparse_torch.generator import build_stripe_plan, prepare_stripe_format
        from tpusparse_torch.io import builder
        from tpusparse_torch.batched import batched_spmm
        from tpusparse_torch.io.mtx import CooMatrix
        from tpusparse_torch.kernels import block_ell as be
        from tpusparse_torch.kernels import build
        from tpusparse_torch.kernels import dg_gather as dg
        from tpusparse_torch.kernels import dgt_gather as dgt
        from tpusparse_torch.kernels import nm_structured as nm
        from tpusparse_torch.kernels import radix_gather as radix
        from tpusparse_torch.kernels import row_walk
        from tpusparse_torch.kernels import sddmm as sd
        from tpusparse_torch.kernels import span_gather as span
        from tpusparse_torch.kernels import stripe_gather as stripe
        from tpusparse_torch.kernels import tile_onehot as tile
        from tpusparse_torch.meta.set import create_init_metadata_set
        from tpusparse_torch.kernels.common import matmul_f32
        from tpusparse_torch.nn import SparseLinear, TrainableSparseLinear
        from tpusparse_torch.oracle import check_result, spmm_reference
        from tpusparse_torch.schedule import Schedule, build_plan, default_schedule
        from tpusparse_torch.spmv import spmv_fn, spmv_multi_fn
        from tpusparse_torch.tune import default_candidates, tune
    except ImportError as e:
        print(f"chip_smoke: cannot import tpusparse_torch ({e}); run it from the repo root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dg_src, dgt_src = "tpusparse_torch/csrc/dg_gather.cu", "tpusparse_torch/csrc/dgt_gather.cu"
    tile_src, span_src = ("tpusparse_torch/csrc/tile_onehot.cu",
                          "tpusparse_torch/csrc/span_gather.cu")
    radix_src, stripe_src = ("tpusparse_torch/csrc/radix_gather.cu",
                             "tpusparse_torch/csrc/stripe_gather.cu")
    nm_src, bell_src = ("tpusparse_torch/csrc/nm_structured.cu",
                        "tpusparse_torch/csrc/block_ell.cu")
    sddmm_src = "tpusparse_torch/csrc/sddmm.cu"
    kernels = {  # the ported kernels, by their wrapper
        "dg": {"wrapper": dg.dg_rows_cuda, "name": "dg_rows_cuda", "source": dg_src,
               "replaces": "tpusparse/kernels/dg_gather.py:318", "err": 0.0},
        "dg1": {"wrapper": dg.dg1_rows_cuda, "name": "dg1_rows_cuda", "source": dg_src,
                "replaces": "tpusparse/kernels/dg_gather.py:382", "err": 0.0},
        "dgt": {"wrapper": dgt.dgt_rows_cuda, "name": "dgt_rows_cuda", "source": dgt_src,
                "replaces": "tpusparse/kernels/dgt_gather.py:667", "err": 0.0},
        "dgt_stream": {"wrapper": dgt.dgt_stream_rows_cuda, "name": "dgt_stream_rows_cuda",
                       "source": dgt_src, "replaces": "tpusparse/kernels/dgt_gather.py:882",
                       "err": 0.0},  # the row walk kernel of #3, over the same walk
        "tile": {"wrapper": tile.tile_rows_cuda, "plain": tile.tile_rows_plain,
                 "name": "tile_rows_cuda", "source": tile_src,
                 "replaces": "tpusparse/kernels/tile_onehot.py:44", "err": 0.0},
        "tile_stream": {"wrapper": tile.tile_stream_rows_cuda,
                        "plain": tile.tile_stream_rows_plain, "name": "tile_stream_rows_cuda",
                        "source": tile_src, "replaces": "tpusparse/kernels/tile_onehot.py:119",
                        "err": 0.0},
        "span": {"wrapper": span.span_rows_cuda, "plain": span.span_rows_plain,
                 "name": "span_rows_cuda", "source": span_src,
                 "replaces": "tpusparse/kernels/span_gather.py:270", "err": 0.0},
        "span_stream": {"wrapper": span.span_stream_rows_cuda,
                        "plain": span.span_stream_rows_plain, "name": "span_stream_rows_cuda",
                        "source": span_src, "replaces": "tpusparse/kernels/span_gather.py:329",
                        "err": 0.0},
        "radix": {"wrapper": radix.radix_rows_cuda, "plain": radix.radix_rows_plain,
                  "name": "radix_rows_cuda", "source": radix_src,
                  "replaces": "tpusparse/kernels/radix_gather.py:441", "err": 0.0},
        "stripe": {"wrapper": stripe.stripe_rows_cuda, "plain": stripe.stripe_rows_plain,
                   "name": "stripe_rows_cuda", "source": stripe_src,
                   "replaces": "tpusparse/kernels/stripe_gather.py:35", "err": 0.0},
        "stripe_nested": {"wrapper": stripe.stripe_nested_rows_cuda,
                          "plain": stripe.stripe_nested_rows_plain,
                          "name": "stripe_nested_rows_cuda", "source": stripe_src,
                          "replaces": "tpusparse/kernels/stripe_gather.py:156", "err": 0.0},
        "nm": {"wrapper": nm.nm_rows_cuda, "plain": nm.nm_rows_plain, "name": "nm_rows_cuda",
               "source": nm_src, "replaces": "tpusparse/kernels/nm_structured.py:160",
               "err": 0.0},
        "bell": {"wrapper": be.bell_rows_cuda, "plain": be.bell_rows_plain,
                 "name": "bell_rows_cuda", "source": bell_src,
                 "replaces": "tpusparse/kernels/block_ell.py:136", "err": 0.0},
        "sddmm": {"wrapper": sd.sddmm_rows_cuda, "plain": sd.sddmm_rows_plain,
                  "name": "sddmm_rows_cuda", "source": sddmm_src,
                  "replaces": "tpusparse/kernels/sddmm.py:72", "err": 0.0},
        "dx": {"wrapper": sd.dx_rows_cuda, "plain": sd.dx_rows_plain, "name": "dx_rows_cuda",
               "source": sddmm_src, "replaces": "tpusparse/kernels/sddmm.py:167", "err": 0.0},
    }

    # ---- 1. device
    dev = torch.device("cuda", 0)
    device_kind = torch.cuda.get_device_name(0)
    power = power_line()
    log(f"[device] {device_kind} x{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {power}")
    # fp32 products stay fp32 (the JAX package's Precision.HIGHEST); the
    # package sets no global flag, so the defaults must hold
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"

    # ---- 2. build (every source, nvcc processes started together)
    info = build.build()
    for name, rec in info.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "error", "warning")):
                log(f"[build]   {line.strip()}")

    # what the redesigned kernels compiled to, function by function: tensor-core
    # wgmma (HGMMA bf16, IGMMA int8) and mma (HMMA, 3xTF32 and bf16) in the
    # N:M, Block-ELL and SDDMM libraries; the atomics of the tile, stripe, dg,
    # dgt, span and radix libraries, where the stream kernels of #5/#6, #10
    # and #11 and the row walk kernel of #1, #3, #4, #7, #8 and #9 must add
    # by vector reductions (REDG...F32x4), the one-column walk of #2, #7 and
    # #9 by scalar ones (RED...F32), and no kernel may hold a shared atomic
    # (ATOMS: a CAS loop for fp32 adds)
    functions = {}  # every kernel function of a library, by library

    def sass_by_kernel(lib_name, opcodes):
        sass = subprocess.run([os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                            "bin", "cuobjdump"), "-sass",
                               str(build.library_path(lib_name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        found, fn = {}, "?"
        for line in sass.splitlines():  # "/*0090*/  @P0 HMMA.16816.F32.BF16 R4, ... ;"
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                functions.setdefault(lib_name, set()).add(fn)
                continue
            words = line.split("*/", 1)[-1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0].startswith(opcodes):
                ops = found.setdefault(fn, {})
                ops[words[0]] = ops.get(words[0], 0) + 1
        return found

    def kernel_family(mangled, names):
        return next((n for n in names if n in mangled), "other")

    sass_ops = {}
    for lib_name, opcodes, names in (
            ("nm_structured", ("HGMMA", "HMMA"), ("nm_kernel",)),
            ("block_ell", ("HGMMA", "IGMMA", "HMMA", "RED", "ATOM"),
             ("bell_wgmma_kernel", "bell_tf32_kernel")),
            ("tile_onehot", ("ATOMS", "ATOMG", "ATOM.", "RED"), ("tile_stream_kernel",)),
            ("stripe_gather", ("ATOMS", "ATOMG", "ATOM.", "RED"),
             ("stripe_nested_kernel", "stripe_kernel")),
            ("dg_gather", ("ATOMS", "ATOMG", "ATOM.", "RED"), ("walk1_kernel", "walk_kernel")),
            ("dgt_gather", ("ATOMS", "ATOMG", "ATOM.", "RED"), ("walk_kernel",)),
            ("span_gather", ("ATOMS", "ATOMG", "ATOM.", "RED"),
             ("walk1_kernel", "walk_kernel")),
            ("radix_gather", ("ATOMS", "ATOMG", "ATOM.", "RED"),
             ("walk1_kernel", "walk_kernel")),
            ("sddmm", ("HGMMA", "HMMA", "ATOMS", "ATOMG", "ATOM.", "RED", "UBLKCP"),
             ("sddmm_tf32_tile_kernel", "sddmm_bf16_tile_kernel", "sddmm_slot_kernel",
              "dx_walk_kernel", "dx_prep_kernel"))):
        by_family = {}
        for fn, ops in sass_by_kernel(lib_name, opcodes).items():
            fam = by_family.setdefault(kernel_family(fn, names), {})
            for op, n in ops.items():
                fam[op] = fam.get(op, 0) + n
        sass_ops[lib_name] = by_family
        for fam, ops in sorted(by_family.items()):
            log(f"[build] {lib_name} SASS, {fam}: " + ", ".join(
                f"{op} x{n}" for op, n in sorted(ops.items())))
    nm_ops = sass_ops["nm_structured"].get("nm_kernel", {})
    if not all(any(op.startswith(c) for op in nm_ops) for c in ("HGMMA", "HMMA")):
        raise AssertionError("the N:M library lacks its tensor-core wgmma or mma")
    bell_ops = sass_ops["block_ell"]
    for fam, ops in (("bell_wgmma_kernel", ("HGMMA", "IGMMA")), ("bell_tf32_kernel", ("HMMA",))):
        if not all(any(op.startswith(c) for op in bell_ops.get(fam, {})) for c in ops):
            raise AssertionError(f"the Block-ELL library's {fam} lacks {ops}: {bell_ops}")
    for lib_name, fam in (("tile_onehot", "tile_stream_kernel"),
                          ("stripe_gather", "stripe_kernel"),
                          ("stripe_gather", "stripe_nested_kernel"),
                          ("dg_gather", "walk_kernel"), ("dgt_gather", "walk_kernel"),
                          ("span_gather", "walk_kernel"), ("radix_gather", "walk_kernel")):
        ops = sass_ops[lib_name].get(fam, {})
        cas = sum(n for op, n in ops.items() if op.startswith("ATOMS"))
        log(f"[build] {fam} ({lib_name}): {cas} ATOMS.CAS / shared atomic sites, "
            f"{sum(n for op, n in ops.items() if 'F32x4' in op)} float4 reduction sites")
        if cas or not any("F32x4" in op for op in ops):
            raise AssertionError(f"{fam}: shared atomics, or no float4 reduction: {ops}")
    # the one-column walk of #2, #7 and #9 adds each row run by one scalar
    # reduction
    for lib_name in ("dg_gather", "span_gather", "radix_gather"):
        ops = sass_ops[lib_name].get("walk1_kernel", {})
        cas = sum(n for op, n in ops.items() if op.startswith("ATOMS"))
        red = sum(n for op, n in ops.items() if op.startswith("RED") and "ADD.F32" in op)
        log(f"[build] walk1_kernel ({lib_name}): {cas} ATOMS.CAS / shared atomic sites, {red} "
            f"scalar fp32 reduction sites")
        if cas or not red:
            raise AssertionError(f"walk1_kernel ({lib_name}): shared atomics, or no fp32 "
                                 f"reduction: {ops}")
    # #4 and #8 launch the walk kernel of #3 and #7, #7 and #9 the two walks:
    # the dgt, span and radix libraries hold nothing else
    for lib_name in ("dgt_gather", "span_gather", "radix_gather"):
        fns = functions.get(lib_name, set())
        walks = all("walk_kernel" in f or "walk1_kernel" in f for f in fns)
        log(f"[build] {lib_name} kernels: {len(fns)}, all row walks: {walks}")
        if not fns or not walks:
            raise AssertionError(f"the {lib_name} library holds a kernel other than the walks: "
                                 f"{fns}")
    # #14: the tile kernels on the tensor cores (HGMMA: 3xTF32 wgmma; HMMA:
    # bf16 mma.sync); no #14 kernel adds by an atomic (every slot is written
    # once)
    sd_ops = sass_ops["sddmm"]
    for fam, op in (("sddmm_tf32_tile_kernel", "HGMMA"), ("sddmm_bf16_tile_kernel", "HMMA")):
        n_op = sum(n for o, n in sd_ops.get(fam, {}).items() if o.startswith(op))
        log(f"[build] {fam}: {n_op} {op} sites")
        if not n_op:
            raise AssertionError(f"{fam} lacks {op}: {sd_ops}")
    # #15: the column walk stages by bulk copies (UBLKCP, the TMA); no
    # kernel of sddmm.cu adds by an atomic (#14 writes each slot once, #15
    # each row of dX once)
    n_op = sum(n for o, n in sd_ops.get("dx_walk_kernel", {}).items() if o.startswith("UBLKCP"))
    log(f"[build] dx_walk_kernel: {n_op} UBLKCP (bulk copy) sites")
    if not n_op:
        raise AssertionError(f"dx_walk_kernel lacks its bulk copies: {sd_ops}")
    atomics = {fam: ops for fam, ops in sd_ops.items() if any(
        o.startswith(("ATOM", "RED")) for o in ops)}
    if atomics:
        raise AssertionError(f"an SDDMM kernel adds by atomics: {atomics}")

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
            walk = dg.dg_row_walk(fmt)
            got = dg.dg1_rows_cuda(*args, x, rb=fmt.rb, walk=walk)
            want = dg.dg1_rows_plain(*args, x, rb=fmt.rb)
            scale = dg.dg1_rows_plain(*abs_args, x.abs(), rb=fmt.rb)
            which = "dg1"
        else:
            x = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
            walk = dg.dg_row_walk(fmt)
            got = dg.dg_rows_cuda(*args, x, rb=fmt.rb, kt=kt, mode=mode, walk=walk, k=k)
            want = dg.dg_rows_plain(*args, x, rb=fmt.rb, kt=kt, mode=mode)
            scale = dg.dg_rows_plain(*abs_args, x.abs(), rb=fmt.rb, kt=kt, mode="fp32x2")
            which = "dg"
        branch = walk1_branch(walk) if kt == 1 else walk_branch(walk, k)
        check_vs_plain(which, label, f"kt={kt} {mode} K={k} rb={fmt.rb}, {branch}",
                       got, want, scale, tol)

    def walk_branch(walk, k):
        """How the row walk kernel (#1, #3, #4, #7, #8) runs a walk at K = k."""
        kc, pw, bs = row_walk.walk_geometry(k)
        return (f"row walk: {kc} columns in panels of {pw}, {bs} slots a block, "
                f"{walk.runs} row runs for {walk.n_slots} live slots")

    def walk1_branch(walk):
        """How the one-column walk kernel (#2) runs a walk: geometry,
        resources, row runs, the walk's bytes and build."""
        spw, wpb, steps = row_walk.WALK1_GEOMETRY
        info = dg.dg_walk1_info()
        return (f"one-column walk: {spw} slots a warp, {wpb} warps a block, {steps} steps "
                f"of 32 slots at once, {max(-(-walk.n_slots // (spw * wpb)), 1)} blocks; "
                f"{info['registers']} registers, {info['spill_bytes']} spill bytes, "
                f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks an SM; "
                f"{walk.runs} row runs for {walk.n_slots} live slots; row walk "
                f"{walk.nbytes / 2**20:.1f} MiB, built in {walk.build_seconds * 1e3:.1f} ms")

    def walk_line(which, label, walk, k, mode="fp32x2"):
        """The [kernel] line of the row walk kernel (#1, #3, #4, #7 or #8) on a
        walk at K = k: geometry, resources, row runs, the walk's bytes and
        build."""
        kc, pw, bs = row_walk.walk_geometry(k)
        info = {"dg": dg.dg_walk_info, "dgt": dgt.dgt_walk_info,
                "dgt_stream": dgt.dgt_walk_info, "span": span.span_walk_info,
                "span_stream": span.span_walk_info}[which](pw, mode)
        order = torch.argsort(walk.slot)  # the same slots in the format's own order
        by_slot = walk.row[order]
        slot_runs = int((by_slot[1:] != by_slot[:-1]).sum()) + int(walk.n_slots > 0)
        log(f"[kernel] {kernels[which]['name']} at {label}, K={k} {mode}: one walk, {kc} "
            f"columns in {-(-kc // pw)} panel(s) of {pw}, {bs} slots a block, "
            f"{max(-(-walk.n_slots // bs), 1)} blocks; {info['registers']} registers, "
            f"{info['spill_bytes']} spill bytes, {info['shared_bytes']} shared bytes, "
            f"{info['blocks_per_sm']} blocks an SM; {walk.runs} row runs for {walk.n_slots} "
            f"live slots ({walk.n_slots / max(walk.runs, 1):.1f} a run; {slot_runs} runs in "
            f"the format's slot order), each summed in registers and added by float4 "
            f"atomicAdd; row walk {walk.nbytes / 2**20:.1f} MiB, built in "
            f"{walk.build_seconds * 1e3:.1f} ms (the format's planes "
            f"{walk.plane_slots * 12 / 2**20:.1f} MiB)")

    def dgt_vs_plain(label, fmt, k, tol, stream=False):
        x = rand_x(fmt.shape[1], k)
        x = dg.pad_dense_cols(x, -(-k // fmt.kt) * fmt.kt).contiguous()
        args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p)
        abs_args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals.abs(), fmt.nc_p)
        kw = dict(rb=fmt.rb, kt=fmt.kt, mode=fmt.mode)
        walk = dgt.dgt_row_walk(fmt)  # one walk per format, both wrappers
        if stream:
            got = dgt.dgt_stream_rows_cuda(*args, x, nw=fmt.nw, walk=walk, k=k, **kw)
            want = dgt.dgt_stream_rows_plain(*args, x, nw=fmt.nw, **kw)
        else:
            got = dgt.dgt_rows_cuda(*args, x, resid=fmt.resid, walk=walk, k=k, **kw)
            want = dgt.dgt_rows_plain(*args, x, resid=fmt.resid, **kw)
        scale = dgt.dgt_rows_plain(*abs_args, x.abs(), resid=fmt.resid, **kw)
        branch = walk_branch(walk, k)
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
        vs_plain(label, fmt_g, 32, 32, "fp32x2", tol)      # rb 2048 (256 KB a K-tile before)
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
        dgt_vs_plain(label, pack(rb=2048, kt=32), 32, tol)                # rb 2048
    log(f"[kernel] dgt checks (packing included): {time.perf_counter() - t0:.1f} s")

    def win_vs_plain(which, label, fmt, k, mode, vals=None):
        """A tile or span kernel (``which``) against its plain version on
        ``fmt`` at K = k (X padded to the kernel's K-tile)."""
        is_tile, stream = which.startswith("tile"), which.endswith("_stream")
        kt = tile.choose_kt(min(tile.default_ktile(k), 32))
        x = dg.pad_dense_cols(rand_x(fmt.shape[1], k), -(-k // kt) * kt).contiguous()
        start = fmt.chunk_tile if is_tile else fmt.c0
        v = fmt.vals.float() if vals is None else vals
        kw = dict(rb=fmt.rb, kt=kt, **(dict(ct=fmt.ct) if is_tile or stream else {}))
        plain = kernels[which]["plain"]
        walk_kw = {} if is_tile else dict(walk=span.span_row_walk(fmt), k=k)
        got = kernels[which]["wrapper"](start, fmt.cols, fmt.lrow, v, fmt.nc_p, x, mode=mode,
                                        **kw, **walk_kw)
        want = plain(start, fmt.cols, fmt.lrow, v, fmt.nc_p, x, mode=mode, **kw)
        scale = plain(start, fmt.cols, fmt.lrow, v.abs(), fmt.nc_p, x.abs(), mode="fp32", **kw)
        if is_tile:  # #5 and #6: one kernel, the format walked once per panel
            pw, cpb = tile.stream_geometry(x.shape[1], fmt.chunk_g)
            branch = f"panel {pw} x{-(-x.shape[1] // pw)}, {cpb} chunk(s) a block"
        else:  # #7 and #8: the row walk, one per format for both wrappers
            branch = walk_branch(walk_kw["walk"], k)
            assert fmt.walk is walk_kw["walk"]
        check_vs_plain(which, label,
                       f"kt={kt} {mode} K={k} rb={fmt.rb} ct={fmt.ct} g={fmt.chunk_g} "
                       f"P={fmt.cols.shape[0]} NC={fmt.n_chunks} pad={fmt.padding_rate:.3f}"
                       + (" vals plane" if vals is not None else "") + f", {branch}",
                       got, want, scale, tol)

    t0 = time.perf_counter()
    for label, m_ in (("small", small), ("headline", mat)):
        head = label == "headline"
        ms_ = create_init_metadata_set(m_)
        rb_t, ct_t, g_t = (1024, 1024, 512) if head else (128, 128, 64)
        ftile = pack_tile(ms_, 0, out_rows=m_.shape[0], rb=rb_t, ct=ct_t, g=g_t, device=dev)
        for mode, k in (("fp32x2", 8), ("fp32", 32), ("bf16", 16), ("fp32x2", 5),
                        ("fp32x2", 100), ("fp32x2", 256), ("fp32x2", 1), ("fp32x2", 2),
                        ("fp32x2", 37), ("fp32x2", 520)):
            win_vs_plain("tile", label, ftile, k, mode)
        for mode, k in (("fp32x2", 256), ("bf16", 8), ("fp32", 5), ("fp32x2", 100)):
            win_vs_plain("tile_stream", label, ftile, k, mode)
        ftile_g = pack_tile(ms_, 0, out_rows=m_.shape[0], rb=2048, ct=ct_t, g=g_t, device=dev)
        win_vs_plain("tile", label, ftile_g, 32, "fp32x2")          # rb 2048
        win_vs_plain("tile_stream", label, ftile_g, 32, "fp32x2")
        rb_s, ct_s, g_s = (512, 1024, 512) if head else (64, 128, 32)
        fspan = span.pack_span(m_, rb=rb_s, ct=ct_s, g=g_s, keep_perm=True, device=dev)
        for mode, k in (("fp32x2", 8), ("fp32", 32), ("bf16", 16), ("fp32x2", 5),
                        ("fp32x2", 100), ("fp32x2", 256)):
            win_vs_plain("span", label, fspan, k, mode)
        for mode, k in (("fp32x2", 8), ("bf16", 32), ("fp32", 5), ("fp32x2", 256)):
            win_vs_plain("span_stream", label, fspan, k, mode)
        new_vals = np.random.default_rng(5).standard_normal(m_.nnz).astype(np.float32)
        plane = span.with_values(fspan, new_vals).vals                  # the vals= override
        win_vs_plain("span", label, fspan, 8, "fp32x2", vals=plane)
        win_vs_plain("span_stream", label, fspan, 8, "fp32x2", vals=plane)
        fspan_g = span.pack_span(m_, rb=2048, ct=ct_s, g=g_s, device=dev)
        win_vs_plain("span", label, fspan_g, 32, "fp32x2")            # rb 2048
        win_vs_plain("span_stream", label, fspan_g, 32, "fp32x2")
        fspan_w = span.pack_span(m_, rb=1024 if head else 128, ct=4096, g=g_s, device=dev)
        win_vs_plain("span_stream", label, fspan_w, 100, "fp32")      # ct 4096, K 100
    log(f"[kernel] tile and span checks (packing included): {time.perf_counter() - t0:.1f} s")

    def radix_branch(walk, kp, mode):
        """How the radix wrapper (#9) runs its walk for X of kp columns:
        the one-column walk or the walk kernel's geometry, resources, row
        runs, the longest run against a block's share, the walk's bytes
        and build."""
        info = radix.radix_walk_info(kp, mode)
        longest = (int(torch.unique_consecutive(walk.row, return_counts=True)[1].max())
                   if walk.n_slots else 0)
        if kp == 1:
            spw, wpb, steps = row_walk.WALK1_GEOMETRY
            geo, share = f"one-column walk ({spw} slots a warp, {wpb} warps a block)", spw * wpb
        else:
            kc, pw, share = row_walk.walk_geometry(kp)
            geo = f"walk kernel ({kc} columns in panels of {pw}, {share} slots a block)"
        return (f"{geo}; {info['registers']} registers, {info['spill_bytes']} spill bytes, "
                f"{info['blocks_per_sm']} blocks an SM; {walk.runs} row runs for "
                f"{walk.n_slots} live slots, the longest {longest} (a block's share {share}); "
                f"row walk {walk.nbytes / 2**20:.1f} MiB, built in "
                f"{walk.build_seconds * 1e3:.1f} ms"), longest, share

    def radix_vs_plain(label, fmt, k, kt=None):
        """The radix kernel against its plain version on ``fmt`` at K = k,
        X padded to kt (the format's unless given), over the format's row
        walk; returns the longest row run and a block's share."""
        kt = fmt.kt if kt is None else kt
        x = dg.pad_dense_cols(rand_x(fmt.shape[1], k), -(-k // kt) * kt).contiguous()
        args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        kw = dict(rb=fmt.rb, kt=kt, mode=fmt.mode)
        walk = radix.radix_row_walk(fmt)
        got = radix.radix_rows_cuda(*args, x, **kw, walk=walk, k=k)
        want = radix.radix_rows_plain(*args, x, **kw)
        scale = radix.radix_rows_plain(fmt.c0, fmt.cols, fmt.lrow, fmt.vals.abs(), fmt.nc_p,
                                       x.abs(), **dict(kw, mode="fp32x2"))
        branch, longest, share = radix_branch(walk, x.shape[1], fmt.mode)
        check_vs_plain("radix", label,
                       f"kt={kt} {fmt.mode} K={k} rb={fmt.rb} S={fmt.S} g={fmt.chunk_g} "
                       f"P={fmt.n_programs} NC={fmt.n_chunks} pad={fmt.padding_rate:.3f}, "
                       f"{branch}", got, want, scale, tol)
        return longest, share

    def stripe_vs_plain(label, fmt, k):
        """A stripe kernel against its plain version on a stripe, nested
        stripe or segment format at K = k (X padded to the K-tile)."""
        which = "stripe_nested" if hasattr(fmt, "wnz") else "stripe"
        kt = stripe.choose_kt(k)
        x = dg.pad_dense_cols(rand_x(fmt.shape[1], k), -(-k // kt) * kt).contiguous()
        rb = getattr(fmt, "max_rows_per_stripe", None) or fmt.max_segments
        extra = (fmt.wnz, fmt.wrow) if which == "stripe_nested" else ()
        kw = {} if which == "stripe_nested" else dict(live=fmt.live_p)
        got = kernels[which]["wrapper"](fmt.cols, fmt.lrow, fmt.vals, *extra, x, rb=rb, kt=kt,
                                        **kw)
        want = kernels[which]["plain"](fmt.cols, fmt.lrow, fmt.vals, *extra, x, rb=rb)
        scale = kernels[which]["plain"](fmt.cols, fmt.lrow, fmt.vals.abs(), *extra, x.abs(), rb=rb)
        # blocks of slots, one walk per panel
        if which == "stripe_nested":
            kp4, pw = stripe.nested_geometry(x.shape[1])
            ranges = stripe.nested_slot_ranges(fmt.wnz.cpu(), fmt.stripe_nnz)
        else:
            kp4, pw, bs = stripe.stripe_geometry(x.shape[1])
            ranges = stripe.stripe_slot_ranges(fmt.live_p.cpu(), fmt.cols.shape[2], bs)
        branch = (f"panel {pw} x{-(-kp4 // pw)}, {int((ranges[..., 1] > ranges[..., 0]).sum())}"
                  f" of {ranges.shape[0] * ranges.shape[1]} blocks hold slots")
        check_vs_plain(which, label,
                       f"{type(fmt).__name__} kt={kt} K={k} vals {fmt.vals.dtype} rb={rb} "
                       f"P={fmt.cols.shape[0]} C={fmt.cols.shape[2]} "
                       f"pad={fmt.padding_rate:.3f}, {branch}", got, want, scale, tol)

    t0 = time.perf_counter()
    for label, m_ in (("small", small), ("headline", mat)):
        head = label == "headline"
        for kt in (1, 2, 4, 8):
            for mode in ("fp32x2", "bf16"):
                fr = radix.pack_radix(m_, rb=1024 if head else 128, S=128,
                                      g=1024 if head else 256, kt=kt, mode=mode, device=dev)
                longest, share = radix_vs_plain(label, fr, kt)
                # config #1's longest row (4471 slots) runs past a block's share
                if head and not longest > share:
                    raise AssertionError(f"radix at K={kt}: no row past a block's share")
                if (kt, mode) == (4, "fp32x2"):
                    radix_vs_plain(label, fr, 3)              # K = 3 padded to the tile
                    radix_vs_plain(label, fr, 8)              # two K-tiles of 4, one walk
                    radix_vs_plain(label, fr, 4, kt=8)        # the same X at KT = 8
        fr = radix.pack_radix(m_, rb=2048, S=128, g=512, kt=32, device=dev)
        radix_vs_plain(label, fr, 32)                         # rb 2048 at KT = 32
        for work, vd in ((512, None), (2048, None), (2048, "bfloat16")):
            fs, _ = prepare_stripe_format(m_, work_per_stripe=work, val_dtype=vd, device=dev)
            for k in (1, 4, 8, 40):
                stripe_vs_plain(label, fs, k)
        for sched, ks in ((Schedule(family="stripe_nested", work_per_block=4096, unroll=8),
                           (1, 2, 5, 8, 32, 37, 256, 520)),
                          (Schedule(family="nnz_segment", work_per_block=2048, unroll=8),
                           (1, 8, 32))):
            for k in ks:
                stripe_vs_plain(label, build_plan(m_, sched).formats[0], k)
    log(f"[kernel] radix and stripe checks (packing included): {time.perf_counter() - t0:.1f} s")

    def fmt_geometry(f) -> str:
        kind = type(f).__name__
        if kind in ("StripeFormat", "NestedStripeFormat", "SegmentFormat"):
            rb = getattr(f, "max_rows_per_stripe", None) or f.max_segments
            return (f"{kind} P={f.cols.shape[0]} C={f.cols.shape[2]} rb={rb}"
                    + (f" W={f.n_warps}" if kind == "NestedStripeFormat" else "")
                    + f" pad={f.padding_rate:.3f}")
        geo = {"DgFormat": lambda: f"ns={f.ns}",
               "DgtFormat": lambda: f"nw={f.nw} resid={f.resid}",
               "RadixFormat": lambda: f"S={f.S} kt={f.kt} {f.mode}"}.get(
                   kind, lambda: f"ct={f.ct}")()
        return (f"{kind} rb={f.rb} {geo} g={f.chunk_g} P={f.cols.shape[0]} NC={f.n_chunks} "
                f"pad={f.padding_rate:.3f}")

    def fmt_vs_plain(label, fmt, k):
        """Whichever kernel runs ``fmt``, against its plain version at K = k."""
        kind = type(fmt).__name__
        if kind == "DgFormat":
            vs_plain(label, fmt, k, fmt.kt, fmt.mode, tol)
        elif kind == "DgtFormat":
            dgt_vs_plain(label, fmt, k, tol)
        elif kind == "RadixFormat":
            radix_vs_plain(label, fmt, k)
        elif kind in ("StripeFormat", "NestedStripeFormat", "SegmentFormat"):
            stripe_vs_plain(label, fmt, k)
        else:  # span, segment-span and tile formats, resident
            win_vs_plain("tile" if kind == "TileFormat" else "span", label, fmt, k, "fp32x2")

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

    def run_entry(path, which, make, x, want, shape, tag="path"):
        """Makes an entry point's fn (packing included) and calls it once,
        with every launch count set to 0 just before and read just after;
        checks the result against the oracle."""
        zero_counts()
        t0 = time.perf_counter()
        fn = make()
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        read_counts(path)
        assert y.is_cuda and tuple(y.shape) == shape and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), want, rtol=2e-3)
        n_l = need(path, which)
        log(f"[{tag}] {path}: oracle ok at rtol 2e-3, {n_l} launch(es) of "
            f"{kernels[which]['name']}, making the fn {t_pack:.2f} s (packing included), "
            f"first call {t_call:.3f} s")
        return fn, t_pack

    for rec in kernels.values():
        rec["paths"] = {}
    # the calls whose gate decisions phase L times (the profiler is first
    # used after phase D: D3 needs every record of its ring calls)
    gate_calls = []
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

    # P1: the default schedule at K > 128 is tile_onehot, on the stream
    # kernel (X is 16 MB in the TPU's layout, past its 6 MB gate)
    xs[256] = np.random.default_rng(0).standard_normal((N, 256)).astype(np.float32)
    ref_h256 = spmm_reference(mat, xs[256].astype(np.float64))
    zero_counts()
    t0 = time.perf_counter()
    y = tpusparse_torch.spmm(mat, xs[256])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    read_counts("spmm_k256")
    sched256 = default_schedule(mat, 256)
    assert sched256.family == "tile_onehot"
    assert y.is_cuda and y.shape == (M, 256) and bool(torch.isfinite(y).all())
    check_result(y.cpu().numpy(), ref_h256, rtol=2e-3)
    n_l = need("spmm_k256", "tile_stream")
    t0 = time.perf_counter()
    plan256 = build_plan(mat, sched256)
    t_pack256 = time.perf_counter() - t0
    f256 = plan256.formats[0]
    log(f"[spmm] K=256: tile_onehot rb={f256.rb} ct={f256.ct} g={f256.chunk_g} "
        f"P={f256.n_programs} NC={f256.n_chunks} pad={f256.padding_rate:.3f} "
        f"{f256.memory_bytes / 2**20:.1f} MiB, pack {t_pack256:.2f} s: oracle ok at rtol 2e-3, "
        f"{n_l} launch(es) of tile_stream_rows_cuda, first call {dt:.2f} s (packing included)")
    win_vs_plain("tile_stream", "headline", f256, 256, "fp32x2")    # the path's own format
    runs256, live256 = tile.row_runs(f256)
    pw256, cpb256 = tile.stream_geometry(256, f256.chunk_g)
    info = tile.tile_stream_info(pw256, "fp32x2")
    log(f"[kernel] tile_stream_rows_cuda at P1: panel {pw256} (one walk), {cpb256} chunks a "
        f"block; {info['registers']} registers, {info['spill_bytes']} spill bytes, "
        f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks an SM; flush: "
        f"each row run summed in registers, added to y_rows in device memory by float4 "
        f"atomicAdd; {runs256} row runs for {live256} live slots "
        f"({live256 / max(runs256, 1):.2f} slots a run), "
        f"{f256.n_programs * f256.n_chunks * f256.chunk_g} slots in the planes")

    # P6: the resident tile kernel at K = 32 (X 4 MB in the TPU's layout)
    assert not tile.uses_stream(N, f256.ct, 32, "fp32x2")
    ref_h32 = spmm_reference(mat, xs[32].astype(np.float64))
    tile32, _ = run_entry("tile_k32", "tile",
                          lambda: functools.partial(tile.tile_spmm, f256), xs[32], ref_h32,
                          (M, 32))
    win_vs_plain("tile", "headline", f256, 32, "fp32x2")
    for k_ in (8, 32, 512):  # the resident wrapper's panels: tune rows, P6, P13's layer
        pw_, cpb_ = tile.stream_geometry(k_, f256.chunk_g)
        info = tile.tile_stream_info(pw_, "fp32x2")
        log(f"[kernel] tile_rows_cuda at K={k_}: panel {pw_} (one walk of the format, where "
            f"the K-tiles of 32 before took {-(-k_ // 32)}), {cpb_} chunks a block; "
            f"{info['registers']} registers, {info['spill_bytes']} spill bytes, "
            f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks an SM")

    # ---- 5. tune at the headline size: K = 8 (P3: dg, dgt, span and tile
    # rows) and K = 256 (P4: the tile rows)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpusparse_torch",
                         "_build", "tune_cache")

    tune_dirs = {}

    def run_tune(path, x, a=None, save=False):
        """The tune of ``path``; with ``save``, in a cache dir of its own that
        holds no cached winner, so that it saves its winner's artifact."""
        cdir = tempfile.mkdtemp(prefix=f"{path}_", dir=os.path.dirname(cache)) if save else cache
        tune_dirs[path] = cdir
        with tpusparse_torch.config_override(cache_dir=cdir):
            zero_counts()
            res_ = tune(mat if a is None else a, x, use_cache=save)
            read_counts(path)
        best_of = {}
        for row in res_.table:
            s = row["schedule"]
            fam = s["family"]
            geo = {"dg_span": f"ns={s['ns']}",
                   "dgt_span": f"nw={s['nw']} resid={s['resid']} u={s['unroll']} "
                               f"i8={s['rowhot_i8']}",
                   "radix_span": f"S={s['sublanes']}", "brick_ell": f"S={s['sublanes']}",
                   "stripe_total": f"{s['blocking']} work={s['work_per_block']}",
                   "stripe_nested": f"work={s['work_per_block']}",
                   "nnz_segment": f"work={s['work_per_block']}",
                   "segment_span": f"work={s['work_per_block']} ct={s['ct']}",
                   "bucketed": f"bounds={s['bucket_bounds']}",
                   "hybrid_cols": f"C={s['hot_cols']}", "dense": "",
                   "block_ell": f"bs={s['row_interval']}"}.get(
                       fam, f"ct={s['ct']} u={s['unroll']}")
            if not row["ok"]:
                # the padding bound and brick_ell's gate refuse rows, as the
                # JAX tuner does; anything else is a fault
                if "CandidateRejected" not in row["error"]:
                    raise AssertionError(f"tune candidate failed: {row['error']}")
                log(f"[tune] {path} {fam} rb={s['rb']} {geo} g={s['g']} kt={s['ktile']}: "
                    f"refused, {row['error']}")
                continue
            same = row.get("same_plan_as")
            log(f"[tune] {path} {fam} rb={s['rb']} {geo} g={s['g']} kt={s['ktile']} "
                f"{s['precision']}: {row['seconds'] * 1e3:.4f} ms, {row['gflops']:.2f} GF/s, "
                f"pad {row['padding_rate']:.3f}, pack {row['pack_seconds']:.2f} s, "
                f"{row['format_bytes'] / 2**20:.1f} MiB, same_plan_as "
                + (f"{same['family']} rb={same['rb']} g={same['g']} (not timed again)"
                   if same else "-") + f"  ({power})")
            if fam not in best_of or row["seconds"] < best_of[fam]["seconds"]:
                best_of[fam] = row
        b = res_.best_schedule
        log(f"[tune] {path} winner: family {b.family} rb={b.rb} g={b.g} kt={b.ktile}, "
            f"{res_.best_seconds * 1e3:.4f} ms; launches "
            + ", ".join(f"{rec['paths'][path]} {rec['name']}" for rec in kernels.values()
                        if rec["paths"][path]))
        return res_, best_of

    def plan_of(row):
        sched = Schedule(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in row["schedule"].items()})
        return build_plan(mat, sched)

    # P3 / P9: the JAX package's 25 candidates in its order (the card's
    # record gives the same list at config #1); brick_ell, which the TPU's
    # 4 MB gate refuses, and the rows the padding bound refused by their
    # packed planes run: the card's bound weighs the slots a kernel reads
    res, best_by_family = run_tune("tune_k8", xs[8], save=True)
    rows_k8 = [row["schedule"] for row in res.table]
    assert [r["family"] for r in rows_k8] == TUNE_K8_FAMILIES, [r["family"] for r in rows_k8]
    assert candidates_digest(rows_k8) == TUNE_K8_DIGEST
    assert candidates_digest(c.describe() for c in default_candidates(mat, 8)) == TUNE_K8_DIGEST
    brick_row = res.table[TUNE_K8_FAMILIES.index("brick_ell")]
    assert brick_row["ok"], brick_row
    log(f"[tune] tune_k8 brick_ell (refused by the TPU's 4 MB gate): pad "
        f"{brick_row['padding_rate']:.2f}, read {brick_row['read_rate']:.2f}, "
        f"{brick_row['seconds'] * 1e3:.4f} ms  ({power})")
    assert {"dg_span", "dgt_span", "radix_span", "span_onehot", "tile_onehot", "stripe_total",
            "nnz_segment", "bucketed"} <= set(best_by_family)
    for which in ("dg", "dgt", "span", "tile", "radix", "stripe"):
        need("tune_k8", which)
    best = res.best_schedule
    # the tuner's winner, held against its plain version at its own geometry
    # (the best row of each family follows with the yardsticks)
    win = res.best
    for wf in win.formats:
        fmt_vs_plain("headline", wf, 8)

    # P4 / P16: the JAX list at K = 256, the dense row (A as 2.1 GB of bf16,
    # densified on the card) last
    res256, best256 = run_tune("tune_k256", xs[256])
    assert candidates_digest(row["schedule"] for row in res256.table) == TUNE_K256_DIGEST
    assert "tile_onehot" in best256 and "dense" in best256
    need("tune_k256", "tile_stream")
    for wf in res256.best.formats:
        if res256.best_schedule.family == "tile_onehot":
            win_vs_plain("tile_stream", "headline", wf, 256, "fp32x2")
        else:
            fmt_vs_plain("headline", wf, 256)
    tune256_winner = (res256.best_schedule.family, res256.best_seconds)
    del res256  # a dense winner holds A's 2.1 GB
    torch.cuda.empty_cache()

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
        fn, pack_s[path] = run_entry(path, which, make, x, want, shape, tag="spmv")
        spmv_fns[path] = fn
        return fn

    # each path's kernel is then held against its plain version at the
    # path's own format
    run_path("spmv_auto_262k", "dg1", lambda: spmv_fn(big, "auto"), xv, ref_v, (SPMV_N,))
    fmt1 = spmv_fns["spmv_auto_262k"].format
    vs_plain("spmv", fmt1, 1, 1, "fp32x2", tol)
    run_path("spmv_dgt8_262k", "dgt", lambda: spmv_fn(big, "dgt8"), xv, ref_v, (SPMV_N,))
    fmt8 = spmv_fns["spmv_dgt8_262k"].format
    log(f"[spmv]   dgt8 format: rb={fmt8.rb} P={fmt8.n_programs} NC={fmt8.n_chunks} "
        f"pad={fmt8.padding_rate:.3f} {fmt8.memory_bytes / 2**20:.1f} MiB")
    dgt_vs_plain("spmv", fmt8, 1, tol)
    walk_line("dgt", "spmv dgt8", dgt.dgt_row_walk(fmt8), 1)
    multi = run_path("spmv_multi_262k", "dgt", lambda: spmv_multi_fn(big, 8), xb8, ref_b8,
                     (SPMV_N, 8))
    assert multi.n_splits == 1
    dgt_vs_plain("spmv", multi.formats[0], 8, tol)
    walk_line("dgt", "spmv_multi_fn(8)", dgt.dgt_row_walk(multi.formats[0]), 8)
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
    # K = 64 at the SpMV size: X is 64 MB, past the 50 MB L2, the regime the
    # TPU's stream variant existed for; the card's walk stages no X
    dgt_vs_plain("spmv", multi.formats[0], 64, tol, stream=True)
    assert multi.formats[0].walk is dgt.dgt_row_walk(multi.formats[0])  # one walk, both
    walk_line("dgt_stream", "spmv size, stream_x", multi.formats[0].walk, 64)

    # P2 (L3): the card's default at 262144 x 262144, K = 8 is one dg_span
    # format; the TPU's record takes span_colsplit(2) there (X is 8 MB, past
    # every dg and radix gate of its decision tree), run beside it
    sched_b8 = default_schedule(big, 8)
    assert (sched_b8.family, sched_b8.ktile) == ("dg_span", 8), sched_b8
    run_entry("spmm_262k_k8", "dg",
              lambda: functools.partial(tpusparse_torch.spmm, big), xb8, ref_b8,
              (SPMV_N, 8), tag="spmm")
    assert kernels["dg"]["paths"]["spmm_262k_k8"] == 1
    plan_b8c = build_plan(big, sched_b8)
    f_b8c = plan_b8c.formats[0]
    log(f"[spmm] 262144^2 K=8, the card's default: dg_span rb={f_b8c.rb} ns={f_b8c.ns} "
        f"g={f_b8c.chunk_g} kt={f_b8c.kt} P={f_b8c.n_programs} NC={f_b8c.n_chunks} "
        f"pad={f_b8c.padding_rate:.3f} {f_b8c.memory_bytes / 2**20:.1f} MiB")
    fmt_vs_plain("spmv", f_b8c, 8)                                  # the path's own format
    walk_line("dg", "P2, the card's default", dg.dg_row_walk(f_b8c), 8)
    sched_b8t = default_schedule(big, 8, gates=TPU_GATES)
    assert (sched_b8t.family, sched_b8t.col_split) == ("span_colsplit", 2)
    zero_counts()
    t0 = time.perf_counter()
    y = tpusparse_torch.spmm(big, xb8, gates=TPU_GATES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    read_counts("spmm_262k_k8_tpu")
    assert y.is_cuda and y.shape == (SPMV_N, 8) and bool(torch.isfinite(y).all())
    check_result(y.cpu().numpy(), ref_b8, rtol=2e-3)
    assert need("spmm_262k_k8_tpu", "span") == 2
    log(f"[spmm] 262144^2 K=8, the TPU's decision: span_colsplit(2) rb={sched_b8t.rb} "
        f"ct={sched_b8t.ct} g={sched_b8t.g}: oracle ok at rtol 2e-3, 2 launches of "
        f"span_rows_cuda, first call {dt:.2f} s (packing included)")
    plan_b8 = build_plan(big, sched_b8t, gates=TPU_GATES)
    for f, (lo, hi), t_p in zip(plan_b8.formats, plan_b8.meta["col_ranges"],
                                plan_b8.meta["pack_seconds"]):
        log(f"[spmm]   columns [{lo}, {hi}): ct={f.ct} P={f.n_programs} NC={f.n_chunks} "
            f"G={f.chunk_g} nnz={f.nnz_real} pad={f.padding_rate:.3f} "
            f"{f.memory_bytes / 2**20:.1f} MiB, pack {t_p:.2f} s")
        win_vs_plain("span", "spmv", f, 8, "fp32x2")                # the path's own formats
        win_vs_plain("span", "spmv", f, 8, "bf16")
        walk_line("span", f"P2 columns [{lo}, {hi})", span.span_row_walk(f), 8)
    xb8d = torch.as_tensor(xb8, device=dev)
    for label, fn_ in (("the card's default (dg_span)", plan_b8c.fn),
                       ("the TPU's decision (span_colsplit(2))", plan_b8.fn)):
        gate_calls.append(("l3", f"P2 262144^2 K=8, {label}", fn_, xb8d, big, 8))

    # P5: the span stream kernel, on the headline's best span tune row at
    # K = 8 and on P2's first sub-format
    best_span = plan_of(best_by_family["span_onehot"])
    f_span = best_span.formats[0]
    lo0, hi0 = plan_b8.meta["col_ranges"][0]
    f_b0 = plan_b8.formats[0]
    sub0 = CooMatrix(big.rows[big.cols < hi0], big.cols[big.cols < hi0],
                     big.vals[big.cols < hi0], (SPMV_N, hi0 - lo0))
    xb8_0 = xb8[lo0:hi0]
    ref_b8_0 = spmm_reference(sub0, xb8_0.astype(np.float64))
    sstream_h, _ = run_entry("span_stream_headline", "span_stream",
                             lambda: functools.partial(span.span_spmm, f_span, stream=True),
                             xs[8], ref_h8, (M, 8))
    sstream_b, _ = run_entry("span_stream_262k", "span_stream",
                             lambda: functools.partial(span.span_spmm, f_b0, stream=True),
                             xb8_0, ref_b8_0, (SPMV_N, 8))
    win_vs_plain("span_stream", "headline", f_span, 8, "fp32x2")
    win_vs_plain("span_stream", "spmv", f_b0, 8, "fp32x2")
    # #8 walks the same row walk as #7 on P2's sub-format, built once
    assert f_b0.walk is span.span_row_walk(f_b0)
    walk_line("span_stream", "P2's first sub-format, stream=True", f_b0.walk, 8)

    # P7, SpMV through the span kernel with x as one column, runs as S2 in
    # phase S

    # P8 (L3): the default at 262144 x 262144, K = 4 is radix_span on both
    # records: X of K = 4 padded to dg's kt of 8 is 8 MB, past the TPU's dg
    # gate, and at K = 2-4 the card keeps the TPU's radix decision, which it
    # measures faster than dg there (radix's kt of 4 moves half dg's
    # columns); dg_span at kt 8 is timed beside it
    xb4 = np.random.default_rng(4).standard_normal((SPMV_N, 4)).astype(np.float32)
    ref_b4 = spmm_reference(big, xb4.astype(np.float64))
    sched_b4 = default_schedule(big, 4)
    assert (sched_b4.family, sched_b4.ktile) == ("radix_span", 4)
    assert sched_b4 == default_schedule(big, 4, gates=TPU_GATES)
    zero_counts()
    t0 = time.perf_counter()
    y = tpusparse_torch.spmm(big, xb4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    read_counts("spmm_262k_k4")
    assert y.is_cuda and y.shape == (SPMV_N, 4) and bool(torch.isfinite(y).all())
    check_result(y.cpu().numpy(), ref_b4, rtol=2e-3)
    assert need("spmm_262k_k4", "radix") == 1
    t0 = time.perf_counter()
    plan_b4 = build_plan(big, sched_b4)
    t_pack_b4 = time.perf_counter() - t0
    f_b4 = plan_b4.formats[0]
    log(f"[spmm] 262144^2 K=4: radix_span rb={f_b4.rb} S={f_b4.S} g={f_b4.chunk_g} kt={f_b4.kt} "
        f"P={f_b4.n_programs} NC={f_b4.n_chunks} window {f_b4.window} pad={f_b4.padding_rate:.3f} "
        f"{f_b4.memory_bytes / 2**20:.1f} MiB, pack {t_pack_b4:.2f} s: oracle ok at rtol 2e-3, "
        f"1 launch of radix_rows_cuda, first call {dt:.2f} s (packing included)")
    radix_vs_plain("spmv", f_b4, 4)                        # the path's own format
    radix_vs_plain("spmv", f_b4, 4, kt=8)
    plan_b4d = build_plan(big, Schedule(family="dg_span", rb=1024, ns=8, g=512, unroll=8,
                                        ktile=8))
    check_result(plan_b4d(xb4).cpu().numpy(), ref_b4, rtol=2e-3)
    xb4d = torch.as_tensor(xb4, device=dev)
    for label, fn_ in (("the default (radix_span, on both records)", plan_b4.fn),
                       ("dg_span at kt 8", plan_b4d.fn)):
        gate_calls.append(("l3", f"P8 262144^2 K=4, {label}", fn_, xb4d, big, 4))

    def stripe_line(label, f, ks):
        """The stripe kernel's [kernel] line on format f: resources, blocks,
        live slots walked against slots stored, row runs, y_slots' zero fill."""
        runs_s, live_s = stripe.stripe_row_runs(f)
        rb_s = getattr(f, "max_rows_per_stripe", None) or f.max_segments
        stored = f.cols.numel()
        walked = int(f.live_p.sum())
        for k_ in ks:
            kp4_, pw_, bs_ = stripe.stripe_geometry(-(-k_ // stripe.choose_kt(k_))
                                                    * stripe.choose_kt(k_))
            ranges_s = stripe.stripe_slot_ranges(f.live_p.cpu(), f.cols.shape[2], bs_)
            held_s = ranges_s[..., 1] > ranges_s[..., 0]
            info = stripe.stripe_info(pw_, f.vals.dtype == torch.bfloat16)
            log(f"[kernel] stripe_rows_cuda at {label}, K={k_}: panel {pw_} x"
                f"{-(-kp4_ // pw_)}, grid {ranges_s.shape[1]} x {ranges_s.shape[0]} blocks of "
                f"{bs_} slots, {int(held_s.sum())} hold slots; "
                f"{info['registers']} registers, {info['spill_bytes']} spill bytes, "
                f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks an SM; "
                f"{walked} live slots walked of {stored} stored ({stored / max(walked, 1):.2f}x), "
                f"{live_s} nonzero, {runs_s} row runs ({live_s / max(runs_s, 1):.2f} a run); "
                f"y_slots zero fill {f.cols.shape[0] * rb_s * kp4_ * 4 / 2**20:.1f} MiB")
            if info["spill_bytes"]:
                raise AssertionError(f"stripe_kernel<{pw_}> spills: {info}")

    # P10: the stripe and segment families at the headline size, K = 8, each
    # with the tuner's parameters, and build_stripe_plan
    bucket = (max(int(8 * float(mat.row_lengths().mean())), 32),)
    p10 = {"stripe_merge_path_512": ("stripe", Schedule(family="stripe_total",
                                                        work_per_block=512, unroll=8)),
           "stripe_merge_path_2048": ("stripe", Schedule(family="stripe_total",
                                                         work_per_block=2048, unroll=8)),
           "stripe_nested": ("stripe_nested", Schedule(family="stripe_nested",
                                                       work_per_block=4096, unroll=8)),
           "nnz_segment": ("stripe", Schedule(family="nnz_segment", work_per_block=2048,
                                              unroll=8)),
           "segment_span": ("span", Schedule(family="segment_span", work_per_block=4096,
                                             ct=512, g=256, unroll=4)),
           "bucketed": ("span", Schedule(family="bucketed", bucket_bounds=bucket))}
    p10_plans, p10_pack = {}, {}
    for name, (which, sched) in p10.items():
        p10_plans[name], p10_pack[name] = run_entry(
            name, which, lambda sched=sched: build_plan(mat, sched), xs[8], ref_h8, (M, 8),
            tag="p10")
    p10_plans["build_stripe_plan"], p10_pack["build_stripe_plan"] = run_entry(
        "build_stripe_plan", "stripe", lambda: build_stripe_plan(mat), xs[8], ref_h8, (M, 8),
        tag="p10")
    for name, plan in p10_plans.items():
        for f in plan.formats:
            log(f"[p10]   {name}: {fmt_geometry(f)}, {f.memory_bytes / 2**20:.1f} MiB")
            fmt_vs_plain("headline", f, 8)
    assert kernels["span"]["paths"]["bucketed"] == p10_plans["bucketed"].meta["n_subs"] == 2
    for name in ("stripe_merge_path_512", "stripe_merge_path_2048", "nnz_segment",
                 "build_stripe_plan"):
        stripe_line(f"P10 {name}", p10_plans[name].formats[0], (8, 256))
    f_nest = p10_plans["stripe_nested"].formats[0]
    runs_n, live_n = stripe.nested_row_runs(f_nest)
    ranges_n = stripe.nested_slot_ranges(f_nest.wnz.cpu(), f_nest.stripe_nnz)
    held = ranges_n[..., 1] - ranges_n[..., 0]
    for k_ in (8, 32):
        pw_ = stripe.nested_geometry(k_)[1]
        info = stripe.stripe_nested_info(pw_)
        log(f"[kernel] stripe_nested_rows_cuda at P10, K={k_}: panel {pw_}, blocks of "
            f"{stripe.NESTED_BLOCK_SLOTS} slots: {int((held > 0).sum())} of {held.size} hold "
            f"slots (the largest stripe {int((held[held.sum(1).argmax()] > 0).sum())}); "
            f"{info['registers']} registers, {info['spill_bytes']} spill bytes, "
            f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks an SM; "
            f"{runs_n} row runs for {live_n} live slots ({live_n / max(runs_n, 1):.2f} a run), "
            f"each summed in registers and added by float4 atomicAdd")

    # P11: brick_ell (the tuner's row) on a banded matrix, whose bricks keep
    # their columns together, so the chunk blocks pass its gate
    band = builder.banded_coo(M, N, bandwidth=16, seed=3)
    ref_band = spmm_reference(band, xs[8].astype(np.float64))
    sched_be = Schedule(family="brick_ell", sort=True, rb=1024, sublanes=256, g=512, unroll=4,
                        ktile=8)
    plan_be, t_pack_be = run_entry("brick_ell_banded", "radix", lambda: build_plan(band, sched_be),
                                   xs[8], ref_band, (M, 8))
    f_be = plan_be.formats[0]
    log(f"[matrix] banded: {M}x{N}, nnz={band.nnz}, bandwidth 16 seed 3; brick_ell "
        f"{fmt_geometry(f_be)}, chunk blocks {f_be.n_chunks * f_be.chunk_g * 12 / 2**20:.2f} MB "
        f"(gate 4 MB), {f_be.memory_bytes / 2**20:.1f} MiB")
    radix_vs_plain("banded", f_be, 8)

    # P12: SpMV through the radix (kt = 1) and stripe kernels at 262144^2
    run_path("spmv_radix_262k", "radix", lambda: spmv_fn(big, "radix"), xv, ref_v, (SPMV_N,))
    f_rv = spmv_fns["spmv_radix_262k"].format
    log(f"[spmv]   radix format: {fmt_geometry(f_rv)} {f_rv.memory_bytes / 2**20:.1f} MiB")
    radix_vs_plain("spmv", f_rv, 1)
    run_path("spmv_stripe_262k", "stripe", lambda: spmv_fn(big, "stripe"), xv, ref_v, (SPMV_N,))
    f_stv = spmv_fns["spmv_stripe_262k"].format
    log(f"[spmv]   stripe format: {fmt_geometry(f_stv)} {f_stv.memory_bytes / 2**20:.1f} MiB")
    stripe_line("P12 spmv_fn('stripe'), x as one column", f_stv, (1,))
    stripe_vs_plain("spmv", f_stv, 1)
    stripe_vs_plain("spmv", f_stv, 8)

    # ---- P13-P16: the dense-tile families, the serving surface for pruned
    # weights, at a 7B-class projection's 4096 x 4096 (tpusparse/bench/
    # suite.py:301-350) and at the headline's size
    t_dense_tile = time.perf_counter()
    rng13 = np.random.default_rng(11)

    def dense_bound_check(label, y, want, scale, kind):
        """The JAX tests' bounds: fp32 1e-5 of max(|W|·|x|, 1); bf16 1e-2 of
        max |want| (tests/test_nm_kernel.py:51-57, test_block_ell.py);
        W8A16 2e-2 and W8A8 4e-2 of |W|·|x| (test_nm_kernel.py:86-104,
        test_block_ell.py:107-120)."""
        got = y.double().cpu().numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), label
        err = np.abs(got - want)
        if kind == "fp32":
            val, tol = float((err / np.maximum(scale, 1.0)).max()), 1e-5
        elif kind == "bf16":
            val, tol = float(err.max() / np.abs(want).max()), 1e-2
        else:
            val = float((err / np.maximum(scale, 1e-30)).max())
            tol = {"w8a16": 2e-2, "w8a8": 4e-2}[kind]
        if not val < tol:
            raise AssertionError(f"{label}: error {val:.3e} past the {kind} bound {tol:g}")
        return val, tol

    def run_dense_path(path, which, fn, x, want, scale, kind, tag):
        """Calls an entry point's fn once with every count at 0 just before
        and read just after; holds Y to the dense oracle at ``kind``'s
        bound; ``which`` is the kernel the path must launch (None: a torch
        product, no kernel of the port)."""
        zero_counts()
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        read_counts(path)
        val, tol = dense_bound_check(path, y, want, scale, kind)
        n_l = need(path, which) if which else 0
        launched = [f"{rec['paths'][path]} {rec['name']}" for rec in kernels.values()
                    if rec["paths"][path]]
        log(f"[{tag}] {path}: {kind} bound ok ({val:.2e} < {tol:g}), launches: "
            f"{', '.join(launched) or 'none (a torch product)'}, first call {t_call:.3f} s")
        if which is None:
            assert not launched, f"{path} launched {launched}"
        return y, n_l

    def nm_vs_plain(label, fmt, x, mode):
        kw = dict(group=fmt.group, packed_bits=fmt.packed_bits, mode=mode)
        got = nm.nm_rows_cuda(fmt.vals, fmt.offs, x, **kw)
        want = nm.nm_rows_plain(fmt.vals, fmt.offs, x, **kw)
        scale = nm.nm_rows_plain(fmt.vals.abs(), fmt.offs, x.abs(), **kw)
        check_vs_plain("nm", label,
                       f"{fmt.n_keep}:{fmt.group} vals {fmt.vals.dtype} {mode} K={x.shape[1]} "
                       f"M_pad={fmt.m_pad} G_pad={fmt.g_pad} "
                       + ("bit-packed offsets" if fmt.packed_bits else "unpacked offsets"),
                       got, want, scale, tol)

    def bell_vs_plain(label, fmt, x, mode):
        args = (fmt.blkcol, fmt.blkvals, fmt.nb_p)
        desc = (f"bs={fmt.bs} vals {fmt.blkvals.dtype} {mode} K={x.shape[1]} MB={fmt.mb} "
                f"BMAX={fmt.bmax} blocks={fmt.n_blocks} pad={fmt.padding_rate:.2f}, "
                f"{fmt.work.shape[0]} work items")
        got = be.bell_rows_cuda(*args, x, mode=mode, work=fmt.work)
        want = be.bell_rows_plain(*args, x, mode=mode)
        if mode == "int8":  # the integer product is exact: equal, element for element
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bell_rows_cuda int8 differs from its plain version: {desc}")
            log(f"[kernel] bell_rows_cuda ({kernels['bell']['replaces']}) {label} {desc}: "
                "int32 result equal to the plain version")
            return
        scale = be.bell_rows_plain(fmt.blkcol, fmt.blkvals.abs(), fmt.nb_p, x.abs(), mode=mode)
        check_vs_plain("bell", label, desc, got, want, scale, tol)

    def rand_dev(shape, seed):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                               dtype=torch.float32, device=dev)

    # each kernel against its plain version: 2:4, 1:4 (bit-packed offsets)
    # and 4:8 (unpacked) in every value type and mode, and BS 64, 128, 256
    t0 = time.perf_counter()
    for n_keep, group in ((2, 4), (1, 4), (4, 8)):
        w_s = builder.nm_pruned_dense(300, 1024, n_keep, group, seed=4)
        x_s = rand_dev((1024, 37), 12)
        for dt in (torch.bfloat16, torch.float32, torch.int8):
            f_s = nm.pack_nm(w_s, n_keep=n_keep, group=group, dtype=dt, device=dev)
            for mode in (("bf16",) if dt == torch.int8 else ("bf16", "fp32")):
                nm_vs_plain("small", f_s, x_s, mode)
    a_s = builder.block_sparse_coo(1024, 768, 128, 0.25, seed=3)
    x_s = rand_dev((768, 72), 13)
    for bs in (64, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            f_s = be.pack_block_ell(a_s, bs=bs, dtype=dt, device=dev)
            for mode in ("fp32", "bf16"):
                bell_vs_plain("small", f_s, x_s, mode)
        f_s = be.pack_block_ell(a_s, bs=bs, dtype=torch.int8, device=dev)
        bell_vs_plain("small", f_s, torch.randint(-127, 128, (768, 72), dtype=torch.int8,
                                                  device=dev), "int8")
    log(f"[kernel] nm and block-ELL checks at small shapes: {time.perf_counter() - t0:.1f} s")

    # P13: the N:M serving layer.  W: 2:4-pruned 4096 x 4096 (seed 5);
    # x [4, 128, 4096] (batch x sequence x hidden): K = 512 folded
    w13 = builder.nm_pruned_dense(4096, 4096, 2, 4, seed=5)
    w13_64 = w13.astype(np.float64)
    x13_np = rng13.standard_normal((4, 128, 4096)).astype(np.float32)
    x13 = torch.as_tensor(x13_np, device=dev)
    xk13 = x13_np.reshape(-1, 4096).T.astype(np.float64)           # [4096, 512]
    want13 = (w13_64 @ xk13).T.reshape(4, 128, 4096)
    scale13 = (np.abs(w13_64) @ np.abs(xk13)).T.reshape(4, 128, 4096)
    log(f"[p13] W 4096x4096 2:4 (seed 5), nnz {int(np.count_nonzero(w13))}; x [4, 128, 4096]")
    layers13 = {}
    for prec, bound in (("bf16", "bf16"), ("fp32", "fp32"), ("int8", "w8a16")):
        t0 = time.perf_counter()
        layers13[prec] = SparseLinear.from_nm(w13, precision=prec)
        t_make = time.perf_counter() - t0
        run_dense_path(f"nm_layer_{prec}", "nm", layers13[prec], x13, want13, scale13, bound,
                       "p13")
        log(f"[p13]   from_nm({prec}): pack {t_make:.2f} s")
    fmt13 = {prec: nm.pack_nm(w13, dtype=dt, device=dev)
             for prec, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32),
                              ("int8", torch.int8))}
    f13 = fmt13["bf16"]
    log(f"[p13]   NmFormat bf16: vals {tuple(f13.vals.shape)} offs {tuple(f13.offs.shape)} "
        f"{f13.memory_bytes / 2**20:.1f} MiB (dense bf16 {4096 * 4096 * 2 / 2**20:.1f} MiB), "
        f"int8 {fmt13['int8'].memory_bytes / 2**20:.1f} MiB")
    x128_np = rng13.standard_normal((4096, 128)).astype(np.float32)
    x128 = torch.as_tensor(x128_np, device=dev)
    want128 = w13_64 @ x128_np.astype(np.float64)
    scale128 = np.abs(w13_64) @ np.abs(x128_np.astype(np.float64))
    run_dense_path("nm_spmm_k128", "nm", functools.partial(nm.nm_spmm, f13), x128, want128,
                   scale128, "bf16", "p13")
    xb13_np = rng13.standard_normal((4, 4096, 128)).astype(np.float32)
    wantb = np.einsum("nk,bkj->bnj", w13_64, xb13_np.astype(np.float64))
    run_dense_path("nm_batched", "nm",
                   lambda v: batched_spmm(functools.partial(nm.nm_spmm, f13), v),
                   torch.as_tensor(xb13_np, device=dev), wantb, None, "bf16", "p13")
    layer13_t = SparseLinear.from_nm(w13, mode="throughput")
    run_dense_path("nm_throughput", None, layer13_t, x13, want13, scale13, "bf16", "p13")
    log("[p13]   mode='throughput': the dense bf16 weight times bf16 x with an fp32 result "
        "(torch.mm out_dtype=float32: cuBLAS, tensor cores)")
    pw = builder.pruned_weight_coo(4096, 4096, 0.9, seed=3)
    pw64 = pw.to_dense(np.float64)
    t0 = time.perf_counter()
    layer_pw = SparseLinear.from_dense(pw.to_dense(np.float32), k_hint=512)
    t_make = time.perf_counter() - t0
    zero_counts()
    y = layer_pw(x13)
    torch.cuda.synchronize()
    read_counts("pruned_layer_k512")
    check_result(y.cpu().numpy(), (pw64 @ xk13).T.reshape(4, 128, 4096), rtol=2e-3)
    which_pw = "tile_stream" if kernels["tile_stream"]["paths"]["pruned_layer_k512"] else "tile"
    log(f"[p13] pruned_layer_k512: SparseLinear.from_dense(90 % pruned, seed 3, nnz {pw.nnz}, "
        f"k_hint=512) -> {layer_pw.meta['schedule']['family']}: oracle ok at rtol 2e-3, "
        f"{need('pruned_layer_k512', which_pw)} launch(es) of {kernels[which_pw]['name']}, "
        f"from_dense {t_make:.2f} s")
    for prec, mode in (("bf16", "bf16"), ("fp32", "fp32"), ("int8", "bf16")):
        nm_vs_plain("p13", fmt13[prec], x128, mode)
        f_ = fmt13[prec]
        info = nm.nm_kernel_info(f_.vals, f_.offs, group=f_.group, packed_bits=f_.packed_bits,
                                 mode=mode, k=512)
        log(f"[kernel] nm_rows_cuda P13 {prec} ({mode} mode: "
            f"{'bf16 wgmma.m64nNk16, A and X in shared memory' if mode == 'bf16' else '3xTF32 mma.m16n8k8'}"
            f"), tile {nm.tile_of(mode, 512)[0]}x{info['tile_n']} at K=512: "
            f"{info['registers']} registers, {info['spill_bytes']} spill bytes, "
            f"{info['dynamic_shared_bytes']} dynamic shared bytes, {info['blocks_per_sm']} "
            f"block(s) an SM, slots "
            + (f"staged by cp.async ({info['staged_groups']} groups a step)"
               if info["staged_groups"] else "read from device memory")
            + f"; depth splits at K=128: {nm.depth_splits(f_.m_pad, 128, 4096, mode, 132)}, "
            f"K=512: {nm.depth_splits(f_.m_pad, 512, 4096, mode, 132)}; y stored whole "
            f"(atomic adds into a zeroed y only when split)")
    nm_vs_plain("p13", f13, torch.as_tensor(xk13.astype(np.float32)).to(dev).contiguous(),
                "bf16")

    # P14: the Block-ELL serving layer: 15 % of the 128-blocks of 4096 x
    # 4096 (seed 6); x [2, 128, 4096]: K = 256
    a14 = builder.block_sparse_coo(4096, 4096, 128, 0.15, seed=6)
    d14 = a14.to_dense(np.float64)
    x14_np = rng13.standard_normal((2, 128, 4096)).astype(np.float32)
    x14 = torch.as_tensor(x14_np, device=dev)
    xk14_np = x14_np.reshape(-1, 4096).T.astype(np.float64)        # [4096, 256]
    xk14 = torch.as_tensor(xk14_np.astype(np.float32), device=dev)
    want14k = d14 @ xk14_np
    scale14k = np.abs(d14) @ np.abs(xk14_np)
    want14, scale14 = want14k.T.reshape(2, 128, 4096), scale14k.T.reshape(2, 128, 4096)
    fmt14 = {prec: be.pack_block_ell(a14, dtype=dt, device=dev)
             for prec, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32),
                              ("int8", torch.int8))}
    f14 = fmt14["bf16"]
    log(f"[p14] A 4096x4096, 15 % of 128-blocks (seed 6): nnz {a14.nnz}, {f14.n_blocks} blocks, "
        f"MB={f14.mb} BMAX={f14.bmax} pad={f14.padding_rate:.2f}, bf16 "
        f"{f14.memory_bytes / 2**20:.1f} MiB; x [2, 128, 4096]")
    # L4: from_block in bf16 and fp32 runs the Block-ELL kernel (#13), the
    # card's default method (the TPU's record takes the batched product)
    for prec, bound in (("bf16", "bf16"), ("fp32", "fp32")):
        layer_b = SparseLinear.from_block(a14, precision=prec)
        _, n_l = run_dense_path(f"block_layer_{prec}", "bell", layer_b, x14, want14, scale14,
                                bound, "p14")
        assert n_l == 1, n_l  # its format is fmt14[prec]'s, held to its plain version below
        run_dense_path(f"bell_pallas_{prec}", "bell",
                       functools.partial(be.block_ell_spmm, fmt14[prec], precision=prec,
                                         method="pallas"),
                       xk14, want14k, scale14k, bound, "p14")
    run_dense_path("block_layer_int8", "bell", SparseLinear.from_block(a14, precision="int8"),
                   x14, want14, scale14, "w8a8", "p14")
    xp14 = be.pad_dense_rows(xk14, 4096).contiguous()
    for prec in ("bf16", "fp32"):
        bell_vs_plain("p14", fmt14[prec], xp14, prec)
        for label, method in (("the card's default (the kernel, #13)", None),
                              ("the TPU's xla method (torch bmm)", "xla")):
            gate_calls.append(("l4", f"P14 K=256 block_ell_spmm {prec}, {label}",
                               functools.partial(be.block_ell_spmm, fmt14[prec], precision=prec,
                                                 method=method), xk14, a14, 256))
    x_amax = xp14.abs().amax(dim=0)
    xq14 = torch.clamp(torch.round(xp14 / torch.where(x_amax > 0, x_amax / 127.0, 1.0)),
                       -127, 127).to(torch.int8).contiguous()
    bell_vs_plain("p14", fmt14["int8"], xq14, "int8")
    bell_vs_plain("p14", fmt14["int8"], xq14.t().contiguous().t(), "int8")  # as bell_int8 hands it
    for mode in ("bf16", "fp32", "int8"):
        info = be.bell_kernel_info(mode)
        work14 = fmt14[mode].work.cpu().numpy()
        log(f"[kernel] bell_rows_cuda at P14, {mode}: grid {work14.shape[0]} work items x "
            f"{-(-f14.bs // 64)} row tiles x {-(-256 // 128)} column tiles (K=256), "
            f"{int(work14[:, 3].sum())} items alone, the rest adding into y; blocks per item "
            f"at most {int((work14[:, 2] - work14[:, 1]).max())}, nb_p {f14.nb_p.min().item()}-"
            f"{f14.nb_p.max().item()} (mean {f14.n_blocks / f14.mb:.2f}); {info['registers']} "
            f"registers, {info['spill_bytes']} spill bytes, {info['static_shared_bytes']} static "
            f"+ {info['dynamic_shared_bytes']} dynamic shared bytes, {info['blocks_per_sm']} "
            f"blocks an SM")
        if info["spill_bytes"]:
            raise AssertionError(f"the Block-ELL {mode} kernel spills: {info}")

    # P15: the schedule families through build_plan, on the card
    # dense at the headline, K = 256: A (2.1 GB of bf16) densified on the card
    mat_abs = CooMatrix(mat.rows, mat.cols, np.abs(mat.vals), mat.shape)
    scale_h256 = spmm_reference(mat_abs, np.abs(xs[256].astype(np.float64)))
    t0 = time.perf_counter()
    plan_dense = build_plan(mat, Schedule(family="dense", precision="bf16"))
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    zero_counts()
    y = plan_dense(xs[256])
    torch.cuda.synchronize()
    read_counts("dense_k256")
    check_result(y.cpu().numpy(), ref_h256, rtol=1e-2, scale=scale_h256)
    log(f"[p15] dense_k256: build_plan(dense, bf16) at the headline, "
        f"{plan_dense.meta['format_bytes'] / 2**30:.2f} GiB densified on the card in "
        f"{t_dense:.2f} s: oracle ok at rtol 1e-2 of |A|.|x| (the tuner's bf16 rule), "
        "no kernel of the port (torch.mm out_dtype=float32)")
    t_dense_mm = float(np.median([time_fn(plan_dense.fn, torch.as_tensor(xs[256], device=dev))
                                  for _ in range(REPS)])) * 1e3
    log(f"[p15]   dense_k256 whole call, median of {REPS}: {t_dense_mm:.4f} ms  ({power})")
    del plan_dense, y
    torch.cuda.empty_cache()
    # L4: the block_ell plan runs the Block-ELL kernel (#13) in bf16 and fp32
    for prec in ("bf16", "fp32"):
        plan_bell = build_plan(a14, Schedule(family="block_ell", precision=prec,
                                             row_interval=128))
        _, n_l = run_dense_path("block_ell_plan" + ("" if prec == "bf16" else "_fp32"), "bell",
                                plan_bell, xk14, want14k, scale14k, prec, "p15")
        assert n_l == 1, n_l
        bell_vs_plain(f"L4 block_ell plan ({prec})'s format", plan_bell.formats[0],
                      be.pad_dense_rows(xk14, 4096).contiguous(), prec)
    del plan_bell
    cs = builder.power_law_col_coo(M, N, AVG_NNZ_PER_ROW, alpha=1.6, seed=9)
    ccount = np.bincount(cs.cols, minlength=N)
    share = float(np.sort(ccount)[-128:].sum()) / cs.nnz
    log(f"[matrix] column-skewed: {M}x{N}, nnz={cs.nnz} (power_law_col_coo alpha 1.6 seed 9), "
        f"top 128 columns hold {100 * share:.1f} % of the nonzeros")
    ref_cs = spmm_reference(cs, xs[8].astype(np.float64))
    scale_cs = spmm_reference(CooMatrix(cs.rows, cs.cols, np.abs(cs.vals), cs.shape),
                              np.abs(xs[8].astype(np.float64)))
    hyb_plans = {}
    for C in (2048, 512):
        path = f"hybrid_c{C}"
        t0 = time.perf_counter()
        hyb_plans[C] = build_plan(cs, Schedule(family="hybrid_cols", hot_cols=C, unroll=4,
                                               ktile=8, precision="bf16"))
        t_make = time.perf_counter() - t0
        zero_counts()
        y = hyb_plans[C](xs[8])
        torch.cuda.synchronize()
        read_counts(path)
        check_result(y.cpu().numpy(), ref_cs, rtol=1e-2, scale=scale_cs)
        meta = hyb_plans[C].meta
        log(f"[p15] {path}: covered {meta['covered_nnz']}/{cs.nnz}, {meta['operator_history']}, "
            f"pad {meta['padding_rate']:.3f}, {meta['format_bytes'] / 2**20:.1f} MiB, build "
            f"{t_make:.2f} s: oracle ok at rtol 1e-2 of |A|.|x|, {need(path, 'dg')} launch(es) "
            "of dg_rows_cuda (the remainder)")
        for f in hyb_plans[C].formats:
            fmt_vs_plain("colskew", f, 8)

    # P16: tune on the column-skewed matrix at K = 8: the JAX package's 26
    # candidates, its three hybrid rows first (top-128 share past 0.6)
    res_cs, best_cs = run_tune("tune_colskew_k8", xs[8], a=cs)
    rows_cs = [row["schedule"] for row in res_cs.table]
    assert candidates_digest(rows_cs) == TUNE_COLSKEW_K8_DIGEST
    assert [r["family"] for r in rows_cs[:3]] == ["hybrid_cols"] * 3 and "hybrid_cols" in best_cs
    need("tune_colskew_k8", "dg")
    tune_cs_winner = (res_cs.best_schedule.family, res_cs.best_seconds)
    del res_cs
    torch.cuda.empty_cache()
    log(f"[p13-16] dense-tile phases: {time.perf_counter() - t_dense_tile:.1f} s")

    # ---- T0-T2: training on the card: the SDDMM pair, the trainable
    # pruned layer (BASELINE.json config #3's 4096^2 weight, x [4, 128,
    # 4096]) and the differentiable serving layers
    t_train_phases = time.perf_counter()

    def tiles_line(label, fmt):
        """The [kernel] line of #14's tile index on ``fmt``: its tiles, the
        slots each path takes by mode, its bytes and build, the kernels'
        resources; returns (dense tiles, their slots, all slots) in fp32x2."""
        t = sd.sddmm_tiles(fmt)
        parts = []
        for mode in ("fp32x2", "bf16"):
            nd, d = t.dense(sd.TILE_MIN_SLOTS[mode])
            ti = sd.sddmm_info("tile", mode)
            parts.append(f"{mode}: {nd} tiles dense (at least {sd.TILE_MIN_SLOTS[mode]} "
                         f"slots), {d} of {t.n_slots} walked slots in them, tile kernel "
                         f"{ti['registers']} registers, {ti['spill_bytes']} spill bytes, "
                         f"{ti['blocks_per_sm']} blocks an SM")
        si = sd.sddmm_info("slot", "fp32x2")
        log(f"[kernel] sddmm_rows_cuda tile index at {label}: tiles of {sd.TILE_ROWS} x "
            f"{sd.TILE_COLS}, {t.n_hit_tiles} hit, the fullest {int(t.counts[:1].sum())} "
            f"slots, the median {int(np.median(t.counts)) if t.n_hit_tiles else 0}; "
            f"{t.nbytes / 2**20:.1f} MiB, built in {t.build_seconds * 1e3:.1f} ms; "
            + "; ".join(parts) + f"; per-slot kernel {si['registers']} registers, "
            f"{si['blocks_per_sm']} blocks an SM")
        return (*t.dense(sd.TILE_MIN_SLOTS["fp32x2"]), t.n_slots)

    def pair_vs_plain(label, fmt, k, kt, mode, dx=True):
        """#14 and #15 against their plain versions on ``fmt`` at K = k (X
        and dY_slots padded to the K-tile kt): 1e-5 of |dY|·|X| (at every
        slot of the plane) and of |A|^T·|dY|, the error of sums taken in
        another order.  #14 samples through the format's tile index."""
        kp = -(-k // kt) * kt
        gen = torch.Generator(device=dev).manual_seed(k)
        n, rows = fmt.shape[1], fmt.n_programs * fmt.rb
        x = torch.zeros((n, kp), device=dev)
        x[:, :k] = torch.randn((n, k), generator=gen, device=dev)
        dy = torch.zeros((rows, kp), device=dev)
        dy[:, :k] = torch.randn((rows, k), generator=gen, device=dev)
        planes = (fmt.c0, fmt.cols, fmt.lrow)
        vals = fmt.vals.float()
        desc = (f"kt={kt} {mode} K={k} rb={fmt.rb} ct={fmt.ct} g={fmt.chunk_g} "
                f"P={fmt.n_programs} NC={fmt.n_chunks} pad={fmt.padding_rate:.4f}")
        kw = dict(rb=fmt.rb, kt=kt, mode=mode)
        t = sd.sddmm_tiles(fmt)
        got = sd.sddmm_rows_cuda(*planes, fmt.nc_p, dy, x, **kw, tiles=t)
        want = sd.sddmm_rows_plain(*planes, fmt.nc_p, dy, x, **kw)
        scale = sd.sddmm_rows_plain(*planes, fmt.nc_p, dy.abs(), x.abs(), **dict(kw, mode="fp32"))
        nd, d = t.dense(sd.TILE_MIN_SLOTS[mode])
        check_vs_plain("sddmm", label, desc + f", {nd} dense tiles ({d} slots), "
                       f"{t.n_slots - d} per-slot", got, want, scale, tol)
        del got, want, scale
        if not dx:
            return
        index = sd.dx_index(fmt)
        got = sd.dx_rows_cuda(*planes, vals, fmt.nc_p, dy, n=n, **kw, index=index)
        again = sd.dx_rows_cuda(*planes, vals, fmt.nc_p, dy, n=n, **kw, index=index)
        want = sd.dx_rows_plain(*planes, vals, fmt.nc_p, dy, n=n, **kw)
        scale = sd.dx_rows_plain(*planes, vals.abs(), fmt.nc_p, dy.abs(), n=n,
                                 **dict(kw, mode="fp32"))
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"#15 at {label}: two launches on the same input differ")
        check_vs_plain("dx", label, desc + f", {index.n_staged} of {index.n_slots} slots staged "
                       f"in {index.n_pieces} pieces, two launches bit for bit", got, want, scale,
                       tol)

    def dx_index_line(label, fmt):
        """The [kernel] line of #15's column index on ``fmt``: its slots,
        staged windows and pieces, its bytes, its first build (at the first
        backward) and a rebuild, the walk kernel's resources."""
        index = sd.dx_index(fmt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = sd.build_dx_index(fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p, rb=fmt.rb,
                                  n=fmt.shape[1])
        torch.cuda.synchronize()
        rebuild = time.perf_counter() - t0
        if not (torch.equal(again.slot, index.slot) and torch.equal(again.row, index.row)):
            raise AssertionError(f"#15's column index at {label} is not built the same way twice")
        per_piece = (index.pieces[:, 2] - index.pieces[:, 1]).cpu().numpy()
        parts = []
        for mode in ("fp32x2", "bf16"):
            wi = sd.sddmm_info("dx", mode)
            parts.append(f"{mode} walk kernel (panel 128) {wi['registers']} registers, "
                         f"{wi['spill_bytes']} spill bytes, {wi['blocks_per_sm']} block an SM")
        log(f"[kernel] dx_rows_cuda column index at {label}: tiles of {sd.DX_TILE_COLS} columns, "
            f"windows of {sd.DX_WIN_ROWS} rows; {index.n_slots} walked slots, {index.n_staged} "
            f"staged in {index.n_pieces} pieces (slots a piece: median "
            f"{int(np.median(per_piece)) if len(per_piece) else 0}, most "
            f"{int(per_piece.max()) if len(per_piece) else 0}); {index.nbytes / 2**20:.2f} MiB, "
            f"built in {index.build_seconds * 1e3:.1f} ms at first use, rebuilt in "
            f"{rebuild * 1e3:.1f} ms; " + "; ".join(parts))
        return index

    # T0 at the JAX tests' shape: the K-tile loop of 8 and its tail
    small_t = builder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0)
    f_small = span.pack_span(small_t, rb=64, ct=128, g=64, keep_perm=True, device=dev)
    for k in (12, 20, 24):
        for mode in ("fp32", "bf16"):
            pair_vs_plain("small", f_small, k, 8, mode)
    # #14 on a pattern whose tiles take both paths: a 4096^2 weight, its first
    # half of rows 90 % pruned (about 800 slots a tile), the rest 99.5 %
    # (about 40), dealt to programs in blocks; and on config #1's pattern
    # (every tile sparse: the per-slot path)
    rng_h = np.random.default_rng(24)
    keep_h = rng_h.random((4096, 4096)) < np.where(np.arange(4096)[:, None] < 2048, 0.1, 0.005)
    rows_h, cols_h = np.nonzero(keep_h)
    half = CooMatrix(rows_h, cols_h, rng_h.standard_normal(rows_h.size).astype(np.float32),
                     (4096, 4096))
    del keep_h
    f_half = span.pack_span(half, rb=512, ct=512, g=128, balance=False, keep_perm=True,
                            device=dev)
    t_half = tiles_line("both paths (4096^2, half 90 %, half 99.5 % pruned)", f_half)
    if not 0 < t_half[1] < t_half[2]:
        raise AssertionError("the two-density pattern does not take both of #14's paths")
    dx_index_line("both paths (4096^2, half 90 %, half 99.5 % pruned)", f_half)
    for mode in ("fp32x2", "bf16"):
        for k in (512, 100):
            pair_vs_plain("both paths", f_half, k, 32, mode)
    f_c1 = span.pack_span(mat, rb=512, ct=512, g=128, keep_perm=True, device=dev)
    if tiles_line("config #1's pattern", f_c1)[0]:
        raise AssertionError("config #1's pattern has a dense tile")
    dx_index_line("config #1's pattern", f_c1)
    for mode in ("fp32x2", "bf16"):
        pair_vs_plain("config #1", f_c1, 8, 8, mode)

    # T1: the pruned 4096^2 weight as a trainable layer with bias, x [4,
    # 128, 4096]; MSE against a fixed target, five Adam steps
    steps, x1_shape = 5, (4, 128, 4096)
    rng = np.random.default_rng(17)
    x1 = torch.as_tensor(rng.standard_normal(x1_shape).astype(np.float32), device=dev)
    t1 = torch.as_tensor(rng.standard_normal(x1_shape[:-1] + (pw.shape[0],))
                         .astype(np.float32), device=dev)
    t0 = time.perf_counter()
    layer1 = TrainableSparseLinear(pw, device=dev)  # rb 512, ct 512, g 128, fp32x2
    t_make = time.perf_counter() - t0
    f1, k1 = layer1.fmt, int(np.prod(x1_shape[:-1]))
    mask1 = torch.from_numpy(sd.occupancy_mask(f1)).to(dev)
    log(f"[t1] TrainableSparseLinear(pruned {pw.shape[0]}x{pw.shape[1]}, nnz {pw.nnz}, bias): "
        f"planes (P, NC, G) = ({f1.n_programs}, {f1.n_chunks}, {f1.chunk_g}), pad "
        f"{f1.padding_rate:.4f}, {f1.memory_bytes / 1e6:.1f} MB, made in {t_make:.2f} s "
        f"(packing included); x {list(x1_shape)}: K = {k1}")
    # T0 at the path's own format and K: #14 and #15, and the forward's
    # span kernel (#7) on the masked value plane the layer hands it
    t_t1 = tiles_line("T1 (8, 1639, 128)", f1)
    dx_index_line("T1 (8, 1639, 128)", f1)
    if t_t1[1] != t_t1[2]:
        raise AssertionError("T1's pattern has a tile for the per-slot path")
    for mode in ("fp32", "fp32x2", "bf16"):
        pair_vs_plain("t1", f1, k1, 32, mode)
    plane1 = (layer1.vals.detach() * mask1).contiguous()
    for mode in ("fp32x2", "bf16"):
        win_vs_plain("span", "t1", f1, k1, mode, vals=plane1)
    walk_line("span", "T1 forward (8, 1639, 128)", span.span_row_walk(f1), k1)
    walk_line("span", "T1 forward (8, 1639, 128)", span.span_row_walk(f1), k1, "bf16")

    rows_t = torch.as_tensor(pw.rows, device=dev)
    cols_t = torch.as_tensor(pw.cols, device=dev)
    w0 = torch.zeros(pw.shape, device=dev)
    w0[rows_t, cols_t] = torch.as_tensor(pw.vals, dtype=torch.float32, device=dev)
    opt1 = torch.optim.Adam(layer1.parameters(), lr=2e-2)
    losses = []
    zero_counts()
    t0 = time.perf_counter()
    for step in range(steps):
        xg = x1.detach().requires_grad_(True)  # both gradients, every step
        opt1.zero_grad(set_to_none=True)
        y = layer1(xg)
        y.retain_grad()
        loss = torch.nn.functional.mse_loss(y, t1)
        loss.backward()
        if step == 0:  # the output and both gradients against dense fp32
            with torch.no_grad():
                dyk0 = y.grad.reshape(k1, -1)                      # [K, out]
                xk0 = x1.reshape(k1, -1)                           # [K, in]
                b0 = layer1.bias.detach()
                # the output as tests/test_sddmm.py checks the forward
                # (check_result's rtol 1e-3 of max(|Y|, 1)), and within 1e-4
                # of its condition scale |X|·|W|^T + |b|
                yk, want_y = y.detach().reshape(k1, -1), xk0 @ w0.T + b0
                rel, _ = rel_err(yk, want_y)
                _, cond = grad_errors(yk, want_y, xk0.abs() @ w0.abs().T + b0.abs())
                log(f"[t1] step 0 y (forward, span) against dense fp32: rel err {rel:.2e} "
                    f"(< 1e-3 of max(|Y|, 1)), {cond:.2e} of the condition scale (< 1e-4)")
                if not (rel < 1e-3 and cond < 1e-4):
                    raise AssertionError("T1 y off its dense reference")
                checks = {
                    "vals.grad (SDDMM, packed_to_nz)": (
                        sd.packed_to_nz(f1, layer1.vals.grad), (dyk0.T @ xk0)[rows_t, cols_t],
                        (dyk0.abs().T @ xk0.abs())[rows_t, cols_t]),
                    "x.grad (transpose apply)": (
                        xg.grad.reshape(k1, -1), dyk0 @ w0, dyk0.abs() @ w0.abs())}
                for name, (got, want, scale) in checks.items():
                    rel, cond = grad_errors(got, want, scale)
                    log(f"[t1] step 0 {name} against dense fp32: rel err {rel:.2e} (< 3e-2, "
                        f"floor 1e-3), {cond:.2e} of the condition scale (< 1e-4)")
                    if not (rel < 3e-2 and cond < 1e-4):
                        raise AssertionError(f"T1 {name} off its dense reference")
                del checks, yk, want_y
                dyk0 = dyk0.clone()
        opt1.step()
        losses.append(loss.item())
        log(f"[t1] step {step}: loss {losses[-1]:.6f}")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    read_counts("train_t1")
    for which in ("span", "sddmm", "dx"):
        if need("train_t1", which) != steps:
            raise AssertionError(f"T1: {steps} steps launched {which} "
                                 f"{kernels[which]['paths']['train_t1']} times")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"T1: the loss did not fall: {losses}")
    log(f"[t1] {steps} Adam steps (lr 2e-2, MSE against a fixed target, seed 17) in "
        f"{t_train:.3f} s, the first-step checks included: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; launches per step: 1 span_rows_cuda (forward), 1 sddmm_rows_cuda, "
        "1 dx_rows_cuda")

    # T2: the differentiable serving layers
    rng2 = np.random.default_rng(18)
    lay_c = SparseLinear.from_coo(mat, differentiable=True, k_hint=8, device=dev)
    fn_c = lay_c._apply_fn
    fams = (fn_c.plan.meta["schedule"]["family"], fn_c.t_plan.meta["schedule"]["family"])
    x2c = torch.as_tensor(rng2.standard_normal((8, mat.shape[1])).astype(np.float32),
                          device=dev).requires_grad_(True)
    tg = rng2.standard_normal((8, mat.shape[0])).astype(np.float32)
    zero_counts()
    y2 = lay_c(x2c)
    torch.cuda.synchronize()
    read_counts("t2_coo_fwd")
    check_result(y2.detach().T.cpu().numpy(),
                 spmm_reference(mat, x2c.detach().T.double().cpu().numpy()), rtol=2e-3)
    zero_counts()
    (y2 * torch.as_tensor(tg, device=dev)).sum().backward()
    torch.cuda.synchronize()
    read_counts("t2_coo_bwd")
    check_result(x2c.grad.T.cpu().numpy(),
                 spmm_reference(mat.transpose(), tg.T.astype(np.float64)), rtol=2e-3)
    for path, fam in (("t2_coo_fwd", fams[0]), ("t2_coo_bwd", fams[1])):
        launched = [f"{rec['paths'][path]} {rec['name']}" for rec in kernels.values()
                    if rec["paths"][path]]
        if not launched:
            raise AssertionError(f"{path} launched no kernel of the port")
        log(f"[t2] SparseLinear.from_coo(differentiable=True, k_hint=8), config #1: {path} "
            f"({fam}) oracle ok at rtol 2e-3, launches: {', '.join(launched)}")
    log(f"[t2]   the transposed plan (A^T, the GNN aggregation backward) took {fams[1]} "
        f"(the forward {fams[0]})")
    # each plan's kernel against its plain version at the plan's own format
    for label, plan_c in (("t2 A", fn_c.plan), ("t2 A^T", fn_c.t_plan)):
        for f in plan_c.formats:
            fmt_vs_plain(label, f, 8)
    del lay_c, fn_c, x2c, y2
    for prec in ("bf16", "fp32"):
        lay_b = SparseLinear.from_block(a14, precision=prec, differentiable=True, device=dev)
        xb2 = x14.detach().clone().requires_grad_(True)
        tb = rng2.standard_normal(tuple(x14.shape[:-1]) + (a14.shape[0],))
        path = f"t2_block_{prec}"
        zero_counts()
        (lay_b(xb2) * torch.as_tensor(tb, dtype=torch.float32, device=dev)).sum().backward()
        torch.cuda.synchronize()
        read_counts(path)
        tk = tb.reshape(-1, a14.shape[0])
        want = (tk @ d14).reshape(xb2.shape)
        scale = (np.abs(tk) @ np.abs(d14)).reshape(xb2.shape)
        val, bound = dense_bound_check(f"{path} x.grad", xb2.grad, want, scale, prec)
        launched = [f"{rec['paths'][path]} {rec['name']}" for rec in kernels.values()
                    if rec["paths"][path]]
        assert need(path, "bell") == 2  # the forward's and the backward's
        log(f"[t2] SparseLinear.from_block({prec}, differentiable=True), x {list(xb2.shape)}: "
            f"x.grad within the {prec} bound ({val:.2e} < {bound:g}) of the dense product; "
            f"launches: {', '.join(launched)}")
    log(f"[t0-t2] training phases: {time.perf_counter() - t_train_phases:.1f} s")

    # ---- G0-G3: the host helpers at the SpMV size, graph analytics on the
    # same matrix (push orientation), SpGEMM on config #1, persistence.
    # Every number beside the card's name and power limit.
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from tpusparse_torch import artifacts, graph, results
    from tpusparse_torch import spgemm as sg
    from tpusparse_torch.bench import spgemm_crossover
    from tpusparse_torch.io.mtx import read_mtx, write_mtx
    from tpusparse_torch.tune import _span_configs, matrix_signature

    t_new_phases = time.perf_counter()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # G0: each packer at 262144^2 through the native helpers and through the
    # numpy walks (their plain versions): every array equal, both times
    rb_dgt8 = dgt.auto_rb_dgt(SPMV_N, SPMV_N, big.nnz)
    rb_s, ct_s, g_s = _span_configs(big.density)[0]
    packers = {
        "dg kt=1 rb=4096 ns=4 g=2048": lambda: dg.pack_dg(big, rb=4096, ns=4, g=2048, kt=1),
        f"dgt8 rb={rb_dgt8} g=512 nw=4": lambda: dgt.pack_dgt(big, rb=rb_dgt8, g=512, kt=8,
                                                              resid=True, nw=4),
        f"span rb={rb_s} ct={ct_s} g={g_s}": lambda: span.pack_span(big, rb=rb_s, ct=ct_s,
                                                                    g=g_s),
        "P8 radix_span rb=1024 S=128 g=1024 kt=4": lambda: radix.pack_radix(
            big, rb=1024, S=128, g=1024, kt=4),
    }
    for label, pack in packers.items():
        f_nat, t_nat = timed(pack)
        with numpy_walks():
            f_np, t_np = timed(pack)
        same_format(f_nat, f_np)
        log(f"[native] pack {label} at 262144^2 ({big.nnz} nnz): native helpers {t_nat:.2f} s, "
            f"numpy walks {t_np:.2f} s ({t_np / t_nat:.1f}x); every array equal  ({power})")
        del f_nat, f_np
    torch.cuda.empty_cache()
    mtx_dir = tempfile.mkdtemp(prefix="mtx_", dir=os.path.dirname(cache))
    mtx_path = os.path.join(mtx_dir, "config1.mtx")
    _, t_w = timed(lambda: write_mtx(mtx_path, mat))
    by_path, t_path = timed(lambda: read_mtx(mtx_path))
    with open(mtx_path) as fh:
        by_file, t_file = timed(lambda: read_mtx(fh))
    for a_, b_ in ((by_path, by_file), (by_path, mat)):
        assert a_.shape == b_.shape and np.array_equal(a_.rows, b_.rows) and \
            np.array_equal(a_.cols, b_.cols)
    assert np.array_equal(by_path.vals, by_file.vals)
    assert np.array_equal(by_path.vals, np.asarray(mat.vals, np.float64))
    log(f"[native] config #1 .mtx ({os.path.getsize(mtx_path) / 2**20:.1f} MiB, {mat.nnz} "
        f"entries): write_mtx {t_w:.2f} s; read_mtx by path (native parser) {t_path:.2f} s, "
        f"by file object (Python reader) {t_file:.2f} s ({t_file / t_path:.1f}x); equal, and "
        f"equal to the matrix written  ({power})")
    del by_path, by_file

    # G1: graph analytics at 262144^2 in push orientation (entry (u, v) is the
    # edge v -> u): scipy's csgraph runs on A^T
    n_g = SPMV_N
    at_csr = sp.csr_matrix((np.ones(big.nnz), (big.cols, big.rows)), shape=(n_g, n_g))
    pr_run, t_pack = timed(lambda: graph.pagerank_fn(big, tol=0.0, max_iter=20))
    zero_counts()
    (r_pr, it_pr), t_pr = timed(pr_run)
    read_counts("graph_pagerank_262k")
    t_pr_warm = min(timed(pr_run)[1] for _ in range(3))
    assert it_pr == 20 and need("graph_pagerank_262k", "dg1") == 20
    r64 = pagerank64(big, 20)
    l1 = float(np.abs(r_pr.cpu().double().numpy() - r64).sum())
    if not l1 <= 1e-5:
        raise AssertionError(f"PageRank: L1 distance {l1:.3e} to float64 > 1e-5")
    log(f"[graph] pagerank_fn(tol=0, max_iter=20) 262144^2: {it_pr} iterations, first run "
        f"{t_pr:.3f} s (the row walk built), warm {t_pr_warm * 1e3:.2f} ms (best of 3; "
        f"{t_pr_warm / it_pr * 1e3:.3f} ms an iteration, a host sync each; plan packed in "
        f"{t_pack:.2f} s: {pr_run.matvec.meta}); L1 distance to a float64 power iteration "
        f"{l1:.2e} (<= 1e-5); {kernels['dg1']['paths']['graph_pagerank_262k']} launches of "
        f"dg1_rows_cuda  ({power})")
    vs_plain("graph_pagerank", pr_run.matvec.format, 1, 1, "fp32x2", tol)
    bfs_run, t_pack = timed(lambda: graph.bfs_fn(big, max_iter=32))
    zero_counts()
    (level, it_bfs), t_bfs = timed(lambda: bfs_run(0))
    read_counts("graph_bfs_262k")
    assert need("graph_bfs_262k", "dg1") == it_bfs
    dist = csgraph.shortest_path(at_csr, unweighted=True, indices=0)
    want_level = np.where(dist <= 32, dist, -1).astype(np.int32)
    if not np.array_equal(level.cpu().numpy(), want_level):
        raise AssertionError("BFS levels differ from scipy's shortest_path")
    log(f"[graph] bfs_fn(max_iter=32) from 0: {it_bfs} iterations, {t_bfs:.3f} s (packed in "
        f"{t_pack:.2f} s), {int((want_level >= 0).sum())} vertices reached, deepest level "
        f"{int(want_level.max())}; levels equal scipy's unweighted shortest_path on A^T; "
        f"{it_bfs} launches of dg1_rows_cuda, one a level  ({power})")
    vs_plain("graph_bfs", bfs_run.matvec.format, 1, 1, "fp32x2", tol)
    w_abs = CooMatrix(big.rows, big.cols, np.abs(np.asarray(big.vals)), big.shape)
    sssp_run = graph.sssp_fn(w_abs)
    (d_ss, it_ss), t_ss = timed(lambda: sssp_run(0))
    at_w = sp.csr_matrix((w_abs.vals, (big.cols, big.rows)), shape=(n_g, n_g))
    d_ref = csgraph.dijkstra(at_w, indices=0)
    d_got = d_ss.cpu().double().numpy()
    fin = np.isfinite(d_ref)
    if not np.array_equal(np.isfinite(d_got), fin) or \
            not (np.abs(d_got[fin] - d_ref[fin]) <= 1e-5 * np.abs(d_ref[fin])).all():
        raise AssertionError("SSSP differs from scipy's dijkstra beyond rtol 1e-5")
    rel_ss = float((np.abs(d_got[fin] - d_ref[fin]) / np.maximum(d_ref[fin], 1e-30)).max())
    log(f"[graph] sssp from 0, weights |vals|: {it_ss} iterations (max_iter "
        f"{tpusparse_torch.get_config().graph_max_iter}), {t_ss:.3f} s (segment min, no "
        f"kernel of the port); max rel err to scipy's dijkstra on A^T {rel_ss:.2e} "
        f"(rtol 1e-5), {int(fin.sum())} reachable  ({power})")
    label_cc, t_cc = timed(lambda: graph.connected_components(big))
    n_comp, lab = csgraph.connected_components(
        sp.csr_matrix((np.ones(big.nnz), (big.rows, big.cols)), shape=(n_g, n_g)),
        directed=False)
    least = np.full(n_comp, n_g, dtype=np.int64)
    np.minimum.at(least, lab, np.arange(n_g))
    if not np.array_equal(label_cc, least[lab]):
        raise AssertionError("connected components differ from scipy's")
    log(f"[graph] connected_components: {t_cc:.3f} s (label propagation, segment min), "
        f"{n_comp} components, equal to scipy's (labels mapped to the least vertex)  ({power})")
    del at_csr, at_w, w_abs, r64

    # G2: SpGEMM, config #1 . power_law(32768, 32768, 8, seed 13) on the
    # device route, and the crossover against scipy from 256^2 up
    b13 = builder.power_law_coo(N, N, avg_nnz_per_row=8.0, seed=13)
    sg._RUNNER_CACHE.clear()
    zero_counts()
    c_dev, t_first = timed(lambda: sg.spgemm(mat, b13, method="device"))
    read_counts("spgemm_32k")
    runner = next(iter(sg._RUNNER_CACHE.values()))
    n_tiles = runner.last_stats["tiles"]
    assert need("spgemm_32k", "dg") == n_tiles == -(-N // 128)
    c_ref = sg.spgemm_host(mat, b13)
    keep_ref = c_ref.vals != 0  # scipy keeps what cancels exactly; the device drops it
    if not (np.array_equal(c_dev.rows, c_ref.rows[keep_ref])
            and np.array_equal(c_dev.cols, c_ref.cols[keep_ref])):
        raise AssertionError("SpGEMM pattern differs from scipy's")
    rel_c = np.abs(c_dev.vals - c_ref.vals[keep_ref]) / np.maximum(np.abs(c_ref.vals[keep_ref]),
                                                                  1.0)
    if not rel_c.max(initial=0) <= 1e-4:
        raise AssertionError(f"SpGEMM: max rel err {rel_c.max():.3e} > 1e-4")
    f_a = runner.plan.formats[0]
    assert runner.plan.meta["schedule"]["family"] == "dg_span" and f_a.kt == 32
    log(f"[spgemm] config #1 . power_law(32768^2, 8, seed 13), method='device': nnz(C) "
        f"{c_dev.nnz}, {sg.spgemm_flops(mat, b13):.4g} FLOPs, {t_first:.2f} s first call (A "
        f"packed: {runner.plan.meta['schedule']['family']} kt={f_a.kt} rb={f_a.rb}); "
        f"{n_tiles} tiles of 128 in {runner.last_stats['groups']} groups (host syncs); max rel "
        f"err to scipy {rel_c.max(initial=0):.2e} (rtol 1e-4), the pattern scipy's; "
        f"{n_tiles} launches of dg_rows_cuda, one a tile of B  ({power})")
    vs_plain("spgemm", f_a, 128, f_a.kt, f_a.mode, tol)
    pairs = spgemm_crossover.products()
    pairs["config #1 . 32768^2 avg 8 (seed 13)"] = (mat, b13)
    spgemm_crossover.crossover(pairs, reps=3, log=log, note=power)
    del c_dev, c_ref, runner
    torch.cuda.empty_cache()

    # G3: persistence: P3's tune saved its winner; the artifact gives back
    # the schedule and every saved array, the same Y, and results.aggregate
    # its best row
    sig = matrix_signature(mat)
    adir = os.path.join(tune_dirs["tune_k8"], "artifacts", sig)
    (run_dir,) = os.listdir(adir)
    art_path = os.path.join(adir, run_dir)
    art_mib = sum(os.path.getsize(os.path.join(art_path, f)) for f in os.listdir(art_path)) / 2**20
    (sched_l, fmts_l, perf_l), t_load = timed(lambda: artifacts.load_plan_artifact(art_path))
    _, fmts_c, _ = artifacts.load_plan_artifact(art_path, device="cpu")
    assert sched_l == json.loads(json.dumps(best.describe()))
    assert len(fmts_l) == len(win.formats) and perf_l["k"] == 8
    xd8 = torch.as_tensor(xs[8], device=dev)
    abs_mat = CooMatrix(mat.rows, mat.cols, np.abs(np.asarray(mat.vals)), mat.shape)
    scale8 = torch.as_tensor(spmm_reference(abs_mat, np.abs(xs[8]).astype(np.float64)),
                             device=dev)
    for f_o, f_l, f_c in zip(win.formats, fmts_l, fmts_c):
        kind = type(f_o).__name__
        for name in artifacts.saved_fields(type(f_o)):
            v_o, v_l = getattr(f_o, name), getattr(f_l, name)
            same = (torch.equal(v_o, v_l) if isinstance(v_o, torch.Tensor)
                    else np.array_equal(v_o, v_l) if isinstance(v_o, np.ndarray)
                    else v_o == v_l)
            if not same:
                raise AssertionError(f"artifact {kind}.{name} differs")
        # the plain version on the CPU, the original's planes copied there:
        # the same function on the same planes gives the same bits
        x_c = torch.from_numpy(xs[8])
        if not torch.equal(artifacts.format_spmm(format_on_cpu(f_o), x_c),
                           artifacts.format_spmm(f_c, x_c)):
            raise AssertionError(f"{kind}: Y of the loaded artifact differs on the CPU")
        # the kernel on the card: rows split over blocks add their partial
        # sums by float atomics in the order the blocks finish, so two calls
        # on one format may differ in the last bits; the loaded format is
        # held to that spread
        y_o, y_o2, y_l = (artifacts.format_spmm(f, xd8) for f in (f_o, f_o, f_l))
        rel_rr, ab_rr = rel_err(y_o2, y_o, scale8)
        rel_l, ab_l = rel_err(y_l, y_o, scale8)
        if not rel_l <= 1e-6:
            raise AssertionError(f"{kind}: Y of the loaded artifact differs on the card: "
                                 f"{rel_l:.3e} of |A|.|x|")
        bits = "bitwise equal" if torch.equal(y_l, y_o) else "not bitwise equal"
        log(f"[persist] {kind}: every saved array equal; Y of the loaded format bitwise equal "
            f"on the CPU (plain version); on the card {bits}: max abs {ab_l:.2e} "
            f"({rel_l:.2e} of |A|.|x|), the original's own call-to-call "
            f"spread {ab_rr:.2e} ({rel_rr:.2e})  ({power})")
    best_rows, n_rows = results.aggregate(
        [os.path.join(tune_dirs["tune_k8"], "results.jsonl")])
    row_b = best_rows[(sig, 8)]
    assert row_b["seconds"] == res.best_seconds and row_b["schedule"]["family"] == best.family
    log(f"[persist] tune_k8's winner ({best.family}, {len(fmts_l)} format(s), {art_mib:.1f} MiB "
        f"on disk) loaded in {t_load:.2f} s; results.aggregate over {n_rows} rows reports the "
        f"best row {row_b['seconds'] * 1e3:.4f} ms, {row_b['gflops']:.2f} GF/s  ({power})")
    log(f"[g0-g3] host helpers, graph, SpGEMM and persistence phases: "
        f"{time.perf_counter() - t_new_phases:.1f} s")

    # ---- B1-B5: the command line, the session probe, the library
    # yardsticks, matrices from data on disk and the suite's SpMV section.
    # Every number beside the card's name and power limit.
    from tpusparse_torch.bench import baselines, microbench, suite
    from tpusparse_torch.io import realdata

    t_bench_phases = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    want8 = spmm_reference(mat, xs[8].astype(np.float64))

    # B1: python -m tpusparse_torch on G0's config #1 .mtx at K = 8, in a
    # process of its own with a fresh cache (so its tune times every
    # candidate); the winner it names is rebuilt here, called once with the
    # counts at 0 and held to the oracle; then --graph cc on the same file
    cli_env = dict(os.environ, HOME=tempfile.mkdtemp(prefix="cli_home_",
                                                     dir=os.path.dirname(cache)))

    def cli(*argv):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tpusparse_torch", *argv], cwd=root,
                           env=cli_env, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"python -m tpusparse_torch {' '.join(argv)} exited "
                                 f"{r.returncode}: {r.stderr[-3000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr, time.perf_counter() - t0

    out_cli, err_cli, t_cli = cli(mtx_path, "8")
    n_rows_cli = sum(1 for line in err_cli.splitlines() if line.startswith("  "))
    log(f"[cli] python -m tpusparse_torch config1.mtx 8: exit 0 in {t_cli:.1f} s (process "
        f"start, .mtx read, tune over {n_rows_cli} candidate rows)  ({power})")
    log(f"[cli] {json.dumps(out_cli)}")
    assert (out_cli["matrix"], out_cli["k"], out_cli["nnz"]) == (mtx_path, 8, mat.nnz)
    assert out_cli["seconds"] > 0 and out_cli["gflops"] > 0
    sched_cli = Schedule(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in out_cli["best_schedule"].items()})
    zero_counts()
    y_cli = build_plan(mat, sched_cli, device=dev)(torch.as_tensor(xs[8], device=dev))
    torch.cuda.synchronize()
    read_counts("cli_winner_k8")
    assert y_cli.is_cuda and y_cli.shape == (M, 8) and bool(torch.isfinite(y_cli).all())
    # the tuner's tolerance for the winner's precision (fp32x2 2e-3, bf16 1e-2
    # of |A|.|x|, fp32 1e-5)
    cfg = tpusparse_torch.get_config()
    check_result(y_cli.cpu().numpy(), want8,
                 rtol={"fp32x2": 2e-3, "bf16": cfg.tol_bf16}.get(sched_cli.precision,
                                                                 cfg.tol_fp32),
                 scale=scale8.cpu().numpy() if sched_cli.precision == "bf16" else None)
    n_cli = {kernels[w]["name"]: rec["paths"]["cli_winner_k8"] for w, rec in kernels.items()
             if rec["paths"]["cli_winner_k8"]}
    assert n_cli, "the command line's winner launched no kernel"
    log(f"[cli] its winner ({sched_cli.family}, {sched_cli.precision}) rebuilt here: oracle ok "
        f"(the tuner's tolerance); launches {n_cli}")
    out_cc, _, t_cc_cli = cli(mtx_path, "--graph", "cc")
    cc_csr = sp.csr_matrix((np.ones(mat.nnz), (mat.rows, mat.cols)), shape=mat.shape)
    n_comp_cc = csgraph.connected_components(cc_csr, directed=False)[0]
    if out_cc != {"algorithm": "cc", "n_components": int(n_comp_cc)}:
        raise AssertionError(f"--graph cc gave {out_cc}; scipy counts {n_comp_cc} components")
    log(f"[cli] python -m tpusparse_torch config1.mtx --graph cc: {json.dumps(out_cc)} in "
        f"{t_cc_cli:.1f} s, scipy's count  ({power})")
    os.remove(mtx_path)
    del y_cli, cc_csr

    # B2: the session probe: every axis within its bounds
    probe = microbench.session_probe()
    for name, (lo, hi) in microbench.PROBE_BOUNDS.items():
        if not lo <= probe[name] <= hi or "implausible" in probe:
            raise AssertionError(f"probe {name} {probe[name]} outside [{lo}, {hi}]: {probe}")
    log(f"[probe] stream {probe['stream_gbs']:.1f} GB/s (reduce {probe['reduce_gbs']:.1f}), "
        f"bf16 tensor cores {probe['mxu_tflops']:.1f} TFLOP/s, fp32 {probe['fp32_tflops']:.2f} "
        f"TFLOP/s; bounds {microbench.PROBE_BOUNDS}; norms to the anchor window: stream "
        f"{probe['norm_stream']}, bf16 {probe['norm']}, fp32 {probe['norm_fp32']}"
        f"{'; violations ' + json.dumps(probe['violations']) if 'violations' in probe else ''}"
        f"  ({power})")

    # B3: the three library yardsticks at config #1, K = 8, against the
    # oracle at 1e-5 of |A|.|x| (the kernels' scale against their plain
    # versions): an fp32 sum over a hub row of config #1 (4441 entries,
    # their |terms| summing to 2834, Y near 1) is off by up to 1e-4 in any
    # order of fp32 adds, so 1e-5 of max(|Y|, 1) would judge the rounding
    xd8 = torch.as_tensor(xs[8], device=dev)
    scale8_np = scale8.cpu().numpy()
    for bname in ("dense_spmm_fn", "csr_spmm_fn", "segment_spmm_fn"):
        bfn = getattr(baselines, bname)(mat)
        y_b = bfn(xd8)
        assert y_b.is_cuda and y_b.dtype == torch.float32 and bool(torch.isfinite(y_b).all())
        err_b = np.abs(y_b.cpu().double().numpy() - want8)
        check_result(y_b.cpu().numpy(), want8, rtol=tpusparse_torch.get_config().tol_fp32,
                     scale=scale8_np)
        b_ms = time_fn(bfn, xd8) * 1e3
        log(f"[baseline] {bname} config #1 K=8: max abs err {err_b.max():.2e}, "
            f"{(err_b / np.maximum(np.abs(want8), 1.0)).max():.2e} of max(|Y|, 1), "
            f"{(err_b / np.maximum(np.maximum(np.abs(want8), 1.0), scale8_np)).max():.2e} of "
            f"|A|.|x| (<= 1e-5); time_fn {b_ms:.4f} ms a call  ({power})")
        del bfn, y_b
    torch.cuda.empty_cache()

    # B4: matrices from data on disk, through spmm (its default schedule)
    for rname, make in (("real_imports", lambda: realdata.import_graph_coo(max_files=400)),
                        ("real_cooc", lambda: realdata.cooccurrence_coo(max_files=400))):
        t0 = time.perf_counter()
        rm = make()
        t_make = time.perf_counter() - t0
        xr = np.random.default_rng(0).standard_normal((rm.shape[1], 8)).astype(np.float32)
        zero_counts()
        y_r = tpusparse_torch.spmm(rm, xr)
        torch.cuda.synchronize()
        read_counts(rname)
        assert y_r.is_cuda and tuple(y_r.shape) == (rm.shape[0], 8)
        assert bool(torch.isfinite(y_r).all())
        check_result(y_r.cpu().numpy(), spmm_reference(rm, xr.astype(np.float64)), rtol=2e-3)
        n_r = {kernels[w]["name"]: rec["paths"][rname] for w, rec in kernels.items()
               if rec["paths"][rname]}
        assert n_r, f"{rname} launched no kernel"
        log(f"[real] {rname}: {rm.shape[0]}x{rm.shape[1]}, {rm.nnz} nnz, built in {t_make:.1f} s "
            f"from the Python sources on disk; spmm K=8 ({default_schedule(rm, 8).family}) "
            f"oracle ok at rtol 2e-3; launches {n_r}  ({power})")

    # B5: the suite's SpMV section, quick (65536^2), into a fresh cache dir
    suite_dir = tempfile.mkdtemp(prefix="suite_", dir=os.path.dirname(cache))
    with tpusparse_torch.config_override(cache_dir=suite_dir):
        zero_counts()
        rows_s = suite.run_suite(quick=True, only="spmv",
                                 out_path=os.path.join(suite_dir, "BENCH_SUITE.jsonl"))
        read_counts("suite_spmv")
    bad = [r for r in rows_s if "error" in r or "rejected" in r]
    if bad:
        raise AssertionError(f"the suite's spmv section failed: {bad}")
    want_rows = {"spmv_multi/dgt_k8"} | {f"spmv_powerlaw/{m_}" for m_ in
                                         ("dg", "dgt8", "radix", "span")} | {"spmv_small/segment"}
    assert {r.get("bench") for r in rows_s[1:]} == want_rows
    for r in rows_s[1:]:
        log(f"[suite] {r['bench']}: " + ", ".join(
            f"{k_} {v_:.4g}" if isinstance(v_, float) else f"{k_} {v_}"
            for k_, v_ in r.items() if k_ not in ("bench", "ts")) + f"  ({power})")
    n_s = {kernels[w]["name"]: rec["paths"]["suite_spmv"] for w, rec in kernels.items()
           if rec["paths"]["suite_spmv"]}
    log(f"[suite] spmv section launches: {n_s}")
    log(f"[b1-b5] command line, probe, yardsticks, real data and suite phases: "
        f"{time.perf_counter() - t_bench_phases:.1f} s")

    # ---- D1-D6: the multi-device layer on virtual ranks of this card
    phase_d(mat, dev, power, kernels, zero_counts, read_counts, need, root)

    # ---- S1-S5: past the TPU limits, at web-Google's and ogbn-arxiv's shapes
    s_profiles, s_sticks = phase_s(big, xv, ref_v, probe["stream_gbs"], dev, power, kernels, zero_counts,
                         read_counts, need)

    # ---- L1-L4: the card's own gates beside the TPU's (L3's P2 and P8 run
    # in phase 6, L4 in P14, P15 and T2)
    l_profiles = phase_l(big, xb8, dev, power, kernels, zero_counts, read_counts, need,
                         fmt_vs_plain, run_tune, gate_calls)
    del gate_calls

    launches = {w: sum(rec["paths"].values()) for w, rec in kernels.items()}
    for w, n_l in launches.items():
        if n_l < 1:
            raise AssertionError(f"the main path never launched {kernels[w]['name']}")
    for rec in kernels.values():
        log(f"[path] launches of {rec['name']} by path: {rec['paths']}")

    # ---- 7. yardsticks: kernel, plain version, whole call, cuSPARSE, bound
    csr_cache = {}

    def csr_of(a):
        """A as a CSR tensor on the card, for cuSPARSE (made once per matrix)."""
        if id(a) in csr_cache:
            return csr_cache[id(a)][1]
        csr = a.to_csr_tensor(device=dev)
        csr_cache[id(a)] = (a, csr)  # holds a, so its id is not reused
        return csr

    def dev_ms(name, fn, x):
        """The device time a call of ``fn(x)`` in ms (``card_ms``; no CUDA
        graph for the plain versions, whose boolean indexing waits for the
        card); a reading other than the profiler's is said in the log."""
        ms, how = card_ms(fn, x, graph=name != "plain")
        if how != CARD_MS_PROFILER:
            log(f"[yardstick]   {name}: the profiler saw no whole window of device time; "
                f"{how} reads {ms:.4f} ms a call")
        return ms

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

    def measure(which, label, fmts, a, k, kern, plain, xk, xd, whole, pack=None, bound_k=None):
        """Times ``kern(xk)`` (the kernel launches of one product), its plain
        version, cuSPARSE on the same product (A = ``a``) and the whole
        entry-point call ``whole(xd)``; ``fmts`` are the formats launched."""
        a_csr = csr_of(a)
        nnz, (m, n) = a.nnz, a.shape
        x2 = xd.view(-1, 1) if xd.ndim == 1 else xd

        def lib(v):
            return torch.sparse.mm(a_csr, v)

        # REPS back-to-back readings each, interleaved; a number is their
        # median, since one reading of a call this short moves with the host
        runs = {"kernel": [], "plain": [], "library": [], "whole": []}
        for _ in range(REPS):
            for name, f, arg in (("kernel", kern, xk), ("plain", plain, xk),
                                 ("library", lib, x2), ("whole", whole, xd)):
                runs[name].append(time_fn(f, arg))
        t = {name: float(np.median(v)) for name, v in runs.items()}
        # the card's own time a call, host excluded: the kernels line's ms
        dev_t = {name: dev_ms(name, f, arg) for name, f, arg in
                 (("kernel", kern, xk), ("plain", plain, xk), ("library", lib, x2))}
        t["kernel_cold"] = time_cold(kern, xk)
        t["library_cold"] = time_cold(lib, x2)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        whole(xd)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        kb = k if bound_k is None else bound_k
        b_ms, b_by = bound_ms(nnz, m, n, kb)
        k_ms, p_ms = t["kernel"] * 1e3, t["plain"] * 1e3
        desc = "; ".join(fmt_geometry(f) for f in fmts)
        mib = sum(f.memory_bytes for f in fmts) / 2**20

        def readings(name):
            return " ".join(f"{v * 1e3:.4f}" for v in runs[name])

        log(f"[yardstick] {kernels[which]['name']} {label} K={k} x{len(fmts)} launch(es): "
            f"{desc}  ({power})")
        log(f"[yardstick]   back to back, median of {REPS}: kernel {k_ms:.4f} ms "
            f"({gflops(nnz, kb, k_ms / 1e3):.1f} GF/s, {nnz / k_ms / 1e6:.2f} Gnnz/s), "
            f"plain {p_ms:.4f} ms, whole call {t['whole'] * 1e3:.4f} ms, cuSPARSE "
            f"{t['library'] * 1e3:.4f} ms")
        log(f"[yardstick]   readings (ms): kernel {readings('kernel')}; plain "
            f"{readings('plain')}; whole {readings('whole')}; cuSPARSE {readings('library')}")
        log(f"[yardstick]   device time a call (profiler, 20 calls; the wrapper's launch and "
            f"fills): kernel {dev_t['kernel']:.4f} ms, plain {dev_t['plain']:.4f} ms, cuSPARSE "
            f"{dev_t['library']:.4f} ms")
        log(f"[yardstick]   cold L2 (median of 20): kernel {t['kernel_cold'] * 1e3:.4f} ms, "
            f"cuSPARSE {t['library_cold'] * 1e3:.4f} ms")
        log(f"[yardstick]   bound {b_ms:.4f} ms ({b_by}, K={kb}); kernel's device time at "
            f"{100 * b_ms / dev_t['kernel']:.1f}% of it; format {mib:.1f} MiB"
            + (f", pack {pack:.2f} s" if pack is not None else "")
            + f"; peak device memory of one call {peak / 2**20:.1f} MiB")
        return {"ms": dev_t["kernel"], "plain_ms": dev_t["plain"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": dev_t["library"], "time_fn_ms": k_ms}

    def yardstick(which, label, fmt, a, k, x, whole, pack=None, bound_k=None):
        """``measure`` for a dg or dgt kernel on one format (X padded to
        its kt, or x [N] for dg1)."""
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
        # #1-#4 walk the format's row walk (built at its first use), #1, #3
        # and #4 reading K columns of X padded to kt, #2 x as one column
        walk_of = {"dg": dg.dg_row_walk, "dg1": dg.dg_row_walk, "dgt": dgt.dgt_row_walk,
                   "dgt_stream": dgt.dgt_row_walk}[which]
        walk_kw = dict(walk=walk_of(fmt), **({} if which == "dg1" else dict(k=x2.shape[1])))
        kern = functools.partial(kernels[which]["wrapper"], *args, rb=fmt.rb, **kw, **walk_kw)
        plain = functools.partial(plain_fn, *args, rb=fmt.rb, **kw)
        return measure(which, label, [fmt], a, k, kern, plain, xk, xd, whole, pack, bound_k)

    def win_yardstick(which, label, parts, a, k, x, whole, pack=None, bound_k=None, kt=None):
        """``measure`` for a tile or span kernel over ``parts``, a list of
        (format, first column of X): the launches of one product, X padded
        to the K-tile ``kt`` (by default ``span_spmm``'s: 1 for the span
        kernel on one column, else 8, 16 or 32)."""
        xd = torch.as_tensor(x, device=dev)
        x2 = xd.view(-1, 1) if xd.ndim == 1 else xd
        if kt is None:
            kt = 1 if which == "span" and x2.shape[1] == 1 else \
                tile.choose_kt(min(tile.default_ktile(x2.shape[1]), 32))
        xp = dg.pad_dense_cols(x2, -(-x2.shape[1] // kt) * kt)
        is_tile, stream = which.startswith("tile"), which.endswith("_stream")
        calls = []
        for f, lo in parts:
            start = f.chunk_tile if is_tile else f.c0
            kw = dict(rb=f.rb, kt=kt, mode="fp32x2",
                      **(dict(ct=f.ct) if is_tile or stream else {}))
            walk_kw = {} if is_tile else dict(walk=span.span_row_walk(f), k=x2.shape[1])
            calls.append(((start, f.cols, f.lrow, f.vals, f.nc_p), kw, walk_kw))
        xk = [xp[lo:lo + f.shape[1]].contiguous() for f, lo in parts]

        def run(fn, walk=True):
            return lambda xs_: [fn(*args, xi, **kw, **(wkw if walk else {}))
                                for (args, kw, wkw), xi in zip(calls, xs_)]

        return measure(which, label, [f for f, _ in parts], a, k,
                       run(kernels[which]["wrapper"]), run(kernels[which]["plain"], False), xk,
                       xd, whole, pack, bound_k)

    def rows_yardstick(which, label, fmt, a, k, x, whole, pack=None, kt=None, bound_k=None):
        """``measure`` for the radix or a stripe kernel on one format, X
        zero-padded to the launch's K-tile ``kt`` (by default the radix
        format's kt, or the stripe K-tile for X's columns)."""
        xd = torch.as_tensor(x, device=dev)
        x2 = xd.view(-1, 1) if xd.ndim == 1 else xd
        if which == "radix":  # over the format's row walk, built at its first use
            kt = fmt.kt if kt is None else kt
            args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
            pkw = dict(rb=fmt.rb, kt=kt, mode=fmt.mode)
            kw = dict(pkw, walk=radix.radix_row_walk(fmt), k=x2.shape[1])
        else:
            kt = stripe.choose_kt(x2.shape[1]) if kt is None else kt
            rb = getattr(fmt, "max_rows_per_stripe", None) or fmt.max_segments
            extra = (fmt.wnz, fmt.wrow) if which == "stripe_nested" else ()
            args = (fmt.cols, fmt.lrow, fmt.vals, *extra)
            kw, pkw = dict(rb=rb, kt=kt), dict(rb=rb)
            if which == "stripe":
                kw["live"] = fmt.live_p
        xk = dg.pad_dense_cols(x2, -(-x2.shape[1] // kt) * kt).contiguous()
        kern = functools.partial(kernels[which]["wrapper"], *args, **kw)
        plain = functools.partial(kernels[which]["plain"], *args, **pkw)
        return measure(which, f"{label}, KT={kt}", [fmt], a, k, kern, plain, xk, xd, whole, pack,
                       bound_k)

    best_dg, best_dgt = plan_of(best_by_family["dg_span"]), plan_of(best_by_family["dgt_span"])
    best_tile = plan_of(best_by_family["tile_onehot"])
    f_dg = best_dg.formats[0]
    vs_plain("headline", f_dg, 8, f_dg.kt, f_dg.mode, tol)
    walk_line("dg", "config #1, best dg tune row", dg.dg_row_walk(f_dg), 8)
    dgt_vs_plain("headline", best_dgt.formats[0], 8, tol)
    walk_line("dgt", "config #1, best dgt tune row", dgt.dgt_row_walk(best_dgt.formats[0]), 8)
    win_vs_plain("tile", "headline", best_tile.formats[0], 8, "fp32x2")
    plan1, plan64 = (build_plan(mat, default_schedule(mat, k)) for k in (1, 64))
    vs_plain("headline", plan64.formats[0], 64, plan64.formats[0].kt, "fp32x2", tol)
    walk_line("dg", "config #1, default schedule", dg.dg_row_walk(plan64.formats[0]), 64)
    tile256 = functools.partial(tile.tile_spmm, f256)
    stats = {
        "dg": yardstick("dg", "headline, best dg tune row", best_dg.formats[0], mat, 8,
                        xs[8], best_dg.fn, best_by_family["dg_span"]["pack_seconds"]),
        "dg1": yardstick("dg1", "headline, default schedule", plan1.formats[0], mat, 1,
                         xs[1][:, 0].copy(), lambda v: plan1.fn(v.view(-1, 1))),
        "dgt": yardstick("dgt", "headline, best dgt tune row", best_dgt.formats[0], mat,
                         8, xs[8], best_dgt.fn, best_by_family["dgt_span"]["pack_seconds"]),
        "dgt_stream": yardstick("dgt_stream", "headline, stream_x", fmt_s, mat, 8,
                                xs[8], stream_h),
        "tile": win_yardstick("tile", "headline, resident (P6)", [(f256, 0)], mat, 32, xs[32],
                              tile32, t_pack256),
        "tile_stream": win_yardstick("tile_stream", "headline, spmm default (P1)", [(f256, 0)],
                                     mat, 256, xs[256], tile256, t_pack256),
        "span": win_yardstick("span", "262144^2, the TPU's decision span_colsplit(2) (P2)",
                              [(f, lo) for f, (lo, _) in zip(plan_b8.formats,
                                                             plan_b8.meta["col_ranges"])],
                              big, 8, xb8, plan_b8.fn, sum(plan_b8.meta["pack_seconds"])),
        "span_stream": win_yardstick("span_stream", "headline, best span tune row (P5)",
                                     [(f_span, 0)], mat, 8, xs[8], sstream_h,
                                     best_by_family["span_onehot"]["pack_seconds"]),
        "radix": rows_yardstick("radix", "262144^2, spmm default radix_span (P8)", f_b4, big,
                                4, xb4, plan_b4.fn, t_pack_b4),
        "stripe": rows_yardstick("stripe", "headline, stripe_total merge_path 2048 (P10)",
                                 p10_plans["stripe_merge_path_2048"].formats[0], mat, 8, xs[8],
                                 p10_plans["stripe_merge_path_2048"],
                                 p10_pack["stripe_merge_path_2048"]),
        "stripe_nested": rows_yardstick("stripe_nested", "headline, stripe_nested (P10)",
                                        p10_plans["stripe_nested"].formats[0], mat, 8, xs[8],
                                        p10_plans["stripe_nested"], p10_pack["stripe_nested"]),
    }
    # P8's format with X padded to KT = 8, as the window kernels would run
    # it, and at K = 8 (two K-tiles of 4, or one of 8)
    rows_yardstick("radix", "262144^2, P8's format, K=4 padded", f_b4, big, 4, xb4, plan_b4.fn,
                   kt=8)
    for kt_ in (4, 8):
        rows_yardstick("radix", "262144^2, P8's format at K=8", f_b4, big, 8, xb8, plan_b4.fn,
                       kt=kt_)
    rows_yardstick("radix", "262144^2, spmv_fn('radix') (P12)", f_rv, big, 1, xv,
                   spmv_fns["spmv_radix_262k"], pack_s["spmv_radix_262k"])
    rows_yardstick("radix", "banded 32768^2, brick_ell (P11)", f_be, band, 8, xs[8], plan_be,
                   t_pack_be)
    rows_yardstick("stripe", "headline, nnz_segment (P10)", p10_plans["nnz_segment"].formats[0],
                   mat, 8, xs[8], p10_plans["nnz_segment"], p10_pack["nnz_segment"])
    rows_yardstick("stripe", "262144^2, spmv_fn('stripe') (P12), x as one column", f_stv, big, 1,
                   xv, spmv_fns["spmv_stripe_262k"], pack_s["spmv_stripe_262k"])
    # #5 on P1's product: the kernel #6 runs there, through the resident
    # wrapper (each K-tile of 32 walked the format before)
    win_yardstick("tile", "headline, P1's product on the resident kernel", [(f256, 0)], mat,
                  256, xs[256], tile256)
    # #5 at P13's pruned layer, from_dense(k_hint=512): the resident wrapper
    # at K = 512; the library call is cuSPARSE's SpMM of W
    plan_pw = build_plan(pw, default_schedule(pw, 512))
    win_yardstick("tile", "P13 from_dense(90 % pruned 4096^2, k_hint=512) layer",
                  [(plan_pw.formats[0], 0)], pw, 512, np.ascontiguousarray(xk13, np.float32),
                  plan_pw.fn)
    # #11 at K = 32 on P10's format
    rows_yardstick("stripe_nested", "headline, stripe_nested (P10)", f_nest, mat, 32, xs[32],
                   p10_plans["stripe_nested"], p10_pack["stripe_nested"])
    win_yardstick("span", "headline, best span tune row", [(f_span, 0)], mat, 8, xs[8],
                  best_span.fn, best_by_family["span_onehot"]["pack_seconds"])
    win_yardstick("tile", "headline, best tile tune row", [(best_tile.formats[0], 0)], mat, 8,
                  xs[8], best_tile.fn, best_by_family["tile_onehot"]["pack_seconds"])
    win_yardstick("span_stream", "262144^2, P2's first sub-format (P5)", [(f_b0, 0)], sub0, 8,
                  xb8_0, sstream_b)
    # S1 and S2: the dgt8 SpMV at web-Google's shape; the span SpMV with x
    # as one column (kt 1, the one-column walk) and, as P7 ran it before,
    # widened to 8 (kt 8, the kernel reading a panel of 4)
    f_s1, a_s1, x_s1, fn_s1, pack_s1 = s_sticks["s1"]
    yardstick("dgt", "web-Google 916428^2 spmv dgt8 (S1)", f_s1, a_s1, 1, x_s1, fn_s1, pack_s1)
    f_s2, a_s2, x_s2, fn_s2, pack_s2 = s_sticks.pop("s2")
    win_yardstick("span", "262144^2, spmv_fn('span') (S2), x as one column", [(f_s2, 0)], a_s2,
                  1, x_s2, fn_s2, pack_s2)
    win_yardstick("span", "262144^2, spmv_fn('span')'s format, x widened to 8 (P7 before)",
                  [(f_s2, 0)], a_s2, 1, x_s2, fn_s2, kt=8)
    del s_sticks, f_s1, a_s1, x_s1, fn_s1, f_s2, a_s2, x_s2, fn_s2
    yardstick("dg", "headline, default schedule", plan64.formats[0], mat, 64, xs[64],
              plan64.fn)
    yardstick("dgt", "spmv dgt8", fmt8, big, 1, xv, spmv_fns["spmv_dgt8_262k"],
              pack_s["spmv_dgt8_262k"])
    yardstick("dgt", "spmv_multi_fn(8)", multi.formats[0], big, 8, xb8, multi,
              pack_s["spmv_multi_262k"])
    yardstick("dgt_stream", "spmv size, stream_x", multi.formats[0], big, 8, xb8, stream_b)
    xb64 = np.random.default_rng(4).standard_normal((SPMV_N, 64)).astype(np.float32)
    yardstick("dgt_stream", "spmv size, stream_x, K=64 (X 64 MB, past the L2)",
              multi.formats[0], big, 64, xb64,
              functools.partial(dgt.dgt_spmm, multi.formats[0], stream_x=True))
    yardstick("dg1", "spmv auto", spmv_fns["spmv_auto_262k"].format, big, 1, xv,
              spmv_fns["spmv_auto_262k"], pack_s["spmv_auto_262k"])

    def dense_tile_yardstick(which, label, kern, plain, xk, whole, xw, libs, nbytes, flops,
                             peak, peak_name):
        """Times a dense-tile kernel (``kern(xk)``), its plain version, the
        whole entry-point call ``whole(xw)`` and the library calls ``libs``
        ({name: (fn, arg)}; the first is ``library_ms``), REPS back-to-back
        readings each, interleaved; the bound is the larger of ``nbytes``
        over the HBM rate and ``flops`` over ``peak``."""
        runs = {"kernel": [], "plain": [], "whole": [], **{n: [] for n in libs}}
        for _ in range(REPS):
            runs["kernel"].append(time_fn(kern, xk))
            runs["plain"].append(time_fn(plain, xk))
            runs["whole"].append(time_fn(whole, xw))
            for n, (f, a) in libs.items():
                runs[n].append(time_fn(f, a))
        t = {n: float(np.median(v)) * 1e3 for n, v in runs.items()}
        lib0 = next(iter(libs))
        dev_t = {name: dev_ms(name, f, arg) for name, f, arg in
                 (("kernel", kern, xk), ("plain", plain, xk),
                  *((n, f, a) for n, (f, a) in libs.items()))}
        cold = time_cold(kern, xk) * 1e3
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        log(f"[yardstick] {kernels[which]['name']} {label}  ({power})")
        log(f"[yardstick]   back to back, median of {REPS}: kernel {t['kernel']:.4f} ms "
            f"({flops / t['kernel'] / 1e6:.1f} GFLOP/s), plain {t['plain']:.4f} ms, whole call "
            f"{t['whole']:.4f} ms; " + ", ".join(f"{n} {t[n]:.4f} ms" for n in libs))
        log(f"[yardstick]   readings (ms): kernel "
            + " ".join(f"{v * 1e3:.4f}" for v in runs["kernel"]))
        log(f"[yardstick]   device time a call (profiler, 20 calls): kernel "
            f"{dev_t['kernel']:.4f} ms, plain {dev_t['plain']:.4f} ms, "
            + ", ".join(f"{n} {dev_t[n]:.4f} ms" for n in libs))
        log(f"[yardstick]   cold L2 (median of 20): kernel {cold:.4f} ms")
        log(f"[yardstick]   bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
            f"{t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP at {peak_name} = {t_ops:.4f} ms); "
            f"kernel's device time at {100 * b_ms / dev_t['kernel']:.1f}% of it")
        return {"ms": dev_t["kernel"], "plain_ms": dev_t["plain"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": dev_t[lib0], "time_fn_ms": t["kernel"]}

    # #12 at P13's shapes: K = 128 (nm_spmm) and K = 512 (the layer), bf16
    # and fp32 modes; the library call is cuBLAS's dense bf16 product
    w13_bf16 = torch.as_tensor(w13, device=dev).bfloat16()
    w13_f32 = torch.as_tensor(w13, device=dev)
    xk13_t = torch.as_tensor(xk13.astype(np.float32), device=dev).contiguous()

    def nm_stats(fmt, x, mode, label, whole, xw):
        kw = dict(group=fmt.group, packed_bits=fmt.packed_bits, mode=mode)
        k = x.shape[1]
        nbytes = fmt.memory_bytes + (x.numel() + fmt.m_pad * k) * 4
        flops = 2.0 * fmt.nnz * k
        if mode == "bf16":
            libs = {"cuBLAS dense bf16 mm": (functools.partial(torch.mm, w13_bf16,
                                                                out_dtype=torch.float32),
                                             x.bfloat16())}
            peak, peak_name = BF16_TC_FLOPS_PER_S, "989 TFLOP/s (bf16 dense tensor cores)"
        else:
            libs = {"cuBLAS dense fp32 mm": (functools.partial(torch.mm, w13_f32), x)}
            peak, peak_name = FP32_FLOPS_PER_S, "67 TFLOP/s (fp32, CUDA cores)"
        return dense_tile_yardstick(
            "nm", label, functools.partial(nm.nm_rows_cuda, fmt.vals, fmt.offs, **kw),
            functools.partial(nm.nm_rows_plain, fmt.vals, fmt.offs, **kw), x, whole, xw, libs,
            nbytes, flops, peak, peak_name)

    nm_k128 = nm_stats(f13, x128, "bf16", "P13 nm_spmm, 2:4 bf16, K=128",
                       functools.partial(nm.nm_spmm, f13), x128)
    nm_stats(fmt13["fp32"], x128, "fp32", "P13 nm_spmm, 2:4 fp32, K=128",
             functools.partial(nm.nm_spmm, fmt13["fp32"], precision="fp32"), x128)
    nm_stats(fmt13["int8"], x128, "bf16", "P13 nm_spmm, 2:4 int8 (W8A16), K=128",
             functools.partial(nm.nm_spmm, fmt13["int8"]), x128)
    nm_stats(f13, xk13_t, "bf16", "P13 SparseLinear.from_nm(bf16), K=512", layers13["bf16"],
             x13)
    nm_stats(fmt13["fp32"], xk13_t, "fp32", "P13 SparseLinear.from_nm(fp32), K=512",
             layers13["fp32"], x13)
    nm_stats(fmt13["int8"], xk13_t, "bf16", "P13 SparseLinear.from_nm(int8, W8A16), K=512",
             layers13["int8"], x13)
    # a prefill batch: x [16, 128, 4096], K = 2048 folded
    x2048 = torch.as_tensor(rng13.standard_normal((4096, 2048)), dtype=torch.float32,
                            device=dev)
    nm_vs_plain("p13", f13, x2048, "bf16")
    nm_stats(f13, x2048, "bf16", "P13 nm_spmm, 2:4 bf16, K=2048 (prefill)",
             functools.partial(nm.nm_spmm, f13), x2048)
    log(f"[yardstick]   P13 mode='throughput' layer (dense bf16 product), median of {REPS}: "
        + f"{float(np.median([time_fn(layer13_t, x13) for _ in range(REPS)])) * 1e3:.4f} ms")

    # #13 at P14's shapes, K = 256: the library calls are cuBLAS's dense
    # product and the batched product of the xla method (which gathers X
    # tiles first); the bytes count the real blocks (the kernel skips the
    # padded slots), X and Y
    d14_bf16 = torch.as_tensor(d14.astype(np.float32), device=dev).bfloat16()
    d14_f32 = torch.as_tensor(d14.astype(np.float32), device=dev)

    def bell_stats(fmt, mode, label, whole, xw):
        # int8: X^T's transposed view, as bell_int8 hands it to the kernel
        x = xq14.t().contiguous().t() if mode == "int8" else xp14
        args = (fmt.blkcol, fmt.blkvals, fmt.nb_p)
        k = x.shape[1]
        real = fmt.n_blocks * fmt.bs * fmt.bs * fmt.blkvals.element_size()
        nbytes = real + fmt.blkcol.numel() * 4 + x.numel() * x.element_size() + \
            fmt.mb * fmt.bs * k * 4
        flops = 2.0 * fmt.n_blocks * fmt.bs * fmt.bs * k
        if mode == "fp32":
            libs = {"cuBLAS dense fp32 mm": (functools.partial(torch.mm, d14_f32), x),
                    "xla-method batched product": (lambda v: be.bell_batched(fmt, v, "fp32"),
                                                   x)}
            peak, peak_name = FP32_FLOPS_PER_S, "67 TFLOP/s (fp32, CUDA cores)"
        elif mode == "bf16":
            libs = {"cuBLAS dense bf16 mm": (functools.partial(torch.mm, d14_bf16,
                                                                out_dtype=torch.float32),
                                             x.bfloat16()),
                    "xla-method batched product": (lambda v: be.bell_batched(fmt, v, "bf16"),
                                                   x)}
            peak, peak_name = BF16_TC_FLOPS_PER_S, "989 TFLOP/s (bf16 dense tensor cores)"
        else:  # the format's own int8 blocks, placed in a dense int8 matrix
            q, bc, nb = (t.cpu().numpy() for t in (fmt.blkvals, fmt.blkcol, fmt.nb_p))
            dq = np.zeros((fmt.mb * fmt.bs, x.shape[0]), np.int8)
            for i in range(fmt.mb):
                for j in range(nb[i]):
                    dq[i * fmt.bs:(i + 1) * fmt.bs, bc[i, j] * fmt.bs:(bc[i, j] + 1) * fmt.bs] = \
                        q[i, j]
            libs = {"torch._int_mm dense int8": (
                functools.partial(torch._int_mm, torch.as_tensor(dq, device=dev)), xq14)}
            peak, peak_name = 1979e12, "1979 TOP/s (int8 dense tensor cores)"
        return dense_tile_yardstick(
            "bell", label, functools.partial(be.bell_rows_cuda, *args, mode=mode, work=fmt.work),
            lambda v: be.bell_rows_plain(*args, v.contiguous(), mode=mode), x, whole, xw, libs,
            nbytes, flops, peak, peak_name)

    bell_bf16 = bell_stats(f14, "bf16", "P14 block_ell_spmm(pallas), bf16, K=256",
                           functools.partial(be.block_ell_spmm, f14, precision="bf16",
                                             method="pallas"), xk14)
    bell_stats(fmt14["fp32"], "fp32", "P14 block_ell_spmm(pallas), fp32, K=256",
               functools.partial(be.block_ell_spmm, fmt14["fp32"], precision="fp32",
                                 method="pallas"), xk14)
    layer14_i8 = SparseLinear.from_block(a14, precision="int8")
    bell_stats(fmt14["int8"], "int8", "P14 SparseLinear.from_block(int8, W8A8), K=256",
               layer14_i8, x14)
    for prec in ("bf16", "fp32"):  # L4: the card's default beside the TPU's, one run
        layer14 = SparseLinear.from_block(a14, precision=prec)
        log(f"[l4] P14 SparseLinear.from_block({prec}) (the kernel, #13), median of {REPS}: "
            + f"{float(np.median([time_fn(layer14, x14) for _ in range(REPS)])) * 1e3:.4f} ms "
            f"by time_fn  ({power})")

    stats["nm"], stats["bell"] = nm_k128, bell_bf16

    # #14 and #15 at T1's shapes: the trainable layer's format, K = 512, the
    # first step's dY; the library calls are cuSPARSE's SDDMM
    # (torch.sparse.sampled_addmm on W's CSR pattern) and its SpMM of W^T
    # (torch.sparse.mm); "whole call" is one whole training step
    m_out, n_in = pw.shape
    inv1 = torch.from_numpy(sd.origrow_of_slot(f1)).to(dev, torch.long)
    dyk_t = dyk0.T.contiguous()                                    # dY [out, K]
    dy_slots1 = sd.rows_to_slots(dyk_t, inv1)                      # [P*rb, K]
    xk1 = xk0.T.contiguous()                                       # X [in, K]
    vals1 = (layer1.vals.detach() * mask1).contiguous()
    planes1 = (f1.c0, f1.cols, f1.lrow)
    kw1 = dict(rb=f1.rb, kt=32, mode="fp32x2")
    slots1 = f1.n_programs * f1.n_chunks * f1.chunk_g
    plane_bytes = 4 * f1.n_programs * f1.n_chunks + 8 * slots1    # c0, cols, lrow
    rows_bytes = 4 * f1.n_programs * f1.rb * k1                    # dY_slots
    flops1 = 2.0 * pw.nnz * k1
    fp32_peak = (FP32_FLOPS_PER_S, "67 TFLOP/s (fp32, CUDA cores)")

    def sparse_step(xb):
        """One training step of T1's layer: forward, both gradients, Adam."""
        xs = xb.detach().requires_grad_(True)
        opt1.zero_grad(set_to_none=True)
        loss = torch.nn.functional.mse_loss(layer1(xs), t1)
        loss.backward()
        opt1.step()
        return loss.detach()

    pw_csr, pwt_csr = csr_of(pw), csr_of(pw.transpose())
    geo1 = f"({f1.n_programs}, {f1.n_chunks}, {f1.chunk_g})"
    tiles1 = sd.sddmm_tiles(f1)
    # #14's bytes: the tile index (row, column, slot), dY_slots and X once,
    # dv; its operations: the sampled products, 2 * nnz * K at the fp32 peak
    idx_bytes = tiles1.nbytes + rows_bytes + 4 * n_in * k1 + 4 * slots1
    for mode in ("fp32x2", "bf16"):
        kw_m = dict(kw1, mode=mode)
        libs = {"cuSPARSE SDDMM (sampled_addmm)": (
            lambda m1: torch.sparse.sampled_addmm(pw_csr, m1, xk0, beta=0.0), dyk_t),
                "cuBLAS dense fp32 mm (dY . X^T, TF32 off)": (
            functools.partial(torch.mm, dyk_t), xk0)}
        st = dense_tile_yardstick(
            "sddmm", f"T1 span_sddmm, pruned 4096^2 planes {geo1}, K={k1}, {mode}",
            lambda d, kw_m=kw_m: sd.sddmm_rows_cuda(*planes1, f1.nc_p, d, xk1, **kw_m,
                                                    tiles=tiles1),
            lambda d, kw_m=kw_m: sd.sddmm_rows_plain(*planes1, f1.nc_p, d, xk1, **kw_m),
            dy_slots1, sparse_step, x1, libs, idx_bytes, flops1, *fp32_peak)
        stats.setdefault("sddmm", st)
    # #14 on config #1's pattern at K = 8: every tile sparse, the per-slot path
    tiles_c1 = sd.sddmm_tiles(f_c1)
    xc1 = torch.as_tensor(xs[8], device=dev)
    dyc1 = torch.as_tensor(np.random.default_rng(25).standard_normal(
        (f_c1.n_programs * f_c1.rb, 8)), dtype=torch.float32, device=dev)
    kw_c1 = dict(rb=f_c1.rb, kt=8, mode="fp32x2")
    planes_c1 = (f_c1.c0, f_c1.cols, f_c1.lrow, f_c1.nc_p)
    dyc1_m = torch.as_tensor(np.random.default_rng(26).standard_normal((M, 8)),
                             dtype=torch.float32, device=dev)    # a dY in Y's row order
    mat_csr, xc1_t = csr_of(mat), xc1.T.contiguous()
    dense_tile_yardstick(
        "sddmm", "config #1's pattern (span rb 512 ct 512 g 128), K=8, fp32x2: per-slot path",
        lambda d: sd.sddmm_rows_cuda(*planes_c1, d, xc1, **kw_c1, tiles=tiles_c1),
        lambda d: sd.sddmm_rows_plain(*planes_c1, d, xc1, **kw_c1), dyc1,
        lambda d: sd.span_sddmm(f_c1, d, xc1), dyc1,
        {"cuSPARSE SDDMM (sampled_addmm)": (
            lambda m1: torch.sparse.sampled_addmm(mat_csr, m1, xc1_t, beta=0.0),
            dyc1_m)},
        tiles_c1.nbytes + 4 * (dyc1.numel() + xc1.numel() + f_c1.cols.numel()),
        2.0 * mat.nnz * 8, *fp32_peak)
    # #15 at T1 in fp32x2 and bf16, against cuSPARSE's SpMM of W^T and
    # cuBLAS's dense fp32 W^T . dY (TF32 off); its bytes: the column index,
    # the value plane, dY_slots and dX once; its operations 2 * nnz * K
    index1 = sd.dx_index(f1)
    wt_dense = torch.zeros((n_in, m_out), device=dev)
    wt_dense[cols_t, rows_t] = torch.as_tensor(pw.vals, dtype=torch.float32, device=dev)
    dx_bytes = index1.nbytes + 4 * slots1 + rows_bytes + 4 * n_in * k1
    for mode in ("fp32x2", "bf16"):
        kw_m = dict(kw1, mode=mode)
        st = dense_tile_yardstick(
            "dx", f"T1 span_dx, pruned 4096^2 planes {geo1}, K={k1}, {mode}",
            lambda d, kw_m=kw_m: sd.dx_rows_cuda(*planes1, vals1, f1.nc_p, d, n=n_in, **kw_m,
                                                 index=index1),
            lambda d, kw_m=kw_m: sd.dx_rows_plain(*planes1, vals1, f1.nc_p, d, n=n_in, **kw_m),
            dy_slots1, sparse_step, x1,
            {"cuSPARSE SpMM of W^T (torch.sparse.mm)": (
                functools.partial(torch.sparse.mm, pwt_csr), dyk_t),
             "cuBLAS dense fp32 mm (W^T . dY, TF32 off)": (
                functools.partial(torch.mm, wt_dense), dyk_t)},
            dx_bytes, flops1, *fp32_peak)
        stats.setdefault("dx", st)
    del wt_dense
    # #15 on config #1's pattern at K = 8: most windows sparse (their dY
    # rows read from L2), against cuSPARSE's SpMM of A^T
    index_c1 = sd.dx_index(f_c1)
    vals_c1 = f_c1.vals.float().contiguous()
    mat_t_csr = csr_of(mat.transpose())
    dense_tile_yardstick(
        "dx", "config #1's pattern (span rb 512 ct 512 g 128), K=8, fp32x2: sparse windows",
        lambda d: sd.dx_rows_cuda(*planes_c1[:3], vals_c1, f_c1.nc_p, d, n=N, **kw_c1,
                                  index=index_c1),
        lambda d: sd.dx_rows_plain(*planes_c1[:3], vals_c1, f_c1.nc_p, d, n=N, **kw_c1), dyc1,
        lambda d: sd.span_dx(f_c1, vals_c1, d), dyc1,
        {"cuSPARSE SpMM of A^T (torch.sparse.mm)": (
            functools.partial(torch.sparse.mm, mat_t_csr), dyc1_m)},
        index_c1.nbytes + 4 * (f_c1.cols.numel() + dyc1.numel() + N * 8), 2.0 * mat.nnz * 8,
        *fp32_peak)

    def t1_forward(_):
        with torch.no_grad():
            return layer1(x1)

    # #7 at T1: the forward's span kernel at K = 512 on the layer's planes,
    # against cuSPARSE's SpMM of W; "whole call" is the layer's forward
    win_yardstick("span", f"T1 forward, pruned 4096^2 planes {geo1}", [(f1, 0)], pw, k1, xk1,
                  t1_forward)

    class Bf16Mm(torch.autograd.Function):
        """x @ W^T on bf16 operands with an fp32 result, both gradients the
        same way (matmul_f32: cuBLAS with out_dtype=float32)."""

        @staticmethod
        def forward(ctx, xk, w):
            ctx.save_for_backward(xk, w)
            return matmul_f32(xk.bfloat16(), w.bfloat16().t().contiguous())

        @staticmethod
        def backward(ctx, dy):
            xk, w = ctx.saved_tensors
            dyb = dy.bfloat16()
            return (matmul_f32(dyb, w.bfloat16()),
                    matmul_f32(dyb.t().contiguous(), xk.bfloat16()))

    def dense_step(prec):
        """The same training step on the dense 4096^2 W (zeros included)."""
        w = torch.nn.Parameter(w0.clone())
        b = torch.nn.Parameter(torch.zeros(m_out, device=dev))
        opt = torch.optim.Adam([w, b], lr=2e-2)

        def step(xb):
            xs = xb.detach().requires_grad_(True)
            opt.zero_grad(set_to_none=True)
            xk = xs.reshape(-1, n_in)
            yk = xk @ w.T if prec == "fp32" else Bf16Mm.apply(xk, w)
            loss = torch.nn.functional.mse_loss((yk + b).reshape(t1.shape), t1)
            loss.backward()
            opt.step()
            return loss.detach()

        return step

    steps_t = {"sparse (TrainableSparseLinear)": sparse_step,
               "dense fp32": dense_step("fp32"), "dense bf16 (fp32 out)": dense_step("bf16")}
    step_runs = {name: [] for name in steps_t}
    for _ in range(REPS):
        for name, f in steps_t.items():
            step_runs[name].append(time_fn(f, x1, iters=10))
    step_ms = {name: float(np.median(v)) * 1e3 for name, v in step_runs.items()}
    log(f"[yardstick] T1 training step (forward, both gradients, Adam), x [4, 128, 4096], "
        f"median of {REPS} x 10 steps: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                                     step_ms.items()) + f"  ({power})")
    for name, v in step_runs.items():
        log(f"[yardstick]   readings (ms) {name}: " + " ".join(f"{t * 1e3:.4f}" for t in v))
    if not all(bool(torch.isfinite(f(x1))) for f in steps_t.values()):
        raise AssertionError("a timed training step gave a loss that is not finite")

    # ---- 8. where the time of one call goes: the tuner's winner at K = 8,
    # P1 (K = 256) and P2 (262144^2, K = 8); with ``host_ops``, the host
    # ops that took longest too
    from torch.profiler import ProfilerActivity, profile

    def profile_call(label, fn, x, calls=20, host_ops=0):
        def back_to_back():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(x)
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
        log(f"[profile] {label}, {calls} calls back to back (warm L2), per call: host wall "
            f"{plain_wall_us:.1f} us ({wall_us:.1f} us under the profiler), device busy "
            f"{busy:.1f} us"
            + (f", device idle share {max(0.0, 1 - busy / plain_wall_us):.2f}" if busy else
               " (the profiler saw no device time: not measured)"))
        for key, (t_dev, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:8]:
            log(f"[profile]   {t_dev:8.2f} us  x{n:g}  {key[:90]}")
        host = sorted((e for e in prof.key_averages()  # the profiler's own set-up left out
                       if e.device_type == torch.autograd.DeviceType.CPU
                       and e.key != "Activity Buffer Request"),
                      key=lambda e: -e.self_cpu_time_total)[:host_ops]
        for e in host:
            log(f"[profile]   host {e.self_cpu_time_total / calls:8.2f} us  "
                f"x{e.count / calls:g}  {e.key[:80]}")

    profile_call(f"spmm K=8 tune winner ({best.family})", win.fn,
                 torch.as_tensor(xs[8], device=dev))
    profile_call("P1 spmm K=256 (tile_onehot, stream kernel)", plan256.fn,
                 torch.as_tensor(xs[256], device=dev), calls=10)
    profile_call("P2 spmm 262144^2 K=8, the card's default (dg_span)", plan_b8c.fn,
                 torch.as_tensor(xb8, device=dev), calls=10)
    profile_call("P2 spmm 262144^2 K=8, the TPU's decision (span_colsplit(2))", plan_b8.fn,
                 torch.as_tensor(xb8, device=dev), calls=10)
    profile_call("SpMV 262144^2 spmv_fn('dgt8') (#3)", spmv_fns["spmv_dgt8_262k"],
                 torch.as_tensor(xv, device=dev), calls=10)
    profile_call("SpMV 262144^2 spmv_fn('auto') (#2)", spmv_fns["spmv_auto_262k"],
                 torch.as_tensor(xv, device=dev), calls=10)
    profile_call("P8 spmm 262144^2 K=4 (radix_span, on both records)", plan_b4.fn,
                 torch.as_tensor(xb4, device=dev), calls=10)
    profile_call("P13 SparseLinear.from_nm(bf16), x [4, 128, 4096]", layers13["bf16"], x13)
    profile_call("P13 SparseLinear.from_dense(k_hint=512) (tile_onehot, #5), x [4, 128, 4096]",
                 layer_pw, x13)
    profile_call("P10 stripe_nested K=8 (#11)", p10_plans["stripe_nested"],
                 torch.as_tensor(xs[8], device=dev))
    profile_call("P10 stripe_total merge path 2048 K=8 (#10)", p10_plans["stripe_merge_path_2048"],
                 torch.as_tensor(xs[8], device=dev))
    profile_call("P12 SpMV 262144^2 spmv_fn('stripe') (#10)", spmv_fns["spmv_stripe_262k"],
                 torch.as_tensor(xv, device=dev), calls=10)
    profile_call("P15 hybrid_cols C=512 (bf16 panel + dg remainder), column-skewed, K=8",
                 hyb_plans[512], torch.as_tensor(xs[8], device=dev))
    for name, f in steps_t.items():
        profile_call(f"T1 training step, {name}, 4096^2, x [4, 128, 4096]", f, x1, calls=10)
    profile_call("G1 pagerank_fn(tol=0, max_iter=20) 262144^2, one run of 20 iterations "
                 "(#2 each, a host sync each)", lambda _: pr_run(), None, calls=3)
    for label, (f, x_, calls) in s_profiles.items():
        profile_call(label, f, x_, calls=calls)
    for label, (f, x_, calls) in l_profiles.items():
        profile_call(label, f, x_, calls=calls)
    del l_profiles
    profile_call("P14 block_ell_spmm(pallas, bf16), K=256",
                 functools.partial(be.block_ell_spmm, f14, precision="bf16", method="pallas"),
                 xk14)
    # the small calls where the suite found the port's winners behind
    # cuSPARSE: the suite's 16384^2 power law (avg 16, seed 1) at K = 8 by
    # its default plan and by cuSPARSE, and its quick SpMV matrix
    # (65536^2, avg 40, seed 9) by spmv_fn('dg') (#2)
    s16 = builder.power_law_coo(16384, 16384, avg_nnz_per_row=16.0, seed=1)
    x16 = torch.as_tensor(np.random.default_rng(0).standard_normal((16384, 8)),
                          dtype=torch.float32, device=dev)
    s16_sched = default_schedule(s16, 8)
    s16_csr = s16.to_csr_tensor(device=dev)
    profile_call(f"suite 16384^2 power law K=8, default plan ({s16_sched.family})",
                 build_plan(s16, s16_sched, device=dev).fn, x16, host_ops=6)
    profile_call("suite 16384^2 power law K=8, cuSPARSE", lambda v: torch.sparse.mm(s16_csr, v),
                 x16, host_ops=6)
    s65 = builder.power_law_coo(65536, 65536, avg_nnz_per_row=40.0, seed=9)
    profile_call("suite quick SpMV 65536^2, spmv_fn('dg') (#2)", spmv_fn(s65, "dg", device=dev),
                 torch.as_tensor(np.random.default_rng(4).standard_normal(65536),
                                 dtype=torch.float32, device=dev), host_ops=6)
    del s16_csr, s65
    log(f"[tune] winners: headline K=256 {tune256_winner[0]} {tune256_winner[1] * 1e3:.4f} ms; "
        f"column-skewed K=8 {tune_cs_winner[0]} {tune_cs_winner[1] * 1e3:.4f} ms  ({power})")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    line = {"kernels": [
        {"name": rec["name"], "kernel": KERNEL_OF[w], "route": "cuda", "source": rec["source"],
         "replaces": rec["replaces"], "launches": launches[w],
         "launches_by_path": rec["paths"], "max_abs_err": rec["err"], **stats[w]}
        for w, rec in kernels.items()]}
    log(power)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
