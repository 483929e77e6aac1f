#!/usr/bin/env python3
"""Smoke run of tpusparse_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from tpusparse_torch/csrc, holds each against its
plain PyTorch version on the card, drives the default SpMM path through
the entry points a user calls (``tpusparse_torch.spmm`` at K = 8, 1 and 64,
then ``tune``) at the headline size — a power-law 32768 x 32768 matrix with
about 1.0M nonzeros (alpha 1.8, seed 42) — checks every result against the
host oracle, and times the winner's kernels against their bound, their
plain versions and cuSPARSE.  Any failure raises and the exit code is not
0.  It exits non-zero before printing any result when no CUDA device is
present or the package cannot be imported.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists every
ported kernel as JSON.
"""

from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, published
SOURCE = "tpusparse_torch/csrc/dg_gather.cu"


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
        from tpusparse_torch.oracle import check_result, spmm_reference
        from tpusparse_torch.schedule import build_plan, default_schedule
        from tpusparse_torch.tune import tune
    except ImportError as e:
        print(f"chip_smoke: cannot import tpusparse_torch ({e}); run it from the repo root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kernels = {  # the ported kernels, by their wrapper
        "dg": {"wrapper": dg.dg_rows_cuda, "name": "dg_rows_cuda",
               "replaces": "tpusparse/kernels/dg_gather.py:318", "err": 0.0},
        "dg1": {"wrapper": dg.dg1_rows_cuda, "name": "dg1_rows_cuda",
                "replaces": "tpusparse/kernels/dg_gather.py:382", "err": 0.0},
    }

    # ---- 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    power = power_line()
    log(f"[device] {kind} x{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {power}")

    # ---- 2. build
    info = build.build()
    for name, rec in info.items():
        log(f"[build] {name}.cu: {rec['seconds']:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "error", "warning")):
                log(f"[build]   {line.strip()}")

    # ---- 3. each kernel against its plain version, on the card
    def vs_plain(label, fmt, k, kt, mode, tol):
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((fmt.shape[1], k)),
                            dtype=torch.float32, device=dev)
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
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want, scale)
        branch = ("shared tile" if kt == 1 or dg.dg_uses_shared_tile(fmt.rb, kt)
                  else "global atomics")
        log(f"[kernel] {kernels[which]['name']} ({kernels[which]['replaces']}) {label} "
            f"kt={kt} {mode} K={k} rb={fmt.rb}: max rel err "
            f"{rel:.2e} (tol {tol:g}), max abs err {ab:.2e}, {branch}")
        if not rel <= tol:
            raise AssertionError(f"{kernels[which]['name']} disagrees with its plain version: "
                                 f"{rel:.3e}")
        if label == "headline":
            kernels[which]["err"] = max(kernels[which]["err"], ab)

    small = builder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=0)
    mat = builder.power_law_coo(M, N, avg_nnz_per_row=AVG_NNZ_PER_ROW, alpha=ALPHA, seed=SEED)
    log(f"[matrix] headline: {M}x{N}, nnz={mat.nnz}, power law alpha={ALPHA} seed={SEED}")
    # The kernel and its plain version form the same products (bf16 rounds
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

    # ---- 4. the main path: spmm through the default schedule, then tune.
    # Each path runs with every count set to 0 just before it and read just
    # after, so each kernel's launches are known path by path.
    def zero_counts():
        for rec in kernels.values():
            rec["wrapper"].launches = 0

    def read_counts(path):
        for w, rec in kernels.items():
            rec["paths"][path] = rec["wrapper"].launches

    for rec in kernels.values():
        rec["paths"] = {}
    xs = {}
    for k, which in ((8, "dg"), (1, "dg1"), (64, "dg")):
        x = np.random.default_rng(0).standard_normal((N, k)).astype(np.float32)
        xs[k] = x
        zero_counts()
        t0 = time.perf_counter()
        y = tpusparse_torch.spmm(mat, x)          # no device given: the card
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        read_counts(f"spmm_k{k}")
        sched = default_schedule(mat, k)
        assert y.is_cuda and y.shape == (M, k) and bool(torch.isfinite(y).all())
        check_result(y.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)
        n_l = kernels[which]["paths"][f"spmm_k{k}"]
        log(f"[spmm] K={k}: {sched.family} rb={sched.rb} ns={sched.ns} g={sched.g} "
            f"ktile={sched.ktile}: oracle ok at rtol 2e-3, {n_l} launch(es) of "
            f"{kernels[which]['name']}, first call {dt:.2f} s (packing included)")
        if n_l < 1:
            raise AssertionError(f"spmm K={k} did not launch {kernels[which]['name']}")

    # ---- 5. tune over the dg candidates at the headline size
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpusparse_torch",
                         "_build", "tune_cache")
    with tpusparse_torch.config_override(cache_dir=cache):
        zero_counts()
        res = tune(mat, xs[8], use_cache=False)
        read_counts("tune_k8")
    for row in res.table:
        s = row["schedule"]
        if not row["ok"]:
            raise AssertionError(f"tune candidate failed: {row['error']}")
        log(f"[tune] dg rb={s['rb']} ns={s['ns']} g={s['g']} kt={s['ktile']} "
            f"{s['precision']}: {row['seconds'] * 1e3:.4f} ms, {row['gflops']:.2f} GF/s, "
            f"pad {row['padding_rate']:.3f}  ({power})")
    best = res.best_schedule
    tune_launches = kernels["dg"]["paths"]["tune_k8"]
    log(f"[tune] winner: rb={best.rb} ns={best.ns} g={best.g} kt={best.ktile}, "
        f"{res.best_seconds * 1e3:.4f} ms; {tune_launches} launches of dg_rows_cuda")
    if tune_launches < 1:
        raise AssertionError("tune did not launch dg_rows_cuda")
    launches = {w: sum(rec["paths"].values()) for w, rec in kernels.items()}
    for w, n_l in launches.items():
        if n_l < 1:
            raise AssertionError(f"the main path never launched {kernels[w]['name']}")
    for w, rec in kernels.items():
        log(f"[path] launches of {rec['name']} by path: {rec['paths']}")
    # the tuner's winner, held against its plain version at its own geometry
    win = res.best
    vs_plain("headline", win.formats[0], 8, win.formats[0].kt, win.formats[0].mode, tol)

    # ---- 6. yardsticks: kernel, plain version, whole call, cuSPARSE, bound
    rows_t = torch.from_numpy(mat.rows)
    crow = torch.zeros(M + 1, dtype=torch.int64)
    crow[1:] = torch.cumsum(torch.bincount(rows_t, minlength=M), 0)
    a_csr = torch.sparse_csr_tensor(crow, torch.from_numpy(mat.cols),
                                    torch.from_numpy(mat.vals.astype(np.float32)),
                                    size=(M, N)).to(dev)

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

    def yardstick(which, k, plan, kt, mode):
        fmt = plan.formats[0]
        args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        x = torch.as_tensor(xs[k], device=dev)
        if which == "dg1":
            xk = x[:, 0].contiguous()
            kern = lambda v: dg.dg1_rows_cuda(*args, v, rb=fmt.rb)
            plain = lambda v: dg.dg1_rows_plain(*args, v, rb=fmt.rb)
            lib = lambda v: torch.sparse.mm(a_csr, v)
        else:
            xk = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
            kern = lambda v: dg.dg_rows_cuda(*args, v, rb=fmt.rb, kt=kt, mode=mode)
            plain = lambda v: dg.dg_rows_plain(*args, v, rb=fmt.rb, kt=kt, mode=mode)
            lib = lambda v: torch.sparse.mm(a_csr, v)
        t = {"plain": time_fn(plain, xk), "kernel": time_fn(kern, xk),
             "library": time_fn(lib, x),
             "spmm": time_fn(plan.fn, x)}
        t["kernel2"] = time_fn(kern, xk)
        t["plain2"] = time_fn(plain, xk)
        t["kernel_cold"] = time_cold(kern, xk)
        t["library_cold"] = time_cold(lib, x)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        plan.fn(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        b_ms, b_by = bound_ms(mat.nnz, M, N, k)
        k_ms = min(t["kernel"], t["kernel2"]) * 1e3
        p_ms = min(t["plain"], t["plain2"]) * 1e3
        log(f"[yardstick] {kernels[which]['name']} K={k} rb={fmt.rb} ns={fmt.ns} "
            f"g={fmt.chunk_g} pad={fmt.padding_rate:.3f}  ({power})")
        log(f"[yardstick]   kernel {t['kernel'] * 1e3:.4f} / {t['kernel2'] * 1e3:.4f} ms "
            f"({gflops(mat.nnz, k, k_ms / 1e3):.1f} GF/s), plain {t['plain'] * 1e3:.4f} / "
            f"{t['plain2'] * 1e3:.4f} ms, whole spmm call {t['spmm'] * 1e3:.4f} ms, "
            f"cuSPARSE {t['library'] * 1e3:.4f} ms (back to back)")
        log(f"[yardstick]   cold L2 (median of 20): kernel {t['kernel_cold'] * 1e3:.4f} ms, "
            f"cuSPARSE {t['library_cold'] * 1e3:.4f} ms")
        log(f"[yardstick]   bound {b_ms:.4f} ms ({b_by}); kernel at "
            f"{100 * b_ms / k_ms:.1f}% of it; format {fmt.memory_bytes / 2**20:.1f} MiB; "
            f"peak device memory of one call {peak / 2**20:.1f} MiB")
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": t["library"] * 1e3}

    kt_win = win.formats[0].kt
    stats = {"dg": yardstick("dg", 8, win, kt_win, win.formats[0].mode),
             "dg1": yardstick("dg1", 1, build_plan(mat, default_schedule(mat, 1)), 1, "fp32x2")}
    yardstick("dg", 64, build_plan(mat, default_schedule(mat, 64)), 32, "fp32x2")

    # ---- 7. where the time of one spmm call goes (the tuner's winner, K=8)
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
    log(f"[profile] spmm K=8 winner, {calls} calls back to back (warm L2), per call: "
        f"host wall {plain_wall_us:.1f} us ({wall_us:.1f} us under the profiler), "
        f"device busy {busy:.1f} us"
        + (f", device idle share {max(0.0, 1 - busy / plain_wall_us):.2f}" if busy else
           " (the profiler saw no device time: not measured)"))
    for key, (t_dev, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {t_dev:8.2f} us  x{n:g}  {key[:90]}")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    line = {"kernels": [
        {"name": rec["name"], "route": "cuda", "source": SOURCE,
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
