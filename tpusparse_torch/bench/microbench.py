"""The card's own readings behind the roofline (counterpart of
``tpusparse/bench/microbench.py``).

Measured on the attached card:

  stream_gbs    an elementwise pass over a 512 MiB fp32 tensor (read and
                write): the roofline's stream rate
  reduce_gbs    a column reduction of the same tensor (read only)
  mxu_tflops    cuBLAS's bf16 product at 8192^3 with an fp32 result: the
                tensor cores' peak
  fp32_tflops   cuBLAS's fp32 product at 8192^3 with TF32 off: the CUDA
                cores' fp32 peak
  family_cost   device ns per nonzero of each schedule family's plan at
                config #1 (power-law 32768^2, about 1.0M nonzeros), K = 8,
                through ``build_plan``

The products are cuBLAS's: the probe measures the card's peak and ports no
kernel.  The JAX module's VPU probe (``measure_vpu``) has no counterpart:
it timed the TPU's vector-register issue rate, which bound its one-hot
gather kernels; the card's kernels walk slots instead.

``python -m tpusparse_torch.bench.microbench`` appends JSON rows to
MICROBENCH.jsonl under the config cache_dir.  ``roofline_bandwidth_gbs()``
measures the stream once per card and caches a reading within
``PROBE_BOUNDS`` there, for callers without a session probe; the suite
and the zoo take their rates from their own run's probe.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from tpusparse_torch.config import get_config
from tpusparse_torch.kernels.common import matmul_f32, resolve_device

CONFIG1 = dict(m=32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)  # bench.py:137-142


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probe measures the card; asked for {dev}")
    return dev


def measure_hbm(nbytes: int = 1 << 29, device="cuda") -> dict:
    """Stream (read + write) and reduction (read) rates over an fp32 tensor
    of ``nbytes``, in GB/s."""
    from tpusparse_torch.bench.harness import time_fn

    dev = _card(device)
    rows = max(nbytes // 4 // 8192, 8)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((rows, 8192), generator=gen, device=dev)
    sec = time_fn(lambda x: x * 1.0000001, a, iters=10, warmup=1)
    sec_r = time_fn(lambda x: x.sum(dim=0) * 1.0000001, a, iters=10, warmup=1)
    return {"metric": "hbm", "stream_gbs": 2 * a.numel() * 4 / sec / 1e9,
            "reduce_gbs": a.numel() * 4 / sec_r / 1e9, "nbytes": a.numel() * 4,
            "device": torch.cuda.get_device_name(dev)}


def measure_mxu(n: int = 8192, precision: str = "bf16", iters: int = 10, device="cuda") -> dict:
    """cuBLAS's n^3 product in TFLOP/s: bf16 operands with an fp32 result
    (the tensor cores), or fp32 with TF32 off (the CUDA cores)."""
    from tpusparse_torch.bench.baselines import _fp32_highest
    from tpusparse_torch.bench.harness import time_fn

    dev = _card(device)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[precision]
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    b = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    with _fp32_highest():
        sec = time_fn(lambda x: matmul_f32(x, b), a, iters=iters, warmup=1)
    return {"metric": f"mxu_{precision}", "tflops": 2 * n ** 3 / sec / 1e12, "shape": [n, n, n],
            "device": torch.cuda.get_device_name(dev)}


def _device_seconds(fn, x) -> tuple[float, str]:
    """Device seconds per call from the profiler or, where it drops records,
    a CUDA graph's replay; with the timer's name."""
    from tpusparse_torch.bench.harness import device_time_fn, graph_time_fn

    try:
        return device_time_fn(fn, x), "profiler"
    except RuntimeError:
        return graph_time_fn(fn, x), "cuda_graph"


def measure_family_costs(quick: bool = False, k: int = 8, device="cuda") -> list[dict]:
    """Device ns per nonzero (and per stored slot) of each schedule
    family's plan at config #1, K = k: the tuner's candidates there, one
    per distinct plan (the first of each family with ``quick``).  The
    counterpart of the JAX module's ``measure_chunk_costs``, which timed
    the TPU kernels' chunk loops on synthetic formats."""
    from tpusparse_torch.io import builder
    from tpusparse_torch.schedule import CandidateRejected, build_plan
    from tpusparse_torch.tune import default_candidates

    dev = _card(device)
    c1 = CONFIG1
    mat = builder.power_law_coo(c1["m"], c1["m"], avg_nnz_per_row=c1["avg_nnz_per_row"],
                                alpha=c1["alpha"], seed=c1["seed"])
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((mat.shape[1], k)),
                        dtype=torch.float32, device=dev)
    seen, rows = set(), []
    for sched in default_candidates(mat, k):
        key = sched.family if quick else sched.plan_key()
        if key in seen:
            continue
        seen.add(key)
        try:
            plan = build_plan(mat, sched, device=dev)
        except CandidateRejected as e:  # a family's gate refused this matrix
            rows.append({"metric": "family_cost", "family": sched.family, "k": k,
                         "schedule": sched.describe(), "rejected": str(e)})
            _log(rows[-1])
            continue
        sec, timer = _device_seconds(plan.fn, x)
        pad = float(plan.meta["padding_rate"])
        rows.append({"metric": "family_cost", "family": sched.family, "k": k,
                     "schedule": sched.describe(), "device_ms": sec * 1e3,
                     "ns_per_nz": sec / mat.nnz * 1e9, "ns_per_stored": sec / (mat.nnz * pad) * 1e9,
                     "padding_rate": pad, "timer": timer,
                     "device": torch.cuda.get_device_name(dev)})
        _log(rows[-1])
    return rows


# The card's own readings, the anchor that a session's norms answer to
# ("what would this run have measured in that window"): the session probe
# of ``python -m tpusparse_torch.bench.microbench --quick`` on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit (PERF.md §2).
REF_WINDOW = {"stream_gbs": 2994.1, "mxu_tflops": 779.7, "fp32_tflops": 51.65}

# Plausibility bounds for the probe's readings.  The upper bounds are the
# H100 SXM's published peaks (3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s
# fp32): a reading above one is a timing fault, never a fast card.  The
# lower bounds are about 30 % of them, below an H100 PCIe's peaks (2.0
# TB/s, 756 and 51 TFLOP/s) and a card held at a reduced power limit: a
# reading below one means the probe timed launches or another device, not
# the card's rate.
PROBE_BOUNDS = {
    "stream_gbs": (1000.0, 3350.0),
    "mxu_tflops": (300.0, 989.0),
    "fp32_tflops": (20.0, 67.0),
}
MAX_READS = 3


def _guarded(name: str, measure, extract) -> tuple[float, dict]:
    """Read ``measure`` once; if the reading falls outside
    ``PROBE_BOUNDS[name]``, read again, ``MAX_READS`` calls of ``measure``
    in all, and take the median.  Readings above the upper bound are
    impossible and dropped before the median; readings below the lower
    bound may be real throttling, so they are kept and can only be
    outvoted.  A remeasure that raises is logged and counts as a call, so
    the loop ends.  Returns (value, info): info holds the first row, any
    violation and, where the median is still outside, ``implausible``."""
    lo, hi = PROBE_BOUNDS[name]
    row = measure()
    readings = [float(extract(row))]
    info: dict = {"row": row}
    if lo <= readings[0] <= hi:
        return readings[0], info
    for _ in range(MAX_READS - 1):
        try:
            readings.append(float(extract(measure())))
        except Exception as e:  # noqa: BLE001 - a failed remeasure is a datum, logged
            _log(f"probe remeasure {name} failed: {type(e).__name__}: {e}")
    sane = [r for r in readings if r <= hi]
    med = float(np.median(sane if sane else readings))
    info["violation"] = {"first": readings[0], "readings": readings, "bounds": [lo, hi]}
    if lo <= med <= hi:
        _log(f"probe {name}: reading(s) outside [{lo}, {hi}], filtered median {med} of "
             f"{readings} accepted")
        return med, info
    _log(f"probe {name}: implausible after {MAX_READS} reads (median {med} of {readings}); "
         "axis flagged, no norm")
    info["implausible"] = True
    return med, info


def session_probe(device="cuda") -> dict:
    """The stream, bf16 and fp32 readings of this session, each guarded by
    ``PROBE_BOUNDS``, with their norms to ``REF_WINDOW`` (``norm_stream``,
    ``norm`` for the tensor cores, ``norm_fp32``): a rate times its axis's
    norm is what the anchor window would have read.  An implausible axis
    gets no norm.  With ``device="cpu"`` there is nothing to measure, and
    the dict says so."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"metric": "session_probe", "backend": "cpu"}
    out = {"metric": "session_probe", "device": torch.cuda.get_device_name(dev)}
    stream, s_info = _guarded("stream_gbs", lambda: measure_hbm(device=dev),
                              lambda r: r["stream_gbs"])
    out["stream_gbs"] = stream
    out["reduce_gbs"] = float(s_info["row"]["reduce_gbs"])
    bf16, b_info = _guarded("mxu_tflops", lambda: measure_mxu(device=dev),
                            lambda r: r["tflops"])
    out["mxu_tflops"] = bf16
    fp32, f_info = _guarded("fp32_tflops", lambda: measure_mxu(precision="fp32", device=dev),
                            lambda r: r["tflops"])
    out["fp32_tflops"] = fp32
    out["ref_window"] = dict(REF_WINDOW)
    implausible = []
    for name, val, info, norm_key in (("stream_gbs", stream, s_info, "norm_stream"),
                                      ("mxu_tflops", bf16, b_info, "norm"),
                                      ("fp32_tflops", fp32, f_info, "norm_fp32")):
        ref = REF_WINDOW.get(name)
        if info.get("implausible"):
            implausible.append(name)
            out[norm_key] = None
        else:
            out[norm_key] = ref / val if ref else None
        if "violation" in info:
            out.setdefault("violations", {})[name] = info["violation"]
    if implausible:
        out["implausible"] = implausible
    return out


def roofline_bandwidth_gbs(refresh: bool = False, device="cuda") -> float:
    """The card's measured stream rate in GB/s, for a caller that has no
    session probe of its own: cached under cache_dir with the card's name
    (a reading of another card is measured anew), measured through the
    probe's guard, and cached only when it is within ``PROBE_BOUNDS``;
    0.0 with ``device="cpu"``, where there is no roofline."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(dev)
    path = os.path.join(get_config().cache_dir, "microbench.json")
    if not refresh and os.path.exists(path):
        with open(path) as f:
            row = json.load(f)
        if row.get("device") == name:
            return float(row["stream_gbs"])
    stream, info = _guarded("stream_gbs", lambda: measure_hbm(device=dev),
                            lambda r: r["stream_gbs"])
    if not info.get("implausible"):
        _save_roofline({"stream_gbs": stream, "device": name})
    return stream


def _save_roofline(row: dict) -> None:
    cfg = get_config()
    os.makedirs(cfg.cache_dir, exist_ok=True)
    with open(os.path.join(cfg.cache_dir, "microbench.json"), "w") as f:
        json.dump(row, f)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpusparse_torch.bench.microbench")
    ap.add_argument("--quick", action="store_true",
                    help="one plan per family in the family costs")
    ap.add_argument("--out", default=None,
                    help="JSON lines to append to (default: MICROBENCH.jsonl under the config "
                         "cache_dir)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(get_config().cache_dir, "MICROBENCH.jsonl")

    rows = [session_probe()]
    for r in rows:
        _log(r)
    rows += measure_family_costs(quick=args.quick)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "a") as f:
        for r in rows:
            r["ts"] = time.time()
            f.write(json.dumps(r) + "\n")
    if "stream_gbs" not in rows[0].get("implausible", ()):  # a flagged axis is never cached
        _save_roofline({"stream_gbs": rows[0]["stream_gbs"], "device": rows[0]["device"]})
    print(json.dumps({"wrote": out, "rows": len(rows)}))


if __name__ == "__main__":
    main()
