"""The card's schedule gates beside the TPU's, measured on the card.

    python3 tpusparse_torch/bench/gates_sweep.py [--only x,spmv,multi,brick,bell,wide,stripe,tune,pairs]
                                                 [--out chiprun_out/gates.jsonl]

Each gate of ``tpusparse_torch.gates`` chooses between families, methods
or routes; this times every one it chooses between, at the shapes where
``TPU_GATES`` and ``CARD_GATES`` part, in one process on one card:

- ``x``: ``default_schedule``'s X gates on the SpMV workload (power-law
  262144², avg 40, seed 9) at K = 1, 4, 8, 32, 64, ogbn-arxiv's shape
  (169343², avg 7.592, seed 4) at K = 16, 64, 128 and web-Google's
  (916428², avg 6.155, seed 3) at K = 8: the card's default, the TPU's,
  ``dg_span`` at the TPU's window, ``radix_span``, ``span_onehot``,
  ``span_colsplit`` at the TPU's split and ``tile_onehot``; cuSPARSE and
  the CSR bound beside them;
- ``small_k``: K = 2 and 4 at config #1, the SpMV workload, ogbn-arxiv's
  and web-Google's shapes: the card's default (``dg_span``, kt 8) against
  ``radix_span`` at K's own K-tile (the TPU's default at the SpMV
  workload);
- ``spmv``: ``spmv_fn('auto')`` on the suite's quick SpMV matrix (65536²,
  avg 40, seed 9), the SpMV workload and, past 1,572,864 columns,
  wiki-Talk's shape (2394385², avg 2.54, seed 6) and ogbn-products' node
  count (2449029², seed 5) at averages 4, 8 and 25.494 (its published
  61,859,140 edges): the dg SpMV kernel (#2) against the segment
  reduction (the TPU's 'auto' past the gate) and cuSPARSE;
- ``multi``: ``spmv_multi_fn`` at web-Google's shape with 8 vectors: one
  format against the TPU's column split;
- ``brick``: ``brick_ell`` at config #1, K = 8 (refused at the TPU's gate)
  beside the ``radix_span`` row;
- ``bell``: the ``block_ell`` plan and ``block_ell_spmm`` at P14's weight
  (15 % of the 128-blocks of 4096², seed 6), K = 256: the kernel (#13)
  against the batched product, bf16 and fp32;
- ``wide``: config #1 at K = 256 (``tile_onehot``, ``stripe_total`` at
  merge path 512 and 2048, ``dense`` bf16) and the dense row against the
  tile default at densities 1 % and 2 %;
- ``stripe``: the padding bound on P12's stripe plan (the SpMV workload,
  ``build_stripe_plan`` work 1024): packed planes against slots read;
- ``tune``: ``tune`` at the SpMV workload, K = 8, under each record, its
  table;
- ``pairs``: the two decisions whose whole calls lie close, timed in
  alternating rounds (each round the calls in one order, then in the
  other; ``--rounds``) in one process, with the median, the least and the
  most of each: the Block-ELL kernel against the batched product at P14
  (the ``block_ell`` plan on each record and ``block_ell_spmm``'s two
  methods, bf16 and fp32), and the dg SpMV plan (#2) against the segment
  reduction past 1,572,864 columns (ogbn-products' node count at averages
  1, 2, 4 and its own, wiki-Talk's shape) and at 65536², with #2's call
  as it was before its unpack index was kept on the format beside it.
  Each call's host time (the calls issued without a wait, over their
  number) and device time are read too.

Every product is checked against scipy's float64 A·X (2e-3, the tuner's
fp32x2 tolerance).  A row: the whole call by ``time_fn`` (20 calls back to
back, host included) and its device time (``device_time_fn``, else a CUDA
graph's replay), the launches of the port's wrappers a call, the padding,
the format's bytes with the port's own indexes (``tune.index_bytes``) and
the pack's seconds.  Rows go to ``--out`` as JSON lines and to standard
output, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from tpusparse_torch.bench.baselines import csr_spmm_fn  # noqa: E402
from tpusparse_torch.bench.harness import device_time_fn, graph_time_fn, time_fn  # noqa: E402
from tpusparse_torch.bench.sol import csr_bound_ms  # noqa: E402
from tpusparse_torch.gates import CARD_GATES, TPU_GATES  # noqa: E402
from tpusparse_torch.io import builder  # noqa: E402
from tpusparse_torch.kernels.radix_gather import choose_kt  # noqa: E402
from tpusparse_torch.oracle import check_result, spmm_reference  # noqa: E402
from tpusparse_torch.schedule import (COLSPLIT_RANGE_BYTES, Schedule, build_plan,  # noqa: E402
                                      default_schedule)
from tpusparse_torch.tune import index_bytes, read_rate  # noqa: E402

SECTIONS = ("x", "small_k", "spmv", "multi", "brick", "bell", "wide", "stripe", "tune", "pairs")
#: (n, avg nonzeros a row, seed): the synthetic power laws of the size of
#: the SpMV workload, ogbn-arxiv, web-Google and wiki-Talk (power_law_coo
#: floors row lengths: these averages give the published edge counts)
SHAPES = {"spmv": (262144, 40.0, 9), "arxiv": (169343, 7.592, 4),
          "webgoogle": (916428, 6.155, 3), "wikitalk": (2394385, 2.54, 6),
          "headline": (32768, 32.0, 42), "quick": (65536, 40.0, 9),
          "products": (2449029, 25.494, 5), "products_avg4": (2449029, 4.0, 5),
          "products_avg8": (2449029, 8.0, 5), "products_avg1": (2449029, 1.0, 5),
          "products_avg2": (2449029, 2.0, 5)}
#: the SpMV section's matrices: the suite's quick SpMV, the SpMV workload,
#: and past 1,572,864 columns wiki-Talk's shape and ogbn-products' node
#: count at averages 4, 8 and ogbn-products' own
SPMV_SHAPES = ("quick", "spmv", "wikitalk", "products_avg4", "products_avg8", "products")
X_CASES = (("spmv", (1, 4, 8, 32, 64)), ("arxiv", (16, 64, 128)), ("webgoogle", (8,)))


def power_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def wrappers():
    """Every kernel wrapper of the port, by name (each counts its launches)."""
    from tpusparse_torch.kernels import block_ell, dg_gather, dgt_gather, nm_structured
    from tpusparse_torch.kernels import radix_gather, sddmm, span_gather, stripe_gather
    from tpusparse_torch.kernels import tile_onehot

    return {f.__name__: f for f in (
        dg_gather.dg_rows_cuda, dg_gather.dg1_rows_cuda, dgt_gather.dgt_rows_cuda,
        dgt_gather.dgt_stream_rows_cuda, tile_onehot.tile_rows_cuda,
        tile_onehot.tile_stream_rows_cuda, span_gather.span_rows_cuda,
        span_gather.span_stream_rows_cuda, radix_gather.radix_rows_cuda,
        stripe_gather.stripe_rows_cuda, stripe_gather.stripe_nested_rows_cuda,
        nm_structured.nm_rows_cuda, block_ell.bell_rows_cuda, sddmm.sddmm_rows_cuda,
        sddmm.dx_rows_cuda)}


def device_ms(fn, x):
    """(ms, how) of one call's device time: the profiler's, else a CUDA
    graph's replay, else None."""
    try:
        return device_time_fn(fn, x) * 1e3, "profiler"
    except RuntimeError:
        pass
    try:
        return graph_time_fn(fn, x) * 1e3, "graph"
    except Exception:  # noqa: BLE001 - the reading that is missing is said
        return None, "none"


class Sweep:
    def __init__(self, out: str):
        self.out = open(out, "a")
        self.power = power_line()
        self.dev = torch.device("cuda", 0)
        self.wrap = wrappers()

    def emit(self, row: dict) -> None:
        row = {"card": self.power, **row}
        self.out.write(json.dumps(row) + "\n")
        self.out.flush()
        print(json.dumps(row), flush=True)

    def launches(self) -> dict:
        return {n: f.launches for n, f in self.wrap.items()}

    def time_call(self, section: str, label: str, make, x, want, *, meta=None,
                  rtol: float = 2e-3, scale=None) -> dict | None:
        """Makes ``fn = make()`` (its seconds the pack), calls it once against
        ``want``, then times it; emits and returns the row (None where it
        raised: the error is the row)."""
        row = {"section": section, "label": label, **(meta or {})}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn = make()
            torch.cuda.synchronize()
            row["pack_s"] = time.perf_counter() - t0
            before = self.launches()
            y = fn(x)
            torch.cuda.synchronize()
            after = self.launches()
            row["launches"] = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            got = y.float().cpu().numpy()
            check_result(got, want, rtol=rtol, scale=scale)
            row["max_abs_err"] = float(np.abs(got - want).max())
            row["call_ms"] = time_fn(fn, x) * 1e3
            row["device_ms"], row["device_how"] = device_ms(fn, x)
            plan = getattr(fn, "plan", None)
            if plan is not None:
                row["pad"] = plan.meta.get("padding_rate")
                row["read_rate"] = read_rate(plan, row.get("nnz", 0))
                row["format_mib"] = (plan.meta.get("format_bytes") or sum(
                    f.memory_bytes + index_bytes(f) for f in plan.formats)) / 2**20
                row["schedule"] = plan.meta["schedule"]
        except Exception as e:  # noqa: BLE001 - recorded, and the sweep goes on
            row["error"] = f"{type(e).__name__}: {e}"[:400]
            fn = None
        self.emit(row)
        del fn
        torch.cuda.empty_cache()
        return row

    def yardsticks(self, section, label, mat, k, x, want):
        """cuSPARSE's product and the CSR bound beside a shape's rows."""
        csr = csr_spmm_fn(mat, device=self.dev)
        self.time_call(section, f"{label} cuSPARSE", lambda: csr, x, want,
                       meta={"nnz": mat.nnz, "k": k})
        del csr
        bound, by = csr_bound_ms(mat.nnz, mat.shape[0], mat.shape[1], k)
        self.emit({"section": section, "label": f"{label} CSR bound", "bound_ms": bound,
                   "bound_by": by})


def plan_fn(mat, sched, gates):
    plan = build_plan(mat, sched, device="cuda", gates=gates)

    def fn(x):
        return plan(x)

    fn.plan = plan
    return fn


def matrix(name):
    n, avg, seed = SHAPES[name]
    t0 = time.perf_counter()
    mat = builder.power_law_coo(n, n, avg_nnz_per_row=avg, seed=seed,
                                **({"alpha": 1.8} if name == "headline" else {}))
    print(f"[matrix] {name}: {n}x{n}, nnz {mat.nnz}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return mat


def section_x(sw: Sweep):
    for name, ks in X_CASES:
        mat = matrix(name)
        n = mat.shape[1]
        for k in ks:
            x64 = np.random.default_rng(k).standard_normal((n, k))
            want = spmm_reference(mat, x64)
            x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
            card = default_schedule(mat, k)
            tpu = default_schedule(mat, k, gates=TPU_GATES)
            kt_r = choose_kt(k)
            split = (tpu.col_split if tpu.family == "span_colsplit"
                     else max(2, -(-(n * 2 * min(k, 128) * 2) // COLSPLIT_RANGE_BYTES)))
            cands = {"card default": (card, CARD_GATES), "tpu default": (tpu, TPU_GATES)}
            if card.family == "dg_span":
                cands["dg_span at the TPU's window"] = (
                    Schedule(**{**card.describe(), "ns": 8 if card.ktile != 1 else 4}),
                    TPU_GATES)
            cands.update({
                "radix_span": (Schedule(family="radix_span", rb=1024, sublanes=128, g=1024,
                                        unroll=4, ktile=kt_r), CARD_GATES),
                "span_onehot": (Schedule(family="span_onehot", rb=512, ct=1024, g=512,
                                         unroll=4), CARD_GATES),
                "span_colsplit": (Schedule(family="span_colsplit", col_split=split, rb=512,
                                           ct=1024, g=512, unroll=4), CARD_GATES),
                "tile_onehot": (Schedule(), CARD_GATES)})
            seen = set()
            for label, (sched, gates) in cands.items():
                key = json.dumps(sched.describe(), sort_keys=True)
                if key in seen:
                    sw.emit({"section": "x", "label": f"{name} K={k} {label}",
                             "same_as_earlier_row": sched.describe()})
                    continue
                seen.add(key)
                sw.time_call("x", f"{name} K={k} {label}",
                             lambda s=sched, g=gates: plan_fn(mat, s, g), x, want,
                             meta={"nnz": mat.nnz, "k": k, "gates": gates.name})
            sw.yardsticks("x", f"{name} K={k}", mat, k, x, want)
            del x
        del mat


def section_small_k(sw: Sweep):
    for name in ("headline", "spmv", "arxiv", "webgoogle"):
        mat = matrix(name)
        n = mat.shape[1]
        for k in (2, 4):
            x64 = np.random.default_rng(k).standard_normal((n, k))
            want = spmm_reference(mat, x64)
            x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
            cands = {"card default": (default_schedule(mat, k), CARD_GATES),
                     "tpu default": (default_schedule(mat, k, gates=TPU_GATES), TPU_GATES),
                     "radix_span": (Schedule(family="radix_span", rb=1024, sublanes=128,
                                             g=1024, unroll=4, ktile=choose_kt(k)), CARD_GATES)}
            seen = set()
            for label, (sched, gates) in cands.items():
                key = json.dumps(sched.describe(), sort_keys=True)
                if key in seen:
                    sw.emit({"section": "small_k", "label": f"{name} K={k} {label}",
                             "same_as_earlier_row": sched.describe()})
                    continue
                seen.add(key)
                sw.time_call("small_k", f"{name} K={k} {label}",
                             lambda s=sched, g=gates: plan_fn(mat, s, g), x, want,
                             meta={"nnz": mat.nnz, "k": k, "gates": gates.name})
            del x
        del mat


def section_spmv(sw: Sweep):
    from tpusparse_torch.spmv import spmv_fn

    for name in SPMV_SHAPES:
        mat = matrix(name)
        n = mat.shape[1]
        x64 = np.random.default_rng(1).standard_normal(n)
        want = spmm_reference(mat, x64) if mat.nnz < 20_000_000 else \
            _csr(mat) @ x64
        x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
        for label, make in (("auto (card: dg, #2)", lambda: spmv_fn(mat, "auto")),
                            ("segment (the TPU's auto past 1,572,864 columns)",
                             lambda: spmv_fn(mat, "segment"))):
            sw.time_call("spmv", f"{name} {label}", make, x, want,
                         meta={"nnz": mat.nnz, "k": 1})
        csr = csr_spmm_fn(mat, device=sw.dev)
        sw.time_call("spmv", f"{name} cuSPARSE", lambda: (lambda v: csr(v[:, None])[:, 0]), x,
                     want, meta={"nnz": mat.nnz, "k": 1})
        bound, by = csr_bound_ms(mat.nnz, n, n, 1)
        sw.emit({"section": "spmv", "label": f"{name} CSR bound", "bound_ms": bound,
                 "bound_by": by})
        del csr, x, mat
        torch.cuda.empty_cache()


def _csr(mat):
    import scipy.sparse as sp

    return sp.csr_matrix((np.asarray(mat.vals, np.float64), (mat.rows, mat.cols)),
                         shape=mat.shape)


def section_multi(sw: Sweep):
    from tpusparse_torch.spmv import spmv_multi_fn

    mat = matrix("webgoogle")
    n = mat.shape[1]
    x64 = np.random.default_rng(8).standard_normal((n, 8))
    want = spmm_reference(mat, x64)
    x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
    for label, gates in (("one format (card)", CARD_GATES), ("column split (tpu)", TPU_GATES)):
        row = sw.time_call("multi", f"webgoogle 8 vectors, {label}",
                           lambda g=gates: spmv_multi_fn(mat, 8, gates=g), x, want,
                           meta={"nnz": mat.nnz, "k": 8})
        del row
    sw.yardsticks("multi", "webgoogle K=8", mat, 8, x, want)


def section_brick(sw: Sweep):
    mat = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    x64 = np.random.default_rng(0).standard_normal((32768, 8))
    want = spmm_reference(mat, x64)
    x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
    for label, sched, gates in (
            ("brick_ell (card)", Schedule(family="brick_ell", sort=True, rb=1024, sublanes=256,
                                          g=512, unroll=4, ktile=8), CARD_GATES),
            ("brick_ell (tpu: refused)", Schedule(family="brick_ell", sort=True, rb=1024,
                                                  sublanes=256, g=512, unroll=4, ktile=8),
             TPU_GATES),
            ("radix_span", Schedule(family="radix_span", rb=1024, sublanes=128, g=1024,
                                    unroll=4, ktile=8), CARD_GATES),
            ("dg_span default", default_schedule(mat, 8), CARD_GATES)):
        sw.time_call("brick", f"config #1 K=8 {label}",
                     lambda s=sched, g=gates: plan_fn(mat, s, g), x, want,
                     meta={"nnz": mat.nnz, "k": 8, "gates": gates.name})


def section_bell(sw: Sweep):
    from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell
    from tpusparse_torch.oracle import spmm_reference as ref

    mat = builder.block_sparse_coo(4096, 4096, 128, 0.15, seed=6)
    x64 = np.random.default_rng(6).standard_normal((4096, 256))
    want = ref(mat, x64)
    x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
    import scipy.sparse as sp

    a_abs = sp.csr_matrix((np.abs(mat.vals), (mat.rows, mat.cols)), shape=mat.shape)
    scale = a_abs @ np.abs(x64)
    for prec, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        tol = 1e-2 if prec == "bf16" else 1e-5
        for gates in (CARD_GATES, TPU_GATES):
            sched = Schedule(family="block_ell", precision=prec, row_interval=128)
            sw.time_call("bell", f"P14 K=256 block_ell plan {prec} ({gates.name}: "
                         f"{gates.block_ell_method})",
                         lambda s=sched, g=gates: plan_fn(mat, s, g), x, want,
                         meta={"nnz": mat.nnz, "k": 256}, rtol=tol, scale=scale)
        fmt = pack_block_ell(mat, bs=128, dtype=dt, device=sw.dev)
        for method in ("pallas", "xla"):
            sw.time_call("bell", f"P14 K=256 block_ell_spmm {prec} method={method}",
                         lambda m=method, f=fmt, p=prec: (
                             lambda v: block_ell_spmm(f, v, precision=p, method=m)),
                         x, want, meta={"nnz": mat.nnz, "k": 256}, rtol=tol, scale=scale)


def section_wide(sw: Sweep):
    for avg, seed in ((32.0, 42), (328.0, 11), (655.0, 12)):
        mat = builder.power_law_coo(32768, 32768, avg_nnz_per_row=avg, alpha=1.8, seed=seed)
        x64 = np.random.default_rng(0).standard_normal((32768, 256))
        want = spmm_reference(mat, x64)
        x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
        label = f"32768^2 avg {avg:g} (density {mat.nnz / 32768 ** 2:.4f}) K=256"
        cands = [("tile_onehot default", Schedule()), ("dense bf16",
                                                       Schedule(family="dense", precision="bf16"))]
        if avg == 32.0:
            cands += [(f"stripe_total merge path {w}", Schedule(family="stripe_total",
                                                                work_per_block=w, unroll=8))
                      for w in (512, 2048)]
        import scipy.sparse as sp

        scale = sp.csr_matrix((np.abs(mat.vals), (mat.rows, mat.cols)),
                              shape=mat.shape) @ np.abs(x64)
        for name, sched in cands:
            bf16 = sched.precision == "bf16"
            sw.time_call("wide", f"{label} {name}", lambda s=sched: plan_fn(mat, s, CARD_GATES),
                         x, want, meta={"nnz": mat.nnz, "k": 256},
                         rtol=1e-2 if bf16 else 2e-3, scale=scale if bf16 else None)
        sw.yardsticks("wide", label, mat, 256, x, want)
        del x, mat
        torch.cuda.empty_cache()


def section_stripe(sw: Sweep):
    from tpusparse_torch.generator import build_stripe_plan

    mat = matrix("spmv")
    plan = build_stripe_plan(mat, work_per_stripe=1024, unroll=8, device=sw.dev)
    sw.emit({"section": "stripe", "label": "P12 stripe plan (work 1024)", "nnz": mat.nnz,
             "pad": plan.meta["padding_rate"], "read_rate": read_rate(plan, mat.nnz),
             "memory_mib": sum(f.memory_bytes for f in plan.formats) / 2**20})


def section_tune(sw: Sweep):
    import tempfile

    from tpusparse_torch.config import config_override
    from tpusparse_torch.tune import tune

    mat = matrix("spmv")
    x = np.random.default_rng(3).standard_normal((mat.shape[1], 8)).astype(np.float32)
    for gates in (CARD_GATES, TPU_GATES):
        t0 = time.perf_counter()
        with config_override(cache_dir=tempfile.mkdtemp(prefix="gates_tune_")):
            res = tune(mat, x, use_cache=False, gates=gates)
        for row in res.table:
            sw.emit({"section": "tune", "gates": gates.name, **{
                k: row.get(k) for k in ("schedule", "ok", "error", "seconds", "padding_rate",
                                        "read_rate", "format_bytes", "pack_seconds")}})
        b = res.best_schedule
        sw.emit({"section": "tune", "gates": gates.name, "label": "winner",
                 "family": b.family, "schedule": b.describe(), "seconds": res.best_seconds,
                 "rows": len(res.table), "tune_s": time.perf_counter() - t0})
        del res
        torch.cuda.empty_cache()


def host_ms(fn, x, iters: int = 20) -> float:
    """ms of host time a call: ``iters`` calls issued without a wait."""
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def alternate(sw: Sweep, section: str, label: str, fns: dict, x, rounds: int, meta=None):
    """Times each of ``fns`` (label -> fn) by ``time_fn`` in ``rounds``
    rounds, each in the given order and then in the reverse one; emits a
    row each with the median, least and most whole call, its host and
    device time, and a row with the rounds each call's mean was the
    shortest in."""
    names = list(fns)
    times = {n: [] for n in names}
    won = dict.fromkeys(names, 0)
    for fn in fns.values():
        fn(x)
    for _ in range(rounds):
        this = dict.fromkeys(names, 0.0)
        for n in names + names[::-1]:
            t = time_fn(fns[n], x) * 1e3
            times[n].append(t)
            this[n] += t / 2
        won[min(this, key=this.get)] += 1
    for n in names:
        ts = sorted(times[n])
        dev, how = device_ms(fns[n], x)
        sw.emit({"section": section, "label": f"{label} {n}", **(meta or {}),
                 "call_ms_median": float(np.median(ts)), "call_ms_min": ts[0],
                 "call_ms_max": ts[-1], "calls_timed": len(ts),
                 "host_ms": host_ms(fns[n], x), "device_ms": dev, "device_how": how})
    sw.emit({"section": section, "label": f"{label}: rounds won", "rounds": rounds, **won})


def section_pairs(sw: Sweep, rounds: int = 15):
    from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell
    from tpusparse_torch.kernels.common import prep_x, unpack_slots
    from tpusparse_torch.kernels.dg_gather import _fmt_args, dg1_rows_cuda, dg_row_walk
    from tpusparse_torch.oracle import spmm_reference as ref
    from tpusparse_torch.spmv import spmv_fn

    mat = builder.block_sparse_coo(4096, 4096, 128, 0.15, seed=6)
    x64 = np.random.default_rng(6).standard_normal((4096, 256))
    want = ref(mat, x64)
    x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
    import scipy.sparse as sp

    scale = sp.csr_matrix((np.abs(mat.vals), (mat.rows, mat.cols)), shape=mat.shape) @ \
        np.abs(x64)
    for prec, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        sched = Schedule(family="block_ell", precision=prec, row_interval=128)
        fmt = pack_block_ell(mat, bs=128, dtype=dt, device=sw.dev)
        fns = {"plan (card: kernel)": build_plan(mat, sched, gates=CARD_GATES),
               "plan (tpu: xla)": build_plan(mat, sched, gates=TPU_GATES),
               "block_ell_spmm pallas": lambda v, f=fmt, p=prec: block_ell_spmm(
                   f, v, precision=p, method="pallas"),
               "block_ell_spmm xla": lambda v, f=fmt, p=prec: block_ell_spmm(
                   f, v, precision=p, method="xla")}
        for fn in fns.values():
            check_result(fn(x).float().cpu().numpy(), want,
                         rtol=1e-2 if prec == "bf16" else 1e-5, scale=scale)
        alternate(sw, "pairs", f"P14 K=256 {prec}", fns, x, rounds,
                  meta={"nnz": mat.nnz, "k": 256})
    del x
    for name in ("quick", "products_avg1", "products_avg2", "wikitalk", "products_avg4",
                 "products"):
        mat = matrix(name)
        n = mat.shape[1]
        x64 = np.random.default_rng(1).standard_normal(n)
        want = _csr(mat) @ x64
        x = torch.as_tensor(x64, dtype=torch.float32, device=sw.dev)
        dg = spmv_fn(mat, "auto")
        fmt = dg.format

        def dg_before(v, fmt=fmt):
            # dg_spmv as it was: the slots converted, clamped and compared
            # at every call
            v = prep_x(v, fmt.device).reshape(-1)
            return unpack_slots(dg1_rows_cuda(*_fmt_args(fmt), v, rb=fmt.rb,
                                              walk=dg_row_walk(fmt)), fmt.slot_of_origrow)

        fns = {"dg (#2, the card's auto)": dg, "dg as before": dg_before,
               "segment (the TPU's auto past 1,572,864 columns)": spmv_fn(mat, "segment")}
        for fn in fns.values():
            check_result(fn(x).cpu().numpy(), want, rtol=2e-3)
        alternate(sw, "pairs", f"{name} SpMV", fns, x, rounds,
                  meta={"nnz": mat.nnz, "n": n, "k": 1})
        del fns, dg, fmt, x, mat
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(SECTIONS))
    ap.add_argument("--out", default="chiprun_out/gates.jsonl")
    ap.add_argument("--rounds", type=int, default=15, help="rounds of the pairs section")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gates_sweep: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sw = Sweep(args.out)
    print(f"[gates] {sw.power}", flush=True)
    t0 = time.perf_counter()
    for name in args.only.split(","):
        ts = time.perf_counter()
        if name == "pairs":
            section_pairs(sw, args.rounds)
        else:
            globals()[f"section_{name}"](sw)
        print(f"[gates] section {name}: {time.perf_counter() - ts:.1f} s  ({sw.power})",
              flush=True)
    print(f"[gates] done in {time.perf_counter() - t0:.1f} s  ({sw.power})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
