"""Matrix-zoo robustness sweep (counterpart of ``tpusparse/bench/zoo.py``):
the port's autotuner over a grid of shapes (square, tall, wide),
densities and structure classes, one row per (case, K) with the winning
schedule and GFLOP/s, and the candidates that were not ok, each with its
error and kind (``bench/suite.py::not_ok``).  Broader than ``suite.py``, which covers the
BASELINE configs: this asks whether the tuner always finds something sane.
The cases, seeds, quick sizes and K list are the JAX module's.

Run: python -m tpusparse_torch.bench.zoo [--quick] [--full] [--out PATH]
(rows appended to BENCH_ZOO.jsonl under the config cache_dir by default;
the first is the session probe).
"""

from __future__ import annotations

import json
import os
import sys
import time


def zoo(quick: bool = False):
    from tpusparse_torch.io import builder

    s = 4096 if quick else 8192
    return {
        "square_sparse": builder.power_law_coo(s, s, avg_nnz_per_row=4.0, seed=1),
        "square_mid": builder.power_law_coo(s, s, avg_nnz_per_row=32.0, seed=2),
        "square_denser": builder.pruned_weight_coo(s // 4, s // 4, sparsity=0.95, seed=3),
        "tall": builder.power_law_coo(4 * s, s // 4, avg_nnz_per_row=8.0, seed=4),
        "wide": builder.power_law_coo(s // 4, 4 * s, avg_nnz_per_row=8.0, seed=5),
        "extreme_skew": builder.power_law_coo(s, s, avg_nnz_per_row=16.0, alpha=1.2, seed=6),
        # web-graph class: power-law column popularity (in-link counts), the
        # hybrid_cols family's case
        "col_skew": builder.power_law_col_coo(s, s, avg_nnz_per_row=16.0, alpha=1.6, seed=9),
        "banded": builder.banded_coo(s, s, bandwidth=32, seed=7),
        "blocky": builder.block_sparse_coo(s // 2, s // 2, block=128, block_density=0.08,
                                           seed=8),
    }


def run_zoo(quick: bool = False, ks=(8, 64), out_path: str | None = None, full: bool = False,
            budget: int | None = 10, device="cuda") -> list[dict]:
    """Tune every case at every K on ``device``; returns the rows (a case
    whose tune raises gets an ``error`` field), each also appended to
    ``out_path``."""
    import numpy as np

    from tpusparse_torch.bench.harness import gflops
    from tpusparse_torch.bench.microbench import session_probe
    from tpusparse_torch.bench.suite import tune_fields
    from tpusparse_torch.config import get_config
    from tpusparse_torch.kernels.common import resolve_device
    from tpusparse_torch.tune import tune

    dev = resolve_device(device)
    if out_path is None:
        out_path = os.path.join(get_config().cache_dir, "BENCH_ZOO.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    probe = session_probe(device=dev)
    probe["ts"] = time.time()
    emit(probe)
    for name, mat in zoo(quick).items():
        for k in ks:
            x = np.random.default_rng(0).standard_normal((mat.shape[1], k)).astype(np.float32)
            row = {"case": name, "shape": list(mat.shape), "nnz": mat.nnz,
                   "density": mat.density, "k": k, "ts": time.time()}
            try:
                res = tune(mat, x, iters=5, validate=True, full=full, budget=budget, device=dev)
            except Exception as e:  # noqa: BLE001 - the grid goes on; the row keeps the error
                row["error"] = f"{type(e).__name__}: {e}"
            else:
                row.update(gflops=gflops(mat.nnz, k, res.best_seconds),
                           seconds=res.best_seconds, schedule=res.best_schedule.family,
                           **tune_fields(res))
                # the rate normalized to the probe's window on the stream
                # axis, which bounds every family here (sol.BOUND_AXIS)
                norm = probe.get("norm_stream")
                if norm:
                    row.update(gflops_norm=row["gflops"] * norm, norm_axis="stream")
            emit(row)
    return rows


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpusparse_torch.bench.zoo")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--full", action="store_true", help="the tuner's exhaustive grid")
    ap.add_argument("--out", default=None,
                    help="JSON lines to append to (default: BENCH_ZOO.jsonl under the config "
                         "cache_dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run_zoo(quick=args.quick, full=args.full, out_path=args.out, device=args.device)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
