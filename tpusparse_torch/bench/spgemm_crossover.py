"""Times SpGEMM's two routes, the tiled device route (``spgemm(...,
method="device")``, A's runner cached) and host scipy (``method="host"``),
on power-law products A . B from 256^2 to 16384^2, to place
``spgemm.HOST_CROSSOVER_FLOPS``, the FLOP count under which
``method="auto"`` sends a product to scipy:

    python3 tpusparse_torch/bench/spgemm_crossover.py [--reps 5]

A = power_law_coo(n, n, avg, seed 12), B = the same with seed 13, at avg 8
for n = 256 to 4096 and avg 16 at 16384 (the JAX package's crossover
products are 4096^2 avg 8, seeds 12/13).  Each route's time is the best
of ``--reps`` calls on the host clock, the card synchronised around each
call; the device route's first call (A packed) is printed beside it.
``chip_smoke.py`` runs ``crossover`` on these products and on config #1
times its SpGEMM B.  Prints the card's name and power limit first and one
JSON object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tpusparse_torch import spgemm as sg  # noqa: E402
from tpusparse_torch.io import builder  # noqa: E402

#: (n, average nonzeros a row) of the square products A . B
SIZES = ((256, 8.0), (512, 8.0), (1024, 8.0), (2048, 8.0), (4096, 8.0), (16384, 16.0))


def products() -> dict:
    """label -> (A, B) for each of ``SIZES``."""
    return {f"{n}^2 avg {avg:g} (seeds 12/13)": (
        builder.power_law_coo(n, n, avg_nnz_per_row=avg, seed=12),
        builder.power_law_coo(n, n, avg_nnz_per_row=avg, seed=13)) for n, avg in SIZES}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def crossover(pairs: dict, reps: int = 5, log=print, note: str = "") -> list[dict]:
    """Each product's FLOPs, nnz(C) and the seconds of both routes (best of
    ``reps``); logs one line a product, ``note`` at its end."""
    rows = []
    for label, (a, b) in pairs.items():
        sg._RUNNER_CACHE.clear()
        c, t_first = _timed(lambda: sg.spgemm(a, b, method="device"))
        t_dev = min(_timed(lambda: sg.spgemm(a, b, method="device"))[1] for _ in range(reps))
        t_host = min(_timed(lambda: sg.spgemm(a, b, method="host"))[1] for _ in range(reps))
        row = {"product": label, "flops": sg.spgemm_flops(a, b), "nnz_c": c.nnz,
               "device_s": t_dev, "device_first_s": t_first, "host_s": t_host}
        rows.append(row)
        log(f"[spgemm] crossover {label}: {row['flops']:.4g} FLOPs, nnz(C) {c.nnz}; device "
            f"route {t_dev * 1e3:.3f} ms a call with A's runner cached (first call, A packed: "
            f"{t_first * 1e3:.1f} ms), host scipy {t_host * 1e3:.3f} ms (best of {reps} each; "
            f"{'device' if t_dev < t_host else 'host'} ahead by "
            f"{max(t_dev, t_host) / min(t_dev, t_host):.2f}x)" + (f"  ({note})" if note else ""))
    sg._RUNNER_CACHE.clear()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spgemm_crossover: no CUDA device", file=sys.stderr)
        return 2
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(power, flush=True)
    rows = crossover(products(), args.reps, log=lambda s: print(s, flush=True))
    print(json.dumps({"power": power, "reps": args.reps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
