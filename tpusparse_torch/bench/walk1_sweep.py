"""Sweeps the geometry of the one-column walk kernel (#2, ``dg1_rows_cuda``):
slots a warp, warps a block and steps of 32 slots a warp loads at once, at
the shapes where ``chip_smoke.py`` reads #2: config #1 (power-law 32768^2,
alpha 1.8, seed 42) in its K = 1 default format (rb 4096, ns 4, g 2048)
and ``spmv_fn(mat, "auto")``'s format of the SpMV workload (power-law
262144^2, avg 40, seed 9):

    python3 tpusparse_torch/bench/walk1_sweep.py [--quick]

For each point: the device time a call (``harness.device_time_fn``, the
profiler over 20 calls: the kernel and the zero fill of y_rows; a CUDA
graph's replay where the profiler drops records in every window, said in
the output) and the largest error against ``dg1_rows_plain`` relative to
|A|·|x|; for each shape cuSPARSE's device time for the same product
(``torch.sparse.mm`` on CSR), and the kernel at ``WALK1_GEOMETRY`` on a
copy of the walk whose columns all name x[0]: the same streams with the
gather of x taken out (its y is not the product).  ``--quick`` sweeps
slots a warp only, at the other two knobs of ``WALK1_GEOMETRY``.  Prints
one JSON object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tpusparse_torch.bench import harness  # noqa: E402
from tpusparse_torch.io import builder  # noqa: E402
from tpusparse_torch.kernels import dg_gather as dg  # noqa: E402
from tpusparse_torch.kernels.row_walk import WALK1_GEOMETRY  # noqa: E402
from tpusparse_torch.schedule import build_plan, default_schedule  # noqa: E402
from tpusparse_torch.spmv import spmv_fn  # noqa: E402

SLOTS_PER_WARP = (64, 128, 256, 512, 1024, 2048, 4096)
WARPS_PER_BLOCK = (4, 8)
STEPS = (1, 2, 4)


def device_ms(fn, x) -> tuple[float, str]:
    """Device ms a call, and how it was read."""
    for _ in range(3):
        try:
            return harness.device_time_fn(fn, x) * 1e3, "profiler"
        except RuntimeError:
            pass
    return harness.graph_time_fn(fn, x) * 1e3, "graph replay"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="sweep slots a warp only, at WALK1_GEOMETRY's other two knobs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("walk1_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0),
           "power": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True).stdout.strip(),
           "default": list(WALK1_GEOMETRY), "shapes": {}}
    if args.quick:
        grid = [(spw, WALK1_GEOMETRY[1], WALK1_GEOMETRY[2]) for spw in SLOTS_PER_WARP]
    else:
        grid = list(itertools.product(SLOTS_PER_WARP, WARPS_PER_BLOCK, STEPS))
    mat = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    big = builder.power_law_coo(262144, 262144, avg_nnz_per_row=40.0, seed=9)
    shapes = (("config #1 default K=1", mat,
               lambda: build_plan(mat, default_schedule(mat, 1), device=dev).formats[0]),
              ("262144^2 spmv_fn('auto')", big, lambda: spmv_fn(big, "auto").format))
    for name, a, make in shapes:
        fmt = make()
        walk = dg.dg_row_walk(fmt)
        planes = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(a.shape[1]),
                            dtype=torch.float32, device=dev)
        want = dg.dg1_rows_plain(*planes, x, rb=fmt.rb).double()
        scale = dg.dg1_rows_plain(fmt.c0, fmt.cols, fmt.lrow, fmt.vals.abs(), fmt.nc_p,
                                  x.abs(), rb=fmt.rb).double().clamp(min=1.0)
        csr = a.to_csr_tensor(device=dev)
        lib_ms, lib_how = device_ms(lambda v: torch.sparse.mm(csr, v), x.view(-1, 1))
        rec = {"slots": walk.n_slots, "runs": walk.runs, "cusparse_ms": lib_ms,
               "cusparse_read": lib_how, "points": []}
        print(f"{name}: {walk.n_slots} slots, {walk.runs} runs; cuSPARSE {lib_ms:.4f} ms "
              f"({lib_how})", flush=True)
        for geometry in grid:
            def kern(v, geometry=geometry):
                return dg.dg1_rows_cuda(*planes, v, rb=fmt.rb, walk=walk, geometry=geometry)

            err = float(((kern(x).double() - want).abs() / scale).max())
            ms, how = device_ms(kern, x)
            rec["points"].append({"geometry": list(geometry), "ms": ms, "read": how,
                                  "rel_err": err})
            print(f"  spw {geometry[0]:5d} wpb {geometry[1]} steps {geometry[2]}: "
                  f"{ms:.4f} ms ({how}), rel err {err:.2e}", flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"{name} at {geometry}: rel err {err:.3e}")
        x0 = dataclasses.replace(walk, col=torch.zeros_like(walk.col))
        rec["x0_ms"], how = device_ms(
            lambda v: dg.dg1_rows_cuda(*planes, v, rb=fmt.rb, walk=x0), x)
        print(f"  at {list(WALK1_GEOMETRY)}, every column x[0] (no gather of x): "
              f"{rec['x0_ms']:.4f} ms ({how})", flush=True)
        best = min(rec["points"], key=lambda r: r["ms"])
        print(f"  fastest: {best['geometry']} {best['ms']:.4f} ms", flush=True)
        out["shapes"][name] = rec
        del fmt, walk, csr
    print(out["power"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
