"""Autotuned SpMM through the PyTorch port: the reference's
`./token_test matrix.mtx K` flow.

Run: python examples/torch_01_spmm_autotune.py [matrix.mtx] [K] [--device cpu]
(on the card by default; the CPU runs the plain versions on a small matrix)
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from tpusparse_torch.io import builder, read_mtx
from tpusparse_torch.tune import tune

ap = argparse.ArgumentParser()
ap.add_argument("matrix", nargs="?")
ap.add_argument("k", nargs="?", type=int, default=8)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# the plain versions on the CPU are slow: demo on a small matrix there
size = 8192 if args.device != "cpu" else 1024
mat = read_mtx(args.matrix) if args.matrix else builder.power_law_coo(
    size, size, avg_nnz_per_row=16.0, seed=0)
x = np.random.default_rng(0).standard_normal((mat.shape[1], args.k)).astype(np.float32)

res = tune(mat, x, device=args.device)   # enumerate, verify, keep the min
y = res.best(x)                          # the winner's plan
print("winner:", res.best_schedule.family, res.best_schedule.describe())
print("cost:", res.best.cost_summary(k=args.k))
print("Y:", tuple(y.shape), y.device)
