"""Times the packers' (program, column) sort on the host: ``np.lexsort``
against ``kernels.common.lex_order`` (one stable argsort of a combined
key), and the whole ``pack_dg`` at the SpMV size's geometry (kt 1, rb 4096,
ns 4, g 2048) around them, on a power-law m x m matrix with 40 nonzeros a
row on average (seed 9: the SpMV workload's generator):

    python3 tpusparse_torch/bench/pack_sort.py [--m 65536] [--reps 3]

A host measurement (it packs on the CPU, ``device="cpu"``); each number is
the best of ``--reps``.  Checks that both sorts give one order.  Prints
one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tpusparse_torch.io import builder  # noqa: E402
from tpusparse_torch.kernels import dg_gather as dg  # noqa: E402
from tpusparse_torch.kernels.common import lex_order  # noqa: E402


def best_of(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    mat = builder.power_law_coo(args.m, args.m, avg_nnz_per_row=40.0, seed=9)
    # pack_dg's length deal at rb 4096: rows dealt round-robin by falling length
    p_count = max(-(-args.m // 4096), 1)
    by_len = np.argsort(-np.bincount(mat.rows, minlength=args.m), kind="stable")
    p_of_row = np.empty(args.m, dtype=np.int64)
    p_of_row[by_len] = np.arange(args.m) % p_count
    p_arr = p_of_row[mat.rows]
    if not np.array_equal(np.lexsort((mat.cols, p_arr)), lex_order(mat.cols, p_arr)):
        raise AssertionError("lex_order gives another order than np.lexsort")
    out = {"m": args.m, "nnz": mat.nnz, "reps": args.reps,
           "lexsort_s": best_of(lambda: np.lexsort((mat.cols, p_arr)), args.reps),
           "lex_order_s": best_of(lambda: lex_order(mat.cols, p_arr), args.reps),
           "pack_dg_s": best_of(lambda: dg.pack_dg(mat, rb=4096, ns=4, g=2048, kt=1,
                                                    device="cpu"), args.reps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
