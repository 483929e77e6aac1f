"""Command line (the reference's ``./token_test <matrix.mtx> <K>``,
token_test.cc:1625-1847; counterpart of ``tpusparse/__main__.py``): load a
matrix, autotune over the schedule candidates on the card, print the
winner's time and GFLOP/s, and save its artifact.

Usage:
  python -m tpusparse_torch <matrix.mtx> [K] [--graph bfs|pr|cc] [--no-validate]
  python -m tpusparse_torch --synthetic powerlaw --m 32768 --k 8
  python -m tpusparse_torch ... --device cpu      # the plain versions, no card

Each candidate's table row goes to stderr, and the last line of stdout is
one JSON object: ``matrix``, ``k``, ``nnz``, ``best_schedule``,
``seconds``, ``gflops`` (with ``--graph``: ``algorithm`` and its fields).
Without a card and without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

DEFAULT_K = 8  # the reference's DENSE_MATRIX_SIZE (the JAX config's dense_matrix_size)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tpusparse_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("matrix", nargs="?", help=".mtx / bare-COO path")
    ap.add_argument("k", nargs="?", type=int, default=None,
                    help="dense operand columns (reference DENSE_MATRIX_SIZE)")
    ap.add_argument("--graph", choices=["bfs", "pr", "cc"], default=None,
                    help="graph-mode load + run the algorithm instead of SpMM")
    ap.add_argument("--source", type=int, default=0, help="BFS source vertex")
    ap.add_argument("--synthetic", choices=["powerlaw", "uniform", "banded", "pruned"],
                    help="generate a synthetic matrix instead of reading a file")
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--avg-nnz", type=float, default=16.0)
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="exhaustive candidate grid (unroll/precision/ktile sweep)")
    ap.add_argument("--budget", type=int, default=None,
                    help="max candidates to time (cached winner first)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card, an error without one) or 'cpu' (the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from tpusparse_torch.io import builder
    from tpusparse_torch.io.mtx import read_mtx
    from tpusparse_torch.kernels.common import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))

    if args.synthetic:
        n = args.n or args.m
        gen = {
            "powerlaw": lambda: builder.power_law_coo(args.m, n, avg_nnz_per_row=args.avg_nnz),
            "uniform": lambda: builder.uniform_coo(args.m, n, nnz_per_row=int(args.avg_nnz)),
            "banded": lambda: builder.banded_coo(args.m, n, bandwidth=int(args.avg_nnz * 2)),
            "pruned": lambda: builder.pruned_weight_coo(args.m, n, sparsity=0.9),
        }[args.synthetic]
        mat = gen()
        name = f"synthetic:{args.synthetic}"
    elif args.matrix:
        mat = read_mtx(args.matrix, graph_mode=args.graph)
        name = args.matrix
    else:
        ap.error("provide a matrix path or --synthetic")

    print(f"{name}: {mat.shape[0]}x{mat.shape[1]}, nnz={mat.nnz} "
          f"({mat.density * 100:.4f}% dense) on {dev}", file=sys.stderr)

    if args.graph:
        from tpusparse_torch import graph

        if args.graph == "bfs":
            level = graph.bfs(mat, args.source, device=dev)
            print(json.dumps({"algorithm": "bfs", "source": args.source,
                              "reached": int((level >= 0).sum()),
                              "max_level": int(level.max())}))
        elif args.graph == "pr":
            r = graph.pagerank(mat, device=dev)
            top = np.argsort(-r)[:10]
            print(json.dumps({"algorithm": "pagerank",
                              "top10": [[int(i), float(r[i])] for i in top]}))
        else:
            label = graph.connected_components(mat, device=dev)
            print(json.dumps({"algorithm": "cc",
                              "n_components": int(len(np.unique(label)))}))
        return 0

    k = args.k if args.k is not None else DEFAULT_K
    x = np.random.default_rng(0).standard_normal((mat.shape[1], k)).astype(np.float32)

    from tpusparse_torch.tune import tune

    res = tune(mat, x, validate=not args.no_validate, iters=args.iters,
               full=args.full, budget=args.budget, device=dev)
    for row in res.table:
        fam = row["schedule"]["family"] if isinstance(row.get("schedule"), dict) else "?"
        if row.get("ok"):
            print(f"  {fam}: {row['seconds'] * 1e3:.3f} ms {row['gflops']:.2f} GFLOP/s",
                  file=sys.stderr)
        else:
            print(f"  {fam}: FAILED {row.get('error', '')[:80]}", file=sys.stderr)
    print(json.dumps({
        "matrix": name, "k": k, "nnz": mat.nnz,
        "best_schedule": res.best_schedule.describe(),
        "seconds": res.best_seconds,
        "gflops": round(2.0 * mat.nnz * k / res.best_seconds / 1e9, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
