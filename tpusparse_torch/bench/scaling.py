"""Multi-device scaling harness (counterpart of ``tpusparse/bench/
scaling.py``; BASELINE.json config #5).

Runs the ring-overlapped halo SpMM at 1, 2, 4, ... ranks, each call held
to the oracle.  The ratio nnz/s(d) / (d * nnz/s(1)) is a scaling
efficiency only where every rank holds a card of its own, and only then
is its field named ``efficiency``.  Ranks that share a card share its
bandwidth and its SMs, so there the field is
``shared_device_ratio_NOT_SCALING``; on CPU ranks (the plain versions,
host wall clock) it is ``cpu_wallclock_ratio_NOT_PERF``.  The multi-card
figure that one card can give is the model of ``bench/projection.py``.

Run: python -m tpusparse_torch.bench.scaling [m] [n] [k] [avg_nnz]
     [--device cpu] [--cards]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def ratio_key(devices) -> str:
    """The ratio's field name for a run whose ranks sit on ``devices``."""
    if any(d.type != "cuda" for d in devices):
        return "cpu_wallclock_ratio_NOT_PERF"
    if len(set(devices)) < len(devices):
        return "shared_device_ratio_NOT_SCALING"
    return "efficiency"


def measure_scaling(m: int = 8192, n: int = 8192, k: int = 32, avg_nnz_per_row: float = 32.0,
                    device_counts=None, iters: int = 10, seed: int = 0, ring: str = "radix",
                    device="cuda", cards: bool = False):
    """One row per rank count d: the ring's seconds a call, nnz/s, the
    ratio (under ``ratio_key``'s name) and the padding rate.  The ranks
    sit on ``device`` (virtual ranks of one card, or CPU ranks), or with
    ``cards`` rank i on ``cuda:i``.  ``device_counts`` defaults to 1, 2, 4
    (every power of two up to the card count with ``cards``).  ``ring``:
    'radix' (the JAX default where its native library is built), 'dgt' or
    'stripe'."""
    import torch

    from tpusparse_torch.bench.harness import time_fn, time_fn_host
    from tpusparse_torch.dist import make_mesh
    from tpusparse_torch.dist import overlap as ov
    from tpusparse_torch.oracle import check_result, spmm_reference

    if device_counts is None:
        n_avail = torch.cuda.device_count() if cards else 4
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    from tpusparse_torch.io import builder

    mat = builder.power_law_coo(m, n, avg_nnz_per_row=avg_nnz_per_row, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    want = spmm_reference(mat, x.astype(np.float64))

    # one name for the whole series: efficiency only where every rank of
    # the largest run holds a card of its own
    d_max = max(device_counts)
    key = ratio_key(make_mesh(d_max, 1, [f"cuda:{i}" for i in range(d_max)] if cards
                              else [device] * d_max).devices.reshape(-1).tolist())
    rows = []
    base = None
    for d in device_counts:
        devs = [f"cuda:{i}" for i in range(d)] if cards else [device] * d
        mesh = make_mesh(d, 1, devs)
        pk = dict(device=mesh.out_device)
        if ring == "dgt":
            fmt = ov.pack_halo_dgt(mat, d, rows_per_program=512, g=256, kt=8, resid=True, nw=8,
                                   walk="multi", **pk)
            fn, put_inputs = ov.build_halo_dgt_spmm(fmt, mesh, scatter="select")
        elif ring == "radix":
            fmt = ov.pack_halo_radix(mat, d, rows_per_program=1024, S=128, g=256, kt=8, **pk)
            fn, put_inputs = ov.build_halo_radix_spmm(fmt, mesh, kt=8)
        elif ring == "stripe":
            fmt = ov.pack_halo_stripe(mat, d, rows_per_stripe=64, **pk)
            fn, put_inputs = ov.build_halo_spmm(fmt, mesh)
        else:
            raise ValueError(f"ring {ring!r}: 'radix', 'dgt' or 'stripe'")
        args = put_inputs(x)
        y = fn(*args)
        check_result(y.cpu().numpy(), want, rtol=1e-3)

        timer = time_fn if y.is_cuda else time_fn_host
        sec = timer(lambda a: fn(*a), args, iters=iters)
        nnz_per_s = mat.nnz / sec
        if base is None:
            base = nnz_per_s
        rows.append({"devices": d, "seconds": sec, "nnz_per_s": nnz_per_s,
                     key: nnz_per_s / (d * base),
                     "padding_rate": fmt.padding_rate, "ring": ring,
                     "rank_devices": sorted(set(map(str, devs)))})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="the halo ring at 1, 2, 4, ... ranks")
    ap.add_argument("sizes", type=float, nargs="*", help="m n k avg_nnz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cards", action="store_true", help="rank i on cuda:i")
    ap.add_argument("--ring", default="radix")
    args = ap.parse_args(argv)
    kwargs = dict(zip(("m", "n", "k"), map(int, args.sizes[:3])))
    if len(args.sizes) > 3:
        kwargs["avg_nnz_per_row"] = float(args.sizes[3])
    for r in measure_scaling(**kwargs, ring=args.ring, device=args.device, cards=args.cards):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
