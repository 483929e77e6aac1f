"""Schedules (counterpart of ``tpusparse/schedule.py``, reference L6).

A Schedule names a kernel family plus its converting / distributing /
implementing parameters; ``build_plan`` runs the operator pipeline through
the OperatorExecutor, packs the format on the device and returns a plan.
``Schedule`` keeps the JAX package's fields and defaults, so one
``describe()`` dict means the same thing in both packages.  Of the
families, this port runs ``dg_span``, ``dgt_span``, ``tile_onehot``,
``span_onehot`` and ``span_colsplit`` (the sum of column-range span
sub-plans); every other family raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from tpusparse_torch.format import pack_tile
from tpusparse_torch.generator import SpmmPlan
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import resolve_device
from tpusparse_torch.kernels.dg_gather import (PRECISIONS, choose_kt_dg, dg_spmm,
                                               dg_spmv, pack_dg)
from tpusparse_torch.kernels.dgt_gather import dgt_spmm, pack_dgt
from tpusparse_torch.kernels.span_gather import pack_span, span_spmm
from tpusparse_torch.kernels.tile_onehot import tile_spmm
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import create_init_metadata_set
from tpusparse_torch.ops import (FixedIntervalColBlockingOperator, GridBlockOperator,
                                 OperatorExecutor, TileOneHotImplementOperator)

KERNEL_FAMILIES = ("stripe_total", "stripe_nested", "nnz_segment",
                   "segment_span", "tile_onehot", "span_onehot",
                   "span_colsplit", "radix_span", "brick_ell", "dg_span",
                   "dgt_span", "bucketed", "dense", "block_ell", "hybrid_cols")
PORTED_FAMILIES = ("dg_span", "dgt_span", "tile_onehot", "span_onehot", "span_colsplit")
#: the ROADMAP.md queue-A item that ports each family still missing
ROADMAP_ITEM = {
    "stripe_total": "A.7", "stripe_nested": "A.7", "nnz_segment": "A.7",
    "segment_span": "A.7", "radix_span": "A.7", "brick_ell": "A.7",
    "bucketed": "A.7",
    "dense": "A.8", "block_ell": "A.8", "hybrid_cols": "A.8",
}


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One tuning candidate."""

    family: str = "tile_onehot"
    # converting
    sort: bool = False
    sort_by: str = "length"
    bucket_bounds: tuple = ()          # non-empty => row-nnz div ('bucketed')
    # distributing
    blocking: str = "merge_path"       # stripe_total: merge_path|balanced|fixed_rows
    work_per_block: int = 1024         # stripe/segment nnz (or work) budget
    row_interval: int = 256            # fixed_rows interval
    # tile_onehot / span params
    rb: int = 1024
    ct: int = 1024
    g: int = 512
    col_split: int = 0                 # span_colsplit: number of column ranges
    sublanes: int = 128                # radix_span: window sublane count S
    ns: int = 8                        # dg_span: window tiles (W = ns*128)
    nw: int = 4                        # dgt_span: windows per 128-lane tile
    resid: bool = True                 # dgt_span: static-residue scatter
    scatter: str = "select"            # dgt_span: select|fullrow
    walk: str = "multi"                # dgt_span: tile walk (multi|single)
    pipe: bool = False                 # dgt_span: software-pipelined body
    rowhot_i8: bool = False            # dgt_span: int8 scatter one-hot (C4)
    hot_cols: int = 0                  # hybrid_cols: dense hot-column panel width
    # implementing
    precision: str = "fp32x2"          # tile kernel precision mode
    unroll: int = 4
    ktile: int | None = None
    # per-bucket schedules for 'bucketed' (parallel to bucket count)
    bucket_schedules: tuple = ()

    def describe(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def plan_key(self) -> "Schedule":
        """This schedule with the fields that only steered the TPU kernels'
        code (``unroll``, ``scatter``, ``pipe``, ``rowhot_i8``) at their
        defaults: two schedules with one key build the same format and
        launch the same kernel on the card."""
        return dataclasses.replace(self, **{f: getattr(Schedule, f) for f in TPU_ONLY_FIELDS})


#: Schedule fields that change the TPU kernels' code but not the card's
TPU_ONLY_FIELDS = ("unroll", "scatter", "pipe", "rowhot_i8")


def _choose_kt_radix(k: int) -> int:
    """radix_span's K-tile (tpusparse/kernels/radix_gather.py:74), needed
    here only for the decision tree's radix gate."""
    for kt in (1, 2, 4, 8, 16, 32):
        if k <= kt:
            return kt
    return 32


def default_schedule(mat: CooMatrix, k: int | None = None) -> Schedule:
    """The JAX package's default family for the K regime, decision for
    decision.  Its gates are TPU-derived: 6 MB is the share of the v5e's
    VMEM that a resident X block may take (x3 for dg, the lane-packed X
    for radix and span).  The card keeps X in HBM and gathers rows through
    L2, so these gates are queued for re-derivation from H100 measurements
    (ROADMAP.md A.4); until then the port takes the same decisions."""
    n = mat.shape[1]
    kt = 128 if k is None else min(k, 128)
    x_bytes = n * 2 * kt * 2  # TPU-derived: fp32x2 packs hi+lo bf16 per X row
    if k is not None and k > 128:
        return Schedule()  # tile_onehot (streams X, safe at any N)
    if k is not None and k <= 32:
        kt_d = choose_kt_dg(k)
        if kt_d == 1 and n * 4 <= 6 * 1024 * 1024:  # TPU-derived gate
            return Schedule(family="dg_span", rb=4096, ns=4, g=2048,
                            unroll=8, ktile=1)
        if kt_d > 1 and n * kt_d * 4 <= 6 * 1024 * 1024:  # TPU-derived gate
            return Schedule(family="dg_span", rb=1024, ns=8, g=512,
                            unroll=8, ktile=kt_d)
        kt_r = _choose_kt_radix(k)
        if n * kt_r * 4 <= 6 * 1024 * 1024:  # TPU-derived gate
            return Schedule(family="radix_span", rb=1024, sublanes=128, g=1024,
                            unroll=4, ktile=kt_r)
    if k is not None and k <= 128 and n * 32 * 4 <= 6 * 1024 * 1024:  # TPU-derived gate
        # dg at kt=32 beat span at 32 < K <= 128 on the v5e
        return Schedule(family="dg_span", rb=512, ns=8, g=512, unroll=8,
                        ktile=32)
    if x_bytes <= 6 * 1024 * 1024:  # TPU-derived gate
        return Schedule(family="span_onehot", rb=512, ct=1024, g=512, unroll=4)
    if k is not None:
        return Schedule(family="span_colsplit",
                        col_split=-(-x_bytes // (4 * 1024 * 1024)),
                        rb=512, ct=1024, g=512, unroll=4)
    return Schedule()


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpusparse_torch yet (ROADMAP.md {item})")


def _build_sub_plan(ms, ex, sub: int, sched: Schedule, out_rows: int, device):
    """Run the implementing operators for one sub-matrix; return (format, fn).

    Launch geometry flows through the metadata set as in the JAX package:
    GridBlockOperator writes GLOBAL ``ktile``/``k_unroll`` and the plan
    reads them back (the reference's grid_block_operator path)."""
    ex.add_and_run(GridBlockOperator(sub, ktile=sched.ktile, unroll=sched.unroll))
    kt_meta = (int(ms.get(Level.GLOBAL, "ktile", sub))
               if ms.has(Level.GLOBAL, "ktile", sub) else None)
    if sched.family == "span_onehot":
        fmt = pack_span(ms, sub, out_rows=out_rows, rb=sched.rb, ct=sched.ct, g=sched.g,
                        device=device)

        def fn(x, fmt=fmt):
            return span_spmm(fmt, x, ktile=kt_meta, precision=sched.precision,
                             unroll=sched.unroll)

        return fmt, fn
    if sched.family == "tile_onehot":
        ex.add_and_run(TileOneHotImplementOperator(
            sub, rb=sched.rb, ct=sched.ct, g=sched.g, precision=sched.precision,
            unroll=sched.unroll))
        fmt = pack_tile(ms, sub, out_rows=out_rows, rb=sched.rb, ct=sched.ct, g=sched.g,
                        device=device)

        def fn(x, fmt=fmt):
            return tile_spmm(fmt, x, ktile=kt_meta, precision=sched.precision,
                             unroll=sched.unroll)

        return fmt, fn
    mode = sched.precision if sched.precision in PRECISIONS else "fp32x2"
    if sched.family == "dgt_span":
        kt = choose_kt_dg(max(kt_meta or 8, 2))  # kt=1 stays dg_span
        fmt = pack_dgt(ms, sub, out_rows=out_rows, rb=sched.rb, g=sched.g, kt=kt,
                       mode=mode, resid=sched.resid, nw=sched.nw, walk=sched.walk,
                       device=device)

        def fn(x, fmt=fmt):
            return dgt_spmm(fmt, x, unroll=sched.unroll, scatter=sched.scatter,
                            pipe=sched.pipe, rowhot_i8=sched.rowhot_i8)

        return fmt, fn
    kt = choose_kt_dg(kt_meta) if kt_meta else 8
    if kt == 1:
        mode = "fp32x2"
    fmt = pack_dg(ms, sub, out_rows=out_rows, rb=sched.rb, ns=sched.ns,
                  g=sched.g, kt=kt, mode=mode, device=device)

    if kt == 1:
        def fn(x, fmt=fmt):
            assert x.shape[-1] == 1, "ktile=1 dg_span schedules are K=1"
            return dg_spmv(fmt, x).reshape(-1, 1)
    else:
        def fn(x, fmt=fmt):
            return dg_spmm(fmt, x)

    return fmt, fn


def _build_span_colsplit_plan(mat: CooMatrix, sched: Schedule, device) -> SpmmPlan:
    """Column-partitioned span family (tpusparse/schedule.py:476): the
    matrix is split into ``col_split`` column ranges by the
    FixedIntervalColBlockingOperator, each range packed as its own span
    format, and the plan sums the partial products with a torch add on the
    format's device.  Every sub-format gathers back to the full output rows,
    so the sum is a plain add.  The split exists because the TPU kernel
    needed X resident in VMEM; the port keeps the JAX decision."""
    m, n = mat.shape
    s = max(int(sched.col_split), 2)
    width = -(-n // s)
    ms = create_init_metadata_set(mat)
    ex = OperatorExecutor(ms)
    ex.add_and_run(FixedIntervalColBlockingOperator(0, Level.TBLOCK, width))
    first_nzs = ms.get(Level.TBLOCK, "first_nz_indices", 0)
    col_tiles = ms.get(Level.TBLOCK, "col_tile_indices", 0)
    rows_s, cols_s, vals_s = ms.coo(0)
    fmts, ranges, pack_seconds = [], [], []
    for t in range(len(col_tiles)):
        lo = int(col_tiles[t])
        hi = min(lo + width, n)
        a, b = int(first_nzs[t]), int(first_nzs[t + 1])
        sub = CooMatrix(rows_s[a:b], cols_s[a:b] - lo, vals_s[a:b],
                        (m, hi - lo)).sort_row_major()
        t0 = time.perf_counter()
        fmts.append(pack_span(sub, rb=sched.rb, ct=min(sched.ct, hi - lo + 8), g=sched.g,
                              device=device))
        pack_seconds.append(time.perf_counter() - t0)
        ranges.append((lo, hi))

    def fn(x):
        y = None
        for fmt, (lo, hi) in zip(fmts, ranges):
            part = span_spmm(fmt, x[lo:hi], ktile=sched.ktile, precision=sched.precision,
                             unroll=sched.unroll)
            y = part if y is None else y + part
        return y

    pads = [f.padding_rate for f in fmts]
    return SpmmPlan(
        fn=fn, formats=fmts, shape=mat.shape,
        meta={"schedule": sched.describe(), "n_subs": len(fmts),
              "padding_rate": float(np.mean(pads)) if pads else 1.0,
              "operator_history": f"fixed_col_blocking[{width}] + span_colsplit[{s}]",
              "device": str(device), "col_ranges": ranges, "pack_seconds": pack_seconds},
    )


def build_plan(mat: CooMatrix, sched: Schedule, *, device="cuda") -> SpmmPlan:
    """Plan for ``sched`` with its format on ``device`` (CUDA by default;
    raises when no card is present unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if sched.family not in KERNEL_FAMILIES:
        raise ValueError(f"unknown family {sched.family!r}")
    if sched.family not in PORTED_FAMILIES:
        raise _not_ported(f"schedule family {sched.family!r}", ROADMAP_ITEM[sched.family])
    if sched.family == "span_colsplit":  # as in the JAX package, before sort and buckets
        return _build_span_colsplit_plan(mat, sched, dev)
    if sched.sort:
        raise _not_ported("Schedule(sort=True) (SortOperator)", "A.7")
    if sched.bucket_bounds:
        raise _not_ported("Schedule(bucket_bounds=...) (RowNnzMatrixDivOperator)", "A.7")
    ms = create_init_metadata_set(mat)
    ex = OperatorExecutor(ms)
    fmt, fn = _build_sub_plan(ms, ex, 0, sched, mat.shape[0], dev)
    return SpmmPlan(
        fn=fn,
        formats=[fmt],
        shape=mat.shape,
        meta={
            "schedule": sched.describe(),
            "n_subs": 1,
            "padding_rate": float(fmt.padding_rate),
            "operator_history": ex.ctx.convert_to_string(),
            "device": str(dev),
        },
    )
