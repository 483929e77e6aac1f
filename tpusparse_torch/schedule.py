"""Schedules (counterpart of ``tpusparse/schedule.py``, reference L6).

A Schedule names a kernel family plus its converting / distributing /
implementing parameters; ``build_plan`` runs the operator pipeline through
the OperatorExecutor, packs the format on the device and returns a plan.
``Schedule`` keeps the JAX package's fields and defaults, so one
``describe()`` dict means the same thing in both packages.  Every family
of the JAX package runs, the dense-tile ones (``dense``, ``block_ell``,
``hybrid_cols``) included; the converting options (``sort``,
``bucket_bounds``) run through the SortOperator and the
RowNnzMatrixDivOperator as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.format import (block_nnz_before_pad, pack_segment, pack_stripe,
                                    pack_stripe_nested, pack_tile)
from tpusparse_torch.gates import CARD_GATES, Gates, dg_ns
from tpusparse_torch.generator import SpmmPlan
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell
from tpusparse_torch.kernels.common import matmul_f32, prep_x, resolve_device
from tpusparse_torch.kernels.dg_gather import (PRECISIONS, choose_kt_dg, dg_geometry,
                                               dg_spmm, dg_spmv, pack_dg)
from tpusparse_torch.kernels.dgt_gather import dgt_spmm, pack_dgt
from tpusparse_torch.kernels.nnz_split import (pack_segment_span, segment_span_spmm,
                                               segment_spmm)
from tpusparse_torch.kernels.radix_gather import (choose_kt, pack_brick_ell, pack_radix,
                                                  radix_spmm)
from tpusparse_torch.kernels.row_walk import WALK_SLOT_BYTES, WALK_SLOT_LIMIT
from tpusparse_torch.kernels.span_gather import pack_span, span_spmm
from tpusparse_torch.kernels.stripe_gather import stripe_nested_spmm, stripe_spmm
from tpusparse_torch.kernels.tile_onehot import tile_spmm
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import create_init_metadata_set
from tpusparse_torch.ops import (BalancedNnzRowBlockingOperator, ChildOffsetsOperator,
                                 EllBlockPadOperator, FixedIntervalColBlockingOperator,
                                 FixedIntervalRowBlockingOperator, FixedNnzBlockingOperator,
                                 GridBlockOperator, GroupChildrenBlockingOperator,
                                 InterleaveStorageOperator, MergeAdjacentBlocksOperator,
                                 MergePathBlockingOperator, OperatorExecutor,
                                 RelativeIndexOperator, RowNnzMatrixDivOperator,
                                 SegmentReduceOperator, SortOperator,
                                 ThreadTotalReduceOperator, TileOneHotImplementOperator,
                                 UniformBlockPadOperator)

KERNEL_FAMILIES = ("stripe_total", "stripe_nested", "nnz_segment",
                   "segment_span", "tile_onehot", "span_onehot",
                   "span_colsplit", "radix_span", "brick_ell", "dg_span",
                   "dgt_span", "bucketed", "dense", "block_ell", "hybrid_cols")


class CandidateRejected(Exception):
    """A schedule refused by a gate of its family (brick_ell's chunk
    blocks) or, in the tuner, by the padding bound or a plausibility
    guard."""


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


#: X a ``span_colsplit`` range holds, in the TPU's layout (its 4 MB of
#: VMEM); the TPU's record splits X past its gates into such ranges
COLSPLIT_RANGE_BYTES = 4 * 1024 * 1024


def default_schedule(mat: CooMatrix, k: int | None = None, *,
                     gates: Gates = CARD_GATES) -> Schedule:
    """The default family for the K regime, one decision tree read with
    ``gates`` (``tpusparse_torch.gates``).  Under ``TPU_GATES`` it is the
    JAX package's, decision for decision: 6 MB is the share of the v5e's
    VMEM that a resident X block may take (x3 for dg, the lane-packed X
    for radix and span), and X past every gate is split into column ranges
    of 4 MB.  Under ``CARD_GATES`` (the default) no X gate binds, since the
    card's kernels stage no X: K <= 128 takes ``dg_span`` at dg's K-tile,
    its window spanning X where the default window would pad its chunks
    past the tuner's padding bound (``gates.dg_ns``), but at K = 2-4 where
    the TPU's tree takes ``radix_span`` (measured faster on the card there:
    its K-tile of 2 or 4 moves fewer columns than dg's 8).  At config #1
    both records give the same schedule."""
    m, n = mat.shape
    kt = 128 if k is None else min(k, 128)
    x_bytes = n * 2 * kt * 2  # the TPU's fp32x2 layout: hi+lo bf16 per X row
    if k is not None and k > 128:
        return Schedule()  # tile_onehot (streams X, safe at any N)

    def dg(rb, ns, g, unroll, ktile):
        wt = dg_geometry(ktile, "fp32x2")[0]
        ns = dg_ns(mat.nnz, m, n, rb=rb, ns=ns, g=g, wt=wt, gates=gates)
        return Schedule(family="dg_span", rb=rb, ns=ns, g=g, unroll=unroll, ktile=ktile)

    if k is not None and k <= 32:
        kt_d = choose_kt_dg(k)
        if kt_d == 1 and gates.x_fits(n * 4, k):
            return dg(4096, 4, 2048, 8, 1)
        if kt_d > 1 and gates.x_fits(n * kt_d * 4, k):
            return dg(1024, 8, 512, 8, kt_d)
        kt_r = choose_kt(k)
        if gates.x_fits(n * kt_r * 4, k):
            return Schedule(family="radix_span", rb=1024, sublanes=128, g=1024,
                            unroll=4, ktile=kt_r)
        if gates.x_bytes is None:  # the card's, K = 2-4: dg past radix's window too
            return dg(1024, 8, 512, 8, kt_d)
    if k is not None and k <= 128 and gates.x_fits(n * 32 * 4):
        # dg at kt=32 beat span at 32 < K <= 128 on the v5e
        return dg(512, 8, 512, 8, 32)
    if gates.x_fits(x_bytes):
        return Schedule(family="span_onehot", rb=512, ct=1024, g=512, unroll=4)
    if k is not None:
        return Schedule(family="span_colsplit",
                        col_split=-(-x_bytes // COLSPLIT_RANGE_BYTES),
                        rb=512, ct=1024, g=512, unroll=4)
    return Schedule()


#: bytes a slot of brick_ell's planes (column, row, value) and, at worst,
#: of its row walk
BRICK_SLOT_BYTES = 12 + WALK_SLOT_BYTES


def brick_slot_limit(device) -> int:
    """The most slots brick_ell's planes may take: below the row walk's
    int32 index and, on a CUDA ``device``, within the card's memory a new
    tensor can take (the free memory ``mem_get_info`` reports and what
    PyTorch's caching allocator holds unused, which it reuses first), at
    ``BRICK_SLOT_BYTES`` a slot.  The packer refuses past it before it
    allocates the planes on the host."""
    if getattr(device, "type", None) != "cuda":
        return WALK_SLOT_LIMIT
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return min(WALK_SLOT_LIMIT, free // BRICK_SLOT_BYTES)


def _build_sub_plan(ms, ex, sub: int, sched: Schedule, out_rows: int, device, gates: Gates):
    """Run distributing and implementing for one sub-matrix; return
    (format, fn).  ``gates`` holds brick_ell's chunk-block refusal.

    Launch geometry flows through the metadata set as in the JAX package:
    GridBlockOperator writes GLOBAL ``ktile``/``k_unroll`` and the plan
    reads them back (the reference's grid_block_operator path)."""
    ex.add_and_run(GridBlockOperator(sub, ktile=sched.ktile, unroll=sched.unroll))
    kt_meta = (int(ms.get(Level.GLOBAL, "ktile", sub))
               if ms.has(Level.GLOBAL, "ktile", sub) else None)
    unroll = max(int(ms.get(Level.GLOBAL, "k_unroll", sub)), 1)
    fam = sched.family
    if fam == "stripe_nested":
        # TBLOCK > WARP: balanced WARP blocks, small ones merged, grouped 8
        # to a TBLOCK program, child offsets and parent-relative indices
        work = max(sched.work_per_block // 8, 8)
        ex.add_and_run(BalancedNnzRowBlockingOperator(sub, Level.WARP, work))
        ex.add_and_run(MergeAdjacentBlocksOperator(sub, Level.WARP, work))
        ex.add_and_run(GroupChildrenBlockingOperator(sub, Level.TBLOCK, Level.WARP,
                                                     children_per_parent=8))
        ex.add_and_run(ChildOffsetsOperator(sub, Level.TBLOCK, Level.WARP))
        ex.add_and_run(RelativeIndexOperator(sub, Level.WARP, Level.TBLOCK))
        ex.add_and_run(ThreadTotalReduceOperator(sub, Level.TBLOCK))
        fmt = pack_stripe_nested(ms, sub, out_rows=out_rows, unroll=unroll, device=device)

        def fn(x, fmt=fmt):
            return stripe_nested_spmm(fmt, x, ktile=kt_meta, unroll=unroll)

        return fmt, fn
    if fam == "stripe_total":
        if sched.blocking == "merge_path":
            ex.add_and_run(MergePathBlockingOperator(sub, Level.TBLOCK, sched.work_per_block))
        elif sched.blocking == "balanced":
            ex.add_and_run(BalancedNnzRowBlockingOperator(sub, Level.TBLOCK,
                                                          sched.work_per_block))
        else:
            ex.add_and_run(FixedIntervalRowBlockingOperator(sub, Level.TBLOCK,
                                                            sched.row_interval))
        ex.add_and_run(ThreadTotalReduceOperator(sub, Level.TBLOCK))
        live = block_nnz_before_pad(ms, sub)
        ex.add_and_run(UniformBlockPadOperator(sub, Level.TBLOCK, multiple_of=unroll))
        fmt = pack_stripe(ms, sub, out_rows=out_rows, live=live, device=device)

        def fn(x, fmt=fmt):
            return stripe_spmm(fmt, x, ktile=kt_meta, unroll=unroll)

        return fmt, fn
    if fam == "nnz_segment":
        nnz_live = ms.nnz(sub)  # before the blocking pads the nnz to whole blocks
        ex.add_and_run(FixedNnzBlockingOperator(sub, Level.TBLOCK, sched.work_per_block))
        ex.add_and_run(SegmentReduceOperator(sub, Level.TBLOCK))
        fmt = pack_segment(ms, sub, out_rows=out_rows, nnz_live=nnz_live, device=device)

        def fn(x, fmt=fmt):
            return segment_spmm(fmt, x, ktile=kt_meta, unroll=unroll)

        return fmt, fn
    if fam == "span_onehot":
        fmt = pack_span(ms, sub, out_rows=out_rows, rb=sched.rb, ct=sched.ct, g=sched.g,
                        device=device)

        def fn(x, fmt=fmt):
            return span_spmm(fmt, x, ktile=kt_meta, precision=sched.precision,
                             unroll=sched.unroll)

        return fmt, fn
    if fam == "tile_onehot":
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
    if fam in ("radix_span", "brick_ell"):
        kt = choose_kt(kt_meta) if kt_meta else 8
        if fam == "radix_span":
            fmt = pack_radix(ms, sub, out_rows=out_rows, rb=sched.rb, S=sched.sublanes,
                             g=sched.g, kt=kt, mode=mode, device=device)
        else:
            # the reference's headline layout: length sort (the Schedule's
            # sort), 8-row bricks ELL-padded to the brick max, interleaved
            # storage, chunked in stored order
            ex.add_and_run(FixedIntervalRowBlockingOperator(sub, Level.TBLOCK, 8))
            ex.add_and_run(EllBlockPadOperator(sub, Level.TBLOCK))
            ex.add_and_run(InterleaveStorageOperator(sub, Level.TBLOCK))
            try:
                fmt = pack_brick_ell(ms, sub, out_rows=out_rows, rb=sched.rb, S=sched.sublanes,
                                     g=sched.g, kt=kt, mode=mode, device=device,
                                     max_slots=brick_slot_limit(device))
            except ValueError as e:
                if "brick_ell planes" not in str(e):
                    raise
                raise CandidateRejected(f"{e}: the card's memory or the row walk's int32 "
                                        "index") from e
            blk_bytes = fmt.n_chunks * fmt.chunk_g * 12
            if gates.brick_block_bytes is not None and blk_bytes > gates.brick_block_bytes:
                raise CandidateRejected(
                    f"brick_ell chunk blocks need {blk_bytes / 2**20:.0f} MB of the TPU's "
                    f"VMEM (NC={fmt.n_chunks}): the interleaved layout has no column "
                    "locality on this matrix; use radix_span")

        def fn(x, fmt=fmt):
            return radix_spmm(fmt, x, unroll=sched.unroll)

        return fmt, fn
    if fam == "dgt_span":
        kt = choose_kt_dg(max(kt_meta or 8, 2))  # kt=1 stays dg_span
        fmt = pack_dgt(ms, sub, out_rows=out_rows, rb=sched.rb, g=sched.g, kt=kt,
                       mode=mode, resid=sched.resid, nw=sched.nw, walk=sched.walk,
                       device=device)

        def fn(x, fmt=fmt):
            return dgt_spmm(fmt, x, unroll=sched.unroll, scatter=sched.scatter,
                            pipe=sched.pipe, rowhot_i8=sched.rowhot_i8)

        return fmt, fn
    if fam != "dg_span":
        raise ValueError(f"{fam!r} has no sub-plan")
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
    needed X resident in VMEM: the TPU's record (``TPU_GATES``) takes it
    past its X gates, the card's never does."""
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


def _build_segment_span_plan(mat: CooMatrix, sched: Schedule, device) -> SpmmPlan:
    """Equal-nnz blocks, span-chunked (tpusparse/schedule.py:541-556)."""
    fmt = pack_segment_span(mat, block_nnz=sched.work_per_block, ct=sched.ct, g=sched.g,
                            device=device)

    def fn(x):
        return segment_span_spmm(fmt, x, ktile=sched.ktile, precision=sched.precision,
                                 unroll=sched.unroll)

    return SpmmPlan(fn=fn, formats=[fmt], shape=mat.shape,
                    meta={"schedule": sched.describe(), "n_subs": 1,
                          "padding_rate": fmt.padding_rate,
                          "operator_history": "segment_span", "device": str(device)})


def _dense_dtype(sched: Schedule) -> torch.dtype:
    return torch.bfloat16 if sched.precision == "bf16" else torch.float32


#: the largest A (as fp32 bytes) that the dense family densifies on the
#: host (tpusparse/schedule.py:328); past it the scatter runs on the device
DENSE_HOST_BYTES = 256 * 1024 * 1024


def _build_dense_plan(mat: CooMatrix, sched: Schedule, device) -> SpmmPlan:
    """The dense product as a schedule family (tpusparse/schedule.py:315):
    at high density or large K the dense product beats any gather, and the
    tuner measures which.  A is densified on the host up to 256 MB of fp32,
    past that on the device (``index_put_`` accumulating the values cast to
    the product's dtype, as JAX's ``.at[].add``).  bf16 multiplies with an
    fp32 result (``matmul_f32``); fp32 in full fp32."""
    dt = _dense_dtype(sched)
    m, n = mat.shape
    if m * n * np.dtype("float32").itemsize <= DENSE_HOST_BYTES:
        a = torch.from_numpy(mat.to_dense(np.float32)).to(device, dt)
    else:
        a = torch.zeros((m, n), dtype=dt, device=device)
        idx = (torch.from_numpy(np.asarray(mat.rows)).to(device),
               torch.from_numpy(np.asarray(mat.cols)).to(device))
        a.index_put_(idx, torch.as_tensor(np.asarray(mat.vals, np.float32),
                                          device=device).to(dt), accumulate=True)

    def fn(x):
        return matmul_f32(a, prep_x(x, device).to(dt))

    return SpmmPlan(
        fn=fn, formats=[], shape=mat.shape,
        meta={"schedule": sched.describe(), "n_subs": 1, "padding_rate": 1.0,
              "operator_history": "dense",
              # the densified A is the format: its residency is the trade-off
              "format_bytes": a.numel() * a.element_size(), "device": str(device)})


def _build_block_ell_plan(mat: CooMatrix, sched: Schedule, device, gates: Gates) -> SpmmPlan:
    """The block-sparse dense-tile family (tpusparse/schedule.py:359): BS
    is the Schedule's ``row_interval`` where it is 64, 128 or 256, else
    128; the plan runs ``gates.block_ell_method``: the kernel (#13) on the
    card's record, the JAX package's batched product (``xla``) on the
    TPU's."""
    bs = sched.row_interval if sched.row_interval in (64, 128, 256) else 128
    fmt = pack_block_ell(mat, bs=bs, dtype=_dense_dtype(sched), device=device)
    prec = "bf16" if sched.precision == "bf16" else "fp32"

    def fn(x):
        return block_ell_spmm(fmt, x, precision=prec, ktile=sched.ktile,
                              method=gates.block_ell_method)

    return SpmmPlan(
        fn=fn, formats=[fmt], shape=mat.shape,
        meta={"schedule": sched.describe(), "n_subs": 1,
              "padding_rate": fmt.padding_rate * (fmt.bs ** 2 * fmt.n_blocks)
              / max(mat.nnz, 1),
              "operator_history": "block_ell", "device": str(device)})


def _build_hybrid_cols_plan(mat: CooMatrix, sched: Schedule, device, gates: Gates) -> SpmmPlan:
    """Hot-column hybrid (tpusparse/schedule.py:383): the ``hot_cols``
    most-populated columns (128 at least, rounded up to a multiple of 128)
    become a dense (M, C) panel, multiplied as the dense family does with
    the hot rows of X taken by ``index_select``; the remainder runs
    ``build_plan`` of its default schedule (at the Schedule's ``ktile``, 8
    when unset) or of ``bucket_schedules[0]``.  ``format_bytes`` counts the
    panel and the remainder's formats by ``memory_bytes``, which leaves out
    the port's own per-program chunk counts (``nc_p``), as JAX's count
    has no such field: the two packages count the same bytes."""
    m, n = mat.shape
    C = min(max(int(sched.hot_cols) or 512, 128), n)
    C = (C + 127) & ~127  # the TPU's lane padding of the panel width
    counts = np.bincount(mat.cols, minlength=n)
    if C >= n:
        hot = np.arange(n, dtype=np.int64)
        C = n
    else:
        hot = np.sort(np.argpartition(counts, n - C)[n - C:])
    is_hot = np.zeros(n, dtype=bool)
    is_hot[hot] = True
    colmap = np.cumsum(is_hot) - 1  # panel position of each hot column
    sel = is_hot[mat.cols]
    dt = _dense_dtype(sched)
    panel_np = np.zeros((m, C), np.float32)
    np.add.at(panel_np, (mat.rows[sel], colmap[mat.cols[sel]]),
              np.asarray(mat.vals[sel], np.float32))
    panel = torch.from_numpy(panel_np).to(device, dt)
    hot_d = torch.from_numpy(hot).to(device)
    rest = CooMatrix(mat.rows[~sel], mat.cols[~sel], np.asarray(mat.vals)[~sel], mat.shape)
    covered = int(sel.sum())
    rest_plan = None
    if rest.nnz:
        rest_sched = (sched.bucket_schedules[0] if sched.bucket_schedules
                      else default_schedule(rest, sched.ktile or 8, gates=gates))
        if sched.ktile is not None:
            rest_sched = dataclasses.replace(rest_sched, ktile=sched.ktile)
        rest_plan = build_plan(rest, rest_sched, device=device, gates=gates)

    def panel_mm(x):
        return matmul_f32(panel, x.index_select(0, hot_d).to(dt))

    def fn(x):
        x = prep_x(x, device)
        return panel_mm(x) if rest_plan is None else panel_mm(x) + rest_plan(x)

    rest_meta = rest_plan.meta if rest_plan else {"padding_rate": 1.0}
    rest_bytes = (int(rest_meta.get("format_bytes") or sum(f.memory_bytes
                                                           for f in rest_plan.formats))
                  if rest_plan else 0)
    # nnz-weighted padding: the panel's nonzeros pad nothing (its bytes are
    # in format_bytes); only the sparse remainder pads
    pad = (covered + rest.nnz * float(rest_meta["padding_rate"])) / max(mat.nnz, 1)
    return SpmmPlan(
        fn=fn, formats=(rest_plan.formats if rest_plan else []), shape=mat.shape,
        meta={"schedule": sched.describe(), "n_subs": 2 if rest_plan else 1,
              "padding_rate": pad,
              "operator_history": (f"hybrid_cols[C={C}, covered={covered}/{mat.nnz}]"
                                   + (" + " + str(rest_meta.get("operator_history", ""))
                                      if rest_plan else "")),
              "format_bytes": panel.numel() * panel.element_size() + rest_bytes,
              "hot_cols": int(C), "covered_nnz": covered, "device": str(device)})


def build_plan(mat: CooMatrix, sched: Schedule, *, device="cuda",
               gates: Gates = CARD_GATES) -> SpmmPlan:
    """Plan for ``sched`` with its formats on ``device`` (CUDA by default;
    raises when no card is present unless ``device="cpu"``).  ``gates``
    (``tpusparse_torch.gates``): under ``TPU_GATES`` brick_ell is refused
    where its chunk blocks pass the TPU's 4 MB and the ``block_ell`` plan
    runs the batched product, as in the JAX package; under ``CARD_GATES``
    (the default) the ``block_ell`` plan runs the kernel and brick_ell is
    refused only where its planes pass ``brick_slot_limit``, as on both
    records.  As in the JAX
    package (tpusparse/schedule.py:558): ``dense``, ``block_ell``,
    ``hybrid_cols``, ``span_colsplit`` and ``segment_span`` build their own
    formats; every other family runs the
    operator pipeline, with the length sort first where ``sort`` is set and
    the row-nnz division into one sub-plan per bucket where the family is
    ``bucketed`` or ``bucket_bounds`` is set, the plan summing the
    sub-plans' products."""
    dev = resolve_device(device)
    if sched.family not in KERNEL_FAMILIES:
        raise ValueError(f"unknown family {sched.family!r}")
    if sched.family == "dense":
        return _build_dense_plan(mat, sched, dev)
    if sched.family == "block_ell":
        return _build_block_ell_plan(mat, sched, dev, gates)
    if sched.family == "hybrid_cols":
        return _build_hybrid_cols_plan(mat, sched, dev, gates)
    if sched.family == "span_colsplit":  # as in the JAX package, before sort and buckets
        return _build_span_colsplit_plan(mat, sched, dev)
    if sched.family == "segment_span":
        return _build_segment_span_plan(mat, sched, dev)
    ms = create_init_metadata_set(mat)
    ex = OperatorExecutor(ms)
    if sched.sort:
        ex.add_and_run(SortOperator(0, by=sched.sort_by))

    subs = [0]
    sub_scheds = {0: sched}
    if sched.family == "bucketed" or sched.bucket_bounds:
        div = RowNnzMatrixDivOperator(0, bounds=tuple(sched.bucket_bounds))
        ex.add_and_run(div)
        subs = div.new_sub_ids
        bucketed = sched.family == "bucketed"
        for i, s in enumerate(subs):
            if i < len(sched.bucket_schedules):
                sub_scheds[s] = sched.bucket_schedules[i]
            else:  # a bucketed plan's default sub-plan is span_onehot rb=512 ct=1024
                sub_scheds[s] = dataclasses.replace(
                    sched, family="span_onehot" if bucketed else sched.family,
                    rb=512 if bucketed else sched.rb, ct=1024 if bucketed else sched.ct,
                    bucket_bounds=(), bucket_schedules=())

    formats, fns = [], []
    for s in subs:
        fmt, fn = _build_sub_plan(ms, ex, s, sub_scheds[s], mat.shape[0], dev, gates)
        formats.append(fmt)
        fns.append(fn)

    if not fns:  # no bucket holds a row: Y is zero, as the oracle's
        def plan_fn(x):
            x = prep_x(x, dev)
            return torch.zeros((mat.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32,
                               device=dev)
    elif len(fns) == 1:
        plan_fn = fns[0]
    else:
        def plan_fn(x):
            y = fns[0](x)
            for f in fns[1:]:
                y = y + f(x)
            return y

    pads = [f.padding_rate for f in formats]
    return SpmmPlan(
        fn=plan_fn,
        formats=formats,
        shape=mat.shape,
        meta={
            "schedule": sched.describe(),
            "n_subs": len(subs),
            "padding_rate": float(np.mean(pads)) if pads else 1.0,
            "operator_history": ex.ctx.convert_to_string(),
            "device": str(dev),
        },
    )
