"""Packed sparse formats built by the operator pipeline (counterpart of
``tpusparse/format.py``).

The row-aligned ``StripeFormat`` (stripe_total), the nnz-direction
``SegmentFormat`` (nnz_segment), the two-level ``NestedStripeFormat``
(stripe_nested) and the column-tiled ``TileFormat``, each with its packer
and a ``*_format_from_numpy`` twin that takes the JAX format's arrays.
Every format holds torch tensors on one device and carries the output
recovery: ``slot_of_origrow`` (the gather that undoes sorting and padding
in one index_select) or, for segments, ``row_of_slot`` (the combine's
scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpusparse_torch.kernels.common import resolve_device, to_device, value_dtype
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


def _slot_of_origrow(ms: MetaDataSet, sub: int, out_rows: int, slot_of_local) -> np.ndarray:
    """Original row -> slot, -1 for rows absent from this sub-matrix."""
    row_num = ms.row_num(sub)
    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        rec = ms.get(Level.ROW, "original_row_of_sorted", sub)[:row_num]
    else:
        rec = np.arange(row_num, dtype=np.int64)
    out = np.full(out_rows, -1, dtype=np.int64)
    keep = rec >= 0
    out[rec[keep]] = slot_of_local[keep]
    return out


def _tensor_bytes(*arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays)


@dataclasses.dataclass
class StripeFormat:
    """Row-aligned stripe format (the reference's thread-total blocking
    with padding): one stripe is a contiguous run of rows with a uniform
    nnz budget C, and no row straddles stripes, so each stripe's rows are
    written by one block (the reference's direct store,
    total_BMT_result_...token.cc).

      cols  [P, 1, C] int32  global column of each nz
      lrow  [P, 1, C] int32  row local to the stripe (< RB)
      vals  [P, 1, C] float  value (0 for padding, whose column repeats a
                             real one); float32 or the packer's val_dtype
      slot_of_origrow [M] int32  p * RB + local row per original row (-1
                                 for rows absent from this sub-matrix)
      live_p [P] int32       the stripe's slots that hold an entry of the
                             COO (``live_counts``): the kernel walks only
                             those

    RB is the most rows any stripe holds.  Every array but ``live_p`` (the
    port's own field, like ``BlockEllFormat.nb_p``, not counted in
    ``memory_bytes``) equals the JAX ``StripeFormat``'s; ``memory_bytes``
    is a property here (a method there).
    """

    cols: Any
    lrow: Any
    vals: Any
    slot_of_origrow: Any
    live_p: Any
    n_stripes: int
    stripe_nnz: int
    max_rows_per_stripe: int
    shape: tuple[int, int]
    nnz_real: int

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def padding_rate(self) -> float:
        return self.n_stripes * self.stripe_nnz / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return _tensor_bytes(self.cols, self.lrow, self.vals)


STRIPE_FIELDS = ("cols", "lrow", "vals", "slot_of_origrow")


def block_nnz_before_pad(ms: MetaDataSet, sub: int, level: Level = Level.TBLOCK) -> np.ndarray:
    """Each ``level`` block's nnz as blocked, read before the uniform pad
    (UniformBlockPadOperator) appends value-0 padding at each block's end:
    the ``live`` of ``pack_stripe``.  [0] for a matrix with no block (the
    pad then makes one block of padding)."""
    sizes = np.diff(ms.get(level, "first_nz_indices", sub).astype(np.int64))
    return sizes if sizes.size else np.zeros(1, np.int64)


def live_counts(vals, *, live=None) -> np.ndarray:
    """[P] int32: the live slots of each stripe (or segment block) of a
    [P, 1, C] value plane.

    The packers keep a stripe's entries first, in row-major order, and
    append the padding after them: ``pad_blocks_to_uniform_nnz`` pads each
    block at its end, ``pad_nnz_to_multiple`` (nnz_segment) appends to the
    last row, so only the last block holds padding, at its end.  So the
    live slots of every stripe are a prefix, and a kernel walks slots
    [0, live_p[p]) and never reads the rest.  The count is the pattern's,
    not ``vals != 0``: a stored zero of the COO, which training or
    ``load_state_dict`` may make nonzero, is live.  ``live`` gives it (the
    packers pass each block's nnz before the pad); without it, for a format
    that comes from outside the packer, it is the last slot holding a
    nonzero plus one, as ``block_ell_format_from_numpy`` derives ``nb_p``."""
    v = np.asarray(vals).reshape(len(vals), -1)
    P, C = v.shape
    if live is None:
        nz = v != 0
        live = np.where(nz.any(axis=1), C - np.argmax(nz[:, ::-1], axis=1), 0)
    live = np.asarray(live, np.int64).reshape(-1)
    if live.shape != (P,) or live.min(initial=0) < 0 or live.max(initial=0) > C:
        raise ValueError(f"live slots {live.shape} out of range for a [{P}, 1, {C}] plane")
    return live.astype(np.int32)


def pack_stripe(ms: MetaDataSet, sub: int, *, out_rows: int, level: Level = Level.TBLOCK,
                val_dtype=None, live=None, device="cuda") -> StripeFormat:
    """Pack a row-aligned, uniform-nnz blocked sub-matrix into StripeFormat
    on ``device`` (tpusparse/format.py:65).  Preconditions: ``level`` has
    first_row_indices / first_nz_indices with the same nnz in every block
    (UniformBlockPadOperator) and row-major nz order.  ``out_rows`` is the
    original matrix's row count; ``val_dtype`` the value plane's dtype
    (float32 by default); ``live`` each block's nnz before the uniform pad
    (``block_nnz_before_pad``; ``live_counts`` derives it from the values
    without)."""
    dev = resolve_device(device)
    first_rows = ms.get(level, "first_row_indices", sub).astype(np.int64)
    first_nzs = ms.get(level, "first_nz_indices", sub).astype(np.int64)
    rows, cols, vals = ms.coo(sub)
    sizes = np.diff(first_nzs)
    assert sizes.size >= 1 and (sizes == sizes[0]).all(), "stripe nnz must be uniform"
    c, p = int(sizes[0]), int(sizes.size)
    assert p * c == rows.size

    lrow = rows - first_rows[np.repeat(np.arange(p, dtype=np.int64), c)]
    rb = max(int(np.diff(first_rows).max()), 1)
    assert lrow.min() >= 0 and lrow.max() < rb

    local_rows = np.arange(ms.row_num(sub), dtype=np.int64)
    blk = np.clip(np.searchsorted(first_rows, local_rows, side="right") - 1, 0, p - 1)
    slot = _slot_of_origrow(ms, sub, out_rows, blk * rb + (local_rows - first_rows[blk]))
    vals32 = np.asarray(vals, dtype=np.float32).reshape(p, 1, c)
    return StripeFormat(
        cols=to_device(dev, cols.reshape(p, 1, c)),
        lrow=to_device(dev, lrow.reshape(p, 1, c)),
        vals=to_device(dev, vals32, value_dtype(val_dtype)),
        slot_of_origrow=to_device(dev, slot),
        live_p=to_device(dev, live_counts(np.asarray(vals).reshape(p, 1, c), live=live)),
        n_stripes=p,
        stripe_nnz=c,
        max_rows_per_stripe=rb,
        shape=(out_rows, ms.col_num(sub)),
        nnz_real=int(np.count_nonzero(vals)),
    )


@dataclasses.dataclass
class SegmentFormat:
    """nnz-direction format for the segment-reduce path (the reference's
    bit-map and segment reduction templates): blocks own equal nnz ranges,
    rows straddle blocks, and each (block, row) segment's partial sum is
    combined into Y afterwards.  The arrays mirror StripeFormat's, but
    ``lrow`` holds the segment id local to the block (< ``max_segments``)
    and ``row_of_slot`` [P * max_segments] int32 maps each (block,
    segment) slot to its original row (-1 for unused slots).  ``live_p``
    [P] int32 is the port's own field, as on StripeFormat (``live_counts``:
    the last block's padding is not walked)."""

    cols: Any
    lrow: Any
    vals: Any
    row_of_slot: Any
    live_p: Any
    n_blocks: int
    block_nnz: int
    max_segments: int
    shape: tuple[int, int]
    nnz_real: int

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def padding_rate(self) -> float:
        return self.n_blocks * self.block_nnz / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return _tensor_bytes(self.cols, self.lrow, self.vals, self.row_of_slot)


SEGMENT_FIELDS = ("cols", "lrow", "vals", "row_of_slot")


def pack_segment(ms: MetaDataSet, sub: int, *, out_rows: int, level: Level = Level.TBLOCK,
                 val_dtype=None, nnz_live: int | None = None, device="cuda") -> SegmentFormat:
    """Pack an nnz-direction blocked sub-matrix (uniform block nnz, the
    bitmap of SegmentReduceOperator) into SegmentFormat on ``device``
    (tpusparse/format.py:294).  ``nnz_live``: the sub-matrix's nnz before
    FixedNnzBlockingOperator padded it to whole blocks (``live_counts``
    derives the live slots from the values without)."""
    dev = resolve_device(device)
    first_nzs = ms.get(level, "first_nz_indices", sub).astype(np.int64)
    rows, cols, vals = ms.coo(sub)
    bm = ms.get(level, "bit_map_of_thread", sub).astype(np.int64)
    nnz = rows.size
    sizes = np.diff(first_nzs)
    assert sizes.size >= 1 and (sizes == sizes[0]).all(), "block nnz must be uniform"
    c, p = int(sizes[0]), int(sizes.size)
    assert p * c == nnz

    # segment id local to the block: the bitmap's running count inside it
    seg_global = np.cumsum(bm) - 1
    block_of_nz = np.repeat(np.arange(p, dtype=np.int64), c)
    lseg = seg_global - seg_global[first_nzs[:-1]][block_of_nz]
    rb = int(lseg.max()) + 1 if nnz else 1

    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        rec = ms.get(Level.ROW, "original_row_of_sorted", sub)[: ms.row_num(sub)]
    else:
        rec = np.arange(ms.row_num(sub), dtype=np.int64)
    row_of_slot = np.full(p * rb, -1, dtype=np.int64)
    starts = bm.astype(bool)
    local_row = rows[starts]
    row_of_slot[block_of_nz[starts] * rb + lseg[starts]] = np.where(
        local_row < rec.size, rec[np.minimum(local_row, rec.size - 1)], -1)
    vals32 = np.asarray(vals, dtype=np.float32).reshape(p, 1, c)
    return SegmentFormat(
        cols=to_device(dev, cols.reshape(p, 1, c)),
        lrow=to_device(dev, lseg.reshape(p, 1, c)),
        vals=to_device(dev, vals32, value_dtype(val_dtype)),
        row_of_slot=to_device(dev, row_of_slot),
        live_p=to_device(dev, live_counts(
            vals32, live=None if nnz_live is None
            else np.clip(nnz_live - np.arange(p, dtype=np.int64) * c, 0, c))),
        n_blocks=p,
        block_nnz=c,
        max_segments=rb,
        shape=(out_rows, ms.col_num(sub)),
        nnz_real=int(np.count_nonzero(vals)),
    )


@dataclasses.dataclass
class NestedStripeFormat:
    """Two-level stripe format: TBLOCK programs holding WARP sub-blocks
    addressed by parent-relative offsets (the reference's nested BMTB > BMW
    loops with ..._relative_to_BMTB indices, code_generator.cc:1655-1871).

      cols  [P, 1, C]       int32  global column per nz
      lrow  [P, 1, C]       int32  row local to the warp sub-block
      vals  [P, 1, C]       f32
      wnz   [P, 1, Wmax+1]  int32  warp first-nz offsets in the stripe
                                   (multiples of ``unroll``; the entries
                                   past a stripe's warps hold its end)
      wrow  [P, 1, Wmax+1]  int32  warp first rows relative to the stripe's
      slot_of_origrow [M]   int32
    """

    cols: Any
    lrow: Any
    vals: Any
    wnz: Any
    wrow: Any
    slot_of_origrow: Any
    n_stripes: int
    stripe_nnz: int
    n_warps: int
    max_rows_per_stripe: int
    shape: tuple[int, int]
    nnz_real: int

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def padding_rate(self) -> float:
        return self.n_stripes * self.stripe_nnz / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return _tensor_bytes(self.cols, self.lrow, self.vals, self.wnz, self.wrow)


NESTED_FIELDS = ("cols", "lrow", "vals", "wnz", "wrow", "slot_of_origrow")


def pack_stripe_nested(ms: MetaDataSet, sub: int, *, out_rows: int, unroll: int = 8,
                       device="cuda") -> NestedStripeFormat:
    """Pack a TBLOCK > WARP two-level blocking into NestedStripeFormat on
    ``device`` (tpusparse/format.py:387).  Preconditions: TBLOCK boundaries
    nest the WARP ones (GroupChildrenBlockingOperator), with the child
    offsets (ChildOffsetsOperator) and parent-relative arrays
    (RelativeIndexOperator).  Each warp's run is padded to a multiple of
    ``unroll``, padding repeating the warp's last column."""
    dev = resolve_device(device)
    w_rows = ms.get(Level.WARP, "first_row_indices", sub).astype(np.int64)
    w_nzs = ms.get(Level.WARP, "first_nz_indices", sub).astype(np.int64)
    p_rows = ms.get(Level.TBLOCK, "first_row_indices", sub).astype(np.int64)
    p_nzs = ms.get(Level.TBLOCK, "first_nz_indices", sub).astype(np.int64)
    offs = ms.get(Level.TBLOCK, "first_BMW_indices", sub).astype(np.int64)
    assert ms.has(Level.WARP, "first_nz_indices_relative_to_BMTB", sub), \
        "run RelativeIndexOperator(WARP, TBLOCK) first"
    rows, cols, vals = ms.coo(sub)

    p = p_nzs.size - 1
    wmax = int(np.diff(offs).max()) if p else 1
    wsz_pad = -(-np.diff(w_nzs) // unroll) * unroll
    c_per_p = np.add.reduceat(wsz_pad, offs[:-1]) if wsz_pad.size else np.zeros(p, np.int64)
    c = int(c_per_p.max()) if p else unroll
    c = max(-(-c // unroll) * unroll, unroll)

    cols_a = np.zeros((p, 1, c), dtype=np.int32)
    lrow_a = np.zeros((p, 1, c), dtype=np.int32)
    vals_a = np.zeros((p, 1, c), dtype=np.float32)
    wnz_a = np.zeros((p, 1, wmax + 1), dtype=np.int32)
    wrow_a = np.zeros((p, 1, wmax + 1), dtype=np.int32)
    for b in range(p):
        pos = 0
        wlo, whi = int(offs[b]), int(offs[b + 1])
        for wi, w in enumerate(range(wlo, whi)):
            lo, hi = int(w_nzs[w]), int(w_nzs[w + 1])
            nreal = hi - lo
            wnz_a[b, 0, wi] = pos
            wrow_a[b, 0, wi] = int(w_rows[w] - p_rows[b])
            cols_a[b, 0, pos:pos + nreal] = cols[lo:hi]
            lrow_a[b, 0, pos:pos + nreal] = rows[lo:hi] - w_rows[w]
            vals_a[b, 0, pos:pos + nreal] = vals[lo:hi]
            if nreal:  # padding repeats the warp's last column (index stays valid)
                cols_a[b, 0, pos + nreal:pos + int(wsz_pad[w])] = cols[hi - 1]
            pos += int(wsz_pad[w])
        wnz_a[b, 0, whi - wlo:] = pos
        wrow_a[b, 0, whi - wlo:] = int(p_rows[b + 1] - p_rows[b])

    rb = max(int(np.diff(p_rows).max()) if p else 1, 1)
    local_rows = np.arange(ms.row_num(sub), dtype=np.int64)
    blk = np.clip(np.searchsorted(p_rows, local_rows, side="right") - 1, 0, p - 1)
    slot = _slot_of_origrow(ms, sub, out_rows, blk * rb + (local_rows - p_rows[blk]))
    return NestedStripeFormat(
        cols=to_device(dev, cols_a), lrow=to_device(dev, lrow_a),
        vals=to_device(dev, vals_a, torch.float32), wnz=to_device(dev, wnz_a),
        wrow=to_device(dev, wrow_a), slot_of_origrow=to_device(dev, slot),
        n_stripes=p, stripe_nnz=c, n_warps=wmax, max_rows_per_stripe=rb,
        shape=(out_rows, ms.col_num(sub)),
        nnz_real=int(np.count_nonzero(vals_a)),
    )


def _checked_tensors(kind: str, fields: dict, names, want: dict, dev, bad: bool,
                     live: bool = False):
    """The arrays of ``names`` as tensors on ``dev`` (vals float32, or
    bfloat16 where the JAX plane was, the rest int32) after the shape checks
    of ``want`` and the index check ``bad``; with ``live``, also ``live_p``
    (``fields["live_p"]`` where given, else derived by ``live_counts``)."""
    arrs = {k: np.asarray(fields[k]) for k in names}
    if live:
        arrs["live_p"] = live_counts(arrs["vals"], live=fields.get("live_p"))
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"{kind}.{k}: shape {arrs[k].shape}, want {shp}")
    if bad(arrs):
        raise ValueError(f"{kind} indices out of range")
    vals_dt = torch.bfloat16 if arrs["vals"].dtype.name == "bfloat16" else torch.float32
    return {k: to_device(dev, a.astype(np.float32), vals_dt) if k == "vals"
            else to_device(dev, a) for k, a in arrs.items()}


def stripe_format_from_numpy(fields: dict, *, device="cuda", **static) -> StripeFormat:
    """A StripeFormat from the JAX ``StripeFormat``'s arrays (``cols``,
    ``lrow``, ``vals``, ``slot_of_origrow``; ``live_p`` is derived from
    ``vals`` unless given) and static fields; shapes and index ranges are
    checked, since the kernels read X and write Y at these indices without
    bounds checks."""
    P, C, rb = static["n_stripes"], static["stripe_nnz"], static["max_rows_per_stripe"]
    m, n = static["shape"]
    want = {"cols": (P, 1, C), "lrow": (P, 1, C), "vals": (P, 1, C), "slot_of_origrow": (m,)}

    def bad(a):
        return (a["cols"].min(initial=0) < 0 or a["cols"].max(initial=0) >= n
                or a["lrow"].min(initial=0) < 0 or a["lrow"].max(initial=0) >= rb
                or a["slot_of_origrow"].max(initial=-1) >= P * rb)

    return StripeFormat(**_checked_tensors("StripeFormat", fields, STRIPE_FIELDS, want,
                                           resolve_device(device), bad, live=True), **static)


def segment_format_from_numpy(fields: dict, *, device="cuda", **static) -> SegmentFormat:
    """A SegmentFormat from the JAX ``SegmentFormat``'s arrays (``live_p``
    derived from ``vals`` unless given), checked."""
    P, C, rb = static["n_blocks"], static["block_nnz"], static["max_segments"]
    m, n = static["shape"]
    want = {"cols": (P, 1, C), "lrow": (P, 1, C), "vals": (P, 1, C), "row_of_slot": (P * rb,)}

    def bad(a):
        return (a["cols"].min(initial=0) < 0 or a["cols"].max(initial=0) >= n
                or a["lrow"].min(initial=0) < 0 or a["lrow"].max(initial=0) >= rb
                or a["row_of_slot"].max(initial=-1) >= m)

    return SegmentFormat(**_checked_tensors("SegmentFormat", fields, SEGMENT_FIELDS, want,
                                            resolve_device(device), bad, live=True), **static)


def nested_format_from_numpy(fields: dict, *, device="cuda", **static) -> NestedStripeFormat:
    """A NestedStripeFormat from the JAX ``NestedStripeFormat``'s arrays,
    checked: every warp's run lies in [0, C) in order, and every slot's row
    (its warp's base row plus its lrow) in [0, RB)."""
    P, C, W = static["n_stripes"], static["stripe_nnz"], static["n_warps"]
    rb, (m, n) = static["max_rows_per_stripe"], static["shape"]
    want = {"cols": (P, 1, C), "lrow": (P, 1, C), "vals": (P, 1, C), "wnz": (P, 1, W + 1),
            "wrow": (P, 1, W + 1), "slot_of_origrow": (m,)}

    def bad(a):
        wnz = a["wnz"].reshape(P, W + 1).astype(np.int64)
        if (a["cols"].min(initial=0) < 0 or a["cols"].max(initial=0) >= n
                or wnz.min(initial=0) < 0 or wnz.max(initial=0) > C
                or (np.diff(wnz, axis=1) < 0).any()
                or a["slot_of_origrow"].max(initial=-1) >= P * rb):
            return True
        wrow = a["wrow"].reshape(P, W + 1).astype(np.int64)
        lrow = a["lrow"].reshape(P, C).astype(np.int64)
        for p in range(P):
            w_of = np.searchsorted(wnz[p], np.arange(C), side="right") - 1
            inside = (w_of >= 0) & (w_of < W) & (np.arange(C) < wnz[p, W])
            r = wrow[p, np.clip(w_of, 0, W)] + lrow[p]
            if inside.any() and (r[inside].min() < 0 or r[inside].max() >= rb):
                return True
        return False

    return NestedStripeFormat(**_checked_tensors("NestedStripeFormat", fields, NESTED_FIELDS,
                                                 want, resolve_device(device), bad), **static)


@dataclasses.dataclass
class TileFormat:
    """Column-tiled chunk format, torch tensors on one device.

    One program = RB consecutive rows.  Its nz are ordered by (column tile,
    row), each (program, tile) segment padded to a multiple of the chunk
    size G, and every program padded to a uniform NC chunks, so all slots of
    a chunk lie in one column tile of width CT.

      cols       [P, NC, G] int32  column local to the chunk's tile (< CT)
      lrow       [P, NC, G] int32  row local to the program (< RB)
      vals       [P, NC, G] float  value (0 for padding)
      chunk_tile [P, 1, NC] int32  column-tile id per chunk (0 for padding)
      nc_p       [P, 1, 1]  int32  real chunk count per program
      slot_of_origrow [M] int32    slot per original row (-1 absent)

    ``nc_p`` is the port's own field (the packer's ``chunks_per_p``): the
    kernels walk only a program's real chunks.  Every other field equals
    the JAX ``TileFormat``'s.  ``memory_bytes`` is a property, as on every
    format of the port (on the JAX ``TileFormat`` it is a method).
    """

    cols: Any
    lrow: Any
    vals: Any
    chunk_tile: Any
    nc_p: Any
    slot_of_origrow: Any
    n_programs: int
    n_chunks: int
    chunk_g: int
    rb: int
    ct: int
    shape: tuple[int, int]
    nnz_real: int

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def padding_rate(self) -> float:
        return self.n_programs * self.n_chunks * self.chunk_g / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.cols, self.lrow, self.vals, self.chunk_tile))


TILE_FIELDS = ("cols", "lrow", "vals", "chunk_tile", "slot_of_origrow")


def pack_tile(
    ms: MetaDataSet,
    sub: int,
    *,
    out_rows: int,
    rb: int = 256,
    ct: int = 512,
    g: int = 128,
    val_dtype=np.float32,
    device="cuda",
) -> TileFormat:
    """Pack a sub-matrix into TileFormat on ``device`` (the JAX packer's
    arrays; indices are always int32, the JAX ``index_dtype`` default)."""
    dev = resolve_device(device)
    rows, cols, vals = ms.coo(sub)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    row_num = ms.row_num(sub)
    col_num = ms.col_num(sub)
    p_count = max(-(-row_num // rb), 1)
    n_tiles = max(-(-col_num // ct), 1)

    p_arr = rows // rb
    t_arr = cols // ct
    order = np.lexsort((cols, rows, t_arr, p_arr))
    rows, cols, vals = rows[order], cols[order], np.asarray(vals)[order]
    p_arr, t_arr = p_arr[order], t_arr[order]

    # (p, tile) segment sizes, padded to multiples of g
    seg_key = p_arr * n_tiles + t_arr
    seg_sizes = np.bincount(seg_key, minlength=p_count * n_tiles).reshape(p_count, n_tiles)
    seg_pad = -(-seg_sizes // g) * g
    chunks_per_p = seg_pad.sum(axis=1) // g
    nc = int(max(chunks_per_p.max(), 1))
    c_per_p = nc * g

    # destination of each nz: program base + padded segment start + rank
    seg_starts = np.cumsum(seg_pad, axis=1) - seg_pad
    nnz = rows.size
    if nnz:
        seg_first = np.concatenate(([0], np.nonzero(np.diff(seg_key))[0] + 1))
        seg_ptr = np.zeros(nnz, dtype=np.int64)
        seg_ptr[seg_first] = seg_first
        seg_ptr = np.maximum.accumulate(seg_ptr)
        rank = np.arange(nnz) - seg_ptr
        dest = p_arr * c_per_p + seg_starts[p_arr, t_arr] + rank
    else:
        dest = np.empty(0, dtype=np.int64)

    total = p_count * c_per_p
    cols_f = np.zeros(total, dtype=np.int32)
    lrow_f = np.zeros(total, dtype=np.int32)
    vals_f = np.zeros(total, dtype=val_dtype)
    cols_f[dest] = cols - t_arr * ct
    lrow_f[dest] = rows - p_arr * rb
    vals_f[dest] = vals.astype(val_dtype)

    # chunk -> tile map (padding chunks name tile 0)
    chunk_tile = np.zeros((p_count, nc), dtype=np.int32)
    for p in range(p_count):
        tiles = np.repeat(np.arange(n_tiles, dtype=np.int32), seg_pad[p] // g)
        chunk_tile[p, : tiles.size] = tiles

    # output recovery: slots are the sorted local rows, contiguous
    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        rec = ms.get(Level.ROW, "original_row_of_sorted", sub)[:row_num]
    else:
        rec = np.arange(row_num, dtype=np.int64)
    slot_of_origrow = np.full(out_rows, -1, dtype=np.int32)
    keep = rec >= 0
    slot_of_origrow[rec[keep]] = np.arange(row_num, dtype=np.int32)[keep]

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return TileFormat(
        cols=dev_t(cols_f.reshape(p_count, nc, g)),
        lrow=dev_t(lrow_f.reshape(p_count, nc, g)),
        vals=dev_t(vals_f.reshape(p_count, nc, g)),
        chunk_tile=dev_t(chunk_tile.reshape(p_count, 1, nc)),
        nc_p=dev_t(chunks_per_p.astype(np.int32).reshape(p_count, 1, 1)),
        slot_of_origrow=dev_t(slot_of_origrow),
        n_programs=p_count,
        n_chunks=nc,
        chunk_g=g,
        rb=rb,
        ct=ct,
        shape=(out_rows, col_num),
        nnz_real=int(np.count_nonzero(vals)),
    )


def live_chunk_counts(vals: np.ndarray) -> np.ndarray:
    """[P, 1, 1] int32: per program, one past its last chunk holding a
    nonzero value (the chunks a kernel must walk) — for formats that come
    without their packer's chunk counts."""
    P, NC, _ = vals.shape
    live = (vals != 0).any(axis=2)
    last = np.where(live.any(axis=1), NC - np.argmax(live[:, ::-1], axis=1), 0)
    return last.astype(np.int32).reshape(P, 1, 1)


def tile_format_from_numpy(fields: dict, *, device="cuda", **static) -> TileFormat:
    """A TileFormat from numpy arrays — the JAX ``TileFormat``'s ``cols``,
    ``lrow``, ``vals``, ``chunk_tile`` and ``slot_of_origrow`` (``nc_p`` is
    derived from ``vals`` unless given) — plus its static fields
    (``n_programs``, ``n_chunks``, ``chunk_g``, ``rb``, ``ct``, ``shape``,
    ``nnz_real``).  The arrays come from outside this package, so their
    shapes and index ranges are checked here: the kernels read X and write
    Y at these indices without bounds checks."""
    dev = resolve_device(device)
    arrs = {k: np.asarray(fields[k]) for k in TILE_FIELDS}
    P, NC, G = static["n_programs"], static["n_chunks"], static["chunk_g"]
    rb, ct, (m, n) = static["rb"], static["ct"], static["shape"]
    arrs["nc_p"] = (np.asarray(fields["nc_p"]) if fields.get("nc_p") is not None
                    else live_chunk_counts(arrs["vals"]))
    want = {"cols": (P, NC, G), "lrow": (P, NC, G), "vals": (P, NC, G),
            "chunk_tile": (P, 1, NC), "nc_p": (P, 1, 1), "slot_of_origrow": (m,)}
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"TileFormat.{k}: shape {arrs[k].shape}, want {shp}")
    live = arrs["vals"] != 0
    col = arrs["chunk_tile"].reshape(P, NC, 1).astype(np.int64) * ct + arrs["cols"]
    if (live.any() and (col[live].min() < 0 or col[live].max() >= n)) or \
            arrs["cols"].min(initial=0) < 0 or arrs["cols"].max(initial=0) >= ct or \
            arrs["lrow"].min(initial=0) < 0 or arrs["lrow"].max(initial=0) >= rb or \
            arrs["nc_p"].min(initial=0) < 0 or arrs["nc_p"].max(initial=0) > NC or \
            arrs["slot_of_origrow"].max(initial=-1) >= P * rb:
        raise ValueError("TileFormat indices out of range")
    dtypes = {"vals": torch.float32}
    tensors = {k: torch.tensor(a, dtype=dtypes.get(k, torch.int32), device=dev)
               for k, a in arrs.items()}
    return TileFormat(**tensors, **static)
