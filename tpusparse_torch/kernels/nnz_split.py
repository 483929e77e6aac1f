"""nnz_split — nnz-direction SpMM with a segment combine (counterpart of
``tpusparse/kernels/nnz_split.py``).

The reference's bit-map / segment reduction family: blocks own equal nnz
ranges regardless of row boundaries (a single long row splits across
blocks), and rows that straddle blocks are resolved by adding the
per-(block, row) partial sums.  Two paths, as in the JAX package:

  segment_spmm       the stripe kernel (``stripe_rows_cuda``) on a
                     SegmentFormat, lrow the segment id in the block, then the
                     combine: an ``index_add_`` of the segment slots into Y
                     (XLA's scatter-add in the JAX package, outside any
                     kernel)
  segment_span_spmm  the span kernel (``span_rows_cuda``) on a
                     SegmentSpanFormat: column-sorted chunks within each nnz
                     block, then the same combine
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpusparse_torch import native
from tpusparse_torch.format import SegmentFormat, live_chunk_counts
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import (cdiv, lex_order, pad_dense_cols, prep_x,
                                            resolve_device, round_up, to_device)
from tpusparse_torch.kernels.row_walk import RowWalk
from tpusparse_torch.kernels.span_gather import span_row_walk, span_rows_cuda, span_rows_plain
from tpusparse_torch.kernels.stripe_gather import (prep_stripe_x, stripe_rows_cuda,
                                                   stripe_rows_plain)
from tpusparse_torch.kernels.tile_onehot import PRECISIONS, choose_kt, default_ktile


def combine_segments(slots: torch.Tensor, row_of_slot: torch.Tensor, m: int) -> torch.Tensor:
    """Y [m, K]: each segment slot's partial sum added into its row
    (``row_of_slot``; -1 slots are dropped)."""
    row = row_of_slot.long()
    row = torch.where(row < 0, torch.full_like(row, m), row)  # a dropped extra row
    y = torch.zeros((m + 1, slots.shape[1]), dtype=slots.dtype, device=slots.device)
    return y.index_add_(0, row, slots)[:m]


def segment_spmm(fmt: SegmentFormat, x, *, ktile: int | None = None,
                 unroll: int = 8) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in SegmentFormat (tpusparse/kernels/nnz_split.py:37)."""
    m, n_cols = fmt.shape
    x, kt, k = prep_stripe_x(x, fmt.device, ktile)
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    if fmt.device.type == "cuda":
        slots = stripe_rows_cuda(fmt.cols, fmt.lrow, fmt.vals, x, rb=fmt.max_segments, kt=kt,
                                 live=fmt.live_p)
    else:
        slots = stripe_rows_plain(fmt.cols, fmt.lrow, fmt.vals, x, rb=fmt.max_segments)
    return combine_segments(slots, fmt.row_of_slot, m)[:, :k]


@dataclasses.dataclass
class SegmentSpanFormat:
    """Equal-nnz blocks, span-chunked within each block, torch tensors on one
    device (P blocks, NC chunks per block, G slots per chunk):

      c0    [P, 1, NC] int32  window start column (multiple of 8)
      cols  [P, NC, G] int32  column offset within the window (< CT)
      lrow  [P, NC, G] int32  segment id in the block (< RB)
      vals  [P, NC, G] f32
      nc_p  [P, 1, 1]  int32  real chunk count per block
      row_of_slot [P * RB] int32  matrix row of each (block, segment) slot

    ``nc_p`` and ``walk`` (the row walk, ``span_row_walk``) are the port's
    own fields, as on SpanFormat; every other field equals the JAX
    ``SegmentSpanFormat``'s.
    """

    c0: Any
    cols: Any
    lrow: Any
    vals: Any
    nc_p: Any
    row_of_slot: Any
    n_blocks: int
    n_chunks: int
    chunk_g: int
    rb: int
    ct: int
    shape: tuple[int, int]
    nnz_real: int
    walk: RowWalk | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.c0.device

    @property
    def padding_rate(self) -> float:
        return self.n_blocks * self.n_chunks * self.chunk_g / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.c0, self.cols, self.lrow, self.vals, self.row_of_slot))


def segment_span_format_from_numpy(fields: dict, *, device="cuda", **static) -> SegmentSpanFormat:
    """A SegmentSpanFormat from the JAX ``SegmentSpanFormat``'s arrays
    (``c0``, ``cols``, ``lrow``, ``vals``, ``row_of_slot``; ``nc_p`` derived
    from ``vals`` unless given) and static fields (``n_blocks``,
    ``n_chunks``, ``chunk_g``, ``rb``, ``ct``, ``shape``, ``nnz_real``);
    shapes and index ranges are checked, since the kernel reads X and
    writes the slots at these indices without bounds checks."""
    dev = resolve_device(device)
    names = ("c0", "cols", "lrow", "vals", "row_of_slot")
    arrs = {k: np.asarray(fields[k]) for k in names}
    vals = arrs["vals"].astype(np.float32)
    P, NC, G = static["n_blocks"], static["n_chunks"], static["chunk_g"]
    rb, ct, (m, n) = static["rb"], static["ct"], static["shape"]
    arrs["nc_p"] = (np.asarray(fields["nc_p"]) if fields.get("nc_p") is not None
                    else live_chunk_counts(vals))
    want = {"c0": (P, 1, NC), "cols": (P, NC, G), "lrow": (P, NC, G), "vals": (P, NC, G),
            "nc_p": (P, 1, 1), "row_of_slot": (P * rb,)}
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"SegmentSpanFormat.{k}: shape {arrs[k].shape}, want {shp}")
    live = vals != 0
    col = arrs["c0"].reshape(P, NC, 1).astype(np.int64) + arrs["cols"]
    if (live.any() and (col[live].min() < 0 or col[live].max() >= n)) or \
            arrs["cols"].min(initial=0) < 0 or arrs["cols"].max(initial=0) >= ct or \
            arrs["lrow"].min(initial=0) < 0 or arrs["lrow"].max(initial=0) >= rb or \
            arrs["nc_p"].min(initial=0) < 0 or arrs["nc_p"].max(initial=0) > NC or \
            arrs["row_of_slot"].max(initial=-1) >= m:
        raise ValueError("SegmentSpanFormat indices out of range")
    arrs["vals"] = vals
    return SegmentSpanFormat(**{k: to_device(dev, a, torch.float32 if k == "vals" else torch.int32)
                                for k, a in arrs.items()}, **static)


def pack_segment_span(mat: CooMatrix, *, block_nnz: int = 4096, ct: int = 512, g: int = 256,
                      device="cuda") -> SegmentSpanFormat:
    """Cut the row-major nonzeros into equal ``block_nnz`` blocks (rows may
    straddle), then span-chunk each block by column
    (tpusparse/kernels/nnz_split.py:111)."""
    dev = resolve_device(device)
    m, n = mat.shape
    rows = np.asarray(mat.rows, dtype=np.int64)
    cols = np.asarray(mat.cols, dtype=np.int64)
    vals = np.asarray(mat.vals, dtype=np.float32)
    nnz = rows.size
    b = max(block_nnz, 1)
    p_count = max(-(-max(nnz, 1) // b), 1)

    blk = np.minimum(np.arange(nnz) // b, p_count - 1) if nnz else np.empty(0, np.int64)
    # segment id = the row's rank within the block, not its offset: a block
    # spanning a gap of empty rows would otherwise make rb (and the P*rb*K
    # slot output) arbitrarily large
    max_seg = 1
    seg = np.zeros(nnz, dtype=np.int64)
    rows_of_block: list[np.ndarray] = [np.empty(0, np.int64)] * p_count
    for p in range(p_count):
        lo, hi = p * b, min((p + 1) * b, nnz)
        if lo >= hi:
            continue
        u, inv = np.unique(rows[lo:hi], return_inverse=True)
        seg[lo:hi] = inv
        rows_of_block[p] = u
        max_seg = max(max_seg, u.size)
    rb = round_up(max_seg, 8)

    order = lex_order(cols, blk)
    starts = np.searchsorted(blk[order], np.arange(p_count + 1))
    c0_2d, cols_f, lrow_f, vals_f, nc_arr = native.span_pack(
        cols[order], seg[order], vals[order], starts, g, ct - 8)

    row_of_slot = np.full(p_count * rb, -1, dtype=np.int32)
    for p in range(p_count):
        u = rows_of_block[p]
        row_of_slot[p * rb: p * rb + u.size] = u

    return SegmentSpanFormat(
        c0=to_device(dev, c0_2d[:, None, :]),
        cols=to_device(dev, cols_f),
        lrow=to_device(dev, lrow_f),
        vals=to_device(dev, vals_f, torch.float32),
        nc_p=to_device(dev, nc_arr.astype(np.int32).reshape(p_count, 1, 1)),
        row_of_slot=to_device(dev, row_of_slot),
        n_blocks=p_count,
        n_chunks=c0_2d.shape[1],
        chunk_g=g,
        rb=rb,
        ct=ct,
        shape=(m, n),
        nnz_real=int(np.count_nonzero(vals_f)),
    )


def segment_span_spmm(fmt: SegmentSpanFormat, x, *, ktile: int | None = None,
                      precision: str = "fp32x2", unroll: int = 4) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in SegmentSpanFormat: the span kernel on
    the blocks' chunks, then the segment combine
    (tpusparse/kernels/nnz_split.py:190).  ``unroll`` changes nothing here."""
    assert precision in PRECISIONS, precision
    x = prep_x(x, fmt.device)
    m, n_cols = fmt.shape
    k = x.shape[1]
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    kt = choose_kt(min(ktile or default_ktile(k), 32))
    x = pad_dense_cols(x, cdiv(k, kt) * kt).contiguous()
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, x)
    if fmt.device.type == "cuda":
        slots = span_rows_cuda(*args, rb=fmt.rb, kt=kt, mode=precision,
                               walk=span_row_walk(fmt), k=k)
    else:
        slots = span_rows_plain(*args, rb=fmt.rb, kt=kt, mode=precision)
    return combine_segments(slots, fmt.row_of_slot, m)[:, :k]
