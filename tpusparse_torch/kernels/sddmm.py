"""sddmm — the value and input gradients of a span-format SpMM with
trainable values (counterpart of ``tpusparse/kernels/sddmm.py``).

For ``Y = A(v) @ X`` with a FIXED sparsity pattern and trainable values v
(pruned-weight fine-tuning):

  dv[nz=(r,c)] = sum_k dY[r,k] * X[c,k]          (SDDMM, sampled at A)
  dX[c,k]      = sum_{nz=(r,c)} v[nz] * dY[r,k]  (A^T @ dY, same layout)

Both run on the span format of ``pack_span(keep_perm=True)``, so the value
parameter is the packed [P, NC, G] plane itself: no repacking per step and
no transposed format.  dY enters in slot order (``dy_slots`` [P*RB, K]:
row p*rb + lrow of a slot is its row of Y), gathered once per backward
through ``origrow_of_slot``.  Padding slots of ``span_sddmm`` get what
their aliased indices compute; the caller masks with ``occupancy_mask``.

Kernels (CUDA C++, ``tpusparse_torch/csrc/sddmm.cu``), each beside its
plain PyTorch version of the same function:

  sddmm_rows_cuda / sddmm_rows_plain  replace ``_sddmm_kernel``
  dx_rows_cuda    / dx_rows_plain     replace ``_dx_kernel``

``sddmm_rows_cuda`` samples through the pattern's tile index
(``sddmm_tiles``, kept on the format as ``fmt.tiles``): the (dY_slots row,
X column) space cut into tiles of ``TILE_ROWS`` x ``TILE_COLS``, every
walked slot listed by tile, the tiles that hold the most slots first.  A
tile holding at least ``TILE_MIN_SLOTS[mode]`` slots is computed whole on
the tensor cores from operand panels staged in shared memory, and its
slots read their entries; the slots of sparser tiles take one dot product
each (``sddmm_tiles_plain`` is the same function in plain PyTorch, tile
by tile).  ``dx_rows_cuda`` walks the pattern's column index (``dx_index``,
kept on the format as ``fmt.dx_index``): the walked slots by tile of
``DX_TILE_COLS`` columns of A, by window of ``DX_WIN_ROWS`` rows of
dY_slots, by column; each group of lanes keeps its columns' sums in
registers, the dY rows of a window holding at least ``stage_min`` slots
staged in shared memory, the others read from L2 (``dx_index_plain`` is
the same function in plain PyTorch, walked from the index).  A wrapper
launches its kernel for CUDA tensors and raises on any failure; only CPU
tensors take the plain version.  The TPU's bf16
hi/lo packing and its one-hot gathers are not ported: fp32 and fp32x2
compute in fp32's class (3xTF32 in the tile kernel), bf16 rounds where the
TPU kernels' bf16 operands did (csrc/sddmm.cu).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, kernel_info, launch_checked,
                                            pad_dense_cols, prep_x)
from tpusparse_torch.kernels.row_walk import version_of
from tpusparse_torch.kernels.span_gather import (SpanFormat, pack_span, slot_rows_cols,
                                                 with_values)
from tpusparse_torch.kernels.tile_onehot import PRECISIONS, choose_kt, default_ktile

#: the tile kernel's tile: rows of dY_slots by columns of X (csrc/sddmm.cu)
TILE_ROWS, TILE_COLS = 128, 64
#: by mode, the fewest slots a tile holds that the tile kernel computes
#: whole; a sparser tile's slots take one dot product each.  Where the
#: two paths cost the same at the trainable 4096^2 layer, K = 512 (a tile
#: of the 3xTF32 kernel as much as 580 per-slot dots, of the bf16 one
#: 310; measured on the card, PERF.md)
TILE_MIN_SLOTS = {"fp32": 576, "fp32x2": 576, "bf16": 320}
#: the transpose apply's column walk (csrc/sddmm.cu, dx_walk_kernel): tiles
#: of DX_TILE_COLS columns of A (rows of dX), windows of DX_WIN_ROWS rows of
#: dY_slots, a staged window cut into pieces of at most DX_PIECE_SLOTS slots,
#: a piece's column offsets padded to DX_OFF_LD int32
DX_TILE_COLS, DX_WIN_ROWS, DX_PIECE_SLOTS = 128, 64, 2048
DX_OFF_LD = DX_TILE_COLS + 4
# A tile's columns are dealt by falling slot count to 16 groups of 8 in a
# snake, and a group's 8 take the snake's rounds in the order 0, 7, 1, 6,
# 2, 5, 3, 4: every aligned 1, 2, 4 or 8 of them (the kernel's groups at
# each panel width) then carries about as many slots as the next.
_DEAL_GROUPS, _DEAL_DEPTH = 16, 8
_ROUND_AT = (0, 2, 4, 6, 7, 5, 3, 1)  # the position of round k within its group


# ------------------------------------------------------------------ host helpers

def occupancy_mask(fmt: SpanFormat) -> np.ndarray:
    """[P, NC, G] float32 1.0 where a real nz lives (0 = padding slot).
    Built from the packing permutation, NOT from vals != 0: a stored zero
    value is still a real (trainable) position."""
    assert fmt.perm_of_nz is not None, "pack_span(..., keep_perm=True) required"
    ones = np.ones(len(fmt.perm_of_nz), dtype=np.float32)
    return with_values(fmt, ones).vals.float().cpu().numpy()


def origrow_of_slot(fmt: SpanFormat) -> np.ndarray:
    """[P*RB] int32 inverse of slot_of_origrow; slots without a row hold M
    (one past the last row, where the gather reads a zero row)."""
    m = fmt.shape[0]
    slot = fmt.slot_of_origrow.cpu().numpy()
    inv = np.full(fmt.n_programs * fmt.rb, m, dtype=np.int32)
    valid = slot >= 0
    inv[slot[valid]] = np.arange(m, dtype=np.int32)[valid]
    return inv


def rows_to_slots(y: torch.Tensor, inv_slot: torch.Tensor) -> torch.Tensor:
    """[P*RB, K] rows of ``y`` [M, K] in slot order (``inv_slot`` from
    ``origrow_of_slot``, as a long tensor on y's device); M reads zeros."""
    y = y.to(torch.float32)
    padded = torch.cat([y, y.new_zeros((1,) + tuple(y.shape[1:]))])
    return padded.index_select(0, inv_slot).contiguous()


def packed_to_nz(fmt: SpanFormat, packed) -> torch.Tensor:
    """Export: the packed [P, NC, G] plane as values in the nonzero order
    given to pack_span (for checkpointing back to COO), an fp32 tensor on
    the plane's device (the CPU for a numpy plane)."""
    assert fmt.perm_of_nz is not None, "pack_span(..., keep_perm=True) required"
    if not isinstance(packed, torch.Tensor):
        packed = torch.from_numpy(np.array(packed, dtype=np.float32))
    flat = packed.to(torch.float32).reshape(-1)
    return flat[torch.as_tensor(fmt.perm_of_nz, dtype=torch.long, device=flat.device)]


# ------------------------------------------------------------------ tile index

def _built_from(index, pattern) -> bool:
    """Whether ``index`` (its ``pattern`` and ``versions``) was derived from
    the index planes ``pattern`` as they stand."""
    return (len(pattern) == len(index.pattern)
            and all(a is b for a, b in zip(pattern, index.pattern))
            and tuple(map(version_of, pattern)) == index.versions)


@dataclasses.dataclass(frozen=True)
class SddmmTiles:
    """Every walked slot of a span pattern (a chunk before ``nc_p``, a
    column of X) listed by tile of ``TILE_ROWS`` dY_slots rows x
    ``TILE_COLS`` X columns, on the format's device:

      row   [S] int32  the slot's row of dY_slots (p * rb + lrow)
      col   [S] int32  its column c0 + cols, a row of X
      slot  [S] int32  its flat index in the [P, NC, G] plane
      tiles [H, 4] int32  each tile that holds a slot: first row, first
                          column and the range [start, end) of its slots
                          in the lists

    The tiles run from the one that holds the most slots down (by position
    where they hold as many), each tile's slots together and rising, so the
    tiles dense at any threshold are a prefix of ``tiles`` and their slots
    a prefix of the lists (``dense``).  ``counts`` (numpy, host) is each
    tile's slot count.  ``pattern`` (the index planes it was derived from)
    and ``versions`` (their version counters then) tie it to the planes as
    they stood; ``n_rows`` (P * rb), ``n_cols`` (X's rows) and
    ``plane_slots`` (P * NC * G) to its format."""

    row: Any
    col: Any
    slot: Any
    tiles: Any
    counts: Any
    pattern: tuple
    versions: tuple
    n_rows: int
    n_cols: int
    plane_slots: int
    build_seconds: float

    @property
    def n_slots(self) -> int:
        return self.row.numel()

    @property
    def n_hit_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def nbytes(self) -> int:
        return 12 * self.n_slots + 16 * self.n_hit_tiles

    def dense(self, min_slots: int) -> tuple[int, int]:
        """(T, D): the T tiles that hold at least ``min_slots`` slots, the
        first T of ``tiles``, and their D slots, the first D of the lists."""
        t = int(np.searchsorted(-self.counts, -min_slots, side="right"))
        return t, int(self.counts[:t].sum())

    def built_from(self, pattern) -> bool:
        """Whether the index was derived from the index planes ``pattern``
        as they stand: the same tensors, not written since."""
        return _built_from(self, pattern)


def build_sddmm_tiles(c0, cols, lrow, nc_p, *, rb, n) -> SddmmTiles:
    """The tile index of span planes for X of ``n`` rows, derived on their
    device with torch ops."""
    t0 = time.perf_counter()
    P, NC, G = cols.shape
    if P * NC * G >= 2 ** 31:
        raise ValueError(f"{P * NC * G} slots: the tile index lists them with int32")
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    idx = torch.nonzero(walked & (col < n)).reshape(-1)            # rising slots
    row, col = row[idx], col[idx]
    n_tc = cdiv(n, TILE_COLS)
    key, order = torch.sort((row // TILE_ROWS) * n_tc + col // TILE_COLS, stable=True)
    keys, counts = torch.unique_consecutive(key, return_counts=True)
    # the tiles by falling count, each tile's slots together and rising
    by_count = torch.sort(counts, descending=True, stable=True)[1]
    rank = torch.empty_like(by_count)
    rank[by_count] = torch.arange(len(by_count), device=by_count.device)
    order = order[torch.sort(rank.repeat_interleave(counts), stable=True)[1]]
    idx, row, col = idx[order], row[order], col[order]
    keys, counts = keys[by_count], counts[by_count]
    ends = torch.cumsum(counts, 0)
    tiles = torch.stack([(keys // n_tc) * TILE_ROWS, (keys % n_tc) * TILE_COLS, ends - counts,
                         ends], dim=1).to(torch.int32).contiguous()
    pattern = (c0, cols, lrow, nc_p)
    index = SddmmTiles(row=row.to(torch.int32).contiguous(), col=col.to(torch.int32).contiguous(),
                       slot=idx.to(torch.int32).contiguous(), tiles=tiles,
                       counts=counts.cpu().numpy(), pattern=pattern,
                       versions=tuple(map(version_of, pattern)), n_rows=P * rb, n_cols=n,
                       plane_slots=P * NC * G, build_seconds=0.0)
    return dataclasses.replace(index, build_seconds=time.perf_counter() - t0)


def sddmm_tiles(fmt: SpanFormat) -> SddmmTiles:
    """The format's tile index, built at first use and kept on the format
    (``fmt.tiles``); built anew where an index plane was replaced or
    written in place since (dv reads no values: they change nothing)."""
    pattern = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    if fmt.tiles is None or not fmt.tiles.built_from(pattern):
        fmt.tiles = build_sddmm_tiles(*pattern, rb=fmt.rb, n=fmt.shape[1])
    return fmt.tiles


# ------------------------------------------------------------- column index

def _run_starts(keys: torch.Tensor) -> torch.Tensor:
    """For sorted ``keys``, the index of the first element of each one's run."""
    _, counts = torch.unique_consecutive(keys, return_counts=True)
    return torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)


def _ranges(starts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The indices of the ranges [starts, starts + counts), one after another."""
    total = int(counts.sum())
    first = torch.cumsum(counts, 0) - counts
    return (torch.repeat_interleave(starts - first, counts)
            + torch.arange(total, device=counts.device))


@dataclasses.dataclass(frozen=True)
class DxIndex:
    """Every walked slot of a span pattern (a chunk before ``nc_p``, a
    column of A below ``n_cols``) listed once for the transpose apply's
    column walk, on the format's device.  Tile t holds columns [t * C, t * C
    + C) of A, C = ``DX_TILE_COLS``; its columns are dealt to positions by
    falling slot count (``colpos`` [T, C] int32: the column at each
    position).  Window w holds rows [w * D, w * D + D) of dY_slots, D =
    ``DX_WIN_ROWS``.  A (tile, window) holding at least ``stage_min`` slots
    is staged, cut into pieces of at most ``DX_PIECE_SLOTS`` slots (in
    (row, slot) order); the other slots of a tile are its sparse ones.
    The lists, tile by tile, hold the tile's sparse slots, then its pieces
    by window; each by position, then row:

      row   [S] int32  the slot's row of dY_slots (in a piece: within its
                       window)
      slot  [S] int32  its flat index in the [P, NC, G] plane
      uoff  [T, C + 1] int32  position p's sparse slots [uoff[t, p],
                       uoff[t, p + 1]) of the lists
      tile_pieces [T + 1] int32  tile t's pieces [tile_pieces[t],
                       tile_pieces[t + 1])
      pieces [H, 4] int32  a piece's first row of dY_slots, its slots
                       [start, end) of the lists, 0
      piece_off [H, DX_OFF_LD] int32  position p's slots [off[p], off[p +
                       1]) of the piece's, from its start (C + 1 used)

    ``pattern`` (the index planes it was derived from) and ``versions``
    (their version counters then) tie it to the planes as they stood;
    ``n_rows`` (P * rb), ``n_cols`` (A's columns) and ``plane_slots`` (P *
    NC * G) to its format; ``n_staged`` counts the pieces' slots.  It holds
    no value: the kernel reads the caller's value plane at each launch."""

    row: Any
    slot: Any
    uoff: Any
    tile_pieces: Any
    pieces: Any
    piece_off: Any
    colpos: Any
    n_staged: int
    pattern: tuple
    versions: tuple
    n_rows: int
    n_cols: int
    plane_slots: int
    build_seconds: float

    @property
    def n_slots(self) -> int:
        return self.row.numel()

    @property
    def n_tiles(self) -> int:
        return self.colpos.shape[0]

    @property
    def n_pieces(self) -> int:
        return self.pieces.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.row, self.slot, self.uoff, self.tile_pieces, self.pieces, self.piece_off,
            self.colpos))

    def built_from(self, pattern) -> bool:
        """Whether the index was derived from the index planes ``pattern``
        as they stand: the same tensors, not written since."""
        return _built_from(self, pattern)

    def entries(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Each listed slot's column of A and row of dY_slots (long [S]),
        walked from the index as the kernel walks it: the sparse ranges of
        each tile's positions, then its pieces' ranges.  Raises unless the
        ranges cover the lists exactly once."""
        c, dev = DX_TILE_COLS, self.row.device
        col = torch.full((self.n_slots,), -1, dtype=torch.long, device=dev)
        row = self.row.long().clone()
        uoff, colpos = self.uoff.long(), self.colpos.long()
        cnt = (uoff[:, 1:] - uoff[:, :-1]).reshape(-1)
        at_u = _ranges(uoff[:, :-1].reshape(-1), cnt)
        tp = torch.repeat_interleave(torch.arange(self.n_tiles * c, device=dev), cnt)
        col[at_u] = tp // c * c + colpos.reshape(-1)[tp]
        off = self.piece_off[:, :c + 1].long()
        cnt = (off[:, 1:] - off[:, :-1]).reshape(-1)
        at_p = _ranges((self.pieces[:, 1:2].long() + off[:, :-1]).reshape(-1), cnt)
        hp = torch.repeat_interleave(torch.arange(self.n_pieces * c, device=dev), cnt)
        h, pos = hp // c, hp % c
        tile_of = torch.repeat_interleave(torch.arange(self.n_tiles, device=dev),
                                          torch.diff(self.tile_pieces.long()))
        col[at_p] = tile_of[h] * c + colpos[tile_of[h], pos]
        row[at_p] += self.pieces[h, 0].long()
        hits = torch.bincount(torch.cat([at_u, at_p]), minlength=self.n_slots)
        if hits.numel() != self.n_slots or not bool((hits == 1).all()):
            raise ValueError("the column index's ranges do not cover its lists exactly once")
        return col, row


def build_dx_index(c0, cols, lrow, nc_p, *, rb, n, stage_min=DX_WIN_ROWS) -> DxIndex:
    """The column index of span planes for A of ``n`` columns, derived on
    their device with torch ops; a window holding at least ``stage_min``
    slots is staged."""
    t0 = time.perf_counter()
    P, NC, G = cols.shape
    if P * NC * G >= 2 ** 31:
        raise ValueError(f"{P * NC * G} slots: the column index lists them with int32")
    c, d, dev = DX_TILE_COLS, DX_WIN_ROWS, cols.device
    n_rows = P * rb
    n_tiles, n_win = cdiv(n, c), cdiv(n_rows, d)
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    idx = torch.nonzero(walked & (col < n)).reshape(-1)            # rising slots
    row, col = row[idx], col[idx]
    tile, win = col // c, row // d
    # each tile's columns by falling slot count, dealt to positions
    by_count = torch.sort(torch.bincount(col, minlength=n_tiles * c).view(n_tiles, c), dim=1,
                          descending=True, stable=True)[1]
    rank = torch.arange(c, device=dev)
    rnd, i = rank // _DEAL_GROUPS, rank % _DEAL_GROUPS
    group = torch.where(rnd % 2 == 0, i, _DEAL_GROUPS - 1 - i)
    pos_of_rank = (group * _DEAL_DEPTH
                   + torch.as_tensor(_ROUND_AT, device=dev)[rnd]).expand(n_tiles, c)
    colpos = torch.empty_like(by_count).scatter_(1, pos_of_rank, by_count)
    pos = torch.empty_like(by_count).scatter_(1, by_count, pos_of_rank)[tile, col % c]
    # the staged windows, cut into pieces by their slots' order (row, slot):
    # a row may hold many slots of one column (a chunk's padding)
    tw = tile * n_win + win
    _, inv, per_win = torch.unique(tw, return_inverse=True, return_counts=True)
    staged = per_win[inv] >= stage_min
    piece = torch.zeros_like(row)
    at = torch.nonzero(staged).reshape(-1)
    if at.numel():
        at = at[torch.sort(tile[at] * n_rows + row[at], stable=True)[1]]
        rank = torch.arange(at.numel(), device=dev) - _run_starts(tw[at])
        piece[at] = rank // DX_PIECE_SLOTS
    max_pieces = cdiv(int(per_win.max()), DX_PIECE_SLOTS) if per_win.numel() else 1
    # the lists: tile, then its sparse slots before its pieces; position, row
    span_t = n_win * max_pieces + 1
    major = tile * span_t + torch.where(staged, 1 + win * max_pieces + piece, 0)
    order = torch.sort(pos * n_rows + row, stable=True)[1]
    order = order[torch.sort(major[order], stable=True)[1]]
    idx, row, tile, pos, win = idx[order], row[order], tile[order], pos[order], win[order]
    staged, major = staged[order], major[order]
    # the pieces: runs of a staged part of a tile
    at = torch.nonzero(staged).reshape(-1)
    keys, per_piece = torch.unique_consecutive(major[at], return_counts=True)
    start = at[torch.cumsum(per_piece, 0) - per_piece]
    n_pieces = keys.numel()
    pieces = torch.stack([((keys % span_t) - 1) // max_pieces * d, start, start + per_piece,
                          torch.zeros_like(start)], dim=1).to(torch.int32).contiguous()
    piece_of = torch.repeat_interleave(torch.arange(n_pieces, device=dev), per_piece)
    per_pos = torch.bincount(piece_of * c + pos[at], minlength=n_pieces * c).view(n_pieces, c)
    piece_off = torch.zeros((n_pieces, DX_OFF_LD), dtype=torch.int32, device=dev)
    piece_off[:, 1:c + 1] = torch.cumsum(per_pos, 1)
    tile_pieces = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    tile_pieces[1:] = torch.cumsum(torch.bincount(keys // span_t, minlength=n_tiles), 0)
    # each tile's sparse slots by position, from the tile's start in the lists
    sparse = ~staged
    per_tile = torch.bincount(tile, minlength=n_tiles)
    first = (torch.cumsum(per_tile, 0) - per_tile).view(-1, 1)
    per_pos = torch.bincount(tile[sparse] * c + pos[sparse], minlength=n_tiles * c)
    uoff = torch.cat([first, first + torch.cumsum(per_pos.view(n_tiles, c), 1)], dim=1)
    pattern = (c0, cols, lrow, nc_p)
    return DxIndex(row=torch.where(staged, row - win * d, row).to(torch.int32).contiguous(),
                   slot=idx.to(torch.int32).contiguous(),
                   uoff=uoff.to(torch.int32).contiguous(), tile_pieces=tile_pieces,
                   pieces=pieces, piece_off=piece_off, colpos=colpos.to(torch.int32).contiguous(),
                   n_staged=at.numel(), pattern=pattern,
                   versions=tuple(map(version_of, pattern)), n_rows=n_rows, n_cols=n,
                   plane_slots=P * NC * G, build_seconds=time.perf_counter() - t0)


def dx_index(fmt: SpanFormat) -> DxIndex:
    """The format's column index, built at first use and kept on the format
    (``fmt.dx_index``); built anew where an index plane was replaced or
    written in place since (the values change nothing: the kernel reads
    them at each launch)."""
    pattern = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    if fmt.dx_index is None or not fmt.dx_index.built_from(pattern):
        fmt.dx_index = build_dx_index(*pattern, rb=fmt.rb, n=fmt.shape[1])
    return fmt.dx_index


# --------------------------------------------------------------- plain versions

def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def sddmm_rows_plain(c0, cols, lrow, nc_p, dy_slots, x, *, rb, kt, mode):
    """Plain PyTorch ``_sddmm_kernel``: dv [P, NC, G] with ``dv = sum_k
    dY_slots[p*rb + lrow, k] * X[c0 + cols, k]`` at every slot of a chunk
    before ``nc_p`` (0 past it, and at a column past X); bf16 rounds X and
    dY before the products.  ``kt`` changes nothing."""
    P, NC, G = cols.shape
    n = x.shape[0]
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    live = walked & (col < n)
    gx = x.index_select(0, col[live])
    gd = dy_slots.index_select(0, row[live])
    if mode == "bf16":
        gx, gd = _bf16(gx), _bf16(gd)
    dv = torch.zeros(P * NC * G, dtype=torch.float32, device=x.device)
    dv[live] = (gx * gd).sum(dim=1)
    return dv.reshape(P, NC, G)


def sddmm_tiles_plain(tiles: SddmmTiles, dy_slots, x, *, mode, min_slots=None) -> torch.Tensor:
    """The tile kernel's function in plain PyTorch, tile by tile: dv [P *
    NC * G] (flat; 0 off the index) with the product of each tile that
    holds at least ``min_slots`` slots (default ``TILE_MIN_SLOTS[mode]``)
    computed whole from its dY_slots and X rows and sampled at its slots,
    and each other slot's dot product; bf16 rounds X and dY before the
    products."""
    n_dense, d = tiles.dense(TILE_MIN_SLOTS[mode] if min_slots is None else min_slots)
    if mode == "bf16":
        dy_slots, x = _bf16(dy_slots), _bf16(x)
    dv = torch.zeros(tiles.plane_slots, dtype=torch.float32, device=x.device)
    row, col, slot = tiles.row.long(), tiles.col.long(), tiles.slot.long()
    if n_dense:
        t = tiles.tiles[:n_dense].long()
        # a zero row past dY's and X's last, for the rows a tile runs past
        dyz = torch.cat([dy_slots, dy_slots.new_zeros((1, dy_slots.shape[1]))])
        xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        rr = (t[:, :1] + torch.arange(TILE_ROWS, device=t.device)).clamp(max=dy_slots.shape[0])
        cc = (t[:, 1:2] + torch.arange(TILE_COLS, device=t.device)).clamp(max=x.shape[0])
        prod = torch.bmm(dyz[rr], xz[cc].transpose(1, 2))          # [T, rows, cols]
        tile_of = torch.repeat_interleave(torch.arange(len(t), device=t.device), t[:, 3] - t[:, 2])
        dv[slot[:d]] = prod[tile_of, row[:d] - t[tile_of, 0], col[:d] - t[tile_of, 1]]
    dv[slot[d:]] = (dy_slots[row[d:]] * x[col[d:]]).sum(dim=1)
    return dv


def dx_rows_plain(c0, cols, lrow, vals, nc_p, dy_slots, *, n, rb, kt, mode):
    """Plain PyTorch ``_dx_kernel``: dX [n, Kp] with ``dX[c0 + cols] +=
    vals * dY_slots[p*rb + lrow]`` over the slots whose value is not zero in
    a chunk before ``nc_p``, as an ``index_add_``; bf16 rounds dY and then
    each product.  ``kt`` changes nothing."""
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    v = vals.reshape(-1).float()
    live = walked & (v != 0) & (col < n)
    gd = dy_slots.index_select(0, row[live])
    if mode == "bf16":
        prod = _bf16(v[live].view(-1, 1) * _bf16(gd))
    else:
        prod = v[live].view(-1, 1) * gd
    dx = torch.zeros((n, dy_slots.shape[1]), dtype=torch.float32, device=dy_slots.device)
    return dx.index_add_(0, col[live], prod)


def dx_index_plain(index: DxIndex, vals, dy_slots, *, mode) -> torch.Tensor:
    """The column walk's function in plain PyTorch, walked from the index:
    dX [n, Kp] with each listed slot's product added into its column, in the
    kernel's order (per column its sparse slots, then its pieces', rows
    rising) by one ``index_add_``; slots whose value is 0 skipped, bf16
    rounding dY and then each product."""
    col, row = index.entries()
    v = vals.reshape(-1).float()[index.slot.long()]
    live = v != 0
    gd = dy_slots.index_select(0, row[live])
    prod = _bf16(v[live].view(-1, 1) * _bf16(gd)) if mode == "bf16" else v[live].view(-1, 1) * gd
    dx = torch.zeros((index.n_cols, dy_slots.shape[1]), dtype=torch.float32,
                     device=dy_slots.device)
    return dx.index_add_(0, col[live], prod)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/sddmm.cu, built at first use, with its C signatures."""
    lib = build.library("sddmm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sddmm_launch.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    lib.dx_walk_launch.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
    for fn in (lib.sddmm_launch, lib.dx_walk_launch):
        fn.restype = i32
    lib.sddmm_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.sddmm_info.restype = i32
    return lib


def sddmm_info(kind: str, mode: str) -> dict:
    """The tile kernel (``kind`` "tile"), the per-slot kernel ("slot") or
    the column walk at panels of 128 columns ("dx") of ``mode``: registers a
    thread, spilled (local) bytes a thread, static shared bytes and blocks
    an SM holds."""
    return kernel_info(_lib().sddmm_info, "sddmm_info", ("tile", "slot", "dx").index(kind),
                       int(mode == "bf16"))


def _check(c0, cols, lrow, nc_p, dy_slots, rb, kt, mode, extra=()):
    P, NC, G = cols.shape
    check_operands(dy_slots, (("c0", c0, torch.int32, (P, 1, NC)),
                              ("cols", cols, torch.int32, (P, NC, G)),
                              ("lrow", lrow, torch.int32, (P, NC, G)),
                              ("nc_p", nc_p, torch.int32, (P, 1, 1)), *extra), ndim=2)
    kp = dy_slots.shape[1]
    if kt not in (8, 16, 32) or mode not in PRECISIONS or kp % kt or \
            dy_slots.shape[0] != P * rb:
        raise ValueError(f"sddmm kernels: kt={kt}, mode={mode}, dY_slots "
                         f"{tuple(dy_slots.shape)} for P={P}, rb={rb}")
    return P, NC, G, kp


def sddmm_rows_cuda(c0, cols, lrow, nc_p, dy_slots, x, *, rb, kt, mode, tiles=None,
                    min_slots=None):
    """CUDA ``_sddmm_kernel`` (tpusparse/kernels/sddmm.py:72): dv [P, NC,
    G] for dY_slots [P*rb, Kp] and X [N, Kp] fp32, Kp a multiple of kt in
    {8, 16, 32}, through ``tiles``, the pattern's tile index
    (``sddmm_tiles(fmt)``; one built from other planes, or before they were
    written, is refused): the tile kernel over the tiles that hold at least
    ``min_slots`` slots (default ``TILE_MIN_SLOTS[mode]``), the per-slot
    kernel over the rest of the slots."""
    P, NC, G, kp = _check(c0, cols, lrow, nc_p, dy_slots, rb, kt, mode)
    n = x.shape[0]
    if x.device != dy_slots.device or x.dtype != torch.float32 or x.ndim != 2 or \
            x.shape[1] != kp or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"X must be a contiguous, 16-byte aligned float32 [N, {kp}] "
                         f"tensor on {dy_slots.device}")
    if not isinstance(tiles, SddmmTiles):
        raise ValueError("sddmm_rows_cuda samples through the pattern's tile index: pass tiles=")
    if not tiles.built_from((c0, cols, lrow, nc_p)):
        raise ValueError("sddmm_rows_cuda: the tile index was not built from these index planes "
                         "as they stand (take it from sddmm_tiles)")
    if (tiles.row.device != x.device or tiles.plane_slots != P * NC * G
            or tiles.n_rows != P * rb or tiles.n_cols != n or tiles.tiles.data_ptr() % 16):
        raise ValueError(f"sddmm_rows_cuda: the tile index ({tiles.plane_slots} slots, "
                         f"{tiles.n_rows} rows, {tiles.n_cols} columns, on {tiles.row.device}) "
                         "is not this format's")
    n_dense, d = tiles.dense(TILE_MIN_SLOTS[mode] if min_slots is None else min_slots)
    dv = torch.zeros((P, NC, G), dtype=torch.float32, device=x.device)
    launch_checked(_lib().sddmm_launch, "sddmm_launch",
                   (tiles.tiles, tiles.row, tiles.col, tiles.slot, dy_slots, x, dv),
                   (n_dense, d, tiles.n_slots, P * rb, n, kp, int(mode == "bf16")))
    sddmm_rows_cuda.launches += 1
    return dv


def dx_rows_cuda(c0, cols, lrow, vals, nc_p, dy_slots, *, n, rb, kt, mode, index=None):
    """CUDA ``_dx_kernel`` (tpusparse/kernels/sddmm.py:167): dX [n, Kp] =
    A(vals)^T . dY over the same span planes, through ``index``, the
    pattern's column index (``dx_index(fmt)``, or ``build_dx_index`` for
    another staging threshold; one built from other planes, or before they
    were written, is refused).  Every column's sum is taken in one order:
    two launches give the same bits."""
    P, NC, G = cols.shape
    _check(c0, cols, lrow, nc_p, dy_slots, rb, kt, mode,
           (("vals", vals, torch.float32, (P, NC, G)),))
    kp = dy_slots.shape[1]
    if not isinstance(index, DxIndex):
        raise ValueError("dx_rows_cuda walks the pattern's column index: pass index=")
    if not index.built_from((c0, cols, lrow, nc_p)):
        raise ValueError("dx_rows_cuda: the column index was not built from these index planes "
                         "as they stand (take it from dx_index)")
    if (index.row.device != dy_slots.device or index.plane_slots != P * NC * G
            or index.n_rows != P * rb or index.n_cols != n or index.pieces.data_ptr() % 16
            or index.piece_off.data_ptr() % 16):
        raise ValueError(f"dx_rows_cuda: the column index ({index.plane_slots} slots, "
                         f"{index.n_rows} rows, {index.n_cols} columns, on {index.row.device}) "
                         "is not this format's")
    dev = dy_slots.device
    dx = torch.empty((n, kp), dtype=torch.float32, device=dev)
    ent = torch.empty((index.n_slots + 1, 2), dtype=torch.int32, device=dev)  # copied in pairs
    bf16 = mode == "bf16"
    dyr = torch.empty_like(dy_slots) if bf16 else dx   # bf16: dY rounded once (else unread)
    launch_checked(_lib().dx_walk_launch, "dx_walk_launch",
                   (index.row, index.slot, vals, index.pieces, index.piece_off,
                    index.tile_pieces, index.uoff, index.colpos, dy_slots, dx, ent, dyr),
                   (index.n_slots, index.n_tiles, P * rb, n, kp, int(bf16)))
    dx_rows_cuda.launches += 1
    return dx


sddmm_rows_cuda.launches = 0
dx_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry points

def _k_tile(k: int, ktile: int | None) -> int:
    """The kernels' K-tile: the JAX package's ktile (K up to 128, else 128)
    capped at 32 and snapped to 8, 16 or 32, as span_spmm takes it; K is
    padded to a multiple of it and the kernels loop over the tiles."""
    return choose_kt(min(default_ktile(k) if ktile is None else ktile, 32))


def span_sddmm(fmt: SpanFormat, dy_slots, x, *, ktile: int | None = None,
               precision: str = "fp32x2") -> torch.Tensor:
    """dv [P, NC, G] fp32 = (dY . X^T) sampled at the format's slots.
    ``dy_slots`` [P*RB, K] is dY in slot order (``rows_to_slots``), ``x``
    [N, K] the forward's dense operand.  Padding slots hold what their
    aliased indices compute; mask with ``occupancy_mask``.  CUDA formats
    run the kernel through the format's tile index (built at the first
    call), CPU formats its plain version."""
    assert precision in PRECISIONS, precision
    dev = fmt.device
    x, dy = prep_x(x, dev), prep_x(dy_slots, dev)
    k = x.shape[1]
    assert x.shape[0] == fmt.shape[1], f"X rows {x.shape[0]} != A cols {fmt.shape[1]}"
    assert dy.shape == (fmt.n_programs * fmt.rb, k), f"dY_slots {tuple(dy.shape)}"
    kt = _k_tile(k, ktile)
    kp = cdiv(k, kt) * kt
    x, dy = pad_dense_cols(x, kp).contiguous(), pad_dense_cols(dy, kp).contiguous()
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p, dy, x)
    if dev.type == "cuda":
        return sddmm_rows_cuda(*args, rb=fmt.rb, kt=kt, mode=precision, tiles=sddmm_tiles(fmt))
    return sddmm_rows_plain(*args, rb=fmt.rb, kt=kt, mode=precision)


def span_dx(fmt: SpanFormat, vals, dy_slots, *, ktile: int | None = None,
            precision: str = "fp32x2") -> torch.Tensor:
    """dX [N, K] fp32 = A(vals)^T . dY without a transposed format:
    ``vals`` is the packed [P, NC, G] plane (zero at padding), ``dy_slots``
    dY in slot order [P*RB, K]."""
    assert precision in PRECISIONS, precision
    dev = fmt.device
    if not isinstance(vals, torch.Tensor) or vals.device != dev or \
            vals.shape != fmt.cols.shape:
        raise ValueError(f"vals must be a {tuple(fmt.cols.shape)} tensor on {dev}")
    dy = prep_x(dy_slots, dev)
    k = dy.shape[1]
    assert dy.shape[0] == fmt.n_programs * fmt.rb, f"dY_slots {tuple(dy.shape)}"
    kt = _k_tile(k, ktile)
    dy = pad_dense_cols(dy, cdiv(k, kt) * kt).contiguous()
    args = (fmt.c0, fmt.cols, fmt.lrow, vals.float().contiguous(), fmt.nc_p, dy)
    kw = dict(n=fmt.shape[1], rb=fmt.rb, kt=kt, mode=precision)
    if dev.type == "cuda":
        return dx_rows_cuda(*args, **kw, index=dx_index(fmt))[:, :k]
    return dx_rows_plain(*args, **kw)[:, :k]


def sddmm(mat, a, b, *, rb: int = 512, ct: int = 512, g: int = 128,
          precision: str = "fp32x2", device="cuda") -> torch.Tensor:
    """Sampled dense-dense matmul: the values of ``a @ b.T`` at ``mat``'s
    nonzeros, in ``mat``'s nz order, as an fp32 tensor on ``device``.
    ``a`` [M, K] and ``b`` [N, K] with ``(M, N) == mat.shape``.  One-shot:
    packs the pattern and runs the span SDDMM kernel; training reuses one
    packing across steps through ``autodiff.spmm_trainable``."""
    m, n = mat.shape
    fmt = pack_span(mat, rb=rb, ct=ct, g=g, keep_perm=True, device=device)
    a, b = prep_x(a, fmt.device), prep_x(b, fmt.device)
    assert a.shape[0] == m and b.shape[0] == n and a.shape[1] == b.shape[1], (
        f"a {tuple(a.shape)} / b {tuple(b.shape)} incompatible with pattern {mat.shape}")
    inv = torch.from_numpy(origrow_of_slot(fmt)).to(fmt.device, torch.long)
    dv = span_sddmm(fmt, rows_to_slots(a, inv), b, precision=precision)
    return packed_to_nz(fmt, dv)
