"""dgt_gather — tile-window dynamic-gather SpMM (counterpart of
``tpusparse/kernels/dgt_gather.py``, the TPU co-champion of ``dg_gather``).

The format and its packer are the JAX package's, array for array.  Heavy
rows are split into 1/2/4/8 virtual rows whose slots are consecutive and
size-aligned; virtual rows are dealt to P programs of ``rb`` rows; each
program's nonzeros are walked by (program, 128-column window) runs into
128-slot tiles that may reach ``nw`` consecutive windows from one base
(``wins``), tiles concatenating into chunks of ``g`` slots.  With
``resid`` a slot's position within its tile carries its row's residue
class (``slot % ngrp == lrow % ngrp``) and ``lrw`` stores ``lrow //
ngrp``.  The TPU kernels needed these constraints to make the gather and
the scatter cheap on the VPU; on the card a thread loads the row of X it
needs, so they only fix where a slot's column and row are read from.
Keeping the format unchanged lets the tests feed the JAX packer's arrays
to the port (``dgt_format_from_numpy``).

Kernels (CUDA C++, ``tpusparse_torch/csrc/dgt_gather.cu``), each beside
its plain PyTorch version of the same function:

  dgt_rows_cuda        / dgt_rows_plain         replace ``_dgt_kernel``
                                                (kt 8/16/32, fp32x2/bf16,
                                                resid on/off, any nw): the
                                                row walk kernel over the
                                                format's ``dgt_row_walk``
  dgt_stream_rows_cuda / dgt_stream_rows_plain  replace ``_dgt_kernel_stream``
                                                (resid formats, any nw): the
                                                same row walk kernel over
                                                the same walk

Both compute the pre-unpack row block ``y_rows[p*rb + row] += v *
X[col]``; ``_unpack_rows`` then recovers matrix rows (the pairwise-sum
pyramid for split rows) as torch ops.  A wrapper launches its kernel for
CUDA tensors and raises on any failure; only CPU tensors take the plain
version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpusparse_torch import native
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, kernel_info, lex_order,
                                            pad_dense_cols, prep_x, resolve_device)
from tpusparse_torch.kernels.dg_gather import PRECISIONS
from tpusparse_torch.kernels.row_walk import RowWalk, build_row_walk, launch_walk, live_slots
from tpusparse_torch.levels import Level

DGT_KTS = (8, 16, 32)


def dgt_geometry(kt: int, mode: str) -> tuple[int, int]:
    """(nhl, ngrp): hi/lo planes and output lane groups of the TPU kernel.
    ``ngrp`` defines the format: with ``resid`` a row's class is ``lrow %
    ngrp`` and ``rb`` must be a multiple of it."""
    assert kt in DGT_KTS, f"kt={kt} not in {DGT_KTS}"
    assert mode in PRECISIONS, mode
    nhl = 2 if mode == "fp32x2" else 1
    assert nhl * kt >= 8, (kt, mode)
    return nhl, 128 // (nhl * kt)


@dataclasses.dataclass
class DgtFormat:
    """Tile-window chunked format (P programs, NC chunks, G slots, T = G/128
    tiles per chunk, nw windows per tile), torch tensors on one device:
      wins [P, NC, T] int32  window base (col // 128) of each 128-slot tile
      cols [P, NC, G] int32  lane within the window (col % 128) | sel << 7,
                             sel < nw the window offset from the tile's base
      lrw  [P, NC, G] int32  resid: lrow // ngrp (class = slot % ngrp);
                             else the program-local row itself
      vals [P, NC, G] f32    0 in padding slots
      nc_p [P, 1, 1]  int32  real chunk count
      slot_of_origrow [M] int32  index of each matrix row in the pyramid
                             [y; fold2(y); fold4(y); fold8(y)] of pairwise
                             sums over the P*rb row slots (-1: empty)
    ``perm_of_nz`` (numpy, host) maps each COO nonzero to its flat slot.
    ``walk`` is the port's own field: the row walk both kernels walk
    (``dgt_row_walk``), built on the card at the first launch, not part of
    ``memory_bytes``.
    """

    wins: Any
    cols: Any
    lrw: Any
    vals: Any
    nc_p: Any
    slot_of_origrow: Any
    n_programs: int
    n_chunks: int
    chunk_g: int
    rb: int
    kt: int
    mode: str
    resid: bool
    nw: int
    shape: tuple[int, int]
    nnz_real: int
    split_levels: int = 1              # max pieces per row (1/2/4/8)
    perm_of_nz: Any = None
    deal: str = "arbitrary"            # 'blocks' | 'index' | 'arbitrary'
    walk: RowWalk | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.wins.device

    @property
    def padding_rate(self) -> float:
        return self.n_programs * self.n_chunks * self.chunk_g / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.wins, self.cols, self.lrw, self.vals))


def auto_rb_dgt(m: int, n: int, nnz: int, *, nw: int = 4, ngrp: int = 8) -> int:
    """Rows per program for a target tile fill (the JAX package's
    heuristic): programs few enough that nnz / (P * windows) * nw ~ 1.5 *
    128, rounded up to a multiple of 8*ngrp and capped at 8192."""
    nwin = max(-(-n // 128), 1)
    p = max(1, int(nnz * nw // (192 * nwin)))
    rb = max(256, -(-m // p))
    rb = -(-rb // (8 * ngrp)) * (8 * ngrp)
    return min(rb, 8192)


# ---------------------------------------------------------------- pack walks
# The JAX package's walks: the run walks by the native host helpers, their
# numpy versions beside them, so both packages emit one format.

def _rank_within_groups(key: np.ndarray) -> np.ndarray:
    """rank of each element within its equal-key group (stable)."""
    n = key.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    ord2 = np.argsort(key, kind="stable")
    sk = key[ord2]
    new_grp = np.empty(n, dtype=bool)
    new_grp[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_grp[1:])
    grp_id = np.cumsum(new_grp) - 1
    first_pos = np.flatnonzero(new_grp)
    rank_sorted = np.arange(n, dtype=np.int64) - first_pos[grp_id]
    rank = np.empty(n, dtype=np.int64)
    rank[ord2] = rank_sorted
    return rank


def _runs(bucket_arr, cols, lrow_arr, *, col_span, ngrp, resid):
    """Sort the nonzeros by (bucket, column) and group them into (bucket,
    128-column window) runs with their per-class counts."""
    nnz = cols.size
    nwin_mat = int(cdiv(col_span, 128))
    ncls = ngrp if resid else 1
    klass = (lrow_arr % ngrp) if resid else np.zeros(nnz, dtype=np.int64)
    order = lex_order(cols, bucket_arr)
    b_s = bucket_arr[order]
    cls_s = klass[order]
    run_key = b_s * nwin_mat + (cols // 128)[order]  # non-decreasing in this order
    new_run = np.empty(nnz, dtype=bool)
    new_run[:1] = True
    np.not_equal(run_key[1:], run_key[:-1], out=new_run[1:])
    run_id = np.cumsum(new_run) - 1
    uniq = run_key[new_run]
    cnt = np.bincount(run_id * ncls + cls_s,
                      minlength=uniq.size * ncls).reshape(uniq.size, ncls)
    return order, b_s, cls_s, run_id, uniq // nwin_mat, uniq % nwin_mat, cnt, ncls


def _dgt_fill(order, b_s, cols, lrow_arr, vals, gtile, pos, sel, cls_s,
              wins_b, wins_t, wins_w, tot_tiles, *, n_buckets, ngrp, T, g, resid):
    """Shared walk tail: per-sorted-nz (tile, pos, sel) assignments into the
    format arrays (the col plane encodes lane | sel << 7)."""
    nc_arr = np.maximum(-(-tot_tiles // T), 1)
    nc = max(int(nc_arr.max()) if n_buckets else 1, 1)
    lane = cls_s + ngrp * pos if resid else pos
    chunk = gtile // T
    slot = (gtile % T) * 128 + lane

    wins_flat = np.zeros(n_buckets * nc * T, dtype=np.int32)
    if len(wins_t):
        wins_flat[np.asarray(wins_b) * nc * T + np.asarray(wins_t)] = \
            np.asarray(wins_w, dtype=np.int32)
    wins_f = wins_flat.reshape(n_buckets, nc, T)

    cols_f = np.zeros((n_buckets, nc, g), dtype=np.int32)
    lrw_f = np.zeros((n_buckets, nc, g), dtype=np.int32)
    vals_f = np.zeros((n_buckets, nc, g), dtype=np.float32)
    flat = (b_s * nc + chunk) * g + slot
    cols_f.reshape(-1)[flat] = ((cols[order] % 128) | (sel << 7)).astype(np.int32)
    lrw_s = lrow_arr[order]
    lrw_f.reshape(-1)[flat] = ((lrw_s // ngrp) if resid else lrw_s).astype(np.int32)
    vals_f.reshape(-1)[flat] = vals[order].astype(np.float32)
    return wins_f, cols_f, lrw_f, vals_f, nc_arr, flat, order


def dgt_runs_multi_numpy(run_b, run_win, cnt, cap, nw, n_buckets, max_open=8):
    """The multi-open-tile run walk in numpy (the plain version of
    ``native.dgt_runs_multi``, which the packer runs): every tile with free
    room stays open while its window base is within nw of the current run,
    so later windows' overflow classes top up earlier tiles.  Returns
    (seg_run, seg_cls, seg_tile, seg_fill, seg_cnt, seg_sel, wins_b,
    wins_t, wins_w, tot_tiles)."""
    ncls = cnt.shape[1]
    seg_run, seg_cls, seg_tile, seg_fill, seg_cnt, seg_sel = ([] for _ in range(6))
    wins_b, wins_t, wins_w = [], [], []
    tot_tiles = np.zeros(n_buckets, dtype=np.int64)
    cur_b = -1
    opens: list = []   # [window_base, tile_id, room(ncls)]
    ntiles = 0
    for r in range(run_b.size):
        b = run_b[r]
        w = int(run_win[r])
        if b != cur_b:
            if cur_b >= 0:
                tot_tiles[cur_b] = ntiles
            cur_b = b
            ntiles = 0
            opens = []
        left = cnt[r].copy()
        opens = [o for o in opens if o[0] > w - nw and int(o[2].sum()) > 0]
        for o in opens:
            if not left.any():
                break
            t = np.minimum(o[2], left)
            if not t.any():
                continue
            fill = cap - o[2]
            for c in np.flatnonzero(t):
                seg_run.append(r)
                seg_cls.append(int(c))
                seg_tile.append(o[1])
                seg_fill.append(int(fill[c]))
                seg_cnt.append(int(t[c]))
                seg_sel.append(w - o[0])
            o[2] = o[2] - t
            left = left - t
        lmax = int(left.max())
        if lmax > 0:
            n_new = -(-lmax // cap)
            for j in range(n_new):
                tid = ntiles + j
                room = np.full(ncls, cap, dtype=np.int64)
                for c in range(ncls):
                    take_c = min(cap, max(int(left[c]) - j * cap, 0))
                    if take_c > 0:
                        seg_run.append(r)
                        seg_cls.append(c)
                        seg_tile.append(tid)
                        seg_fill.append(0)
                        seg_cnt.append(take_c)
                        seg_sel.append(0)
                        room[c] = cap - take_c
                opens.append([w, tid, room])
                wins_b.append(b)
                wins_t.append(tid)
                wins_w.append(w)
            ntiles += n_new
            if len(opens) > max_open:
                opens = opens[-max_open:]
    if cur_b >= 0:
        tot_tiles[cur_b] = ntiles
    return (*(np.asarray(a, dtype=np.int64) for a in (seg_run, seg_cls, seg_tile, seg_fill,
                                                      seg_cnt, seg_sel, wins_b, wins_t,
                                                      wins_w)), tot_tiles)


def _dgt_walk_multi(bucket_arr, cols, lrow_arr, vals, *, n_buckets, col_span,
                    ngrp, cap, T, g, nw, resid, max_open=8):
    """The multi-open-tile walk (pack default) over the (bucket, window)
    runs, by ``native.dgt_runs_multi``, then each nonzero's (tile, slot)."""
    nnz = cols.size
    order, b_s, cls_s, run_id, run_b, run_win, cnt, ncls = _runs(
        bucket_arr, cols, lrow_arr, col_span=col_span, ngrp=ngrp, resid=resid)
    (seg_run, seg_cls, seg_tile, seg_fill, seg_cnt, seg_sel, wins_b, wins_t, wins_w,
     tot_tiles) = native.dgt_runs_multi(run_b, run_win, cnt, cap, nw, n_buckets, max_open)

    # expand segments to per-nz assignments: nz sorted stably by (run, cls)
    # align 1:1 with segments sorted stably by (run, cls) repeated by count
    sord = np.argsort(seg_run * ncls + seg_cls, kind="stable")
    cnts = seg_cnt[sord]
    total = int(cnts.sum())
    assert total == nnz, (total, nnz)
    nord = np.argsort(run_id * ncls + cls_s, kind="stable")
    starts = (np.cumsum(cnts) - cnts).astype(np.int64)  # no segments: no starts
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, cnts)
    gtile = np.empty(nnz, dtype=np.int64)
    pos = np.empty(nnz, dtype=np.int64)
    sel = np.empty(nnz, dtype=np.int64)
    gtile[nord] = np.repeat(seg_tile[sord], cnts)
    pos[nord] = np.repeat(seg_fill[sord], cnts) + within
    sel[nord] = np.repeat(seg_sel[sord], cnts)
    return _dgt_fill(order, b_s, cols, lrow_arr, vals, gtile, pos, sel,
                     cls_s, wins_b, wins_t, wins_w, tot_tiles,
                     n_buckets=n_buckets, ngrp=ngrp, T=T, g=g, resid=resid)


def dgt_runs_numpy(run_b, run_win, cnt, cap, nw, n_buckets):
    """The single-open-tile run walk in numpy (the plain version of
    ``native.dgt_runs``): a run first tops up the carried open tile (if its
    window is within the tile's reach), then fills fresh single-window
    tiles, the last of which becomes the new open tile.  Returns (take,
    open_tile, open_fill, join_pos, new_base, fresh_n, tot_tiles)."""
    n_runs, ncls = cnt.shape
    take = np.zeros((n_runs, ncls), dtype=np.int64)
    open_tile = np.zeros(n_runs, dtype=np.int64)
    open_fill = np.zeros((n_runs, ncls), dtype=np.int64)
    join_pos = np.zeros(n_runs, dtype=np.int64)
    new_base = np.zeros(n_runs, dtype=np.int64)
    fresh_n = np.zeros(n_runs, dtype=np.int64)
    tot_tiles = np.zeros(n_buckets, dtype=np.int64)
    cur_b = -1
    room = None
    open_w = -1  # window base of the carried open tile
    ntiles = 0
    for r in range(n_runs):
        b = run_b[r]
        if b != cur_b:
            if cur_b >= 0:
                tot_tiles[cur_b] = ntiles
            cur_b = b
            ntiles = 0
            room = None
            open_w = -1
        c = cnt[r]
        w = int(run_win[r])
        joined = (room is not None and 0 <= w - open_w < nw
                  and int(np.minimum(room, c).sum()) > 0)
        if joined:
            t = np.minimum(room, c)
            take[r] = t
            open_tile[r] = ntiles - 1
            open_fill[r] = cap - room
            join_pos[r] = w - open_w
            room = room - t
        else:
            t = np.zeros(ncls, dtype=np.int64)
        left = c - t
        lmax = int(left.max())
        if lmax > 0:
            n_new = -(-lmax // cap)
            new_base[r] = ntiles
            fresh_n[r] = n_new
            ntiles += n_new
            room = cap - np.maximum(left - (n_new - 1) * cap, 0)
            open_w = w
    if cur_b >= 0:
        tot_tiles[cur_b] = ntiles
    return take, open_tile, open_fill, join_pos, new_base, fresh_n, tot_tiles


def _dgt_walk(bucket_arr, cols, lrow_arr, vals, *, n_buckets, col_span,
              ngrp, cap, T, g, nw, resid):
    """The single-open-tile walk over the (bucket, window) runs, by
    ``native.dgt_runs``, then each nonzero's (tile, slot)."""
    order, b_s, cls_s, run_id, run_b, run_win, cnt, ncls = _runs(
        bucket_arr, cols, lrow_arr, col_span=col_span, ngrp=ngrp, resid=resid)
    rank = _rank_within_groups(run_id * ncls + cls_s)  # rank in (run, class)
    take, open_tile, open_fill, join_pos, new_base, fresh_n, tot_tiles = native.dgt_runs(
        run_b, run_win, cnt, cap, nw, n_buckets)

    t_of = take[run_id, cls_s]
    in_open = rank < t_of
    gtile = np.where(in_open, open_tile[run_id], new_base[run_id] + (rank - t_of) // cap)
    pos = np.where(in_open, open_fill[run_id, cls_s] + rank, (rank - t_of) % cap)
    sel = np.where(in_open, join_pos[run_id], 0)
    # fresh tiles carry their creator run's window as their base
    fr = np.flatnonzero(fresh_n > 0)
    wins_b = np.repeat(run_b[fr], fresh_n[fr])
    wins_t = (np.repeat(new_base[fr], fresh_n[fr])
              + _rank_within_groups(np.repeat(fr, fresh_n[fr])))
    wins_w = np.repeat(run_win[fr], fresh_n[fr])
    return _dgt_fill(order, b_s, cols, lrow_arr, vals, gtile, pos, sel,
                     cls_s, wins_b, wins_t, wins_w, tot_tiles,
                     n_buckets=n_buckets, ngrp=ngrp, T=T, g=g, resid=resid)


def pack_dgt(
    mat_or_ms,
    sub: int = 0,
    *,
    out_rows: int | None = None,
    rb: int = 256,
    g: int = 512,
    kt: int = 8,
    mode: str = "fp32x2",
    resid: bool = True,
    nw: int = 4,
    split: int | str | None = "auto",
    balance: bool = True,
    deal: str | None = None,
    keep_perm: bool = False,
    walk: str = "multi",
    device="cuda",
) -> DgtFormat:
    """Pack into DgtFormat on ``device``: heavy rows split into <= 8 virtual
    rows (``split`` nnz per piece, 'auto' = 8x the mean row length, at
    least 64), virtual rows length-dealt across programs (snake order),
    then the tile walk (``walk`` 'multi' or 'single'), as in the JAX
    packer."""
    dev = resolve_device(device)
    _, ngrp = dgt_geometry(kt, mode)
    cap = (128 // ngrp) if resid else 128  # slots per (class, tile)
    assert rb % ngrp == 0, f"rb={rb} must be a multiple of ngrp={ngrp}"
    assert g % 128 == 0, f"g={g} must be a multiple of the 128-slot tile"
    assert nw in (1, 2, 4, 8), nw
    T = g // 128

    if isinstance(mat_or_ms, CooMatrix):
        rows = mat_or_ms.rows.astype(np.int64)
        cols = mat_or_ms.cols.astype(np.int64)
        vals = np.asarray(mat_or_ms.vals)
        row_num, col_num = mat_or_ms.shape
        rec = np.arange(row_num, dtype=np.int64)
        if out_rows is None:
            out_rows = row_num
    else:
        ms = mat_or_ms
        rows, cols, vals = ms.coo(sub)
        rows = rows.astype(np.int64)
        cols = cols.astype(np.int64)
        row_num = ms.row_num(sub)
        col_num = ms.col_num(sub)
        if ms.has(Level.ROW, "original_row_of_sorted", sub):
            rec = ms.get(Level.ROW, "original_row_of_sorted", sub)[:row_num]
        else:
            rec = np.arange(row_num, dtype=np.int64)
        assert out_rows is not None

    nnz = rows.size
    if deal is None:
        deal = "length" if (balance and row_num > rb) else "blocks"
    assert deal in ("length", "index", "blocks"), deal

    # virtual rows: split heavy rows into 1/2/4/8 pieces (length dealing
    # only; the affine deals stay 1:1).  A unit's pieces get consecutive
    # size-aligned slots in one program, so one gather from the pairwise-sum
    # pyramid recovers the row.
    lengths = np.bincount(rows, minlength=row_num) if row_num else np.zeros(0, np.int64)
    if split == "auto":
        split = max(64, 8 * max(nnz // max(row_num, 1), 1))
    if deal != "length" or not split:
        pieces = np.ones(row_num, dtype=np.int64)
    else:
        raw = np.minimum(np.maximum(-(-lengths // int(split)), 1), 8)
        pieces = np.where(raw > 4, 8, np.where(raw > 2, 4, raw)).astype(np.int64)
    vrow_base = np.concatenate([[0], np.cumsum(pieces)]).astype(np.int64)
    mv = int(vrow_base[-1])
    if int(pieces.max(initial=1)) > 1:
        order0 = np.argsort(rows, kind="stable")
        row_start = np.concatenate([[0], np.cumsum(lengths)])
        rnk = np.arange(nnz, dtype=np.int64) - row_start[rows[order0]]
        vr = np.empty(nnz, dtype=np.int64)
        vr[order0] = vrow_base[rows[order0]] + rnk % pieces[rows[order0]]
    else:
        vr = rows
    smax = int(pieces.max(initial=1))
    assert rb % 8 == 0, rb

    if deal == "length" and mv:
        # per piece-size class, deal units round-robin by length in snake
        # order; slot bases allocate descending size so alignment is free
        p_count = max(-(-mv // rb), 1)
        while True:
            per_p = sum(s * (-(-int((pieces == s).sum()) // p_count)) for s in (8, 4, 2, 1))
            if per_p <= rb or p_count >= max(mv, 1):
                break
            p_count += 1
        p_of_unit = np.zeros(row_num, dtype=np.int64)
        base_of_unit = np.zeros(row_num, dtype=np.int64)
        offset_p = np.zeros(p_count, dtype=np.int64)
        order_len = np.argsort(-lengths, kind="stable")
        for size in (8, 4, 2, 1):
            cls_units = order_len[pieces[order_len] == size]
            if cls_units.size == 0:
                continue
            i = np.arange(cls_units.size)
            fwd = (i // p_count) % 2 == 0
            pp = np.where(fwd, i % p_count, p_count - 1 - i % p_count)
            p_of_unit[cls_units] = pp
            base_of_unit[cls_units] = offset_p[pp] + (i // p_count) * size
            offset_p += np.bincount(pp, minlength=p_count) * size
        assert int(offset_p.max(initial=0)) <= rb, (offset_p.max(), rb)
        unit_of_vr = np.repeat(np.arange(row_num), pieces)
        p_of_vr = p_of_unit[unit_of_vr]
        lrow_of_vr = base_of_unit[unit_of_vr] + np.arange(mv) - vrow_base[unit_of_vr]
        p_arr = p_of_vr[vr]
        lrow_arr = lrow_of_vr[vr]
    elif deal == "index" and mv:
        p_count = max(-(-mv // rb), 1)
        p_arr = vr % p_count
        lrow_arr = vr // p_count
    else:
        p_count = max(-(-mv // rb), 1)
        p_arr = vr // rb
        lrow_arr = vr % rb

    assert walk in ("multi", "single"), walk
    walk_fn = _dgt_walk_multi if walk == "multi" else _dgt_walk
    wins_f, cols_f, lrw_f, vals_f, nc_arr, flat, order = walk_fn(
        p_arr, cols, lrow_arr, np.asarray(vals), n_buckets=p_count,
        col_span=col_num, ngrp=ngrp, cap=cap, T=T, g=g, nw=nw, resid=resid)
    nc = cols_f.shape[1]

    # pyramid index: row -> one gather position in [y; fold2; fold4; fold8]
    if deal == "length":
        slot0_of_unit = p_of_unit * rb + base_of_unit
    elif deal == "index":
        u = np.arange(row_num, dtype=np.int64)
        slot0_of_unit = (u % p_count) * rb + u // p_count
    else:
        slot0_of_unit = np.arange(row_num, dtype=np.int64)
    nslots = p_count * rb
    lvl_of_unit = np.log2(pieces).astype(np.int64) if row_num else pieces
    lvl_off = np.array([0, nslots, nslots + nslots // 2,
                        nslots + nslots // 2 + nslots // 4], dtype=np.int64)
    pyr_idx = lvl_off[lvl_of_unit] + (slot0_of_unit >> lvl_of_unit)

    slot_of_origrow = np.full(out_rows, -1, dtype=np.int32)
    kept_rows = np.flatnonzero(rec >= 0)
    slot_of_origrow[rec[kept_rows]] = pyr_idx[kept_rows].astype(np.int32)

    def _affine_ok(aff):
        if out_rows > p_count * rb or smax != 1:
            return False
        got = slot_of_origrow >= 0
        if not np.array_equal(slot_of_origrow[got], aff[got]):
            return False
        occ = np.zeros(p_count * rb, dtype=bool)
        occ[slot_of_origrow[got]] = True
        return not occ[aff[~got]].any()

    unpack = "arbitrary"
    ar = np.arange(out_rows, dtype=np.int64)
    if deal == "blocks" and _affine_ok(ar):
        unpack = "blocks"
    elif deal == "index" and _affine_ok((ar % p_count) * rb + ar // p_count):
        unpack = "index"

    perm = None
    if keep_perm:
        perm = np.empty(nnz, dtype=np.int64)
        perm[order] = flat

    def dev_t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return DgtFormat(
        wins=dev_t(wins_f, torch.int32),
        cols=dev_t(cols_f, torch.int32),
        lrw=dev_t(lrw_f, torch.int32),
        vals=dev_t(vals_f, torch.float32),
        nc_p=dev_t(np.asarray(nc_arr, np.int32).reshape(p_count, 1, 1), torch.int32),
        slot_of_origrow=dev_t(slot_of_origrow, torch.int32),
        split_levels=smax,
        n_programs=p_count,
        n_chunks=nc,
        chunk_g=g,
        rb=rb,
        kt=kt,
        mode=mode,
        nw=nw,
        resid=resid,
        shape=(out_rows, col_num),
        nnz_real=int(np.count_nonzero(vals_f)),
        perm_of_nz=perm,
        deal=unpack,
    )


def with_values(fmt: DgtFormat, new_vals) -> DgtFormat:
    """Values-only update (same pattern; requires pack_dgt(keep_perm=True)).
    The row walk, of the pattern, is carried over with the new values."""
    assert fmt.perm_of_nz is not None, "pack_dgt(..., keep_perm=True) required"
    new_vals = np.asarray(new_vals, dtype=np.float32)
    flat = np.zeros(fmt.n_programs * fmt.n_chunks * fmt.chunk_g, dtype=np.float32)
    flat[np.asarray(fmt.perm_of_nz)] = new_vals
    vals = torch.from_numpy(flat.reshape(fmt.n_programs, fmt.n_chunks, fmt.chunk_g))
    vals = vals.to(fmt.device)
    return dataclasses.replace(fmt, vals=vals, nnz_real=int(np.count_nonzero(flat)),
                               walk=None if fmt.walk is None else fmt.walk.for_plane(vals))


def _pyramid_len(nslots: int, split_levels: int) -> int:
    return sum(nslots >> lvl for lvl in range(split_levels.bit_length()))


FIELDS = ("wins", "cols", "lrw", "vals", "nc_p", "slot_of_origrow")
_DTYPES = {"wins": torch.int32, "cols": torch.int32, "lrw": torch.int32,
           "vals": torch.float32, "nc_p": torch.int32, "slot_of_origrow": torch.int32}


def dgt_format_from_numpy(fields: dict, *, device="cuda", **static) -> DgtFormat:
    """A DgtFormat from numpy arrays — the JAX ``DgtFormat``'s ``wins``,
    ``cols``, ``lrw``, ``vals``, ``nc_p``, ``slot_of_origrow`` and
    ``perm_of_nz`` — plus its static fields (``n_programs``, ``n_chunks``,
    ``chunk_g``, ``rb``, ``kt``, ``mode``, ``resid``, ``nw``, ``shape``,
    ``nnz_real``, ``split_levels``, ``deal``).  The arrays come from outside
    this package, so their shapes and index ranges are checked here: the
    kernels read X and write Y at these indices without bounds checks."""
    dev = resolve_device(device)
    arrs = {k: np.asarray(fields[k]) for k in FIELDS}
    P, NC, G = static["n_programs"], static["n_chunks"], static["chunk_g"]
    rb, nw, (m, n) = static["rb"], static["nw"], static["shape"]
    levels = static.get("split_levels", 1)
    _, ngrp = dgt_geometry(static["kt"], static["mode"])
    if G % 128 or levels not in (1, 2, 4, 8) or nw not in (1, 2, 4, 8):
        raise ValueError(f"DgtFormat: chunk_g={G}, split_levels={levels}, nw={nw}")
    want = {"wins": (P, NC, G // 128), "cols": (P, NC, G), "lrw": (P, NC, G),
            "vals": (P, NC, G), "nc_p": (P, 1, 1), "slot_of_origrow": (m,)}
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"DgtFormat.{k}: shape {arrs[k].shape}, want {shp}")
    live = arrs["vals"] != 0
    c = arrs["cols"].astype(np.int64)
    base = np.repeat(arrs["wins"].astype(np.int64), 128, axis=2)
    col = (base + (c >> 7)) * 128 + (c & 127)
    lrw = arrs["lrw"].astype(np.int64)
    row = lrw * ngrp + np.arange(G) % ngrp if static["resid"] else lrw
    if (live.any() and (col[live].min() < 0 or col[live].max() >= n
                        or (c[live] >> 7).max() >= nw)) or \
            lrw.min(initial=0) < 0 or row.max(initial=0) >= rb or \
            arrs["nc_p"].min(initial=0) < 0 or arrs["nc_p"].max(initial=0) > NC or \
            arrs["slot_of_origrow"].max(initial=-1) >= _pyramid_len(P * rb, levels):
        raise ValueError("DgtFormat indices out of range")
    tensors = {k: torch.tensor(arrs[k], dtype=_DTYPES[k], device=dev) for k in FIELDS}
    perm = fields.get("perm_of_nz")
    return DgtFormat(**tensors, **static, perm_of_nz=None if perm is None else np.asarray(perm))


def pack_rowhot(fmt: DgtFormat) -> torch.Tensor:
    """(P, NC, rb/ngrp, G) bf16 row one-hot planes, the JAX package's
    streamed-scatter operand.  The port's kernels read rows from ``lrw``;
    ``dgt_spmm(rowhot=...)`` accepts the planes and gives the same Y."""
    assert fmt.resid, "streamed rowhot pairs with the static-residue kernel"
    _, ngrp = dgt_geometry(fmt.kt, fmt.mode)
    rbs = fmt.rb // ngrp
    iota = torch.arange(rbs, dtype=torch.int32, device=fmt.device)
    return (fmt.lrw[:, :, None, :] == iota[None, None, :, None]).to(torch.bfloat16)


# --------------------------------------------------------------- plain versions

def _slot_cols_rows(wins, cols, lrw, rb, ngrp, resid):
    """(column of X, row of y_rows) of every slot, as int64 [P, NC, G]."""
    P, NC, G = cols.shape
    c = cols.long()
    col = (wins.long().repeat_interleave(128, dim=2) + (c >> 7)) * 128 + (c & 127)
    row = lrw.long() * ngrp + torch.arange(G, device=cols.device) % ngrp if resid else lrw.long()
    return col, row + torch.arange(P, device=cols.device).view(P, 1, 1) * rb


def build_dgt_walk(wins, cols, lrw, vals, nc_p, *, rb, kt, mode, resid, n,
                   perm_of_nz=None) -> RowWalk:
    """The row walk of a dgt format's planes: its live slots (those of
    ``perm_of_nz`` where given, else the nonzeros of ``vals`` in a chunk
    before ``nc_p``) with their y_rows row, as ``dgt_rows_plain`` decodes
    it (the split-row piece's row; the residue class with ``resid``), and
    their column of X [n, ...], sorted by (row, slot)."""
    _, ngrp = dgt_geometry(kt, mode)
    P, NC, _ = cols.shape
    col, row = _slot_cols_rows(wins, cols, lrw, rb, ngrp, resid)
    walked = torch.arange(NC, device=cols.device).view(1, NC, 1) < nc_p.reshape(P, 1, 1)
    return build_row_walk(row, col, live_slots(vals, walked, perm_of_nz), vals,
                          pattern=(wins, cols, lrw, nc_p), live_from_values=perm_of_nz is None,
                          n_rows=P * rb, n_cols=n)


def dgt_row_walk(fmt: DgtFormat) -> RowWalk:
    """The format's row walk, built at first use and kept on the format;
    built anew where a plane was replaced or written in place since."""
    wins, cols, lrw, vals, nc_p = _fmt_args(fmt)
    if fmt.walk is None or not fmt.walk.fresh((wins, cols, lrw, nc_p), vals):
        fmt.walk = build_dgt_walk(wins, cols, lrw, vals, nc_p, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode,
                                  resid=fmt.resid, n=fmt.shape[1], perm_of_nz=fmt.perm_of_nz)
    return fmt.walk


def dgt_rows_plain(wins, cols, lrw, vals, nc_p, x, *, rb, kt, mode, resid):
    """Plain PyTorch ``_dgt_kernel``: y_rows [P*rb, Kp] with ``y_rows[p*rb +
    row] += v * X[col]`` over the slots whose value is not zero, col =
    (wins[tile] + (cols >> 7)) * 128 + (cols & 127) and row = lrw * ngrp +
    slot % ngrp (resid) or lrw.  bf16 rounds each product as the kernel
    does; chunks past ``nc_p`` hold only zeros, so ``nc_p`` changes nothing."""
    _, ngrp = dgt_geometry(kt, mode)
    col, row = _slot_cols_rows(wins, cols, lrw, rb, ngrp, resid)
    live = (vals != 0).reshape(-1)
    prod = vals.reshape(-1)[live].view(-1, 1) * x[col.reshape(-1)[live]]
    if mode == "bf16":
        prod = prod.to(torch.bfloat16).float()
    y = torch.zeros((cols.shape[0] * rb, x.shape[1]), dtype=torch.float32, device=x.device)
    return y.index_add_(0, row.reshape(-1)[live], prod)


def dgt_stream_rows_plain(wins, cols, lrw, vals, nc_p, x, *, rb, kt, mode, nw):
    """Plain PyTorch ``_dgt_kernel_stream``: the same y_rows as
    ``dgt_rows_plain`` for a resid format; ``nw`` (the windows a tile
    reaches) changes nothing in the result."""
    return dgt_rows_plain(wins, cols, lrw, vals, nc_p, x, rb=rb, kt=kt, mode=mode, resid=True)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/dgt_gather.cu, built at first use, with its C signatures."""
    lib = build.library("dgt_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dgt_spmm_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.dgt_spmm_launch.restype = i32
    lib.dgt_walk_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.dgt_walk_info.restype = i32
    return lib


def dgt_walk_info(pw: int, mode: str) -> dict:
    """The row walk kernel of panel ``pw`` in ``mode`` in this library:
    registers a thread, spilled (local) bytes a thread, static shared bytes
    and blocks an SM holds."""
    return kernel_info(_lib().dgt_walk_info, "dgt_walk_info", pw, int(mode == "bf16"))


def _check(wins, cols, lrw, vals, nc_p, x, kt, mode):
    P, NC, G = cols.shape
    if G % 128:
        raise ValueError(f"chunk size {G} is not a multiple of 128")
    check_operands(x, (("wins", wins, torch.int32, (P, NC, G // 128)),
                       ("cols", cols, torch.int32, (P, NC, G)),
                       ("lrw", lrw, torch.int32, (P, NC, G)),
                       ("vals", vals, torch.float32, (P, NC, G)),
                       ("nc_p", nc_p, torch.int32, (P, 1, 1))), ndim=2)
    if kt not in DGT_KTS or mode not in PRECISIONS or x.shape[1] % kt:
        raise ValueError(f"dgt kernel: kt={kt}, mode={mode}, X {tuple(x.shape)}")


def dgt_rows_cuda(wins, cols, lrw, vals, nc_p, x, *, rb, kt, mode, resid, walk=None, k=None,
                  out=None):
    """CUDA ``_dgt_kernel`` (tpusparse/kernels/dgt_gather.py:667): y_rows
    [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt in {8, 16, 32}, from
    one launch of the row walk kernel over ``walk``, the format's live
    slots in row order (``dgt_row_walk(fmt)``, which holds ``resid``'s
    decode; one built from other planes, or before they were written, is
    refused).  The values are ``vals``'s: streamed from the walk where it
    holds them (``vals`` is the plane it was built from, unwritten since),
    else gathered through its slot index.  ``k``: the columns of X
    that carry the product (the rest is the kt padding; None: all Kp); the
    kernel reads and writes them rounded up to 4, the rest of y_rows stays
    zero.  ``out``: y_rows [P*rb, Kp] to add into, returned in its place."""
    _check(wins, cols, lrw, vals, nc_p, x, kt, mode)
    y = launch_walk(_lib().dgt_spmm_launch, "dgt_spmm_launch", walk, (wins, cols, lrw, nc_p),
                    vals, x, rows=cols.shape[0] * rb, k=k, bf16=mode == "bf16", out=out)
    dgt_rows_cuda.launches += 1
    return y


def dgt_stream_rows_cuda(wins, cols, lrw, vals, nc_p, x, *, rb, kt, mode, nw, walk=None,
                         k=None):
    """CUDA ``_dgt_kernel_stream`` (tpusparse/kernels/dgt_gather.py:882)
    for a resid format: one launch of the row walk kernel over ``walk``, as
    ``dgt_rows_cuda`` (the format's ``dgt_row_walk``, shared by both; a
    missing or stale walk is refused).  The TPU kernel staged each tile's
    ``nw`` X windows because X could not stay in VMEM; the card reads X
    where a slot needs it, so ``nw`` (1, 2, 4 or 8) is checked and changes
    nothing in the result."""
    if nw not in (1, 2, 4, 8):
        raise ValueError(f"nw={nw}")
    _check(wins, cols, lrw, vals, nc_p, x, kt, mode)
    y = launch_walk(_lib().dgt_spmm_launch, "dgt_stream_rows_cuda", walk,
                    (wins, cols, lrw, nc_p), vals, x, rows=cols.shape[0] * rb, k=k,
                    bf16=mode == "bf16")
    dgt_stream_rows_cuda.launches += 1
    return y


dgt_rows_cuda.launches = 0
dgt_stream_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry points

def _unpack_rows(fmt: DgtFormat, y_rows):
    if fmt.deal == "blocks":
        return y_rows[: fmt.shape[0]]
    if fmt.deal == "index":
        P = fmt.n_programs
        return (y_rows.reshape(P, fmt.rb, *y_rows.shape[1:])
                .transpose(0, 1).reshape(P * fmt.rb, *y_rows.shape[1:])[: fmt.shape[0]])
    # split rows: Y[r] = the sum over the row's consecutive aligned slots =
    # one gather from the pairwise-sum pyramid [y; fold2; fold4; fold8]
    pyr = [y_rows]
    for _ in range(fmt.split_levels.bit_length() - 1):
        prev = pyr[-1]
        pyr.append(prev.reshape(prev.shape[0] // 2, 2, *prev.shape[1:]).sum(1))
    y_src = torch.cat(pyr) if len(pyr) > 1 else y_rows
    slot = fmt.slot_of_origrow.long()
    got = y_src.index_select(0, slot.clamp(min=0))
    valid = (slot >= 0).view(-1, *([1] * (y_rows.ndim - 1)))
    return torch.where(valid, got, torch.zeros((), dtype=got.dtype, device=got.device))


def _fmt_args(fmt):
    return fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p


def dgt_spmm(
    fmt: DgtFormat,
    x,
    *,
    unroll: int = 8,
    rowhot=None,
    scatter: str = "select",
    fold: bool = True,
    pipe: bool = False,
    rowhot_i8: bool = False,
    stream_x: bool = False,
) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in DgtFormat (X padded to a multiple of
    kt, whose K columns the kernel walks at once).  ``stream_x`` takes the
    stream wrapper (resid + select, no rowhot, as in the JAX package), over
    the same row walk.  ``unroll``, ``scatter``,
    ``fold``, ``pipe``, ``rowhot_i8`` and ``rowhot`` steered the TPU
    kernel's schedule: they are checked as the JAX package checks them and
    give the same Y.  CUDA formats run the kernel, CPU formats the plain
    version."""
    assert scatter in ("select", "fullrow"), scatter
    assert not (rowhot is not None and scatter == "fullrow"), \
        "streamed rowhot pairs with the group-scatter kernels"
    if rowhot is not None:
        _, ngrp = dgt_geometry(fmt.kt, fmt.mode)
        want = (fmt.n_programs, fmt.n_chunks, fmt.rb // ngrp, fmt.chunk_g)
        assert tuple(rowhot.shape) == want, f"rowhot {tuple(rowhot.shape)}, want {want}"
    x = prep_x(x, fmt.device)
    k = x.shape[1]
    assert x.shape[0] == fmt.shape[1], f"X rows {x.shape[0]} != A cols {fmt.shape[1]}"
    x = pad_dense_cols(x, cdiv(k, fmt.kt) * fmt.kt).contiguous()
    on_card = fmt.device.type == "cuda"
    if stream_x:
        assert fmt.resid and scatter == "select" and rowhot is None, \
            "stream_x pairs with the resid select kernel"
        kw = dict(walk=dgt_row_walk(fmt), k=k) if on_card else {}
        rows_fn = dgt_stream_rows_cuda if on_card else dgt_stream_rows_plain
        y_rows = rows_fn(*_fmt_args(fmt), x, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode, nw=fmt.nw,
                         **kw)
    elif on_card:
        y_rows = dgt_rows_cuda(*_fmt_args(fmt), x, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode,
                               resid=fmt.resid, walk=dgt_row_walk(fmt), k=k)
    else:
        y_rows = dgt_rows_plain(*_fmt_args(fmt), x, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode,
                                resid=fmt.resid)
    return _unpack_rows(fmt, y_rows)[:, :k]


def dgt_spmv(fmt: DgtFormat, x, *, unroll: int = 8) -> torch.Tensor:
    """y[M] = A . x[N]: SpMV through the kt-wide SpMM kernel (x zero-padded
    to kt columns, of which the kernel reads 4)."""
    x = prep_x(x, fmt.device)
    assert x.ndim == 1 and x.shape[0] == fmt.shape[1], f"x shape {tuple(x.shape)}"
    return dgt_spmm(fmt, x[:, None], unroll=unroll)[:, 0]
