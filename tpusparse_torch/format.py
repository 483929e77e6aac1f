"""Packed sparse formats built by the operator pipeline (counterpart of
``tpusparse/format.py``).

Ported so far: the column-tiled ``TileFormat`` and its packer.  The
stripe, segment and nested-stripe formats arrive with the families that
run them (ROADMAP.md A.7).  As in the JAX package, every format carries
``slot_of_origrow``: the output-recovery gather that undoes sorting and
padding in one index_select.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpusparse_torch.kernels.common import resolve_device
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


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
