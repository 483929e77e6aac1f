"""Padding transforms (counterpart of ``tpusparse/transforms/pad.py``).

Reference steps covered: row-pad ``modify_*_by_row_pad_in_sub_matrix``
@722-827, col-pad-to-multiple ``..._by_col_pad_in_sub_matrix`` @1049-1146,
col-pad-parent-to-max-row ``..._by_col_pad_parent_blk_to_max_row_size``
@1385-1481 (ELL), empty-row pad ``..._by_empty_pad_in_submatrix`` @1482-1559,
nnz-pad ``modify_*_by_nnz_pad`` @3849-3944.  All pad with val=0 (the
reference also uses col=0; we pad with the row's own last column to preserve
column locality of each chunk, which is value-neutral since val=0).

Padding invalidates existing blocking arrays; like the reference (which
deletes WARP/TBLOCK items and re-runs the former distributing operators,
...thread_blocking_operator.cc:225-317), padding functions here drop
parallel-level metadata and return the removed item names so the operator
executor can re-run blocking.  The exception is
:func:`pad_blocks_to_uniform_nnz`, whose purpose is to *equalize* an existing
blocking into uniform stripes: it updates that level's arrays in place.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level, PARALLEL_LEVELS
from tpusparse_torch.meta.set import MetaDataSet


def _drop_parallel_levels(ms: MetaDataSet, sub: int, keep: Level | None = None) -> list[str]:
    removed: list[str] = []
    for lv in PARALLEL_LEVELS:
        if lv is not keep:
            removed += ms.remove_level(lv, sub)
    return removed


def _append_nz(ms, sub, rows, cols, vals, add_rows, add_cols, add_vals, step, **params):
    """Merge padding nz into the row-major COO arrays."""
    nr = np.concatenate([rows, add_rows])
    nc = np.concatenate([cols, add_cols])
    nv = np.concatenate([vals, add_vals])
    order = np.argsort(nr, kind="stable")
    ms.set_coo(sub, nr[order], nc[order], nv[order])
    ms.trace.record(
        step,
        [f"row_nz_row_indices_{sub}"],
        [f"row_nz_row_indices_{sub}", f"col_nz_col_indices_{sub}", f"val_nz_vals_{sub}"],
        added=int(add_rows.size),
        **params,
    )


def _pad_col_for_rows(ms: MetaDataSet, sub: int, pad_rows: np.ndarray) -> np.ndarray:
    """Column index used for padding each given row: the row's last real
    column (0 for empty rows) — value-neutral since padded vals are 0."""
    rows, cols, _ = ms.coo(sub)
    row_num = ms.row_num(sub)
    last_col = np.zeros(row_num, dtype=np.int64)
    if rows.size:
        last_col[rows] = cols  # row-major order: final write per row = last col
    return last_col[pad_rows]


def pad_rows_to_multiple(ms: MetaDataSet, sub: int, multiple: int) -> list[str]:
    """Grow the logical row count to a multiple (reference row-pad).  Padded
    rows are empty; ``original_row_of_sorted`` gets -1 sentinels so output
    recovery discards them."""
    assert multiple > 0
    row_num = ms.row_num(sub)
    target = -(-row_num // multiple) * multiple
    if target == row_num:
        return []
    begin = int(ms.get_scalar(Level.GLOBAL, "begin_row_index", sub))
    ms.add(Level.GLOBAL, "end_row_index", sub, np.int64(begin + target), replace=True)
    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        rec = ms.get(Level.ROW, "original_row_of_sorted", sub)
        rec = np.concatenate([rec, np.full(target - rec.size, -1, dtype=np.int64)])
        ms.add(Level.ROW, "original_row_of_sorted", sub, rec, replace=True)
    ms.trace.record("pad_rows_to_multiple", [f"global_end_row_index_{sub}"],
                    [f"global_end_row_index_{sub}"], multiple=multiple, new_row_num=target)
    return _drop_parallel_levels(ms, sub)


def pad_empty_rows(ms: MetaDataSet, sub: int) -> list[str]:
    """Give every empty row one explicit zero nz (reference:
    empty_row_pad_operator)."""
    rows, cols, vals = ms.coo(sub)
    row_num = ms.row_num(sub)
    lengths = np.bincount(rows, minlength=row_num)
    empty = np.nonzero(lengths == 0)[0]
    if empty.size == 0:
        return []
    _append_nz(
        ms, sub, rows, cols, vals,
        empty.astype(np.int64), np.zeros(empty.size, dtype=np.int64),
        np.zeros(empty.size, dtype=vals.dtype), "pad_empty_rows",
    )
    return _drop_parallel_levels(ms, sub)


def pad_row_nnz_to_multiple(ms: MetaDataSet, sub: int, multiple: int) -> list[str]:
    """Pad every row's nnz to a multiple (reference col-pad-to-multiple):
    enables fixed per-row vector widths."""
    assert multiple > 0
    rows, cols, vals = ms.coo(sub)
    row_num = ms.row_num(sub)
    lengths = np.bincount(rows, minlength=row_num)
    target = -(-np.maximum(lengths, 0) // multiple) * multiple
    deficit = target - lengths
    pad_rows = np.repeat(np.arange(row_num, dtype=np.int64), deficit)
    if pad_rows.size == 0:
        return []
    _append_nz(
        ms, sub, rows, cols, vals,
        pad_rows, _pad_col_for_rows(ms, sub, pad_rows),
        np.zeros(pad_rows.size, dtype=vals.dtype),
        "pad_row_nnz_to_multiple", multiple=multiple,
    )
    return _drop_parallel_levels(ms, sub)


def pad_block_rows_to_max(
    ms: MetaDataSet, sub: int, level: Level, count_empty_rows: bool = True
) -> list[str]:
    """ELL padding: every row of each ``level`` block padded to that block's
    max row length (reference col-pad-parent-blk-to-max-row-size — the
    heaviest reference steps, 498/452/414 LoC).  ``count_empty_rows`` mirrors
    the reference option of including empty rows in the pad."""
    first_rows = ms.get(level, "first_row_indices", sub).astype(np.int64)
    rows, cols, vals = ms.coo(sub)
    row_num = ms.row_num(sub)
    lengths = np.bincount(rows, minlength=row_num)
    block_of_row = np.searchsorted(first_rows, np.arange(row_num), side="right") - 1
    n_blocks = first_rows.size - 1
    blk_max = np.zeros(n_blocks, dtype=np.int64)
    np.maximum.at(blk_max, block_of_row, lengths)
    target = blk_max[block_of_row]
    if not count_empty_rows:
        target = np.where(lengths == 0, 0, target)
    deficit = target - lengths
    pad_rows = np.repeat(np.arange(row_num, dtype=np.int64), deficit)
    if pad_rows.size == 0:
        return []
    _append_nz(
        ms, sub, rows, cols, vals,
        pad_rows, _pad_col_for_rows(ms, sub, pad_rows),
        np.zeros(pad_rows.size, dtype=vals.dtype),
        f"pad_block_rows_to_max[{level.block_name}]", count_empty_rows=count_empty_rows,
    )
    return _drop_parallel_levels(ms, sub)


def pad_nnz_to_multiple(ms: MetaDataSet, sub: int, multiple: int) -> list[str]:
    """Pad total nnz to a multiple by appending zeros to the last row
    (reference nnz-pad, used by nnz-direction blocking)."""
    assert multiple > 0
    rows, cols, vals = ms.coo(sub)
    nnz = rows.size
    target = -(-max(nnz, 1) // multiple) * multiple
    if target == nnz:
        return []
    n_add = target - nnz
    last_row = rows[-1] if nnz else 0
    pad_rows = np.full(n_add, last_row, dtype=np.int64)
    _append_nz(
        ms, sub, rows, cols, vals,
        pad_rows, _pad_col_for_rows(ms, sub, pad_rows),
        np.zeros(n_add, dtype=vals.dtype),
        "pad_nnz_to_multiple", multiple=multiple,
    )
    return _drop_parallel_levels(ms, sub)


def pad_blocks_to_uniform_nnz(ms: MetaDataSet, sub: int, level: Level, multiple_of: int = 1) -> int:
    """Equalize every ``level`` block to the max block nnz so the packed
    format has one nnz count per stripe (the reference's
    padding-for-fixed-thread-work; padding inserted at each block's end with
    the block's last row id so row-major order within/across blocks holds).
    Updates this level's blocking arrays in place, drops other levels.
    Returns the uniform per-block nnz."""
    first_rows = ms.get(level, "first_row_indices", sub).astype(np.int64)
    first_nzs = ms.get(level, "first_nz_indices", sub).astype(np.int64)
    rows, cols, vals = ms.coo(sub)
    sizes = np.diff(first_nzs)
    c = int(sizes.max()) if sizes.size else 0
    c = -(-max(c, 1) // multiple_of) * multiple_of
    n_blocks = first_nzs.size - 1
    if n_blocks <= 0:  # empty matrix: one all-padding block
        n_blocks = 1
        first_rows = np.zeros(2, dtype=np.int64)
        first_nzs = np.zeros(2, dtype=np.int64)
        sizes = np.zeros(1, dtype=np.int64)
        ms.add(level, "first_row_indices", sub, first_rows, replace=True)
    deficit = c - sizes
    # row id for each block's padding: last nz row in block, else block first row
    if rows.size:
        pad_row_of_block = np.where(
            sizes > 0, rows[np.maximum(first_nzs[1:] - 1, 0)], first_rows[:-1]
        )
    else:
        pad_row_of_block = first_rows[:-1]
    parts_r, parts_c, parts_v = [], [], []
    for b in range(n_blocks):
        lo, hi = first_nzs[b], first_nzs[b + 1]
        parts_r.append(rows[lo:hi])
        parts_c.append(cols[lo:hi])
        parts_v.append(vals[lo:hi])
        if deficit[b]:
            parts_r.append(np.full(deficit[b], pad_row_of_block[b], dtype=rows.dtype))
            pc = cols[hi - 1] if hi > lo else 0
            parts_c.append(np.full(deficit[b], pc, dtype=cols.dtype))
            parts_v.append(np.zeros(deficit[b], dtype=vals.dtype))
    ms.set_coo(sub, np.concatenate(parts_r), np.concatenate(parts_c), np.concatenate(parts_v))
    new_first_nzs = np.arange(n_blocks + 1, dtype=np.int64) * c
    ms.add(level, "first_nz_indices", sub, new_first_nzs, replace=True)
    _drop_parallel_levels(ms, sub, keep=level)
    ms.trace.record(
        f"pad_blocks_to_uniform_nnz[{level.block_name}]",
        [f"{level.short_name}_first_nz_indices_{sub}"],
        [f"{level.short_name}_first_nz_indices_{sub}", f"val_nz_vals_{sub}"],
        uniform_nnz=c, added=int(deficit.sum()),
    )
    return c


def padding_rate(ms: MetaDataSet, sub: int, original_nnz: int) -> float:
    """Current nnz / original nnz — schedules exceeding the config bound
    ``padding_rate_up_bound`` are rejected (reference PADDING_RATE_UP_BOUND)."""
    return ms.nnz(sub) / max(original_nnz, 1)
