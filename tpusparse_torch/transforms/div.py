"""Matrix-div transforms: split one sub-matrix into several (counterpart
of ``tpusparse/transforms/div.py``).

Reference steps covered: fixed_div_row_indices @458,
fixed_div_col_indices_by_corr_row_indices @386, fixed_div_vals_... @423,
modify_{row,col}_{start,end}_boundary_after_fixed_div_in_row_direction
@493-630, div_{row,col,val}_indices_by_row_nnz @2516-2653 and the
corresponding boundary steps @2333-2515 (used by row_nz_matrix_div_operator).

Convention: every sub-matrix keeps *local* row indices starting at 0; the
GLOBAL ``begin_row_index``/``end_row_index`` scalars record the global row
range, and ROW ``original_row_of_sorted`` [local_row_num] maps each local row
back to its absolute row in the original matrix (identity-offset when no sort
happened).  Output recovery always goes through ``original_row_of_sorted``.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


def _ensure_recovery(ms: MetaDataSet, sub: int) -> np.ndarray:
    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        return ms.get(Level.ROW, "original_row_of_sorted", sub)
    begin = int(ms.get_scalar(Level.GLOBAL, "begin_row_index", sub))
    rec = np.arange(begin, begin + ms.row_num(sub), dtype=np.int64)
    ms.add(Level.ROW, "original_row_of_sorted", sub, rec)
    return rec


def _emit_sub(
    ms: MetaDataSet,
    new_sub: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    recovery: np.ndarray,
    col_range: tuple[int, int],
) -> None:
    ms.add(Level.GLOBAL, "begin_row_index", new_sub, np.int64(0), replace=True)
    ms.add(Level.GLOBAL, "end_row_index", new_sub, np.int64(recovery.size), replace=True)
    ms.add(Level.GLOBAL, "begin_col_index", new_sub, np.int64(col_range[0]), replace=True)
    ms.add(Level.GLOBAL, "end_col_index", new_sub, np.int64(col_range[1]), replace=True)
    ms.add(Level.ROW, "nz_row_indices", new_sub, rows, replace=True)
    ms.add(Level.COL, "nz_col_indices", new_sub, cols, replace=True)
    ms.add(Level.VAL, "nz_vals", new_sub, vals, replace=True)
    ms.add(Level.ROW, "original_row_of_sorted", new_sub, recovery, replace=True)


def _remove_sub(ms: MetaDataSet, sub: int) -> None:
    for level, name in (
        (Level.GLOBAL, "begin_row_index"),
        (Level.GLOBAL, "end_row_index"),
        (Level.GLOBAL, "begin_col_index"),
        (Level.GLOBAL, "end_col_index"),
        (Level.ROW, "nz_row_indices"),
        (Level.COL, "nz_col_indices"),
        (Level.VAL, "nz_vals"),
        (Level.ROW, "original_row_of_sorted"),
        (Level.ROW, "row_order"),
        (Level.GLOBAL, "interleaved"),
        (Level.GLOBAL, "calculation_method"),
    ):
        if ms.has(level, name, sub):
            ms.remove(level, name, sub)


def fixed_div_by_rows(ms: MetaDataSet, sub: int, row_interval: int) -> list[int]:
    """Split sub-matrix ``sub`` into sub-matrices of ``row_interval`` rows
    each (reference: fixed_interval_row_matrix_div_operator).  Returns new
    sub-matrix ids.  The source sub-matrix is replaced (its id becomes the
    first chunk)."""
    assert row_interval > 0
    rows, cols, vals = ms.coo(sub)
    recovery = _ensure_recovery(ms, sub)
    row_num = ms.row_num(sub)
    col_range = (
        int(ms.get_scalar(Level.GLOBAL, "begin_col_index", sub)),
        int(ms.get_scalar(Level.GLOBAL, "end_col_index", sub)),
    )
    n_chunks = max(-(-row_num // row_interval), 1)
    existing = ms.sub_matrix_ids()
    next_id = max(existing) + 1 if existing else 0
    new_ids: list[int] = []
    _remove_sub(ms, sub)
    bounds = np.searchsorted(rows, np.arange(0, n_chunks + 1) * row_interval)
    for i in range(n_chunks):
        nid = sub if i == 0 else next_id
        if i > 0:
            next_id += 1
        lo, hi = bounds[i], bounds[i + 1]
        r0 = i * row_interval
        r1 = min((i + 1) * row_interval, row_num)
        _emit_sub(
            ms, nid,
            rows[lo:hi] - r0, cols[lo:hi].copy(), vals[lo:hi].copy(),
            recovery[r0:r1].copy(), col_range,
        )
        new_ids.append(nid)
    ms.trace.record(
        "fixed_div_by_rows",
        [f"row_nz_row_indices_{sub}"],
        [f"row_nz_row_indices_{i}" for i in new_ids],
        row_interval=row_interval,
    )
    return new_ids


def div_by_row_nnz(ms: MetaDataSet, sub: int, bounds: list[int]) -> list[int]:
    """Split by row-nnz buckets (reference: row_nz_matrix_div_operator with
    bucket bounds [init_bound * expansion_rate^i]).

    ``bounds`` are upper-exclusive nnz thresholds, e.g. [32, 256] yields
    buckets len<32, 32<=len<256, len>=256.  Rows are grouped by bucket
    (stable within bucket), so this implicitly reorders rows; recovery is
    maintained via ``original_row_of_sorted``.  Empty buckets are skipped.
    Returns the new sub-matrix ids in bucket order."""
    rows, cols, vals = ms.coo(sub)
    recovery = _ensure_recovery(ms, sub)
    row_num = ms.row_num(sub)
    col_range = (
        int(ms.get_scalar(Level.GLOBAL, "begin_col_index", sub)),
        int(ms.get_scalar(Level.GLOBAL, "end_col_index", sub)),
    )
    lengths = np.bincount(rows, minlength=row_num)
    bucket_of_row = np.searchsorted(np.asarray(bounds, dtype=np.int64), lengths, side="right")
    n_buckets = len(bounds) + 1
    row_ptr = np.zeros(row_num + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)

    existing = ms.sub_matrix_ids()
    next_id = max(existing) + 1 if existing else 0
    _remove_sub(ms, sub)
    new_ids: list[int] = []
    first = True
    for b in range(n_buckets):
        sel_rows = np.nonzero(bucket_of_row == b)[0]
        if sel_rows.size == 0:
            continue
        # gather nz of the selected rows, renumber rows to local 0..k-1
        counts = lengths[sel_rows]
        starts = row_ptr[sel_rows]
        idx = np.concatenate(
            [np.arange(s, s + c, dtype=np.int64) for s, c in zip(starts, counts)]
        ) if sel_rows.size else np.empty(0, dtype=np.int64)
        local_rows = np.repeat(np.arange(sel_rows.size, dtype=np.int64), counts)
        nid = sub if first else next_id
        if not first:
            next_id += 1
        first = False
        _emit_sub(
            ms, nid,
            local_rows, cols[idx].copy(), vals[idx].copy(),
            recovery[sel_rows].copy(), col_range,
        )
        new_ids.append(nid)
    ms.trace.record(
        "div_by_row_nnz",
        [f"row_nz_row_indices_{sub}"],
        [f"row_nz_row_indices_{i}" for i in new_ids],
        bounds=list(bounds),
    )
    return new_ids
