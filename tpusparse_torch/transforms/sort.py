"""Sort / reorder transforms (counterpart of ``tpusparse/transforms/sort.py``).

Reference steps covered (data_transform_step.hpp decl lines):
  get_row_order_by_length @249, get_row_order_by_col @278,
  reorder_row/col/val_by_index @304/332/359,
  remove_empty_row_in_end_of_sub_matrix @694.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


def get_row_order_by_length(ms: MetaDataSet, sub: int, descending: bool = True) -> np.ndarray:
    """Permutation of rows ordered by nnz count (stable).

    Stores ROW ``row_order`` [row_num]: position p holds the *original* row
    index placed at sorted position p.
    """
    rows, _, _ = ms.coo(sub)
    row_num = ms.row_num(sub)
    lengths = np.bincount(rows, minlength=row_num)
    key = -lengths if descending else lengths
    order = np.argsort(key, kind="stable").astype(np.int64)
    ms.add(Level.ROW, "row_order", sub, order, replace=True)
    ms.trace.record(
        "get_row_order_by_length",
        [f"row_nz_row_indices_{sub}"],
        [f"row_row_order_{sub}"],
        descending=descending,
    )
    return order


def get_row_order_by_col(ms: MetaDataSet, sub: int) -> np.ndarray:
    """Permutation of rows ordered by column pattern (first col index, then
    length) — the reference's col_based_sort_operator ordering."""
    rows, cols, _ = ms.coo(sub)
    row_num = ms.row_num(sub)
    first_col = np.full(row_num, np.iinfo(np.int64).max, dtype=np.int64)
    # rows are sorted row-major so the first occurrence per row has min col
    first_idx = np.unique(rows, return_index=True)
    first_col[first_idx[0]] = cols[first_idx[1]]
    lengths = np.bincount(rows, minlength=row_num)
    order = np.lexsort((lengths, first_col)).astype(np.int64)
    ms.add(Level.ROW, "row_order", sub, order, replace=True)
    ms.trace.record(
        "get_row_order_by_col",
        [f"row_nz_row_indices_{sub}", f"col_nz_col_indices_{sub}"],
        [f"row_row_order_{sub}"],
    )
    return order


def reorder_by_row_order(ms: MetaDataSet, sub: int) -> None:
    """Apply ROW ``row_order`` to the COO triple: rows are renumbered to their
    sorted positions and the nz arrays are gathered into the new row-major
    order (reference: reorder_row/col/val_by_index).

    Also maintains ROW ``original_row_of_sorted`` — the composed permutation
    mapping sorted row position -> original row id, used for output recovery
    (reference: unfused sort-recovery via original_nz_row_indices,
    code_generator.cc:1392-1525).
    """
    order = ms.get(Level.ROW, "row_order", sub)
    rows, cols, vals = ms.coo(sub)
    row_num = ms.row_num(sub)
    inv = np.empty(row_num, dtype=np.int64)
    inv[order] = np.arange(row_num)
    new_rows = inv[rows]
    perm = np.argsort(new_rows, kind="stable")
    ms.set_coo(sub, new_rows[perm], cols[perm], vals[perm])
    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        prev = ms.get(Level.ROW, "original_row_of_sorted", sub)
        composed = prev[order]
    else:
        composed = order.copy()
    ms.add(Level.ROW, "original_row_of_sorted", sub, composed, replace=True)
    ms.remove(Level.ROW, "row_order", sub)
    ms.trace.record(
        "reorder_by_row_order",
        [f"row_row_order_{sub}", f"row_nz_row_indices_{sub}"],
        [f"row_nz_row_indices_{sub}", f"col_nz_col_indices_{sub}", f"val_nz_vals_{sub}",
         f"row_original_row_of_sorted_{sub}"],
    )


def remove_empty_rows_in_end(ms: MetaDataSet, sub: int) -> int:
    """Shrink the sub-matrix row range to drop trailing empty rows
    (reference: remove_empty_row_in_end_of_sub_matrix @694).  Returns the new
    row count.  Only trims the *logical* row count; ``original_row_of_sorted``
    keeps full length so recovery still works."""
    rows, _, _ = ms.coo(sub)
    row_num = ms.row_num(sub)
    # an empty sub-matrix keeps one (empty) row, so its blockings and
    # paddings still have a row to hold
    last = int(rows.max()) + 1 if rows.size else min(row_num, 1)
    if last < row_num:
        begin = int(ms.get_scalar(Level.GLOBAL, "begin_row_index", sub))
        ms.add(Level.GLOBAL, "end_row_index", sub, np.int64(begin + last), replace=True)
        ms.trace.record(
            "remove_empty_rows_in_end",
            [f"row_nz_row_indices_{sub}"],
            [f"global_end_row_index_{sub}"],
            old=row_num,
            new=last,
        )
    return min(last, row_num)
