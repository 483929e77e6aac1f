"""Hierarchical blocking transforms (counterpart of
``tpusparse/transforms/block.py``).

Reference steps covered (data_transform_step.hpp): the
``get_begin_{rows,nzs}_of_{BMTB,BMW,BMT}_after_*`` families — fixed
row-interval blocking @631-1025, col-direction @2057-2301, nnz-direction
@3373-3815, balanced (nnz) @2858-3176, merge-path @4274/4310, merge-thread
@4122-4241 — plus child offsets (``get_begin_BMTs/BMWs_of_specific_parent_
after_blocking`` @1026/1352/2025), ``get_BMT/BMW_size_of_each_parent``
@1319/2211 and the ``..._relative_to_BMTB/BMW`` variants.  Each blocking
function emits, at the requested level:
  first_row_indices [n_blocks + 1]  absolute first row of each block
  first_nz_indices  [n_blocks + 1]  absolute first nz of each block
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


def _row_ptr(ms: MetaDataSet, sub: int) -> np.ndarray:
    rows, _, _ = ms.coo(sub)
    row_num = ms.row_num(sub)
    ptr = np.zeros(row_num + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr)


def _emit(ms: MetaDataSet, sub: int, level: Level, first_rows: np.ndarray,
          first_nzs: np.ndarray, step: str, **params) -> None:
    assert first_rows.size == first_nzs.size
    ms.add(level, "first_row_indices", sub, first_rows.astype(np.int64), replace=True)
    ms.add(level, "first_nz_indices", sub, first_nzs.astype(np.int64), replace=True)
    ms.add(level, "first_row_indices_without_ending", sub,
           first_rows[:-1].astype(np.int64), replace=True)
    ms.trace.record(
        step,
        [f"row_nz_row_indices_{sub}"],
        [f"{level.short_name}_first_row_indices_{sub}",
         f"{level.short_name}_first_nz_indices_{sub}"],
        **params,
    )


def block_fixed_interval_cols(ms: MetaDataSet, sub: int, level: Level,
                              col_interval: int) -> int:
    """Column-direction blocking: reorders the nz arrays by (column tile,
    row, column) so each tile's nz are contiguous, and emits at ``level``
    first_nz_indices [n_tiles + 1] and col_tile_indices [n_tiles] (every
    tile spans all rows).  Returns the tile count."""
    assert col_interval > 0
    rows, cols, vals = ms.coo(sub)
    col_num = ms.col_num(sub)
    n_tiles = max(-(-col_num // col_interval), 1)
    tile = cols // col_interval
    order = np.lexsort((cols, rows, tile))
    ms.set_coo(sub, rows[order], cols[order], vals[order])
    first_nzs = np.searchsorted(tile[order], np.arange(n_tiles + 1))
    first_rows = np.zeros(n_tiles + 1, dtype=np.int64)
    first_rows[-1] = ms.row_num(sub)
    ms.add(level, "col_tile_indices", sub,
           np.arange(n_tiles, dtype=np.int64) * col_interval, replace=True)
    _emit(ms, sub, level, first_rows, first_nzs,
          f"block_fixed_interval_cols[{level.block_name}]", col_interval=col_interval)
    return n_tiles


def block_fixed_interval_rows(
    ms: MetaDataSet, sub: int, level: Level, row_interval: int
) -> int:
    """Row-direction fixed-interval blocking: a block every ``row_interval``
    rows (reference: ..._after_fixed_blocking_in_row_direction).  Returns the
    block count."""
    assert row_interval > 0
    row_num = ms.row_num(sub)
    ptr = _row_ptr(ms, sub)
    n_blocks = max(-(-row_num // row_interval), 1)
    first_rows = np.minimum(np.arange(n_blocks + 1, dtype=np.int64) * row_interval, row_num)
    first_nzs = ptr[first_rows]
    _emit(ms, sub, level, first_rows, first_nzs,
          f"block_fixed_interval_rows[{level.block_name}]", row_interval=row_interval)
    return n_blocks


def block_balanced_nnz_rows(
    ms: MetaDataSet, sub: int, level: Level, nnz_per_block: int
) -> int:
    """Row-aligned nnz-balanced blocking: blocks hold ~``nnz_per_block`` nz
    but never split a row (reference: balanced_interval_*_operator via
    get_begin_*_after_balance_blocking, data_transform_common.hpp:46-56)."""
    assert nnz_per_block > 0
    ptr = _row_ptr(ms, sub)
    row_num = ms.row_num(sub)
    nnz = int(ptr[-1])
    n_blocks = max(-(-nnz // nnz_per_block), 1)
    targets = np.arange(1, n_blocks, dtype=np.int64) * nnz_per_block
    cut_rows = np.searchsorted(ptr, targets, side="left")
    # Blocks must advance at least one row each; enforce strict monotonicity.
    first_rows = np.concatenate(([0], cut_rows, [row_num]))
    first_rows = np.maximum.accumulate(first_rows)
    first_rows = np.unique(first_rows)
    if first_rows[-1] != row_num:
        first_rows = np.append(first_rows, row_num)
    first_nzs = ptr[first_rows]
    _emit(ms, sub, level, first_rows, first_nzs,
          f"block_balanced_nnz_rows[{level.block_name}]", nnz_per_block=nnz_per_block)
    return first_rows.size - 1


def block_fixed_nnz(
    ms: MetaDataSet, sub: int, level: Level, nnz_per_block: int
) -> int:
    """nnz-direction blocking: exactly ``nnz_per_block`` nz per block (last
    block ragged); rows may straddle blocks, so a bitmap/segment reduction is
    required downstream (reference: fixed_interval_nnz_direction_*_operator).

    ``first_row_indices[b]`` is the row containing the block's first nz."""
    assert nnz_per_block > 0
    rows, _, _ = ms.coo(sub)
    nnz = rows.size
    row_num = ms.row_num(sub)
    n_blocks = max(-(-nnz // nnz_per_block), 1)
    first_nzs = np.minimum(np.arange(n_blocks + 1, dtype=np.int64) * nnz_per_block, nnz)
    first_rows = np.empty(n_blocks + 1, dtype=np.int64)
    first_rows[:-1] = rows[np.minimum(first_nzs[:-1], max(nnz - 1, 0))] if nnz else 0
    first_rows[-1] = row_num
    _emit(ms, sub, level, first_rows, first_nzs,
          f"block_fixed_nnz[{level.block_name}]", nnz_per_block=nnz_per_block)
    return n_blocks


def block_merge_path(
    ms: MetaDataSet, sub: int, level: Level, work_per_block: int, row_weight: int = 1
) -> int:
    """Merge-path equal-work partition: work = nnz + row_weight * rows; cut
    every ``work_per_block`` along the merge path, row-aligned (reference:
    get_begin_{rows,nzs}_of_level_after_merge_path @4274/4310, algorithm
    transform_step/get_begin_rows_of_level_after_merge_path.cc:1-85)."""
    assert work_per_block > 0
    ptr = _row_ptr(ms, sub)
    row_num = ms.row_num(sub)
    # cumulative work after finishing row r: ptr[r] + row_weight * r
    work = ptr + row_weight * np.arange(row_num + 1, dtype=np.int64)
    total = int(work[-1])
    n_blocks = max(-(-total // work_per_block), 1)
    targets = np.arange(1, n_blocks, dtype=np.int64) * work_per_block
    cut_rows = np.searchsorted(work, targets, side="left")
    first_rows = np.concatenate(([0], cut_rows, [row_num]))
    first_rows = np.unique(np.maximum.accumulate(first_rows))
    if first_rows[-1] != row_num:
        first_rows = np.append(first_rows, row_num)
    first_nzs = ptr[first_rows]
    _emit(ms, sub, level, first_rows, first_nzs,
          f"block_merge_path[{level.block_name}]",
          work_per_block=work_per_block, row_weight=row_weight)
    return first_rows.size - 1


def add_relative_to_parent(ms: MetaDataSet, sub: int, child: Level, parent: Level) -> None:
    """Emit child's first_row/first_nz relative to the enclosing parent block
    (reference: ..._relative_to_BMTB/BMW variants)."""
    c_rows = ms.get(child, "first_row_indices", sub).astype(np.int64)
    c_nzs = ms.get(child, "first_nz_indices", sub).astype(np.int64)
    p_rows = ms.get(parent, "first_row_indices", sub).astype(np.int64)
    p_nzs = ms.get(parent, "first_nz_indices", sub).astype(np.int64)
    parent_of = np.searchsorted(p_nzs, c_nzs[:-1], side="right") - 1
    parent_of = np.clip(parent_of, 0, p_nzs.size - 2)
    suffix = f"relative_to_{parent.block_name}"
    ms.add(child, f"first_row_indices_{suffix}", sub,
           c_rows[:-1] - p_rows[parent_of], replace=True)
    ms.add(child, f"first_nz_indices_{suffix}", sub,
           c_nzs[:-1] - p_nzs[parent_of], replace=True)
    ms.trace.record(
        f"add_relative_to_parent[{child.block_name}->{parent.block_name}]",
        [f"{child.short_name}_first_nz_indices_{sub}",
         f"{parent.short_name}_first_nz_indices_{sub}"],
        [f"{child.short_name}_first_nz_indices_{suffix}_{sub}"],
    )


def add_child_offsets(ms: MetaDataSet, sub: int, parent: Level, child: Level) -> np.ndarray:
    """Emit parent-level ``first_<CHILD>_indices`` [n_parents + 1]: the first
    child block id inside each parent (reference:
    get_begin_BMTs/BMWs_of_specific_parent_after_blocking)."""
    c_nzs = ms.get(child, "first_nz_indices", sub).astype(np.int64)
    p_nzs = ms.get(parent, "first_nz_indices", sub).astype(np.int64)
    offs = np.searchsorted(c_nzs[:-1], p_nzs, side="left")
    offs[-1] = c_nzs.size - 1
    name = f"first_{child.block_name}_indices"
    ms.add(parent, name, sub, offs, replace=True)
    ms.trace.record(
        f"add_child_offsets[{parent.block_name}->{child.block_name}]",
        [f"{child.short_name}_first_nz_indices_{sub}",
         f"{parent.short_name}_first_nz_indices_{sub}"],
        [f"{parent.short_name}_{name}_{sub}"],
    )
    return offs


def add_block_sizes(ms: MetaDataSet, sub: int, parent: Level, child: Level) -> np.ndarray:
    """Emit parent-level ``<CHILD>_size_of_each_parent`` (reference:
    get_BMT/BMW_size_of_each_parent)."""
    name_in = f"first_{child.block_name}_indices"
    offs = ms.get(parent, name_in, sub).astype(np.int64)
    sizes = np.diff(offs)
    name = f"{child.block_name}_size_of_each_parent"
    ms.add(parent, name, sub, sizes, replace=True)
    ms.trace.record(
        f"add_block_sizes[{parent.block_name}->{child.block_name}]",
        [f"{parent.short_name}_{name_in}_{sub}"],
        [f"{parent.short_name}_{name}_{sub}"],
    )
    return sizes


def block_group_children(
    ms: MetaDataSet, sub: int, parent: Level, child: Level,
    children_per_parent: int
) -> int:
    """Form ``parent`` blocks by grouping every ``children_per_parent``
    consecutive ``child`` blocks (the reference's BMTB-over-BMWs nesting:
    get_begin_BMWs_of_BMTB_after_blocking — here derived bottom-up, which
    guarantees exact nesting of the boundaries)."""
    assert children_per_parent > 0
    c_rows = ms.get(child, "first_row_indices", sub).astype(np.int64)
    c_nzs = ms.get(child, "first_nz_indices", sub).astype(np.int64)
    idx = np.arange(0, c_nzs.size - 1, children_per_parent, dtype=np.int64)
    idx = np.append(idx, c_nzs.size - 1)
    _emit(ms, sub, parent, c_rows[idx], c_nzs[idx],
          f"block_group_children[{parent.block_name}<-{child.block_name}]",
          children_per_parent=children_per_parent)
    return idx.size - 1


def merge_adjacent_blocks(
    ms: MetaDataSet, sub: int, level: Level, max_nnz: int
) -> int:
    """Coalesce consecutive blocks while the combined nnz stays within
    ``max_nnz`` (reference merge-thread steps:
    get_begin_{rows,nzs}{,_relative_to_parent}_after_merge_thread @4122-4241,
    get_begin_BMTs_after_merge_thread @4242).  Rewrites the level's
    first_row/nz arrays in place; returns the merged block count."""
    assert max_nnz > 0
    first_rows = ms.get(level, "first_row_indices", sub)
    first_nzs = ms.get(level, "first_nz_indices", sub)
    keep = [0]
    base = first_nzs[0]
    for i in range(1, first_nzs.size - 1):
        if first_nzs[i + 1] - base > max_nnz:
            keep.append(i)
            base = first_nzs[i]
    keep.append(first_nzs.size - 1)
    idx = np.asarray(sorted(set(keep)), dtype=np.int64)
    _emit(ms, sub, level, first_rows[idx], first_nzs[idx],
          f"merge_adjacent_blocks[{level.block_name}]", max_nnz=max_nnz)
    return idx.size - 1
