"""Bitmap / segment transforms for split-row reductions (counterpart of
``tpusparse/transforms/segment.py``).

Reference steps covered: thread_bit_map @3945 (row-start bit per nz,
transform_step/thread_bit_map.cc:16-60), parent_bit_map_of_thread @3974,
segment_ptr @4061, segment_offset @4091.

When nnz-direction blocking splits rows across blocks, each block produces
per-(block, row) partial sums and one combine pass adds them into Y (the
JAX package's segment-sum; ``index_add_`` here).  These arrays drive the
packer's segment ids and the combine.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


def thread_bit_map(ms: MetaDataSet, sub: int, level: Level = Level.THREAD) -> np.ndarray:
    """Bit per nz: 1 where a new row starts *within its block* (the block's
    first nz is always a row start)."""
    rows, _, _ = ms.coo(sub)
    first_nzs = ms.get(level, "first_nz_indices", sub).astype(np.int64)
    bm = np.zeros(rows.size, dtype=np.int8)
    if rows.size:
        bm[0] = 1
        bm[1:] = (rows[1:] != rows[:-1]).astype(np.int8)
        starts = first_nzs[:-1]
        bm[starts[starts < rows.size]] = 1
    ms.add(level, "bit_map_of_thread", sub, bm, replace=True)
    ms.trace.record(
        f"thread_bit_map[{level.block_name}]",
        [f"row_nz_row_indices_{sub}", f"{level.short_name}_first_nz_indices_{sub}"],
        [f"{level.short_name}_bit_map_of_thread_{sub}"],
    )
    return bm


def parent_bit_map_of_thread(
    ms: MetaDataSet, sub: int, child: Level, parent: Level
) -> np.ndarray:
    """Bit per child block: 1 if the child block's first row differs from the
    previous child block's last row within the same parent (i.e. the child
    starts a fresh row segment; reference parent_bit_map_of_thread)."""
    rows, _, _ = ms.coo(sub)
    c_nzs = ms.get(child, "first_nz_indices", sub).astype(np.int64)
    p_nzs = ms.get(parent, "first_nz_indices", sub).astype(np.int64)
    n_child = c_nzs.size - 1
    bm = np.zeros(n_child, dtype=np.int8)
    for b in range(n_child):
        lo = c_nzs[b]
        if lo >= rows.size:
            continue
        if b == 0 or lo in p_nzs[:-1]:
            bm[b] = 1
        else:
            prev_last = c_nzs[b] - 1
            bm[b] = 1 if rows[lo] != rows[prev_last] else 0
    ms.add(child, "parent_bit_map_of_thread", sub, bm, replace=True)
    ms.trace.record(
        f"parent_bit_map_of_thread[{child.block_name}->{parent.block_name}]",
        [f"{child.short_name}_first_nz_indices_{sub}"],
        [f"{child.short_name}_parent_bit_map_of_thread_{sub}"],
    )
    return bm


def segment_ptr(ms: MetaDataSet, sub: int, level: Level) -> np.ndarray:
    """Per block: index of its first row segment among all (block, row)
    segments, [n_blocks + 1].  A segment is a maximal run of one row's nz
    inside one block; total segments = sum over blocks of rows touched."""
    rows, _, _ = ms.coo(sub)
    first_nzs = ms.get(level, "first_nz_indices", sub).astype(np.int64)
    bm = (
        ms.get(level, "bit_map_of_thread", sub)
        if ms.has(level, "bit_map_of_thread", sub)
        else thread_bit_map(ms, sub, level)
    )
    seg_count_prefix = np.concatenate(([0], np.cumsum(bm.astype(np.int64))))
    ptr = seg_count_prefix[np.minimum(first_nzs, rows.size)]
    ms.add(level, "segment_ptr", sub, ptr, replace=True)
    ms.trace.record(
        f"segment_ptr[{level.block_name}]",
        [f"{level.short_name}_bit_map_of_thread_{sub}"],
        [f"{level.short_name}_segment_ptr_{sub}"],
    )
    return ptr


def segment_offset(ms: MetaDataSet, sub: int, level: Level) -> np.ndarray:
    """Per segment: the destination row of that (block, row) partial sum —
    what the combine pass scatters into (reference segment_offset +
    segment_empty_row handling collapsed: we store actual row ids)."""
    rows, _, _ = ms.coo(sub)
    bm = ms.get(level, "bit_map_of_thread", sub)
    seg_rows = rows[bm.astype(bool)]
    ms.add(level, "segment_row_indices", sub, seg_rows.astype(np.int64), replace=True)
    ms.trace.record(
        f"segment_offset[{level.block_name}]",
        [f"{level.short_name}_bit_map_of_thread_{sub}", f"row_nz_row_indices_{sub}"],
        [f"{level.short_name}_segment_row_indices_{sub}"],
    )
    return seg_rows
