"""Hierarchical blocking transforms (counterpart of
``tpusparse/transforms/block.py``).

Ported so far: the column-direction blocking (reference
``..._after_fixed_blocking_in_col_direction``, data_transform_step.hpp
@2057-2301) and the emission helper every blocking function shares.  Each
blocking function emits, at the requested level:
  first_row_indices [n_blocks + 1]  absolute first row of each block
  first_nz_indices  [n_blocks + 1]  absolute first nz of each block
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


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
