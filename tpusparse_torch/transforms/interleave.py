"""Interleaved (ELL column-major) storage (counterpart of
``tpusparse/transforms/interleave.py``).

Reference steps covered: modify_{row,col,vals}_indices_by_interlance_storage
@1597-1693 — transpose nz storage within each parent block so consecutive
execution lanes read consecutive addresses.  The ``brick_ell`` family packs
nonzeros in this stored order.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


def interleave_storage(ms: MetaDataSet, sub: int, level: Level) -> None:
    """Reorder nz storage within each ``level`` block from row-major to
    position-major.  Requires uniform row length inside each block
    (run :func:`~tpusparse.transforms.pad.pad_block_rows_to_max` first and
    re-block).  Sets GLOBAL ``interleaved`` = 1 so logical_check skips the
    row-major assertion."""
    first_rows = ms.get(level, "first_row_indices", sub).astype(np.int64)
    first_nzs = ms.get(level, "first_nz_indices", sub).astype(np.int64)
    rows, cols, vals = ms.coo(sub)
    n_blocks = first_nzs.size - 1
    perm = np.empty(rows.size, dtype=np.int64)
    for b in range(n_blocks):
        lo, hi = first_nzs[b], first_nzs[b + 1]
        nrows = int(first_rows[b + 1] - first_rows[b])
        size = int(hi - lo)
        if size == 0:
            continue
        if nrows <= 1 or size % nrows != 0:
            perm[lo:hi] = np.arange(lo, hi)
            continue
        L = size // nrows
        # row-major [nrows, L] -> position-major [L, nrows]
        idx = np.arange(size).reshape(nrows, L).T.ravel()
        perm[lo:hi] = lo + idx
    ms.set_coo(sub, rows[perm], cols[perm], vals[perm])
    ms.add(Level.GLOBAL, "interleaved", sub, np.int64(1), replace=True)
    ms.trace.record(
        f"interleave_storage[{level.block_name}]",
        [f"{level.short_name}_first_nz_indices_{sub}"],
        [f"row_nz_row_indices_{sub}", f"col_nz_col_indices_{sub}", f"val_nz_vals_{sub}"],
    )
