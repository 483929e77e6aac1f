"""Implementing-stage operators (counterpart of
``tpusparse/ops/implementing.py``).

Only the launch-geometry operator is ported: it is the one operator the
``dg_span`` branch of the plan builder runs.  The reduction-style and
padding operators arrive with the families that use them.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet
from tpusparse_torch.ops.base import BasicOperator, OperatorContext, Stage


class GridBlockOperator(BasicOperator):
    """Launch geometry: K tiling and coarsening (reference grid_block_operator
    computes grid/block dims from K; here the grid is derived from the
    blocking, so this only pins the K tile / unroll)."""

    stage = Stage.IMPLEMENTING
    name = "grid_block"

    def __init__(self, sub_matrix_id=0, ktile: int | None = None, unroll: int = 8):
        super().__init__(sub_matrix_id)
        self.ktile = ktile
        self.unroll = unroll

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        if self.ktile is not None:
            ms.add(Level.GLOBAL, "ktile", self.sub_matrix_id, np.int64(self.ktile), replace=True)
        ms.add(Level.GLOBAL, "k_unroll", self.sub_matrix_id, np.int64(self.unroll), replace=True)
