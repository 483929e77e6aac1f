"""Implementing-stage operators (counterpart of
``tpusparse/ops/implementing.py``).

Ported so far: the launch-geometry operator, which every ported family
runs, and the reduction-style operator that selects the ``tile_onehot``
kernel.  The other reduction-style and padding operators arrive with the
families that use them.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet
from tpusparse_torch.ops.base import BasicOperator, OperatorContext, Stage


class _ReduceOperator(BasicOperator):
    stage = Stage.IMPLEMENTING

    def __init__(self, sub_matrix_id=0, level: Level = Level.TBLOCK):
        super().__init__(sub_matrix_id)
        self.level = level

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return super().is_valid_according_to_metadata(ms) and ms.has(
            self.level, "first_nz_indices", self.sub_matrix_id
        )

    def _set_style(self, ms: MetaDataSet, style: int) -> None:
        ms.add(Level.GLOBAL, "reduce_style", self.sub_matrix_id, np.int64(style), replace=True)


class TileOneHotImplementOperator(_ReduceOperator):
    """Selects the tile kernel; carries its static parameters."""

    name = "tile_onehot"
    STYLE = 2

    def __init__(self, sub_matrix_id=0, rb: int = 1024, ct: int = 1024, g: int = 512,
                 precision: str = "fp32x2", unroll: int = 4):
        super().__init__(sub_matrix_id, Level.TBLOCK)
        self.rb = rb
        self.ct = ct
        self.g = g
        self.precision = precision
        self.unroll = unroll

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        # the tile packer does its own blocking; only the sub must exist
        return BasicOperator.is_valid_according_to_metadata(self, ms)

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        self._set_style(ms, self.STYLE)


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
