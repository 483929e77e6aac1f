"""Implementing-stage operators (counterpart of
``tpusparse/ops/implementing.py``).

Reference operators covered: thread_total_reduce_operator @1070, the
bit-map and segment operators @1093-1209 (one ``SegmentReduceOperator``),
grid_block_operator @1047, and the padding that equalizes a blocking
(uniform nnz per block, ELL rows per block).  The reduce style selects the
kernel family: total reduce (rows owned by one block) the stripe kernels,
segment reduce (rows straddle blocks) the segment path with its combine,
``TileOneHotImplementOperator`` the tile kernel.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch import transforms as T
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet
from tpusparse_torch.ops.base import BasicOperator, OperatorContext, Stage
from tpusparse_torch.ops.distributing import FixedNnzBlockingOperator


class UniformBlockPadOperator(BasicOperator):
    """Equalize per-block nnz: the stripe formats hold one nnz count C per
    block (implementing-stage pad; keeps the blocking it equalizes)."""

    stage = Stage.IMPLEMENTING
    name = "uniform_block_pad"

    def __init__(self, sub_matrix_id=0, level: Level = Level.TBLOCK, multiple_of: int = 8):
        super().__init__(sub_matrix_id)
        self.level = level
        self.multiple_of = multiple_of

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return super().is_valid_according_to_metadata(ms) and ms.has(
            self.level, "first_nz_indices", self.sub_matrix_id
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.pad_blocks_to_uniform_nnz(ms, self.sub_matrix_id, self.level, self.multiple_of)


class EllBlockPadOperator(BasicOperator):
    """ELL padding: every row of each block padded to the block max
    (reference col_pad_parent_blk_to_max_row_size options on the thread
    blocking operator).  Invalidates blocking -> executor re-runs it."""

    stage = Stage.IMPLEMENTING
    name = "ell_block_pad"
    invalidates_blocking = True

    def __init__(self, sub_matrix_id=0, level: Level = Level.TBLOCK, count_empty_rows=True):
        super().__init__(sub_matrix_id)
        self.level = level
        self.count_empty_rows = count_empty_rows

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return super().is_valid_according_to_metadata(ms) and ms.has(
            self.level, "first_row_indices", self.sub_matrix_id
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.pad_block_rows_to_max(ms, self.sub_matrix_id, self.level, self.count_empty_rows)


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


class ThreadTotalReduceOperator(_ReduceOperator):
    """Rows owned per block -> direct slot store (reference
    *_total_reduce_operator family -> total_*_reduce_to_one_register tokens).
    Requires row-aligned blocking (row-direction / balanced / merge-path)."""

    name = "total_reduce"
    STYLE = 0

    def is_valid_according_to_operator(self, ctx: OperatorContext) -> bool:
        return not ctx.ran(FixedNnzBlockingOperator, self.sub_matrix_id)

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        self._set_style(ms, self.STYLE)


class SegmentReduceOperator(_ReduceOperator):
    """Rows straddle blocks -> bitmap/segment arrays + combine pass
    (reference thread/warp/tblock bit-map & segment operators ->
    two-register/bitmap/segment-scan reduction tokens; the combine pass that
    adds the per-(block, row) partials into Y replaces their atomicAdd)."""

    name = "segment_reduce"
    STYLE = 1

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.thread_bit_map(ms, self.sub_matrix_id, self.level)
        T.segment_ptr(ms, self.sub_matrix_id, self.level)
        T.segment_offset(ms, self.sub_matrix_id, self.level)
        self._set_style(ms, self.STYLE)


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
