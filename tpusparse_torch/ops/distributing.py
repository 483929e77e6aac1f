"""Distributing-stage operators: hierarchy blocking (counterpart of
``tpusparse/ops/distributing.py``).

Reference operators covered: fixed_interval_{row,col}_direction_{tblock,warp,
thread}_blocking_operator, balanced_interval_row_direction_*_operator,
fixed_interval_nnz_direction_*_operator, merge_path_{tblock,warp,thread}_
operator (operator.hpp @356-1297), plus the relative-index and child-offset
emission options those operators carry.  ``level`` is a parameter: the
three reference levels share one implementation.
"""

from __future__ import annotations

from tpusparse_torch import transforms as T
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet
from tpusparse_torch.ops.base import BasicOperator, OperatorContext, Stage


class _BlockingOperator(BasicOperator):
    stage = Stage.DISTRIBUTING

    def __init__(self, sub_matrix_id: int = 0, level: Level = Level.TBLOCK):
        super().__init__(sub_matrix_id)
        self.level = level

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        if not super().is_valid_according_to_metadata(ms):
            return False
        # a level may only be blocked once (until a rollback removes it), and
        # parent levels must be blocked before their children (reference
        # pipeline-order checks)
        if ms.has(self.level, "first_nz_indices", self.sub_matrix_id):
            return False
        parent = self.level.parent()
        if parent is not None and any(
            ms.has(lv, "first_nz_indices", self.sub_matrix_id)
            for lv in (Level.WARP, Level.THREAD)
            if lv > self.level
        ):
            return False
        return True

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        if ms.has(self.level, "first_nz_indices", self.sub_matrix_id):
            return  # a re-run after rollback is already satisfied
        self._block(ms)

    def _block(self, ms: MetaDataSet) -> None:
        raise NotImplementedError


class FixedIntervalColBlockingOperator(_BlockingOperator):
    name = "fixed_col_blocking"

    def __init__(self, sub_matrix_id=0, level=Level.TBLOCK, col_interval: int = 512):
        super().__init__(sub_matrix_id, level)
        self.col_interval = col_interval

    def _block(self, ms: MetaDataSet) -> None:
        T.block_fixed_interval_cols(ms, self.sub_matrix_id, self.level, self.col_interval)


class FixedIntervalRowBlockingOperator(_BlockingOperator):
    name = "fixed_row_blocking"

    def __init__(self, sub_matrix_id=0, level=Level.TBLOCK, row_interval: int = 256):
        super().__init__(sub_matrix_id, level)
        self.row_interval = row_interval

    def _block(self, ms: MetaDataSet) -> None:
        T.block_fixed_interval_rows(ms, self.sub_matrix_id, self.level, self.row_interval)


class BalancedNnzRowBlockingOperator(_BlockingOperator):
    name = "balanced_nnz_blocking"

    def __init__(self, sub_matrix_id=0, level=Level.TBLOCK, nnz_per_block: int = 1024):
        super().__init__(sub_matrix_id, level)
        self.nnz_per_block = nnz_per_block

    def _block(self, ms: MetaDataSet) -> None:
        T.block_balanced_nnz_rows(ms, self.sub_matrix_id, self.level, self.nnz_per_block)


class FixedNnzBlockingOperator(_BlockingOperator):
    """nnz-direction blocking: rows may straddle blocks; requires a segment /
    bitmap reduce downstream (reference fixed_interval_nnz_direction_*)."""

    name = "fixed_nnz_blocking"

    def __init__(self, sub_matrix_id=0, level=Level.TBLOCK, nnz_per_block: int = 1024,
                 pad_nnz: bool = True):
        super().__init__(sub_matrix_id, level)
        self.nnz_per_block = nnz_per_block
        self.pad_nnz = pad_nnz

    def _block(self, ms: MetaDataSet) -> None:
        if self.pad_nnz:
            T.pad_nnz_to_multiple(ms, self.sub_matrix_id, self.nnz_per_block)
        T.block_fixed_nnz(ms, self.sub_matrix_id, self.level, self.nnz_per_block)


class MergePathBlockingOperator(_BlockingOperator):
    name = "merge_path_blocking"

    def __init__(self, sub_matrix_id=0, level=Level.TBLOCK, work_per_block: int = 1024,
                 row_weight: int = 1):
        super().__init__(sub_matrix_id, level)
        self.work_per_block = work_per_block
        self.row_weight = row_weight

    def _block(self, ms: MetaDataSet) -> None:
        T.block_merge_path(
            ms, self.sub_matrix_id, self.level, self.work_per_block, self.row_weight
        )


class RelativeIndexOperator(BasicOperator):
    """Emit child-relative boundary arrays (reference ..._relative_to_BMTB/BMW
    step options)."""

    stage = Stage.DISTRIBUTING
    name = "relative_index"

    def __init__(self, sub_matrix_id=0, child: Level = Level.THREAD, parent: Level = Level.TBLOCK):
        super().__init__(sub_matrix_id)
        self.child = child
        self.parent = parent

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return (
            super().is_valid_according_to_metadata(ms)
            and ms.has(self.child, "first_nz_indices", self.sub_matrix_id)
            and ms.has(self.parent, "first_nz_indices", self.sub_matrix_id)
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        if not ms.has(self.parent, f"first_{self.child.block_name}_indices", self.sub_matrix_id):
            T.add_child_offsets(ms, self.sub_matrix_id, self.parent, self.child)
        T.add_relative_to_parent(ms, self.sub_matrix_id, self.child, self.parent)


class ChildOffsetsOperator(BasicOperator):
    """Emit first_<CHILD>_indices + sizes at the parent level."""

    stage = Stage.DISTRIBUTING
    name = "child_offsets"

    def __init__(self, sub_matrix_id=0, parent: Level = Level.TBLOCK, child: Level = Level.THREAD):
        super().__init__(sub_matrix_id)
        self.parent = parent
        self.child = child

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return (
            super().is_valid_according_to_metadata(ms)
            and ms.has(self.child, "first_nz_indices", self.sub_matrix_id)
            and ms.has(self.parent, "first_nz_indices", self.sub_matrix_id)
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.add_child_offsets(ms, self.sub_matrix_id, self.parent, self.child)
        T.add_block_sizes(ms, self.sub_matrix_id, self.parent, self.child)


class GroupChildrenBlockingOperator(BasicOperator):
    """Form parent blocks by grouping consecutive child blocks (the
    reference's BMTB-over-BMW nesting, derived bottom-up so the boundaries
    nest exactly)."""

    stage = Stage.DISTRIBUTING
    name = "group_children_blocking"

    def __init__(self, sub_matrix_id=0, parent: Level = Level.TBLOCK,
                 child: Level = Level.WARP, children_per_parent: int = 8):
        super().__init__(sub_matrix_id)
        self.parent = parent
        self.child = child
        self.children_per_parent = children_per_parent

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return super().is_valid_according_to_metadata(ms) and ms.has(
            self.child, "first_nz_indices", self.sub_matrix_id
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.block_group_children(ms, self.sub_matrix_id, self.parent,
                               self.child, self.children_per_parent)


class MergeAdjacentBlocksOperator(BasicOperator):
    """Coalesce consecutive blocks under an nnz budget (reference
    merge-thread steps, get_begin_*_after_merge_thread)."""

    stage = Stage.DISTRIBUTING
    name = "merge_adjacent_blocks"

    def __init__(self, sub_matrix_id=0, level: Level = Level.WARP,
                 max_nnz: int = 1024):
        super().__init__(sub_matrix_id)
        self.level = level
        self.max_nnz = max_nnz

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return super().is_valid_according_to_metadata(ms) and ms.has(
            self.level, "first_nz_indices", self.sub_matrix_id
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.merge_adjacent_blocks(ms, self.sub_matrix_id, self.level, self.max_nnz)
