"""Distributing-stage operators: hierarchy blocking (counterpart of
``tpusparse/ops/distributing.py``).

Ported so far: the shared blocking base and the column-direction blocking
operator (reference fixed_interval_col_direction_*_blocking_operator,
operator.hpp @727), which ``span_colsplit`` runs.  ``level`` is a
parameter: the three reference levels share one implementation.
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
