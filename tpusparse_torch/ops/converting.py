"""Converting-stage operators: global format preparation (counterpart of
``tpusparse/ops/converting.py``).

Reference operators covered (operator.hpp decl lines / operator/*.cc):
  sort_operator @268, col_based_sort_operator @1026,
  fixed_interval_row_matrix_div_operator @289, row_nz_matrix_div_operator
  @319, empty_row_pad_operator @449, interlance_storage_operator @567,
  calculation_method_choose_operator @1004.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet
from tpusparse_torch.ops.base import BasicOperator, OperatorContext, Stage
from tpusparse_torch import transforms as T


class SortOperator(BasicOperator):
    """Reorder rows by nnz length or column pattern; trims trailing empties
    (reference sort_operator: 5 transform steps)."""

    stage = Stage.CONVERTING
    name = "sort"

    def __init__(self, sub_matrix_id: int = 0, by: str = "length", descending: bool = True):
        super().__init__(sub_matrix_id)
        assert by in ("length", "col")
        self.by = by
        self.descending = descending

    def is_valid_according_to_operator(self, ctx: OperatorContext) -> bool:
        # reference: sorting after any blocking would invalidate blockings
        return not ctx.ops(Stage.DISTRIBUTING, self.sub_matrix_id)

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        if self.by == "length":
            T.get_row_order_by_length(ms, self.sub_matrix_id, self.descending)
        else:
            T.get_row_order_by_col(ms, self.sub_matrix_id)
        T.reorder_by_row_order(ms, self.sub_matrix_id)
        T.remove_empty_rows_in_end(ms, self.sub_matrix_id)


class FixedIntervalRowMatrixDivOperator(BasicOperator):
    stage = Stage.CONVERTING
    name = "fixed_row_div"

    def __init__(self, sub_matrix_id: int = 0, row_interval: int = 4096):
        super().__init__(sub_matrix_id)
        self.row_interval = row_interval
        self.new_sub_ids: list[int] = []

    def is_valid_according_to_operator(self, ctx: OperatorContext) -> bool:
        return not ctx.ops(Stage.DISTRIBUTING, self.sub_matrix_id)

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        self.new_sub_ids = T.fixed_div_by_rows(ms, self.sub_matrix_id, self.row_interval)


class RowNnzMatrixDivOperator(BasicOperator):
    """Bucket rows by nnz range into sub-matrices (reference:
    row_nz_matrix_div_operator with bounds init_bound * expansion_rate^i)."""

    stage = Stage.CONVERTING
    name = "row_nnz_div"

    def __init__(self, sub_matrix_id: int = 0, bounds: tuple = (32, 256)):
        super().__init__(sub_matrix_id)
        self.bounds = tuple(bounds)
        self.new_sub_ids: list[int] = []

    def is_valid_according_to_operator(self, ctx: OperatorContext) -> bool:
        return not ctx.ops(Stage.DISTRIBUTING, self.sub_matrix_id)

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        self.new_sub_ids = T.div_by_row_nnz(ms, self.sub_matrix_id, list(self.bounds))


class EmptyRowPadOperator(BasicOperator):
    stage = Stage.CONVERTING
    name = "empty_row_pad"
    invalidates_blocking = True

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.pad_empty_rows(ms, self.sub_matrix_id)


class RowPadToMultipleOperator(BasicOperator):
    """Pad each row's nnz to a multiple (reference col-pad-to-multiple)."""

    stage = Stage.CONVERTING
    name = "row_pad_multiple"
    invalidates_blocking = True

    def __init__(self, sub_matrix_id: int = 0, multiple: int = 8):
        super().__init__(sub_matrix_id)
        self.multiple = multiple

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.pad_row_nnz_to_multiple(ms, self.sub_matrix_id, self.multiple)


class InterleaveStorageOperator(BasicOperator):
    """Position-major nz storage within blocks (reference
    interlance_storage_operator; also sets the interleave flag the packers
    and logical_check consult)."""

    stage = Stage.CONVERTING
    name = "interleave"

    def __init__(self, sub_matrix_id: int = 0, level=Level.TBLOCK):
        super().__init__(sub_matrix_id)
        self.level = level

    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        return super().is_valid_according_to_metadata(ms) and ms.has(
            self.level, "first_nz_indices", self.sub_matrix_id
        )

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        T.interleave_storage(ms, self.sub_matrix_id, self.level)


class CalculationMethodChooseOperator(BasicOperator):
    """Writes the scalar ``calculation_method`` metadata — the semiring /
    graph-algorithm hook (reference calculation_method_choose_operator)."""

    stage = Stage.CHOOSING
    name = "calculation_method"

    METHODS = {"plus_times": 0, "min_plus": 1, "or_and": 2, "graph": 3}

    def __init__(self, sub_matrix_id: int = 0, method: str = "plus_times"):
        super().__init__(sub_matrix_id)
        assert method in self.METHODS
        self.method = method

    def run(self, ms: MetaDataSet, ctx: OperatorContext) -> None:
        ms.add(
            Level.GLOBAL, "calculation_method", self.sub_matrix_id,
            np.int64(self.METHODS[self.method]), replace=True,
        )
