from tpusparse_torch.ops.base import (
    BasicOperator,
    InvalidOperator,
    OperatorContext,
    OperatorExecutor,
    Stage,
)
from tpusparse_torch.ops.distributing import FixedIntervalColBlockingOperator
from tpusparse_torch.ops.implementing import GridBlockOperator, TileOneHotImplementOperator

__all__ = [
    "BasicOperator",
    "InvalidOperator",
    "OperatorContext",
    "OperatorExecutor",
    "Stage",
    "FixedIntervalColBlockingOperator",
    "GridBlockOperator",
    "TileOneHotImplementOperator",
]
