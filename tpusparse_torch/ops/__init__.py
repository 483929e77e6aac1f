from tpusparse_torch.ops.base import (
    BasicOperator,
    InvalidOperator,
    OperatorContext,
    OperatorExecutor,
    Stage,
)
from tpusparse_torch.ops.implementing import GridBlockOperator

__all__ = [
    "BasicOperator",
    "InvalidOperator",
    "OperatorContext",
    "OperatorExecutor",
    "Stage",
    "GridBlockOperator",
]
