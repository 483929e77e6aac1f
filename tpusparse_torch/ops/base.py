"""Operator base classes, context, and executor (counterpart of
``tpusparse/ops/base.py``).

Reference mapping:
  OPERATOR_STAGE (operator.hpp:16-23)        -> Stage
  basic_operator (operator.hpp:64-189)       -> BasicOperator with the dual
      validity gates and a transform-step sequence recorded per run
  operator_context (operator.hpp:191-265)    -> OperatorContext
  operator_executer::add_and_run
      (operator_executer.hpp:10-80)          -> OperatorExecutor.add_and_run
  padding delete-and-re-run
      (...thread_blocking_operator.cc:225-317) -> OperatorExecutor re-runs
      recorded DISTRIBUTING operators when an operator reports it dropped
      blocking metadata.
"""

from __future__ import annotations

import abc
import enum
from typing import Any

from tpusparse_torch.config import get_config
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import MetaDataSet


class Stage(enum.IntEnum):
    """Reference: CHOOSING_OP, CONVERTING_OP, DISTRIBUTING_OP, IMPLEMENTING_OP."""

    CHOOSING = 0
    CONVERTING = 1
    DISTRIBUTING = 2
    IMPLEMENTING = 3


class InvalidOperator(RuntimeError):
    """Raised when an operator's validity gates reject the current state."""


class BasicOperator(abc.ABC):
    stage: Stage = Stage.CONVERTING
    name: str = "basic"

    def __init__(self, sub_matrix_id: int = 0):
        self.sub_matrix_id = sub_matrix_id

    # -- validity gates -----------------------------------------------------
    def is_valid_according_to_metadata(self, ms: MetaDataSet) -> bool:
        """State preconditions (reference gate #1)."""
        return ms.has(Level.VAL, "nz_vals", self.sub_matrix_id)

    def is_valid_according_to_operator(self, ctx: "OperatorContext") -> bool:
        """Pipeline-order preconditions against the history (reference gate
        #2, e.g. 'no thread-blocking ran yet')."""
        return True

    @abc.abstractmethod
    def run(self, ms: MetaDataSet, ctx: "OperatorContext") -> None:
        ...

    # -- rollback protocol ---------------------------------------------------
    #: True if run() may drop parallel-level metadata (padding operators);
    #: the executor then re-runs the recorded distributing operators.
    invalidates_blocking: bool = False

    def describe(self) -> dict[str, Any]:
        skip = {"sub_matrix_id"}
        params = {k: v for k, v in vars(self).items() if k not in skip}
        return {"op": self.name, "stage": self.stage.name, "sub": self.sub_matrix_id, **params}

    def __repr__(self) -> str:
        return f"{type(self).__name__}(sub={self.sub_matrix_id})"


class OperatorContext:
    """Per-stage, per-sub-matrix operator history (reference operator_context)."""

    def __init__(self) -> None:
        self.history: list[BasicOperator] = []

    def ops(self, stage: Stage | None = None, sub: int | None = None) -> list[BasicOperator]:
        return [
            op
            for op in self.history
            if (stage is None or op.stage == stage)
            and (sub is None or op.sub_matrix_id == sub)
        ]

    def ran(self, op_type: type, sub: int | None = None) -> bool:
        return any(isinstance(op, op_type) for op in self.ops(sub=sub))

    def append(self, op: BasicOperator) -> None:
        self.history.append(op)

    def convert_to_string(self) -> str:
        return "\n".join(
            f"[{i}] {op.stage.name}: {op.describe()}" for i, op in enumerate(self.history)
        )


class OperatorExecutor:
    """Validates, runs, records; re-runs distributing operators after a
    blocking-invalidating operator (the reference's padding re-execution)."""

    def __init__(self, ms: MetaDataSet, check: bool | None = None):
        self.ms = ms
        self.ctx = OperatorContext()
        self.check = get_config().operator_runtime_check if check is None else check

    def add_and_run(self, op: BasicOperator) -> None:
        if not op.is_valid_according_to_metadata(self.ms):
            raise InvalidOperator(f"{op!r}: metadata preconditions not met")
        if not op.is_valid_according_to_operator(self.ctx):
            raise InvalidOperator(f"{op!r}: pipeline-order preconditions not met")
        former_distributing = self.ctx.ops(Stage.DISTRIBUTING, op.sub_matrix_id)
        op.run(self.ms, self.ctx)
        if op.invalidates_blocking and former_distributing:
            # reference: remove_item_of_metadata for all WARP/TBLOCK items,
            # then re-run the former distributing operators (the transforms
            # already dropped the levels; we re-run the operators).
            for former in former_distributing:
                former.run(self.ms, self.ctx)
        self.ctx.append(op)
        if self.check:
            self.ms.logical_check()
