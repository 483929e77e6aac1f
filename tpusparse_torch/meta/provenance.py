"""Transform provenance tracing.

The reference records, for every data-transform step, which metadata items
were read and which were created/rewritten (``data_item_record`` +
``transform_step_record_item``; reference: data_transform_step.hpp:176-245,
operator.hpp:33-59) and can print the aggregated history
(token_test.cc:871-876), plus an optional global step table
(data_transform_graph.{hpp,cc}).

Here: a simple append-only trace of records kept on the MetaDataSet,
printable for observability.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class DataItemRecord:
    """One step's provenance: the step name, source keys, dest keys."""

    step: str
    sources: list[str]
    dests: list[str]
    params: dict[str, Any] = dataclasses.field(default_factory=dict)


class TransformTrace:
    """Append-only provenance trace (the reference's transform history +
    transform graph, collapsed into one structure)."""

    def __init__(self) -> None:
        self.records: list[DataItemRecord] = []

    def record(self, step: str, sources: list[str], dests: list[str], **params: Any) -> None:
        self.records.append(DataItemRecord(step, list(sources), list(dests), dict(params)))

    def convert_to_string(self) -> str:
        """Human-readable dump (reference: convert_to_string)."""
        lines = []
        for i, r in enumerate(self.records):
            p = f" {r.params}" if r.params else ""
            lines.append(f"[{i}] {r.step}: {', '.join(r.sources)} -> {', '.join(r.dests)}{p}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self.records)
