"""Plans (counterpart of ``tpusparse/generator.py:23-59``).

A plan is the packed format plus a Python callable that runs the kernel on
it; ``build_plan`` in ``tpusparse_torch.schedule`` makes one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class SpmmPlan:
    """A ready-to-run SpMM: ``plan(x)`` computes A @ x."""

    fn: Callable[[Any], Any]
    formats: list[Any]
    shape: tuple[int, int]
    meta: dict

    def __call__(self, x):
        return self.fn(x)

    def cost_summary(self, k: int | None = None) -> dict:
        """Static cost introspection: format bytes, padding, and the
        per-call useful-FLOP count (the reference prints the same quantities
        around its timing loop, code_generator.cc:589-648)."""
        fmt_bytes = int(self.meta.get("format_bytes", 0))
        nnz_real = 0
        for f in self.formats:
            mb = getattr(f, "memory_bytes", 0)
            fmt_bytes += mb() if callable(mb) else mb
            nnz_real += getattr(f, "nnz_real", getattr(f, "nnz", 0))
        out = {
            "schedule": self.meta.get("schedule"),
            "format_bytes": int(fmt_bytes),
            "padding_rate": self.meta.get("padding_rate"),
            "n_sub_plans": self.meta.get("n_subs", 1),
            "shape": list(self.shape),
        }
        if nnz_real:
            out["nnz"] = int(nnz_real)
        if k is not None and nnz_real:
            out["useful_gflop_per_call"] = 2.0 * nnz_real * k / 1e9
        return out
