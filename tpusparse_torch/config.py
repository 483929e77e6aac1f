"""Typed configuration (counterpart of ``tpusparse/config.py``).

One process-global dataclass with a context-manager override, as in the
JAX package.  The TPU-only fields (lane and sublane counts, the VMEM limit)
are dropped; the plausibility guards are re-derived for the H100 below, and
the cache directory is the port's own, so the port never reads a schedule
that the JAX tuner cached.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Iterator


@dataclasses.dataclass
class Config:
    # Transform / schedule bounds
    padding_rate_up_bound: float = 4.0  # reject schedules that pad > 4x nnz
    operator_runtime_check: bool = True

    # Semiring / graph hooks (reference config stubs: Semiring, Graph_Algorithm)
    performance_flag: str = "throughput"  # 'throughput' | 'latency' | 'graph'
    semiring: str = "plus_times"          # 'plus_times' | 'min_plus' | 'or_and'
    graph_algorithm: str = "none"         # 'none' | 'bfs' | 'pr' | 'cc'
    graph_max_iter: int = 100

    # Tuner
    float_rate: float = 2.0             # FLOPs per (nnz, dense col): mul+add
    # Plausibility guard (reference GFLOPS_UP_BOUND, executor.cc:51-55).
    # Counted sparse-equivalent FLOPs never exceed executed FLOPs, so no
    # row can honestly beat the card's fastest arithmetic that this package
    # could use: the H100 SXM's dense bf16 tensor-core peak, 989 TFLOP/s
    # (no mode here computes in fp8 or int8, whose 1,979 would be next).
    gflops_up_bound: float = 9.89e5
    # A call issues at least two kernels (the output zero-fill and the
    # gather kernel); the card does not start kernels in one stream faster
    # than about one per microsecond, so a call timed under 2 us is a
    # measurement artifact, not a result.
    seconds_floor: float = 2.0e-6
    cache_dir: str = os.path.join(os.path.expanduser("~"), ".cache", "tpusparse_torch")

    # Numeric tolerances (reference: rel 1e-2 half; we add strict fp32)
    tol_fp32: float = 1.0e-5
    tol_bf16: float = 1.0e-2

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)


_GLOBAL = Config()


def get_config() -> Config:
    """Current process-global config (immutable snapshot semantics)."""
    return _GLOBAL


def set_config(**kwargs: Any) -> Config:
    """Update the process-global config in place; returns the new config."""
    global _GLOBAL
    _GLOBAL = _GLOBAL.replace(**kwargs)
    return _GLOBAL


@contextlib.contextmanager
def config_override(**kwargs: Any) -> Iterator[Config]:
    """Scoped config override (the tuner's replacement for the reference's
    mid-run global_config.json rewrites)."""
    global _GLOBAL
    saved = _GLOBAL
    _GLOBAL = _GLOBAL.replace(**kwargs)
    try:
        yield _GLOBAL
    finally:
        _GLOBAL = saved
