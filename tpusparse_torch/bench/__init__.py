"""Benchmark tools (counterpart of ``tpusparse/bench``).

The library yardsticks ``dense_spmm_fn`` (cuBLAS), ``csr_spmm_fn``
(cuSPARSE) and ``segment_spmm_fn`` (``index_add_``) are the port's
counterparts of the JAX package's ``dense_spmm_fn``, ``bcoo_spmm_fn`` and
``xla_segment_spmm_fn``; the timers and ``measured_stream_bandwidth_gbs``
run on the card.
"""

from tpusparse_torch.bench.baselines import csr_spmm_fn, dense_spmm_fn, segment_spmm_fn
from tpusparse_torch.bench.harness import (
    device_time_fn,
    gflops,
    measured_stream_bandwidth_gbs,
    time_fn,
    time_fn_host,
)

__all__ = ["dense_spmm_fn", "csr_spmm_fn", "segment_spmm_fn", "time_fn", "time_fn_host",
           "device_time_fn", "gflops", "measured_stream_bandwidth_gbs"]
