"""Synthetic matrix builders (counterpart of ``tpusparse/io/builder.py``).

For the same arguments and seed each builder returns arrays equal to the
JAX package's, so both packages can be fed one matrix from one seed:

  uniform_coo    -> the reference's dataset_builder (uniform nnz per row)
  power_law_coo  -> SuiteSparse/graph-like skewed row lengths (IG5-18 class)
  banded_coo     -> PDE/banded scientific matrices (strong column locality)
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.io.mtx import CooMatrix


def _finish(rows, cols, vals, shape) -> CooMatrix:
    return CooMatrix(rows, cols, vals, shape).sort_row_major().dedup()


def uniform_coo(m: int, n: int, nnz_per_row: int, seed: int = 0) -> CooMatrix:
    """Uniform nnz per row at random columns (reference dataset_builder)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n, size=m * nnz_per_row, dtype=np.int64)
    vals = rng.standard_normal(m * nnz_per_row)
    return _finish(rows, cols, vals, (m, n))


def power_law_coo(
    m: int,
    n: int,
    avg_nnz_per_row: float,
    alpha: float = 1.8,
    max_row: int | None = None,
    seed: int = 0,
) -> CooMatrix:
    """Skewed (Zipf-ish) row-length distribution, like web/graph matrices."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    if max_row is None:
        max_row = max(int(avg_nnz_per_row * 64), 64)
    raw = np.minimum(raw, max_row)
    lengths = np.maximum((raw * (avg_nnz_per_row * m / raw.sum())).astype(np.int64), 0)
    lengths = np.minimum(lengths, n)
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    cols = rng.integers(0, n, size=int(lengths.sum()), dtype=np.int64)
    vals = rng.standard_normal(rows.size)
    return _finish(rows, cols, vals, (m, n))


def banded_coo(m: int, n: int, bandwidth: int, fill: float = 0.6, seed: int = 0) -> CooMatrix:
    """Banded matrix: nnz clustered within +-bandwidth of the diagonal."""
    rng = np.random.default_rng(seed)
    per_row = max(int(bandwidth * fill), 1)
    rows = np.repeat(np.arange(m, dtype=np.int64), per_row)
    centers = (rows * n) // max(m, 1)
    offs = rng.integers(-bandwidth, bandwidth + 1, size=rows.size)
    cols = np.clip(centers + offs, 0, n - 1).astype(np.int64)
    vals = rng.standard_normal(rows.size)
    return _finish(rows, cols, vals, (m, n))
