"""Synthetic matrix builders (counterpart of ``tpusparse/io/builder.py``).

For the same arguments and seed each builder returns arrays equal to the
JAX package's, so both packages can be fed one matrix from one seed:

  uniform_coo       -> the reference's dataset_builder (uniform nnz per row)
  power_law_coo     -> SuiteSparse/graph-like skewed row lengths (IG5-18 class)
  power_law_col_coo -> skewed column popularity (web-graph class; hybrid_cols)
  banded_coo        -> PDE/banded scientific matrices (strong column locality)
  pruned_weight_coo -> unstructured magnitude-pruned weight (FlashLLM class)
  nm_pruned_dense   -> N:M (e.g. 2:4) structured pruning of a dense weight
  block_sparse_coo  -> block-sparse (BSR-style) pattern for the dense-tile path
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


def power_law_col_coo(
    m: int,
    n: int,
    avg_nnz_per_row: float,
    alpha: float = 1.6,
    seed: int = 0,
) -> CooMatrix:
    """Skewed (Zipf-ish) column popularity with uniform rows: a few hot
    columns, scattered by a permutation, carry most of the nonzeros."""
    rng = np.random.default_rng(seed)
    nnz = int(avg_nnz_per_row * m)
    pop = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    pop /= pop.sum()
    perm = rng.permutation(n)
    cols = perm[rng.choice(n, size=nnz, p=pop)]
    rows = rng.integers(0, m, size=nnz, dtype=np.int64)
    vals = rng.standard_normal(nnz)
    return _finish(rows, cols.astype(np.int64), vals, (m, n))


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


def pruned_weight_coo(m: int, n: int, sparsity: float = 0.9, seed: int = 0) -> CooMatrix:
    """Unstructured magnitude-pruned weight matrix: keep the largest
    (1-sparsity) fraction of a Gaussian weight."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, n)).astype(np.float32)
    k = int(round(m * n * (1.0 - sparsity)))
    if k <= 0:
        return CooMatrix(np.empty(0, np.int64), np.empty(0, np.int64),
                         np.empty(0, np.float32), (m, n))
    thresh = np.partition(np.abs(w).ravel(), m * n - k)[m * n - k]
    rows, cols = np.nonzero(np.abs(w) >= thresh)
    return CooMatrix(rows.astype(np.int64), cols.astype(np.int64), w[rows, cols], (m, n))


def nm_pruned_dense(m: int, k: int, n_keep: int = 2, group: int = 4, seed: int = 0) -> np.ndarray:
    """Dense weight [m, k] pruned to N:M structure along k: in every
    contiguous group of ``group`` columns only the ``n_keep`` largest
    magnitudes stay.  Returned dense (with zeros) for format packing."""
    assert k % group == 0
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, k)).astype(np.float32)
    wg = w.reshape(m, k // group, group)
    order = np.argsort(-np.abs(wg), axis=2)
    keep = np.zeros_like(wg, dtype=bool)
    np.put_along_axis(keep, order[:, :, :n_keep], True, axis=2)
    return (wg * keep).reshape(m, k)


def block_sparse_coo(m: int, n: int, block: int = 128, block_density: float = 0.1,
                     seed: int = 0) -> CooMatrix:
    """Dense ``block`` x ``block`` blocks placed with probability
    ``block_density`` (MegaBlocks/BSR class)."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-m // block), -(-n // block)
    active = rng.random((mb, nb)) < block_density
    br, bc = np.nonzero(active)
    rows_l, cols_l, vals_l = [], [], []
    base = np.arange(block)
    for r0, c0 in zip(br * block, bc * block):
        rr = np.repeat(base + r0, block)
        cc = np.tile(base + c0, block)
        ok = (rr < m) & (cc < n)
        rows_l.append(rr[ok])
        cols_l.append(cc[ok])
        vals_l.append(rng.standard_normal(int(ok.sum())))
    if not rows_l:
        return CooMatrix(np.empty(0, np.int64), np.empty(0, np.int64),
                         np.empty(0, np.float64), (m, n))
    return _finish(np.concatenate(rows_l).astype(np.int64),
                   np.concatenate(cols_l).astype(np.int64), np.concatenate(vals_l), (m, n))
