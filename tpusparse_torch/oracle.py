"""Correctness oracle (counterpart of ``tpusparse/oracle.py``).

The reference's generated programs recompute the product on the host
(``spmm_reference_host``) and compare with relative tolerance 1e-2
(cuda_code/kernel_lib.hpp:859-921).  These stay numpy: they are the host
oracle that every device result is held against.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch.config import get_config
from tpusparse_torch.io.mtx import CooMatrix


def spmm_reference(mat: CooMatrix, x: np.ndarray, semiring: str = "plus_times") -> np.ndarray:
    """Y[M, K] = A[M, N] . X[N, K] on the host (or y[M] = A . x[N]), under
    the semiring: plus_times (*, +), min_plus (+, min; an empty row is
    +inf) or or_and (&, |; boolean)."""
    m, n = mat.shape
    assert x.shape[0] == n, f"X rows {x.shape[0]} != A cols {n}"
    vals = mat.vals[:, None] if x.ndim == 2 else mat.vals
    if semiring == "plus_times":
        y = np.zeros((m,) + x.shape[1:], dtype=np.result_type(mat.vals.dtype, x.dtype))
        np.add.at(y, mat.rows, vals * x[mat.cols])
        return y
    if semiring == "min_plus":
        y = np.full((m,) + x.shape[1:], np.inf, dtype=np.result_type(mat.vals.dtype, x.dtype))
        np.minimum.at(y, mat.rows, vals + x[mat.cols])
        return y
    if semiring == "or_and":
        y = np.zeros((m,) + x.shape[1:], dtype=bool)
        np.logical_or.at(y, mat.rows, vals.astype(bool) & x[mat.cols].astype(bool))
        return y
    raise ValueError(f"unknown semiring: {semiring}")


def spmv_reference(mat: CooMatrix, x: np.ndarray) -> np.ndarray:
    """y[M] = A[M, N] . x[N] on the host."""
    assert x.ndim == 1
    return spmm_reference(mat, x)


def spgemm_reference(a: CooMatrix, b: CooMatrix) -> CooMatrix:
    """C = A . B, both sparse, via scipy (host oracle only)."""
    import scipy.sparse as sp

    sa = sp.coo_matrix((a.vals, (a.rows, a.cols)), shape=a.shape).tocsr()
    sb = sp.coo_matrix((b.vals, (b.rows, b.cols)), shape=b.shape).tocsr()
    sc = (sa @ sb).tocoo()
    return CooMatrix(sc.row.astype(np.int64), sc.col.astype(np.int64), sc.data,
                     sc.shape).sort_row_major()


def batched_spmm_reference(mat: CooMatrix, x: np.ndarray) -> np.ndarray:
    """Y[B, M, K] = A . X[B, N, K] (shared sparsity across the batch)."""
    assert x.ndim == 3
    return np.stack([spmm_reference(mat, x[b]) for b in range(x.shape[0])])


def tolerance_for(dtype) -> float:
    cfg = get_config()
    dt = np.dtype(dtype) if dtype != "bfloat16" else None
    if dtype == "bfloat16" or (dt is not None and dt.itemsize <= 2):
        return cfg.tol_bf16
    return cfg.tol_fp32


def check_result(
    got: np.ndarray,
    want: np.ndarray,
    *,
    rtol: float | None = None,
    dtype=None,
    scale: np.ndarray | None = None,
    what: str = "result",
) -> None:
    """Relative-error check (reference: check_result, kernel_lib.hpp:885-921).

    Uses max(|want|, 1) as the denominator like the reference, so zero rows
    don't blow up.  ``scale`` (same shape as ``want``) optionally raises the
    denominator to a condition-aware bound — pass |A|·|x| so low-precision
    storage is judged by the numerically attainable error eps·Σ|terms|
    rather than pure relative error, which no rounded method can meet on
    cancellation-heavy outputs.  Raises AssertionError on failure.
    """
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    if rtol is None:
        rtol = tolerance_for(dtype if dtype is not None else np.float32)
    denom = np.maximum(np.abs(want), 1.0)
    if scale is not None:
        denom = np.maximum(denom, np.asarray(scale, dtype=np.float64))
    rel = np.abs(got - want) / denom
    bad = rel > rtol
    if bad.any():
        idx = np.unravel_index(int(np.argmax(rel)), rel.shape)
        raise AssertionError(
            f"{what}: {int(bad.sum())}/{rel.size} elements exceed rtol {rtol}; "
            f"worst rel err {rel.max():.3e} at {idx} (got {got[idx]:.6g}, want {want[idx]:.6g})"
        )
