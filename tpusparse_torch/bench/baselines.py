"""Library yardsticks for SpMM (counterpart of ``tpusparse/bench/baselines.py``).

The reference benchmarks cuSPARSE CSR SpMM as its baseline
(baseline/base_cusparse/spmm.cu).  On the card:

  dense_spmm_fn    cuBLAS's dense product of the densified matrix (what a
                   user does while the matrix fits), fp32 with TF32 off as
                   the JAX package's ``Precision.HIGHEST``, or bf16 with an
                   fp32 result
  csr_spmm_fn      cuSPARSE's CSR SpMM through ``torch.sparse.mm`` (the JAX
                   package's BCOO product)
  segment_spmm_fn  a gather of X's rows and an ``index_add_`` into Y's rows:
                   the best formulation without a kernel of its own (the
                   JAX package's take + segment_sum)

These are yardsticks, not ports of a kernel.  Each returns ``fn(x) -> Y``
with X [N, K] as numpy or a float tensor on ``device``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import matmul_f32, prep_x, resolve_device


@contextlib.contextmanager
def _fp32_highest():
    """fp32 products in full fp32 inside the block (TF32 off), whatever the
    caller set, and the caller's setting back after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def dense_spmm_fn(mat: CooMatrix, dtype=torch.float32, *, device="cuda"):
    """Y = dense(A) @ X: fp32 (TF32 off) or bf16 operands, an fp32 Y."""
    dev = resolve_device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: torch.float32 or torch.bfloat16")
    a = torch.as_tensor(mat.to_dense(np.float32), device=dev).to(dtype)

    def fn(x):
        x = prep_x(x, dev).to(dtype)
        with _fp32_highest():
            return matmul_f32(a, x)

    return fn


def csr_spmm_fn(mat: CooMatrix, *, device="cuda"):
    """Y = A @ X by cuSPARSE (``torch.sparse.mm`` of A's CSR tensor), fp32."""
    dev = resolve_device(device)
    csr = mat.to_csr_tensor(device=dev)

    def fn(x):
        return torch.sparse.mm(csr, prep_x(x, dev))

    return fn


def segment_spmm_fn(mat: CooMatrix, *, device="cuda"):
    """Y = A @ X as vals * X[cols] added into Y's rows by ``index_add_``, fp32."""
    dev = resolve_device(device)
    rows = torch.as_tensor(mat.rows, device=dev)
    cols = torch.as_tensor(mat.cols, device=dev)
    vals = torch.as_tensor(np.asarray(mat.vals, np.float32), device=dev)
    m = mat.shape[0]

    def fn(x):
        x = prep_x(x, dev)
        contrib = vals[:, None] * x.index_select(0, cols)
        return torch.zeros((m, x.shape[1]), dtype=torch.float32, device=dev).index_add_(
            0, rows, contrib)

    return fn
