"""Batched SpMM (counterpart of ``tpusparse/batched.py``, BASELINE.json
config #4): one sparse A applied to a batch of dense operands X[B, n, K].

The batch is folded into the dense K axis, so Y[b] = A . X[b] for every b
is one product over K' = B*K columns: one kernel launch, no extra format.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_batch(xb):
    """[B, n, k] -> [n, B*k] with batch-major column order (a tensor, or a
    numpy array that the SpMM moves to its format's device)."""
    b, n, k = xb.shape
    if isinstance(xb, torch.Tensor):
        return xb.permute(1, 0, 2).reshape(n, b * k)
    return np.transpose(np.asarray(xb), (1, 0, 2)).reshape(n, b * k)


def unfold_batch(y: torch.Tensor, b: int) -> torch.Tensor:
    """[m, B*k] -> [B, m, k]."""
    m = y.shape[0]
    return y.reshape(m, b, y.shape[1] // b).permute(1, 0, 2)


def batched_spmm(spmm_fn, xb) -> torch.Tensor:
    """Apply ``spmm_fn: [n, K'] -> [m, K']`` to a batch X[B, n, k]."""
    return unfold_batch(spmm_fn(fold_batch(xb)), xb.shape[0])
