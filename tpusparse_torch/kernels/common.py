"""Shared kernel utilities (counterpart of ``tpusparse/kernels/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default and there is
    no quiet fallback: asking for CUDA without a card raises.  Only a caller
    that passes ``device="cpu"`` gets the plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: 'cuda' or 'cpu'")
    return dev


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_dense_rows(x: torch.Tensor, target_rows: int) -> torch.Tensor:
    """Zero-pad the leading dim of X (dense operand) to ``target_rows``."""
    if x.shape[0] == target_rows:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, target_rows - x.shape[0]])


def pad_dense_cols(x: torch.Tensor, target_cols: int) -> torch.Tensor:
    """Zero-pad the last dim of X to ``target_cols``."""
    if x.shape[-1] == target_cols:
        return x
    return F.pad(x, [0, target_cols - x.shape[-1]])
