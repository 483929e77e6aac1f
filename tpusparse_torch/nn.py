"""Sparse layers for pruned-weight serving (counterpart of
``tpusparse/nn.py``).

``SparseLinear`` computes ``y = x @ W^T + b`` with a sparse ``W [out,
in]``: the leading dims of x fold into the dense K axis of one SpMM
``Y = W @ X`` with ``X = x^T [in, K]``.  It is a ``torch.nn.Module`` whose
packed format's tensors and bias are buffers, inference only.

Constructors:
  SparseLinear.from_coo(mat)         unstructured sparse W (CooMatrix)
  SparseLinear.from_dense(w)         prune-by-zeros dense W
  SparseLinear.from_nm(w, n, m)      N:M structured W (compact kernel, or the
                                     dense product in ``mode="throughput"``)
  SparseLinear.from_block(mat, bs)   block-sparse W (Block-ELL)

A differentiable layer (``differentiable=True``) needs the transposed plans
and the SDDMM kernels of the training slice (ROADMAP.md A.9) and raises
until then; ``TrainableSparseLinear`` comes with that slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import matmul_f32, prep_x, resolve_device


def _training_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpusparse_torch yet: it needs the "
                               "SDDMM kernels and autodiff of ROADMAP.md A.9")


def _tensors_of(fmt) -> dict:
    """The tensor fields of a packed format (its arrays on the device)."""
    return {f.name: getattr(fmt, f.name) for f in dataclasses.fields(fmt)
            if isinstance(getattr(fmt, f.name), torch.Tensor)}


class SparseLinear(torch.nn.Module):
    """y[..., out] = x[..., in] @ W^T + b with sparse W.  The format's
    tensors (``fmt0_vals``, ...) and ``bias`` are buffers, so ``state_dict`` holds
    the packed weight; ``apply_fn`` maps X [in, K] to Y [out, K]."""

    def __init__(self, apply_fn, out_features: int, in_features: int, *, bias=None,
                 meta: dict | None = None, formats=(), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._apply_fn = apply_fn
        self.out_features = out_features
        self.in_features = in_features
        self.meta = meta or {}
        self.device = dev
        for i, fmt in enumerate(formats):
            for name, t in _tensors_of(fmt).items():
                self.register_buffer(f"fmt{i}_{name}", t, persistent=True)
        self.register_buffer("bias", None if bias is None else
                             torch.as_tensor(np.asarray(bias), dtype=torch.float32, device=dev))

    @classmethod
    def from_coo(cls, mat: CooMatrix, *, schedule=None, bias=None,
                 differentiable: bool = False, k_hint: int | None = None,
                 device="cuda") -> "SparseLinear":
        """``k_hint``: the expected folded batch width (serving batch x
        sequence).  The plan is built before the first call, so without a
        hint the default streams X (``tile_onehot``); a small-K hint
        takes the small-K defaults."""
        from tpusparse_torch.schedule import build_plan, default_schedule

        if differentiable:
            raise _training_not_ported("SparseLinear.from_coo(differentiable=True)")
        if schedule is None:
            schedule = default_schedule(mat, k_hint)
        plan = build_plan(mat, schedule, device=device)
        m, n = mat.shape
        return cls(plan.fn, m, n, bias=bias, formats=plan.formats, device=device,
                   meta={"kind": "coo", "schedule": plan.meta["schedule"]})

    @classmethod
    def from_dense(cls, w, **kwargs) -> "SparseLinear":
        return cls.from_coo(CooMatrix.from_dense(np.asarray(w)), **kwargs)

    @classmethod
    def from_nm(cls, w, *, n_keep: int = 2, group: int = 4, precision: str = "bf16",
                bias=None, mode: str = "compact", device="cuda") -> "SparseLinear":
        """N:M structured weight.  ``mode='compact'``: the packed N:M kernel
        (bf16 values and int8 offsets, 0.625x the dense bf16 bytes at 2:4;
        ``precision='int8'`` stores W8A16 values for 0.375x).
        ``mode='throughput'``: the dense weight in bf16 (fp32 for
        ``precision='fp32'``) and the dense product with an fp32 result, at
        the dense weight's size."""
        from tpusparse_torch.kernels.nm_structured import nm_spmm, pack_nm

        dev = resolve_device(device)
        w = np.asarray(w)
        m, n = w.shape
        if mode == "throughput":
            dt = torch.float32 if precision == "fp32" else torch.bfloat16
            a = torch.as_tensor(w, dtype=torch.float32).to(dev, dt)

            def mm(x):
                return matmul_f32(a, prep_x(x, dev).to(dt))

            layer = cls(mm, m, n, bias=bias, device=dev,
                        meta={"kind": f"nm_{n_keep}_{group}:throughput"})
            layer.register_buffer("weight", a)
            return layer
        fmt = pack_nm(w, n_keep=n_keep, group=group, device=dev,
                      dtype={"int8": torch.int8, "fp32": torch.float32}.get(precision,
                                                                          torch.bfloat16))

        def fn(x):
            return nm_spmm(fmt, x, precision=precision)

        return cls(fn, m, n, bias=bias, formats=[fmt], device=dev,
                   meta={"kind": f"nm_{n_keep}_{group}", "precision": precision})

    @classmethod
    def from_block(cls, mat: CooMatrix, *, bs: int = 128, precision: str = "bf16",
                   bias=None, differentiable: bool = False, device="cuda") -> "SparseLinear":
        """Block-sparse weight in Block-ELL (``block_ell_spmm``'s default
        method; ``precision='int8'`` quantizes W per row and X per column,
        W8A8 on the kernel's integer product)."""
        from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell

        if differentiable:
            raise _training_not_ported("SparseLinear.from_block(differentiable=True)")
        dt = {"int8": torch.int8, "bf16": torch.bfloat16}.get(precision, torch.float32)
        fmt = pack_block_ell(mat, bs=bs, dtype=dt, device=device)

        def fn(x):
            return block_ell_spmm(fmt, x, precision=precision)

        m, n = mat.shape
        return cls(fn, m, n, bias=bias, formats=[fmt], device=device,
                   meta={"kind": f"block_{bs}"})

    def forward(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else prep_x(x, self.device)
        lead = x.shape[:-1]
        assert x.shape[-1] == self.in_features, (
            f"last dim {x.shape[-1]} != in_features {self.in_features}")
        xk = x.reshape(-1, self.in_features).T.contiguous()  # [in, K]
        y = self._apply_fn(xk).T                               # [K, out]
        y = y.reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias
        return y

