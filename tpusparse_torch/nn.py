"""Sparse layers for pruned-weight serving (counterpart of
``tpusparse/nn.py``).

``SparseLinear`` computes ``y = x @ W^T + b`` with a sparse ``W [out,
in]``: the leading dims of x fold into the dense K axis of one SpMM
``Y = W @ X`` with ``X = x^T [in, K]``.  It is a ``torch.nn.Module`` whose
packed format's tensors and bias are buffers.

Constructors:
  SparseLinear.from_coo(mat)         unstructured sparse W (CooMatrix)
  SparseLinear.from_dense(w)         prune-by-zeros dense W
  SparseLinear.from_nm(w, n, m)      N:M structured W (compact kernel, or the
                                     dense product in ``mode="throughput"``)
  SparseLinear.from_block(mat, bs)   block-sparse W (Block-ELL)

``from_coo`` and ``from_block`` with ``differentiable=True`` give layers
whose input gradient runs the transposed plan (A^T's own default schedule,
or A^T's Block-ELL format).  ``TrainableSparseLinear`` trains the values
of a fixed pattern: its value plane and bias are ``nn.Parameter``s, and its
gradients run the SDDMM kernel pair (kernels/sddmm.py).  The JAX package's
``flax_sparse_linear`` has no counterpart of its own here:
``TrainableSparseLinear`` is the PyTorch module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import matmul_f32, prep_x, resolve_device


def _tensors_of(fmt) -> dict:
    """The tensor fields of a packed format (its arrays on the device)."""
    return {f.name: getattr(fmt, f.name) for f in dataclasses.fields(fmt)
            if isinstance(getattr(fmt, f.name), torch.Tensor)}


def _fold(x, in_features: int, device) -> tuple[torch.Tensor, tuple]:
    """x [..., in] as X [in, K] (the leading dims folded into K) and the
    leading dims."""
    x = x if isinstance(x, torch.Tensor) else prep_x(x, device)
    assert x.shape[-1] == in_features, f"last dim {x.shape[-1]} != in_features {in_features}"
    return x.reshape(-1, in_features).T, x.shape[:-1]


class SparseLinear(torch.nn.Module):
    """y[..., out] = x[..., in] @ W^T + b with sparse W.  The format's
    tensors (``fmt0_vals``, ...) and ``bias`` are buffers, so ``state_dict`` holds
    the packed weight; ``apply_fn`` maps X [in, K] to Y [out, K].  Only
    layers built with ``differentiable=True`` pass gradients to x."""

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
        takes the small-K defaults.  ``differentiable=True`` adds A^T's plan
        (``autodiff.spmm_fn``) as the backward."""
        from tpusparse_torch.schedule import build_plan, default_schedule

        m, n = mat.shape
        if differentiable:
            from tpusparse_torch.autodiff import spmm_fn

            fn = spmm_fn(mat, schedule, k_hint=k_hint, device=device)
            return cls(fn, m, n, bias=bias, formats=[*fn.plan.formats, *fn.t_plan.formats],
                       device=device, meta={"kind": "coo+vjp"})
        if schedule is None:
            schedule = default_schedule(mat, k_hint)
        plan = build_plan(mat, schedule, device=device)
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
        method, the kernel; ``precision='int8'`` quantizes W per row and X per column,
        W8A8 on the kernel's integer product).  ``differentiable=True``
        runs the backward on A^T's Block-ELL format (a transposed
        block-sparse matrix is block-sparse with transposed blocks); int8
        weights serve only."""
        from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell

        if precision == "int8":
            assert not differentiable, "int8 block weights are a serving path; train in bf16/fp32"
        dt = {"int8": torch.int8, "bf16": torch.bfloat16}.get(precision, torch.float32)
        fmt = pack_block_ell(mat, bs=bs, dtype=dt, device=device)
        formats = [fmt]

        def fn(x):
            return block_ell_spmm(fmt, x, precision=precision)

        if differentiable:
            fmt_t = pack_block_ell(mat.transpose().sort_row_major(), bs=bs, dtype=dt,
                                   device=device)
            formats.append(fmt_t)

            class _Block(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x):
                    return block_ell_spmm(fmt, x, precision=precision)

                @staticmethod
                def backward(ctx, dy):
                    return block_ell_spmm(fmt_t, dy, precision=precision)

            fn = _Block.apply

        m, n = mat.shape
        return cls(fn, m, n, bias=bias, formats=formats, device=device,
                   meta={"kind": f"block_{bs}"})

    def forward(self, x) -> torch.Tensor:
        xk, lead = _fold(x, self.in_features, self.device)
        y = self._apply_fn(xk.contiguous()).T                  # [K, out]
        y = y.reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias
        return y


class TrainableSparseLinear(torch.nn.Module):
    """Fixed-pattern, trainable-values sparse layer: y[..., out] =
    x[..., in] @ W^T + b with W's pattern frozen as pruning left it and its
    values trained.  The values live in the span format's packed [P, NC, G]
    plane (``vals``, an ``nn.Parameter`` beside ``bias``), so an optimizer
    step touches device tensors only, with no repacking; the gradients run
    the SDDMM kernel pair (kernels/sddmm.py).

        layer = TrainableSparseLinear(w_coo)
        y = layer(x)                        # any leading batch dims
        loss.backward()                     # layer.vals.grad via the SDDMM kernel

    The JAX package's ``init()`` and ``apply(params, x)`` are the module's
    parameters and ``forward``; its ``flax_sparse_linear`` is this module
    too.  ``export_vals()`` gives the trained values in COO order;
    ``trainable_state_from_numpy`` loads the JAX layer's parameters."""

    def __init__(self, mat: CooMatrix, *, bias: bool = True, rb: int = 512, ct: int = 512,
                 g: int = 128, precision: str = "fp32x2", device="cuda"):
        from tpusparse_torch.autodiff import spmm_trainable

        super().__init__()
        self._fn, v0 = spmm_trainable(mat, rb=rb, ct=ct, g=g, precision=precision,
                                      device=device)
        self.device = v0.device
        self.out_features, self.in_features = mat.shape
        self.vals = torch.nn.Parameter(v0)
        self.bias = (torch.nn.Parameter(torch.zeros(self.out_features, device=self.device))
                     if bias else None)

    @property
    def fmt(self):
        return self._fn.fmt

    def forward(self, x) -> torch.Tensor:
        xk, lead = _fold(x, self.in_features, self.device)
        y = self._fn(self.vals, xk).T                          # [K, out]
        y = y.reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias
        return y

    def export_vals(self) -> torch.Tensor:
        """Trained values in the original COO nz order (checkpointing)."""
        from tpusparse_torch.kernels.sddmm import packed_to_nz

        return packed_to_nz(self.fmt, self.vals.detach())


def trainable_state_from_numpy(params: dict) -> dict:
    """A ``state_dict`` for ``TrainableSparseLinear.load_state_dict`` from
    the JAX layer's parameters as numpy arrays (``{"vals": [P, NC, G],
    "bias": [out]}``, bias optional); the layers must share the pattern
    and the packing geometry."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in params.items()}

