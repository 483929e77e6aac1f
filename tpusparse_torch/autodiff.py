"""Differentiable SpMM (counterpart of ``tpusparse/autodiff.py``).

For Y = A @ X with A a constant sparse matrix, the X-gradient is
dX = A^T @ dY: another SpMM, with the transpose's format.  ``spmm_fn``
builds both plans through the same schedule machinery (A is [M, N], A^T is
[N, M], each with its own default) and wires them into a
``torch.autograd.Function``, so the backward runs a packed kernel.
``spmm_trainable`` makes the values trainable too: the forward is the span
kernel, the backward the SDDMM pair of ``kernels/sddmm.py``.
"""

from __future__ import annotations

import torch

from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import prep_x, resolve_device


def spmm_fn(mat: CooMatrix, schedule=None, t_schedule=None, *, k_hint: int | None = None,
            device="cuda"):
    """A differentiable ``fn(x) -> A @ x`` (a tensor on ``device``).

    ``schedule`` / ``t_schedule``: optional explicit Schedules for the
    forward (A) and backward (A^T) plans; the defaults take the default
    schedule for ``k_hint`` (the expected dense width; both plans are built
    before the first call, so without a hint the default must stream X).
    ``fn.plan`` and ``fn.t_plan`` are the two plans."""
    from tpusparse_torch.schedule import build_plan, default_schedule

    if t_schedule is None:
        # mirror an explicit user schedule; default independently (A and A^T
        # have swapped shapes, so the size gates can differ)
        t_schedule = (schedule if schedule is not None
                      else default_schedule(mat.transpose(), k_hint))
    if schedule is None:
        schedule = default_schedule(mat, k_hint)
    dev = resolve_device(device)
    fwd_plan = build_plan(mat, schedule, device=dev)
    bwd_plan = build_plan(mat.transpose().sort_row_major(), t_schedule, device=dev)

    class _Spmm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fwd_plan(x)

        @staticmethod
        def backward(ctx, dy):
            return bwd_plan(dy)

    def fn(x):
        return _Spmm.apply(x if isinstance(x, torch.Tensor) else prep_x(x, dev))

    fn.plan, fn.t_plan = fwd_plan, bwd_plan
    return fn


def spmm_trainable(mat: CooMatrix, *, rb: int = 512, ct: int = 512, g: int = 128,
                   precision: str = "fp32x2", k_hint: int | None = None,
                   vmem_budget: int = 4 * 2**20, device="cuda"):
    """Trainable-values SpMM: ``fn(v, x) -> A(v) @ x``, differentiable in
    both arguments over a fixed sparsity pattern (pruned-weight
    fine-tuning).

    Returns ``(fn, v0)``: ``v0`` [P, NC, G] float32 on ``device`` is the
    packed value plane holding ``mat.vals`` (the parameter to train).
    ``vmem_budget`` is deprecated: it sized the JAX package's K-tile to
    the TPU's VMEM (``tpusparse/autodiff.py::_auto_ktile``), which refused
    in_features past 131,072 at the default; it is accepted, for the JAX
    signature, and changes nothing here, where the K-tile follows x as in
    ``span_spmm``, so no width is refused.
    Gradients:

      dv = SDDMM(pattern; dY, X)   (kernels/sddmm.span_sddmm, masked)
      dX = A(v)^T @ dY             (kernels/sddmm.span_dx, over the same
                                    format: v never needs a transposed pack)

    ``fn.fmt`` is the format; ``kernels.sddmm.packed_to_nz(fn.fmt, v)``
    exports values in COO order."""
    from tpusparse_torch.kernels import sddmm as _sddmm
    from tpusparse_torch.kernels.span_gather import pack_span, span_spmm

    del k_hint, vmem_budget  # the K-tile follows x at call time, as in span_spmm
    fmt = pack_span(mat, rb=rb, ct=ct, g=g, keep_perm=True, device=device)
    dev = fmt.device
    mask = torch.from_numpy(_sddmm.occupancy_mask(fmt)).to(dev)
    inv_slot = torch.from_numpy(_sddmm.origrow_of_slot(fmt)).to(dev, torch.long)
    v0 = fmt.vals.float().clone()

    class _Trainable(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v, x):
            ctx.save_for_backward(v, x)
            return span_spmm(fmt, x, precision=precision, vals=v * mask)

        @staticmethod
        def backward(ctx, dy):
            v, x = ctx.saved_tensors
            # dY rows into slot order once; both gradient kernels read slots
            dy_slots = _sddmm.rows_to_slots(prep_x(dy, dev), inv_slot)
            dv = dx = None
            if ctx.needs_input_grad[0]:
                dv = _sddmm.span_sddmm(fmt, dy_slots, x, precision=precision) * mask
            if ctx.needs_input_grad[1]:
                dx = _sddmm.span_dx(fmt, v * mask, dy_slots, precision=precision)
            return dv, dx

    def fn(v, x):
        return _Trainable.apply(v, x if isinstance(x, torch.Tensor) else prep_x(x, dev))

    fn.fmt = fmt
    return fn, v0
