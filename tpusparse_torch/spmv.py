"""SpMV: y[M] = A . x[N] (counterpart of ``tpusparse/spmv.py``).

Methods, decision for decision as in the JAX package:

  'dg'       the one-column row walk kernel (``dg1_rows_cuda``) over the
             row walk of a kt = 1 dg format, rb = 4096, ns = 4.
  'dgt8'     the dgt kernel at kt = 8 (``dgt_rows_cuda``) on x zero-padded
             to 8 columns, rb from ``auto_rb_dgt``, at any width (the JAX
             package refuses N * 32 bytes past 9 MB, its VMEM residency for
             X; the card's walk stages no X).
  'span'     the span kernel (``span_rows_cuda``) at kt = 1, x as one
             column through the one-column walk kernel, at the first of
             the tuner's span points (the JAX package widens x to 8
             columns, the TPU's 8-sublane minimum: the same Y).
  'radix'    the radix kernel at kt = 1 (``radix_rows_cuda``), rb = 2048,
             S = 128, g = 1024.
  'stripe'   the stripe kernel (``stripe_rows_cuda``) through
             ``build_stripe_plan`` (work 1024, unroll 8) on x as one
             column (the JAX package widens it to 8 for the TPU's
             8-sublane minimum, a rule the card does not have: the same Y,
             one float4 of X a slot).
  'segment'  plain torch: ``index_add_`` of vals * x[cols] over rows.  The
             JAX version is XLA code, no Pallas kernel, so no kernel here.
  'auto'     'dg' where ``takes_dg``: on the card's record
             (``CARD_GATES``, the default) at any N, on the TPU's where x
             fits 6 MB (N*4 bytes, the JAX package's gate); else
             'segment'.

``spmv_multi_fn`` fuses m <= 8 independent SpMVs into one K = m dgt call;
on the TPU's record with the JAX package's column split for large N, on
the card's in one format at any N.  The size gates ('auto', the column
split, dg's window) are read from ``gates`` (``tpusparse_torch.gates``):
the card's walks read x through L2 at any N (PERF.md, "Gates").  Every
entry point runs on ``device`` ("cuda" by default; no card raises unless
``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.gates import CARD_GATES, Gates, dg_ns
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import cdiv, resolve_device

def _as_x(x, dev: torch.device) -> torch.Tensor:
    """x as an fp32 tensor on ``dev``; a tensor on another device is
    refused rather than moved."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"x is on {x.device}, the matrix on {dev}")
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


#: X a column range of ``spmv_multi_fn``'s split holds on the TPU's record
#: (the JAX package's, from its compile limits on the v5e)
MULTI_RANGE_BYTES = 8 * 1024 * 1024


def takes_dg(n: int, gates: Gates = CARD_GATES) -> bool:
    """Whether an SpMV of x of ``n`` fp32 takes the dg SpMV plan
    (``spmv_fn('auto')``, ``graph.matvec_plan``) under ``gates``, rather
    than a segment reduction: where x passes ``gates.dg_x_bytes``."""
    return gates.dg_x_bytes is None or n * 4 <= gates.dg_x_bytes


def pack_dg_spmv(mat: CooMatrix, *, device, gates: Gates = CARD_GATES):
    """The kt = 1 dg format of the SpMV plans (``spmv_fn('dg')``,
    ``graph.matvec_plan``): rb 4096 (a multiple of 64 below it), 4 window
    tiles of 1024 columns (spanning x where ``gates.dg_ns`` widens them), g
    2048 past 1M nonzeros else 512."""
    from tpusparse_torch.kernels.dg_gather import pack_dg

    m, n = mat.shape
    rb = 4096 if m >= 4096 else max(64, 64 * cdiv(m, 64))
    g = 2048 if mat.nnz > 1 << 20 else 512
    ns = dg_ns(mat.nnz, m, n, rb=rb, ns=4, g=g, wt=1024, gates=gates)
    return pack_dg(mat, rb=rb, ns=ns, g=g, kt=1, mode="fp32x2", device=device)


def spmv_fn(mat: CooMatrix, method: str = "auto", *, device="cuda",
            gates: Gates = CARD_GATES):
    """Returns ``fn(x[N]) -> y[M]`` for repeated application, the matrix
    packed once on ``device``; ``gates`` decides 'auto' and dg's window."""
    dev = resolve_device(device)
    m, n = mat.shape
    if method == "auto":
        method = "dg" if takes_dg(n, gates) else "segment"
    if method == "dg":
        from tpusparse_torch.kernels.dg_gather import dg_spmv

        fmt = pack_dg_spmv(mat, device=dev, gates=gates)

        def fn(x):
            assert tuple(x.shape) == (n,), f"x shape {tuple(x.shape)} != ({n},)"
            return dg_spmv(fmt, x)

        fn.format = fmt
        return fn
    if method == "dgt8":
        from tpusparse_torch.kernels.dgt_gather import auto_rb_dgt, dgt_spmv, pack_dgt

        rb = auto_rb_dgt(m, n, mat.nnz) if m >= 256 else max(8, 8 * cdiv(m, 8))
        fmt = pack_dgt(mat, rb=rb, g=512, kt=8, mode="fp32x2", resid=True, nw=4,
                       device=dev)

        def fn(x):
            assert tuple(x.shape) == (n,), f"x shape {tuple(x.shape)} != ({n},)"
            return dgt_spmv(fmt, x)

        fn.format = fmt
        return fn
    if method == "span":
        from tpusparse_torch.schedule import Schedule, build_plan
        from tpusparse_torch.tune import _span_configs

        rb, ct, g = _span_configs(mat.density)[0]
        plan = build_plan(mat, Schedule(family="span_onehot", rb=rb, ct=ct, g=g, unroll=4),
                          device=dev)

        def fn(x):
            assert tuple(x.shape) == (n,), f"x shape {tuple(x.shape)} != ({n},)"
            return plan(_as_x(x, dev)[:, None])[:, 0]

        fn.format = plan.formats[0]
        return fn
    if method == "segment":
        rows = torch.as_tensor(mat.rows, dtype=torch.int64, device=dev)
        cols = torch.as_tensor(mat.cols, dtype=torch.int64, device=dev)
        vals = torch.as_tensor(np.asarray(mat.vals), dtype=torch.float32, device=dev)

        def fn(x):
            assert tuple(x.shape) == (n,), f"x shape {tuple(x.shape)} != ({n},)"
            y = torch.zeros(m, dtype=torch.float32, device=dev)
            return y.index_add_(0, rows, vals * _as_x(x, dev)[cols])

        return fn
    if method == "radix":
        from tpusparse_torch.kernels.radix_gather import pack_radix, radix_spmm

        fmt = pack_radix(mat, rb=2048, S=128, g=1024, kt=1, mode="fp32x2", device=dev)

        def fn(x):
            assert tuple(x.shape) == (n,), f"x shape {tuple(x.shape)} != ({n},)"
            return radix_spmm(fmt, _as_x(x, dev)[:, None])[:, 0]

        fn.format = fmt
        return fn
    if method == "stripe":
        from tpusparse_torch.generator import build_stripe_plan

        plan = build_stripe_plan(mat, work_per_stripe=1024, unroll=8, device=dev)

        def fn(x):
            assert tuple(x.shape) == (n,), f"x shape {tuple(x.shape)} != ({n},)"
            return plan(_as_x(x, dev)[:, None])[:, 0]

        fn.format = plan.formats[0]
        return fn
    raise ValueError(f"unknown spmv method {method!r}")


def spmv(mat: CooMatrix, x, method: str = "auto", *, device="cuda",
         gates: Gates = CARD_GATES):
    return spmv_fn(mat, method, device=device, gates=gates)(x)


def spmv_multi_fn(mat: CooMatrix, n_vectors: int = 8, col_split: int | None = None, *,
                  device="cuda", gates: Gates = CARD_GATES):
    """Returns ``fn(X[N, m]) -> Y[M, m]``: m independent SpMVs fused into
    one K = m dgt call (kt = 8).  ``col_split`` packs each column range as
    its own dgt format and sums the partial products; by default
    (``col_split=None``) ``gates`` decides: the TPU's record splits X of
    more than 16 MB into ranges of at most 8 MB (the JAX package's rule,
    from its compile limits on the v5e), the card's never splits (the walk
    reads X through L2 at any N).  ``fn.n_splits`` is the number of
    formats."""
    from tpusparse_torch.kernels.dgt_gather import auto_rb_dgt, dgt_spmm, pack_dgt

    dev = resolve_device(device)
    m, n = mat.shape
    kt = 8
    assert 1 <= n_vectors <= kt, "pack with ktile > 8 for more vectors"
    if col_split is None:
        x_bytes = n * kt * 4
        col_split = (1 if gates.multi_split_bytes is None or x_bytes <= gates.multi_split_bytes
                     else max(2, -(-x_bytes // MULTI_RANGE_BYTES)))

    def _pack(sub, width):
        rb = auto_rb_dgt(m, width, sub.nnz) if m >= 256 else max(8, 8 * cdiv(m, 8))
        return pack_dgt(sub, rb=rb, g=512, kt=kt, mode="fp32x2", resid=True, nw=4,
                        device=dev)

    if col_split <= 1:
        fmt = _pack(mat, n)

        def fn(xs):
            assert tuple(xs.shape) == (n, n_vectors), tuple(xs.shape)
            return dgt_spmm(fmt, xs)

        fn.n_splits = 1
        fn.formats = [fmt]
        return fn

    width = -(-n // col_split)
    rows_a, cols_a, vals_a = np.asarray(mat.rows), np.asarray(mat.cols), np.asarray(mat.vals)
    fmts, ranges = [], []
    for s in range(col_split):
        lo, hi = s * width, min((s + 1) * width, n)
        sel = (cols_a >= lo) & (cols_a < hi)
        if not sel.any():
            continue
        sub = CooMatrix(rows_a[sel], cols_a[sel] - lo, vals_a[sel], (m, hi - lo)).sort_row_major()
        fmts.append(_pack(sub, hi - lo))
        ranges.append((lo, hi))

    def fn(xs):
        assert tuple(xs.shape) == (n, n_vectors), tuple(xs.shape)
        xs = _as_x(xs, dev)
        y = None
        for fmt, (lo, hi) in zip(fmts, ranges):
            part = dgt_spmm(fmt, xs[lo:hi])
            y = part if y is None else y + part
        # a range without a nonzero has no format; with none at all, Y = 0
        return torch.zeros((m, n_vectors), dtype=torch.float32, device=dev) if y is None else y

    fn.n_splits = len(fmts)
    fn.formats = fmts
    return fn
