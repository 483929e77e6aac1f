"""stripe_gather — row-aligned stripe SpMM (counterpart of
``tpusparse/kernels/stripe_gather.py``).

The reference's total-reduce family
(total_BMT/total_warp/total_block_result_reduce_to_one_register_token): each
stripe owns whole rows, loops its nonzeros, accumulates, and stores its rows
of Y once.  The formats are ``tpusparse_torch.format``'s ``StripeFormat`` and
``NestedStripeFormat``, array for array the JAX package's.

Kernels (CUDA C++, ``tpusparse_torch/csrc/stripe_gather.cu``), each beside its
plain PyTorch version of the same function:

  stripe_rows_cuda        / stripe_rows_plain         replace ``_stripe_kernel``
  stripe_nested_rows_cuda / stripe_nested_rows_plain  replace ``_stripe_nested_kernel``

Each computes the stripe slots ``y_slots[p*rb + row] += v * X[col]``; the
slot gather through ``slot_of_origrow`` then gives Y.  The K-tile is the
card's own choice (1, 2, 4, 8, 16 or 32 columns, X padded to it): the JAX
ktile rule is Mosaic's 128-lane fallback, and its model-driven index
compression (``tpusparse/transforms/compress.py``) lets the TPU compute a
stripe's rows instead of loading them, which changes no Y; neither is
ported.  Both kernels cut each stripe into blocks of slots and walk them
once per panel of columns (X of 1 or 2 columns read padded to 4), each row
run summed in registers and added with float4 atomics into the zeroed
y_slots: the stripe kernel the stripe's live slots (``live_p``,
``stripe_slot_ranges``) in blocks of the row walk's size by panel
(``stripe_geometry``), the nested kernel its sub-blocks
(``nested_slot_ranges``) in blocks of ``NESTED_BLOCK_SLOTS``
(``nested_geometry``).  ``unroll`` steered the TPU loop only.  A wrapper
launches its kernel for CUDA tensors and raises on any failure; only CPU
tensors take the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpusparse_torch.format import NestedStripeFormat, StripeFormat
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, kernel_info, launch_checked,
                                            pad_dense_cols, prep_x, unpack_slots)
# the stripe kernels take radix's K-tiles: 1, 2, 4, 8, 16 or 32 columns
from tpusparse_torch.kernels.radix_gather import RADIX_KTS as STRIPE_KTS
from tpusparse_torch.kernels.radix_gather import choose_kt
from tpusparse_torch.kernels.row_walk import check_out, walk_geometry
from tpusparse_torch.kernels.tile_onehot import STREAM_BLOCK_SLOTS, STREAM_PANELS

#: the nested kernel's panel widths (columns a slot stream carries)
NESTED_PANELS = (4,) + STREAM_PANELS
#: slots of one stripe a block of the nested kernel takes
NESTED_BLOCK_SLOTS = STREAM_BLOCK_SLOTS


def nested_geometry(kp: int) -> tuple[int, int]:
    """The nested kernel's (columns of X it reads, panel width) for X of
    ``kp`` columns: kp rounded up to 4 (the wrapper pads X of 1 or 2
    columns; a gathered row costs one 32-byte sector either way), and the
    narrowest panel that holds it (512 and several panels past it)."""
    kp4 = cdiv(kp, 4) * 4
    return kp4, next((w for w in NESTED_PANELS if w >= kp4), NESTED_PANELS[-1])


def nested_slot_ranges(wnz, c: int, bs: int = NESTED_BLOCK_SLOTS) -> np.ndarray:
    """[P, cdiv(c, bs), 2]: the slots [lo, hi) that block b of stripe p takes,
    ``[b*bs, (b+1)*bs)`` within the stripe's sub-blocks ``[wnz[p, 0],
    wnz[p, W])``; lo >= hi for a block that exits at once."""
    wz = np.asarray(wnz).reshape(len(wnz), -1).astype(np.int64)
    start = np.arange(cdiv(c, bs), dtype=np.int64) * bs
    lo = np.maximum(start[None, :], wz[:, :1])
    hi = np.minimum(start[None, :] + bs, wz[:, -1:])
    return np.stack([lo, hi], axis=-1)


def stripe_geometry(kp: int) -> tuple[int, int, int]:
    """The stripe kernel's (columns of X it reads, panel width, slots a
    block) for X of ``kp`` columns: the row walk's (``walk_geometry``),
    whose block sizes were chosen on the card for the same slot streams
    (2048 slots up to 8 columns, 1024, 512 at 256 and 512 columns)."""
    return walk_geometry(kp)


def stripe_slot_ranges(live_p, c: int, bs: int) -> np.ndarray:
    """[P, cdiv(c, bs), 2]: the slots [lo, hi) that block b of stripe p of
    the stripe kernel takes, ``[b*bs, (b+1)*bs)`` below the stripe's live
    count ``live_p[p]``; lo >= hi for a block that exits at once."""
    live = np.asarray(live_p).reshape(-1, 1).astype(np.int64)
    return nested_slot_ranges(np.concatenate([np.zeros_like(live), live], axis=1), c, bs)


def stripe_row_runs(fmt) -> tuple[int, int]:
    """(row runs, live slots) of a stripe or segment format: a run is a
    maximal sequence of live slots (below ``live_p``, value not zero) of
    one row in a stripe's slot order, which the stripe kernel sums in
    registers and adds into y_slots once (a block's or stream's boundary
    may cut a run)."""
    P, _, C = fmt.cols.shape
    vals = fmt.vals.detach().float().cpu().numpy().reshape(P, C)
    lrow = fmt.lrow.cpu().numpy().reshape(P, C)
    walked = (np.arange(C)[None, :] < fmt.live_p.cpu().numpy().reshape(P, 1)) & (vals != 0)
    runs = 0
    for p in range(P):
        r = lrow[p][walked[p]]
        runs += int(r.size > 0) + int(np.count_nonzero(r[1:] != r[:-1]))
    return runs, int(walked.sum())


def sub_block_of(wz, lo: int, hi: int) -> np.ndarray:
    """The sub-block w (wz[w] <= i < wz[w+1]) of each slot i in [lo, hi),
    found as a lane of the nested kernel finds it: binary search for slot
    lo, then a cursor moved past every wz[w+1] <= i as i rises, through
    empty sub-blocks too.  ``wz``: one stripe's W + 1 offsets, lo >= wz[0],
    hi <= wz[W]."""
    a, b = 0, len(wz) - 1
    while b - a > 1:
        m = (a + b) // 2
        a, b = (m, b) if wz[m] <= lo else (a, m)
    out = np.empty(hi - lo, dtype=np.int64)
    i, w = lo, a
    while i < hi:
        while i >= wz[w + 1]:
            w += 1
        end = min(int(wz[w + 1]), hi)
        out[i - lo:end - lo] = w
        i = end
    return out


def nested_row_runs(fmt: NestedStripeFormat) -> tuple[int, int]:
    """(row runs, live slots) of a nested stripe format: a run is a maximal
    sequence of live slots (value not zero, inside a sub-block) of one row
    in a stripe's slot order, which the nested kernel sums in registers and
    adds into y_slots once (a block's or stream's boundary may cut a run; a
    sub-block's does not)."""
    P, _, C = fmt.cols.shape
    vals = fmt.vals.detach().cpu().numpy().reshape(P, C)
    lrow = fmt.lrow.cpu().numpy().reshape(P, C)
    wnz = fmt.wnz.cpu().numpy().reshape(P, -1)
    wrow = fmt.wrow.cpu().numpy().reshape(P, -1)
    runs = live = 0
    for p in range(P):
        lo, hi = int(wnz[p, 0]), int(wnz[p, -1])
        rows = wrow[p, sub_block_of(wnz[p], lo, hi)] + lrow[p, lo:hi]
        rows = rows[vals[p, lo:hi] != 0]
        runs += int(rows.size > 0) + int(np.count_nonzero(rows[1:] != rows[:-1]))
        live += rows.size
    return runs, live


# --------------------------------------------------------------- plain versions

def _slots_plain(live, row, col, v, x, n_rows):
    prod = v[live].view(-1, 1) * x[col[live]]
    y = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    return y.index_add_(0, row[live], prod)


def stripe_rows_plain(cols, lrow, vals, x, *, rb):
    """Plain PyTorch ``_stripe_kernel``: y_slots [P*rb, Kp] with
    ``y_slots[p*rb + lrow] += vals * X[cols]`` over the slots whose value is
    not zero, as an ``index_add_`` (bf16 values widen exactly).  The slots
    past a stripe's live count hold zeros, so they add nothing here and the
    kernel does not walk them."""
    P, _, C = cols.shape
    v = vals.reshape(-1).float()
    row = (torch.arange(P, device=cols.device).view(P, 1) * rb
           + lrow.reshape(P, C).long()).reshape(-1)
    return _slots_plain(v != 0, row, cols.reshape(-1).long(), v, x, P * rb)


def stripe_nested_rows_plain(cols, lrow, vals, wnz, wrow, x, *, rb):
    """Plain PyTorch ``_stripe_nested_kernel``: slot i of stripe p in warp
    sub-block w (wnz[p, w] <= i < wnz[p, w + 1]) adds ``vals * X[cols]`` to
    row ``p*rb + wrow[p, w] + lrow``; slots past the last sub-block are not
    walked."""
    P, _, C = cols.shape
    W = wnz.shape[-1] - 1
    wnz2, wrow2 = wnz.reshape(P, W + 1).long(), wrow.reshape(P, W + 1).long()
    slot = torch.arange(C, device=cols.device).expand(P, C).contiguous()
    w_of = torch.searchsorted(wnz2, slot, right=True) - 1
    walked = (w_of >= 0) & (w_of < W) & (slot < wnz2[:, W:])
    base = wrow2.gather(1, w_of.clamp(0, W))
    row = (torch.arange(P, device=cols.device).view(P, 1) * rb + base
           + lrow.reshape(P, C).long()).reshape(-1)
    v = vals.reshape(-1).float()
    return _slots_plain(walked.reshape(-1) & (v != 0), row, cols.reshape(-1).long(), v, x,
                        P * rb)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/stripe_gather.cu, built at first use, with its C signatures."""
    lib = build.library("stripe_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stripe_spmm_launch.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.stripe_spmm_launch.restype = i32
    lib.stripe_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.stripe_info.restype = i32
    lib.stripe_nested_launch.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
    lib.stripe_nested_launch.restype = i32
    lib.stripe_nested_info.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.stripe_nested_info.restype = i32
    return lib


def stripe_info(pw: int, bf16_vals: bool = False) -> dict:
    """The stripe kernel of panel ``pw`` (bf16 values or fp32) on the
    current card: registers a thread, spilled (local) bytes a thread,
    static shared bytes and blocks an SM holds."""
    return kernel_info(_lib().stripe_info, "stripe_info", pw, int(bf16_vals))


def stripe_nested_info(pw: int) -> dict:
    """The nested kernel of panel ``pw`` on the current card: registers a
    thread, spilled (local) bytes a thread, static shared bytes and blocks
    an SM holds."""
    return kernel_info(_lib().stripe_nested_info, "stripe_nested_info", pw)


def _check_kt(kt, x, what):
    if kt not in STRIPE_KTS or x.shape[1] % kt:
        raise ValueError(f"{what}: kt={kt}, X {tuple(x.shape)}")


def stripe_rows_cuda(cols, lrow, vals, x, *, rb, kt, live, out=None):
    """CUDA ``_stripe_kernel`` (tpusparse/kernels/stripe_gather.py:35):
    y_slots [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt; vals fp32 or
    bf16; ``live`` [P] int32 the stripes' live slots (``live_p``), the only
    ones walked, each stripe cut into blocks of slots (``stripe_geometry``:
    X of 1 or 2 columns is read padded to 4, and the first Kp columns of
    the kernel's y_slots returned).  ``out``: y_slots [P*rb, Kp] to add
    into (Kp a multiple of 4), returned in its place."""
    P, _, C = cols.shape
    vdt = vals.dtype if vals.dtype in (torch.float32, torch.bfloat16) else torch.float32
    check_operands(x, (("cols", cols, torch.int32, (P, 1, C)),
                       ("lrow", lrow, torch.int32, (P, 1, C)),
                       ("vals", vals, vdt, (P, 1, C)),
                       ("live", live, torch.int32, (P,))), ndim=2)
    _check_kt(kt, x, "stripe kernel")
    n, kp = x.shape
    kp4, pw, bs = stripe_geometry(kp)
    if out is None:
        y = torch.zeros((P * rb, kp4), dtype=torch.float32, device=x.device)
    elif kp4 != kp:
        raise ValueError(f"stripe kernel: out= needs X of a multiple of 4 columns, not {kp}")
    else:
        check_out("stripe_rows_cuda", out, (P * rb, kp), x.device)
        y = out
    launch_checked(_lib().stripe_spmm_launch, "stripe_spmm_launch",
                   (cols, lrow, vals, live, pad_dense_cols(x, kp4).contiguous(), y),
                   (P, C, rb, n, kp4, pw, bs, int(vals.dtype == torch.bfloat16)))
    stripe_rows_cuda.launches += 1
    return y[:, :kp]


def stripe_nested_rows_cuda(cols, lrow, vals, wnz, wrow, x, *, rb, kt):
    """CUDA ``_stripe_nested_kernel`` (tpusparse/kernels/stripe_gather.py:156):
    y_slots [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt, each stripe
    cut into blocks of ``NESTED_BLOCK_SLOTS`` slots (``nested_geometry``:
    X of 1 or 2 columns is read padded to 4, and the first Kp columns of
    the kernel's y_slots returned)."""
    P, _, C = cols.shape
    W = wnz.shape[-1] - 1
    check_operands(x, (("cols", cols, torch.int32, (P, 1, C)),
                       ("lrow", lrow, torch.int32, (P, 1, C)),
                       ("vals", vals, torch.float32, (P, 1, C)),
                       ("wnz", wnz, torch.int32, (P, 1, W + 1)),
                       ("wrow", wrow, torch.int32, (P, 1, W + 1))), ndim=2)
    _check_kt(kt, x, "nested stripe kernel")
    n, kp = x.shape
    kp4, pw = nested_geometry(kp)
    y = torch.zeros((P * rb, kp4), dtype=torch.float32, device=x.device)
    launch_checked(_lib().stripe_nested_launch, "stripe_nested_launch",
                   (cols, lrow, vals, wnz, wrow, pad_dense_cols(x, kp4).contiguous(), y),
                   (P, C, W, rb, n, kp4, pw, NESTED_BLOCK_SLOTS))
    stripe_nested_rows_cuda.launches += 1
    return y[:, :kp]


stripe_rows_cuda.launches = 0
stripe_nested_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry points

def prep_stripe_x(x, device, k_tile):
    """X as fp32 on ``device``, its columns padded to the K-tile chosen for
    ``k_tile`` columns; returns (x, kt, K)."""
    x = prep_x(x, device)
    k = x.shape[1]
    kt = choose_kt(min(k_tile or k, 32))
    return pad_dense_cols(x, cdiv(k, kt) * kt).contiguous(), kt, k


def stripe_spmm(fmt: StripeFormat, x, *, ktile: int | None = None,
                unroll: int = 8) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in StripeFormat.  ``ktile`` caps the
    K-tile (at most 32 columns); ``unroll`` changes nothing here.  CUDA
    formats run the kernel, CPU formats its plain version."""
    m, n_cols = fmt.shape
    x, kt, k = prep_stripe_x(x, fmt.device, ktile)
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    rb = fmt.max_rows_per_stripe
    if fmt.device.type == "cuda":
        y_slots = stripe_rows_cuda(fmt.cols, fmt.lrow, fmt.vals, x, rb=rb, kt=kt,
                                   live=fmt.live_p)
    else:
        y_slots = stripe_rows_plain(fmt.cols, fmt.lrow, fmt.vals, x, rb=rb)
    return unpack_slots(y_slots, fmt.slot_of_origrow)[:, :k]


def stripe_nested_spmm(fmt: NestedStripeFormat, x, *, ktile: int | None = None,
                       unroll: int = 8) -> torch.Tensor:
    """Y = A . X with A in NestedStripeFormat (two-level TBLOCK > WARP)."""
    m, n_cols = fmt.shape
    x, kt, k = prep_stripe_x(x, fmt.device, ktile)
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    args = (fmt.cols, fmt.lrow, fmt.vals, fmt.wnz, fmt.wrow, x)
    rb = fmt.max_rows_per_stripe
    if fmt.device.type == "cuda":
        y_slots = stripe_nested_rows_cuda(*args, rb=rb, kt=kt)
    else:
        y_slots = stripe_nested_rows_plain(*args, rb=rb)
    return unpack_slots(y_slots, fmt.slot_of_origrow)[:, :k]
