"""tile_onehot — column-tiled SpMM (counterpart of
``tpusparse/kernels/tile_onehot.py``).

The format is the JAX package's ``TileFormat`` (``tpusparse_torch.format``):
each chunk's G slots lie in one column tile of width CT.  On the TPU the
tile bounded a one-hot MXU contraction that gathered X rows and a second
that scattered products to rows.  The card gathers rows in hardware, so the
port keeps the format and computes its function, ``y_rows[p*rb + lrow] +=
v * X[chunk_tile*ct + cols]``, without the one-hot mechanism: the TPU's
``_prep_x`` (the bf16 hi/lo packing of X for fp32x2) and
``kernels/common.py::onehot_chunk_contrib`` (the one-hot MXU dots) are not
ported.  fp32 and fp32x2 both compute in fp32; bf16 rounds each product.

One CUDA C++ kernel (``tpusparse_torch/csrc/tile_onehot.cu``) replaces both
TPU kernels, each wrapper beside its plain PyTorch version of the same
function:

  tile_rows_cuda        / tile_rows_plain         replace ``_tile_kernel``
  tile_stream_rows_cuda / tile_stream_rows_plain  replace ``_tile_kernel_stream``

The TPU's two kernels differed only in how X reached VMEM; on the card X is
read from L2 either way.  The kernel walks the format once per panel of up
to 512 columns (``stream_geometry``), sums each row run in registers and
adds it into y_rows with float4 atomics.

``tile_spmm`` picks between the wrappers by the JAX package's rule (X of
more than 6 MB in the TPU's packed layout streams, ``uses_stream``), and
each counts its own launches.  Both launch one kernel over one format, so
on the card the rule decides nothing but which wrapper counts the launch,
and it stays the JAX package's.  A wrapper launches its kernel for CUDA
tensors and raises on any failure; only CPU tensors take the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

import torch

from tpusparse_torch.format import TileFormat
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, kernel_info,
                                            launch_checked, pad_dense_cols, prep_x,
                                            unpack_slots, window_rows_plain)

PRECISIONS = ("bf16", "fp32x2", "fp32")
#: TPU-derived: the VMEM footprint above which the JAX package streams X
#: (tile_onehot.py:179); kept so both packages pick the same wrapper (on
#: the card both launch one kernel, so it only names the counter)
_RESIDENT_X_BYTES = 6 * 1024 * 1024


def choose_kt(k: int) -> int:
    """The K-tile X's columns are padded to for K columns: 8, 16 or 32
    (wider K: a multiple of 32)."""
    return 8 if k <= 8 else 16 if k <= 16 else 32


#: the kernel's panel widths (columns a slot stream carries)
STREAM_PANELS = (8, 16, 32, 64, 128, 256, 512)
#: slots a block of the kernel takes, in whole chunks
STREAM_BLOCK_SLOTS = 1024


def stream_geometry(kp: int, g: int) -> tuple[int, int]:
    """The kernel's (panel width, chunks per block) for X of ``kp``
    columns and chunks of ``g`` slots: the narrowest panel that holds kp
    (512 and several panels past it), and whole chunks of about
    ``STREAM_BLOCK_SLOTS`` slots a block."""
    pw = next((w for w in STREAM_PANELS if w >= kp), STREAM_PANELS[-1])
    return pw, max(1, STREAM_BLOCK_SLOTS // g)


def row_runs(fmt: TileFormat) -> tuple[int, int]:
    """(row runs, live slots) of a tile format: a run is a maximal sequence
    of live slots (value not zero, chunk before ``nc_p``) of one row in a
    program's chunk order, which the kernel sums in registers and
    adds into y_rows once (a block's or stream's boundary may cut a run)."""
    vals = fmt.vals.detach().cpu().numpy()
    lrow = fmt.lrow.cpu().numpy()
    nc_p = fmt.nc_p.cpu().numpy().reshape(-1)
    P, NC, _ = vals.shape
    live = (vals != 0) & (np.arange(NC)[None, :, None] < nc_p[:, None, None])
    runs = 0
    for p in range(P):
        rows = lrow[p][live[p]]
        runs += int(rows.size > 0) + int(np.count_nonzero(rows[1:] != rows[:-1]))
    return runs, int(live.sum())


def default_ktile(k: int) -> int:
    """The JAX package's K tile: K up to 128, else 128 (tile_onehot.py:199)."""
    return k if k <= 128 else 128


def uses_stream(n_cols: int, ct: int, ktile: int, precision: str) -> bool:
    """The JAX package's choice of the stream kernel (tile_onehot.py:207-228):
    X padded to whole column tiles, in the TPU's layout for ``precision``
    (fp32x2: hi and lo bf16; bf16: bf16; fp32: fp32), takes more than 6 MB.
    TPU-derived."""
    xwidth = 2 * ktile if precision == "fp32x2" else ktile
    item = 4 if precision == "fp32" else 2
    return cdiv(n_cols, ct) * ct * xwidth * item > _RESIDENT_X_BYTES


# --------------------------------------------------------------- plain versions

def tile_rows_plain(chunk_tile, cols, lrow, vals, nc_p, x, *, rb, ct, kt, mode):
    """Plain PyTorch ``_tile_kernel``: y_rows [P*rb, Kp] with
    ``y_rows[p*rb + lrow] += vals * X[chunk_tile*ct + cols]`` over the slots
    whose value is not zero in a chunk before ``nc_p`` (bf16 rounds each
    product as the kernel does); ``kt`` changes nothing."""
    return window_rows_plain(chunk_tile, cols, lrow, vals, nc_p, x, rb=rb, scale=ct,
                             bf16=mode == "bf16")


def tile_stream_rows_plain(chunk_tile, cols, lrow, vals, nc_p, x, *, rb, ct, kt, mode):
    """Plain PyTorch ``_tile_kernel_stream``: the same function as
    ``tile_rows_plain`` (the stream kernel differs only in how X reaches
    the multiply)."""
    return tile_rows_plain(chunk_tile, cols, lrow, vals, nc_p, x, rb=rb, ct=ct, kt=kt,
                           mode=mode)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/tile_onehot.cu, built at first use, with its C signatures."""
    lib = build.library("tile_onehot")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tile_stream_launch.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
    lib.tile_stream_launch.restype = i32
    lib.tile_stream_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.tile_stream_info.restype = i32
    return lib


def tile_stream_info(pw: int, mode: str) -> dict:
    """The kernel of panel ``pw`` in ``mode`` on the current card:
    registers a thread, spilled (local) bytes a thread, static shared bytes
    and blocks an SM holds."""
    return kernel_info(_lib().tile_stream_info, "tile_stream_info", pw, int(mode == "bf16"))


def _rows_cuda(chunk_tile, cols, lrow, vals, nc_p, x, rb, ct, kt, mode):
    """y_rows [P*rb, Kp] from one launch of the kernel, after checking the
    operands; ``kt`` only checks X's padding."""
    P, NC, G = cols.shape
    check_operands(x, (("chunk_tile", chunk_tile, torch.int32, (P, 1, NC)),
                       ("cols", cols, torch.int32, (P, NC, G)),
                       ("lrow", lrow, torch.int32, (P, NC, G)),
                       ("vals", vals, torch.float32, (P, NC, G)),
                       ("nc_p", nc_p, torch.int32, (P, 1, 1))), ndim=2)
    if kt not in (8, 16, 32) or mode not in PRECISIONS or x.shape[1] % kt:
        raise ValueError(f"tile kernel: kt={kt}, mode={mode}, X {tuple(x.shape)}")
    n, kp = x.shape
    pw, cpb = stream_geometry(kp, G)
    y = torch.zeros((P * rb, kp), dtype=torch.float32, device=x.device)
    launch_checked(_lib().tile_stream_launch, "tile_stream_launch",
                   (chunk_tile, cols, lrow, vals, nc_p, x, y),
                   (P, NC, G, rb, ct, n, kp, pw, int(mode == "bf16"), cpb))
    return y


def tile_rows_cuda(chunk_tile, cols, lrow, vals, nc_p, x, *, rb, ct, kt, mode):
    """CUDA ``_tile_kernel`` (tpusparse/kernels/tile_onehot.py:44): y_rows
    [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt in {8, 16, 32}, the
    format walked once per panel of columns (``stream_geometry``)."""
    y = _rows_cuda(chunk_tile, cols, lrow, vals, nc_p, x, rb, ct, kt, mode)
    tile_rows_cuda.launches += 1
    return y


def tile_stream_rows_cuda(chunk_tile, cols, lrow, vals, nc_p, x, *, rb, ct, kt, mode):
    """CUDA ``_tile_kernel_stream`` (tpusparse/kernels/tile_onehot.py:119):
    the same y_rows from the same kernel, counted on its own."""
    y = _rows_cuda(chunk_tile, cols, lrow, vals, nc_p, x, rb, ct, kt, mode)
    tile_stream_rows_cuda.launches += 1
    return y


tile_rows_cuda.launches = 0
tile_stream_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry point

def tile_spmm(
    fmt: TileFormat,
    x,
    *,
    ktile: int | None = None,
    precision: str = "fp32x2",
    unroll: int = 2,
) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in TileFormat, through
    ``tile_stream_rows_cuda`` where the JAX package's rule (``uses_stream``)
    streams X, else through ``tile_rows_cuda``.  ``unroll`` steered the TPU kernel's loop only and
    changes nothing here.  CUDA formats run a kernel, CPU formats its plain
    version."""
    assert precision in PRECISIONS, precision
    x = prep_x(x, fmt.device)
    m, n_cols = fmt.shape
    k = x.shape[1]
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    if ktile is None:
        ktile = default_ktile(k)
    kt = choose_kt(min(ktile, 32))
    x = pad_dense_cols(x, cdiv(k, kt) * kt).contiguous()
    on_card = fmt.device.type == "cuda"
    if uses_stream(n_cols, fmt.ct, ktile, precision):
        rows_fn = tile_stream_rows_cuda if on_card else tile_stream_rows_plain
    else:
        rows_fn = tile_rows_cuda if on_card else tile_rows_plain
    vals = fmt.vals if fmt.vals.dtype == torch.float32 else fmt.vals.float()
    y_rows = rows_fn(fmt.chunk_tile, fmt.cols, fmt.lrow, vals, fmt.nc_p, x, rb=fmt.rb,
                     ct=fmt.ct, kt=kt, mode=precision)
    return unpack_slots(y_rows, fmt.slot_of_origrow)[:, :k]
