"""nm_structured — N:M structured-sparsity SpMM (counterpart of
``tpusparse/kernels/nm_structured.py``, BASELINE.json config #4).

Weights pruned so that every contiguous group of ``group`` columns keeps at
most ``n_keep`` values (canonically 2:4).  The format is the JAX package's,
array for array, padding included (rows to a multiple of ``rb``, groups to
a multiple of 128: TPU-shaped, but the format is the contract):

  vals [S, M_pad, G_pad]  the s-th kept value of each group (0 if fewer);
                          bf16 (the default), fp32, or int8 with row_scale
  offs [1, M_pad, G_pad]  every slot's in-group offset bit-packed into one
                          int8 (slot s in bits [s*b, (s+1)*b), b =
                          ceil(log2(group))) when S*b <= 8, else the
                          unpacked [S, M_pad, G_pad] int8 plane
                          (packed_bits = 0)

Kernel (CUDA C++, ``tpusparse_torch/csrc/nm_structured.cu``) beside its
plain PyTorch version of the same function:

  nm_rows_cuda / nm_rows_plain  replace ``_nm_kernel``: y [M_pad, K] fp32
      with y[r, k] = sum_g sum_s vals[s, r, g] * X[g*group + off_s(r, g), k]

Precision, as the TPU kernel: ``bf16`` rounds the value and X to bf16 and
sums the exact products in fp32; ``fp32`` is fp32-accurate; int8 values
(W8A16) are exact in bf16, so they run the bf16 mode and ``row_scale``
scales each row afterwards.  The TPU's one-hot decomposition over the
group's offsets, its 128-lane K padding and its (rb, gt, ktile) tiling are
Mosaic mechanism: the card kernel rebuilds dense tiles of the weight in
shared memory from the slots and multiplies them on the tensor cores (bf16
mma; fp32 as 3xTF32), at any K.  The tiling knobs are accepted and change
nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, launch_checked, pad_dense_cols, prep_x,
                                            quantize_rows, resolve_device, round_up, sm_count,
                                            storage_dtype)

PRECISIONS = ("bf16", "fp32")


@dataclasses.dataclass
class NmFormat:
    """Packed N:M structured weight (see the module docstring)."""

    vals: Any  # [S, M_pad, G_pad] bf16/f32 (int8 when row_scale is set)
    offs: Any  # [1, M_pad, G_pad] int8 bit-packed, or [S, ...] unpacked
    shape: tuple[int, int]  # original (M, n_cols)
    n_keep: int
    group: int
    packed_bits: int = 0  # bits per slot offset when bit-packed, else 0
    row_scale: Any = None  # [M_pad] f32: W8A16 per-output-row scale

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def m_pad(self) -> int:
        return self.vals.shape[1]

    @property
    def g_pad(self) -> int:
        return self.vals.shape[2]

    @property
    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in (self.vals, self.offs))

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.vals))


def pack_nm(dense, *, n_keep: int = 2, group: int = 4, rb: int = 256,
            dtype=torch.bfloat16, device="cuda") -> NmFormat:
    """Pack a dense [M, n_cols] N:M-structured matrix (at most ``n_keep``
    nonzeros in each ``group`` consecutive columns) on ``device``; raises if
    the structure is violated.  The arrays equal the JAX packer's
    (tpusparse/kernels/nm_structured.py:87)."""
    dev = resolve_device(device)
    dt = storage_dtype(dtype)
    dense = np.asarray(dense)
    m, n_cols = dense.shape
    assert n_cols % group == 0, f"n_cols {n_cols} not a multiple of group {group}"
    g = n_cols // group
    wg = dense.reshape(m, g, group)
    nz = wg != 0
    counts = nz.sum(axis=2)
    if int(counts.max(initial=0)) > n_keep:
        bad = int((counts > n_keep).sum())
        raise ValueError(
            f"{bad} groups exceed {n_keep}:{group} structure (max {int(counts.max())})")
    # stable in-group order: offset ascending; argsort pushes zeros last
    order = np.argsort(~nz, axis=2, kind="stable")[:, :, :n_keep]  # [M, G, S]
    valid = np.take_along_axis(nz, order, axis=2)
    svals = np.where(valid, np.take_along_axis(wg, order, axis=2), 0.0)
    soffs = np.where(valid, order, 0).astype(np.int8)
    m_pad = round_up(max(m, 8), rb)
    g_pad = round_up(max(g, 128), 128)
    out_v = np.zeros((n_keep, m_pad, g_pad), dtype=np.float32)
    out_o = np.zeros((n_keep, m_pad, g_pad), dtype=np.int8)
    out_v[:, :m, :g] = np.moveaxis(svals, 2, 0)
    out_o[:, :m, :g] = np.moveaxis(soffs, 2, 0)
    row_scale = None
    if dt == torch.int8:
        out_v, rs = quantize_rows(out_v, axes=(0, 2))
        row_scale = torch.from_numpy(rs).to(dev)
    bits = max(int(np.ceil(np.log2(max(group, 2)))), 1)
    packed_bits = 0
    if n_keep * bits <= 8:
        packed = np.zeros((1, m_pad, g_pad), dtype=np.uint8)
        for s in range(n_keep):
            packed[0] |= out_o[s].astype(np.uint8) << (s * bits)
        out_o, packed_bits = packed.view(np.int8), bits
    return NmFormat(vals=torch.from_numpy(out_v).to(dev, dt),
                    offs=torch.from_numpy(np.ascontiguousarray(out_o)).to(dev),
                    shape=(m, n_cols), n_keep=n_keep, group=group, packed_bits=packed_bits,
                    row_scale=row_scale)


def nm_format_from_numpy(fields: dict, *, device="cuda", **static) -> NmFormat:
    """An NmFormat from numpy arrays — the JAX ``NmFormat``'s ``vals``,
    ``offs`` and ``row_scale`` (None for float values) — plus its static
    fields (``shape``, ``n_keep``, ``group``, ``packed_bits``).  The arrays
    come from outside this package, so their shapes, dtypes and offsets are
    checked here: the kernel reads X at these offsets without bounds
    checks."""
    dev = resolve_device(device)
    vals, offs = np.asarray(fields["vals"]), np.asarray(fields["offs"])
    rs = fields.get("row_scale")
    (m, n_cols), n_keep, group = static["shape"], static["n_keep"], static["group"]
    bits = static.get("packed_bits", 0)
    if n_cols % group or vals.ndim != 3 or vals.shape[0] != n_keep or \
            vals.shape[1] < m or vals.shape[2] * group < n_cols:
        raise ValueError(f"NmFormat.vals: shape {vals.shape} for {m}x{n_cols} at "
                         f"{n_keep}:{group}")
    if offs.dtype != np.int8 or offs.shape != ((1 if bits else n_keep),) + vals.shape[1:]:
        raise ValueError(f"NmFormat.offs: {offs.dtype} {offs.shape}")
    if bits and (bits != max(int(np.ceil(np.log2(max(group, 2)))), 1) or n_keep * bits > 8):
        raise ValueError(f"NmFormat.packed_bits {bits} for {n_keep}:{group}")
    if vals.dtype == np.int8:
        rs = np.asarray(rs, np.float32) if rs is not None else None
        if rs is None or rs.shape != (vals.shape[1],):
            raise ValueError("int8 NmFormat values need row_scale [M_pad]")
        dt = torch.int8
    else:
        if rs is not None:
            raise ValueError("row_scale belongs to int8 values only")
        dt = storage_dtype(vals.dtype.name)
    w = offs.view(np.uint8).astype(np.int32)
    dec = ([(w[0] >> (s * bits)) & ((1 << bits) - 1) for s in range(n_keep)] if bits
           else list(offs.astype(np.int32)))
    if any(d.min(initial=0) < 0 or d.max(initial=0) >= group for d in dec):
        raise ValueError("NmFormat offsets out of range")
    # the kernel stores each kept value into its place: two at one offset
    # of a group would not add up
    key = np.where(vals != 0, np.stack(dec), -1 - np.arange(n_keep).reshape(-1, 1, 1))
    key.sort(axis=0)
    if (key[1:] == key[:-1]).any():
        raise ValueError("NmFormat: two kept values of a group at one offset")
    vt = torch.tensor(vals.astype(np.float32) if dt == torch.bfloat16 else vals)
    return NmFormat(vals=vt.to(dev, dt), offs=torch.tensor(offs, device=dev),
                    shape=(m, n_cols), n_keep=n_keep, group=group, packed_bits=bits,
                    row_scale=None if rs is None else torch.tensor(rs, device=dev))


def unpacked_offs(fmt: NmFormat) -> np.ndarray:
    """[S, M_pad, G_pad] int8 offsets, decoding the bit-packed plane."""
    offs = fmt.offs.cpu().numpy()
    if not fmt.packed_bits:
        return offs
    w = offs[0].view(np.uint8).astype(np.int32)
    mask = (1 << fmt.packed_bits) - 1
    return np.stack([((w >> (s * fmt.packed_bits)) & mask).astype(np.int8)
                     for s in range(fmt.n_keep)])


# --------------------------------------------------------------- plain version

def nm_rows_plain(vals, offs, x, *, group, packed_bits, mode):
    """Plain PyTorch ``_nm_kernel``: y [M_pad, K] fp32, the slots scattered
    into a dense [M_pad, G_pad*group] weight and multiplied in fp32.
    ``bf16`` rounds the values and X to bf16 first (their products are
    exact in fp32); int8 values widen exactly."""
    S, mp, gp = vals.shape
    off = offs.to(torch.int32) & 0xFF  # the byte read as unsigned
    if packed_bits:
        off = torch.stack([(off[0] >> (s * packed_bits)) & ((1 << packed_bits) - 1)
                           for s in range(S)])
    v = vals.float()
    if mode == "bf16":
        v, x = v.bfloat16().float(), x.bfloat16().float()
    col = torch.arange(gp, device=vals.device).view(1, gp) * group
    dense = torch.zeros((mp, gp * group), dtype=torch.float32, device=vals.device)
    for s in range(S):
        dense.scatter_add_(1, col + off[s].long(), v[s])
    return dense[:, :x.shape[0]] @ x


# ---------------------------------------------------------------- CUDA kernel

@functools.cache
def _lib():
    """csrc/nm_structured.cu, built at first use, with its C signature."""
    lib = build.library("nm_structured")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nm_spmm_launch.argtypes = [ptr] * 4 + [i32] * 12 + [ptr]
    lib.nm_spmm_launch.restype = i32
    lib.nm_spmm_info.argtypes = [i32] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.nm_spmm_info.restype = i32
    return lib


VAL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: the kernel's depth step (csrc/nm_structured.cu: kBK)
DEPTH_STEP = 64


def tile_of(mode: str, k: int) -> tuple[int, int]:
    """The kernel's tile of y (rows, columns) for ``mode`` at K = ``k``: in
    bf16 256 columns past K = 128 (half the A rebuilds and slot reads per
    product), else 128 (csrc/nm_structured.cu: Tile)."""
    return (128, 256 if k > 128 else 128) if mode == "bf16" else (64, 128)


def depth_splits(m_pad: int, k: int, depth: int, mode: str, sms: int) -> int:
    """Blocks the kernel splits the depth over: 1 where the tiles of y fill
    the card's ``sms`` SMs (the kernel holds one block an SM), else as many
    as keep the blocks within one wave, each at least 4 depth steps."""
    bm, bn = tile_of(mode, k)
    tiles = cdiv(m_pad, bm) * cdiv(k, bn)
    return max(1, min(sms // max(tiles, 1), cdiv(depth, DEPTH_STEP) // 4))


def nm_kernel_info(vals, offs, *, group, packed_bits, mode, k) -> dict:
    """What a launch of the kernel on this format, mode and K uses on the
    current card: registers and spilled (local) bytes a thread, static and
    dynamic shared bytes, groups a staged depth step takes (0: the slots are
    read from device memory), blocks an SM holds and the tile's columns."""
    out = (ctypes.c_int * 6)()
    tile_n = tile_of(mode, k)[1]
    rc = _lib().nm_spmm_info(VAL_CODES[vals.dtype], int(mode == "bf16"), vals.shape[0], group,
                             packed_bits, vals.shape[2], tile_n, out)
    if rc:
        raise RuntimeError(f"nm_spmm_info failed with CUDA error {rc}")
    return dict(zip(("registers", "spill_bytes", "static_shared_bytes", "dynamic_shared_bytes",
                     "staged_groups", "blocks_per_sm"), out), tile_n=tile_n)


def nm_rows_cuda(vals, offs, x, *, group, packed_bits, mode):
    """CUDA ``_nm_kernel`` (tpusparse/kernels/nm_structured.py:160): y
    [M_pad, K] fp32 for X [G*group, K] fp32 (G <= G_pad groups; K any)."""
    S, mp, gp = vals.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, X is on {dev}")
    so = 1 if packed_bits else S
    for name, t, ok, shp in (("vals", vals, vals.dtype in VAL_CODES, (S, mp, gp)),
                             ("offs", offs, offs.dtype == torch.int8, (so, mp, gp))):
        if t.device != dev or not ok or tuple(t.shape) != shp or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor {shp} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("X must be a contiguous, 16-byte aligned 2-D float32 tensor")
    if mode not in PRECISIONS or not 2 <= group <= 128 or x.shape[0] % group or \
            x.shape[0] // group > gp:
        raise ValueError(f"nm kernel: mode {mode!r}, group {group}, X {tuple(x.shape)}, "
                         f"G_pad {gp}")
    n, k = x.shape
    # X as the tensor cores take it, rows padded to 16 bytes for cp.async:
    # bf16 (rounded to nearest even, as the TPU's wrapper casts it) or fp32
    if mode == "bf16":
        xk = pad_dense_cols(x, round_up(k, 8)).to(torch.bfloat16).contiguous()
    else:
        xk = pad_dense_cols(x, round_up(k, 4)).contiguous()
    splits = depth_splits(mp, k, n, mode, sm_count(dev))
    y = (torch.zeros if splits > 1 else torch.empty)((mp, k), dtype=torch.float32, device=dev)
    launch_checked(_lib().nm_spmm_launch, "nm_spmm_launch", (vals, offs, xk, y),
                   (S, mp, gp, n // group, group, k, xk.shape[1], packed_bits,
                    VAL_CODES[vals.dtype], int(mode == "bf16"), splits, tile_of(mode, k)[1]))
    nm_rows_cuda.launches += 1
    return y


nm_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry point

def nm_spmm(fmt: NmFormat, x, *, rb: int = 256, gt: int | None = None,
            ktile: int | None = None, precision: str = "bf16") -> torch.Tensor:
    """Y[M, K] = A . X[n_cols, K] with A in NmFormat.  int8 formats run
    W8A16: the integers dot bf16 activations and ``row_scale`` scales each
    row of the result.  ``rb``, ``gt`` and ``ktile`` were the TPU kernel's
    tiling and change nothing here.  CUDA formats run the kernel, CPU
    formats its plain version."""
    if fmt.row_scale is not None:
        assert precision in ("bf16", "int8"), (
            "int8-packed N:M weights dot in bf16 (W8A16); fp32 activations "
            "are not supported on this path")
        precision = "bf16"
    else:
        assert precision != "int8", (
            "precision='int8' needs an int8-packed format: pack_nm(dtype=torch.int8)")
    assert precision in PRECISIONS, precision
    m, n_cols = fmt.shape
    x = prep_x(x, fmt.device)
    k = x.shape[1]
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    kw = dict(group=fmt.group, packed_bits=fmt.packed_bits, mode=precision)
    if fmt.device.type == "cuda":
        y = nm_rows_cuda(fmt.vals, fmt.offs, x, **kw)
    else:
        y = nm_rows_plain(fmt.vals, fmt.offs, x, **kw)
    if fmt.row_scale is not None:
        y = y * fmt.row_scale[:, None]
    return y[:m, :k]
