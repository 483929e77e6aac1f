"""block_ell — block-sparse (BSR/ELL) SpMM on dense tiles (counterpart of
``tpusparse/kernels/block_ell.py``, the block-sparse half of BASELINE.json
config #4).

Format (ELL over blocks; MB row-blocks of BS rows, BMAX slots each), array
for array the JAX package's:

  blkcol  [MB, BMAX]          int32  block-column of each slot (0 if padded)
  blkvals [MB, BMAX, BS, BS]  fp32/bf16, or int8 with row_scale [MB, BS]
  nb_p    [MB]                int32  real blocks per row-block (the port's
                                     own field: the kernel walks only those;
                                     not counted in ``memory_bytes``)
  work    [n, 4]              int32  the kernel's work items, built from
                                     nb_p (``bell_work``; the port's own,
                                     not in ``memory_bytes``)

``block_ell_spmm`` has the JAX package's two methods: ``xla`` (the JAX
package's default: gather the X tiles and run one batched product, which
is XLA code there and a torch ``bmm`` here) and ``pallas`` (the kernel,
the port's default: ``gates.CARD_GATES.block_ell_method``).  int8 formats
quantize X per column and run the integer product on the kernel's int8
instantiation whatever the method, since torch has no int8 batched
product on CUDA; the rank-1 rescale follows in torch.

Kernel (CUDA C++, ``tpusparse_torch/csrc/block_ell.cu``) beside its plain
PyTorch version of the same function:

  bell_rows_cuda / bell_rows_plain  replace ``_bell_kernel`` (and the
      product of ``_bell_xla_int8``): y [MB*BS, K] with
      y[i*BS + a] = sum_j blkvals[i, j, a, :] @ X[blkcol[i, j]*BS + :BS]

The kernel is a tensor-core GEMM over each row-block's gathered depth
(bf16 and int8 on ``wgmma``, fp32 as 3xTF32 ``mma.sync``), cut into work
items of at most ``ITEM_STEPS`` depth steps of a row-block, so that no
block of the grid carries the longest row-block alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpusparse_torch.gates import CARD_GATES
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, launch_checked, matmul_f32, pad_dense_cols,
                                            pad_dense_rows, prep_x, quantize_rows,
                                            resolve_device, round_up, storage_dtype)

PRECISIONS = ("bf16", "fp32", "int8")
#: depth steps that one work item of the kernel carries, and a step's
#: values (csrc/block_ell.cu: 128 bytes of a bf16 or int8 row, 64 fp32)
ITEM_STEPS = 4
DEPTH_STEP = 64
INT8_DEPTH_STEP = 128


def bell_work(nb_p, bs: int, *, int8: bool = False) -> np.ndarray:
    """The kernel's work items, [n, 4] int32 (row-block i, first block j0,
    end block j1, alone): each row-block's ``nb_p[i]`` real blocks in runs
    of ``max(1, ITEM_STEPS // steps)`` blocks, in order, ``steps`` the
    depth steps of one block (``cdiv(bs, DEPTH_STEP)``; an int8 format's
    ``cdiv(bs, INT8_DEPTH_STEP)``, so its items share fewer row-blocks and
    add fewer int32 atomics); ``alone`` is 1 where the run is its
    row-block's only one (the kernel stores its tile of y; the runs of a
    shared row-block add into the zeroed y).  A row-block with no real
    block has no item."""
    nb = np.asarray(nb_p, np.int64).reshape(-1)
    per = max(1, ITEM_STEPS // cdiv(bs, INT8_DEPTH_STEP if int8 else DEPTH_STEP))
    runs = -(-nb // per)
    i = np.repeat(np.arange(nb.size), runs)
    j0 = (np.arange(i.size) - np.repeat(np.cumsum(runs) - runs, runs)) * per
    return np.stack([i, j0, np.minimum(j0 + per, nb[i]), runs[i] == 1],
                    axis=1).astype(np.int32).reshape(-1, 4)


@dataclasses.dataclass
class BlockEllFormat:
    blkcol: Any   # [MB, BMAX] int32
    blkvals: Any  # [MB, BMAX, BS, BS]  (int8 when row_scale is set)
    nb_p: Any     # [MB] int32: real blocks per row-block, stored first
    work: Any     # [n, 4] int32: the kernel's work items (bell_work)
    shape: tuple[int, int]
    bs: int
    n_blocks: int  # real (non-padding) blocks
    row_scale: Any = None  # [MB, BS] f32: int8 per-output-row scale

    @property
    def device(self) -> torch.device:
        return self.blkcol.device

    @property
    def mb(self) -> int:
        return self.blkcol.shape[0]

    @property
    def bmax(self) -> int:
        return self.blkcol.shape[1]

    @property
    def padding_rate(self) -> float:
        return (self.mb * self.bmax) / max(self.n_blocks, 1)

    @property
    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in (self.blkcol, self.blkvals))


def pack_block_ell(mat: CooMatrix, *, bs: int = 128, dtype=torch.float32,
                   device="cuda") -> BlockEllFormat:
    """Pack a COO matrix into BlockEllFormat on ``device``.  The arrays equal
    the JAX packer's (tpusparse/kernels/block_ell.py:71): a row-block's
    blocks in block-column order, then zero padding.  ``dtype=torch.int8``
    quantizes symmetrically per output row (``row_scale``)."""
    dev = resolve_device(device)
    dt = storage_dtype(dtype)
    m, n = mat.shape
    mb = cdiv(max(m, 1), bs)
    rows, cols, vals = np.asarray(mat.rows), np.asarray(mat.cols), np.asarray(mat.vals)
    nb_cols = cdiv(max(n, 1), bs)
    blk_id = (rows // bs) * nb_cols + cols // bs
    order = np.argsort(blk_id, kind="stable")
    blk_sorted = blk_id[order]
    uniq = np.unique(blk_sorted)
    n_blocks = uniq.size
    u_br = (uniq // nb_cols).astype(np.int64)
    counts = np.bincount(u_br, minlength=mb)
    bmax = max(int(counts.max(initial=0)), 1)
    # slot of each block within its row-block: its rank there (uniq is
    # sorted by row-block, then block-column)
    slot = np.arange(n_blocks) - np.searchsorted(u_br, u_br)
    blkcol = np.zeros((mb, bmax), dtype=np.int32)
    blkcol[u_br, slot] = uniq % nb_cols
    blkvals = np.zeros((mb, bmax, bs, bs), dtype=np.float32)
    b_of_nz = np.searchsorted(uniq, blk_sorted)
    np.add.at(blkvals, (u_br[b_of_nz], slot[b_of_nz], rows[order] % bs, cols[order] % bs),
              vals[order].astype(np.float32))
    row_scale = None
    if dt == torch.int8:
        blkvals, rs = quantize_rows(blkvals, axes=(1, 3))
        row_scale = torch.from_numpy(rs).to(dev)
    return BlockEllFormat(blkcol=torch.from_numpy(blkcol).to(dev),
                          blkvals=torch.from_numpy(blkvals).to(dev, dt),
                          nb_p=torch.from_numpy(counts.astype(np.int32)).to(dev),
                          work=torch.from_numpy(bell_work(counts, bs,
                                                          int8=dt == torch.int8)).to(dev),
                          shape=(m, n), bs=bs, n_blocks=int(n_blocks), row_scale=row_scale)


def block_ell_format_from_numpy(fields: dict, *, device="cuda", **static) -> BlockEllFormat:
    """A BlockEllFormat from numpy arrays — the JAX ``BlockEllFormat``'s
    ``blkcol``, ``blkvals`` and ``row_scale`` (None for float values) — plus
    its static fields (``shape``, ``bs``, ``n_blocks``).  ``nb_p`` is each
    row-block's last slot holding a nonzero value, plus one, unless given.
    The arrays come from outside this package, so their shapes and indices
    are checked here: the kernel reads X at these block-columns without
    bounds checks."""
    dev = resolve_device(device)
    blkcol, blkvals = np.asarray(fields["blkcol"]), np.asarray(fields["blkvals"])
    rs = fields.get("row_scale")
    (m, n), bs = static["shape"], static["bs"]
    mb = cdiv(max(m, 1), bs)
    if blkcol.ndim != 2 or blkcol.shape[0] != mb or \
            blkvals.shape != blkcol.shape + (bs, bs):
        raise ValueError(f"BlockEllFormat: blkcol {blkcol.shape}, blkvals {blkvals.shape} "
                         f"for {m}x{n} at bs={bs}")
    if blkcol.min(initial=0) < 0 or blkcol.max(initial=0) >= cdiv(max(n, 1), bs):
        raise ValueError("BlockEllFormat block-columns out of range")
    if fields.get("nb_p") is not None:
        nb_p = np.asarray(fields["nb_p"])
    else:
        live = (blkvals != 0).any(axis=(2, 3))
        nb_p = np.where(live.any(axis=1), blkcol.shape[1] - np.argmax(live[:, ::-1], axis=1), 0)
    if nb_p.shape != (mb,) or nb_p.min(initial=0) < 0 or nb_p.max(initial=0) > blkcol.shape[1]:
        raise ValueError("BlockEllFormat.nb_p out of range")
    if blkvals.dtype == np.int8:
        rs = np.asarray(rs, np.float32) if rs is not None else None
        if rs is None or rs.shape != (mb, bs):
            raise ValueError("int8 BlockEllFormat values need row_scale [MB, BS]")
        vt, dt = torch.tensor(blkvals), torch.int8
    else:
        if rs is not None:
            raise ValueError("row_scale belongs to int8 values only")
        dt = storage_dtype(blkvals.dtype.name)
        vt = torch.tensor(blkvals.astype(np.float32))
    return BlockEllFormat(blkcol=torch.tensor(blkcol, dtype=torch.int32, device=dev),
                          blkvals=vt.to(dev, dt),
                          nb_p=torch.tensor(nb_p, dtype=torch.int32, device=dev),
                          work=torch.from_numpy(bell_work(nb_p, bs, int8=dt == torch.int8)).to(dev),
                          shape=(m, n),
                          bs=bs, n_blocks=int(static["n_blocks"]),
                          row_scale=None if rs is None else torch.tensor(rs, device=dev))


# --------------------------------------------------------------- plain version

def bell_rows_plain(blkcol, blkvals, nb_p, x, *, mode):
    """Plain PyTorch ``_bell_kernel``: y [MB*BS, K] from the gathered X
    tiles and one batched product.  ``fp32``: in fp32; ``bf16``: the values
    and X rounded to bf16 first (exact products, fp32 sums); ``int8``: int8
    values and X, the sums exact in float64 (each below 2**53) and returned
    as int32.  The padded slots past ``nb_p`` hold zero blocks."""
    mb, bmax, bs, _ = blkvals.shape
    k = x.shape[1]
    wide = torch.float64 if mode == "int8" else torch.float32
    a, xv = blkvals.to(wide), x.to(wide)
    if mode == "bf16":
        a, xv = a.bfloat16().float(), xv.bfloat16().float()
    gx = xv.view(-1, bs, k).index_select(0, blkcol.reshape(-1).long())
    y = torch.bmm(a.permute(0, 2, 1, 3).reshape(mb, bs, bmax * bs),
                  gx.reshape(mb, bmax * bs, k)).reshape(mb * bs, k)
    return y.round().to(torch.int32) if mode == "int8" else y


# ---------------------------------------------------------------- CUDA kernel

@functools.cache
def _lib():
    """csrc/block_ell.cu, built at first use, with its C signatures."""
    lib = build.library("block_ell")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bell_spmm_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.bell_spmm_launch.restype = i32
    lib.bell_spmm_info.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.bell_spmm_info.restype = i32
    return lib


MODE_CODES = {"fp32": 0, "bf16": 1, "int8": 2}
#: the value type each mode's kernel reads (the wrapper casts a plane of
#: the other float type once: bf16 rounds to nearest even, fp32 widens)
MODE_VALS = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def bell_kernel_info(mode: str) -> dict:
    """The kernel of ``mode`` on the current card: registers and spilled
    (local) bytes a thread, static and dynamic shared bytes, blocks an SM
    holds."""
    out = (ctypes.c_int * 5)()
    rc = _lib().bell_spmm_info(MODE_CODES[mode], out)
    if rc:
        raise RuntimeError(f"bell_spmm_info failed with CUDA error {rc}")
    return dict(zip(("registers", "spill_bytes", "static_shared_bytes", "dynamic_shared_bytes",
                     "blocks_per_sm"), out))


def bell_rows_cuda(blkcol, blkvals, nb_p, x, *, mode, work):
    """CUDA ``_bell_kernel`` (tpusparse/kernels/block_ell.py:136): y
    [MB*BS, K], fp32 (X fp32, ``fp32``/``bf16`` mode) or int32 (X and the
    values int8, ``int8`` mode); X has NB*BS rows, BS a multiple of 32;
    ``work`` the format's work items (``bell_work(nb_p, BS)``).  The
    tensor cores take bf16 X (cast here once, rows padded to 16 bytes),
    fp32 X padded to 4 columns, or int8 X^T [K, NB*BS] (``x.t()`` made
    contiguous here: free where X is a transposed view of a contiguous
    X^T, as ``bell_int8`` passes it).  The returned y is the first K
    columns of [MB*BS, round_up(K, 4)]."""
    mb, bmax, bs, _ = blkvals.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, X is on {dev}")
    xdt = torch.int8 if mode == "int8" else torch.float32
    for name, t, ok, shp in (("blkcol", blkcol, blkcol.dtype == torch.int32, (mb, bmax)),
                             ("blkvals", blkvals, blkvals.dtype in MODE_VALS.values(),
                              (mb, bmax, bs, bs)),
                             ("nb_p", nb_p, nb_p.dtype == torch.int32, (mb,)),
                             ("work", work, work.dtype == torch.int32, (work.shape[0], 4))):
        if t.device != dev or not ok or tuple(t.shape) != shp or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor {shp} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype != xdt or x.ndim != 2 or x.shape[0] % bs:
        raise ValueError(f"X must be a 2-D {xdt} tensor of whole blocks, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if mode not in MODE_CODES or bs % 32 or (mode == "int8") != (blkvals.dtype == torch.int8):
        raise ValueError(f"block-ELL kernel: mode {mode!r}, bs {bs}, values {blkvals.dtype}")
    k = x.shape[1]
    ldy = round_up(k, 4)
    if mode == "int8":
        xk = x.t().contiguous()
    elif mode == "bf16":
        xk = pad_dense_cols(x, round_up(k, 8)).to(torch.bfloat16).contiguous()
    else:
        xk = pad_dense_cols(x, ldy).contiguous()
    if xk.data_ptr() % 16:
        xk = xk.clone()
    a = blkvals.to(MODE_VALS[mode]).contiguous()
    y = torch.zeros((mb * bs, ldy), dtype=torch.int32 if mode == "int8" else torch.float32,
                    device=dev)
    launch_checked(_lib().bell_spmm_launch, "bell_spmm_launch", (blkcol, a, work, xk, y),
                   (work.shape[0], bmax, bs, k, xk.shape[1], ldy, MODE_CODES[mode]))
    bell_rows_cuda.launches += 1
    return y[:, :k]


bell_rows_cuda.launches = 0


# ---------------------------------------------------------------- entry points

def _bell_rows(fmt: BlockEllFormat, x, mode):
    if fmt.device.type == "cuda":
        return bell_rows_cuda(fmt.blkcol, fmt.blkvals, fmt.nb_p, x, mode=mode, work=fmt.work)
    return bell_rows_plain(fmt.blkcol, fmt.blkvals, fmt.nb_p, x.contiguous(), mode=mode)


def bell_batched(fmt: BlockEllFormat, x: torch.Tensor, mode: str) -> torch.Tensor:
    """The ``xla`` method (tpusparse/kernels/block_ell.py:184): every
    slot's X tile gathered, then one batched product per row-block over
    its BMAX*BS contraction, fp32 result."""
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    mb, bmax, bs = fmt.mb, fmt.bmax, fmt.bs
    k = x.shape[1]
    gx = x.to(dt).view(-1, bs, k).index_select(0, fmt.blkcol.reshape(-1).long())
    a = fmt.blkvals.to(dt).permute(0, 2, 1, 3).reshape(mb, bs, bmax * bs)
    return matmul_f32(a, gx.reshape(mb, bmax * bs, k)).reshape(mb * bs, k)


def bell_int8(fmt: BlockEllFormat, x: torch.Tensor) -> torch.Tensor:
    """``_bell_xla_int8`` (tpusparse/kernels/block_ell.py:200): X quantized
    per column (scale max|x[:, k]| / 127, rounded half to even), the
    int8 . int8 -> int32 product, then the rank-1 rescale.  The
    quantization writes X^T [K, NB*BS] (the kernel's int8 operand is
    K-major) and hands the product its transposed view, so X is
    transposed in the pass that quantizes it."""
    x_amax = x.abs().amax(dim=0)
    x_scale = torch.where(x_amax > 0, x_amax / 127.0, torch.ones_like(x_amax))
    xq_t = torch.clamp(torch.round(x.t() / x_scale.view(-1, 1)), -127, 127).to(
        torch.int8).contiguous()
    idot = _bell_rows(fmt, xq_t.t(), "int8")
    return idot.float() * fmt.row_scale.reshape(-1, 1) * x_scale.view(1, -1)


def block_ell_spmm(fmt: BlockEllFormat, x, *, ktile: int | None = None,
                   precision: str = "bf16", method: str | None = None) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in BlockEllFormat.  ``method='pallas'``
    runs the kernel (#13), ``'xla'`` the JAX package's default, the batched
    product; None (the default) takes ``CARD_GATES.block_ell_method``, the
    kernel, which beats the batched product on the card in bf16 and fp32
    (PERF.md, "Gates").  int8 formats run the quantized integer product on
    the kernel whatever ``precision`` and ``method`` say.  ``ktile`` was
    the TPU kernel's K tile and changes nothing here.  CUDA formats run on
    the card, CPU formats the plain versions."""
    assert precision in PRECISIONS, precision
    if method is None:
        method = CARD_GATES.block_ell_method
    if method not in ("xla", "pallas"):
        raise ValueError(f"method {method!r}: 'xla' or 'pallas'")
    m, n = fmt.shape
    x = prep_x(x, fmt.device)
    k = x.shape[1]
    assert x.shape[0] == n, f"X rows {x.shape[0]} != A cols {n}"
    x = pad_dense_rows(x, cdiv(max(n, 1), fmt.bs) * fmt.bs).contiguous()
    if fmt.row_scale is not None:
        return bell_int8(fmt, x)[:m, :k]
    assert precision != "int8", (
        "precision='int8' needs an int8-packed format: pack_block_ell(dtype=torch.int8)")
    if method == "xla":
        return bell_batched(fmt, x, precision)[:m, :k]
    return _bell_rows(fmt, x, precision)[:m, :k]
