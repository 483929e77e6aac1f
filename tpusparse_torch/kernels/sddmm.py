"""sddmm — the value and input gradients of a span-format SpMM with
trainable values (counterpart of ``tpusparse/kernels/sddmm.py``).

For ``Y = A(v) @ X`` with a FIXED sparsity pattern and trainable values v
(pruned-weight fine-tuning):

  dv[nz=(r,c)] = sum_k dY[r,k] * X[c,k]          (SDDMM, sampled at A)
  dX[c,k]      = sum_{nz=(r,c)} v[nz] * dY[r,k]  (A^T @ dY, same layout)

Both run on the span format of ``pack_span(keep_perm=True)``, so the value
parameter is the packed [P, NC, G] plane itself: no repacking per step and
no transposed format.  dY enters in slot order (``dy_slots`` [P*RB, K]:
row p*rb + lrow of a slot is its row of Y), gathered once per backward
through ``origrow_of_slot``.  Padding slots of ``span_sddmm`` get what
their aliased indices compute; the caller masks with ``occupancy_mask``.

Kernels (CUDA C++, ``tpusparse_torch/csrc/sddmm.cu``), each beside its
plain PyTorch version of the same function:

  sddmm_rows_cuda / sddmm_rows_plain  replace ``_sddmm_kernel``
  dx_rows_cuda    / dx_rows_plain     replace ``_dx_kernel``

``sddmm_rows_cuda`` samples through the pattern's tile index
(``sddmm_tiles``, kept on the format as ``fmt.tiles``): the (dY_slots row,
X column) space cut into tiles of ``TILE_ROWS`` x ``TILE_COLS``, every
walked slot listed by tile, the tiles that hold the most slots first.  A
tile holding at least ``TILE_MIN_SLOTS[mode]`` slots is computed whole on
the tensor cores from operand panels staged in shared memory, and its
slots read their entries; the slots of sparser tiles take one dot product
each (``sddmm_tiles_plain`` is the same function in plain PyTorch, tile
by tile).  A wrapper launches its kernel for CUDA tensors and raises on
any failure; only CPU tensors take the plain version.  The TPU's bf16
hi/lo packing and its one-hot gathers are not ported: fp32 and fp32x2
compute in fp32's class (3xTF32 in the tile kernel), bf16 rounds where the
TPU kernels' bf16 operands did (csrc/sddmm.cu).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, kernel_info, launch_checked,
                                            pad_dense_cols, prep_x)
from tpusparse_torch.kernels.row_walk import version_of
from tpusparse_torch.kernels.span_gather import (SpanFormat, pack_span, slot_rows_cols,
                                                 with_values)
from tpusparse_torch.kernels.tile_onehot import PRECISIONS, choose_kt, default_ktile

#: the tile kernel's tile: rows of dY_slots by columns of X (csrc/sddmm.cu)
TILE_ROWS, TILE_COLS = 128, 64
#: by mode, the fewest slots a tile holds that the tile kernel computes
#: whole; a sparser tile's slots take one dot product each.  Where the
#: two paths cost the same at the trainable 4096^2 layer, K = 512 (a tile
#: of the 3xTF32 kernel as much as 580 per-slot dots, of the bf16 one
#: 310; measured on the card, PERF.md)
TILE_MIN_SLOTS = {"fp32": 576, "fp32x2": 576, "bf16": 320}


# ------------------------------------------------------------------ host helpers

def occupancy_mask(fmt: SpanFormat) -> np.ndarray:
    """[P, NC, G] float32 1.0 where a real nz lives (0 = padding slot).
    Built from the packing permutation, NOT from vals != 0: a stored zero
    value is still a real (trainable) position."""
    assert fmt.perm_of_nz is not None, "pack_span(..., keep_perm=True) required"
    ones = np.ones(len(fmt.perm_of_nz), dtype=np.float32)
    return with_values(fmt, ones).vals.float().cpu().numpy()


def origrow_of_slot(fmt: SpanFormat) -> np.ndarray:
    """[P*RB] int32 inverse of slot_of_origrow; slots without a row hold M
    (one past the last row, where the gather reads a zero row)."""
    m = fmt.shape[0]
    slot = fmt.slot_of_origrow.cpu().numpy()
    inv = np.full(fmt.n_programs * fmt.rb, m, dtype=np.int32)
    valid = slot >= 0
    inv[slot[valid]] = np.arange(m, dtype=np.int32)[valid]
    return inv


def rows_to_slots(y: torch.Tensor, inv_slot: torch.Tensor) -> torch.Tensor:
    """[P*RB, K] rows of ``y`` [M, K] in slot order (``inv_slot`` from
    ``origrow_of_slot``, as a long tensor on y's device); M reads zeros."""
    y = y.to(torch.float32)
    padded = torch.cat([y, y.new_zeros((1,) + tuple(y.shape[1:]))])
    return padded.index_select(0, inv_slot).contiguous()


def packed_to_nz(fmt: SpanFormat, packed) -> torch.Tensor:
    """Export: the packed [P, NC, G] plane as values in the nonzero order
    given to pack_span (for checkpointing back to COO), an fp32 tensor on
    the plane's device (the CPU for a numpy plane)."""
    assert fmt.perm_of_nz is not None, "pack_span(..., keep_perm=True) required"
    if not isinstance(packed, torch.Tensor):
        packed = torch.from_numpy(np.array(packed, dtype=np.float32))
    flat = packed.to(torch.float32).reshape(-1)
    return flat[torch.as_tensor(fmt.perm_of_nz, dtype=torch.long, device=flat.device)]


# ------------------------------------------------------------------ tile index

@dataclasses.dataclass(frozen=True)
class SddmmTiles:
    """Every walked slot of a span pattern (a chunk before ``nc_p``, a
    column of X) listed by tile of ``TILE_ROWS`` dY_slots rows x
    ``TILE_COLS`` X columns, on the format's device:

      row   [S] int32  the slot's row of dY_slots (p * rb + lrow)
      col   [S] int32  its column c0 + cols, a row of X
      slot  [S] int32  its flat index in the [P, NC, G] plane
      tiles [H, 4] int32  each tile that holds a slot: first row, first
                          column and the range [start, end) of its slots
                          in the lists

    The tiles run from the one that holds the most slots down (by position
    where they hold as many), each tile's slots together and rising, so the
    tiles dense at any threshold are a prefix of ``tiles`` and their slots
    a prefix of the lists (``dense``).  ``counts`` (numpy, host) is each
    tile's slot count.  ``pattern`` (the index planes it was derived from)
    and ``versions`` (their version counters then) tie it to the planes as
    they stood; ``n_rows`` (P * rb), ``n_cols`` (X's rows) and
    ``plane_slots`` (P * NC * G) to its format."""

    row: Any
    col: Any
    slot: Any
    tiles: Any
    counts: Any
    pattern: tuple
    versions: tuple
    n_rows: int
    n_cols: int
    plane_slots: int
    build_seconds: float

    @property
    def n_slots(self) -> int:
        return self.row.numel()

    @property
    def n_hit_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def nbytes(self) -> int:
        return 12 * self.n_slots + 16 * self.n_hit_tiles

    def dense(self, min_slots: int) -> tuple[int, int]:
        """(T, D): the T tiles that hold at least ``min_slots`` slots, the
        first T of ``tiles``, and their D slots, the first D of the lists."""
        t = int(np.searchsorted(-self.counts, -min_slots, side="right"))
        return t, int(self.counts[:t].sum())

    def built_from(self, pattern) -> bool:
        """Whether the index was derived from the index planes ``pattern``
        as they stand: the same tensors, not written since."""
        return (len(pattern) == len(self.pattern)
                and all(a is b for a, b in zip(pattern, self.pattern))
                and tuple(map(version_of, pattern)) == self.versions)


def build_sddmm_tiles(c0, cols, lrow, nc_p, *, rb, n) -> SddmmTiles:
    """The tile index of span planes for X of ``n`` rows, derived on their
    device with torch ops."""
    t0 = time.perf_counter()
    P, NC, G = cols.shape
    if P * NC * G >= 2 ** 31:
        raise ValueError(f"{P * NC * G} slots: the tile index lists them with int32")
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    idx = torch.nonzero(walked & (col < n)).reshape(-1)            # rising slots
    row, col = row[idx], col[idx]
    n_tc = cdiv(n, TILE_COLS)
    key, order = torch.sort((row // TILE_ROWS) * n_tc + col // TILE_COLS, stable=True)
    keys, counts = torch.unique_consecutive(key, return_counts=True)
    # the tiles by falling count, each tile's slots together and rising
    by_count = torch.sort(counts, descending=True, stable=True)[1]
    rank = torch.empty_like(by_count)
    rank[by_count] = torch.arange(len(by_count), device=by_count.device)
    order = order[torch.sort(rank.repeat_interleave(counts), stable=True)[1]]
    idx, row, col = idx[order], row[order], col[order]
    keys, counts = keys[by_count], counts[by_count]
    ends = torch.cumsum(counts, 0)
    tiles = torch.stack([(keys // n_tc) * TILE_ROWS, (keys % n_tc) * TILE_COLS, ends - counts,
                         ends], dim=1).to(torch.int32).contiguous()
    pattern = (c0, cols, lrow, nc_p)
    index = SddmmTiles(row=row.to(torch.int32).contiguous(), col=col.to(torch.int32).contiguous(),
                       slot=idx.to(torch.int32).contiguous(), tiles=tiles,
                       counts=counts.cpu().numpy(), pattern=pattern,
                       versions=tuple(map(version_of, pattern)), n_rows=P * rb, n_cols=n,
                       plane_slots=P * NC * G, build_seconds=0.0)
    return dataclasses.replace(index, build_seconds=time.perf_counter() - t0)


def sddmm_tiles(fmt: SpanFormat) -> SddmmTiles:
    """The format's tile index, built at first use and kept on the format
    (``fmt.tiles``); built anew where an index plane was replaced or
    written in place since (dv reads no values: they change nothing)."""
    pattern = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    if fmt.tiles is None or not fmt.tiles.built_from(pattern):
        fmt.tiles = build_sddmm_tiles(*pattern, rb=fmt.rb, n=fmt.shape[1])
    return fmt.tiles


# --------------------------------------------------------------- plain versions

def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def sddmm_rows_plain(c0, cols, lrow, nc_p, dy_slots, x, *, rb, kt, mode):
    """Plain PyTorch ``_sddmm_kernel``: dv [P, NC, G] with ``dv = sum_k
    dY_slots[p*rb + lrow, k] * X[c0 + cols, k]`` at every slot of a chunk
    before ``nc_p`` (0 past it, and at a column past X); bf16 rounds X and
    dY before the products.  ``kt`` changes nothing."""
    P, NC, G = cols.shape
    n = x.shape[0]
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    live = walked & (col < n)
    gx = x.index_select(0, col[live])
    gd = dy_slots.index_select(0, row[live])
    if mode == "bf16":
        gx, gd = _bf16(gx), _bf16(gd)
    dv = torch.zeros(P * NC * G, dtype=torch.float32, device=x.device)
    dv[live] = (gx * gd).sum(dim=1)
    return dv.reshape(P, NC, G)


def sddmm_tiles_plain(tiles: SddmmTiles, dy_slots, x, *, mode, min_slots=None) -> torch.Tensor:
    """The tile kernel's function in plain PyTorch, tile by tile: dv [P *
    NC * G] (flat; 0 off the index) with the product of each tile that
    holds at least ``min_slots`` slots (default ``TILE_MIN_SLOTS[mode]``)
    computed whole from its dY_slots and X rows and sampled at its slots,
    and each other slot's dot product; bf16 rounds X and dY before the
    products."""
    n_dense, d = tiles.dense(TILE_MIN_SLOTS[mode] if min_slots is None else min_slots)
    if mode == "bf16":
        dy_slots, x = _bf16(dy_slots), _bf16(x)
    dv = torch.zeros(tiles.plane_slots, dtype=torch.float32, device=x.device)
    row, col, slot = tiles.row.long(), tiles.col.long(), tiles.slot.long()
    if n_dense:
        t = tiles.tiles[:n_dense].long()
        # a zero row past dY's and X's last, for the rows a tile runs past
        dyz = torch.cat([dy_slots, dy_slots.new_zeros((1, dy_slots.shape[1]))])
        xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        rr = (t[:, :1] + torch.arange(TILE_ROWS, device=t.device)).clamp(max=dy_slots.shape[0])
        cc = (t[:, 1:2] + torch.arange(TILE_COLS, device=t.device)).clamp(max=x.shape[0])
        prod = torch.bmm(dyz[rr], xz[cc].transpose(1, 2))          # [T, rows, cols]
        tile_of = torch.repeat_interleave(torch.arange(len(t), device=t.device), t[:, 3] - t[:, 2])
        dv[slot[:d]] = prod[tile_of, row[:d] - t[tile_of, 0], col[:d] - t[tile_of, 1]]
    dv[slot[d:]] = (dy_slots[row[d:]] * x[col[d:]]).sum(dim=1)
    return dv


def dx_rows_plain(c0, cols, lrow, vals, nc_p, dy_slots, *, n, rb, kt, mode):
    """Plain PyTorch ``_dx_kernel``: dX [n, Kp] with ``dX[c0 + cols] +=
    vals * dY_slots[p*rb + lrow]`` over the slots whose value is not zero in
    a chunk before ``nc_p``, as an ``index_add_``; bf16 rounds dY and then
    each product.  ``kt`` changes nothing."""
    col, row, walked = slot_rows_cols(c0, cols, lrow, nc_p, rb)
    v = vals.reshape(-1).float()
    live = walked & (v != 0) & (col < n)
    gd = dy_slots.index_select(0, row[live])
    if mode == "bf16":
        prod = _bf16(v[live].view(-1, 1) * _bf16(gd))
    else:
        prod = v[live].view(-1, 1) * gd
    dx = torch.zeros((n, dy_slots.shape[1]), dtype=torch.float32, device=dy_slots.device)
    return dx.index_add_(0, col[live], prod)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/sddmm.cu, built at first use, with its C signatures."""
    lib = build.library("sddmm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sddmm_launch, lib.dx_launch):
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        fn.restype = i32
    lib.sddmm_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.sddmm_info.restype = i32
    return lib


def sddmm_info(kind: str, mode: str) -> dict:
    """The tile kernel (``kind`` "tile") or the per-slot kernel ("slot") of
    ``mode``: registers a thread, spilled (local) bytes a thread, static
    shared bytes and blocks an SM holds."""
    return kernel_info(_lib().sddmm_info, "sddmm_info", ("tile", "slot").index(kind),
                       int(mode == "bf16"))


def _check(c0, cols, lrow, nc_p, dy_slots, rb, kt, mode, extra=()):
    P, NC, G = cols.shape
    check_operands(dy_slots, (("c0", c0, torch.int32, (P, 1, NC)),
                              ("cols", cols, torch.int32, (P, NC, G)),
                              ("lrow", lrow, torch.int32, (P, NC, G)),
                              ("nc_p", nc_p, torch.int32, (P, 1, 1)), *extra), ndim=2)
    kp = dy_slots.shape[1]
    if kt not in (8, 16, 32) or mode not in PRECISIONS or kp % kt or \
            dy_slots.shape[0] != P * rb:
        raise ValueError(f"sddmm kernels: kt={kt}, mode={mode}, dY_slots "
                         f"{tuple(dy_slots.shape)} for P={P}, rb={rb}")
    return P, NC, G, kp


def sddmm_rows_cuda(c0, cols, lrow, nc_p, dy_slots, x, *, rb, kt, mode, tiles=None,
                    min_slots=None):
    """CUDA ``_sddmm_kernel`` (tpusparse/kernels/sddmm.py:72): dv [P, NC,
    G] for dY_slots [P*rb, Kp] and X [N, Kp] fp32, Kp a multiple of kt in
    {8, 16, 32}, through ``tiles``, the pattern's tile index
    (``sddmm_tiles(fmt)``; one built from other planes, or before they were
    written, is refused): the tile kernel over the tiles that hold at least
    ``min_slots`` slots (default ``TILE_MIN_SLOTS[mode]``), the per-slot
    kernel over the rest of the slots."""
    P, NC, G, kp = _check(c0, cols, lrow, nc_p, dy_slots, rb, kt, mode)
    n = x.shape[0]
    if x.device != dy_slots.device or x.dtype != torch.float32 or x.ndim != 2 or \
            x.shape[1] != kp or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"X must be a contiguous, 16-byte aligned float32 [N, {kp}] "
                         f"tensor on {dy_slots.device}")
    if not isinstance(tiles, SddmmTiles):
        raise ValueError("sddmm_rows_cuda samples through the pattern's tile index: pass tiles=")
    if not tiles.built_from((c0, cols, lrow, nc_p)):
        raise ValueError("sddmm_rows_cuda: the tile index was not built from these index planes "
                         "as they stand (take it from sddmm_tiles)")
    if (tiles.row.device != x.device or tiles.plane_slots != P * NC * G
            or tiles.n_rows != P * rb or tiles.n_cols != n or tiles.tiles.data_ptr() % 16):
        raise ValueError(f"sddmm_rows_cuda: the tile index ({tiles.plane_slots} slots, "
                         f"{tiles.n_rows} rows, {tiles.n_cols} columns, on {tiles.row.device}) "
                         "is not this format's")
    n_dense, d = tiles.dense(TILE_MIN_SLOTS[mode] if min_slots is None else min_slots)
    dv = torch.zeros((P, NC, G), dtype=torch.float32, device=x.device)
    launch_checked(_lib().sddmm_launch, "sddmm_launch",
                   (tiles.tiles, tiles.row, tiles.col, tiles.slot, dy_slots, x, dv),
                   (n_dense, d, tiles.n_slots, P * rb, n, kp, int(mode == "bf16")))
    sddmm_rows_cuda.launches += 1
    return dv


def dx_rows_cuda(c0, cols, lrow, vals, nc_p, dy_slots, *, n, rb, kt, mode):
    """CUDA ``_dx_kernel`` (tpusparse/kernels/sddmm.py:167): dX [n, Kp] =
    A(vals)^T . dY over the same span planes, by fp32 atomics (the order
    of the sums varies from run to run)."""
    P, NC, G = cols.shape
    _check(c0, cols, lrow, nc_p, dy_slots, rb, kt, mode,
           (("vals", vals, torch.float32, (P, NC, G)),))
    kp = dy_slots.shape[1]
    dx = torch.zeros((n, kp), dtype=torch.float32, device=dy_slots.device)
    launch_checked(_lib().dx_launch, "dx_launch", (c0, cols, lrow, vals, nc_p, dy_slots, dx),
                   (P, NC, G, rb, n, kp, int(mode == "bf16")))
    dx_rows_cuda.launches += 1
    return dx


sddmm_rows_cuda.launches = 0
dx_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry points

def _k_tile(k: int, ktile: int | None) -> int:
    """The kernels' K-tile: the JAX package's ktile (K up to 128, else 128)
    capped at 32 and snapped to 8, 16 or 32, as span_spmm takes it; K is
    padded to a multiple of it and the kernels loop over the tiles."""
    return choose_kt(min(default_ktile(k) if ktile is None else ktile, 32))


def span_sddmm(fmt: SpanFormat, dy_slots, x, *, ktile: int | None = None,
               precision: str = "fp32x2") -> torch.Tensor:
    """dv [P, NC, G] fp32 = (dY . X^T) sampled at the format's slots.
    ``dy_slots`` [P*RB, K] is dY in slot order (``rows_to_slots``), ``x``
    [N, K] the forward's dense operand.  Padding slots hold what their
    aliased indices compute; mask with ``occupancy_mask``.  CUDA formats
    run the kernel through the format's tile index (built at the first
    call), CPU formats its plain version."""
    assert precision in PRECISIONS, precision
    dev = fmt.device
    x, dy = prep_x(x, dev), prep_x(dy_slots, dev)
    k = x.shape[1]
    assert x.shape[0] == fmt.shape[1], f"X rows {x.shape[0]} != A cols {fmt.shape[1]}"
    assert dy.shape == (fmt.n_programs * fmt.rb, k), f"dY_slots {tuple(dy.shape)}"
    kt = _k_tile(k, ktile)
    kp = cdiv(k, kt) * kt
    x, dy = pad_dense_cols(x, kp).contiguous(), pad_dense_cols(dy, kp).contiguous()
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p, dy, x)
    if dev.type == "cuda":
        return sddmm_rows_cuda(*args, rb=fmt.rb, kt=kt, mode=precision, tiles=sddmm_tiles(fmt))
    return sddmm_rows_plain(*args, rb=fmt.rb, kt=kt, mode=precision)


def span_dx(fmt: SpanFormat, vals, dy_slots, *, ktile: int | None = None,
            precision: str = "fp32x2") -> torch.Tensor:
    """dX [N, K] fp32 = A(vals)^T . dY without a transposed format:
    ``vals`` is the packed [P, NC, G] plane (zero at padding), ``dy_slots``
    dY in slot order [P*RB, K]."""
    assert precision in PRECISIONS, precision
    dev = fmt.device
    if not isinstance(vals, torch.Tensor) or vals.device != dev or \
            vals.shape != fmt.cols.shape:
        raise ValueError(f"vals must be a {tuple(fmt.cols.shape)} tensor on {dev}")
    dy = prep_x(dy_slots, dev)
    k = dy.shape[1]
    assert dy.shape[0] == fmt.n_programs * fmt.rb, f"dY_slots {tuple(dy.shape)}"
    kt = _k_tile(k, ktile)
    dy = pad_dense_cols(dy, cdiv(k, kt) * kt).contiguous()
    rows_fn = dx_rows_cuda if dev.type == "cuda" else dx_rows_plain
    dx = rows_fn(fmt.c0, fmt.cols, fmt.lrow, vals.float().contiguous(), fmt.nc_p, dy,
                 n=fmt.shape[1], rb=fmt.rb, kt=kt, mode=precision)
    return dx[:, :k]


def sddmm(mat, a, b, *, rb: int = 512, ct: int = 512, g: int = 128,
          precision: str = "fp32x2", device="cuda") -> torch.Tensor:
    """Sampled dense-dense matmul: the values of ``a @ b.T`` at ``mat``'s
    nonzeros, in ``mat``'s nz order, as an fp32 tensor on ``device``.
    ``a`` [M, K] and ``b`` [N, K] with ``(M, N) == mat.shape``.  One-shot:
    packs the pattern and runs the span SDDMM kernel; training reuses one
    packing across steps through ``autodiff.spmm_trainable``."""
    m, n = mat.shape
    fmt = pack_span(mat, rb=rb, ct=ct, g=g, keep_perm=True, device=device)
    a, b = prep_x(a, fmt.device), prep_x(b, fmt.device)
    assert a.shape[0] == m and b.shape[0] == n and a.shape[1] == b.shape[1], (
        f"a {tuple(a.shape)} / b {tuple(b.shape)} incompatible with pattern {mat.shape}")
    inv = torch.from_numpy(origrow_of_slot(fmt)).to(fmt.device, torch.long)
    dv = span_sddmm(fmt, rows_to_slots(a, inv), b, precision=precision)
    return packed_to_nz(fmt, dv)
