"""dg_gather — dynamic-gather SpMM/SpMV (counterpart of
``tpusparse/kernels/dg_gather.py``).

The format and its packer are the JAX package's, array for array: rows are
dealt to P programs of ``rb`` rows, each program's nonzeros are sorted by
column and cut into chunks of ``g`` slots whose columns fall in one window
of ``ns`` aligned tiles of ``wt`` columns (``dg_geometry``).  The TPU kernels
needed that window to realize ``x[col]`` as a 128-lane VPU gather; on the
card a thread loads the row of X it needs, so the window only bounds the
chunk.  Keeping the format unchanged lets the tests feed the JAX packer's
arrays to the port's kernels and back (``dg_format_from_numpy``).

Kernels (CUDA C++, ``tpusparse_torch/csrc/dg_gather.cu``), each beside its
plain PyTorch version of the same function:

  dg_rows_cuda   / dg_rows_plain    replace ``_dg_kernel``  (kt 8/16/32,
                                    fp32x2 and bf16): the row walk kernel
                                    over the format's ``dg_row_walk``
  dg1_rows_cuda  / dg1_rows_plain   replace ``_dg1_kernel`` (kt 1, SpMV):
                                    the one-column walk kernel over the
                                    same ``dg_row_walk``

Each computes the pre-unpack row block ``y_rows[p*rb + lrow] += v * X[c0 +
cols]``; ``unpack_by_deal`` then maps program slots back to matrix rows as
torch ops.  A wrapper launches its kernel for CUDA tensors and raises on
any failure; only CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpusparse_torch import native
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, fill_chunks, kernel_info,
                                            lex_order, pad_dense_cols, prep_x, resolve_device,
                                            unpack_by_deal, window_rows_plain)
from tpusparse_torch.kernels.row_walk import (WALK1_GEOMETRY, RowWalk, launch_walk,
                                              launch_walk1, window_row_walk)
from tpusparse_torch.levels import Level

PRECISIONS = ("fp32x2", "bf16")
DG_KTS = (1, 8, 16, 32)


def choose_kt_dg(k: int) -> int:
    """Smallest supported K-tile covering k (k <= 8 pads to kt=8; K=1 has
    its own kernel)."""
    if k == 1:
        return 1
    for kt in (8, 16, 32):
        if k <= kt:
            return kt
    return 32


def dg_geometry(kt: int, mode: str) -> tuple[int, int, int]:
    """(wt, nhl, ngrp): window-tile width, hi/lo planes, output lane groups
    of the TPU kernels.  The packer keeps them because they define the
    format: ``wt`` aligns the chunk windows and ``rb`` must be a multiple of
    ``ngrp``."""
    assert kt in DG_KTS, f"kt={kt} not in {DG_KTS}"
    assert mode in PRECISIONS, mode
    if kt == 1:
        assert mode == "fp32x2", "kt=1 runs the fp32x2 candidate-fold kernel"
        return 1024, 2, 64
    nhl = 2 if mode == "fp32x2" else 1
    assert nhl * kt >= 8, (kt, mode)
    return 128, nhl, 128 // (nhl * kt)


@dataclasses.dataclass
class DgFormat:
    """Aligned-window span-chunked format (P programs, NC chunks, G nz),
    torch tensors on one device:
      c0    [P, 1, NC] int32  window start column (multiple of wt)
      cols  [P, NC, G] int32  column offset within the window (< ns*wt)
      lrow  [P, NC, G] int32  row local to the program (< RB)
      vals  [P, NC, G] f32
      nc_p  [P, 1, 1]  int32  real chunk count
      slot_of_origrow [M] int32
    ``perm_of_nz`` (numpy, host) maps each COO nonzero to its flat slot.
    ``walk`` is the port's own field: the row walk the kernels walk
    (``dg_row_walk``), built on the card at the first launch, not part of
    ``memory_bytes``.
    """

    c0: Any
    cols: Any
    lrow: Any
    vals: Any
    nc_p: Any
    slot_of_origrow: Any
    n_programs: int
    n_chunks: int
    chunk_g: int
    rb: int
    ns: int
    kt: int
    mode: str
    shape: tuple[int, int]
    nnz_real: int
    perm_of_nz: Any = None
    deal: str = "arbitrary"  # 'blocks' | 'index' | 'arbitrary'
    walk: RowWalk | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.c0.device

    @property
    def padding_rate(self) -> float:
        return self.n_programs * self.n_chunks * self.chunk_g / max(self.nnz_real, 1)

    @property
    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.c0, self.cols, self.lrow, self.vals))

    @property
    def window(self) -> int:
        wt, _, _ = dg_geometry(self.kt, self.mode)
        return self.ns * wt


FIELDS = ("c0", "cols", "lrow", "vals", "nc_p", "slot_of_origrow")
_DTYPES = {"c0": torch.int32, "cols": torch.int32, "lrow": torch.int32,
           "vals": torch.float32, "nc_p": torch.int32, "slot_of_origrow": torch.int32}


def dg_format_from_numpy(fields: dict, *, device="cuda", **static) -> DgFormat:
    """A DgFormat from numpy arrays — the JAX ``DgFormat``'s ``c0``,
    ``cols``, ``lrow``, ``vals``, ``nc_p``, ``slot_of_origrow`` and
    ``perm_of_nz`` — plus its static fields (``n_programs``, ``n_chunks``,
    ``chunk_g``, ``rb``, ``ns``, ``kt``, ``mode``, ``shape``, ``nnz_real``,
    ``deal``).  The arrays come from outside this package, so their shapes
    and index ranges are checked here: the kernels read X and write Y at
    these indices without bounds checks."""
    dev = resolve_device(device)
    arrs = {k: np.asarray(fields[k]) for k in FIELDS}
    P, NC, G = static["n_programs"], static["n_chunks"], static["chunk_g"]
    rb, (m, n) = static["rb"], static["shape"]
    want = {"c0": (P, 1, NC), "cols": (P, NC, G), "lrow": (P, NC, G),
            "vals": (P, NC, G), "nc_p": (P, 1, 1), "slot_of_origrow": (m,)}
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"DgFormat.{k}: shape {arrs[k].shape}, want {shp}")
    live = arrs["vals"] != 0
    col = arrs["c0"].reshape(P, NC, 1).astype(np.int64) + arrs["cols"]
    if (live.any() and (col[live].min() < 0 or col[live].max() >= n)) or \
            arrs["lrow"].min(initial=0) < 0 or arrs["lrow"].max(initial=0) >= rb or \
            arrs["nc_p"].min(initial=0) < 0 or arrs["nc_p"].max(initial=0) > NC or \
            arrs["slot_of_origrow"].max(initial=-1) >= P * rb:
        raise ValueError("DgFormat indices out of range")
    tensors = {k: torch.tensor(arrs[k], dtype=_DTYPES[k], device=dev) for k in FIELDS}
    perm = fields.get("perm_of_nz")
    return DgFormat(**tensors, **static,
                    perm_of_nz=None if perm is None else np.asarray(perm))


def _aligned_chunk_numpy(cols_sorted, lrow_sorted, vals_sorted, p_starts, g: int,
                         window: int, align: int, want_dest: bool = False):
    """The aligned-window chunk walk in numpy, the plain version of
    ``native.span_pack_aligned`` (which the packer runs), with its
    signature and returns: per program, cut the column-sorted nonzeros into
    chunks of at most g slots within one aligned window of ``window``
    columns."""
    cols_s = np.asarray(cols_sorted)
    p_count = len(p_starts) - 1
    chunks: list[list[tuple[int, int, int]]] = [[] for _ in range(p_count)]
    for p in range(p_count):
        lo, hi = int(p_starts[p]), int(p_starts[p + 1])
        colp = cols_s[lo:hi]
        i = lo
        while i < hi:
            c0 = int(cols_s[i]) & ~(align - 1)
            j_span = lo + int(np.searchsorted(colp, c0 + window, side="left"))
            j = min(i + g, j_span, hi)
            chunks[p].append((c0, i, j))
            i = j
    return fill_chunks(chunks, cols_s, lrow_sorted, vals_sorted, g, want_dest)


def pack_dg(
    mat_or_ms,
    sub: int = 0,
    *,
    out_rows: int | None = None,
    rb: int = 1024,
    ns: int = 8,
    g: int = 512,
    kt: int = 8,
    mode: str = "fp32x2",
    balance: bool = True,
    deal: str | None = None,
    keep_perm: bool = False,
    device="cuda",
) -> DgFormat:
    """Pack into DgFormat on ``device`` (aligned-window chunking; row
    dealing and the affine-unpack detection as in the JAX packer)."""
    dev = resolve_device(device)
    wt, nhl, ngrp = dg_geometry(kt, mode)
    W = ns * wt
    assert rb % ngrp == 0, f"rb={rb} must be a multiple of ngrp={ngrp}"
    assert g % 128 == 0, f"g={g} must be a multiple of the 128-lane tile"

    if isinstance(mat_or_ms, CooMatrix):
        rows = mat_or_ms.rows.astype(np.int64)
        cols = mat_or_ms.cols.astype(np.int64)
        vals = np.asarray(mat_or_ms.vals)
        row_num, col_num = mat_or_ms.shape
        rec = np.arange(row_num, dtype=np.int64)
        if out_rows is None:
            out_rows = row_num
    else:
        ms = mat_or_ms
        rows, cols, vals = ms.coo(sub)
        rows = rows.astype(np.int64)
        cols = cols.astype(np.int64)
        row_num = ms.row_num(sub)
        col_num = ms.col_num(sub)
        if ms.has(Level.ROW, "original_row_of_sorted", sub):
            rec = ms.get(Level.ROW, "original_row_of_sorted", sub)[:row_num]
        else:
            rec = np.arange(row_num, dtype=np.int64)
        assert out_rows is not None

    p_count = max(-(-row_num // rb), 1)
    if deal is None:
        deal = "length" if (balance and p_count > 1) else "blocks"
    assert deal in ("length", "index", "blocks"), deal

    if deal == "length" and row_num:
        lengths = np.bincount(rows, minlength=row_num)
        by_len = np.argsort(-lengths, kind="stable")
        p_of_row = np.empty(row_num, dtype=np.int64)
        lrow_of_row = np.empty(row_num, dtype=np.int64)
        ranks = np.arange(row_num)
        p_of_row[by_len] = ranks % p_count
        lrow_of_row[by_len] = ranks // p_count
        p_arr = p_of_row[rows]
        lrow_arr = lrow_of_row[rows]
        slot_of_local = p_of_row * rb + lrow_of_row
    elif deal == "index" and row_num:
        p_arr = rows % p_count
        lrow_arr = rows // p_count
        r = np.arange(row_num)
        slot_of_local = (r % p_count) * rb + r // p_count
    else:
        p_arr = rows // rb
        lrow_arr = rows % rb
        slot_of_local = (np.arange(row_num) // rb) * rb + np.arange(row_num) % rb
    order = lex_order(cols, p_arr)
    lrow_s, cols_s, vals_s = lrow_arr[order], cols[order], np.asarray(vals)[order]
    starts = np.searchsorted(p_arr[order], np.arange(p_count + 1))

    packed = native.span_pack_aligned(cols_s, lrow_s, vals_s, starts, g, W, wt,
                                      want_dest=keep_perm)
    c0_2d, cols_f, lrow_f, vals_f, nc_arr = packed[:5]
    dest_sorted = packed[5] if keep_perm else None
    nc = c0_2d.shape[1]

    slot_of_origrow = np.full(out_rows, -1, dtype=np.int32)
    keep = rec >= 0
    slot_of_origrow[rec[keep]] = slot_of_local[keep].astype(np.int32)

    def _affine_ok(aff):
        if out_rows > p_count * rb:
            return False
        got = slot_of_origrow >= 0
        if not np.array_equal(slot_of_origrow[got], aff[got]):
            return False
        occ = np.zeros(p_count * rb, dtype=bool)
        occ[slot_of_origrow[got]] = True
        return not occ[aff[~got]].any()

    unpack = "arbitrary"
    ar = np.arange(out_rows, dtype=np.int64)
    if deal == "blocks" and _affine_ok(ar):
        unpack = "blocks"
    elif deal == "index" and _affine_ok((ar % p_count) * rb + ar // p_count):
        unpack = "index"

    def dev_t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return DgFormat(
        c0=dev_t(c0_2d[:, None, :], torch.int32),
        cols=dev_t(cols_f, torch.int32),
        lrow=dev_t(lrow_f, torch.int32),
        vals=dev_t(vals_f, torch.float32),
        nc_p=dev_t(np.asarray(nc_arr, np.int32).reshape(p_count, 1, 1), torch.int32),
        slot_of_origrow=dev_t(slot_of_origrow, torch.int32),
        n_programs=p_count,
        n_chunks=nc,
        chunk_g=g,
        rb=rb,
        ns=ns,
        kt=kt,
        mode=mode,
        shape=(out_rows, col_num),
        nnz_real=int(np.count_nonzero(vals_f)),
        perm_of_nz=(None if dest_sorted is None
                    else np.asarray(dest_sorted)[np.argsort(order, kind="stable")]),
        deal=unpack,
    )


def with_values(fmt: DgFormat, new_vals) -> DgFormat:
    """Values-only update (same pattern; requires pack_dg(keep_perm=True)).
    The row walk, of the pattern, is carried over with the new values."""
    assert fmt.perm_of_nz is not None, "pack_dg(..., keep_perm=True) required"
    new_vals = np.asarray(new_vals, dtype=np.float32)
    flat = np.zeros(fmt.n_programs * fmt.n_chunks * fmt.chunk_g, dtype=np.float32)
    flat[np.asarray(fmt.perm_of_nz)] = new_vals
    vals = torch.from_numpy(flat.reshape(fmt.n_programs, fmt.n_chunks, fmt.chunk_g))
    vals = vals.to(fmt.device)
    return dataclasses.replace(fmt, vals=vals, nnz_real=int(np.count_nonzero(flat)),
                               walk=None if fmt.walk is None else fmt.walk.for_plane(vals))


# ------------------------------------------------------------------- row walk

def dg_row_walk(fmt: DgFormat) -> RowWalk:
    """The format's row walk (``row_walk.window_row_walk``): the live slots
    with their y_rows row ``p*rb + lrow`` and X column ``c0 + cols``, as
    ``dg_rows_plain`` decodes them, sorted by (row, slot); built at first
    use and kept on the format, built anew where a plane was replaced or
    written in place since."""
    return window_row_walk(fmt)


# --------------------------------------------------------------- plain versions

def dg_rows_plain(c0, cols, lrow, vals, nc_p, x, *, rb, kt, mode):
    """Plain PyTorch ``_dg_kernel``: y_rows [P*rb, Kp] with
    ``y_rows[p*rb + lrow] += vals * X[c0 + cols]`` over the slots whose value
    is not zero in a chunk before ``nc_p`` (bf16 rounds each product as the
    kernel does); ``kt`` changes nothing."""
    return window_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=rb, bf16=mode == "bf16")


def dg1_rows_plain(c0, cols, lrow, vals, nc_p, x, *, rb):
    """Plain PyTorch ``_dg1_kernel``: y_rows [P*rb] for x [N]."""
    return window_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=rb)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/dg_gather.cu, built at first use, with its C signatures."""
    lib = build.library("dg_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dg_walk_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.dg_walk_launch.restype = i32
    lib.dg_walk_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.dg_walk_info.restype = i32
    lib.dg_spmv_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.dg_spmv_launch.restype = i32
    lib.dg_walk1_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.dg_walk1_info.restype = i32
    return lib


def _check_format(c0, cols, lrow, vals, nc_p, x, ndim):
    P, NC, G = cols.shape
    check_operands(x, (("c0", c0, torch.int32, (P, 1, NC)),
                       ("cols", cols, torch.int32, (P, NC, G)),
                       ("lrow", lrow, torch.int32, (P, NC, G)),
                       ("vals", vals, torch.float32, (P, NC, G)),
                       ("nc_p", nc_p, torch.int32, (P, 1, 1))), ndim=ndim)


def dg_walk_info(pw: int, mode: str) -> dict:
    """The row walk kernel of panel ``pw`` in ``mode`` in this library:
    registers a thread, spilled (local) bytes a thread, static shared bytes
    and blocks an SM holds."""
    return kernel_info(_lib().dg_walk_info, "dg_walk_info", pw, int(mode == "bf16"))


def dg_rows_cuda(c0, cols, lrow, vals, nc_p, x, *, rb, kt, mode, walk=None, k=None,
                 out=None):
    """CUDA ``_dg_kernel`` (tpusparse/kernels/dg_gather.py:318): y_rows
    [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt in {8, 16, 32}, from
    one launch of the row walk kernel over ``walk``, the format's live
    slots in row order (``dg_row_walk(fmt)``; one built from other planes,
    or before they were written, is refused), for all of Kp at once.  The
    values are ``vals``'s: streamed from the walk where it holds them, else
    gathered through its slot index.  ``k``: the columns of X that carry
    the product (the rest is the kt padding; None: all Kp); the kernel
    reads and writes them rounded up to 4, the rest of y_rows stays zero.
    ``out``: y_rows [P*rb, Kp] to add into, returned in its place."""
    _check_format(c0, cols, lrow, vals, nc_p, x, 2)
    if kt not in (8, 16, 32) or mode not in PRECISIONS or x.shape[1] % kt:
        raise ValueError(f"dg kernel: kt={kt}, mode={mode}, X {tuple(x.shape)}")
    y = launch_walk(_lib().dg_walk_launch, "dg_walk_launch", walk, (c0, cols, lrow, nc_p),
                    vals, x, rows=cols.shape[0] * rb, k=k, bf16=mode == "bf16", out=out)
    dg_rows_cuda.launches += 1
    return y


def dg_walk1_info(geometry: tuple[int, int, int] = WALK1_GEOMETRY) -> dict:
    """The one-column walk kernel of ``geometry`` (slots a warp, warps a
    block, steps at once) in this library: registers a thread, spilled
    (local) bytes a thread, static shared bytes and blocks of the
    geometry's warps an SM holds."""
    _, wpb, steps = geometry
    return kernel_info(_lib().dg_walk1_info, "dg_walk1_info", steps, wpb)


def dg1_rows_cuda(c0, cols, lrow, vals, nc_p, x, *, rb, walk=None,
                  geometry: tuple[int, int, int] = WALK1_GEOMETRY):
    """CUDA ``_dg1_kernel`` (tpusparse/kernels/dg_gather.py:382): y_rows
    [P*rb] for x [N] fp32, from one launch of the one-column walk kernel
    over ``walk``, the format's live slots in row order
    (``dg_row_walk(fmt)``; one built from other planes, or before they
    were written, is refused).  The values are ``vals``'s: streamed from
    the walk where it holds them, else gathered through its slot index.
    ``geometry``: slots a warp, warps a block and steps of 32 slots a warp
    loads at once (``WALK1_GEOMETRY``, chosen on the card)."""
    _check_format(c0, cols, lrow, vals, nc_p, x, 1)
    y = launch_walk1(_lib().dg_spmv_launch, "dg_spmv_launch", walk, (c0, cols, lrow, nc_p),
                     vals, x, rows=cols.shape[0] * rb, geometry=geometry)
    dg1_rows_cuda.launches += 1
    return y


dg_rows_cuda.launches = 0
dg1_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry points

def _fmt_args(fmt):
    return fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p


def dg_spmm(fmt: DgFormat, x) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in DgFormat (kt >= 8; X padded to a
    multiple of kt, whose K columns the kernel walks at once).  CUDA
    formats run the kernel over the format's row walk, CPU formats the
    plain version."""
    assert fmt.kt >= 8, "kt=1 formats run dg_spmv"
    x = prep_x(x, fmt.device)
    m, n_cols = fmt.shape
    k = x.shape[1]
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    x = pad_dense_cols(x, cdiv(k, fmt.kt) * fmt.kt).contiguous()
    if fmt.device.type == "cuda":
        y_rows = dg_rows_cuda(*_fmt_args(fmt), x, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode,
                              walk=dg_row_walk(fmt), k=k)
    else:
        y_rows = dg_rows_plain(*_fmt_args(fmt), x, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode)
    return unpack_by_deal(fmt, y_rows)[:, :k]


def dg_spmv(fmt: DgFormat, x) -> torch.Tensor:
    """y[M] = A . x[N] with A in a kt=1 DgFormat."""
    assert fmt.kt == 1, "pack with kt=1 for SpMV"
    x = prep_x(x, fmt.device).reshape(-1)
    assert x.shape[0] == fmt.shape[1], f"x length {x.shape[0]} != A cols {fmt.shape[1]}"
    if fmt.device.type == "cuda":
        y_rows = dg1_rows_cuda(*_fmt_args(fmt), x, rb=fmt.rb, walk=dg_row_walk(fmt))
    else:
        y_rows = dg1_rows_plain(*_fmt_args(fmt), x, rb=fmt.rb)
    return unpack_by_deal(fmt, y_rows)
