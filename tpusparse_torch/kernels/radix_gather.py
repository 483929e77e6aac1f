"""radix_gather — radix-window SpMM (counterpart of
``tpusparse/kernels/radix_gather.py``).

The format and its packers are the JAX package's, array for array: rows
are dealt to P programs of ``rb`` rows, each program's nonzeros are sorted
by column and cut into chunks of at most ``g`` slots whose columns fit a
window of W = S * spr columns starting at ``c0``, a multiple of 8 * spr
(``radix_geometry``).  On the TPU that geometry came from packing spr rows
of X into one 128-lane word (``pack_x_radix``) so that three one-hot MXU
dots could gather, collapse and scatter a chunk; the lane packing, the
dots and the fp32x2 hi/lo split are TPU mechanism and are not ported.  On
the card a slot's column is ``c0 + cols`` and its row ``p*rb + lrow``, as
in the dg and span formats, so the window only bounds the chunk; keeping
it lets the tests feed the JAX packer's arrays to the port's kernel
(``radix_format_from_numpy``).  ``pack_brick_ell`` cuts the same format
from the interleaved ELL storage of the ``brick_ell`` family.

Kernel (CUDA C++, ``tpusparse_torch/csrc/radix_gather.cu``) beside its plain
PyTorch version of the same function:

  radix_rows_cuda / radix_rows_plain   replace ``_radix_kernel``

Each computes ``y_rows[p*rb + lrow] += v * X[c0 + cols]`` for X of Kp
columns, Kp a multiple of the format's kt in {1, 2, 4, 8, 16, 32};
``unpack_by_deal`` then maps the slots back to matrix rows.  The wrapper
launches a row walk kernel of ``csrc/row_walk.cuh`` over the format's row
walk (``radix_row_walk``, the decode dg and span share): ``walk1_kernel``
for x of one column (the radix SpMV), else ``walk_kernel`` over all of
Kp's columns at once (X of 2 columns padded to 4), so kt is no longer a
K-tile on the card.  Precision: fp32x2 computes in fp32 (at least the
TPU's class); bf16 rounds each fp32 product to bf16 once
(radix_gather.py:33-37) and sums in fp32.  A wrapper launches its kernel
for CUDA tensors and raises on any failure; only CPU tensors take the
plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from tpusparse_torch.format import live_chunk_counts
from tpusparse_torch import native
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels.common import (cdiv, check_operands, kernel_info, lex_order,
                                            pad_dense_cols, prep_x, resolve_device, round_up,
                                            to_device, unpack_by_deal, window_rows_plain)
from tpusparse_torch.kernels.row_walk import (WALK1_GEOMETRY, RowWalk, launch_walk,
                                              launch_walk1, walk_geometry, window_row_walk)
from tpusparse_torch.levels import Level

PRECISIONS = ("fp32x2", "bf16")
RADIX_KTS = (1, 2, 4, 8, 16, 32)


def choose_kt(k: int) -> int:
    """Smallest supported K-tile covering k (32 past it)."""
    for kt in RADIX_KTS:
        if k <= kt:
            return kt
    return 32


def radix_geometry(kt: int, mode: str) -> tuple[int, int, int]:
    """(spr, nhl, ngrp): X rows per 128-lane word, hi/lo planes and output
    lane groups of the TPU kernel.  The packer keeps them because they
    define the format: the window W = S * spr, c0 a multiple of 8 * spr,
    and rb a multiple of ngrp."""
    assert kt in RADIX_KTS, f"kt={kt} not in {RADIX_KTS}"
    assert mode in PRECISIONS, mode
    nhl = 2 if mode == "fp32x2" else 1
    spr = 128 // (nhl * kt)
    ngrp = 128 // (nhl * kt)
    return spr, nhl, ngrp


@dataclasses.dataclass
class RadixFormat:
    """Span-chunked format with window starts aligned to 8 * spr columns,
    torch tensors on one device (P programs, NC chunks, G slots each):

      c0    [P, 1, NC] int32  window start column (multiple of 8 * spr)
      cols  [P, NC, G] int32  column offset within the window (< S * spr)
      lrow  [P, NC, G] int32  row local to the program (< RB)
      vals  [P, NC, G] f32    value (0 for padding)
      nc_p  [P, 1, 1]  int32  real chunk count per program
      slot_of_origrow [M] int32

    ``deal`` says how output rows map back to matrix rows (checked at pack
    time): 'blocks' (slot == row), 'index' (slot = (r % P) * rb + r // P)
    or 'arbitrary' (the gather through ``slot_of_origrow``).  Every field
    equals the JAX ``RadixFormat``'s; ``perm_of_nz`` (numpy, host) maps each
    input nonzero to its flat slot (``pack_radix(keep_perm=True)``).  ``walk``
    is the port's own: the row walk the kernel walks (``radix_row_walk``),
    built on the card at the first launch and not part of ``memory_bytes``.
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
    S: int
    kt: int
    mode: str
    shape: tuple[int, int]
    nnz_real: int
    perm_of_nz: Any = None
    deal: str = "arbitrary"
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
        return self.S * radix_geometry(self.kt, self.mode)[0]


RADIX_FIELDS = ("c0", "cols", "lrow", "vals", "slot_of_origrow")


def _coo_and_recovery(mat_or_ms, sub, out_rows):
    """(rows, cols, vals, row_num, col_num, rec, out_rows) of a CooMatrix or
    of a MetaDataSet sub-matrix; rec maps local rows to original ones."""
    if isinstance(mat_or_ms, CooMatrix):
        row_num, col_num = mat_or_ms.shape
        return (mat_or_ms.rows.astype(np.int64), mat_or_ms.cols.astype(np.int64),
                np.asarray(mat_or_ms.vals), row_num, col_num,
                np.arange(row_num, dtype=np.int64), row_num if out_rows is None else out_rows)
    ms = mat_or_ms
    rows, cols, vals = ms.coo(sub)
    row_num = ms.row_num(sub)
    if ms.has(Level.ROW, "original_row_of_sorted", sub):
        rec = ms.get(Level.ROW, "original_row_of_sorted", sub)[:row_num]
    else:
        rec = np.arange(row_num, dtype=np.int64)
    assert out_rows is not None
    return (rows.astype(np.int64), cols.astype(np.int64), vals, row_num, ms.col_num(sub),
            rec, out_rows)


def pack_radix(
    mat_or_ms,
    sub: int = 0,
    *,
    out_rows: int | None = None,
    rb: int = 1024,
    S: int = 128,
    g: int = 512,
    kt: int = 8,
    mode: str = "fp32x2",
    balance: bool = True,
    deal: str | None = None,
    keep_perm: bool = False,
    device="cuda",
) -> RadixFormat:
    """Pack into RadixFormat on ``device`` (tpusparse/kernels/radix_gather.py:151):
    the span chunk walk with the window budget shrunk by the 8 * spr
    alignment, then each chunk's c0 realigned down to it (padding columns
    stay below W, their values 0).

    ``deal`` picks the row-to-program assignment: 'length' (descending
    length round-robin, best nnz balance, unpacked by a gather), 'index'
    (round-robin by row index, unpacked by a reshape), 'blocks'
    (contiguous row blocks, no unpack), or None: 'length' for several
    programs with ``balance``, else 'blocks'."""
    dev = resolve_device(device)
    spr, _, ngrp = radix_geometry(kt, mode)
    align = 8 * spr
    W = S * spr
    assert rb % ngrp == 0, f"rb={rb} must be a multiple of ngrp={ngrp}"
    assert W > align, f"window S*spr={W} must exceed the alignment {align}"
    rows, cols, vals, row_num, col_num, rec, out_rows = _coo_and_recovery(
        mat_or_ms, sub, out_rows)

    p_count = max(-(-row_num // rb), 1)
    # the chunk walk aligns c0 to 8; leave headroom so the realign to 8*spr
    # never pushes a column past the window
    span_budget = W - align
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

    packed = native.span_pack(cols_s, lrow_s, vals_s, starts, g, span_budget,
                              want_dest=keep_perm)
    c0_2d, cols_f, lrow_f, vals_f, nc_arr = packed[:5]
    dest_sorted = packed[5] if keep_perm else None
    # realign window starts from the walk's 8 to 8*spr
    delta = (c0_2d % align).astype(np.int32)
    c0_2d = c0_2d - delta
    cols_f = cols_f + delta[:, :, None]

    slot_of_origrow = np.full(out_rows, -1, dtype=np.int32)
    keep = rec >= 0
    slot_of_origrow[rec[keep]] = slot_of_local[keep].astype(np.int32)

    # the affine unpacks hold only where the original row space allows them
    # (a metadata-set sort permutes rec and leaves the gather).  A row with
    # slot -1 is fine iff its affine slot is unoccupied: nothing writes it.
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

    return RadixFormat(
        c0=to_device(dev, c0_2d[:, None, :]),
        cols=to_device(dev, cols_f),
        lrow=to_device(dev, lrow_f),
        vals=to_device(dev, vals_f, torch.float32),
        nc_p=to_device(dev, np.asarray(nc_arr, np.int32).reshape(p_count, 1, 1)),
        slot_of_origrow=to_device(dev, slot_of_origrow),
        n_programs=p_count,
        n_chunks=c0_2d.shape[1],
        chunk_g=g,
        rb=rb,
        S=S,
        kt=kt,
        mode=mode,
        shape=(out_rows, col_num),
        nnz_real=int(np.count_nonzero(vals_f)),
        perm_of_nz=(None if dest_sorted is None
                    else np.asarray(dest_sorted)[np.argsort(order, kind="stable")]),
        deal=unpack,
    )


def pack_brick_ell(
    ms,
    sub: int = 0,
    *,
    out_rows: int,
    rb: int = 1024,
    S: int = 128,
    g: int = 512,
    kt: int = 8,
    mode: str = "fp32x2",
    device="cuda",
    max_slots: int | None = None,
) -> RadixFormat:
    """Brick-ELL packing (tpusparse/kernels/radix_gather.py:314): chunks cut
    in the STORED (ELL-padded, interleaved) order instead of column order,
    the reference's headline layout (col-pad-parent-to-max + interlance
    storage, data_transform_step.hpp:1385-1693) in the radix format.
    ``max_slots``: planes of more slots raise ``ValueError`` before they
    are allocated (the caller's memory or the row walk's int32 index).

    Expects the metadata set after SortOperator (length),
    FixedIntervalRowBlockingOperator(8), EllBlockPadOperator and
    InterleaveStorageOperator.  Bricks of 8 sorted rows are dealt
    round-robin to programs; a chunk closes when its column range exceeds
    the window or it holds G slots."""
    dev = resolve_device(device)
    spr, _, ngrp = radix_geometry(kt, mode)
    align = 8 * spr
    assert rb % ngrp == 0 and rb % 8 == 0
    budget = S * spr - align
    rows, cols, vals, row_num, col_num, rec, out_rows = _coo_and_recovery(ms, sub, out_rows)

    p_count = max(-(-row_num // rb), 1)
    brick_of_nz = rows // 8
    n_bricks = -(-row_num // 8) + 1
    p_of_brick = np.arange(n_bricks, dtype=np.int64) % p_count
    slot_of_brick = np.arange(n_bricks, dtype=np.int64) // p_count
    p_of_nz = p_of_brick[brick_of_nz]
    order = np.argsort(p_of_nz, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], np.asarray(vals)[order]
    lrow_s = slot_of_brick[rows_s // 8] * 8 + rows_s % 8
    starts = np.searchsorted(p_of_nz[order], np.arange(p_count + 1))

    chunks: list[list[tuple[int, int, int]]] = [[] for _ in range(p_count)]
    cols_l = cols_s.tolist()
    for p in range(p_count):
        lo, hi = int(starts[p]), int(starts[p + 1])
        i = lo
        while i < hi:
            cmin = cmax = cols_l[i]
            j = i + 1
            while j < hi and j - i < g:
                c = cols_l[j]
                nmin, nmax = min(cmin, c), max(cmax, c)
                if nmax - nmin > budget:
                    break
                cmin, cmax = nmin, nmax
                j += 1
            chunks[p].append((cmin & ~(align - 1), i, j))
            i = j

    nc = max(max((len(c) for c in chunks), default=1), 1)
    if max_slots is not None and p_count * nc * g > max_slots:
        raise ValueError(f"brick_ell planes of {p_count * nc * g} slots (NC={nc}) pass the "
                         f"limit of {max_slots}")
    c0_2d = np.zeros((p_count, nc), dtype=np.int32)
    cols_f = np.zeros((p_count, nc, g), dtype=np.int32)
    lrow_f = np.zeros((p_count, nc, g), dtype=np.int32)
    vals_f = np.zeros((p_count, nc, g), dtype=np.float32)
    for p in range(p_count):
        for ci, (c0, i, j) in enumerate(chunks[p]):
            c0_2d[p, ci] = c0
            cols_f[p, ci, :j - i] = cols_s[i:j] - c0
            lrow_f[p, ci, :j - i] = lrow_s[i:j]
            vals_f[p, ci, :j - i] = vals_s[i:j]

    slot_of_origrow = np.full(out_rows, -1, dtype=np.int32)
    keep = rec >= 0
    local = np.arange(row_num, dtype=np.int64)
    slot_local = p_of_brick[local // 8] * rb + slot_of_brick[local // 8] * 8 + local % 8
    slot_of_origrow[rec[keep]] = slot_local[keep].astype(np.int32)

    return RadixFormat(
        c0=to_device(dev, c0_2d[:, None, :]),
        cols=to_device(dev, cols_f),
        lrow=to_device(dev, lrow_f),
        vals=to_device(dev, vals_f, torch.float32),
        nc_p=to_device(dev, np.asarray([len(c) for c in chunks], np.int32).reshape(p_count, 1, 1)),
        slot_of_origrow=to_device(dev, slot_of_origrow),
        n_programs=p_count,
        n_chunks=nc,
        chunk_g=g,
        rb=rb,
        S=S,
        kt=kt,
        mode=mode,
        shape=(out_rows, col_num),
        nnz_real=int(np.count_nonzero(vals_f)),
    )


def with_values(fmt: RadixFormat, new_vals) -> RadixFormat:
    """Values-only update: the same pattern with new values, in the nonzero
    order given to pack_radix (requires keep_perm=True).  The row walk, of
    the pattern, is carried over with the new values."""
    assert fmt.perm_of_nz is not None, "pack_radix(..., keep_perm=True) required"
    flat = np.zeros(fmt.n_programs * fmt.n_chunks * fmt.chunk_g, dtype=np.float32)
    flat[np.asarray(fmt.perm_of_nz)] = np.asarray(new_vals, dtype=np.float32)
    vals = torch.from_numpy(flat.reshape(fmt.n_programs, fmt.n_chunks, fmt.chunk_g))
    vals = vals.to(fmt.device)
    return dataclasses.replace(fmt, vals=vals, nnz_real=int(np.count_nonzero(flat)),
                               walk=None if fmt.walk is None else fmt.walk.for_plane(vals))


def radix_format_from_numpy(fields: dict, *, device="cuda", **static) -> RadixFormat:
    """A RadixFormat from numpy arrays — the JAX ``RadixFormat``'s ``c0``,
    ``cols``, ``lrow``, ``vals``, ``slot_of_origrow``, optional ``nc_p``
    (derived from ``vals`` when absent) and ``perm_of_nz`` — plus its static
    fields (``n_programs``, ``n_chunks``, ``chunk_g``, ``rb``, ``S``, ``kt``,
    ``mode``, ``shape``, ``nnz_real``, ``deal``).  Shapes and index ranges
    are checked: the kernel reads X and writes Y at these indices without
    bounds checks."""
    dev = resolve_device(device)
    arrs = {k: np.asarray(fields[k]) for k in RADIX_FIELDS}
    vals = arrs["vals"].astype(np.float32)
    P, NC, G = static["n_programs"], static["n_chunks"], static["chunk_g"]
    rb, (m, n) = static["rb"], static["shape"]
    W = static["S"] * radix_geometry(static["kt"], static["mode"])[0]
    arrs["nc_p"] = (np.asarray(fields["nc_p"]) if fields.get("nc_p") is not None
                    else live_chunk_counts(vals))
    want = {"c0": (P, 1, NC), "cols": (P, NC, G), "lrow": (P, NC, G), "vals": (P, NC, G),
            "nc_p": (P, 1, 1), "slot_of_origrow": (m,)}
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"RadixFormat.{k}: shape {arrs[k].shape}, want {shp}")
    live = vals != 0
    col = arrs["c0"].reshape(P, NC, 1).astype(np.int64) + arrs["cols"]
    if (live.any() and (col[live].min() < 0 or col[live].max() >= n)) or \
            arrs["cols"].min(initial=0) < 0 or arrs["cols"].max(initial=0) >= W or \
            arrs["lrow"].min(initial=0) < 0 or arrs["lrow"].max(initial=0) >= rb or \
            arrs["nc_p"].min(initial=0) < 0 or arrs["nc_p"].max(initial=0) > NC or \
            arrs["slot_of_origrow"].max(initial=-1) >= P * rb:
        raise ValueError("RadixFormat indices out of range")
    arrs["vals"] = vals
    tensors = {k: torch.tensor(a, dtype=torch.float32 if k == "vals" else torch.int32,
                               device=dev) for k, a in arrs.items()}
    perm = fields.get("perm_of_nz")
    return RadixFormat(**tensors, **static, perm_of_nz=None if perm is None else np.asarray(perm))


# --------------------------------------------------------------- plain version

def radix_rows_plain(c0, cols, lrow, vals, nc_p, x, *, rb, kt, mode):
    """Plain PyTorch ``_radix_kernel``: y_rows [P*rb, Kp] with
    ``y_rows[p*rb + lrow] += vals * X[c0 + cols]`` over the slots whose value
    is not zero in a chunk before ``nc_p`` (bf16 rounds each product, as the
    kernel does); ``kt`` changes nothing."""
    return window_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=rb, bf16=mode == "bf16")


# ------------------------------------------------------------------- row walk

def radix_row_walk(fmt: RadixFormat) -> RowWalk:
    """The format's row walk (``row_walk.window_row_walk``): the live slots
    (those of ``perm_of_nz`` where ``pack_radix(keep_perm=True)`` kept it,
    else the plane's nonzeros in a chunk before ``nc_p``, as for
    ``pack_brick_ell``'s formats) with their y_rows row ``p*rb + lrow`` and
    X column ``c0 + cols``, sorted by (row, slot); built at first use and
    kept on the format, built anew where a plane was replaced or written in
    place since."""
    return window_row_walk(fmt)


# ---------------------------------------------------------------- CUDA kernel

@functools.cache
def _lib():
    """csrc/radix_gather.cu, built at first use, with its C signatures."""
    lib = build.library("radix_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.radix_walk_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.radix_walk_launch.restype = i32
    lib.radix_spmv_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.radix_spmv_launch.restype = i32
    lib.radix_walk_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.radix_walk_info.restype = i32
    lib.radix_walk1_info.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.radix_walk1_info.restype = i32
    return lib


def radix_walk_info(kp: int, mode: str, geometry: tuple[int, int, int] = WALK1_GEOMETRY) -> dict:
    """The row walk kernel that ``radix_rows_cuda`` launches for X of
    ``kp`` columns in ``mode`` (the one-column walk of ``geometry`` at kp =
    1): registers a thread, spilled (local) bytes a thread, static shared
    bytes and blocks an SM holds."""
    bf16 = int(mode == "bf16")
    if kp == 1:
        _, wpb, steps = geometry
        return kernel_info(_lib().radix_walk1_info, "radix_walk1_info", steps, wpb, bf16)
    return kernel_info(_lib().radix_walk_info, "radix_walk_info", walk_geometry(kp)[1], bf16)


def radix_rows_cuda(c0, cols, lrow, vals, nc_p, x, *, rb, kt, mode, walk=None, k=None,
                    out=None):
    """CUDA ``_radix_kernel`` (tpusparse/kernels/radix_gather.py:441): y_rows
    [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt in RADIX_KTS, from one
    launch of a row walk kernel over ``walk``, the format's live slots in
    row order (``radix_row_walk(fmt)``; one built from other planes, or
    before they were written, is refused): the one-column walk at Kp = 1,
    else the walk kernel over all Kp columns at once (X of 2 columns is
    copied into 4, which a gathered row costs either way).  The values are
    ``vals``'s: streamed from the walk where it holds them, else gathered
    through its slot index.  ``k``: the columns of X that carry the product
    (the rest is the kt padding; None: all Kp); the kernel reads and writes
    them rounded up to 4, the rest of y_rows stays zero.  ``out``: y_rows
    [P*rb, Kp] to add into (Kp a multiple of 4), returned in its place."""
    P, NC, G = cols.shape
    check_operands(x, (("c0", c0, torch.int32, (P, 1, NC)),
                       ("cols", cols, torch.int32, (P, NC, G)),
                       ("lrow", lrow, torch.int32, (P, NC, G)),
                       ("vals", vals, torch.float32, (P, NC, G)),
                       ("nc_p", nc_p, torch.int32, (P, 1, 1))), ndim=2)
    if kt not in RADIX_KTS or mode not in PRECISIONS or x.shape[1] % kt:
        raise ValueError(f"radix kernel: kt={kt}, mode={mode}, X {tuple(x.shape)}")
    lib, pattern, rows, bf16 = _lib(), (c0, cols, lrow, nc_p), P * rb, mode == "bf16"
    kp = x.shape[1]
    if out is not None and kp % 4:
        raise ValueError(f"radix kernel: out= needs X of a multiple of 4 columns, not {kp}")
    if kp == 1:
        y = launch_walk1(lib.radix_spmv_launch, "radix_spmv_launch", walk, pattern, vals,
                         x.view(-1), rows=rows, bf16=bf16).view(rows, 1)
    else:
        x4 = pad_dense_cols(x, round_up(kp, 4)).contiguous()
        y = launch_walk(lib.radix_walk_launch, "radix_walk_launch", walk, pattern, vals, x4,
                        rows=rows, k=kp if k is None else min(k, kp), bf16=bf16,
                        out=out)[:, :kp]
    radix_rows_cuda.launches += 1
    return y


radix_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry point

def max_ktin(fmt: RadixFormat, kt_count: int, unroll: int) -> int:
    """The JAX package's largest legal inner K-tile count
    (tpusparse/kernels/radix_gather.py:613): it divides kt_count, keeps the
    lane-packed X block and the chunk blocks within 8 MB of VMEM and the
    unrolled body small, and stays on the wide collapse.  TPU-derived; the
    card kernel has no inner K-tiles, so ``ktin`` changes no Y here."""
    spr, nhl, _ = radix_geometry(fmt.kt, fmt.mode)
    if nhl * fmt.kt < 8 or kt_count == 1:
        return 1
    xp_tile_bytes = (round_up(fmt.shape[1] + fmt.window, 8 * spr) // spr) * 128 * 2
    chunk_bytes = fmt.n_chunks * fmt.chunk_g * 12
    best = 1
    for cand in (2, 4, 8):
        if kt_count % cand or cand * xp_tile_bytes + chunk_bytes > 8 * 1024 * 1024 or \
                cand * max(unroll, 1) > 16:
            continue
        best = cand
    return best


def radix_spmm(fmt: RadixFormat, x, *, unroll: int = 4, ktin: int | None = None) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in RadixFormat (kt and mode fixed at
    pack time; X padded to a multiple of kt).  ``unroll`` and ``ktin``
    steered the TPU kernel's loops and change nothing here.  CUDA formats
    run the kernel over the format's row walk, CPU formats its plain
    version."""
    x = prep_x(x, fmt.device)
    m, n_cols = fmt.shape
    k = x.shape[1]
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    kt = fmt.kt
    x = pad_dense_cols(x, cdiv(k, kt) * kt).contiguous()
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, x)
    if fmt.device.type == "cuda":
        y_rows = radix_rows_cuda(*args, rb=fmt.rb, kt=kt, mode=fmt.mode,
                                 walk=radix_row_walk(fmt), k=k)
    else:
        y_rows = radix_rows_plain(*args, rb=fmt.rb, kt=kt, mode=fmt.mode)
    return unpack_by_deal(fmt, y_rows)[:, :k]
