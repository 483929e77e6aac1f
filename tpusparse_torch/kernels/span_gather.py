"""span_gather — span-chunked SpMM (counterpart of
``tpusparse/kernels/span_gather.py``).

The format and its packer are the JAX package's, array for array: rows are
dealt to P programs of ``rb`` rows (round-robin by descending length with
``balance``), each program's nonzeros are sorted by column and cut into
chunks of at most ``g`` slots whose columns fit one window of ``ct``
columns starting at ``c0`` (a multiple of 8).  On the TPU the window
bounded a one-hot MXU gather over an X block that had to stay in VMEM; on
the card a thread loads the row of X it needs, so the window only bounds
the chunk.  The packer's walk is the native host helper
``native.span_pack``; ``span_chunk_numpy`` is its plain numpy version.
The TPU's bf16 hi/lo packing of X and its one-hot dots are not ported:
fp32 and fp32x2 compute in fp32, bf16 rounds each product.

Kernels (CUDA C++, ``tpusparse_torch/csrc/span_gather.cu``), each beside its
plain PyTorch version of the same function:

  span_rows_cuda        / span_rows_plain         replace ``_span_kernel``
  span_stream_rows_cuda / span_stream_rows_plain  replace ``_span_kernel_stream``

Both launch the row walk kernel over the format's ``span_row_walk``: the
TPU's stream variant staged each chunk's window of X because X could not
stay in VMEM, and on the card a slot reads the row of X it needs.  X of
one column (``span_spmm`` at K = 1, the SpMV ``spmv_fn('span')``) runs at
kt = 1: ``span_rows_cuda`` launches the one-column walk kernel over the
same walk, as the dg and radix SpMVs do; the JAX package widened x to 8
columns, the TPU's 8-sublane minimum.

Each computes ``y_rows[p*rb + lrow] += v * X[c0 + cols]``; the slot gather
through ``slot_of_origrow`` then gives Y.  A wrapper launches its kernel for
CUDA tensors and raises on any failure; only CPU tensors take the plain
version.
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
from tpusparse_torch.kernels.common import (cdiv, check_operands, fill_chunks, kernel_info,
                                            lex_order, pad_dense_cols, prep_x, resolve_device,
                                            unpack_slots, value_dtype, window_rows_plain)
from tpusparse_torch.kernels.row_walk import (WALK1_GEOMETRY, RowWalk, launch_walk,
                                              launch_walk1, window_row_walk)
from tpusparse_torch.kernels.tile_onehot import PRECISIONS, choose_kt, default_ktile
from tpusparse_torch.levels import Level


@dataclasses.dataclass
class SpanFormat:
    """Per-program column-sorted chunks with dynamic window starts, torch
    tensors on one device (P programs, NC chunks each, G slots per chunk):

      c0    [P, 1, NC] int32  window start column (multiple of 8)
      cols  [P, NC, G] int32  column offset within the window (< CT)
      lrow  [P, NC, G] int32  row local to the program (< RB)
      vals  [P, NC, G] f32    value (0 for padding), or ``val_dtype``
      nc_p  [P, 1, 1]  int32  real chunk count per program
      slot_of_origrow [M] int32

    ``nc_p`` is the port's own field (the chunk walk's count per program):
    the kernels walk only a program's real chunks.  So are ``walk``, the
    row walk both wrappers' kernel walks (``span_row_walk``), ``tiles``,
    the SDDMM kernel's tile index (``sddmm.sddmm_tiles``), and
    ``dx_index``, the transpose apply's column walk (``sddmm.dx_index``),
    each built on the card at its first launch and not part of
    ``memory_bytes``.  Every
    other field equals the JAX ``SpanFormat``'s.  ``perm_of_nz`` (numpy, host) maps each input
    nonzero to its flat slot (``pack_span(keep_perm=True)``).
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
    ct: int
    shape: tuple[int, int]
    nnz_real: int
    perm_of_nz: Any = None
    walk: RowWalk | None = dataclasses.field(default=None, repr=False, compare=False)
    tiles: Any = dataclasses.field(default=None, repr=False, compare=False)
    dx_index: Any = dataclasses.field(default=None, repr=False, compare=False)

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


SPAN_FIELDS = ("c0", "cols", "lrow", "vals", "slot_of_origrow")


def span_chunk_numpy(cols_sorted, lrow_sorted, vals_sorted, p_starts, g: int,
                     span_budget: int, want_dest: bool = False):
    """The span chunk walk in numpy, the plain version of
    ``native.span_pack``, with its signature and returns: cut each
    program's column-sorted nz into chunks of <= G nz whose columns fit a
    ``span_budget``-wide window.  Returns (c0 [P, NC], cols/lrow [P, NC,
    G], vals [P, NC, G], nc_per_program [P] (1 for a program with no
    nonzero)[, dest [nnz]])."""
    cols_s = np.asarray(cols_sorted)
    p_count = len(p_starts) - 1
    chunks: list[list[tuple[int, int, int]]] = [[] for _ in range(p_count)]
    for p in range(p_count):
        lo, hi = int(p_starts[p]), int(p_starts[p + 1])
        colp = cols_s[lo:hi]
        i = lo
        while i < hi:
            c0 = int(cols_s[i]) & ~7
            j_span = lo + int(np.searchsorted(colp, c0 + span_budget + 8, side="left"))
            j = min(i + g, j_span, hi)
            chunks[p].append((c0, i, j))
            i = j
    return fill_chunks(chunks, cols_s, lrow_sorted, vals_sorted, g, want_dest)


def pack_span(
    mat_or_ms,
    sub: int = 0,
    *,
    out_rows: int | None = None,
    rb: int = 512,
    ct: int = 512,
    g: int = 128,
    balance: bool = True,
    val_dtype=None,
    keep_perm: bool = False,
    device="cuda",
) -> SpanFormat:
    """Pack a CooMatrix (or a MetaDataSet sub-matrix) into SpanFormat on
    ``device``.  ``balance`` deals rows to programs round-robin in
    descending-length order, so every program carries ~nnz/P work and the
    uniform chunk count NC pads only the tail; output recovery is the slot
    gather.  ``val_dtype`` (torch dtype or name; float32 by default) is the
    value plane's dtype — the reference's half mode is bf16."""
    dev = resolve_device(device)
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
    span_budget = ct - 8  # the window start is rounded down to a multiple of 8

    if balance and row_num:
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
    nc = c0_2d.shape[1]

    slot_of_origrow = np.full(out_rows, -1, dtype=np.int32)
    keep = rec >= 0
    slot_of_origrow[rec[keep]] = slot_of_local[keep].astype(np.int32)

    def dev_t(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dev, dt) if dt is not None else t.to(dev)

    return SpanFormat(
        c0=dev_t(c0_2d[:, None, :]),
        cols=dev_t(cols_f),
        lrow=dev_t(lrow_f),
        vals=dev_t(vals_f, value_dtype(val_dtype)),
        nc_p=dev_t(nc_arr.astype(np.int32).reshape(p_count, 1, 1)),
        slot_of_origrow=dev_t(slot_of_origrow),
        n_programs=p_count,
        n_chunks=nc,
        chunk_g=g,
        rb=rb,
        ct=ct,
        shape=(out_rows, col_num),
        nnz_real=int(np.count_nonzero(vals_f)),
        perm_of_nz=(None if dest_sorted is None
                    else np.asarray(dest_sorted)[np.argsort(order, kind="stable")]),
    )


def with_values(fmt: SpanFormat, new_vals) -> SpanFormat:
    """Values-only update: the same pattern with new values, in the nonzero
    order given to pack_span (requires keep_perm=True).  The index planes
    are reused untouched, the row walk with the new values."""
    assert fmt.perm_of_nz is not None, "pack_span(..., keep_perm=True) required"
    new_vals = np.asarray(new_vals, dtype=np.float32)
    flat = np.zeros(fmt.n_programs * fmt.n_chunks * fmt.chunk_g, dtype=np.float32)
    flat[np.asarray(fmt.perm_of_nz)] = new_vals
    vals = torch.from_numpy(flat.reshape(fmt.n_programs, fmt.n_chunks, fmt.chunk_g))
    vals = vals.to(fmt.device, fmt.vals.dtype)
    return dataclasses.replace(fmt, vals=vals, nnz_real=int(np.count_nonzero(flat)),
                               walk=None if fmt.walk is None else fmt.walk.for_plane(vals))


def span_format_from_numpy(fields: dict, *, device="cuda", **static) -> SpanFormat:
    """A SpanFormat from numpy arrays — the JAX ``SpanFormat``'s ``c0``,
    ``cols``, ``lrow``, ``vals``, ``slot_of_origrow`` and ``perm_of_nz``
    (``nc_p`` is derived from ``vals`` unless given) — plus its static
    fields (``n_programs``, ``n_chunks``, ``chunk_g``, ``rb``, ``ct``,
    ``shape``, ``nnz_real``).  The arrays come from outside this package,
    so their shapes and index ranges are checked here: the kernels read X
    and write Y at these indices without bounds checks."""
    dev = resolve_device(device)
    arrs = {k: np.asarray(fields[k]) for k in SPAN_FIELDS}
    vals = arrs["vals"].astype(np.float32)
    P, NC, G = static["n_programs"], static["n_chunks"], static["chunk_g"]
    rb, ct, (m, n) = static["rb"], static["ct"], static["shape"]
    arrs["nc_p"] = (np.asarray(fields["nc_p"]) if fields.get("nc_p") is not None
                    else live_chunk_counts(vals))
    want = {"c0": (P, 1, NC), "cols": (P, NC, G), "lrow": (P, NC, G), "vals": (P, NC, G),
            "nc_p": (P, 1, 1), "slot_of_origrow": (m,)}
    for k, shp in want.items():
        if arrs[k].shape != shp:
            raise ValueError(f"SpanFormat.{k}: shape {arrs[k].shape}, want {shp}")
    live = vals != 0
    col = arrs["c0"].reshape(P, NC, 1).astype(np.int64) + arrs["cols"]
    if (live.any() and (col[live].min() < 0 or col[live].max() >= n)) or \
            arrs["cols"].min(initial=0) < 0 or arrs["cols"].max(initial=0) >= ct or \
            arrs["lrow"].min(initial=0) < 0 or arrs["lrow"].max(initial=0) >= rb or \
            arrs["nc_p"].min(initial=0) < 0 or arrs["nc_p"].max(initial=0) > NC or \
            arrs["slot_of_origrow"].max(initial=-1) >= P * rb:
        raise ValueError("SpanFormat indices out of range")
    arrs["vals"] = vals
    tensors = {k: torch.tensor(a, dtype=torch.float32 if k == "vals" else torch.int32,
                               device=dev) for k, a in arrs.items()}
    perm = fields.get("perm_of_nz")
    return SpanFormat(**tensors, **static, perm_of_nz=None if perm is None else np.asarray(perm))


# ------------------------------------------------------------------- row walk

def slot_rows_cols(c0, cols, lrow, nc_p, rb):
    """Each slot's column of X and row of y_rows (or dY_slots), flat and
    long, and whether its chunk is walked (before nc_p)."""
    P, NC, G = cols.shape
    col = (c0.reshape(P, NC, 1).long() + cols.long()).reshape(-1)
    row = (torch.arange(P, device=cols.device).view(P, 1, 1) * rb + lrow.long()).reshape(-1)
    walked = (torch.arange(NC, device=cols.device).view(1, NC, 1)
              < nc_p.reshape(P, 1, 1)).expand(P, NC, G).reshape(-1)
    return col, row, walked


def span_row_walk(fmt) -> RowWalk:
    """The row walk of a SpanFormat or SegmentSpanFormat
    (``row_walk.window_row_walk``), built at first use and kept on the
    format; built anew where a plane was replaced or written in place
    since."""
    return window_row_walk(fmt)


# --------------------------------------------------------------- plain versions

def span_rows_plain(c0, cols, lrow, vals, nc_p, x, *, rb, kt, mode):
    """Plain PyTorch ``_span_kernel``: y_rows [P*rb, Kp] with
    ``y_rows[p*rb + lrow] += vals * X[c0 + cols]`` over the slots whose value
    is not zero in a chunk before ``nc_p`` (bf16 rounds each product as the
    kernel does); ``kt`` changes nothing."""
    return window_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=rb, bf16=mode == "bf16")


def span_stream_rows_plain(c0, cols, lrow, vals, nc_p, x, *, rb, ct, kt, mode):
    """Plain PyTorch ``_span_kernel_stream``: the same function as
    ``span_rows_plain`` (``ct`` sized only the TPU kernel's window)."""
    return span_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=rb, kt=kt, mode=mode)


# ---------------------------------------------------------------- CUDA kernels

@functools.cache
def _lib():
    """csrc/span_gather.cu, built at first use, with its C signatures."""
    lib = build.library("span_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.span_spmm_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.span_spmm_launch.restype = i32
    lib.span_walk_info.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.span_walk_info.restype = i32
    lib.span_walk1_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.span_walk1_launch.restype = i32
    lib.span_walk1_info.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.span_walk1_info.restype = i32
    return lib


def span_walk_info(pw: int, mode: str) -> dict:
    """The row walk kernel of panel ``pw`` in ``mode`` in this library:
    registers a thread, spilled (local) bytes a thread, static shared bytes
    and blocks an SM holds."""
    return kernel_info(_lib().span_walk_info, "span_walk_info", pw, int(mode == "bf16"))


def span_walk1_info(mode: str, geometry: tuple[int, int, int] = WALK1_GEOMETRY) -> dict:
    """The one-column walk kernel of ``geometry`` (slots a warp, warps a
    block, steps at once) in ``mode`` in this library: registers a thread,
    spilled (local) bytes a thread, static shared bytes and blocks of the
    geometry's warps an SM holds."""
    _, wpb, steps = geometry
    return kernel_info(_lib().span_walk1_info, "span_walk1_info", steps, wpb,
                       int(mode == "bf16"))


def _check(c0, cols, lrow, vals, nc_p, x, kt, mode, kts=(8, 16, 32)):
    P, NC, G = cols.shape
    check_operands(x, (("c0", c0, torch.int32, (P, 1, NC)),
                       ("cols", cols, torch.int32, (P, NC, G)),
                       ("lrow", lrow, torch.int32, (P, NC, G)),
                       ("vals", vals, torch.float32, (P, NC, G)),
                       ("nc_p", nc_p, torch.int32, (P, 1, 1))), ndim=2)
    if (kt not in kts or mode not in PRECISIONS or x.shape[1] % kt
            or (kt == 1) != (x.shape[1] == 1)):
        raise ValueError(f"span kernel: kt={kt}, mode={mode}, X {tuple(x.shape)}")


def span_rows_cuda(c0, cols, lrow, vals, nc_p, x, *, rb, kt, mode, walk=None, k=None,
                   out=None):
    """CUDA ``_span_kernel`` (tpusparse/kernels/span_gather.py:270): y_rows
    [P*rb, Kp] for X [N, Kp] fp32, Kp a multiple of kt in {8, 16, 32}, from
    one launch of the row walk kernel over ``walk``, the format's live
    slots in row order (``span_row_walk(fmt)``; one built from other
    planes, or before they were written, is refused); at kt = 1, X of one
    column (the SpMV), one launch of the one-column walk kernel over the
    same walk (bf16 rounds each product; no ``out``).  The values are
    ``vals``'s: streamed from the walk where it holds them (``vals`` is the
    packed plane it was built from, unwritten since), else gathered through
    its slot index (a caller's plane of the same shape).  ``k``: the columns of X that
    carry the product (the rest is the kt padding; None: all Kp); the
    kernel reads and writes them rounded up to 4, the rest of y_rows stays
    zero.  ``out``: y_rows [P*rb, Kp] to add into, returned in its place."""
    _check(c0, cols, lrow, vals, nc_p, x, kt, mode, kts=(1, 8, 16, 32))
    lib, pattern, rows = _lib(), (c0, cols, lrow, nc_p), cols.shape[0] * rb
    if kt == 1:
        if out is not None:
            raise ValueError("span kernel: out= takes X of kt 8, 16 or 32 columns")
        y = launch_walk1(lib.span_walk1_launch, "span_walk1_launch", walk, pattern, vals,
                         x.view(-1), rows=rows, bf16=mode == "bf16").view(rows, 1)
    else:
        y = launch_walk(lib.span_spmm_launch, "span_spmm_launch", walk, pattern, vals, x,
                        rows=rows, k=k, bf16=mode == "bf16", out=out)
    span_rows_cuda.launches += 1
    return y


def span_stream_rows_cuda(c0, cols, lrow, vals, nc_p, x, *, rb, ct, kt, mode, walk=None,
                          k=None):
    """CUDA ``_span_kernel_stream`` (tpusparse/kernels/span_gather.py:329):
    the same y_rows as ``span_rows_cuda``, from one launch of the same row
    walk kernel over the same ``walk`` (``span_row_walk(fmt)``), whose
    arguments it takes.  The TPU kernel staged each chunk's [c0, c0+ct)
    window of X; here a slot reads its row of X where it needs it, so
    ``ct`` changes nothing (it must be positive)."""
    _check(c0, cols, lrow, vals, nc_p, x, kt, mode)
    if ct < 1:
        raise ValueError(f"span stream kernel: ct={ct}")
    y = launch_walk(_lib().span_spmm_launch, "span_spmm_launch", walk, (c0, cols, lrow, nc_p),
                    vals, x, rows=cols.shape[0] * rb, k=k, bf16=mode == "bf16")
    span_stream_rows_cuda.launches += 1
    return y


span_rows_cuda.launches = 0
span_stream_rows_cuda.launches = 0


# ----------------------------------------------------------------- entry point

def span_spmm(
    fmt: SpanFormat,
    x,
    *,
    ktile: int | None = None,
    precision: str = "fp32x2",
    unroll: int = 4,
    stream: bool = False,
    vals=None,
) -> torch.Tensor:
    """Y[M, K] = A . X[N, K] with A in SpanFormat.  ``stream=True`` runs the
    stream wrapper, the JAX package's grid-over-chunks variant, on the same
    row walk.  ``vals`` overrides the packed [P, NC, G] value plane (the
    trainable-values path); it is read only at the format's live slots
    (``perm_of_nz``'s, or the packed plane's nonzeros without it), so it
    must be zero elsewhere: on the card, a format without ``perm_of_nz``
    refuses a plane that is not.
    ``unroll`` steered the TPU kernel's loop only and changes nothing here.
    X of one column runs at kt = 1 whatever ``ktile`` (the one-column walk
    kernel; the stream wrapper takes kt 8).
    CUDA formats run a kernel, CPU formats its plain version."""
    assert precision in PRECISIONS, precision
    if vals is None:
        vals = fmt.vals
    if not isinstance(vals, torch.Tensor) or vals.device != fmt.device or \
            vals.shape != fmt.cols.shape:
        raise ValueError(f"vals must be a {tuple(fmt.cols.shape)} tensor on {fmt.device}")
    vals = vals.float().contiguous()  # a bf16 plane widens exactly
    x = prep_x(x, fmt.device)
    m, n_cols = fmt.shape
    k = x.shape[1]
    assert x.shape[0] == n_cols, f"X rows {x.shape[0]} != A cols {n_cols}"
    if ktile is None:
        ktile = default_ktile(k)
    # one column walks at kt = 1 (the one-column walk kernel), not the TPU's 8
    kt = 1 if k == 1 and not stream else choose_kt(min(ktile, 32))
    x = pad_dense_cols(x, cdiv(k, kt) * kt).contiguous()
    on_card = fmt.device.type == "cuda"
    args = (fmt.c0, fmt.cols, fmt.lrow, vals, fmt.nc_p, x)
    if stream and on_card:  # one walk per pattern, shared with the resident wrapper
        y_rows = span_stream_rows_cuda(*args, rb=fmt.rb, ct=fmt.ct, kt=kt, mode=precision,
                                       walk=span_row_walk(fmt), k=k)
    elif stream:
        y_rows = span_stream_rows_plain(*args, rb=fmt.rb, ct=fmt.ct, kt=kt, mode=precision)
    elif on_card:
        y_rows = span_rows_cuda(*args, rb=fmt.rb, kt=kt, mode=precision,
                                walk=span_row_walk(fmt), k=k)
    else:
        y_rows = span_rows_plain(*args, rb=fmt.rb, kt=kt, mode=precision)
    return unpack_slots(y_rows, fmt.slot_of_origrow)[:, :k]

