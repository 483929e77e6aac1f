"""Shared kernel utilities (counterpart of ``tpusparse/kernels/common.py``)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on, with its index (``cuda`` becomes
    the current device, ``cuda:0`` say).  CUDA is the default and there is
    no quiet fallback: asking for CUDA without a card raises.  Only a caller
    that passes ``device="cpu"`` gets the plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # the index the tensors made on it carry, so that devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def value_dtype(val_dtype) -> torch.dtype:
    """The value plane's dtype: None is float32; else a torch dtype or its
    name ("bfloat16", "float16", "float32")."""
    if val_dtype is None:
        return torch.float32
    if isinstance(val_dtype, torch.dtype):
        return val_dtype
    name = val_dtype if isinstance(val_dtype, str) else np.dtype(val_dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"val_dtype {val_dtype!r} is not a float dtype")
    return dt


def storage_dtype(dtype) -> torch.dtype:
    """The value plane's dtype, from a torch dtype or a numpy dtype or name:
    bfloat16, float32 or int8."""
    if isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dt = getattr(torch, name, None)
    if dt not in (torch.bfloat16, torch.float32, torch.int8):
        raise ValueError(f"dtype {dtype!r}: want bfloat16, float32 or int8")
    return dt


def quantize_rows(out_v: np.ndarray, axes) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization per output row: scale max|row| / 127
    (1 for an empty row) over ``axes``; returns (int8 values, fp32 scale)
    with the JAX packers' numpy arithmetic."""
    row_amax = np.abs(out_v).max(axis=axes)
    rs = np.where(row_amax > 0, row_amax / 127.0, 1.0)
    shape = [1] * out_v.ndim
    keep = [d for d in range(out_v.ndim) if d not in axes]
    for d, size in zip(keep, rs.shape):
        shape[d] = size
    q = np.clip(np.rint(out_v / rs.reshape(shape)), -127, 127).astype(np.int8)
    return q, rs.astype(np.float32)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) with an fp32 result, as JAX's
    ``preferred_element_type=float32``.  fp32 operands: a plain fp32
    product (TF32 stays off).  bf16 operands: on the card cuBLAS's bf16
    product with an fp32 output (``out_dtype``); the CPU build has no kernel
    for that, so there the fp32 product of the same bf16 values (exact
    products, fp32 sums).  ``torch.matmul`` of bf16 would round Y to bf16."""
    mm = torch.mm if a.ndim == 2 else torch.bmm
    if a.dtype == torch.bfloat16 and a.device.type == "cuda":
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


def to_device(dev: torch.device, a, dtype=torch.int32) -> torch.Tensor:
    """A packer's numpy array as a contiguous tensor of ``dtype`` on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def lex_order(minor: np.ndarray, major: np.ndarray) -> np.ndarray:
    """``np.lexsort((minor, major))`` for nonnegative integer keys: one
    stable argsort of ``major * (max(minor) + 1) + minor``, the same order
    (ties kept in input order) at about half lexsort's time on 10M keys,
    where the sort was most of a pack."""
    minor = np.asarray(minor, dtype=np.int64)
    major = np.asarray(major, dtype=np.int64)
    span = int(minor.max(initial=0)) + 1
    return np.argsort(major * span + minor, kind="stable")


def fill_chunks(chunks, cols_s, lrow_s, vals_s, g: int, want_dest: bool):
    """The [P, NC, G] planes of a chunk walk's (c0, first, end) chunks per
    program, as the native fill writes them (the numpy walks' shared
    half): (c0, cols, lrow, vals, nc_per_program[, dest]), where a program
    with no chunk counts one."""
    p_count = len(chunks)
    nc = max(max((len(c) for c in chunks), default=1), 1)
    c0_2d = np.zeros((p_count, nc), dtype=np.int32)
    cols_f = np.zeros((p_count, nc, g), dtype=np.int32)
    lrow_f = np.zeros((p_count, nc, g), dtype=np.int32)
    vals_f = np.zeros((p_count, nc, g), dtype=np.float32)
    dest = np.zeros(cols_s.size, dtype=np.int64) if want_dest else None
    for p in range(p_count):
        for ci, (c0, i, j) in enumerate(chunks[p]):
            n = j - i
            c0_2d[p, ci] = c0
            cols_f[p, ci, :n] = cols_s[i:j] - c0
            lrow_f[p, ci, :n] = lrow_s[i:j]
            vals_f[p, ci, :n] = vals_s[i:j]
            if want_dest:
                dest[i:j] = (p * nc + ci) * g + np.arange(n)
    nc_arr = np.asarray([max(len(c), 1) for c in chunks], dtype=np.int64)
    out = (c0_2d, cols_f, lrow_f, vals_f, nc_arr)
    return (*out, dest) if want_dest else out


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_dense_rows(x: torch.Tensor, target_rows: int) -> torch.Tensor:
    """Zero-pad the leading dim of X (dense operand) to ``target_rows``."""
    if x.shape[0] == target_rows:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, target_rows - x.shape[0]])


def pad_dense_cols(x: torch.Tensor, target_cols: int) -> torch.Tensor:
    """Zero-pad the last dim of X to ``target_cols``."""
    if x.shape[-1] == target_cols:
        return x
    return F.pad(x, [0, target_cols - x.shape[-1]])


def prep_x(x, device: torch.device) -> torch.Tensor:
    """X as a contiguous fp32 tensor on the format's ``device``.  A tensor
    on another device is refused rather than moved, so nothing quietly runs
    on the CPU."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"X is on {x.device}, the format on {device}")
        return x.to(torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device).contiguous()


def unpack_slots(y_rows: torch.Tensor, slot_of_origrow: torch.Tensor) -> torch.Tensor:
    """Y's rows from the pre-unpack row block: row r is y_rows[slot[r]], or
    zero where slot[r] < 0 (a row the format holds no slot for)."""
    slot = slot_of_origrow.long()
    got = y_rows.index_select(0, slot.clamp(min=0))
    valid = (slot >= 0).view(-1, *([1] * (y_rows.ndim - 1)))
    return torch.where(valid, got, torch.zeros((), dtype=got.dtype, device=got.device))


def unpack_by_deal(fmt, y_rows: torch.Tensor) -> torch.Tensor:
    """Y's rows from the pre-unpack row block of a dealt format (dg, radix):
    ``fmt.deal`` 'blocks' (slot == row) slices, 'index' (slot = (r % P) *
    rb + r // P) reshapes and transposes, anything else gathers through
    ``slot_of_origrow``, by the gather index that ``deal_index`` keeps on
    the format."""
    if fmt.deal == "blocks":
        return y_rows[: fmt.shape[0]]
    if fmt.deal == "index":
        P = fmt.n_programs
        return (y_rows.reshape(P, fmt.rb, *y_rows.shape[1:])
                .transpose(0, 1).reshape(P * fmt.rb, *y_rows.shape[1:])[: fmt.shape[0]])
    idx, valid = deal_index(fmt)
    got = y_rows.index_select(0, idx)
    if valid is None:
        return got
    return torch.where(valid.view(-1, *([1] * (y_rows.ndim - 1))), got, 0.0)


def deal_index(fmt):
    """(index, valid) of a dealt format's unpack: ``slot_of_origrow`` as an
    int64 gather index (a row without a slot reads slot 0) and the mask of
    the rows with a slot, None where every row has one.  Made at the first
    call and kept on the format as ``fmt.unpack_index`` while
    ``slot_of_origrow`` stands, so that a call gathers and masks Y without
    converting, clamping and comparing the slots anew (host work the SpMV's
    short calls would wait on)."""
    slot = fmt.slot_of_origrow
    kept = getattr(fmt, "unpack_index", None)
    version = None if slot.is_inference() else slot._version
    if kept is None or kept[0] is not slot or kept[1] != version:
        idx = slot.long()
        valid = idx >= 0
        kept = (slot, version, idx.clamp(min=0),
                None if bool(valid.all()) else valid.contiguous())
        fmt.unpack_index = kept
    return kept[2], kept[3]


def window_rows_plain(start, cols, lrow, vals, nc_p, x, *, rb, scale=1, bf16=False):
    """Plain PyTorch version of the window-format gather kernels (dg, span,
    tile): y_rows [P*rb, ...] with ``y_rows[p*rb + lrow] += vals *
    X[start[p, j]*scale + cols]`` over the live slots — chunk j < nc_p[p],
    value not zero — as an ``index_add_``; bf16 rounds each product, as
    the kernels do."""
    P, NC, G = cols.shape
    live = ((vals != 0) & (torch.arange(NC, device=cols.device).view(1, NC, 1)
                           < nc_p.reshape(P, 1, 1))).reshape(-1)
    col = (start.reshape(P, NC, 1).long() * scale + cols.long()).reshape(-1)[live]
    row = (torch.arange(P, device=cols.device).view(P, 1, 1) * rb
           + lrow.long()).reshape(-1)[live]
    v = vals.reshape(-1)[live].float()
    prod = v.view(-1, *([1] * (x.ndim - 1))) * x[col]
    if bf16:
        prod = prod.to(torch.bfloat16).float()
    y = torch.zeros((P * rb,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    return y.index_add_(0, row, prod)


# ------------------------------------------- launching the csrc gather kernels

@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """The number of SMs of a CUDA device."""
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


def check_operands(x: torch.Tensor, fields, *, ndim: int) -> None:
    """Raises unless X is an ``ndim``-D contiguous, 16-byte aligned float32
    CUDA tensor and every ``(name, tensor, dtype, shape)`` of ``fields`` a
    contiguous tensor of that dtype and shape on X's device, with at most
    65535 programs (the grid's y dimension; the first dim of the first
    field)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, X is on {dev}")
    for name, t, dt, shp in fields:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shp or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dt} tensor {shp} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"X must be a contiguous, 16-byte aligned {ndim}-D float32 tensor")
    if fields[0][3][0] > 65535:
        raise ValueError(f"P={fields[0][3][0]} programs exceed the grid's y dimension (65535)")


def kernel_info(fn, name: str, *ints) -> dict:
    """A csrc kernel's resources on the current card, from its query
    ``fn(*ints, out)``: registers a thread, spilled (local) bytes a thread,
    static shared bytes and blocks an SM holds."""
    out = (ctypes.c_int * 4)()
    rc = fn(*ints, out)
    if rc:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    return dict(zip(("registers", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))


def launch_checked(fn, name: str, tensors, ints) -> None:
    """Calls a csrc launcher ``fn(*pointers, *ints, stream)`` with the
    tensors' pointers on the current stream of their device; raises on a
    nonzero cudaError_t."""
    with torch.cuda.device(tensors[0].device):
        rc = fn(*(t.data_ptr() for t in tensors), *ints,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
