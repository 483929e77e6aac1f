"""ctypes bindings for the port's native host helpers (counterpart of
``tpusparse/native.py``).

``tpusparse_torch/csrc/tpusparse_host.cpp`` is built by ``g++`` (or
``$CXX``) at first use (``kernels/build.py::host_library``) and holds the
host-side O(nnz) walks: the .mtx parser, merge-path cuts, bucket packing,
the span and aligned-window chunk walks and the dgt tile walks.  Every
entry point takes and returns numpy arrays, as in the JAX package.  There
is no numpy fallback here: a missing compiler or a failed build raises.
The numpy walks stay beside the packers as the plain versions that the
tests hold these against.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from tpusparse_torch.kernels.build import host_library

_lock = threading.Lock()
_lib = None

_I64 = ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PF32 = ctypes.POINTER(ctypes.c_float)
_PF64 = ctypes.POINTER(ctypes.c_double)

# argtypes of each export (restype, argtypes)
_SIGNATURES = {
    "ts_parse_mtx": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_PI64),
                                    ctypes.POINTER(_PI64), ctypes.POINTER(_PF64),
                                    _PI64, _PI64, _PI64]),
    "ts_free": (None, [ctypes.c_void_p]),
    "ts_merge_path_cuts": (_I64, [_PI64, _I64, _I64, _I64, _PI64, _PI64]),
    "ts_bucket_pack": (_I64, [_PI64, _I64, _I64, _I64, _PI32, _PI32, _PF32,
                              _PI32, _PI32, _PF32]),
    "ts_bucket_counts": (None, [_PI64, _I64, _I64, _PI64]),
    "ts_span_count": (_I64, [_PI64, _PI64, _I64, _I64, _I64, _PI64]),
    "ts_span_fill": (None, [_PI64, _PI64, _PF32, _PI64, _I64, _I64, _I64, _I64,
                            _PI32, _PI32, _PI32, _PF32, _PI64]),
    "ts_span_count_al": (_I64, [_PI64, _PI64, _I64, _I64, _I64, _I64, _PI64]),
    "ts_span_fill_al": (None, [_PI64, _PI64, _PF32, _PI64, _I64, _I64, _I64, _I64, _I64,
                               _PI32, _PI32, _PI32, _PF32, _PI64]),
    "ts_dgt_runs": (None, [_PI64, _PI64, _PI64, _I64, _I64, _I64, _I64, _I64,
                           *[_PI64] * 7]),
    "ts_dgt_runs_multi": (_I64, [_PI64, _PI64, _PI64, *[_I64] * 7, *[_PI64] * 11]),
}


def _load() -> ctypes.CDLL:
    """The host library with its exports' signatures bound (built at first
    use; raises if it cannot be built)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = host_library()
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _p(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def parse_mtx(path: str):
    """Native .mtx load -> (rows, cols, vals, (m, n)), row-major sorted.
    Raises FileNotFoundError for a missing file and ValueError on a
    malformed file, an entry out of range or a diagonal entry of a
    skew-symmetric matrix, as the JAX package's native parser does."""
    lib = _load()
    rows_p, cols_p, vals_p = _PI64(), _PI64(), _PF64()
    m, n, nnz = _I64(), _I64(), _I64()
    rc = lib.ts_parse_mtx(os.fsencode(path), ctypes.byref(rows_p), ctypes.byref(cols_p),
                          ctypes.byref(vals_p), ctypes.byref(m), ctypes.byref(n),
                          ctypes.byref(nnz))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"malformed matrix file: {path}")
    if rc == -3:
        raise ValueError(f"entry index out of range in {path}")
    if rc == -5:
        raise ValueError(f"diagonal entry in skew-symmetric matrix: {path}")
    if rc != 0:
        raise MemoryError(f"parse_mtx: allocation failed reading {path}")
    k = nnz.value
    try:
        rows = np.ctypeslib.as_array(rows_p, shape=(max(k, 1),))[:k].copy()
        cols = np.ctypeslib.as_array(cols_p, shape=(max(k, 1),))[:k].copy()
        vals = np.ctypeslib.as_array(vals_p, shape=(max(k, 1),))[:k].copy()
    finally:
        for ptr in (rows_p, cols_p, vals_p):
            lib.ts_free(ptr)
    return rows, cols, vals, (int(m.value), int(n.value))


def merge_path_cuts(row_ptr: np.ndarray, nnz: int, work: int):
    """Merge-path cut points -> (first_rows, first_nzs), each n_cuts+1 long."""
    lib = _load()
    row_ptr = _i64(row_ptr)
    m = row_ptr.size - 1
    n_cuts = max((m + nnz + work - 1) // work, 1) if work > 0 else 1
    out_r = np.zeros(n_cuts + 1, dtype=np.int64)
    out_z = np.zeros(n_cuts + 1, dtype=np.int64)
    got = lib.ts_merge_path_cuts(_p(row_ptr, _PI64), m, nnz, work,
                                 _p(out_r, _PI64), _p(out_z, _PI64))
    return out_r[: got + 1], out_z[: got + 1]


def bucket_pack(key: np.ndarray, a: np.ndarray, b: np.ndarray, v: np.ndarray,
                n_buckets: int, cap: int):
    """Scatter payloads into padded [n_buckets, cap] arrays (stable order).
    Returns (out_a, out_b, out_v, max_fill).  Raises ValueError if any
    bucket exceeds cap or a key lies outside [0, n_buckets)."""
    lib = _load()
    key = _i64(key)
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.float32)
    out_a = np.empty((n_buckets, cap), dtype=np.int32)
    out_b = np.empty((n_buckets, cap), dtype=np.int32)
    out_v = np.empty((n_buckets, cap), dtype=np.float32)
    got = lib.ts_bucket_pack(_p(key, _PI64), key.size, n_buckets, cap,
                             _p(a, _PI32), _p(b, _PI32), _p(v, _PF32),
                             _p(out_a, _PI32), _p(out_b, _PI32), _p(out_v, _PF32))
    if got < 0:
        raise ValueError(f"bucket overflow: occupancy exceeds cap {cap}")
    return out_a, out_b, out_v, int(got)


def bucket_counts(key: np.ndarray, n_buckets: int) -> np.ndarray:
    """Per-bucket occupancy counts (keys outside [0, n_buckets) ignored)."""
    lib = _load()
    key = _i64(key)
    out = np.zeros(n_buckets, dtype=np.int64)
    lib.ts_bucket_counts(_p(key, _PI64), key.size, n_buckets, _p(out, _PI64))
    return out


def _chunk_pack(count, fill, cols_sorted, lrow_sorted, vals_sorted, p_starts, g, params,
                want_dest):
    """The two passes of a chunk walk: count the chunks of each program,
    then fill the zeroed [P, NC, G] planes."""
    cols_sorted = _i64(cols_sorted)
    lrow_sorted = _i64(lrow_sorted)
    vals_sorted = np.ascontiguousarray(vals_sorted, dtype=np.float32)
    p_starts = _i64(p_starts)
    p_count = p_starts.size - 1
    nc_arr = np.zeros(p_count, dtype=np.int64)
    nc = int(count(_p(cols_sorted, _PI64), _p(p_starts, _PI64), p_count, g, *params,
                   _p(nc_arr, _PI64)))
    c0 = np.zeros((p_count, nc), dtype=np.int32)
    out_cols = np.zeros((p_count, nc, g), dtype=np.int32)
    out_lrow = np.zeros((p_count, nc, g), dtype=np.int32)
    out_vals = np.zeros((p_count, nc, g), dtype=np.float32)
    dest = np.zeros(cols_sorted.size, dtype=np.int64) if want_dest else None
    fill(_p(cols_sorted, _PI64), _p(lrow_sorted, _PI64), _p(vals_sorted, _PF32),
         _p(p_starts, _PI64), p_count, g, *params, nc, _p(c0, _PI32), _p(out_cols, _PI32),
         _p(out_lrow, _PI32), _p(out_vals, _PF32),
         _p(dest, _PI64) if want_dest else None)
    return c0, out_cols, out_lrow, out_vals, nc_arr, dest


def span_pack(cols_sorted, lrow_sorted, vals_sorted, p_starts, g: int, span_budget: int,
              want_dest: bool = False):
    """The span chunk walk: each program's column-sorted nonzeros cut into
    chunks of at most ``g`` whose columns lie within ``span_budget + 8`` of
    the chunk's start (its first column rounded down to a multiple of 8).
    Returns (c0 [P, NC] int32, cols/lrow [P, NC, G] int32, vals [P, NC, G]
    f32, nc_per_program [P] int64 (1 for a program with no nonzero)[, dest
    [nnz] int64: each input nonzero's flat packed position])."""
    lib = _load()
    out = _chunk_pack(lib.ts_span_count, lib.ts_span_fill, cols_sorted, lrow_sorted,
                      vals_sorted, p_starts, g, (span_budget,), want_dest)
    return out if want_dest else out[:5]


def span_pack_aligned(cols_sorted, lrow_sorted, vals_sorted, p_starts, g: int, window: int,
                      align: int, want_dest: bool = False):
    """The aligned-window chunk walk (dg): a chunk's start is its first
    column aligned down to ``align``, and its columns lie in ``window``
    from there.  Same returns as :func:`span_pack`."""
    lib = _load()
    out = _chunk_pack(lib.ts_span_count_al, lib.ts_span_fill_al, cols_sorted, lrow_sorted,
                      vals_sorted, p_starts, g, (window, align), want_dest)
    return out if want_dest else out[:5]


def dgt_runs_multi(run_b, run_win, cnt, cap: int, nw: int, n_buckets: int, max_open: int):
    """The multi-open-tile dgt walk over (bucket, window) runs: (seg_run,
    seg_cls, seg_tile, seg_fill, seg_cnt, seg_sel, wins_b, wins_t, wins_w,
    tot_tiles)."""
    lib = _load()
    run_b, run_win, cnt = _i64(run_b), _i64(run_win), _i64(cnt)
    n_runs, ncls = cnt.shape
    seg_cap = max(int(cnt.sum()), 1)  # every segment and fresh tile holds >= 1 nz
    segs = [np.zeros(seg_cap, dtype=np.int64) for _ in range(6)]
    wins = [np.zeros(seg_cap, dtype=np.int64) for _ in range(3)]
    tot_tiles = np.zeros(max(n_buckets, 1), dtype=np.int64)
    counts = np.zeros(2, dtype=np.int64)  # n_segs, n_wins
    rc = lib.ts_dgt_runs_multi(_p(run_b, _PI64), _p(run_win, _PI64), _p(cnt, _PI64),
                               n_runs, ncls, cap, nw, n_buckets, max_open, seg_cap,
                               *[_p(a, _PI64) for a in segs + wins],
                               _p(tot_tiles, _PI64), _p(counts, _PI64))
    if rc != 0:
        raise RuntimeError(f"ts_dgt_runs_multi: more than {seg_cap} segments")
    ns, nwins = int(counts[0]), int(counts[1])
    return (*[a[:ns] for a in segs], *[a[:nwins] for a in wins], tot_tiles[:n_buckets])


def dgt_runs(run_b, run_win, cnt, cap: int, nw: int, n_buckets: int):
    """The single-open-tile dgt walk over (bucket, window) runs: (take,
    open_tile, open_fill, join_pos, new_base, fresh_n, tot_tiles)."""
    lib = _load()
    run_b, run_win, cnt = _i64(run_b), _i64(run_win), _i64(cnt)
    n_runs, ncls = cnt.shape
    take = np.zeros((n_runs, ncls), dtype=np.int64)
    open_tile = np.zeros(n_runs, dtype=np.int64)
    open_fill = np.zeros((n_runs, ncls), dtype=np.int64)
    join_pos = np.zeros(n_runs, dtype=np.int64)
    new_base = np.zeros(n_runs, dtype=np.int64)
    fresh_n = np.zeros(n_runs, dtype=np.int64)
    tot_tiles = np.zeros(max(n_buckets, 1), dtype=np.int64)
    lib.ts_dgt_runs(_p(run_b, _PI64), _p(run_win, _PI64), _p(cnt, _PI64), n_runs, ncls,
                    cap, nw, n_buckets,
                    *[_p(a, _PI64) for a in (take, open_tile, open_fill, join_pos,
                                              new_base, fresh_n, tot_tiles)])
    return take, open_tile, open_fill, join_pos, new_base, fresh_n, tot_tiles[:n_buckets]
