"""tpusparse_torch.native: the port's host helpers (built by g++ from its own
copy of tpusparse_host.cpp) against the port's numpy walks and the JAX
package's native helpers, on the same inputs; the .mtx parser on every
banner and on bad files; the packers that run on the helpers against the
JAX packers."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusparse import native as jnative
from tpusparse.io import mtx as jmtx
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.kernels import dg_gather as jdg
from tpusparse.kernels import dgt_gather as jdgt
from tpusparse.kernels import nnz_split as jnnz
from tpusparse.kernels import radix_gather as jradix
from tpusparse.kernels import span_gather as jspan
from tpusparse_torch import native
from tpusparse_torch.io import builder
from tpusparse_torch.io.mtx import CooMatrix, read_mtx, write_mtx
from tpusparse_torch.kernels import build
from tpusparse_torch.kernels import dg_gather as tdg
from tpusparse_torch.kernels import dgt_gather as tdgt
from tpusparse_torch.kernels import nnz_split as tnnz
from tpusparse_torch.kernels import radix_gather as tradix
from tpusparse_torch.kernels import span_gather as tspan


def _chunk_input(seed, p_count=5, empty=(2,)):
    """Column-sorted nonzeros of ``p_count`` programs (those in ``empty``
    hold none) with their program starts."""
    rng = np.random.default_rng(seed)
    sizes = [0 if p in empty else int(rng.integers(20, 300)) for p in range(p_count)]
    cols = np.concatenate([np.sort(rng.integers(0, 5000, s)) for s in sizes])
    lrow = rng.integers(0, 64, cols.size)
    vals = rng.standard_normal(cols.size).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return cols, lrow, vals, starts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("want_dest", [False, True])
def test_span_pack_equals_numpy_and_jax(seed, want_dest):
    cols, lrow, vals, starts = _chunk_input(seed)
    got = native.span_pack(cols, lrow, vals, starts, 64, 120, want_dest=want_dest)
    want = tspan.span_chunk_numpy(cols, lrow, vals, starts, 64, 120, want_dest=want_dest)
    jgot = jnative.span_pack(cols, lrow, vals, starts, 64, 120, want_dest=want_dest)
    assert len(got) == len(want) == len(jgot) == (6 if want_dest else 5)
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("window,align", [(512, 128), (1024, 1024)])
def test_span_pack_aligned_equals_numpy_and_jax(seed, window, align):
    cols, lrow, vals, starts = _chunk_input(seed, empty=(0, 4))
    got = native.span_pack_aligned(cols, lrow, vals, starts, 32, window, align, want_dest=True)
    want = tdg._aligned_chunk_numpy(cols, lrow, vals, starts, 32, window, align, want_dest=True)
    jgot = jnative.span_pack_aligned(cols, lrow, vals, starts, 32, window, align,
                                     want_dest=True)
    assert len(got) == len(want) == len(jgot) == 6
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _runs_input(seed, resid=True, ngrp=8):
    mat = builder.power_law_coo(600, 3000, avg_nnz_per_row=9.0, seed=seed)
    n_buckets = 7
    bucket = mat.rows % n_buckets
    lrow = mat.rows // n_buckets
    _, _, _, _, run_b, run_win, cnt, _ = tdgt._runs(bucket, mat.cols, lrow, col_span=3000,
                                                    ngrp=ngrp, resid=resid)
    return run_b, run_win, cnt, n_buckets + 1  # the last bucket holds no run


@pytest.mark.parametrize("seed,resid,cap,nw", [(0, True, 16, 4), (1, False, 128, 2),
                                                (2, True, 16, 8)])
def test_dgt_runs_multi_equals_numpy_and_jax(seed, resid, cap, nw):
    run_b, run_win, cnt, nb = _runs_input(seed, resid)
    got = native.dgt_runs_multi(run_b, run_win, cnt, cap, nw, nb, 8)
    want = tdgt.dgt_runs_multi_numpy(run_b, run_win, cnt, cap, nw, nb, 8)
    jgot = jnative.dgt_runs_multi(run_b, run_win, cnt, cap, nw, nb, 8)
    assert len(got) == len(want) == len(jgot) == 10
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed,resid,cap,nw", [(0, True, 16, 4), (1, False, 128, 1)])
def test_dgt_runs_equals_numpy_and_jax(seed, resid, cap, nw):
    run_b, run_win, cnt, nb = _runs_input(seed, resid)
    got = native.dgt_runs(run_b, run_win, cnt, cap, nw, nb)
    want = tdgt.dgt_runs_numpy(run_b, run_win, cnt, cap, nw, nb)
    jgot = jnative.dgt_runs(run_b, run_win, cnt, cap, nw, nb)
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("work", [1, 7, 64, 10_000])
def test_merge_path_cuts_equals_brute_force_and_jax(work):
    mat = builder.power_law_coo(300, 200, avg_nnz_per_row=5.0, seed=4)
    ptr = mat.to_csr_ptr()
    rows, nzs = native.merge_path_cuts(ptr, mat.nnz, work)
    jrows, jnzs = jnative.merge_path_cuts(ptr, mat.nnz, work)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(nzs, jnzs)
    # the cut on diagonal d: the fewest row steps r whose rows hold at
    # least the d - r nonzero steps taken (the merge-path search)
    total = mat.shape[0] + mat.nnz
    for i, d in enumerate(np.minimum(np.arange(rows.size) * work, total)):
        r = min(r for r in range(max(0, d - mat.nnz), min(d, mat.shape[0]) + 1)
                if ptr[r] >= d - r)
        assert (rows[i], nzs[i]) == (r, d - r)


def test_bucket_pack_and_counts():
    rng = np.random.default_rng(5)
    key = rng.integers(0, 9, 500)
    a, b = rng.integers(0, 1000, 500), rng.integers(0, 1000, 500)
    v = rng.standard_normal(500).astype(np.float32)
    counts = native.bucket_counts(key, 9)
    np.testing.assert_array_equal(counts, np.bincount(key, minlength=9))
    np.testing.assert_array_equal(counts, jnative.bucket_counts(key, 9))
    cap = int(counts.max())
    oa, ob, ov, fill = native.bucket_pack(key, a, b, v, 9, cap)
    assert fill == cap
    for k in range(9):  # stable: a bucket's payloads in input order, then zeros
        sel = key == k
        np.testing.assert_array_equal(oa[k], np.pad(a[sel], (0, cap - sel.sum())))
        np.testing.assert_array_equal(ob[k], np.pad(b[sel], (0, cap - sel.sum())))
        np.testing.assert_array_equal(ov[k], np.pad(v[sel], (0, cap - sel.sum())))
    for x, y in zip((oa, ob, ov, fill), jnative.bucket_pack(key, a, b, v, 9, cap)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="bucket overflow"):
        native.bucket_pack(key, a, b, v, 9, cap - 1)
    with pytest.raises(ValueError, match="bucket overflow"):
        native.bucket_pack(key, a, b, v, 8, cap)  # a key past the last bucket


MTX_FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% c\n4 5 4\n"
               "1 1 1.5\n4 5 -2\n2 3 3.25\n1 2 1e-3\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n3 3 3\n1 1 2\n2 1 -1\n3 2 4\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n3 4 3\n1 4\n3 1\n2 2\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n2 1 5\n3 1 -1\n",
    "bare": "3 3 2\n1 3 7\n3 1 8\n",
}
BAD_FILES = {
    "malformed": "%%MatrixMarket matrix coordinate real general\nnot a size line\n",
    "out_of_range": "%%MatrixMarket matrix coordinate real general\n3 3 1\n4 1 1.0\n",
    "skew_diagonal": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 1\n2 2 1.0\n",
}


def _same_coo(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)


@pytest.mark.parametrize("kind", sorted(MTX_FILES))
def test_parse_mtx_equals_python_reader_and_jax(kind, tmp_path):
    path = tmp_path / f"{kind}.mtx"
    path.write_text(MTX_FILES[kind])
    got = read_mtx(path)
    with open(path) as f:
        _same_coo(got, read_mtx(f))
    _same_coo(got, jmtx.read_mtx(str(path)))
    rows, cols, vals, dims = native.parse_mtx(str(path))
    _same_coo(got, CooMatrix(rows, cols, vals, dims))


@pytest.mark.parametrize("kind", sorted(BAD_FILES))
def test_parse_mtx_raises_like_jax(kind, tmp_path):
    path = tmp_path / f"{kind}.mtx"
    path.write_text(BAD_FILES[kind])
    with pytest.raises(ValueError) as jerr:
        jmtx.read_mtx(str(path))
    with pytest.raises(ValueError) as err:
        read_mtx(path)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError):  # the Python reader refuses it too
        with open(path) as f:
            read_mtx(f)
    with pytest.raises(FileNotFoundError):
        read_mtx(tmp_path / "missing.mtx")


def test_parse_mtx_round_trip_of_write_mtx(tmp_path):
    mat = builder.power_law_coo(500, 300, avg_nnz_per_row=7.0, seed=8)
    write_mtx(tmp_path / "m.mtx", mat)
    got = read_mtx(tmp_path / "m.mtx")
    np.testing.assert_array_equal(got.rows, mat.rows)
    np.testing.assert_array_equal(got.cols, mat.cols)
    np.testing.assert_array_equal(got.vals, np.asarray(mat.vals, np.float64))


def _mats():
    with_empty = builder.power_law_coo(400, 900, avg_nnz_per_row=6.0, seed=11)
    keep = (with_empty.rows % 5) != 2          # every fifth row empty
    return {
        "power_law": builder.power_law_coo(700, 1200, avg_nnz_per_row=8.0, seed=10),
        "empty_rows": CooMatrix(with_empty.rows[keep], with_empty.cols[keep],
                                with_empty.vals[keep], with_empty.shape),
        "uniform": builder.uniform_coo(256, 3000, nnz_per_row=5, seed=12),
    }


def _assert_fields_equal(jfmt, tfmt):
    """Every field the JAX format has, equal in the port's format."""
    for f in dataclasses.fields(jfmt):
        want, got = getattr(jfmt, f.name), getattr(tfmt, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.float().numpy() if got.dtype == torch.bfloat16
                                          else got.numpy(), np.asarray(want), err_msg=f.name)
        elif want is None or isinstance(want, (int, float, str, bool, tuple)):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f.name)


PACKERS = {
    "dg": (lambda m, **kw: jdg.pack_dg(m, rb=128, ns=2, g=128, kt=8, keep_perm=True),
           lambda m, **kw: tdg.pack_dg(m, rb=128, ns=2, g=128, kt=8, keep_perm=True, **kw)),
    "dg1": (lambda m, **kw: jdg.pack_dg(m, rb=256, ns=4, g=128, kt=1),
            lambda m, **kw: tdg.pack_dg(m, rb=256, ns=4, g=128, kt=1, **kw)),
    "dgt_multi": (lambda m, **kw: jdgt.pack_dgt(m, rb=64, g=256, kt=8, keep_perm=True),
                  lambda m, **kw: tdgt.pack_dgt(m, rb=64, g=256, kt=8, keep_perm=True, **kw)),
    "dgt_single": (lambda m, **kw: jdgt.pack_dgt(m, rb=64, g=256, kt=8, walk="single"),
                   lambda m, **kw: tdgt.pack_dgt(m, rb=64, g=256, kt=8, walk="single", **kw)),
    "span": (lambda m, **kw: jspan.pack_span(m, rb=64, ct=256, g=32, keep_perm=True),
             lambda m, **kw: tspan.pack_span(m, rb=64, ct=256, g=32, keep_perm=True, **kw)),
    "radix": (lambda m, **kw: jradix.pack_radix(m, rb=64, S=32, g=64, kt=8),
              lambda m, **kw: tradix.pack_radix(m, rb=64, S=32, g=64, kt=8, **kw)),
    "segment_span": (lambda m, **kw: jnnz.pack_segment_span(m, block_nnz=512, ct=256, g=64),
                     lambda m, **kw: tnnz.pack_segment_span(m, block_nnz=512, ct=256, g=64,
                                                            **kw)),
}


@pytest.mark.parametrize("which", sorted(_mats()))
@pytest.mark.parametrize("packer", sorted(PACKERS))
def test_packers_on_native_helpers_equal_jax(packer, which):
    mat = _mats()[which]
    jpack, tpack = PACKERS[packer]
    jfmt = jpack(JCoo(mat.rows, mat.cols, mat.vals, mat.shape))
    _assert_fields_equal(jfmt, tpack(mat, device="cpu"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setitem(build._libs, build.HOST_SOURCE, None)
    build._libs.pop(build.HOST_SOURCE)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="host compiler"):
        native.span_pack(np.zeros(1, np.int64), np.zeros(1, np.int64), np.ones(1, np.float32),
                         np.array([0, 1]), 8, 64)
    assert not list(tmp_path.iterdir())


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / f"{build.HOST_SOURCE}.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setitem(build._libs, build.HOST_SOURCE, None)
    build._libs.pop(build.HOST_SOURCE)
    with pytest.raises(RuntimeError, match="host build failed"):
        build.host_library()
    assert not list((tmp_path / "out").glob("*.tmp"))
