"""tpusparse_torch.kernels.radix_gather against the JAX package's radix_gather.

The packers must emit the JAX packers' arrays (pack_radix over every deal,
kt and mode; pack_brick_ell after the brick-ELL operator pipeline), and the
port's radix_spmm on the CPU (the kernel's plain version) must match the
JAX functions (Pallas interpret mode, as tests/test_radix_kernel.py runs
them) and the oracle.  Tolerances against the JAX side, of max|ref|: 2e-3
where it runs fp32x2 (its hi/lo bf16 split of X and of each product), 1e-2
in bf16 (it rounds X to bf16 as well as the product; the port rounds only
the product); the port itself is fp32 in fp32x2 mode and is held to 1e-5
against the oracle.
"""

import numpy as np
import pytest
import torch

from tpusparse.io import builder as jbuilder
from tpusparse.kernels import radix_gather as jrg
from tpusparse.kernels.common import pad_dense_rows, round_up
from tpusparse.meta.set import create_init_metadata_set as jms
from tpusparse.oracle import check_result, spmm_reference
from tpusparse import ops as jops
from tpusparse_torch import ops as tops
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import radix_gather as trg
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.set import create_init_metadata_set as tms

STATIC = ("n_programs", "n_chunks", "chunk_g", "rb", "S", "kt", "mode", "shape", "nnz_real",
          "deal")
TOL = {"fp32x2": 2e-3, "bf16": 1e-2}


def _case(m=300, n=400, k=8, avg=6.0, seed=0):
    jmat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return jmat, CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape), x


def _assert_same_format(jfmt, tfmt):
    for f in (*trg.RADIX_FIELDS, "nc_p"):
        np.testing.assert_array_equal(getattr(tfmt, f).numpy(), np.asarray(getattr(jfmt, f)),
                                      err_msg=f)
    for f in STATIC:
        assert getattr(tfmt, f) == getattr(jfmt, f), f
    if jfmt.perm_of_nz is None:
        assert tfmt.perm_of_nz is None
    else:
        np.testing.assert_array_equal(tfmt.perm_of_nz, jfmt.perm_of_nz)
    assert tfmt.memory_bytes == jfmt.memory_bytes and tfmt.window == jfmt.window


def _from_jax(jfmt):
    fields = {f: np.asarray(getattr(jfmt, f)) for f in trg.RADIX_FIELDS}
    fields["perm_of_nz"] = jfmt.perm_of_nz
    return trg.radix_format_from_numpy(fields, device="cpu",
                                       **{f: getattr(jfmt, f) for f in STATIC})


@pytest.mark.parametrize("deal", [None, "length", "index", "blocks"])
@pytest.mark.parametrize("kt", trg.RADIX_KTS)
@pytest.mark.parametrize("mode", trg.PRECISIONS)
def test_pack_radix_equals_jax(deal, kt, mode):
    jmat, tmat, _ = _case(m=300, n=3000, avg=9.0, seed=7)
    kw = dict(rb=128, S=32, g=64, kt=kt, mode=mode, deal=deal, keep_perm=True)
    _assert_same_format(jrg.pack_radix(jmat, **kw), trg.pack_radix(tmat, device="cpu", **kw))


def test_geometry_choose_kt_and_refusals_equal_jax():
    for kt in trg.RADIX_KTS:
        for mode in trg.PRECISIONS:
            assert trg.radix_geometry(kt, mode) == jrg.radix_geometry(kt, mode)
    for k in range(1, 70):
        assert trg.choose_kt(k) == jrg.choose_kt(k)
    _, tmat, _ = _case()
    with pytest.raises(AssertionError, match="multiple of ngrp"):
        trg.pack_radix(tmat, rb=100, kt=8, device="cpu")
    with pytest.raises(AssertionError, match="exceed the alignment"):
        trg.pack_radix(tmat, rb=128, S=8, kt=8, device="cpu")


def test_pack_radix_through_a_sorted_metadata_set():
    jmat, tmat, x = _case(seed=5)
    jm, tm = jms(jmat), tms(tmat)
    jops.OperatorExecutor(jm).add_and_run(jops.SortOperator(0))
    tops.OperatorExecutor(tm).add_and_run(tops.SortOperator(0))
    kw = dict(out_rows=300, rb=64, S=16, g=64, kt=4, mode="fp32x2", deal="index")
    jfmt, tfmt = jrg.pack_radix(jm, 0, **kw), trg.pack_radix(tm, 0, device="cpu", **kw)
    _assert_same_format(jfmt, tfmt)
    assert tfmt.deal == "arbitrary"          # the sort leaves only the gather
    check_result(trg.radix_spmm(tfmt, x).numpy(), spmm_reference(jmat, x.astype(np.float64)),
                 rtol=1e-5)


@pytest.mark.parametrize("kt,mode,k", [(1, "fp32x2", 1), (2, "fp32x2", 2), (4, "fp32x2", 4),
                                       (8, "fp32x2", 8), (32, "fp32x2", 32), (4, "bf16", 4),
                                       (8, "bf16", 16)])
def test_radix_rows_plain_matches_radix_call(kt, mode, k):
    # the kernel's own contract: the pre-unpack row block, before the gather
    jmat, _, x = _case(k=k, seed=3)
    jfmt = jrg.pack_radix(jmat, rb=128, S=16, g=128, kt=kt, mode=mode)
    spr = jrg.radix_geometry(kt, mode)[0]
    xj = pad_dense_rows(x, round_up(400 + jfmt.window, 8 * spr))
    rows_j = np.asarray(jrg._radix_call(
        jfmt.c0, jfmt.cols, jfmt.lrow, jfmt.vals, xj, n_programs=jfmt.n_programs,
        nc=jfmt.n_chunks, g=jfmt.chunk_g, rb=jfmt.rb, S=jfmt.S, kt=kt, mode=mode, unroll=1,
        ktin=1, interpret=True))
    t = _from_jax(jfmt)
    rows_t = trg.radix_rows_plain(t.c0, t.cols, t.lrow, t.vals, t.nc_p, torch.from_numpy(x),
                                  rb=t.rb, kt=kt, mode=mode)
    assert rows_t.shape == rows_j.shape
    ref = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(rows_t.numpy(), rows_j, rtol=0, atol=TOL[mode] * np.abs(ref).max())


@pytest.mark.parametrize("kt,k,deal,mode", [(2, 2, None, "fp32x2"), (4, 3, "index", "fp32x2"),
                                            (8, 8, "blocks", "fp32x2"), (16, 40, None, "fp32x2"),
                                            (8, 8, None, "bf16")])
def test_radix_spmm_matches_jax_and_oracle(kt, k, deal, mode):
    jmat, tmat, x = _case(k=k, seed=2)
    kw = dict(rb=128, S=16, g=128, kt=kt, mode=mode, deal=deal)
    jfmt = jrg.pack_radix(jmat, **kw)
    yj = np.asarray(jrg.radix_spmm(jfmt, x))
    ref = spmm_reference(jmat, x.astype(np.float64))
    for fmt in (trg.pack_radix(tmat, device="cpu", **kw), _from_jax(jfmt)):
        yt = trg.radix_spmm(fmt, x)
        assert isinstance(yt, torch.Tensor) and yt.shape == (300, k)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=TOL[mode] * np.abs(ref).max())
        check_result(yt.numpy(), ref, rtol=8e-2 if mode == "bf16" else 1e-5)


def test_ktin_and_unroll_change_no_y():
    jmat, tmat, x = _case(k=32, seed=9)
    fmt = trg.pack_radix(tmat, rb=128, S=16, g=128, kt=8, device="cpu")
    y1 = trg.radix_spmm(fmt, x)
    for ktin, unroll in ((2, 4), (4, 2), (3, 1)):
        torch.testing.assert_close(trg.radix_spmm(fmt, x, ktin=ktin, unroll=unroll), y1,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kt,mode,kt_count,unroll", [(8, "fp32x2", 4, 4), (8, "fp32x2", 4, 8),
                                                     (4, "fp32x2", 4, 4), (16, "bf16", 2, 2),
                                                     (32, "fp32x2", 1, 4), (8, "fp32x2", 6, 2)])
def test_max_ktin_equals_jax(kt, mode, kt_count, unroll):
    jmat, tmat, _ = _case(seed=4)
    kw = dict(rb=128, S=16, g=128, kt=kt, mode=mode)
    assert trg.max_ktin(trg.pack_radix(tmat, device="cpu", **kw), kt_count, unroll) == \
        jrg.max_ktin(jrg.pack_radix(jmat, **kw), kt_count, unroll)


def _brick_pipeline(ops, ms, rb_rows=8):
    ex = ops.OperatorExecutor(ms)
    steps = [ops.SortOperator(0), ops.FixedIntervalRowBlockingOperator(0, Level.TBLOCK, rb_rows),
             ops.EllBlockPadOperator(0, Level.TBLOCK),
             ops.InterleaveStorageOperator(0, Level.TBLOCK)]
    for op in steps:
        ex.add_and_run(op)
        yield op.name, ms


@pytest.mark.parametrize("kt,S,g", [(8, 64, 64), (4, 32, 128), (1, 16, 256)])
def test_pack_brick_ell_equals_jax(kt, S, g):
    jmat, tmat, x = _case(m=200, n=300, avg=5.0, seed=6)
    jm, tm = jms(jmat), tms(tmat)
    for (name, jset), (_, tset) in zip(_brick_pipeline(jops, jm), _brick_pipeline(tops, tm)):
        for key in jset.keys():           # the metadata after each operator
            np.testing.assert_array_equal(tset.get(*key), jset.get(*key), err_msg=f"{name} {key}")
        assert len(tset) == len(jset), name
    kw = dict(out_rows=200, rb=64, S=S, g=g, kt=kt, mode="fp32x2")
    jfmt, tfmt = jrg.pack_brick_ell(jm, 0, **kw), trg.pack_brick_ell(tm, 0, device="cpu", **kw)
    _assert_same_format(jfmt, tfmt)
    check_result(trg.radix_spmm(tfmt, x).numpy(), spmm_reference(jmat, x.astype(np.float64)),
                 rtol=1e-5)


def test_with_values_matches_jax():
    jmat, tmat, x = _case(seed=8)
    kw = dict(rb=128, S=16, g=128, kt=8, keep_perm=True)
    jfmt, tfmt = jrg.pack_radix(jmat, **kw), trg.pack_radix(tmat, device="cpu", **kw)
    new = np.random.default_rng(4).standard_normal(jmat.nnz).astype(np.float32)
    jnew, tnew = jrg.with_values(jfmt, new), trg.with_values(tfmt, new)
    _assert_same_format(jnew, tnew)
    check_result(trg.radix_spmm(tnew, x).numpy(),
                 spmm_reference(CooMatrix(tmat.rows, tmat.cols, new, tmat.shape),
                                x.astype(np.float64)), rtol=1e-5)
    with pytest.raises(AssertionError, match="keep_perm"):
        trg.with_values(trg.pack_radix(tmat, rb=128, S=16, device="cpu"), new)


@pytest.mark.parametrize("field,value", [("cols", 16 * 16), ("lrow", 128), ("c0", 400),
                                         ("nc_p", 99)])
def test_format_from_numpy_checks_indices(field, value):
    jmat, _, _ = _case(seed=11)
    jfmt = jrg.pack_radix(jmat, rb=128, S=16, g=128, kt=8)
    fields = {f: np.asarray(getattr(jfmt, f)).copy() for f in trg.RADIX_FIELDS}
    fields["nc_p"] = np.asarray(jfmt.nc_p).copy()
    static = {f: getattr(jfmt, f) for f in STATIC}
    fmt = trg.radix_format_from_numpy(dict(fields, nc_p=None), device="cpu", **static)
    np.testing.assert_array_equal(fmt.nc_p.numpy(), fields["nc_p"])
    fields[field].reshape(-1)[0] = value
    with pytest.raises(ValueError, match="out of range"):
        trg.radix_format_from_numpy(fields, device="cpu", **static)
    with pytest.raises(ValueError, match="shape"):
        trg.radix_format_from_numpy(dict(fields, lrow=fields["lrow"][:1]), device="cpu",
                                    **static)


def test_plain_version_rounds_products_and_wrapper_refuses_cpu():
    _, tmat, x = _case(k=4, seed=12)
    fmt = trg.pack_radix(tmat, rb=128, S=16, g=128, kt=4, device="cpu")
    xt = torch.from_numpy(x)
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, xt)
    y32 = trg.radix_rows_plain(*args, rb=128, kt=4, mode="fp32x2")
    y16 = trg.radix_rows_plain(*args, rb=128, kt=4, mode="bf16")
    assert not torch.equal(y32, y16)
    torch.testing.assert_close(y16, y32, rtol=0, atol=1e-2 * float(y32.abs().max()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trg.radix_rows_cuda(*args, rb=128, kt=4, mode="fp32x2")
    with pytest.raises(ValueError, match="X is on"):
        trg.radix_spmm(fmt, torch.zeros((400, 4), device="meta"))


# ------------------------------------------------------------------- row walk
# On the card #9 walks the format's row walk (kernels/row_walk.py), the
# decode dg and span share: each live slot once, sorted by (y_rows row,
# slot), all of X's columns in one launch (x of one column: the one-column
# walk).  Its function in plain PyTorch (``walk_rows_plain``) must equal
# ``radix_rows_plain`` and, unpacked, the JAX kernel in interpret mode and
# the oracle.

from test_torch_dg_gather import _assert_walk_covers  # noqa: E402
from tpusparse_torch.kernels import row_walk as rw  # noqa: E402


def _walk_vs_plain_jax(tfmt, jfmt, jmat, x, kt, mode):
    """The walk's plain version against radix_rows_plain (1e-5 of |A|.|X|)
    and, unpacked, against the JAX radix_spmm and the oracle."""
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, -(-x.shape[1] // kt) * kt - x.shape[1]))
    bf16 = mode == "bf16"
    walk = trg.radix_row_walk(tfmt)
    got = rw.walk_rows_plain(walk, tfmt.vals, xp, bf16=bf16)
    args = (tfmt.c0, tfmt.cols, tfmt.lrow)
    want = trg.radix_rows_plain(*args, tfmt.vals, tfmt.nc_p, xp, rb=tfmt.rb, kt=kt, mode=mode)
    scale = trg.radix_rows_plain(*args, tfmt.vals.abs(), tfmt.nc_p, xp.abs(), rb=tfmt.rb, kt=kt,
                                 mode="fp32x2")
    assert float(((got - want).abs() / scale.clamp(min=1.0)).max()) <= 1e-5
    y = trg.unpack_by_deal(tfmt, got)[:, :x.shape[1]].numpy()
    ref = spmm_reference(jmat, x.astype(np.float64))
    if jfmt is not None:
        yj = np.asarray(jrg.radix_spmm(jfmt, x))
        np.testing.assert_allclose(y, yj, rtol=0, atol=TOL[mode] * max(np.abs(ref).max(), 1.0))
    check_result(y, ref, rtol=8e-2 if bf16 else 1e-5)
    return walk


@pytest.mark.parametrize("kt,mode,deal,k", [(1, "fp32x2", None, 1), (1, "bf16", "index", 1),
                                            (2, "fp32x2", "blocks", 2), (4, "fp32x2", None, 3),
                                            (4, "bf16", "length", 4), (8, "fp32x2", "index", 8),
                                            (16, "bf16", None, 40), (32, "fp32x2", None, 32)])
def test_radix_row_walk_equals_plain_and_jax(kt, mode, deal, k):
    jmat, tmat, x = _case(m=300, n=3000, k=k, avg=9.0, seed=7)
    kw = dict(rb=128, S=32, g=64, kt=kt, mode=mode, deal=deal)
    jfmt = jrg.pack_radix(jmat, **kw)
    for fmt in (_from_jax(jfmt), trg.pack_radix(tmat, keep_perm=True, device="cpu", **kw)):
        assert fmt.walk is None                   # a CPU format builds it only when asked
        walk = _walk_vs_plain_jax(fmt, jfmt, jmat, x, kt, mode)
        assert trg.radix_row_walk(fmt) is walk and fmt.walk is walk
        walked = torch.arange(fmt.n_chunks).view(1, -1, 1) < fmt.nc_p.reshape(-1, 1, 1)
        _assert_walk_covers(walk, (fmt.vals != 0) & walked)
        assert walk.n_slots == jmat.nnz and walk.n_rows == fmt.n_programs * fmt.rb
        assert walk.runs == len(np.unique(jmat.rows))
        assert walk.live_from_values == (fmt.perm_of_nz is None)


@pytest.mark.parametrize("case", ["brick_ell", "stored_zero", "empty"])
def test_radix_row_walk_edges(case):
    # brick-ELL keeps no perm_of_nz (its live slots are the plane's
    # nonzeros); a stored zero of perm_of_nz is a live slot; an empty
    # matrix walks nothing
    jmat, tmat, x = _case(m=200, n=300, avg=5.0, seed=6)
    if case == "brick_ell":
        jm, tm = jms(jmat), tms(tmat)
        for _ in zip(_brick_pipeline(jops, jm), _brick_pipeline(tops, tm)):
            pass
        kw = dict(out_rows=200, rb=64, S=64, g=64, kt=8, mode="fp32x2")
        jfmt, fmt = jrg.pack_brick_ell(jm, 0, **kw), trg.pack_brick_ell(tm, 0, device="cpu", **kw)
        walk = _walk_vs_plain_jax(fmt, jfmt, jmat, x, 8, "fp32x2")
        assert walk.live_from_values and walk.n_slots == jmat.nnz
        return
    if case == "empty":
        tmat = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
                         (200, 300))
        fmt = trg.pack_radix(tmat, rb=64, S=64, g=64, kt=8, device="cpu")
        walk = trg.radix_row_walk(fmt)
        assert walk.n_slots == 0 and walk.runs == 0
        y = trg.unpack_by_deal(fmt, rw.walk_rows_plain(walk, fmt.vals, torch.from_numpy(x)))
        assert y.shape == (200, 8) and not bool(y.any())
        return
    vals = tmat.vals.copy()
    vals[::4] = 0.0
    zmat = CooMatrix(tmat.rows, tmat.cols, vals, tmat.shape)
    fmt = trg.pack_radix(zmat, rb=64, S=64, g=64, kt=4, keep_perm=True, device="cpu")
    walk = trg.radix_row_walk(fmt)
    live = torch.zeros(fmt.vals.numel(), dtype=torch.bool)
    live[torch.as_tensor(fmt.perm_of_nz, dtype=torch.long)] = True
    _assert_walk_covers(walk, live)
    assert walk.n_slots == zmat.nnz > int(np.count_nonzero(vals)) and not walk.live_from_values
    _walk_vs_plain_jax(fmt, None, zmat, x, 4, "fp32x2")


@pytest.mark.parametrize("case", ["with_values", "values_in_place", "pattern_in_place"])
def test_radix_row_walk_follows_its_planes(case):
    # with_values carries the pattern's walk with the new values; a plane
    # written in place (values or pattern) gives the format a new walk
    _, tmat, x = _case(seed=8)
    fmt = trg.pack_radix(tmat, rb=128, S=16, g=128, kt=8, keep_perm=True, device="cpu")
    pattern = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    walk = trg.radix_row_walk(fmt)
    assert walk.fresh(pattern, fmt.vals)
    xt = torch.from_numpy(x)
    if case == "with_values":
        new_vals = np.random.default_rng(4).standard_normal(tmat.nnz).astype(np.float32)
        new = trg.with_values(fmt, new_vals)
        assert new.walk.slot is walk.slot and new.walk.val_src is new.vals
        assert trg.radix_row_walk(new) is new.walk
        y = trg.unpack_by_deal(new, rw.walk_rows_plain(new.walk, new.vals, xt)).numpy()
        check_result(y, spmm_reference(CooMatrix(tmat.rows, tmat.cols, new_vals, tmat.shape),
                                       x.astype(np.float64)), rtol=1e-5)
    elif case == "values_in_place":
        fmt.vals.neg_()
        new = trg.radix_row_walk(fmt)
        assert new is not walk and new.holds(fmt.vals)
        torch.testing.assert_close(new.val, -walk.val)
    else:
        fmt.cols.add_(0)
        assert not walk.built_from(pattern) and trg.radix_row_walk(fmt) is not walk
