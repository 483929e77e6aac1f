"""tpusparse_torch.kernels.dgt_gather against the JAX package's dgt_gather.

The packer must emit the JAX packer's arrays, and the port's dgt_spmm on
the CPU (the kernels' plain versions) must match the JAX dgt_spmm (Pallas
interpret mode, as tests/test_dgt_kernel.py runs it) and the oracle.
Tolerances are tests/test_dgt_kernel.py's: atol 1e-4 * max|ref| where the
JAX side runs fp32x2 (its hi/lo bf16 split of each product, :30) and
4e-3 * max|ref| for bf16 (:83); the port itself is fp32 and is held to
1e-5 against the oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusparse.io import builder as jbuilder
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.kernels import dgt_gather as jdgt
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch.io import builder as tbuilder
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import dgt_gather as tdgt
from tpusparse_torch.kernels import row_walk as rw

STATIC = ("n_programs", "n_chunks", "chunk_g", "rb", "kt", "mode", "resid", "nw",
          "shape", "nnz_real", "split_levels", "deal")


def _port_mat(jmat):
    return CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)


def _mega_row(m=600, n=1200, seed=23):
    """One row of 600 nonzeros among sparse rows (the JAX split-row test)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.zeros(600, np.int64), rng.integers(1, m, 3000)])
    cols = np.concatenate([rng.permutation(n)[:600], rng.integers(0, n, 3000)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    order = np.lexsort((cols, rows))
    return JCoo(rows[order], cols[order], vals[order], (m, n))


def _x(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _from_jax(jfmt):
    fields = {k: np.asarray(getattr(jfmt, k)) for k in tdgt.FIELDS}
    fields["perm_of_nz"] = jfmt.perm_of_nz
    return tdgt.dgt_format_from_numpy(fields, device="cpu",
                                      **{k: getattr(jfmt, k) for k in STATIC})


def _assert_same_format(jfmt, tfmt):
    for k in tdgt.FIELDS:
        np.testing.assert_array_equal(getattr(tfmt, k).numpy(), np.asarray(getattr(jfmt, k)),
                                      err_msg=k)
    for k in STATIC:
        assert getattr(tfmt, k) == getattr(jfmt, k), k
    if jfmt.perm_of_nz is None:
        assert tfmt.perm_of_nz is None
    else:
        np.testing.assert_array_equal(tfmt.perm_of_nz, jfmt.perm_of_nz)


BASE = dict(resid=True, walk="multi", deal="length", kt=8, mode="fp32x2", nw=4, split="auto")


@pytest.mark.parametrize("change", [
    {}, dict(resid=False), dict(walk="single"), dict(deal="index"), dict(deal="blocks"),
    dict(kt=16), dict(kt=32), dict(mode="bf16"), dict(nw=1), dict(nw=8),
    dict(split=None), dict(split=64),
    dict(resid=False, walk="single"), dict(resid=False, deal="index"),
    dict(mode="bf16", walk="single"), dict(kt=32, nw=8), dict(walk="single", nw=1),
    dict(walk="single", deal="blocks"), dict(resid=False, kt=16), dict(mega=True),
    dict(mega=True, walk="single", split=64),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "base")
def test_pack_dgt_equals_jax(change):
    kw = dict(BASE, **change)
    mat = _mega_row() if kw.pop("mega", False) else \
        jbuilder.power_law_coo(500, 3000, avg_nnz_per_row=9.0, seed=7)
    kw.update(rb=128, g=256, keep_perm=True)
    jfmt = jdgt.pack_dgt(mat, **kw)
    _assert_same_format(jfmt, tdgt.pack_dgt(_port_mat(mat), device="cpu", **kw))
    if change.get("mega") and kw["split"]:
        assert jfmt.split_levels > 1


def test_pack_dgt_equals_jax_through_metadata_set():
    from tpusparse.meta.set import create_init_metadata_set as jms
    from tpusparse_torch.meta.set import create_init_metadata_set as tms

    mat = jbuilder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=5)
    kw = dict(rb=64, g=128, kt=8, nw=4)
    _assert_same_format(jdgt.pack_dgt(jms(mat), 0, out_rows=300, **kw),
                        tdgt.pack_dgt(tms(_port_mat(mat)), 0, out_rows=300, device="cpu", **kw))


@pytest.mark.parametrize("case", ["resid", "no_resid", "bf16", "split_rows", "k40_kt32"])
def test_dgt_spmm_matches_jax_and_oracle(case):
    mat = _mega_row() if case == "split_rows" else \
        jbuilder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=2)
    k = 40 if case == "k40_kt32" else 8
    kw = dict(rb=128, g=128 if case == "k40_kt32" else 256, kt=32 if case == "k40_kt32" else 8,
              mode="bf16" if case == "bf16" else "fp32x2", resid=case != "no_resid",
              split=64 if case == "split_rows" else "auto")
    jfmt = jdgt.pack_dgt(mat, **kw)
    if case == "split_rows":
        assert jfmt.split_levels > 1
    x = _x(mat.shape[1], k, seed=3)
    yj = np.asarray(jdgt.dgt_spmm(jfmt, x))
    yt = tdgt.dgt_spmm(tdgt.pack_dgt(_port_mat(mat), device="cpu", **kw), x)
    assert yt.device.type == "cpu" and yt.dtype == torch.float32 and yt.shape == (mat.shape[0], k)
    ref = spmm_reference(mat, x.astype(np.float64))
    atol = (4e-3 if case == "bf16" else 1e-4) * np.abs(ref).max()
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=atol)
    np.testing.assert_allclose(yt.numpy(), ref, rtol=0, atol=atol)
    if case != "bf16":
        check_result(yt.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(resid=True, nw=8), dict(resid=False, walk="single"),
                                dict(mode="bf16", deal="index")])
def test_jax_format_through_the_port(kw):
    mat = jbuilder.power_law_coo(500, 3000, avg_nnz_per_row=9.0, seed=11)
    kw = dict(rb=128, g=256, kt=8, keep_perm=True, **kw)
    x = _x(3000, 8, seed=4)
    tfmt = tdgt.pack_dgt(_port_mat(mat), device="cpu", **kw)
    y_jax_fmt = tdgt.dgt_spmm(_from_jax(jdgt.pack_dgt(mat, **kw)), x)
    torch.testing.assert_close(y_jax_fmt, tdgt.dgt_spmm(tfmt, x), rtol=0, atol=0)


def test_knobs_give_the_same_y_and_jax_refusals_hold():
    mat = tbuilder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=6)
    fmt = tdgt.pack_dgt(mat, rb=128, g=256, kt=8, device="cpu")
    x = _x(400, 8, seed=7)
    y0 = tdgt.dgt_spmm(fmt, x)
    for kw in (dict(scatter="fullrow"), dict(fold=False), dict(pipe=True), dict(unroll=1),
               dict(rowhot_i8=True), dict(rowhot=tdgt.pack_rowhot(fmt)), dict(stream_x=True),
               dict(stream_x=True, unroll=16, rowhot_i8=True)):
        torch.testing.assert_close(tdgt.dgt_spmm(fmt, x, **kw), y0, rtol=0, atol=0, msg=str(kw))
    check_result(y0.numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=1e-5)
    rowhot = tdgt.pack_rowhot(fmt)
    assert rowhot.dtype == torch.bfloat16 and rowhot.shape == (fmt.n_programs, fmt.n_chunks,
                                                               fmt.rb // 8, fmt.chunk_g)
    no_resid = tdgt.pack_dgt(mat, rb=128, g=256, kt=8, resid=False, device="cpu")
    for f, kw in ((no_resid, dict(stream_x=True)), (fmt, dict(stream_x=True, scatter="fullrow")),
                  (fmt, dict(stream_x=True, rowhot=rowhot)),
                  (fmt, dict(rowhot=rowhot, scatter="fullrow")), (fmt, dict(scatter="wide"))):
        with pytest.raises(AssertionError):
            tdgt.dgt_spmm(f, x, **kw)
    with pytest.raises(AssertionError):
        tdgt.pack_rowhot(no_resid)


def test_with_values_and_spmv():
    jmat = jbuilder.uniform_coo(400, 700, 7, seed=17)
    mat = _port_mat(jmat)
    kw = dict(rb=128, g=128, kt=8, keep_perm=True)
    new_vals = np.random.default_rng(5).standard_normal(mat.nnz).astype(np.float32)
    tfmt = tdgt.with_values(tdgt.pack_dgt(mat, device="cpu", **kw), new_vals)
    _assert_same_format(jdgt.with_values(jdgt.pack_dgt(jmat, **kw), new_vals), tfmt)
    x = _x(700, 8, seed=6)
    mat2 = CooMatrix(mat.rows, mat.cols, new_vals, mat.shape)
    check_result(tdgt.dgt_spmm(tfmt, x).numpy(), spmm_reference(mat2, x.astype(np.float64)),
                 rtol=1e-5)
    xv = x[:, 0].copy()
    y = tdgt.dgt_spmv(tfmt, xv)
    assert y.shape == (400,)
    check_result(y.numpy(), spmm_reference(mat2, xv.astype(np.float64)), rtol=1e-5)


def test_banded_builder_and_auto_rb_equal_jax():
    a = jbuilder.banded_coo(700, 900, bandwidth=9, seed=3)
    b = tbuilder.banded_coo(700, 900, bandwidth=9, seed=3)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for args in ((262144, 262144, 10228408), (32768, 32768, 1000982), (900, 1500, 7000)):
        for ngrp in (4, 8, 16):
            assert tdgt.auto_rb_dgt(*args, ngrp=ngrp) == jdgt.auto_rb_dgt(*args, ngrp=ngrp)
    mat = tdgt.pack_dgt(b, rb=128, g=256, kt=8, device="cpu")
    x = _x(900, 8, seed=8)
    check_result(tdgt.dgt_spmm(mat, x).numpy(), spmm_reference(b, x.astype(np.float64)),
                 rtol=1e-5)


def test_plain_version_decodes_residue_and_rounds_bf16():
    # one tile, window base 2: slot 13 (class 13 % 8 = 5) of lrw 3 is row
    # 3*8 + 5 = 29, at column (2 + 1) * 128 + 7 = 391 (sel = 1)
    wins = torch.full((1, 1, 1), 2, dtype=torch.int32)
    cols = torch.zeros((1, 1, 128), dtype=torch.int32)
    lrw = torch.zeros((1, 1, 128), dtype=torch.int32)
    vals = torch.zeros((1, 1, 128))
    cols[0, 0, 13], lrw[0, 0, 13], vals[0, 0, 13] = 7 | (1 << 7), 3, 1.0 + 2 ** -10
    x = torch.zeros((400, 8))
    x[391] = 1.0 + 2 ** -9
    nc_p = torch.ones((1, 1, 1), dtype=torch.int32)
    args = (wins, cols, lrw, vals, nc_p, x)
    y = tdgt.dgt_rows_plain(*args, rb=64, kt=8, mode="fp32x2", resid=True)
    exact = (1.0 + 2 ** -10) * (1.0 + 2 ** -9)
    assert y[29, 0].item() == pytest.approx(exact, rel=1e-7)
    assert y.shape == (64, 8) and torch.count_nonzero(y) == 8
    y_raw = tdgt.dgt_rows_plain(*args, rb=64, kt=8, mode="fp32x2", resid=False)
    assert torch.count_nonzero(y_raw[3]) == 8            # without resid, lrw is the row
    y16 = tdgt.dgt_stream_rows_plain(*args, rb=64, kt=8, mode="bf16", nw=4)
    # bf16 mode: ngrp = 16, so slot 13 is class 13 and row 3*16 + 13 = 61
    assert y16[61, 0].item() == torch.tensor(exact).to(torch.bfloat16).float().item()


def test_cuda_wrappers_refuse_cpu_tensors():
    fmt = tdgt.pack_dgt(tbuilder.power_law_coo(300, 400, 6.0, seed=1), rb=128, g=256, kt=8,
                        device="cpu")
    args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p, torch.zeros(400, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tdgt.dgt_rows_cuda(*args, rb=128, kt=8, mode="fp32x2", resid=True)
    with pytest.raises(ValueError, match="CUDA"):
        tdgt.dgt_stream_rows_cuda(*args, rb=128, kt=8, mode="fp32x2", nw=4)
    assert tdgt.dgt_rows_cuda.launches == 0 and tdgt.dgt_stream_rows_cuda.launches == 0


@pytest.mark.parametrize("field,pos,value", [
    ("cols", (0, 0, 0), 127 | (4 << 7)),   # sel 4 >= nw
    ("wins", (0, 0, 0), 10 ** 6),          # column past N
    ("lrw", (0, 0, 0), 16),                # resid row 16*8 >= rb
    ("slot_of_origrow", (0,), 10 ** 6),    # past the pyramid
    ("nc_p", (0, 0, 0), 99),               # more chunks than NC
])
def test_format_from_numpy_checks_indices(field, pos, value):
    mat = jbuilder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=3)
    jfmt = jdgt.pack_dgt(mat, rb=128, g=256, kt=8, nw=4)
    fields = {k: np.asarray(getattr(jfmt, k)).copy() for k in tdgt.FIELDS}
    static = {k: getattr(jfmt, k) for k in STATIC}
    assert fields["vals"][0, 0, 0] != 0
    fields[field][pos] = value
    with pytest.raises(ValueError, match="out of range"):
        tdgt.dgt_format_from_numpy(fields, device="cpu", **static)
    with pytest.raises(ValueError, match="shape"):
        tdgt.dgt_format_from_numpy(fields, device="cpu", **dict(static, n_chunks=1))


def test_x_on_another_device_is_refused():
    fmt = tdgt.pack_dgt(tbuilder.power_law_coo(300, 400, 6.0, seed=1), rb=128, g=256, kt=8,
                        device="cpu")
    fmt_meta = dataclasses.replace(fmt, wins=fmt.wins.to("meta"))
    with pytest.raises(ValueError, match="X is on"):
        tdgt.dgt_spmm(fmt_meta, torch.zeros(400, 8))


# ------------------------------------------------------------------- row walk
# The CUDA kernel #3 walks the format's row walk (kernels/row_walk.py): each
# live slot once, sorted by (y_rows row, slot).  Its function in plain
# PyTorch (``walk_rows_plain``, the same sum in the walk's order) must equal
# ``dgt_rows_plain`` and, unpacked, the JAX kernel in interpret mode.

def _assert_walk_covers(walk, live):
    """Each live slot exactly once, rows non-decreasing, slots rising in a
    row; the values those of the plane the walk was built from."""
    slot, row = walk.slot.long(), walk.row.long()
    torch.testing.assert_close(walk.val, walk.val_src.reshape(-1)[slot].float(), rtol=0, atol=0)
    np.testing.assert_array_equal(np.sort(slot.numpy()),
                                  np.flatnonzero(live.reshape(-1).numpy()))
    assert bool((row[1:] >= row[:-1]).all())
    same = row[1:] == row[:-1]
    assert bool((slot[1:][same] > slot[:-1][same]).all())
    assert walk.runs == int(torch.unique(row).numel())


@pytest.mark.parametrize("case", ["fp32x2", "bf16", "no_resid", "split_rows", "kt32"])
def test_row_walk_equals_plain_and_jax(case):
    mat = _mega_row() if case == "split_rows" else \
        jbuilder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=2)
    kt = 32 if case == "kt32" else 8
    kw = dict(rb=128, g=256, kt=kt, mode="bf16" if case == "bf16" else "fp32x2",
              resid=case != "no_resid", split=64 if case == "split_rows" else "auto")
    jfmt = jdgt.pack_dgt(mat, **kw)
    fmt = _from_jax(jfmt)
    assert fmt.walk is None                       # a CPU format builds it only when asked
    walk = tdgt.dgt_row_walk(fmt)
    assert tdgt.dgt_row_walk(fmt) is walk and fmt.walk is walk
    _assert_walk_covers(walk, fmt.vals != 0)
    assert walk.n_slots == mat.nnz and walk.nbytes == 16 * mat.nnz
    assert walk.n_rows == fmt.n_programs * fmt.rb and walk.runs <= walk.n_slots
    if case == "split_rows":
        assert fmt.split_levels > 1
    x = torch.from_numpy(_x(mat.shape[1], kt, seed=3))
    args = (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p, x)
    pkw = dict(rb=fmt.rb, kt=kt, mode=fmt.mode, resid=fmt.resid)
    bf16 = fmt.mode == "bf16"
    got = rw.walk_rows_plain(walk, fmt.vals, x, bf16=bf16)
    want = tdgt.dgt_rows_plain(*args, **pkw)
    scale = tdgt.dgt_rows_plain(fmt.wins, fmt.cols, fmt.lrw, fmt.vals.abs(), fmt.nc_p, x.abs(),
                                **dict(pkw, mode="fp32x2"))
    assert float(((got - want).abs() / scale.clamp(min=1.0)).max()) <= 1e-5
    # unpacked, against the JAX kernel (interpret mode) and the oracle, at
    # 1e-5 of |A|.|X|; the JAX side's fp32x2 splits X into hi/lo bf16
    # planes, which keeps 16 bits of each product: 2^-16 of |A|.|X| there
    y = tdgt._unpack_rows(fmt, got).numpy()
    ref = spmm_reference(mat, x.numpy().astype(np.float64))
    scale_ref = spmm_reference(JCoo(mat.rows, mat.cols, np.abs(mat.vals), mat.shape),
                               np.abs(x.numpy()).astype(np.float64))
    yj = np.asarray(jdgt.dgt_spmm(jfmt, x.numpy()))
    tol_j = 1e-5 if bf16 else 2.0 ** -16
    assert float((np.abs(y - yj) / np.maximum(scale_ref, 1.0)).max()) <= tol_j
    if not bf16:
        assert float((np.abs(y - ref) / np.maximum(scale_ref, 1.0)).max()) <= 1e-5


@pytest.mark.parametrize("case", ["values_in_place", "pattern_in_place", "off_pattern"])
def test_row_walk_follows_its_planes(case):
    # as for span: a plane written in place gives the format a new walk,
    # and a plane with a nonzero off a walk without perm_of_nz is refused
    mat = _port_mat(jbuilder.uniform_coo(400, 700, 7, seed=17))
    fmt = tdgt.pack_dgt(mat, rb=128, g=128, kt=8, device="cpu")
    pattern = (fmt.wins, fmt.cols, fmt.lrw, fmt.nc_p)
    walk = tdgt.dgt_row_walk(fmt)
    assert walk.fresh(pattern, fmt.vals) and walk.live_from_values
    if case == "values_in_place":
        fmt.vals.neg_()
        assert rw.gathers(walk, fmt.vals, "dgt")
        new = tdgt.dgt_row_walk(fmt)
        assert new is not walk and new.holds(fmt.vals)
        torch.testing.assert_close(new.val, -walk.val)
    elif case == "pattern_in_place":
        fmt.wins.add_(0)
        assert not walk.built_from(pattern) and tdgt.dgt_row_walk(fmt) is not walk
    else:
        plane = fmt.vals.clone()
        plane.view(-1)[int(torch.nonzero(plane.reshape(-1) == 0)[0])] = 1.0
        with pytest.raises(ValueError, match="off the format's pattern"):
            rw.gathers(walk, plane, "dgt")


@pytest.mark.parametrize("case", ["with_values", "stored_zero", "empty"])
def test_row_walk_is_the_pattern(case):
    if case == "empty":
        mat = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
                        (300, 400))
    else:
        mat = _port_mat(jbuilder.uniform_coo(400, 700, 7, seed=17))
    if case == "stored_zero":  # a stored zero of the COO is a live slot of the pattern
        vals = mat.vals.copy()
        vals[::5] = 0.0
        mat = CooMatrix(mat.rows, mat.cols, vals, mat.shape)
    fmt = tdgt.pack_dgt(mat, rb=128, g=128, kt=8, keep_perm=True, device="cpu")
    walk = tdgt.dgt_row_walk(fmt)
    live = torch.zeros(fmt.vals.numel(), dtype=torch.bool)
    live[torch.as_tensor(fmt.perm_of_nz, dtype=torch.long)] = True
    _assert_walk_covers(walk, live)
    assert walk.n_slots == mat.nnz
    new_vals = np.random.default_rng(5).standard_normal(mat.nnz).astype(np.float32)
    new = tdgt.with_values(fmt, new_vals)
    # the pattern's walk goes with it, holding the new plane's values
    assert new.walk.slot is walk.slot and new.walk.val_src is new.vals
    assert tdgt.dgt_row_walk(new) is new.walk
    torch.testing.assert_close(new.walk.val, new.vals.reshape(-1)[walk.slot.long()].float())
    x = torch.from_numpy(_x(mat.shape[1], 8, seed=6))
    y = tdgt._unpack_rows(new, rw.walk_rows_plain(walk, new.vals, x)).numpy()
    ref = spmm_reference(CooMatrix(mat.rows, mat.cols, new_vals, mat.shape),
                         x.numpy().astype(np.float64))
    check_result(y, ref, rtol=1e-5)
    if case == "empty":
        assert walk.n_slots == 0 and walk.runs == 0 and not y.any()
    if case == "stored_zero":
        assert walk.n_slots > int(np.count_nonzero(mat.vals))


@pytest.mark.parametrize("nw,mode", [(4, "fp32x2"), (8, "fp32x2"), (2, "bf16")])
def test_stream_x_over_the_walk_matches_jax_stream(nw, mode):
    # #4 on the card launches the row walk kernel over the format's walk,
    # whatever nw: the walk's function, unpacked, and the port's stream_x
    # path must equal the JAX stream kernel (interpret mode) and the oracle
    # at this file's tolerances (atol 1e-4 * max|ref| fp32x2, 4e-3 bf16)
    mat = jbuilder.power_law_coo(300, 400, avg_nnz_per_row=6.0, seed=12)
    kw = dict(rb=128, g=256, kt=8, mode=mode, resid=True, nw=nw)
    jfmt = jdgt.pack_dgt(mat, **kw)
    fmt = _from_jax(jfmt)
    x = _x(400, 8, seed=13)
    yj = np.asarray(jdgt.dgt_spmm(jfmt, x, stream_x=True))
    bf16 = mode == "bf16"
    y_walk = tdgt._unpack_rows(fmt, rw.walk_rows_plain(tdgt.dgt_row_walk(fmt), fmt.vals,
                                                       torch.from_numpy(x), bf16=bf16))
    y_stream = tdgt.dgt_spmm(fmt, x, stream_x=True)
    ref = spmm_reference(mat, x.astype(np.float64))
    atol = (4e-3 if bf16 else 1e-4) * np.abs(ref).max()
    for y in (y_walk.numpy(), y_stream.numpy()):
        np.testing.assert_allclose(y, yj, rtol=0, atol=atol)
        np.testing.assert_allclose(y, ref, rtol=0, atol=atol)
