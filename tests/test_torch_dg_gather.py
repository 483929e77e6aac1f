"""tpusparse_torch.kernels.dg_gather against the JAX package's dg_gather.

The packer must emit the JAX packer's arrays, and the port's dg_spmm /
dg_spmv on the CPU (the kernels' plain versions), fed the JAX format, must
match the JAX functions (Pallas interpret mode, as tests/test_dg_kernel.py
runs them) and the oracle.  Tolerances: 5e-4 where the JAX side runs
fp32x2 (its hi/lo bf16 split of each product, tests/test_dg_kernel.py:25);
the port itself is fp32 and is held to 1e-5 against the oracle; bf16 8e-2
against the oracle (tests/test_dg_kernel.py:32).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusparse.io import builder as jbuilder
from tpusparse.kernels import dg_gather as jdg
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import dg_gather as tdg
from tpusparse_torch.kernels import row_walk as rw

STATIC = ("n_programs", "n_chunks", "chunk_g", "rb", "ns", "kt", "mode",
          "shape", "nnz_real", "deal")


def _case(m=300, n=400, k=8, avg=6.0, seed=0):
    mat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return mat, x


def _port_mat(jmat):
    return CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)


def _from_jax(jfmt):
    fields = {k: np.asarray(getattr(jfmt, k)) for k in tdg.FIELDS}
    fields["perm_of_nz"] = jfmt.perm_of_nz
    return tdg.dg_format_from_numpy(
        fields, device="cpu", **{k: getattr(jfmt, k) for k in STATIC})


def _assert_same_format(jfmt, tfmt):
    for k in tdg.FIELDS:
        np.testing.assert_array_equal(getattr(tfmt, k).numpy(), np.asarray(getattr(jfmt, k)),
                                      err_msg=k)
    for k in STATIC:
        assert getattr(tfmt, k) == getattr(jfmt, k), k
    if jfmt.perm_of_nz is None:
        assert tfmt.perm_of_nz is None
    else:
        np.testing.assert_array_equal(tfmt.perm_of_nz, jfmt.perm_of_nz)


@pytest.mark.parametrize("deal", ["length", "index", "blocks"])
@pytest.mark.parametrize("kt,mode", [(1, "fp32x2"), (8, "fp32x2"), (16, "fp32x2"),
                                     (32, "fp32x2"), (8, "bf16")])
def test_pack_dg_equals_jax(deal, kt, mode):
    mat, _ = _case(m=500, n=3000, avg=9.0, seed=7)
    kw = dict(rb=128, ns=2 if kt == 1 else 4, g=128, kt=kt, mode=mode, deal=deal,
              keep_perm=True)
    _assert_same_format(jdg.pack_dg(mat, **kw),
                        tdg.pack_dg(_port_mat(mat), device="cpu", **kw))


def test_pack_dg_equals_jax_default_deal_and_metadata_set():
    from tpusparse.meta.set import create_init_metadata_set as jms
    from tpusparse_torch.meta.set import create_init_metadata_set as tms

    mat, _ = _case(seed=5)
    kw = dict(rb=64, ns=4, g=128, kt=8)
    _assert_same_format(jdg.pack_dg(mat, **kw), tdg.pack_dg(_port_mat(mat), device="cpu", **kw))
    _assert_same_format(jdg.pack_dg(jms(mat), 0, out_rows=300, **kw),
                        tdg.pack_dg(tms(_port_mat(mat)), 0, out_rows=300, device="cpu", **kw))


def _spmm_both(jfmt, x):
    yj = np.asarray(jdg.dg_spmm(jfmt, x))
    yt = tdg.dg_spmm(_from_jax(jfmt), x)
    assert yt.device.type == "cpu" and yt.dtype == torch.float32
    return yj, yt.numpy()


@pytest.mark.parametrize("kt,k,deal", [(8, 8, None), (16, 16, None), (32, 32, None),
                                       (8, 3, None), (16, 40, None),
                                       (8, 8, "index"), (8, 8, "blocks")])
def test_dg_spmm_matches_jax_fp32x2(kt, k, deal):
    mat, x = _case(k=k, seed=2)
    jfmt = jdg.pack_dg(mat, rb=128, ns=4, g=128, kt=kt, mode="fp32x2", deal=deal)
    yj, yt = _spmm_both(jfmt, x)
    assert yt.shape == (mat.shape[0], k)
    want = spmm_reference(mat, x.astype(np.float64))
    check_result(yt, yj, rtol=5e-4)
    check_result(yt, want, rtol=1e-5)


def test_dg_spmm_matches_jax_bf16():
    mat, x = _case(k=8, seed=4)
    jfmt = jdg.pack_dg(mat, rb=128, ns=4, g=128, kt=8, mode="bf16")
    yj, yt = _spmm_both(jfmt, x)
    want = spmm_reference(mat, x.astype(np.float64))
    check_result(yj, want, rtol=8e-2)
    check_result(yt, want, rtol=8e-2)


@pytest.mark.parametrize("m,n,avg,rb,ns,seed", [(500, 3000, 9.0, 128, 2, 7),
                                                (200, 9000, 20.0, 64, 4, 8)])
def test_dg_spmv_matches_jax(m, n, avg, rb, ns, seed):
    # the second case's columns span several 1024-wide windows
    mat, _ = _case(m=m, n=n, k=1, avg=avg, seed=seed)
    x = np.random.default_rng(seed + 4).standard_normal(n).astype(np.float32)
    jfmt = jdg.pack_dg(mat, rb=rb, ns=ns, g=128, kt=1)
    yj = np.asarray(jdg.dg_spmv(jfmt, x)).reshape(-1, 1)
    yt = tdg.dg_spmv(_from_jax(jfmt), x).numpy().reshape(-1, 1)
    want = spmm_reference(mat, x.astype(np.float64).reshape(-1, 1))
    check_result(yt, yj, rtol=5e-4)
    check_result(yt, want, rtol=1e-5)


def test_with_values_matches_jax():
    mat, x = _case(seed=9)
    kw = dict(rb=128, ns=4, g=128, kt=8, keep_perm=True)
    new_vals = np.asarray(mat.vals) * 3.0
    jfmt = jdg.with_values(jdg.pack_dg(mat, **kw), new_vals)
    tfmt = tdg.with_values(tdg.pack_dg(_port_mat(mat), device="cpu", **kw), new_vals)
    _assert_same_format(jfmt, tfmt)
    yj, yt = _spmm_both(jfmt, x)
    check_result(yt, yj, rtol=5e-4)
    check_result(tdg.dg_spmm(tfmt, x).numpy(),
                 3.0 * spmm_reference(mat, x.astype(np.float64)), rtol=1e-5)


def test_empty_and_single_nz():
    from tpusparse.io.mtx import CooMatrix as JCoo

    x = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    single = JCoo(np.array([2]), np.array([7]), np.array([2.5]), (10, 20))
    jfmt = jdg.pack_dg(single, rb=64, ns=2, g=128, kt=8)
    yj, yt = _spmm_both(jfmt, x)
    want = np.zeros((10, 8))
    want[2] = 2.5 * x[7]
    np.testing.assert_allclose(yt, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    empty = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), (10, 20))
    y0 = tdg.dg_spmm(tdg.pack_dg(empty, rb=64, ns=2, g=128, kt=8, device="cpu"), x)
    assert y0.shape == (10, 8) and not y0.any()


def test_plain_version_rounds_products_to_bf16():
    # one slot: y = bf16(v * x), the rounding the kernel applies
    c0 = torch.zeros((1, 1, 1), dtype=torch.int32)
    cols = torch.zeros((1, 1, 128), dtype=torch.int32)
    lrow = torch.zeros((1, 1, 128), dtype=torch.int32)
    vals = torch.zeros((1, 1, 128))
    vals[0, 0, 0] = 1.0 + 2 ** -10
    x = torch.full((4, 8), 1.0 + 2 ** -9)
    nc_p = torch.ones((1, 1, 1), dtype=torch.int32)
    y32 = tdg.dg_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=8, kt=8, mode="fp32x2")
    y16 = tdg.dg_rows_plain(c0, cols, lrow, vals, nc_p, x, rb=8, kt=8, mode="bf16")
    exact = (1.0 + 2 ** -10) * (1.0 + 2 ** -9)
    assert y32[0, 0].item() == pytest.approx(exact, rel=1e-7)
    assert y16[0, 0].item() == torch.tensor(exact).to(torch.bfloat16).float().item()
    assert y32.shape == (8, 8) and not y32[1:].any()


def test_cuda_wrappers_refuse_cpu_tensors():
    fmt = tdg.pack_dg(_port_mat(_case(seed=1)[0]), rb=128, ns=4, g=128, kt=8, device="cpu")
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
    with pytest.raises(ValueError, match="CUDA"):
        tdg.dg_rows_cuda(*args, torch.zeros(400, 8), rb=128, kt=8, mode="fp32x2")
    with pytest.raises(ValueError, match="CUDA"):
        tdg.dg1_rows_cuda(*args, torch.zeros(400), rb=128)
    assert tdg.dg_rows_cuda.launches == 0 and tdg.dg1_rows_cuda.launches == 0


def test_format_from_numpy_checks_indices():
    mat, _ = _case(seed=3)
    jfmt = jdg.pack_dg(mat, rb=128, ns=4, g=128, kt=8)
    fields = {k: np.asarray(getattr(jfmt, k)).copy() for k in tdg.FIELDS}
    static = {k: getattr(jfmt, k) for k in STATIC}
    fields["lrow"][0, 0, 0] = 128
    with pytest.raises(ValueError, match="out of range"):
        tdg.dg_format_from_numpy(fields, device="cpu", **static)
    with pytest.raises(ValueError, match="shape"):
        tdg.dg_format_from_numpy(fields, device="cpu", **dict(static, n_chunks=1))


def test_x_on_another_device_is_refused():
    fmt = tdg.pack_dg(_port_mat(_case(seed=1)[0]), rb=128, ns=4, g=128, kt=8, device="cpu")
    fmt_meta = dataclasses.replace(fmt, c0=fmt.c0.to("meta"))
    with pytest.raises(ValueError, match="X is on"):
        tdg.dg_spmm(fmt_meta, torch.zeros(400, 8))


# ------------------------------------------------------------------- row walk
# On the card #1 walks the format's row walk (kernels/row_walk.py): each
# live slot once, sorted by (y_rows row, slot), for all of X's columns in
# one launch.  Its function in plain PyTorch (``walk_rows_plain``, the same
# sum in the walk's order) must equal ``dg_rows_plain`` and, unpacked, the
# JAX kernel in interpret mode, which runs K = 64 as two K-tiles of 32.

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


@pytest.mark.parametrize("mode,deal,k", [("fp32x2", "length", 8), ("fp32x2", "index", 8),
                                         ("fp32x2", "blocks", 64), ("bf16", "length", 64),
                                         ("bf16", "index", 8), ("bf16", "blocks", 8)])
def test_row_walk_equals_plain_and_jax(mode, deal, k):
    mat, x = _case(m=500, n=3000, k=k, avg=9.0, seed=7)
    kt = 32 if k == 64 else 8
    jfmt = jdg.pack_dg(mat, rb=128, ns=4, g=128, kt=kt, mode=mode, deal=deal)
    fmt = _from_jax(jfmt)
    assert fmt.walk is None                       # a CPU format builds it only when asked
    walk = tdg.dg_row_walk(fmt)
    assert tdg.dg_row_walk(fmt) is walk and fmt.walk is walk
    walked = torch.arange(fmt.n_chunks).view(1, -1, 1) < fmt.nc_p.reshape(-1, 1, 1)
    _assert_walk_covers(walk, (fmt.vals != 0) & walked)
    assert walk.n_slots == mat.nnz and walk.n_rows == fmt.n_programs * fmt.rb
    assert walk.runs == len(np.unique(mat.rows)) and walk.live_from_values
    xt = torch.from_numpy(x)
    bf16 = mode == "bf16"
    got = rw.walk_rows_plain(walk, fmt.vals, xt, bf16=bf16)
    args = (fmt.c0, fmt.cols, fmt.lrow)
    want = tdg.dg_rows_plain(*args, fmt.vals, fmt.nc_p, xt, rb=fmt.rb, kt=kt, mode=mode)
    scale = tdg.dg_rows_plain(*args, fmt.vals.abs(), fmt.nc_p, xt.abs(), rb=fmt.rb, kt=kt,
                              mode="fp32x2")
    # the same products summed in another order: 1e-5 of |A|.|X|
    assert float(((got - want).abs() / scale.clamp(min=1.0)).max()) <= 1e-5
    # unpacked, against the JAX kernel and the oracle at 1e-5 of |A|.|X|;
    # the JAX side's fp32x2 splits each product into hi/lo bf16 planes,
    # which keeps 16 bits of it: 2^-16 of |A|.|X| there
    y = tdg.unpack_by_deal(fmt, got).numpy()
    ref = spmm_reference(mat, x.astype(np.float64))
    scale_ref = spmm_reference(type(mat)(mat.rows, mat.cols, np.abs(mat.vals), mat.shape),
                               np.abs(x).astype(np.float64))
    yj = np.asarray(jdg.dg_spmm(jfmt, x))
    tol_j = 1e-5 if bf16 else 2.0 ** -16
    assert float((np.abs(y - yj) / np.maximum(scale_ref, 1.0)).max()) <= tol_j
    if not bf16:
        assert float((np.abs(y - ref) / np.maximum(scale_ref, 1.0)).max()) <= 1e-5


@pytest.mark.parametrize("case", ["with_values", "values_in_place", "pattern_in_place",
                                  "off_pattern", "stored_zero"])
def test_row_walk_follows_its_planes(case):
    # a plane replaced or written in place gives the format a new walk,
    # with_values carries the pattern's walk with the new values, and a
    # stored zero of perm_of_nz is a live slot of the pattern
    mat, x = _case(seed=9)
    mat = _port_mat(mat)
    if case == "stored_zero":
        vals = mat.vals.copy()
        vals[::5] = 0.0
        mat = CooMatrix(mat.rows, mat.cols, vals, mat.shape)
    keep = case in ("with_values", "stored_zero")
    fmt = tdg.pack_dg(mat, rb=128, ns=4, g=128, kt=8, keep_perm=keep, device="cpu")
    pattern = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    walk = tdg.dg_row_walk(fmt)
    assert walk.fresh(pattern, fmt.vals) and walk.live_from_values != keep
    xt = torch.from_numpy(x)
    if keep:
        live = torch.zeros(fmt.vals.numel(), dtype=torch.bool)
        live[torch.as_tensor(fmt.perm_of_nz, dtype=torch.long)] = True
        _assert_walk_covers(walk, live)
        assert walk.n_slots == mat.nnz
        new_vals = np.random.default_rng(5).standard_normal(mat.nnz).astype(np.float32)
        new = tdg.with_values(fmt, new_vals)
        # the pattern's walk goes with it, holding the new plane's values
        assert new.walk.slot is walk.slot and new.walk.val_src is new.vals
        assert tdg.dg_row_walk(new) is new.walk
        y = tdg.unpack_by_deal(new, rw.walk_rows_plain(new.walk, new.vals, xt)).numpy()
        check_result(y, spmm_reference(CooMatrix(mat.rows, mat.cols, new_vals, mat.shape),
                                       x.astype(np.float64)), rtol=1e-5)
        if case == "stored_zero":
            assert walk.n_slots > int(np.count_nonzero(mat.vals))
    elif case == "values_in_place":
        fmt.vals.neg_()
        assert rw.gathers(walk, fmt.vals, "dg")
        new = tdg.dg_row_walk(fmt)
        assert new is not walk and new.holds(fmt.vals)
        torch.testing.assert_close(new.val, -walk.val)
    elif case == "pattern_in_place":
        fmt.lrow.add_(0)
        assert not walk.built_from(pattern) and tdg.dg_row_walk(fmt) is not walk
    else:
        plane = fmt.vals.clone()
        plane.view(-1)[int(torch.nonzero(plane.reshape(-1) == 0)[0])] = 1.0
        with pytest.raises(ValueError, match="off the format's pattern"):
            rw.gathers(walk, plane, "dg")


# ------------------------------------------------------ the one-column walk
# On the card #2 walks the same row walk as #1, with x as one column: its
# one-column kernel sums each row run of the walk by a warp scan.  Its
# function in plain PyTorch (``walk_rows_plain`` on x as one column) must
# equal ``dg1_rows_plain`` at 1e-5 of |A|.|x| and, unpacked, the JAX
# ``dg_spmv`` in interpret mode, as ``test_dg_spmv_matches_jax`` runs it.

def _spmv_case(case):
    """(JAX COO, x [N]) of a one-column walk case."""
    from tpusparse.io.mtx import CooMatrix as JCoo

    rng = np.random.default_rng(61)
    if case == "empty":
        return JCoo(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
                    (70, 90)), rng.standard_normal(90).astype(np.float32)
    if case == "one_nz":
        return JCoo(np.array([5]), np.array([17]), np.array([-1.5], np.float32),
                    (70, 90)), rng.standard_normal(90).astype(np.float32)
    m, n = {"long_row": (96, 5200), "n_odd": (300, 403)}.get(case, (500, 3000))
    mat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=9.0, seed=62)
    if case == "long_row":  # row 3 holds every column: one run of 5200 slots
        keep = mat.rows != 3
        mat = JCoo(np.concatenate([mat.rows[keep], np.full(n, 3)]),
                   np.concatenate([mat.cols[keep], np.arange(n)]),
                   np.concatenate([mat.vals[keep],
                                   rng.standard_normal(n).astype(np.float32)]), (m, n))
    return mat, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("case", ["power_law", "empty", "one_nz", "long_row", "n_odd",
                                  "with_values"])
def test_one_column_walk_equals_plain_and_jax(case):
    from tpusparse.io.mtx import CooMatrix as JCoo

    mat, x = _spmv_case(case)
    jfmt = jdg.pack_dg(mat, rb=64, ns=2, g=128, kt=1, keep_perm=case == "with_values")
    fmt = _from_jax(jfmt)
    walk = tdg.dg_row_walk(fmt)
    if case == "with_values":  # the pattern's walk goes with the new values
        new_vals = np.random.default_rng(63).standard_normal(mat.nnz).astype(np.float32)
        jfmt = jdg.with_values(jfmt, new_vals)
        fmt = tdg.with_values(fmt, new_vals)
        assert fmt.walk.slot is walk.slot and tdg.dg_row_walk(fmt) is fmt.walk
        walk, mat = fmt.walk, JCoo(mat.rows, mat.cols, new_vals, mat.shape)
    assert walk.n_slots == mat.nnz and walk.n_rows == fmt.n_programs * fmt.rb
    if case == "long_row":
        assert int(torch.unique_consecutive(walk.row, return_counts=True)[1].max()) >= 5000
    xt = torch.from_numpy(x)
    got = rw.walk_rows_plain(walk, fmt.vals, xt.view(-1, 1))[:, 0]
    args = (fmt.c0, fmt.cols, fmt.lrow)
    want = tdg.dg1_rows_plain(*args, fmt.vals, fmt.nc_p, xt, rb=fmt.rb)
    scale = tdg.dg1_rows_plain(*args, fmt.vals.abs(), fmt.nc_p, xt.abs(), rb=fmt.rb)
    assert got.shape == want.shape == (fmt.n_programs * fmt.rb,)
    assert float(((got - want).abs() / scale.clamp(min=1.0)).max()) <= 1e-5
    y = tdg.unpack_by_deal(fmt, got).numpy().reshape(-1, 1)
    yj = np.asarray(jdg.dg_spmv(jfmt, x)).reshape(-1, 1)
    check_result(y, yj, rtol=5e-4)
    check_result(y, spmm_reference(mat, x.astype(np.float64).reshape(-1, 1)), rtol=1e-5)
    if case in ("empty", "one_nz"):
        assert walk.runs == mat.nnz and int(np.count_nonzero(y)) == mat.nnz
