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
