"""tpusparse_torch.kernels.sddmm and autodiff.spmm_trainable against the
JAX package on the CPU (Pallas interpret mode there, the kernels' plain
versions here), mirroring tests/test_sddmm.py and
tests/test_fuzz.py::test_fuzz_trainable_grads.

The same numpy inputs go through both.  Tolerances, of the condition
scale |dY|·|X| (sampled at the slots) for dv and |A|^T·|dY| for dX: fp32
1e-5 (both compute in fp32 and differ in the order of the sums); fp32x2
2e-3 (the JAX side splits X and dY into bf16 hi/lo halves, the port
computes in fp32); bf16 1e-2, and 1e-5 for the kernels, which round
the same operands at the same places as the JAX kernels.
Against the dense formulas, the JAX tests' rule: relative error < 3e-2
with a floor of 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.autodiff import spmm_trainable as jtrainable
from tpusparse.io import builder as jbuilder
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.kernels import sddmm as jsddmm
from tpusparse.kernels.span_gather import pack_span as jpack_span
from tpusparse_torch.autodiff import spmm_trainable
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import sddmm
from tpusparse_torch.kernels.span_gather import pack_span
from test_fuzz import _random_matrix

TOL = {"fp32": 1e-5, "fp32x2": 2e-3, "bf16": 1e-2}


def _tmat(jmat):
    return CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)


def _rel_err(got, want, floor=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / (np.abs(want) + floor)))


def _within(got, want, scale, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * scale + 1e-30), (
        float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30))))


def _dense_check(got, want, scale, precision):
    """Against the dense formula: the JAX tests' relative rule, or for
    bf16 the repo's bf16 rule, 1e-2 of the condition scale."""
    if precision == "bf16":
        _within(got, want, scale, 1e-2)
    else:
        assert _rel_err(got, want) < 3e-2


def _formats(jmat, **kw):
    jfmt = jpack_span(jmat, keep_perm=True, **kw)
    tfmt = pack_span(_tmat(jmat), keep_perm=True, device="cpu", **kw)
    return jfmt, tfmt


@pytest.mark.parametrize("precision", ["fp32", "fp32x2", "bf16"])
@pytest.mark.parametrize("k", [12, 20, 24])
def test_span_sddmm_and_dx_match_jax(k, precision):
    # ktile 8: the K-tile loop, and at K = 12 and 20 the K tail
    jmat = jbuilder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0)
    jfmt, tfmt = _formats(jmat, rb=64, ct=128, g=64)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((260, k)).astype(np.float32)
    dy = rng.standard_normal((300, k)).astype(np.float32)
    inv = sddmm.origrow_of_slot(tfmt)
    np.testing.assert_array_equal(inv, jsddmm.origrow_of_slot(jfmt))
    mask = sddmm.occupancy_mask(tfmt)
    np.testing.assert_array_equal(mask, jsddmm.occupancy_mask(jfmt))
    dy_slots = np.concatenate([dy, np.zeros((1, k), np.float32)])[inv]

    dv = sddmm.span_sddmm(tfmt, dy_slots, x, ktile=8, precision=precision).numpy()
    dv_j = np.asarray(jsddmm.span_sddmm(jfmt, jnp.asarray(dy_slots), jnp.asarray(x), ktile=8,
                                        precision=precision))
    scale = sddmm.span_sddmm(tfmt, np.abs(dy_slots), np.abs(x), precision="fp32").numpy()
    # bf16: both round the same operands at the same places, so they also
    # agree at the fp32 rule, which catches a rounding left out
    tol = TOL["fp32"] if precision == "bf16" else TOL[precision]
    _within(dv * mask, dv_j * mask, scale * mask, tol)
    _dense_check(sddmm.packed_to_nz(tfmt, dv).numpy(), (dy @ x.T)[jmat.rows, jmat.cols],
                 sddmm.packed_to_nz(tfmt, scale).numpy(), precision)

    vals = tfmt.vals
    dx = sddmm.span_dx(tfmt, vals, dy_slots, ktile=8, precision=precision).numpy()
    dx_j = np.asarray(jsddmm.span_dx(jfmt, jfmt.vals, jnp.asarray(dy_slots), ktile=8,
                                     precision=precision))
    assert dx.shape == dx_j.shape == (260, k)
    scale = sddmm.span_dx(tfmt, vals.abs(), np.abs(dy_slots), precision="fp32").numpy()
    _within(dx, dx_j, scale, tol)
    _dense_check(dx, _tmat(jmat).to_dense().T @ dy, scale, precision)


def test_host_helpers_and_public_sddmm_match_jax():
    jmat = jbuilder.power_law_coo(220, 190, avg_nnz_per_row=5.0, seed=7)
    rng = np.random.default_rng(8)
    a = rng.standard_normal((220, 16)).astype(np.float32)
    b = rng.standard_normal((190, 16)).astype(np.float32)
    got = sddmm.sddmm(_tmat(jmat), a, b, rb=64, ct=128, g=64, precision="fp32", device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (jmat.nnz,)
    want_j = jsddmm.sddmm(jmat, a, b, rb=64, ct=128, g=64, precision="fp32")
    scale = (np.abs(a) @ np.abs(b).T)[jmat.rows, jmat.cols]
    _within(got.numpy(), want_j, scale, TOL["fp32"])
    assert _rel_err(got.numpy(), (a @ b.T)[jmat.rows, jmat.cols]) < 3e-2
    # the export helper equals the JAX one on the same plane
    jfmt, tfmt = _formats(jmat, rb=64, ct=128, g=64)
    plane = rng.standard_normal(tuple(tfmt.cols.shape)).astype(np.float32)
    np.testing.assert_array_equal(sddmm.packed_to_nz(tfmt, plane).numpy(),
                                  jsddmm.packed_to_nz(jfmt, plane))


def test_trainable_values_with_explicit_zero():
    # a stored zero is a real trainable position: its value-grad must be
    # kept (the occupancy mask comes from the packing permutation)
    rows = np.array([0, 0, 1, 2], dtype=np.int64)
    cols = np.array([0, 2, 1, 3], dtype=np.int64)
    vals = np.array([1.0, 0.0, 2.0, -1.0], dtype=np.float32)
    mat = CooMatrix(rows=rows, cols=cols, vals=vals, shape=(3, 8))
    fn, v0 = spmm_trainable(mat, rb=8, ct=16, g=8, device="cpu")
    v = v0.clone().requires_grad_(True)
    x = torch.as_tensor(np.eye(8, 4, dtype=np.float32))
    fn(v, x).sum().backward()
    nz = sddmm.packed_to_nz(fn.fmt, v.grad).numpy()
    # dL/dv[nz=(r,c)] = sum_k x[c, k]; col 2 has x[2, :4].sum() == 1
    assert nz[1] == 1.0
    jfn, jv0 = jtrainable(JCoo(rows, cols, vals, (3, 8)), rb=8, ct=16, g=8)
    jdv = jax.grad(lambda v: jnp.sum(jfn(v, jnp.asarray(x.numpy()))))(jv0)
    np.testing.assert_allclose(nz, jsddmm.packed_to_nz(jfn.fmt, jdv), rtol=1e-6)


def _grads_port(mat, x, w, **kw):
    fn, v0 = spmm_trainable(mat, device="cpu", **kw)
    v = v0.clone().requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = fn(v, xt)
    (y * torch.as_tensor(w)).sum().backward()
    return fn, y.detach().numpy(), sddmm.packed_to_nz(fn.fmt, v.grad).numpy(), xt.grad.numpy()


def _grads_jax(jmat, x, w, **kw):
    fn, v0 = jtrainable(jmat, **kw)
    dv, dx = jax.grad(lambda v, x: jnp.sum(fn(v, x) * w), argnums=(0, 1))(v0, jnp.asarray(x))
    return np.asarray(fn(v0, jnp.asarray(x))), jsddmm.packed_to_nz(fn.fmt, dv), np.asarray(dx)


@pytest.mark.parametrize("k", [12, 20])
def test_trainable_grads_match_jax_and_dense(k):
    jmat = jbuilder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0)
    mat = _tmat(jmat)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((260, k)).astype(np.float32)
    w = rng.standard_normal((300, k)).astype(np.float32)
    kw = dict(rb=64, ct=128, g=64)
    _, y, dv, dx = _grads_port(mat, x, w, **kw)
    yj, dvj, dxj = _grads_jax(jmat, x, w, **kw)
    a = mat.to_dense(np.float64)
    _within(y, yj, np.abs(a) @ np.abs(x), TOL["fp32x2"])
    _within(dv, dvj, (np.abs(w) @ np.abs(x).T)[mat.rows, mat.cols], TOL["fp32x2"])
    _within(dx, dxj, np.abs(a).T @ np.abs(w), TOL["fp32x2"])
    # against float64 dense autograd: y = A x, dL/dA sampled, dL/dx = A^T w
    wa = torch.tensor(a, requires_grad=True)
    xa = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    ((wa @ xa) * torch.as_tensor(w, dtype=torch.float64)).sum().backward()
    np.testing.assert_allclose(y, (wa @ xa).detach().numpy(), rtol=1e-4, atol=1e-4)
    assert _rel_err(dv, wa.grad.numpy()[mat.rows, mat.cols]) < 3e-2
    assert _rel_err(dx, xa.grad.numpy()) < 3e-2


@pytest.mark.parametrize("seed", [0, 5, 7, 25])
def test_fuzz_trainable_grads(seed):
    # tests/test_fuzz.py::test_fuzz_trainable_grads's draws at its seeds
    # (5000 + seed): 5 holds 6 nonzeros, 25 none, which the JAX test skips
    # and the port answers with zeros
    rng = np.random.default_rng(5000 + seed)
    jmat = _random_matrix(rng)
    mat = _tmat(jmat)
    k = int(rng.integers(1, 24))
    x = rng.standard_normal((mat.shape[1], k)).astype(np.float32)
    w = rng.standard_normal((mat.shape[0], k)).astype(np.float32)
    kw = dict(rb=int(2 ** rng.integers(4, 7)), ct=int(2 ** rng.integers(5, 8)),
              g=int(2 ** rng.integers(4, 7)))
    fn, y, dv, dx = _grads_port(mat, x, w, **kw)
    if mat.nnz == 0:
        assert y.shape == (mat.shape[0], k) and not y.any()
        assert dx.shape == x.shape and not dx.any() and dv.shape == (0,)
        return
    a = mat.to_dense(np.float64)

    def close(got, want):
        # condition-aware floor, as the JAX fuzz test
        floor = 1e-3 * (1.0 + np.abs(want).max())
        assert np.max(np.abs(got - want) / (np.abs(want) + floor)) < 3e-2

    close(dv, (w @ x.T)[mat.rows, mat.cols])
    close(dx, a.T @ w)
    _, dvj, dxj = _grads_jax(jmat, x, w, **kw)
    _within(dv, dvj, (np.abs(w) @ np.abs(x).T)[mat.rows, mat.cols], TOL["fp32x2"])
    _within(dx, dxj, np.abs(a).T @ np.abs(w), TOL["fp32x2"])
