"""tpusparse_torch.autodiff against the JAX package on the CPU, mirroring
tests/test_autodiff.py and the K-tile test of tests/test_sddmm.py:
``spmm_fn``'s gradient (A^T's own plan) against ``jax.grad`` through the
JAX ``spmm_fn`` and against float64 dense autograd, the trainable path
where the JAX ``_auto_ktile`` refuses, and ``CooMatrix.transpose``.
Tolerances: against JAX 2e-3 of |A|^T·|w| (the JAX kernels split fp32
into bf16 hi/lo, the port computes in fp32); against the dense gradient
the JAX test's 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.autodiff import _auto_ktile as j_auto_ktile
from tpusparse.autodiff import spmm_fn as jspmm_fn
from tpusparse.io import builder as jbuilder
from tpusparse.schedule import default_schedule as jdefault_schedule
from tpusparse_torch.autodiff import spmm_fn, spmm_trainable
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.sddmm import packed_to_nz
from tpusparse_torch.schedule import default_schedule


def _tmat(jmat):
    return CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)


@pytest.mark.parametrize("k_hint", [None, 8])
def test_spmm_grad_matches_jax_and_dense(k_hint):
    jmat = jbuilder.power_law_coo(120, 100, avg_nnz_per_row=5.0, seed=3)
    mat = _tmat(jmat)
    a = mat.to_dense(np.float64)
    x = np.random.default_rng(0).standard_normal((100, 8)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((120, 8)).astype(np.float32)

    fn = spmm_fn(mat, k_hint=k_hint, device="cpu")
    # the transposed plan takes A^T's own default, as the JAX package's
    assert fn.t_plan.meta["schedule"] == jdefault_schedule(jmat.transpose(), k_hint).describe()
    assert fn.plan.meta["schedule"] == default_schedule(mat, k_hint).describe()
    xt = torch.as_tensor(x).requires_grad_(True)
    (fn(xt) * torch.as_tensor(w)).sum().backward()
    gs = xt.grad.numpy()

    jfn = jspmm_fn(jmat, k_hint=k_hint)
    gj = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v) * w))(jnp.asarray(x)))
    assert np.all(np.abs(gs - gj) <= 2e-3 * (np.abs(a).T @ np.abs(w)) + 1e-30)

    xd = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    ((torch.as_tensor(a) @ xd) * torch.as_tensor(w, dtype=torch.float64)).sum().backward()
    np.testing.assert_allclose(gs, xd.grad.numpy(), rtol=5e-3, atol=5e-3)


def test_spmm_value_and_explicit_schedules():
    jmat = jbuilder.uniform_coo(64, 48, nnz_per_row=4, seed=1)
    mat = _tmat(jmat)
    x = np.random.default_rng(2).standard_normal((48, 8)).astype(np.float32)
    fn = spmm_fn(mat, device="cpu")
    y = fn(x)  # numpy in, a tensor out
    assert isinstance(y, torch.Tensor) and y.shape == (64, 8)
    want = mat.to_dense(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y.numpy(), want, rtol=5e-3, atol=5e-3)
    # an explicit schedule is mirrored onto the transposed plan
    from tpusparse_torch.schedule import Schedule

    sched = Schedule(family="stripe_total", work_per_block=64)
    fn2 = spmm_fn(mat, sched, device="cpu")
    assert fn2.t_plan.meta["schedule"]["family"] == "stripe_total"
    xt = torch.as_tensor(x).requires_grad_(True)
    fn2(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               mat.to_dense(np.float64).T @ np.ones((64, 8)), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 4])
def test_transpose_equals_jax(seed):
    jmat = jbuilder.power_law_coo(90, 70, avg_nnz_per_row=4.0, seed=seed)
    jt, tt = jmat.transpose(), _tmat(jmat).transpose()
    assert tt.shape == jt.shape == (70, 90)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    assert tt.is_row_major_sorted()


def test_auto_ktile_reduces_and_grads_match():
    # a tiny vmem_budget forces the JAX K-tile down (20 -> 10); the port
    # accepts the knob and its K-tile follows x, so the gradients match the
    # dense formulas, also at a budget where the JAX package refuses
    mat = _tmat(jbuilder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0))
    rng = np.random.default_rng(2)
    k = 20
    x = torch.as_tensor(rng.standard_normal((260, k)), dtype=torch.float32).requires_grad_(True)
    w = rng.standard_normal((300, k)).astype(np.float32)
    fn, v0 = spmm_trainable(mat, rb=64, ct=128, g=64, vmem_budget=260 * 10 * 4, device="cpu")
    v = v0.clone().requires_grad_(True)
    (fn(v, x) * torch.as_tensor(w)).sum().backward()
    dA = w @ x.detach().numpy().T
    got = packed_to_nz(fn.fmt, v.grad).numpy()
    want = dA[mat.rows, mat.cols]
    assert np.max(np.abs(got - want) / (np.abs(want) + 1e-3)) < 3e-2
    want = mat.to_dense().T @ w
    assert np.max(np.abs(x.grad.numpy() - want) / (np.abs(want) + 1e-3)) < 3e-2
    fn, v0 = spmm_trainable(mat, rb=64, ct=128, g=64, vmem_budget=5200, device="cpu")
    x.grad = None
    v = v0.clone().requires_grad_(True)
    (fn(v, x) * torch.as_tensor(w)).sum().backward()
    got = packed_to_nz(fn.fmt, v.grad).numpy()
    want = dA[mat.rows, mat.cols]
    assert np.max(np.abs(got - want) / (np.abs(want) + 1e-3)) < 3e-2
    want = mat.to_dense().T @ w
    assert np.max(np.abs(x.grad.numpy() - want) / (np.abs(want) + 1e-3)) < 3e-2


def test_trainable_runs_past_the_jax_width_gate():
    # 140,000 input features: the JAX package's 4 MiB VMEM budget refuses
    # any width past 131,072; the port's kernels stage no X.  Output and
    # both gradients against float64 formulas, at T1's tolerances
    n, k = 140_000, 8
    jmat = jbuilder.power_law_coo(64, n, avg_nnz_per_row=6.0, seed=4)
    mat = _tmat(jmat)
    with pytest.raises(ValueError, match="exceeds the VMEM budget"):
        j_auto_ktile(n, k, 4 * 2**20)
    rng = np.random.default_rng(5)
    x64 = rng.standard_normal((n, k))
    w = rng.standard_normal((64, k))
    x = torch.as_tensor(x64, dtype=torch.float32).requires_grad_(True)
    fn, v0 = spmm_trainable(mat, device="cpu")
    v = v0.clone().requires_grad_(True)
    y = fn(v, x)
    (y * torch.as_tensor(w, dtype=torch.float32)).sum().backward()
    xf = x.detach().double().numpy()
    want_y = np.zeros((64, k))
    np.add.at(want_y, mat.rows, mat.vals[:, None].astype(np.float64) * xf[mat.cols])
    assert y.shape == (64, k)
    assert np.max(np.abs(y.detach().numpy() - want_y)) <= 1e-3 * max(np.abs(want_y).max(), 1)
    want_dv = np.einsum("ik,ik->i", w[mat.rows], xf[mat.cols])    # sum_k dY[r,k] X[c,k]
    got_dv = packed_to_nz(fn.fmt, v.grad).numpy()
    assert np.max(np.abs(got_dv - want_dv) / (np.abs(want_dv) + 1e-3)) < 3e-2
    want_dx = np.zeros((n, k))                                    # A^T . dY
    np.add.at(want_dx, mat.cols, mat.vals[:, None].astype(np.float64) * w[mat.rows])
    assert np.max(np.abs(x.grad.numpy() - want_dx) / (np.abs(want_dx) + 1e-3)) < 3e-2
