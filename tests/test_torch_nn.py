"""tpusparse_torch.nn.SparseLinear against the JAX package's layer on the
CPU (Pallas interpret mode there, the kernels' plain versions here): every
constructor with leading dims and a bias, the layer as a torch Module
(buffers), and the training entry points that wait for ROADMAP.md A.9.
Tolerances: port against JAX 1e-5 of |x|·|W^T| (+|b|) where both compute
in fp32 or round the same inputs to bf16; 2e-3 of it where the JAX side
runs its fp32x2 hi/lo split (from_coo's kernels); against the dense
reference the JAX tests' bounds (tests/test_nn.py, tests/test_nm_kernel.py,
tests/test_block_ell.py).
"""

import numpy as np
import pytest
import torch

import tpusparse
from tpusparse.nn import SparseLinear as JLinear
from tpusparse_torch.io import builder as tbuilder
from tpusparse_torch.nn import SparseLinear


def _jmat(mat):
    return tpusparse.CooMatrix(mat.rows, mat.cols, mat.vals, mat.shape)


def _scale(w, x, b=None):
    s = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64)).T
    return s + (np.abs(b) if b is not None else 0)


def _check(layer, jlayer, w, x, b, *, vs_jax):
    y = layer(x)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert y.shape == x.shape[:-1] + (w.shape[0],)
    y = y.numpy()
    scale = _scale(w, x, b)
    yj = np.asarray(jlayer(x))
    assert np.abs(y - yj).max() <= vs_jax * scale.max()
    want = x.astype(np.float64) @ w.astype(np.float64).T + (b if b is not None else 0)
    return y, want, scale


def test_from_coo_lead_dims_and_bias():
    mat = tbuilder.power_law_coo(96, 80, avg_nnz_per_row=5.0, seed=0)
    w = mat.to_dense(np.float32)
    b = np.random.default_rng(0).standard_normal(96).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((2, 3, 80)).astype(np.float32)
    layer = SparseLinear.from_coo(mat, bias=b, device="cpu")
    assert isinstance(layer, torch.nn.Module) and layer.meta["kind"] == "coo"
    assert layer.meta["schedule"] == JLinear.from_coo(_jmat(mat)).meta["schedule"]
    y, want, _ = _check(layer, JLinear.from_coo(_jmat(mat), bias=b), w, x, b,
                        vs_jax=2e-3)
    np.testing.assert_allclose(y, want, rtol=5e-3, atol=5e-3)
    assert torch.equal(layer.bias, torch.from_numpy(b))
    assert {n for n, _ in layer.named_buffers()} >= {"bias", "fmt0_vals", "fmt0_cols"}


def test_from_coo_k_hint_and_from_dense():
    mat = tbuilder.power_law_coo(128, 96, avg_nnz_per_row=5.0, seed=2)
    layer = SparseLinear.from_coo(mat, k_hint=8, device="cpu")
    jlayer = JLinear.from_coo(_jmat(mat), k_hint=8)
    assert layer.meta["schedule"]["family"] == "dg_span" == jlayer.meta["schedule"]["family"]
    x = np.random.default_rng(0).standard_normal((4, 96)).astype(np.float32)
    y, want, _ = _check(layer, jlayer, mat.to_dense(np.float32), x, None, vs_jax=2e-3)
    np.testing.assert_allclose(y, want, rtol=2e-3, atol=1e-4)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[np.abs(w) < 1.0] = 0.0
    x = rng.standard_normal((5, 48)).astype(np.float32)
    y, want, _ = _check(SparseLinear.from_dense(w, device="cpu"), JLinear.from_dense(w), w, x,
                        None, vs_jax=2e-3)
    np.testing.assert_allclose(y, want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("precision,mode", [("fp32", "compact"), ("bf16", "compact"),
                                            ("int8", "compact"), ("fp32", "throughput"),
                                            ("bf16", "throughput")])
def test_from_nm_matches_jax(precision, mode):
    w = tbuilder.nm_pruned_dense(64, 128, seed=3)
    b = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((2, 7, 128)).astype(np.float32)
    layer = SparseLinear.from_nm(w, precision=precision, mode=mode, bias=b, device="cpu")
    jlayer = JLinear.from_nm(w, precision=precision, mode=mode, bias=b)
    assert layer.meta == jlayer.meta
    y, want, scale = _check(layer, jlayer, w, x, b, vs_jax=1e-5)
    if precision == "fp32":
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
    elif precision == "int8":
        assert (np.abs(y - want) / np.maximum(scale, 1e-30)).max() < 2e-2
    else:
        assert np.abs(y - want).max() / np.abs(want).max() < 1e-2
    if mode == "throughput":
        assert layer.weight.dtype == (torch.float32 if precision == "fp32" else torch.bfloat16)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_from_block_matches_jax(precision):
    mat = tbuilder.block_sparse_coo(256, 256, block=128, block_density=0.3, seed=5)
    w = mat.to_dense(np.float32)
    b = np.random.default_rng(7).standard_normal(256).astype(np.float32)
    x = np.random.default_rng(6).standard_normal((2, 4, 256)).astype(np.float32)
    layer = SparseLinear.from_block(mat, precision=precision, bias=b, device="cpu")
    jlayer = JLinear.from_block(_jmat(mat), precision=precision, bias=b)
    assert layer.meta == jlayer.meta
    y, want, scale = _check(layer, jlayer, w, x, b, vs_jax=1e-5)
    if precision == "fp32":
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-3)
    elif precision == "int8":
        assert (np.abs(y - want) / np.maximum(scale, 1e-30)).max() < 4e-2
    else:
        assert np.abs(y - want).max() / np.abs(want).max() < 1e-2


def test_layer_takes_tensors_and_checks_shape():
    mat = tbuilder.uniform_coo(16, 8, nnz_per_row=2, seed=9)
    layer = SparseLinear.from_coo(mat, device="cpu")
    x = torch.randn(3, 8, dtype=torch.float64)
    y = layer(x.T.contiguous().T)  # a transposed view folds like any tensor
    np.testing.assert_allclose(y.numpy(), x.numpy() @ mat.to_dense(np.float64).T,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError, match="in_features"):
        layer(np.zeros((3, 7), np.float32))


@pytest.mark.parametrize("ctor", ["from_coo", "from_block"])
def test_differentiable_layer_waits_for_training_slice(ctor):
    mat = tbuilder.block_sparse_coo(128, 128, block=64, block_density=0.5, seed=1)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.9"):
        getattr(SparseLinear, ctor)(mat, differentiable=True, device="cpu")
