"""tpusparse_torch.nn.SparseLinear against the JAX package's layer on the
CPU (Pallas interpret mode there, the kernels' plain versions here): every
constructor with leading dims and a bias, the layer as a torch Module
(buffers), the differentiable layers' input gradients against
``jax.grad`` through the JAX layers, and ``TrainableSparseLinear`` loaded
from the JAX layer's parameters (same forward and gradients), trained with
Adam and saved and restored through its ``state_dict``.
Tolerances: port against JAX 1e-5 of |x|·|W^T| (+|b|) where both compute
in fp32 or round the same inputs to bf16; 2e-3 of it where the JAX side
runs its fp32x2 hi/lo split (from_coo's kernels, the trainable layer);
gradients the same, of |t|·|W| for x and |t|^T·|x| for the values;
against the dense reference the JAX tests' bounds (tests/test_nn.py,
tests/test_nm_kernel.py, tests/test_block_ell.py, tests/test_sddmm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse
from tpusparse.nn import SparseLinear as JLinear
from tpusparse.nn import TrainableSparseLinear as JTrainable
from tpusparse_torch.io import builder as tbuilder
from tpusparse_torch.nn import SparseLinear, TrainableSparseLinear, trainable_state_from_numpy


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


@pytest.mark.parametrize("ctor,precision", [("from_coo", None), ("from_block", "fp32"),
                                            ("from_block", "bf16")])
def test_differentiable_layer_grads_match_jax(ctor, precision):
    if ctor == "from_coo":
        mat = tbuilder.power_law_coo(96, 80, avg_nnz_per_row=5.0, seed=4)
        kw, vs_jax = dict(k_hint=8), 2e-3
    else:
        mat = tbuilder.block_sparse_coo(128, 128, block=64, block_density=0.5, seed=1)
        kw, vs_jax = dict(bs=64, precision=precision), 1e-5
    w = mat.to_dense(np.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, mat.shape[1])).astype(np.float32)
    t = rng.standard_normal((2, 3, mat.shape[0])).astype(np.float32)
    layer = getattr(SparseLinear, ctor)(mat, differentiable=True, device="cpu", **kw)
    jlayer = getattr(JLinear, ctor)(_jmat(mat), differentiable=True, **kw)
    assert layer.meta == jlayer.meta
    xt = torch.as_tensor(x).requires_grad_(True)
    y = layer(xt)
    (y * torch.as_tensor(t)).sum().backward()
    gj = np.asarray(jax.grad(lambda v: jnp.sum(jlayer(v) * t))(jnp.asarray(x)))
    scale = np.abs(t.astype(np.float64)) @ np.abs(w.astype(np.float64))
    assert np.abs(xt.grad.numpy() - gj).max() <= vs_jax * scale.max()
    want = t.astype(np.float64) @ w.astype(np.float64)
    if precision == "bf16":
        assert np.abs(xt.grad.numpy() - want).max() / np.abs(want).max() < 1e-2
    else:
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=5e-3, atol=5e-3)
    with pytest.raises(AssertionError, match="serving path"):
        SparseLinear.from_block(mat, bs=64, precision="int8", differentiable=True, device="cpu")


def _trainable_pair(seed=5, bias=True):
    wc = tbuilder.pruned_weight_coo(48, 40, sparsity=0.8, seed=seed)
    layer = TrainableSparseLinear(wc, rb=16, ct=64, g=32, bias=bias, device="cpu")
    jlayer = JTrainable(_jmat(wc), rb=16, ct=64, g=32, bias=bias)
    return wc, layer, jlayer


def test_trainable_layer_loads_jax_params_and_matches():
    wc, layer, jlayer = _trainable_pair()
    rng = np.random.default_rng(6)
    params = jlayer.init()
    params = {"vals": np.asarray(params["vals"]),
              "bias": rng.standard_normal(48).astype(np.float32)}  # a trained-like bias
    layer.load_state_dict(trainable_state_from_numpy(params))
    assert {n for n, _ in layer.named_parameters()} == {"vals", "bias"}
    x = rng.standard_normal((4, 5, 40)).astype(np.float32)
    t = rng.standard_normal((4, 5, 48)).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = layer(xt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    yj = np.asarray(jlayer.apply(jp, x))
    w = wc.to_dense(np.float64)
    scale = np.abs(x) @ np.abs(w).T + np.abs(params["bias"])
    assert np.abs(y.detach().numpy() - yj).max() <= 2e-3 * scale.max()

    ((y - torch.as_tensor(t)) ** 2).mean().backward()
    gj, gxj = jax.grad(lambda p, v: jnp.mean((jlayer.apply(p, v) - t) ** 2),
                       argnums=(0, 1))(jp, jnp.asarray(x))
    dy = 2.0 * (y.detach().numpy() - t) / t.size
    gscale_v = np.abs(dy.reshape(-1, 48)).T @ np.abs(x.reshape(-1, 40))
    got_v = layer.export_vals()
    # the JAX gradient plane, exported through the port's (equal) permutation
    from tpusparse_torch.kernels.sddmm import packed_to_nz

    want_v = packed_to_nz(layer.fmt, np.asarray(gj["vals"])).numpy()
    assert got_v.shape == (wc.nnz,)
    np.testing.assert_array_equal(got_v.numpy(), wc.vals.astype(np.float32))
    got_gv = packed_to_nz(layer.fmt, layer.vals.grad).numpy()
    assert np.abs(got_gv - want_v).max() <= 2e-3 * gscale_v[wc.rows, wc.cols].max()
    assert np.abs(layer.bias.grad.numpy() - np.asarray(gj["bias"])).max() <= 2e-3 * (
        np.abs(dy).reshape(-1, 48).sum(axis=0).max())
    assert np.abs(xt.grad.numpy() - np.asarray(gxj)).max() <= 2e-3 * (
        np.abs(dy) @ np.abs(w)).max()


def _adam_run(layer, x, t, steps):
    opt = torch.optim.Adam(layer.parameters(), lr=5e-2)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = ((layer(x) - t) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return opt, losses


def test_trainable_layer_trains():
    wc, layer, _ = _trainable_pair()
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((4, 5, 40)), dtype=torch.float32)
    t = torch.as_tensor(rng.standard_normal((4, 5, 48)), dtype=torch.float32)
    _, losses = _adam_run(layer, x, t, 30)
    assert losses[-1] < 0.7 * losses[0], losses
    out = layer.export_vals().numpy()
    assert out.shape == (wc.nnz,)
    assert np.abs(out - wc.vals).max() > 1e-4
    # padding slots stay out of the gradient: their values never move
    from tpusparse_torch.kernels.sddmm import occupancy_mask

    pad = occupancy_mask(layer.fmt) == 0
    assert not layer.vals.detach().numpy()[pad].any()


def test_trainable_state_dict_checkpoint_resume(tmp_path):
    """Save the parameters and the optimizer state mid-training, restore
    them into a fresh layer built from the same COO, and training goes on
    bit for bit as the uninterrupted run."""
    _, layer, _ = _trainable_pair(seed=9)
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((8, 40)), dtype=torch.float32)
    t = torch.as_tensor(rng.standard_normal((8, 48)), dtype=torch.float32)
    opt, _ = _adam_run(layer, x, t, 2)
    torch.save({"model": layer.state_dict(), "opt": opt.state_dict()}, tmp_path / "ckpt.pt")

    def more(layer, opt):
        for _ in range(2):
            opt.zero_grad()
            ((layer(x) - t) ** 2).mean().backward()
            opt.step()

    more(layer, opt)
    _, layer2, _ = _trainable_pair(seed=9)
    opt2 = torch.optim.Adam(layer2.parameters(), lr=5e-2)
    ckpt = torch.load(tmp_path / "ckpt.pt")
    layer2.load_state_dict(ckpt["model"])
    opt2.load_state_dict(ckpt["opt"])
    more(layer2, opt2)
    assert torch.equal(layer.vals, layer2.vals) and torch.equal(layer.bias, layer2.bias)
