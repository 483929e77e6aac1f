"""tpusparse_torch's N:M structured path against the JAX package's: the
builder, pack_nm (the packed arrays, padding included, bit-packed and
unpacked offsets, int8 row_scale), nm_format_from_numpy, nm_spmm on the CPU
(the kernel's plain version) against the JAX function (Pallas interpret
mode) and the oracle, and batched_spmm.  Tolerances: port against JAX 1e-5
of |A|·|X| in every mode (the same inputs rounded the same way, fp32 sums in
another order); against the oracle the JAX tests' own bounds
(tests/test_nm_kernel.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.batched import batched_spmm as jbatched
from tpusparse.io import builder as jbuilder
from tpusparse.kernels import nm_structured as jnm
from tpusparse_torch import batched as tbatched
from tpusparse_torch.io import builder as tbuilder
from tpusparse_torch.kernels import nm_structured as tnm

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (np.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


def _dense_and_x(m=96, n=256, k=24, n_keep=2, group=4, seed=0):
    dense = tbuilder.nm_pruned_dense(m, n, n_keep=n_keep, group=group, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return dense, x


def _packs(dense, n_keep, group, dtype):
    jdt, tdt = DTYPES[dtype]
    return (jnm.pack_nm(dense, n_keep=n_keep, group=group, dtype=jdt),
            tnm.pack_nm(dense, n_keep=n_keep, group=group, dtype=tdt, device="cpu"))


def _scale(dense, x):
    return np.abs(dense.astype(np.float64)) @ np.abs(x.astype(np.float64))


@pytest.mark.parametrize("n_keep,group", [(2, 4), (1, 4), (4, 8)])
def test_nm_pruned_dense_equals_jax(n_keep, group):
    np.testing.assert_array_equal(
        tbuilder.nm_pruned_dense(64, 128, n_keep, group, seed=3),
        jbuilder.nm_pruned_dense(64, 128, n_keep, group, seed=3))


@pytest.mark.parametrize("dtype", ["bf16", "fp32", "int8"])
@pytest.mark.parametrize("n_keep,group,m,n", [(2, 4, 96, 256), (1, 4, 96, 256),
                                              (4, 8, 96, 256), (2, 4, 50, 148)])
def test_pack_nm_equals_jax(n_keep, group, m, n, dtype):
    dense, _ = _dense_and_x(m=m, n=n, n_keep=n_keep, group=group)
    jf, tf = _packs(dense, n_keep, group, dtype)
    np.testing.assert_array_equal(tf.vals.float().numpy(), np.asarray(jf.vals, np.float32))
    assert tf.vals.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(tf.offs.numpy(), np.asarray(jf.offs))
    assert (tf.packed_bits, tf.m_pad, tf.g_pad, tf.shape) == \
        (jf.packed_bits, jf.m_pad, jf.g_pad, jf.shape)
    assert tf.packed_bits == (0 if (n_keep, group) == (4, 8) else 2)
    assert tf.memory_bytes == jf.memory_bytes and tf.nnz == jf.nnz
    np.testing.assert_array_equal(tnm.unpacked_offs(tf), jnm.unpacked_offs(jf))
    if dtype == "int8":
        np.testing.assert_array_equal(tf.row_scale.numpy(), np.asarray(jf.row_scale))
    else:
        assert tf.row_scale is None and jf.row_scale is None


def test_pack_nm_rejects_violation():
    with pytest.raises(ValueError, match="exceed 2:4"):
        tnm.pack_nm(np.ones((8, 16), np.float32), n_keep=2, group=4, device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_nm_format_from_numpy_roundtrip(dtype):
    dense, x = _dense_and_x(n_keep=2, group=4, seed=2)
    jf, tf = _packs(dense, 2, 4, dtype)
    static = dict(shape=jf.shape, n_keep=jf.n_keep, group=jf.group,
                  packed_bits=jf.packed_bits)
    fields = {"vals": np.asarray(jf.vals), "offs": np.asarray(jf.offs),
              "row_scale": None if jf.row_scale is None else np.asarray(jf.row_scale)}
    back = tnm.nm_format_from_numpy(fields, device="cpu", **static)
    assert torch.equal(back.vals, tf.vals) and torch.equal(back.offs, tf.offs)
    torch.testing.assert_close(tnm.nm_spmm(back, x), tnm.nm_spmm(tf, x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="offsets out of range"):
        tnm.nm_format_from_numpy(dict(fields, offs=np.full((2,) + fields["offs"].shape[1:], 5,
                                                           np.int8)),
                                 device="cpu", **dict(static, packed_bits=0))
    with pytest.raises(ValueError, match="NmFormat.vals"):
        tnm.nm_format_from_numpy(dict(fields, vals=fields["vals"][:, :10]), device="cpu",
                                 **static)


@pytest.mark.parametrize("precision,dtype,n_keep,group,shape", [
    ("fp32", "fp32", 2, 4, (96, 256, 24)), ("fp32", "fp32", 1, 4, (96, 256, 24)),
    ("fp32", "fp32", 4, 8, (96, 256, 24)), ("fp32", "fp32", 2, 4, (50, 148, 9)),
    ("bf16", "bf16", 2, 4, (128, 512, 64)), ("bf16", "fp32", 4, 8, (96, 256, 16)),
    ("fp32", "bf16", 2, 4, (96, 256, 16)), ("int8", "int8", 2, 4, (96, 256, 40)),
    ("bf16", "int8", 4, 8, (96, 256, 16)),
])
def test_nm_spmm_matches_jax_and_oracle(precision, dtype, n_keep, group, shape):
    m, n, k = shape
    dense, x = _dense_and_x(m=m, n=n, k=k, n_keep=n_keep, group=group, seed=7)
    jf, tf = _packs(dense, n_keep, group, dtype)
    y = tnm.nm_spmm(tf, x, precision=precision)
    assert y.dtype == torch.float32 and y.shape == (m, k)
    y = y.numpy()
    scale = _scale(dense, x)
    yj = np.asarray(jnm.nm_spmm(jf, x, precision=precision))
    assert np.abs(y - yj).max() <= 1e-5 * scale.max()
    want = dense.astype(np.float64) @ x.astype(np.float64)
    if dtype == "int8":       # tests/test_nm_kernel.py:86-104
        assert (np.abs(y - want) / np.maximum(scale, 1e-30)).max() < 2e-2
    elif precision == "fp32" and dtype == "fp32":
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    else:                     # tests/test_nm_kernel.py:51-57
        assert np.abs(y - want).max() / np.abs(want).max() < 1e-2


def test_nm_spmm_precision_guards():
    dense, x = _dense_and_x(k=8, seed=8)
    with pytest.raises(AssertionError, match="int8-packed"):
        tnm.nm_spmm(tnm.pack_nm(dense, device="cpu"), x, precision="int8")
    with pytest.raises(AssertionError, match="W8A16"):
        tnm.nm_spmm(tnm.pack_nm(dense, dtype=torch.int8, device="cpu"), x, precision="fp32")


def test_batched_spmm_nm_matches_jax():
    dense, _ = _dense_and_x(m=64, n=128, k=8)
    jf, tf = _packs(dense, 2, 4, "fp32")
    xb = np.random.default_rng(7).standard_normal((3, 128, 8)).astype(np.float32)
    yb = tbatched.batched_spmm(lambda x: tnm.nm_spmm(tf, x, precision="fp32"), xb)
    assert yb.shape == (3, 64, 8)
    want = np.einsum("nk,bkj->bnj", dense, xb)
    np.testing.assert_allclose(yb.numpy(), want, rtol=1e-5, atol=1e-5)
    yj = np.asarray(jbatched(lambda x: jnm.nm_spmm(jf, x, precision="fp32"), xb))
    np.testing.assert_allclose(yb.numpy(), yj, rtol=0, atol=1e-5 * np.abs(want).max())
    xt = torch.from_numpy(xb)
    torch.testing.assert_close(tbatched.unfold_batch(tbatched.fold_batch(xt), 3), xt)


@pytest.mark.parametrize("m_pad,k,depth,mode,want", [
    (4096, 512, 4096, "bf16", 2),    # P13's layer: 32 x 2 tiles of 128 x 256
    (4096, 128, 4096, "bf16", 4),    # nm_spmm at K = 128: 32 tiles of 128 x 128
    (4096, 128, 4096, "fp32", 2),    # 64 x 128 tiles: 64 of them
    (4096, 512, 4096, "fp32", 1),    # 64 x 4 tiles
    (4096, 2048, 4096, "bf16", 1),   # a prefill batch: 256 tiles
    (512, 37, 1024, "bf16", 4),      # 4 tiles, 16 depth steps: at least 4 each
    (512, 37, 128, "fp32", 1),       # 2 depth steps: no split
])
def test_depth_splits(m_pad, k, depth, mode, want):
    assert tnm.depth_splits(m_pad, k, depth, mode, 132) == want
    assert tnm.tile_of(mode, k) == ((128, 256 if k > 128 else 128) if mode == "bf16" else
                                    (64, 128))


def test_nm_format_from_numpy_refuses_two_values_at_one_offset():
    # the kernel stores each kept value into its place, so a group's kept
    # values must sit at distinct offsets (as every packer makes them)
    dense, _ = _dense_and_x(n_keep=2, group=4, seed=2)
    jf, _ = _packs(dense, 2, 4, "fp32")
    static = dict(shape=jf.shape, n_keep=2, group=4, packed_bits=jf.packed_bits)
    vals, offs = np.asarray(jf.vals), np.asarray(jf.offs).copy()
    assert jf.packed_bits == 2 and (vals[:, 0, 0] != 0).all()
    o0 = int(offs[0, 0, 0].view(np.uint8)) & 3
    offs[0, 0, 0] = np.array(o0 | (o0 << 2), np.uint8).view(np.int8)
    with pytest.raises(ValueError, match="one offset"):
        tnm.nm_format_from_numpy({"vals": vals, "offs": offs}, device="cpu", **static)
    vals = vals.copy()
    vals[1, 0, 0] = 0.0                   # a padding slot may share offset 0
    tnm.nm_format_from_numpy({"vals": vals, "offs": offs}, device="cpu", **static)
