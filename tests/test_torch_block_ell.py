"""tpusparse_torch's Block-ELL path against the JAX package's: the builder,
pack_block_ell (the packed arrays at bs 64 and 128 in fp32, bf16 and int8,
empty row-blocks, odd shapes), block_ell_format_from_numpy, and
block_ell_spmm on the CPU (the kernel's plain version and the batched
product) against the JAX function with both methods (Pallas interpret mode)
and the oracle.  Tolerances: port against JAX 1e-5 of |A|·|X| (the same
inputs rounded the same way, fp32 sums in another order); against the
oracle the JAX tests' own bounds (tests/test_block_ell.py); the int8
integer product exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.io import builder as jbuilder
from tpusparse.kernels import block_ell as jbe
from tpusparse_torch.io import builder as tbuilder
from tpusparse_torch.kernels import block_ell as tbe

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": ("bfloat16", torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _case(m=384, n=512, bs=128, density=0.2, k=32, seed=0):
    mat = tbuilder.block_sparse_coo(m, n, block=bs, block_density=density, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return mat, x


def _jmat(mat):
    import tpusparse

    return tpusparse.CooMatrix(mat.rows, mat.cols, mat.vals, mat.shape)


def _packs(mat, bs, dtype):
    jdt, tdt = DTYPES[dtype]
    return (jbe.pack_block_ell(_jmat(mat), bs=bs, dtype=jdt),
            tbe.pack_block_ell(mat, bs=bs, dtype=tdt, device="cpu"))


def _ref(mat, x):
    d = mat.to_dense(np.float64)
    return d @ x.astype(np.float64), np.abs(d) @ np.abs(x.astype(np.float64))


@pytest.mark.parametrize("args", [(384, 512, 128, 0.2, 0), (300, 450, 128, 0.2, 0),
                                  (512, 512, 128, 0.08, 5), (200, 200, 64, 0.0, 1)])
def test_block_sparse_coo_equals_jax(args):
    a, b = jbuilder.block_sparse_coo(*args[:4], seed=args[4]), \
        tbuilder.block_sparse_coo(*args[:4], seed=args[4])
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("bs,m,n,density,seed", [(128, 384, 512, 0.2, 0), (64, 384, 512, 0.2, 0),
                                                 (128, 512, 512, 0.08, 5),   # empty row-blocks
                                                 (128, 300, 450, 0.2, 0)])   # odd shapes
def test_pack_block_ell_equals_jax(bs, m, n, density, seed, dtype):
    mat, _ = _case(m=m, n=n, density=density, seed=seed)
    jf, tf = _packs(mat, bs, dtype)
    np.testing.assert_array_equal(tf.blkcol.numpy(), np.asarray(jf.blkcol))
    np.testing.assert_array_equal(tf.blkvals.float().numpy(), np.asarray(jf.blkvals, np.float32))
    assert tf.blkvals.dtype == DTYPES[dtype][1]
    assert (tf.n_blocks, tf.mb, tf.bmax, tf.bs, tf.shape) == \
        (jf.n_blocks, jf.mb, jf.bmax, jf.bs, jf.shape)
    assert tf.padding_rate == jf.padding_rate and tf.memory_bytes == jf.memory_bytes
    live = (np.asarray(jf.blkvals) != 0).any(axis=(2, 3))
    np.testing.assert_array_equal(tf.nb_p.numpy(), live.sum(axis=1))
    if dtype == "int8":
        np.testing.assert_array_equal(tf.row_scale.numpy(), np.asarray(jf.row_scale))


def test_block_ell_format_from_numpy_roundtrip():
    mat, x = _case(m=512, density=0.08, seed=5)
    jf, tf = _packs(mat, 128, "int8")
    fields = {"blkcol": np.asarray(jf.blkcol), "blkvals": np.asarray(jf.blkvals),
              "row_scale": np.asarray(jf.row_scale)}
    static = dict(shape=jf.shape, bs=jf.bs, n_blocks=jf.n_blocks)
    back = tbe.block_ell_format_from_numpy(fields, device="cpu", **static)
    assert torch.equal(back.nb_p, tf.nb_p) and torch.equal(back.blkvals, tf.blkvals)
    torch.testing.assert_close(tbe.block_ell_spmm(back, x), tbe.block_ell_spmm(tf, x),
                               rtol=0, atol=0)
    bad = dict(fields, blkcol=np.full_like(fields["blkcol"], 4))
    with pytest.raises(ValueError, match="block-columns out of range"):
        tbe.block_ell_format_from_numpy(bad, device="cpu", **static)
    with pytest.raises(ValueError, match="row_scale"):
        tbe.block_ell_format_from_numpy(dict(fields, row_scale=None), device="cpu", **static)


@pytest.mark.parametrize("method", ["xla", "pallas"])
@pytest.mark.parametrize("precision,dtype,bs,shape", [
    ("fp32", "fp32", 128, (384, 512, 24)), ("fp32", "fp32", 64, (384, 512, 24)),
    ("fp32", "fp32", 128, (300, 450, 8)), ("bf16", "bf16", 128, (384, 512, 200)),
    ("bf16", "fp32", 64, (384, 512, 16)), ("fp32", "bf16", 128, (384, 512, 16)),
])
def test_block_ell_spmm_matches_jax_and_oracle(precision, dtype, bs, shape, method):
    m, n, k = shape
    mat, x = _case(m=m, n=n, k=k, seed=9)
    jf, tf = _packs(mat, bs, dtype)
    y = tbe.block_ell_spmm(tf, x, precision=precision, method=method)
    assert y.dtype == torch.float32 and y.shape == (m, k)
    y = y.numpy()
    want, scale = _ref(mat, x)
    yj = np.asarray(jbe.block_ell_spmm(jf, x, precision=precision, method=method))
    assert np.abs(y - yj).max() <= 1e-5 * scale.max()
    if precision == "fp32" and dtype == "fp32":
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-3)
    else:
        assert np.abs(y - want).max() / np.abs(want).max() < 1e-2


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_block_ell_int8_matches_jax(method):
    mat, x = _case(k=64, seed=4)
    jf, tf = _packs(mat, 128, "int8")
    y = tbe.block_ell_spmm(tf, x, precision="int8", method=method).numpy()
    want, scale = _ref(mat, x)
    np.testing.assert_allclose(y, np.asarray(jbe.block_ell_spmm(jf, x, precision="int8")),
                               rtol=1e-6, atol=1e-5)
    assert (np.abs(y - want) / np.maximum(scale, 1e-30)).max() < 4e-2
    assert tf.blkvals.numel() * 4 == tbe.pack_block_ell(mat, device="cpu").blkvals.nbytes


def test_block_ell_int8_arithmetic_exact():
    # the int8 . int8 -> int32 product is exact: Y equals a float64
    # recomputation from the dequantized planes (tests/test_block_ell.py:76)
    rng = np.random.default_rng(3)
    mat, _ = _case(seed=3)
    x = rng.standard_normal((mat.shape[1], 16)).astype(np.float32)
    fmt = tbe.pack_block_ell(mat, bs=128, dtype=torch.int8, device="cpu")
    y = tbe.block_ell_spmm(fmt, x).numpy()
    q = fmt.blkvals.double().numpy()
    rs = fmt.row_scale.double().numpy()
    blkcol = fmt.blkcol.numpy()
    a_deq = np.zeros((fmt.mb * fmt.bs, 4 * fmt.bs))
    for i in range(fmt.mb):
        for j in range(fmt.bmax):
            a_deq[i * 128:(i + 1) * 128, blkcol[i, j] * 128:(blkcol[i, j] + 1) * 128] += \
                q[i, j] * rs[i][:, None]
    xa = np.abs(x).max(axis=0)
    xs = np.where(xa > 0, xa / 127.0, 1.0).astype(np.float64)
    want = a_deq[:mat.shape[0]] @ (np.clip(np.rint(x / xs), -127, 127) * xs)
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-5)
    # and the plain integer product itself equals an int64 einsum
    xq = torch.randint(-127, 128, (4 * 128, 16), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(0))
    got = tbe.bell_rows_plain(fmt.blkcol, fmt.blkvals, fmt.nb_p, xq, mode="int8")
    gx = xq.long().view(4, 128, 16)[fmt.blkcol.long()]
    ref = torch.einsum("ijab,ijbk->iak", fmt.blkvals.long(), gx).reshape(-1, 16)
    assert got.dtype == torch.int32 and torch.equal(got.long(), ref)


def test_block_ell_precision_guards():
    mat, x = _case(k=8, seed=6)
    fmt = tbe.pack_block_ell(mat, bs=128, device="cpu")
    with pytest.raises(AssertionError, match="int8-packed"):
        tbe.block_ell_spmm(fmt, x, precision="int8")
    with pytest.raises(AssertionError):
        tbe.block_ell_spmm(fmt, x, precision="fp16")
    with pytest.raises(ValueError, match="method"):
        tbe.block_ell_spmm(fmt, x, method="dense")


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("bs,density,seed", [(128, 0.3, 2), (64, 0.2, 0), (256, 0.5, 7),
                                             (128, 0.0, 1)])
def test_bell_work_covers_each_real_block_once(bs, density, seed, dtype):
    # the kernel's work items: each (row-block, real block) in exactly one
    # item, runs of at most ITEM_STEPS depth steps (128 values a step in
    # int8, 64 else), no item for an empty row-block, and `alone` where the
    # item is its row-block's only one
    mat, _ = _case(m=1024, n=768, bs=128, density=density, seed=seed)
    fmt = tbe.pack_block_ell(mat, bs=bs, dtype=DTYPES[dtype][1], device="cpu")
    work, nb = fmt.work.numpy(), fmt.nb_p.numpy()
    assert work.shape[1] == 4 and work.dtype == np.int32
    int8 = dtype == "int8"
    np.testing.assert_array_equal(work, tbe.bell_work(nb, bs, int8=int8))
    step = tbe.INT8_DEPTH_STEP if int8 else tbe.DEPTH_STEP
    per = max(1, tbe.ITEM_STEPS // -(-bs // step))
    seen = np.zeros((fmt.mb, fmt.bmax), np.int64)
    for i, j0, j1, alone in work:
        assert 0 <= j0 < j1 <= nb[i] and j1 - j0 <= per
        seen[i, j0:j1] += 1
        assert alone == (np.count_nonzero(work[:, 0] == i) == 1)
    np.testing.assert_array_equal(seen, np.arange(fmt.bmax)[None, :] < nb[:, None])
    assert not np.isin(np.nonzero(nb == 0)[0], work[:, 0]).any()


def _items_sum(fmt, x, mode):
    """y as the kernel builds it: for each work item, its run of blocks
    summed on its own, the runs of a row-block then added into the zeroed
    y (float64 for the float modes, int64 for int8)."""
    wide = torch.int64 if mode == "int8" else torch.float64
    a, xv = fmt.blkvals.to(wide), x.to(wide)
    if mode == "bf16":
        a, xv = fmt.blkvals.bfloat16().double(), x.bfloat16().double()
    bs, k = fmt.bs, x.shape[1]
    y = torch.zeros((fmt.mb * bs, k), dtype=wide)
    for i, j0, j1, _ in fmt.work.tolist():
        part = torch.zeros((bs, k), dtype=wide)
        for j in range(j0, j1):
            c = int(fmt.blkcol[i, j])
            part += a[i, j] @ xv[c * bs:(c + 1) * bs]
        y[i * bs:(i + 1) * bs] += part
    return y


@pytest.mark.parametrize("mode,dtype", [("fp32", "fp32"), ("bf16", "bf16"), ("bf16", "fp32"),
                                        ("fp32", "bf16"), ("int8", "int8")])
@pytest.mark.parametrize("bs", [64, 128])
def test_bell_items_sum_equals_plain(mode, dtype, bs):
    mat, x = _case(m=512, n=768, bs=128, density=0.6, k=12, seed=3)
    fmt = tbe.pack_block_ell(mat, bs=bs, dtype=DTYPES[dtype][1], device="cpu")
    assert (fmt.work[:, 3] == 0).any()                    # row-blocks shared by items
    if mode == "int8":
        xt = torch.randint(-127, 128, (768, 12), dtype=torch.int8,
                           generator=torch.Generator().manual_seed(1))
        got = _items_sum(fmt, xt, mode)
        want = tbe.bell_rows_plain(fmt.blkcol, fmt.blkvals, fmt.nb_p, xt, mode=mode)
        assert torch.equal(got, want.long())
        return
    xt = torch.from_numpy(x)
    got = _items_sum(fmt, xt, mode)
    want = tbe.bell_rows_plain(fmt.blkcol, fmt.blkvals, fmt.nb_p, xt, mode=mode)
    scale = tbe.bell_rows_plain(fmt.blkcol, fmt.blkvals.abs(), fmt.nb_p, xt.abs(), mode=mode)
    assert float(((got - want.double()).abs() / scale.double().clamp(min=1)).max()) <= 1e-5


@pytest.mark.parametrize("k,bs,m,n", [(1, 128, 384, 512), (37, 64, 300, 450),
                                      (256, 128, 512, 384)])
def test_bell_int8_transposed_quantization_matches_jax(k, bs, m, n):
    # the port quantizes X into X^T (the kernel's K-major int8 operand) and
    # hands the product its transposed view: the same int32 dot and rescale
    # as _bell_xla_int8 on the JAX side
    mat, x = _case(m=m, n=n, bs=128, density=0.3, k=k, seed=8)
    jf, tf = _packs(mat, bs, "int8")
    xp = np.zeros((-(-n // bs) * bs, k), np.float32)
    xp[:n] = x
    want = np.asarray(jbe._bell_xla_int8(jf.blkcol, jf.blkvals, jf.row_scale, xp, bs=bs))
    got = tbe.bell_int8(tf, torch.from_numpy(xp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1))
    y = tbe.block_ell_spmm(tf, x, precision="int8").numpy()
    np.testing.assert_allclose(y, want[:m], rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1))
