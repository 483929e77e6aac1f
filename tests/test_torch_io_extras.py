"""The port's CooMatrix torch conversions, narrow_dtype and
detect_compression against the JAX package's on the CPU: from_torch over
dense, COO, CSR and CSC tensors, to_torch, the CSR tensor that the
cuSPARSE yardstick multiplies by, the integer narrowing over signed and
unsigned ranges, and the closed forms of index compression."""

import numpy as np
import pytest
import torch

import tpusparse
import tpusparse_torch
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.meta.item import narrow_dtype as jnarrow
from tpusparse.transforms.compress import detect_compression as jdetect
from tpusparse_torch.io import builder
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.meta.item import narrow_dtype
from tpusparse_torch.transforms.compress import CompressInfo, detect_compression


def _weight():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    w[rng.random(w.shape) < 0.8] = 0.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("layout", ["dense", "coo", "coo_uncoalesced", "csr", "csc"])
def test_from_torch_equals_jax(layout):
    w = _weight()
    t = {"dense": lambda: w, "coo": w.to_sparse_coo, "csr": w.to_sparse_csr,
         "csc": w.to_sparse_csc,
         # a duplicated entry: both packages sum it
         "coo_uncoalesced": lambda: torch.sparse_coo_tensor(
             torch.cat([w.to_sparse_coo().indices(), w.to_sparse_coo().indices()[:, :3]], 1),
             torch.cat([w.to_sparse_coo().values(), w.to_sparse_coo().values()[:3]]),
             size=w.shape)}[layout]()
    got, want = CooMatrix.from_torch(t), JCoo.from_torch(t)
    assert got.shape == want.shape == (40, 24)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.is_row_major_sorted()


def test_to_torch_equals_jax():
    m = builder.power_law_coo(60, 50, avg_nnz_per_row=4.0, seed=2)
    jm = JCoo(m.rows, m.cols, m.vals, m.shape)
    got, want = m.to_torch(device="cpu"), jm.to_torch()
    assert got.layout == want.layout == torch.sparse_coo and got.is_coalesced()
    assert got.dtype == want.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got.indices(), want.indices())
    assert torch.equal(got.values(), want.values())
    assert torch.equal(got.to_dense(), torch.from_numpy(m.to_dense(np.float32)))
    back = CooMatrix.from_torch(got)
    np.testing.assert_array_equal(back.rows, m.rows)
    np.testing.assert_array_equal(back.vals, m.vals.astype(np.float32))


def test_to_csr_tensor_is_the_matrix():
    m = builder.power_law_coo(70, 90, avg_nnz_per_row=5.0, seed=6)
    shuffled = np.random.default_rng(1).permutation(m.nnz)  # entries in any order
    m = CooMatrix(m.rows[shuffled], m.cols[shuffled], m.vals[shuffled], m.shape)
    csr = m.to_csr_tensor(device="cpu")
    assert csr.layout == torch.sparse_csr and csr.dtype == torch.float32
    assert torch.equal(csr.crow_indices(), torch.from_numpy(
        CooMatrix(m.rows, m.cols, m.vals, m.shape).sort_row_major().to_csr_ptr()))
    crow, col = csr.crow_indices().numpy(), csr.col_indices().numpy()
    for r in range(m.shape[0]):
        assert np.all(np.diff(col[crow[r]:crow[r + 1]]) > 0)  # each row in column order
    assert torch.equal(csr.to_dense(), torch.from_numpy(m.to_dense(np.float32)))
    assert m.to_csr_tensor(device="cpu", dtype=torch.bfloat16).dtype == torch.bfloat16


def test_conversions_want_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = builder.power_law_coo(20, 20, avg_nnz_per_row=2.0, seed=1)
    for conv in (m.to_torch, m.to_csr_tensor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            conv()


NARROW_CASES = {
    "int8": np.array([-128, 0, 127]),
    "int16": np.array([-129, 5]),
    "int16_hi": np.array([0, 128]),
    "int32": np.array([-40000, 40000]),
    "int64": np.array([0, 2**40]),
    "uint8": np.array([0, 255]),
    "uint16": np.array([0, 256, 65535]),
    "uint32": np.array([3, 70000]),
    "negative_unsigned": np.array([-1, 200]),
    "empty": np.array([], dtype=np.int64),
    "float": np.array([1.5, -2.0]),
}


@pytest.mark.parametrize("case", sorted(NARROW_CASES))
@pytest.mark.parametrize("allow_unsigned", [False, True])
@pytest.mark.parametrize("min_bits", [8, 16])
def test_narrow_dtype_equals_jax(case, allow_unsigned, min_bits):
    a = NARROW_CASES[case]
    got = narrow_dtype(a, allow_unsigned=allow_unsigned, min_bits=min_bits)
    want = jnarrow(a, allow_unsigned=allow_unsigned, min_bits=min_bits)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_all_holds_every_jax_name():
    assert set(tpusparse.__all__) <= set(tpusparse_torch.__all__)
    assert tpusparse_torch.narrow_dtype is narrow_dtype


COMPRESS_CASES = {
    "constant": np.full(9, 7),
    "linear": 3 + 4 * np.arange(12),
    "branch": np.repeat([5, 1, 9], [4, 3, 5]),
    "cycle_linear": 2 + 3 * (np.arange(24) % 6),
    "cycle_increase": 1 + 2 * (np.arange(40) // 4),
    "none": np.random.default_rng(0).integers(0, 100, 30),
    "float": np.linspace(0, 1, 8),
}


@pytest.mark.parametrize("case", sorted(COMPRESS_CASES))
def test_detect_compression_equals_jax(case):
    a = COMPRESS_CASES[case]
    got, want = detect_compression(a), jdetect(a)
    assert isinstance(got, CompressInfo)
    assert (got.kind, got.base, got.step, got.cycle, got.bounds, got.values) == \
        (want.kind, want.base, want.step, want.cycle, want.bounds, want.values)
    if case in ("constant", "linear", "branch", "cycle_linear", "cycle_increase"):
        assert got.kind == case
        np.testing.assert_array_equal(got.evaluate(np.arange(a.size)), a)
