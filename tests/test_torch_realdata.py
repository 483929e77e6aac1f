"""tpusparse_torch.io.realdata against the JAX package's extractors on the
CPU, at tests/test_realdata.py's caps: the same matrices from the same
files, and the same trained and pruned weight."""

import numpy as np
import pytest
import torch

from tpusparse.io import realdata as jrd
from tpusparse_torch.io import realdata as trd
from tpusparse_torch.io.mtx import CooMatrix


def _same(got, want):
    assert isinstance(got, CooMatrix)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)
    assert got.vals.dtype == want.vals.dtype


@pytest.mark.parametrize("name,kwargs", [
    ("cooccurrence_coo", dict(vocab_size=512, max_files=25)),
    ("docterm_coo", dict(vocab_size=512, max_files=40)),
    ("import_graph_coo", dict(max_files=400)),
])
def test_extractor_equals_jax(name, kwargs):
    got = getattr(trd, name)(**kwargs)
    _same(got, getattr(jrd, name)(**kwargs))
    assert got.nnz > 100


def test_trained_pruned_weight_equals_jax():
    kw = dict(d_model=64, d_ff=128, steps=8, seq=64, batch=2, sparsity=0.9)
    state = torch.random.get_rng_state()
    w, meta = trd.trained_pruned_weight(device="cpu", **kw)
    # the seed is the function's own: the global generator is left as it was
    assert torch.equal(torch.random.get_rng_state(), state)
    jw, jmeta = jrd.trained_pruned_weight(**kw)
    assert w.shape == jw.shape == (128, 64)
    np.testing.assert_array_equal(w.rows, jw.rows)
    np.testing.assert_array_equal(w.cols, jw.cols)
    np.testing.assert_allclose(w.vals, jw.vals, rtol=0, atol=1e-6)
    assert meta["shape"] == jmeta["shape"] and meta["steps"] == jmeta["steps"]
    for key in ("loss_first", "loss_last", "sparsity"):
        assert meta[key] == pytest.approx(jmeta[key], abs=1e-6)
    assert meta["loss_last"] < meta["loss_first"]  # it trained


def test_trained_pruned_weight_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trd.trained_pruned_weight(d_model=64, d_ff=128, steps=1, seq=64, batch=2)
