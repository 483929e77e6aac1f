"""tpusparse_torch.spgemm against the JAX package's spgemm and scipy on the
CPU: the tiled device route (A packed once, B's column tiles densified,
multiplied and re-sparsified), the runner cache, the tuned plan of A, the
host route and its crossover, and products with no nonzero on a side."""

import numpy as np
import pytest

from tpusparse import spgemm as jspgemm
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse_torch import spgemm as tsp
from tpusparse_torch.io import builder
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.oracle import spgemm_reference


def _jax(mat):
    return JCoo(mat.rows, mat.cols, mat.vals, mat.shape)


def _close(c, want):
    np.testing.assert_allclose(c.to_dense(np.float64), want.to_dense(np.float64),
                               rtol=1e-4, atol=1e-4)


def _dense64(c):
    return np.asarray(c.to_dense(np.float64))


@pytest.mark.parametrize("method", ["device", "host", "auto"])
def test_spgemm_matches_scipy_and_jax(method):
    a = builder.power_law_coo(120, 90, avg_nnz_per_row=5.0, seed=1)
    b = builder.power_law_coo(90, 150, avg_nnz_per_row=4.0, seed=2)
    c = tsp.spgemm(a, b, method=method, device="cpu")
    want = spgemm_reference(a, b)
    _close(c, want)
    np.testing.assert_allclose(_dense64(c), _dense64(jspgemm.spgemm(_jax(a), _jax(b),
                                                                   method=method)),
                               rtol=1e-4, atol=1e-4)
    # structural zeros must not appear: the pattern is scipy's
    assert c.is_row_major_sorted()
    got_d, want_d = _dense64(c), _dense64(want)
    assert np.all((got_d != 0) <= ((want_d != 0) | (np.abs(got_d) < 1e-6)))


def test_spgemm_tiled():
    a = builder.uniform_coo(64, 80, nnz_per_row=6, seed=3)
    b = builder.uniform_coo(80, 700, nnz_per_row=3, seed=4)
    c = tsp.spgemm(a, b, tile_cols=256, method="device", device="cpu")
    _close(c, spgemm_reference(a, b))
    jc = jspgemm.spgemm(_jax(a), _jax(b), tile_cols=256, method="device")
    np.testing.assert_allclose(_dense64(c), _dense64(jc), rtol=1e-4, atol=1e-4)
    assert c.nnz == jc.nnz


def test_spgemm_runner_reuse():
    # spgemm_fn builds once; the runner handles B's of different widths and
    # patterns, and the spgemm() wrapper hits the cache keyed by A's hash
    a = builder.power_law_coo(100, 96, avg_nnz_per_row=5.0, seed=11)
    run = tsp.spgemm_fn(a, tile_cols=64, device="cpu")
    for seed, p in ((12, 130), (13, 70)):
        b = builder.power_law_coo(96, p, avg_nnz_per_row=4.0, seed=seed)
        c = run(b)
        _close(c, spgemm_reference(a, b))
        assert run.last_stats["tiles"] == -(-p // 64) and run.last_stats["nnz"] == c.nnz
    tsp._RUNNER_CACHE.clear()
    b = builder.power_law_coo(96, 130, avg_nnz_per_row=4.0, seed=12)
    tsp.spgemm(a, b, tile_cols=64, method="device", device="cpu")
    n_runners = len(tsp._RUNNER_CACHE)
    tsp.spgemm(a, b, tile_cols=64, method="device", device="cpu")  # same A: cached runner
    assert n_runners == 1 and len(tsp._RUNNER_CACHE) == 1
    # the auto route on this tiny product is the host's (the crossover)
    assert tsp.spgemm_flops(a, b) < tsp.HOST_CROSSOVER_FLOPS
    assert tsp.spgemm_flops(a, b) == jspgemm.spgemm_flops(_jax(a), _jax(b))
    tsp._RUNNER_CACHE.clear()


@pytest.mark.parametrize("change", ["every value", "past the first 4096 entries"])
def test_spgemm_cache_tells_values_apart(change):
    # two A's of one shape and nnz: each product is its own A's, though the
    # first A's runner is cached when the second comes
    a1 = builder.power_law_coo(1200, 1000, avg_nnz_per_row=5.0, seed=21)
    assert a1.nnz > 4096
    vals = np.array(a1.vals, dtype=np.float64)
    if change == "every value":
        vals = 2.0 * vals + 1.0
    else:
        vals[4096:] = -vals[4096:] + 0.5
    a2 = CooMatrix(a1.rows, a1.cols, vals, a1.shape)
    b = builder.power_law_coo(1000, 90, avg_nnz_per_row=4.0, seed=22)
    tsp._RUNNER_CACHE.clear()
    c1 = tsp.spgemm(a1, b, tile_cols=64, method="device", device="cpu")
    c2 = tsp.spgemm(a2, b, tile_cols=64, method="device", device="cpu")
    _close(c1, spgemm_reference(a1, b))
    _close(c2, spgemm_reference(a2, b))
    assert not np.allclose(_dense64(c1), _dense64(c2))
    assert len(tsp._RUNNER_CACHE) == 2
    tsp._RUNNER_CACHE.clear()


def test_spgemm_tuned_a_plan(tmp_path):
    from tpusparse_torch.config import config_override

    a = builder.power_law_coo(120, 90, avg_nnz_per_row=5.0, seed=5)
    b = builder.power_law_coo(90, 150, avg_nnz_per_row=4.0, seed=6)
    with config_override(cache_dir=str(tmp_path)):
        c = tsp.spgemm(a, b, tune_a=True, tune_budget=2, method="device", device="cpu")
    _close(c, spgemm_reference(a, b))
    tsp._RUNNER_CACHE.clear()


def test_spgemm_device_resparsify_matches_dense():
    a = builder.power_law_coo(150, 120, avg_nnz_per_row=4.0, seed=5)
    b = builder.power_law_coo(120, 200, avg_nnz_per_row=4.0, seed=6)
    c = tsp.spgemm(a, b, tile_cols=64, method="device", device="cpu")
    want = a.to_dense(np.float64) @ b.to_dense(np.float64)
    np.testing.assert_allclose(_dense64(c), want, rtol=1e-4, atol=1e-5)
    jc = jspgemm.spgemm(_jax(a), _jax(b), tile_cols=64, method="device")
    np.testing.assert_allclose(_dense64(c), _dense64(jc), rtol=1e-4, atol=1e-4)
    tsp._RUNNER_CACHE.clear()


def test_spgemm_threshold_drops_small_entries():
    a = builder.power_law_coo(80, 60, avg_nnz_per_row=5.0, seed=7)
    b = builder.power_law_coo(60, 90, avg_nnz_per_row=4.0, seed=8)
    full = spgemm_reference(a, b)
    thr = float(np.median(np.abs(full.vals)))
    for method in ("device", "host"):
        c = tsp.spgemm(a, b, threshold=thr, method=method, device="cpu")
        assert np.all(np.abs(c.vals) > thr)
        assert c.nnz == int((np.abs(full.vals) > thr).sum())
    tsp._RUNNER_CACHE.clear()


def _empty(m, n):
    return CooMatrix(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0), (m, n))


@pytest.mark.parametrize("side", ["a", "b", "both"])
@pytest.mark.parametrize("method", ["device", "host"])
def test_spgemm_with_no_nonzero_on_a_side(side, method):
    a = builder.power_law_coo(70, 50, avg_nnz_per_row=4.0, seed=9)
    b = builder.power_law_coo(50, 90, avg_nnz_per_row=3.0, seed=10)
    if side in ("a", "both"):
        a = _empty(70, 50)
    if side in ("b", "both"):
        b = _empty(50, 90)
    c = tsp.spgemm(a, b, method=method, device="cpu")
    assert c.shape == (70, 90) and c.nnz == 0
    assert c.rows.dtype == c.cols.dtype == np.int64
    tsp._RUNNER_CACHE.clear()


def test_spgemm_product_that_cancels_to_no_nonzero():
    # A's two columns cancel on B's single row pattern: C is structurally
    # nonzero but numerically zero, and the device route drops exact zeros
    a = CooMatrix(np.array([0, 0]), np.array([0, 1]), np.array([1.0, -1.0]), (3, 2))
    b = CooMatrix(np.array([0, 1]), np.array([4, 4]), np.array([2.0, 2.0]), (2, 6))
    c = tsp.spgemm(a, b, method="device", device="cpu")
    assert c.shape == (3, 6) and c.nnz == 0
    tsp._RUNNER_CACHE.clear()
