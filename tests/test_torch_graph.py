"""tpusparse_torch.graph against the JAX package's graph module on the CPU:
the semiring SpMV, matvec_plan's choice, the four drivers on a path graph,
a graph with unreachable and isolated vertices and a power-law graph, the
graph modes of read_mtx and the config hooks."""

import io

import numpy as np
import pytest
import torch

from tpusparse import graph as jg
from tpusparse.config import config_override as jconfig_override
from tpusparse.io import mtx as jmtx
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.oracle import spmm_reference as jspmm_reference
from tpusparse_torch import graph as tg
from tpusparse_torch.config import config_override, get_config
from tpusparse_torch.gates import TPU_GATES
from tpusparse_torch.io import builder
from tpusparse_torch.io.mtx import CooMatrix, read_mtx, write_mtx
from tpusparse_torch.oracle import spmm_reference


def _path_graph(n):
    """Directed path 0->1->...->n-1 in push orientation ((u, v) = edge v->u)."""
    src = np.arange(n - 1, dtype=np.int64)
    return CooMatrix(src + 1, src, np.ones(n - 1), (n, n)).sort_row_major()


def _islands():
    """Two disjoint paths (0..5 and 7->8->9) and isolated vertices 6, 10-13."""
    g = _path_graph(6)
    rows = np.concatenate([g.rows, [8, 9]])
    cols = np.concatenate([g.cols, [7, 8]])
    return CooMatrix(rows, cols, np.full(rows.size, 1.5), (14, 14)).sort_row_major()


GRAPHS = {"path": lambda: _path_graph(12), "islands": _islands,
          "power_law": lambda: builder.power_law_coo(300, 300, 6.0, seed=3)}


def _jax(mat):
    return JCoo(mat.rows, mat.cols, mat.vals, mat.shape)


def _weighted(mat):
    """SSSP's nonnegative weights: |vals|."""
    return CooMatrix(mat.rows, mat.cols, np.abs(np.asarray(mat.vals, np.float64)), mat.shape)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "or_and"])
def test_semiring_spmv_equals_jax_and_oracle(semiring):
    mat = _islands() if semiring == "min_plus" else builder.power_law_coo(200, 160, 6.0, seed=3)
    rng = np.random.default_rng(1)
    x = (rng.random(mat.shape[1]) > 0.5) if semiring == "or_and" else \
        rng.standard_normal(mat.shape[1])
    got = tg.semiring_spmv(mat, x, semiring, device="cpu").numpy()
    want = np.asarray(jg.semiring_spmv(_jax(mat), x, semiring))
    oracle = spmm_reference(mat, x, semiring=semiring)
    np.testing.assert_array_equal(oracle, jspmm_reference(_jax(mat), x, semiring=semiring))
    if semiring == "or_and":
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)
        return
    assert np.array_equal(np.isinf(got), np.isinf(want))  # empty rows: +inf under min_plus
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[fin], oracle[fin], rtol=1e-5, atol=1e-5)


def test_semiring_spmv_takes_the_config_semiring():
    mat = _islands()
    x = np.arange(14, dtype=np.float64)
    with config_override(semiring="min_plus"):
        got = tg.semiring_spmv(mat, x, device="cpu").numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(spmm_reference(mat, x, "min_plus")))


@pytest.mark.parametrize("semiring", ["plus_times", "or_and", "min_plus"])
@pytest.mark.parametrize("shape", [(300, 300), (40, 1_600_000)])
def test_matvec_plan_meta_and_product_equal_jax(semiring, shape):
    m, n = shape
    mat = builder.power_law_coo(m, n, avg_nnz_per_row=6.0 if n < 10**6 else 2.0, seed=2)
    fn = tg.matvec_plan(mat, semiring=semiring, device="cpu", gates=TPU_GATES)
    jfn = jg.matvec_plan(_jax(mat), semiring=semiring)
    assert fn.meta == jfn.meta
    # x > 4 MB of fp32 at n = 1.6M: past the TPU-derived gate, the segment path
    assert fn.meta["method"] == ("dg" if n * 4 <= TPU_GATES.dg_x_bytes
                                 and semiring != "min_plus" else "segment")
    x = np.abs(np.random.default_rng(0).standard_normal(n)).astype(np.float32)
    if semiring == "or_and":
        x = (x > 1.0).astype(np.float32)
    got = fn(torch.from_numpy(x)).numpy()
    want = np.asarray(jfn(x))
    if semiring == "or_and":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)  # JAX's dg is fp32x2


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bfs_and_cc_exactly_equal_jax(graph):
    mat = GRAPHS[graph]()
    run, jrun = tg.bfs_fn(mat, device="cpu"), jg.bfs_fn(_jax(mat))
    for source in (0, mat.shape[0] // 2):
        (level, it), (jlevel, jit) = run(source), jrun(source)
        assert level.dtype == torch.int32 and it == int(jit)
        np.testing.assert_array_equal(level.numpy(), np.asarray(jlevel))
    np.testing.assert_array_equal(tg.bfs(mat, source, device="cpu"), level.numpy())
    np.testing.assert_array_equal(tg.connected_components(mat, device="cpu"),
                                  np.asarray(jg.connected_components(_jax(mat))))


def test_bfs_and_cc_on_islands():
    level = tg.bfs(_islands(), 0, device="cpu")
    np.testing.assert_array_equal(level[:6], np.arange(6))
    assert (level[6:] == -1).all()
    label = tg.connected_components(_islands(), device="cpu")
    np.testing.assert_array_equal(label, [0] * 6 + [6, 7, 7, 7, 10, 11, 12, 13])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sssp_within_1e6_of_jax(graph):
    mat = _weighted(GRAPHS[graph]())
    got = tg.sssp(mat, 0, device="cpu")
    want = np.asarray(jg.sssp(_jax(mat), 0))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)
    _, it = tg.sssp_fn(mat, device="cpu")(0)
    _, jit = jg.sssp_fn(_jax(mat))(0)
    assert it == int(jit)


def _pagerank64_steps(mat, damping=0.85):
    """Float64 power iteration with the drivers' dangling rule: yields
    (iteration count, ranks, L1 delta of that iteration)."""
    n = mat.shape[0]
    deg = np.bincount(mat.cols, minlength=n).astype(np.float64)
    w = 1.0 / deg[mat.cols]
    r = np.full(n, 1.0 / n)
    for it in range(1, 101):
        spread = np.zeros(n)
        np.add.at(spread, mat.rows, w * r[mat.cols])
        nxt = (1 - damping) / n + damping * (spread + r[deg == 0].sum() / n)
        yield it, nxt, np.abs(nxt - r).sum()
        r = nxt


def _pagerank64(mat, iters):
    return next(r for it, r, _ in _pagerank64_steps(mat) if it == iters)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pagerank_within_1e6_of_jax(graph):
    mat = GRAPHS[graph]()
    # tol = 0: a fixed count of iterations on both sides
    r, it = tg.pagerank_fn(mat, tol=0.0, max_iter=15, device="cpu")()
    jr, jit = jg.pagerank_fn(_jax(mat), tol=0.0, max_iter=15)()
    assert r.dtype == torch.float32 and it == 15
    # JAX's dg kernel splits x and the values into bf16 hi/lo (fp32x2), so
    # its ranks sit up to 1.2e-5 of a rank from float64; the port's sum in
    # fp32 is held to float64 at 1e-6, and to JAX at JAX's own error
    np.testing.assert_allclose(r.numpy(), _pagerank64(mat, it), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=2e-5, atol=1e-6)
    # the default tol: the stop test reads an fp32 L1 delta, which JAX's
    # fp32x2 error keeps above tol for up to four more iterations (43 against
    # 39 on the path graph); the port stops where float64 stops, and its
    # ranks are compared with JAX's, not its count
    r, it = tg.pagerank_fn(mat, device="cpu")()
    jr, _ = jg.pagerank_fn(_jax(mat))()
    assert it == next(k for k, _, delta in _pagerank64_steps(mat) if delta <= 1e-6)
    np.testing.assert_allclose(r.numpy(), _pagerank64(mat, it), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(tg.pagerank(mat, device="cpu"), r.numpy())


def test_pagerank_uniform_on_cycle():
    n = 8
    src = np.arange(n, dtype=np.int64)
    mat = CooMatrix((src + 1) % n, src, np.ones(n), (n, n)).sort_row_major()
    r = tg.pagerank(mat, tol=1e-10, device="cpu")
    np.testing.assert_allclose(r, np.full(n, 1.0 / n), rtol=1e-4)


@pytest.mark.parametrize("mode", [None, "bfs", "pr", "cc"])
def test_read_mtx_graph_modes_equal_jax(mode, tmp_path):
    mat = builder.power_law_coo(60, 60, avg_nnz_per_row=4.0, seed=6)
    dup = CooMatrix(np.concatenate([mat.rows, mat.rows[:5]]),
                    np.concatenate([mat.cols, mat.cols[:5]]),
                    np.concatenate([mat.vals, mat.vals[:5]]), mat.shape)  # cc dedups
    path = tmp_path / "g.mtx"
    write_mtx(path, dup)
    want = jmtx.read_mtx(str(path), graph_mode=mode)
    by_path = read_mtx(path, graph_mode=mode)
    by_file = read_mtx(io.StringIO(path.read_text()), graph_mode=mode)
    for got in (by_path, by_file):
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.rows, want.rows)
        np.testing.assert_array_equal(got.cols, want.cols)
        np.testing.assert_array_equal(got.vals, want.vals)


def test_graph_config_hooks_equal_jax(tmp_path):
    assert (get_config().performance_flag, get_config().semiring, get_config().graph_algorithm,
            get_config().graph_max_iter) == ("throughput", "plus_times", "none", 100)
    mat = _path_graph(10)
    path = tmp_path / "p.mtx"
    write_mtx(path, mat)
    kw = dict(performance_flag="graph", graph_algorithm="bfs", graph_max_iter=3)
    with config_override(**kw), jconfig_override(**kw):
        level = tg.bfs(mat, 0, device="cpu")  # max_iter truncates the traversal
        np.testing.assert_array_equal(level, np.asarray(jg.bfs(_jax(mat), 0)))
        assert level.max() == 3 and np.sum(level >= 0) == 4
        got, want = read_mtx(path), jmtx.read_mtx(str(path))  # the loader transposes
        np.testing.assert_array_equal(got.rows, want.rows)
        np.testing.assert_array_equal(got.rows, mat.cols)


def test_coo_scipy_round_trip_and_csr_ptr():
    mat = builder.power_law_coo(50, 40, avg_nnz_per_row=3.0, seed=1)
    back = CooMatrix.from_scipy(mat.to_scipy().tocsr())
    np.testing.assert_array_equal(back.rows, mat.rows)
    np.testing.assert_array_equal(back.cols, mat.cols)
    np.testing.assert_array_equal(mat.to_csr_ptr(), _jax(mat).to_csr_ptr())
