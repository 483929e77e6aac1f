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
from tpusparse_torch.kernels.span_gather import pack_span, with_values
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


# ------------------------------------------------------------------ tile index
# On the card #14 samples through the pattern's tile index: the (dY_slots
# row, X column) space cut into tiles of TILE_ROWS x TILE_COLS, every
# walked slot listed once by tile, the tiles that hold at least
# TILE_MIN_SLOTS slots computed whole (tensor cores) and sampled, the rest
# one dot product a slot.  ``sddmm_tiles_plain`` is that function tile by
# tile in plain PyTorch.

def _two_density_mat(m=320, n=192, seed=24):
    """Rows [0, 128) 30 % dense (about 2500 slots a tile of 128 x 64), the
    rest 1 %: in blocks of rows (balance=False) its tiles take both paths."""
    rng = np.random.default_rng(seed)
    keep = rng.random((m, n)) < np.where(np.arange(m)[:, None] < 128, 0.3, 0.01)
    rows, cols = np.nonzero(keep)
    return JCoo(rows, cols, rng.standard_normal(rows.size).astype(np.float32), (m, n))


_PATTERNS = {
    "two_densities": (_two_density_mat, dict(rb=128, ct=128, g=64, balance=False)),
    "pruned_weight": (lambda: jbuilder.pruned_weight_coo(256, 192, sparsity=0.9, seed=3),
                      dict(rb=128, ct=128, g=64)),
    "power_law": (lambda: jbuilder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0),
                  dict(rb=64, ct=128, g=64)),
}


def _walked(tfmt):
    return (torch.arange(tfmt.n_chunks).view(1, -1, 1)
            < tfmt.nc_p.reshape(-1, 1, 1)).expand(tuple(tfmt.cols.shape))


@pytest.mark.parametrize("pattern,min_slots", [("two_densities", None), ("pruned_weight", None),
                                               ("power_law", None), ("power_law", 1),
                                               ("two_densities", 10 ** 9)])
def test_tile_index_covers_every_walked_slot(pattern, min_slots):
    make, kw = _PATTERNS[pattern]
    jmat = make()
    tfmt = pack_span(_tmat(jmat), keep_perm=True, device="cpu", **kw)
    planes = (tfmt.c0, tfmt.cols, tfmt.lrow, tfmt.nc_p)
    tiles = sddmm.sddmm_tiles(tfmt)
    assert sddmm.sddmm_tiles(tfmt) is tiles and tfmt.tiles is tiles
    # every slot of a walked chunk exactly once, padding included
    slot, row, col = tiles.slot.long(), tiles.row.long(), tiles.col.long()
    np.testing.assert_array_equal(np.sort(slot.numpy()),
                                  np.flatnonzero(_walked(tfmt).reshape(-1).numpy()))
    c, r, _ = sddmm.slot_rows_cols(*planes, tfmt.rb)
    np.testing.assert_array_equal(row.numpy(), r[slot].numpy())
    np.testing.assert_array_equal(col.numpy(), c[slot].numpy())
    # the tiles by falling count, each a contiguous range within its bounds,
    # slots rising, every hit tile once
    t = tiles.tiles.long()
    np.testing.assert_array_equal((t[:, 3] - t[:, 2]).numpy(), tiles.counts)
    assert bool((t[1:, 2] == t[:-1, 3]).all()) and int(t[-1, 3]) == tiles.n_slots
    assert bool((np.diff(tiles.counts) <= 0).all())
    assert len(set(map(tuple, t[:, :2].tolist()))) == tiles.n_hit_tiles
    for r0, c0, lo, hi in t.tolist():
        assert bool(((row[lo:hi] >= r0) & (row[lo:hi] < r0 + sddmm.TILE_ROWS)).all())
        assert bool(((col[lo:hi] >= c0) & (col[lo:hi] < c0 + sddmm.TILE_COLS)).all())
        assert bool((slot[lo + 1:hi] > slot[lo:hi - 1]).all())
    # the dense tiles at a threshold: a prefix of the tiles and of the lists
    if min_slots is None:
        min_slots = sddmm.TILE_MIN_SLOTS["fp32x2"]
    n_dense, d = tiles.dense(min_slots)
    assert bool((tiles.counts[:n_dense] >= min_slots).all())
    assert bool((tiles.counts[n_dense:] < min_slots).all())
    assert d == (int(t[n_dense - 1, 3]) if n_dense else 0)
    kinds = (d > 0, d < tiles.n_slots)
    assert kinds == {"two_densities": (min_slots < 10 ** 9, True),
                     "pruned_weight": (True, False),
                     "power_law": (min_slots == 1, min_slots > 1)}[pattern]


@pytest.mark.parametrize("pattern", list(_PATTERNS))
@pytest.mark.parametrize("precision", ["fp32x2", "bf16"])
@pytest.mark.parametrize("k", [8, 20])
def test_tile_plain_equals_rows_plain_and_jax(pattern, precision, k):
    # the tile kernel's function, tile by tile, at every slot: against the
    # port's per-slot plain version everywhere, and against the JAX
    # function at every slot of a walked chunk (past nc_p the JAX kernel
    # computes aliased indices; the port's contract is 0 there)
    make, kw = _PATTERNS[pattern]
    jmat = make()
    jfmt, tfmt = _formats(jmat, **kw)
    m, n = jmat.shape
    rng = np.random.default_rng(k)
    x = rng.standard_normal((n, k)).astype(np.float32)
    dy_slots = rng.standard_normal((tfmt.n_programs * tfmt.rb, k)).astype(np.float32)
    tiles = sddmm.sddmm_tiles(tfmt)
    if pattern == "two_densities":  # about 2500 slots a tile, or about 80
        assert 0 < tiles.dense(sddmm.TILE_MIN_SLOTS[precision])[1] < tiles.n_slots
    kp = -(-k // 8) * 8
    xt = torch.nn.functional.pad(torch.from_numpy(x), (0, kp - k))
    dyt = torch.nn.functional.pad(torch.from_numpy(dy_slots), (0, kp - k))
    planes = (tfmt.c0, tfmt.cols, tfmt.lrow, tfmt.nc_p)
    want = sddmm.sddmm_rows_plain(*planes, dyt, xt, rb=tfmt.rb, kt=8, mode=precision)
    scale = sddmm.sddmm_rows_plain(*planes, dyt.abs(), xt.abs(), rb=tfmt.rb, kt=8, mode="fp32")
    for min_slots in (1, None):  # every tile dense, then the mode's threshold
        got = sddmm.sddmm_tiles_plain(tiles, dyt, xt, mode=precision, min_slots=min_slots)
        got = got.view(tuple(tfmt.cols.shape))
        _within(got.numpy(), want.numpy(), scale.numpy(), TOL["fp32"])
    dv_j = np.asarray(jsddmm.span_sddmm(jfmt, jnp.asarray(dy_slots), jnp.asarray(x), ktile=8,
                                        precision=precision))
    walked = _walked(tfmt).numpy()
    tol = TOL["fp32"] if precision == "bf16" else TOL[precision]
    _within(got.numpy()[walked], dv_j[walked], scale.numpy()[walked], tol)


def test_tile_index_follows_its_planes():
    # kept on the format and carried by with_values (dv reads no values);
    # an index plane written in place gives a new index; the wrapper
    # refuses CPU tensors
    jmat = jbuilder.pruned_weight_coo(256, 192, sparsity=0.9, seed=5)
    tfmt = pack_span(_tmat(jmat), rb=128, ct=128, g=64, keep_perm=True, device="cpu")
    tiles = sddmm.sddmm_tiles(tfmt)
    new = with_values(tfmt, np.ones(jmat.nnz, np.float32))
    assert new.tiles is tiles and sddmm.sddmm_tiles(new) is tiles
    tfmt.lrow.add_(0)
    assert not tiles.built_from((tfmt.c0, tfmt.cols, tfmt.lrow, tfmt.nc_p))
    assert sddmm.sddmm_tiles(tfmt) is not tiles
    x = torch.zeros((192, 8))
    dy = torch.zeros((tfmt.n_programs * tfmt.rb, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sddmm.sddmm_rows_cuda(tfmt.c0, tfmt.cols, tfmt.lrow, tfmt.nc_p, dy, x, rb=tfmt.rb, kt=8,
                              mode="fp32", tiles=tfmt.tiles)


# ---------------------------------------------------------------- column index
# On the card #15 walks the pattern's column index: the walked slots by tile
# of DX_TILE_COLS columns of A, by window of DX_WIN_ROWS rows of dY_slots,
# by column, then row; a window holding at least ``stage_min`` slots is
# staged in pieces of at most DX_PIECE_SLOTS, the rest read from L2.
# ``dx_index_plain`` is that function walked from the index.

def _gappy_mat(m=400, n=300, seed=31):
    """Rows [0, 64) and [192, 256) 20 % dense, [320, 400) 1 %, none else:
    in blocks of rows (rb 200, balance=False), windows of every kind and
    empty ones; neither 300 columns nor 2 programs x 200 rows a multiple of
    the tile or the window."""
    rng = np.random.default_rng(seed)
    r = np.arange(m)[:, None]
    dens = np.where((r < 64) | ((r >= 192) & (r < 256)), 0.2, np.where(r >= 320, 0.01, 0.0))
    rows, cols = np.nonzero(rng.random((m, n)) < dens)
    return JCoo(rows, cols, rng.standard_normal(rows.size).astype(np.float32), (m, n))


_DX_PATTERNS = dict(_PATTERNS, gappy=(_gappy_mat, dict(rb=200, ct=128, g=64, balance=False)))


@pytest.mark.parametrize("pattern", list(_DX_PATTERNS))
@pytest.mark.parametrize("stage_min", [None, 1, 2 ** 31 - 1])
def test_dx_index_covers_every_walked_slot(pattern, stage_min):
    make, kw = _DX_PATTERNS[pattern]
    jmat = make()
    tfmt = pack_span(_tmat(jmat), keep_perm=True, device="cpu", **kw)
    planes = (tfmt.c0, tfmt.cols, tfmt.lrow, tfmt.nc_p)
    if stage_min is None:
        index = sddmm.dx_index(tfmt)
        assert sddmm.dx_index(tfmt) is index and tfmt.dx_index is index
        stage_min = sddmm.DX_WIN_ROWS
    else:
        index = sddmm.build_dx_index(*planes, rb=tfmt.rb, n=jmat.shape[1], stage_min=stage_min)
    c, d = sddmm.DX_TILE_COLS, sddmm.DX_WIN_ROWS
    # every slot of a walked chunk exactly once, at its own column and row
    slot = index.slot.long()
    np.testing.assert_array_equal(np.sort(slot.numpy()),
                                  np.flatnonzero(_walked(tfmt).reshape(-1).numpy()))
    col, row = index.entries()
    want_col, want_row, _ = sddmm.slot_rows_cols(*planes, tfmt.rb)
    np.testing.assert_array_equal(col.numpy(), want_col[slot].numpy())
    np.testing.assert_array_equal(row.numpy(), want_row[slot].numpy())
    # positions: a permutation of each tile's columns
    assert index.n_tiles == -(-jmat.shape[1] // c)
    assert bool((index.colpos.sort(dim=1)[0] == torch.arange(c)).all())
    # staged: the windows holding at least stage_min slots, pieces of one
    # tile and window, at most DX_PIECE_SLOTS slots, rows within the window
    tile, win = col // c, row // d
    key = tile * (-(-index.n_rows // d)) + win
    per_win = torch.bincount(key)[key]
    staged = torch.zeros(index.n_slots, dtype=torch.bool)
    for (w0, lo, hi, _), t in zip(index.pieces.tolist(),
                                  torch.repeat_interleave(torch.arange(index.n_tiles), torch.diff(
                                      index.tile_pieces.long())).tolist()):
        assert 0 < hi - lo <= sddmm.DX_PIECE_SLOTS and w0 % d == 0
        assert bool((tile[lo:hi] == t).all() & (win[lo:hi] == w0 // d).all())
        assert bool((index.row[lo:hi] < d).all())
        staged[lo:hi] = True
    assert int(staged.sum()) == index.n_staged
    np.testing.assert_array_equal(staged.numpy(), (per_win >= stage_min).numpy())
    # within a tile's sparse part and within a piece: by position, then row
    off = index.piece_off.long()
    assert bool((off[:, c + 1:] == 0).all())
    for t in range(index.n_tiles):
        u = index.uoff[t].long()
        assert bool((torch.diff(u) >= 0).all())
        for p in range(c):
            assert bool((torch.diff(row[u[p]:u[p + 1]]) >= 0).all())
    kinds = (index.n_staged > 0, index.n_staged < index.n_slots)
    if pattern in ("two_densities", "gappy") and stage_min == sddmm.DX_WIN_ROWS:
        assert kinds == (True, True)


@pytest.mark.parametrize("precision", ["fp32", "fp32x2", "bf16"])
@pytest.mark.parametrize("k", [12, 20, 24])
def test_dx_index_plain_matches_rows_plain_and_jax(k, precision):
    # the column walk's function, walked from the index (staged and sparse
    # windows): against the port's plain version and the JAX function at
    # the fp32 rule.  bf16: both round at the same places; fp32x2: the port
    # computes in fp32 (csrc/sddmm.cu), so it is held to the JAX fp32
    # function here (the JAX fp32x2 split into bf16 halves is held at 2e-3
    # in test_span_sddmm_and_dx_match_jax)
    jmat = _gappy_mat()
    kw = _DX_PATTERNS["gappy"][1]
    jfmt, tfmt = _formats(jmat, **kw)
    rng = np.random.default_rng(k)
    dy_slots = rng.standard_normal((tfmt.n_programs * tfmt.rb, k)).astype(np.float32)
    kp = -(-k // 8) * 8
    dyt = torch.nn.functional.pad(torch.from_numpy(dy_slots), (0, kp - k))
    index = sddmm.dx_index(tfmt)
    assert 0 < index.n_staged < index.n_slots
    planes = (tfmt.c0, tfmt.cols, tfmt.lrow)
    vals = tfmt.vals.float()
    n = jmat.shape[1]
    got = sddmm.dx_index_plain(index, vals, dyt, mode=precision)
    want = sddmm.dx_rows_plain(*planes, vals, tfmt.nc_p, dyt, n=n, rb=tfmt.rb, kt=8,
                               mode=precision)
    scale = sddmm.dx_rows_plain(*planes, vals.abs(), tfmt.nc_p, dyt.abs(), n=n, rb=tfmt.rb,
                                kt=8, mode="fp32")
    assert got.shape == (n, kp)
    _within(got.numpy(), want.numpy(), scale.numpy(), TOL["fp32"])
    dx_j = np.asarray(jsddmm.span_dx(jfmt, jfmt.vals, jnp.asarray(dy_slots), ktile=8,
                                     precision="bf16" if precision == "bf16" else "fp32"))
    _within(got.numpy()[:, :k], dx_j, scale.numpy()[:, :k], TOL["fp32"])


def test_dx_index_follows_its_planes():
    # kept on the format and carried by with_values; rebuilt after an index
    # plane is written in place, not when the values change; a value written
    # after the index was built shows in dX; the wrapper refuses CPU tensors
    jmat = jbuilder.pruned_weight_coo(256, 192, sparsity=0.9, seed=5)
    tfmt = pack_span(_tmat(jmat), rb=128, ct=128, g=64, keep_perm=True, device="cpu")
    index = sddmm.dx_index(tfmt)
    new = with_values(tfmt, np.ones(jmat.nnz, np.float32))
    assert new.dx_index is index and sddmm.dx_index(new) is index
    dy = torch.as_tensor(np.random.default_rng(3).standard_normal((tfmt.n_programs * tfmt.rb, 8)),
                         dtype=torch.float32)
    vals = tfmt.vals.float().clone()
    before = sddmm.dx_index_plain(index, vals, dy, mode="fp32")
    vals.view(-1)[int(index.slot[0])] += 2.0
    assert sddmm.dx_index(tfmt) is index
    after = sddmm.dx_index_plain(index, vals, dy, mode="fp32")
    want = sddmm.dx_rows_plain(tfmt.c0, tfmt.cols, tfmt.lrow, vals, tfmt.nc_p, dy, n=192,
                               rb=tfmt.rb, kt=8, mode="fp32")
    assert not torch.equal(before, after)
    assert float((after - want).abs().max()) <= 1e-5 * float(want.abs().max())
    tfmt.lrow.add_(0)
    assert not index.built_from((tfmt.c0, tfmt.cols, tfmt.lrow, tfmt.nc_p))
    assert sddmm.dx_index(tfmt) is not index
    with pytest.raises(ValueError, match="CUDA tensors"):
        sddmm.dx_rows_cuda(tfmt.c0, tfmt.cols, tfmt.lrow, vals, tfmt.nc_p, dy, n=192, rb=tfmt.rb,
                           kt=8, mode="fp32", index=tfmt.dx_index)
