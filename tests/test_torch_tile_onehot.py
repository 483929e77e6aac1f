"""tpusparse_torch's tile format and tile_spmm against the JAX package.

The packer must emit the JAX packer's arrays, and the port's tile_spmm on
the CPU (the kernels' plain versions) must match the JAX tile_spmm (Pallas
interpret mode, as tests/test_tile_kernel.py runs it) and the oracle.
Tolerances: fp32 1e-5 of max|ref|; fp32x2 1e-4 of max|ref| (the JAX side's
hi/lo bf16 split of X; the port computes fp32 and is held to 1e-5 against
the oracle); bf16 5e-2 (tests/test_tile_kernel.py).
"""

import numpy as np
import pytest
import torch

from tpusparse.generator import build_tile_plan as jbuild_tile_plan
from tpusparse.generator import prepare_tile_format as jprepare
from tpusparse.io import builder as jbuilder
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.kernels import tile_onehot as jtile
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch import generator as tgen
from tpusparse_torch.format import TILE_FIELDS, pack_tile, tile_format_from_numpy
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import tile_onehot as ttile
from tpusparse_torch.kernels.common import unpack_slots
from tpusparse_torch.meta.set import create_init_metadata_set as tms

STATIC = ("n_programs", "n_chunks", "chunk_g", "rb", "ct", "shape", "nnz_real")
TOL = {"fp32": 1e-5, "fp32x2": 1e-4, "bf16": 5e-2}


def _case(m=150, n=130, k=8, avg=4.0, seed=4):
    jmat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return jmat, CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape), x


def _with_empty_rows(jmat, every=5):
    keep = jmat.rows % every != 0
    return JCoo(jmat.rows[keep], jmat.cols[keep], jmat.vals[keep], jmat.shape)


def _assert_same_format(jfmt, tfmt):
    for k in TILE_FIELDS:
        np.testing.assert_array_equal(getattr(tfmt, k).numpy(), np.asarray(getattr(jfmt, k)),
                                      err_msg=k)
    for k in STATIC:
        assert getattr(tfmt, k) == getattr(jfmt, k), k
    # nc_p: the packer's chunks_per_p; every chunk past it is padding
    vals = np.asarray(jfmt.vals)
    nc_p = tfmt.nc_p.numpy().reshape(-1)
    for p in range(jfmt.n_programs):
        assert not vals[p, nc_p[p]:].any()
        assert nc_p[p] == 0 or np.asarray(jfmt.chunk_tile)[p, 0, nc_p[p] - 1] >= 0


@pytest.mark.parametrize("rb,ct,g", [(64, 64, 32), (32, 64, 16), (128, 32, 64), (16, 128, 8)])
@pytest.mark.parametrize("empty_rows", [False, True])
def test_pack_tile_equals_jax(rb, ct, g, empty_rows):
    jmat, _, _ = _case(m=200, n=170, avg=5.0, seed=8)
    if empty_rows:
        jmat = _with_empty_rows(jmat)
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    jfmt, _ = jprepare(jmat, rb=rb, ct=ct, g=g)
    tfmt = pack_tile(tms(tmat), 0, out_rows=jmat.shape[0], rb=rb, ct=ct, g=g, device="cpu")
    _assert_same_format(jfmt, tfmt)
    assert tfmt.memory_bytes == jfmt.memory_bytes()
    assert tfmt.padding_rate == pytest.approx(jfmt.padding_rate)


def test_pack_tile_chunk_counts_and_metadata_set_input():
    from tpusparse.format import pack_tile as jpack_tile
    from tpusparse.meta.set import create_init_metadata_set as jms

    jmat, tmat, _ = _case(m=100, n=90, avg=3.0, seed=2)
    kw = dict(out_rows=120, rb=32, ct=32, g=16)   # out_rows past the matrix: slots -1
    jfmt = jpack_tile(jms(jmat), 0, **kw)
    tfmt = pack_tile(tms(tmat), 0, device="cpu", **kw)
    _assert_same_format(jfmt, tfmt)
    assert (tfmt.slot_of_origrow.numpy()[100:] == -1).all()
    # chunks_per_p by hand: each (program, tile) segment rounded up to g
    p_of, t_of = tmat.rows // 32, tmat.cols // 32
    want = [sum(-(-np.count_nonzero((p_of == p) & (t_of == t)) // 16) for t in range(3))
            for p in range(tfmt.n_programs)]
    np.testing.assert_array_equal(tfmt.nc_p.numpy().reshape(-1), want)
    empty = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), (40, 30))
    efmt = pack_tile(tms(empty), 0, out_rows=40, rb=16, ct=16, g=8, device="cpu")
    assert efmt.n_chunks == 1 and int(efmt.nc_p.sum()) == 0 and efmt.nnz_real == 0
    assert not ttile.tile_spmm(efmt, np.ones((30, 3), np.float32)).any()


def _from_jax(jfmt):
    fields = {k: np.asarray(getattr(jfmt, k)) for k in TILE_FIELDS}
    return tile_format_from_numpy(fields, device="cpu", **{k: getattr(jfmt, k) for k in STATIC})


@pytest.mark.parametrize("precision,k", [("fp32", 8), ("fp32x2", 5), ("fp32x2", 100),
                                         ("bf16", 16)])
def test_tile_spmm_matches_jax(precision, k):
    jmat, tmat, x = _case(k=k)
    jfmt, _ = jprepare(jmat, rb=64, ct=64, g=32)
    tfmt = pack_tile(tms(tmat), 0, out_rows=150, rb=64, ct=64, g=32, device="cpu")
    assert not ttile.uses_stream(130, 64, ttile.default_ktile(k), precision)
    ref = spmm_reference(jmat, x.astype(np.float64))
    yj = np.asarray(jtile.tile_spmm(jfmt, x, precision=precision))
    for fmt in (tfmt, _from_jax(jfmt)):
        yt = ttile.tile_spmm(fmt, x, precision=precision)
        assert isinstance(yt, torch.Tensor) and yt.shape == (150, k)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=TOL[precision] * np.abs(ref).max())
        check_result(yt.numpy(), ref, rtol=8e-2 if precision == "bf16" else 1e-5)


@pytest.mark.parametrize("precision", ["fp32x2", "fp32"])
def test_tile_stream_matches_jax_stream_call(precision):
    # the JAX stream kernel by a direct call, and the port's plain version of it
    jmat, tmat, x = _case(k=16, seed=6)
    jfmt, _ = jprepare(jmat, rb=32, ct=64, g=16)
    tfmt = pack_tile(tms(tmat), 0, out_rows=150, rb=32, ct=64, g=16, device="cpu")
    xp = np.pad(x, ((0, 3 * 64 - 130), (0, 0)))      # whole column tiles, as tile_spmm pads
    rows_j = np.asarray(jtile._tile_call_stream(
        jfmt.chunk_tile, jfmt.cols, jfmt.lrow, jfmt.vals, xp, n_programs=jfmt.n_programs,
        nc=jfmt.n_chunks, g=16, rb=32, ct=64, ktile=16, mode=precision, interpret=True))
    rows_t = ttile.tile_stream_rows_plain(tfmt.chunk_tile, tfmt.cols, tfmt.lrow, tfmt.vals,
                                          tfmt.nc_p, torch.from_numpy(x), rb=32, ct=64,
                                          kt=16, mode=precision)
    ref = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(rows_t.numpy(), rows_j, rtol=0,
                               atol=TOL[precision] * np.abs(ref).max())
    check_result(unpack_slots(rows_t, tfmt.slot_of_origrow).numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("k", [256, 520])
def test_tile_rows_plain_matches_tile_call(k):
    # the JAX resident kernel by a direct call at wide K (K-tiles of 128,
    # X padded to whole tiles and whole column tiles), and the port's plain
    # version, which the card's kernel is held to at every panel
    jmat, tmat, x = _case(k=k, seed=15)
    jfmt, _ = jprepare(jmat, rb=64, ct=64, g=32)
    tfmt = pack_tile(tms(tmat), 0, out_rows=150, rb=64, ct=64, g=32, device="cpu")
    kp = -(-k // 128) * 128
    xp = np.pad(x, ((0, 3 * 64 - 130), (0, kp - k)))
    rows_j = np.asarray(jtile._tile_call(
        jfmt.chunk_tile, jfmt.cols, jfmt.lrow, jfmt.vals, xp, n_programs=jfmt.n_programs,
        nc=jfmt.n_chunks, g=32, rb=64, ct=64, ktile=128, mode="fp32", unroll=1,
        interpret=True))
    rows_t = ttile.tile_rows_plain(tfmt.chunk_tile, tfmt.cols, tfmt.lrow, tfmt.vals,
                                   tfmt.nc_p, torch.from_numpy(x), rb=64, ct=64, kt=32,
                                   mode="fp32")
    ref = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(rows_t.numpy(), rows_j[:, :k], rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    check_result(unpack_slots(rows_t, tfmt.slot_of_origrow).numpy(), ref, rtol=1e-5)


def test_build_tile_plan_matches_jax():
    jmat, tmat, x = _case(k=12, seed=9)
    jplan = jbuild_tile_plan(jmat, rb=64, ct=32, g=32, precision="fp32")
    tplan = tgen.build_tile_plan(tmat, rb=64, ct=32, g=32, precision="fp32", device="cpu")
    assert tplan.meta == jplan.meta
    _assert_same_format(jplan.formats[0], tplan.formats[0])
    ref = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(tplan(x).numpy(), np.asarray(jplan(x)), rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    check_result(tplan(x).numpy(), ref, rtol=1e-5)
    assert tplan.cost_summary(12)["format_bytes"] == tplan.formats[0].memory_bytes
    # sort=True: the length sort first, as in the JAX package
    jsort = jbuild_tile_plan(jmat, rb=64, ct=32, g=32, sort=True, precision="fp32")
    tsort = tgen.build_tile_plan(tmat, rb=64, ct=32, g=32, sort=True, precision="fp32",
                                 device="cpu")
    assert tsort.meta == jsort.meta
    _assert_same_format(jsort.formats[0], tsort.formats[0])
    check_result(tsort(x).numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("n,ct,ktile,precision,stream", [
    (32768, 1024, 128, "fp32x2", True),     # config #1 at K = 256: 16 MB
    (32768, 1024, 32, "fp32x2", False),     # K = 32: 4 MB
    (32768, 1024, 64, "fp32", True), (32768, 1024, 32, "fp32", False),
    (32768, 1024, 128, "bf16", True), (32768, 1024, 64, "bf16", False),
    (24577, 1024, 64, "fp32x2", True),      # padded to 25 tiles: 6.25 MiB
    (24576, 1024, 64, "fp32x2", False),     # exactly 6 MiB stays resident
])
def test_resident_stream_rule_is_jax(n, ct, ktile, precision, stream, monkeypatch):
    # the JAX rule (tile_onehot.py:207-228) in numbers, and tile_spmm follows it
    xwidth = 2 * ktile if precision == "fp32x2" else ktile
    item = 4 if precision == "fp32" else 2
    assert (-(-n // ct) * ct * xwidth * item > jtile._RESIDENT_X_BYTES) == stream
    assert ttile.uses_stream(n, ct, ktile, precision) == stream
    calls = []
    monkeypatch.setattr(ttile, "tile_stream_rows_plain",
                        lambda *a, **kw: calls.append("stream") or ttile.tile_rows_plain(*a, **kw))
    mat = CooMatrix(np.array([0, 1]), np.array([0, n - 1]), np.array([1.0, 2.0]), (2, n))
    fmt = pack_tile(tms(mat), 0, out_rows=2, rb=8, ct=ct, g=8, device="cpu")
    x = np.zeros((n, 1), np.float32)
    x[-1] = 3.0
    y = ttile.tile_spmm(fmt, x, ktile=ktile, precision=precision)
    assert calls == (["stream"] if stream else []) and y[1, 0] == 6.0


def test_tile_format_from_numpy_checks_indices():
    jmat, _, x = _case(seed=11)
    jfmt, _ = jprepare(jmat, rb=64, ct=64, g=32)
    fields = {k: np.asarray(getattr(jfmt, k)).copy() for k in TILE_FIELDS}
    static = {k: getattr(jfmt, k) for k in STATIC}
    fmt = tile_format_from_numpy(fields, device="cpu", **static)
    np.testing.assert_array_equal(
        fmt.nc_p.numpy().reshape(-1),
        [int(np.flatnonzero(v.any(axis=1)).max(initial=-1)) + 1 for v in fields["vals"]])
    for name, bad in (("cols", 64), ("lrow", 64)):
        broken = dict(fields)
        broken[name] = fields[name].copy()
        broken[name][0, 0, 0] = bad
        with pytest.raises(ValueError, match="out of range"):
            tile_format_from_numpy(broken, device="cpu", **static)
    broken = dict(fields)
    broken["chunk_tile"] = fields["chunk_tile"] + 5       # every live column past N
    with pytest.raises(ValueError, match="out of range"):
        tile_format_from_numpy(broken, device="cpu", **static)
    with pytest.raises(ValueError, match="shape"):
        tile_format_from_numpy(dict(fields, vals=fields["vals"][:, :1]), device="cpu", **static)


def test_plain_versions_walk_only_real_chunks():
    # a value past nc_p adds nothing, as the kernels skip those chunks
    jmat, tmat, x = _case(seed=12)
    fmt = pack_tile(tms(tmat), 0, out_rows=150, rb=64, ct=64, g=32, device="cpu")
    vals = fmt.vals.clone()
    p = int(torch.argmin(fmt.nc_p.reshape(-1)))
    assert int(fmt.nc_p.reshape(-1)[p]) < fmt.n_chunks
    vals[p, -1, 0] = 7.0
    args = (fmt.chunk_tile, fmt.cols, fmt.lrow)
    kw = dict(rb=64, ct=64, kt=8, mode="fp32")
    xt = torch.from_numpy(x)
    torch.testing.assert_close(ttile.tile_rows_plain(*args, vals, fmt.nc_p, xt, **kw),
                               ttile.tile_rows_plain(*args, fmt.vals, fmt.nc_p, xt, **kw))


def test_k_tiles_and_wrapper_refuses_cpu_tensors():
    assert [ttile.choose_kt(k) for k in (1, 5, 8, 9, 16, 17, 32)] == [8, 8, 8, 16, 16, 32, 32]
    assert ttile.default_ktile(100) == 100 and ttile.default_ktile(300) == 128
    _, tmat, x = _case()
    fmt = pack_tile(tms(tmat), 0, out_rows=150, rb=64, ct=64, g=32, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttile.tile_rows_cuda(fmt.chunk_tile, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p,
                             torch.zeros((130, 8)), rb=64, ct=64, kt=8, mode="fp32")
    with pytest.raises(ValueError, match="X is on"):
        ttile.tile_spmm(fmt, torch.zeros((130, 8), device="meta"))


@pytest.mark.parametrize("kp,g,want", [
    (8, 512, (8, 2)), (16, 128, (16, 8)), (32, 2048, (32, 1)), (40, 512, (64, 2)),
    (128, 1024, (128, 1)), (256, 512, (256, 2)),        # config #1 at K = 256
    (288, 32, (512, 32)), (608, 4096, (512, 1)),         # one masked panel; two panels
])
def test_stream_geometry(kp, g, want):
    # the panel is the narrowest that holds Kp (its lanes carry 4 columns
    # each, at most 32 lanes a stream); a block takes whole chunks of about
    # 1024 slots
    pw, cpb = ttile.stream_geometry(kp, g)
    assert (pw, cpb) == want and pw in ttile.STREAM_PANELS
    assert pw >= kp or pw == ttile.STREAM_PANELS[-1]
    assert cpb * g >= min(g, ttile.STREAM_BLOCK_SLOTS)


def test_row_runs_counts_runs_of_live_slots():
    _, tmat, _ = _case(seed=13)
    fmt = pack_tile(tms(tmat), 0, out_rows=150, rb=64, ct=64, g=32, device="cpu")
    runs, live = ttile.row_runs(fmt)
    # walk every program's chunks before nc_p in order, skipping zeros
    want, prev = 0, None
    for p in range(fmt.n_programs):
        prev = None
        for j in range(int(fmt.nc_p.reshape(-1)[p])):
            for s in range(fmt.chunk_g):
                if fmt.vals[p, j, s] != 0:
                    row = int(fmt.lrow[p, j, s])
                    want += row != prev
                    prev = row
    assert (runs, live) == (want, tmat.nnz) and runs < live
