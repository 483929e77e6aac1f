"""tpusparse_torch's CUDA kernels on the card: each kernel against its plain
version for every kt and mode, the default SpMM paths (dg, radix, tile, span
and the column split), tune, the stripe and segment families,
build_tile_plan, build_stripe_plan and the SpMV entry points at a medium
size; the N:M and Block-ELL kernels in every mode and layout, SparseLinear
with a folded activation, and the dense, block_ell and hybrid_cols families;
the SDDMM and transpose-apply kernels against their plain versions, and
the trainable and differentiable layers' gradients; the graph drivers and
SpGEMM against their CPU path and scipy, a format packed by the native
host helpers against one packed by the numpy walks, and the bench tools:
the session probe's readings within their bounds and the three library
yardsticks at config #1 against the oracle; the multi-device layer: each
halo ring and the sharded stripe SpMM on virtual ranks of the card against
the same ring on CPU ranks, its shifts off the kernels' stream, and the
dry run; past the TPU limits: the dgt8 SpMV past 294,912 columns and the
span SpMV at one column, each kernel against its plain version, and
``measured_stream_bandwidth_gbs`` within the probe's stream bounds.
Marked ``gpu``; without a CUDA device every test skips (the ``cuda``
fixture decides, so every pytest worker collects the same tests).  Run on
the card with ``python -m pytest tests/test_torch_gpu.py -q -m gpu``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import tpusparse_torch
from tpusparse_torch.io import builder
from tpusparse_torch.format import pack_tile
from tpusparse_torch.generator import build_stripe_plan, build_tile_plan, prepare_stripe_format
from tpusparse_torch.kernels import block_ell as be
from tpusparse_torch.kernels import dg_gather as dg
from tpusparse_torch.kernels import dgt_gather as dgt
from tpusparse_torch.kernels import nm_structured as nm
from tpusparse_torch.kernels import radix_gather as radix
from tpusparse_torch.kernels import row_walk as rw
from tpusparse_torch.kernels import sddmm as sd
from tpusparse_torch.kernels import span_gather as span
from tpusparse_torch.kernels import stripe_gather as stripe
from tpusparse_torch.kernels import tile_onehot as tile
from tpusparse_torch.meta.set import create_init_metadata_set
from tpusparse_torch.oracle import check_result, spmm_reference
from tpusparse_torch.nn import SparseLinear, TrainableSparseLinear
from tpusparse_torch.gates import TPU_GATES
from tpusparse_torch.schedule import KERNEL_FAMILIES, Schedule, build_plan, default_schedule
from tpusparse_torch.spmv import spmv_fn, spmv_multi_fn
from tpusparse_torch.tune import tune

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mat():
    return builder.power_law_coo(4096, 4096, avg_nnz_per_row=16.0, seed=21)


def _rows_vs_plain(fmt, k, kt, mode, dev, vals=None, geometry=rw.WALK1_GEOMETRY):
    """Max error of the kernel against its plain version, relative to
    |A|·|x| (they differ only in the order of their atomic fp32 sums).
    ``vals``: a value plane other than the format's (the row walk kernels
    gather from it); ``geometry``: the one-column walk's (kt = 1)."""
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((fmt.shape[1], k)),
                        dtype=torch.float32, device=dev)
    vals = fmt.vals if vals is None else vals
    args = (fmt.c0, fmt.cols, fmt.lrow, vals, fmt.nc_p)
    abs_args = (fmt.c0, fmt.cols, fmt.lrow, vals.abs(), fmt.nc_p)
    if kt == 1:
        x = x[:, 0].contiguous()
        before = dg.dg1_rows_cuda.launches
        got = dg.dg1_rows_cuda(*args, x, rb=fmt.rb, walk=dg.dg_row_walk(fmt),
                               geometry=geometry)
        assert dg.dg1_rows_cuda.launches == before + 1
        want = dg.dg1_rows_plain(*args, x, rb=fmt.rb)
        scale = dg.dg1_rows_plain(*abs_args, x.abs(), rb=fmt.rb)
    else:
        x = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
        before = dg.dg_rows_cuda.launches
        got = dg.dg_rows_cuda(*args, x, rb=fmt.rb, kt=kt, mode=mode, walk=dg.dg_row_walk(fmt),
                              k=k)
        assert dg.dg_rows_cuda.launches == before + 1
        want = dg.dg_rows_plain(*args, x, rb=fmt.rb, kt=kt, mode=mode)
        scale = dg.dg_rows_plain(*abs_args, x.abs(), rb=fmt.rb, kt=kt, mode="fp32x2")
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda
    denom = torch.maximum(scale.double(), torch.ones((), dtype=torch.float64, device=dev))
    return float(((got.double() - want.double()).abs() / denom).max())


@pytest.mark.parametrize("kt,mode,k,rb", [
    (8, "fp32x2", 8, 1024), (8, "bf16", 8, 1024), (16, "fp32x2", 16, 1024),
    (16, "bf16", 16, 1024), (32, "fp32x2", 32, 512), (32, "bf16", 32, 512),
    (8, "fp32x2", 3, 256), (16, "fp32x2", 40, 512), (32, "fp32x2", 64, 512),
    (32, "fp32x2", 32, 2048),  # rb 2048: y_rows in device memory
    (1, "fp32x2", 1, 4096),
])
def test_kernel_matches_plain(cuda, mat, kt, mode, k, rb):
    fmt = dg.pack_dg(mat, rb=rb, ns=4 if kt == 1 else 8, g=2048 if kt == 1 else 512,
                     kt=kt, mode=mode, device=cuda)
    assert _rows_vs_plain(fmt, k, kt, mode, cuda) <= 1e-5
    # #1 and #2 walk rows: no row tile, no spill, at least 2 blocks an SM
    info = dg.dg_walk_info(rw.walk_geometry(k)[1], mode) if kt > 1 else dg.dg_walk1_info()
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2


@pytest.mark.parametrize("k,kt", [(2, 8), (5, 8), (64, 32), (200, 32)])
def test_dg_row_walk_widths(cuda, mat, k, kt):
    # #1 at several panels (K = 200: 208 columns of X padded to 224, one
    # 256-column panel), the walk's own values streamed and a copy of the
    # plane gathered, and the walk shared by the wrapper's calls
    fmt = dg.pack_dg(mat, rb=512, ns=8, g=512, kt=kt, device=cuda)
    assert _rows_vs_plain(fmt, k, kt, "fp32x2", cuda) <= 1e-5
    assert _rows_vs_plain(fmt, k, kt, "fp32x2", cuda, vals=fmt.vals.clone()) <= 1e-5
    assert fmt.walk is dg.dg_row_walk(fmt) and fmt.walk.n_slots == mat.nnz


def _spmv_walk_case(case):
    """A COO of a one-column walk case: power law, empty, one nonzero, one
    row of 5200 slots, 403 columns (not a multiple of 4)."""
    from tpusparse_torch.io.mtx import CooMatrix

    rng = np.random.default_rng(61)
    if case == "empty":
        return CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
                         (70, 90))
    if case == "one_nz":
        return CooMatrix(np.array([5]), np.array([17]), np.array([-1.5], np.float32), (70, 90))
    m, n = {"long_row": (4096, 5200), "n_odd": (4096, 403)}.get(case, (4096, 4096))
    a = builder.power_law_coo(m, n, avg_nnz_per_row=16.0, seed=62)
    if case == "long_row":  # row 3 holds every column
        keep = a.rows != 3
        a = CooMatrix(np.concatenate([a.rows[keep], np.full(n, 3)]),
                      np.concatenate([a.cols[keep], np.arange(n)]),
                      np.concatenate([a.vals[keep], rng.standard_normal(n).astype(np.float32)]),
                      (m, n))
    return a


@pytest.mark.parametrize("case,geometry", [
    ("power_law", rw.WALK1_GEOMETRY), ("empty", rw.WALK1_GEOMETRY),
    ("one_nz", rw.WALK1_GEOMETRY), ("long_row", rw.WALK1_GEOMETRY),
    ("n_odd", rw.WALK1_GEOMETRY), ("with_values", rw.WALK1_GEOMETRY),
    ("long_row", (32, 1, 1)),        # the 5200-slot row over 163 warps, each a block
    ("long_row", (64, 2, 4)),        # ranges shorter than a warp's four steps
    ("power_law", (4096, 4, 2)),
])
def test_dg_spmv_walk_matches_plain(cuda, case, geometry):
    # #2, the one-column walk, on hand-built formats and geometries: a run
    # carried from step to step, cut at warp and block ends, an empty walk
    a = _spmv_walk_case("power_law" if case == "with_values" else case)
    fmt = dg.pack_dg(a, rb=4096 if a.shape[0] >= 4096 else 128, ns=4, g=2048, kt=1,
                     keep_perm=case == "with_values", device=cuda)
    walk = dg.dg_row_walk(fmt)
    assert walk.n_slots == a.nnz
    if case == "with_values":  # the walk's values, then a caller's plane gathered
        new = np.random.default_rng(64).standard_normal(a.nnz).astype(np.float32)
        fmt = dg.with_values(fmt, new)
        assert fmt.walk.slot is walk.slot and dg.dg_row_walk(fmt) is fmt.walk
        assert _rows_vs_plain(fmt, 1, 1, "fp32x2", cuda, vals=fmt.vals.clone()) <= 1e-5
    if case == "long_row":  # the row spans warps (and, at 32 or 64 slots a warp, blocks)
        longest = int(torch.unique_consecutive(walk.row, return_counts=True)[1].max())
        assert longest >= 5000 and longest > geometry[0]
    assert _rows_vs_plain(fmt, 1, 1, "fp32x2", cuda, geometry=geometry) <= 1e-5
    info = dg.dg_walk1_info(geometry)
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2


def test_dg_spmv_walk_refuses_bad_walks(cuda, mat):
    # a missing walk, another format's and one of planes written since are
    # refused, not run; nothing falls back to the plain version
    fmt = dg.pack_dg(mat, rb=4096, ns=4, g=2048, kt=1, device=cuda)
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)
    x = torch.ones(4096, dtype=torch.float32, device=cuda)
    before = dg.dg1_rows_cuda.launches
    with pytest.raises(ValueError, match="walk="):
        dg.dg1_rows_cuda(*args, x, rb=4096)
    other = dg.pack_dg(mat, rb=4096, ns=4, g=2048, kt=1, device=cuda)
    with pytest.raises(ValueError, match="not built from"):
        dg.dg1_rows_cuda(*args, x, rb=4096, walk=dg.dg_row_walk(other))
    walk = dg.dg_row_walk(fmt)
    fmt.cols.add_(0)                                  # written since: stale
    with pytest.raises(ValueError, match="not built from"):
        dg.dg1_rows_cuda(*args, x, rb=4096, walk=walk)
    with pytest.raises(RuntimeError, match="dg_spmv_launch"):   # a geometry it refuses
        dg.dg1_rows_cuda(*args, x, rb=4096, walk=dg.dg_row_walk(fmt), geometry=(48, 8, 4))
    assert dg.dg1_rows_cuda.launches == before
    assert dg.dg_spmv(fmt, x).is_cuda and dg.dg1_rows_cuda.launches == before + 1


@pytest.mark.parametrize("k", [1, 8, 64])
def test_spmm_default_path_on_card(cuda, mat, k):
    x = np.random.default_rng(k).standard_normal((4096, k)).astype(np.float32)
    counter = dg.dg1_rows_cuda if k == 1 else dg.dg_rows_cuda
    before = counter.launches
    y = tpusparse_torch.spmm(mat, x)
    assert y.is_cuda and y.shape == (4096, k)
    assert counter.launches == before + 1
    assert default_schedule(mat, k).family == "dg_span"
    check_result(y.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)


def test_tune_on_card(cuda, mat, tmp_path):
    x = np.random.default_rng(5).standard_normal((4096, 8)).astype(np.float32)
    with tpusparse_torch.config_override(cache_dir=str(tmp_path)):
        res = tune(mat, x, iters=3)
    assert all(r["device"] == torch.cuda.get_device_name(cuda) for r in res.table)
    # rows may fail only at the padding bound or brick_ell's gate
    assert all(r["ok"] or "CandidateRejected" in r["error"] for r in res.table)
    assert {r["schedule"]["family"] for r in res.table} == {
        "dg_span", "dgt_span", "radix_span", "brick_ell", "span_onehot", "tile_onehot",
        "stripe_total", "segment_span", "nnz_segment", "bucketed"}   # skewed: segment rows
    assert res.best_schedule.family in KERNEL_FAMILIES and res.best_seconds > 0
    check_result(res.best(x).cpu().numpy(), spmm_reference(mat, x.astype(np.float64)),
                 rtol=2e-3)


def test_wrapper_refuses_bad_inputs(cuda, mat):
    fmt = dg.pack_dg(mat, rb=1024, ns=8, g=512, kt=8, device=cuda)
    args = [fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p]
    x = torch.zeros((4096, 8), device=cuda)
    with pytest.raises(ValueError):
        dg.dg_rows_cuda(*args, x.double(), rb=1024, kt=8, mode="fp32x2")
    with pytest.raises(ValueError):
        dg.dg_rows_cuda(*args, torch.zeros((4096, 12), device=cuda), rb=1024, kt=8,
                        mode="fp32x2")
    with pytest.raises(ValueError):
        dg.dg_rows_cuda(fmt.c0, fmt.cols.long(), *args[2:], x, rb=1024, kt=8, mode="fp32x2")
    with pytest.raises(ValueError):
        dg.dg_spmm(fmt, torch.zeros((4096, 8)))   # X on the CPU, format on the card
    with pytest.raises(ValueError, match="walk="):   # the row walk is required
        dg.dg_rows_cuda(*args, x, rb=1024, kt=8, mode="fp32x2")
    walk = dg.dg_row_walk(fmt)
    other = dg.pack_dg(mat, rb=1024, ns=8, g=512, kt=8, device=cuda)
    with pytest.raises(ValueError, match="not built from"):   # another format's walk
        dg.dg_rows_cuda(other.c0, other.cols, other.lrow, other.vals, other.nc_p, x, rb=1024,
                        kt=8, mode="fp32x2", walk=walk)
    fmt.lrow.add_(0)                                  # a plane written since: stale
    with pytest.raises(ValueError, match="not built from"):
        dg.dg_rows_cuda(*args, x, rb=1024, kt=8, mode="fp32x2", walk=walk)


def _dgt_vs_plain(fmt, k, dev, stream, vals=None):
    """Max error of a dgt kernel against its plain version, relative to
    |A|·|x|, and the launch count it added.  ``vals``: a value plane other
    than the format's (the row walk kernel gathers from it)."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((fmt.shape[1], k)),
                        dtype=torch.float32, device=dev)
    x = dg.pad_dense_cols(x, -(-k // fmt.kt) * fmt.kt).contiguous()
    vals = fmt.vals if vals is None else vals
    args = (fmt.wins, fmt.cols, fmt.lrw, vals, fmt.nc_p)
    abs_args = (fmt.wins, fmt.cols, fmt.lrw, vals.abs(), fmt.nc_p)
    kw = dict(rb=fmt.rb, kt=fmt.kt, mode=fmt.mode)
    wrapper = dgt.dgt_stream_rows_cuda if stream else dgt.dgt_rows_cuda
    before = wrapper.launches
    if stream:
        got = dgt.dgt_stream_rows_cuda(*args, x, nw=fmt.nw, walk=dgt.dgt_row_walk(fmt), k=k,
                                       **kw)
        want = dgt.dgt_stream_rows_plain(*args, x, nw=fmt.nw, **kw)
    else:
        got = dgt.dgt_rows_cuda(*args, x, resid=fmt.resid, walk=dgt.dgt_row_walk(fmt), k=k,
                                **kw)
        want = dgt.dgt_rows_plain(*args, x, resid=fmt.resid, **kw)
    scale = dgt.dgt_rows_plain(*abs_args, x.abs(), resid=fmt.resid, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.shape == want.shape and got.is_cuda
    denom = torch.maximum(scale.double(), torch.ones((), dtype=torch.float64, device=dev))
    return float(((got.double() - want.double()).abs() / denom).max())


@pytest.mark.parametrize("kt,mode,k,rb,nw,resid,stream", [
    (8, "fp32x2", 8, 512, 8, True, False), (8, "bf16", 8, 512, 4, True, False),
    (16, "fp32x2", 16, 512, 4, True, False), (16, "bf16", 16, 512, 4, True, False),
    (32, "fp32x2", 32, 256, 4, True, False), (32, "bf16", 32, 256, 1, True, False),
    (8, "fp32x2", 8, 256, 8, False, False), (16, "fp32x2", 40, 512, 4, True, False),
    (32, "fp32x2", 32, 2048, 4, True, False),  # rb 2048: y_rows in device memory
    (8, "fp32x2", 8, 2560, 4, True, False),    # the SpMV workload's rb
    (8, "fp32x2", 8, 512, 4, True, True), (8, "fp32x2", 8, 512, 8, True, True),
    (32, "bf16", 32, 256, 8, True, True),
    (8, "fp32x2", 8, 2560, 4, True, True),     # the SpMV workload's rb
])
def test_dgt_kernels_match_plain(cuda, mat, kt, mode, k, rb, nw, resid, stream):
    fmt = dgt.pack_dgt(mat, rb=rb, g=512, kt=kt, mode=mode, nw=nw, resid=resid, device=cuda)
    assert _dgt_vs_plain(fmt, k, cuda, stream) <= 1e-5
    # #3 and #4 walk rows: no row tile, no spill, at least 2 blocks an SM
    info = dgt.dgt_walk_info(rw.walk_geometry(k)[1], mode)
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2
    if stream:  # one walk per format: the resident wrapper takes the stream's
        walk = fmt.walk
        assert _dgt_vs_plain(fmt, k, cuda, False) <= 1e-5 and fmt.walk is walk


@pytest.mark.parametrize("k", [1, 2, 5, 37, 256, 520])
def test_dgt_row_walk_widths(cuda, mat, k):
    # #3 at every panel: K 1-2 read one float4 a slot of X padded to kt,
    # 5 the 8-column panel, 37 the 64-column one, 256 one panel, 520 two
    # the walk's own values streamed, and a copy of the plane gathered
    kt = 8 if k <= 8 else 32
    fmt = dgt.pack_dgt(mat, rb=512, g=512, kt=kt, nw=4, device=cuda)
    assert _dgt_vs_plain(fmt, k, cuda, False) <= 1e-5
    assert _dgt_vs_plain(fmt, k, cuda, False, vals=fmt.vals.clone()) <= 1e-5


def _edge_coo(case, seed=23):
    """A 4096^2 power law with one edge: longest_row (row 700 holds every
    column, so its run crosses several blocks of the walk), empty_program
    (rows 1024-2047 hold no nonzero), stored_zero (every fifth value a
    stored zero of the COO)."""
    from tpusparse_torch.io.mtx import CooMatrix

    base = builder.power_law_coo(4096, 4096, avg_nnz_per_row=8.0, seed=seed)
    keep = ((base.rows < 1024) | (base.rows >= 2048) if case == "empty_program"
            else base.rows != 700)
    rows, cols, vals = base.rows[keep], base.cols[keep], base.vals[keep]
    if case == "longest_row":
        rows = np.concatenate([rows, np.full(4096, 700)])
        cols = np.concatenate([cols, np.arange(4096)])
        vals = np.concatenate([vals, np.random.default_rng(31).standard_normal(4096)])
    if case == "stored_zero":
        vals = vals.copy()
        vals[::5] = 0.0
    return CooMatrix(rows, cols, vals.astype(np.float32), (4096, 4096))


@pytest.mark.parametrize("case", ["longest_row", "empty_program", "padding_chunk",
                                  "stored_zero"])
@pytest.mark.parametrize("mode,k", [("fp32x2", 8), ("bf16", 256), ("fp32", 1)])
def test_row_walk_kernel_edges(cuda, case, mode, k):
    # #7 and #3 on hand-built formats.  padding_chunk: a chunk (a tile for
    # dgt) before nc_p whose values are all zero; stored_zero: the pattern
    # holds slots whose packed value is 0, which the caller's plane makes
    # nonzero (pack_span(keep_perm=True), the trainable path)
    a = _edge_coo("longest_row" if case == "padding_chunk" else case)
    keep_perm, empty = case == "stored_zero", case == "empty_program"
    # rows dealt to programs in blocks where a program is to be empty
    fmt = span.pack_span(a, rb=1024, ct=1024, g=512, balance=not empty, keep_perm=keep_perm,
                         device=cuda)
    if case == "padding_chunk":
        vals = fmt.vals.clone()
        vals[0, 0] = 0.0
        fmt = dataclasses.replace(fmt, vals=vals, walk=None)
    walk = span.span_row_walk(fmt)
    if case == "longest_row":  # one run of 4096 slots: several streams' and blocks' share
        assert int(torch.unique_consecutive(walk.row, return_counts=True)[1].max()) == 4096
    if empty:
        assert not bool(fmt.vals[1].any())
    plane = None
    if keep_perm:
        new = np.random.default_rng(32).standard_normal(a.nnz).astype(np.float32)
        plane = span.with_values(fmt, new).vals
        assert walk.n_slots == a.nnz > int(np.count_nonzero(a.vals))
    assert _window_vs_plain("span", fmt, k, cuda, False, mode, vals=plane) <= 1e-5
    dmode = "bf16" if mode == "bf16" else "fp32x2"
    fd = dgt.pack_dgt(a, rb=512, g=512, kt=8, mode=dmode, nw=4, keep_perm=keep_perm,
                      deal="blocks" if empty else None, device=cuda)
    if empty:
        assert not bool(fd.vals[2:4].any())
    if case == "padding_chunk":
        vals = fd.vals.clone()
        vals[0, 0, :128] = 0.0
        fd = dataclasses.replace(fd, vals=vals, walk=None)
    if keep_perm:              # with_values carries the pattern's walk
        walk = dgt.dgt_row_walk(fd)
        fd = dgt.with_values(fd, new)
        assert fd.walk.slot is walk.slot and dgt.dgt_row_walk(fd) is fd.walk
        assert fd.walk.n_slots == a.nnz
    assert _dgt_vs_plain(fd, k, cuda, False) <= 1e-5
    if keep_perm and mode != "bf16":  # through the entry points, against the oracle
        from tpusparse_torch.io.mtx import CooMatrix

        x = np.random.default_rng(33).standard_normal((4096, 8)).astype(np.float32)
        want = spmm_reference(CooMatrix(a.rows, a.cols, new, a.shape), x.astype(np.float64))
        check_result(dgt.dgt_spmm(fd, x).cpu().numpy(), want, rtol=2e-3)
        check_result(span.span_spmm(fmt, x, vals=plane).cpu().numpy(), want, rtol=2e-3)


@pytest.mark.parametrize("family", ["dgt_span", "span_onehot"])
def test_row_walk_follows_load_state_dict(cuda, mat, family):
    # load_state_dict writes the layer's buffers, the format's planes, in
    # place: the next call must build a new row walk and serve the new
    # weights, through #3 or #7
    from tpusparse_torch.io.mtx import CooMatrix

    counter = dgt.dgt_rows_cuda if family == "dgt_span" else span.span_rows_cuda
    sched = Schedule(family=family, rb=512, ct=1024, g=512, ktile=8)
    x = torch.as_tensor(np.random.default_rng(41).standard_normal((5, 4096)),
                        dtype=torch.float32, device=cuda)
    layer = SparseLinear.from_coo(mat, schedule=sched, device=cuda)
    check_result(layer(x).T.cpu().numpy(),
                 spmm_reference(mat, x.T.cpu().numpy().astype(np.float64)), rtol=2e-3)
    new = CooMatrix(mat.rows, mat.cols, np.random.default_rng(42).standard_normal(mat.nnz)
                    .astype(np.float32), mat.shape)
    layer.load_state_dict(SparseLinear.from_coo(new, schedule=sched, device=cuda).state_dict())
    before = counter.launches
    y = layer(x)
    assert counter.launches > before
    check_result(y.T.cpu().numpy(), spmm_reference(new, x.T.cpu().numpy().astype(np.float64)),
                 rtol=2e-3)


def test_row_walk_refuses_what_it_would_drop(cuda, mat):
    # a caller's plane with a nonzero off a format packed without
    # perm_of_nz, and a walk of another format, are refused, not run
    fmt = span.pack_span(mat, rb=1024, ct=1024, g=512, device=cuda)
    x = torch.ones((4096, 8), dtype=torch.float32, device=cuda)
    plane = fmt.vals.clone()
    plane.view(-1)[int(torch.nonzero(plane.reshape(-1) == 0)[0])] = 1.0
    with pytest.raises(ValueError, match="off the format's pattern"):
        span.span_spmm(fmt, x, vals=plane)
    other = span.pack_span(mat, rb=1024, ct=1024, g=512, device=cuda)
    with pytest.raises(ValueError, match="not built from these index planes"):
        span.span_rows_cuda(fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, x, rb=fmt.rb,
                            kt=8, mode="fp32x2", walk=span.span_row_walk(other))
    fd = dgt.pack_dgt(mat, rb=512, g=512, kt=8, device=cuda)
    walk = dgt.dgt_row_walk(fd)
    fd.cols.add_(0)                      # written in place since the walk was built
    with pytest.raises(ValueError, match="not built from these index planes"):
        dgt.dgt_rows_cuda(fd.wins, fd.cols, fd.lrw, fd.vals, fd.nc_p, x, rb=fd.rb, kt=8,
                          mode=fd.mode, resid=fd.resid, walk=walk)
    assert dgt.dgt_row_walk(fd) is not walk


def test_spmv_entry_points_on_card(cuda, mat):
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    want = spmm_reference(mat, x.astype(np.float64))
    for method, counter in (("auto", dg.dg1_rows_cuda), ("dgt8", dgt.dgt_rows_cuda)):
        before = counter.launches
        y = spmv_fn(mat, method)(x)
        assert y.is_cuda and y.shape == (4096,) and counter.launches == before + 1
        check_result(y.cpu().numpy(), want, rtol=2e-3)
    xs = np.random.default_rng(8).standard_normal((4096, 8)).astype(np.float32)
    for col_split in (None, 2):
        fn = spmv_multi_fn(mat, 8, col_split=col_split)
        before = dgt.dgt_rows_cuda.launches
        y = fn(xs)
        assert y.is_cuda and dgt.dgt_rows_cuda.launches == before + fn.n_splits
        check_result(y.cpu().numpy(), spmm_reference(mat, xs.astype(np.float64)), rtol=2e-3)


def _window_vs_plain(which, fmt, k, dev, stream, mode, vals=None):
    """Max error of a tile or span kernel against its plain version,
    relative to |A|·|x|; checks that the wrapper counted one launch."""
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((fmt.shape[1], k)),
                        dtype=torch.float32, device=dev)
    kt = tile.choose_kt(min(tile.default_ktile(k), 32))
    x = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
    vals = fmt.vals if vals is None else vals
    if which == "tile":
        start = fmt.chunk_tile
        kw = dict(rb=fmt.rb, ct=fmt.ct, kt=kt)
        wrapper, plain = ((tile.tile_stream_rows_cuda, tile.tile_stream_rows_plain) if stream
                          else (tile.tile_rows_cuda, tile.tile_rows_plain))
    else:
        start = fmt.c0
        kw = dict(rb=fmt.rb, kt=kt, **(dict(ct=fmt.ct) if stream else {}))
        wrapper, plain = ((span.span_stream_rows_cuda, span.span_stream_rows_plain) if stream
                          else (span.span_rows_cuda, span.span_rows_plain))
    args = (start, fmt.cols, fmt.lrow, vals, fmt.nc_p)
    walk_kw = {} if which == "tile" else dict(walk=span.span_row_walk(fmt), k=k)
    before = wrapper.launches
    got = wrapper(*args, x, mode=mode, **kw, **walk_kw)
    want = plain(*args, x, mode=mode, **kw)
    scale = plain(start, fmt.cols, fmt.lrow, vals.abs(), fmt.nc_p, x.abs(), mode="fp32", **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.shape == want.shape and got.is_cuda
    denom = torch.maximum(scale.double(), torch.ones((), dtype=torch.float64, device=dev))
    return float(((got.double() - want.double()).abs() / denom).max())


@pytest.mark.parametrize("mode,k,rb,ct,g,stream", [
    ("fp32x2", 8, 1024, 1024, 512, False), ("fp32", 32, 1024, 512, 256, False),
    ("bf16", 16, 512, 1024, 256, False), ("fp32x2", 5, 512, 1024, 256, False),
    ("fp32x2", 100, 1024, 1024, 512, False),     # Kp 128: one panel of 128
    ("fp32x2", 32, 2048, 1024, 512, False),      # rb 2048: y_rows in device memory
    ("fp32x2", 256, 1024, 1024, 512, True), ("bf16", 8, 1024, 1024, 512, True),
    ("fp32", 5, 512, 512, 256, True), ("fp32x2", 32, 2048, 1024, 512, True),
    ("bf16", 256, 1024, 1024, 512, True), ("fp32", 256, 2048, 1024, 512, True),
    ("fp32x2", 264, 1024, 1024, 512, True),      # Kp 288: one 512-column panel, masked
    ("fp32x2", 600, 512, 1024, 256, True),       # Kp 608: two panels of 512
    ("fp32x2", 64, 1024, 1024, 128, True),       # a 64-column panel, 16 lanes a stream
])
def test_tile_kernels_match_plain(cuda, mat, mode, k, rb, ct, g, stream):
    # both wrappers launch one kernel: no row tile, runs go to y_rows in
    # device memory whatever rb, the format walked once per panel
    fmt = pack_tile(create_init_metadata_set(mat), 0, out_rows=4096, rb=rb, ct=ct, g=g,
                    device=cuda)
    assert _window_vs_plain("tile", fmt, k, cuda, stream, mode) <= 1e-5
    kt = tile.choose_kt(min(k, 32))
    info = tile.tile_stream_info(tile.stream_geometry(-(-k // kt) * kt, g)[0], mode)
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2


@pytest.mark.parametrize("k", [1, 2, 5, 8, 37, 256, 520])
def test_tile_resident_kernel_widths(cuda, mat, k):
    # #5 at every panel: K 1-8 on the 8-column panel (X padded to kt 8),
    # 37 on 64 (Kp 64), 256 on one panel, 520 on two of 512 (Kp 544)
    fmt = pack_tile(create_init_metadata_set(mat), 0, out_rows=4096, rb=1024, ct=1024, g=512,
                    device=cuda)
    assert _window_vs_plain("tile", fmt, k, cuda, False, "fp32x2") <= 1e-5


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", ["longest_row", "empty_program"])
@pytest.mark.parametrize("mode,k", [("fp32x2", 256), ("bf16", 264), ("fp32", 8)])
def test_tile_stream_kernel_edges(cuda, case, mode, k, stream):
    # longest_row: row 700 holds every column, so its chunks are one row
    # (one run of 512 slots each) beside the power-law rows; empty_program:
    # rows 1024-2047 (program 1 at rb 1024) hold no nonzero
    from tpusparse_torch.io.mtx import CooMatrix

    base = builder.power_law_coo(4096, 4096, avg_nnz_per_row=8.0, seed=23)
    keep = ((base.rows < 1024) | (base.rows >= 2048) if case == "empty_program"
            else base.rows != 700)
    rows, cols, vals = base.rows[keep], base.cols[keep], base.vals[keep]
    if case == "longest_row":
        rows = np.concatenate([rows, np.full(4096, 700)])
        cols = np.concatenate([cols, np.arange(4096)])
        vals = np.concatenate([vals, np.random.default_rng(31).standard_normal(4096)])
    a = CooMatrix(rows, cols, vals.astype(np.float32), (4096, 4096))
    fmt = pack_tile(create_init_metadata_set(a), 0, out_rows=4096, rb=1024, ct=1024, g=512,
                    device=cuda)
    if case == "empty_program":
        assert not bool(fmt.vals[1].any())
    else:
        p, lr = 0, fmt.lrow.cpu().numpy()
        one_row = [(lr[p, j] == lr[p, j, 0]).all() and bool(fmt.vals[p, j].all())
                   for j in range(int(fmt.nc_p[p].item()))]
        assert any(one_row)
    runs, live = tile.row_runs(fmt)
    assert live == a.nnz and runs < live
    assert _window_vs_plain("tile", fmt, k, cuda, stream, mode) <= 1e-5


@pytest.mark.parametrize("mode,k,rb,ct,g,stream", [
    ("fp32x2", 8, 512, 1024, 512, False), ("fp32", 32, 1024, 1024, 256, False),
    ("bf16", 16, 512, 512, 512, False), ("fp32x2", 5, 256, 1024, 256, False),
    ("fp32x2", 100, 512, 1024, 512, False),
    ("fp32x2", 32, 2048, 1024, 512, False),      # rb 2048: y_rows in device memory
    ("fp32x2", 8, 512, 1024, 512, True), ("bf16", 32, 512, 1024, 512, True),
    ("fp32", 100, 1024, 4096, 512, True),        # ct 4096, Kp 128: one panel of 128
    ("fp32x2", 8, 2048, 4096, 512, True),        # rb 2048, ct 4096
    ("fp32x2", 32, 2048, 1024, 512, True),       # rb 2048: y_rows in device memory
])
def test_span_kernels_match_plain(cuda, mat, mode, k, rb, ct, g, stream):
    fmt = span.pack_span(mat, rb=rb, ct=ct, g=g, device=cuda)
    assert _window_vs_plain("span", fmt, k, cuda, stream, mode) <= 1e-5
    # #7 and #8 walk rows: no row tile, no spill, at least 2 blocks an SM
    info = span.span_walk_info(rw.walk_geometry(k)[1], mode)
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2
    if stream:  # the stream and resident wrappers share the format's one walk
        walk = fmt.walk
        assert walk is not None and span.span_row_walk(fmt) is walk
        assert _window_vs_plain("span", fmt, k, cuda, False, mode) <= 1e-5
        assert fmt.walk is walk


@pytest.mark.parametrize("k", [1, 2, 5, 37, 256, 520])
def test_span_row_walk_widths(cuda, mat, k):
    # #7 at every panel, X padded to the span K-tile (kt 8 up to K = 8); the
    # walk's own values streamed, and a copy of the plane gathered
    fmt = span.pack_span(mat, rb=512, ct=1024, g=512, device=cuda)
    assert _window_vs_plain("span", fmt, k, cuda, False, "fp32x2") <= 1e-5
    assert _window_vs_plain("span", fmt, k, cuda, False, "fp32x2",
                            vals=fmt.vals.clone()) <= 1e-5


def test_span_kernel_at_the_trainable_layer(cuda):
    # T1's format: the 90 %-pruned 4096^2 weight as TrainableSparseLinear
    # packs it, (P, NC, G) = (8, 1639, 128), the masked value plane, K = 512
    w = builder.pruned_weight_coo(4096, 4096, 0.9, seed=3)
    fmt = span.pack_span(w, rb=512, ct=512, g=128, keep_perm=True, device=cuda)
    assert (fmt.n_programs, fmt.n_chunks, fmt.chunk_g) == (8, 1639, 128)
    walk = span.span_row_walk(fmt)
    assert walk.n_slots == w.nnz and walk.runs == 4096
    mask = torch.from_numpy(sd.occupancy_mask(fmt)).to(cuda)
    plane = (fmt.vals.float() * mask).contiguous()
    assert _window_vs_plain("span", fmt, 512, cuda, False, "fp32x2", vals=plane) <= 1e-5


def test_span_value_plane_on_card(cuda, mat):
    fmt = span.pack_span(mat, rb=512, ct=1024, g=512, keep_perm=True, device=cuda)
    new = np.random.default_rng(9).standard_normal(mat.nnz).astype(np.float32)
    plane = span.with_values(fmt, new).vals
    assert _window_vs_plain("span", fmt, 8, cuda, False, "fp32x2", vals=plane) <= 1e-5
    x = np.random.default_rng(10).standard_normal((4096, 8)).astype(np.float32)
    from tpusparse_torch.io.mtx import CooMatrix
    want = spmm_reference(CooMatrix(mat.rows, mat.cols, new, mat.shape), x.astype(np.float64))
    for stream in (False, True):
        y = span.span_spmm(fmt, x, vals=plane, stream=stream)
        check_result(y.cpu().numpy(), want, rtol=2e-3)


@pytest.fixture(scope="module")
def wide():
    # 262144 columns: X of 8 fp32 columns is 8 MB, past every dg and radix
    # gate of the TPU's record, where K = 8 takes span_colsplit(2) and K = 5
    # span_onehot; the card's record takes dg_span at both
    return builder.power_law_coo(4096, 262144, avg_nnz_per_row=16.0, seed=22)


@pytest.mark.parametrize("k,family,counter,launches", [
    (8, "dg_span", "dg", 1), (5, "dg_span", "dg", 1),
    (200, "tile_onehot", "tile", 1),
])
def test_spmm_wide_and_large_paths_on_card(cuda, mat, wide, k, family, counter, launches):
    a = mat if family == "tile_onehot" else wide
    x = np.random.default_rng(k).standard_normal((a.shape[1], k)).astype(np.float32)
    assert default_schedule(a, k).family == family
    wrapper = {"dg": dg.dg_rows_cuda, "tile": tile.tile_rows_cuda}[counter]
    before = wrapper.launches
    y = tpusparse_torch.spmm(a, x)
    assert y.is_cuda and y.shape == (a.shape[0], k)
    assert wrapper.launches == before + launches
    check_result(y.cpu().numpy(), spmm_reference(a, x.astype(np.float64)), rtol=2e-3)


def test_tile_plan_and_spmv_span_on_card(cuda, mat):
    x = np.random.default_rng(11).standard_normal((4096, 40)).astype(np.float32)
    before = tile.tile_rows_cuda.launches
    plan = build_tile_plan(mat, rb=512, ct=512, g=256)
    check_result(plan(x).cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)
    assert tile.tile_rows_cuda.launches == before + 1
    v = np.random.default_rng(12).standard_normal(4096).astype(np.float32)
    want = spmm_reference(mat, v.astype(np.float64))
    fn = spmv_fn(mat, "span")
    for arg in (v, torch.as_tensor(v, device=cuda)):   # a tensor on the card is taken as is
        before = span.span_rows_cuda.launches
        y = fn(arg)
        assert y.is_cuda and y.shape == (4096,) and span.span_rows_cuda.launches == before + 1
        check_result(y.cpu().numpy(), want, rtol=2e-3)
    xs = torch.as_tensor(np.stack([v] * 3, axis=1), device=cuda)
    check_result(spmv_multi_fn(mat, 3, col_split=2)(xs).cpu().numpy(),
                 np.stack([want] * 3, axis=1), rtol=2e-3)
    check_result(spmv_fn(mat, "segment")(xs[:, 0]).cpu().numpy(), want, rtol=2e-3)


@pytest.mark.parametrize("rb,kt", [(512, 32), (1792, 8)])
def test_opt_in_is_per_library(cuda, mat, rb, kt):
    # the Block-ELL kernel (#13) and the SDDMM tile kernel (#14) each opt
    # into more than 48 KB of dynamic shared memory from their own library:
    # Block-ELL first (its bf16 wgmma kernel's four stages), then the SDDMM
    # tile kernel's three stages.  An opt-in made by one must not be taken
    # for the other's.  The row walk kernels of dg (#1, #2), radix (#9) and
    # span (no shared memory) run between and after.
    a13 = builder.block_sparse_coo(512, 512, 128, 0.5, seed=14)
    f13 = be.pack_block_ell(a13, dtype=torch.bfloat16, device=cuda)
    xb = torch.as_tensor(np.random.default_rng(15).standard_normal((512, 64)),
                         dtype=torch.float32, device=cuda)
    b13 = (f13.blkcol, f13.blkvals, f13.nb_p, xb)
    got = be.bell_rows_cuda(*b13, mode="bf16", work=f13.work)
    scale = be.bell_rows_plain(f13.blkcol, f13.blkvals.abs(), f13.nb_p, xb.abs(), mode="bf16")
    assert _rel_to_scale(got, be.bell_rows_plain(*b13, mode="bf16"), scale) <= 1e-5
    x = torch.as_tensor(np.random.default_rng(13).standard_normal((4096, kt)),
                        dtype=torch.float32, device=cuda)
    f1 = dg.pack_dg(mat, rb=16384, ns=4, g=2048, kt=1, device=cuda)
    args = (f1.c0, f1.cols, f1.lrow, f1.vals, f1.nc_p, x[:, 0].contiguous())
    torch.testing.assert_close(dg.dg1_rows_cuda(*args, rb=16384, walk=dg.dg_row_walk(f1)),
                               dg.dg1_rows_plain(*args, rb=16384), rtol=1e-5, atol=1e-4)
    f = dg.pack_dg(mat, rb=rb, ns=8, g=512, kt=kt, device=cuda)
    args = (f.c0, f.cols, f.lrow, f.vals, f.nc_p, x)
    torch.testing.assert_close(dg.dg_rows_cuda(*args, rb=rb, kt=kt, mode="fp32x2",
                                               walk=dg.dg_row_walk(f)),
                               dg.dg_rows_plain(*args, rb=rb, kt=kt, mode="fp32x2"),
                               rtol=1e-5, atol=1e-4)
    r = radix.pack_radix(mat, rb=rb, S=128, g=512, kt=kt, device=cuda)
    args = (r.c0, r.cols, r.lrow, r.vals, r.nc_p, x)
    torch.testing.assert_close(radix.radix_rows_cuda(*args, rb=rb, kt=kt, mode=r.mode,
                                                     walk=radix.radix_row_walk(r)),
                               radix.radix_rows_plain(*args, rb=rb, kt=kt, mode=r.mode),
                               rtol=1e-5, atol=1e-4)
    s = span.pack_span(mat, rb=rb, ct=1024, g=512, keep_perm=True, device=cuda)
    assert _window_vs_plain("span", s, kt, cuda, False, "fp32") <= 1e-5
    assert _sddmm_vs_plain(s, kt, "fp32", cuda, min_slots=1) <= 1e-5   # every tile dense
    got = be.bell_rows_cuda(*b13, mode="bf16", work=f13.work)
    assert _rel_to_scale(got, be.bell_rows_plain(*b13, mode="bf16"), scale) <= 1e-5


def _err(got, want, scale, dev):
    torch.cuda.synchronize()
    denom = torch.maximum(scale.double(), torch.ones((), dtype=torch.float64, device=dev))
    return float(((got.double() - want.double()).abs() / denom).max())


def _radix_vs_plain(fmt, k, kt, dev):
    """Max error of the radix wrapper (#9: the row walk kernels over the
    format's walk) against its plain version at K = k, X padded to kt,
    relative to |A|·|x|; checks that it counted one launch."""
    x = np.random.default_rng(14).standard_normal((fmt.shape[1], k))
    x = dg.pad_dense_cols(torch.as_tensor(x, dtype=torch.float32, device=dev),
                          -(-k // kt) * kt).contiguous()
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, x)
    kw = dict(rb=fmt.rb, kt=kt, mode=fmt.mode)
    before = radix.radix_rows_cuda.launches
    got = radix.radix_rows_cuda(*args, **kw, walk=radix.radix_row_walk(fmt), k=k)
    assert radix.radix_rows_cuda.launches == before + 1
    assert got.shape == (fmt.n_programs * fmt.rb, x.shape[1])
    want = radix.radix_rows_plain(*args, **kw)
    scale = radix.radix_rows_plain(fmt.c0, fmt.cols, fmt.lrow, fmt.vals.abs(), fmt.nc_p,
                                   x.abs(), **dict(kw, mode="fp32x2"))
    return _err(got, want, scale, dev)


@pytest.mark.parametrize("kt,mode,k,rb", [
    (1, "fp32x2", 1, 2048), (2, "fp32x2", 2, 1024), (4, "fp32x2", 4, 1024),
    (4, "fp32x2", 3, 1024), (8, "fp32x2", 8, 1024), (16, "fp32x2", 40, 1024),
    (32, "fp32x2", 32, 768), (1, "bf16", 1, 2048), (2, "bf16", 2, 1024), (4, "bf16", 4, 1024),
    (8, "bf16", 16, 1024), (32, "bf16", 32, 2048), (1, "fp32x2", 3, 1024),
])
def test_radix_kernel_matches_plain(cuda, mat, kt, mode, k, rb):
    # kt = 1 at K = 1 takes the one-column walk (bf16 rounding each
    # product), every other case the walk kernel over all of X's columns
    fmt = radix.pack_radix(mat, rb=rb, S=128, g=1024, kt=kt, mode=mode, device=cuda)
    assert _radix_vs_plain(fmt, k, kt, cuda) <= 1e-5
    assert fmt.walk is not None and fmt.walk.n_slots == mat.nnz


@pytest.mark.parametrize("case", ["longest_row", "empty_program", "stored_zero"])
@pytest.mark.parametrize("kt,mode", [(1, "fp32x2"), (1, "bf16"), (4, "fp32x2"), (8, "bf16")])
def test_radix_row_walk_edges(cuda, case, kt, mode):
    # longest_row: one run of 4096 slots, past a block's share of the walk
    # kernel (2048 slots) and of the one-column walk (1024); the brick-ELL
    # cut of the same matrix keeps no perm_of_nz (live slots from values)
    a = _edge_coo(case)
    empty, keep_perm = case == "empty_program", case == "stored_zero"
    fmt = radix.pack_radix(a, rb=1024, S=128, g=512, kt=kt, mode=mode,
                           deal="blocks" if empty else None, keep_perm=keep_perm, device=cuda)
    walk = radix.radix_row_walk(fmt)
    if case == "longest_row":
        assert int(torch.unique_consecutive(walk.row, return_counts=True)[1].max()) == 4096
    if keep_perm:
        assert walk.n_slots == a.nnz > int(np.count_nonzero(a.vals))
    assert _radix_vs_plain(fmt, kt, kt, cuda) <= 1e-5
    from tpusparse_torch import ops
    from tpusparse_torch.levels import Level

    ms = create_init_metadata_set(a)
    ex = ops.OperatorExecutor(ms)
    for op in (ops.SortOperator(0), ops.FixedIntervalRowBlockingOperator(0, Level.TBLOCK, 8),
               ops.EllBlockPadOperator(0, Level.TBLOCK),
               ops.InterleaveStorageOperator(0, Level.TBLOCK)):
        ex.add_and_run(op)
    fb = radix.pack_brick_ell(ms, 0, out_rows=4096, rb=1024, S=128, g=512, kt=kt, mode=mode,
                              device=cuda)
    assert radix.radix_row_walk(fb).live_from_values
    assert _radix_vs_plain(fb, kt, kt, cuda) <= 1e-5


def test_spmv_radix_walk_on_card(cuda, spmv_size):
    # P12: spmv_fn(mat, "radix") at the SpMV size, x as one column through
    # the one-column walk, against the oracle
    v = np.random.default_rng(21).standard_normal(262144).astype(np.float32)
    fn = spmv_fn(spmv_size, "radix")
    before = radix.radix_rows_cuda.launches
    y = fn(v)
    assert y.is_cuda and y.shape == (262144,) and radix.radix_rows_cuda.launches == before + 1
    assert fn.format.walk is not None and fn.format.walk.n_slots == spmv_size.nnz
    check_result(y.cpu().numpy(), spmm_reference(spmv_size, v.astype(np.float64)), rtol=2e-3)


def _stripe_vs_plain(fmt, k, dev, vals=None):
    """Max error of the stripe kernel against its plain version at K = k
    (X padded to the stripe K-tile), relative to |A|·|x|, on the format
    or on ``vals`` in its place; checks that the wrapper counted one
    launch."""
    vals = fmt.vals if vals is None else vals
    kt = stripe.choose_kt(k)
    x = torch.as_tensor(np.random.default_rng(15).standard_normal((fmt.shape[1], k)),
                        dtype=torch.float32, device=dev)
    x = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
    rb = getattr(fmt, "max_rows_per_stripe", None) or fmt.max_segments
    before = stripe.stripe_rows_cuda.launches
    got = stripe.stripe_rows_cuda(fmt.cols, fmt.lrow, vals, x, rb=rb, kt=kt, live=fmt.live_p)
    assert stripe.stripe_rows_cuda.launches == before + 1
    want = stripe.stripe_rows_plain(fmt.cols, fmt.lrow, vals, x, rb=rb)
    scale = stripe.stripe_rows_plain(fmt.cols, fmt.lrow, vals.abs(), x.abs(), rb=rb)
    assert got.shape == want.shape
    return _err(got, want, scale, dev)


@pytest.mark.parametrize("work,val_dtype,k", [
    (512, None, 8), (2048, None, 1), (2048, "bfloat16", 4), (512, "bfloat16", 40),
    (20000, None, 32),                     # rb = 2500: a stripe of long rows, several blocks
    (2048, None, 2), (2048, "bfloat16", 33), (512, None, 256), (512, "bfloat16", 256),
    ("segment", None, 1), ("segment", None, 2), ("segment", None, 8), ("segment", None, 33),
    ("segment", None, 256),
])
def test_stripe_kernel_matches_plain(cuda, mat, work, val_dtype, k):
    if work == "segment":
        fmt = build_plan(mat, Schedule(family="nnz_segment", work_per_block=2048, unroll=8),
                         device=cuda).formats[0]
    else:
        fmt, _ = prepare_stripe_format(mat, work_per_stripe=work, val_dtype=val_dtype,
                                       device=cuda)
    assert _stripe_vs_plain(fmt, k, cuda) <= 1e-5
    pw = stripe.stripe_geometry(-(-k // stripe.choose_kt(k)) * stripe.choose_kt(k))[1]
    info = stripe.stripe_info(pw, fmt.vals.dtype == torch.bfloat16)
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2


def stripe_by_hand(device, long_row=4471, n=4096, seed=43, bf16=False):
    """A StripeFormat (P = 4, rb = 64) built slot by slot, its live slots a
    prefix of each stripe: stripe 0 holds a row of ``long_row`` slots
    beside short rows, so the row is cut over several blocks of the stripe
    kernel; stripe 1 has no live slot; stripe 2 ends its live part with a
    stored zero (value 0 inside the live slots, see ``STORED_ZERO``);
    stripe 3 holds stored zeros among its short rows.  Padding: value 0,
    the column of the stripe's last live slot.  ``bf16``: the value plane
    in bf16."""
    from tpusparse_torch.format import stripe_format_from_numpy

    rng = np.random.default_rng(seed)

    def rows(*runs):  # (lrow, count) runs -> lrow array
        return np.concatenate([np.zeros(0)] + [np.full(c, r) for r, c in runs]).astype(np.int32)

    stripes = [rows((0, 3), (1, 1), (2, long_row), (5, 4)), rows(),
               rows((0, 2), (1, 7), (3, 30)), rows((0, 5), (2, 9), (7, 40))]
    P, rb = len(stripes), 64
    C = max(len(s) for s in stripes) + 24
    cols = np.zeros((P, 1, C), np.int32)
    lrow = np.zeros((P, 1, C), np.int32)
    vals = np.zeros((P, 1, C), np.float32)
    live = np.array([len(s) for s in stripes], np.int32)
    for p, lr in enumerate(stripes):
        cols[p, 0, :len(lr)] = rng.integers(0, n, len(lr))
        lrow[p, 0, :len(lr)] = lr
        vals[p, 0, :len(lr)] = rng.standard_normal(len(lr))
        if len(lr):  # padding repeats the last live slot's row and column
            cols[p, 0, len(lr):], lrow[p, 0, len(lr):] = cols[p, 0, len(lr) - 1], lr[-1]
    vals[STORED_ZERO] = 0.0
    vals[3, 0, [1, 6, 20, 53]] = 0.0
    fields = dict(cols=cols, lrow=lrow, vals=vals, live_p=live,
                  slot_of_origrow=np.arange(P * rb, dtype=np.int32))
    fmt = stripe_format_from_numpy(fields, device=device, n_stripes=P, stripe_nnz=C,
                                   max_rows_per_stripe=rb, shape=(P * rb, n),
                                   nnz_real=int(np.count_nonzero(vals)))
    return dataclasses.replace(fmt, vals=fmt.vals.bfloat16()) if bf16 else fmt


#: stripe_by_hand's stored zero: the last live slot of stripe 2
STORED_ZERO = (2, 0, 38)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8, 33, 256])
def test_stripe_kernel_edges(cuda, k, bf16):
    fmt = stripe_by_hand(cuda, bf16=bf16)
    ranges = stripe.stripe_slot_ranges(fmt.live_p.cpu(), fmt.stripe_nnz,
                                       stripe.stripe_geometry(k)[2])
    assert (ranges[0, :, 1] > ranges[0, :, 0]).sum() >= 3     # the long row over 3-9 blocks
    assert not (ranges[1, :, 1] > ranges[1, :, 0]).any()       # the stripe with no live slot
    assert _stripe_vs_plain(fmt, k, cuda) <= 1e-5
    # the stored zero made nonzero after packing, as training or
    # load_state_dict would: inside the live part, so walked
    vals = fmt.vals.clone()
    vals[STORED_ZERO] = 3.0
    assert _stripe_vs_plain(fmt, k, cuda, vals=vals) <= 1e-5


def _nested_vs_plain(fmt, k, dev):
    """Max error of the nested kernel against its plain version at K = k
    (X padded to the stripe K-tile), relative to |A|·|x|; checks that the
    wrapper counted one launch."""
    kt = stripe.choose_kt(k)
    x = torch.as_tensor(np.random.default_rng(16).standard_normal((fmt.shape[1], k)),
                        dtype=torch.float32, device=dev)
    x = dg.pad_dense_cols(x, -(-k // kt) * kt).contiguous()
    args = (fmt.cols, fmt.lrow, fmt.vals, fmt.wnz, fmt.wrow, x)
    rb = fmt.max_rows_per_stripe
    before = stripe.stripe_nested_rows_cuda.launches
    got = stripe.stripe_nested_rows_cuda(*args, rb=rb, kt=kt)
    assert stripe.stripe_nested_rows_cuda.launches == before + 1
    want = stripe.stripe_nested_rows_plain(*args, rb=rb)
    scale = stripe.stripe_nested_rows_plain(fmt.cols, fmt.lrow, fmt.vals.abs(), fmt.wnz,
                                            fmt.wrow, x.abs(), rb=rb)
    assert got.shape == want.shape
    return _err(got, want, scale, dev)


@pytest.mark.parametrize("work,k", [(4096, 1), (4096, 2), (4096, 5), (4096, 8), (4096, 37),
                                    (4096, 256), (4096, 520), (60000, 32)])
def test_stripe_nested_kernel_matches_plain(cuda, mat, work, k):
    # panels of 4 (K 1-2, X read padded to 4 columns; K 5 at kt 8), 8, 64
    # (K 37), 256, two of 512 (K 520, Kp 544) and 32 on a 60000-slot stripe
    fmt = build_plan(mat, Schedule(family="stripe_nested", work_per_block=work, unroll=8),
                     device=cuda).formats[0]
    assert _nested_vs_plain(fmt, k, cuda) <= 1e-5
    info = stripe.stripe_nested_info(stripe.nested_geometry(-(-k // stripe.choose_kt(k))
                                                            * stripe.choose_kt(k))[1])
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    assert info["blocks_per_sm"] >= 2


def nested_by_hand(device, long_row=4471, n=4096, seed=41):
    """A NestedStripeFormat (W = 4, unroll 8, rb = 64) built slot by slot:
    stripe 0 holds a row of ``long_row`` slots cut over sub-blocks 0, 2 and
    3 (sub-block 1 between them is empty) and so over several blocks of the
    nested kernel, beside short rows; stripe 1 is all padding (values 0
    inside its sub-blocks); stripe 2 holds no sub-block slot (wnz all 0);
    stripe 3 holds short rows and a value past its last sub-block, which is
    not walked."""
    from tpusparse_torch.format import nested_format_from_numpy

    rng = np.random.default_rng(seed)
    third = long_row // 3

    def rows(*runs):  # (lrow, count) runs -> lrow array
        return np.concatenate([np.zeros(0)] + [np.full(c, r) for r, c in runs]).astype(np.int32)

    # per stripe: sub-blocks as (wrow, lrow array, all values zero)
    stripes = [
        [(0, rows((0, 3), (1, 1), (2, 5), (3, third)), False), (3, rows(), False),
         (3, rows((0, long_row - 2 * third), (1, 2)), False),
         (3, rows((0, third), (7, 4)), False)],
        [(0, rows((0, 5), (1, 3)), True), (2, rows((0, 9)), True), (5, rows(), True),
         (5, rows(), True)],
        [(0, rows(), False)] * 4,
        [(0, rows((0, 2), (1, 7)), False), (2, rows((0, 1), (3, 30)), False),
         (6, rows((0, 6)), False), (9, rows((1, 11)), False)],
    ]
    P, W, rb = len(stripes), 4, 64
    sizes = [sum(-(-len(lr) // 8) * 8 for _, lr, _ in s) for s in stripes]
    C = max(sizes) + 8                                  # room past the last sub-block
    cols = np.zeros((P, 1, C), np.int32)
    lrow = np.zeros((P, 1, C), np.int32)
    vals = np.zeros((P, 1, C), np.float32)
    wnz = np.zeros((P, 1, W + 1), np.int32)
    wrow = np.zeros((P, 1, W + 1), np.int32)
    for p, subs in enumerate(stripes):
        pos = 0
        for w, (r0, lr, zero) in enumerate(subs):
            wnz[p, 0, w], wrow[p, 0, w] = pos, r0
            cols[p, 0, pos:pos + len(lr)] = rng.integers(0, n, len(lr))
            lrow[p, 0, pos:pos + len(lr)] = lr
            if not zero:
                vals[p, 0, pos:pos + len(lr)] = rng.standard_normal(len(lr))
            pos += -(-len(lr) // 8) * 8
        wnz[p, 0, W], wrow[p, 0, W] = pos, rb
    vals[3, 0, sizes[3]] = 7.0                          # past the last sub-block
    fields = dict(cols=cols, lrow=lrow, vals=vals, wnz=wnz, wrow=wrow,
                  slot_of_origrow=np.arange(P * rb, dtype=np.int32))
    return nested_format_from_numpy(fields, device=device, n_stripes=P, stripe_nnz=C,
                                    n_warps=W, max_rows_per_stripe=rb, shape=(P * rb, n),
                                    nnz_real=int(np.count_nonzero(vals)))


@pytest.mark.parametrize("k", [1, 2, 8, 37, 256, 520])
def test_stripe_nested_kernel_edges(cuda, k):
    fmt = nested_by_hand(cuda)
    ranges = stripe.nested_slot_ranges(fmt.wnz.cpu(), fmt.stripe_nnz)
    assert (ranges[0, :, 1] > ranges[0, :, 0]).sum() >= 5     # the long row over 5 blocks
    assert not (ranges[2, :, 1] > ranges[2, :, 0]).any()       # the empty stripe
    runs, live = stripe.nested_row_runs(fmt)
    assert live == int(fmt.vals.count_nonzero()) - 1 and runs < live
    assert _nested_vs_plain(fmt, k, cuda) <= 1e-5


@pytest.fixture(scope="module")
def spmv_size():
    # P8: the SpMV workload's matrix, where spmm's default at K = 4 is radix
    # on both records (the card keeps the TPU's decision at K = 2-4)
    return builder.power_law_coo(262144, 262144, avg_nnz_per_row=40.0, seed=9)


def test_spmm_radix_default_on_card(cuda, spmv_size):
    x = torch.as_tensor(np.random.default_rng(17).standard_normal((262144, 4)),
                        dtype=torch.float32, device=cuda)
    sched = default_schedule(spmv_size, 4)
    assert (sched.family, sched.ktile) == ("radix_span", 4)
    assert sched == default_schedule(spmv_size, 4, gates=TPU_GATES)
    before = radix.radix_rows_cuda.launches
    y = tpusparse_torch.spmm(spmv_size, x)
    assert y.is_cuda and y.shape == (262144, 4) and radix.radix_rows_cuda.launches == before + 1
    check_result(y.cpu().numpy(), spmm_reference(spmv_size, x.cpu().numpy().astype(np.float64)),
                 rtol=2e-3)


@pytest.mark.parametrize("kw,counter,launches", [
    (dict(family="stripe_total", work_per_block=512), "stripe", 1),
    (dict(family="stripe_total", blocking="fixed_rows", row_interval=256), "stripe", 1),
    (dict(family="stripe_nested", work_per_block=4096), "nested", 1),
    (dict(family="nnz_segment", work_per_block=2048), "stripe", 1),
    (dict(family="segment_span", work_per_block=4096, ct=512, g=256), "span", 1),
    (dict(family="bucketed", bucket_bounds=(128,)), "span", 2),
    (dict(family="brick_ell", sort=True, rb=1024, sublanes=256, g=512, ktile=8), "radix", 1),
])
def test_stripe_segment_families_on_card(cuda, kw, counter, launches):
    a = builder.banded_coo(4096, 4096, bandwidth=8, seed=23) if kw["family"] == "brick_ell" \
        else builder.power_law_coo(4096, 4096, avg_nnz_per_row=16.0, seed=21)
    wrapper = {"stripe": stripe.stripe_rows_cuda, "nested": stripe.stripe_nested_rows_cuda,
               "span": span.span_rows_cuda, "radix": radix.radix_rows_cuda}[counter]
    x = np.random.default_rng(18).standard_normal((4096, 8)).astype(np.float32)
    plan = build_plan(a, Schedule(**kw))
    before = wrapper.launches
    y = plan(x)
    assert y.is_cuda and wrapper.launches == before + launches
    check_result(y.cpu().numpy(), spmm_reference(a, x.astype(np.float64)), rtol=2e-3)


def test_stripe_plan_and_spmv_radix_stripe_on_card(cuda, mat):
    x = np.random.default_rng(19).standard_normal((4096, 8)).astype(np.float32)
    check_result(build_stripe_plan(mat)(x).cpu().numpy(),
                 spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)
    v = np.random.default_rng(20).standard_normal(4096).astype(np.float32)
    want = spmm_reference(mat, v.astype(np.float64))
    for method, wrapper in (("radix", radix.radix_rows_cuda), ("stripe", stripe.stripe_rows_cuda)):
        fn = spmv_fn(mat, method)
        for arg in (v, torch.as_tensor(v, device=cuda)):
            before = wrapper.launches
            y = fn(arg)
            assert y.is_cuda and y.shape == (4096,) and wrapper.launches == before + 1
            check_result(y.cpu().numpy(), want, rtol=2e-3)


def _rel_to_scale(got, want, scale):
    denom = torch.maximum(scale.double(), torch.ones((), dtype=torch.float64,
                                                      device=scale.device))
    return float(((got.double() - want.double()).abs() / denom).max())


@functools.cache
def _nm_case(m, n, n_keep, group, dtype):
    """An N:M weight (n cut to whole groups) packed on the card, cached
    across the modes that share it."""
    w = builder.nm_pruned_dense(m, n // group * group, n_keep, group, seed=4)
    return w, nm.pack_nm(w, n_keep=n_keep, group=group, dtype=dtype, device="cuda")


@pytest.mark.parametrize("n_keep,group", [(2, 4), (1, 4), (4, 8), (3, 6), (48, 128)])
@pytest.mark.parametrize("dtype,mode", [(torch.bfloat16, "bf16"), (torch.bfloat16, "fp32"),
                                        (torch.float32, "bf16"), (torch.float32, "fp32"),
                                        (torch.int8, "bf16")])
@pytest.mark.parametrize("m,n,k", [(300, 1024, 37), (1024, 2048, 128), (300, 1024, 1),
                                   (4096, 4096, 520)])
def test_nm_kernel_matches_plain(cuda, n_keep, group, dtype, mode, m, n, k):
    # 3:6 and 48:128 straddle the kernel's 64-column depth steps and read
    # their slots from device memory; the others are staged by cp.async
    w, fmt = _nm_case(m, n, n_keep, group, dtype)
    n = w.shape[1]
    bits = max(int(np.ceil(np.log2(group))), 1)
    assert fmt.packed_bits == (bits if n_keep * bits <= 8 else 0)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((n, k)),
                        dtype=torch.float32, device=cuda)
    kw = dict(group=group, packed_bits=fmt.packed_bits, mode=mode)
    before = nm.nm_rows_cuda.launches
    got = nm.nm_rows_cuda(fmt.vals, fmt.offs, x, **kw)
    assert nm.nm_rows_cuda.launches == before + 1 and got.shape == (fmt.m_pad, k)
    want = nm.nm_rows_plain(fmt.vals, fmt.offs, x, **kw)
    scale = nm.nm_rows_plain(fmt.vals.abs(), fmt.offs, x.abs(), **kw)
    torch.cuda.synchronize()
    assert _rel_to_scale(got, want, scale) <= 1e-5


def bell_case(bs, seed):
    """A block-sparse 1024 x 768 weight (128-blocks, density 0.4) with the
    rows [128, 256) and [768, 1024) emptied: at BS = 64, 128 and 256 some
    row-blocks have no real block (nb_p = 0), some one work item alone and
    some several (their partials added into y)."""
    a = builder.block_sparse_coo(1024, 768, 128, 0.4, seed=seed)
    keep = ~(((a.rows >= 128) & (a.rows < 256)) | (a.rows >= 768))
    return a.__class__(a.rows[keep], a.cols[keep], a.vals[keep], a.shape)


@pytest.mark.parametrize("bs", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 40, 72, 256, 300])
def test_bell_kernel_matches_plain(cuda, bs, dtype, mode, k):
    # each run of a shared row-block adds its partial into y with atomics, in
    # an order that changes from run to run: the sums of one row differ in
    # their last bits only, far inside 1e-5 of |A|·|x|
    fmt = be.pack_block_ell(bell_case(bs, bs), bs=bs, dtype=dtype, device=cuda)
    alone = fmt.work[:, 3]
    assert (fmt.nb_p == 0).any() and (alone == 0).any() and (alone == 1).any()
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((768, k)),
                        dtype=torch.float32, device=cuda)
    before = be.bell_rows_cuda.launches
    got = be.bell_rows_cuda(fmt.blkcol, fmt.blkvals, fmt.nb_p, x, mode=mode, work=fmt.work)
    assert be.bell_rows_cuda.launches == before + 1
    want = be.bell_rows_plain(fmt.blkcol, fmt.blkvals, fmt.nb_p, x, mode=mode)
    scale = be.bell_rows_plain(fmt.blkcol, fmt.blkvals.abs(), fmt.nb_p, x.abs(), mode=mode)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_to_scale(got, want, scale) <= 1e-5


@pytest.mark.parametrize("bs", [64, 128, 256])
@pytest.mark.parametrize("k", [1, 40, 72, 256, 300])
def test_bell_kernel_int8_is_exact(cuda, bs, k):
    fmt = be.pack_block_ell(bell_case(bs, bs), bs=bs, dtype=torch.int8, device=cuda)
    xq = torch.randint(-127, 128, (768, k), dtype=torch.int8, device=cuda)
    got = be.bell_rows_cuda(fmt.blkcol, fmt.blkvals, fmt.nb_p, xq, mode="int8", work=fmt.work)
    want = be.bell_rows_plain(fmt.blkcol, fmt.blkvals, fmt.nb_p, xq, mode="int8")
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # X^T handed as the transposed view bell_int8 passes: the same product
    got_t = be.bell_rows_cuda(fmt.blkcol, fmt.blkvals, fmt.nb_p, xq.t().contiguous().t(),
                              mode="int8", work=fmt.work)
    assert torch.equal(got_t, want)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_bell_kernel_resources(cuda, mode):
    info = be.bell_kernel_info(mode)
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1


@pytest.fixture(scope="module")
def nm_weight():
    # P13's weight: a 2:4-pruned 4096 x 4096 projection
    return builder.nm_pruned_dense(4096, 4096, 2, 4, seed=5)


@pytest.mark.parametrize("precision,mode", [("bf16", "compact"), ("fp32", "compact"),
                                            ("int8", "compact"), ("bf16", "throughput")])
def test_sparse_linear_nm_on_card(cuda, nm_weight, precision, mode):
    # a [4, 128, 4096] activation: the folded X is a transposed view
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((4, 128, 4096)),
                        dtype=torch.float32, device=cuda)
    layer = SparseLinear.from_nm(nm_weight, precision=precision, mode=mode)
    before = nm.nm_rows_cuda.launches
    y = layer(x)
    assert y.is_cuda and y.shape == (4, 128, 4096) and y.dtype == torch.float32
    assert nm.nm_rows_cuda.launches == before + (mode == "compact")
    want = x.double().cpu().numpy() @ nm_weight.astype(np.float64).T
    scale = np.abs(x.double().cpu().numpy()) @ np.abs(nm_weight.astype(np.float64)).T
    err = np.abs(y.double().cpu().numpy() - want)
    if precision == "fp32":
        assert (err / np.maximum(scale, 1.0)).max() <= 1e-5
    elif precision == "int8":
        assert (err / np.maximum(scale, 1e-30)).max() < 2e-2
    else:
        assert err.max() / np.abs(want).max() < 1e-2


@pytest.mark.parametrize("precision", ["bf16", "fp32", "int8"])
def test_sparse_linear_block_on_card(cuda, precision):
    a = builder.block_sparse_coo(2048, 2048, 128, 0.15, seed=6)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((2, 64, 2048)),
                        dtype=torch.float32, device=cuda)
    layer = SparseLinear.from_block(a, precision=precision)
    before = be.bell_rows_cuda.launches
    y = layer(x)
    assert y.is_cuda and y.shape == (2, 64, 2048)
    assert be.bell_rows_cuda.launches == before + 1  # the kernel: the card's default method
    w = a.to_dense(np.float64)
    xs = x.double().cpu().numpy()
    want, scale = xs @ w.T, np.abs(xs) @ np.abs(w).T
    err = np.abs(y.double().cpu().numpy() - want)
    if precision == "fp32":
        assert (err / np.maximum(scale, 1.0)).max() <= 1e-5
    elif precision == "int8":  # rows of no block: 0 of 0
        assert (err / np.maximum(scale, 1e-30)).max() < 4e-2
    else:
        assert err.max() / np.abs(want).max() < 1e-2
    fmt = be.pack_block_ell(a, dtype=torch.bfloat16 if precision == "bf16" else torch.float32,
                            device=cuda) if precision != "int8" else None
    if fmt is not None:  # the kernel path against the batched product
        xk = x.reshape(-1, 2048).T.contiguous()
        ya = be.block_ell_spmm(fmt, xk, precision=precision, method="pallas")
        yb = be.block_ell_spmm(fmt, xk, precision=precision, method="xla")
        assert float((ya - yb).abs().max()) <= 1e-5 * float(yb.abs().max() + 1)


@pytest.mark.parametrize("kw,a_of,counter", [
    (dict(family="dense", precision="bf16"), "mat", None),
    (dict(family="dense"), "mat", None),
    (dict(family="block_ell", precision="bf16", row_interval=128), "blocky", None),
    (dict(family="hybrid_cols", hot_cols=512, ktile=8, precision="bf16"), "colskew", "dg"),
])
def test_dense_tile_families_on_card(cuda, mat, kw, a_of, counter):
    a = {"mat": mat, "blocky": builder.block_sparse_coo(4096, 4096, 128, 0.15, seed=6),
         "colskew": builder.power_law_col_coo(4096, 4096, 16, alpha=1.6, seed=9)}[a_of]
    x = np.random.default_rng(21).standard_normal((4096, 8)).astype(np.float32)
    plan = build_plan(a, Schedule(**kw))
    before = dg.dg_rows_cuda.launches
    y = plan(x)
    assert y.is_cuda and y.shape == (4096, 8) and y.dtype == torch.float32
    if counter:
        assert dg.dg_rows_cuda.launches == before + 1 and plan.meta["n_subs"] == 2
    want = spmm_reference(a, x.astype(np.float64))
    bf16 = kw.get("precision") == "bf16"
    scale = spmm_reference(a.__class__(a.rows, a.cols, np.abs(a.vals), a.shape),
                           np.abs(x.astype(np.float64))) if bf16 else None
    check_result(y.cpu().numpy(), want, rtol=1e-2 if bf16 else 2e-3, scale=scale)


def test_dense_tile_kernels_refuse_rather_than_fall_back(cuda):
    from tpusparse_torch.kernels.common import launch_checked

    a = builder.block_sparse_coo(480, 480, 96, 0.3, seed=1)
    x = torch.zeros((480, 8), device=cuda)
    odd = be.pack_block_ell(a, bs=48, device=cuda)   # BS not a multiple of 32
    with pytest.raises(ValueError, match="bs 48"):
        be.block_ell_spmm(odd, x, precision="fp32", method="pallas")
    fmt = be.pack_block_ell(a, bs=64, device=cuda)
    y = torch.empty((fmt.mb * 64, 8), device=cuda)
    xp = be.pad_dense_rows(x, 512).contiguous()
    with pytest.raises(RuntimeError, match="CUDA error"):   # mode 7: refused by the launcher
        launch_checked(be._lib().bell_spmm_launch, "bell_spmm_launch",
                       (fmt.blkcol, fmt.blkvals, fmt.work, xp, y),
                       (fmt.work.shape[0], fmt.bmax, 64, 8, 8, 8, 7))
    w = builder.nm_pruned_dense(64, 128, seed=2)
    f = nm.pack_nm(w, device=cuda)
    with pytest.raises(ValueError, match="X must be"):
        nm.nm_rows_cuda(f.vals, f.offs, torch.zeros((128, 8), device=cuda).double(),
                        group=4, packed_bits=2, mode="bf16")
    with pytest.raises(ValueError, match="X is on cpu"):
        nm.nm_spmm(f, torch.zeros((128, 8)))


def _sddmm_vs_plain(fmt, k, mode, dev, min_slots=None, kt=None):
    """Max error of #14 (the tile kernel over the dense tiles, the per-slot
    kernel over the rest) against its plain version at every slot of the
    plane, padding and chunks past nc_p included, relative to |dY|·|X|;
    ``min_slots``: the threshold of a dense tile (None: the mode's,
    ``TILE_MIN_SLOTS``).  Checks one counted launch."""
    kt = kt or min(32, max(8, 1 << (k - 1).bit_length()))
    kp = -(-k // kt) * kt
    gen = torch.Generator(device=dev).manual_seed(k)
    n, rows = fmt.shape[1], fmt.n_programs * fmt.rb
    x = torch.zeros((n, kp), device=dev)
    x[:, :k] = torch.randn((n, k), generator=gen, device=dev)
    dy = torch.zeros((rows, kp), device=dev)
    dy[:, :k] = torch.randn((rows, k), generator=gen, device=dev)
    planes = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    before = sd.sddmm_rows_cuda.launches
    got = sd.sddmm_rows_cuda(*planes, dy, x, rb=fmt.rb, kt=kt, mode=mode,
                             tiles=sd.sddmm_tiles(fmt), min_slots=min_slots)
    assert sd.sddmm_rows_cuda.launches == before + 1
    want = sd.sddmm_rows_plain(*planes, dy, x, rb=fmt.rb, kt=kt, mode=mode)
    scale = sd.sddmm_rows_plain(*planes, dy.abs(), x.abs(), rb=fmt.rb, kt=kt, mode="fp32")
    torch.cuda.synchronize()
    return float(((got - want).abs() / scale.clamp(min=1e-30)).max())


@pytest.mark.parametrize("k", [12, 20, 24])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_sddmm_kernels_match_plain(cuda, k, mode):
    """#14 and #15 against their plain versions at the JAX tests' shape,
    K-tile 8 (the K loop and its tail): 1e-5 of |dY|·|X| and |A|^T·|dY|
    (the same products, summed in another order).  #14 through the
    format's own tile index (per-slot: the tiles are sparse) and an index
    whose every tile is dense (the tile kernel); #15 through the format's
    column index."""
    a = builder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0)
    fmt = span.pack_span(a, rb=64, ct=128, g=64, keep_perm=True, device=cuda)
    for min_slots in (None, 1):
        assert _sddmm_vs_plain(fmt, k, mode, cuda, min_slots=min_slots, kt=8) <= 1e-5
    rng = np.random.default_rng(k)
    kp = -(-k // 8) * 8
    dy = torch.zeros((fmt.n_programs * 64, kp), device=cuda)
    dy[:, :k] = torch.as_tensor(rng.standard_normal((fmt.n_programs * 64, k)),
                                dtype=torch.float32)
    planes = (fmt.c0, fmt.cols, fmt.lrow)
    before = sd.dx_rows_cuda.launches
    got = sd.dx_rows_cuda(*planes, fmt.vals, fmt.nc_p, dy, n=260, rb=64, kt=8, mode=mode,
                          index=sd.dx_index(fmt))
    want = sd.dx_rows_plain(*planes, fmt.vals, fmt.nc_p, dy, n=260, rb=64, kt=8, mode=mode)
    scale = sd.dx_rows_plain(*planes, fmt.vals.abs(), fmt.nc_p, dy.abs(), n=260, rb=64, kt=8,
                             mode="fp32")
    torch.cuda.synchronize()
    assert got.shape == (260, kp) and bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())
    assert sd.dx_rows_cuda.launches == before + 1


def _half_dense_coo(m=1024, n=1024, seed=24):
    """A weight whose first half of rows is 90 % pruned (about 800 slots a
    tile of 128 x 64) and second half 99.5 % (about 40): dealt to programs
    in blocks of rows, its tiles take both of #14's paths."""
    from tpusparse_torch.io.mtx import CooMatrix

    rng = np.random.default_rng(seed)
    keep = rng.random((m, n)) < np.where(np.arange(m)[:, None] < m // 2, 0.1, 0.005)
    rows, cols = np.nonzero(keep)
    return CooMatrix(rows, cols, rng.standard_normal(rows.size).astype(np.float32), (m, n))


@pytest.mark.parametrize("case", ["both_paths", "t1_weight", "sparse"])
@pytest.mark.parametrize("mode", ["fp32x2", "bf16"])
@pytest.mark.parametrize("k", [8, 100, 512])
def test_sddmm_tile_kernel_matches_plain(cuda, case, mode, k):
    # #14 at every slot against its plain version: a pattern whose tiles
    # take both paths, the trainable layer's 90 % pruned weight (every tile
    # dense) and a power law (every tile sparse); K = 100: a K-slice past
    # Kp's end is staged as zeros
    if case == "both_paths":
        fmt = span.pack_span(_half_dense_coo(), rb=512, ct=512, g=128, balance=False,
                             keep_perm=True, device=cuda)
    elif case == "t1_weight":
        fmt = span.pack_span(builder.pruned_weight_coo(1024, 768, sparsity=0.9, seed=3), rb=512,
                             ct=512, g=128, keep_perm=True, device=cuda)
    else:
        fmt = span.pack_span(builder.power_law_coo(4096, 4096, avg_nnz_per_row=16.0, seed=21),
                             rb=512, ct=512, g=128, keep_perm=True, device=cuda)
    tiles = sd.sddmm_tiles(fmt)
    assert tiles.n_slots == int(fmt.nc_p.sum()) * fmt.chunk_g      # every walked slot
    n_dense, d = tiles.dense(sd.TILE_MIN_SLOTS[mode])
    if case == "both_paths":
        assert 0 < d < tiles.n_slots
    elif case == "t1_weight":
        assert d == tiles.n_slots and n_dense == tiles.n_hit_tiles
    else:
        assert n_dense == 0
    assert _sddmm_vs_plain(fmt, k, mode, cuda) <= 1e-5


def test_sddmm_tile_index_follows_its_planes(cuda):
    # a plane written in place gives the format a new tile index; a stale
    # one, or one of another format, is refused
    fmt = span.pack_span(builder.pruned_weight_coo(512, 512, sparsity=0.9, seed=4), rb=256,
                         ct=512, g=128, keep_perm=True, device=cuda)
    tiles = sd.sddmm_tiles(fmt)
    assert sd.sddmm_tiles(fmt) is tiles and fmt.tiles is tiles
    x = torch.ones((512, 8), device=cuda)
    dy = torch.ones((fmt.n_programs * fmt.rb, 8), device=cuda)
    planes = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    fmt.lrow.add_(0)
    with pytest.raises(ValueError, match="not built from these index planes"):
        sd.sddmm_rows_cuda(*planes, dy, x, rb=fmt.rb, kt=8, mode="fp32", tiles=tiles)
    assert sd.sddmm_tiles(fmt) is not tiles
    with pytest.raises(ValueError, match="pass tiles="):
        sd.sddmm_rows_cuda(*planes, dy, x, rb=fmt.rb, kt=8, mode="fp32")


def _dx_vs_plain(fmt, k, kt, mode, dev, stage_min=None, vals=None):
    """#15 against its plain version and against the plain walk of its
    index, relative to |A|^T·|dY|, through the format's column index or,
    with ``stage_min``, one built to stage the windows holding that many
    slots.  Checks one counted launch, the same bits from a second launch
    and the output's shape.  Returns (max error, the index)."""
    kp = -(-k // kt) * kt
    gen = torch.Generator(device=dev).manual_seed(k)
    dy = torch.zeros((fmt.n_programs * fmt.rb, kp), device=dev)
    dy[:, :k] = torch.randn((fmt.n_programs * fmt.rb, k), generator=gen, device=dev)
    vals = fmt.vals.float() if vals is None else vals
    planes = (fmt.c0, fmt.cols, fmt.lrow)
    n = fmt.shape[1]
    index = (sd.dx_index(fmt) if stage_min is None else
             sd.build_dx_index(*planes, fmt.nc_p, rb=fmt.rb, n=n, stage_min=stage_min))
    kw = dict(n=n, rb=fmt.rb, kt=kt, mode=mode)
    before = sd.dx_rows_cuda.launches
    got = sd.dx_rows_cuda(*planes, vals, fmt.nc_p, dy, **kw, index=index)
    assert sd.dx_rows_cuda.launches == before + 1
    again = sd.dx_rows_cuda(*planes, vals, fmt.nc_p, dy, **kw, index=index)
    want = sd.dx_rows_plain(*planes, vals, fmt.nc_p, dy, **kw)
    walked = sd.dx_index_plain(index, vals, dy, mode=mode)
    scale = sd.dx_rows_plain(*planes, vals.abs(), fmt.nc_p, dy.abs(), **dict(kw, mode="fp32"))
    torch.cuda.synchronize()
    assert got.shape == (n, kp) and torch.equal(got, again)
    err = max(float(((got - w).abs() / scale.clamp(min=1e-30)).max()) for w in (want, walked))
    return err, index


@pytest.mark.parametrize("case", ["t1_weight", "both_paths", "power_law"])
@pytest.mark.parametrize("stage", ["default", "every_window", "no_window"])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [20, 150, 512])
def test_dx_kernel_matches_plain(cuda, case, stage, mode, k):
    # #15 against its plain version at every column: the trainable layer's
    # 90 % pruned weight (every window staged), a pattern whose windows take
    # both paths and a power law of 4000 columns in 9 programs of 480 rows
    # (sparse windows; neither a multiple of the tile or the window); each
    # also with every window staged and with none; K = 20 and 150 (padded
    # to 24 and 160) end in a panel that is partly past the row
    if case == "t1_weight":
        fmt = span.pack_span(builder.pruned_weight_coo(1024, 768, sparsity=0.9, seed=3), rb=512,
                             ct=512, g=128, keep_perm=True, device=cuda)
    elif case == "both_paths":
        fmt = span.pack_span(_half_dense_coo(), rb=512, ct=512, g=128, balance=False,
                             keep_perm=True, device=cuda)
    else:
        fmt = span.pack_span(builder.power_law_coo(4096, 4000, avg_nnz_per_row=16.0, seed=21),
                             rb=480, ct=512, g=128, keep_perm=True, device=cuda)
    stage_min = {"every_window": 1, "no_window": 2 ** 31 - 1}.get(stage)
    err, index = _dx_vs_plain(fmt, k, 8 if k == 20 else 32, mode, cuda, stage_min)
    assert index.n_slots == int(fmt.nc_p.sum()) * fmt.chunk_g      # every walked slot
    if stage == "every_window":
        assert index.n_staged == index.n_slots
    elif stage == "no_window":
        assert index.n_staged == 0 and index.n_pieces == 0
    elif case == "t1_weight":
        assert index.n_staged == index.n_slots
    elif case == "both_paths":
        assert 0 < index.n_staged < index.n_slots
    assert err <= 1e-5


@pytest.mark.parametrize("mode", ["fp32x2", "bf16"])
def test_dx_kernel_edges(cuda, mode):
    # chunks of G = 8192 slots (past the 4096 the kernel this replaced
    # staged), K = 4 and 20 (a panel of one float4, a tail), a value written
    # after the index was built, and an empty pattern (nnz = 0)
    w = builder.pruned_weight_coo(1024, 1024, sparsity=0.8, seed=7)
    fmt = span.pack_span(w, rb=1024, ct=1024, g=8192, keep_perm=True, device=cuda)
    assert fmt.chunk_g == 8192
    for k, kt in ((4, 8), (20, 8), (64, 32)):
        assert _dx_vs_plain(fmt, k, kt, mode, cuda)[0] <= 1e-5
    vals = fmt.vals.float().clone()
    index = sd.dx_index(fmt)
    vals.view(-1)[index.slot[:: 7].long()] = 3.0
    assert _dx_vs_plain(fmt, 20, 8, mode, cuda, vals=vals)[0] <= 1e-5
    assert sd.dx_index(fmt) is index
    from tpusparse_torch.io.mtx import CooMatrix

    empty = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
                      (300, 260))
    fmt0 = span.pack_span(empty, rb=64, ct=128, g=64, keep_perm=True, device=cuda)
    dy = torch.ones((fmt0.n_programs * fmt0.rb, 8), device=cuda)
    before = sd.dx_rows_cuda.launches
    got = sd.dx_rows_cuda(fmt0.c0, fmt0.cols, fmt0.lrow, fmt0.vals.float(), fmt0.nc_p, dy, n=260,
                          rb=64, kt=8, mode=mode, index=sd.dx_index(fmt0))
    torch.cuda.synchronize()
    assert sd.dx_rows_cuda.launches == before + 1
    assert got.shape == (260, 8) and not bool(got.any())


def test_dx_index_follows_its_planes(cuda):
    # a plane written in place gives the format a new column index; a stale
    # one, or one of another format, is refused; so is a missing one
    fmt = span.pack_span(builder.pruned_weight_coo(512, 512, sparsity=0.9, seed=4), rb=256,
                         ct=512, g=128, keep_perm=True, device=cuda)
    index = sd.dx_index(fmt)
    assert sd.dx_index(fmt) is index and fmt.dx_index is index
    dy = torch.ones((fmt.n_programs * fmt.rb, 8), device=cuda)
    planes = (fmt.c0, fmt.cols, fmt.lrow)
    kw = dict(n=512, rb=fmt.rb, kt=8, mode="fp32")
    with pytest.raises(ValueError, match="is not this format's"):
        sd.dx_rows_cuda(*planes, fmt.vals, fmt.nc_p, dy, **dict(kw, n=511), index=index)
    fmt.cols.add_(0)
    with pytest.raises(ValueError, match="not built from these index planes"):
        sd.dx_rows_cuda(*planes, fmt.vals, fmt.nc_p, dy, **kw, index=index)
    assert sd.dx_index(fmt) is not index
    with pytest.raises(ValueError, match="pass index="):
        sd.dx_rows_cuda(*planes, fmt.vals, fmt.nc_p, dy, **kw)


def test_trainable_layer_on_card(cuda):
    """TrainableSparseLinear's gradients on the card against the same
    layer on the CPU (the plain versions), and a few Adam steps."""
    w = builder.pruned_weight_coo(512, 384, sparsity=0.9, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 384)).astype(np.float32)
    t = rng.standard_normal((4, 16, 512)).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        layer = TrainableSparseLinear(w, rb=128, ct=128, g=64, device=dev)
        xt = torch.as_tensor(x, device=dev).requires_grad_(True)
        before = sd.sddmm_rows_cuda.launches, sd.dx_rows_cuda.launches
        ((layer(xt) - torch.as_tensor(t, device=dev)) ** 2).mean().backward()
        if dev.type == "cuda":
            assert (sd.sddmm_rows_cuda.launches, sd.dx_rows_cuda.launches) == (
                before[0] + 1, before[1] + 1)
        grads[dev.type] = (layer.vals.grad.cpu(), xt.grad.cpu())
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert float((g_card - g_cpu).abs().max()) <= 1e-5 * float(g_cpu.abs().max())
    layer = TrainableSparseLinear(w, rb=128, ct=128, g=64, device=cuda)
    opt = torch.optim.Adam(layer.parameters(), lr=2e-2)
    xs, ts = torch.as_tensor(x, device=cuda), torch.as_tensor(t, device=cuda)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = ((layer(xs) - ts) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("ctor", ["from_coo", "from_block"])
def test_differentiable_layers_on_card(cuda, ctor):
    a = (builder.power_law_coo(2048, 1536, avg_nnz_per_row=8.0, seed=5) if ctor == "from_coo"
         else builder.block_sparse_coo(1024, 768, 128, 0.25, seed=3))
    kw = dict(k_hint=8) if ctor == "from_coo" else dict(precision="fp32")
    layer = getattr(SparseLinear, ctor)(a, differentiable=True, **kw)
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((8, a.shape[1])), dtype=torch.float32,
                        device=cuda).requires_grad_(True)
    t = rng.standard_normal((8, a.shape[0]))
    (layer(x) * torch.as_tensor(t, dtype=torch.float32, device=cuda)).sum().backward()
    w = a.to_dense(np.float64)
    want = t @ w
    scale = np.abs(t) @ np.abs(w)
    assert (np.abs(x.grad.double().cpu().numpy() - want) / np.maximum(scale, 1.0)).max() < 2e-3


# --------------------------------------------------- graph, SpGEMM, native packers

def _graphs():
    """A path graph, a graph with unreachable and isolated vertices, and a
    power-law graph of 4096 vertices (push orientation)."""
    src = np.arange(11, dtype=np.int64)
    path = tpusparse_torch.CooMatrix(src + 1, src, np.ones(11), (12, 12)).sort_row_major()
    islands = tpusparse_torch.CooMatrix(np.array([1, 2, 8, 9]), np.array([0, 1, 7, 8]),
                                        np.full(4, 1.5), (14, 14)).sort_row_major()
    return {"path": path, "islands": islands,
            "power_law": builder.power_law_coo(4096, 4096, avg_nnz_per_row=8.0, seed=3)}


@pytest.mark.parametrize("name", ["path", "islands", "power_law"])
def test_graph_drivers_on_card_equal_their_cpu_path(cuda, name):
    from tpusparse_torch import graph

    g = _graphs()[name]
    w = tpusparse_torch.CooMatrix(g.rows, g.cols, np.abs(np.asarray(g.vals)), g.shape)
    dg.dg1_rows_cuda.launches = 0
    for src in (0, g.shape[0] // 2):
        np.testing.assert_array_equal(graph.bfs(g, src), graph.bfs(g, src, device="cpu"))
        d, dc = graph.sssp(w, src), graph.sssp(w, src, device="cpu")
        assert np.array_equal(np.isinf(d), np.isinf(dc))
        np.testing.assert_allclose(d[np.isfinite(d)], dc[np.isfinite(dc)], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(graph.connected_components(g),
                                  graph.connected_components(g, device="cpu"))
    # tol = 0 stops where an iteration changes no rank; the two paths sum in
    # other orders, so on a graph that converges within 20 they may stop
    # apart: compare the ranks
    r, it = graph.pagerank_fn(g, tol=0.0, max_iter=20)()
    rc, itc = graph.pagerank_fn(g, tol=0.0, max_iter=20, device="cpu")()
    assert r.is_cuda and it <= 20 and itc <= 20
    np.testing.assert_allclose(r.cpu().numpy(), rc.numpy(), rtol=0, atol=1e-6)
    assert dg.dg1_rows_cuda.launches >= 20  # BFS levels and PageRank: the dg SpMV kernel


@pytest.mark.parametrize("tile_cols", [64, 128])
def test_spgemm_on_card_matches_scipy(cuda, tile_cols):
    from tpusparse_torch import spgemm as sg
    from tpusparse_torch.oracle import spgemm_reference

    a = builder.power_law_coo(2048, 1536, avg_nnz_per_row=8.0, seed=12)
    b = builder.power_law_coo(1536, 3000, avg_nnz_per_row=6.0, seed=13)
    dg.dg_rows_cuda.launches = 0
    c = sg.spgemm(a, b, tile_cols=tile_cols, method="device")
    want = spgemm_reference(a, b)
    assert dg.dg_rows_cuda.launches == -(-3000 // tile_cols)  # one launch of #1 a tile of B
    assert c.shape == want.shape and c.nnz == want.nnz
    np.testing.assert_array_equal(c.rows, want.rows)
    np.testing.assert_array_equal(c.cols, want.cols)
    np.testing.assert_allclose(c.vals, want.vals, rtol=1e-4, atol=1e-4)
    sg._RUNNER_CACHE.clear()


def test_native_packed_format_gives_numpy_packed_y(cuda, mat, monkeypatch):
    from tpusparse_torch import native

    x = torch.as_tensor(np.random.default_rng(2).standard_normal((mat.shape[1], 8)),
                        dtype=torch.float32, device=cuda)
    packs = {"dg": lambda: dg.pack_dg(mat, rb=1024, ns=8, g=512, kt=8),
             "dgt": lambda: dgt.pack_dgt(mat, rb=512, g=512, kt=8, nw=8),
             "span": lambda: span.pack_span(mat, rb=512, ct=1024, g=512),
             "radix": lambda: radix.pack_radix(mat, rb=1024, S=128, g=1024, kt=8)}
    runs = {"dg": dg.dg_spmm, "dgt": dgt.dgt_spmm, "span": span.span_spmm,
            "radix": radix.radix_spmm}
    native_y = {k: runs[k](f(), x) for k, f in packs.items()}

    monkeypatch.setattr(native, "span_pack", span.span_chunk_numpy)
    monkeypatch.setattr(native, "span_pack_aligned", dg._aligned_chunk_numpy)
    monkeypatch.setattr(native, "dgt_runs_multi", dgt.dgt_runs_multi_numpy)
    for k, f in packs.items():
        got = runs[k](f(), x)
        torch.testing.assert_close(got, native_y[k], rtol=1e-5, atol=1e-5)


def test_session_probe_within_bounds(cuda):
    from tpusparse_torch.bench import microbench as mb

    probe = mb.session_probe()
    assert probe["device"] == torch.cuda.get_device_name(cuda)
    assert "implausible" not in probe, probe
    for name, (lo, hi) in mb.PROBE_BOUNDS.items():
        assert lo <= probe[name] <= hi, (name, probe[name])
    for key in ("norm_stream", "norm", "norm_fp32"):
        assert probe[key] > 0


@pytest.mark.parametrize("make", ["dense_spmm_fn", "csr_spmm_fn", "segment_spmm_fn"])
def test_baselines_on_card_at_config1(cuda, make):
    from tpusparse_torch.bench import baselines
    from tpusparse_torch.io.mtx import CooMatrix as CooMatrixT

    c1 = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    x = np.random.default_rng(0).standard_normal((c1.shape[1], 8)).astype(np.float32)
    y = getattr(baselines, make)(c1)(x)
    assert y.device == cuda and y.dtype == torch.float32
    # 1e-5 of |A|.|x|: fp32 sums over config #1's hub rows (up to 4471
    # entries) round by up to 1e-4 against a Y near 1, in any order of adds
    absm = CooMatrixT(c1.rows, c1.cols, np.abs(c1.vals), c1.shape)
    check_result(y.cpu().numpy(), spmm_reference(c1, x.astype(np.float64)), rtol=1e-5,
                 scale=spmm_reference(absm, np.abs(x).astype(np.float64)))


def test_family_cost_on_card(cuda, monkeypatch):
    from tpusparse_torch.bench import microbench as mb

    # the family costs on a small power law: one row a family, each timed on the card
    monkeypatch.setattr(mb, "CONFIG1", dict(m=4096, avg_nnz_per_row=16.0, alpha=1.8, seed=42))
    rows = mb.measure_family_costs(quick=True)
    assert len({r["family"] for r in rows}) == len(rows) >= 5
    for r in rows:
        assert "rejected" in r or (r["ns_per_nz"] > 0 and r["device"] ==
                                   torch.cuda.get_device_name(cuda)), r


# ----------------------------------------------------------- multi-device

RING_CASES = {  # packer kwargs, builder kwargs, wrapper, at the 4096^2 fixture
    "stripe": ("pack_halo_stripe", {"rows_per_stripe": 64}, "build_halo_spmm", {},
               stripe.stripe_rows_cuda),
    "span": ("pack_halo_span", {"rows_per_program": 256, "ct": 512, "g": 128},
             "build_halo_span_spmm", {}, span.span_rows_cuda),
    "radix": ("pack_halo_radix", {"rows_per_program": 256, "S": 32, "g": 128, "kt": 8},
              "build_halo_radix_spmm", {"kt": 8}, radix.radix_rows_cuda),
    "dg": ("pack_halo_dg", {"rows_per_program": 256, "ns": 2, "g": 128, "kt": 8},
           "build_halo_dg_spmm", {"kt": 8}, dg.dg_rows_cuda),
    "dgt": ("pack_halo_dgt", {"rows_per_program": 256, "g": 256, "kt": 8},
            "build_halo_dgt_spmm", {}, dgt.dgt_rows_cuda),
}


def _abs_scale(m, x):
    from tpusparse_torch.io.mtx import CooMatrix as CooMatrixT

    absm = CooMatrixT(m.rows, m.cols, np.abs(np.asarray(m.vals)), m.shape)
    return spmm_reference(absm, np.abs(x).astype(np.float64))


@pytest.mark.parametrize("kind,n_k", [(k, n) for k in RING_CASES for n in (1, 2)
                                      if not (k == "stripe" and n == 2)])
def test_ring_on_virtual_ranks_matches_plain_ring(cuda, mat, kind, n_k):
    """Each halo ring on ["cuda:0"] * 4 (and a 4 x 2 mesh but for the stripe
    ring, which does not shard K, as in the JAX package) against the same
    ring on CPU ranks, which run the plain kernels, at 1e-5 of |A|.|x|;
    each call launches its kernel D * n_k * D times; the shifts run off the
    kernels' stream and no host sync falls inside the ring."""
    from tpusparse_torch.bench.ring_profile import check_ring_overlap, ring_overlap
    from tpusparse_torch.dist import make_mesh
    from tpusparse_torch.dist import overlap as ov

    pack, pkw, build, bkw, wrapper = RING_CASES[kind]
    x = np.random.default_rng(3).standard_normal((mat.shape[1], 8 * n_k)).astype(np.float32)
    name = f"cuda:{cuda.index}"
    fn, put = getattr(ov, build)(getattr(ov, pack)(mat, 4, device=cuda, **pkw),
                                 make_mesh(4, n_k, [name] * (4 * n_k)), **bkw)
    args = put(x)
    before = wrapper.launches
    y = fn(*args)
    assert wrapper.launches - before == 4 * n_k * 4
    pfn, pput = getattr(ov, build)(getattr(ov, pack)(mat, 4, device="cpu", **pkw),
                                   make_mesh(4, n_k, ["cpu"] * (4 * n_k)), **bkw)
    check_result(y.cpu().numpy(), pfn(*pput(x)).numpy(), rtol=1e-5, scale=_abs_scale(mat, x))
    check_result(y.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=1e-3,
                 scale=_abs_scale(mat, x))
    check_ring_overlap(ring_overlap(fn, args, expect=4 * n_k * 4, shifts=4 * n_k * 3),
                       f"{kind} ring")


@pytest.mark.parametrize("n_row,n_k", [(2, 2), (4, 1)])
def test_sharded_stripe_on_card_matches_plain(cuda, mat, n_row, n_k):
    from tpusparse_torch.dist import build_sharded_stripe_spmm, make_mesh

    x = np.random.default_rng(4).standard_normal((mat.shape[1], 16)).astype(np.float32)
    fmt, _ = prepare_stripe_format(mat, work_per_stripe=1024, nnz_multiple=8, device=cuda)
    fn, put = build_sharded_stripe_spmm(fmt, make_mesh(n_row, n_k, [cuda] * (n_row * n_k)))
    before = stripe.stripe_rows_cuda.launches
    y = fn(*put(x))
    assert stripe.stripe_rows_cuda.launches - before == n_row * n_k
    pfmt, _ = prepare_stripe_format(mat, work_per_stripe=1024, nnz_multiple=8, device="cpu")
    pfn, pput = build_sharded_stripe_spmm(pfmt, make_mesh(n_row, n_k, ["cpu"] * (n_row * n_k)))
    check_result(y.cpu().numpy(), pfn(*pput(x)).numpy(), rtol=1e-5, scale=_abs_scale(mat, x))


def test_dryrun_multichip_on_card(cuda):
    from tpusparse_torch.dist.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device=f"cuda:{cuda.index}")
    assert out["losses"][-1] < out["losses"][0]


def test_dgt8_spmv_past_the_jax_width_gate(cuda):
    # 400,000 columns: the JAX package refuses dgt8 past 294,912 (its VMEM
    # residency for X); the walk (#3) stages no X
    wide = builder.power_law_coo(2048, 400_000, avg_nnz_per_row=8.0, seed=3)
    x = np.random.default_rng(9).standard_normal(400_000).astype(np.float32)
    fn = spmv_fn(wide, "dgt8")
    before = dgt.dgt_rows_cuda.launches
    y = fn(x)
    assert y.is_cuda and y.shape == (2048,) and dgt.dgt_rows_cuda.launches == before + 1
    check_result(y.cpu().numpy(), spmm_reference(wide, x.astype(np.float64)), rtol=2e-3)
    f = fn.format
    xp = dg.pad_dense_cols(torch.as_tensor(x, device=cuda).view(-1, 1), 8).contiguous()
    args = (f.wins, f.cols, f.lrw, f.vals, f.nc_p)
    kw = dict(rb=f.rb, kt=f.kt, mode=f.mode, resid=f.resid)
    got = dgt.dgt_rows_cuda(*args, xp, walk=dgt.dgt_row_walk(f), k=1, **kw)
    scale = dgt.dgt_rows_plain(f.wins, f.cols, f.lrw, f.vals.abs(), f.nc_p, xp.abs(), **kw)
    assert _err(got, dgt.dgt_rows_plain(*args, xp, **kw), scale, cuda) <= 1e-5


@pytest.mark.parametrize("mode", ["fp32x2", "bf16"])
def test_span_spmv_one_column_on_card(cuda, mat, mode):
    # the span SpMV runs x as one column through the one-column walk
    # kernel (span_rows_cuda at kt = 1), counted as #7's launch
    x = np.random.default_rng(10).standard_normal(4096).astype(np.float32)
    fn = spmv_fn(mat, "span")
    before = span.span_rows_cuda.launches
    y = fn(x)
    assert y.is_cuda and y.shape == (4096,) and span.span_rows_cuda.launches == before + 1
    check_result(y.cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)
    f = fn.format
    x1 = torch.as_tensor(x, device=cuda).view(-1, 1).contiguous()
    # span_spmm at K = 1 is the same one launch at kt = 1, whatever ktile
    y1 = span.span_spmm(f, x1, ktile=8)
    assert y1.shape == (4096, 1) and span.span_rows_cuda.launches == before + 2
    check_result(y1[:, 0].cpu().numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)
    args = (f.c0, f.cols, f.lrow, f.vals, f.nc_p)
    walk = span.span_row_walk(f)
    got = span.span_rows_cuda(*args, x1, rb=f.rb, kt=1, mode=mode, walk=walk)
    assert got.shape == (f.n_programs * f.rb, 1) and span.span_rows_cuda.launches == before + 3
    want = span.span_rows_plain(*args, x1, rb=f.rb, kt=1, mode=mode)
    scale = span.span_rows_plain(f.c0, f.cols, f.lrow, f.vals.abs(), f.nc_p, x1.abs(), rb=f.rb,
                                 kt=1, mode="fp32")
    assert _err(got, want, scale, cuda) <= 1e-5
    assert _err(got, rw.walk_rows_plain(walk, f.vals, x1, bf16=mode == "bf16"), scale,
                cuda) <= 1e-5
    info = span.span_walk1_info(mode)
    assert info["spill_bytes"] == 0 and info["shared_bytes"] == 0
    with pytest.raises(ValueError, match="span kernel"):  # kt = 1 takes one column only
        span.span_rows_cuda(*args, x1.expand(-1, 8).contiguous(), rb=f.rb, kt=1, mode=mode,
                            walk=walk)


def test_measured_stream_bandwidth_within_probe_bounds(cuda):
    from tpusparse_torch.bench import measured_stream_bandwidth_gbs
    from tpusparse_torch.bench.microbench import PROBE_BOUNDS

    lo, hi = PROBE_BOUNDS["stream_gbs"]
    gbs = measured_stream_bandwidth_gbs()
    assert lo <= gbs <= hi, gbs
