"""tpusparse_torch.kernels.span_gather against the JAX package's span_gather.

The packer must emit the JAX packer's arrays (the JAX side may run its
native span_pack; the port runs its own native walk, whose numpy version
must agree with the JAX one), and the port's span_spmm on the CPU (the
kernels' plain versions) must match the JAX span_spmm (Pallas interpret
mode, as tests/test_span_kernel.py runs it) and the oracle.  Tolerances:
fp32 1e-5 of max|ref|; fp32x2 1e-4 of max|ref| (the JAX side's hi/lo bf16
split of X; the port computes fp32 and is held to 1e-5 against the
oracle); bf16 5e-2.
"""

import numpy as np
import pytest
import torch

from tpusparse.io import builder as jbuilder
from tpusparse.kernels import span_gather as jspan
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import row_walk as rw
from tpusparse_torch.kernels import span_gather as tspan
from tpusparse_torch.kernels.common import unpack_slots
from tpusparse_torch.kernels.nnz_split import pack_segment_span

STATIC = ("n_programs", "n_chunks", "chunk_g", "rb", "ct", "shape", "nnz_real")
TOL = {"fp32": 1e-5, "fp32x2": 1e-4, "bf16": 5e-2}


def _case(m=300, n=400, k=8, avg=6.0, seed=0):
    jmat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return jmat, CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape), x


def _assert_same_format(jfmt, tfmt):
    for k in tspan.SPAN_FIELDS:
        want = np.asarray(getattr(jfmt, k))
        got = getattr(tfmt, k)
        if got.dtype == torch.bfloat16:
            got, want = got.float(), want.astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    for k in STATIC:
        assert getattr(tfmt, k) == getattr(jfmt, k), k
    if jfmt.perm_of_nz is None:
        assert tfmt.perm_of_nz is None
    else:
        np.testing.assert_array_equal(tfmt.perm_of_nz, jfmt.perm_of_nz)


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("rb,ct,g", [(64, 128, 32), (128, 64, 16), (32, 256, 64)])
def test_pack_span_equals_jax(balance, rb, ct, g):
    jmat, tmat, _ = _case(m=200, n=2000, avg=9.0, seed=7)
    kw = dict(rb=rb, ct=ct, g=g, balance=balance, keep_perm=True)
    jfmt = jspan.pack_span(jmat, **kw)
    tfmt = tspan.pack_span(tmat, device="cpu", **kw)
    _assert_same_format(jfmt, tfmt)
    assert tfmt.memory_bytes == jfmt.memory_bytes
    # nc_p is the walk's chunk count; every chunk past it is padding
    vals = np.asarray(jfmt.vals)
    nc_p = tfmt.nc_p.numpy().reshape(-1)
    assert nc_p.max() == jfmt.n_chunks
    for p in range(jfmt.n_programs):
        assert not vals[p, nc_p[p]:].any() and vals[p, nc_p[p] - 1].any()


def test_span_chunk_walk_equals_jax():
    rng = np.random.default_rng(3)
    starts = np.array([0, 40, 40, 130])            # an empty program
    cols_s = np.concatenate([np.sort(rng.integers(0, 900, 40)), np.sort(rng.integers(0, 900, 90))])
    lrow_s = rng.integers(0, 16, 130)
    vals_s = rng.standard_normal(130).astype(np.float32)
    # the port's walk has the native walk's returns: (c0, cols, lrow, vals,
    # nc, dest), an empty program counted as one chunk
    c0, cols, lrow, vals, dest, nc = jspan.span_chunk_numpy(cols_s, lrow_s, vals_s, starts, 16,
                                                            120, keep_perm=True)
    got = tspan.span_chunk_numpy(cols_s, lrow_s, vals_s, starts, 16, 120, want_dest=True)
    for a, b in zip((c0, cols, lrow, vals, np.maximum(nc, 1), dest), got):
        np.testing.assert_array_equal(a, b)


def test_pack_span_metadata_set_input_val_dtype_and_out_rows():
    from tpusparse.meta.set import create_init_metadata_set as jms
    from tpusparse_torch.meta.set import create_init_metadata_set as tms

    jmat, tmat, x = _case(seed=5)
    kw = dict(out_rows=320, rb=64, ct=128, g=32)
    _assert_same_format(jspan.pack_span(jms(jmat), 0, **kw),
                        tspan.pack_span(tms(tmat), 0, device="cpu", **kw))
    jfmt = jspan.pack_span(jmat, rb=64, ct=128, g=32, val_dtype="bfloat16")
    tfmt = tspan.pack_span(tmat, rb=64, ct=128, g=32, val_dtype="bfloat16", device="cpu")
    assert tfmt.vals.dtype == torch.bfloat16
    _assert_same_format(jfmt, tfmt)
    ref = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(tspan.span_spmm(tfmt, x, precision="bf16").numpy(),
                               np.asarray(jspan.span_spmm(jfmt, x, precision="bf16")),
                               rtol=0, atol=TOL["bf16"] * np.abs(ref).max())
    with pytest.raises(ValueError, match="float dtype"):
        tspan.pack_span(tmat, val_dtype="int32", device="cpu")


@pytest.mark.parametrize("precision,k,stream", [
    ("fp32", 8, False), ("fp32x2", 5, False), ("bf16", 16, False), ("fp32x2", 100, False),
    ("fp32", 8, True), ("fp32x2", 12, True),
])
def test_span_spmm_matches_jax(precision, k, stream):
    jmat, tmat, x = _case(k=k, seed=2)
    kw = dict(rb=64, ct=128, g=32)
    jfmt = jspan.pack_span(jmat, **kw)
    ref = spmm_reference(jmat, x.astype(np.float64))
    yj = np.asarray(jspan.span_spmm(jfmt, x, precision=precision, stream=stream))
    fields = {f: np.asarray(getattr(jfmt, f)) for f in tspan.SPAN_FIELDS}
    from_jax = tspan.span_format_from_numpy(fields, device="cpu",
                                            **{f: getattr(jfmt, f) for f in STATIC})
    for fmt in (tspan.pack_span(tmat, device="cpu", **kw), from_jax):
        yt = tspan.span_spmm(fmt, x, precision=precision, stream=stream)
        assert isinstance(yt, torch.Tensor) and yt.shape == (300, k)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=TOL[precision] * np.abs(ref).max())
        check_result(yt.numpy(), ref, rtol=8e-2 if precision == "bf16" else 1e-5)


@pytest.mark.parametrize("stream", [False, True])
def test_with_values_and_value_plane_match_jax(stream):
    jmat, tmat, x = _case(seed=9)
    kw = dict(rb=64, ct=128, g=32, keep_perm=True)
    jfmt = jspan.pack_span(jmat, **kw)
    tfmt = tspan.pack_span(tmat, device="cpu", **kw)
    new = np.random.default_rng(4).standard_normal(jmat.nnz).astype(np.float32)
    jnew, tnew = jspan.with_values(jfmt, new), tspan.with_values(tfmt, new)
    _assert_same_format(jnew, tnew)
    ref = spmm_reference(CooMatrix(tmat.rows, tmat.cols, new, tmat.shape), x.astype(np.float64))
    # the value plane as an override of the packed one (the trainable path)
    yj = np.asarray(jspan.span_spmm(jfmt, x, precision="fp32", stream=stream, vals=jnew.vals))
    yt = tspan.span_spmm(tfmt, x, precision="fp32", stream=stream, vals=tnew.vals)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-5 * np.abs(ref).max())
    check_result(yt.numpy(), ref, rtol=1e-5)
    check_result(tspan.span_spmm(tnew, x).numpy(), ref, rtol=1e-5)
    with pytest.raises(ValueError, match="vals must be"):
        tspan.span_spmm(tfmt, x, vals=tnew.vals[:, :1])


def test_span_format_from_numpy_checks_indices():
    jmat, _, _ = _case(seed=11)
    jfmt = jspan.pack_span(jmat, rb=64, ct=128, g=32)
    fields = {k: np.asarray(getattr(jfmt, k)).copy() for k in tspan.SPAN_FIELDS}
    static = {k: getattr(jfmt, k) for k in STATIC}
    fmt = tspan.span_format_from_numpy(fields, device="cpu", **static)
    np.testing.assert_array_equal(fmt.nc_p.numpy(), tspan.pack_span(
        CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape), rb=64, ct=128, g=32,
        device="cpu").nc_p.numpy())
    for name, bad in (("cols", 128), ("lrow", 64), ("c0", 400)):
        broken = dict(fields)
        broken[name] = fields[name].copy()
        broken[name][0, 0, 0] = bad
        with pytest.raises(ValueError, match="out of range"):
            tspan.span_format_from_numpy(broken, device="cpu", **static)
    with pytest.raises(ValueError, match="shape"):
        tspan.span_format_from_numpy(dict(fields, lrow=fields["lrow"][:1]), device="cpu",
                                     **static)


def test_plain_versions_and_wrappers():
    _, tmat, x = _case(seed=12)
    fmt = tspan.pack_span(tmat, rb=64, ct=128, g=32, device="cpu")
    xt = torch.from_numpy(x)
    args = (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, xt)
    torch.testing.assert_close(tspan.span_stream_rows_plain(*args, rb=64, ct=128, kt=8,
                                                            mode="fp32x2"),
                               tspan.span_rows_plain(*args, rb=64, kt=8, mode="fp32x2"))
    # a value past a program's real chunks adds nothing, as in the kernels
    p = int(torch.argmin(fmt.nc_p.reshape(-1)))
    vals = fmt.vals.clone()
    vals[p, -1, 0] = 5.0
    assert int(fmt.nc_p.reshape(-1)[p]) < fmt.n_chunks
    torch.testing.assert_close(
        tspan.span_rows_plain(fmt.c0, fmt.cols, fmt.lrow, vals, fmt.nc_p, xt, rb=64, kt=8,
                              mode="fp32"),
        tspan.span_rows_plain(*args, rb=64, kt=8, mode="fp32"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tspan.span_rows_cuda(*args, rb=64, kt=8, mode="fp32")
    with pytest.raises(ValueError, match="X is on"):
        tspan.span_spmm(fmt, torch.zeros((400, 8), device="meta"))


# ------------------------------------------------------------------- row walk
# The CUDA kernel #7 walks the format's row walk (kernels/row_walk.py): each
# live slot once, sorted by (y_rows row, slot).  Its function in plain
# PyTorch (``walk_rows_plain``, the same sum in the walk's order) must equal
# ``span_rows_plain`` at 1e-5 of |A|.|X| and, unpacked, the JAX kernel in
# interpret mode: at 1e-5 of |A|.|X| in fp32, at TOL of max|ref| where the
# JAX side splits (fp32x2) or rounds (bf16) its operands.

def _assert_walk_covers(walk, live):
    """Each live slot exactly once, rows non-decreasing, slots rising in a
    row; the values those of the plane the walk was built from."""
    slot, row = walk.slot.long(), walk.row.long()
    torch.testing.assert_close(walk.val, walk.val_src.reshape(-1)[slot].float(), rtol=0, atol=0)
    np.testing.assert_array_equal(np.sort(slot.numpy()),
                                  np.flatnonzero(live.reshape(-1).numpy()))
    assert bool((row[1:] >= row[:-1]).all())
    same = row[1:] == row[:-1]
    assert bool((slot[1:][same] > slot[:-1][same]).all())
    assert walk.runs == int(torch.unique(row).numel())


def _abs_ref(jmat, x):
    return spmm_reference(CooMatrix(jmat.rows, jmat.cols, np.abs(jmat.vals), jmat.shape),
                          np.abs(x).astype(np.float64))


@pytest.mark.parametrize("precision,balance", [("fp32", True), ("fp32x2", True),
                                               ("bf16", True), ("fp32", False)])
def test_row_walk_equals_plain_and_jax(precision, balance):
    jmat, _, x = _case(seed=2)
    jfmt = jspan.pack_span(jmat, rb=64, ct=128, g=32, balance=balance)
    fields = {f: np.asarray(getattr(jfmt, f)) for f in tspan.SPAN_FIELDS}
    fmt = tspan.span_format_from_numpy(fields, device="cpu",
                                       **{f: getattr(jfmt, f) for f in STATIC})
    walk = tspan.span_row_walk(fmt)
    assert fmt.walk is walk and tspan.span_row_walk(fmt) is walk
    _assert_walk_covers(walk, fmt.vals != 0)
    assert walk.n_slots == jmat.nnz and walk.n_rows == fmt.n_programs * fmt.rb
    # in slot order a chunk is sorted by column: nearly every slot its own run
    assert walk.runs <= jmat.shape[0] < walk.n_slots
    xt = torch.from_numpy(x)
    bf16 = precision == "bf16"
    got = rw.walk_rows_plain(walk, fmt.vals, xt, bf16=bf16)
    args = (fmt.c0, fmt.cols, fmt.lrow)
    want = tspan.span_rows_plain(*args, fmt.vals, fmt.nc_p, xt, rb=fmt.rb, kt=8, mode=precision)
    scale = tspan.span_rows_plain(*args, fmt.vals.abs(), fmt.nc_p, xt.abs(), rb=fmt.rb, kt=8,
                                  mode="fp32")
    assert float(((got - want).abs() / scale.clamp(min=1.0)).max()) <= 1e-5
    y = unpack_slots(got, fmt.slot_of_origrow).numpy()
    yj = np.asarray(jspan.span_spmm(jfmt, x, precision=precision))
    if precision == "fp32":
        assert float((np.abs(y - yj) / np.maximum(_abs_ref(jmat, x), 1.0)).max()) <= 1e-5
    else:
        ref = spmm_reference(jmat, x.astype(np.float64))
        np.testing.assert_allclose(y, yj, rtol=0, atol=TOL[precision] * np.abs(ref).max())


@pytest.mark.parametrize("case", ["with_values", "stored_zero", "no_perm", "empty", "segment"])
def test_row_walk_is_the_pattern(case):
    jmat, tmat, x = _case(seed=9)
    if case == "empty":
        tmat = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32),
                         tmat.shape)
    if case == "stored_zero":  # a stored zero of the COO is a live slot of the pattern
        vals = tmat.vals.copy()
        vals[::4] = 0.0
        tmat = CooMatrix(tmat.rows, tmat.cols, vals, tmat.shape)
    xt = torch.from_numpy(x)
    if case == "segment":      # segment_span's format walks the same way
        fmt = pack_segment_span(tmat, block_nnz=256, ct=128, g=32, device="cpu")
        walk = tspan.span_row_walk(fmt)
        _assert_walk_covers(walk, fmt.vals != 0)
        want = tspan.span_rows_plain(fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, xt,
                                     rb=fmt.rb, kt=8, mode="fp32")
        torch.testing.assert_close(rw.walk_rows_plain(walk, fmt.vals, xt), want,
                                   rtol=1e-5, atol=1e-5)
        return
    fmt = tspan.pack_span(tmat, rb=64, ct=128, g=32, keep_perm=case != "no_perm",
                          device="cpu")
    walk = tspan.span_row_walk(fmt)
    if case == "no_perm":      # the packed plane's nonzeros
        _assert_walk_covers(walk, fmt.vals != 0)
        return
    live = torch.zeros(fmt.vals.numel(), dtype=torch.bool)
    live[torch.as_tensor(fmt.perm_of_nz, dtype=torch.long)] = True
    _assert_walk_covers(walk, live)
    assert walk.n_slots == tmat.nnz
    new_vals = np.random.default_rng(4).standard_normal(tmat.nnz).astype(np.float32)
    new = tspan.with_values(fmt, new_vals)
    # the pattern's walk goes with it, holding the new plane's values
    assert new.walk.slot is walk.slot and new.walk.val_src is new.vals
    assert tspan.span_row_walk(new) is new.walk
    torch.testing.assert_close(new.walk.val, new.vals.reshape(-1)[walk.slot.long()].float())
    # the caller's plane (the trainable path's vals=) read through the walk
    y = unpack_slots(rw.walk_rows_plain(walk, new.vals, xt), fmt.slot_of_origrow).numpy()
    check_result(y, spmm_reference(CooMatrix(tmat.rows, tmat.cols, new_vals, tmat.shape),
                                   x.astype(np.float64)), rtol=1e-5)
    if case == "empty":
        assert walk.n_slots == 0 and walk.runs == 0 and not y.any()
    if case == "stored_zero":
        assert walk.n_slots > int(np.count_nonzero(tmat.vals))


@pytest.mark.parametrize("case", ["values_in_place", "pattern_in_place", "other_format",
                                  "state_dict", "off_pattern", "stored_zero_plane"])
def test_row_walk_follows_its_planes(case):
    # A walk is tied to the planes it was decoded from, as they stood: a
    # plane written in place (load_state_dict into a layer's buffers) gives
    # the format a new walk, the old one no longer passes the wrapper's
    # check, and its values are no longer streamed.  Without perm_of_nz a
    # caller's plane with a nonzero off the walk is refused, not dropped.
    from tpusparse_torch.nn import SparseLinear
    from tpusparse_torch.schedule import Schedule, build_plan

    _, tmat, x = _case(seed=9)
    if case == "stored_zero_plane":
        vals = tmat.vals.copy()
        vals[::4] = 0.0
        tmat = CooMatrix(tmat.rows, tmat.cols, vals, tmat.shape)
    xt = torch.from_numpy(x)
    fmt = tspan.pack_span(tmat, rb=64, ct=128, g=32, keep_perm=case == "stored_zero_plane",
                          device="cpu")
    pattern = (fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p)
    walk = tspan.span_row_walk(fmt)
    assert walk.fresh(pattern, fmt.vals) and not rw.gathers(walk, fmt.vals, "span")
    assert walk.live_from_values == (case != "stored_zero_plane")
    if case == "values_in_place":
        fmt.vals.mul_(2.0)              # the same nonzeros: gathered, not refused
        assert not walk.holds(fmt.vals) and rw.gathers(walk, fmt.vals, "span")
        new = tspan.span_row_walk(fmt)
        assert new is not walk and new.holds(fmt.vals)
        torch.testing.assert_close(new.val, 2.0 * walk.val)
    elif case == "pattern_in_place":
        fmt.lrow.copy_(fmt.lrow)
        assert not walk.built_from(pattern)
        assert tspan.span_row_walk(fmt) is not walk
    elif case == "other_format":
        other = tspan.pack_span(tmat, rb=64, ct=128, g=32, device="cpu")
        assert not walk.built_from((other.c0, other.cols, other.lrow, other.nc_p))
    elif case == "state_dict":
        sched = Schedule(family="span_onehot", rb=64, ct=128, g=32)
        plan = build_plan(tmat, sched, device="cpu")
        layer = SparseLinear(plan.fn, *tmat.shape, formats=plan.formats, device="cpu")
        f = plan.formats[0]
        old = tspan.span_row_walk(f)
        new_vals = np.random.default_rng(12).standard_normal(tmat.nnz).astype(np.float32)
        new_mat = CooMatrix(tmat.rows, tmat.cols, new_vals, tmat.shape)
        src = build_plan(new_mat, sched, device="cpu")
        layer.load_state_dict(SparseLinear(src.fn, *tmat.shape, formats=src.formats,
                                           device="cpu").state_dict())
        new = tspan.span_row_walk(f)
        assert new is not old and new.holds(f.vals) and not old.fresh(
            (f.c0, f.cols, f.lrow, f.nc_p), f.vals)
        want = spmm_reference(new_mat, x.astype(np.float64))
        check_result(unpack_slots(rw.walk_rows_plain(new, f.vals, xt),
                                  f.slot_of_origrow).numpy(), want, rtol=1e-5)
        check_result(layer(xt.T).T.numpy(), want, rtol=1e-5)
    elif case == "off_pattern":
        plane = fmt.vals.clone()
        assert rw.gathers(walk, plane, "span")      # the same nonzeros
        col, _, walked = tspan.slot_rows_cols(*pattern[:3], fmt.nc_p, fmt.rb)
        spare = torch.nonzero(walked & (col < tmat.shape[1])
                              & (plane.reshape(-1) == 0)).reshape(-1)
        plane.view(-1)[spare[0]] = 1.0
        with pytest.raises(ValueError, match="off the format's pattern"):
            rw.gathers(walk, plane, "span")
    else:                               # a stored zero made nonzero is summed
        plane = tspan.with_values(fmt, np.ones(tmat.nnz, np.float32)).vals
        assert rw.gathers(walk, plane, "span")
        check_result(unpack_slots(rw.walk_rows_plain(walk, plane, xt),
                                  fmt.slot_of_origrow).numpy(),
                     spmm_reference(CooMatrix(tmat.rows, tmat.cols,
                                              np.ones(tmat.nnz, np.float32), tmat.shape),
                                    x.astype(np.float64)), rtol=1e-5)


@pytest.mark.parametrize("k,want", [(1, (4, 4, 2048)), (2, (4, 4, 2048)), (5, (8, 8, 2048)),
                                    (37, (40, 64, 1024)), (512, (512, 512, 512)),
                                    (520, (520, 512, 512))])
def test_walk_geometry(k, want):
    # K = 1-2 read one float4 a slot; streams of one or two lanes take
    # bigger blocks, the widest panels smaller; past 512 the panels repeat
    assert rw.walk_geometry(k) == want


@pytest.mark.parametrize("case", ["ct4096_k100", "vals_plane", "bf16"])
def test_stream_row_walk_equals_plain_and_jax(case):
    # On the card the stream wrapper (#8) walks the format's row walk, as
    # the resident one does: its function in plain PyTorch must equal
    # span_stream_rows_plain and, unpacked, the JAX package's stream
    # kernel in interpret mode, at the stream shapes the card checks: a
    # window of 4096 columns at K = 100 in fp32, a caller's value plane,
    # bf16
    k, precision = {"ct4096_k100": (100, "fp32"), "bf16": (16, "bf16")}.get(case, (8, "fp32"))
    jmat, tmat, x = _case(k=k, seed=13)
    kw = dict(rb=64, ct=4096 if case == "ct4096_k100" else 128, g=32,
              keep_perm=case == "vals_plane")
    jfmt = jspan.pack_span(jmat, **kw)
    fmt = tspan.pack_span(tmat, device="cpu", **kw)
    _assert_same_format(jfmt, fmt)
    walk = tspan.span_row_walk(fmt)
    jvals, vals, ref_mat = None, fmt.vals, jmat
    if case == "vals_plane":  # the trainable path's vals=, gathered through the walk
        new = np.random.default_rng(14).standard_normal(jmat.nnz).astype(np.float32)
        jvals, vals = jspan.with_values(jfmt, new).vals, tspan.with_values(fmt, new).vals
        ref_mat = CooMatrix(tmat.rows, tmat.cols, new, tmat.shape)
        assert rw.gathers(walk, vals, "span")
    xt = torch.from_numpy(x)
    bf16 = precision == "bf16"
    got = rw.walk_rows_plain(walk, vals, xt, bf16=bf16)
    args = (fmt.c0, fmt.cols, fmt.lrow)
    want = tspan.span_stream_rows_plain(*args, vals, fmt.nc_p, xt, rb=fmt.rb, ct=fmt.ct, kt=8,
                                        mode=precision)
    scale = tspan.span_stream_rows_plain(*args, vals.abs(), fmt.nc_p, xt.abs(), rb=fmt.rb,
                                         ct=fmt.ct, kt=8, mode="fp32")
    assert float(((got - want).abs() / scale.clamp(min=1.0)).max()) <= 1e-5
    y = unpack_slots(got, fmt.slot_of_origrow).numpy()
    yj = np.asarray(jspan.span_spmm(jfmt, x, precision=precision, stream=True, vals=jvals))
    ref = spmm_reference(ref_mat, x.astype(np.float64))
    np.testing.assert_allclose(y, yj, rtol=0, atol=TOL[precision] * np.abs(ref).max())
    check_result(y, ref, rtol=8e-2 if bf16 else 1e-5)
