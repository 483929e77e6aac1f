"""tpusparse_torch's stripe and segment families against the JAX package's:
the converting, distributing and implementing operators (the metadata after
each one), the StripeFormat / NestedStripeFormat / SegmentFormat /
SegmentSpanFormat packers (the packed arrays), and stripe_spmm,
stripe_nested_spmm, segment_spmm and segment_span_spmm on the CPU (the
kernels' plain versions) against the JAX functions (Pallas interpret mode)
and the oracle.  Tolerances: the stripe and segment paths compute in fp32 on
both sides, 1e-5 of max|ref|; segment_span's JAX side runs the span
kernel's fp32x2 hi/lo split, 1e-4 (tests/test_torch_span_gather.py).
"""

import numpy as np
import pytest
import torch

from tpusparse import format as jformat
from tpusparse import generator as jgen
from tpusparse import ops as jops
from tpusparse.io import builder as jbuilder
from tpusparse.kernels import nnz_split as jnnz
from tpusparse.kernels import stripe_gather as jsg
from tpusparse.levels import Level as JLevel
from tpusparse.meta.set import create_init_metadata_set as jms
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch import format as tformat
from tpusparse_torch import generator as tgen
from tpusparse_torch import ops as tops
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import nnz_split as tnnz
from tpusparse_torch.kernels import stripe_gather as tsg
from tpusparse_torch.levels import Level as TLevel
from tpusparse_torch.meta.set import create_init_metadata_set as tms

STRIPE_STATIC = ("n_stripes", "stripe_nnz", "max_rows_per_stripe", "shape", "nnz_real")
NESTED_STATIC = ("n_stripes", "stripe_nnz", "n_warps", "max_rows_per_stripe", "shape",
                 "nnz_real")
SEGMENT_STATIC = ("n_blocks", "block_nnz", "max_segments", "shape", "nnz_real")


def _case(m=300, n=400, k=8, avg=6.0, seed=0):
    jmat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, k)).astype(np.float32)
    return jmat, CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape), x


def _assert_same(jfmt, tfmt, fields, static):
    for f in fields:
        want = np.asarray(getattr(jfmt, f))
        got = getattr(tfmt, f)
        if got.dtype == torch.bfloat16:
            got, want = got.float(), want.astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    for f in static:
        assert getattr(tfmt, f) == getattr(jfmt, f), f
    assert tfmt.padding_rate == pytest.approx(jfmt.padding_rate)
    assert tfmt.memory_bytes == jfmt.memory_bytes()


# Operator pipelines, written once for both packages: ``o`` is the ops
# module, ``L`` its Level.
PIPELINES = {
    "stripe_merge_path": lambda o, L: [
        o.SortOperator(0), o.MergePathBlockingOperator(0, L.TBLOCK, 128),
        o.ThreadTotalReduceOperator(0, L.TBLOCK), o.UniformBlockPadOperator(0, L.TBLOCK, 8)],
    "stripe_balanced": lambda o, L: [
        o.BalancedNnzRowBlockingOperator(0, L.TBLOCK, 96),
        o.ThreadTotalReduceOperator(0, L.TBLOCK), o.UniformBlockPadOperator(0, L.TBLOCK, 4)],
    "stripe_fixed_rows": lambda o, L: [
        o.FixedIntervalRowBlockingOperator(0, L.TBLOCK, 32),
        o.ThreadTotalReduceOperator(0, L.TBLOCK), o.UniformBlockPadOperator(0, L.TBLOCK, 1)],
    "stripe_nested": lambda o, L: [
        o.BalancedNnzRowBlockingOperator(0, L.WARP, 32),
        o.MergeAdjacentBlocksOperator(0, L.WARP, 32),
        o.GroupChildrenBlockingOperator(0, L.TBLOCK, L.WARP, children_per_parent=8),
        o.ChildOffsetsOperator(0, L.TBLOCK, L.WARP), o.RelativeIndexOperator(0, L.WARP, L.TBLOCK),
        o.ThreadTotalReduceOperator(0, L.TBLOCK)],
    "nnz_segment": lambda o, L: [
        o.FixedNnzBlockingOperator(0, L.TBLOCK, 128), o.SegmentReduceOperator(0, L.TBLOCK)],
    "sort_by_col": lambda o, L: [o.SortOperator(0, by="col")],
    "row_nnz_div": lambda o, L: [o.SortOperator(0), o.RowNnzMatrixDivOperator(0, bounds=(4, 16))],
    "fixed_row_div": lambda o, L: [o.FixedIntervalRowMatrixDivOperator(0, row_interval=64)],
    "empty_row_pad": lambda o, L: [o.FixedIntervalRowBlockingOperator(0, L.TBLOCK, 16),
                                   o.EmptyRowPadOperator(0)],
    "row_pad_multiple": lambda o, L: [o.FixedIntervalRowBlockingOperator(0, L.TBLOCK, 16),
                                      o.RowPadToMultipleOperator(0, multiple=4)],
    "brick_ell": lambda o, L: [
        o.SortOperator(0), o.FixedIntervalRowBlockingOperator(0, L.TBLOCK, 8),
        o.EllBlockPadOperator(0, L.TBLOCK), o.InterleaveStorageOperator(0, L.TBLOCK)],
    "calculation_method": lambda o, L: [o.CalculationMethodChooseOperator(0, "min_plus")],
}


def _run_both(name, jmat, tmat):
    """Runs PIPELINES[name] through both executors, holding every metadata
    item of the port equal to the JAX package's after each operator."""
    jm, tm = jms(jmat), tms(tmat)
    jex, tex = jops.OperatorExecutor(jm), tops.OperatorExecutor(tm)
    for jop, top in zip(PIPELINES[name](jops, JLevel), PIPELINES[name](tops, TLevel)):
        jex.add_and_run(jop)
        tex.add_and_run(top)
        assert len(tm) == len(jm), top.name
        for key in jm.keys():
            np.testing.assert_array_equal(tm.get(*key), jm.get(*key), err_msg=f"{top.name} {key}")
        assert getattr(top, "new_sub_ids", None) == getattr(jop, "new_sub_ids", None)
    assert tex.ctx.convert_to_string() == jex.ctx.convert_to_string()
    return jm, tm


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_operator_metadata_equals_jax(name):
    jmat, tmat, _ = _case(m=200, n=160, avg=6.0, seed=3)
    _run_both(name, jmat, tmat)


def test_operator_gates_equal_jax():
    # pipeline-order and metadata refusals (reference gates #1 and #2)
    jmat, tmat, _ = _case(seed=4)
    for o, L, make in ((jops, JLevel, jms), (tops, TLevel, tms)):
        ex = o.OperatorExecutor(make(jmat if o is jops else tmat))
        ex.add_and_run(o.MergePathBlockingOperator(0, L.TBLOCK, 128))
        with pytest.raises(o.InvalidOperator):
            ex.add_and_run(o.SortOperator(0))            # sort after blocking
        with pytest.raises(o.InvalidOperator):
            ex.add_and_run(o.MergePathBlockingOperator(0, L.TBLOCK, 64))  # blocked twice
        ex2 = o.OperatorExecutor(make(jmat if o is jops else tmat))
        ex2.add_and_run(o.FixedNnzBlockingOperator(0, L.TBLOCK, 128))
        with pytest.raises(o.InvalidOperator):
            ex2.add_and_run(o.ThreadTotalReduceOperator(0, L.TBLOCK))   # rows straddle


@pytest.mark.parametrize("work,sort,mult,vd", [(128, True, 8, None), (512, False, 4, None),
                                               (64, True, 1, "bfloat16"), (1024, True, 8, None)])
def test_prepare_stripe_format_equals_jax(work, sort, mult, vd):
    import jax.numpy as jnp

    jmat, tmat, x = _case(seed=5)
    jfmt, jm = jgen.prepare_stripe_format(jmat, work_per_stripe=work, sort=sort,
                                          nnz_multiple=mult,
                                          val_dtype=jnp.bfloat16 if vd else np.float32)
    tfmt, tm = tgen.prepare_stripe_format(tmat, work_per_stripe=work, sort=sort,
                                          nnz_multiple=mult, val_dtype=vd, device="cpu")
    _assert_same(jfmt, tfmt, tformat.STRIPE_FIELDS, STRIPE_STATIC)
    assert tfmt.vals.dtype == (torch.bfloat16 if vd else torch.float32)
    tm.logical_check()
    ref = spmm_reference(jmat, x.astype(np.float64))
    yj = np.asarray(jsg.stripe_spmm(jfmt, x))
    yt = tsg.stripe_spmm(tfmt, x).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(ref).max())
    if vd is None:
        check_result(yt, ref, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 8, 40])
def test_build_stripe_plan_matches_jax(k):
    jmat, tmat, x = _case(k=k, seed=6)
    jplan = jgen.build_stripe_plan(jmat, work_per_stripe=256, unroll=4)
    tplan = tgen.build_stripe_plan(tmat, work_per_stripe=256, unroll=4, device="cpu")
    assert tplan.meta == jplan.meta
    ref = spmm_reference(jmat, x.astype(np.float64))
    y = tplan(x).numpy()
    assert y.shape == (300, k)
    np.testing.assert_allclose(y, np.asarray(jplan(x)), rtol=0, atol=1e-5 * np.abs(ref).max())
    check_result(y, ref, rtol=1e-5)


@pytest.mark.parametrize("ktile", [8, 16])
def test_stripe_rows_plain_matches_stripe_call(ktile):
    jmat, _, x = _case(k=ktile, seed=7)
    jfmt, _ = jgen.prepare_stripe_format(jmat, work_per_stripe=128)
    rows_j = np.asarray(jsg._stripe_call(
        jfmt.cols, jfmt.lrow, jfmt.vals, np.pad(x, ((0, 0), (0, 0))),
        n_stripes=jfmt.n_stripes, stripe_nnz=jfmt.stripe_nnz, rb=jfmt.max_rows_per_stripe,
        ktile=ktile, unroll=8, interpret=True))
    t = tformat.stripe_format_from_numpy(
        {f: np.asarray(getattr(jfmt, f)) for f in tformat.STRIPE_FIELDS}, device="cpu",
        **{f: getattr(jfmt, f) for f in STRIPE_STATIC})
    rows_t = tsg.stripe_rows_plain(t.cols, t.lrow, t.vals, torch.from_numpy(x),
                                   rb=t.max_rows_per_stripe)
    assert rows_t.shape == rows_j.shape
    ref = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(rows_t.numpy(), rows_j, rtol=0, atol=1e-5 * np.abs(ref).max())


def _nested(jmat, tmat, unroll=4):
    jm, tm = _run_both("stripe_nested", jmat, tmat)
    jfmt = jformat.pack_stripe_nested(jm, 0, out_rows=jmat.shape[0], unroll=unroll)
    tfmt = tformat.pack_stripe_nested(tm, 0, out_rows=jmat.shape[0], unroll=unroll,
                                      device="cpu")
    return jfmt, tfmt


@pytest.mark.parametrize("unroll", [1, 4, 8])
def test_pack_stripe_nested_equals_jax(unroll):
    jmat, tmat, x = _case(seed=8)
    jfmt, tfmt = _nested(jmat, tmat, unroll)
    _assert_same(jfmt, tfmt, tformat.NESTED_FIELDS, NESTED_STATIC)
    ref = spmm_reference(jmat, x.astype(np.float64))
    y = tsg.stripe_nested_spmm(tfmt, x).numpy()
    np.testing.assert_allclose(y, np.asarray(jsg.stripe_nested_spmm(jfmt, x, unroll=unroll)),
                               rtol=0, atol=1e-5 * np.abs(ref).max())
    check_result(y, ref, rtol=1e-5)


def _hand_nested():
    """tests/test_torch_gpu.py's hand-built nested format at a CPU size: a
    row of 100 slots over sub-blocks 0, 2 and 3 of stripe 0 (sub-block 1
    empty), an all-padding stripe, an empty stripe, a value past the last
    sub-block of stripe 3."""
    from test_torch_gpu import nested_by_hand

    return nested_by_hand("cpu", long_row=100, n=400)


@pytest.mark.parametrize("case,k", [("packed", 8), ("by_hand", 1), ("by_hand", 5),
                                    ("by_hand", 37)])
def test_stripe_nested_plain_matches_nested_call(case, k):
    # the JAX kernel (interpret mode) and the port's plain version on the
    # packer's format and on one whose longest row crosses sub-blocks
    if case == "packed":
        jmat, tmat, _ = _case(seed=9)
        jfmt, _ = _nested(jmat, tmat)
        arrays = {f: np.asarray(getattr(jfmt, f)) for f in tformat.NESTED_FIELDS}
        t = tformat.nested_format_from_numpy(arrays, device="cpu",
                                             **{f: getattr(jfmt, f) for f in NESTED_STATIC})
        unroll = 4
    else:
        t = _hand_nested()
        arrays = {f: getattr(t, f).numpy() for f in tformat.NESTED_FIELDS}
        unroll = 8
    x = np.random.default_rng(k).standard_normal((t.shape[1], k)).astype(np.float32)
    rows_j = np.asarray(jsg._stripe_nested_call(
        arrays["cols"], arrays["lrow"], arrays["vals"], arrays["wnz"], arrays["wrow"], x,
        n_stripes=t.n_stripes, stripe_nnz=t.stripe_nnz, n_warps=t.n_warps,
        rb=t.max_rows_per_stripe, ktile=k, unroll=unroll, interpret=True))
    rows_t = tsg.stripe_nested_rows_plain(t.cols, t.lrow, t.vals, t.wnz, t.wrow,
                                          torch.from_numpy(x), rb=t.max_rows_per_stripe)
    scale = tsg.stripe_nested_rows_plain(t.cols, t.lrow, t.vals.abs(), t.wnz, t.wrow,
                                         torch.from_numpy(np.abs(x)), rb=t.max_rows_per_stripe)
    np.testing.assert_allclose(rows_t.numpy(), rows_j, rtol=0,
                               atol=1e-5 * max(float(scale.max()), 1.0))


def _nested_formats():
    jmat, tmat, _ = _case(seed=14)
    return {"packed": _nested(jmat, tmat, unroll=8)[1], "by_hand": _hand_nested()}


@pytest.mark.parametrize("bs", [8, 24, 1024])
def test_nested_slot_ranges_cover_walked_slots(bs):
    # the nested kernel's blocks: together they take every slot inside a
    # sub-block exactly once, and nothing before wnz[0] or past wnz[W]
    for name, fmt in _nested_formats().items():
        wnz = fmt.wnz.numpy().reshape(fmt.n_stripes, -1)
        ranges = tsg.nested_slot_ranges(fmt.wnz, fmt.stripe_nnz, bs)
        assert ranges.shape == (fmt.n_stripes, -(-fmt.stripe_nnz // bs), 2), name
        for p in range(fmt.n_stripes):
            taken = np.zeros(fmt.stripe_nnz, np.int64)
            for lo, hi in ranges[p]:
                taken[lo:max(lo, hi)] += 1
            want = (np.arange(fmt.stripe_nnz) >= wnz[p, 0]) & (np.arange(fmt.stripe_nnz) < wnz[p, -1])
            np.testing.assert_array_equal(taken, want.astype(np.int64), err_msg=f"{name} {p}")


def test_sub_block_lookup_is_searchsorted():
    # a lane's binary search and cursor give searchsorted's sub-block for
    # every slot of every block range and every start, empty sub-blocks too
    for name, fmt in _nested_formats().items():
        wnz = fmt.wnz.numpy().reshape(fmt.n_stripes, -1)
        for p in range(fmt.n_stripes):
            lo_all, hi_all = int(wnz[p, 0]), int(wnz[p, -1])
            starts = sorted({lo_all, *range(lo_all, hi_all, 7),
                             *(int(v) for v in wnz[p, :-1] if v < hi_all)})
            for lo in starts:
                want = np.searchsorted(wnz[p], np.arange(lo, hi_all), side="right") - 1
                np.testing.assert_array_equal(tsg.sub_block_of(wnz[p], lo, hi_all), want,
                                              err_msg=f"{name} stripe {p} from {lo}")
        assert (np.diff(wnz, axis=1) == 0).any() or name == "packed"


def test_nested_row_runs_counts_runs_of_live_slots():
    for name, fmt in _nested_formats().items():
        runs, live = tsg.nested_row_runs(fmt)
        # every stripe's slots in order, skipping zeros and slots outside
        # its sub-blocks; a run goes on across a sub-block boundary
        wnz = fmt.wnz.numpy().reshape(fmt.n_stripes, -1)
        wrow = fmt.wrow.numpy().reshape(fmt.n_stripes, -1)
        want_runs = want_live = 0
        for p in range(fmt.n_stripes):
            prev = None
            for w in range(fmt.n_warps):
                for i in range(wnz[p, w], wnz[p, w + 1]):
                    if fmt.vals[p, 0, i] != 0:
                        row = int(wrow[p, w] + fmt.lrow[p, 0, i])
                        want_runs += row != prev
                        want_live += 1
                        prev = row
        assert (runs, live) == (want_runs, want_live), name
        assert runs < live
    assert tsg.nested_row_runs(_hand_nested()) == (13, 172)


@pytest.mark.parametrize("kp,want", [(1, (4, 4)), (2, (4, 4)), (4, (4, 4)), (8, (8, 8)),
                                     (40, (40, 64)), (256, (256, 256)), (544, (544, 512))])
def test_nested_geometry(kp, want):
    # X of 1 or 2 columns read padded to 4; the narrowest panel past that
    assert tsg.nested_geometry(kp) == want


def test_pack_segment_and_segment_spmm_match_jax():
    jmat, tmat, x = _case(m=120, n=200, k=5, avg=8.0, seed=10)
    jm, tm = _run_both("nnz_segment", jmat, tmat)
    jfmt = jformat.pack_segment(jm, 0, out_rows=120)
    tfmt = tformat.pack_segment(tm, 0, out_rows=120, device="cpu")
    _assert_same(jfmt, tfmt, tformat.SEGMENT_FIELDS, SEGMENT_STATIC)
    ref = spmm_reference(jmat, x.astype(np.float64))
    y = tnnz.segment_spmm(tfmt, x).numpy()
    np.testing.assert_allclose(y, np.asarray(jnnz.segment_spmm(jfmt, x)), rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    check_result(y, ref, rtol=1e-5)
    from_jax = tformat.segment_format_from_numpy(
        {f: np.asarray(getattr(jfmt, f)) for f in tformat.SEGMENT_FIELDS}, device="cpu",
        **{f: getattr(jfmt, f) for f in SEGMENT_STATIC})
    torch.testing.assert_close(tnnz.segment_spmm(from_jax, x), torch.from_numpy(y))


@pytest.mark.parametrize("block_nnz,ct,g,k,precision", [(128, 64, 32, 8, "fp32x2"),
                                                       (300, 128, 64, 3, "fp32"),
                                                       (1 << 20, 64, 16, 12, "fp32x2")])
def test_segment_span_equals_jax(block_nnz, ct, g, k, precision):
    jmat, tmat, x = _case(m=150, n=300, k=k, avg=7.0, seed=11)
    jfmt = jnnz.pack_segment_span(jmat, block_nnz=block_nnz, ct=ct, g=g)
    tfmt = tnnz.pack_segment_span(tmat, block_nnz=block_nnz, ct=ct, g=g, device="cpu")
    for f in ("c0", "cols", "lrow", "vals", "row_of_slot"):
        np.testing.assert_array_equal(getattr(tfmt, f).numpy(), np.asarray(getattr(jfmt, f)),
                                      err_msg=f)
    for f in ("n_blocks", "n_chunks", "chunk_g", "rb", "ct", "shape", "nnz_real"):
        assert getattr(tfmt, f) == getattr(jfmt, f), f
    assert tfmt.memory_bytes == jfmt.memory_bytes
    ref = spmm_reference(jmat, x.astype(np.float64))
    y = tnnz.segment_span_spmm(tfmt, x, precision=precision).numpy()
    np.testing.assert_allclose(y, np.asarray(jnnz.segment_span_spmm(jfmt, x, precision=precision)),
                               rtol=0, atol=1e-4 * np.abs(ref).max())
    check_result(y, ref, rtol=1e-5)


def test_formats_from_numpy_check_indices():
    jmat, tmat, _ = _case(seed=12)
    jfmt, _ = jgen.prepare_stripe_format(jmat, work_per_stripe=128)
    fields = {f: np.asarray(getattr(jfmt, f)).copy() for f in tformat.STRIPE_FIELDS}
    static = {f: getattr(jfmt, f) for f in STRIPE_STATIC}
    tformat.stripe_format_from_numpy(fields, device="cpu", **static)
    for name, bad in (("cols", 400), ("lrow", jfmt.max_rows_per_stripe)):
        broken = dict(fields, **{name: fields[name].copy()})
        broken[name][0, 0, 0] = bad
        with pytest.raises(ValueError, match="out of range"):
            tformat.stripe_format_from_numpy(broken, device="cpu", **static)
    with pytest.raises(ValueError, match="shape"):
        tformat.stripe_format_from_numpy(dict(fields, vals=fields["vals"][:1]), device="cpu",
                                         **static)
    jn, _ = _nested(jmat, tmat)
    nf = {f: np.asarray(getattr(jn, f)).copy() for f in tformat.NESTED_FIELDS}
    nstatic = {f: getattr(jn, f) for f in NESTED_STATIC}
    tformat.nested_format_from_numpy(nf, device="cpu", **nstatic)
    broken = dict(nf, wrow=nf["wrow"].copy())
    broken["wrow"][0, 0, 0] = jn.max_rows_per_stripe       # rows past the stripe's tile
    with pytest.raises(ValueError, match="out of range"):
        tformat.nested_format_from_numpy(broken, device="cpu", **nstatic)
    broken = dict(nf, wnz=nf["wnz"][:, :, ::-1].copy())    # runs out of order
    with pytest.raises(ValueError, match="out of range"):
        tformat.nested_format_from_numpy(broken, device="cpu", **nstatic)


def test_wrappers_refuse_cpu_tensors_and_plain_skips_padding():
    _, tmat, x = _case(seed=13)
    fmt, _ = tgen.prepare_stripe_format(tmat, work_per_stripe=128, device="cpu")
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsg.stripe_rows_cuda(fmt.cols, fmt.lrow, fmt.vals, xt, rb=fmt.max_rows_per_stripe, kt=8,
                             live=fmt.live_p)
    nest = _nested(*_case(seed=13)[:2])[1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsg.stripe_nested_rows_cuda(nest.cols, nest.lrow, nest.vals, nest.wnz, nest.wrow, xt,
                                    rb=nest.max_rows_per_stripe, kt=8)
    # a value in a slot past the stripe's last warp run is not walked
    vals = nest.vals.clone()
    p = int(torch.argmin(nest.wnz[:, 0, -1]))
    assert int(nest.wnz[p, 0, -1]) < nest.stripe_nnz
    vals[p, 0, -1] = 7.0
    torch.testing.assert_close(
        tsg.stripe_nested_rows_plain(nest.cols, nest.lrow, vals, nest.wnz, nest.wrow, xt,
                                     rb=nest.max_rows_per_stripe),
        tsg.stripe_nested_rows_plain(nest.cols, nest.lrow, nest.vals, nest.wnz, nest.wrow, xt,
                                     rb=nest.max_rows_per_stripe))
    with pytest.raises(ValueError, match="X is on"):
        tsg.stripe_spmm(fmt, torch.zeros((400, 8), device="meta"))


def _stored_zero_case(seed=21):
    """A power-law 300 x 400 matrix whose every row ends in a stored zero
    (an entry of the COO with value 0), so that every stripe's live part
    ends in one; and x."""
    _, tmat, x = _case(seed=seed)
    vals = tmat.vals.copy()
    vals[np.r_[np.nonzero(np.diff(tmat.rows))[0], tmat.rows.size - 1]] = 0.0
    return CooMatrix(tmat.rows, tmat.cols, vals, tmat.shape), x


def _stripe_formats(mat):
    """The port's stripe and segment formats of ``mat`` on every packer
    path: stripe_total (merge path, balanced, fixed rows) and nnz_segment
    through build_plan, build_stripe_plan with and without sort, bf16
    values."""
    from tpusparse_torch.schedule import Schedule, build_plan

    out = {f"prepare sort={sort} vals={vd}": tgen.prepare_stripe_format(
        mat, work_per_stripe=96, sort=sort, val_dtype=vd, device="cpu")[0]
        for sort, vd in ((True, None), (False, None), (True, "bfloat16"))}
    out["build_stripe_plan"] = tgen.build_stripe_plan(mat, work_per_stripe=128,
                                                      device="cpu").formats[0]
    for name, kw in (("merge_path", dict(work_per_block=128)),
                     ("balanced", dict(blocking="balanced", work_per_block=96)),
                     ("fixed_rows", dict(blocking="fixed_rows", row_interval=32))):
        out[name] = build_plan(mat, Schedule(family="stripe_total", unroll=8, **kw),
                               device="cpu").formats[0]
    out["nnz_segment"] = build_plan(mat, Schedule(family="nnz_segment", work_per_block=128,
                                                  unroll=8), device="cpu").formats[0]
    return out


@pytest.mark.parametrize("stored_zeros", [False, True])
def test_live_slots_are_each_stripes_pattern_prefix(stored_zeros):
    # live_p counts each stripe's entries of the COO, stored zeros among
    # them, and every nonzero of a stripe lies before it (the packers append
    # the padding at a stripe's end); without stored zeros it equals the
    # count derived from the values, as for a format of the JAX package's
    mat = _stored_zero_case()[0] if stored_zeros else _case(seed=21)[1]
    for name, fmt in _stripe_formats(mat).items():
        P, _, C = fmt.cols.shape
        live = fmt.live_p.numpy()
        assert live.shape == (P,) and live.dtype == np.int32, name
        vals = fmt.vals.float().numpy().reshape(P, C)
        assert not (vals * (np.arange(C)[None, :] >= live[:, None])).any(), name
        assert int(live.sum()) == mat.nnz, name
        derived = tformat.live_counts(fmt.vals.float().numpy())
        if stored_zeros:  # the derived count drops each stripe's trailing stored zero
            assert (derived <= live).all() and (derived < live).any(), name
        else:
            np.testing.assert_array_equal(derived, live, err_msg=name)
        assert fmt.memory_bytes == sum(getattr(fmt, f).numel() * getattr(fmt, f).element_size()
                                       for f in ("cols", "lrow", "vals")
                                       + (("row_of_slot",) if name == "nnz_segment" else ()))


def test_live_slots_of_jax_formats_are_derived():
    # a format made from the JAX package's arrays: live_p is the last slot
    # holding a nonzero plus one, the port's packer gives the same on a
    # matrix without stored zeros, and a given live_p is taken as it is
    jmat, tmat, _ = _case(seed=22)
    jfmt, _ = jgen.prepare_stripe_format(jmat, work_per_stripe=128)
    fields = {f: np.asarray(getattr(jfmt, f)) for f in tformat.STRIPE_FIELDS}
    static = {f: getattr(jfmt, f) for f in STRIPE_STATIC}
    t = tformat.stripe_format_from_numpy(fields, device="cpu", **static)
    ported, _ = tgen.prepare_stripe_format(tmat, work_per_stripe=128, device="cpu")
    torch.testing.assert_close(t.live_p, ported.live_p)
    given = tformat.stripe_format_from_numpy(dict(fields, live_p=np.full(jfmt.n_stripes,
                                                                         jfmt.stripe_nnz)),
                                             device="cpu", **static)
    assert (given.live_p == jfmt.stripe_nnz).all()
    with pytest.raises(ValueError, match="live slots"):
        tformat.stripe_format_from_numpy(dict(fields, live_p=np.full(jfmt.n_stripes, -1)),
                                         device="cpu", **static)
    jm, _ = _run_both("nnz_segment", jmat, tmat)
    jseg = jformat.pack_segment(jm, 0, out_rows=300)
    seg = tformat.segment_format_from_numpy(
        {f: np.asarray(getattr(jseg, f)) for f in tformat.SEGMENT_FIELDS}, device="cpu",
        **{f: getattr(jseg, f) for f in SEGMENT_STATIC})
    assert int(seg.live_p.sum()) == jmat.nnz and (seg.live_p[:-1] == jseg.block_nnz).all()


def _live_only_rows(fmt, vals, x):
    """y_slots from each stripe's live slots only, as the kernel walks them
    (float64)."""
    P, _, C = fmt.cols.shape
    rb = getattr(fmt, "max_rows_per_stripe", None) or fmt.max_segments
    y = np.zeros((P * rb, x.shape[1]))
    v = vals.float().numpy().reshape(P, C).astype(np.float64)
    cols, lrow = fmt.cols.numpy().reshape(P, C), fmt.lrow.numpy().reshape(P, C)
    for p, n in enumerate(fmt.live_p.tolist()):
        np.add.at(y, p * rb + lrow[p, :n], v[p, :n, None] * x[cols[p, :n]].astype(np.float64))
    return y


def test_stripe_rows_plain_over_live_slots_equals_all_slots():
    # the plain version walks every slot whose value is not zero; the
    # kernel only the live ones: the same y_slots, also after a stored zero
    # is made nonzero in the format's plane (training, load_state_dict)
    mat, x = _stored_zero_case(seed=23)
    for name, fmt in _stripe_formats(mat).items():
        rb = getattr(fmt, "max_rows_per_stripe", None) or fmt.max_segments
        vals = fmt.vals.clone()
        p = int(torch.argmax(fmt.live_p))
        vals[p, 0, int(fmt.live_p[p]) - 1] = 2.5                 # the stored zero
        assert tformat.live_counts(vals.float().numpy())[p] == fmt.live_p[p]
        for v in (fmt.vals, vals):
            want = tsg.stripe_rows_plain(fmt.cols, fmt.lrow, v, torch.from_numpy(x), rb=rb)
            scale = tsg.stripe_rows_plain(fmt.cols, fmt.lrow, v.abs(), torch.from_numpy(
                np.abs(x)), rb=rb)
            np.testing.assert_allclose(_live_only_rows(fmt, v, x), want.numpy(), rtol=0,
                                       atol=1e-5 * max(float(scale.max()), 1.0), err_msg=name)


@pytest.mark.parametrize("bs", [8, 24, 1024])
def test_stripe_slot_ranges_cover_live_slots(bs):
    # the stripe kernel's blocks: together they take every live slot of a
    # stripe exactly once, and nothing past it (the hand-built format of
    # the card tests: a row cut over blocks, a stripe with no live slot)
    from test_torch_gpu import stripe_by_hand

    fmts = dict(_stripe_formats(_stored_zero_case()[0]),
                by_hand=stripe_by_hand("cpu", long_row=100, n=400))
    for name, fmt in fmts.items():
        P, _, C = fmt.cols.shape
        ranges = tsg.stripe_slot_ranges(fmt.live_p, C, bs)
        assert ranges.shape == (P, -(-C // bs), 2), name
        for p in range(P):
            taken = np.zeros(C, np.int64)
            for lo, hi in ranges[p]:
                taken[lo:max(lo, hi)] += 1
            np.testing.assert_array_equal(taken, (np.arange(C) < int(fmt.live_p[p])).astype(
                np.int64), err_msg=f"{name} {p}")


def test_stripe_row_runs_counts_runs_of_live_slots():
    from test_torch_gpu import stripe_by_hand

    fmts = dict(_stripe_formats(_case(seed=24)[1]),
                by_hand=stripe_by_hand("cpu", long_row=100, n=400))
    for name, fmt in fmts.items():
        P, _, C = fmt.cols.shape
        want_runs = want_live = 0
        for p in range(P):
            prev = None
            for i in range(int(fmt.live_p[p])):
                if fmt.vals[p, 0, i] != 0:
                    row = int(fmt.lrow[p, 0, i])
                    want_runs += row != prev
                    want_live += 1
                    prev = row
        assert tsg.stripe_row_runs(fmt) == (want_runs, want_live), name
        assert want_runs < want_live
    # by hand: stripe 0's four rows, stripe 2's three, stripe 3's three with
    # stored zeros inside them
    assert tsg.stripe_row_runs(fmts["by_hand"]) == (10, 3 + 1 + 100 + 4 + 38 + 50)
