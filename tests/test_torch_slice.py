"""The port's default SpMM path as a whole, on the CPU, against the JAX
package: builders, the schedule decision tree, build_plan, spmm and tune.
The JAX side runs its Pallas kernels in interpret mode (tests/conftest.py).
"""

import io

import numpy as np
import pytest
import torch

import tpusparse
import tpusparse_torch
from tpusparse import schedule as jsched
from tpusparse import tune as jtune
from tpusparse.io import builder as jbuilder
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch import schedule as tsched
from tpusparse_torch import tune as ttune
from tpusparse_torch.gates import TPU_GATES
from tpusparse_torch.io import builder as tbuilder
from tpusparse_torch.io.mtx import CooMatrix, read_mtx, write_mtx


def _mat(m=300, n=400, avg=6.0, seed=0):
    return tbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)


def _x(n, k, seed=1):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


@pytest.mark.parametrize("name,args,kw", [
    ("power_law_coo", (300, 400), dict(avg_nnz_per_row=6.0, seed=3)),
    ("power_law_coo", (2000, 1600), dict(avg_nnz_per_row=7.0, alpha=2.2, max_row=50, seed=11)),
    ("uniform_coo", (64, 48), dict(nnz_per_row=4, seed=1)),
])
def test_builders_equal_jax(name, args, kw):
    a = getattr(jbuilder, name)(*args, **kw)
    b = getattr(tbuilder, name)(*args, **kw)
    assert a.shape == b.shape
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_mtx_roundtrip_and_coo_helpers(tmp_path):
    mat = _mat(seed=2)
    write_mtx(tmp_path / "a.mtx", mat)
    back = read_mtx(tmp_path / "a.mtx")
    assert back.shape == mat.shape and back.is_row_major_sorted()
    np.testing.assert_array_equal(back.rows, mat.rows)
    np.testing.assert_allclose(back.vals, mat.vals)
    sym = read_mtx(io.StringIO("%%MatrixMarket matrix coordinate real symmetric\n"
                               "3 3 2\n2 1 5.0\n3 3 1.0\n"))
    np.testing.assert_array_equal(sym.to_dense(), [[0, 5, 0], [5, 0, 0], [0, 0, 1]])
    dup = CooMatrix(np.array([0, 0, 1]), np.array([1, 1, 0]), np.array([1.0, 2.0, 3.0]), (2, 2))
    np.testing.assert_array_equal(dup.sum_duplicates().vals, [3.0, 3.0])
    np.testing.assert_array_equal(dup.dedup().vals, [1.0, 3.0])
    np.testing.assert_array_equal(mat.row_lengths(), np.bincount(mat.rows, minlength=300))


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate real general\n% c\n3 4 3\n1 2 0.5\n3 1 -2\n2 4 7\n",
    "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n2 1\n1 2\n",
    "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n2 1 4.0\n3 2 -1.5\n",
    "3 3 2\n1 1 2.0\n3 2 1.0\n",      # bare "rows cols nnz" first line
    "2 3\n2 3 1.0\n",                  # bare "rows cols"
])
def test_read_mtx_equals_jax(text):
    a = tpusparse.io.read_mtx(io.StringIO(text))
    b = read_mtx(io.StringIO(text))
    assert a.shape == b.shape
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("text", ["%%MatrixMarket matrix coordinate real general\n3\n",
                                  "3 3 2 9\n1 1 1.0\n", "% only comments\n"])
def test_read_mtx_rejects_malformed(text):
    with pytest.raises(ValueError):
        read_mtx(io.StringIO(text))


def test_time_fn_refuses_a_cpu_output():
    from tpusparse_torch.bench.harness import device_time_fn, time_fn, time_fn_host

    for timer in (time_fn, device_time_fn):
        with pytest.raises(RuntimeError, match="times the card"):
            timer(lambda v: v * 2, torch.ones(4))
    assert time_fn_host(lambda v: v * 2, torch.ones(4), iters=2, warmup=1) > 0


@pytest.mark.parametrize("n,k", [(400, 1), (400, 3), (400, 8), (400, 40), (400, 64),
                                 (400, 200), (2_000_000, 1), (300_000, 3), (400_000, 8),
                                 (1_000_000, 8), (100_000, 64), (2_000_000, 64), (400, None),
                                 (32768, 256), (262144, 8), (262144, 5)])
def test_default_schedule_equals_jax(n, k):
    tmat = CooMatrix(np.array([0]), np.array([0]), np.array([1.0]), (10, n))
    jmat = tpusparse.CooMatrix(np.array([0]), np.array([0]), np.array([1.0]), (10, n))
    assert tsched.default_schedule(tmat, k, gates=TPU_GATES).describe() == \
        jsched.default_schedule(jmat, k).describe()


@pytest.mark.parametrize("k,full", [(1, False), (8, False), (32, False), (40, False),
                                    (64, False), (8, True)])
def test_default_candidates_equal_jax_dg_block(k, full):
    # the whole JAX list, the dg_span and dgt_span blocks among it
    jmat = jbuilder.power_law_coo(500, 600, avg_nnz_per_row=8.0, seed=4)
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    want = [s.describe() for s in jtune.default_candidates(jmat, k, full=full)]
    got = [s.describe() for s in ttune.default_candidates(tmat, k, full=full, gates=TPU_GATES)]
    assert got == want
    assert any(s["family"] == "dgt_span" for s in got) == (k > 1)


@pytest.mark.parametrize("k,full", [(8, False), (64, False), (200, False), (200, True)])
@pytest.mark.parametrize("n", [600, 60000])
def test_default_candidates_equal_jax_without_unported_families(k, full, n):
    # at n = 60000 X passes no span gate at K = 64 (span_colsplit) and K = 8
    # takes the dgt block only where dg's gate holds
    jmat = jbuilder.power_law_coo(500, n, avg_nnz_per_row=8.0, seed=4)
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    want = [s.describe() for s in jtune.default_candidates(jmat, k, full=full)]
    got = [s.describe() for s in ttune.default_candidates(tmat, k, full=full, gates=TPU_GATES)]
    assert got == want
    fams = [s["family"] for s in got]
    assert fams.count("tile_onehot") == (9 if full else 3)
    assert ("span_colsplit" in fams) == (k == 64 and n == 60000)
    assert ("span_onehot" in fams) == (k <= 128 and not (k == 64 and n == 60000))
    assert ttune._span_configs(jmat.density) == jtune._span_configs(jmat.density)


def test_default_candidates_insert_auto_rb_dgt_like_jax():
    # a sparse wide matrix: auto_rb_dgt exceeds 512 and leads the dgt block
    jmat = jbuilder.power_law_coo(8192, 60000, avg_nnz_per_row=2.0, seed=9)
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    want = [s.describe() for s in jtune.default_candidates(jmat, 8)]
    got = [s.describe() for s in ttune.default_candidates(tmat, 8, gates=TPU_GATES)]
    assert got == want and [s["rb"] for s in got if s["family"] == "dgt_span"][0] > 512


@pytest.mark.parametrize("k", [1, 3, 8, 40, 64])
def test_spmm_cpu_matches_jax_and_oracle(k):
    tmat = _mat()
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    x = _x(400, k)
    y = tpusparse_torch.spmm(tmat, x, device="cpu")
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu" and y.shape == (300, k)
    want = spmm_reference(jmat, x.astype(np.float64))
    check_result(y.numpy(), np.asarray(tpusparse.spmm(jmat, x)), rtol=5e-4)
    check_result(y.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("sched", [
    dict(rb=128, ns=4, g=128, ktile=8),
    dict(rb=64, ns=2, g=256, ktile=16),
    dict(rb=128, ns=4, g=128, ktile=8, precision="bf16"),
    dict(rb=256, ns=2, g=128, ktile=1),
])
def test_build_plan_explicit_dg_schedules(sched):
    mat = _mat(seed=5)
    s = tsched.Schedule(family="dg_span", unroll=8, **sched)
    k = 1 if s.ktile == 1 else 12
    x = _x(400, k, seed=6)
    plan = tsched.build_plan(mat, s, device="cpu")
    fmt = plan.formats[0]
    assert fmt.rb == s.rb and fmt.ns == s.ns and fmt.chunk_g == s.g
    assert plan.meta["schedule"] == s.describe()
    assert "grid_block" in plan.meta["operator_history"]
    summary = plan.cost_summary(k)
    assert summary["nnz"] == mat.nnz and summary["format_bytes"] == fmt.memory_bytes
    check_result(plan(x).numpy(), spmm_reference(mat, x.astype(np.float64)),
                 rtol=8e-2 if s.precision == "bf16" else 1e-5)


@pytest.mark.parametrize("sched", [
    dict(rb=128, g=256, nw=4, ktile=8),
    dict(rb=128, g=128, nw=8, ktile=16, resid=False, walk="single"),
    dict(rb=128, g=256, nw=2, ktile=8, precision="bf16", rowhot_i8=True),
    dict(rb=64, g=128, nw=1, ktile=32, scatter="fullrow", pipe=True),
])
def test_build_plan_explicit_dgt_schedules(sched):
    mat = _mat(seed=5)
    s = tsched.Schedule(family="dgt_span", unroll=8, **sched)
    x = _x(400, 12, seed=6)
    plan = tsched.build_plan(mat, s, device="cpu")
    fmt = plan.formats[0]
    assert (fmt.rb, fmt.chunk_g, fmt.nw, fmt.resid) == (s.rb, s.g, s.nw, s.resid)
    assert fmt.kt == s.ktile and plan.meta["schedule"] == s.describe()
    assert "grid_block" in plan.meta["operator_history"]
    assert plan.cost_summary(12)["format_bytes"] == fmt.memory_bytes
    check_result(plan(x).numpy(), spmm_reference(mat, x.astype(np.float64)),
                 rtol=8e-2 if s.precision == "bf16" else 1e-5)


def test_build_plan_dgt_span_matches_jax():
    tmat = _mat(seed=16)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    kw = dict(family="dgt_span", rb=128, g=256, nw=8, unroll=8, ktile=8)
    jplan = jsched.build_plan(jmat, jsched.Schedule(**kw))
    tplan = tsched.build_plan(tmat, tsched.Schedule(**kw), device="cpu")
    dg_plan = tsched.build_plan(tmat, tsched.Schedule(family="dg_span", ktile=8), device="cpu")
    assert set(tplan.meta) == set(dg_plan.meta)
    assert tplan.meta["schedule"] == jplan.meta["schedule"]
    assert tplan.meta["padding_rate"] == pytest.approx(jplan.meta["padding_rate"])
    for f in ("wins", "cols", "lrw", "vals", "slot_of_origrow"):
        np.testing.assert_array_equal(getattr(tplan.formats[0], f).numpy(),
                                      np.asarray(getattr(jplan.formats[0], f)), err_msg=f)
    x = _x(400, 8, seed=17)
    want = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(tplan(x).numpy(), np.asarray(jplan(x)), rtol=0,
                               atol=1e-4 * np.abs(want).max())
    check_result(tplan(x).numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(family="span_onehot", rb=64, ct=128, g=32, unroll=4),
    dict(family="tile_onehot", rb=64, ct=64, g=32, unroll=4),
    dict(family="span_colsplit", col_split=2, rb=64, ct=128, g=32, unroll=4),
    dict(family="span_colsplit", col_split=3, rb=64, ct=128, g=32, unroll=4),
])
def test_build_plan_tile_and_span_families_match_jax(kw):
    tmat = _mat(seed=16)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    jplan = jsched.build_plan(jmat, jsched.Schedule(**kw))
    tplan = tsched.build_plan(tmat, tsched.Schedule(**kw), device="cpu")
    assert tplan.meta["schedule"] == jplan.meta["schedule"]
    assert tplan.meta["n_subs"] == jplan.meta["n_subs"] == len(tplan.formats)
    assert tplan.meta["padding_rate"] == pytest.approx(jplan.meta["padding_rate"])
    if kw["family"] == "span_colsplit":
        assert tplan.meta["operator_history"] == jplan.meta["operator_history"]
    else:
        assert kw["family"] in tplan.meta["operator_history"] or "grid_block" in \
            tplan.meta["operator_history"]
    for tf, jf in zip(tplan.formats, jplan.formats):
        fields = ("c0", "cols", "lrow", "vals", "slot_of_origrow") if hasattr(jf, "c0") else \
            ("chunk_tile", "cols", "lrow", "vals", "slot_of_origrow")
        for f in fields:
            np.testing.assert_array_equal(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                          err_msg=f)
        assert (tf.ct, tf.rb, tf.chunk_g) == (jf.ct, jf.rb, jf.chunk_g)
    x = _x(400, 8, seed=17)
    want = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(tplan(x).numpy(), np.asarray(jplan(x)), rtol=0,
                               atol=1e-4 * np.abs(want).max())
    check_result(tplan(x).numpy(), want, rtol=1e-5)
    assert tplan.cost_summary(8)["format_bytes"] == sum(f.memory_bytes for f in tplan.formats)


def test_spmm_default_tile_path_at_wide_k_matches_jax():
    # K > 128: the default schedule is tile_onehot, two K tiles on the TPU
    tmat = _mat(m=120, n=100, seed=18)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    x = _x(100, 200, seed=19)
    assert tsched.default_schedule(tmat, 200).family == "tile_onehot"
    y = tpusparse_torch.spmm(tmat, x, device="cpu")
    assert y.shape == (120, 200)
    want = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(y.numpy(), np.asarray(tpusparse.spmm(jmat, x)), rtol=0,
                               atol=1e-4 * np.abs(want).max())
    check_result(y.numpy(), want, rtol=1e-5)


def test_tune_cpu_picks_a_dg_candidate(tmp_path):
    # a candidate of a ported family: at K = 8 every ported family's rows are
    # in the list
    mat = _mat(seed=7)
    x = _x(400, 8, seed=8)
    with tpusparse_torch.config_override(cache_dir=str(tmp_path)):
        res = ttune.tune(mat, x, iters=2, device="cpu")
        again = ttune.tune(mat, x, iters=2, device="cpu", budget=1)
    assert res.best_schedule.family in tsched.KERNEL_FAMILIES
    # a skewed matrix (longest row 254 > 32 x the mean): every sparse block
    assert {r["schedule"]["family"] for r in res.table} == {
        "dg_span", "dgt_span", "radix_span", "brick_ell", "span_onehot", "tile_onehot",
        "stripe_total", "segment_span", "nnz_segment", "bucketed"}
    assert all(r["ok"] and r["device"] == "cpu" for r in res.table)
    assert len(res.table) == len(ttune.default_candidates(mat, 8))
    check_result(res.best(x).numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=2e-3)
    assert again.table[0]["schedule"] == res.best_schedule.describe()  # cached winner first
    assert (tmp_path / "results.jsonl").read_text().count("\n") == len(res.table) + 1


def test_tune_times_one_plan_once(tmp_path):
    # candidates that differ only in TPU-only knobs are one plan on the card
    mat = _mat(seed=7)
    x = _x(400, 8, seed=8)
    base = tsched.Schedule(family="dgt_span", rb=128, g=256, nw=2, unroll=8, ktile=8)
    cands = [base, tsched.dataclasses.replace(base, rowhot_i8=True, unroll=16),
             tsched.dataclasses.replace(base, nw=4),
             tsched.dataclasses.replace(base, scatter="fullrow", pipe=True)]
    assert len({c.plan_key() for c in cands}) == 2
    with tpusparse_torch.config_override(cache_dir=str(tmp_path)):
        res = ttune.tune(mat, x, iters=1, device="cpu", candidates=cands)
    first, dup, other, dup2 = res.table
    assert [r["schedule"] for r in res.table] == [c.describe() for c in cands]
    assert "same_plan_as" not in first and "same_plan_as" not in other
    for d in (dup, dup2):
        assert d["same_plan_as"] == first["schedule"] and d["ok"]
        assert d["seconds"] == first["seconds"] and d["pack_seconds"] == first["pack_seconds"]
    assert res.best_schedule in (base, cands[2])


def test_tune_drops_cached_schedule_of_unported_family(tmp_path):
    import json

    mat = _mat(seed=7)
    x = _x(400, 8, seed=8)
    sig = ttune.matrix_signature(mat)
    # a family this package does not know (every JAX family is ported)
    (tmp_path / f"tune_{sig}_k8.json").write_text(json.dumps(
        {"schedule": tsched.Schedule(family="dense_panel").describe()}))
    with tpusparse_torch.config_override(cache_dir=str(tmp_path)):
        res = ttune.tune(mat, x, iters=1, device="cpu", budget=1)
    assert res.table[0]["schedule"]["family"] == "dg_span"


def test_tune_accepts_cached_dgt_schedule(tmp_path):
    import json

    mat = _mat(seed=7)
    x = _x(400, 8, seed=8)
    cached = tsched.Schedule(family="dgt_span", rb=128, g=256, nw=2, unroll=8, ktile=8)
    (tmp_path / f"tune_{ttune.matrix_signature(mat)}_k8.json").write_text(json.dumps(
        {"schedule": cached.describe()}))
    with tpusparse_torch.config_override(cache_dir=str(tmp_path)):
        res = ttune.tune(mat, x, iters=1, device="cpu", budget=1)
    assert res.table[0]["schedule"] == cached.describe() and res.best_schedule == cached


@pytest.mark.parametrize("kw", [dict(sort=True), dict(bucket_bounds=(8,))])
def test_unported_converting_options_raise(kw):
    # the converting options were unported until the sort and row-nnz div
    # operators came (ROADMAP.md A.7): now they build the JAX package's plan
    tmat = _mat(seed=19)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    sk = dict(family="dg_span", ktile=8, rb=128, ns=4, g=128, **kw)
    tplan = tsched.build_plan(tmat, tsched.Schedule(**sk), device="cpu")
    jplan = jsched.build_plan(jmat, jsched.Schedule(**sk))
    assert tplan.meta["operator_history"] == jplan.meta["operator_history"]
    assert tplan.meta["n_subs"] == jplan.meta["n_subs"] == (2 if "bucket_bounds" in kw else 1)
    x = _x(400, 8, seed=20)
    want = spmm_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(tplan(x).numpy(), np.asarray(jplan(x)), rtol=0,
                               atol=2e-3 * np.abs(want).max())
    check_result(tplan(x).numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(family="stripe_total", work_per_block=128, unroll=8),
    dict(family="stripe_total", blocking="balanced", work_per_block=96, unroll=4),
    dict(family="stripe_total", blocking="fixed_rows", row_interval=32, unroll=8, sort=True),
    dict(family="stripe_nested", work_per_block=256, unroll=4),
    dict(family="nnz_segment", work_per_block=128, unroll=8),
    dict(family="segment_span", work_per_block=256, ct=64, g=32),
    dict(family="radix_span", rb=128, sublanes=16, g=128, ktile=4),
    dict(family="radix_span", rb=64, sublanes=32, g=64, ktile=8, precision="bf16"),
    dict(family="brick_ell", sort=True, rb=128, sublanes=32, g=64, ktile=8),
    dict(family="bucketed", bucket_bounds=(8,)),
    dict(family="bucketed", bucket_bounds=(4, 16), bucket_schedules=(
        tsched.Schedule(family="stripe_total", work_per_block=64),
        tsched.Schedule(family="radix_span", rb=64, sublanes=16, g=64, ktile=8),
        tsched.Schedule(family="nnz_segment", work_per_block=64)), sort=True),
    dict(family="span_onehot", rb=64, ct=128, g=32, sort=True),
    dict(family="tile_onehot", rb=64, ct=64, g=32, sort=True),
])
def test_build_plan_new_families_match_jax(kw):
    tmat = _mat(seed=21)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    jkw = dict(kw)
    if "bucket_schedules" in kw:
        jkw["bucket_schedules"] = tuple(jsched.Schedule(**s.describe())
                                        for s in kw["bucket_schedules"])
    jplan = jsched.build_plan(jmat, jsched.Schedule(**jkw))
    tplan = tsched.build_plan(tmat, tsched.Schedule(**kw), device="cpu")
    assert tplan.meta["schedule"] == jplan.meta["schedule"]
    assert tplan.meta["n_subs"] == jplan.meta["n_subs"] == len(tplan.formats)
    assert tplan.meta["padding_rate"] == pytest.approx(jplan.meta["padding_rate"])
    assert tplan.meta["operator_history"] == jplan.meta["operator_history"]
    for tf, jf in zip(tplan.formats, jplan.formats):
        assert type(tf).__name__ == type(jf).__name__
        for f in ("c0", "cols", "lrow", "vals", "wnz", "wrow", "chunk_tile",
                  "slot_of_origrow", "row_of_slot"):
            if hasattr(jf, f):
                np.testing.assert_array_equal(getattr(tf, f).float().numpy(),
                                              np.asarray(getattr(jf, f), np.float32),
                                              err_msg=f)
    x = _x(400, 8, seed=22)
    want = spmm_reference(jmat, x.astype(np.float64))
    y = tplan(x).numpy()
    np.testing.assert_allclose(y, np.asarray(jplan(x)), rtol=0,
                               atol=(1e-2 if kw.get("precision") == "bf16" else 2e-3)
                               * np.abs(want).max())
    check_result(y, want, rtol=8e-2 if kw.get("precision") == "bf16" else 1e-5)
    assert tplan.cost_summary(8)["format_bytes"] == sum(f.memory_bytes for f in tplan.formats)


def test_brick_ell_gate_is_jax():
    # no column locality: the interleaved chunks need more than the TPU's
    # 4 MB of chunk blocks, and both packages refuse the schedule there
    tmat = tbuilder.uniform_coo(2048, 1 << 20, nnz_per_row=48, seed=3)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    sk = dict(family="brick_ell", sort=True, rb=1024, sublanes=256, g=512, ktile=8)
    with pytest.raises(RuntimeError, match="brick_ell chunk blocks"):
        jsched.build_plan(jmat, jsched.Schedule(**sk))
    with pytest.raises(tsched.CandidateRejected, match="brick_ell chunk blocks"):
        tsched.build_plan(tmat, tsched.Schedule(**sk), device="cpu", gates=TPU_GATES)


@pytest.mark.parametrize("k", [2, 4])
def test_spmm_default_takes_radix_span_like_jax(k):
    # 262144 columns at K = 2..4: dg's gate (kt 8) fails, radix's (kt = K
    # rounded up to a power of two) holds
    tmat = tbuilder.power_law_coo(64, 262144, avg_nnz_per_row=8.0, seed=5)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    sched = tsched.default_schedule(tmat, k, gates=TPU_GATES)
    assert sched.family == "radix_span" and sched.ktile == k
    assert sched.describe() == jsched.default_schedule(jmat, k).describe()
    x = _x(262144, k, seed=23)
    y = tpusparse_torch.spmm(tmat, x, device="cpu", gates=TPU_GATES)
    want = spmm_reference(jmat, x.astype(np.float64))
    assert y.shape == (64, k)
    np.testing.assert_allclose(y.numpy(), np.asarray(tpusparse.spmm(jmat, x)), rtol=0,
                               atol=2e-3 * np.abs(want).max())
    check_result(y.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("k", [1, 4, 8, 32, 256])
def test_default_candidates_equal_jax(k, full):
    # a skewed matrix (its longest row past 32x the mean) takes the segment
    # and bucketed rows too; with ``full`` every family of the JAX list
    tmat = tbuilder.power_law_coo(600, 800, avg_nnz_per_row=5.0, seed=24)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    jall = jtune.default_candidates(jmat, k, full=full)
    got = [s.describe() for s in ttune.default_candidates(tmat, k, full=full, gates=TPU_GATES)]
    assert got == [s.describe() for s in jall]
    fams = {s["family"] for s in got}
    assert ({"dense", "block_ell", "hybrid_cols"} <= fams) == full
    assert ("radix_span" in fams) == (k <= 128) and "stripe_total" in fams
    assert ("stripe_nested" in fams) == full and "nnz_segment" in fams
    for kt in (1, 2, 4, 8, 16, 32):
        assert ttune._radix_configs(tmat.density, kt) == jtune._radix_configs(jmat.density, kt)


def test_chip_smoke_tune_list_is_jax():
    # chip_smoke.py's P9 holds tune(config #1, K = 8) to the JAX package's 25
    # candidates through two constants, since the card machine has no jax
    import chip_smoke

    jmat = jbuilder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    jlist = jtune.default_candidates(jmat, 8)
    assert [s.family for s in jlist] == chip_smoke.TUNE_K8_FAMILIES
    assert chip_smoke.candidates_digest(s.describe() for s in jlist) == chip_smoke.TUNE_K8_DIGEST
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    assert chip_smoke.candidates_digest(
        s.describe() for s in ttune.default_candidates(tmat, 8, gates=TPU_GATES)) == \
        chip_smoke.TUNE_K8_DIGEST


def test_no_card_means_no_quiet_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    mat, x = _mat(), _x(400, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpusparse_torch.spmm(mat, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttune.tune(mat, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.build_plan(mat, tsched.default_schedule(mat, 8))


def _colskew(m=400, n=360, seed=3, alpha=1.4):
    return tbuilder.power_law_col_coo(m, n, avg_nnz_per_row=7.0, alpha=alpha, seed=seed)


DENSE_TILE_CASES = {
    "dense": (dict(family="dense", precision="bf16"), lambda: _mat(seed=25)),
    "block_ell": (dict(family="block_ell", precision="bf16", row_interval=128),
                  lambda: tbuilder.block_sparse_coo(384, 400, 128, 0.3, seed=2)),
    "hybrid_cols": (dict(family="hybrid_cols", hot_cols=128, unroll=4, ktile=8,
                         precision="bf16"), _colskew),
}


def _plans_match_jax(kw, tmat, k=8, bf16=None):
    """build_plan in both packages: the same meta and, within 1e-5 of
    |A|·|x|, the same Y (bf16 rounds the same inputs in both; the dg
    remainder's fp32x2 split on the JAX side within 2e-3), and the oracle."""
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    jkw = dict(kw)
    if "bucket_schedules" in kw:
        jkw["bucket_schedules"] = tuple(jsched.Schedule(**s.describe())
                                        for s in kw["bucket_schedules"])
    jplan = jsched.build_plan(jmat, jsched.Schedule(**jkw))
    tplan = tsched.build_plan(tmat, tsched.Schedule(**kw), device="cpu")
    for key in ("schedule", "n_subs", "operator_history", "hot_cols", "covered_nnz",
                "format_bytes"):
        assert tplan.meta.get(key) == jplan.meta.get(key), key
    assert tplan.meta["padding_rate"] == pytest.approx(jplan.meta["padding_rate"])
    x = _x(tmat.shape[1], k, seed=26)
    want = spmm_reference(jmat, x.astype(np.float64))
    scale = np.abs(tmat.to_dense(np.float64)) @ np.abs(x.astype(np.float64))
    y = tplan(x)
    assert y.dtype == torch.float32 and y.shape == (tmat.shape[0], k)
    y = y.numpy()
    sparse_rest = kw["family"] == "hybrid_cols" and tplan.meta["n_subs"] == 2
    assert np.abs(y - np.asarray(jplan(x))).max() <= \
        (2e-3 if sparse_rest else 1e-5) * scale.max()
    bf16 = kw.get("precision") == "bf16" if bf16 is None else bf16
    check_result(y, want, rtol=8e-2 if bf16 else 1e-5, scale=scale if bf16 else None)
    return tplan, jplan


@pytest.mark.parametrize("family", list(DENSE_TILE_CASES))
def test_dense_tile_family_matches_jax(family):
    kw, make = DENSE_TILE_CASES[family]
    tplan, _ = _plans_match_jax(kw, make())
    if family == "block_ell":  # counted by its format, as the sparse families
        assert tplan.cost_summary(8)["format_bytes"] == tplan.formats[0].memory_bytes
    else:                      # the dense A or the panel (and the remainder) in meta
        assert tplan.cost_summary(8)["format_bytes"] == tplan.meta["format_bytes"] > 0


@pytest.mark.parametrize("kw,make,k", [
    (dict(family="dense"), lambda: _mat(seed=25), 8),                         # fp32
    (dict(family="dense", precision="bf16"), lambda: _mat(seed=25), 256),
    (dict(family="block_ell", row_interval=64), lambda: tbuilder.block_sparse_coo(
        384, 400, 128, 0.3, seed=2), 8),
    (dict(family="block_ell", row_interval=256), lambda: tbuilder.block_sparse_coo(
        300, 450, 128, 0.2, seed=0), 24),
    (dict(family="block_ell", row_interval=100), lambda: _mat(seed=27), 8),  # bs 128
    (dict(family="hybrid_cols", hot_cols=256, ktile=8), _colskew, 8),
    (dict(family="hybrid_cols", hot_cols=128, ktile=1), _colskew, 1),
    (dict(family="hybrid_cols", hot_cols=4096, ktile=8), lambda: _colskew(n=200), 8),
    (dict(family="hybrid_cols", hot_cols=128, ktile=8, bucket_schedules=(
        tsched.Schedule(family="stripe_total", work_per_block=64),)), _colskew, 8),
])
def test_dense_tile_schedules_match_jax(kw, make, k):
    tplan, _ = _plans_match_jax(kw, make(), k=k)
    if kw.get("hot_cols") == 4096:
        assert tplan.meta["n_subs"] == 1 and tplan.formats == []


def test_dense_family_densifies_on_the_device_past_its_host_gate(monkeypatch):
    # past 256 MB of fp32 A is densified by an accumulating scatter on its
    # device; a small gate sends a small matrix down that branch
    tmat = _mat(seed=28)
    monkeypatch.setattr(tsched, "DENSE_HOST_BYTES", 0)
    for prec in ("fp32", "bf16"):
        _plans_match_jax(dict(family="dense", precision=prec), tmat)


@pytest.fixture(scope="module")
def headline():
    return tbuilder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)


@pytest.fixture(scope="module")
def colskew_headline():
    return tbuilder.power_law_col_coo(32768, 32768, 32, alpha=1.6, seed=9)


@pytest.mark.parametrize("k", [1, 8, 256])
@pytest.mark.parametrize("which", ["headline", "colskew_headline", "blocky"])
def test_default_candidates_equal_jax_with_dense_tile_rows(which, k, request):
    if which == "blocky":
        tmat = tbuilder.block_sparse_coo(1024, 1024, 128, 0.2, seed=6)
    else:
        tmat = request.getfixturevalue(which)
    jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
    jlist = [s.describe() for s in jtune.default_candidates(jmat, k)]
    got = [s.describe() for s in ttune.default_candidates(tmat, k, gates=TPU_GATES)]
    assert got == jlist
    fams = [s["family"] for s in got]
    assert ("dense" in fams) == (k == 256 or which == "blocky")
    assert ("block_ell" in fams) == (which == "blocky")
    assert ("hybrid_cols" in fams) == (which == "colskew_headline")
    if which == "colskew_headline":  # share of the top 128 columns past 0.6: ranked first
        assert fams[:2] == ["hybrid_cols"] * 2


def test_chip_smoke_dense_tile_lists_are_jax(headline, colskew_headline):
    # P4 (tune at the headline, K = 256) and P16 (tune on the column-skewed
    # headline, K = 8) hold their lists to digests of the JAX lists
    import chip_smoke

    for tmat, k, digest in ((headline, 256, chip_smoke.TUNE_K256_DIGEST),
                            (colskew_headline, 8, chip_smoke.TUNE_COLSKEW_K8_DIGEST)):
        jmat = tpusparse.CooMatrix(tmat.rows, tmat.cols, tmat.vals, tmat.shape)
        jlist = jtune.default_candidates(jmat, k)
        assert chip_smoke.candidates_digest(s.describe() for s in jlist) == digest
        assert chip_smoke.candidates_digest(
            s.describe() for s in ttune.default_candidates(tmat, k, gates=TPU_GATES)) == digest
