"""The card's schedule gates (``tpusparse_torch.gates.CARD_GATES``) on the
CPU, beside the TPU's (``TPU_GATES``, which the JAX-equality tests of
test_torch_slice.py, test_torch_spmv.py and test_torch_graph.py hold to
the JAX package): the default schedule at the shapes where the two part,
spmm past the TPU's X gates, the SpMV and graph plans past 1,572,864
columns, brick_ell past its 4 MB refusal and up to the row walk's int32
index, the ``block_ell`` plan's method, what the tuner's padding bound
counts, the tile rule, and config #1, where both records take the same
decisions.  Y against the
JAX package's oracle at the tuner's tolerance (fp32x2 2e-3, bf16 1e-2 of
|A|·|x|, fp32 1e-5).
"""

import numpy as np
import pytest
import torch

import tpusparse
import tpusparse_torch
from tpusparse import schedule as jsched
from tpusparse.oracle import check_result, spmm_reference
from tpusparse_torch import gates as tgates
from tpusparse_torch import graph as tg
from tpusparse_torch import schedule as tsched
from tpusparse_torch import spmv as tspmv
from tpusparse_torch import tune as ttune
from tpusparse_torch.config import config_override
from tpusparse_torch.gates import CARD_GATES, TPU_GATES
from tpusparse_torch.io import builder
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels import block_ell as be
from tpusparse_torch.kernels import row_walk as rw
from tpusparse_torch.kernels import tile_onehot as ttile
from tpusparse_torch.kernels.dg_gather import DgFormat, choose_kt_dg, dg_geometry
from tpusparse_torch.nn import SparseLinear


def _jax(mat):
    return tpusparse.CooMatrix(mat.rows, mat.cols, mat.vals, mat.shape)


def _one_nonzero(n):
    return CooMatrix(np.array([0]), np.array([0]), np.array([1.0]), (10, n))


@pytest.fixture(scope="module")
def headline():
    return builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)


# (N, K, the TPU's decision: family and column ranges): the shapes of
# ogbn-arxiv, the SpMV workload, web-Google and wiki-Talk, 65536 and
# config #1's width
@pytest.mark.parametrize("n,k,tpu_family,tpu_split", [
    (169343, 128, "span_colsplit", 21), (169343, 16, "span_colsplit", 3),
    (169343, 64, "span_colsplit", 11), (262144, 8, "span_colsplit", 2),
    (262144, 32, "span_colsplit", 8), (262144, 64, "span_colsplit", 16),
    (916428, 8, "span_colsplit", 7), (2394385, 1, "span_colsplit", 3),
    (65536, 64, "span_colsplit", 4), (916428, 4, "span_colsplit", 4),
    (32768, 8, "dg_span", 0), (32768, 64, "dg_span", 0),
])
def test_card_default_takes_dg_where_the_tpu_splits_x(n, k, tpu_family, tpu_split):
    mat = _one_nonzero(n)
    tpu = tsched.default_schedule(mat, k, gates=TPU_GATES)
    assert tpu.describe() == jsched.default_schedule(_jax(mat), k).describe()
    assert (tpu.family, tpu.col_split) == (tpu_family, tpu_split)
    card = tsched.default_schedule(mat, k)
    kt = choose_kt_dg(min(k, 32))
    assert (card.family, card.ktile, card.col_split) == ("dg_span", kt, 0)
    # one nonzero: every default window would pad its chunk, so the card's
    # window spans X
    assert card.ns == -(-n // dg_geometry(kt, "fp32x2")[0])


@pytest.mark.parametrize("n,k", [(262144, 4), (262144, 2), (600000, 2), (32768, 4)])
def test_card_keeps_the_tpu_decision_at_k_2_to_4(n, k):
    # where the TPU's tree takes radix_span at K = 2-4 (dg's X at kt 8 past
    # 6 MB, radix's at kt 2 or 4 within it) the card measures it faster
    # than dg, and takes it too; where it takes dg (config #1's width), dg
    mat = _one_nonzero(n)
    tpu = tsched.default_schedule(mat, k, gates=TPU_GATES)
    card = tsched.default_schedule(mat, k)
    assert tpu.family == ("dg_span" if n == 32768 else "radix_span")
    assert card.family == tpu.family and card.ktile == tpu.ktile


@pytest.mark.parametrize("k", [1, 8, 64])
def test_config1_default_and_tune_list_are_the_same_on_both_records(headline, k):
    assert tsched.default_schedule(headline, k) == tsched.default_schedule(
        headline, k, gates=TPU_GATES)
    if k == 8:
        import chip_smoke

        card = [s.describe() for s in ttune.default_candidates(headline, 8)]
        assert chip_smoke.candidates_digest(card) == chip_smoke.TUNE_K8_DIGEST
        assert [s["family"] for s in card] == chip_smoke.TUNE_K8_FAMILIES


def test_smoke_dense_tile_lists_are_the_same_on_both_records(headline):
    # P4 (the headline at K = 256) and P16 (the column-skewed headline at
    # K = 8) tune the card's list; no gate binds at 32768 columns
    import chip_smoke

    colskew = builder.power_law_col_coo(32768, 32768, 32, alpha=1.6, seed=9)
    for mat, k, digest in ((headline, 256, chip_smoke.TUNE_K256_DIGEST),
                           (colskew, 8, chip_smoke.TUNE_COLSKEW_K8_DIGEST)):
        assert chip_smoke.candidates_digest(
            s.describe() for s in ttune.default_candidates(mat, k)) == digest


def test_card_window_keeps_the_padding_within_the_bound():
    # the SpMV workload's density at 8192 rows: dg's default windows at K =
    # 64 (kt 32, rb 512, W 1024) would pad about 6.5x; the card's span X
    mat = builder.power_law_coo(8192, 262144, avg_nnz_per_row=40.0, seed=9)
    tpu = tsched.build_plan(mat, tsched.default_schedule(mat, 64, gates=TPU_GATES),
                            device="cpu", gates=TPU_GATES)
    sched = tsched.default_schedule(mat, 64)
    assert sched.family == "dg_span" and sched.ns == 262144 // 128
    card = tsched.build_plan(mat, sched, device="cpu")
    assert tpu.meta["schedule"]["family"] == "span_colsplit"
    assert card.formats[0].padding_rate <= get_bound() < tpu.meta["padding_rate"]
    x = np.random.default_rng(1).standard_normal((262144, 64)).astype(np.float32)
    check_result(card(x).numpy(), spmm_reference(_jax(mat), x.astype(np.float64)), rtol=2e-3)


def get_bound():
    return tpusparse_torch.get_config().padding_rate_up_bound


def test_spmm_wide_and_short_through_the_card_default():
    # 64 x 262,144 at K = 8: X of 8 MB passes every TPU gate (two span
    # ranges there); the card's default is one dg format
    mat = builder.power_law_coo(64, 262144, avg_nnz_per_row=8.0, seed=5)
    assert tsched.default_schedule(mat, 8).family == "dg_span"
    x = np.random.default_rng(23).standard_normal((262144, 8)).astype(np.float32)
    y = tpusparse_torch.spmm(mat, x, device="cpu")
    want = spmm_reference(_jax(mat), x.astype(np.float64))
    assert isinstance(y, torch.Tensor) and y.shape == (64, 8)
    check_result(y.numpy(), want, rtol=2e-3)
    ytpu = tpusparse_torch.spmm(mat, x, device="cpu", gates=TPU_GATES)
    check_result(ytpu.numpy(), want, rtol=2e-3)


@pytest.fixture(scope="module")
def past_dg_gate():
    # 1.6M columns: x of 6.4 MB, past the JAX package's 6 MB dg gate
    return builder.uniform_coo(500, 1_600_000, nnz_per_row=40, seed=2)


def test_spmv_auto_takes_dg_past_the_tpu_gate(past_dg_gate):
    mat = past_dg_gate
    x = np.random.default_rng(0).standard_normal(1_600_000).astype(np.float32)
    want = spmm_reference(_jax(mat), x.astype(np.float64))
    fn = tspmv.spmv_fn(mat, "auto", device="cpu")
    assert isinstance(fn.format, DgFormat)
    check_result(fn(x).numpy(), want, rtol=2e-3)
    assert not hasattr(tspmv.spmv_fn(mat, "auto", device="cpu", gates=TPU_GATES), "format")
    # the card's rule has no size in it: wiki-Talk's density at 2.4M
    # columns takes dg too
    few = builder.power_law_coo(40, 2_394_385, avg_nnz_per_row=2.54, seed=6)
    assert isinstance(tspmv.spmv_fn(few, "auto", device="cpu").format, DgFormat)
    assert tspmv.takes_dg(10**9) and not tspmv.takes_dg(1_572_865, TPU_GATES)


@pytest.mark.parametrize("semiring", ["plus_times", "or_and"])
def test_matvec_plan_takes_dg_past_the_tpu_gate(past_dg_gate, semiring):
    mat = past_dg_gate
    fn = tg.matvec_plan(mat, semiring=semiring, device="cpu")
    assert fn.meta["method"] == "dg" and isinstance(fn.format, DgFormat)
    assert tg.matvec_plan(mat, semiring=semiring, device="cpu",
                          gates=TPU_GATES).meta["method"] == "segment"
    x = np.abs(np.random.default_rng(0).standard_normal(1_600_000)).astype(np.float32)
    if semiring == "or_and":
        x = (x > 1.0).astype(np.float32)
        want = (spmm_reference(_jax(CooMatrix(mat.rows, mat.cols, np.ones(mat.nnz), mat.shape)),
                               x.astype(np.float64)) > 0).astype(np.float32)
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)
    else:
        check_result(fn(torch.from_numpy(x)).numpy(),
                     spmm_reference(_jax(mat), x.astype(np.float64)), rtol=2e-3)


def test_spmv_multi_keeps_one_format_on_the_card():
    # X of 600000 x 8 fp32 (19.2 MB): the TPU's rule splits it in three
    rng = np.random.default_rng(5)
    rows = np.sort(rng.integers(0, 64, 500))
    mat = CooMatrix(rows, rng.integers(0, 600_000, 500), rng.standard_normal(500),
                    (64, 600_000)).sort_row_major()
    card = tspmv.spmv_multi_fn(mat, 2, device="cpu")
    assert card.n_splits == 1
    assert tspmv.spmv_multi_fn(mat, 2, device="cpu", gates=TPU_GATES).n_splits == 3
    xs = rng.standard_normal((600_000, 2)).astype(np.float32)
    check_result(card(xs).numpy(), spmm_reference(_jax(mat), xs.astype(np.float64)), rtol=1e-5)


BRICK = dict(family="brick_ell", sort=True, rb=1024, sublanes=256, g=512, ktile=8)


def test_brick_ell_runs_past_the_tpu_block_gate():
    # two nonzeros a row over a million columns: the interleaved chunks
    # take more than the TPU's 4 MB of chunk blocks, so the JAX package
    # refuses the schedule; the card's walk (#9) reads the live slots only
    mat = builder.uniform_coo(1024, 1 << 20, nnz_per_row=2, seed=3)
    jmat = _jax(mat)
    with pytest.raises(RuntimeError, match="brick_ell chunk blocks"):
        jsched.build_plan(jmat, jsched.Schedule(**BRICK))
    with pytest.raises(tsched.CandidateRejected, match="brick_ell chunk blocks"):
        tsched.build_plan(mat, tsched.Schedule(**BRICK), device="cpu", gates=TPU_GATES)
    plan = tsched.build_plan(mat, tsched.Schedule(**BRICK), device="cpu")
    fmt = plan.formats[0]
    assert fmt.n_chunks * fmt.chunk_g * 12 > 4 * 2**20
    x = np.random.default_rng(7).standard_normal((1 << 20, 8)).astype(np.float32)
    check_result(plan(x).numpy(), spmm_reference(jmat, x.astype(np.float64)), rtol=2e-3)


@pytest.mark.parametrize("gates", [CARD_GATES, TPU_GATES], ids=["card", "tpu"])
def test_brick_ell_refused_past_the_walk_index(gates, monkeypatch):
    # the card's own limit, on both records: planes the row walk could not
    # index are refused before they are allocated (off the card the limit
    # is the walk's int32 index alone)
    assert tsched.brick_slot_limit(torch.device("cpu")) == rw.WALK_SLOT_LIMIT
    mat = builder.uniform_coo(1024, 1 << 20, nnz_per_row=2, seed=3)
    monkeypatch.setattr(tsched, "WALK_SLOT_LIMIT", 100_000)
    with pytest.raises(tsched.CandidateRejected, match="brick_ell planes of"):
        tsched.build_plan(mat, tsched.Schedule(**BRICK), device="cpu", gates=gates)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_block_ell_plan_runs_the_kernel_on_the_card_record(precision, monkeypatch):
    mat = builder.block_sparse_coo(512, 512, 128, 0.3, seed=6)
    calls = []
    plain, batched = be.bell_rows_plain, be.bell_batched
    monkeypatch.setattr(be, "bell_rows_plain",
                        lambda *a, **k: calls.append("kernel") or plain(*a, **k))
    monkeypatch.setattr(be, "bell_batched",
                        lambda *a, **k: calls.append("xla") or batched(*a, **k))
    x = np.random.default_rng(3).standard_normal((512, 64)).astype(np.float32)
    want = spmm_reference(_jax(mat), x.astype(np.float64))
    scale = spmm_reference(_jax(CooMatrix(mat.rows, mat.cols, np.abs(mat.vals), mat.shape)),
                           np.abs(x).astype(np.float64))
    tol = dict(rtol=1e-2 if precision == "bf16" else 1e-5, scale=scale)
    sched = tsched.Schedule(family="block_ell", precision=precision, row_interval=128)
    for gates, route in ((CARD_GATES, "kernel"), (TPU_GATES, "xla")):
        calls.clear()
        y = tsched.build_plan(mat, sched, device="cpu", gates=gates)(x)
        assert calls == [route]
        check_result(y.numpy(), want, **tol)
    calls.clear()
    layer = SparseLinear.from_block(mat, precision=precision, device="cpu")
    check_result(layer(torch.from_numpy(x.T.copy())).detach().numpy().T, want, **tol)
    fmt = be.pack_block_ell(mat, bs=128, dtype=torch.bfloat16 if precision == "bf16"
                            else torch.float32, device="cpu")
    check_result(be.block_ell_spmm(fmt, x, precision=precision).numpy(), want, **tol)
    check_result(be.block_ell_spmm(fmt, x, precision=precision, method="xla").numpy(), want,
                 **tol)
    assert calls == ["kernel", "kernel", "xla"]


def test_padding_bound_counts_slots_read_on_the_card():
    # a bound of 1.01 refuses every padded plan by its planes; the card's
    # record weighs what the stripe and dg kernels read (the live slots)
    mat = builder.power_law_coo(600, 800, avg_nnz_per_row=5.0, seed=24)
    x = np.random.default_rng(2).standard_normal((800, 8)).astype(np.float32)
    cands = [tsched.Schedule(family="stripe_total", work_per_block=512, unroll=8),
             tsched.Schedule(family="dg_span", rb=512, ns=4, g=512, ktile=8),
             tsched.Schedule(family="tile_onehot", rb=512, ct=512, g=256)]
    with config_override(padding_rate_up_bound=1.01):
        with pytest.raises(RuntimeError, match="no schedule candidate succeeded") as refused:
            ttune.tune(mat, x, candidates=cands, use_cache=False, device="cpu",
                       gates=TPU_GATES, results_path=_results(), iters=1)
        res = ttune.tune(mat, x, candidates=cands, use_cache=False, device="cpu",
                         results_path=_results(), iters=1)
    assert str(refused.value).count("exceeds bound") == 3
    card = {r["schedule"]["family"]: r for r in res.table}
    for fam in ("stripe_total", "dg_span"):
        assert card[fam]["ok"] and card[fam]["read_rate"] == 1.0
        assert card[fam]["padding_rate"] > 1.01
    assert not card["tile_onehot"]["ok"] and "exceeds bound" in card["tile_onehot"]["error"]
    fmt = tsched.build_plan(mat, cands[1], device="cpu").formats[0]
    # the card's row counts the row walk, 16 B a live slot, beside the planes
    assert card["dg_span"]["format_bytes"] == fmt.memory_bytes + 16 * mat.nnz


def _results():
    import os
    import tempfile

    return os.path.join(tempfile.mkdtemp(prefix="gates_"), "results.jsonl")


@pytest.mark.parametrize("stream", [False, True])
def test_tile_rule_changes_no_product(stream, monkeypatch):
    # the tile rule (the JAX package's, ``uses_stream``) only names the
    # wrapper: either way the same Y
    mat = builder.power_law_coo(700, 900, avg_nnz_per_row=6.0, seed=8)
    x = np.random.default_rng(4).standard_normal((900, 16)).astype(np.float32)
    plan = tsched.build_plan(mat, tsched.Schedule(family="tile_onehot", rb=512, ct=512, g=256),
                             device="cpu")
    want = plan(x).numpy()
    monkeypatch.setattr(ttile, "uses_stream", lambda *a, **k: stream)
    np.testing.assert_allclose(plan(x).numpy(), want, rtol=1e-6, atol=1e-6)
    check_result(want, spmm_reference(_jax(mat), x.astype(np.float64)), rtol=2e-3)


def test_walk_index_refuses_a_plane_past_int32(monkeypatch):
    # the walk indexes the value plane with int32, its last block reading
    # two blocks past the end: the limit the brick_ell packer and the walk
    # share
    assert rw.WALK_SLOT_LIMIT == 2 ** 31 - 2 * max(rw.WALK_BLOCK_SLOTS.values())
    mat = builder.power_law_coo(300, 400, avg_nnz_per_row=4.0, seed=3)
    fmt = tsched.build_plan(mat, tsched.default_schedule(mat, 8), device="cpu").formats[0]
    monkeypatch.setattr(rw, "WALK_SLOT_LIMIT", fmt.vals.numel())
    with pytest.raises(ValueError, match="int32"):
        rw.window_row_walk(fmt)


def test_dg_window_rule_in_numbers():
    # config #1 at K = 8 (kt 8: rb 1024, W 1024, g 512): about 977
    # nonzeros a window, kept; the SpMV workload at K = 64 (kt 32: rb 512):
    # about 80, past the bound, widened; the TPU's record never widens
    nnz = 1_000_982
    assert tgates.dg_ns(nnz, 32768, 32768, rb=1024, ns=8, g=512, wt=128, gates=CARD_GATES) == 8
    assert tgates.dg_ns(10_228_408, 262144, 262144, rb=512, ns=8, g=512, wt=128,
                        gates=CARD_GATES) == 2048
    assert tgates.dg_ns(10_228_408, 262144, 262144, rb=512, ns=8, g=512, wt=128,
                        gates=TPU_GATES) == 8
