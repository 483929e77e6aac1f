"""tpusparse_torch.spmv against the JAX package's spmv, on the CPU.

Each method's y is held against the port's spmv_reference and the JAX
oracle (1e-5: the port computes in fp32), and one dgt8 and one
spmv_multi_fn call against the JAX functions (Pallas interpret mode) at
tests/test_dgt_kernel.py's atol 1e-4 * max|ref| for fp32x2.
"""

import numpy as np
import pytest
import torch

import tpusparse_torch
from tpusparse import spmv as jspmv
from tpusparse.io import builder as jbuilder
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.oracle import check_result, spmm_reference, spmv_reference
from tpusparse_torch import oracle as toracle
from tpusparse_torch import spmv as tspmv
from tpusparse_torch.gates import TPU_GATES
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.dg_gather import DgFormat
from tpusparse_torch.kernels.dgt_gather import DgtFormat
from tpusparse_torch.format import StripeFormat
from tpusparse_torch.kernels.radix_gather import RadixFormat
from tpusparse_torch.kernels.span_gather import SpanFormat


def _mats(m=300, n=400, avg=6.0, seed=12):
    jmat = jbuilder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    return jmat, CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)


@pytest.mark.parametrize("method,fmt_type", [("auto", DgFormat), ("dg", DgFormat),
                                             ("dgt8", DgtFormat), ("span", SpanFormat),
                                             ("radix", RadixFormat), ("stripe", StripeFormat),
                                             ("segment", None)])
def test_spmv_fn_matches_oracle(method, fmt_type):
    jmat, tmat = _mats()
    x = np.random.default_rng(2).standard_normal(400).astype(np.float32)
    fn = tspmv.spmv_fn(tmat, method, device="cpu")
    assert type(getattr(fn, "format", None)) is (fmt_type or type(None))
    y = fn(x)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu" and y.shape == (300,)
    want = spmv_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(toracle.spmv_reference(tmat, x.astype(np.float64)), want)
    check_result(y.numpy(), want, rtol=1e-5)
    check_result(fn(torch.from_numpy(x)).numpy(), want, rtol=1e-5)
    check_result(tspmv.spmv(tmat, x, method, device="cpu").numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("slotless_rows", [False, True])
def test_dealt_unpack_keeps_its_index(slotless_rows):
    # a dg format dealt by row length unpacks through slot_of_origrow: the
    # int64 index and the mask of the rows with a slot (None where all have
    # one) are made once and kept while the slots stand; a row without a
    # slot (a sub-format's rows of another) reads 0
    from tpusparse_torch.kernels.dg_gather import dg_spmv, pack_dg

    jmat, tmat = _mats(m=300, n=400, avg=6.0, seed=21)
    fmt = pack_dg(tmat, rb=64, ns=4, g=512, kt=1, mode="fp32x2", device="cpu")
    assert fmt.deal not in ("blocks", "index")
    x = np.random.default_rng(5).standard_normal(400).astype(np.float32)
    want = spmv_reference(jmat, x.astype(np.float64))
    check_result(dg_spmv(fmt, x).numpy(), want, rtol=1e-5)
    kept = fmt.unpack_index
    assert kept[3] is None
    check_result(dg_spmv(fmt, x).numpy(), want, rtol=1e-5)
    assert fmt.unpack_index is kept
    if slotless_rows:
        fmt.slot_of_origrow[::3] = -1  # written in place: made anew, with a mask
        want[::3] = 0.0
    else:
        fmt.slot_of_origrow.add_(0)    # written in place: made anew
    check_result(dg_spmv(fmt, x).numpy(), want, rtol=1e-5)
    assert fmt.unpack_index is not kept
    assert (fmt.unpack_index[3] is not None) == slotless_rows


def test_auto_takes_segment_past_the_size_gate():
    tmat = CooMatrix(np.array([0, 3]), np.array([5, 1_999_999]), np.array([2.0, -1.0]),
                     (4, 2_000_000))
    fn = tspmv.spmv_fn(tmat, "auto", device="cpu", gates=TPU_GATES)  # the JAX gate
    assert not hasattr(fn, "format")                    # segment: no kernel format
    x = np.zeros(2_000_000, np.float32)
    x[5], x[-1] = 3.0, 4.0
    np.testing.assert_array_equal(fn(x).numpy(), [6.0, 0.0, 0.0, -4.0])


def test_dgt8_matches_jax():
    jmat, tmat = _mats(seed=13)
    x = np.random.default_rng(3).standard_normal(400).astype(np.float32)
    yj = np.asarray(jspmv.spmv_fn(jmat, "dgt8")(x))
    yt = tspmv.spmv_fn(tmat, "dgt8", device="cpu")(x).numpy()
    ref = spmv_reference(jmat, x.astype(np.float64))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_span_matches_jax():
    # at the tuner's first span point (tpusparse/spmv.py:118-133); the JAX
    # package widens x to 8 columns, the port runs it as one
    from tpusparse.tune import _span_configs

    jmat, tmat = _mats(seed=16)
    x = np.random.default_rng(5).standard_normal(400).astype(np.float32)
    fn = tspmv.spmv_fn(tmat, "span", device="cpu")
    yj = np.asarray(jspmv.spmv_fn(jmat, "span")(x))
    ref = spmv_reference(jmat, x.astype(np.float64))
    assert (fn.format.rb, fn.format.ct, fn.format.chunk_g) == _span_configs(jmat.density)[0]
    np.testing.assert_allclose(fn(x).numpy(), yj, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_dgt8_runs_past_the_jax_width_gate():
    # the JAX package refuses N * 32 bytes past 9 MB (294,912 columns: its
    # VMEM residency for X); the port's walk stages no X, so the oracle is
    # the judge at 300,000 columns
    jmat = jbuilder.power_law_coo(512, 300_000, avg_nnz_per_row=8.0, seed=3)
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    with pytest.raises(AssertionError, match="VMEM"):
        jspmv.spmv_fn(jmat, "dgt8")
    x = np.random.default_rng(4).standard_normal(300_000).astype(np.float32)
    fn = tspmv.spmv_fn(tmat, "dgt8", device="cpu")
    assert isinstance(fn.format, DgtFormat) and fn.format.kt == 8
    y = fn(x)
    assert y.shape == (512,) and bool(torch.isfinite(y).all())
    check_result(y.numpy(), spmv_reference(jmat, x.astype(np.float64)), rtol=2e-3)


@pytest.mark.parametrize("seed", [16, 17])
def test_span_runs_x_as_one_column(seed, monkeypatch):
    # the span SpMV hands its plain version (on the card: the one-column
    # walk kernel, span_rows_cuda at kt = 1) x as one column, never widened
    # to the TPU's 8
    from tpusparse_torch.kernels import span_gather as tspan

    seen = []
    plain = tspan.span_rows_plain

    def spy(*args, **kw):
        seen.append((tuple(args[5].shape), kw["kt"]))
        return plain(*args, **kw)

    monkeypatch.setattr(tspan, "span_rows_plain", spy)
    jmat, tmat = _mats(seed=seed)
    x = np.random.default_rng(6).standard_normal(400).astype(np.float32)
    fn = tspmv.spmv_fn(tmat, "span", device="cpu")
    y = fn(x)
    assert seen == [((400, 1), 1)]
    assert y.shape == (300,)
    check_result(y.numpy(), spmv_reference(jmat, x.astype(np.float64)), rtol=2e-3)
    # the same Y as the span SpMM at K = 1 on the same format
    np.testing.assert_allclose(tspan.span_spmm(fn.format, x[:, None]).numpy()[:, 0], y.numpy(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("path", ["plan", "trainable", "stream"])
def test_span_spmm_takes_one_column_at_kt_1(path, monkeypatch):
    # every K = 1 span call walks x as one column (kt = 1, on the card the
    # one-column walk kernel), whatever K-tile its caller asks for: a span
    # Schedule's plan (ktile 8), spmm_trainable; the stream wrapper keeps
    # its kt of 8
    from tpusparse_torch.autodiff import spmm_trainable
    from tpusparse_torch.kernels import span_gather as tspan
    from tpusparse_torch.schedule import Schedule, build_plan

    seen = []
    name = "span_stream_rows_plain" if path == "stream" else "span_rows_plain"
    plain = getattr(tspan, name)

    def spy(*args, **kw):
        seen.append((tuple(args[5].shape), kw["kt"]))
        return plain(*args, **kw)

    monkeypatch.setattr(tspan, name, spy)
    jmat, tmat = _mats(seed=18)
    x = np.random.default_rng(7).standard_normal((400, 1)).astype(np.float32)
    want = spmm_reference(jmat, x.astype(np.float64))
    if path == "plan":
        plan = build_plan(tmat, Schedule(family="span_onehot", rb=64, ct=128, g=32, ktile=8),
                          device="cpu")
        y = plan(x)
    elif path == "trainable":
        fn, v0 = spmm_trainable(tmat, rb=64, ct=128, g=32, device="cpu")
        y = fn(v0, torch.from_numpy(x))
    else:
        fmt = tspan.pack_span(tmat, rb=64, ct=128, g=32, device="cpu")
        y = tspan.span_spmm(fmt, x, stream=True)
    assert seen == [((400, 8), 8)] if path == "stream" else seen == [((400, 1), 1)]
    assert tuple(y.shape) == (300, 1)
    check_result(y.detach().numpy(), want, rtol=2e-3)


@pytest.mark.parametrize("col_split", [None, 1, 2, 3])
def test_spmv_multi_fn_matches_oracle(col_split):
    jmat, tmat = _mats(seed=14)
    xs = np.random.default_rng(4).standard_normal((400, 5)).astype(np.float32)
    fn = tspmv.spmv_multi_fn(tmat, 5, col_split=col_split, device="cpu")
    assert fn.n_splits == (col_split or 1) and len(fn.formats) == fn.n_splits
    if col_split and col_split > 1:
        assert fn.n_splits == jspmv.spmv_multi_fn(jmat, 5, col_split=col_split).n_splits
    y = fn(xs)
    assert y.shape == (300, 5)
    check_result(y.numpy(), spmm_reference(jmat, xs.astype(np.float64)), rtol=1e-5)


def test_spmv_multi_fn_auto_split_equals_jax():
    # X of 600000 x 8 fp32 is 19.2 MB, past the 16 MB rule: 3 ranges of <= 8 MB
    rng = np.random.default_rng(5)
    rows = np.sort(rng.integers(0, 64, 500))
    cols = rng.integers(0, 600_000, 500)
    jmat = JCoo(rows, cols, rng.standard_normal(500), (64, 600_000)).sort_row_major()
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    fn = tspmv.spmv_multi_fn(tmat, 2, device="cpu", gates=TPU_GATES)  # the JAX rule
    assert fn.n_splits == jspmv.spmv_multi_fn(jmat, 2).n_splits == 3
    xs = rng.standard_normal((600_000, 2)).astype(np.float32)
    check_result(fn(xs).numpy(), spmm_reference(jmat, xs.astype(np.float64)), rtol=1e-5)


def test_spmv_multi_fn_matches_jax():
    jmat, tmat = _mats(seed=15)
    xs = np.random.default_rng(6).standard_normal((400, 8)).astype(np.float32)
    yj = np.asarray(jspmv.spmv_multi_fn(jmat, 8)(xs))
    yt = tspmv.spmv_multi_fn(tmat, 8, device="cpu")(xs).numpy()
    ref = spmm_reference(jmat, xs.astype(np.float64))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("method,item", [("radix", "A.7"), ("stripe", "A.7")])
def test_unported_methods_raise(method, item):
    # radix and stripe were unported until ROADMAP.md A.7; now only an
    # unknown method raises
    fn = tspmv.spmv_fn(_mats()[1], method, device="cpu")
    assert fn(np.ones(400, np.float32)).shape == (300,)
    with pytest.raises(ValueError, match="unknown"):
        tspmv.spmv_fn(_mats()[1], "bogus", device="cpu")


@pytest.mark.parametrize("method", ["radix", "stripe"])
def test_radix_and_stripe_match_jax(method):
    # radix: kt = 1, rb = 2048, S = 128, g = 1024; stripe: build_stripe_plan
    # (work 1024, unroll 8) on x widened to 8 columns (tpusparse/spmv.py:85-116)
    jmat, tmat = _mats(seed=17)
    x = np.random.default_rng(7).standard_normal(400).astype(np.float32)
    fn = tspmv.spmv_fn(tmat, method, device="cpu")
    ref = spmv_reference(jmat, x.astype(np.float64))
    if method == "radix":
        assert (fn.format.rb, fn.format.S, fn.format.chunk_g, fn.format.kt) == (2048, 128, 1024, 1)
    else:
        assert fn.format.stripe_nnz % 8 == 0
    np.testing.assert_allclose(fn(x).numpy(), np.asarray(jspmv.spmv_fn(jmat, method)(x)), rtol=0,
                               atol=2e-3 * np.abs(ref).max())


def test_lazy_export_and_no_quiet_cpu_run():
    assert tpusparse_torch.__getattr__("spmv") is tspmv.spmv
    tmat = _mats()[1]
    fn = tspmv.spmv_fn(tmat, "segment", device="cpu")
    with pytest.raises(ValueError, match="x is on"):
        fn(torch.zeros(400, device="meta"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmv.spmv(tmat, np.zeros(400, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmv.spmv_multi_fn(tmat, 8)
