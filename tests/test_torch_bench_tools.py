"""The port's bench tools on the CPU: the three library yardsticks against
the JAX package's oracle, the probe's plausibility guard (the cases of
tests/test_probe_guard.py, at the H100's bounds) and its session probe,
the speed-of-light table's CSR floor and bound axes, the report's tables,
the suite's section tags and the zoo's cases."""

import json

import numpy as np
import pytest
import torch

from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.oracle import check_result as jcheck
from tpusparse.oracle import spmm_reference as jref
from tpusparse_torch.bench import baselines, microbench as mb, report, sol, suite, zoo
from tpusparse_torch.io import builder


@pytest.fixture(scope="module")
def mat300():
    return builder.power_law_coo(300, 200, avg_nnz_per_row=7.0, seed=13)


@pytest.mark.parametrize("make", ["dense_spmm_fn", "csr_spmm_fn", "segment_spmm_fn"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_baselines_match_the_oracle(mat300, make, as_tensor):
    x = np.random.default_rng(5).standard_normal((200, 16)).astype(np.float32)
    fn = getattr(baselines, make)(mat300, device="cpu")
    y = fn(torch.from_numpy(x) if as_tensor else x)
    assert y.dtype == torch.float32 and y.shape == (300, 16) and y.device.type == "cpu"
    want = jref(JCoo(mat300.rows, mat300.cols, mat300.vals, mat300.shape), x.astype(np.float64))
    jcheck(y.numpy(), want, rtol=1e-5)


def test_dense_baseline_bf16_and_tf32_restored(mat300):
    x = np.random.default_rng(6).standard_normal((200, 8)).astype(np.float32)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        y = baselines.dense_spmm_fn(mat300, device="cpu")(x)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    want = jref(JCoo(mat300.rows, mat300.cols, mat300.vals, mat300.shape), x.astype(np.float64))
    jcheck(y.numpy(), want, rtol=1e-5)
    yb = baselines.dense_spmm_fn(mat300, torch.bfloat16, device="cpu")(x)
    assert yb.dtype == torch.float32
    jcheck(yb.numpy(), want, rtol=5e-2)
    with pytest.raises(ValueError):
        baselines.dense_spmm_fn(mat300, torch.float16, device="cpu")


def test_baselines_want_a_card_by_default(mat300):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (baselines.dense_spmm_fn, baselines.csr_spmm_fn, baselines.segment_spmm_fn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(mat300)


def _meas_seq(values, calls=None):
    it = iter(values)

    def measure():
        if calls is not None:
            calls.append(1)
        return {"tflops": next(it)}

    return measure


GUARD_CASES = {
    # first reading in bounds: taken as it is, no remeasure
    "in_bounds": ([900.0], 900.0, False),
    # a first reading above the peak (1500 > 989) is dropped before the
    # median of the three: med(910, 890)
    "remeasure_median": ([1500.0, 910.0, 890.0], 900.0, False),
    # two readings above the peak and one sane: the sane one wins
    "filters_above_peak": ([1200.0, 1300.0, 800.0], 800.0, False),
    # readings below the lower bound are kept, and all-low stays implausible
    "keeps_low": ([100.0, 120.0, 110.0], 110.0, True),
    "persistent": ([1500.0, 1600.0, 1400.0], 1500.0, True),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guarded(case):
    values, want, implausible = GUARD_CASES[case]
    calls = []
    val, info = mb._guarded("mxu_tflops", _meas_seq(values, calls), lambda r: r["tflops"])
    assert val == pytest.approx(want)
    assert bool(info.get("implausible")) is implausible
    assert len(calls) == len(values) <= mb.MAX_READS
    if len(values) > 1:
        assert info["violation"]["first"] == values[0]
        assert info["violation"]["bounds"] == [300.0, 989.0]
    else:
        assert "violation" not in info


def test_guarded_ends_when_the_remeasure_raises():
    calls = []

    def measure():
        calls.append(1)
        if len(calls) == 1:
            return {"tflops": 1500.0}
        raise RuntimeError("the card went away")

    val, info = mb._guarded("mxu_tflops", measure, lambda r: r["tflops"])
    # one reading and two failed remeasures: three calls, and the median is
    # the implausible first reading
    assert len(calls) == mb.MAX_READS == 3
    assert val == 1500.0 and info.get("implausible") is True
    assert info["violation"]["readings"] == [1500.0]


def test_session_probe_guard_integration(monkeypatch):
    """A wild bf16 reading is read again and its median normed; an fp32 axis
    that stays above its peak gets no norm and is flagged."""
    monkeypatch.setattr(mb, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "a test card")
    monkeypatch.setattr(mb, "measure_hbm",
                        lambda device: {"stream_gbs": 3000.0, "reduce_gbs": 2900.0})
    bf16 = iter([2000.0, 700.0, 720.0])

    def measure_mxu(precision="bf16", device=None):
        return {"tflops": next(bf16) if precision == "bf16" else 90.0}

    monkeypatch.setattr(mb, "measure_mxu", measure_mxu)
    monkeypatch.setattr(mb, "REF_WINDOW",
                        {"stream_gbs": 2850.0, "mxu_tflops": 650.0, "fp32_tflops": 50.0})
    probe = mb.session_probe()
    assert probe["device"] == "a test card"
    assert probe["stream_gbs"] == 3000.0 and probe["reduce_gbs"] == 2900.0
    assert probe["norm_stream"] == pytest.approx(2850.0 / 3000.0)
    assert probe["mxu_tflops"] == 710.0
    assert probe["norm"] == pytest.approx(650.0 / 710.0)
    assert probe["norm_fp32"] is None and probe["implausible"] == ["fp32_tflops"]
    assert set(probe["violations"]) == {"mxu_tflops", "fp32_tflops"}


def test_probe_on_the_cpu():
    assert mb.session_probe(device="cpu") == {"metric": "session_probe", "backend": "cpu"}
    assert mb.roofline_bandwidth_gbs(device="cpu") == 0.0
    with pytest.raises(RuntimeError):
        mb.measure_hbm(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mb.session_probe()


def _fake_card(monkeypatch, stream_readings):
    """The probe's module on a card that reads ``stream_readings`` in turn."""
    monkeypatch.setattr(mb, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "a test card")
    it = iter(stream_readings)
    monkeypatch.setattr(mb, "measure_hbm",
                        lambda device: {"stream_gbs": next(it), "reduce_gbs": 2900.0})


def test_roofline_caches_only_a_reading_in_bounds(tmp_path, monkeypatch):
    from tpusparse_torch.config import config_override

    with config_override(cache_dir=str(tmp_path)):
        # three reads above the published peak: flagged, returned, not cached
        _fake_card(monkeypatch, [5000.0, 5100.0, 5200.0, 3000.0])
        assert mb.roofline_bandwidth_gbs() == 5100.0  # the median of the three
        assert not (tmp_path / "microbench.json").exists()
        # the next call measures anew and caches the sane reading
        assert mb.roofline_bandwidth_gbs() == 3000.0
        _fake_card(monkeypatch, [])  # a cached reading needs no measure
        assert mb.roofline_bandwidth_gbs() == 3000.0


@pytest.mark.parametrize("stream, cached", [(3000.0, True), (5000.0, False)])
def test_microbench_main_never_caches_a_flagged_stream(tmp_path, monkeypatch, capsys,
                                                       stream, cached):
    from tpusparse_torch.config import config_override

    probe = {"metric": "session_probe", "device": "a test card", "stream_gbs": stream}
    if not cached:
        probe["implausible"] = ["stream_gbs"]
    monkeypatch.setattr(mb, "session_probe", lambda: dict(probe))
    monkeypatch.setattr(mb, "measure_family_costs", lambda quick: [])
    with config_override(cache_dir=str(tmp_path)):
        mb.main(["--out", str(tmp_path / "mb.jsonl")])
    assert (tmp_path / "microbench.json").exists() is cached
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["rows"] == 1


def test_not_ok_kinds():
    table = [
        {"schedule": {"family": "dg_span"}, "ok": True},
        {"schedule": {"family": "dgt_span"}, "ok": False,
         "error": "CandidateRejected: padding rate 4.93 exceeds bound"},
        {"schedule": {"family": "radix_span"}, "ok": False,
         "error": "AssertionError: result: 3/64 elements exceed rtol 0.002; worst rel err"},
        {"schedule": {"family": "span"}, "ok": False, "error": "AssertionError: kt=3 not in"},
        {"schedule": {"family": "tile_onehot"}, "same_plan_as": {}, "ok": True},
    ]
    assert [(r["family"], r["kind"]) for r in suite.not_ok(table)] == [
        ("dgt_span", "refused"), ("radix_span", "oracle"), ("span", "precondition")]

    class Res:
        pass

    res = Res()
    res.table = table
    fields = suite.tune_fields(res)
    assert (fields["n_ok"], fields["n_cand"], len(fields["not_ok"])) == (2, 5, 3)


def test_report_not_ok_table(tmp_path):
    s, z = tmp_path / "s.jsonl", tmp_path / "z.jsonl"
    _write(s, [
        {"bench": "suite/powerlaw", "k": 8, "gflops": 1.0, "schedule": "dg_span", "ts": 1,
         "not_ok": [{"family": "dgt_span", "kind": "refused", "error": "a | b"}]},
        {"bench": "layout_h2h/powerlaw/brick_ell", "k": 8, "rejected": "VMEM", "ts": 2},
        # a later row for a cell supersedes its earlier failure
        {"bench": "graph_bfs", "error": "RuntimeError: x", "ts": 3},
        {"bench": "graph_bfs", "seconds": 1.0, "ts": 4},
    ])
    _write(z, [{"case": "wide", "k": 64, "schedule": "dgt_span", "ts": 1, "not_ok": [
        {"family": "radix_span", "kind": "oracle", "error": "AssertionError: r"}]}])
    assert report.not_ok_table(str(s), str(z)).splitlines()[2:] == [
        "| suite | layout_h2h/powerlaw/brick_ell | 8 | — | rejected | VMEM |",
        "| suite | suite/powerlaw | 8 | dgt_span | refused | a / b |",
        "| zoo | wide | 64 | radix_span | oracle | AssertionError: r |"]


def test_probe_bounds_are_the_published_peaks():
    assert mb.PROBE_BOUNDS["stream_gbs"][1] * 1e9 == sol.HBM_BYTES_PER_S
    assert mb.PROBE_BOUNDS["mxu_tflops"][1] * 1e12 == sol.BF16_TC_FLOPS_PER_S
    assert mb.PROBE_BOUNDS["fp32_tflops"][1] * 1e12 == sol.FP32_FLOPS_PER_S
    for name, (lo, hi) in mb.PROBE_BOUNDS.items():
        assert 0 < lo < hi
        assert lo <= mb.REF_WINDOW[name] <= hi, name


@pytest.mark.parametrize("nnz,m,n,k", [(1_048_576, 32768, 32768, 8), (10_485_760, 262144,
                                        262144, 1), (7, 3, 5, 512), (0, 10, 10, 8)])
def test_csr_floor_is_the_smoke_bound(nnz, m, n, k):
    # the bound chip_smoke.py's kernels line has used: A's CSR bytes, X and Y
    # once over 3.35 TB/s, against 2 nnz K flops at 67 TFLOP/s
    t_bytes = (nnz * 8 + (m + 1) * 4 + n * k * 4 + m * k * 4) / 3.35e12
    t_ops = 2.0 * nnz * k / 67e12
    want = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    assert sol.csr_bound_ms(nnz, m, n, k) == want
    s = sol.MatrixStats(nnz, m, n, 0)
    assert sol.floor_ms(sol.FAMILIES["csr"](s, k)) == want


def test_floor_reads_the_probe():
    c = sol.Cost(bytes=3.0e9, ops=1.0e11, precision="bf16")
    assert sol.floor_ms(c) == (pytest.approx(3.0e9 / 3.35e12 * 1e3), "bytes")
    assert sol.floor_ms(c, stream_gbs=3000.0, bf16_tflops=50.0) == (
        pytest.approx(1.0e11 / 50e12 * 1e3), "operations")


def test_bound_axis_agrees_with_the_table():
    """BOUND_AXIS holds what the floors say at the suite's shapes: every
    family bound by its bytes."""
    c1 = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    rows = sol.table(c1, 8)
    assert {r["family"] for r in rows} == set(sol.FAMILIES)
    assert all(r["bound_by"] == "bytes" for r in rows if r["family"] != "nm")
    nm = sol.MatrixStats(4096 * 2048, 4096, 4096, 0)
    bell = sol.MatrixStats.of(builder.block_sparse_coo(4096, 4096, block=128,
                                                       block_density=0.15, seed=6))
    dense = sol.MatrixStats(c1.nnz, 32768, 32768, 0)
    for fam, s, k in (("nm", nm, 128), ("block_ell", bell, 256), ("dense", dense, 256)):
        assert sol.floor_ms(sol.FAMILIES[fam](s, k))[1] == "bytes", fam
    assert set(sol.BOUND_AXIS.values()) == {"stream"}
    assert sol.bound_axis_for("dg_span") == "stream"
    assert sol.bound_axis_for("nm_2_4_batched") == "stream"
    assert sol.bound_axis_for("unknown_family x=1") == "stream"
    for fam in sol.FLOOR_OF:
        assert fam.split("_")[0] in sol.BOUND_AXIS, fam


def test_table_measured_column():
    m = builder.power_law_coo(2048, 2048, avg_nnz_per_row=8.0, seed=1)
    rows = {r["family"]: r for r in sol.table(m, 8, measured={"walk": 0.5})}
    w = rows["walk"]
    assert w["measured_ns_per_nz"] == 0.5
    assert w["measured_over_floor"] == pytest.approx(0.5 / w["floor_ns_per_nz"])
    assert rows["csr"]["measured_over_floor"] is None
    assert w["bytes"] == m.nnz * 16 + m.nnz * 8 * 4 + 2048 * 8 * 4


def test_sol_main_reads_microbench_rows(tmp_path, capsys):
    path = tmp_path / "mb.jsonl"
    rows = [{"metric": "session_probe", "stream_gbs": 3000.0, "mxu_tflops": 700.0,
             "fp32_tflops": 50.0},
            {"metric": "family_cost", "family": "dg_span", "k": 8, "ns_per_nz": 0.04},
            {"metric": "family_cost", "family": "dgt_span", "k": 8, "ns_per_nz": 0.03},
            {"metric": "family_cost", "family": "tile_onehot", "k": 8, "rejected": "x"}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    out = sol.main(["--microbench", str(path)])
    got = {r["family"]: r for r in out["rows"]}
    assert out["rates"] == "probe"
    assert got["walk"]["measured_ns_per_nz"] == 0.03
    assert got["tile"]["measured_ns_per_nz"] is None
    assert json.loads(capsys.readouterr().out)["k"] == 8


def _write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows) + "not json\n\n")


def test_report_tables(tmp_path):
    s = tmp_path / "suite.jsonl"
    _write(s, [
        {"metric": "session_probe", "ts": 1},
        {"bench": "suite/powerlaw", "k": 8, "gflops": 10.0, "schedule": "dg_span",
         "vs_cusparse": 1.5, "pct_roofline": 40.0, "ts": 2},
        # a later row for the same cell supersedes
        {"bench": "suite/powerlaw", "k": 8, "gflops": 12.0, "gflops_norm": 11.0,
         "schedule": "dgt_span", "vs_cusparse": 1.8, "pct_roofline": 42.5, "ts": 5},
        {"bench": "suite/banded", "k": 32, "gflops": 30.0, "schedule": "tile_onehot", "ts": 3},
        {"bench": "spmv_powerlaw/dg", "k": 1, "gflops": 1.0, "ts": 4},
    ])
    table = report.sweep_table(str(s), fresh_after=4)
    lines = table.splitlines()
    assert lines[0].startswith("| workload | K=8 | K=32 | K=128 |") and "vs cuSPARSE" in lines[0]
    assert lines[2] == "| powerlaw | 12.0/11.0* | — | — | dgt | 1.80–1.80x | 42.5–42.5% |"
    assert lines[3] == "| uniform | — | — | — |  | — | — |"
    assert lines[4] == "| banded | — | 30.0 | — | tile_onehot | — | — |"
    z = tmp_path / "zoo.jsonl"
    _write(z, [{"case": "tall", "k": 8, "gflops": 5.0, "schedule": "dg_span", "ts": 1},
               {"case": "tall", "k": 64, "gflops": 50.0, "schedule": "tile_onehot", "ts": 2},
               {"case": "banded", "k": 64, "error": "RuntimeError: x", "ts": 3}])
    assert report.zoo_table(str(z)).splitlines()[2:] == [
        "| banded | — | — | — / ? |",
        "| tall | 5.0 | 50.0 | dg / tile_onehot |"]
    assert report.sweep_table(str(tmp_path / "missing.jsonl")).count("—") == 15


def test_report_main(tmp_path, capsys):
    report.main(["--suite", str(tmp_path / "a"), "--zoo", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "## SuiteSparse-class sweep" in out and "## Robustness grid" in out


def test_suite_unknown_only_lists_the_tags(capsys):
    with pytest.raises(SystemExit) as e:
        suite.run_suite(only="bogus", device="cpu")
    assert all(t in str(e.value) for t in suite.TAGS) and "'bogus'" in str(e.value)
    with pytest.raises(SystemExit) as e:
        suite.main(["--only", "suit"])  # no match by substring
    assert "valid tags: " + ", ".join(suite.TAGS) in str(e.value)


def test_suite_norms_read_this_runs_probe(tmp_path, monkeypatch):
    """The rates' norm is the run's own probe's stream norm; a flagged
    stream leaves no norm."""
    for flagged in (False, True):
        probe = {"metric": "session_probe", "stream_gbs": 3000.0, "norm_stream": 0.5}
        if flagged:
            probe.update(norm_stream=None, implausible=["stream_gbs"])
        monkeypatch.setattr(mb, "session_probe", lambda device, probe=probe: dict(probe))
        rows = suite.run_suite(quick=True, only="block", out_path=str(tmp_path / "s.jsonl"),
                               device="cpu")
        row = rows[1]
        if flagged:
            assert "gflops_norm" not in row and "norm_axis" not in row
        else:
            assert row["gflops_norm"] == pytest.approx(0.5 * row["gflops"])
            assert row["norm_axis"] == "stream"


def test_suite_section_on_the_cpu(tmp_path):
    out = tmp_path / "s.jsonl"
    rows = suite.run_suite(quick=True, only="block", out_path=str(out), device="cpu")
    assert [r.get("bench") for r in rows] == [None, "block_sparse_128"]
    assert rows[0] == {**mb.session_probe(device="cpu"), "ts": rows[0]["ts"]}
    assert rows[1]["gflops"] > 0 and "error" not in rows[1]
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows


def test_zoo_cases_are_the_jax_cases():
    from tpusparse.bench.zoo import zoo as jzoo

    got, want = zoo.zoo(quick=True), jzoo(quick=True)
    assert list(got) == list(want)
    for name in got:
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name].rows, want[name].rows)
        np.testing.assert_array_equal(got[name].cols, want[name].cols)
        np.testing.assert_array_equal(got[name].vals, want[name].vals)
