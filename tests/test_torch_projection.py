"""The port's multi-card projection model and scaling harness
(tests/test_projection.py's cases with the port's constants: NVIDIA's
published link rates, a step latency given by the caller), the scaling
harness's field names on CPU and shared-card ranks, and the port's
examples, each run once with --device cpu in a process of its own."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpusparse_torch.bench.projection import LINK_GBS, project
from tpusparse_torch.bench.scaling import measure_scaling, ratio_key

ROOT = Path(__file__).resolve().parent.parent
PCIE, NVLINK = LINK_GBS["pcie_gen5_x16"], LINK_GBS["nvlink4_h100_sxm"]
STEP_LAT_US = 12.0   # a caller's measured shift; the model takes it as given


def test_link_bracket_is_nvidia_published():
    assert LINK_GBS == {"pcie_gen5_x16": 64.0, "nvlink4_h100_sxm": 450.0}


def test_project_compute_bound():
    # bucket compute far above comm: T(d) = d * t_bucket
    r = project(8, 50e-6, 0.8e-3, 32768, 8, PCIE, STEP_LAT_US)
    assert r["bound"] == "compute"
    assert r["t_total_us"] == pytest.approx(8 * 50.0, rel=1e-6)
    assert r["projected_efficiency"] == pytest.approx(0.8e-3 / (8 * 8 * 50e-6), rel=1e-3)


def test_project_comm_bound():
    # tiny bucket: the step floors at chunk_bytes / link + the step latency
    d, n, kt = 8, 32768, 8
    r = project(d, 1e-6, 0.8e-3, n, kt, PCIE, STEP_LAT_US)
    assert r["bound"] == "comm"
    t_comm = (n // d) * kt * 4 / (PCIE * 1e9) + STEP_LAT_US * 1e-6
    assert r["t_total_us"] == pytest.approx(d * t_comm * 1e6, rel=1e-3)


def test_project_speedup_consistency():
    r = project(4, 30e-6, 0.6e-3, 32768, 8, NVLINK, STEP_LAT_US)
    assert r["projected_speedup"] == pytest.approx(4 * r["projected_efficiency"], rel=1e-2)


def test_no_tpu_figure_in_the_projection():
    src = (ROOT / "tpusparse_torch" / "bench" / "projection.py").read_text()
    assert "ICI_GBS" not in src and "STEP_LAT_US =" not in src and "940e6" not in src


def test_scaling_harness_field_name_on_cpu():
    """On CPU ranks the harness emits no perf-shaped 'efficiency' field."""
    rows = measure_scaling(m=512, n=512, k=8, avg_nnz_per_row=4.0, device_counts=[1, 2],
                           iters=2, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert "efficiency" not in r
        assert "cpu_wallclock_ratio_NOT_PERF" in r


def test_ratio_named_efficiency_only_for_a_card_each():
    cards = [torch.device("cuda", i) for i in range(4)]
    assert ratio_key(cards) == "efficiency"
    assert ratio_key([torch.device("cuda", 0)] * 4) == "shared_device_ratio_NOT_SCALING"
    assert ratio_key([torch.device("cpu")] * 2) == "cpu_wallclock_ratio_NOT_PERF"


EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("torch_0*.py"))


def test_every_example_has_a_port():
    assert [n[len("torch_"):] for n in EXAMPLES] == sorted(
        p.name for p in (ROOT / "examples").glob("0*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["HOME"] = str(tmp_path)   # the tuner's cache
    res = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "jax" not in res.stderr.lower()
