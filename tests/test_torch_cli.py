"""``python -m tpusparse_torch`` against ``python -m tpusparse`` on the CPU
(mirrors tests/test_cli_and_cache.py::test_cli_synthetic): the port's
command line runs in a subprocess with ``--device cpu``, its last line is
a JSON object with the JAX command line's keys, and without a card and
without ``--device cpu`` it exits non-zero, naming the missing card."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpusparse.__main__ import main as jax_main
from tpusparse.config import config_override as jconfig_override

ROOT = Path(__file__).resolve().parent.parent


def _args(graph):
    if graph:
        # graph algorithms need a square adjacency
        return f"--synthetic uniform --m 256 --n 256 --avg-nnz 3 --graph {graph}"
    return "--synthetic uniform --m 256 --avg-nnz 3 --iters 2"


def _port_cli(argv, home):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["HOME"] = str(home)  # the tune cache lands under the test's own directory
    return subprocess.run([sys.executable, "-m", "tpusparse_torch", *argv],
                          capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


def _jax_cli(argv, cache_dir):
    out = io.StringIO()
    with jconfig_override(cache_dir=str(cache_dir)), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jax_main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("graph", [None, "cc"])
def test_cli_synthetic(graph, tmp_path):
    r = _port_cli(_args(graph).split() + ["--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    # the JAX command line on the same arguments (one candidate timed: the
    # keys do not depend on how many)
    want = _jax_cli(_args(graph).split() + ([] if graph else ["--budget", "1"]),
                    tmp_path / "jax_cache")
    assert set(out) == set(want)
    if graph:
        assert out == want  # the same number of components
    else:
        assert out["gflops"] > 0 and out["best_schedule"]["family"]
        assert set(out["best_schedule"]) == set(want["best_schedule"])
        assert (out["matrix"], out["k"], out["nnz"]) == (want["matrix"], want["k"], want["nnz"])
    assert "on cpu" in r.stderr


def test_cli_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    r = _port_cli(_args(None).split(), tmp_path)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""
