"""tpusparse_torch stands alone: importing it loads no JAX and no module of
the JAX package, and no file of the port (nor chip_smoke.py, nor the port's
examples) imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+tpusparse(\.|\s|$|,)"
                       r"|from\s+tpusparse(\.|\s))", re.M)


def test_import_loads_no_jax_and_no_tpusparse():
    code = ("import sys, tpusparse_torch, tpusparse_torch.tune, "
            "tpusparse_torch.schedule, tpusparse_torch.kernels.dg_gather, "
            "tpusparse_torch.kernels.dgt_gather, tpusparse_torch.kernels.tile_onehot, "
            "tpusparse_torch.kernels.span_gather, tpusparse_torch.kernels.radix_gather, "
            "tpusparse_torch.kernels.stripe_gather, tpusparse_torch.kernels.nnz_split, "
            "tpusparse_torch.kernels.nm_structured, tpusparse_torch.kernels.block_ell, "
            "tpusparse_torch.kernels.sddmm, tpusparse_torch.autodiff, "
            "tpusparse_torch.batched, tpusparse_torch.nn, tpusparse_torch.format, "
            "tpusparse_torch.generator, tpusparse_torch.transforms, tpusparse_torch.ops, "
            "tpusparse_torch.spmv, tpusparse_torch.native, tpusparse_torch.graph, "
            "tpusparse_torch.spgemm, tpusparse_torch.artifacts, tpusparse_torch.results, "
            "tpusparse_torch.__main__, tpusparse_torch.io.realdata, "
            "tpusparse_torch.transforms.compress, tpusparse_torch.bench.baselines, "
            "tpusparse_torch.bench.microbench, tpusparse_torch.bench.sol, "
            "tpusparse_torch.bench.suite, tpusparse_torch.bench.zoo, "
            "tpusparse_torch.bench.report, tpusparse_torch.dist, tpusparse_torch.dist.shard, "
            "tpusparse_torch.dist.overlap, tpusparse_torch.dist.dryrun, "
            "tpusparse_torch.bench.scaling, tpusparse_torch.bench.projection, "
            "tpusparse_torch.bench.ring_profile; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'tpusparse' or m.startswith('tpusparse.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "tpusparse_torch").rglob("*.py"), ROOT / "chip_smoke.py",
     *(ROOT / "examples").glob("torch_*.py")]))
def test_no_jax_or_tpusparse_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


def test_forbidden_pattern_spares_the_port_name():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from tpusparse.io import builder")
    assert FORBIDDEN.search("import tpusparse")
    assert not FORBIDDEN.search("import tpusparse_torch")
    assert not FORBIDDEN.search("from tpusparse_torch.io import builder")


def test_build_sources_are_every_csrc_file():
    # chip_smoke.py builds build.SOURCES in parallel: every kernel source is there
    from tpusparse_torch.kernels import build

    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
