"""An empty matrix (no nonzeros) through the port on the CPU: every schedule
family of ``build_plan`` (and the sorted and bucketed variants), every
``spmv_fn`` method and ``tune`` at K = 8 give the oracle's Y = 0.

The JAX package raises on five of these paths instead (a reference fault
the port does not copy, ROADMAP.md §C): ``dgt_span`` and ``spmv_fn("dgt8")``
with a ValueError at tpusparse/kernels/dgt_gather.py:298-299; sorted
``stripe_total`` and ``stripe_nested`` on the first_nz_indices check at
tpusparse/meta/set.py:207; sorted ``nnz_segment`` with an IndexError at
tpusparse/transforms/pad.py:60; sorted ``bucketed`` at
tpusparse/schedule.py:593; and ``tune`` with a RuntimeError from
tpusparse/tune.py:441, every candidate having failed.
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import config_override
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.oracle import check_result, spmm_reference
from tpusparse_torch.schedule import KERNEL_FAMILIES, Schedule, build_plan
from tpusparse_torch.spmv import spmv_fn, spmv_multi_fn
from tpusparse_torch.tune import tune

SHAPES = [(10, 8), (300, 200)]
K = 8
# per family the parameters a schedule needs on this matrix
EXTRA = {"dgt_span": dict(rb=16, g=128, ktile=8), "span_colsplit": dict(col_split=2),
         "hybrid_cols": dict(hot_cols=4), "dense": dict(precision="fp32"),
         "block_ell": dict(row_interval=64), "bucketed": dict(bucket_bounds=(3,))}
# the sorted variants of the paths the JAX package fails on
SORTED = ("dgt_span", "stripe_total", "stripe_nested", "nnz_segment", "bucketed")
CASES = ([("plan", f, False) for f in KERNEL_FAMILIES]
         + [("plan", f, True) for f in SORTED]
         + [("spmv", m, False) for m in ("auto", "dg", "dgt8", "span", "segment", "radix",
                                         "stripe")])


def _empty(m, n):
    return CooMatrix(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float64),
                     (m, n))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind,name,sort", CASES,
                         ids=[f"{k}-{n}{'-sorted' if s else ''}" for k, n, s in CASES])
def test_empty_matrix_gives_zero(kind, name, sort, shape):
    mat = _empty(*shape)
    x = np.random.default_rng(0).standard_normal((shape[1], K)).astype(np.float32)
    if kind == "plan":
        y = build_plan(mat, Schedule(family=name, sort=sort, **EXTRA.get(name, {})),
                       device="cpu")(x)
        want = spmm_reference(mat, x.astype(np.float64))
    else:
        y = spmv_fn(mat, name, device="cpu")(x[:, 0])
        want = spmm_reference(mat, x[:, 0].astype(np.float64))
    assert isinstance(y, torch.Tensor) and tuple(y.shape) == want.shape
    assert not want.any() and not y.numpy().any()
    check_result(y.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tune_on_empty_matrix(shape, tmp_path):
    mat = _empty(*shape)
    x = np.random.default_rng(1).standard_normal((shape[1], K)).astype(np.float32)
    with config_override(cache_dir=str(tmp_path)):
        res = tune(mat, x, use_cache=False, device="cpu")
    assert all(row["ok"] or "CandidateRejected" in row["error"] for row in res.table)
    y = res.best(x)
    assert tuple(y.shape) == (shape[0], K) and not y.numpy().any()


@pytest.mark.parametrize("col_split", [2, 3])
def test_spmv_multi_column_split_of_empty_matrix(col_split):
    # no column range holds a nonzero, so the split packs no format; Y is
    # the oracle's zeros, not None (tpusparse/spmv.py:213-217 returns None)
    mat = _empty(40, 30)
    fn = spmv_multi_fn(mat, 5, col_split=col_split, device="cpu")
    assert fn.n_splits == 0 and fn.formats == []
    x = np.random.default_rng(2).standard_normal((30, 5)).astype(np.float32)
    y = fn(x)
    want = spmm_reference(mat, x.astype(np.float64))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert tuple(y.shape) == want.shape == (40, 5) and not y.numpy().any()
