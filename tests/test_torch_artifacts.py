"""tpusparse_torch.artifacts and results: every format class the port packs
survives a save and load and gives the same Y; the port's .npz holds the
JAX package's arrays under its names; an artifact the JAX package saved
loads into the port's format; tune saves its winner; results.aggregate
equals the JAX aggregate."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpusparse import artifacts as jart
from tpusparse import results as jresults
from tpusparse.io.mtx import CooMatrix as JCoo
from tpusparse.schedule import Schedule as JSchedule
from tpusparse.schedule import build_plan as jbuild_plan
from tpusparse_torch import artifacts as art
from tpusparse_torch import results
from tpusparse_torch.config import config_override
from tpusparse_torch.io import builder
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.block_ell import pack_block_ell
from tpusparse_torch.kernels.nm_structured import pack_nm
from tpusparse_torch.schedule import Schedule, build_plan
from tpusparse_torch.tune import matrix_signature, tune

MAT = builder.power_law_coo(300, 260, avg_nnz_per_row=6.0, seed=3)
X = np.random.default_rng(0).standard_normal((260, 8)).astype(np.float32)

#: a schedule of each plan family whose format the JAX package can save too
SCHEDULES = {
    "dg_span": dict(rb=64, ns=2, g=128, ktile=8),
    "dg_span_kt1": dict(family="dg_span", rb=256, ns=4, g=512, ktile=1),
    "dgt_span": dict(rb=64, g=256, ktile=8),
    "span_onehot": dict(rb=64, ct=128, g=64),
    "radix_span": dict(rb=64, g=128, sublanes=32, ktile=8),
    "tile_onehot": dict(rb=64, ct=128, g=64),
    "stripe_total": dict(work_per_block=256),
    "stripe_nested": dict(work_per_block=256),
    "nnz_segment": dict(work_per_block=256),
    "segment_span": dict(work_per_block=256, ct=128, g=64),
}


def _schedule(name, cls=Schedule):
    kw = dict(SCHEDULES[name])
    return cls(**{"family": name, **kw})


def _plan_format(name):
    return build_plan(MAT, _schedule(name), device="cpu").formats[0]


def _nm_format(dtype):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w.reshape(64, 24, 4)[:, :, 2:] = 0.0  # 2:4
    return pack_nm(w, n_keep=2, group=4, dtype=dtype, device="cpu")


OTHER_FORMATS = {
    "nm_bf16": lambda: _nm_format(torch.bfloat16),
    "nm_int8": lambda: _nm_format(torch.int8),
    "block_ell": lambda: pack_block_ell(builder.block_sparse_coo(256, 192, 64, 0.3, seed=2),
                                        bs=64, device="cpu"),
    "span_bf16": lambda: dataclasses.replace(_plan_format("span_onehot"),
                                             vals=_plan_format("span_onehot").vals.bfloat16()),
}


def _fields_equal(a, b):
    assert type(a) is type(b)
    for name in art.saved_fields(type(a)):
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype, name
            assert torch.equal(va, vb), name
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def _x_for(fmt):
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (fmt.shape[1], 8)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(SCHEDULES) + sorted(OTHER_FORMATS))
def test_every_format_class_survives_save_and_load(name, tmp_path):
    fmt = OTHER_FORMATS[name]() if name in OTHER_FORMATS else _plan_format(name)
    art.save_format(fmt, str(tmp_path / "f"))
    back = art.load_format(str(tmp_path / "f"), device="cpu")
    _fields_equal(fmt, back)
    x = _x_for(fmt)
    if name == "dg_span_kt1":
        x = x[:, 0]
    assert torch.equal(art.format_spmm(fmt, x), art.format_spmm(back, x))


def test_every_port_format_class_is_covered(tmp_path):
    names = {"StripeFormat", "SegmentFormat", "NestedStripeFormat", "TileFormat", "SpanFormat",
             "RadixFormat", "SegmentSpanFormat", "DgFormat", "DgtFormat", "NmFormat",
             "BlockEllFormat"}
    assert set(art._FORMATS) == names
    (tmp_path / "f.json").write_text(json.dumps({"__class__": "HaloStripeFormat"}))
    np.savez(tmp_path / "f.npz")
    with pytest.raises(KeyError, match="HaloStripeFormat"):
        art.load_format(str(tmp_path / "f"), device="cpu")


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_npz_holds_the_jax_arrays_under_its_names(name, tmp_path):
    fmt = _plan_format(name)
    jfmt = jbuild_plan(JCoo(MAT.rows, MAT.cols, MAT.vals, MAT.shape),
                       _schedule(name, JSchedule)).formats[0]
    art.save_format(fmt, str(tmp_path / "port"))
    jart.save_format(jfmt, str(tmp_path / "jax"))
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    with open(tmp_path / "port.json") as f:
        pj = json.load(f)
    with open(tmp_path / "jax.json") as f:
        jj = json.load(f)
    assert pj == jj


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_jax_artifact_loads_into_the_port(name, tmp_path):
    jfmt = jbuild_plan(JCoo(MAT.rows, MAT.cols, MAT.vals, MAT.shape),
                       _schedule(name, JSchedule)).formats[0]
    jart.save_format(jfmt, str(tmp_path / "jax"))
    got = art.load_format(str(tmp_path / "jax"), device="cpu")
    own = _plan_format(name)
    x = _x_for(own)
    if name == "dg_span_kt1":
        x = x[:, 0]
    assert torch.equal(art.format_spmm(got, x), art.format_spmm(own, x))


def test_tune_saves_its_winner_and_results_aggregate_equal_jax(tmp_path):
    cands = [_schedule("dg_span"), _schedule("span_onehot"), _schedule("stripe_total")]
    with config_override(cache_dir=str(tmp_path)):
        res = tune(MAT, X, candidates=cands, iters=2, device="cpu")
        sig = matrix_signature(MAT)
        runs = os.listdir(tmp_path / "artifacts" / sig)
        assert len(runs) == 1
        sched, formats, perf = art.load_plan_artifact(str(tmp_path / "artifacts" / sig / runs[0]),
                                                      device="cpu")
    assert Schedule(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in sched.items()}) == res.best_schedule
    assert perf["k"] == 8 and perf["seconds"] == res.best_seconds
    assert len(formats) == len(res.best.formats)
    for a, b in zip(res.best.formats, formats):
        _fields_equal(a, b)
        x = torch.from_numpy(X)
        assert torch.equal(art.format_spmm(a, x), art.format_spmm(b, x))
    path = str(tmp_path / "results.jsonl")
    with open(path, "a") as f:
        f.write("not json\n\n")
    best, n_rows = results.aggregate([path])
    jbest, jn_rows = jresults.aggregate([path])
    assert (best, n_rows) == (jbest, jn_rows) and n_rows == 3
    assert best[(sig, 8)]["schedule"]["family"] == res.best_schedule.family


def test_tune_writes_an_artifact_once_per_winner(tmp_path):
    # a re-tune that keeps its winner writes nothing; a matrix of the same
    # signature but other values gets a directory of its own
    cands = [_schedule("dg_span")]
    other = CooMatrix(MAT.rows, MAT.cols, 2.0 * np.asarray(MAT.vals), MAT.shape)
    assert matrix_signature(other) == matrix_signature(MAT)
    with config_override(cache_dir=str(tmp_path)):
        root = tmp_path / "artifacts" / matrix_signature(MAT)
        tune(MAT, X, candidates=cands, iters=1, device="cpu")
        (run,) = os.listdir(root)
        stamp = os.path.getmtime(root / run / "schedule.json")
        tune(MAT, X, candidates=cands, iters=1, device="cpu")
        assert os.listdir(root) == [run]
        assert os.path.getmtime(root / run / "schedule.json") == stamp
        tune(other, X, candidates=cands, iters=1, device="cpu")
        runs = sorted(os.listdir(root))
        assert len(runs) == 2
        (new,) = set(runs) - {run}
        _, (f_old,), _ = art.load_plan_artifact(str(root / run), device="cpu")
        _, (f_new,), _ = art.load_plan_artifact(str(root / new), device="cpu")
    x = torch.from_numpy(X)
    torch.testing.assert_close(art.format_spmm(f_new, x), 2.0 * art.format_spmm(f_old, x),
                               rtol=1e-6, atol=1e-6)


def test_results_main_prints_the_best_row(tmp_path, capsys):
    rows = [{"matrix": "m", "k": 8, "ok": True, "gflops": 2.0, "seconds": 1e-3,
             "schedule": {"family": "dg_span"}, "device": "cpu"},
            {"matrix": "m", "k": 8, "ok": True, "gflops": 3.0, "seconds": 5e-4,
             "schedule": {"family": "span_onehot"}, "padding_rate": 1.5},
            {"matrix": "m", "k": 8, "ok": False, "error": "x"}]
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    results.main([str(path)])
    out = capsys.readouterr().out
    assert "3 measurements, 1 (matrix, K) groups" in out and "span_onehot" in out
    results.main([str(tmp_path / "missing.jsonl")])
    assert "no successful measurements found (0 rows scanned)" in capsys.readouterr().out


def test_a_failed_save_is_reported(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise OSError("read-only")

    monkeypatch.setattr(art, "save_plan_artifact", refuse)
    with config_override(cache_dir=str(tmp_path)):
        with pytest.warns(UserWarning, match="artifact was not saved: OSError: read-only"):
            res = tune(MAT, X, candidates=[_schedule("dg_span")], iters=1, device="cpu")
    assert res.best_schedule.family == "dg_span"
