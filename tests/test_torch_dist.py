"""tpusparse_torch.dist against tpusparse.dist on the conftest's 8 virtual
CPU devices: the five halo packers' planes array for array, each ring's Y
on ``LocalRing`` over CPU ranks against the JAX ring on the same packed
format and the oracle (1-D rings at D = 2, 4, 8 and 2-D (4 x 2) meshes),
the sharded stripe SpMM, the order of the ring's shifts and kernels, the
dry run and the dp x tp training step."""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import tpusparse.dist as jdist
import tpusparse.dist.overlap as jov
from tpusparse.generator import prepare_stripe_format as jax_prepare_stripe
from tpusparse.io import builder
from tpusparse.oracle import check_result, spmm_reference

import tpusparse_torch.dist.overlap as ov
from tpusparse_torch.dist import build_sharded_stripe_spmm, make_mesh, shard_stripe_format
from tpusparse_torch.generator import prepare_stripe_format
from tpusparse_torch.io.mtx import CooMatrix

# kind: (JAX test's matrix (m, n, avg, seed), X's (columns, seed), pack
# kwargs, JAX builder kwargs, oracle tolerance), at the JAX tests' sizes
# (tests/test_dist.py; dg at tests/test_dist_hlo_overlap.py's)
RINGS = {
    "stripe": ((280, 300, 5.0, 7), (24, 8), dict(rows_per_stripe=32), dict(unroll=4), 1e-4),
    "span": ((280, 300, 5.0, 7), (24, 8), dict(rows_per_program=64, ct=64, g=32), {}, 1e-3),
    "radix": ((512, 600, 6.0, 7), (16, 1), dict(rows_per_program=128, S=16, g=64, kt=8),
              dict(kt=8), 2e-3),
    "dg": ((512, 512, 6.0, 3), (16, 0), dict(rows_per_program=64, ns=2, g=128, kt=8),
           dict(kt=8), 5e-4),
    "dgt": ((400, 520, 5.0, 9), (16, 10), dict(rows_per_program=64, g=128, kt=8), {}, 1e-3),
}
PACKERS = {"stripe": "pack_halo_stripe", "span": "pack_halo_span", "radix": "pack_halo_radix",
           "dg": "pack_halo_dg", "dgt": "pack_halo_dgt"}
BUILDERS = {"stripe": "build_halo_spmm", "span": "build_halo_span_spmm",
            "radix": "build_halo_radix_spmm", "dg": "build_halo_dg_spmm",
            "dgt": "build_halo_dgt_spmm"}
# the port's own field of each format, beside the JAX planes
OWN_FIELD = {"stripe": "live_p", "span": "nc_p", "radix": "nc_p", "dg": "nc_p", "dgt": "nc_p"}


def _port(mat) -> CooMatrix:
    return CooMatrix(np.asarray(mat.rows), np.asarray(mat.cols), np.asarray(mat.vals), mat.shape)


def _mat_x(kind, k=None):
    (m, n, avg, seed), (kx, xseed), *_ = RINGS[kind]
    mat = builder.power_law_coo(m, n, avg_nnz_per_row=avg, seed=seed)
    x = np.random.default_rng(xseed).standard_normal((n, k or kx)).astype(np.float32)
    return mat, x


def _packs(kind, mat, d, **extra):
    kw = {**RINGS[kind][2], **extra}
    return (getattr(jov, PACKERS[kind])(mat, d, **kw),
            getattr(ov, PACKERS[kind])(_port(mat), d, device="cpu", **kw))


def _assert_same_format(jf, tf, kind):
    assert type(jf).__name__ == type(tf).__name__
    for f in dataclasses.fields(jf):
        a, b = getattr(jf, f.name), getattr(tf, f.name)
        if isinstance(b, torch.Tensor):
            a = np.asarray(a)
            assert b.dtype == (torch.float32 if a.dtype == np.float32 else torch.int32), f.name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{kind}.{f.name}")
        else:
            assert a == b, (kind, f.name, a, b)
    assert tf.padding_rate == pytest.approx(jf.padding_rate)


def _jax_mesh(n_row, n_k=1):
    devs = np.array(jax.devices()[:n_row * n_k])
    if n_k == 1:
        return JaxMesh(devs, ("rows",))
    return JaxMesh(devs.reshape(n_row, n_k), ("rows", "k"))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("kind", list(RINGS))
def test_halo_packer_equals_jax(kind, d):
    """Every plane, the slot map and the static fields equal the JAX
    packer's; the format carried across by halo_format_from_numpy equals
    the port's own pack, its own field (live_p / nc_p) derived alike."""
    mat, _ = _mat_x(kind)
    jf, tf = _packs(kind, mat, d)
    _assert_same_format(jf, tf, kind)
    fields = {f.name: np.asarray(getattr(jf, f.name)) for f in dataclasses.fields(jf)
              if hasattr(getattr(jf, f.name), "shape")}
    static = {f.name: getattr(jf, f.name) for f in dataclasses.fields(jf) if f.name not in fields}
    carried = ov.halo_format_from_numpy(fields, device="cpu", **static)
    for f in dataclasses.fields(tf):
        a, b = getattr(carried, f.name), getattr(tf, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), (kind, f.name)
        else:
            assert a == b
    # the own field counts what the kernel walks: every live slot lies below it
    own = getattr(tf, OWN_FIELD[kind])
    if kind == "stripe":
        slot = torch.arange(tf.stripe_nnz).view(1, 1, 1, 1, -1)
        assert not bool(((tf.vals != 0) & (slot >= own[..., None, None])).any())
    else:
        nc = torch.arange(tf.vals.shape[3]).view(1, 1, 1, -1, 1)
        assert not bool(((tf.vals != 0) & (nc >= own.view(*own.shape[:3], 1, 1))).any())


def test_halo_dgt_split_rows_pack_and_ring():
    """The mega row of tests/test_dist.py::test_halo_dgt_split_rows splits
    (split_levels > 1) in both packers, and sums exactly through the
    port's pyramid fold."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.zeros(300, np.int64), rng.integers(1, 256, 1500)])
    cols = np.concatenate([rng.permutation(512)[:300], rng.integers(0, 512, 1500)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    from tpusparse.io.mtx import CooMatrix as JaxCoo

    order = np.lexsort((cols, rows))
    mat = JaxCoo(rows[order], cols[order], vals[order], (256, 512))
    x = rng.standard_normal((512, 8)).astype(np.float32)
    jf = jov.pack_halo_dgt(mat, 4, rows_per_program=64, g=128, kt=8, split=64)
    tf = ov.pack_halo_dgt(_port(mat), 4, rows_per_program=64, g=128, kt=8, split=64,
                          device="cpu")
    assert tf.split_levels > 1
    _assert_same_format(jf, tf, "dgt")
    fn, put = ov.build_halo_dgt_spmm(tf, make_mesh(4, 1, ["cpu"] * 4))
    check_result(fn(*put(x)).numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=1e-3)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("kind", list(RINGS))
def test_halo_ring_matches_jax_and_oracle(kind, d):
    """The port's ring on LocalRing over d CPU ranks gives the oracle's Y
    and the JAX ring's Y on the same packed format, at the JAX test's
    tolerance."""
    mat, x = _mat_x(kind)
    jf, tf = _packs(kind, mat, d)
    bkw, tol = RINGS[kind][3], RINGS[kind][4]
    fn, put = getattr(ov, BUILDERS[kind])(tf, make_mesh(d, 1, ["cpu"] * d), **bkw)
    args = put(x)
    y = fn(*args)
    assert y.shape == (mat.shape[0], x.shape[1]) and y.dtype == torch.float32
    want = spmm_reference(mat, x.astype(np.float64))
    check_result(y.numpy(), want, rtol=tol)
    jfn, jput = getattr(jov, BUILDERS[kind])(jf, _jax_mesh(d), **bkw)
    jy = np.asarray(jfn(*jput(x)))[:, :x.shape[1]]
    check_result(y.numpy(), jy, rtol=tol, what="against the JAX ring")
    # a second call on the same inputs gives the same Y (the ring never
    # writes its inputs)
    assert torch.equal(fn(*args), y)


@pytest.mark.parametrize("kind", ["span", "radix", "dg", "dgt"])
def test_halo_ring_2d_mesh(kind):
    """A 4 x 2 ('rows', 'k') mesh: one ring per 'k' column, X's columns
    split over them; Y equals the oracle's and the JAX ring's on its 2-D
    mesh."""
    mat, x = _mat_x(kind, k=32)
    jf, tf = _packs(kind, mat, 4)
    bkw, tol = dict(RINGS[kind][3]), RINGS[kind][4]
    if kind == "span":
        bkw["ktile"] = 16       # tests/test_dist.py::test_halo_span_2d_mesh
    fn, put = getattr(ov, BUILDERS[kind])(tf, make_mesh(4, 2, ["cpu"] * 8), **bkw)
    assert fn.transport.n_k == 2
    y = fn(*put(x)).numpy()
    check_result(y, spmm_reference(mat, x.astype(np.float64)), rtol=tol)
    jfn, jput = getattr(jov, BUILDERS[kind])(jf, _jax_mesh(4, 2), **bkw)
    check_result(y, np.asarray(jfn(*jput(x)))[:, :32], rtol=tol, what="against the JAX ring")


def test_stripe_ring_refuses_a_k_sharded_mesh():
    mat, _ = _mat_x("stripe")
    tf = ov.pack_halo_stripe(_port(mat), 4, rows_per_stripe=32, device="cpu")
    with pytest.raises(ValueError, match="does not shard K"):
        ov.build_halo_spmm(tf, make_mesh(4, 2, ["cpu"] * 8))


def test_ring_refuses_a_mesh_of_another_size_and_foreign_inputs():
    mat, x = _mat_x("dg")
    tf = ov.pack_halo_dg(_port(mat), 4, rows_per_program=64, ns=2, g=128, kt=8, device="cpu")
    with pytest.raises(ValueError, match="rows ranks"):
        ov.build_halo_dg_spmm(tf, make_mesh(2, 1, ["cpu"] * 2))
    fn, put = ov.build_halo_dg_spmm(tf, make_mesh(4, 1, ["cpu"] * 4))
    _, put2 = ov.build_halo_dg_spmm(tf, make_mesh(4, 1, ["cpu"] * 4))
    planes, slot, xs = put2(x)
    with pytest.raises(ValueError, match="this builder's put_inputs"):
        fn(planes, slot, xs)
    with pytest.raises(ValueError, match="mesh= or a group="):
        ov.build_halo_dg_spmm(tf)


def test_make_mesh():
    mesh = make_mesh(4, 2, ["cpu"] * 8)
    assert mesh.shape == {"rows": 4, "k": 2} and mesh.devices.shape == (4, 2)
    assert mesh.out_device == torch.device("cpu")
    assert str(mesh).startswith("Mesh({'rows': 4, 'k': 2}")
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh(4, 2, ["cpu"] * 4)


@pytest.mark.parametrize("n_row,n_k", [(4, 2), (8, 1), (2, 1)])
def test_sharded_stripe_spmm(n_row, n_k):
    """tests/test_dist.py::test_sharded_stripe_spmm on CPU ranks: the
    oracle's Y and the JAX sharded SpMM's."""
    mat = builder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0)
    x = np.random.default_rng(1).standard_normal((260, 16 * n_k)).astype(np.float32)
    fmt, _ = prepare_stripe_format(_port(mat), work_per_stripe=256, nnz_multiple=8,
                                   device="cpu")
    fn, put = build_sharded_stripe_spmm(fmt, make_mesh(n_row, n_k, ["cpu"] * 8), unroll=4)
    y = fn(*put(x)).numpy()
    check_result(y, spmm_reference(mat, x.astype(np.float64)), rtol=1e-4)
    jfmt, _ = jax_prepare_stripe(mat, work_per_stripe=256, nnz_multiple=8)
    jfn, jput = jdist.build_sharded_stripe_spmm(jfmt, jdist.make_mesh(n_row, n_k), unroll=4)
    check_result(y, np.asarray(jfn(*jput(x)))[:, :x.shape[1]], rtol=1e-4)


def test_shard_stripe_format_pads_with_empty_stripes():
    mat = builder.power_law_coo(300, 260, avg_nnz_per_row=5.0, seed=0)
    fmt, _ = prepare_stripe_format(_port(mat), work_per_stripe=256, nnz_multiple=8,
                                   device="cpu")
    n_row = fmt.n_stripes + 3
    padded = shard_stripe_format(fmt, n_row)
    assert padded.n_stripes == n_row and padded.cols.shape[0] == n_row
    assert not bool(padded.vals[fmt.n_stripes:].any()) and not bool(
        padded.live_p[fmt.n_stripes:].any())


class RecordingRing(ov.LocalRing):
    """A LocalRing that logs each shift's start and wait and each rank's
    kernel launch, in order."""

    def __init__(self, mesh, log):
        super().__init__(mesh)
        self.log = log

    def start(self, step, bufs):
        self.log.append(("start", step))
        return super().start(step, bufs)

    def wait(self, handle):
        self.log.append(("wait", handle))
        super().wait(handle)

    @contextlib.contextmanager
    def on_rank(self, q, step):
        with super().on_rank(q, step):
            yield
        self.log.append(("kernel", step, q))


@pytest.fixture
def sync_log(monkeypatch):
    """Logs every host call that would wait on a card: synchronize, a
    tensor's value read on the host."""
    log = []

    def wrap(owner, name):
        orig = getattr(owner, name)

        def f(*a, **k):
            log.append(("sync", name))
            return orig(*a, **k)

        monkeypatch.setattr(owner, name, f)

    wrap(torch.cuda, "synchronize")
    for owner in (torch.cuda.Stream, torch.cuda.Event):
        wrap(owner, "synchronize")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__"):
        wrap(torch.Tensor, name)
    return log


@pytest.mark.parametrize("kind", list(RINGS))
def test_ring_shift_overlaps_the_step_kernel(kind, sync_log):
    """The counterpart of tests/test_dist_hlo_overlap.py: at every step the
    shift that brings the chunk of step s+1 starts before the kernels of
    step s are launched and is waited on only after them (and before the
    kernels of step s+1); no host sync falls inside the loop."""
    mat = builder.power_law_coo(512, 512, avg_nnz_per_row=6.0, seed=3)
    x = np.random.default_rng(0).standard_normal((512, 16)).astype(np.float32)
    kw = {"stripe": dict(rows_per_stripe=32), "span": dict(rows_per_program=64, ct=128, g=64),
          "radix": dict(rows_per_program=64, S=16, g=32, kt=8),
          "dg": dict(rows_per_program=64, ns=2, g=128, kt=8),
          "dgt": dict(rows_per_program=64, g=128, kt=8)}[kind]
    d = 4
    tf = getattr(ov, PACKERS[kind])(_port(mat), d, device="cpu", **kw)
    ring = RecordingRing(make_mesh(d, 1, ["cpu"] * d), sync_log)
    fn, put = getattr(ov, BUILDERS[kind])(tf, ring, **RINGS[kind][3])
    args = put(x)
    del sync_log[:]
    y = fn(*args)
    log = list(sync_log)
    check_result(y.numpy(), spmm_reference(mat, x.astype(np.float64)), rtol=RINGS[kind][4])

    def at(pred):
        return [i for i, e in enumerate(log) if pred(e)]

    kernels = {s: at(lambda e, s=s: e[0] == "kernel" and e[1] == s) for s in range(d)}
    assert all(len(kernels[s]) == d for s in range(d)), log
    assert len(at(lambda e: e[0] == "start")) == d - 1
    for s in range(d - 1):
        (i_start,) = at(lambda e, s=s: e == ("start", s))
        (i_wait,) = at(lambda e, s=s: e == ("wait", s))
        assert i_start < min(kernels[s]) and max(kernels[s]) < i_wait < min(kernels[s + 1])
    inside = [e for e in log[min(kernels[0]):max(kernels[d - 1])] if e[0] == "sync"]
    assert not inside, inside


def test_dryrun_multichip_on_cpu_ranks(capsys):
    from tpusparse_torch.dist.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == (2, 2)
    assert out["dgt"] <= 2.5 and out["dgt_fullrow"] <= 1.5
    assert out["losses"][-1] < out["losses"][0]
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_train_step_dp_tp():
    """tests/test_dist.py::test_train_step_dp_tp: the dp x tp step on a
    4 x 2 mesh of CPU ranks, the gradients through the frozen plans (A and
    A^T) and the SDDMM pair; the loss falls."""
    from tpusparse_torch.dist.dryrun import _train_step_dryrun

    mat = builder.power_law_coo(128, 96, avg_nnz_per_row=6.0, seed=3)
    losses = _train_step_dryrun(make_mesh(4, 2, ["cpu"] * 8), _port(mat), steps=3)
    assert losses[-1] < losses[0], losses


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _ring_trace(shift_stream=13, sync_at=None):
    """Two bucket kernels on stream 7 and one shift in a ring_shift span,
    with a copy of the gather's outside it."""
    events = [
        _ev("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
        _ev(ov.SHIFT_SPAN, "user_annotation", 12, 5),
        _ev("cudaMemcpyAsync", "cuda_runtime", 13, 1, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 20, 2, correlation=3),
        _ev("cudaMemcpyAsync", "cuda_runtime", 30, 1, correlation=4),
        _ev("void walk_kernel<8>(...)", "kernel", 100, 10, stream=7, correlation=1),
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 104, 4, stream=shift_stream,
            correlation=2),
        _ev("void walk_kernel<8>(...)", "kernel", 112, 10, stream=7, correlation=3),
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 130, 3, stream=7, correlation=4),
    ]
    if sync_at is not None:
        events.append(_ev("cudaStreamSynchronize", "cuda_runtime", sync_at, 1, correlation=5))
    return events


def test_ring_trace_analysis():
    """bench/ring_profile.py on a made-up trace: the shift is the copy in
    the ring_shift span (the gather's copy is not), all of it beside a
    kernel of another stream; a shift on the kernels' stream and a host
    sync between the first and last bucket launch are refused."""
    from tpusparse_torch.bench.ring_profile import analyse_ring_trace, check_ring_overlap

    prof = analyse_ring_trace(_ring_trace(), shifts=1)
    assert (prof["n_kernels"], prof["n_shifts"]) == (2, 1)
    assert prof["shift_us"] == 4 and prof["overlap_share"] == 1.0
    assert prof["busy_us"] == 23 and prof["kernel_us"] == 20
    assert prof["kernel_streams"] == [7] and prof["shift_streams"] == [13]
    check_ring_overlap(prof, "made-up ring")
    with pytest.raises(AssertionError, match="the ring makes 2"):
        analyse_ring_trace(_ring_trace(), shifts=2)
    with pytest.raises(AssertionError, match="kernels' stream"):
        check_ring_overlap(analyse_ring_trace(_ring_trace(shift_stream=7)), "made-up ring")
    with pytest.raises(AssertionError, match="cudaStreamSynchronize"):
        check_ring_overlap(analyse_ring_trace(_ring_trace(sync_at=15)), "made-up ring")
    assert not analyse_ring_trace(_ring_trace(sync_at=25))["syncs_inside"]
