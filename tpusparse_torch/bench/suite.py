"""Workload-class sweep (counterpart of ``tpusparse/bench/suite.py``;
BASELINE.json configs #2-#4).

Sweeps the reference's workload classes through the port's entry points on
the card: SuiteSparse-like matrices (power-law, uniform, banded) at K in
{8, 32, 128} through ``tune``, the reference's brick-ELL layout against
column-sorted chunks, nested against flat stripes, a pruned-LLM weight at
K = 512, a training step of ``TrainableSparseLinear`` (with the SDDMM
kernel alone and the dense step beside it), N:M 2:4 and Block-ELL weights
(bf16 and int8), SpMV at 262144^2, the graph drivers, SpGEMM and matrices
built from data on disk.  One JSON line per (workload, K), each appended to
the output file as it comes (``BENCH_SUITE.jsonl`` under the config
cache_dir by default).  The first line is the session probe; a rate on a
line has a twin normalized to the probe's anchor window on the stream
axis, which bounds every family at these shapes (``bench/sol.py::
BOUND_AXIS``).  A line from ``tune`` lists its candidates that were not ok
(``not_ok``): each one's family, its error, and whether a gate or guard
refused it (``refused``), it missed the oracle (``oracle``) or a packer's
precondition failed (``precondition``).

The baseline is cuSPARSE's CSR product (``bench/baselines.py::
csr_spmm_fn``), where the JAX suite used BCOO; ``pct_roofline`` is the
traffic (format, X and Y once each) over this run's probe's stream
(none where the probe flagged that axis).

Run: python -m tpusparse_torch.bench.suite [--quick] [--only TAG] [--out PATH]

``--only TAG`` runs just the section with that exact tag (see TAGS); an
unknown tag exits with the list of tags.  A section that raises writes an
``error`` line and the run goes on; the command then exits 1.  A schedule
that its family's gate refuses on a matrix (brick-ELL's chunk blocks)
writes a ``rejected`` line.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

TAGS = ("suite", "layout", "nested", "pruned", "trainable", "nm", "block",
        "quant", "spmv", "graph", "spgemm", "real")


def not_ok(table: list[dict]) -> list[dict]:
    """The candidates of a ``tune`` table that were not ok, each with its
    family, its error and its kind: ``refused`` (a family's gate, the
    padding bound or a plausibility guard: ``CandidateRejected``),
    ``oracle`` (Y missed the oracle's tolerance) or ``precondition`` (any
    other ``AssertionError``, a packer's)."""
    out = []
    for r in table:
        if r.get("ok", True):
            continue
        err = str(r.get("error", ""))
        kind = ("refused" if err.startswith("CandidateRejected")
                else "oracle" if "exceed rtol" in err else "precondition")
        out.append({"family": (r.get("schedule") or {}).get("family"), "kind": kind,
                    "error": err})
    return out


def tune_fields(res) -> dict:
    """What a row records of a tune's candidates: how many ran, how many
    were ok, and the rest (``not_ok``)."""
    return {"n_ok": sum(1 for r in res.table if r.get("ok")), "n_cand": len(res.table),
            "not_ok": not_ok(res.table)}


def _check_only(only: str | None) -> None:
    if only is not None and only not in TAGS:
        raise SystemExit(
            f"--only {only!r} is not a section tag; valid tags: {', '.join(TAGS)}")


def run_suite(quick: bool = False, out_path: str | None = None, only: str | None = None,
              device="cuda") -> list[dict]:
    """Run the sections (all, or the one tagged ``only``) on ``device`` and
    return their rows; each row is also appended to ``out_path``."""
    _check_only(only)

    import numpy as np
    import torch

    from tpusparse_torch.bench.baselines import csr_spmm_fn
    from tpusparse_torch.bench.harness import gflops, time_fn, time_fn_host
    from tpusparse_torch.bench.microbench import session_probe
    from tpusparse_torch.config import get_config
    from tpusparse_torch.io import builder
    from tpusparse_torch.kernels.common import resolve_device
    from tpusparse_torch.schedule import CandidateRejected, Schedule, build_plan
    from tpusparse_torch.tune import tune

    dev = resolve_device(device)
    timer = time_fn if dev.type == "cuda" else time_fn_host
    if out_path is None:
        out_path = os.path.join(get_config().cache_dir, "BENCH_SUITE.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    size = 8192 if quick else 16384
    rows: list[dict] = []
    probe = session_probe(device=dev)
    # this run's stream GB/s; none on the CPU or where the probe flagged it
    bw = (None if "stream_gbs" in probe.get("implausible", ())
          else probe.get("stream_gbs"))
    # every family is stream-bound at these shapes (sol.BOUND_AXIS)
    norm = probe.get("norm_stream")

    def emit(row):
        row["ts"] = time.time()
        for field in ("gflops", "gnnz_per_s"):
            if isinstance(row.get(field), (int, float)) and norm:
                row[field + "_norm"] = row[field] * norm
                row["norm_axis"] = "stream"
        rows.append(row)
        print(json.dumps(row), flush=True)
        # appended at once, so that a run cut short keeps what it measured
        with open(out_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def guard(label, body, **fields):
        """Run ``body()``; a schedule a family's gate refuses becomes a
        ``rejected`` row for ``label``, any other raise an ``error`` row."""
        try:
            body()
        except CandidateRejected as e:
            emit({"bench": label, **fields, "rejected": str(e)})
        except Exception as e:  # noqa: BLE001 - the sweep goes on; the row keeps the error
            tb = traceback.extract_tb(e.__traceback__)[-1]
            emit({"bench": label, **fields,
                  "error": f"{type(e).__name__}: {e} ({os.path.basename(tb.filename)}:"
                           f"{tb.lineno})"})

    def sel(tag):
        return only is None or only == tag

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def rand(shape, seed):
        return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)

    def pct_roofline(fmt_bytes, m, n, k, sec):
        """Traffic (format read + X read + Y write, each once) as % of the
        measured stream rate."""
        if not bw or not sec:
            return None
        return 100.0 * (fmt_bytes + (n * k + m * k) * 4) / sec / 1e9 / bw

    def plan_bytes(plan):
        return int(plan.meta.get("format_bytes") or sum(f.memory_bytes for f in plan.formats))

    emit(dict(probe))

    # built lazily, so that --only pays for no other section's matrices
    _wl: dict = {}

    def workload(name):
        if name not in _wl:
            _wl[name] = {
                "powerlaw": lambda: builder.power_law_coo(size, size, avg_nnz_per_row=16.0,
                                                          seed=1),
                "uniform": lambda: builder.uniform_coo(size, size, nnz_per_row=12, seed=2),
                "banded": lambda: builder.banded_coo(size, size, bandwidth=48, seed=3),
            }[name]()
        return _wl[name]

    wl_names = ("powerlaw", "uniform", "banded")

    # ---- config #2: SuiteSparse-class sweep, fp32, K in {8, 32, 128}
    def suite_row(name, k):
        mat = workload(name)
        x = rand((mat.shape[1], k), 0)
        res = tune(mat, x, iters=5, validate=True, budget=10, device=dev)
        bsec = timer(csr_spmm_fn(mat, device=dev), on_dev(x), iters=5)
        emit({"bench": f"suite/{name}", "k": k, "nnz": mat.nnz,
              "gflops": gflops(mat.nnz, k, res.best_seconds), "seconds": res.best_seconds,
              "schedule": res.best_schedule.family, "vs_cusparse": bsec / res.best_seconds,
              "pct_roofline": pct_roofline(plan_bytes(res.best), mat.shape[0], mat.shape[1], k,
                                           res.best_seconds), **tune_fields(res)})

    for name in (wl_names if sel("suite") else ()):
        for k in ([8] if quick else [8, 32, 128]):
            guard(f"suite/{name}", lambda name=name, k=k: suite_row(name, k), k=k)

    def ab_rows(tag, variants, x, k, nnz, reps=5, iters=5):
        """Repeated measures: every variant is built first, then the timing
        reps interleave across variants; each row has the median, min and
        max."""
        plans = {}
        for vname, make in variants:
            def build(vname=vname, make=make):
                plan = make()
                plan(on_dev(x))
                plans[vname] = plan
            guard(f"{tag}/{vname}", build, k=k)
        times = {v: [] for v in plans}
        for _ in range(reps):
            for vname, plan in plans.items():
                times[vname].append(timer(plan.fn, on_dev(x), iters=iters))
        for vname, ts in times.items():
            med = float(np.median(ts))
            emit({"bench": f"{tag}/{vname}", "k": k, "nnz": nnz, "reps": reps,
                  "gflops": gflops(nnz, k, med), "gflops_min": gflops(nnz, k, max(ts)),
                  "gflops_max": gflops(nnz, k, min(ts)), "seconds_median": med,
                  "padding_rate": float(plans[vname].meta["padding_rate"])})

    # ---- layout head to head: the reference's interleaved brick-ELL layout
    # against column-sorted span chunks, on the same radix kernel
    for name in (wl_names if sel("layout") else ()):
        mat = workload(name)
        for k in ([8] if quick else [8, 32]):
            ab_rows(f"layout_h2h/{name}",
                    [(fam, lambda fam=fam, S=S, k=k, mat=mat: build_plan(mat, Schedule(
                        family=fam, sort=(fam == "brick_ell"), rb=1024, sublanes=S, g=512,
                        unroll=4, ktile=k), device=dev))
                     for fam, S in (("radix_span", 128), ("brick_ell", 256))],
                    rand((mat.shape[1], k), 0), k, mat.nnz)

    # ---- nested two-level against flat stripes
    if sel("nested"):
        mat_n = workload("uniform")
        ab_rows("nested_h2h/uniform",
                [(fam, lambda fam=fam: build_plan(
                    mat_n, Schedule(family=fam, work_per_block=4096, unroll=8), device=dev))
                 for fam in ("stripe_total", "stripe_nested")],
                rand((mat_n.shape[1], 8), 7), 8, mat_n.nnz)

    # ---- config #3: pruned-LLM unstructured weight, K = 512
    def pruned():
        w = builder.pruned_weight_coo(4096 if quick else 8192, 4096 if quick else 8192,
                                      sparsity=0.9, seed=7)
        k = 512
        res = tune(w, rand((w.shape[1], k), 1), iters=5, validate=False, device=dev)
        emit({"bench": "pruned_llm_90", "k": k, "nnz": w.nnz,
              "gflops": gflops(w.nnz, k, res.best_seconds), "seconds": res.best_seconds,
              "schedule": res.best_schedule.family, **tune_fields(res)})

    if sel("pruned"):
        guard("pruned_llm_90", pruned)

    # ---- a training step of the trainable layer (forward, SDDMM dv,
    # transpose dx), the SDDMM kernel alone, and the dense fp32 step
    if sel("trainable"):
        from tpusparse_torch.autodiff import spmm_trainable
        from tpusparse_torch.kernels import sddmm as sd
        from tpusparse_torch.nn import TrainableSparseLinear

        tm, tk = (2048 if quick else 4096), 256
        tw = builder.pruned_weight_coo(tm, tm, sparsity=0.9, seed=21)
        rngt = np.random.default_rng(22)
        xb = on_dev(rngt.standard_normal((tk, tm)))
        tt = on_dev(rngt.standard_normal((tk, tm)))

        def step():
            layer = TrainableSparseLinear(tw, bias=False, device=dev)

            def grad_step(x):
                x = x.detach().requires_grad_()
                loss = ((layer(x) - tt) ** 2).mean()
                gv, gx = torch.autograd.grad(loss, (layer.vals, x))
                return gv.sum() + gx.mean()  # both gradient kernels' outputs read

            grad_step(xb)
            sec = timer(grad_step, xb, iters=3)
            emit({"bench": "trainable_step_pruned90", "k": tk, "nnz": tw.nnz, "seconds": sec,
                  # one step = 3 SpMM-shaped passes (forward, dv, dx)
                  "gflops": 3 * gflops(tw.nnz, tk, sec)})

        def sddmm_alone():
            fn, _ = spmm_trainable(tw, device=dev)
            inv_slot = torch.as_tensor(sd.origrow_of_slot(fn.fmt), device=dev).long()
            dy_slots = sd.rows_to_slots(on_dev(rngt.standard_normal((tm, tk))), inv_slot)
            xs = on_dev(rngt.standard_normal((tm, tk)))
            sec = timer(lambda x: sd.span_sddmm(fn.fmt, dy_slots, x), xs, iters=5)
            emit({"bench": "sddmm_alone_pruned90", "k": tk, "nnz": tw.nnz,
                  "schedule": "span_onehot", "seconds": sec, "gflops": gflops(tw.nnz, tk, sec)})

        def dense_step():
            wd = on_dev(np.random.default_rng(23).standard_normal((tm, tm)))

            def grad_step(x):
                w = wd.detach().requires_grad_()
                x = x.detach().requires_grad_()
                loss = ((x @ w.T - tt) ** 2).mean()
                gw, gx = torch.autograd.grad(loss, (w, x))
                return gw.mean() + gx.mean()

            grad_step(xb)
            sec = timer(grad_step, xb, iters=3)
            emit({"bench": "trainable_step_dense_baseline", "k": tk, "m": tm, "seconds": sec,
                  # dense forward and backward: 3 fp32 products of 2 m m k
                  "dense_gflops": 3 * 2 * tm * tm * tk / sec / 1e9,
                  # the same step priced by the sparse FLOP count
                  "equiv_sparse_gflops": 3 * gflops(tw.nnz, tk, sec)})

        guard("trainable_step_pruned90", step)
        guard("sddmm_alone_pruned90", sddmm_alone)
        guard("trainable_step_dense_baseline", dense_step)

    # ---- config #4: N:M (2:4) structured, batched; block-sparse; int8
    m = 2048 if quick else 4096
    if sel("nm") or sel("quant"):
        dense = builder.nm_pruned_dense(m, m, n_keep=2, group=4, seed=5)
        xb4 = rand((4, m, 128), 2)
    if sel("nm"):
        def nm_row():
            from tpusparse_torch.batched import batched_spmm
            from tpusparse_torch.kernels.nm_structured import nm_spmm, pack_nm

            fmt = pack_nm(dense, device=dev)

            def fn(xx):
                return nm_spmm(fmt, xx, precision="bf16")

            y = batched_spmm(fn, on_dev(xb4))  # the batched path
            sec = timer(fn, on_dev(xb4[0]), iters=5)
            emit({"bench": "nm_2_4_batched", "k": 128, "nnz": fmt.nnz,
                  "gflops": gflops(fmt.nnz, 128, sec), "batched_shape": list(y.shape)})

        guard("nm_2_4_batched", nm_row)

    bell = {}
    if sel("block") or sel("quant"):
        def block_row():
            from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell

            bmat = builder.block_sparse_coo(m, m, block=128, block_density=0.15, seed=6)
            bfmt = pack_block_ell(bmat, bs=128, dtype=torch.bfloat16, device=dev)
            xB = on_dev(rand((m, 256), 3))

            def bfn(xx):  # the Block-ELL kernel (#13)
                return block_ell_spmm(bfmt, xx, precision="bf16", method="pallas")

            bsec = timer(bfn, xB, iters=5)
            bell.update(mat=bmat, x=xB, sec=bsec)
            if sel("block"):
                emit({"bench": "block_sparse_128", "k": 256, "nnz": bmat.nnz,
                      "gflops": gflops(bmat.nnz, 256, bsec), "padding_rate": bfmt.padding_rate})

        guard("block_sparse_128", block_row)

    if sel("quant") and bell:
        def quant_rows():
            from tpusparse_torch.kernels.block_ell import block_ell_spmm, pack_block_ell
            from tpusparse_torch.kernels.nm_structured import nm_spmm, pack_nm

            bmat, xB = bell["mat"], bell["x"]
            qfmt = pack_block_ell(bmat, bs=128, dtype=torch.int8, device=dev)
            qsec = timer(lambda xx: block_ell_spmm(qfmt, xx), xB, iters=5)
            emit({"bench": "block_sparse_128_int8", "k": 256, "nnz": bmat.nnz,
                  "gflops": gflops(bmat.nnz, 256, qsec), "vs_bf16": bell["sec"] / qsec,
                  "format_bytes": qfmt.memory_bytes})
            nm8 = pack_nm(dense, dtype=torch.int8, device=dev)
            nsec = timer(lambda xx: nm_spmm(nm8, xx, precision="int8"), on_dev(xb4[0]), iters=5)
            emit({"bench": "nm_2_4_int8_w8a16", "k": 128, "nnz": nm8.nnz,
                  "gflops": gflops(nm8.nnz, 128, nsec), "format_bytes": nm8.memory_bytes})

        guard("quantized", quant_rows)

    # ---- SpMV (K = 1) at a scale where the launch does not dominate
    if sel("spmv"):
        from tpusparse_torch.spmv import spmv_fn, spmv_multi_fn

        mv_n = 65536 if quick else 262144
        mv = builder.power_law_coo(mv_n, mv_n, avg_nnz_per_row=40.0, seed=9)
        xv = on_dev(rand(mv.shape[1], 4))

        def multi_row(mmat, tag, col_split=None):
            nv = 8
            xm = on_dev(rand((mmat.shape[1], nv), 6))
            mfn = spmv_multi_fn(mmat, n_vectors=nv, col_split=col_split, device=dev)
            msec = timer(mfn, xm, iters=10)
            emit({"bench": f"spmv_multi/dgt_k8{tag}", "k": nv, "nnz": mmat.nnz,
                  "n": mmat.shape[1], "col_split": getattr(mfn, "n_splits", 1),
                  # nv vectors' worth of nonzeros a second, and one call's
                  "gnnz_per_s_aggregate": nv * mmat.nnz / msec / 1e9,
                  "gnnz_per_s_call": mmat.nnz / msec / 1e9})

        def multi_rows():
            multi_row(mv, "")
            if not quick:
                multi_row(mv, "_nosplit", col_split=1)
                multi_row(builder.power_law_coo(65536, 65536, avg_nnz_per_row=40.0, seed=9),
                          "_65k")

        guard("spmv_multi/dgt_k8", multi_rows)

        def method_row(method):
            vfn = spmv_fn(mv, method=method, device=dev)
            sec = timer(vfn, xv, iters=10)
            emit({"bench": f"spmv_powerlaw/{method}", "k": 1, "nnz": mv.nnz,
                  "gflops": gflops(mv.nnz, 1, sec), "gnnz_per_s": mv.nnz / sec / 1e9,
                  # the row walk's 16 B a nonzero
                  "pct_roofline": pct_roofline(16 * mv.nnz, mv.shape[0], mv.shape[1], 1, sec)})

        for method in ("dg", "dgt8", "radix", "span"):
            guard(f"spmv_powerlaw/{method}", lambda method=method: method_row(method), k=1)

        def small_segment():
            mvs = workload("powerlaw")
            vfn = spmv_fn(mvs, method="segment", device=dev)
            sec = timer(vfn, on_dev(rand(mvs.shape[1], 5)), iters=10)
            emit({"bench": "spmv_small/segment", "k": 1, "nnz": mvs.nnz,
                  "gnnz_per_s": mvs.nnz / sec / 1e9})

        guard("spmv_small/segment", small_segment)

    # ---- graph algorithms through the packed matvec plan
    def graph_rows():
        from tpusparse_torch import graph

        gm = builder.power_law_coo(size, size, avg_nnz_per_row=16.0, seed=11)
        xg = on_dev(rand(size, 8))
        for tag, g in (("graph_matvec", gm),
                       ("graph_matvec_large",
                        builder.power_law_coo(size, size, avg_nnz_per_row=64.0, seed=14))):
            fn = graph.matvec_plan(g, semiring="plus_times", device=dev)
            sec = timer(fn, xg, iters=10)
            emit({"bench": f"{tag}/plus_times", "nnz": g.nnz, "method": fn.meta["method"],
                  "gnnz_per_s": g.nnz / sec / 1e9})
        pr_run = graph.pagerank_fn(gm, tol=0.0, max_iter=20, device=dev)
        r, _ = pr_run()
        r0 = torch.full((size,), 1.0 / size, dtype=torch.float32, device=dev)
        pr_sec = timer(lambda v: pr_run(v)[0], r0, iters=3)
        emit({"bench": "graph_pagerank", "nnz": gm.nnz, "iters": 20, "seconds": pr_sec,
              "g_edges_per_s": 20 * gm.nnz / pr_sec / 1e9, "checksum": float(r.sum())})
        bfs_run = graph.bfs_fn(gm, max_iter=32, device=dev)
        lv, _ = bfs_run(0)
        bfs_sec = timer(lambda s: bfs_run(s)[0], 0, iters=3)
        emit({"bench": "graph_bfs", "nnz": gm.nnz, "seconds": bfs_sec,
              "reached": int((lv >= 0).sum())})

    if sel("graph"):
        guard("graph", graph_rows)

    # ---- SpGEMM through the reusable runner (the port's measured crossover)
    def spgemm_rows():
        import scipy.sparse as sp

        from tpusparse_torch.spgemm import HOST_CROSSOVER_FLOPS, spgemm_flops, spgemm_fn

        def scipy_csr(a):
            return sp.coo_matrix((a.vals, (a.rows, a.cols)), shape=a.shape).tocsr()

        def wall(fn):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out, time.perf_counter() - t0

        sa = builder.power_law_coo(4096, 4096, avg_nnz_per_row=8.0, seed=12)
        sb = builder.power_law_coo(4096, 4096, avg_nnz_per_row=8.0, seed=13)
        run, sg_cold = wall(lambda: spgemm_fn(sa, device=dev))  # A packed once
        _, first = wall(lambda: run(sb))
        c1, sg_sec = wall(lambda: run(sb))
        flops = spgemm_flops(sa, sb)
        sa_s, sb_s = scipy_csr(sa), scipy_csr(sb)
        _, sp_sec = wall(lambda: [sa_s @ sb_s for _ in range(5)])
        sp_sec /= 5
        emit({"bench": "spgemm_powerlaw_4k", "nnz_a": sa.nnz, "nnz_b": sb.nnz, "nnz_c": c1.nnz,
              "seconds": sg_sec, "seconds_cold": sg_cold + first, "seconds_scipy": sp_sec,
              "gflops": flops / sg_sec / 1e9, "gflops_scipy": flops / sp_sec / 1e9,
              "route": "host" if flops < HOST_CROSSOVER_FLOPS else "device"})
        if not quick:
            # a large, denser product: the device's dense-tile work does not
            # grow with B's density
            sa2 = builder.power_law_coo(16384, 16384, avg_nnz_per_row=128.0, seed=14)
            sb2 = builder.power_law_coo(16384, 16384, avg_nnz_per_row=256.0, seed=15)
            run2 = spgemm_fn(sa2, device=dev)
            run2(sb2)
            c2, dev2 = wall(lambda: run2(sb2))
            sa2_s, sb2_s = scipy_csr(sa2), scipy_csr(sb2)
            _, sp2 = wall(lambda: sa2_s @ sb2_s)
            flops2 = spgemm_flops(sa2, sb2)
            emit({"bench": "spgemm_powerlaw_16k_dense", "nnz_a": sa2.nnz, "nnz_b": sb2.nnz,
                  "nnz_c": c2.nnz, "seconds": dev2, "seconds_scipy": sp2,
                  "gflops": flops2 / dev2 / 1e9, "gflops_scipy": flops2 / sp2 / 1e9,
                  "device_vs_scipy": sp2 / dev2})

    if sel("spgemm"):
        guard("spgemm_powerlaw_4k", spgemm_rows)

    # ---- matrices from data on disk: the Python sources beside the
    # interpreter, and any .mtx files already in $TPUSPARSE_REAL_MTX_DIR
    if sel("real"):
        from tpusparse_torch.io import read_mtx, realdata

        real_mats = []
        mdir = os.environ.get("TPUSPARSE_REAL_MTX_DIR")
        if mdir and os.path.isdir(mdir):
            for root, _, files in os.walk(mdir):
                for f in sorted(files):
                    if f.endswith(".mtx"):
                        p = os.path.join(root, f)
                        real_mats.append((f[:-4], lambda p=p: read_mtx(p)))
        real_mats += [
            ("real/cooc_pysrc", lambda: realdata.cooccurrence_coo(
                vocab_size=8192 if quick else 32768, max_files=300 if quick else 2500)),
            ("real/docterm_pysrc", lambda: realdata.docterm_coo(
                vocab_size=8192 if quick else 32768, max_files=1000 if quick else 8000)),
            ("real/imports_pysrc", lambda: realdata.import_graph_coo(
                max_files=2000 if quick else 30000)),
        ]

        def real_row(name, make):
            mat = make()
            for k in ([8] if quick else [8, 32]):
                res = tune(mat, rand((mat.shape[1], k), 0), iters=5, validate=True, budget=10,
                           device=dev)
                emit({"bench": name, "k": k, "shape": list(mat.shape), "nnz": mat.nnz,
                      "gflops": gflops(mat.nnz, k, res.best_seconds),
                      "schedule": res.best_schedule.family,
                      "pct_roofline": pct_roofline(plan_bytes(res.best), mat.shape[0],
                                                   mat.shape[1], k, res.best_seconds),
                      **tune_fields(res)})

        for name, make in real_mats:
            guard(name, lambda name=name, make=make: real_row(name, make))

        def trained_row():
            w, meta = realdata.trained_pruned_weight(steps=60 if quick else 300, device=dev)
            k = 512
            res = tune(w, rand((w.shape[1], k), 2), iters=5, validate=True, budget=10,
                       device=dev)
            emit({"bench": "real/trained_pruned_ffn", "k": k, "shape": list(w.shape),
                  "nnz": w.nnz, "train_meta": meta,
                  "gflops": gflops(w.nnz, k, res.best_seconds),
                  "schedule": res.best_schedule.family, **tune_fields(res)})

        guard("real/trained_pruned_ffn", trained_row)

    return rows


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpusparse_torch.bench.suite")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None, help=f"one section: {', '.join(TAGS)}")
    ap.add_argument("--out", default=None,
                    help="JSON lines to append to (default: BENCH_SUITE.jsonl under the config "
                         "cache_dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _check_only(args.only)
    rows = run_suite(quick=args.quick, out_path=args.out, only=args.only, device=args.device)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
