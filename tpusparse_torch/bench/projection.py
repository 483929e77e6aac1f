"""Multi-card scaling projection from one card (counterpart of
``tpusparse/bench/projection.py``; BASELINE.md config #5).

The card machine holds one H100, so a ring across cards cannot be timed
there.  This is a labelled model built from what one card can measure:

  T_bucket(d)  the card's time for one (rank, ring chunk) bucket of the
               dgt halo ring at d ranks (kernel #3 over the bucket's row
               walk, ``bench/harness.py::time_fn``, guarded): the step's
               compute.  Every bucket of a pack has the same [P, NC, G]
               planes and the deal balances their nonzeros, so one
               bucket stands for every step.
  T1           the d = 1 ring pack's one bucket: the same kernel and
               geometry, the efficiency's denominator.
  STEP_LAT     the shift of one X chunk between two ranks of one card
               through ``LocalRing`` (a side-stream copy and its event
               wait) replayed in a CUDA graph, measured here: a lower
               bound for an NCCL send/recv across cards, which adds its
               own launch and protocol (the shift as issued from Python,
               the host included, is reported beside it).

and one bracket of link rates, NVIDIA's published figures, not measured
here (``LINK_GBS``): PCIe Gen5 x16, 64 GB/s a direction, and NVLink 4 on
H100 SXM, 450 GB/s a direction.

Ring model (dist/overlap._build_ring): d steps; at each step a rank runs
one bucket while its X chunk ((n/d) * kt * 4 bytes) moves on:

  T(d)   = d * max(T_bucket(d), chunk_bytes / link + STEP_LAT)
  eff(d) = T1 / (d * T(d))

The same bucket harness times the two dgt packs, scatter='select'
(resid=True) against 'fullrow' (resid=False), on the ring's buckets.  A
bucket this small is host-bound in ``time_fn``, so each projection row
also gives the model on the kernels' device times (profiler).

Run on the card: python -m tpusparse_torch.bench.projection [--quick]
[--out path.json]
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

#: NVIDIA's published link rates a direction, GB/s (not measured here)
LINK_GBS = {"pcie_gen5_x16": 64.0, "nvlink4_h100_sxm": 450.0}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bucket_runner(fmt, x_chunk, *, rank: int = 0, chunk: int = 0, scatter: str = "select"):
    """``run(x) -> y_rows``: one (rank, chunk) bucket of a HaloDgtFormat on
    X's card, its row walk built once here, and the walk (for its bytes)."""
    from tpusparse_torch.kernels import dgt_gather as dgt

    assert scatter in ("select", "fullrow"), scatter
    dev = x_chunk.device
    planes = tuple(a[rank, chunk].to(dev).contiguous()
                   for a in (fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p))
    walk = dgt.build_dgt_walk(*planes, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode, resid=fmt.resid,
                              n=x_chunk.shape[0])

    def run(x):
        return dgt.dgt_rows_cuda(*planes, x, rb=fmt.rb, kt=fmt.kt, mode=fmt.mode,
                                 resid=fmt.resid, walk=walk)

    run.walk = walk
    return run


def time_ring_bucket(fmt, x_chunk, *, scatter: str, unroll: int = 8, device: int = 0,
                     chunk: int = 0, reps: int = 3) -> dict:
    """Seconds for one (rank ``device``, ring chunk) bucket kernel of a
    HaloDgtFormat on the card, X chunk [n_x, kt] on it: the median of
    ``reps`` ``time_fn`` readings at or above a physical floor (the walk's
    bytes and X's rows read once at the card's published stream; a reading
    below it is a timing misfire, discarded as the JAX harness discards
    them), and the device time beside it: the profiler's, or where it
    drops records in every window a CUDA graph's replay (``device_how``).
    ``unroll`` steered the TPU kernel and changes nothing."""
    from tpusparse_torch.bench.harness import device_time_fn, graph_time_fn, time_fn
    from tpusparse_torch.bench.sol import HBM_BYTES_PER_S

    del unroll
    run = bucket_runner(fmt, x_chunk, rank=device, chunk=chunk, scatter=scatter)
    lo = (run.walk.nbytes + run.walk.n_slots * 4 * fmt.kt) / HBM_BYTES_PER_S
    vals = []
    for _ in range(2 * reps):
        sec = time_fn(run, x_chunk, iters=64)
        if sec >= lo:
            vals.append(sec)
            if len(vals) >= reps:
                break
        else:
            _log(f"bucket timing misfire ({sec * 1e6:.2f} us < floor {lo * 1e6:.2f} us): "
                 "discarded")
    if not vals:
        raise RuntimeError(f"all bucket timings below the {lo * 1e6:.2f} us floor")
    try:
        dev_s, how = device_time_fn(run, x_chunk), "profiler"
    except RuntimeError:  # the profiler dropped records in every window
        dev_s, how = graph_time_fn(run, x_chunk), "graph"
    return {"seconds": float(np.median(vals)), "device_seconds": dev_s, "device_how": how,
            "floor_seconds": lo, "live_slots": run.walk.n_slots}


def measure_shift_us(n_rows: int, k: int, device="cuda", iters: int = 50) -> dict:
    """Microseconds for one ring shift of an X chunk [n_rows, k] fp32
    between two ranks of one card through ``LocalRing``: its side-stream
    copy and the compute stream's wait on its event.  ``graph_us``: the
    shift with the host out of the way, ``iters`` shifts captured into one
    CUDA graph and replayed between CUDA events (the card's own latency, a
    lower bound for an NCCL send/recv); ``eager_us``: one shift as issued
    from Python (begin, start, wait) between CUDA events on the compute
    stream, the host's issue time included (median of ``iters``)."""
    import torch

    from tpusparse_torch.dist import make_mesh
    from tpusparse_torch.dist.overlap import LocalRing

    ring = LocalRing(make_mesh(2, 1, [device] * 2))
    dev = ring.out_device
    bufs = {q: tuple(torch.zeros((n_rows, k), device=dev) for _ in range(3)) for q in ring.ranks}

    def shift():
        ring.begin(bufs)
        ring.wait(ring.start(0, bufs))

    stream = torch.cuda.current_stream(dev)
    times = []
    for _ in range(iters + 5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(stream)
        shift()
        e.record(stream)
        times.append((s, e))
    torch.cuda.synchronize(dev)
    eager = float(np.median([s.elapsed_time(e) * 1e3 for s, e in times[5:]]))

    side = torch.cuda.Stream(dev)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        shift()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            shift()
    graph.replay()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(stream)
    graph.replay()
    e.record(stream)
    torch.cuda.synchronize(dev)
    return {"graph_us": s.elapsed_time(e) * 1e3 / iters, "eager_us": eager}


def project(d: int, t_bucket_s: float, t1_s: float, n: int, kt: int, link_gbs: float,
            step_lat_us: float) -> dict:
    """The ring model: T(d) = d * max(compute, comm), eff = T1 / (d * T(d));
    ``link_gbs`` the assumed link rate a direction, ``step_lat_us`` the
    shift's fixed cost."""
    chunk_bytes = (n // d) * kt * 4
    t_comm = chunk_bytes / (link_gbs * 1e9) + step_lat_us * 1e-6
    t_step = max(t_bucket_s, t_comm)
    t_total = d * t_step
    return {
        "devices": d,
        "link_gbs_assumed": link_gbs,
        "step_lat_us": round(step_lat_us, 2),
        "t_bucket_us": round(t_bucket_s * 1e6, 2),
        "t_comm_us": round(t_comm * 1e6, 2),
        "bound": "compute" if t_bucket_s >= t_comm else "comm",
        "t_total_us": round(t_total * 1e6, 2),
        "projected_efficiency": round(t1_s / (d * t_total), 4),
        "projected_speedup": round(t1_s / t_total, 3),
    }


def run(quick: bool = False, m: int = 32768, avg: float = 32.0, label: str = "powerlaw32k",
        device="cuda", probe: bool = True) -> dict:
    """The ring-bucket A/B and the projection at config #1 (power law
    m x m, avg ``avg``, alpha 1.8, seed 42, kt 8) for d = 2, 4, 8 (8 alone
    with ``quick``), on the card; ``probe`` runs the session probe first.
    Prints the card's name and power limit beside the numbers."""
    import torch

    from tpusparse_torch.bench.harness import time_fn
    from tpusparse_torch.dist.overlap import pack_halo_dgt
    from tpusparse_torch.io import builder
    from tpusparse_torch.kernels.dgt_gather import dgt_spmm, pack_dgt

    power = power_line()
    _log(f"card: {power}")
    probe_row = None
    if probe:
        from tpusparse_torch.bench.microbench import session_probe

        probe_row = session_probe(device)
        _log(f"probe: {probe_row}  ({power})")
    n, kt = m, 8
    mat = builder.power_law_coo(m, n, avg_nnz_per_row=avg, alpha=1.8, seed=42)
    x = np.random.default_rng(0).standard_normal((n, kt)).astype(np.float32)
    dev = torch.device(device)
    xd = torch.as_tensor(x, device=dev)

    # the single-card dgt plan (another geometry: context only, not the
    # efficiency's denominator)
    fmt1 = pack_dgt(mat, rb=512, g=512, kt=kt, nw=8, resid=True, walk="multi", device=dev)
    t1_spmm = time_fn(lambda xv: dgt_spmm(fmt1, xv, unroll=8), xd, iters=16)
    _log(f"single-card dgt_spmm: {t1_spmm * 1e3:.4f} ms (pad {fmt1.padding_rate:.2f})  "
         f"({power})")

    def chunk_of(fmt):
        return torch.as_tensor(np.pad(x, ((0, fmt.n_chunk_rows * fmt.n_devices - n), (0, 0)))
                               [:fmt.n_chunk_rows], device=dev).contiguous()

    fmt_1 = pack_halo_dgt(mat, 1, rows_per_program=512, g=256, kt=kt, resid=True, nw=8,
                          walk="multi", device="cpu")
    b1 = time_ring_bucket(fmt_1, chunk_of(fmt_1), scatter="select")
    t1 = b1["seconds"]
    _log(f"T1 (d=1 ring bucket, select): {t1 * 1e6:.2f} us, device {b1['device_seconds'] * 1e6:.2f}"
         f" us (pad {fmt_1.padding_rate:.3f})  ({power})")

    out_rows, ab_rows, shifts = [], [], {}
    for d in ((8,) if quick else (2, 4, 8)):
        tbs, tb_dev = {}, {}
        for resid, scatter in ((False, "fullrow"), (True, "select")):
            fmt = pack_halo_dgt(mat, d, rows_per_program=512, g=256, kt=kt, resid=resid, nw=8,
                                walk="multi", device="cpu")
            b = time_ring_bucket(fmt, chunk_of(fmt), scatter=scatter)
            ab_rows.append({"metric": "ring_bucket_ab", "devices": d, "scatter": scatter,
                            "resid": resid, "t_bucket_us": round(b["seconds"] * 1e6, 2),
                            "t_bucket_device_us": round(b["device_seconds"] * 1e6, 2),
                            "live_slots": b["live_slots"],
                            "padding_rate": round(fmt.padding_rate, 3)})
            _log(ab_rows[-1], f"({power})")
            tbs[scatter], tb_dev[scatter] = b["seconds"], b["device_seconds"]
        best = min(tbs, key=tbs.get)
        shifts[d] = measure_shift_us((n // d), kt, device=dev)
        _log(f"shift of one chunk ({n // d} x {kt} fp32) through LocalRing: "
             f"{shifts[d]['graph_us']:.2f} us in a CUDA graph (a lower bound for NCCL), "
             f"{shifts[d]['eager_us']:.2f} us issued from Python  ({power})")
        for name, gbs in LINK_GBS.items():
            row = project(d, tbs[best], t1, n, kt, gbs, shifts[d]["graph_us"])
            # the same model on the kernels' device times (the host out of the way)
            dev_row = project(d, tb_dev[best], b1["device_seconds"], n, kt, gbs,
                              shifts[d]["graph_us"])
            row.update(scatter=best, link=name, t_bucket_device_us=dev_row["t_bucket_us"],
                       bound_device_times=dev_row["bound"],
                       projected_efficiency_device_times=dev_row["projected_efficiency"])
            out_rows.append(row)
            _log(row)
    return {"card": power,
            "workload": {"label": label, "m": m, "avg_nnz_per_row": avg, "nnz": mat.nnz},
            "probe": None if probe_row is None else {
                k: probe_row.get(k) for k in ("stream_gbs", "mxu_tflops", "fp32_tflops")},
            "link_gbs": {"published, not measured": LINK_GBS},
            "t1_d1_ring_bucket_us": round(t1 * 1e6, 2),
            "t1_single_card_dgt_spmm_us": round(t1_spmm * 1e6, 2),
            "shift_us_lower_bound_for_nccl": {str(d): round(v["graph_us"], 2)
                                              for d, v in shifts.items()},
            "shift_us_issued_from_python": {str(d): round(v["eager_us"], 2)
                                            for d, v in shifts.items()},
            "ring_bucket_ab": ab_rows,
            "projection": out_rows}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="the multi-card projection from one card")
    ap.add_argument("--quick", action="store_true", help="d = 8 only")
    ap.add_argument("--big", action="store_true", help="65536^2 avg-40 workload")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default=None, help="write the result there as JSON")
    args = ap.parse_args(argv)
    kw = dict(m=65536, avg=40.0, label="powerlaw65k") if args.big else {}
    res = run(quick=args.quick, probe=not args.no_probe, **kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"card": res["card"], "projection": res["projection"],
                      "ring_bucket_ab": res["ring_bucket_ab"]}))


if __name__ == "__main__":
    main()
