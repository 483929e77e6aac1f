"""Where one call of a halo ring spends the card's time, and whether its
shifts overlap its kernels (used by ``chip_smoke.py`` phase D3 and the
card tests).

``ring_overlap(fn, args, kernels=...)`` profiles one call ``fn(*args)``
(``torch.profiler``, CUPTI), reads the Chrome trace, and returns:

  busy_us        the union of the call's device intervals (kernels,
                 copies, fills)
  kernel_us      the ring's bucket kernels' summed time
  shift_us       the shifts' summed time: the copies issued inside the
                 ring's ``ring_shift`` profiler spans (``dist.overlap.
                 SHIFT_SPAN``), told by their correlation ids
  overlap_share  the share of shift_us that runs while a kernel runs on
                 another stream
  kernel_streams, shift_streams   the streams they ran on
  syncs_inside   host calls that wait on the card (stream, event or device
                 synchronize, a blocking copy) issued between the launch
                 of the ring's first bucket kernel and its last

and raises when the trace holds fewer bucket kernels than ``expect``
in three tries (the profiler may drop records).
"""

from __future__ import annotations

import json
import os
import tempfile

from tpusparse_torch.dist.overlap import SHIFT_SPAN

#: host calls that wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
              "cuEventSynchronize")


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _overlap_us(a: float, b: float, intervals) -> float:
    return _union_us([(max(a, x), min(b, y)) for x, y in intervals if min(b, y) > max(a, x)])


def _trace(fn, args) -> list:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ring.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def ring_overlap(fn, args, *, kernels=("walk_kernel", "stripe_kernel"), expect: int = 1,
                 shifts: int | None = None, warmup: int = 2) -> dict:
    """The profile of one call ``fn(*args)`` of a ring whose bucket kernels'
    names hold one of ``kernels`` (``analyse_ring_trace``); ``expect``: the
    bucket launches a call makes (D * n_k * D), ``TRIES`` tries to see them
    all (the profiler may drop records); ``shifts``: the shifts it makes (D
    * n_k * (D - 1)), checked where given."""
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(TRIES):
        events = _trace(fn, args)
        if len(_bucket_kernels(events, kernels)) >= expect:
            return analyse_ring_trace(events, kernels=kernels, shifts=shifts)
    raise RuntimeError(f"the profiler saw fewer than {expect} bucket kernels in {TRIES} "
                       "tries: not measured")


#: profiled calls ``ring_overlap`` takes to see every bucket kernel of one
#: (a smoke run on the card saw three in a row drop records)
TRIES = 6


def _device_events(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _bucket_kernels(events, kernels):
    return [e for e in _device_events(events)
            if e["cat"] == "kernel" and any(k in e["name"] for k in kernels)]


def analyse_ring_trace(events, *, kernels=("walk_kernel", "stripe_kernel"),
                       shifts: int | None = None) -> dict:
    """``ring_overlap``'s numbers from a Chrome trace's ``traceEvents``."""
    dev = _device_events(events)
    ring = _bucket_kernels(events, kernels)
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))  # noqa: E731
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    spans = [iv(e) for e in events if e.get("ph") == "X" and e.get("name") == SHIFT_SPAN
             and e.get("cat") == "user_annotation"]
    in_span = {e["args"].get("correlation") for e in host
               if any(a <= float(e["ts"]) <= b for a, b in spans)}
    copies = [e for e in dev if e["cat"] == "gpu_memcpy"
              and e["args"].get("correlation") in in_span]
    if shifts is not None and len(copies) != shifts:
        raise AssertionError(f"the trace holds {len(copies)} shifts, the ring makes {shifts}")
    all_kernels = [e for e in dev if e["cat"] == "kernel"]
    overlap = sum(_overlap_us(*iv(c), [iv(k) for k in all_kernels
                                       if k["args"].get("stream") != c["args"].get("stream")])
                  for c in copies)
    shift_us = sum(float(e["dur"]) for e in copies)

    # host side: the launches of the first and last bucket kernel, by
    # correlation id, and any waiting call between them
    corr = {e["args"].get("correlation") for e in ring}
    launches = sorted(float(e["ts"]) for e in host if e["args"].get("correlation") in corr)
    syncs = []
    if launches:
        lo, hi = launches[0], launches[-1]
        syncs = [e["name"] for e in host if e["name"] in SYNC_CALLS and lo < float(e["ts"]) < hi]
    return {"busy_us": _union_us([iv(e) for e in dev]),
            "kernel_us": sum(float(e["dur"]) for e in ring), "n_kernels": len(ring),
            "shift_us": shift_us, "n_shifts": len(copies),
            "overlap_share": overlap / shift_us if shift_us else 0.0,
            "kernel_streams": sorted({e["args"].get("stream") for e in ring}),
            "shift_streams": sorted({e["args"].get("stream") for e in copies}),
            "syncs_inside": syncs}


def ring_graph(fn, args, *, shifts: int, iters: int = 20) -> dict:
    """One call ``fn(*args)`` of a ring captured into a CUDA graph and
    replayed, so that the host issues nothing between its kernels and
    copies: ``graph_ms`` (CUDA events over ``iters`` replays, a call),
    and from one profiled replay ``graph_busy_us``, ``graph_shift_us`` and
    ``graph_overlap_share`` (the share of the shifts' time that runs while
    any kernel runs: a replay's records carry the graph's launch stream,
    so overlap is read in time alone).  The replay's device-to-device
    copies are taken as the shifts; where their count is not ``shifts``,
    the overlap is reported as not measured (None)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    out = {"graph_ms": start.elapsed_time(end) / iters}
    dev = _device_events(_trace(graph.replay, ()))
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))  # noqa: E731
    copies = [e for e in dev if e["cat"] == "gpu_memcpy" and "DtoD" in e["name"]]
    kernels = [iv(e) for e in dev if e["cat"] == "kernel"]
    out["graph_busy_us"] = _union_us([iv(e) for e in dev])
    if len(copies) != shifts:
        out.update(graph_shift_us=None, graph_overlap_share=None,
                   graph_note=f"{len(copies)} copies in the replay, the ring makes {shifts}")
        return out
    shift_us = sum(float(e["dur"]) for e in copies)
    out["graph_shift_us"] = shift_us
    out["graph_overlap_share"] = (sum(_overlap_us(*iv(c), kernels) for c in copies) / shift_us
                                  if shift_us else 0.0)
    return out


def check_ring_overlap(prof: dict, name: str) -> None:
    """Raises where a shift ran on a bucket kernel's stream or the host
    waited on the card inside the ring."""
    if set(prof["shift_streams"]) & set(prof["kernel_streams"]):
        raise AssertionError(f"{name}: a shift ran on the kernels' stream "
                             f"({prof['shift_streams']} vs {prof['kernel_streams']})")
    if prof["syncs_inside"]:
        raise AssertionError(f"{name}: the host waited on the card inside the ring: "
                             f"{prof['syncs_inside']}")
