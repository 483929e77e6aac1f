"""Autotuner (counterpart of ``tpusparse/tune.py``, reference L6 driver).

As in the reference (token_test.cc:1625-1847): enumerate Schedule
candidates, check each against the oracle, time it, keep the min, cache the
winner per matrix signature under the config cache_dir, and append every
measurement to results.jsonl.  Candidates are the JAX package's list in
its order, every family included; a cached winner of a family this
package does not know is dropped.  Candidates that differ only
in knobs of the TPU kernels' code (``Schedule.plan_key``) are one plan on
the card: it is packed and timed once, and each such row carries that
measurement and ``same_plan_as``.
On the card each candidate is timed with CUDA events; on the CPU (the
tests) with the host clock, and its rows say so.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from tpusparse_torch.bench.harness import gflops, time_fn, time_fn_host
from tpusparse_torch.config import get_config
from tpusparse_torch.gates import CARD_GATES, Gates
from tpusparse_torch.generator import SpmmPlan
from tpusparse_torch.format import SegmentFormat, StripeFormat
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import resolve_device
from tpusparse_torch.kernels.dg_gather import DgFormat, choose_kt_dg
from tpusparse_torch.kernels.dgt_gather import DgtFormat, auto_rb_dgt, dgt_geometry
from tpusparse_torch.kernels.nnz_split import SegmentSpanFormat
from tpusparse_torch.kernels.radix_gather import RadixFormat, choose_kt
from tpusparse_torch.kernels.row_walk import WALK_SLOT_BYTES
from tpusparse_torch.kernels.span_gather import SpanFormat
from tpusparse_torch.oracle import check_result, spmm_reference
from tpusparse_torch.schedule import (COLSPLIT_RANGE_BYTES, KERNEL_FAMILIES, CandidateRejected,
                                      Schedule, build_plan)


def matrix_signature(mat: CooMatrix) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(mat.shape, dtype=np.int64).tobytes())
    h.update(np.int64(mat.nnz).tobytes())
    h.update(np.ascontiguousarray(mat.rows[:4096]).tobytes())
    h.update(np.ascontiguousarray(mat.cols[:4096]).tobytes())
    return h.hexdigest()[:16]


def matrix_digest(mat: CooMatrix) -> str:
    """A hash of the whole matrix: its shape, every index and every value
    (one O(nnz) pass).  It keys what holds the matrix's values (SpGEMM's
    runners, the tune's saved formats), where ``matrix_signature``, which
    reads only the shape, the nnz and the first 4096 entries, keys the
    tuned schedule."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(mat.shape, dtype=np.int64).tobytes())
    for a in (mat.rows, mat.cols, mat.vals):
        a = np.ascontiguousarray(a)
        h.update(a.dtype.str.encode())
        h.update(a)
    return h.hexdigest()


def _span_configs(density: float) -> list[tuple[int, int, int]]:
    """Density-adaptive (rb, ct, g) for the span family
    (tpusparse/tune.py:39): a G-chunk of column-sorted nz spans about
    G/(density*RB) columns, so the window needs CT*RB ~ 1.3*G/density; the
    TPU's one-hot cost (CT+RB) put both near the square root.  TPU-derived
    and kept so both packages time the same points."""
    density = max(density, 1e-8)

    def pow2(v, lo, hi, up=False):
        f = math.ceil if up else round
        return int(min(max(2 ** f(math.log2(max(v, 1))), lo), hi))

    out = []
    for g in (512, 256):
        prod = min(max(1.3 * g / density, 512 * 512), 2048 * 4096)
        side = prod ** 0.5
        rb = pow2(side, 256, 2048)
        ct = pow2(prod / rb, 256, 4096, up=True)  # the window must cover the span
        for cand in ((rb, ct, g), (max(rb // 2, 256), ct, g)):
            if cand not in out:
                out.append(cand)
    return out[:4]


def _radix_configs(density: float, kt: int) -> list[tuple[int, int, int]]:
    """(rb, S, g) for the radix family (tpusparse/tune.py:64): the window
    W = S*spr should just hold a G-chunk's column span, about
    g/(density*rb); S capped to [32, 512].  TPU-derived (spr is the fp32x2
    lane packing's) and kept so both packages time the same points."""
    spr = 64 // kt
    density = max(density, 1e-8)
    out = []
    cfgs = (((2048, 1024), (1024, 1024), (1024, 512)) if kt <= 2
            else ((1024, 1024), (1024, 512), (768, 512)))
    for rb, g in cfgs:
        W = min(max(1.0 * g / (density * rb), 256), 64 * 1024)
        S = int(min(max(2 ** round(math.log2(max(W / spr, 1))), 32), 512))
        if (rb, S, g) not in out:
            out.append((rb, S, g))
    return out[:3]


def default_candidates(mat: CooMatrix, k: int, *, full: bool = False,
                       gates: Gates = CARD_GATES) -> list[Schedule]:
    """The JAX package's candidate list (tpusparse/tune.py:90-313), block
    for block in its order: dg's density-sized (rb, ns, g) points (with
    ``full`` the wider grid, unrolls and bf16); dgt's points; radix's
    (rb, S, g) points at kt and, past kt = 8, at 8 too, with ``full`` the
    wider grid, unrolls and bf16, and the ``brick_ell`` row (K <= 32, or
    ``full``);
    the span points (``span_onehot`` where X passes the gate, else
    ``span_colsplit``) at K <= 128; the three tile points; the stripe rows
    (merge path at two work budgets; with ``full`` four, balanced, fixed
    rows and ``stripe_nested``); and on a skewed matrix (longest row past
    32x the mean) or with ``full`` the ``segment_span``, ``nnz_segment``
    and ``bucketed`` rows; where the top 128 columns hold a large share of
    the nonzeros (or with ``full``) the ``hybrid_cols`` rows at panel widths
    2048, 512 and N/8, bf16 first, ranked ahead of everything past a 0.6
    share; the ``dense`` row (A's bf16 copy within 4 GB, and density past
    2 % or K >= 256); and the ``block_ell`` row where the 128-blocks are
    more than a quarter full.  The X-size gates are read from ``gates``:
    under ``TPU_GATES`` the JAX package's (6 MB of the v5e's VMEM), the
    list equal to its own; under ``CARD_GATES`` (the default) none binds,
    so a wide matrix keeps the dg, dgt and radix rows and takes the
    ``span_onehot`` rows in place of ``span_colsplit``.  At config #1 both
    give the same 25 rows."""
    lengths = mat.row_lengths()
    max_len = int(lengths.max()) if lengths.size else 0
    avg_len = float(lengths.mean()) if lengths.size else 0.0
    skewed = max_len > 32 * max(avg_len, 1.0)
    cands: list[Schedule] = []
    kt_dg = choose_kt_dg(k)
    if k <= 128 and gates.x_fits(mat.shape[1] * kt_dg * 4):
        density = max(mat.density, 1e-8)
        if kt_dg == 1:
            dg_cfgs = [(4096, 4, 2048), (4096, 4, 1024), (1024, 8, 512)]
        else:
            dg_cfgs = []
            for rb, g in ((1024, 512), (512, 512), (1024, 1024)):
                W = min(max(1.0 * g / (density * rb), 256), 16 * 1024)
                ns = int(min(max(2 ** round(math.log2(max(W / 128, 2))), 2), 32))
                if (rb, ns, g) not in dg_cfgs:
                    dg_cfgs.append((rb, ns, g))
        if full and kt_dg > 1:
            dg_cfgs = list(dict.fromkeys(
                dg_cfgs + [(rb, ns, g) for rb in (512, 1024, 2048)
                           for ns in (4, 8, 16) for g in (512, 1024)]))
        kts_dg = [kt_dg] if (kt_dg <= 8 or kt_dg == 1) else \
            list(dict.fromkeys([kt_dg, 8]))
        for kt_c in kts_dg:
            for rb, ns, g in (dg_cfgs if kt_c == kt_dg else dg_cfgs[:1]):
                if kt_c == 1 and rb % 64:
                    continue
                for u in ((4, 8, 16) if full else (8,)):
                    cands.append(Schedule(family="dg_span", rb=rb, ns=ns,
                                          g=g, unroll=u, ktile=kt_c))
                if full and kt_c >= 8:
                    cands.append(Schedule(family="dg_span", rb=rb, ns=ns,
                                          g=g, unroll=8, ktile=kt_c,
                                          precision="bf16"))
    if 2 <= kt_dg <= 32 and k <= 128 and gates.x_fits(mat.shape[1] * max(kt_dg, 8) * 4):
        _, ngrp_dgt = dgt_geometry(max(kt_dg, 8), "fp32x2")
        rb_auto = auto_rb_dgt(mat.shape[0], mat.shape[1], mat.nnz, ngrp=ngrp_dgt)
        dgt_cfgs = [(True, 512, 8, 512, 8, False), (True, 256, 4, 512, 8, False),
                    (False, 256, 8, 512, 8, False), (True, 512, 8, 1024, 16, False),
                    (True, 256, 4, 512, 8, True), (True, 512, 8, 512, 8, True)]
        if rb_auto > 512:
            dgt_cfgs.insert(0, (True, rb_auto, 4, 512, 8, False))
        if full:
            dgt_cfgs += [(True, 512, 4, 512, 8, False), (True, 256, 8, 512, 8, False),
                         (False, 512, 8, 512, 8, False), (True, 1024, 2, 512, 8, False),
                         (True, 512, 8, 512, 16, False), (True, 512, 8, 1024, 8, False),
                         (True, 512, 8, 1024, 16, True)]
        for resid, rb, nw, g_c, u_c, i8 in dgt_cfgs:
            cands.append(Schedule(family="dgt_span", rb=rb, nw=nw, resid=resid, g=g_c,
                                  unroll=u_c, ktile=max(kt_dg, 8), rowhot_i8=i8))
    kt_r = choose_kt(k)
    if k <= 128 and gates.x_fits(mat.shape[1] * kt_r * 4):
        for kt_c in ([kt_r] if kt_r <= 8 else list(dict.fromkeys([kt_r, 8]))):
            radix_cfgs = _radix_configs(mat.density, kt_c)
            if not full and kt_c != kt_r:
                radix_cfgs = radix_cfgs[:1]
            if full:
                radix_cfgs = list(dict.fromkeys(
                    radix_cfgs + [(rb, S, g) for rb in (512, 1024, 2048)
                                  for S in (64, 128, 256) for g in (256, 512)]))
            for rb, S, g in radix_cfgs:
                for u in ((2, 4, 8) if full else (4,)):
                    cands.append(Schedule(family="radix_span", rb=rb, sublanes=S, g=g,
                                          unroll=u, ktile=kt_c))
                if full:
                    cands.append(Schedule(family="radix_span", rb=rb, sublanes=S, g=g,
                                          unroll=4, ktile=kt_c, precision="bf16"))
        if k <= 32 or full:
            cands.append(Schedule(family="brick_ell", sort=True, rb=1024, sublanes=256,
                                  g=512, unroll=4, ktile=kt_r))
    x_bytes = mat.shape[1] * 2 * min(k, 128) * 2  # the TPU's layout: X as hi+lo bf16
    if k <= 128:
        if gates.x_fits(x_bytes):
            unrolls = (2, 4, 8) if full else (4,)
            precisions = ("fp32x2", "bf16") if full else ("fp32x2",)
            for rb, ct, g in _span_configs(mat.density):
                for u in unrolls:
                    for prec in precisions:
                        cands.append(Schedule(family="span_onehot", rb=rb, ct=ct, g=g,
                                              unroll=u, precision=prec))
        else:
            s = -(-x_bytes // COLSPLIT_RANGE_BYTES)
            for rb, ct, g in _span_configs(mat.density)[:2]:
                cands.append(Schedule(family="span_colsplit", col_split=s, rb=rb, ct=ct,
                                      g=g, unroll=4))
    for rb, ct, g in ((1024, 1024, 512), (1024, 512, 256), (512, 1024, 256)):
        for kt in ((None, 64, 128) if full and k > 128 else (None,)):
            cands.append(Schedule(family="tile_onehot", rb=rb, ct=ct, g=g, unroll=4,
                                  ktile=kt))
    for work in ((512, 1024, 2048, 4096) if full else (512, 2048)):
        cands.append(Schedule(family="stripe_total", blocking="merge_path",
                              work_per_block=work, unroll=8))
    if full:
        cands.append(Schedule(family="stripe_total", blocking="balanced",
                              work_per_block=1024, unroll=8))
        cands.append(Schedule(family="stripe_total", blocking="fixed_rows",
                              row_interval=256, unroll=8))
        cands.append(Schedule(family="stripe_nested", work_per_block=4096, unroll=8))
    if skewed or full:
        if k <= 128:
            cands.append(Schedule(family="segment_span", work_per_block=4096, ct=512, g=256,
                                  unroll=4))
        cands.append(Schedule(family="nnz_segment", work_per_block=2048, unroll=8))
        cands.append(Schedule(family="bucketed", bucket_bounds=(max(int(8 * avg_len), 32),)))
    m, n = mat.shape
    if mat.nnz and n > 256:
        ccounts = np.bincount(mat.cols, minlength=n)
        share128 = float(np.sort(ccounts)[-128:].sum()) / mat.nnz
        # column concentration against the uniform expectation 128/n
        if share128 > max(0.25, 2.5 * 128 / n) or full:
            hyb = []
            kt_h = choose_kt(k) if k <= 128 else None
            for C in dict.fromkeys((2048, 512, max(128, (n // 8) & ~127))):
                if 128 <= C < n and m * C * 4 <= 512 * 1024 * 1024:
                    hyb.append(Schedule(family="hybrid_cols", hot_cols=C, unroll=4,
                                        ktile=kt_h, precision="bf16"))
                    if full:
                        hyb.append(Schedule(family="hybrid_cols", hot_cols=C, unroll=4,
                                            ktile=kt_h))
            if share128 > 0.6 and not full:
                cands = hyb + cands  # extreme concentration: time the panel first
            else:
                cands.extend(hyb)
    if m * n * 2 <= 4 * 1024 ** 3 and (mat.density > 0.02 or k >= 256 or full):
        cands.append(Schedule(family="dense", precision="bf16"))
    blocks = np.unique((mat.rows >> 7) * (-(-n // 128)) + (mat.cols >> 7)).size
    if blocks and (mat.nnz / (blocks * 128 * 128) > 0.25
                   or (full and m * n * 2 <= 4 * 1024 ** 3)):
        cands.append(Schedule(family="block_ell", precision="bf16", row_interval=128))
    return cands


def slots_read(fmt) -> int | None:
    """The slots a format's kernel reads on the card, where it reads only
    live ones: the row walks of the dg, dgt, span, segment-span, radix and
    brick-ELL formats (#1-#4, #7-#9), one a live slot, and the stripe
    kernel over each stripe's live slots (stripe and segment formats, #10);
    None for a format whose kernel reads its packed planes (tile, nested
    stripe) or its dense blocks."""
    if isinstance(fmt, (StripeFormat, SegmentFormat)):
        return int(fmt.live_p.sum())
    if isinstance(fmt, (DgFormat, DgtFormat, SpanFormat, RadixFormat, SegmentSpanFormat)):
        return int(fmt.nnz_real)
    return None


def read_rate(plan: SpmmPlan, nnz: int) -> float | None:
    """The slots a plan's kernels read over the nonzeros, where every
    format of it reads only live slots (``slots_read``); else None."""
    reads = [slots_read(f) for f in plan.formats]
    if not reads or None in reads or plan.meta.get("format_bytes"):
        return None
    return sum(reads) / max(nnz, 1)


def index_bytes(fmt) -> int:
    """The bytes of the port's own indexes a format carries on the card,
    which ``memory_bytes`` (the JAX package's count) leaves out: the row
    walk, 16 B a live slot, of every format with one (built at its first
    launch: counted whether or not it is built yet), and where built, the
    SDDMM tile index (#14, ``fmt.tiles``) and the transpose apply's column
    index (#15, ``fmt.dx_index``)."""
    n = 0
    if not isinstance(fmt, (StripeFormat, SegmentFormat)) and slots_read(fmt) is not None:
        n += WALK_SLOT_BYTES * slots_read(fmt)
    for extra in (getattr(fmt, "tiles", None), getattr(fmt, "dx_index", None)):
        if extra is not None:
            n += int(extra.nbytes)
    return n


@dataclasses.dataclass
class TuneResult:
    best: SpmmPlan
    best_schedule: Schedule
    best_seconds: float
    table: list[dict]

    @property
    def gflops(self):
        return self.table and max(r.get("gflops", 0.0) for r in self.table)


def tune(
    mat: CooMatrix,
    x,
    *,
    candidates: Sequence[Schedule] | None = None,
    validate: bool = True,
    rtol: float | None = None,
    iters: int = 10,
    results_path: str | None = None,
    use_cache: bool = True,
    full: bool = False,
    budget: int | None = None,
    device="cuda",
    gates: Gates = CARD_GATES,
) -> TuneResult:
    """Enumerate + time candidates on ``device``, keep the min
    (token_test.cc min-time).  ``full=True`` sweeps the wider grid;
    ``budget`` caps the number of candidates tried (cached winner first).
    ``gates`` (``tpusparse_torch.gates``) gives the candidate list's gates,
    what the padding bound counts (the card's: the slots read, for the
    families that read live slots only; the TPU's: the packed planes) and
    the plans' (brick_ell's refusal); a row's ``format_bytes`` counts the
    port's own indexes too under the card's (``index_bytes``)."""
    dev = resolve_device(device)
    cfg = get_config()
    x_host = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x))
    xd = torch.as_tensor(x_host, dtype=torch.float32, device=dev)
    k = xd.shape[1]
    sig = matrix_signature(mat)
    cache_file = os.path.join(cfg.cache_dir, f"tune_{sig}_k{k}.json")
    timer = time_fn if dev.type == "cuda" else time_fn_host
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    if candidates is None:
        candidates = default_candidates(mat, k, full=full, gates=gates)
        if use_cache and os.path.exists(cache_file):
            try:
                with open(cache_file) as f:
                    # JSON turns the tuple fields into lists; restore them so
                    # the cached winner equals its candidate and is tried once
                    cached = Schedule(**{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in json.load(f)["schedule"].items()})
            except (OSError, ValueError, TypeError, KeyError):
                cached = None  # an unreadable cache entry is re-tuned
            if cached is not None and cached.family in KERNEL_FAMILIES:
                candidates = [cached] + [c for c in candidates if c != cached]
    if budget is not None:
        candidates = list(candidates)[:max(budget, 1)]

    want = spmm_reference(mat, x_host.astype(np.float64)) if validate else None
    bf16_scale = None

    def _bf16_scale():
        # bf16 candidates are judged with a condition-aware denominator
        # |A|·|x|: rounding to bf16 carries an irreducible error
        # ~eps·Σ|terms| per output that every bf16 method shares — the
        # oracle should catch kernel bugs, not re-litigate the precision
        # choice (the reference sidesteps the same issue by checking with
        # all-ones values, kernel_lib.hpp:859-921)
        nonlocal bf16_scale
        if bf16_scale is None:
            mat_abs = CooMatrix(mat.rows, mat.cols,
                                np.abs(np.asarray(mat.vals, np.float64)),
                                mat.shape)
            bf16_scale = spmm_reference(mat_abs, np.abs(x_host.astype(np.float64)))
        return bf16_scale

    table: list[dict] = []
    best = None
    timed: dict[Schedule, dict] = {}  # plan_key -> the row that packed and timed it
    for sched in candidates:
        row = {"schedule": sched.describe(), "matrix": sig, "k": k, "device": where}
        same = timed.get(sched.plan_key())
        if same is not None:
            # only a TPU-only knob differs: the same format and kernel, so
            # the row repeats that measurement instead of timing host noise
            row.update({key: v for key, v in same.items() if key not in row and key != "ts"},
                       same_plan_as=same["schedule"], ts=time.time())
            table.append(row)
            continue
        timed[sched.plan_key()] = row
        try:
            t_pack = time.time()
            plan = build_plan(mat, sched, device=dev, gates=gates)
            row["pack_seconds"] = round(time.time() - t_pack, 4)
            if validate:
                y = plan(xd).cpu().numpy()
                tol = rtol
                if tol is None:
                    tol = 2e-3 if sched.precision == "fp32x2" else (
                        cfg.tol_bf16 if sched.precision == "bf16" else cfg.tol_fp32
                    )
                scale = (_bf16_scale()
                         if rtol is None and sched.precision == "bf16"
                         else None)
                check_result(y, want, rtol=tol, scale=scale)
            # the bound weighs padding against real nonzeros; an empty
            # matrix has none, and every candidate is all padding.  On the
            # card's record it weighs the slots a kernel reads where it
            # reads only live ones, not the packed planes
            pad = plan.meta["padding_rate"]
            read = read_rate(plan, mat.nnz) if gates.padding_counts == "read" else None
            if mat.nnz and (pad if read is None else read) > cfg.padding_rate_up_bound:
                raise CandidateRejected(
                    f"padding rate {pad if read is None else read:.2f} exceeds bound"
                )
            sec = timer(plan.fn, xd, iters=iters, warmup=1)
            g = gflops(mat.nnz, k, sec, cfg.float_rate)
            # plausibility guards (executor.cc:51-55): counted GF/s above
            # the card's peak, or a timing under the launch floor, is a
            # measurement artifact, not a result
            if g > cfg.gflops_up_bound:
                raise CandidateRejected(f"implausible {g:.1f} GFLOP/s > bound")
            if 0 < sec < cfg.seconds_floor:
                raise CandidateRejected(
                    f"implausible timing {sec:.2e}s under the launch floor")
            # the dense-tile families count their panel or dense A (and a
            # hybrid its remainder's formats) in meta; the others their formats
            fmt_bytes = (plan.meta.get("format_bytes")
                         or sum(f.memory_bytes for f in plan.formats))
            if gates.padding_counts == "read":  # the card's: its own indexes too
                fmt_bytes += sum(index_bytes(f) for f in plan.formats)
            row.update(seconds=sec, gflops=g, padding_rate=pad, format_bytes=fmt_bytes,
                       ok=True)
            if read is not None:
                row["read_rate"] = read
            if best is None or sec < best[1]:
                best = (plan, sec, sched)
        except (AssertionError, CandidateRejected) as e:
            # a candidate that fails its oracle check (or a packer
            # precondition), a guard or its family's gate is recorded and
            # skipped; a failed launch or build is a fault and propagates
            row.update(ok=False, error=f"{type(e).__name__}: {e}")
        row["ts"] = time.time()
        table.append(row)

    if results_path is None:
        os.makedirs(cfg.cache_dir, exist_ok=True)
        results_path = os.path.join(cfg.cache_dir, "results.jsonl")
    with open(results_path, "a") as f:
        for row in table:
            f.write(json.dumps(row) + "\n")

    if best is None:
        raise RuntimeError(f"no schedule candidate succeeded: {table}")
    plan, sec, sched = best
    if use_cache:
        os.makedirs(cfg.cache_dir, exist_ok=True)
        with open(cache_file, "w") as f:
            json.dump({"schedule": sched.describe(), "seconds": sec, "device": where}, f)
        # persist the winner's packed formats (data_source/<id> analogue) in
        # a directory named by the matrix's values, K and the winner's plan:
        # a re-tune that keeps its winner writes nothing.  A failure to save
        # is said, and the tune's result stands
        try:
            from tpusparse_torch.artifacts import artifact_path, save_plan_artifact

            desc = sched.describe()
            run_id = hashlib.blake2b(
                json.dumps([matrix_digest(mat), k, desc], sort_keys=True,
                           default=str).encode(), digest_size=8).hexdigest()
            if not os.path.exists(os.path.join(artifact_path(sig, run_id), "schedule.json")):
                save_plan_artifact(sig, desc, plan.formats,
                                   perf={"seconds": sec, "gflops": gflops(mat.nnz, k, sec,
                                                                          cfg.float_rate),
                                         "k": k, "device": where}, run_id=run_id)
        except (OSError, ValueError, TypeError, KeyError) as e:
            warnings.warn(f"tune: the winner's artifact was not saved: "
                          f"{type(e).__name__}: {e}", stacklevel=2)
    return TuneResult(best=plan, best_schedule=sched, best_seconds=sec, table=table)
