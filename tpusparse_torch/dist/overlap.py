"""Multi-device SpMM with the ring-overlapped halo exchange (counterpart of
``tpusparse/dist/overlap.py``).

Strategy (no GeneralSparse counterpart; SURVEY §2.6): row-partition A over
the mesh axis 'rows' AND shard the dense X by its rows (the contraction
dim).  Each rank then needs every X chunk once, so the chunks travel a
ring: at step s, rank d multiplies its sub-format for column chunk
((d - s) mod D) against the chunk it holds, while the chunk for step s+1
is already on its way from rank d-1.

The packers (``pack_halo_stripe``, ``pack_halo_span``, ``pack_halo_radix``,
``pack_halo_dg``, ``pack_halo_dgt``) are the JAX package's, array for
array: every [D, C, ...] plane, the slot map and the TPU alignments that
fix them (the 8-row chunk rounding, 128-column windows for dg, 8*spr for
radix).  Their formats carry one field of the port's own beside the JAX
planes: ``live_p`` (a stripe bucket's live slots) or ``nc_p`` (a span or
dgt bucket's chunk count), from the packer's walk.

The ring harness ``_build_ring`` runs over a transport, either of:

- ``LocalRing``: every rank of a ``Mesh`` in this process.  Ranks may share
  a device (``["cuda:0"] * 4``): each keeps its own planes, row walks and
  two chunk buffers.  At step s the shift of each rank's chunk to rank
  r+1's other buffer is issued on a side stream of that rank's device,
  then the step's kernels on the compute stream (the device's current
  stream); the compute stream waits on the shift's CUDA event before step
  s+1, and the shift of step s waits on the event of the kernel that last
  read the buffer it overwrites.  Nothing syncs the host inside the loop.
  With distinct cards in one process the same copy is a peer copy.
- ``GroupRing``: one rank a process over ``torch.distributed`` (gloo on
  the CPU, NCCL across cards): ``batch_isend_irecv`` started before the
  step's kernel and waited on after it, the row blocks collected by
  ``all_gather``.

Each (rank, chunk) bucket builds its kernel's operands once, at build
time: the row walk (``kernels/row_walk.py``) for the span (#7), radix
(#9), dg (#1) and dgt (#3) kernels, the live-slot counts for the stripe
kernel (#10).  A step's kernel adds into the rank's y_rows (``out=``), so
the ring makes no per-step ``y += partial`` pass.  CPU ranks run the plain
versions, and add.  The TPU-only knobs (``unroll``, ``scatter``,
``fold``, ``interpret``, the fp32x2 hi/lo split) are accepted and give the
same Y.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from tpusparse_torch import native
from tpusparse_torch.dist.shard import Mesh, host_x, k_blocks
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import (lex_order, pad_dense_rows, resolve_device,
                                            round_up, to_device, unpack_slots)


def _count_nonzero(vals) -> int:
    return int(torch.count_nonzero(vals))


# ------------------------------------------------------------------ formats

@dataclasses.dataclass
class HaloStripeFormat:
    """Ring halo format for the stripe kernel: the device's rows cut into
    stripes shared by every column chunk, so each chunk's partial products
    add into the same (stripe, row) slots.

      cols [D, C, P, 1, Cnz] int32  chunk-local column (C = D chunks)
      lrow [D, C, P, 1, Cnz] int32  stripe-local row
      vals [D, C, P, 1, Cnz] f32
      slot_of_origrow [M] int32     (d * P + p) * RB + r
      live_p [D, C, P] int32        the bucket stripe's live slots (the
                                    port's own field: the kernel walks
                                    only those)
    """

    cols: Any
    lrow: Any
    vals: Any
    slot_of_origrow: Any
    live_p: Any
    shape: tuple[int, int]
    n_devices: int
    stripes_per_device: int
    rb: int            # rows per stripe
    stripe_nnz: int    # Cnz
    n_chunk_rows: int  # X rows per chunk (= padded N / D)

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def padding_rate(self) -> float:
        total = self.n_devices ** 2 * self.stripes_per_device * self.stripe_nnz
        return total / max(_count_nonzero(self.vals), 1)


@dataclasses.dataclass
class HaloSpanFormat:
    """Ring halo format carrying span-chunked sub-formats (the span, radix
    and dg rings).  Per (device d, X chunk c): the device's rows dealt to P
    programs shared across chunks; each program's chunk-c nonzeros
    column-sorted and cut into G-slot span chunks with chunk-local window
    starts; NC the most over (d, c, program).

      c0    [D, C, P, 1, NC] int32
      cols  [D, C, P, NC, G] int32 (window-local)
      lrow  [D, C, P, NC, G] int32 (program-local)
      vals  [D, C, P, NC, G] f32
      slot_of_origrow [M] int32  (d * P + p) * RB + r
      nc_p  [D, C, P, 1, 1] int32  the bucket program's chunk count (the
                                   port's own field)
    """

    c0: Any
    cols: Any
    lrow: Any
    vals: Any
    slot_of_origrow: Any
    nc_p: Any
    shape: tuple[int, int]
    n_devices: int
    programs_per_device: int
    n_chunks_span: int   # NC
    chunk_g: int         # G
    rb: int
    ct: int
    n_chunk_rows: int    # X rows per ring chunk

    @property
    def device(self) -> torch.device:
        return self.c0.device

    @property
    def padding_rate(self) -> float:
        total = (self.n_devices ** 2 * self.programs_per_device
                 * self.n_chunks_span * self.chunk_g)
        return total / max(_count_nonzero(self.vals), 1)


@dataclasses.dataclass
class HaloDgtFormat:
    """Ring halo format for the dgt kernel: per (device, ring chunk,
    program) bucket the consecutive-window tile walk of
    ``kernels/dgt_gather``; heavy rows split into <= 8 aligned virtual rows
    whose outputs fold through the pairwise-sum pyramid before the slot
    gather (the machinery of the single-device ``pack_dgt``).

      wins [D, C, P, NC, T] int32
      cols [D, C, P, NC, G] int32 (lane | sel << 7)
      lrw  [D, C, P, NC, G] int32
      vals [D, C, P, NC, G] f32
      slot_of_origrow [M] int32  pyramid index over D*P*rb slots
      nc_p [D, C, P, 1, 1] int32  the bucket's chunk count (the port's own)
    """

    wins: Any
    cols: Any
    lrw: Any
    vals: Any
    slot_of_origrow: Any
    nc_p: Any
    shape: tuple[int, int]
    n_devices: int
    programs_per_device: int
    n_chunks: int
    chunk_g: int
    rb: int
    kt: int
    mode: str
    resid: bool
    nw: int
    split_levels: int
    n_chunk_rows: int

    @property
    def device(self) -> torch.device:
        return self.wins.device

    @property
    def padding_rate(self) -> float:
        total = (self.n_devices ** 2 * self.programs_per_device
                 * self.n_chunks * self.chunk_g)
        return total / max(_count_nonzero(self.vals), 1)


# ------------------------------------------------------------------ packers

def _coo(mat: CooMatrix):
    return (np.asarray(mat.rows), np.asarray(mat.cols),
            np.asarray(mat.vals, dtype=np.float32))


def pack_halo_stripe(mat: CooMatrix, n_devices: int, *, rows_per_stripe: int = 64,
                     nnz_multiple: int = 8, device="cuda") -> HaloStripeFormat:
    """Pack for the D-device ring (tpusparse/dist/overlap.py:61).  Rows are
    dealt to devices in contiguous balanced-nnz ranges; each device's range
    is cut into ``rows_per_stripe``-row stripes shared by all column chunks,
    rows dealt to stripes by the greedy that balances the per-chunk load."""
    dev = resolve_device(device)
    m, n = mat.shape
    d = n_devices
    rb = rows_per_stripe
    rows, cols, vals = _coo(mat)

    # balanced-nnz contiguous row partition over devices (merge-path style)
    row_ptr = mat.to_csr_ptr()
    targets = (np.arange(1, d) * mat.nnz) // d
    cut_rows = np.searchsorted(row_ptr, targets, side="left")
    bounds = np.concatenate([[0], cut_rows, [m]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)

    # chunk rows padded to the 8-row sublane multiple (the TPU's tiling;
    # it fixes the format)
    n_chunk_rows = round_up(-(-max(n, 1) // d), 8)
    p_per_dev = max(int(np.max(np.diff(bounds), initial=1) + rb - 1) // rb, 1)

    # bucket nz by (device, chunk, stripe); rows descending by length, each
    # on the stripe minimizing the worst per-ring-chunk load
    dev_of_nz = np.searchsorted(bounds, rows, side="right") - 1
    chunk_of_nz = cols // n_chunk_rows
    lcol_of_nz = cols % n_chunk_rows
    rc = np.zeros((m, d), dtype=np.int64)
    np.add.at(rc, (rows, chunk_of_nz), 1)
    stripe_of_row = np.zeros(m, dtype=np.int64)
    lrow_of_row = np.zeros(m, dtype=np.int64)
    big = np.iinfo(np.int64).max
    for dv in range(d):
        lo, hi = int(bounds[dv]), int(bounds[dv + 1])
        rr = np.arange(lo, hi)
        if rr.size == 0:
            continue
        order_r = rr[np.argsort(-(row_ptr[rr + 1] - row_ptr[rr]), kind="stable")]
        loads = np.zeros((p_per_dev, d), dtype=np.int64)
        used = np.zeros(p_per_dev, dtype=np.int64)
        for u in order_r:
            feas = used < rb
            worst = np.where(feas, (loads + rc[u]).max(axis=1), big)
            s = int(np.argmin(worst))
            stripe_of_row[u] = s
            lrow_of_row[u] = used[s]
            used[s] += 1
            loads[s] += rc[u]
    stripe_of_nz = stripe_of_row[rows]
    lrow_of_nz = lrow_of_row[rows]

    key = (dev_of_nz * d + chunk_of_nz) * p_per_dev + stripe_of_nz
    buckets = d * d * p_per_dev
    counts = np.bincount(key, minlength=buckets)
    cnz = round_up(max(int(counts.max(initial=1)), 1), max(nnz_multiple, 1))
    out_cols, out_lrow, out_vals, _ = native.bucket_pack(key, lcol_of_nz, lrow_of_nz, vals,
                                                         buckets, cnz)

    shape5 = (d, d, p_per_dev, 1, cnz)
    r = np.arange(m)
    dev_of_row = np.searchsorted(bounds, r, side="right") - 1
    slot = ((dev_of_row * p_per_dev + stripe_of_row) * rb + lrow_of_row).astype(np.int32)
    return HaloStripeFormat(
        cols=to_device(dev, out_cols.reshape(shape5)),
        lrow=to_device(dev, out_lrow.reshape(shape5)),
        vals=to_device(dev, out_vals.reshape(shape5), torch.float32),
        slot_of_origrow=to_device(dev, slot),
        live_p=to_device(dev, counts.reshape(d, d, p_per_dev)),
        shape=(m, n), n_devices=d, stripes_per_device=p_per_dev, rb=rb, stripe_nnz=cnz,
        n_chunk_rows=n_chunk_rows)


def pack_halo_span(mat: CooMatrix, n_devices: int, *, rows_per_program: int = 512,
                   ct: int = 512, g: int = 256, align: int = 8,
                   device="cuda") -> HaloSpanFormat:
    """Pack for the span ring (tpusparse/dist/overlap.py:344): rows dealt
    globally to the D*P (device, program) bins by the greedy that balances
    the per-ring-chunk nnz vector, each bucket cut by the span chunk walk
    (``native.span_pack``).  ``align`` > 8 packs for the radix and dg
    rings: window starts land on ``align``-column boundaries."""
    dev = resolve_device(device)
    m, n = mat.shape
    d = n_devices
    rb = rows_per_program
    rows, cols, vals = _coo(mat)

    n_chunk_rows = round_up(-(-max(n, 1) // d), max(align, 8))
    span_budget = ct - align

    lengths = np.bincount(rows, minlength=m)
    chunk_of_nz_pre = cols // n_chunk_rows
    p_loc = max(-(-m // (d * rb)), 1)
    nbins = d * p_loc
    bin_of_row = np.zeros(m, dtype=np.int64)
    lrow_of_row = np.zeros(m, dtype=np.int64)
    if m and nbins > 1:
        rc = np.zeros((m, d), dtype=np.int64)
        np.add.at(rc, (rows, chunk_of_nz_pre), 1)
        by_len = np.argsort(-lengths, kind="stable")
        loads = np.zeros((nbins, d), dtype=np.int64)
        used = np.zeros(nbins, dtype=np.int64)
        big = np.iinfo(np.int64).max
        for r in by_len:
            v = rc[r]
            worst = np.where(used < rb, (loads + v).max(axis=1), big)
            b = int(np.argmin(worst))
            loads[b] += v
            bin_of_row[r] = b
            lrow_of_row[r] = used[b]
            used[b] += 1
    else:
        lrow_of_row[:] = np.arange(m)
    dev_of_row = bin_of_row // p_loc
    p_of_row = bin_of_row % p_loc

    dev_nz = dev_of_row[rows]
    chunk_nz = cols // n_chunk_rows
    prog_nz = p_of_row[rows]
    lcol_nz = cols % n_chunk_rows
    lrow_nz = lrow_of_row[rows]

    # sort by (dev, chunk, program, local col) and pack each bucket with the
    # span chunk walk
    key = (dev_nz * d + chunk_nz) * p_loc + prog_nz
    order = lex_order(lcol_nz, key)
    key_s = key[order]
    buckets = d * d * p_loc
    starts = np.searchsorted(key_s, np.arange(buckets + 1))
    c0_2d, cols_f, lrow_f, vals_f, nc_b = native.span_pack(
        lcol_nz[order].astype(np.int64), lrow_nz[order].astype(np.int64), vals[order], starts,
        g, span_budget)
    if align > 8:
        # realign window starts from the chunk walk's 8 to ``align``
        delta = (c0_2d % align).astype(np.int32)
        c0_2d = c0_2d - delta
        cols_f = cols_f + delta[:, :, None]
    nc = c0_2d.shape[1]

    shape3 = (d, d, p_loc)
    slot = ((dev_of_row * p_loc + p_of_row) * rb + lrow_of_row).astype(np.int32)
    return HaloSpanFormat(
        c0=to_device(dev, c0_2d.reshape(*shape3, 1, nc)),
        cols=to_device(dev, cols_f.reshape(*shape3, nc, g)),
        lrow=to_device(dev, lrow_f.reshape(*shape3, nc, g)),
        vals=to_device(dev, vals_f.reshape(*shape3, nc, g), torch.float32),
        slot_of_origrow=to_device(dev, slot),
        nc_p=to_device(dev, np.asarray(nc_b).reshape(*shape3, 1, 1)),
        shape=(m, n), n_devices=d, programs_per_device=p_loc, n_chunks_span=nc, chunk_g=g,
        rb=rb, ct=ct, n_chunk_rows=n_chunk_rows)


def pack_halo_radix(mat: CooMatrix, n_devices: int, *, rows_per_program: int = 1024,
                    S: int = 128, g: int = 256, kt: int = 8, mode: str = "fp32x2",
                    device="cuda") -> HaloSpanFormat:
    """Halo ring format for the radix kernel (tpusparse/dist/overlap.py:509):
    span packing with window starts aligned to the 8*spr radix row-group
    boundary (ct = S*spr)."""
    from tpusparse_torch.kernels.radix_gather import radix_geometry

    spr, _, ngrp = radix_geometry(kt, mode)
    assert rows_per_program % ngrp == 0
    return pack_halo_span(mat, n_devices, rows_per_program=rows_per_program, ct=S * spr, g=g,
                          align=8 * spr, device=device)


def pack_halo_dg(mat: CooMatrix, n_devices: int, *, rows_per_program: int = 1024,
                 ns: int = 4, g: int = 256, kt: int = 8, mode: str = "fp32x2",
                 device="cuda") -> HaloSpanFormat:
    """Halo ring format for the dg kernel (tpusparse/dist/overlap.py:576):
    span packing with window starts aligned to the 128-column tile (ct =
    ns*128; ns >= 2 so the chunk-then-realign walk keeps a positive
    budget)."""
    from tpusparse_torch.kernels.dg_gather import dg_geometry

    wt, _, ngrp = dg_geometry(kt, mode)
    assert wt == 128 and ns >= 2, (wt, ns)
    assert rows_per_program % ngrp == 0
    assert g % 128 == 0, f"g={g} must be a multiple of the 128-lane tile"
    return pack_halo_span(mat, n_devices, rows_per_program=rows_per_program, ct=ns * 128, g=g,
                          align=128, device=device)


def pack_halo_dgt(mat: CooMatrix, n_devices: int, *, rows_per_program: int = 256,
                  g: int = 512, kt: int = 8, mode: str = "fp32x2", nw: int = 4,
                  resid: bool = True, split: int | str | None = "auto", walk: str = "multi",
                  device="cuda") -> HaloDgtFormat:
    """Halo ring format for the dgt kernel (tpusparse/dist/overlap.py:676):
    virtual-row splits, then a greedy unit deal over the D*P (device,
    program) bins that balances the per-ring-chunk nnz vector under
    size-aligned slot allocation, then the dgt tile walk per (device,
    chunk, program) bucket (``_dgt_walk_multi`` by default, ``_dgt_walk``
    for ``walk="single"``)."""
    from tpusparse_torch.kernels.dgt_gather import _dgt_walk, _dgt_walk_multi, dgt_geometry

    dev = resolve_device(device)
    _, ngrp = dgt_geometry(kt, mode)
    cap = (128 // ngrp) if resid else 128
    rb = rows_per_program
    assert rb % ngrp == 0 and rb % 8 == 0, rb
    assert g % 128 == 0, g
    T = g // 128
    m, n = mat.shape
    d = n_devices
    rows, cols, vals = _coo(mat)
    nnz = rows.size
    n_chunk_rows = round_up(-(-max(n, 1) // d), 8)

    # virtual rows (pow2 pieces, see pack_dgt)
    lengths = np.bincount(rows, minlength=m) if m else np.zeros(0, np.int64)
    if split == "auto":
        split = max(64, 8 * max(nnz // max(m, 1), 1))
    if not split:
        pieces = np.ones(m, dtype=np.int64)
    else:
        raw = np.minimum(np.maximum(-(-lengths // int(split)), 1), 8)
        pieces = np.where(raw > 4, 8, np.where(raw > 2, 4, raw)).astype(np.int64)
    vrow_base = np.concatenate([[0], np.cumsum(pieces)]).astype(np.int64)
    mv = int(vrow_base[-1])
    if int(pieces.max(initial=1)) > 1:
        order0 = np.argsort(rows, kind="stable")
        row_start = np.concatenate([[0], np.cumsum(lengths)])
        rnk = np.arange(nnz, dtype=np.int64) - row_start[rows[order0]]
        vr = np.empty(nnz, dtype=np.int64)
        vr[order0] = vrow_base[rows[order0]] + rnk % pieces[rows[order0]]
    else:
        vr = rows
    smax = int(pieces.max(initial=1))

    # greedy unit deal over bins: per-chunk balance + aligned slots
    chunk_of_nz = cols // n_chunk_rows
    rc = np.zeros((m, d), dtype=np.int64)
    np.add.at(rc, (rows, chunk_of_nz), 1)
    order_u = np.lexsort((-lengths, -pieces))
    p_loc = max(-(-mv // (d * rb)), 1)
    big = np.iinfo(np.int64).max
    while True:
        nbins = d * p_loc
        bin_of_unit = np.zeros(m, dtype=np.int64)
        base_of_unit = np.zeros(m, dtype=np.int64)
        loads = np.zeros((nbins, d), dtype=np.int64)
        used = np.zeros(nbins, dtype=np.int64)
        ok = True
        for u in order_u:
            size = int(pieces[u])
            base_cand = -(-used // size) * size
            feasible = base_cand + size <= rb
            if not feasible.any():
                ok = False
                break
            worst = np.where(feasible, (loads + rc[u]).max(axis=1), big)
            b = int(np.argmin(worst))
            bin_of_unit[u] = b
            base_of_unit[u] = base_cand[b]
            used[b] = base_cand[b] + size
            loads[b] += rc[u]
        if ok:
            break
        p_loc += 1

    unit_of_vr = np.repeat(np.arange(m), pieces)
    lrow_of_vr = base_of_unit[unit_of_vr] + np.arange(mv) - vrow_base[unit_of_vr]
    bin_of_vr = bin_of_unit[unit_of_vr]
    dev_nz = bin_of_vr[vr] // p_loc
    prog_nz = bin_of_vr[vr] % p_loc
    lrow_nz = lrow_of_vr[vr]
    lcol_nz = cols % n_chunk_rows
    bucket = (dev_nz * d + chunk_of_nz) * p_loc + prog_nz

    walker = _dgt_walk_multi if walk == "multi" else _dgt_walk
    wins_f, cols_f, lrw_f, vals_f, nc_arr, _, _ = walker(
        bucket, lcol_nz, lrow_nz, vals, n_buckets=d * d * p_loc, col_span=n_chunk_rows,
        ngrp=ngrp, cap=cap, T=T, g=g, nw=nw, resid=resid)
    nc = cols_f.shape[1]
    shape3 = (d, d, p_loc)

    # pyramid index over the D*P*rb slot space
    nslots = d * p_loc * rb
    slot0_of_unit = bin_of_unit * rb + base_of_unit
    lvl_of_unit = np.log2(pieces).astype(np.int64) if m else pieces
    lvl_off = np.array([0, nslots, nslots + nslots // 2,
                        nslots + nslots // 2 + nslots // 4], dtype=np.int64)
    pyr_idx = (lvl_off[lvl_of_unit] + (slot0_of_unit >> lvl_of_unit)).astype(np.int32)
    return HaloDgtFormat(
        wins=to_device(dev, wins_f.reshape(*shape3, nc, T)),
        cols=to_device(dev, cols_f.reshape(*shape3, nc, g)),
        lrw=to_device(dev, lrw_f.reshape(*shape3, nc, g)),
        vals=to_device(dev, vals_f.reshape(*shape3, nc, g), torch.float32),
        slot_of_origrow=to_device(dev, pyr_idx),
        nc_p=to_device(dev, np.asarray(nc_arr).reshape(*shape3, 1, 1)),
        shape=(m, n), n_devices=d, programs_per_device=p_loc, n_chunks=nc, chunk_g=g, rb=rb,
        kt=kt, mode=mode, resid=resid, nw=nw, split_levels=smax, n_chunk_rows=n_chunk_rows)


def halo_format_from_numpy(fields: dict, *, device="cuda", **static):
    """A halo format from the JAX ``Halo*Format``'s arrays (numpy) and
    static fields: ``HaloDgtFormat`` where ``fields`` has ``wins``,
    ``HaloSpanFormat`` where it has ``c0``, else ``HaloStripeFormat``.  The
    port's own field (``live_p``, ``nc_p``) is derived from ``vals`` unless
    given; shapes and index ranges are checked, since the kernels read X and
    write y_rows at these indices without bounds checks."""
    dev = resolve_device(device)
    arr = {k: np.array(v) for k, v in fields.items()}  # copies: a JAX array reads only
    d = static["n_devices"]
    m = static["shape"][0]
    vals = arr["vals"].astype(np.float32)
    if "wins" in arr:
        cls, idx = HaloDgtFormat, ("wins", "cols", "lrw")
        p, nc, g, rb = (static["programs_per_device"], static["n_chunks"], static["chunk_g"],
                        static["rb"])
        want = {"wins": (d, d, p, nc, g // 128), "cols": (d, d, p, nc, g),
                "lrw": (d, d, p, nc, g), "vals": (d, d, p, nc, g)}
        n_slots = sum((d * p * rb) >> lvl for lvl in range(static["split_levels"].bit_length()))
        bad_rows = arr["lrw"].min(initial=0) < 0 or arr["lrw"].max(initial=0) >= rb
    elif "c0" in arr:
        cls, idx = HaloSpanFormat, ("c0", "cols", "lrow")
        p, nc, g, rb = (static["programs_per_device"], static["n_chunks_span"],
                        static["chunk_g"], static["rb"])
        want = {"c0": (d, d, p, 1, nc), "cols": (d, d, p, nc, g), "lrow": (d, d, p, nc, g),
                "vals": (d, d, p, nc, g)}
        n_slots = d * p * rb
        bad_rows = arr["lrow"].min(initial=0) < 0 or arr["lrow"].max(initial=0) >= rb
    else:
        cls, idx = HaloStripeFormat, ("cols", "lrow")
        p, c, rb = static["stripes_per_device"], static["stripe_nnz"], static["rb"]
        want = {k: (d, d, p, 1, c) for k in ("cols", "lrow", "vals")}
        n_slots = d * p * rb
        bad_rows = (arr["lrow"].min(initial=0) < 0 or arr["lrow"].max(initial=0) >= rb
                    or arr["cols"].min(initial=0) < 0
                    or arr["cols"].max(initial=0) >= static["n_chunk_rows"])
    for k, shp in want.items():
        if arr[k].shape != shp:
            raise ValueError(f"{cls.__name__}.{k}: shape {arr[k].shape}, want {shp}")
    slot = arr["slot_of_origrow"]
    if slot.shape != (m,) or bad_rows or slot.max(initial=-1) >= n_slots:
        raise ValueError(f"{cls.__name__} indices out of range")
    out = {k: to_device(dev, arr[k]) for k in (*idx, "slot_of_origrow")}
    out["vals"] = to_device(dev, vals, torch.float32)
    if cls is HaloStripeFormat:
        from tpusparse_torch.format import live_counts

        live = arr.get("live_p")
        live = live_counts(vals.reshape(-1, 1, c), live=None if live is None else live.reshape(-1))
        out["live_p"] = to_device(dev, live.reshape(d, d, p))
    else:
        from tpusparse_torch.format import live_chunk_counts

        ncp = arr.get("nc_p")
        if ncp is None:
            ncp = np.maximum(live_chunk_counts(vals.reshape(-1, nc, g)), 1)
        out["nc_p"] = to_device(dev, np.asarray(ncp).reshape(d, d, p, 1, 1))
    return cls(**out, **static)


# ------------------------------------------------------------------ transports

#: the profiler span around each step's shifts (``bench/ring_profile.py``
#: tells the ring's copies from any other by it)
SHIFT_SPAN = "ring_shift"


class LocalRing:
    """The ring over every rank of a ``Mesh``, in this process: rank (r, j)
    sits at ring position r of ring j (one ring per 'k' column).  Shifts
    run on a side stream of the sending rank's device and are ordered
    against the kernels by CUDA events only; on CPU ranks they are plain
    copies.  A subclass may hook ``start``, ``wait`` and ``on_rank`` (the
    launch of a rank's step) to watch the order."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        devs = set(mesh.devices.reshape(-1))
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a ring runs on CUDA ranks or CPU ranks, not both: {mesh}")
        self.cuda = next(iter(devs)).type == "cuda"
        self.n_row, self.n_k = mesh.devices.shape
        self.ranks = [(r, j) for r in range(self.n_row) for j in range(self.n_k)]
        self.side = ({q: torch.cuda.Stream(device=self.device(q)) for q in self.ranks}
                     if self.cuda else {})

    def device(self, q) -> torch.device:
        return self.mesh.devices[q]

    @property
    def out_device(self) -> torch.device:
        return self.mesh.out_device

    def succ(self, q):
        return ((q[0] + 1) % self.n_row, q[1])

    @contextlib.contextmanager
    def on_rank(self, q, step: int):
        """The context of rank q's kernel launches at ``step``: its device,
        whose current stream is the compute stream."""
        if self.cuda:
            with torch.cuda.device(self.device(q)):
                yield
        else:
            yield

    def begin(self, bufs):
        """Called once the chunk buffers are made: the side streams wait for
        the compute streams' work so far (the chunks' placement and the
        buffers' allocation)."""
        self.read_ev, self.shift_ev = {}, {}
        if self.cuda:
            for q in self.ranks:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device(q)))
                self.side[q].wait_event(ev)

    def start(self, step: int, bufs):
        """Starts the shift of each rank's chunk of ``step`` into the
        buffer its successor reads at step+1."""
        with torch.profiler.record_function(SHIFT_SPAN):
            self._start(step, bufs)
        return step

    def _start(self, step: int, bufs):
        arrived = dict(self.shift_ev)   # the shifts of step-1, which brought the chunks
        for q in self.ranks:
            dst = self.succ(q)
            src_t, dst_t = held(bufs, q, step), held(bufs, dst, step + 1)
            if not self.cuda:
                dst_t.copy_(src_t)
                continue
            same = self.device(q) == self.device(dst)
            send, recv = self.side[q], self.side[dst]
            waiter = send if same else recv
            if q in arrived:          # src_t came in by the shift of step-1
                send.wait_event(arrived[q])
            if dst in self.read_ev:   # the kernel of step-1 read dst_t
                waiter.wait_event(self.read_ev[dst])
            # the copy runs on the sender's side stream; across devices the
            # receiver's side stream is the destination's current stream, so
            # the compute streams stay out of the copy's own barrier
            with torch.cuda.stream(recv), torch.cuda.stream(send):
                dst_t.copy_(src_t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(waiter)
            self.shift_ev[dst] = ev

    def kernels_issued(self, step: int, bufs):
        """After every rank's kernels of ``step``: records that they read
        their buffer of this step (the shift of step+1 overwrites it)."""
        if self.cuda:
            for q in self.ranks:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device(q)))
                self.read_ev[q] = ev

    def wait(self, handle):
        """The compute streams wait for the shift started at step ``handle``
        (on the device; the host goes on)."""
        if self.cuda:
            for q in self.ranks:
                torch.cuda.current_stream(self.device(q)).wait_event(self.shift_ev[q])

    def gather(self, ys):
        """y_slots [D*P*rb, K] on the output device from every rank's
        y_rows: the 'k' ranks' columns side by side, the rows ranks' blocks
        one after another."""
        out = self.out_device

        def row(r):
            if self.n_k == 1:
                return ys[(r, 0)].to(out)
            return torch.cat([ys[(r, j)].to(out) for j in range(self.n_k)], dim=1)

        return torch.cat([row(r) for r in range(self.n_row)], dim=0)


class GroupRing:
    """The ring over a ``torch.distributed`` process group, one rank a
    process (gloo on CPU tensors, NCCL on CUDA tensors): this process is
    ring position ``group.rank()`` with one chunk of X on ``device``.
    The shift is a ``batch_isend_irecv`` to rank r+1 and from rank r-1,
    started before the step's kernel and waited on after it (NCCL's wait
    orders the current stream after the transfer; gloo's returns when the
    bytes are in); y_slots are collected by ``all_gather``."""

    def __init__(self, group=None, device="cuda"):
        import torch.distributed as dist

        self.dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.n_row = dist.get_world_size(self.group)
        self.n_k = 1
        self.rank = dist.get_rank(self.group)
        self._dev = resolve_device(device)
        self.cuda = self._dev.type == "cuda"
        self.ranks = [(self.rank, 0)]

    def device(self, q) -> torch.device:
        return self._dev

    @property
    def out_device(self) -> torch.device:
        return self._dev

    def _global(self, r: int) -> int:
        return self.dist.get_global_rank(self.group, r)

    @contextlib.contextmanager
    def on_rank(self, q, step: int):
        if self.cuda:
            with torch.cuda.device(self._dev):
                yield
        else:
            yield

    def begin(self, bufs):
        pass

    def start(self, step: int, bufs):
        q = self.ranks[0]
        nxt = self._global((self.rank + 1) % self.n_row)
        prv = self._global((self.rank - 1) % self.n_row)
        ops = [self.dist.P2POp(self.dist.isend, held(bufs, q, step), nxt, self.group),
               self.dist.P2POp(self.dist.irecv, held(bufs, q, step + 1), prv, self.group)]
        with torch.profiler.record_function(SHIFT_SPAN):
            return self.dist.batch_isend_irecv(ops)

    def kernels_issued(self, step: int, bufs):
        pass

    def wait(self, handle):
        for req in handle:
            req.wait()

    def gather(self, ys):
        y = ys[self.ranks[0]].contiguous()
        parts = [torch.empty_like(y) for _ in range(self.n_row)]
        self.dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=0)


def ring_transport(mesh=None, group=None, device="cuda"):
    """The transport of a builder's ``mesh=`` (a ``Mesh`` or a
    ``LocalRing``) or ``group=`` (a process group or a ``GroupRing``;
    ``device`` is then this process's device)."""
    if (mesh is None) == (group is None):
        raise ValueError("give a mesh= or a group=, not both")
    if mesh is not None:
        return mesh if isinstance(mesh, LocalRing) else LocalRing(mesh)
    return group if isinstance(group, GroupRing) else GroupRing(group, device)


# ------------------------------------------------------------------ the ring

def held(bufs, q, step: int):
    """The chunk buffer rank q reads at ``step``: its own chunk (from
    put_inputs, never written) at step 0, then two buffers in turn, which
    the shifts fill."""
    return bufs[q][0] if step == 0 else bufs[q][1 + step % 2]


def _ring_loop(transport, bufs, ys, buckets, n_devices: int, kt: int, kl: int):
    """The ring: D steps; at step s each rank multiplies its bucket for
    chunk (r - s) mod D into its y_rows, while the chunk for step s+1 is in
    flight.  No host sync."""
    d = n_devices
    transport.begin(bufs)
    for s in range(d):
        handle = transport.start(s, bufs) if s + 1 < d else None
        for q in transport.ranks:
            with transport.on_rank(q, s):
                buckets[(q[0], transport.device(q))][(q[0] - s) % d](held(bufs, q, s), ys[q],
                                                                     kt, kl)
        if handle is not None:
            if s + 2 < d:
                transport.kernels_issued(s, bufs)
            transport.wait(handle)


def _build_ring(mesh, *, n_devices: int, arrays: tuple, slot_of_origrow, out_slots: int,
                n_chunk_rows: int, tail_pad: int, k_multiple, make_bucket,
                allow_k_shard: bool = True, fold_out=None, group=None, device="cuda"):
    """The shared ring harness (one ring, five kernels).

    ``arrays`` are the per-(device, ring chunk) format planes, each shaped
    [D, C, ...].  Each rank takes its device's planes, and
    ``make_bucket(planes, n_x)`` makes, once, the runner of one (rank,
    chunk) bucket: ``run(x_cur, y, kt, k)`` adds that bucket's product with
    the X chunk [n_x, Kp] into y [out_slots, Kp] (``k``: X's live
    columns).  ``k_multiple`` maps the local K width to the kernel's K-tile;
    ``tail_pad`` zero rows are appended to every X chunk, as the JAX ring
    does for its TPU windows (the row walks read only the chunk's columns).
    Returns (fn, put_inputs): ``fn(*put_inputs(x)) -> Y`` [M, K] on the
    output device."""
    transport = ring_transport(mesh, group, device)
    d = n_devices
    if transport.n_row != d:
        raise ValueError(f"the ring has {transport.n_row} rows ranks, the format {d} devices")
    if transport.n_k > 1 and not allow_k_shard:
        raise ValueError("this ring does not shard K: give a mesh with one 'k' column")
    n_x = n_chunk_rows + tail_pad

    # each rank's planes on its device, once per (row rank, device), and a
    # runner per (rank, chunk) bucket built from them
    planes, buckets = {}, {}
    for q in transport.ranks:
        key = (q[0], transport.device(q))
        if key in planes:
            continue
        mine = tuple(a[q[0]].to(key[1]).contiguous() for a in arrays)
        planes[key] = mine
        buckets[key] = [make_bucket(tuple(a[c] for a in mine), n_x) for c in range(d)]
    slot = slot_of_origrow.to(transport.out_device)
    placed = tuple(planes[(q[0], transport.device(q))] for q in transport.ranks)

    def fn(placed_in, slot_in, xs):
        if placed_in is not placed or slot_in is not slot:
            raise ValueError("fn takes the planes and slot map of this builder's put_inputs")
        parts, kt, kl = xs
        bufs, ys = {}, {}
        for q in transport.ranks:
            x0 = parts[q]
            bufs[q] = (x0, torch.empty_like(x0), torch.empty_like(x0))
            ys[q] = torch.zeros((out_slots, x0.shape[1]), dtype=torch.float32,
                                device=x0.device)
        _ring_loop(transport, bufs, ys, buckets, d, kt, kl)
        for q in transport.ranks:
            ys[q] = ys[q][:, :kl]
        y_slots = transport.gather(ys)
        if fold_out is not None:
            y_slots = fold_out(y_slots)
        return unpack_slots(y_slots, slot)

    def put_inputs(x):
        x = host_x(x)
        kl = k_blocks(x.shape[1], transport.n_k)
        kt = k_multiple(kl)
        kp = round_up(kl, max(kt, 4))
        x = pad_dense_rows(x, d * n_chunk_rows)
        if x.shape[0] != d * n_chunk_rows:
            raise ValueError(f"X has {x.shape[0]} rows, the format {d * n_chunk_rows} at most")
        xc = x.reshape(d, n_chunk_rows, -1)
        parts = {}
        for q in transport.ranks:
            r, j = q
            parts[q] = torch.zeros((n_x, kp), dtype=torch.float32, device=transport.device(q))
            parts[q][:n_chunk_rows, :kl].copy_(xc[r][:, j * kl:(j + 1) * kl])
        return placed, slot, (parts, kt, kl)

    fn.transport, fn.buckets = transport, buckets
    return fn, put_inputs


# ------------------------------------------------------------------ builders

def _walk_bucket(rows_cuda, rows_plain, build_walk, planes, n_x, **kw):
    """A bucket runner over a row walk kernel: the walk built once here on a
    CUDA rank; a CPU rank's plain version adds its partial into y."""
    walk = build_walk(planes, n_x) if planes[0].is_cuda else None

    def run(x, y, kt, k):
        if walk is not None:
            rows_cuda(*planes, x, kt=kt, walk=walk, k=k, out=y, **kw)
        else:
            y += rows_plain(*planes, x, kt=kt, **kw)

    run.planes = planes
    return run


def _window_walk(rb):
    from tpusparse_torch.kernels.row_walk import build_window_walk

    def build(planes, n_x):
        c0, cols, lrow, vals, nc_p = planes
        return build_window_walk(c0, cols, lrow, vals, nc_p, rb=rb, n=n_x)

    return build


def _span_arrays(fmt: HaloSpanFormat):
    return (fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p)


def build_halo_spmm(fmt: HaloStripeFormat, mesh=None, *, ktile: int | None = None,
                    unroll: int = 8, interpret: bool | None = None, group=None,
                    device="cuda"):
    """Returns (fn, put_inputs): the stripe ring (tpusparse/dist/overlap.py:
    257) over ``mesh`` (a one-column ``Mesh`` or ``LocalRing``) or
    ``group`` (a process group, this process's rank on ``device``); each
    step runs the stripe kernel (#10, ``stripe_rows_cuda``) over the
    bucket's live slots.  ``ktile`` caps the K-tile; ``unroll`` and
    ``interpret`` change nothing."""
    from tpusparse_torch.kernels.radix_gather import choose_kt
    from tpusparse_torch.kernels.stripe_gather import stripe_rows_cuda, stripe_rows_plain

    del unroll, interpret
    rb = fmt.rb

    def make_bucket(planes, n_x):
        cols, lrow, vals, live = planes

        def run(x, y, kt, k):
            if x.is_cuda:
                stripe_rows_cuda(cols, lrow, vals, x, rb=rb, kt=kt, live=live, out=y)
            else:
                y += stripe_rows_plain(cols, lrow, vals, x, rb=rb)

        run.planes = planes
        return run

    return _build_ring(
        mesh, n_devices=fmt.n_devices, arrays=(fmt.cols, fmt.lrow, fmt.vals, fmt.live_p),
        slot_of_origrow=fmt.slot_of_origrow, out_slots=fmt.stripes_per_device * rb,
        n_chunk_rows=fmt.n_chunk_rows, tail_pad=0,
        k_multiple=lambda kl: choose_kt(min(ktile or kl, 32, kl)), make_bucket=make_bucket,
        allow_k_shard=False, group=group, device=device)


def build_halo_span_spmm(fmt: HaloSpanFormat, mesh=None, *, ktile: int | None = None,
                         precision: str = "fp32x2", unroll: int = 4,
                         interpret: bool | None = None, group=None, device="cuda"):
    """Span-kernel ring (tpusparse/dist/overlap.py:460): each step runs the
    span kernel (#7, ``span_rows_cuda``) over the bucket's row walk.  A 2D
    ('rows', 'k') mesh also shards X's columns: one ring per 'k' column.
    ``unroll`` and ``interpret`` change nothing."""
    from tpusparse_torch.kernels import span_gather as span
    from tpusparse_torch.kernels.tile_onehot import PRECISIONS, choose_kt, default_ktile

    del unroll, interpret
    assert precision in PRECISIONS, precision

    def make_bucket(planes, n_x):
        return _walk_bucket(span.span_rows_cuda, span.span_rows_plain, _window_walk(fmt.rb),
                            planes, n_x, rb=fmt.rb, mode=precision)

    return _build_ring(
        mesh, n_devices=fmt.n_devices, arrays=_span_arrays(fmt),
        slot_of_origrow=fmt.slot_of_origrow, out_slots=fmt.programs_per_device * fmt.rb,
        n_chunk_rows=fmt.n_chunk_rows, tail_pad=((fmt.ct + 7) // 8) * 8,
        k_multiple=lambda kl: choose_kt(min(ktile or default_ktile(kl), 32)),
        make_bucket=make_bucket, group=group, device=device)


def build_halo_radix_spmm(fmt: HaloSpanFormat, mesh=None, *, kt: int = 8,
                          mode: str = "fp32x2", unroll: int = 4,
                          interpret: bool | None = None, group=None, device="cuda"):
    """Radix-kernel ring (tpusparse/dist/overlap.py:529): each step runs the
    radix kernel (#9, ``radix_rows_cuda``) over the bucket's row walk, X
    padded to a multiple of ``kt``.  ``unroll`` and ``interpret`` change
    nothing."""
    from tpusparse_torch.kernels import radix_gather as radix

    del unroll, interpret
    spr, _, _ = radix.radix_geometry(kt, mode)
    W = fmt.ct

    def make_bucket(planes, n_x):
        return _walk_bucket(radix.radix_rows_cuda, radix.radix_rows_plain,
                            _window_walk(fmt.rb), planes, n_x, rb=fmt.rb, mode=mode)

    return _build_ring(
        mesh, n_devices=fmt.n_devices, arrays=_span_arrays(fmt),
        slot_of_origrow=fmt.slot_of_origrow, out_slots=fmt.programs_per_device * fmt.rb,
        n_chunk_rows=fmt.n_chunk_rows, tail_pad=round_up(W + 8 * spr, 8 * spr),
        k_multiple=lambda kl: kt, make_bucket=make_bucket, group=group, device=device)


def build_halo_dg_spmm(fmt: HaloSpanFormat, mesh=None, *, kt: int = 8, mode: str = "fp32x2",
                       unroll: int = 4, interpret: bool | None = None, group=None,
                       device="cuda"):
    """dg-kernel ring (tpusparse/dist/overlap.py:599): each step runs the dg
    kernel (#1, ``dg_rows_cuda``) over the bucket's row walk, X padded to a
    multiple of ``kt``.  ``unroll`` and ``interpret`` change nothing."""
    from tpusparse_torch.kernels import dg_gather as dg

    del unroll, interpret

    def make_bucket(planes, n_x):
        return _walk_bucket(dg.dg_rows_cuda, dg.dg_rows_plain, _window_walk(fmt.rb), planes,
                            n_x, rb=fmt.rb, mode=mode)

    return _build_ring(
        mesh, n_devices=fmt.n_devices, arrays=_span_arrays(fmt),
        slot_of_origrow=fmt.slot_of_origrow, out_slots=fmt.programs_per_device * fmt.rb,
        n_chunk_rows=fmt.n_chunk_rows, tail_pad=((fmt.ct + 127) // 128) * 128 + 128,
        k_multiple=lambda kl: kt, make_bucket=make_bucket, group=group, device=device)


def fold_pyramid(y_slots, split_levels: int):
    """[y; fold2(y); fold4(y); fold8(y)]: the pairwise-sum pyramid that a
    dgt slot map indexes, for ``split_levels`` pieces a row at most."""
    pyr = [y_slots]
    for _ in range(split_levels.bit_length() - 1):
        prev = pyr[-1]
        pyr.append(prev.reshape(prev.shape[0] // 2, 2, *prev.shape[1:]).sum(1))
    return torch.cat(pyr, dim=0) if split_levels > 1 else y_slots


def build_halo_dgt_spmm(fmt: HaloDgtFormat, mesh=None, *, unroll: int = 8,
                        scatter: str = "select", fold: bool = True,
                        interpret: bool | None = None, group=None, device="cuda"):
    """dgt-kernel ring (tpusparse/dist/overlap.py:816): each step runs the
    dgt kernel (#3, ``dgt_rows_cuda``) over the bucket's row walk; split
    rows fold through the pairwise-sum pyramid before the slot gather.
    ``scatter`` ('select' or 'fullrow'), ``fold``, ``unroll`` and
    ``interpret`` steered the TPU kernel and change nothing."""
    from tpusparse_torch.kernels import dgt_gather as dgt

    assert scatter in ("select", "fullrow"), scatter
    del unroll, fold, interpret

    def build_walk(planes, n_x):
        wins, cols, lrw, vals, nc_p = planes
        return dgt.build_dgt_walk(wins, cols, lrw, vals, nc_p, rb=fmt.rb, kt=fmt.kt,
                                  mode=fmt.mode, resid=fmt.resid, n=n_x)

    def make_bucket(planes, n_x):
        return _walk_bucket(dgt.dgt_rows_cuda, dgt.dgt_rows_plain, build_walk, planes, n_x,
                            rb=fmt.rb, mode=fmt.mode, resid=fmt.resid)

    return _build_ring(
        mesh, n_devices=fmt.n_devices,
        arrays=(fmt.wins, fmt.cols, fmt.lrw, fmt.vals, fmt.nc_p),
        slot_of_origrow=fmt.slot_of_origrow, out_slots=fmt.programs_per_device * fmt.rb,
        n_chunk_rows=fmt.n_chunk_rows, tail_pad=0, k_multiple=lambda kl: fmt.kt,
        make_bucket=make_bucket, fold_out=lambda y: fold_pyramid(y, fmt.split_levels),
        group=group, device=device)
