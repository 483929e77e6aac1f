"""row_walk — the row order that the dg (#1, #2), dgt (#3, #4), span
(#7, #8) and radix (#9) kernels walk.

None of these formats stores its slots by row: a dg, span or radix chunk
is sorted by column (a brick-ELL chunk by stored order), a dgt tile by
window and residue class, so in slot order almost every slot is a row run
of its own.  The kernels (``csrc/row_walk.cuh``: ``walk_kernel`` for X of
4 columns and more, ``walk1_kernel`` for x of one, the dg and radix SpMV)
sum each row run in registers and add it into y_rows once, so they walk a
derived list instead: every live slot of the pattern once, as (y_rows
row, X column, flat slot index), sorted by (row, slot).  The list is built
on the device with torch ops from the decode the plain versions use, at a
format's first launch on the card, and kept on the format
(``DgFormat.walk``, ``DgtFormat.walk``, ``SpanFormat.walk``,
``RadixFormat.walk``), so that ``dataclasses.replace`` carries it;
``with_values`` gives it the new plane's values (``RowWalk.for_plane``).
It also holds the values of the plane it was built from in its order,
which the kernel streams when a caller multiplies by that very plane as it
stood then; any other plane (the trainable path's ``v * mask``) is
gathered through the slot index.  Streaming the values took a third off
the SpMV kernel's time on the card (PERF.md).

A walk remembers the planes it was decoded from and their version
counters, so a plane written in place (``load_state_dict`` into a layer's
buffers) is seen: ``dg_row_walk``, ``dgt_row_walk``, ``span_row_walk`` and
``radix_row_walk`` build the walk anew, and the wrappers refuse a walk
that is not the planes' they are given.

Live slots are the pattern's: where the format kept ``perm_of_nz`` those
slots, a stored zero included (training may make it nonzero); otherwise the
packed plane's nonzeros in a chunk before ``nc_p``, and then a plane with a
nonzero anywhere else is refused rather than partly summed.  The kernel
still skips a value that reads 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from tpusparse_torch.kernels.common import cdiv, launch_checked

#: slots a block takes, by panel width (the columns a slot stream carries):
#: more where a stream has one or two lanes, fewer where it carries 256 or
#: 512 columns (chosen on the card, PERF.md)
WALK_BLOCK_SLOTS = {4: 2048, 8: 2048, 16: 1024, 32: 1024, 64: 1024, 128: 1024, 256: 512,
                    512: 512}
WALK_PANELS = tuple(WALK_BLOCK_SLOTS)
#: the one-column walk kernel's geometry: slots a warp, warps a block and
#: steps of 32 slots a warp loads at once (chosen on the card, PERF.md)
WALK1_GEOMETRY = (256, 4, 2)
#: the walk indexes a format's value plane with int32 (and a kernel's last
#: block reads up to two blocks of slots past its end): a plane of this
#: many slots or more has no row walk
WALK_SLOT_LIMIT = 2 ** 31 - 2 * max(WALK_BLOCK_SLOTS.values())
#: bytes of the walk a live slot: row, column, slot and value
WALK_SLOT_BYTES = 16


@dataclasses.dataclass(frozen=True)
class RowWalk:
    """A format's live slots in (y_rows row, slot) order, on its device:

      row  [S] int32  the slot's row of y_rows (p * rb + the format's row)
      col  [S] int32  its column of X
      slot [S] int32  its flat index in the [P, NC, G] value plane
      val  [S] f32    its value in ``val_src``, the plane the walk was
                      built from (or given by ``for_plane``)

    ``n_rows`` (P * rb), ``n_cols`` (X's rows) and ``plane_slots`` (P * NC
    * G) tie it to its format, ``pattern`` (the index planes it was decoded
    from), ``versions`` (their version counters then) and ``val_version``
    (``val_src``'s) to the planes as they stood; ``live_from_values``: its
    live slots are ``val_src``'s nonzeros (no ``perm_of_nz``).  ``runs`` is
    the number of row runs in walk order (the distinct rows),
    ``build_seconds`` what building it took."""

    row: Any
    col: Any
    slot: Any
    val: Any
    val_src: Any
    pattern: tuple
    versions: tuple
    val_version: Any
    live_from_values: bool
    n_rows: int
    n_cols: int
    plane_slots: int
    runs: int
    build_seconds: float

    @property
    def n_slots(self) -> int:
        return self.row.numel()

    @property
    def nbytes(self) -> int:
        return WALK_SLOT_BYTES * self.n_slots

    def for_plane(self, vals) -> "RowWalk":
        """The same walk with the values of ``vals`` (a plane of the same
        pattern, the format's shape), for a values-only update."""
        return dataclasses.replace(self, val=_walk_values(vals, self.slot), val_src=vals,
                                   val_version=version_of(vals))

    def built_from(self, pattern) -> bool:
        """Whether the walk was decoded from the index planes ``pattern``
        as they stand: the same tensors, not written since."""
        return (len(pattern) == len(self.pattern)
                and all(a is b for a, b in zip(pattern, self.pattern))
                and tuple(map(version_of, pattern)) == self.versions)

    def holds(self, vals) -> bool:
        """Whether ``val`` holds the values of ``vals`` as it stands."""
        return vals is self.val_src and version_of(vals) == self.val_version

    def fresh(self, pattern, vals) -> bool:
        """Whether the walk is that of a format with these planes now."""
        return self.built_from(pattern) and self.holds(vals)


def version_of(t):
    """``t``'s version counter, which every in-place write raises (None
    for an inference tensor, which keeps none)."""
    return None if t.is_inference() else t._version


def _walk_values(vals, slot) -> torch.Tensor:
    return vals.reshape(-1)[slot.long()].to(torch.float32).contiguous()


def live_slots(vals, walked, perm_of_nz=None) -> torch.Tensor:
    """Bool [P, NC, G]: the slots of ``perm_of_nz`` where given, else the
    nonzeros of the packed plane ``vals`` where ``walked`` (a chunk before
    ``nc_p``)."""
    if perm_of_nz is None:
        return (vals != 0) & walked
    live = torch.zeros(vals.numel(), dtype=torch.bool, device=vals.device)
    live[torch.as_tensor(perm_of_nz, dtype=torch.long, device=vals.device)] = True
    return live.view(vals.shape)


def build_row_walk(row, col, live, vals, *, pattern, live_from_values: bool, n_rows: int,
                   n_cols: int) -> RowWalk:
    """The RowWalk of the slots where ``live``, from every slot's y_rows
    ``row`` and X ``col`` (integer tensors of the value plane's shape),
    decoded from the index planes ``pattern``, and the plane ``vals``; a
    column at or past ``n_cols`` is left out."""
    t0 = time.perf_counter()
    plane = live.numel()
    if plane >= WALK_SLOT_LIMIT:
        raise ValueError(f"{plane} slots: the row walk indexes them with int32")
    col = col.reshape(-1)
    idx = torch.nonzero(live.reshape(-1) & (col < n_cols)).reshape(-1)  # rising slots
    rows, order = torch.sort(row.reshape(-1)[idx], stable=True)         # (row, slot)
    idx = idx[order]
    runs = int((rows[1:] != rows[:-1]).sum()) + int(rows.numel() > 0)
    walk = RowWalk(row=rows.to(torch.int32).contiguous(),
                   col=col[idx].to(torch.int32).contiguous(),
                   slot=idx.to(torch.int32).contiguous(), val=_walk_values(vals, idx),
                   val_src=vals, pattern=tuple(pattern),
                   versions=tuple(map(version_of, pattern)), val_version=version_of(vals),
                   live_from_values=live_from_values, n_rows=n_rows, n_cols=n_cols,
                   plane_slots=plane, runs=runs, build_seconds=0.0)
    if walk.row.is_cuda:
        torch.cuda.synchronize(walk.row.device)
    return dataclasses.replace(walk, build_seconds=time.perf_counter() - t0)


def build_window_walk(c0, cols, lrow, vals, nc_p, *, rb, n, perm_of_nz=None) -> RowWalk:
    """The row walk of the window formats (dg, span, segment-span, radix
    and brick-ELL planes), whose slot names X's column ``c0 + cols`` and
    y_rows row ``p*rb + lrow``: the live slots (those of ``perm_of_nz``
    where given, else the nonzeros of ``vals`` in a chunk before ``nc_p``)
    with that row and column (a column at or past ``n`` left out), sorted
    by (row, slot)."""
    P, NC, G = cols.shape
    col = c0.reshape(P, NC, 1).long() + cols.long()
    row = torch.arange(P, device=cols.device).view(P, 1, 1) * rb + lrow.long()
    walked = torch.arange(NC, device=cols.device).view(1, NC, 1) < nc_p.reshape(P, 1, 1)
    return build_row_walk(row, col, live_slots(vals, walked, perm_of_nz), vals,
                          pattern=(c0, cols, lrow, nc_p), live_from_values=perm_of_nz is None,
                          n_rows=P * rb, n_cols=n)


def window_row_walk(fmt) -> RowWalk:
    """The row walk of a window format (``DgFormat``, ``SpanFormat``,
    ``SegmentSpanFormat``, ``RadixFormat``), built at first use and kept on
    the format as ``fmt.walk``; built anew where a plane was replaced or
    written in place since."""
    if fmt.walk is None or not fmt.walk.fresh((fmt.c0, fmt.cols, fmt.lrow, fmt.nc_p), fmt.vals):
        fmt.walk = build_window_walk(fmt.c0, fmt.cols, fmt.lrow, fmt.vals, fmt.nc_p, rb=fmt.rb,
                                     n=fmt.shape[1], perm_of_nz=getattr(fmt, "perm_of_nz", None))
    return fmt.walk


def walk_geometry(kc: int) -> tuple[int, int, int]:
    """The kernel's (columns it reads and writes, panel width, slots a
    block) for ``kc`` columns of X: kc rounded up to 4 (a gathered row of
    up to 8 floats costs one 32-byte sector either way), the narrowest
    panel that holds it (512 and several panels past it), and the panel's
    ``WALK_BLOCK_SLOTS``."""
    kc4 = cdiv(kc, 4) * 4
    pw = next((w for w in WALK_PANELS if w >= kc4), WALK_PANELS[-1])
    return kc4, pw, WALK_BLOCK_SLOTS[pw]


def gathers(walk: RowWalk, vals, name: str) -> bool:
    """Whether the kernel gathers ``vals`` through the walk's slot index:
    it is not the plane whose values the walk holds, as it stands.  Where
    the walk's live slots are the packed plane's nonzeros, a plane with a
    nonzero off them is refused: the kernel would not sum it."""
    if walk.holds(vals):
        return False
    if walk.live_from_values:
        off = int(torch.count_nonzero(vals) - torch.count_nonzero(
            vals.reshape(-1).index_select(0, walk.slot)))
        if off:
            raise ValueError(f"{name}: the value plane has {off} nonzeros off the format's "
                             "pattern (pack with keep_perm=True to give it stored zeros)")
    return True


def check_walk(name: str, walk: RowWalk, pattern, vals, x, *, rows: int) -> None:
    """Raises unless ``walk`` is a RowWalk decoded from the index planes
    ``pattern`` as they stand, of a format whose value plane has ``vals``'s
    slots, ``rows`` rows of y_rows and X's rows, on X's device."""
    if walk is None or not isinstance(walk, RowWalk):
        raise ValueError(f"{name} walks the format's row walk: pass walk=")
    if not walk.built_from(pattern):
        raise ValueError(f"{name}: the row walk was not built from these index planes as "
                         "they stand (take it from dg_row_walk, dgt_row_walk, span_row_walk or "
                         "radix_row_walk)")
    if (walk.row.device != x.device or walk.plane_slots != vals.numel()
            or walk.n_cols != x.shape[0] or walk.n_rows != rows):
        raise ValueError(f"{name}: the row walk ({walk.plane_slots} slots, {walk.n_rows} "
                         f"rows, {walk.n_cols} columns, on {walk.row.device}) is not this "
                         "format's")


def launch_walk(fn, name: str, walk: RowWalk, pattern, vals, x, *, rows: int,
                k: int | None, bf16: bool, out=None):
    """y_rows [rows, Kp] from one launch of a library's row walk kernel
    ``fn`` over ``walk``, which must be decoded from the index planes
    ``pattern`` as they stand (``check_walk``), with the value plane
    ``vals`` (fp32, the format's shape) and X [N, Kp] (checked by the
    caller); ``k`` is the number of X's columns that carry the product
    (None: all Kp), the rest zero padding that the kernel neither reads nor
    writes.  The kernel streams the walk's own values where it holds those
    of ``vals``, else gathers from ``vals`` (``gathers``).  ``out``: a
    contiguous fp32 [rows, Kp] tensor on X's device that the kernel adds
    into (it adds each row run into y_rows), returned in place of a new
    zeroed y_rows: a caller that sums several launches (a ring's steps)
    saves a pass over y_rows a launch."""
    check_walk(name, walk, pattern, vals, x, rows=rows)
    kp = x.shape[1]
    kc, pw, bs = walk_geometry(kp if k is None else min(k, kp))
    if kp % 4 or kc > kp:
        raise ValueError(f"{name}: X {tuple(x.shape)} is not padded to a multiple of 4")
    gather = gathers(walk, vals, name)
    if out is None:
        y = torch.zeros((walk.n_rows, kp), dtype=torch.float32, device=x.device)
    else:
        check_out(name, out, (walk.n_rows, kp), x.device)
        y = out
    launch_checked(fn, name, (walk.row, walk.col, walk.slot, vals if gather else walk.val, x, y),
                   (walk.n_slots, kp, kc, pw, int(bf16), bs, int(gather)))
    return y


def check_out(name: str, out, shape, device) -> None:
    """Raises unless ``out`` is a contiguous fp32 tensor of ``shape`` on
    ``device``: the y_rows a kernel adds into."""
    if (not isinstance(out, torch.Tensor) or out.dtype != torch.float32
            or tuple(out.shape) != tuple(shape) or out.device != device
            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous float32 tensor {tuple(shape)} on "
                         f"{device}")


def launch_walk1(fn, name: str, walk: RowWalk, pattern, vals, x, *, rows: int,
                 geometry: tuple[int, int, int] = WALK1_GEOMETRY, bf16: bool = False):
    """y_rows [rows] from one launch of the one-column walk kernel ``fn``
    over ``walk`` (checked as ``launch_walk`` checks it), with the value
    plane ``vals`` and x [N] (checked by the caller); ``geometry``: slots a
    warp, warps a block and steps of 32 slots loaded at once; ``bf16``
    rounds each product to bf16."""
    check_walk(name, walk, pattern, vals, x, rows=rows)
    gather = gathers(walk, vals, name)
    y = torch.zeros(walk.n_rows, dtype=torch.float32, device=x.device)
    launch_checked(fn, name, (walk.row, walk.col, walk.slot, vals if gather else walk.val, x, y),
                   (walk.n_slots, *geometry, int(gather), int(bf16)))
    return y


def walk_rows_plain(walk: RowWalk, vals, x, *, bf16: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: y_rows [walk.n_rows, Kp]
    with ``y_rows[row] += vals[slot] * X[col]`` over the walk in its order,
    a value of 0 skipped; bf16 rounds each product."""
    v = vals.reshape(-1)[walk.slot.long()].float()
    keep = v != 0
    prod = v[keep].view(-1, 1) * x[walk.col.long()[keep]]
    if bf16:
        prod = prod.to(torch.bfloat16).float()
    y = torch.zeros((walk.n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    return y.index_add_(0, walk.row.long()[keep], prod)
