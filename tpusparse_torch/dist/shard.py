"""Multi-device SpMM: the sharded stripe SpMM (counterpart of
``tpusparse/dist/shard.py``).

Strategy (SURVEY §2.6): row-partition A across devices, here the
row-aligned stripes of StripeFormat, which the merge-path transform has
already balanced by nonzeros; shard the dense X by its columns; and let
each device produce its own stripe-slot rows with the stripe kernel (#10).
The final slot gather collects the ranks' row blocks onto the output
device.  X's column shards need no communication on the contraction.

The mesh is 2D: ('rows', 'k').  It is a grid of torch devices held in one
process, and an entry may repeat: ``make_mesh(4, devices=["cuda:0"] * 4)``
gives four ranks on one card, each with its own planes and buffers, where
the JAX package took virtual devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.format import StripeFormat
from tpusparse_torch.kernels.common import (cdiv, pad_dense_cols, prep_x, resolve_device,
                                            unpack_slots)

AXES = ("rows", "k")


class Mesh:
    """A (n_row, n_k) grid of torch devices with the axis names ('rows',
    'k'): ``devices`` is a numpy object array of ``torch.device``;
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names=AXES):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for r, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("every row of the mesh holds the same number of devices")
            for j, d in enumerate(row):
                grid[r, j] = resolve_device(d)
        if tuple(axis_names) != AXES:
            raise ValueError(f"mesh axes are {AXES}, not {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def out_device(self) -> torch.device:
        """The device that the slot gather collects Y on: the first rank's."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_row: int, n_k: int = 1, devices=None) -> Mesh:
    """A (n_row, n_k) mesh over ``devices`` (names or ``torch.device``s, the
    first n_row * n_k taken in row-major order).  None takes every card of
    the machine, ``cuda:0`` ... ``cuda:{n-1}``, and raises when there are too
    few; a list that repeats a device gives ranks that share it
    (``["cuda:0"] * 4``, or ``["cpu"] * 8`` for the plain versions)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n to run "
                               "the plain PyTorch versions of the kernels")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n_row * n_k:
        raise ValueError(f"need {n_row * n_k} devices, have {len(devices)}")
    return Mesh([devices[r * n_k:(r + 1) * n_k] for r in range(n_row)])


def shard_stripe_format(fmt: StripeFormat, n_row: int) -> StripeFormat:
    """Pad the stripe count to a multiple of the row-axis size (padding
    stripes are all-zero: val=0, col=0, lrow=0, no live slot, so they
    contribute nothing)."""
    p = fmt.n_stripes
    target = -(-p // n_row) * n_row
    if target == p:
        return fmt
    padp = target - p

    def padarr(a):
        pad = torch.zeros((padp,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], dim=0)

    return dataclasses.replace(fmt, cols=padarr(fmt.cols), lrow=padarr(fmt.lrow),
                               vals=padarr(fmt.vals), live_p=padarr(fmt.live_p),
                               n_stripes=target)


def host_x(x) -> torch.Tensor:
    """X as an fp32 tensor: a tensor stays where it is, an array comes to
    the host, from where each rank takes its share."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return prep_x(x, torch.device("cpu"))


def k_blocks(k: int, n_k: int) -> int:
    """X's columns a 'k' rank holds: K split evenly over the axis."""
    if k % n_k:
        raise ValueError(f"K={k} does not split evenly over the 'k' axis of size {n_k}")
    return k // n_k


def placed(mesh: Mesh, arrays, n_row: int):
    """Each row rank's share of ``arrays`` (leading dim split in n_row
    equal blocks) on every device of its mesh row: ``out[r][j]`` is the
    tuple of rank (r, j)'s tensors, the same tensors where two ranks of a
    row share a device."""
    out = []
    for r in range(n_row):
        by_dev = {}
        row = []
        for dev in mesh.devices[r]:
            if dev not in by_dev:
                by_dev[dev] = tuple(a.reshape(n_row, -1, *a.shape[1:])[r].to(dev).contiguous()
                                    for a in arrays)
            row.append(by_dev[dev])
        out.append(row)
    return out


def build_sharded_stripe_spmm(fmt: StripeFormat, mesh: Mesh, *, ktile: int | None = None,
                              unroll: int = 8, interpret: bool | None = None):
    """Returns (fn, put_inputs): ``fn(*put_inputs(x)) -> Y`` [M, K] on the
    mesh's first device.  ``put_inputs(x)`` places each row rank's stripes
    (``cols``, ``lrow``, ``vals``, ``live``) and each 'k' rank's columns of
    X on its device; each rank runs the stripe kernel (#10,
    ``stripe_rows_cuda``; the plain version on CPU ranks) on its stripes
    and its columns, and the slot gather collects the ranks' row blocks.
    ``ktile`` caps the K-tile; ``unroll`` and ``interpret`` steered the
    TPU kernel only and change nothing."""
    from tpusparse_torch.kernels.radix_gather import choose_kt
    from tpusparse_torch.kernels.stripe_gather import stripe_rows_cuda, stripe_rows_plain

    del unroll, interpret
    n_row, n_k = mesh.devices.shape
    fmt = shard_stripe_format(fmt, n_row)
    rb = fmt.max_rows_per_stripe
    out_dev = mesh.out_device
    planes = placed(mesh, (fmt.cols, fmt.lrow, fmt.vals, fmt.live_p), n_row)
    slot = fmt.slot_of_origrow.to(out_dev)

    def fn(planes_in, slot_in, xs):
        if planes_in is not planes or slot_in is not slot:
            raise ValueError("fn takes the planes and slot map of this builder's put_inputs")
        parts = []
        for r in range(n_row):
            cols_part = []
            for j in range(n_k):
                cols, lrow, vals, live = planes[r][j]
                x, kt, kl = xs[r][j]
                if x.is_cuda:
                    y = stripe_rows_cuda(cols, lrow, vals, x, rb=rb, kt=kt, live=live)
                else:
                    y = stripe_rows_plain(cols, lrow, vals, x, rb=rb)
                cols_part.append(y[:, :kl].to(out_dev))
            parts.append(torch.cat(cols_part, dim=1))
        return unpack_slots(torch.cat(parts, dim=0), slot)

    def put_inputs(x):
        x = host_x(x)
        assert x.shape[0] == fmt.shape[1], f"X rows {x.shape[0]} != A cols {fmt.shape[1]}"
        kl = k_blocks(x.shape[1], n_k)
        kt = choose_kt(min(ktile or kl, 32, kl))
        kp = cdiv(kl, max(kt, 4)) * max(kt, 4)
        xs = [[(pad_dense_cols(x[:, j * kl:(j + 1) * kl].to(mesh.devices[r, j], torch.float32),
                               kp).contiguous(), kt, kl) for j in range(n_k)]
              for r in range(n_row)]
        return planes, slot, xs

    return fn, put_inputs
