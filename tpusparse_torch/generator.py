"""Plans (counterpart of ``tpusparse/generator.py``).

A plan is the packed format plus a Python callable that runs the kernel on
it; ``build_plan`` in ``tpusparse_torch.schedule`` makes one, and so do
``build_stripe_plan`` (the thread-total pipeline) and ``build_tile_plan``
(the tile pipeline) here, without a Schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class SpmmPlan:
    """A ready-to-run SpMM: ``plan(x)`` computes A @ x."""

    fn: Callable[[Any], Any]
    formats: list[Any]
    shape: tuple[int, int]
    meta: dict

    def __call__(self, x):
        return self.fn(x)

    def cost_summary(self, k: int | None = None) -> dict:
        """Static cost introspection: format bytes, padding, and the
        per-call useful-FLOP count (the reference prints the same quantities
        around its timing loop, code_generator.cc:589-648)."""
        # the dense-tile families count every byte in meta (a hybrid's
        # remainder formats too); the others by their formats
        fmt_bytes = self.meta.get("format_bytes") or sum(f.memory_bytes for f in self.formats)
        nnz_real = sum(getattr(f, "nnz_real", getattr(f, "nnz", 0)) for f in self.formats)
        out = {
            "schedule": self.meta.get("schedule"),
            "format_bytes": int(fmt_bytes),
            "padding_rate": self.meta.get("padding_rate"),
            "n_sub_plans": self.meta.get("n_subs", 1),
            "shape": list(self.shape),
        }
        if nnz_real:
            out["nnz"] = int(nnz_real)
        if k is not None and nnz_real:
            out["useful_gflop_per_call"] = 2.0 * nnz_real * k / 1e9
        return out


def prepare_stripe_format(mat, *, work_per_stripe: int = 1024, row_weight: int = 1,
                          sort: bool = True, nnz_multiple: int = 8, val_dtype=None,
                          device="cuda"):
    """The thread-total pipeline (tpusparse/generator.py:61; reference
    test_spmm_thread_total, token_test.cc:1003-1092): sort rows by length,
    merge-path partition into row-aligned stripes, equalize stripe nnz,
    pack; returns (format on ``device``, metadata set)."""
    from tpusparse_torch import transforms as T
    from tpusparse_torch.format import block_nnz_before_pad, pack_stripe
    from tpusparse_torch.levels import Level
    from tpusparse_torch.meta.set import create_init_metadata_set

    ms = create_init_metadata_set(mat)
    if sort:
        T.get_row_order_by_length(ms, 0)
        T.reorder_by_row_order(ms, 0)
        T.remove_empty_rows_in_end(ms, 0)
    T.block_merge_path(ms, 0, Level.TBLOCK, work_per_stripe, row_weight)
    live = block_nnz_before_pad(ms, 0)
    T.pad_blocks_to_uniform_nnz(ms, 0, Level.TBLOCK, multiple_of=nnz_multiple)
    fmt = pack_stripe(ms, 0, out_rows=mat.shape[0], val_dtype=val_dtype, live=live,
                      device=device)
    return fmt, ms


def build_stripe_plan(mat, *, work_per_stripe: int = 1024, row_weight: int = 1,
                      sort: bool = True, ktile: int | None = None, unroll: int = 8,
                      val_dtype=None, device="cuda") -> SpmmPlan:
    """A stripe plan without a Schedule (tpusparse/generator.py:86)."""
    from tpusparse_torch.kernels.stripe_gather import stripe_spmm

    fmt, ms = prepare_stripe_format(mat, work_per_stripe=work_per_stripe,
                                    row_weight=row_weight, sort=sort,
                                    nnz_multiple=max(unroll, 1), val_dtype=val_dtype,
                                    device=device)

    def fn(x):
        return stripe_spmm(fmt, x, ktile=ktile, unroll=unroll)

    return SpmmPlan(
        fn=fn,
        formats=[fmt],
        shape=mat.shape,
        meta={
            "kernel": "stripe_gather",
            "n_stripes": fmt.n_stripes,
            "stripe_nnz": fmt.stripe_nnz,
            "max_rows_per_stripe": fmt.max_rows_per_stripe,
            "padding_rate": fmt.padding_rate,
            "trace_steps": len(ms.trace),
        },
    )


def prepare_tile_format(mat, *, rb: int = 256, ct: int = 512, g: int = 128,
                        sort: bool = False, val_dtype=np.float32, device="cuda"):
    """The tile pipeline (tpusparse/generator.py:126): the length sort
    where ``sort``, then fixed-interval row blocking (RB) and column tiling
    (CT) inside the packer; returns (format on ``device``, metadata set)."""
    from tpusparse_torch import transforms as T
    from tpusparse_torch.format import pack_tile
    from tpusparse_torch.meta.set import create_init_metadata_set

    ms = create_init_metadata_set(mat)
    if sort:
        T.get_row_order_by_length(ms, 0)
        T.reorder_by_row_order(ms, 0)
    fmt = pack_tile(ms, 0, out_rows=mat.shape[0], rb=rb, ct=ct, g=g, val_dtype=val_dtype,
                    device=device)
    return fmt, ms


def build_tile_plan(mat, *, rb: int = 256, ct: int = 512, g: int = 128, sort: bool = False,
                    ktile: int | None = None, precision: str = "fp32x2",
                    val_dtype=np.float32, device="cuda") -> SpmmPlan:
    """A tile plan without a Schedule (tpusparse/generator.py:147)."""
    from tpusparse_torch.kernels.tile_onehot import tile_spmm

    fmt, _ = prepare_tile_format(mat, rb=rb, ct=ct, g=g, sort=sort, val_dtype=val_dtype,
                                 device=device)

    def fn(x):
        return tile_spmm(fmt, x, ktile=ktile, precision=precision)

    return SpmmPlan(
        fn=fn,
        formats=[fmt],
        shape=mat.shape,
        meta={
            "kernel": "tile_onehot",
            "precision": precision,
            "n_programs": fmt.n_programs,
            "n_chunks": fmt.n_chunks,
            "chunk_g": fmt.chunk_g,
            "rb": rb,
            "ct": ct,
            "padding_rate": fmt.padding_rate,
        },
    )
