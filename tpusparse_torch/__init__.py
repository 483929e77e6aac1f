"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

The JAX package ``tpusparse`` is the reference; this package mirrors its
layout and names (config, levels, io, meta, ops, oracle, generator,
kernels, schedule, bench, tune, batched, nn, autodiff) and imports nothing
from it.  Its kernels
are written by hand in CUDA C++ for sm_90a (``tpusparse_torch/csrc``), each
beside a plain PyTorch version of the same function.

Entry points run on the card (``device="cuda"``, the default) and raise
when there is none; only ``device="cpu"`` runs the plain versions.  Ported
so far: ``spmm``, ``entry`` (the flagship dgt SpMM), ``tune.tune`` and ``schedule.build_plan`` with every
schedule family (the sort and bucket options included),
``generator.build_stripe_plan`` and ``build_tile_plan``, SpMV (``spmv``,
``spmv.spmv_fn`` with every method, ``spmv.spmv_multi_fn``), and the
pruned-weight serving surface: ``nn.SparseLinear`` (``from_coo``,
``from_dense``, ``from_nm``, ``from_block``), ``batched.batched_spmm``,
``kernels.nm_structured`` and ``kernels.block_ell``; and training:
``autodiff.spmm_fn`` (the backward on A^T's plan), ``autodiff.spmm_trainable``
and ``kernels.sddmm`` (trainable values: the SDDMM value gradient and the
transpose apply), ``nn.TrainableSparseLinear`` and the differentiable
``SparseLinear.from_coo`` / ``from_block``; graph analytics
(``graph.semiring_spmv``, ``bfs``, ``sssp``, ``pagerank``,
``connected_components``, their plus_times and or_and matvecs on the dg
SpMV kernel) and SpGEMM (``spgemm.spgemm``, ``spgemm_fn``: A's plan on the
card, B's column tiles densified and re-sparsified there); the native host
helpers (``native``: the .mtx parser and the packers' walks, built by g++
from ``csrc/tpusparse_host.cpp``) and the artifact store (``artifacts``,
``results``; ``tune`` saves its winner); the command line
(``python -m tpusparse_torch``), the bench tools (``bench.baselines``,
``microbench`` with the card's probe, ``sol``, ``suite``, ``zoo``,
``report``), the real-data loaders (``io.realdata``), the torch
conversions of ``CooMatrix`` and ``narrow_dtype``, and
``transforms.compress``; the multi-device paths (``dist``: ``make_mesh``,
the sharded stripe SpMM, the five halo rings on a mesh of devices in one
process or over ``torch.distributed``, the dry run), ``bench.scaling``,
``bench.projection`` and the port's examples (``examples/torch_0*.py``).
Still to port: the headline benchmark (ROADMAP.md A.4 part 1).
"""

from tpusparse_torch.config import Config, config_override, get_config, set_config
from tpusparse_torch.gates import CARD_GATES, TPU_GATES, Gates
from tpusparse_torch.io.mtx import CooMatrix, read_mtx, write_mtx
from tpusparse_torch.levels import Level
from tpusparse_torch.meta.item import MetaDataItem, narrow_dtype
from tpusparse_torch.meta.set import MetaDataSet

__version__ = "0.1.0"


def spmm(mat, x, schedule=None, device="cuda", *, gates=None):
    """One-shot SpMM: Y = A @ X as a tensor on ``device``.  X is [N, K]
    (numpy or a tensor on ``device``).  With no schedule, takes the default
    for the K regime under ``gates`` (``tpusparse_torch.gates``; the card's
    ``CARD_GATES`` when None): on the card ``dg_span`` at K <= 128 at any
    N, ``tile_onehot`` at K > 128; under ``TPU_GATES`` the JAX package's
    (``dg_span`` where X passes its size gate, ``radix_span`` at K <= 32
    where only radix's holds, ``span_onehot`` or ``span_colsplit`` past
    them).  Pass a Schedule to control it, or use
    ``tpusparse_torch.tune.tune`` for the autotuned path."""
    from tpusparse_torch.gates import CARD_GATES
    from tpusparse_torch.schedule import build_plan, default_schedule

    gates = CARD_GATES if gates is None else gates
    if schedule is None:
        schedule = default_schedule(mat, x.shape[-1], gates=gates)
    plan = build_plan(mat, schedule, device=device, gates=gates)
    return plan(x)


def entry(device="cuda"):
    """The flagship single-device forward (``__graft_entry__.py::entry``):
    returns ``(fn, (x,))``, ``fn(x) -> Y [512, 16]`` the dgt SpMM of the
    JAX entry's matrix (``power_law_coo(512, 384, avg_nnz_per_row=6.0,
    seed=0)``) in its pack (rb 128, g 128, kt 16, fp32x2, nw 4) on
    ``device``, x [384, 16] fp32 from ``default_rng(0)`` on it.  On the
    card ``fn`` launches the dgt kernel (#3); on the CPU its plain
    version."""
    import numpy as np
    import torch

    from tpusparse_torch.io import builder
    from tpusparse_torch.kernels.dgt_gather import dgt_spmm, pack_dgt

    mat = builder.power_law_coo(512, 384, avg_nnz_per_row=6.0, seed=0)
    fmt = pack_dgt(mat, rb=128, g=128, kt=16, mode="fp32x2", nw=4, device=device)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((384, 16)),
                        dtype=torch.float32, device=fmt.device)

    def fn(x):
        return dgt_spmm(fmt, x)

    fn.format, fn.matrix = fmt, mat
    return fn, (x,)


def _lazy(name):
    import importlib

    mod, attr = name.rsplit(".", 1)
    return getattr(importlib.import_module(mod), attr)


def __getattr__(name):
    lazy_map = {
        "Schedule": "tpusparse_torch.schedule.Schedule",
        "build_plan": "tpusparse_torch.schedule.build_plan",
        "autotune": "tpusparse_torch.tune.tune",
        "SpmmPlan": "tpusparse_torch.generator.SpmmPlan",
        "spmv": "tpusparse_torch.spmv.spmv",
        "spgemm": "tpusparse_torch.spgemm.spgemm",
        "spgemm_fn": "tpusparse_torch.spgemm.spgemm_fn",
        "semiring_spmv": "tpusparse_torch.graph.semiring_spmv",
        "SparseLinear": "tpusparse_torch.nn.SparseLinear",
        "batched_spmm": "tpusparse_torch.batched.batched_spmm",
        "spmm_fn": "tpusparse_torch.autodiff.spmm_fn",
        "spmm_trainable": "tpusparse_torch.autodiff.spmm_trainable",
        "sddmm": "tpusparse_torch.kernels.sddmm.sddmm",
        "TrainableSparseLinear": "tpusparse_torch.nn.TrainableSparseLinear",
        "make_mesh": "tpusparse_torch.dist.shard.make_mesh",
        "shard_stripe_format": "tpusparse_torch.dist.shard.shard_stripe_format",
        "build_sharded_stripe_spmm": "tpusparse_torch.dist.shard.build_sharded_stripe_spmm",
    }
    if name in lazy_map:
        return _lazy(lazy_map[name])
    raise AttributeError(name)


__all__ = [
    "Config",
    "get_config",
    "set_config",
    "config_override",
    "Level",
    "MetaDataSet",
    "MetaDataItem",
    "narrow_dtype",
    "CooMatrix",
    "read_mtx",
    "write_mtx",
    "spmm",
    "entry",
    "Gates",
    "CARD_GATES",
    "TPU_GATES",
    "Schedule",
    "build_plan",
    "autotune",
    "SpmmPlan",
    "spmv",
    "spgemm",
    "spgemm_fn",
    "semiring_spmv",
    "SparseLinear",
    "batched_spmm",
    "spmm_fn",
    "spmm_trainable",
    "sddmm",
    "TrainableSparseLinear",
    "make_mesh",
    "shard_stripe_format",
    "build_sharded_stripe_spmm",
]
