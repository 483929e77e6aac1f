"""Format/plan artifact store (counterpart of ``tpusparse/artifacts.py``).

The reference persists every tuning candidate's transformed metadata arrays
(the *format*) plus its perf result under ``data_source/<rand_id>/``
(metadata_set.cc:517-571).  As in the JAX package, a packed format is saved
as one ``.npz`` (arrays) + ``.json`` (scalar fields) per artifact under the
config cache_dir, with the fields the JAX format has, under the same names:
an artifact either package saved loads into the port's format.

The port's derived indexes are not saved: the row walks (``walk``), the
live prefix (``live_p``), the chunk counts the JAX format lacks (``nc_p`` of
the span, tile and segment-span formats), Block-ELL's ``nb_p`` and work
items, the SDDMM tile index (``tiles``) and the dx column index
(``dx_index``).  Loading derives the first ones from the values (each
format's ``*_from_numpy``, which also checks shapes and index ranges), and
the walks and indexes are built at first use, as after ``load_state_dict``.
A bf16 value plane is saved as fp32 (exact) and named in the JSON's
``__bf16__``.

Every format class that the port packs is covered, ``DgFormat`` and
``DgtFormat`` included (the JAX ``load_format`` lists neither).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import time
from typing import Any

import numpy as np
import torch

from tpusparse_torch.config import get_config

#: class name -> (module, its ``*_from_numpy`` builder, the port-only fields
#: left out of an artifact, the product entry point: module, function)
_DERIVED = ("walk", "tiles", "dx_index", "live_p")
_FORMATS = {
    "StripeFormat": ("format", "stripe_format_from_numpy", (),
                     ("kernels.stripe_gather", "stripe_spmm")),
    "SegmentFormat": ("format", "segment_format_from_numpy", (),
                      ("kernels.nnz_split", "segment_spmm")),
    "NestedStripeFormat": ("format", "nested_format_from_numpy", (),
                           ("kernels.stripe_gather", "stripe_nested_spmm")),
    "TileFormat": ("format", "tile_format_from_numpy", ("nc_p",),
                   ("kernels.tile_onehot", "tile_spmm")),
    "SpanFormat": ("kernels.span_gather", "span_format_from_numpy", ("nc_p",),
                   ("kernels.span_gather", "span_spmm")),
    "RadixFormat": ("kernels.radix_gather", "radix_format_from_numpy", (),
                    ("kernels.radix_gather", "radix_spmm")),
    "SegmentSpanFormat": ("kernels.nnz_split", "segment_span_format_from_numpy", ("nc_p",),
                          ("kernels.nnz_split", "segment_span_spmm")),
    "DgFormat": ("kernels.dg_gather", "dg_format_from_numpy", (),
                 ("kernels.dg_gather", "dg_spmm")),
    "DgtFormat": ("kernels.dgt_gather", "dgt_format_from_numpy", (),
                  ("kernels.dgt_gather", "dgt_spmm")),
    "NmFormat": ("kernels.nm_structured", "nm_format_from_numpy", (),
                 ("kernels.nm_structured", "nm_spmm")),
    "BlockEllFormat": ("kernels.block_ell", "block_ell_format_from_numpy", ("nb_p", "work"),
                       ("kernels.block_ell", "block_ell_spmm")),
}


def _module(name: str):
    if name not in _FORMATS:
        raise KeyError(f"no format class {name!r} in tpusparse_torch: {sorted(_FORMATS)}")
    return importlib.import_module(f"tpusparse_torch.{_FORMATS[name][0]}")


def saved_fields(cls) -> list[str]:
    """The fields of ``cls`` that an artifact holds: the JAX format's."""
    skip = set(_DERIVED) | set(_FORMATS[cls.__name__][2])
    return [f.name for f in dataclasses.fields(cls) if f.name not in skip]


def format_spmm(fmt: Any, x, **kw):
    """Y = A . X through the format's own product entry point (``dg_spmm``,
    ``span_spmm``, ...; a kt=1 dg format through ``dg_spmv``), with ``kw``
    its options: a loaded artifact runs as it was packed."""
    name = type(fmt).__name__
    if name == "DgFormat" and fmt.kt == 1:
        from tpusparse_torch.kernels.dg_gather import dg_spmv

        return dg_spmv(fmt, x, **kw)
    mod, fn = _FORMATS[name][3]
    return getattr(importlib.import_module(f"tpusparse_torch.{mod}"), fn)(fmt, x, **kw)


def save_format(fmt: Any, path: str) -> None:
    """Save a packed-format dataclass as <path>.npz + <path>.json."""
    arrays, bf16 = {}, []
    scalars: dict[str, Any] = {"__class__": type(fmt).__name__}
    for name in saved_fields(type(fmt)):
        v = getattr(fmt, name)
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                bf16.append(name)
                v = v.float()
            arrays[name] = v.detach().cpu().numpy()
        elif isinstance(v, np.ndarray) and v.ndim >= 1:
            arrays[name] = v
        elif isinstance(v, tuple):
            scalars[name] = list(v)
        else:
            scalars[name] = v
    if bf16:
        scalars["__bf16__"] = bf16
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(scalars, f, default=str)


def load_format(path: str, *, device="cuda"):
    """Load a format saved by :func:`save_format` (by either package) onto
    ``device``."""
    with open(path + ".json") as f:
        scalars = json.load(f)
    name = scalars.pop("__class__")
    bf16 = scalars.pop("__bf16__", [])
    mod = _module(name)
    cls = getattr(mod, name)
    with np.load(path + ".npz") as data:
        fields = {k: data[k] for k in data.files}
    known = {f.name for f in dataclasses.fields(cls)}
    static = {}
    for k, v in scalars.items():
        if k not in known or k in _DERIVED:
            continue
        if v is None or k in ("perm_of_nz", "row_scale"):
            fields.setdefault(k, v)  # an absent array (None) goes with the arrays
        else:
            static[k] = tuple(v) if isinstance(v, list) else v
    fmt = getattr(mod, _FORMATS[name][1])(fields, device=device, **static)
    if bf16:
        fmt = dataclasses.replace(fmt, **{k: getattr(fmt, k).to(torch.bfloat16) for k in bf16})
    return fmt


def artifact_path(sig: str, run_id: str) -> str:
    """The directory of one artifact under the cache dir (not created)."""
    return os.path.join(get_config().cache_dir, "artifacts", sig, run_id)


def artifact_dir(sig: str, run_id: str | None = None) -> str:
    """data_source/<rand_id> analogue under the cache dir."""
    if run_id is None:
        run_id = time.strftime("%Y%m%d_%H%M%S")
    d = artifact_path(sig, run_id)
    os.makedirs(d, exist_ok=True)
    return d


def save_plan_artifact(sig: str, schedule_desc: dict, formats: list,
                       perf: dict | None = None, run_id: str | None = None) -> str:
    """Persist one tuning candidate: its packed formats, perf and schedule.
    ``schedule.json`` is written last, so its presence marks a whole
    artifact."""
    d = artifact_dir(sig, run_id)
    for i, fmt in enumerate(formats):
        save_format(fmt, os.path.join(d, f"format_{i}"))
    if perf is not None:
        with open(os.path.join(d, "perf_result.json"), "w") as f:
            json.dump(perf, f, indent=2)
    with open(os.path.join(d, "schedule.json"), "w") as f:
        json.dump(schedule_desc, f, indent=2, default=str)
    return d


def load_plan_artifact(path: str, *, device="cuda"):
    """Load (schedule_desc, formats on ``device``, perf) from an artifact dir."""
    with open(os.path.join(path, "schedule.json")) as f:
        sched = json.load(f)
    formats = []
    i = 0
    while os.path.exists(os.path.join(path, f"format_{i}.json")):
        formats.append(load_format(os.path.join(path, f"format_{i}"), device=device))
        i += 1
    perf = None
    pf = os.path.join(path, "perf_result.json")
    if os.path.exists(pf):
        with open(pf) as f:
            perf = json.load(f)
    return sched, formats, perf
