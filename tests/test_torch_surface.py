"""The port's public surface against the JAX package's, on the CPU.

Every name of every ``__all__`` in ``tpusparse/`` has a counterpart in the
same module of ``tpusparse_torch/`` (the same name, or the renamed
counterpart in ``RENAMED``), and every public top-level function and class
of a ``tpusparse/`` module has one in the port's module of the same path;
or it sits in ``BY_DESIGN`` with its reason.  The names this slice ported
are held to the JAX functions: ``pad_rows_to_multiple``, ``padding_rate``
and ``parent_bit_map_of_thread`` on MetaDataSets built from the same seeded
COO (the items, their arrays and the trace), ``batched_spmm_reference``,
``measured_stream_bandwidth_gbs`` (the card only) and ``entry()`` (its
format equal to the JAX ``pack_dgt``'s, Y within 2e-3 of the oracle).
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from tpusparse import transforms as JT
from tpusparse.io import builder as jbuilder
from tpusparse.kernels.dgt_gather import pack_dgt as jpack_dgt
from tpusparse.levels import Level as JLevel
from tpusparse.meta import create_init_metadata_set as jcreate
from tpusparse.oracle import batched_spmm_reference as jbatched
from tpusparse.oracle import spmm_reference as jspmm_reference
from tpusparse_torch import transforms as TT
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.levels import Level as TLevel
from tpusparse_torch.meta import create_init_metadata_set as tcreate
from tpusparse_torch.oracle import batched_spmm_reference, check_result

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "tpusparse", ROOT / "tpusparse_torch"

#: JAX names whose port counterpart has another name: (module, JAX name) ->
#: the port's name in the same module
RENAMED = {
    ("bench", "bcoo_spmm_fn"): "csr_spmm_fn",                # cuSPARSE CSR for BCOO
    ("bench", "xla_segment_spmm_fn"): "segment_spmm_fn",     # index_add_ for segment_sum
    ("bench.baselines", "bcoo_spmm_fn"): "csr_spmm_fn",
    ("bench.baselines", "xla_segment_spmm_fn"): "segment_spmm_fn",
    ("bench.microbench", "measure_chunk_costs"): "measure_family_costs",
}

_VREG = "the TPU's VPU vector-register model of the one-hot gathers; no card kernel spends it"

#: JAX names with no counterpart in the port, by design: (module, name) -> why
BY_DESIGN = {
    ("kernels", "kernel_backend_interpret"):
        "Pallas interpret mode; the port's CPU path is the kernels' plain versions",
    ("kernels.common", "kernel_backend_interpret"):
        "Pallas interpret mode; the port's CPU path is the kernels' plain versions",
    ("kernels.common", "onehot_chunk_contrib"): "the TPU's one-hot MXU gather",
    ("kernels.radix_gather", "pack_x_radix"): "the TPU's lane packing of X",
    ("native", "available"):
        "the port's native helpers raise without a compiler instead of falling back",
    ("nn", "flax_sparse_linear"): "TrainableSparseLinear is the nn.Module",
    ("bench.microbench", "measure_vpu"): _VREG,
    ("bench.microbench", "measure_index_compression"):
        "queued until a card kernel reads a compressed index (ROADMAP A.12)",
    **{("bench.sol", n): _VREG for n in ("dg_cost", "dgt_cost", "radix_cost", "span_cost",
                                          "fit_vpu_rate", "fit_vpu_rate_lsq")},
    **{("bench.formulations", n): _VREG for n in (
        "band_cost", "candidates_table", "class_block_cost", "int8_rowhot_cost", "main",
        "mxu_gather_cost", "select_cost", "simulate_pads")},
}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(JAX_PKG).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _port_path(mod: str, is_pkg: bool) -> pathlib.Path:
    base = PORT_PKG.joinpath(*mod.split(".")) if mod else PORT_PKG
    return base / "__init__.py" if is_pkg else base.with_suffix(".py")


def _all_of(tree) -> list[str] | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return [e.value for e in node.value.elts]
    return None


def _defined(tree) -> set[str]:
    """Every name a module's top level binds: functions, classes,
    assignments and imports."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return out


def _jax_modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        yield _module_name(path), path.name == "__init__.py", ast.parse(path.read_text())


ALL_LISTS = [(mod, is_pkg, _all_of(tree)) for mod, is_pkg, tree in _jax_modules()
             if _all_of(tree) is not None]
PUBLIC_DEFS = [(mod, is_pkg, sorted(n.name for n in tree.body
                                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                                    and not n.name.startswith("_")))
               for mod, is_pkg, tree in _jax_modules()]


def _counterpart(mod: str, name: str, port_names) -> str | None:
    """The port's name for JAX's ``mod.name``, or None when it has none."""
    want = RENAMED.get((mod, name), name)
    return want if want in port_names else None


@pytest.mark.parametrize("mod,is_pkg,names", ALL_LISTS, ids=[m or "tpusparse" for m, _, _ in
                                                              ALL_LISTS])
def test_every_all_name_has_a_counterpart(mod, is_pkg, names):
    port = importlib.import_module("tpusparse_torch" + (f".{mod}" if mod else ""))
    port_all = set(getattr(port, "__all__", ()))
    missing = []
    for name in names:
        if (mod, name) in BY_DESIGN:
            assert not hasattr(port, name), f"{mod}.{name} is ported: take it off BY_DESIGN"
            continue
        got = _counterpart(mod, name, port_all)
        if got is None or not hasattr(port, got):
            missing.append(name)
    assert not missing, f"tpusparse_torch.{mod} lacks {missing} of the JAX __all__"


@pytest.mark.parametrize("mod,is_pkg,names", PUBLIC_DEFS,
                         ids=[m or "tpusparse" for m, _, _ in PUBLIC_DEFS])
def test_every_public_def_has_a_counterpart(mod, is_pkg, names):
    port_path = _port_path(mod, is_pkg)
    if not port_path.exists():  # a whole module kept out by design
        assert names and all((mod, n) in BY_DESIGN for n in names), \
            f"tpusparse_torch has no {port_path.relative_to(ROOT)}"
        return
    port_names = _defined(ast.parse(port_path.read_text()))
    missing = [n for n in names if (mod, n) not in BY_DESIGN
               and _counterpart(mod, n, port_names) is None]
    assert not missing, f"{port_path.relative_to(ROOT)} lacks {missing}"


def test_by_design_and_renamed_lists_are_current():
    jax_names = {mod: {n for n in names} for mod, _, names in PUBLIC_DEFS}
    for mod, _, names in ALL_LISTS:
        jax_names.setdefault(mod, set()).update(names)
    for (mod, name), reason in BY_DESIGN.items():
        assert reason and name in jax_names.get(mod, ()), (mod, name)
    for (mod, name) in RENAMED:
        assert name in jax_names.get(mod, ()), (mod, name)


# ------------------------------------------------------------ transform steps

def _both_sets(seed):
    jmat = jbuilder.power_law_coo(90, 70, avg_nnz_per_row=5.0, seed=seed)
    jms = jcreate(jmat)
    tms = tcreate(CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape))
    return jms, tms


def _assert_same_sets(jms, tms):
    j_items = {(k[0].name, k[1], k[2]): v.data for k, v in jms._items.items()}
    t_items = {(k[0].name, k[1], k[2]): v.data for k, v in tms._items.items()}
    assert sorted(j_items) == sorted(t_items)
    for key, data in j_items.items():
        np.testing.assert_array_equal(t_items[key], data, err_msg=str(key))
        assert np.asarray(t_items[key]).dtype == np.asarray(data).dtype, key
    assert [(r.step, r.sources, r.dests, r.params) for r in tms.trace.records] == \
        [(r.step, r.sources, r.dests, r.params) for r in jms.trace.records]


@pytest.mark.parametrize("multiple", [1, 8, 64, 90, 128])
@pytest.mark.parametrize("sorted_first", [False, True])
def test_pad_rows_to_multiple_equals_jax(multiple, sorted_first):
    jms, tms = _both_sets(seed=7)
    for T, ms, L in ((JT, jms, JLevel), (TT, tms, TLevel)):
        if sorted_first:  # gives original_row_of_sorted, which takes -1 sentinels
            T.get_row_order_by_length(ms, 0)
            T.reorder_by_row_order(ms, 0)
        T.block_fixed_nnz(ms, 0, L.WARP, 7)  # a blocking the pad drops
    removed = JT.pad_rows_to_multiple(jms, 0, multiple)
    assert TT.pad_rows_to_multiple(tms, 0, multiple) == removed
    _assert_same_sets(jms, tms)
    target = -(-90 // multiple) * multiple
    assert tms.row_num(0) == target
    if sorted_first:
        rec = tms.get(TLevel.ROW, "original_row_of_sorted", 0)
        assert rec.size == target and (rec[90:] == -1).all() and (rec[:90] >= 0).all()


def test_padding_rate_equals_jax():
    jms, tms = _both_sets(seed=8)
    nnz0 = tms.nnz(0)
    assert TT.padding_rate(tms, 0, nnz0) == JT.padding_rate(jms, 0, nnz0) == 1.0
    JT.pad_row_nnz_to_multiple(jms, 0, 8)
    TT.pad_row_nnz_to_multiple(tms, 0, 8)
    assert TT.padding_rate(tms, 0, nnz0) == JT.padding_rate(jms, 0, nnz0) > 1.0
    assert TT.padding_rate(tms, 0, 0) == JT.padding_rate(jms, 0, 0) == tms.nnz(0)


@pytest.mark.parametrize("per_child,children", [(7, 3), (5, 1), (16, 4), (1, 2)])
def test_parent_bit_map_of_thread_equals_jax(per_child, children):
    jms, tms = _both_sets(seed=9)
    out = []
    for T, ms, L in ((JT, jms, JLevel), (TT, tms, TLevel)):
        T.get_row_order_by_length(ms, 0)
        T.reorder_by_row_order(ms, 0)
        T.block_fixed_nnz(ms, 0, L.WARP, per_child)
        T.block_group_children(ms, 0, L.TBLOCK, L.WARP, children)
        out.append(T.parent_bit_map_of_thread(ms, 0, L.WARP, L.TBLOCK))
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1].dtype == np.int8 and out[1][0] == 1
    _assert_same_sets(jms, tms)


# ------------------------------------------------------------ oracle, harness

def test_batched_spmm_reference_equals_jax():
    jmat = jbuilder.power_law_coo(60, 50, avg_nnz_per_row=4.0, seed=2)
    tmat = CooMatrix(jmat.rows, jmat.cols, jmat.vals, jmat.shape)
    x = np.random.default_rng(3).standard_normal((3, 50, 5))
    got = batched_spmm_reference(tmat, x)
    assert got.shape == (3, 60, 5)
    np.testing.assert_array_equal(got, jbatched(jmat, x))
    with pytest.raises(AssertionError):
        batched_spmm_reference(tmat, x[0])


def test_measured_stream_bandwidth_runs_on_a_card_only():
    from tpusparse_torch.bench import measured_stream_bandwidth_gbs

    with pytest.raises(RuntimeError, match="reads a card"):
        measured_stream_bandwidth_gbs(1 << 20, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measured_stream_bandwidth_gbs(1 << 20)


# ------------------------------------------------------------------- entry()

def test_entry_equals_the_jax_flagship_on_cpu():
    from tpusparse_torch import entry
    from tpusparse_torch.dist import dryrun
    from tpusparse_torch.kernels import dgt_gather as tdgt

    assert dryrun.entry is entry  # beside dryrun_multichip, as in the JAX file
    fn, (x,) = entry(device="cpu")
    jmat = jbuilder.power_law_coo(512, 384, avg_nnz_per_row=6.0, seed=0)
    jfmt = jpack_dgt(jmat, rb=128, g=128, kt=16, mode="fp32x2", nw=4)
    for k in tdgt.FIELDS:
        np.testing.assert_array_equal(getattr(fn.format, k).numpy(),
                                      np.asarray(getattr(jfmt, k)), err_msg=k)
    for k in ("n_programs", "n_chunks", "chunk_g", "rb", "kt", "mode", "resid", "nw",
              "shape", "nnz_real"):
        assert getattr(fn.format, k) == getattr(jfmt, k), k
    x_want = np.random.default_rng(0).standard_normal((384, 16)).astype(np.float32)
    assert x.device.type == "cpu" and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), x_want)
    y = fn(x)
    assert y.shape == (512, 16) and bool(torch.isfinite(y).all())
    check_result(y.numpy(), jspmm_reference(jmat, x_want.astype(np.float64)), rtol=2e-3)
