"""Graph algorithms over semiring SpMV (counterpart of ``tpusparse/graph.py``).

The reference carries config hooks ``PERFORMANCE_FLAG=graph``, ``Semiring``,
``Graph_Algorithm`` (bfs|pr|cc) and ``GRAPH_MAX_ITER`` and prepares
matrices for them in its loader (struct.cc:53-75) but leaves the kernels
unwired.  Here, as in the JAX package, the semiring SpMV runs on the device
and the four iterative drivers (BFS, SSSP, PageRank, connected components)
loop over it.  The plus_times and or_and matvecs of BFS and PageRank run
the dg SpMV kernel (#2, ``dg_spmv``) on a format packed once; min_plus and
the label propagation run as segment reductions.

The drivers are Python loops over tensors on the device, with the JAX
drivers' stop tests and ``max_iter``: each iteration reads its stop test on
the host (one sync an iteration).

Semirings (combine, reduce):
  plus_times  (*, +)       numeric SpMV
  or_and      (&, |)       frontier propagation (BFS)
  min_plus    (+, min)     shortest paths / label propagation (CC uses
                           (second, min): neighbor label min)

Orientation: the drivers take the *push* orientation, entry (u, v) is the
edge v->u (``read_mtx(graph_mode='bfs')``).  An empty row's min is +inf
(floats) or INT32_MAX (CC's labels), its or is False: the outputs are
filled with these before the reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.config import get_config
from tpusparse_torch.gates import CARD_GATES, Gates
from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import prep_x, resolve_device
from tpusparse_torch.spmv import pack_dg_spmv, takes_dg

SEMIRINGS = ("plus_times", "min_plus", "or_and")

def _segment_spmv(rows, cols, vals, x, *, semiring: str, m: int) -> torch.Tensor:
    """y[M] under ``semiring`` as one gather of x and one segment reduction
    over the rows; the output is filled with the reduction's identity
    first, so an empty row keeps it."""
    xc = x.index_select(0, cols)
    if semiring == "plus_times":
        return torch.zeros(m, dtype=xc.dtype, device=x.device).index_add_(0, rows, vals * xc)
    if semiring == "min_plus":
        return torch.full((m,), float("inf"), dtype=xc.dtype, device=x.device).scatter_reduce_(
            0, rows, vals + xc, "amin", include_self=True)
    if semiring == "or_and":
        hit = ((vals != 0) & (xc != 0)).to(torch.int32)
        return torch.zeros(m, dtype=torch.int32, device=x.device).scatter_reduce_(
            0, rows, hit, "amax", include_self=True) > 0
    raise ValueError(f"unknown semiring {semiring!r}")


def _coo_tensors(rows, cols, dev):
    return (torch.as_tensor(np.asarray(rows, np.int64), device=dev),
            torch.as_tensor(np.asarray(cols, np.int64), device=dev))


def semiring_spmv(mat: CooMatrix, x, semiring: str | None = None, *,
                  device="cuda") -> torch.Tensor:
    """y[M] = A (combine) x reduced per row under the semiring, on
    ``device`` (or_and: a bool tensor; else float32)."""
    if semiring is None:
        semiring = get_config().semiring
    assert semiring in SEMIRINGS, semiring
    dev = resolve_device(device)
    rows, cols = _coo_tensors(mat.rows, mat.cols, dev)
    x = prep_x(x, dev)
    if semiring == "or_and":
        vals = torch.as_tensor(np.asarray(mat.vals) != 0, device=dev)
        x = x != 0
    else:
        vals = torch.as_tensor(np.asarray(mat.vals, np.float32), device=dev)
    return _segment_spmv(rows, cols, vals, x, semiring=semiring, m=mat.shape[0])


def matvec_plan(mat: CooMatrix, semiring: str = "plus_times",
                vals: np.ndarray | None = None, *, device="cuda",
                gates: Gates = CARD_GATES):
    """Packed repeated-matvec plan for the iterative drivers.

    Runs CalculationMethodChooseOperator so ``calculation_method`` lives in
    the metadata set and the plan is chosen from it, then packs the matrix
    once, as the JAX package does:

      plus_times  the dg kt=1 format, run by the dg SpMV kernel (#2,
                  ``dg_spmv``), where ``spmv.takes_dg``: at any N on the
                  card's record (the default), on the TPU's where x fits
                  6 MB (tpusparse/graph.py:95); else a segment reduction
      or_and      plus_times on 0/1 values + a >0 threshold (counts and
                  boolean OR agree for non-negative values; exact in f32
                  below 2^24 per row)
      min_plus    a segment min (``scatter_reduce``)

    Returns ``fn(x[N] f32 tensor) -> y[M] f32 tensor`` with ``fn.meta``
    (and ``fn.format``, the dg format, on the packed path)."""
    from tpusparse_torch.levels import Level
    from tpusparse_torch.meta.set import create_init_metadata_set
    from tpusparse_torch.ops import CalculationMethodChooseOperator, OperatorExecutor

    assert semiring in SEMIRINGS, semiring
    dev = resolve_device(device)
    m, n = mat.shape
    use_vals = np.asarray(mat.vals if vals is None else vals, np.float32)
    ms = create_init_metadata_set(mat)
    OperatorExecutor(ms).add_and_run(CalculationMethodChooseOperator(0, method=semiring))
    method_code = int(ms.get(Level.GLOBAL, "calculation_method", 0))

    if method_code in (0, 2) and takes_dg(n, gates):
        from tpusparse_torch.kernels.dg_gather import dg_spmv

        v = (use_vals != 0).astype(np.float32) if method_code == 2 else use_vals
        fmt = pack_dg_spmv(CooMatrix(mat.rows, mat.cols, v, mat.shape), device=dev,
                           gates=gates)

        if method_code == 2:
            def fn(x):
                return (dg_spmv(fmt, x) > 0).to(torch.float32)
        else:
            def fn(x):
                return dg_spmv(fmt, x)

        fn.meta = {"method": "dg", "calculation_method": method_code,
                   "padding_rate": fmt.padding_rate}
        fn.format = fmt
        return fn

    rows, cols = _coo_tensors(mat.rows, mat.cols, dev)
    v = torch.as_tensor(use_vals, device=dev)
    if method_code == 2:
        v = (v != 0).to(torch.float32)

    def fn(x):
        if method_code == 2:
            y = _segment_spmv(rows, cols, v, x, semiring="plus_times", m=m)
            return (y > 0).to(torch.float32)
        return _segment_spmv(rows, cols, v, x,
                             semiring="plus_times" if method_code == 0 else "min_plus", m=m)

    fn.meta = {"method": "segment", "calculation_method": method_code}
    return fn


def bfs(mat: CooMatrix, source: int, max_iter: int | None = None, *,
        device="cuda") -> np.ndarray:
    """Level array (-1 = unreachable) by frontier propagation with or_and.
    ``mat`` in push orientation: entry (u, v) means edge v->u."""
    level, _ = bfs_fn(mat, max_iter=max_iter, device=device)(source)
    return level.cpu().numpy()


def bfs_fn(mat: CooMatrix, max_iter: int | None = None, *, device="cuda"):
    """``run(source) -> (level int32 tensor, n_iters)`` for repeated BFS over
    one packed matrix (the or_and plan packs once)."""
    n = mat.shape[0]
    assert mat.shape[0] == mat.shape[1], "BFS needs a square adjacency"
    if max_iter is None:
        max_iter = min(get_config().graph_max_iter, n)
    dev = resolve_device(device)
    fn = matvec_plan(mat, semiring="or_and", device=dev)

    def run(source):
        level = torch.full((n,), -1, dtype=torch.int32, device=dev)
        level[source] = 0
        frontier = torch.zeros(n, dtype=torch.float32, device=dev)
        frontier[source] = 1.0
        it = 0
        while it < max_iter and bool(frontier.any()):
            nxt = (fn(frontier) > 0) & (level < 0)
            level = torch.where(nxt, it + 1, level)
            frontier = nxt.to(torch.float32)
            it += 1
        return level, it

    run.matvec = fn
    return run


def sssp(mat: CooMatrix, source: int, max_iter: int | None = None, *,
         device="cuda") -> np.ndarray:
    """Single-source shortest-path distances (+inf = unreachable) by
    Bellman-Ford-style min_plus relaxation; ``mat`` in push orientation
    (entry (u, v) = nonnegative weight of edge v->u)."""
    d, _ = sssp_fn(mat, max_iter=max_iter, device=device)(source)
    return d.cpu().numpy()


def sssp_fn(mat: CooMatrix, max_iter: int | None = None, *, device="cuda"):
    """``run(source) -> (dist float32 tensor, n_iters)`` for repeated SSSP
    over one matrix (the min_plus semiring: a segment min)."""
    n = mat.shape[0]
    assert mat.shape[0] == mat.shape[1], "SSSP needs a square adjacency"
    if max_iter is None:
        max_iter = min(get_config().graph_max_iter, n)
    dev = resolve_device(device)
    fn = matvec_plan(mat, semiring="min_plus", device=dev)

    def run(source):
        d = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        d[source] = 0.0
        changed, it = True, 0
        while changed and it < max_iter:
            nxt = torch.minimum(d, fn(d))
            changed = bool((nxt < d).any())
            d = nxt
            it += 1
        return d, it

    return run


def pagerank(mat: CooMatrix, damping: float = 0.85, tol: float = 1e-6,
             max_iter: int | None = None, *, device="cuda") -> np.ndarray:
    """Power iteration.  ``mat`` in push orientation (entry (u, v) = edge
    v->u); dangling mass is redistributed uniformly."""
    r, _ = pagerank_fn(mat, damping=damping, tol=tol, max_iter=max_iter, device=device)()
    return r.cpu().numpy()


def pagerank_fn(mat: CooMatrix, damping: float = 0.85, tol: float = 1e-6,
                max_iter: int | None = None, *, device="cuda"):
    """``run(r0=None) -> (rank float32 tensor, n_iters)`` for repeated
    PageRank over one packed matrix: each iteration one launch of the dg
    SpMV kernel (where the gate takes the dg plan), the stop test an fp32
    L1 delta against ``tol``."""
    n = mat.shape[0]
    assert mat.shape[0] == mat.shape[1]
    if max_iter is None:
        max_iter = get_config().graph_max_iter
    dev = resolve_device(device)
    # out-degree of v = number of entries with col v (push orientation)
    deg = np.bincount(mat.cols, minlength=n).astype(np.float32)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    fn = matvec_plan(mat, semiring="plus_times",
                     vals=np.ones(mat.nnz, np.float32) * inv_deg[mat.cols], device=dev)
    dangling = torch.as_tensor(deg == 0, device=dev)

    def run(r0=None):
        r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev) if r0 is None \
            else prep_x(r0, dev)
        delta, it = float("inf"), 0
        while delta > tol and it < max_iter:
            spread = fn(r)
            dangle = torch.where(dangling, r, 0.0).sum() / n
            nxt = (1.0 - damping) / n + damping * (spread + dangle)
            delta = float((nxt - r).abs().sum())
            r = nxt
            it += 1
        return r, it

    run.matvec = fn
    return run


def connected_components(mat: CooMatrix, max_iter: int | None = None, *,
                         device="cuda") -> np.ndarray:
    """Component label per vertex (= min vertex id in its component) by min
    label propagation; edges treated as undirected (matrix symmetrized).
    ``read_mtx(graph_mode='cc')`` provides the value-dropped dedup input."""
    n = mat.shape[0]
    assert mat.shape[0] == mat.shape[1]
    if max_iter is None:
        max_iter = min(get_config().graph_max_iter, n)
    dev = resolve_device(device)
    rows, cols = _coo_tensors(np.concatenate([mat.rows, mat.cols]),
                              np.concatenate([mat.cols, mat.rows]), dev)
    label = torch.arange(n, dtype=torch.int32, device=dev)
    empty = torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32, device=dev)
    changed, it = True, 0
    while changed and it < max_iter:
        neigh = empty.clone().scatter_reduce_(0, rows, label.index_select(0, cols), "amin",
                                              include_self=True)
        nxt = torch.minimum(label, neigh)
        changed = bool((nxt != label).any())
        label = nxt
        it += 1
    return label.cpu().numpy()
