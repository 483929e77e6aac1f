"""SpGEMM: C = A . B with both operands sparse (counterpart of
``tpusparse/spgemm.py``).

The JAX package's formulation, kept: a tiled dense-intermediate SpMM.  A is
packed once by ``build_plan(a, default_schedule(a, tile_cols))`` (at the
default 128 columns that is ``dg_span`` at kt 32, run by the dg kernel #1);
B is staged on the device once as COO sorted by column, each column tile of
B is densified on the device, multiplied through A's plan (one launch of
the plan's kernel a tile) and the product re-sparsified on the device.
Tiles run in groups whose dense products fit ``GROUP_BYTES``; a group costs
one host sync (its ``nonzero``).  The (row, column, value) triplets stay on
the device, are put in row-major order there by one sort and copied to the
host once.

Each tile is densified from B's own entries of its columns only, so no
padded entry exists that a scatter would have to drop.  A structural zero
stays exactly 0.0 through the kernel (a zero product adds 0), so the
``!= 0`` test recovers the exact pattern; cancelled entries may survive as
explicit near-zeros, as in scipy (pass ``threshold`` to drop them).

``spgemm(a, b)`` routes through a runner cache keyed by a hash of the whole
of A (its indexes and its values, ``tune.matrix_digest``), so repeated
products with one A pay only the device time and an A with new values gets
a runner of its own; ``method="auto"`` sends products under
``HOST_CROSSOVER_FLOPS`` to host scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.kernels.common import resolve_device

#: the dense products of one group of tiles (fp32 [T, M, tile_cols]) are
#: held to 1 GiB, 1.25 % of the H100's 80 GB: at config #1's 32768 rows
#: that is 64 tiles of 128 columns a group, four host syncs for a 32768-
#: column B
GROUP_BYTES = 1 << 30


def _empty(m: int, p: int) -> CooMatrix:
    return CooMatrix(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float64),
                     (m, p))


class SpgemmRunner:
    """Reusable C = A . B executor with A's format packed once on the device.

    Build with :func:`spgemm_fn`; call with any ``CooMatrix`` B whose row
    count equals A's column count.  Only B's staging and the per-group host
    syncs are paid per call.
    """

    def __init__(self, a: CooMatrix, *, tile_cols: int = 128, plan=None,
                 threshold: float = 0.0, device="cuda"):
        self.device = resolve_device(device)
        self.a_shape = a.shape
        self.a_nnz = a.nnz
        self.tile_cols = int(tile_cols)
        self.threshold = float(threshold)
        if plan is None:
            from tpusparse_torch.schedule import build_plan, default_schedule

            plan = build_plan(a, default_schedule(a, self.tile_cols), device=self.device)
        self.plan = plan
        #: per call: tiles, groups (host syncs), nnz(C)
        self.last_stats: dict = {}

    def __call__(self, b: CooMatrix) -> CooMatrix:
        m, n = self.a_shape
        nb, p = b.shape
        assert n == nb, f"inner dims mismatch: A cols {n} != B rows {nb}"
        if self.a_nnz == 0 or b.nnz == 0 or p == 0:
            self.last_stats = {"tiles": 0, "groups": 0, "nnz": 0}
            return _empty(m, p)
        dev, tc, thr = self.device, self.tile_cols, self.threshold

        # B staged on the device once as column-sorted COO; a tile's entries
        # are one slice of it (tile_starts on the host)
        order = np.argsort(b.cols, kind="stable")
        b_cols_h = np.asarray(b.cols, np.int64)[order]
        tile_starts = np.searchsorted(b_cols_h, np.arange(0, p + tc, tc))
        b_rows = torch.as_tensor(np.asarray(b.rows, np.int64)[order], device=dev)
        b_cols = torch.as_tensor(b_cols_h, device=dev)
        b_vals = torch.as_tensor(np.asarray(b.vals, np.float32)[order], device=dev)

        n_tiles = -(-p // tc)
        group = max(1, min(n_tiles, GROUP_BYTES // max(m * tc * 4, 1)))
        z = torch.empty((n, tc), dtype=torch.float32, device=dev)
        ys = torch.empty((min(group, n_tiles), m, tc), dtype=torch.float32, device=dev)
        out_r, out_c, out_v = [], [], []  # on the device
        n_groups = 0
        for g0 in range(0, n_tiles, group):
            t = min(group, n_tiles - g0)
            for i in range(t):
                lo, hi = int(tile_starts[g0 + i]), int(tile_starts[g0 + i + 1])
                z.zero_()
                if hi > lo:
                    z.index_put_((b_rows[lo:hi], b_cols[lo:hi] - (g0 + i) * tc), b_vals[lo:hi],
                                 accumulate=True)
                ys[i] = self.plan(z)
            yg = ys[:t]
            keep = yg.abs() > thr if thr > 0 else yg != 0
            idx = torch.nonzero(keep)  # the group's one host sync
            n_groups += 1
            if idx.numel() == 0:
                continue
            out_r.append(idx[:, 1])
            out_c.append((idx[:, 0] + g0) * tc + idx[:, 2])
            out_v.append(yg[idx[:, 0], idx[:, 1], idx[:, 2]])
        nnz = int(sum(r.numel() for r in out_r))
        self.last_stats = {"tiles": n_tiles, "groups": n_groups, "nnz": nnz}
        if not out_r:
            return _empty(m, p)
        # row-major order by one sort on the device, then one copy to the host
        rows, cols, vals = torch.cat(out_r), torch.cat(out_c), torch.cat(out_v)
        order = torch.argsort(rows * p + cols)
        return CooMatrix(rows[order].cpu().numpy(), cols[order].cpu().numpy(),
                         vals[order].cpu().numpy().astype(np.float64), (m, p))


def spgemm_fn(a: CooMatrix, *, tile_cols: int = 128, plan=None, tune_a: bool = False,
              tune_budget: int = 6, threshold: float = 0.0, device="cuda") -> SpgemmRunner:
    """Build a reusable ``C = A . B`` executor (A packed once).  A's plan
    defaults to ``default_schedule(a, tile_cols)``; ``tune_a=True`` first
    times ``tune_budget`` candidates at K = tile_cols, or pass ``plan``."""
    if plan is None and tune_a:
        from tpusparse_torch.tune import tune

        x0 = np.random.default_rng(0).standard_normal((a.shape[1], tile_cols)).astype(np.float32)
        plan = tune(a, x0, budget=tune_budget, iters=5, device=device).best
    return SpgemmRunner(a, tile_cols=tile_cols, plan=plan, threshold=threshold, device=device)


_RUNNER_CACHE: dict = {}
_RUNNER_CACHE_MAX = 8


def spgemm_flops(a: CooMatrix, b: CooMatrix) -> float:
    """2 * sum over A nz of nnz(B row) — the classic SpGEMM FLOP count."""
    brow = np.bincount(np.asarray(b.rows), minlength=b.shape[0])
    return float(2.0 * brow[np.asarray(a.cols)].sum())


def spgemm_host(a: CooMatrix, b: CooMatrix) -> CooMatrix:
    """Host scipy CSR product (the sub-crossover route)."""
    import scipy.sparse as sp

    ca = sp.coo_matrix((a.vals, (a.rows, a.cols)), shape=a.shape).tocsr()
    cb = sp.coo_matrix((b.vals, (b.rows, b.cols)), shape=b.shape).tocsr()
    c = (ca @ cb).tocoo()
    return CooMatrix(c.row.astype(np.int64), c.col.astype(np.int64), c.data,
                     a.shape[:1] + b.shape[1:]).sort_row_major()


#: Products with fewer FLOPs than this go to host scipy under
#: ``method="auto"``.  Measured on an NVIDIA H100 80GB HBM3 at its 700 W
#: limit (PERF.md §6), device route with A's runner cached against scipy,
#: power-law n^2 avg 8 products (``bench/spgemm_crossover.py``, best of 5 /
#: ``chip_smoke.py``'s G2, best of 3), device / scipy ms: 1.8e4 FLOPs
#: (256^2) 1.89 / 1.63, 2.61 / 1.94; 4.3e4 (512^2) 3.66 / 2.97, 3.14 / 2.53;
#: 1.1e5 (1024^2) 6.44 / 7.49, 10.27 / 8.98; 2.0e5 (2048^2) 12.3 / 20.6,
#: 11.7 / 14.6.  Scipy led at 4.3e4 and below in both runs, the device at
#: 2.0e5 and above; the log time ratio, interpolated in log FLOPs, crosses
#: 0 at 7.44e4 in the first run and 1.38e5 in the second.  The constant is
#: their geometric mean; from 4.3e4 to 1.1e5 either route is within 1.25x
#: of the other.
HOST_CROSSOVER_FLOPS = 1.0e5


def spgemm(a: CooMatrix, b: CooMatrix, *, tile_cols: int = 128, plan=None,
           tune_a: bool = False, tune_budget: int = 6, threshold: float = 0.0,
           method: str = "auto", device="cuda") -> CooMatrix:
    """C[M, P] = A[M, N] . B[N, P]; returns COO, row-major sorted.

    ``method``: 'auto' routes products under ``HOST_CROSSOVER_FLOPS`` to
    host scipy, 'device' forces the tiled runner on ``device``, 'host'
    forces scipy.  Runners are cached per (a hash of A's indexes and
    values, tile_cols, threshold, tune_a, tune_budget, device): the plan
    holds A's values, so a key that skipped them could hand back the
    product of an earlier A."""
    assert method in ("auto", "device", "host"), method
    if method == "auto":
        method = "host" if spgemm_flops(a, b) < HOST_CROSSOVER_FLOPS else "device"
    if method == "host":
        out = spgemm_host(a, b)
        if threshold:
            keep = np.abs(out.vals) > threshold
            out = CooMatrix(out.rows[keep], out.cols[keep], out.vals[keep], out.shape)
        return out
    if plan is not None:
        return SpgemmRunner(a, tile_cols=tile_cols, plan=plan, threshold=threshold,
                            device=device)(b)
    from tpusparse_torch.tune import matrix_digest

    dev = resolve_device(device)
    key = (matrix_digest(a), tile_cols, threshold, tune_a, tune_budget, str(dev))
    runner = _RUNNER_CACHE.get(key)
    if runner is None:
        runner = spgemm_fn(a, tile_cols=tile_cols, tune_a=tune_a, tune_budget=tune_budget,
                           threshold=threshold, device=dev)
        if len(_RUNNER_CACHE) >= _RUNNER_CACHE_MAX:
            _RUNNER_CACHE.pop(next(iter(_RUNNER_CACHE)))
        _RUNNER_CACHE[key] = runner
    return runner(b)
