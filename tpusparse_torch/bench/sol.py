"""Speed-of-light floors per schedule family on the card (counterpart of
``tpusparse/bench/sol.py``).

The JAX module counts the TPU's MXU multiply-accumulates and VPU vector
registers per chunk.  The card's kernels are bound by other things, so
this module counts, for each family, what its kernel must do for one
product Y[M, K] = A . X on a given matrix:

  bytes  its format's planes as its kernel reads them, X as gathered
         (K values for each slot it walks, or X once where the kernel
         reads X as a dense panel), and Y written once
  ops    the multiply-adds it issues (2 per product term), at the peak of
         the precision it issues them in (fp32 on the CUDA cores, bf16 on
         the tensor cores)

A family's floor is the larger of bytes over the stream rate and ops over
the peak: the least time the card could take for that kernel's work.  The
CSR floor is the contract's bound for the product itself (A's CSR bytes,
X and Y each moved once), the one ``chip_smoke.py``'s kernels line uses,
so that its bound column and this table cannot drift apart.

Rates default to the H100 SXM's published peaks; ``table`` takes the
session probe's readings (``bench/microbench.py::session_probe``) in their
place.  Run: ``python -m tpusparse_torch.bench.sol [--microbench PATH]``
(the port's MICROBENCH.jsonl under the config cache_dir by default; its
``family_cost`` rows give the measured column).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores, published
BF16_TC_FLOPS_PER_S = 989e12   # H100 SXM bf16 dense tensor cores, published
WALK_SLOT_BYTES = 16           # the row walk's slot: row, column, slot index, value
PLANE_SLOT_BYTES = 12          # a packed slot: column, local row, value (int32, int32, fp32)
BLOCK = 128                    # the Block-ELL block and the N:M group count's tile


@dataclasses.dataclass(frozen=True)
class Cost:
    bytes: float
    ops: float
    precision: str = "fp32"  # whose peak the ops run at: "fp32" or "bf16"


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    """What the floors read of a matrix: its nnz, shape and the number of
    nonzero BLOCK x BLOCK blocks."""

    nnz: int
    m: int
    n: int
    blocks: int

    @classmethod
    def of(cls, mat) -> "MatrixStats":
        nb_cols = -(-mat.shape[1] // BLOCK)
        keys = np.unique((mat.rows // BLOCK) * nb_cols + mat.cols // BLOCK)
        return cls(mat.nnz, mat.shape[0], mat.shape[1], int(keys.size))


def csr_cost(nnz: int, m: int, n: int, k: int) -> Cost:
    """A's CSR planes (nnz values and column indices, M+1 row pointers), X
    and Y each moved once; 2 nnz K fp32 ops."""
    return Cost(nnz * 8 + (m + 1) * 4 + n * k * 4 + m * k * 4, 2.0 * nnz * k)


def gather_cost(s: MatrixStats, k: int, slot_bytes: int) -> Cost:
    """A kernel that walks the nnz live slots of ``slot_bytes`` and gathers
    X's K fp32 values for each; Y written once."""
    return Cost(s.nnz * slot_bytes + s.nnz * k * 4 + s.m * k * 4, 2.0 * s.nnz * k)


def csr_bound_ms(nnz: int, m: int, n: int, k: int) -> tuple[float, str]:
    """The least time for Y = A X on an H100 SXM at its published peaks: the
    CSR floor in ms, and "bytes" or "operations" for what binds it."""
    return floor_ms(csr_cost(nnz, m, n, k))


FAMILIES = {
    # cuSPARSE's format, the yardstick's, and the contract's bound
    "csr": lambda s, k: csr_cost(s.nnz, s.m, s.n, k),
    # dg (#1, #2), dgt (#3, #4), span (#7, #8) and radix (#9): the row walk
    # over the live slots, 16 B each
    "walk": lambda s, k: gather_cost(s, k, WALK_SLOT_BYTES),
    # stripe (#10, #11): slot streams over each stripe's live slots
    "stripe": lambda s, k: gather_cost(s, k, PLANE_SLOT_BYTES),
    # tile (#5, #6): the packed planes (the floor of an unpadded format)
    "tile": lambda s, k: gather_cost(s, k, PLANE_SLOT_BYTES),
    # Block-ELL (#13): the bf16 blocks, a block column each, X's bf16 panel
    # for each block, Y once; dense block products on the tensor cores
    "block_ell": lambda s, k: Cost(
        s.blocks * (BLOCK * BLOCK * 2 + 4) + s.blocks * BLOCK * k * 2 + s.m * k * 4,
        2.0 * s.blocks * BLOCK * BLOCK * k, "bf16"),
    # N:M 2:4 (#12): bf16 values, one byte of packed offsets a group, X's
    # bf16 panel once, Y once; the rebuilt dense tiles on the tensor cores
    "nm": lambda s, k: Cost(s.nnz * 2 + s.m * s.n // 4 + s.n * k * 2 + s.m * k * 4,
                            2.0 * s.m * s.n * k, "bf16"),
    # cuBLAS on the densified bf16 A
    "dense": lambda s, k: Cost(s.m * s.n * 2 + s.n * k * 2 + s.m * k * 4,
                               2.0 * s.m * s.n * k, "bf16"),
}

# Which probed axis binds each schedule family at the suite's shapes
# (``table`` at config #1, K = 8, and N:M 4096^2 at K = 128, Block-ELL
# 4096^2 at K = 256, dense at config #1, K = 256; tests hold the two
# together): every family is bound by its bytes there.  The suite and the
# zoo normalize a winner's rate on its axis.  Keys are the family prefixes
# as they appear in schedule and bench names.
BOUND_AXIS = {
    "dg": "stream", "dgt": "stream", "span": "stream", "radix": "stream",
    "brick": "stream", "stripe": "stream", "segment": "stream", "nnz": "stream",
    "bucketed": "stream", "nested": "stream", "tile": "stream", "hybrid": "stream",
    "dense": "stream", "nm": "stream", "block": "stream", "csr": "stream",
}


def bound_axis_for(winner_name: str) -> str:
    """The probed axis ("stream", "mxu" for the bf16 tensor cores, "fp32")
    that bounds a schedule family or bench label, e.g. 'dg_span' or
    'nm_2_4_batched'; "stream" for a name it does not know."""
    head = winner_name.split()[0].split("_")[0].lower()
    return BOUND_AXIS.get(head, "stream")


def floor_ms(cost: Cost, *, stream_gbs: float | None = None, bf16_tflops: float | None = None,
             fp32_tflops: float | None = None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    stream rate and the ops over their precision's peak; the published
    peaks where no reading is given."""
    bw = stream_gbs * 1e9 if stream_gbs else HBM_BYTES_PER_S
    peak = {"fp32": fp32_tflops * 1e12 if fp32_tflops else FP32_FLOPS_PER_S,
            "bf16": bf16_tflops * 1e12 if bf16_tflops else BF16_TC_FLOPS_PER_S}[cost.precision]
    t_bytes, t_ops = cost.bytes / bw, cost.ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def table(mat, k: int, *, probe: dict | None = None,
          measured: dict | None = None) -> list[dict]:
    """One row per family: its bytes and ops for ``mat`` at K = k, its
    floor in ms and in ns per nonzero at the probe's readings (``probe``,
    a ``session_probe`` dict; the published peaks without one), what binds
    it, and where ``measured`` (family -> device ns per nonzero) has the
    family, the measured time over the floor."""
    probe = probe or {}
    rates = {"stream_gbs": probe.get("stream_gbs"), "bf16_tflops": probe.get("mxu_tflops"),
             "fp32_tflops": probe.get("fp32_tflops")}
    s = MatrixStats.of(mat)
    measured = measured or {}
    rows = []
    for name, fn in FAMILIES.items():
        c = fn(s, k)
        ms, bound_by = floor_ms(c, **rates)
        floor_ns = ms * 1e6 / max(s.nnz, 1)
        got = measured.get(name)
        rows.append({
            "family": name, "k": k, "bytes": int(c.bytes), "ops": int(c.ops),
            "precision": c.precision, "floor_ms": ms, "floor_ns_per_nz": floor_ns,
            "bound_by": bound_by, "measured_ns_per_nz": got,
            "measured_over_floor": got / floor_ns if got else None,
        })
    return rows


# which floor each schedule family's kernel walks
FLOOR_OF = {"dg_span": "walk", "dgt_span": "walk", "span_onehot": "walk",
            "span_colsplit": "walk", "radix_span": "walk", "segment_span": "walk",
            "bucketed": "walk", "brick_ell": "walk", "stripe_total": "stripe",
            "stripe_nested": "stripe", "nnz_segment": "stripe", "tile_onehot": "tile",
            "block_ell": "block_ell", "dense": "dense"}


def main(argv=None):
    import argparse

    from tpusparse_torch.config import get_config
    from tpusparse_torch.io import builder

    ap = argparse.ArgumentParser(prog="python -m tpusparse_torch.bench.sol")
    ap.add_argument("--microbench", default=None,
                    help="JSON lines of bench/microbench.py (default: MICROBENCH.jsonl under "
                         "the config cache_dir)")
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args(argv)
    path = args.microbench or os.path.join(get_config().cache_dir, "MICROBENCH.jsonl")

    # the least measured ns per nonzero per floor, and the newest probe
    meas: dict[str, float] = {}
    probe = None
    try:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("metric") == "session_probe":
                    probe = r
                elif (r.get("metric") == "family_cost" and r.get("k") == args.k
                      and "ns_per_nz" in r):
                    key = FLOOR_OF.get(r["family"])
                    if key:
                        meas[key] = min(meas.get(key, float("inf")), r["ns_per_nz"])
    except FileNotFoundError:
        pass
    mat = builder.power_law_coo(32768, 32768, avg_nnz_per_row=32.0, alpha=1.8, seed=42)
    rows = table(mat, args.k, probe=probe, measured=meas)
    out = {"matrix": "config #1: power_law 32768^2, avg 32, alpha 1.8, seed 42", "k": args.k,
           "rates": "probe" if probe else "published", "rows": rows}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
