"""The thresholds where the card's choices of family, method and kernel
part from the TPU's.

The decisions that weigh a size read one record of thresholds, a
``Gates``, for the values on which the two sets differ:

  default_schedule (``schedule.py``)  the family and dg's window for the K regime
  default_candidates (``tune.py``)    which family blocks the tuner times
  tune (``tune.py``)                  what the padding bound counts
  build_plan (``schedule.py``)        brick_ell's chunk-block refusal, the
                                      ``block_ell`` plan's method
  spmv_fn('auto'), spmv_multi_fn      the SpMV method and the column split
  graph.matvec_plan                   the dg SpMV plan or a segment reduction

``TPU_GATES`` holds the JAX package's values, each the v5e's VMEM (or its
compile limit) that the TPU kernels kept X or a chunk block in: under it
every decision equals the JAX package's, which the CPU tests hold.
``CARD_GATES``, the default everywhere, holds the H100's.  The card's
kernels stage no X: the row walks (#1-#4, #7-#9) read X through L2 a slot
at a time, the stripe and tile kernels (#5, #6, #10, #11) a panel of a row
at a time.  So no X gate binds on the card.  The limits it does have hold
under both records: the row walk's int32 slot index
(``kernels/row_walk.py``), and the card's memory, which ``build_plan``
weighs before it packs brick_ell's planes (``schedule.py``).  The values
both records share stay constants beside the rules that read them.  The
measurements behind each value are in PERF.md
(``bench/gates_sweep.py``).
"""

from __future__ import annotations

import dataclasses

MB = 1024 * 1024

#: X a resident block may hold at K = 2-4 on both records: the TPU's tree
#: (dg where X at kt 8 fits, else radix where X at its kt of 2 or 4 fits),
#: which the card measures faster there than dg; past both the card's
#: record takes dg
SMALL_K_X_BYTES = 6 * MB


@dataclasses.dataclass(frozen=True)
class Gates:
    """One set of thresholds (see the module's docstring for who reads
    which).

      x_bytes            X a resident block may hold, dg / radix / span
                         (``default_schedule``, ``default_candidates``),
                         K = 2-4 aside (``SMALL_K_X_BYTES``); None: no X
                         gate
      dg_window_pad      where dg's default window would pad its chunks
                         past this (a chunk of g slots over the nonzeros a
                         program's window holds), the window spans X
                         instead; None: the default geometry as it is
      multi_split_bytes  ``spmv_multi_fn`` splits X past this (None: never)
      brick_block_bytes  brick_ell's chunk blocks past this are refused
                         (None: never)
      dg_x_bytes         x of N fp32 that the dg SpMV plan takes
                         (``spmv_fn('auto')``, ``matvec_plan``); past it a
                         segment reduction; None: always dg
      padding_counts     'planes': the padding bound weighs the packed
                         slots; 'read': for the families whose kernels read
                         only live slots, the slots the kernel reads
      block_ell_method   ``block_ell_spmm``'s method on the ``block_ell``
                         plan: 'xla' (the batched product) or 'pallas' (the
                         kernel, #13)
    """

    name: str
    x_bytes: int | None
    dg_window_pad: float | None
    multi_split_bytes: int | None
    brick_block_bytes: int | None
    dg_x_bytes: int | None
    padding_counts: str
    block_ell_method: str

    def x_fits(self, nbytes: int, k: int | None = None) -> bool:
        """Whether X of ``nbytes`` passes the X gate for ``k`` columns
        (``SMALL_K_X_BYTES`` at K = 2-4)."""
        limit = SMALL_K_X_BYTES if k is not None and 2 <= k <= 4 else self.x_bytes
        return limit is None or nbytes <= limit


#: the JAX package's values (tpusparse/schedule.py:103-147, tune.py:90-313,
#: spmv.py:60-225, graph.py:95, schedule.py:284-293, tune.py:441);
#: TPU-derived
TPU_GATES = Gates(name="tpu", x_bytes=6 * MB, dg_window_pad=None, multi_split_bytes=16 * MB,
                  brick_block_bytes=4 * MB, dg_x_bytes=6 * MB, padding_counts="planes",
                  block_ell_method="xla")

#: the H100's (PERF.md, "Gates"; bench/gates_sweep.py): no X gate and no
#: column split past K = 4, dg's window widened where it would pad past the
#: tuner's padding bound (4); the SpMV and graph drivers on the dg SpMV
#: kernel (#2) at any N; brick_ell never refused by its chunk blocks; the
#: padding bound on the slots read; the Block-ELL kernel
CARD_GATES = Gates(name="card", x_bytes=None, dg_window_pad=4.0, multi_split_bytes=None,
                   brick_block_bytes=None, dg_x_bytes=None, padding_counts="read",
                   block_ell_method="pallas")


def window_nnz(nnz: int, m: int, n: int, rb: int, window: int) -> float:
    """The nonzeros one program's window holds on average: ``rb`` of the
    ``m`` rows (the packer deals rows to programs by length, so programs
    hold alike) over ``window`` of the ``n`` columns, the columns taken as
    uniform."""
    return nnz * min(rb, max(m, 1)) / max(m, 1) * min(window, max(n, 1)) / max(n, 1)


def dg_ns(nnz: int, m: int, n: int, *, rb: int, ns: int, g: int, wt: int,
          gates: Gates) -> int:
    """dg's window tiles: ``ns`` under the TPU's rule, and on the card
    where a chunk of ``g`` slots over the nonzeros a program's window
    holds on average stays within ``dg_window_pad``; else enough tiles to
    span X (a sparse window pads every chunk it cuts; the card's walk reads
    live slots only, so the window weighs only on the format's bytes and
    its pack)."""
    if (gates.dg_window_pad is None
            or g <= gates.dg_window_pad * window_nnz(nnz, m, n, rb, ns * wt)):
        return ns
    return max(ns, -(-n // wt))

