"""Model-driven index compression (counterpart of
``tpusparse/transforms/compress.py``).

Reference component covered: arr_optimization.{hpp,cc} — detect that a
metadata array is expressible as a closed-form formula and replace the array
load with arithmetic: ``linear`` (i*c + b, arr_optimization.cc:6-80),
``constant``, ``branch`` (<= BRANCH_COMPRESS_MAX_SIZE constant ranges),
``cycle_linear`` (periodic ramp), ``cycle_increase`` (step every cycle);
consumed by codegen via if_*_compress / get_compress_and_relative_result
(code_generator.hpp:80-91), gated by config MODEL_DRIVEN_INDEX_COMPRESS.

Here only the detection is kept: :func:`detect_compression` returns what
the JAX package's returns.  No card kernel consumes it yet: the CUDA
kernels load every index plane (``lrow`` included) from memory, so a
detected formula changes neither a format nor Y.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CompressInfo:
    """A closed-form description of an integer array.

    kind:
      'constant'       arr[i] == value
      'linear'         arr[i] == base + i * step
      'cycle_linear'   arr[i] == base + (i % cycle) * step   (periodic ramp)
      'cycle_increase' arr[i] == base + (i // cycle) * step  (staircase)
      'branch'         piecewise-constant with <= max_branches ranges:
                       arr[i] == values[j] for bounds[j] <= i < bounds[j+1]
      'none'           incompressible
    """

    kind: str
    base: int = 0
    step: int = 0
    cycle: int = 0
    bounds: tuple = ()
    values: tuple = ()

    def evaluate(self, i):
        """Evaluate the formula (works on ints and numpy arrays)."""
        if self.kind == "constant":
            return self.base + 0 * i
        if self.kind == "linear":
            return self.base + i * self.step
        if self.kind == "cycle_linear":
            return self.base + (i % self.cycle) * self.step
        if self.kind == "cycle_increase":
            return self.base + (i // self.cycle) * self.step
        if self.kind == "branch":
            out = 0 * i + self.values[-1]
            for j in range(len(self.values) - 2, -1, -1):
                out = np.where(i < self.bounds[j + 1], self.values[j], out)
            return out
        raise ValueError(f"cannot evaluate kind {self.kind!r}")


def detect_compression(arr: np.ndarray, max_branches: int = 5) -> CompressInfo:
    """Detect the cheapest closed form for an integer array (reference:
    arr_optimization.cc detection order: constant, linear, branch, cyclic)."""
    arr = np.asarray(arr)
    if arr.ndim != 1 or arr.size == 0 or not np.issubdtype(arr.dtype, np.integer):
        return CompressInfo("none")
    a = arr.astype(np.int64)
    n = a.size
    if np.all(a == a[0]):
        return CompressInfo("constant", base=int(a[0]))
    d = np.diff(a)
    if np.all(d == d[0]):
        return CompressInfo("linear", base=int(a[0]), step=int(d[0]))
    # branch: piecewise constant with few ranges
    change = np.nonzero(d != 0)[0]
    if change.size + 1 <= max_branches:
        bounds = tuple([0] + (change + 1).tolist() + [n])
        values = tuple(int(a[b]) for b in bounds[:-1])
        return CompressInfo("branch", bounds=bounds, values=values)
    # cycle_linear: periodic ramp with period c
    nz = np.nonzero(d != d[0])[0]
    if nz.size:
        c = int(nz[0]) + 1
        if c >= 2 and n >= 2 * c:
            base, step = int(a[0]), int(d[0])
            idx = np.arange(n, dtype=np.int64)
            if np.all(a == base + (idx % c) * step):
                return CompressInfo("cycle_linear", base=base, step=step, cycle=c)
            # cycle_increase: constant within cycle, jump every cycle
            jumps = np.nonzero(d != 0)[0]
            if jumps.size:
                c2 = int(jumps[0]) + 1
                s2 = int(d[jumps[0]])
                if c2 >= 1 and np.all(a == int(a[0]) + (idx // c2) * s2):
                    return CompressInfo("cycle_increase", base=int(a[0]), step=s2, cycle=c2)
    return CompressInfo("none")
