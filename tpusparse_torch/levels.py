"""Parallel-level vocabulary.

The reference keys every metadata item by a ``POS_TYPE`` parallel level
(reference: metadata_set.hpp:13-23) with a parent/child priority order
(metadata_set.hpp:29-32).  We keep the same conceptual hierarchy but map it
onto the TPU execution model:

  reference level   GPU meaning              TPU meaning
  ---------------   ----------------------   -------------------------------------
  GLOBAL            whole kernel / grid      whole pallas_call
  TBLOCK  (BMTB)    CUDA thread block        Pallas grid program (one VMEM window)
  WARP    (BMW)     warp of 32 threads       8-sublane row group of the VPU tile
  THREAD  (BMT)     single CUDA thread       row (or nnz chunk) within the tile
  ROW/COL/VAL       per-nonzero arrays       per-nonzero arrays

Levels order from outermost to innermost: GLOBAL > TBLOCK > WARP > THREAD.
"""

import enum


class Level(enum.IntEnum):
    """Parallel levels; smaller value = outer level (higher priority)."""

    GLOBAL = 0
    TBLOCK = 1
    WARP = 2
    THREAD = 3
    ROW = 4
    COL = 5
    VAL = 6

    @property
    def is_parallel(self) -> bool:
        """True for levels that correspond to an execution hierarchy level."""
        return self in (Level.TBLOCK, Level.WARP, Level.THREAD)

    @property
    def short_name(self) -> str:
        return _SHORT_NAMES[self]

    @property
    def block_name(self) -> str:
        """Name of a block at this level (reference: BMTB/BMW/BMT)."""
        return _BLOCK_NAMES[self]

    def parent(self) -> "Level | None":
        """The enclosing parallel level, or None for TBLOCK/non-parallel."""
        if self == Level.THREAD:
            return Level.WARP
        if self == Level.WARP:
            return Level.TBLOCK
        return None


_SHORT_NAMES = {
    Level.GLOBAL: "global",
    Level.TBLOCK: "tblock",
    Level.WARP: "warp",
    Level.THREAD: "thread",
    Level.ROW: "row",
    Level.COL: "col",
    Level.VAL: "val",
}

# Reference block naming: BMTB = Block of Matrix per Thread Block, BMW = per
# Warp, BMT = per Thread (SURVEY.md §1 "Core domain model").
_BLOCK_NAMES = {
    Level.GLOBAL: "MATRIX",
    Level.TBLOCK: "BMTB",
    Level.WARP: "BMW",
    Level.THREAD: "BMT",
    Level.ROW: "ROW",
    Level.COL: "COL",
    Level.VAL: "VAL",
}

#: Parallel levels ordered outer -> inner.
PARALLEL_LEVELS = (Level.TBLOCK, Level.WARP, Level.THREAD)
