"""Metadata items and dtype narrowing (counterpart of
``tpusparse/meta/item.py``).

The reference's ``universal_array`` is a type-erased typed array with
data-type compression: ``get_compress_data_type`` shrinks u64 index arrays
to u8/u16/u32 by their range (reference: code_source_data.hpp:10-76,
code_source_data.cc).  Here an item holds a plain numpy array, and
:func:`narrow_dtype` is the narrowing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpusparse_torch.levels import Level


def narrow_dtype(arr: np.ndarray, *, allow_unsigned: bool = False, min_bits: int = 8) -> np.ndarray:
    """Shrink an integer array to the smallest dtype that holds its range,
    keeping at least ``min_bits`` bits (the reference's
    ``get_compress_data_type`` / ``find_most_suitable_data_type``).
    Floating arrays are returned unchanged: value precision is a schedule
    decision, not an automatic one."""
    if not np.issubdtype(arr.dtype, np.integer):
        return arr
    if arr.size == 0:
        return arr.astype(np.int32 if not allow_unsigned else np.uint32)
    lo, hi = int(arr.min()), int(arr.max())
    kinds = ([(np.uint8, 8), (np.uint16, 16), (np.uint32, 32), (np.uint64, 64)]
             if (allow_unsigned and lo >= 0)
             else [(np.int8, 8), (np.int16, 16), (np.int32, 32), (np.int64, 64)])
    for dt, bits in kinds:
        if bits < min_bits:
            continue
        info = np.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return arr.astype(dt)
    return arr


@dataclasses.dataclass
class MetaDataItem:
    """One metadata entry: ``(level, name, sub_matrix_id) -> array``.

    Mirrors the reference's ``meta_data_item`` (metadata_set.hpp:62-101)
    including the ``needed_by_format`` flag that marks items which become part
    of the packed on-device format (= kernel inputs; in the reference these
    are also the on-disk filenames and kernel parameter names).
    Scalars are stored as 0-d numpy arrays.
    """

    level: Level
    name: str
    sub_matrix_id: int
    data: np.ndarray
    needed_by_format: bool = False

    def __post_init__(self) -> None:
        self.data = np.asarray(self.data)

    @property
    def key(self) -> tuple[Level, str, int]:
        return (self.level, self.name, self.sub_matrix_id)

    @property
    def item_name(self) -> str:
        """Canonical string name (reference: get_metadata_item_name,
        metadata_set.hpp:59) — used for format files and kernel params."""
        return f"{self.level.short_name}_{self.name}_{self.sub_matrix_id}"

    def check(self) -> None:
        assert isinstance(self.name, str) and self.name
        assert self.sub_matrix_id >= -1  # -1 = whole-matrix scalars
        assert self.data.ndim <= 2, f"{self.item_name}: ndim {self.data.ndim}"
