"""Metadata items (counterpart of ``tpusparse/meta/item.py``).

The reference's ``universal_array`` is a type-erased typed array
(reference: code_source_data.hpp:10-76); here an item holds a plain numpy
array.  The JAX package's dtype narrowing is not needed by this slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpusparse_torch.levels import Level


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
