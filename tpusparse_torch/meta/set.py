"""MetaDataSet — the in-memory metadata database (counterpart of
``tpusparse/meta/set.py``, reference L2).

A dict of numpy arrays keyed ``(level, name, sub_matrix_id)`` as in the
reference's ``meta_data_set`` (metadata_set.hpp:104-154), bootstrapped from
a COO matrix, with per-item ``check()`` and a ``logical_check()`` that
cross-validates the COO arrays and the blocking metadata: block
boundaries, column tiles, child offsets, parent-relative indices and the
segment bitmaps.  The ``.npz`` format cache is not ported.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from tpusparse_torch.io.mtx import CooMatrix
from tpusparse_torch.levels import PARALLEL_LEVELS, Level
from tpusparse_torch.meta.item import MetaDataItem
from tpusparse_torch.meta.provenance import TransformTrace

Key = tuple[Level, str, int]


class MetaDataSet:
    """Dict of metadata items keyed (level, name, sub_matrix_id)."""

    def __init__(self) -> None:
        self._items: dict[Key, MetaDataItem] = {}
        self.trace = TransformTrace()

    def add(
        self,
        level: Level,
        name: str,
        sub_matrix_id: int,
        data,
        *,
        needed_by_format: bool = False,
        replace: bool = False,
    ) -> MetaDataItem:
        item = MetaDataItem(level, name, sub_matrix_id, np.asarray(data), needed_by_format)
        if not replace and item.key in self._items:
            raise KeyError(f"metadata item already exists: {item.item_name}")
        self._items[item.key] = item
        return item

    def get(self, level: Level, name: str, sub_matrix_id: int) -> np.ndarray:
        return self._items[(level, name, sub_matrix_id)].data

    def get_scalar(self, level: Level, name: str, sub_matrix_id: int) -> int | float:
        return self.get(level, name, sub_matrix_id).item()

    def has(self, level: Level, name: str, sub_matrix_id: int) -> bool:
        return (level, name, sub_matrix_id) in self._items

    def remove(self, level: Level, name: str, sub_matrix_id: int) -> None:
        """Delete an item (reference: remove_item_of_metadata, used by the
        padding re-execution)."""
        del self._items[(level, name, sub_matrix_id)]

    def remove_level(self, level: Level, sub_matrix_id: int) -> list[str]:
        """Delete every item of a parallel level of one sub-matrix (the
        padding rollback); returns their names."""
        doomed = [k for k in self._items if k[0] == level and k[2] == sub_matrix_id]
        for k in doomed:
            del self._items[k]
        return [f"{k[0].short_name}_{k[1]}_{k[2]}" for k in doomed]

    def items(self) -> Iterable[MetaDataItem]:
        return self._items.values()

    def sub_matrix_ids(self) -> list[int]:
        return sorted({k[2] for k in self._items if k[2] >= 0})

    def __len__(self) -> int:
        return len(self._items)

    def nnz(self, sub: int) -> int:
        return int(self.get(Level.VAL, "nz_vals", sub).size)

    def row_num(self, sub: int) -> int:
        return int(self.get_scalar(Level.GLOBAL, "end_row_index", sub)) - int(
            self.get_scalar(Level.GLOBAL, "begin_row_index", sub)
        )

    def col_num(self, sub: int) -> int:
        return int(self.get_scalar(Level.GLOBAL, "end_col_index", sub)) - int(
            self.get_scalar(Level.GLOBAL, "begin_col_index", sub)
        )

    def coo(self, sub: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (
            self.get(Level.ROW, "nz_row_indices", sub),
            self.get(Level.COL, "nz_col_indices", sub),
            self.get(Level.VAL, "nz_vals", sub),
        )

    def set_coo(self, sub: int, rows, cols, vals) -> None:
        self.add(Level.ROW, "nz_row_indices", sub, rows, replace=True)
        self.add(Level.COL, "nz_col_indices", sub, cols, replace=True)
        self.add(Level.VAL, "nz_vals", sub, vals, replace=True)

    def check(self) -> None:
        for item in self._items.values():
            item.check()

    def logical_check(self) -> None:
        """Cross-validate the COO arrays and the blocking metadata of every
        sub-matrix (reference: metadata_set.cc:806+).  Raises AssertionError
        on inconsistency."""
        self.check()
        for sub in self.sub_matrix_ids():
            self._logical_check_sub(sub)

    def _logical_check_sub(self, sub: int) -> None:
        if not self.has(Level.VAL, "nz_vals", sub):
            return
        rows, cols, vals = self.coo(sub)
        nnz = vals.size
        assert rows.size == cols.size == nnz, f"sub {sub}: COO length mismatch"
        row_num = self.row_num(sub)
        # interleaved storage (brick_ell) is position-major inside each block
        interleaved = self.has(Level.GLOBAL, "interleaved", sub) and bool(
            self.get_scalar(Level.GLOBAL, "interleaved", sub))
        if nnz:
            assert rows.min() >= 0 and rows.max() < row_num, f"sub {sub}: row index range"
            assert cols.min() >= 0 and cols.max() < self.col_num(sub), (
                f"sub {sub}: col index range")
            tiled = [lv for lv in PARALLEL_LEVELS if self.has(lv, "col_tile_indices", sub)]
            if tiled and not interleaved:
                # col-direction blocking stores nz by (col tile, row): rows
                # must be sorted within each tile
                fnz = self.get(tiled[0], "first_nz_indices", sub).astype(np.int64)
                for a, b in zip(fnz[:-1], fnz[1:]):
                    assert np.all(np.diff(rows[a:b].astype(np.int64)) >= 0), (
                        f"sub {sub}: rows not sorted within col tile")
            elif not interleaved:
                assert np.all(np.diff(rows.astype(np.int64)) >= 0), f"sub {sub}: rows not sorted"
        for level in PARALLEL_LEVELS:
            self._check_level_blocks(sub, level, nnz, row_num)
        self._check_child_offsets(sub)
        self._check_relative(sub)
        self._check_segments(sub, nnz)

    def _check_level_blocks(self, sub: int, level: Level, nnz: int, row_num: int) -> None:
        has_nz = self.has(level, "first_nz_indices", sub)
        has_row = self.has(level, "first_row_indices", sub)
        n_blocks = None
        if has_nz:
            fnz = self.get(level, "first_nz_indices", sub).astype(np.int64)
            assert fnz.ndim == 1 and fnz.size >= 2, f"{level.block_name} first_nz_indices shape"
            assert fnz[0] == 0 and fnz[-1] == nnz, (
                f"{level.block_name} first_nz_indices must span [0, nnz]: "
                f"{fnz[0]}..{fnz[-1]} vs {nnz}")
            assert np.all(np.diff(fnz) >= 0), f"{level.block_name} first_nz_indices not sorted"
            n_blocks = fnz.size - 1
        if has_row:
            frow = self.get(level, "first_row_indices", sub).astype(np.int64)
            assert frow.ndim == 1 and frow.size >= 2
            assert frow[0] >= 0 and frow[-1] <= row_num, (
                f"{level.block_name} first_row_indices range")
            assert np.all(np.diff(frow) >= 0), f"{level.block_name} first_row_indices not sorted"
            if n_blocks is not None:
                assert frow.size - 1 == n_blocks, (
                    f"{level.block_name}: first_row ({frow.size - 1}) vs first_nz "
                    f"({n_blocks}) count")
        if self.has(level, "first_row_indices_without_ending", sub):
            fwe = self.get(level, "first_row_indices_without_ending", sub)
            frow = self.get(level, "first_row_indices", sub)
            assert fwe.size == frow.size - 1
            assert np.array_equal(fwe.astype(np.int64), frow[:-1].astype(np.int64))

    def _check_child_offsets(self, sub: int) -> None:
        for parent, child, name in ((Level.TBLOCK, Level.WARP, "first_BMW_indices"),
                                    (Level.TBLOCK, Level.THREAD, "first_BMT_indices"),
                                    (Level.WARP, Level.THREAD, "first_BMT_indices")):
            if not self.has(parent, name, sub):
                continue
            arr = self.get(parent, name, sub).astype(np.int64)
            assert np.all(np.diff(arr) >= 0), f"{parent.block_name}.{name} not sorted"
            assert arr[0] == 0
            if self.has(child, "first_nz_indices", sub):
                n_child = self.get(child, "first_nz_indices", sub).size - 1
                assert arr[-1] == n_child, (
                    f"{parent.block_name}.{name} last ({arr[-1]}) != child count ({n_child})")
            if self.has(parent, "first_nz_indices", sub):
                n_parent = self.get(parent, "first_nz_indices", sub).size - 1
                assert arr.size - 1 == n_parent, f"{parent.block_name}.{name} length"

    def _check_relative(self, sub: int) -> None:
        for child, parent in ((Level.WARP, Level.TBLOCK), (Level.THREAD, Level.TBLOCK),
                              (Level.THREAD, Level.WARP)):
            for base in ("first_row_indices", "first_nz_indices"):
                name = f"{base}_relative_to_{parent.block_name}"
                if not self.has(child, name, sub):
                    continue
                rel = self.get(child, name, sub).astype(np.int64)
                child_abs = self.get(child, base, sub).astype(np.int64)
                parent_abs = self.get(parent, base, sub).astype(np.int64)
                off_name = f"first_{child.block_name}_indices"
                assert self.has(parent, off_name, sub), f"need {parent.block_name}.{off_name}"
                offs = self.get(parent, off_name, sub).astype(np.int64)
                parent_of_child = np.clip(
                    np.searchsorted(offs, np.arange(rel.size), side="right") - 1,
                    0, offs.size - 2)
                assert np.array_equal(parent_abs[parent_of_child] + rel,
                                      child_abs[: rel.size]), (
                    f"{child.block_name}.{name}: abs != parent abs + rel")

    def _check_segments(self, sub: int, nnz: int) -> None:
        for level in PARALLEL_LEVELS:
            if self.has(level, "bit_map_of_thread", sub):
                bm = self.get(level, "bit_map_of_thread", sub)
                assert bm.size == nnz, f"{level.block_name} bit_map size"
                assert set(np.unique(bm)).issubset({0, 1})
            if self.has(level, "segment_ptr", sub):
                assert np.all(np.diff(self.get(level, "segment_ptr", sub).astype(np.int64)) >= 0)


def create_init_metadata_set(mat: CooMatrix) -> MetaDataSet:
    """Bootstrap a MetaDataSet from a COO matrix (reference:
    create_init_metadata_set_from_file, metadata_set.cc:612-707): 7 scalars
    (global dims under sub_matrix_id=-1, boundary scalars under sub 0) plus
    the 3 COO arrays under sub_matrix_id=0."""
    if not mat.is_row_major_sorted():
        mat = mat.sort_row_major()
    ms = MetaDataSet()
    m, n = mat.shape
    ms.add(Level.GLOBAL, "origin_row_num", -1, np.int64(m))
    ms.add(Level.GLOBAL, "origin_col_num", -1, np.int64(n))
    ms.add(Level.GLOBAL, "origin_nnz_num", -1, np.int64(mat.nnz))
    ms.add(Level.GLOBAL, "begin_row_index", 0, np.int64(0))
    ms.add(Level.GLOBAL, "end_row_index", 0, np.int64(m))
    ms.add(Level.GLOBAL, "begin_col_index", 0, np.int64(0))
    ms.add(Level.GLOBAL, "end_col_index", 0, np.int64(n))
    ms.add(Level.ROW, "nz_row_indices", 0, mat.rows.copy())
    ms.add(Level.COL, "nz_col_indices", 0, mat.cols.copy())
    ms.add(Level.VAL, "nz_vals", 0, mat.vals.copy())
    ms.trace.record(
        "create_init_metadata_set",
        [],
        ["global_origin_row_num_-1", "row_nz_row_indices_0", "col_nz_col_indices_0", "val_nz_vals_0"],
        rows=m,
        cols=n,
        nnz=mat.nnz,
    )
    return ms
