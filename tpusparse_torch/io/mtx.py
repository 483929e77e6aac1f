"""Matrix-Market COO I/O.

The reference reads row-major-sorted COO ``.mtx`` files: lines starting with
``%`` are comments, the first data line is ``rows cols [nnz]``, entries are
1-based ``row col [val]`` converted to 0-based (reference: struct.cc:49-130,
and the generated-program reader cuda_code/kernel_lib.hpp:237-560 which is a
full mmio implementation supporting pattern/symmetric banners).

Counterpart of ``tpusparse/io/mtx.py``: general / pattern / symmetric /
skew-symmetric real & integer matrices, 1-based indices, comment lines,
rows sorted row-major on load.  A file path goes through the native C++
parser (``native.parse_mtx``); a file object through the Python reader.
Graph mode (config ``performance_flag == 'graph'``) mirrors struct.cc:53-75:
transpose for BFS/PageRank push-style traversal, and drop values / dedup
for connected components.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os

import numpy as np

from tpusparse_torch.config import get_config


@dataclasses.dataclass
class CooMatrix:
    """A COO sparse matrix, always kept row-major sorted (rows, then cols).

    Equivalent of the reference's initial metadata triple ``nz_row_indices`` /
    ``nz_col_indices`` / ``nz_vals`` plus the dimension scalars
    (metadata_set.cc:612-707).
    """

    rows: np.ndarray  # int64 [nnz]
    cols: np.ndarray  # int64 [nnz]
    vals: np.ndarray  # float [nnz]
    shape: tuple[int, int]

    def __post_init__(self) -> None:
        self.rows = np.asarray(self.rows, dtype=np.int64)
        self.cols = np.asarray(self.cols, dtype=np.int64)
        self.vals = np.asarray(self.vals)
        assert self.rows.shape == self.cols.shape == self.vals.shape

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(max(m * n, 1))

    def sort_row_major(self) -> "CooMatrix":
        """The entries in (row, column) order, ties in their given order:
        ``np.lexsort((cols, rows))``, as one stable argsort of the int64
        key row * N + column (the same order, an order of magnitude
        faster at tens of millions of entries)."""
        key = np.asarray(self.rows, np.int64) * self.shape[1] + self.cols
        order = np.argsort(key, kind="stable")
        return CooMatrix(self.rows[order], self.cols[order], self.vals[order], self.shape)

    def is_row_major_sorted(self) -> bool:
        key = self.rows * (self.shape[1] + 1) + self.cols
        return bool(np.all(np.diff(key) >= 0))

    def transpose(self) -> "CooMatrix":
        m, n = self.shape
        return CooMatrix(self.cols, self.rows, self.vals, (n, m)).sort_row_major()

    def dedup(self) -> "CooMatrix":
        """Remove duplicate (row, col) entries keeping the first occurrence
        (in row-major order, the first of each run of equal entries)."""
        key = np.asarray(self.rows, np.int64) * self.shape[1] + self.cols
        if key.size and bool(np.all(key[1:] >= key[:-1])):
            idx = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        else:
            _, idx = np.unique(key, return_index=True)
            idx.sort()
        return CooMatrix(self.rows[idx], self.cols[idx], self.vals[idx], self.shape)

    def sum_duplicates(self) -> "CooMatrix":
        """Sum values of duplicate (row, col) entries (BCOO / scipy COO
        semantics, and what this package's own kernels compute)."""
        key = self.rows * self.shape[1] + self.cols
        uniq, inv = np.unique(key, return_inverse=True)
        vals = np.zeros(uniq.size, dtype=np.asarray(self.vals).dtype)
        np.add.at(vals, inv, self.vals)
        return CooMatrix(uniq // self.shape[1], uniq % self.shape[1], vals, self.shape)

    def row_lengths(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.shape[0]).astype(np.int64)

    def to_csr_ptr(self) -> np.ndarray:
        """Row-pointer array [m+1] (requires row-major order)."""
        ptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.add.at(ptr, self.rows + 1, 1)
        return np.cumsum(ptr)

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        np.add.at(out, (self.rows, self.cols), self.vals.astype(dtype))
        return out

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CooMatrix":
        """The nonzeros of a dense matrix, row-major."""
        rows, cols = np.nonzero(dense)
        return cls(rows.astype(np.int64), cols.astype(np.int64), dense[rows, cols], dense.shape)

    @classmethod
    def from_scipy(cls, sp_mat) -> "CooMatrix":
        """From any scipy.sparse matrix."""
        coo = sp_mat.tocoo()
        return cls(coo.row.astype(np.int64), coo.col.astype(np.int64),
                   np.asarray(coo.data), tuple(coo.shape)).sort_row_major()

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix((self.vals, (self.rows, self.cols)), shape=self.shape)

    @classmethod
    def from_torch(cls, t) -> "CooMatrix":
        """From a torch tensor: sparse COO/CSR/CSC or dense, on any device
        (the pruned-LLM checkpoint path: such weights arrive as torch
        tensors).  Values come out float32."""
        import torch

        if t.layout != torch.strided:
            t = t.coalesce() if t.layout == torch.sparse_coo else t.to_sparse_coo().coalesce()
            idx = t.indices().cpu().numpy()
            return cls(idx[0].astype(np.int64), idx[1].astype(np.int64),
                       t.values().detach().cpu().float().numpy(), tuple(t.shape)).sort_row_major()
        return cls.from_dense(t.detach().cpu().float().numpy())

    def to_torch(self, device="cuda"):
        """A coalesced ``torch.sparse_coo_tensor`` of float32 values on
        ``device`` (duplicates summed)."""
        import torch

        from tpusparse_torch.kernels.common import resolve_device

        idx = torch.from_numpy(np.stack([self.rows, self.cols]))
        vals = torch.from_numpy(np.asarray(self.vals, np.float32))
        return torch.sparse_coo_tensor(idx, vals, size=tuple(self.shape)).coalesce().to(
            resolve_device(device))

    def to_csr_tensor(self, device="cuda", dtype=None):
        """A ``torch.sparse_csr_tensor`` (int64 indices, each row's entries
        in column order, ``dtype`` values, float32 by default) on ``device``:
        the operand of cuSPARSE's product through ``torch.sparse.mm``.
        Duplicate entries stay, and the product sums them."""
        import torch

        from tpusparse_torch.kernels.common import resolve_device

        m, n = self.shape
        order = np.lexsort((self.cols, self.rows))
        crow = torch.zeros(m + 1, dtype=torch.int64)
        crow[1:] = torch.cumsum(torch.bincount(torch.from_numpy(self.rows), minlength=m), 0)
        csr = torch.sparse_csr_tensor(
            crow, torch.from_numpy(self.cols[order]),
            torch.from_numpy(np.asarray(self.vals)[order].astype(np.float32)), size=(m, n))
        return csr.to(device=resolve_device(device), dtype=dtype or torch.float32)


def read_mtx(path_or_file, graph_mode: str | None = None) -> CooMatrix:
    """Read a Matrix-Market (or bare COO) file into a row-major CooMatrix.

    A path goes through the native C++ parser (``native.parse_mtx``, built
    at first use), a file object through the Python reader.  ``graph_mode``
    overrides config: None uses ``get_config().graph_algorithm`` when
    ``performance_flag == 'graph'``; 'bfs'/'pr' transpose the matrix, 'cc'
    drops values to 1 and dedups (struct.cc:53-75).
    """
    if not hasattr(path_or_file, "read"):
        from tpusparse_torch import native

        rows, cols, vals, dims = native.parse_mtx(os.fspath(path_or_file))
        return _apply_graph_mode(CooMatrix(rows, cols, vals, dims), graph_mode)
    text_iter = iter(path_or_file.read().splitlines())

    symmetric = False
    skew = False
    pattern = False
    header_seen = False
    dims: tuple[int, int] | None = None
    rows_l: list[int] = []
    cols_l: list[int] = []
    vals_l: list[float] = []

    first_line = True
    for line in text_iter:
        line = line.strip()
        if not line:
            continue
        if line.startswith("%"):
            if first_line and line.startswith("%%MatrixMarket"):
                banner = line.lower().split()
                skew = "skew-symmetric" in banner
                symmetric = skew or "symmetric" in banner
                pattern = "pattern" in banner
                header_seen = True
            first_line = False
            continue
        first_line = False
        parts = line.split()
        if dims is None:
            # "rows cols [nnz]"; a bare file (reference .mtx.coo style) has
            # no banner and at most three fields
            if len(parts) < 2 or (len(parts) > 3 and not header_seen):
                raise ValueError(f"malformed size line: {line!r}")
            dims = (int(parts[0]), int(parts[1]))
            continue
        r = int(parts[0]) - 1
        c = int(parts[1]) - 1
        v = 1.0 if (pattern or len(parts) < 3) else float(parts[2])
        if skew and r == c:
            raise ValueError(
                f"diagonal entry ({r + 1}, {c + 1}) in skew-symmetric matrix"
            )
        rows_l.append(r)
        cols_l.append(c)
        vals_l.append(v)
        if symmetric and r != c:
            rows_l.append(c)
            cols_l.append(r)
            # skew-symmetric: A = -A^T, the mirrored entry is negated
            vals_l.append(-v if skew else v)

    if dims is None:
        raise ValueError("no size line found in matrix file")
    if rows_l:
        if min(rows_l) < 0 or max(rows_l) >= dims[0] or min(cols_l) < 0 or max(cols_l) >= dims[1]:
            raise ValueError(
                f"entry index out of range for declared shape {dims}: "
                f"rows [{min(rows_l)}, {max(rows_l)}], cols [{min(cols_l)}, {max(cols_l)}] (0-based)"
            )
    mat = CooMatrix(
        np.asarray(rows_l, dtype=np.int64),
        np.asarray(cols_l, dtype=np.int64),
        np.asarray(vals_l, dtype=np.float64),
        dims,
    ).sort_row_major()
    return _apply_graph_mode(mat, graph_mode)


def _apply_graph_mode(mat: CooMatrix, graph_mode: str | None) -> CooMatrix:
    """Graph-mode loader post-processing (struct.cc:53-75)."""
    cfg = get_config()
    mode = graph_mode
    if mode is None and cfg.performance_flag == "graph":
        mode = cfg.graph_algorithm
    if mode in ("bfs", "pr"):
        mat = mat.transpose()
    elif mode == "cc":
        mat = CooMatrix(mat.rows, mat.cols, np.ones_like(mat.vals), mat.shape).dedup()
    return mat


def write_mtx(path: str | os.PathLike, mat: CooMatrix, comment: str = "") -> None:
    """Write a CooMatrix as a Matrix-Market 'coordinate real general' file."""
    buf = _io.StringIO()
    buf.write("%%MatrixMarket matrix coordinate real general\n")
    if comment:
        for line in comment.splitlines():
            buf.write(f"% {line}\n")
    m, n = mat.shape
    buf.write(f"{m} {n} {mat.nnz}\n")
    for r, c, v in zip(mat.rows, mat.cols, mat.vals):
        buf.write(f"{r + 1} {c + 1} {v:.17g}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())
