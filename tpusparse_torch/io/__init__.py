from tpusparse_torch.io.mtx import CooMatrix, read_mtx, write_mtx
from tpusparse_torch.io.builder import (banded_coo, block_sparse_coo, nm_pruned_dense,
                                       power_law_col_coo, power_law_coo, pruned_weight_coo,
                                       uniform_coo)

__all__ = [
    "CooMatrix",
    "read_mtx",
    "write_mtx",
    "uniform_coo",
    "power_law_coo",
    "banded_coo",
    "power_law_col_coo",
    "pruned_weight_coo",
    "nm_pruned_dense",
    "block_sparse_coo",
]
