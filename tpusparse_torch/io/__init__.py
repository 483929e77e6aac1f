from tpusparse_torch.io.mtx import CooMatrix, read_mtx, write_mtx
from tpusparse_torch.io.builder import banded_coo, power_law_coo, uniform_coo

__all__ = [
    "CooMatrix",
    "read_mtx",
    "write_mtx",
    "uniform_coo",
    "power_law_coo",
    "banded_coo",
]
