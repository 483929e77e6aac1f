"""Data-transform steps (counterpart of ``tpusparse/transforms``,
reference L3), trimmed to the steps the ported schedule families run:
the column-direction blocking that ``span_colsplit`` consumes."""

from tpusparse_torch.transforms.block import block_fixed_interval_cols

__all__ = ["block_fixed_interval_cols"]
