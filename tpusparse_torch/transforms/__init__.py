"""Data-transform steps (counterpart of ``tpusparse/transforms``,
reference L3), trimmed to the steps the ported schedule families run.
Each group of the reference's single-purpose steps is one numpy function
over a MetaDataSet that records its provenance on ``ms.trace``.

  reference group                         module
  -------------------------------------   -----------------------------
  sort / reorder steps                    transforms.sort
  matrix div (fixed rows / row-nnz)       transforms.div
  BMTB/BMW/BMT blocking (all directions)  transforms.block
  padding steps                           transforms.pad
  interleave storage                      transforms.interleave
  bitmap / segment arrays                 transforms.segment

  model-driven index compression          transforms.compress

``transforms.compress`` detects the closed forms of the JAX package's
model-driven index compression; no card kernel consumes them yet (the
kernels load every index plane).
"""

from tpusparse_torch.transforms.block import (
    add_block_sizes,
    add_child_offsets,
    add_relative_to_parent,
    block_balanced_nnz_rows,
    block_fixed_interval_cols,
    block_fixed_interval_rows,
    block_fixed_nnz,
    block_group_children,
    block_merge_path,
    merge_adjacent_blocks,
)
from tpusparse_torch.transforms.compress import CompressInfo, detect_compression
from tpusparse_torch.transforms.div import div_by_row_nnz, fixed_div_by_rows
from tpusparse_torch.transforms.interleave import interleave_storage
from tpusparse_torch.transforms.pad import (
    pad_block_rows_to_max,
    pad_blocks_to_uniform_nnz,
    pad_empty_rows,
    pad_nnz_to_multiple,
    pad_row_nnz_to_multiple,
    pad_rows_to_multiple,
    padding_rate,
)
from tpusparse_torch.transforms.segment import (
    parent_bit_map_of_thread,
    segment_offset,
    segment_ptr,
    thread_bit_map,
)
from tpusparse_torch.transforms.sort import (
    get_row_order_by_col,
    get_row_order_by_length,
    remove_empty_rows_in_end,
    reorder_by_row_order,
)

__all__ = [
    "CompressInfo",
    "add_block_sizes",
    "add_child_offsets",
    "add_relative_to_parent",
    "block_balanced_nnz_rows",
    "block_fixed_interval_cols",
    "block_fixed_interval_rows",
    "block_fixed_nnz",
    "block_group_children",
    "block_merge_path",
    "detect_compression",
    "div_by_row_nnz",
    "fixed_div_by_rows",
    "get_row_order_by_col",
    "get_row_order_by_length",
    "interleave_storage",
    "merge_adjacent_blocks",
    "pad_block_rows_to_max",
    "pad_blocks_to_uniform_nnz",
    "pad_empty_rows",
    "pad_nnz_to_multiple",
    "pad_row_nnz_to_multiple",
    "pad_rows_to_multiple",
    "padding_rate",
    "parent_bit_map_of_thread",
    "remove_empty_rows_in_end",
    "reorder_by_row_order",
    "segment_offset",
    "segment_ptr",
    "thread_bit_map",
]
