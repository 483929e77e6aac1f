"""Hand-written CUDA kernels for Hopper (counterpart of
``tpusparse/kernels``), each beside a plain PyTorch version of the same
function.  Sources live in ``tpusparse_torch/csrc`` and are built by
``kernels.build`` at first use.

  dg_gather   the K <= 128 / SpMV workhorse of the default schedule
              (family dg_span): replaces _dg_kernel and _dg1_kernel.
  dgt_gather  the tile-window co-champion (family dgt_span, SpMV 'dgt8',
              spmv_multi_fn): replaces _dgt_kernel and _dgt_kernel_stream.
  tile_onehot the column-tiled family (tile_onehot, the default at K > 128):
              replaces _tile_kernel and _tile_kernel_stream.
  span_gather the span-chunked family (span_onehot, span_colsplit, SpMV
              'span'): replaces _span_kernel and _span_kernel_stream.
  radix_gather the radix_span and brick_ell families (SpMV 'radix'):
              replaces _radix_kernel.
  stripe_gather the stripe and segment families (SpMV 'stripe'):
              replaces _stripe_kernel and _stripe_nested_kernel.
  nm_structured N:M structured weights (SparseLinear.from_nm): replaces
              _nm_kernel.
  block_ell   block-sparse weights (family block_ell,
              SparseLinear.from_block): replaces _bell_kernel.
  sddmm       the gradients of trainable span values (spmm_trainable,
              TrainableSparseLinear): replaces _sddmm_kernel and _dx_kernel.
"""
