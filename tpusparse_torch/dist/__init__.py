"""Multi-device SpMM (counterpart of ``tpusparse/dist/``): the sharded
stripe SpMM (``shard``) and the ring-overlapped halo SpMM (``overlap``)
over a mesh of torch devices in one process or a ``torch.distributed``
process group."""

from tpusparse_torch.dist.shard import (
    make_mesh,
    shard_stripe_format,
    build_sharded_stripe_spmm,
)

__all__ = ["make_mesh", "shard_stripe_format", "build_sharded_stripe_spmm"]
