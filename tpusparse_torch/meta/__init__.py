from tpusparse_torch.meta.item import MetaDataItem, narrow_dtype
from tpusparse_torch.meta.set import MetaDataSet, create_init_metadata_set
from tpusparse_torch.meta.provenance import DataItemRecord, TransformTrace

__all__ = [
    "MetaDataItem",
    "narrow_dtype",
    "MetaDataSet",
    "create_init_metadata_set",
    "DataItemRecord",
    "TransformTrace",
]
