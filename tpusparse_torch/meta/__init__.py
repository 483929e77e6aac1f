from tpusparse_torch.meta.item import MetaDataItem
from tpusparse_torch.meta.set import MetaDataSet, create_init_metadata_set
from tpusparse_torch.meta.provenance import DataItemRecord, TransformTrace

__all__ = [
    "MetaDataItem",
    "MetaDataSet",
    "create_init_metadata_set",
    "DataItemRecord",
    "TransformTrace",
]
