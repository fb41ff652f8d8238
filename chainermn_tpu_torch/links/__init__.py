"""Links: synchronised batch normalisation and the cross-rank model
graph of model parallelism."""

from .batch_normalization import (
    BatchNormState,
    MultiNodeBatchNormalization,
    init_batch_norm,
    multi_node_batch_normalization,
)
from .multi_node_chain_list import MultiNodeChainList

__all__ = ["BatchNormState", "MultiNodeBatchNormalization",
           "MultiNodeChainList", "init_batch_norm",
           "multi_node_batch_normalization"]
