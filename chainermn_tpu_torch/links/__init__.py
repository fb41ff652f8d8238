"""Links: synchronised batch normalisation."""

from .batch_normalization import (
    BatchNormState,
    MultiNodeBatchNormalization,
    init_batch_norm,
    multi_node_batch_normalization,
)

__all__ = ["BatchNormState", "MultiNodeBatchNormalization",
           "init_batch_norm", "multi_node_batch_normalization"]
