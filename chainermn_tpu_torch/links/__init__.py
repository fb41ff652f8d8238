"""Links: synchronised batch normalisation, the cross-rank model graph
of model parallelism, and the stacked RNN split over ranks by layer."""

from .batch_normalization import (
    BatchNormState,
    MultiNodeBatchNormalization,
    init_batch_norm,
    multi_node_batch_normalization,
)
from .multi_node_chain_list import MultiNodeChainList
from .n_step_rnn import MultiNodeNStepRNN, create_multi_node_n_step_rnn

__all__ = ["BatchNormState", "MultiNodeBatchNormalization",
           "MultiNodeChainList", "MultiNodeNStepRNN",
           "create_multi_node_n_step_rnn", "init_batch_norm",
           "multi_node_batch_normalization"]
