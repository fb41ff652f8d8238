"""The parallel layer: the mesh over the world communicator, ring and
Ulysses attention over its sequence axis, the Megatron dense layers
over its model axis, the pipeline schedules over its pipe axis, the
mixture of experts over its expert axis, and FSDP and the sharded-state
layer over its data axis."""

from .expert import (
    SimulatedExpertAxis,
    expert_parallel_moe,
    simulate_expert_parallel,
)
from .fsdp import fsdp_dims, fsdp_gather, fsdp_shard
from .mesh import MeshConfig
from .pipeline import (
    pipeline_apply,
    pipeline_train_1f1b,
    pipeline_train_interleaved,
    stack_stage_params,
    unstack_stage_params,
)
from .ring_attention import (
    broadcast_kv,
    local_attention,
    ring_attention,
    simulate_ring,
    zigzag_indices,
)
from .sharded_state import LayerGatherStream, LeafLayout, ShardedState
from .tensor import column_parallel_dense, row_parallel_dense
from .ulysses import all_to_all_tiled, ulysses_attention

__all__ = ["LayerGatherStream", "LeafLayout", "MeshConfig",
           "ShardedState", "SimulatedExpertAxis", "all_to_all_tiled",
           "broadcast_kv", "column_parallel_dense", "expert_parallel_moe",
           "fsdp_dims", "fsdp_gather", "fsdp_shard",
           "local_attention", "pipeline_apply",
           "pipeline_train_1f1b", "pipeline_train_interleaved",
           "ring_attention", "row_parallel_dense",
           "simulate_expert_parallel", "simulate_ring",
           "stack_stage_params", "ulysses_attention",
           "unstack_stage_params", "zigzag_indices"]
