"""The parallel layer: the mesh over the world communicator, ring and
Ulysses attention over its sequence axis, and the Megatron dense layers
over its model axis."""

from .mesh import MeshConfig
from .ring_attention import (
    broadcast_kv,
    local_attention,
    ring_attention,
    simulate_ring,
    zigzag_indices,
)
from .tensor import column_parallel_dense, row_parallel_dense
from .ulysses import all_to_all_tiled, ulysses_attention

__all__ = ["MeshConfig", "all_to_all_tiled", "broadcast_kv",
           "column_parallel_dense", "local_attention", "ring_attention",
           "row_parallel_dense", "simulate_ring", "ulysses_attention",
           "zigzag_indices"]
