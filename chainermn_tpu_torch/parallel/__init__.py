"""Single-device parts of the JAX package's parallel layer."""

from .ring_attention import broadcast_kv, local_attention
from .tensor import column_parallel_dense, row_parallel_dense

__all__ = ["broadcast_kv", "column_parallel_dense", "local_attention",
           "row_parallel_dense"]
