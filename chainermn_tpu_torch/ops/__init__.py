"""Hand-written Hopper kernels with their plain PyTorch versions, the
differentiable collectives and the fused gradient all-reduce."""

from .collectives import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    pmean,
    psum,
    reduce_scatter,
    scatter,
)
from .flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_supported,
)
from .fused import (
    DEFAULT_BUCKET_BYTES,
    FusedSpec,
    flatten_buckets,
    fused_allreduce,
    fused_collective_budget,
    unflatten_buckets,
)

__all__ = [
    "DEFAULT_BUCKET_BYTES", "FusedSpec", "allgather", "allreduce",
    "alltoall", "bcast", "flash_attention", "flash_attention_bwd_reference",
    "flash_attention_reference", "flash_attention_supported",
    "flatten_buckets", "fused_allreduce", "fused_collective_budget",
    "gather", "pmean", "psum", "reduce_scatter", "scatter",
    "unflatten_buckets",
]
