"""Hand-written Hopper kernels with their plain PyTorch versions, the
differentiable collectives and point-to-point transfers, and the fused
gradient all-reduce."""

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
from .point_to_point import (
    ppermute,
    pseudo_connect,
    recv,
    send,
    send_recv,
    shift_down,
    shift_up,
)
from .fused import (
    DEFAULT_BUCKET_BYTES,
    FusedSpec,
    OverlapExchange,
    build_overlap_schedule,
    flatten_buckets,
    fused_allreduce,
    fused_collective_budget,
    hierarchical_allreduce,
    overlap_exchange,
    reduce_scatter_allgather,
    unflatten_buckets,
)

__all__ = [
    "DEFAULT_BUCKET_BYTES", "FusedSpec", "OverlapExchange", "allgather",
    "allreduce", "alltoall", "bcast", "build_overlap_schedule",
    "flash_attention", "flash_attention_bwd_reference",
    "flash_attention_reference", "flash_attention_supported",
    "flatten_buckets", "fused_allreduce", "fused_collective_budget",
    "gather", "hierarchical_allreduce", "overlap_exchange", "pmean",
    "ppermute", "pseudo_connect", "psum", "recv",
    "reduce_scatter", "reduce_scatter_allgather", "scatter", "send", "send_recv", "shift_down",
    "shift_up", "unflatten_buckets",
]
