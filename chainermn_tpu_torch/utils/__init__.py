"""Utilities of the port: the snapshot container
(:mod:`~chainermn_tpu_torch.utils.serialization`).  The JAX package's
observability and tuning planes (telemetry, metrics, profiling, the
autotuner) are ROADMAP Queue A item 10."""

from chainermn_tpu_torch.utils.serialization import (
    ForeignSnapshotError,
    SnapshotCorruptError,
    load_state,
    load_state_with_stamps,
    load_state_with_topology,
    read_topology,
    save_state,
    tree_flatten,
    tree_unflatten,
    verify_state,
)

__all__ = [
    "ForeignSnapshotError",
    "SnapshotCorruptError",
    "load_state",
    "load_state_with_stamps",
    "load_state_with_topology",
    "read_topology",
    "save_state",
    "tree_flatten",
    "tree_unflatten",
    "verify_state",
]
