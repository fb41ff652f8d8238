"""Topology signatures — the part of the JAX package's
``training/elastic.py`` that the checkpointer stamps into every shard.

``world_size`` is the number of ranks the state is laid out over and
``inter_size`` the number of processes.  A port process is one rank, so
both are ``comm.size``; the JAX package counts devices and processes.
The port shards no optimizer state yet (ZeRO, ROADMAP Queue A item 8
as ``create_multi_node_optimizer(zero1=True)`` names it), so its
signatures carry ``zero1 = False`` and no per-leaf layout, and there is
no device mesh (``axis_names`` and ``mesh_shape`` are ``None``).

Not ported, each raising: re-laying a state onto another world size
(:func:`relayout_state`), :class:`ElasticMembership` and
:class:`ResizeController` (elastic training, ROADMAP Queue A item 9).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ElasticMembership", "ResizeController", "TOPOLOGY_FORMAT",
           "relayout_state", "same_topology", "topology_signature"]

# Bump when the signature's meaning changes: a format mismatch is a
# topology mismatch.
TOPOLOGY_FORMAT = 1

# the fields two signatures must agree on to be the same topology
_COMPARE_KEYS = ("format", "world_size", "inter_size", "axis_names",
                 "mesh_shape", "zero1")


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to chainermn_tpu_torch yet (elastic "
        "training, ROADMAP Queue A item 9)")


def _sharding_mode(sig: Optional[dict]) -> Optional[str]:
    if sig is None:
        return None
    mode = sig.get("sharding")
    if mode is not None:
        return str(mode)
    return "zero1" if sig.get("zero1") else None


def topology_signature(comm, zero1: bool = False) -> dict:
    """The builtins-only layout record a snapshot is stamped with."""
    if zero1:
        raise NotImplementedError(
            "a ZeRO-sharded topology signature is not ported to "
            "chainermn_tpu_torch yet (ROADMAP Queue A item 8)")
    return {
        "format": TOPOLOGY_FORMAT,
        "world_size": int(comm.size),
        "inter_size": int(comm.size),
        "axis_names": None,
        "mesh_shape": None,
        "zero1": False,
    }


def same_topology(a: Optional[dict], b: Optional[dict]) -> bool:
    """Whether two signatures describe the same topology (the exact
    resume path).  ``None`` (an unstamped snapshot) never matches."""
    if a is None or b is None:
        return False
    return (all(a.get(k) == b.get(k) for k in _COMPARE_KEYS)
            and _sharding_mode(a) == _sharding_mode(b))


def relayout_state(state: dict, topo_old: dict, topo_new: dict) -> dict:
    """Not ported: re-lay a saved state onto another world size."""
    raise _not_ported("relayout_state")


class ElasticMembership:
    """Not ported: membership epochs on the coordination store."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("ElasticMembership")


class ResizeController:
    """Not ported: a live resize at a step boundary."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("ResizeController")
