"""Topology signatures — the part of the JAX package's
``training/elastic.py`` that the checkpointer stamps into every shard.

``world_size`` is the number of ranks the state is laid out over and
``inter_size`` the number of processes.  A port process is one rank, so
both are ``comm.size``; the JAX package counts devices and processes.
There is no device mesh (``axis_names`` and ``mesh_shape`` are
``None``).  ``sharding`` names the optimizer state's layout
(``"zero1"``/``"zero2"``, :class:`~chainermn_tpu_torch.training.
Zero1Transformation`; ``"zero3"`` for FSDP), and for a ZeRO-1/2 state
``opt_leaves`` records each leaf's layout
(:mod:`~chainermn_tpu_torch.parallel.sharded_state`'s vocabulary):
this rank's state is the JAX world-stacked state's row, so its leaves
are recorded with the member axis in front.  :func:`same_topology`
refuses another mode.

Not ported, each raising: re-laying a state onto another world size
(:func:`relayout_state`), :class:`ElasticMembership` and
:class:`ResizeController` (elastic training, ROADMAP Queue A item 11).
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import torch
import torch.utils._pytree as pytree

__all__ = ["ElasticMembership", "RelayoutError", "ResizeController",
           "TOPOLOGY_FORMAT", "gather_zero1_leaves", "relayout_state",
           "same_topology", "shard_zero1_leaves", "topology_signature"]

# Bump when the signature's meaning changes: a format mismatch is a
# topology mismatch.
TOPOLOGY_FORMAT = 1

# the fields two signatures must agree on to be the same topology
_COMPARE_KEYS = ("format", "world_size", "inter_size", "axis_names",
                 "mesh_shape", "zero1")


class RelayoutError(RuntimeError):
    """A saved state could not be laid onto the new topology (a missing
    or garbled layout record, a leaf the signature cannot identify)."""


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to chainermn_tpu_torch yet (elastic "
        "training, ROADMAP Queue A item 11)")


def _zero1_leaf_layout(opt_state, params, world: int) -> List[dict]:
    """The layout records of a WORLD-STACKED ZeRO-1/2 state tree in
    flattened order (``shard``/``stack``/``rep``), from
    :func:`~chainermn_tpu_torch.parallel.sharded_state.zero_opt_layouts`."""
    from chainermn_tpu_torch.parallel.sharded_state import (
        layout_records,
        zero_opt_layouts,
    )

    return layout_records(zero_opt_layouts(opt_state, params, world))


def _rank_state_records(opt_state, params, world: int) -> List[dict]:
    """:func:`_zero1_leaf_layout` of this rank's ZeRO state (the
    optimizer, as :func:`~chainermn_tpu_torch.training.
    optimizer_state_tree` gives it): every tensor and number is read as
    one row of a ``(world, ...)`` stack, and each per-parameter moment,
    accumulator and stash is matched to its parameter by place."""
    from .optimizers import optimizer_state_tree

    tree = optimizer_state_tree(opt_state)
    leaves = pytree.tree_leaves(params)
    stacked = pytree.tree_map(
        lambda t: torch.empty((world, *torch.as_tensor(t).shape),
                              dtype=torch.as_tensor(t).dtype,
                              device="meta"), tree)
    inner = tree.get("inner", tree)
    mirror = {"state": [{k: p for k in st if k != "count"}
                        for st, p in zip(inner["state"], leaves)],
              "acc": list(leaves), "prev_grads": list(leaves)}
    return _zero1_leaf_layout(stacked, mirror, world)


def _sharding_mode(sig: Optional[dict]) -> Optional[str]:
    """The sharding mode of a signature: ``sharding`` when stamped, else
    the legacy ``zero1`` flag."""
    if sig is None:
        return None
    mode = sig.get("sharding")
    if mode is not None:
        return str(mode)
    return "zero1" if sig.get("zero1") else None


def topology_signature(comm, params=None, opt_state=None,
                       zero1: bool = False,
                       sharding: Optional[str] = None,
                       layouts: Optional[dict] = None) -> dict:
    """The builtins-only layout record a snapshot is stamped with.

    ``sharding`` names the state-sharding mode (``"zero1"``/``"zero2"``/
    ``"zero3"``; ``zero1=True`` means ``"zero1"``).  Under ZeRO-1/2 with
    both ``params`` and ``opt_state`` (this rank's), ``opt_leaves``
    records every optimizer-state leaf's layout; a ``layouts`` table
    (:func:`~chainermn_tpu_torch.parallel.sharded_state.
    state_layout_table`'s) is stamped as it is instead, and under
    ``"zero3"`` its dim-sharded parameters as ``param_leaves``."""
    mode = sharding if sharding is not None else (
        "zero1" if zero1 else None)
    sig = {
        "format": TOPOLOGY_FORMAT,
        "world_size": int(comm.size),
        "inter_size": int(comm.size),
        "axis_names": None,
        "mesh_shape": None,
        # True for any ZeRO-1/2 carry: the two share one layout
        "zero1": mode in ("zero1", "zero2"),
    }
    if mode is not None:
        sig["sharding"] = mode
    if layouts is not None:
        from chainermn_tpu_torch.parallel.sharded_state import (
            layout_records,
        )

        if layouts.get("opt_state") is not None:
            sig["opt_leaves"] = layout_records(layouts["opt_state"])
        recs = layout_records(layouts.get("params") or [])
        if any(r.get("kind") == "fsdp" for r in recs):
            sig["param_leaves"] = recs
    elif mode in ("zero1", "zero2") and params is not None \
            and opt_state is not None:
        sig["opt_leaves"] = _rank_state_records(opt_state, params,
                                                sig["world_size"])
    return sig


def same_topology(a: Optional[dict], b: Optional[dict]) -> bool:
    """Whether two signatures describe the same topology (the exact
    resume path).  ``None`` (an unstamped snapshot) never matches."""
    if a is None or b is None:
        return False
    return (all(a.get(k) == b.get(k) for k in _COMPARE_KEYS)
            and _sharding_mode(a) == _sharding_mode(b))


_ZERO1_LEAVES_WARNED = False


def _warn_zero1_leaves_deprecated(name: str) -> None:
    global _ZERO1_LEAVES_WARNED
    if _ZERO1_LEAVES_WARNED:
        return
    _ZERO1_LEAVES_WARNED = True
    warnings.warn(
        f"training.elastic.{name} is deprecated: the unified "
        "sharded-state layer (parallel.sharded_state."
        "gather_state_leaves / shard_state_leaves) handles "
        "ZeRO-1/2/3 layouts through one signature table; this shim "
        "delegates there and will be removed (warning shown once per "
        "process)", DeprecationWarning, stacklevel=3)


def gather_zero1_leaves(opt_state, layouts: List[dict]):
    """Deprecated: :func:`~chainermn_tpu_torch.parallel.sharded_state.
    gather_state_leaves`, warning once a process."""
    from chainermn_tpu_torch.parallel.sharded_state import (
        gather_state_leaves,
    )

    _warn_zero1_leaves_deprecated("gather_zero1_leaves")
    return gather_state_leaves(opt_state, layouts)


def shard_zero1_leaves(full_state, layouts: List[dict], world: int):
    """Deprecated: :func:`~chainermn_tpu_torch.parallel.sharded_state.
    shard_state_leaves`, warning once a process."""
    from chainermn_tpu_torch.parallel.sharded_state import (
        shard_state_leaves,
    )

    _warn_zero1_leaves_deprecated("shard_zero1_leaves")
    return shard_state_leaves(full_state, layouts, world)


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
