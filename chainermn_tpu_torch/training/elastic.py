"""Elastic resume — the JAX package's ``training/elastic.py``: topology
signatures and the re-layout of a saved state onto another world size.

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
are recorded with the member axis in front, in the order the snapshot
container flattens them (a dict's keys sorted, JAX's rule).
:func:`same_topology` refuses another mode.

:func:`relayout_state` is the JAX function: it re-lays a WORLD-STACKED
host state saved at world W onto W′ (``shard`` leaves concatenated back
to their true extent, re-padded and re-split; ``stack`` rows trimmed or
repeated, refused when they differ; ``rep`` and ``fsdp`` leaves passed
through; the snapshot-riding exchange plan dropped), bitwise what a
from-scratch sharding of the gathered state at W′ would hold.  A port
rank holds only its own row, so the checkpointer reads the rows of
every old rank (their files, or the parts of a shard-only set), stacks
them (:func:`stack_rank_states`), re-lays the stack on the host — the
same bytes give the same result on every rank — and keeps its own row
(:func:`rank_state_row`).

Not ported, each raising: :class:`ElasticMembership`,
:class:`ResizeController`, :class:`MembershipRecord` and
:func:`post_resize_intent` (the live resize, ROADMAP Queue A item 11).
"""

from __future__ import annotations

import logging
import warnings
from typing import List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch.utils.serialization import (
    sorted_keys,
    tree_flatten,
    tree_unflatten,
)

_LOG = logging.getLogger(__name__)

__all__ = ["ElasticMembership", "MembershipRecord", "RelayoutError",
           "ResizeController", "TOPOLOGY_FORMAT", "gather_zero1_leaves",
           "post_resize_intent", "rank_state_row", "relayout_state",
           "same_topology", "shard_zero1_leaves", "stack_rank_states",
           "topology_signature"]

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
        f"{what} is not ported to chainermn_tpu_torch yet (the live "
        "resize, ROADMAP Queue A item 11)")



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
    optimizer_state_tree` gives it), in the snapshot container's leaf
    order: every tensor and number is read as one row of a ``(world,
    ...)`` stack, and each per-parameter moment, accumulator and stash
    is matched to its parameter by place."""
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
    return _zero1_leaf_layout(sorted_keys(stacked), mirror, world)


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


# --------------------------------------------------------------------- #
# shrink/grow re-layout
# --------------------------------------------------------------------- #


def _leaf_paths(tree) -> List[str]:
    """Each leaf's path in the snapshot container's flatten order, as
    ``jax.tree_util.keystr`` writes it (``['mu'][0]``)."""
    out = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}[{k!r}]")
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f, v in zip(x._fields, x):
                walk(v, f"{path}.{f}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out.append(path)

    walk(tree, "")
    return out


def _host(leaf):
    """``(array, back)``: a leaf as numpy and the function that brings a
    result back to the leaf's kind (a bf16 tensor travels as its
    ``uint16`` bits, which zero-pad to +0.0)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).numpy().view(np.uint16),
                    lambda a: torch.from_numpy(np.array(a).view(
                        np.int16)).view(torch.bfloat16))
        return t.numpy(), torch.from_numpy
    return np.asarray(leaf), lambda a: a


def _rows_identical(arr: np.ndarray) -> bool:
    first = arr[:1].tobytes()
    return all(arr[i:i + 1].tobytes() == first
               for i in range(1, arr.shape[0]))


def _relayout_leaf(leaf, spec: dict, new_world: int, where: str):
    arr, back = _host(leaf)
    kind = spec.get("kind")
    if kind == "rep":
        return leaf
    if kind == "shard":
        if arr.ndim != 2:
            raise RelayoutError(
                f"{where}: recorded as a shard stack but has shape "
                f"{arr.shape} — the snapshot's layout record does not "
                "describe this tree")
        size = int(spec["size"])
        flat = arr.reshape(-1)
        if flat.size < size:
            raise RelayoutError(
                f"{where}: shard stack holds {flat.size} elements, "
                f"fewer than the recorded parameter size {size}")
        s2 = -(-size // new_world)
        out = np.zeros((new_world * s2,), dtype=arr.dtype)
        # the minimal covering read: the true extent only, the old
        # padding dropped and fresh zero padding where a from-scratch
        # sharding at new_world puts it
        out[:size] = flat[:size]
        return back(out.reshape(new_world, s2))
    if kind == "stack":
        if arr.ndim < 1 or arr.shape[0] < 1:
            raise RelayoutError(f"{where}: empty member stack")
        if not _rows_identical(arr):
            raise RelayoutError(
                f"{where}: member-stacked leaf rows differ but the "
                "layout record did not identify it as a parameter "
                "shard — refusing to re-slice state whose layout is "
                "unknown (a silent slice would corrupt the optimizer)")
        if new_world <= arr.shape[0]:
            return back(np.ascontiguousarray(arr[:new_world]))
        return back(np.concatenate(
            [arr] + [arr[:1]] * (new_world - arr.shape[0]), axis=0))
    if kind == "fsdp":
        # the host form of a ZeRO-3 leaf is full width (a shard-only set
        # is assembled first), so a new world passes it through; the
        # placement at the new world re-slices the dim
        dim = int(spec.get("dim", -1))
        length = spec.get("len")
        if dim < 0 or dim >= arr.ndim:
            raise RelayoutError(
                f"{where}: fsdp layout records shard dim {dim} but the "
                f"leaf has shape {arr.shape}")
        if length is not None and int(arr.shape[dim]) != int(length):
            raise RelayoutError(
                f"{where}: fsdp leaf holds {arr.shape[dim]} of the "
                f"recorded {length} elements along dim {dim} — a "
                "shard, not the assembled full leaf; assemble the "
                "covering set first (assemble_shard_state)")
        return leaf
    raise RelayoutError(f"{where}: unknown layout kind {kind!r}")


def relayout_state(state: dict, topo_old: dict, topo_new: dict) -> dict:
    """Re-lay a checkpointer state dict saved under ``topo_old`` onto
    ``topo_new``'s world size (the JAX function, on host numpy; a bf16
    leaf may be a CPU bf16 tensor).  ``state["opt_state"]`` is the
    WORLD-STACKED optimizer state (:func:`stack_rank_states`): under
    ZeRO-1/2 each leaf is re-laid per its record in ``topo_old``'s
    ``opt_leaves`` (refused when a record is missing, a leaf count
    differs, or the mode changes — each :class:`RelayoutError` names the
    leaf's path); the parameters, model state and a replicated
    optimizer pass through; the snapshot-riding exchange plan is
    dropped.  Deterministic: every rank computes the same result from
    the same bytes."""
    mode_old = _sharding_mode(topo_old)
    mode_new = _sharding_mode(topo_new)
    if mode_old != mode_new:
        raise RelayoutError(
            f"snapshot was saved with sharding={mode_old!r} but this "
            f"job runs sharding={mode_new!r} — elastic resume re-lays "
            "a sharding, it does not convert between layouts")
    new_world = int(topo_new["world_size"])
    out = dict(state)
    if mode_old is not None:
        layouts = topo_old.get("opt_leaves")
        if layouts is None:
            raise RelayoutError(
                f"snapshot records sharding={mode_old!r} but carries "
                "no per-leaf layout — it predates the elastic-resume "
                "format and can only restart at its original topology")
        leaves, treedef = tree_flatten(state["opt_state"])
        paths = _leaf_paths(state["opt_state"])
        if len(leaves) != len(layouts):
            raise RelayoutError(
                f"snapshot records {len(layouts)} optimizer-state "
                f"leaves but the tree holds {len(leaves)} — the "
                "model changed shape as well as the world; elastic "
                "resume only re-lays the same model")
        out["opt_state"] = tree_unflatten(treedef, [
            _relayout_leaf(leaf, spec, new_world, f"opt_state{path}")
            for leaf, spec, path in zip(leaves, layouts, paths)])
    ts = state.get("train_state")
    if isinstance(ts, dict) and "exchange_plan" in ts:
        ts = dict(ts)
        ts.pop("exchange_plan")
        out["train_state"] = ts
        _LOG.info(
            "elastic resume: dropped the snapshot-riding exchange plan "
            "(tuned for world=%s) — the new topology re-tunes",
            topo_old.get("world_size"))
    return out


def _stacked(rows):
    """Rows of one leaf stacked on a new member axis (numpy, or a bf16
    tensor's bits)."""
    arrs = [_host(r) for r in rows]
    return arrs[0][1](np.stack([a for a, _ in arrs]))


def stack_rank_states(states, records) -> dict:
    """The world-stacked optimizer state of ``states``, every old rank's
    tree (:func:`~chainermn_tpu_torch.training.optimizer_state_tree`'s,
    as saved), in rank order: each ``shard`` and ``stack`` leaf the
    ranks' rows stacked, a ``rep`` leaf rank 0's."""
    flat = [tree_flatten(s)[0] for s in states]
    leaves, treedef = tree_flatten(states[0])
    if any(len(f) != len(records) for f in flat):
        raise RelayoutError(
            f"{len(records)} layout records for rank states of "
            f"{sorted({len(f) for f in flat})} leaves")
    return tree_unflatten(treedef, [
        leaves[i] if rec.get("kind") in ("rep", "fsdp")
        else _stacked([f[i] for f in flat])
        for i, rec in enumerate(records)])


def rank_state_row(stacked, records, rank: int):
    """Rank ``rank``'s own tree of a world-stacked optimizer state: row
    ``rank`` of each ``shard`` and ``stack`` leaf, ``rep`` leaves as
    they are."""
    leaves, treedef = tree_flatten(stacked)
    out = []
    for leaf, rec in zip(leaves, records):
        if rec.get("kind") in ("rep", "fsdp"):
            out.append(leaf)
            continue
        arr, back = _host(leaf)
        # np.array, not ascontiguousarray: a 0-d row stays 0-d
        out.append(back(np.array(arr[rank])))
    return tree_unflatten(treedef, out)


class ElasticMembership:
    """Not ported: membership epochs on the coordination store."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("ElasticMembership")


class ResizeController:
    """Not ported: a live resize at a step boundary."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("ResizeController")


class MembershipRecord:
    """Not ported: one agreed membership epoch."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("MembershipRecord")


def post_resize_intent(*args, **kwargs):
    """Not ported: post a resize intent on the coordination store."""
    raise _not_ported("post_resize_intent")
