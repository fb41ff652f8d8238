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

Membership epochs and the live resize:

- :class:`ElasticMembership` agrees epoch-numbered
  :class:`MembershipRecord` s over the world's key-value store only (a
  :class:`~chainermn_tpu_torch.communicators._obj_channel.
  KVObjectChannel` allgather, never the gloo or NCCL group), keeps the
  record in ``membership.json`` (written atomically) and fences object
  channels to the epoch, so traffic of an older incarnation is refused
  with :class:`StaleGenerationError`.
- :class:`ResizeController` resizes a RUNNING job at a step boundary,
  in the same processes.  ``torchrun`` fixes the process set: a world of
  size W is the communicator over the launch's ranks ``[0, W)``
  (``create_communicator(ranks=)``), so of two worlds the larger holds
  the smaller.  A rank a shrink leaves out is PARKED inside the
  controller: it gives its rows and waits on the store for the next
  membership record; one that names it (a grow) brings it back into
  ``trainer.run`` at the survivors' iteration, the job's end stops its
  trainer.  The state moves over the larger world's object group (the
  old members give their rows), is stacked, re-laid and cut per rank as
  an elastic resume does it, so the result is bitwise what a
  save/restart at the same boundary restores.  A process that dies is
  not a shrink: NCCL cannot keep a group without it, and that case is
  the between-run resume.
- :func:`post_resize_intent` posts an intent on the store for a running
  job's controller.

The JAX package names processes ``inter_rank``/``inter_size``; a port
process is one rank, so the port reads ``rank``/``size``
(``inter_size`` counts nodes here).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import warnings
from typing import Any, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch.communicators._obj_channel import (
    KVObjectChannel,
    StaleGenerationError,
    kv_get_json,
    read_json_file,
)
from chainermn_tpu_torch.utils.serialization import (
    sorted_keys,
    tree_flatten,
    tree_unflatten,
)

_LOG = logging.getLogger(__name__)

__all__ = ["ElasticMembership", "MembershipRecord", "RelayoutError",
           "ResizeController", "StaleGenerationError", "TOPOLOGY_FORMAT",
           "gather_zero1_leaves", "post_resize_intent", "rank_state_row",
           "relayout_state", "same_topology", "shard_zero1_leaves",
           "stack_rank_states", "topology_signature"]

# Bump when the signature's meaning changes: a format mismatch is a
# topology mismatch.
TOPOLOGY_FORMAT = 1

# the fields two signatures must agree on to be the same topology
_COMPARE_KEYS = ("format", "world_size", "inter_size", "axis_names",
                 "mesh_shape", "zero1")


class RelayoutError(RuntimeError):
    """A saved state could not be laid onto the new topology (a missing
    or garbled layout record, a leaf the signature cannot identify)."""


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




# --------------------------------------------------------------------- #
# membership epochs
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class MembershipRecord:
    """One agreed membership epoch: who is in the world and in what
    order.  ``members`` is the sorted list of the world's ranks; a
    rank's place in it is its rank in the world."""

    epoch: int
    world_size: int
    members: List[int]
    created: float = 0.0

    def rank_of(self, process_id: int) -> int:
        return self.members.index(process_id)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MembershipRecord":
        return cls(epoch=int(d["epoch"]),
                   world_size=int(d["world_size"]),
                   members=[int(m) for m in d["members"]],
                   created=float(d.get("created", 0.0)))


class ElasticMembership:
    """Epoch-numbered membership agreement over the world's key-value
    store.

    ``agree()`` is collective over ``comm``'s ranks: each contributes
    ``(rank, last known epoch)`` through a store-only allgather (never a
    process group: membership must be agreeable when the data plane is
    what failed), and every rank folds the same rows into the same
    record: epoch = the largest known epoch + 1, members = the
    contributors, or with ``world_size`` the ranks ``[0, world_size)``
    (the live resize's next world, a prefix of the launch).  The first
    member writes the record beside the snapshots (``path``, atomically)
    so epochs survive a relaunch, and publishes it on the store
    (``elastic/membership/<epoch>``).  :meth:`fence` tags object
    channels with the epoch; :meth:`note_stop` records a deliberate
    stop (the preemption path), so a relaunch bumps past it.

    The store outlives a live resize's worlds, so each agreement's
    allgather runs on keys of its own: the object's tag salted with the
    epoch of the record this process last agreed or adopted, which the
    contributors share (they agreed it together, or a joining rank
    adopted it from the resize's record).  A rank parked through some
    agreements therefore never reads another's rows.  The keys of an
    agreement are one small message a rank, left on the store.
    ``comm`` follows the world: :class:`ResizeController` points it at
    the world that agrees.
    """

    KV_PREFIX = "elastic"

    # per-process creation counter: distinct objects never share keys
    # (every rank makes its memberships in the same order)
    _INCARNATIONS = 0

    def __init__(self, comm, path: Optional[str] = None,
                 filename: str = "membership.json",
                 timeout_ms: int = 60_000):
        self.comm = comm
        self.path = path
        self.filename = filename
        self.timeout_ms = int(timeout_ms)
        self.record: Optional[MembershipRecord] = None
        inc = ElasticMembership._INCARNATIONS
        ElasticMembership._INCARNATIONS = inc + 1
        self._tag = f"elastic-membership-i{inc}"

    # -- persistence --------------------------------------------------- #

    @property
    def _file(self) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, self.filename)

    def _read_file(self) -> dict:
        f = self._file
        return {} if f is None else read_json_file(f)

    def _write_file(self, payload: dict) -> None:
        f = self._file
        if f is None:
            return
        os.makedirs(os.path.dirname(f) or ".", exist_ok=True)
        tmp = f"{f}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        os.replace(tmp, f)

    def stored_epoch(self) -> int:
        """The newest epoch this process knows: the persisted record's,
        or the last one it agreed (0 before any: the first agreement is
        epoch 1)."""
        known = self.record.epoch if self.record is not None else 0
        return max(int(self._read_file().get("epoch", 0)), known)

    # -- the store side ------------------------------------------------ #

    @property
    def _kv(self):
        """The world's store, or ``None`` for a world of one rank or one
        started without ``init_distributed``."""
        if int(self.comm.size) <= 1:
            return None
        return getattr(self.comm, "store", None)

    def _publish_record(self, rec: MembershipRecord) -> None:
        kv = self._kv
        if kv is None:
            return
        payload = json.dumps(rec.to_dict(), sort_keys=True)
        for key, value in ((f"{self.KV_PREFIX}/epoch", str(rec.epoch)),
                           (f"{self.KV_PREFIX}/membership/{rec.epoch}",
                            payload)):
            kv.set(key, value)

    # -- the collective ------------------------------------------------ #

    def agree(self, world_size: Optional[int] = None) -> MembershipRecord:
        """Agree this incarnation's record (COLLECTIVE over ``comm``'s
        ranks); also kept as :attr:`record`.  ``world_size`` names the
        next world ``[0, world_size)`` when it differs from the
        contributors (a live resize)."""
        me, n = int(self.comm.rank), int(self.comm.size)
        prev = self.stored_epoch()
        if n <= 1:
            rows = [(me, prev)]
        else:
            salt = self.record.epoch if self.record is not None else 0
            chan = KVObjectChannel(tag=f"{self._tag}-e{salt}",
                                   timeout_ms=self.timeout_ms,
                                   store=getattr(self.comm, "store", None))
            rows = chan.allgather((me, prev), list(range(n)), me)
        members = (sorted(int(r) for r, _ in rows) if world_size is None
                   else list(range(int(world_size))))
        epoch = max(int(p) for _, p in rows) + 1
        rec = MembershipRecord(epoch=epoch, world_size=len(members),
                               members=members, created=time.time())
        if me == min(int(r) for r, _ in rows):
            self._write_file(rec.to_dict())
            self._publish_record(rec)
        self.record = rec
        _LOG.info("elastic membership epoch %d agreed: world_size=%d "
                  "members=%s (this process: rank %d)", epoch,
                  rec.world_size, members, me)
        return rec

    def fence(self, *targets) -> int:
        """Fence object channels to the agreed epoch.  Each target is a
        :class:`KVObjectChannel` or anything carrying one as
        ``_obj_channel`` (a communicator).  Returns the generation set.
        Must run AFTER :meth:`agree`."""
        if self.record is None:
            raise RuntimeError(
                "fence() before agree() — there is no agreed epoch to "
                "fence to")
        gen = self.record.epoch
        for t in targets:
            chan = getattr(t, "_obj_channel", t)
            if not hasattr(chan, "set_generation"):
                raise TypeError(
                    f"cannot fence {type(t).__name__}: no object "
                    "channel found")
            chan.set_generation(gen)
        return gen

    def note_stop(self, reason: str = "",
                  iteration: Optional[int] = None) -> None:
        """Record that this incarnation stopped deliberately (the
        preemption path calls it after its collective save), so a
        relaunch's ``agree()`` bumps past this epoch.  The first member
        writes; the others do nothing."""
        me = int(self.comm.rank)
        writer = (self.record.members[0] if self.record is not None
                  else 0)
        if me != writer:
            return
        if self._file is None:
            _LOG.warning(
                "ElasticMembership.note_stop: no durable path was "
                "configured (path=None), so this stop is NOT recorded "
                "— a relaunch cannot bump the epoch past this "
                "incarnation; pass path=<snapshot dir> to get the "
                "documented preemption→relaunch cycle")
            return
        payload = self._read_file()
        if self.record is not None:
            payload.update(self.record.to_dict())
        payload.setdefault("epoch", self.stored_epoch())
        payload["stopped"] = {"reason": reason, "iteration": iteration,
                              "ts": time.time()}
        self._write_file(payload)


# --------------------------------------------------------------------- #
# the live resize
# --------------------------------------------------------------------- #

#: the store prefix of a resize intent (:func:`post_resize_intent`)
RESIZE_KV_PREFIX = "elastic/resize"
#: the store prefix of the live resize's records, one a resize in order,
#: which parked ranks wait on
LIVE_KV_PREFIX = "elastic/live"
# a parked rank's poll of the store: a short wait next to a resize's
# pause, one store round trip a poll
_PARK_POLL_S = 0.02


def post_resize_intent(world_size: int, reason: str = "",
                       store=None) -> None:
    """Post a resize intent on the world's store for a running job's
    :class:`ResizeController` to pick up (external tooling's entry
    point; in the job, ``controller.request``).  Overwrites in place, so
    repeated posts converge on the newest."""
    from chainermn_tpu_torch.communicators._obj_channel import world_store

    store = store if store is not None else world_store()
    if store is None:
        raise RuntimeError(
            "post_resize_intent needs the distributed runtime's store "
            "(init_distributed) — single-process jobs call "
            "ResizeController.request instead")
    store.set(f"{RESIZE_KV_PREFIX}/intent",
              json.dumps({"world_size": int(world_size),
                          "reason": reason, "ts": time.time()}))


def _host_tree(tree):
    """``tree`` with every tensor leaf on the host as numpy (a bf16
    tensor stays a CPU bf16 tensor), what a checkpoint's file holds."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for leaf in leaves:
        if torch.is_tensor(leaf):
            t = leaf.detach().cpu()
            out.append(t.clone() if t.dtype == torch.bfloat16
                       else t.numpy().copy())
        else:
            out.append(leaf)
    return tree_unflatten(treedef, out)


def _nbytes(tree) -> int:
    return int(sum(np.asarray(x).nbytes if not torch.is_tensor(x)
                   else x.numel() * x.element_size()
                   for x in tree_flatten(tree)[0]))


class ResizeController:
    """Trainer extension: resize a LIVE job at a step boundary;
    training continues in the same processes.

    1. **Intent** — ``request(world)``, an intent on the store
       (:func:`post_resize_intent`), or a fault plan.  Every tick of the
       shared ``check_interval`` cadence the intents seen are OR-agreed
       over the world (the largest wins), so every rank pauses at the
       same boundary.
    2. **Pause** — the windows in flight are drained.
    3. **State out** — this rank's checkpoint state on the host,
       stamped with the OLD topology.
    4. **Epoch** — ``membership.agree()`` over the old world (or a local
       counter), and old rank 0 posts the record that parked ranks wait
       on.
    5. **Re-form** — ``comm_factory(world)`` builds the new world over
       ranks ``[0, world)`` (``create_communicator(ranks=range(w))``)
       and ``optimizer_factory(new_comm)`` its optimizer; the new world
       and ``fence_targets`` are fenced to the epoch.  Every rank of
       the launch calls ``comm_factory`` for every resize, parked ones
       too, in the same order, and gets ``None`` outside the world:
       torch names such groups by a launch-wide count.
    6. **Re-lay** — the old members' rows cross the larger world's
       object group, are stacked and re-laid (only when the topology
       changed) and each new rank keeps its row; the parameters and the
       model state reach a joining rank by broadcast from rank 0.
    7. ``updater.rebind_world``, the state installed, the train state
       restored, and every extension with a ``rebind_world`` rebound.
       Training continues with the next ``update()``.

    A rank outside the new world is parked in :meth:`resize` until a
    record names it or the job ends (:meth:`finalize` on rank 0 posts
    the end).  Around the old world's end every extension's
    ``rebind_world(None)`` runs on every old rank, before the old
    world's groups are destroyed (an async checkpoint write is joined
    under the world that started it); then members get
    ``rebind_world(new_comm)``.

    ``on_resize(controller, new_comm, epoch)`` runs last.
    ``drain_engines`` and ``drain_timeout`` (a serving engine's epoch
    drain) are not ported: either raises.
    """

    trigger = (1, "iteration")
    # the last extension of its tick: log writers, checkpointers and
    # fault injectors run before the world changes, so a resize at
    # iteration N is a stop after N
    priority = 0

    def __init__(self, comm_factory, optimizer_factory, *,
                 membership: Optional[ElasticMembership] = None,
                 coord_comm=None, check_interval: int = 1,
                 drain_engines=(), drain_timeout: Optional[float] = None,
                 fence_targets=(), on_resize=None):
        for name, value in (("drain_engines", tuple(drain_engines)),
                            ("drain_timeout", drain_timeout)):
            if value not in ((), None):
                raise NotImplementedError(
                    f"ResizeController({name}=...) is not ported to "
                    "chainermn_tpu_torch yet: the serving engine is "
                    "ROADMAP Queue A item 12")
        self.comm_factory = comm_factory
        self.optimizer_factory = optimizer_factory
        self.membership = membership
        self.coord_comm = coord_comm
        self._check_interval = max(int(check_interval), 1)
        self.drain_engines = ()
        self.fence_targets = tuple(fence_targets)
        self.on_resize = on_resize
        self.epoch = 0              # local counter without a membership
        self._requested: Optional[int] = None
        self._calls = 0
        self._seq = 0               # the records of this job, in order
        self._store = None
        self.parked = False
        self.resizes: List[dict] = []
        self.drained: List[Any] = []

    # -- introspection --------------------------------------------------- #

    def status(self) -> dict:
        """The live-resize block of a status page: the epoch the job
        runs under, a pending intent, the resize history."""
        epoch = self.resizes[-1]["epoch"] if self.resizes \
            else self.epoch
        if self.membership is not None:
            epoch = max(epoch, self.membership.stored_epoch())
        return {
            "epoch": epoch,
            "requested_world": self._requested,
            "resizes": len(self.resizes),
            "last_resize": (dict(self.resizes[-1]) if self.resizes
                            else None),
            "draining_engines": len(self.drain_engines),
            "parked": self.parked,
        }

    # -- intent ---------------------------------------------------------- #

    def request(self, world_size: int) -> None:
        """Arm a resize to ``world_size``, acted on at the next step
        boundary of the shared cadence (only sets a flag: safe in a
        signal handler)."""
        if int(world_size) < 1:
            raise ValueError(f"world_size={world_size} must be >= 1")
        self._requested = int(world_size)

    @staticmethod
    def _kv(comm):
        """The world's store (read whatever the world's size: a world
        of one rank may be asked to grow)."""
        return getattr(comm, "store", None)

    def _kv_intent(self, comm) -> Optional[int]:
        kv = self._kv(comm)
        if kv is None:
            return None
        got = kv_get_json(kv, f"{RESIZE_KV_PREFIX}/intent")
        if not isinstance(got, dict) or not isinstance(
                got.get("world_size"), int):
            if got is not None:
                _LOG.warning("ignoring malformed resize intent %r", got)
            return None
        return int(got["world_size"])

    def _clear_kv_intent(self, comm) -> None:
        kv = self._kv(comm)
        if kv is not None:
            kv.delete_key(f"{RESIZE_KV_PREFIX}/intent")

    # -- the extension --------------------------------------------------- #

    def __call__(self, trainer) -> None:
        self._calls += 1
        # the shared cadence only: every rank makes the same enter/skip
        # decision for the agreement below
        if self._calls % self._check_interval:
            return
        comm = self.coord_comm or trainer.updater.comm
        mine = self._requested
        if mine is None:
            mine = self._kv_intent(comm)
        # size, not inter_size: a port process is one rank, and
        # inter_size counts nodes (1 for four ranks on one host)
        if int(comm.size) > 1:
            seen = [r for r in comm.allgather_obj(mine) if r is not None]
            agreed = max(seen) if seen else None
        else:
            agreed = mine
        if agreed is None:
            return
        self.resize(trainer, agreed)

    def finalize(self, trainer=None) -> None:
        """At the job's end, rank 0 of the world posts the end record, so
        parked ranks stop their trainers."""
        if trainer is None or self.parked:
            return
        comm = trainer.updater.comm
        store = self._kv(comm)
        if store is not None and int(comm.rank) == 0:
            store.set(f"{LIVE_KV_PREFIX}/{self._seq}",
                      json.dumps({"end": True}))

    # -- the resize ------------------------------------------------------ #

    def resize(self, trainer, world_size: int) -> None:
        """Perform the live resize NOW (normally reached through the
        agreed intent; every rank of the world calls it).  A rank the
        new world leaves out returns only when a later record names it
        again (with the state of the world it joins) or the job ends
        (its trainer stopped)."""
        import torch.distributed as dist

        from chainermn_tpu_torch.utils.metrics import get_registry
        from chainermn_tpu_torch.utils.telemetry import get_recorder

        from ._resume import updater_state

        upd = trainer.updater
        old = upd.comm
        it = int(upd.iteration)
        W1 = int(world_size)
        launch = dist.get_world_size() if dist.is_initialized() else 1
        if not 1 <= W1 <= launch:
            raise ValueError(
                f"world_size={W1}: a live resize re-forms a world over "
                f"the launch's ranks [0, {launch})")
        upd.check_world_change(W1)
        t0 = time.time()
        with get_recorder().span("elastic/live_resize", cat="elastic",
                                 step=it, world=W1):
            # 0. consume the intent FIRST, on every rank, before the
            #    resize's collectives: a fast rank must not re-read a
            #    still-posted intent at its next tick
            self._requested = None
            self._clear_kv_intent(self.coord_comm or old)
            # 1. drain: the old world's windows retire before its groups
            #    go
            upd.drain()
            # 2. state out, stamped with the OLD topology: exactly the
            #    checkpointer's save tree, on the host
            topo_old = topology_signature(
                old, params=upd.params, opt_state=upd.opt_state,
                sharding=upd.sharding)
            full = updater_state(upd, trainer)
            mine = {"opt_state": _host_tree(full["opt_state"])}
            if int(old.rank) == 0:
                mine.update(iteration=full["iteration"],
                            world_size=full["world_size"],
                            train_state=full["train_state"],
                            topology=topo_old)
            # 3. epoch: agreed by the old world over the store only
            if self.membership is not None:
                self.membership.comm = old
                epoch = self.membership.agree(world_size=W1).epoch
            else:
                self.epoch += 1
                epoch = self.epoch
            self._store = self._kv(old)
            record = {"epoch": epoch, "world_size": W1, "iteration": it,
                      "calls": self._calls,
                      "members": list(range(W1)), "end": False}
            if W1 < int(old.size) and self._store is None:
                raise RuntimeError(
                    "a live shrink parks ranks, which wait on the world's "
                    "store: start the world with init_distributed")
            if self._store is not None and int(old.rank) == 0:
                self._store.set(f"{LIVE_KV_PREFIX}/{self._seq}",
                                json.dumps(record))
            self._seq += 1
            new, moved = self._move(trainer, old, W1, epoch, mine)
        pause = time.time() - t0
        entry = {"iteration": it, "world": W1, "epoch": epoch,
                 "pause_s": pause, "bytes_moved": moved}
        self.resizes.append(entry)
        get_registry().inc("elastic/live_resizes")
        _LOG.info("live resize at iteration %d: world -> %d (epoch %d, "
                  "pause %.3fs)", it, W1, epoch, pause)
        if new is None:
            self._park(trainer)

    def _rebind_extensions(self, trainer, comm) -> None:
        for entry in getattr(trainer, "_extensions", []):
            hook = getattr(entry.ext, "rebind_world", None)
            if hook is not None and entry.ext is not self:
                hook(comm)

    def _move(self, trainer, old, W1: int, epoch: int, mine):
        """Steps 5-7 on a rank of the union of the two worlds (``old``
        ``None`` on a joining rank, ``mine`` its rows or ``None``).
        Returns ``(new_comm or None when parked, bytes received)``."""
        upd = trainer.updater
        grow = old is None or W1 > int(old.size)
        if not grow:
            # every rank of the launch builds the new world (None outside
            # it) while the old one still stands, then the rows cross
            # the old, the larger
            new = self.comm_factory(W1)
            rows = old.allgather_obj(mine)
            own = int(old.rank)
        if old is not None:
            # leave the old world: what runs on it ends under it, then
            # its groups go
            self._rebind_extensions(trainer, None)
            old.close()
        if grow:
            new = self.comm_factory(W1)
            rows = new.allgather_obj(mine)
            own = int(new.rank)
        # what crossed the wire to this rank: every row but its own
        moved = _nbytes([r for i, r in enumerate(rows) if i != own])
        if new is None:
            return None, moved
        new_opt = self.optimizer_factory(new)
        if self.membership is not None:
            targets = [t for t in (new, *self.fence_targets)
                       if hasattr(getattr(t, "_obj_channel", t),
                                  "set_generation")]
            if targets:
                self.membership.fence(*targets)
        head = rows[0]
        given = [r for r in rows if r is not None]
        topo_old = head["topology"]
        opt_rows = [r["opt_state"] for r in given]
        records = topo_old.get("opt_leaves")
        if records:
            opt = stack_rank_states(opt_rows, records)
        else:
            opt = opt_rows[0]
        state = {"iteration": head["iteration"],
                 "world_size": head["world_size"], "opt_state": opt,
                 "train_state": head["train_state"]}
        topo_new = topology_signature(new, sharding=upd.sharding)
        topo_new["opt_leaves"] = records
        if not same_topology(topo_old, topo_new):
            state = relayout_state(state, topo_old, topo_new)
        if records:
            state["opt_state"] = rank_state_row(state["opt_state"],
                                                records, int(new.rank))
        joined = old is None
        upd.rebind_world(new, new_opt)
        if grow:
            # the replicated parameters and model state from rank 0
            new.bcast_data(upd.params)
            if upd.state is not None:
                new.bcast_data(upd.state)
            if joined:
                moved += _nbytes(upd.params) + (
                    _nbytes(upd.state) if upd.state is not None else 0)
        from ._resume import restore_train_state
        from .optimizers import load_optimizer_state_tree

        load_optimizer_state_tree(upd.opt_state, state["opt_state"])
        upd.iteration = int(state["iteration"])
        restore_train_state(state.get("train_state"), upd, trainer)
        self._rebind_extensions(trainer, new)
        if self.coord_comm is not None:
            self.coord_comm = new
        if self.on_resize is not None:
            self.on_resize(self, new, epoch)
        return new, moved

    def _wait_record(self, key: str) -> dict:
        """The record under ``key``, waiting for it in bounded polls:
        the wait outlasts any store timeout, and a store that died
        raises from ``check``."""
        while True:
            got = kv_get_json(self._store, key)
            if got is not None:
                return got
            time.sleep(_PARK_POLL_S)

    def _park(self, trainer) -> None:
        """Wait, parked, for a record naming this rank (join the world
        it describes and return into the trainer) or the job's end
        (stop the trainer)."""
        import torch.distributed as dist

        from chainermn_tpu_torch.utils.metrics import get_registry
        from chainermn_tpu_torch.utils.telemetry import get_recorder

        me = dist.get_rank()
        self.parked = True
        while True:
            rec = self._wait_record(f"{LIVE_KV_PREFIX}/{self._seq}")
            self._seq += 1
            if rec.get("end"):
                trainer.stop("the live-resized job ended while this rank "
                             "was parked")
                return
            if me < int(rec["world_size"]):
                break
            # a world without this rank: the launch names its groups
            # together, so this rank counts them too
            self.comm_factory(int(rec["world_size"]))
        self.parked = False
        W1, epoch = int(rec["world_size"]), int(rec["epoch"])
        self._calls = int(rec["calls"])
        self.epoch = epoch
        if self.membership is not None:
            self.membership.record = MembershipRecord(
                epoch=epoch, world_size=W1, members=list(rec["members"]),
                created=time.time())
        t0 = time.time()
        with get_recorder().span("elastic/live_resize", cat="elastic",
                                 step=int(rec["iteration"]), world=W1,
                                 joined=True):
            _, moved = self._move(trainer, None, W1, epoch, None)
        self.resizes.append({"iteration": int(rec["iteration"]),
                             "world": W1, "epoch": epoch,
                             "pause_s": time.time() - t0,
                             "bytes_moved": moved, "joined": True})
        get_registry().inc("elastic/live_resizes")
