"""Multi-node checkpointer — ChainerMN's ``create_multi_node_checkpointer``
(the JAX package's ``extensions/checkpoint.py``) over per-rank tensors.

- Every rank writes its own file a trigger, named with the iteration
  and the rank (``snapshot_iter_{it}.{rank}``).  A port process is one
  rank, so the file's rank is ``comm.rank`` (the JAX package's
  ``inter_rank``, its process index), and under ZeRO-1/2 it holds that
  rank's rows of the optimizer state, where a JAX process file holds
  the whole world-stacked state.
- ``shard_only=True`` writes a scale-free covering set instead: rank
  ``r`` writes part ``snapshot_iter_{it}.s{r}of{W}`` with its rows of
  every ``shard`` leaf (:func:`~chainermn_tpu_torch.utils.
  serialization.build_shard_part`), and rank 0's part, the root, also
  holds the replicated entries once, so the set costs about one state
  whatever W.  A resume reads every part and assembles the
  world-stacked state (``assemble_shard_state``).  Full and shard-only
  sets share the directory and resume alike.
- Resume loads the **latest iteration for which every rank holds a file
  that passes its integrity check**: candidates are tried newest first,
  each rank tries the CRC-checked load of what it needs, and the
  verdicts ride an ``allgather_obj``.  A damaged own file (or owned
  part) is quarantined (renamed ``*.corrupt``, never deleted) and
  resume falls back to the newest set that loads clean everywhere; a
  partial shard-only set never looks complete.
- After a save, superseded sets are removed; ``history=N`` keeps the N
  newest sets every rank agrees are complete; a set still being written
  neither counts nor is removed until its writer is joined.
- Every file is stamped with its topology
  (:func:`~chainermn_tpu_torch.training.elastic.topology_signature`).
  At the same topology a resume takes the exact path (bitwise; this
  rank's own file, or its rows of an assembled set).  A different one is
  refused unless the checkpointer is built ``elastic=True``: then the
  inventory is every rank's files, the resume reads the rows of every
  old rank (their files, or the set's parts), stacks them, re-lays the
  stack on the host (:func:`~chainermn_tpu_torch.training.elastic.
  relayout_state`: the same bytes, the same result on every rank) and
  keeps this rank's row; the replicated entries come from this rank's
  old file, or the lowest rank's.  ``last_resume_mode`` says which path
  ran.

``async_write=True`` overlaps the file write with training.  The port's
parameters, BN statistics and momentum are mutated in place by the next
``update()``, so ``save`` first copies every tensor into one half of a
double buffer of host tensors (pinned when the tensor is on the card),
with ``non_blocking`` copies on the current stream, and synchronises an
event recorded after them before it returns.  The copies are ordered
before the next step's kernels by the stream anyway; the event is for
the host: the writer thread reads the buffer, and it makes no CUDA call
and no collective (the barrier and the GC stay on the main thread), so
the copy must be complete when the thread starts.  The wait costs the
copy's time on the main thread (measured in ``chip_smoke.py`` phase 9);
a copy on a side stream ordered by ``wait_stream`` would hide it, at the
price of a buffer the next step may not touch until an event says so.

``rebind_world(comm)`` follows a live resize: a write in flight is
joined and agreed under the OLD communicator, and later saves stamp and
write the new world's set (``rebind_world(None)``: the rank left its
world, parked, and runs no collective of it again).

Recordings, the JAX package's: the ``checkpoint/save_shard`` and
``checkpoint/resume`` spans, and the counters
``checkpoint/snapshots_written`` (after a write lands: at the async
path's join) and ``checkpoint/quarantined``.
"""

from __future__ import annotations

import logging
import os
import re
import sys
import threading
from typing import List, Optional, Set

import numpy as np
import torch

from chainermn_tpu_torch.training._resume import (
    restore_updater,
    updater_state,
)
from chainermn_tpu_torch.training.elastic import (
    _sharding_mode,
    rank_state_row,
    relayout_state,
    same_topology,
    stack_rank_states,
    topology_signature,
)
from chainermn_tpu_torch.utils.metrics import get_registry
from chainermn_tpu_torch.utils.serialization import (
    ShardSetError,
    SnapshotCorruptError,
    assemble_shard_state,
    build_shard_part,
    load_state_with_stamps,
    save_state,
    tree_flatten,
    tree_unflatten,
)
from chainermn_tpu_torch.utils.telemetry import get_recorder

_LOG = logging.getLogger(__name__)

__all__ = ["MultiNodeCheckpointer", "create_multi_node_checkpointer"]

# two file shapes share one namespace: a full per-rank file
# (``name_iter_7.0``) and a shard-only part (``name_iter_7.s3of8``, member
# 3 of a world-8 set); quarantined ``*.corrupt`` files match neither
_FILE_RE = re.compile(
    r"^(?P<name>.+)_iter_(?P<iter>\d+)\."
    r"(?:(?P<rank>\d+)|s(?P<member>\d+)of(?P<world>\d+))$")


def _snapshot_filename(name: str, iteration: int, rank: int) -> str:
    return f"{name}_iter_{iteration}.{rank}"


def _shard_filename(name: str, iteration: int, member: int,
                    world: int) -> str:
    return f"{name}_iter_{iteration}.s{member}of{world}"


def _replicas(leaf, world: int):
    """A ``stack`` leaf's ``world`` rows: the members hold the same
    value (a count, a learning rate), so this rank's repeats."""
    if torch.is_tensor(leaf):
        return leaf.detach().unsqueeze(0).expand(world, *leaf.shape)
    arr = np.asarray(leaf)
    return np.broadcast_to(arr, (world,) + arr.shape)


def _member_view(state: dict, topology: dict) -> dict:
    """``state`` with its optimizer leaves as member rows, what
    ``build_shard_part`` cuts from: each ``shard`` leaf this rank's one
    row ``(1, s)``, each ``stack`` leaf its world of replicas."""
    records = topology.get("opt_leaves")
    if not records:
        return state
    world = int(topology["world_size"])
    leaves, treedef = tree_flatten(state["opt_state"])
    rows = []
    for leaf, rec in zip(leaves, records):
        kind = rec.get("kind")
        rows.append(leaf[None] if kind == "shard"
                    else _replicas(leaf, world) if kind == "stack"
                    else leaf)
    return dict(state, opt_state=tree_unflatten(treedef, rows))


class MultiNodeCheckpointer:
    """Trainer extension: per-rank snapshots and latest-common-set
    resume.

    Use ``trainer.extend(checkpointer, trigger=(1000, 'iteration'))`` and
    call :meth:`maybe_load` before ``trainer.run()``.
    """

    # lowest priority: the checkpointer saves extension state (the
    # LogReport history), so it runs after the log writers of its tick
    priority = 30

    def __init__(self, comm, path: str, name: str = "snapshot",
                 async_write: bool = False, history: int = 1,
                 elastic: bool = False, shard_only: bool = False):
        self.comm = comm
        self.path = path
        self.name = name
        self.async_write = async_write
        # 1 keeps the latest set only; 2+ keeps an older complete set
        # for a fallback resume to land on
        self.history = max(int(history), 1)
        self.elastic = bool(elastic)
        self.shard_only = bool(shard_only)
        self.last_resume_mode = None     # "exact" | "relayout" | None
        self._saved_iterations: Set[int] = set()
        self._pending = None             # (thread, iteration, error box)
        # iterations the writer thread is still writing: out of the
        # inventory, and protected from GC, until the join agrees them
        self._streaming: Set[int] = set()
        # the async path's double buffer of host copies
        self._host_bufs = [None, None]
        self._host_idx = 0

    @property
    def _rank(self) -> int:
        return self.comm.rank

    # ------------------------------------------------------------------ #
    # inventory
    # ------------------------------------------------------------------ #

    def _scan(self) -> dict:
        """``{iteration: {"ranks": full-file ranks, "parts": {member:
        filename}, "world": a part set's world or None}}`` of the files
        on disk."""
        out: dict = {}
        if not os.path.isdir(self.path):
            return out
        for fn in os.listdir(self.path):
            m = _FILE_RE.match(fn)
            if not m or m.group("name") != self.name:
                continue
            rec = out.setdefault(int(m.group("iter")),
                                 {"ranks": set(), "parts": {},
                                  "world": None})
            if m.group("rank") is not None:
                rec["ranks"].add(int(m.group("rank")))
            else:
                rec["parts"][int(m.group("member"))] = fn
                rec["world"] = int(m.group("world"))
        return out

    @staticmethod
    def _parts_complete(rec: dict) -> bool:
        return (rec["world"] is not None
                and set(rec["parts"]) == set(range(rec["world"])))

    def _owned_members(self) -> List[int]:
        """The members whose parts this rank writes, quarantines and
        removes: its own."""
        return [self._rank]

    def _local_iterations(self, any_rank: bool = False) -> Set[int]:
        """Iterations this rank can resume from, less those still being
        written: its own full file (``any_rank``: any rank's, the
        elastic inventory), or a shard-only set with every part."""
        found = set()
        for it, rec in self._scan().items():
            if it in self._streaming:
                continue
            if self._rank in rec["ranks"] or (any_rank and rec["ranks"]) \
                    or self._parts_complete(rec):
                found.add(it)
        return found

    def _iteration_shards(self, it: int):
        """``(rank, path)`` of every full file of iteration ``it``, this
        rank's first, then ascending (parts excluded)."""
        if not os.path.isdir(self.path):
            return []
        rows = []
        for fn in os.listdir(self.path):
            m = _FILE_RE.match(fn)
            if (m and m.group("name") == self.name
                    and m.group("rank") is not None
                    and int(m.group("iter")) == it):
                rows.append((int(m.group("rank")),
                             os.path.join(self.path, fn)))
        rows.sort(key=lambda rp: (rp[0] != self._rank, rp[0]))
        return rows

    def _agreed_inventory(self):
        """``(common, streaming)``: the iterations every rank holds, and
        those any rank is still writing (one allgather)."""
        rows = self.comm.allgather_obj(
            (self._local_iterations(any_rank=self.elastic),
             set(self._streaming)))
        common = set.intersection(*(r[0] for r in rows))
        streaming = set().union(*(r[1] for r in rows))
        return sorted(common), streaming

    # ------------------------------------------------------------------ #
    # integrity: verification and quarantine
    # ------------------------------------------------------------------ #

    def _quarantine(self, path: str) -> str:
        """Rename a damaged file out of the inventory (``*.corrupt``,
        then ``*.corrupt1``, ...); GC never touches it."""
        q = path + ".corrupt"
        n = 0
        while os.path.exists(q):
            n += 1
            q = f"{path}.corrupt{n}"
        os.replace(path, q)
        get_registry().inc("checkpoint/quarantined")
        return q

    def _checked_file(self, path: str, owner: int):
        """``(tree, topology, shard_part)`` of one file through the
        CRC-checked read, or ``None``: a damaged file of this rank's is
        quarantined, a peer's is left to its owner, and a vanished one
        ("gone", not "damaged": a peer's GC on a shared disk) votes no
        untouched."""
        fn = os.path.basename(path)
        try:
            return load_state_with_stamps(path)
        except SnapshotCorruptError as e:
            if owner != self._rank:
                _LOG.warning("rank %d: %s (rank %d's) failed its integrity "
                             "check: %s", self._rank, fn, owner, e)
                return None
            try:
                where = os.path.basename(self._quarantine(path))
            except OSError as qe:
                # a failed rename must not leave the agreement protocol:
                # peers wait in the verdict allgather
                where = f"<quarantine failed: {qe}>"
            _LOG.warning(
                "rank %d: snapshot %s failed its integrity check and was "
                "quarantined as %s: %s", self._rank, fn, where, e)
        except FileNotFoundError:
            pass
        return None

    def _checked_local_load(self, it: int, cur_topo: dict):
        """``(state, topology, stacked)`` of iteration ``it``, or
        ``None``.  ``stacked``: the optimizer state is world-stacked
        (every rank's rows), else it is one rank's.  Each file is read
        at most once (the checked load is the verification).

        A shard-only set is assembled from all its parts.  Otherwise this
        rank's own file; with ``elastic`` the others' too, own first:
        one clean file covers a replicated optimizer; a ZeRO file holds
        its rank's rows, so at the same topology only this rank's own
        will do, and at another every old rank's file is read and their
        rows stacked."""
        rec = self._scan().get(it)
        if rec is not None and self._parts_complete(rec):
            return self._load_shard_set(it, rec)
        me = self._rank
        candidates = self._iteration_shards(it) if self.elastic else [
            (me, os.path.join(self.path,
                              _snapshot_filename(self.name, it, me)))]
        for rank, path in candidates:
            got = self._checked_file(path, rank)
            if got is None:
                continue
            state, topo, _ = got
            if not (topo or {}).get("opt_leaves") or not self.elastic:
                return state, topo, False
            if same_topology(topo, cur_topo):
                return (state, topo, False) if rank == me else None
            return self._stack_full_set(it, state, topo, rank)
        return None

    def _stack_full_set(self, it: int, state, topo, loaded: int):
        """The world-stacked state of a full set saved under ``topo``
        (``state`` is rank ``loaded``'s file, already read): every old
        rank's optimizer rows, stacked in rank order."""
        rows = []
        for k in range(int(topo["world_size"])):
            if k == loaded:
                rows.append(state["opt_state"])
                continue
            got = self._checked_file(os.path.join(
                self.path, _snapshot_filename(self.name, it, k)), k)
            if got is None:
                return None
            rows.append(got[0]["opt_state"])
        return (dict(state, opt_state=stack_rank_states(
            rows, topo["opt_leaves"])), topo, True)

    def _load_shard_set(self, it: int, rec: dict):
        """The checked load and assembly of a shard-only set: every part
        is needed, so a damaged one fails the set (this rank's own part
        is quarantined), and a set that does not tile votes no."""
        parts, topology = [], None
        for member in sorted(rec["parts"]):
            path = os.path.join(self.path, rec["parts"][member])
            got = self._checked_file(path, member)
            if got is None:
                return None
            tree, topo, sp = got
            if sp is None:
                _LOG.warning(
                    "rank %d: %s matches the shard-part name pattern but "
                    "carries no shard_part record: skipping the set",
                    self._rank, os.path.basename(path))
                return None
            if sp.get("root"):
                topology = topo
            parts.append((sp, tree))
        try:
            state = assemble_shard_state(parts)
        except ShardSetError as e:
            _LOG.warning("rank %d: the shard set of iteration %d does not "
                         "assemble (%s): falling back", self._rank, it, e)
            return None
        return state, topology, bool((topology or {}).get("opt_leaves"))

    # ------------------------------------------------------------------ #
    # save (the extension's call)
    # ------------------------------------------------------------------ #

    def __call__(self, trainer) -> None:
        self.save(trainer.updater, trainer)

    def _topology(self, updater) -> dict:
        """The signature a save is stamped with and a resume compares
        against: the world and the updater's sharding mode (ZeRO-1/2:
        each rank's file holds its own shard state)."""
        return topology_signature(
            self.comm, params=getattr(updater, "params", None),
            opt_state=getattr(updater, "opt_state", None),
            sharding=getattr(updater, "sharding", None))

    def save(self, updater, trainer=None) -> None:
        it = int(updater.iteration)
        with get_recorder().span("checkpoint/save_shard", cat="checkpoint",
                                 step=it, async_write=self.async_write):
            topology = self._topology(updater)
            # the signature rides __meta__, not the tree
            jobs = self._set_jobs(updater_state(updater, trainer), it,
                                  topology)
            if self.async_write:
                # counted at the join, where a failed write surfaces
                self._save_async(jobs, it, topology)
                return
            for path, tree, part in jobs:
                self._write_part(path, tree, topology, part)
            # counted once the write landed: a scraper diffs it against
            # the sets on disk
            get_registry().inc("checkpoint/snapshots_written")
            self._saved_iterations.add(it)
            # every rank's file of this iteration exists before older
            # sets go
            self.comm.barrier()
            self._cleanup(keep=it)

    def _set_jobs(self, state, it: int, topology) -> List[tuple]:
        """The files this rank owes for one save, as ``(path, tree,
        shard_part)``: its full file, or with ``shard_only`` its member's
        part (the root, rank 0's, with the replicated entries)."""
        if not self.shard_only:
            return [(os.path.join(self.path, _snapshot_filename(
                self.name, it, self._rank)), state, None)]
        world, r = int(topology["world_size"]), self._rank
        part, rec = build_shard_part(_member_view(state, topology),
                                     topology, r, r + 1, root=r == 0)
        return [(os.path.join(self.path, _shard_filename(
            self.name, it, r, world)), part, rec)]

    def _write_part(self, path: str, tree, topology, shard_part=None) -> None:
        """Write one file (``.tmp`` then rename, in ``save_state``): the
        one place the sync and the writer-thread paths write through,
        which the fault injector wraps to stall a write."""
        save_state(path, tree, topology=topology, shard_part=shard_part)

    # ------------------------------------------------------------------ #
    # the async path
    # ------------------------------------------------------------------ #

    def _host_snapshot(self, tree):
        """A copy of ``tree`` on the host, in the idle half of the
        double buffer (the writer of the previous save may still read
        the other half).  Tensors land in host tensors, pinned when they
        come from the card, by ``non_blocking`` copies on the current
        stream; the event recorded after the last copy is synchronised
        before this returns.  numpy leaves are copied; numbers are
        values already."""
        leaves, treedef = tree_flatten(tree)
        buf = self._host_bufs[self._host_idx]
        prev = buf[1] if buf is not None and buf[0] == treedef \
            else [None] * len(leaves)
        out, on_card = [], False
        for old, leaf in zip(prev, leaves):
            if torch.is_tensor(leaf):
                src = leaf.detach()
                if not (torch.is_tensor(old) and old.shape == src.shape
                        and old.dtype == src.dtype):
                    old = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=src.is_cuda)
                old.copy_(src, non_blocking=src.is_cuda)
                on_card |= src.is_cuda
                out.append(old)
            elif isinstance(leaf, np.ndarray):
                out.append(leaf.copy())
            else:
                out.append(leaf)
        if on_card:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self._host_bufs[self._host_idx] = (treedef, out)
        self._host_idx ^= 1
        return tree_unflatten(treedef, out)

    def _save_async(self, jobs, it: int, topology) -> None:
        """1. copy the jobs' trees to the host now, on the main thread,
        into the idle buffer (this overlaps the previous save's writer);
        2. join the previous write, then barrier and GC: every rank that
        reached this save has written the previous set;
        3. hand the host copies to a writer thread and return, marking
        the iteration as being written until the next join agrees it."""
        host = self._host_snapshot(tuple(tree for _, tree, _ in jobs))
        jobs = [(path, tree, part)
                for (path, _, part), tree in zip(jobs, host)]
        self._join_pending(barrier_and_gc=True)
        box = {}

        def write():
            try:
                for path, tree, part in jobs:
                    self._write_part(path, tree, topology, part)
            except BaseException as e:     # re-raised at the join
                box["error"] = e

        # not a daemon: an exception unwinding the interpreter still lets
        # the write finish, which save() already reported as taken
        th = threading.Thread(target=write, name=f"ckpt-write-{it}")
        self._streaming.add(it)
        th.start()
        self._pending = (th, it, box)

    def _join_pending(self, barrier_and_gc: bool) -> None:
        """Wait for the write in flight, if any, and re-raise its error.
        With ``barrier_and_gc`` the joined set is then agreed complete
        across ranks and older sets are removed."""
        if self._pending is None:
            return
        th, it, box = self._pending
        self._pending = None
        th.join()
        self._streaming.discard(it)
        if "error" in box:
            raise RuntimeError(
                f"async checkpoint write of iteration {it} failed"
            ) from box["error"]
        get_registry().inc("checkpoint/snapshots_written")
        self._saved_iterations.add(it)
        if barrier_and_gc:
            self.comm.barrier()
            self._cleanup(keep=it)

    # ------------------------------------------------------------------ #
    # GC
    # ------------------------------------------------------------------ #

    def _cleanup(self, keep: int) -> None:
        """Remove every superseded file of this rank, orphans of a dead
        run included.  With ``history > 1`` the protected iterations are
        agreed across ranks (after a quarantine the local inventories
        differ, and a per-rank choice would keep different sets on
        different ranks); iterations newer than ``keep`` are orphans and
        never protected; a set any rank is still writing is never
        counted and never removed; ``*.corrupt`` files never match."""
        scan = self._scan()
        inventory = set(scan) | self._saved_iterations
        if self.history > 1:
            common, streaming = self._agreed_inventory()
            candidates = [i for i in common
                          if i <= keep and i not in streaming]
        else:
            candidates = [keep]
            streaming = set(self._streaming)
        protected = set(sorted(candidates, reverse=True)[: self.history])
        protected.add(keep)
        protected |= streaming
        owned = set(self._owned_members())
        for it in inventory - protected:
            self._remove(_snapshot_filename(self.name, it, self._rank))
            for member, fn in scan.get(it, {"parts": {}})["parts"].items():
                if member in owned:
                    self._remove(fn)
            self._saved_iterations.discard(it)
        if self.elastic and self._rank == 0:
            # after a shrink the files of ranks (and the parts of
            # members) past the world are nobody's own: rank 0 removes
            # the superseded ones under the same protection
            for it, rec in scan.items():
                if it in protected:
                    continue
                for k in rec["ranks"]:
                    if k >= self.comm.size:
                        self._remove(_snapshot_filename(self.name, it, k))
                for member, fn in rec["parts"].items():
                    if member >= self.comm.size:
                        self._remove(fn)

    def _remove(self, fn: str) -> None:
        try:
            os.remove(os.path.join(self.path, fn))
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------------ #
    # resume
    # ------------------------------------------------------------------ #

    def maybe_load(self, updater, trainer=None) -> Optional[int]:
        """Restore the newest set every rank holds and loads clean into
        ``updater`` (and ``trainer``: the iterator, the extensions'
        state, the clock).  Each file is read at most once (the checked
        load is the verification); a damaged newest set falls back to
        the next, and what was skipped is logged.  Returns the resumed
        iteration, or ``None`` when there is nothing to resume."""
        with get_recorder().span("checkpoint/resume", cat="checkpoint"):
            return self._maybe_load(updater, trainer)

    def _maybe_load(self, updater, trainer) -> Optional[int]:
        self._join_pending(barrier_and_gc=True)
        cur_topo = self._topology(updater)
        skipped: List[int] = []
        rejected: Set[int] = set()
        while True:
            # each round gathers this rank's eligible set (its inventory
            # less what it voted down), so every rank walks the same
            # descending candidates even if a quarantine rename failed
            mine = self._local_iterations(any_rank=self.elastic) - rejected
            rows = self.comm.allgather_obj(mine)
            common = sorted(set.intersection(*rows))
            if not common:
                if skipped:
                    _LOG.warning(
                        "no snapshot set is loadable on every rank "
                        "(candidates %s all had a corrupt or vanished "
                        "file somewhere): starting fresh; quarantined "
                        "files kept as *.corrupt", skipped)
                return None
            it = common[-1]
            loaded = self._checked_local_load(it, cur_topo)
            if loaded is None:
                rejected.add(it)
            if all(self.comm.allgather_obj(loaded is not None)):
                state, saved_topo, stacked = loaded
                break
            skipped.append(it)
        if skipped:
            _LOG.warning(
                "fallback resume: snapshot iteration(s) %s had a corrupt "
                "file on at least one rank; restoring iteration %d "
                "instead (bad files quarantined as *.corrupt)",
                skipped, it)
        if saved_topo is not None and _sharding_mode(saved_topo) \
                != _sharding_mode(cur_topo):
            raise RuntimeError(
                f"snapshot at iteration {it} was saved with optimizer "
                f"sharding {_sharding_mode(saved_topo)!r}, but this job "
                f"runs {_sharding_mode(cur_topo)!r}: the saved state's "
                "layout does not fit the optimizer")
        if saved_topo is not None and not same_topology(saved_topo,
                                                        cur_topo):
            if not self.elastic:
                raise RuntimeError(
                    f"snapshot at iteration {it} was saved under another "
                    f"topology (world {saved_topo.get('world_size')} vs "
                    f"live {cur_topo['world_size']}): per-rank checkpoints "
                    "resume at the same world size unless the "
                    "checkpointer is built elastic=True")
            state = relayout_state(state, saved_topo, cur_topo)
            self.last_resume_mode = "relayout"
            _LOG.info("elastic resume: iteration %d re-laid from world %s "
                      "onto world %s", it, saved_topo.get("world_size"),
                      cur_topo["world_size"])
        else:
            saved_world = int(state.get("world_size", self.comm.size))
            if saved_world != self.comm.size:
                raise RuntimeError(
                    f"snapshot at iteration {it} was saved with world size "
                    f"{saved_world}, but this job has {self.comm.size} "
                    "ranks: per-rank checkpoints resume at the same world "
                    "size (multi_node_snapshot writes one resize-safe "
                    "file)")
            self.last_resume_mode = "exact"
        if stacked:
            state = dict(state, opt_state=rank_state_row(
                state["opt_state"], saved_topo["opt_leaves"], self._rank))
        restore_updater(state, updater, trainer)
        self._saved_iterations = self._local_iterations()
        return it

    def rebind_world(self, comm) -> None:
        """Follow a live resize (``ResizeController`` calls it on every
        extension that has it): a write in flight is joined and agreed
        complete under the OLD communicator first (its barrier belongs to
        the world that started it; every old rank reaches the resize's
        boundary), then later saves stamp the new world's topology and
        write its set.  ``comm=None``: this rank left its world (parked)
        and runs none of its collectives again.  Idempotent for the
        communicator already bound."""
        if comm is self.comm:
            return
        if self.comm is not None:
            self._join_pending(barrier_and_gc=True)
        self._host_bufs = [None, None]
        self.comm = comm

    def finalize(self, trainer=None) -> None:
        # while an exception unwinds (Trainer.run's finally) peers may be
        # dead: join the write for durability, but run no collective;
        # nor does a rank parked outside the world (comm None)
        crashing = sys.exc_info()[0] is not None or self.comm is None
        self._join_pending(barrier_and_gc=not crashing)
        if not crashing:
            self.comm.barrier()


def create_multi_node_checkpointer(
    comm, path: str, name: str = "snapshot",
    async_write: bool = False, history: int = 1,
    elastic: bool = False, shard_only: bool = False,
) -> MultiNodeCheckpointer:
    """ChainerMN's factory.  ``async_write=True`` copies the state to
    host buffers in ``save`` and writes the file on a thread, joined at
    the next save, resume or finalize; the file loads bitwise the same
    as a sync save.  ``history`` (default 1) is how many of the newest
    complete sets GC keeps; use 2 so a corrupted newest set has an older
    one to fall back to.  ``shard_only=True`` writes scale-free covering
    sets (a part a rank, the replicated entries once); ``elastic=True``
    resumes a set saved at another world size by re-laying it (see the
    module's docstring); either composes with the other and with
    ``async_write``."""
    return MultiNodeCheckpointer(comm, path, name,
                                 async_write=async_write, history=history,
                                 elastic=elastic, shard_only=shard_only)
