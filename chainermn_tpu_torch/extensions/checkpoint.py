"""Multi-node checkpointer — ChainerMN's ``create_multi_node_checkpointer``
(the JAX package's ``extensions/checkpoint.py``) over per-rank tensors.

- Every rank writes its own file a trigger, named with the iteration
  and the rank (``snapshot_iter_{it}.{rank}``).  A port process is one
  rank, so the file's rank is ``comm.rank`` (the JAX package's
  ``inter_rank``, its process index).
- Resume loads the **latest iteration for which every rank holds a file
  that passes its integrity check**: candidates are tried newest first,
  each rank tries the CRC-checked load of its own file, and the verdicts
  ride an ``allgather_obj``.  A file whose CRCs fail is quarantined
  (renamed ``*.corrupt``, never deleted) and resume falls back to the
  newest set that loads clean everywhere.
- After a save, superseded sets are removed; ``history=N`` keeps the N
  newest sets every rank agrees are complete.
- The world size must match at restart.

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

Not ported, each raising: ``shard_only=True``, ``elastic=True`` and
``rebind_world`` (elastic training, ROADMAP Queue A item 11).  Not
ported, and absent: the metrics counters and telemetry spans (item 10).
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
    same_topology,
    topology_signature,
)
from chainermn_tpu_torch.utils.serialization import (
    SnapshotCorruptError,
    load_state_with_topology,
    save_state,
    tree_flatten,
    tree_unflatten,
)

_LOG = logging.getLogger(__name__)

__all__ = ["MultiNodeCheckpointer", "create_multi_node_checkpointer"]

# a full per-rank file (``name_iter_7.0``); quarantined ``*.corrupt``
# files and the JAX package's shard-only parts (``.s3of8``) do not match
_FILE_RE = re.compile(r"^(?P<name>.+)_iter_(?P<iter>\d+)\.(?P<rank>\d+)$")


def _not_ported(what):
    return NotImplementedError(
        f"MultiNodeCheckpointer {what} is not ported to chainermn_tpu_torch "
        "yet (elastic training, ROADMAP Queue A item 11)")


def _snapshot_filename(name: str, iteration: int, rank: int) -> str:
    return f"{name}_iter_{iteration}.{rank}"


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
        if shard_only:
            raise _not_ported("shard_only=True (scale-free covering sets)")
        if elastic:
            raise _not_ported("elastic=True (resume across a resize)")
        self.comm = comm
        self.path = path
        self.name = name
        self.async_write = async_write
        # 1 keeps the latest set only; 2+ keeps an older complete set
        # for a fallback resume to land on
        self.history = max(int(history), 1)
        self.last_resume_mode = None     # "exact" | None
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
        """``{iteration: set of ranks}`` of the files on disk."""
        out: dict = {}
        if not os.path.isdir(self.path):
            return out
        for fn in os.listdir(self.path):
            m = _FILE_RE.match(fn)
            if m and m.group("name") == self.name:
                out.setdefault(int(m.group("iter")), set()).add(
                    int(m.group("rank")))
        return out

    def _local_iterations(self) -> Set[int]:
        """Iterations this rank holds a file of, less those still being
        written."""
        return {it for it, ranks in self._scan().items()
                if it not in self._streaming and self._rank in ranks}

    def _agreed_inventory(self):
        """``(common, streaming)``: the iterations every rank holds, and
        those any rank is still writing (one allgather)."""
        rows = self.comm.allgather_obj(
            (self._local_iterations(), set(self._streaming)))
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
        return q

    def _checked_local_load(self, it: int):
        """``(state, topology)`` of iteration ``it`` through the
        CRC-checked read, or ``None``: a damaged own file is quarantined
        and votes no; a vanished one ("gone", not "damaged": a peer's
        GC on a shared disk) votes no untouched."""
        fn = _snapshot_filename(self.name, it, self._rank)
        path = os.path.join(self.path, fn)
        try:
            return load_state_with_topology(path)
        except SnapshotCorruptError as e:
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
        topology = self._topology(updater)
        # the signature rides __meta__, not the tree
        state = updater_state(updater, trainer)
        path = os.path.join(self.path,
                            _snapshot_filename(self.name, it, self._rank))
        if self.async_write:
            self._save_async(state, it, path, topology)
            return
        self._write_part(path, state, topology)
        self._saved_iterations.add(it)
        # every rank's file of this iteration exists before older sets
        # go
        self.comm.barrier()
        self._cleanup(keep=it)

    def _write_part(self, path: str, tree, topology) -> None:
        """Write one file (``.tmp`` then rename, in ``save_state``): the
        one place the sync and the writer-thread paths write through,
        which the fault injector wraps to stall a write."""
        save_state(path, tree, topology=topology)

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

    def _save_async(self, state, it: int, path: str, topology) -> None:
        """1. copy the state to the host now, on the main thread, into
        the idle buffer (this overlaps the previous save's writer);
        2. join the previous write, then barrier and GC: every rank that
        reached this save has written the previous set;
        3. hand the host copy to a writer thread and return, marking the
        iteration as being written until the next join agrees it."""
        host = self._host_snapshot(state)
        self._join_pending(barrier_and_gc=True)
        box = {}

        def write():
            try:
                self._write_part(path, host, topology)
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
        inventory = set(self._scan()) | self._saved_iterations
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
        for it in inventory - protected:
            self._remove(_snapshot_filename(self.name, it, self._rank))
            self._saved_iterations.discard(it)

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
        self._join_pending(barrier_and_gc=True)
        skipped: List[int] = []
        rejected: Set[int] = set()
        while True:
            # each round gathers this rank's eligible set (its inventory
            # less what it voted down), so every rank walks the same
            # descending candidates even if a quarantine rename failed
            mine = self._local_iterations() - rejected
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
            loaded = self._checked_local_load(it)
            if loaded is None:
                rejected.add(it)
            if all(self.comm.allgather_obj(loaded is not None)):
                state, saved_topo = loaded
                break
            skipped.append(it)
        if skipped:
            _LOG.warning(
                "fallback resume: snapshot iteration(s) %s had a corrupt "
                "file on at least one rank; restoring iteration %d "
                "instead (bad files quarantined as *.corrupt)",
                skipped, it)
        cur_topo = self._topology(updater)
        if saved_topo is not None and _sharding_mode(saved_topo) \
                != _sharding_mode(cur_topo):
            raise RuntimeError(
                f"snapshot at iteration {it} was saved with optimizer "
                f"sharding {_sharding_mode(saved_topo)!r}, but this job "
                f"runs {_sharding_mode(cur_topo)!r}: the saved state's "
                "layout does not fit the optimizer")
        if saved_topo is not None and not same_topology(saved_topo,
                                                        cur_topo):
            raise RuntimeError(
                f"snapshot at iteration {it} was saved under another "
                f"topology (world {saved_topo.get('world_size')} vs live "
                f"{cur_topo['world_size']}): per-rank checkpoints resume "
                "at the same world size")
        saved_world = int(state.get("world_size", self.comm.size))
        if saved_world != self.comm.size:
            raise RuntimeError(
                f"snapshot at iteration {it} was saved with world size "
                f"{saved_world}, but this job has {self.comm.size} ranks: "
                "per-rank checkpoints resume at the same world size "
                "(multi_node_snapshot writes one resize-safe file)")
        self.last_resume_mode = "exact"
        restore_updater(state, updater, trainer)
        self._saved_iterations = self._local_iterations()
        return it

    def rebind_world(self, comm) -> None:
        """Not ported: follow a live resize onto a new communicator."""
        raise _not_ported("rebind_world")

    def finalize(self, trainer=None) -> None:
        # while an exception unwinds (Trainer.run's finally) peers may be
        # dead: join the write for durability, but run no collective
        crashing = sys.exc_info()[0] is not None
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
    one to fall back to.  ``elastic=True`` and ``shard_only=True``
    raise (ROADMAP Queue A item 11)."""
    return MultiNodeCheckpointer(comm, path, name,
                                 async_write=async_write, history=history,
                                 elastic=elastic, shard_only=shard_only)
