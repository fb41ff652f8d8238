"""Fault injection for the training loop (the training part of the JAX
package's ``testing.py``): :class:`FaultPlan`, :class:`FaultInjector`
and :func:`corrupt_file`, with :func:`replicas_bitwise`, the check
that ranks holding one replica did not drift apart.  Every recovery
path the extensions promise (kill → resume, corrupted newest set →
fallback, SIGTERM → save and stop, a stalled rank → watchdog, NaN →
abort) is driven by a fault scripted by iteration number, not by
luck.

Not ported, each raising: the live resize (``resize_live_at_iteration``,
``FaultInjector(resize_controller=)``; ROADMAP Queue A item 11) and the
serving and fleet faults (``serve_*``, ``fleet_*``,
:meth:`FaultInjector.attach_engine`, :meth:`FaultInjector.attach_fleet`;
serving, item 12).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal as _signal
import sys
import time
from typing import Optional

import torch

from chainermn_tpu_torch.utils.serialization import tree_flatten

__all__ = ["FaultInjector", "FaultPlan", "corrupt_file", "replicas_bitwise"]


def replicas_bitwise(comm, tree) -> bool:
    """Whether every tensor of ``tree`` (of 4-byte elements) is the same
    bits on every member of ``comm``: the all-reduced max and min of its
    int32 view agree.  Collective over ``comm``."""
    import torch.utils._pytree as pytree

    same = True
    for t in pytree.tree_leaves(tree):
        bits = t.detach().contiguous().view(torch.int32)
        same &= bool(torch.equal(comm.allreduce(bits, "max"),
                                 comm.allreduce(bits, "min")))
    return same


def corrupt_file(path: str, n_bytes: int = 8, offset: Optional[int] = None,
                 seed: int = 0) -> list:
    """Flip ``n_bytes`` bytes of ``path`` in place, reproducibly: each
    chosen byte is XOR-ed with a non-zero mask from ``random.Random(seed)``
    (a zero mask would change nothing).  With ``offset=None`` the bytes
    land in the middle half of the file, inside an npz's leaf data.
    Returns the flipped offsets."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty: nothing to corrupt")
    rng = random.Random(seed)
    if offset is not None:
        positions = [min(offset + i, size - 1) for i in range(n_bytes)]
    else:
        lo, hi = size // 4, max(size // 4 + 1, 3 * size // 4)
        positions = sorted(rng.randrange(lo, hi) for _ in range(n_bytes))
    with open(path, "r+b") as f:
        for pos in positions:
            f.seek(pos)
            old = f.read(1)
            f.seek(pos)
            f.write(bytes([old[0] ^ rng.randrange(1, 256)]))
    return positions


_ELASTIC_FIELDS = ("resize_live_at_iteration",)
_SERVING_FIELDS = ("serve_delay_at_round", "serve_raise_at_round",
                   "serve_exhaust_pool_at_admit", "fleet_kill_at_step",
                   "fleet_slow_at_step", "fleet_flap_at_step")


@dataclasses.dataclass
class FaultPlan:
    """A fault script keyed by iteration number; plain scalars, so it
    travels to a child process as JSON (:meth:`to_json`).  Each fault
    fires at the step boundary after the named iteration:

    - ``kill_at_iteration``: ``SIGKILL`` self, the crash nothing
      flushes;
    - ``sigterm_at_iteration`` (``sigterm_rank``: one rank, else all):
      the preemption notice;
    - ``corrupt_at_iteration`` + ``corrupt_path``: flip
      ``corrupt_n_bytes`` bytes of that file;
    - ``delay_at_iteration`` + ``delay_rank`` + ``delay_seconds``: stall
      one rank past a watchdog's threshold;
    - ``nan_at_iteration``: poison the parameters with NaN, so the next
      loss is not finite;
    - ``save_stall_after_files`` + ``save_stall_seconds``: after the
      checkpointer's Nth file, every further file waits first, so a
      kill lands while a write is in flight;
    - ``resize_at_iteration`` + ``resize_to``: the shrink/grow drill:
      save through the injector's ``checkpointer`` (topology stamped),
      record that the relaunch runs at world ``resize_to`` and stop the
      trainer; the driver relaunches at that world and resumes through
      an ``elastic=True`` checkpointer.

    The live-resize, serving and fleet fields exist so a JAX-package
    plan reads here; setting one raises."""

    kill_at_iteration: Optional[int] = None
    sigterm_at_iteration: Optional[int] = None
    sigterm_rank: Optional[int] = None
    corrupt_at_iteration: Optional[int] = None
    corrupt_path: Optional[str] = None
    corrupt_n_bytes: int = 8
    delay_at_iteration: Optional[int] = None
    delay_rank: int = 0
    delay_seconds: float = 0.0
    nan_at_iteration: Optional[int] = None
    resize_at_iteration: Optional[int] = None
    resize_to: int = 0
    resize_live_at_iteration: Optional[int] = None
    resize_live_to: int = 0
    save_stall_after_files: Optional[int] = None
    save_stall_seconds: float = 0.0
    serve_delay_at_round: Optional[int] = None
    serve_delay_seconds: float = 0.0
    serve_raise_at_round: Optional[int] = None
    serve_exhaust_pool_at_admit: Optional[int] = None
    serve_exhaust_pool_rounds: int = 4
    fleet_kill_at_step: Optional[int] = None
    fleet_kill_replica: int = 0
    fleet_slow_at_step: Optional[int] = None
    fleet_slow_replica: int = 0
    fleet_slow_seconds: float = 0.0
    fleet_slow_steps: int = 1
    fleet_flap_at_step: Optional[int] = None
    fleet_flap_replica: int = 0
    fleet_flap_count: int = 2
    seed: int = 0

    def __post_init__(self):
        for f in _ELASTIC_FIELDS:
            if getattr(self, f) is not None:
                raise NotImplementedError(
                    f"FaultPlan.{f} is not ported to chainermn_tpu_torch "
                    "yet (the live resize, ROADMAP Queue A item 11)")
        for f in _SERVING_FIELDS:
            if getattr(self, f) is not None:
                raise NotImplementedError(
                    f"FaultPlan.{f} is not ported to chainermn_tpu_torch "
                    "yet (serving, ROADMAP Queue A item 12)")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "FaultPlan":
        return cls(**json.loads(payload))


class FaultInjector:
    """Trainer extension applying a :class:`FaultPlan`.

    Lowest priority: it runs last on its tick, after the log writers and
    the checkpointer, so a kill fires once everything the tick persists
    has at least started (an async write is then really in flight).
    """

    trigger = (1, "iteration")
    priority = 1

    def __init__(self, plan: FaultPlan, comm=None, checkpointer=None,
                 resize_controller=None):
        if resize_controller is not None:
            raise NotImplementedError(
                "FaultInjector(resize_controller=...) is not ported to "
                "chainermn_tpu_torch yet (the live resize, ROADMAP Queue "
                "A item 11)")
        self.plan = plan
        self.comm = comm
        self.checkpointer = checkpointer
        self.fired: list = []
        if checkpointer is not None \
                and plan.save_stall_after_files is not None:
            self._attach_save_stall(checkpointer)

    def _attach_save_stall(self, checkpointer) -> None:
        """Wrap the checkpointer's per-file write so every file after
        the plan's Nth sleeps first."""
        plan = self.plan
        real = checkpointer._write_part
        state = {"files": 0}

        def stalled(path, tree, topology, shard_part=None):
            if state["files"] >= plan.save_stall_after_files:
                self.fired.append(("save_stall", state["files"]))
                time.sleep(plan.save_stall_seconds)
            real(path, tree, topology, shard_part)
            state["files"] += 1

        checkpointer._write_part = stalled

    def _rank(self) -> int:
        return self.comm.rank if self.comm is not None else 0

    def __call__(self, trainer) -> None:
        plan = self.plan
        it = trainer.updater.iteration
        if plan.nan_at_iteration == it:
            leaves, _ = tree_flatten(trainer.updater.params)
            with torch.no_grad():
                for p in leaves:
                    p.fill_(float("nan"))
            self.fired.append(("nan", it))
        if (plan.delay_at_iteration == it
                and self._rank() == plan.delay_rank):
            self.fired.append(("delay", it))
            time.sleep(plan.delay_seconds)
        if plan.corrupt_at_iteration == it and plan.corrupt_path:
            corrupt_file(plan.corrupt_path, plan.corrupt_n_bytes,
                         seed=plan.seed)
            self.fired.append(("corrupt", it))
        if plan.resize_at_iteration == it:
            if self.checkpointer is None:
                raise RuntimeError(
                    "FaultPlan.resize_at_iteration needs "
                    "FaultInjector(checkpointer=...): the resize drill "
                    "saves a topology-stamped snapshot to resume from")
            self.checkpointer.save(trainer.updater, trainer)
            self.fired.append(("resize", it, plan.resize_to))
            trainer.stop(
                f"elastic resize drill: snapshot saved at iteration {it}; "
                f"relaunch at world={plan.resize_to}")
        if plan.sigterm_at_iteration == it and (
                plan.sigterm_rank is None
                or self._rank() == plan.sigterm_rank):
            self.fired.append(("sigterm", it))
            os.kill(os.getpid(), _signal.SIGTERM)
        if plan.kill_at_iteration == it:
            # flush so the phase's progress survives the kill
            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), _signal.SIGKILL)

    def attach_engine(self, engine):
        raise NotImplementedError(
            "FaultInjector.attach_engine is not ported to "
            "chainermn_tpu_torch yet (serving, ROADMAP Queue A item 12)")

    def attach_fleet(self, router):
        raise NotImplementedError(
            "FaultInjector.attach_fleet is not ported to "
            "chainermn_tpu_torch yet (serving, ROADMAP Queue A item 12)")
