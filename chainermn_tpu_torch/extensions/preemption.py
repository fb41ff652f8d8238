"""Save and stop on a preemption notice (the JAX package's
``extensions/preemption.py``).

A spot or preemptible machine gets ``SIGTERM`` some seconds before it is
taken.  A job that checkpoints on the notice loses no work, where
ChainerMN's lost everything since its last periodic snapshot.

- The signal handler, installed on the main thread, only sets a flag;
  the work happens at the next step boundary, where the state is
  consistent.
- The decision is collective: often one rank gets the signal, so the
  flag is OR-ed over the ranks (``allgather_obj``) before anyone acts,
  and every rank saves the same iteration.
- Then the trainer stops cleanly (``trainer.stop()``): ``finalize``
  joins an async write and restores the previous handlers.
- With ``membership=`` (an
  :class:`~chainermn_tpu_torch.training.elastic.ElasticMembership`) the
  stop is recorded after the save (``note_stop``), so the relaunch, at
  whatever world size it gets, agrees a new epoch before it touches the
  snapshots.
- ``rebind_world(comm)`` follows a live resize: the flag's OR and the
  wrapped checkpointer's saves run on the new world.
"""

from __future__ import annotations

import signal
import threading
from typing import Sequence

__all__ = ["PreemptionCheckpointer"]


class PreemptionCheckpointer:
    """Trainer extension: checkpoint and stop when a preemption signal
    reaches any rank.

    Args:
      checkpointer: a ``MultiNodeCheckpointer``; its ``save`` is used,
        so a restart's ``maybe_load`` resumes from it like any set.
      comm: the communicator for the flag's OR; ``None`` or one rank
        skips the collective.
      signals: the signals to trap (default ``SIGTERM``).  The previous
        handlers are chained, and restored at ``finalize``.
      check_interval: look at the flag every N iterations (every rank
        on the same calls).
      membership: an ``ElasticMembership`` whose ``note_stop`` records
        the stop after the collective save.
    """

    trigger = (1, "iteration")
    # last on its tick: a periodic save on the same iteration runs after
    # the log writers, and so does this one
    priority = 20

    def __init__(self, checkpointer, comm=None,
                 signals: Sequence[int] = (signal.SIGTERM,),
                 check_interval: int = 1, membership=None):
        self.checkpointer = checkpointer
        self.comm = comm
        self.membership = membership
        # a flag OR'd over a communicator follows the world; one checked
        # locally (comm None) stays local
        self._follows_world = comm is not None
        self.signaled = False
        self._signals = tuple(signals)
        self._prev_handlers = {}
        self._check_interval = max(int(check_interval), 1)
        self._calls = 0
        self._installed = False

    # -- signal plumbing ------------------------------------------------
    def _handler(self, signum, frame):
        self.signaled = True
        prev = self._prev_handlers.get(signum)
        if callable(prev) and prev not in (
                signal.SIG_IGN, signal.SIG_DFL, self._handler):
            prev(signum, frame)

    def _install(self):
        if self._installed:
            return
        for s in self._signals:
            self._prev_handlers[s] = signal.signal(s, self._handler)
        self._installed = True

    def _uninstall(self):
        # handlers belong to the main thread; a handler that was not set
        # from Python (None) goes back to the default
        if not self._installed \
                or threading.current_thread() is not threading.main_thread():
            return
        for s, prev in self._prev_handlers.items():
            signal.signal(s, signal.SIG_DFL if prev is None else prev)
        self._prev_handlers.clear()
        self._installed = False

    # -- the trainer's extension protocol -------------------------------
    def initialize(self, trainer):
        self._install()

    def rebind_world(self, comm) -> None:
        """Follow a live resize (``ResizeController`` calls it): the
        flag's OR and the wrapped checkpointer's saves run on the new
        world's communicator (``None``: this rank is parked)."""
        if self._follows_world:
            self.comm = comm
        self.checkpointer.rebind_world(comm)

    def _global_flag(self) -> bool:
        if self.comm is None or self.comm.size <= 1:
            return self.signaled
        return any(self.comm.allgather_obj(bool(self.signaled)))

    def __call__(self, trainer):
        self._calls += 1
        # every rank makes the same enter/skip decision here, so the
        # allgather below pairs calls of the same iteration
        if self._calls % self._check_interval:
            return
        if not self._global_flag():
            return
        it = trainer.updater.iteration
        self.checkpointer.save(trainer.updater, trainer)
        if self.membership is not None:
            # the durable record of this stop makes the relaunch's
            # agree() bump the epoch past this incarnation
            self.membership.note_stop(reason="preemption", iteration=it)
        trainer.stop(f"preemption signal received; checkpoint saved at "
                     f"iteration {it}")

    def finalize(self, trainer=None):
        self._uninstall()
