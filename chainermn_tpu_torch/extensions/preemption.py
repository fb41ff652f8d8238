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

Not ported: ``membership=`` (elastic relaunch, ROADMAP Queue A item 9).
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
    """

    trigger = (1, "iteration")
    # last on its tick: a periodic save on the same iteration runs after
    # the log writers, and so does this one
    priority = 20

    def __init__(self, checkpointer, comm=None,
                 signals: Sequence[int] = (signal.SIGTERM,),
                 check_interval: int = 1, membership=None):
        if membership is not None:
            raise NotImplementedError(
                "PreemptionCheckpointer(membership=...) is not ported to "
                "chainermn_tpu_torch yet (elastic training, ROADMAP Queue "
                "A item 9)")
        self.checkpointer = checkpointer
        self.comm = comm
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
        raise NotImplementedError(
            "PreemptionCheckpointer.rebind_world is not ported to "
            "chainermn_tpu_torch yet (elastic training, ROADMAP Queue A "
            "item 9)")

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
        trainer.stop(f"preemption signal received; checkpoint saved at "
                     f"iteration {it}")

    def finalize(self, trainer=None):
        self._uninstall()
