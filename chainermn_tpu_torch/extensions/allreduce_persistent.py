"""AllreducePersistentValues — ChainerMN's ``allreduce_persistent`` (the
JAX package's ``extensions/allreduce_persistent.py``): the mean over
ranks of persistent, non-gradient state such as BN running statistics,
so evaluation and snapshots see one consensus value.

With synchronised BN the statistics are equal on every rank already and
this is an identity; it matters for local BN or any other state that
drifts between ranks.  The mean is one tensor all-reduce a leaf through
the communicator (NCCL on the card); the JAX package averages host
copies over its object path.  Floating-point leaves are averaged;
integer leaves (BN's update count, equal on every rank) keep their
value and dtype, where the JAX package's object mean turns them into
floats.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

__all__ = ["AllreducePersistentValues"]


class AllreducePersistentValues:
    priority = 85  # above the evaluator (80): it must see the mean

    def __init__(self, comm, get_state=None, set_state=None):
        """``get_state(updater) -> tree`` and ``set_state(updater,
        tree)`` choose the values to average; the default is the
        updater's model state (``updater.state``, the BN statistics),
        and nothing when it has none."""
        self.comm = comm
        self._get = get_state or (lambda up: getattr(up, "state", None))
        self._set = set_state or self._default_set

    @staticmethod
    def _default_set(updater, value):
        updater.state = value

    def allreduce_persistent(self, updater) -> None:
        state = self._get(updater)
        if state is None:
            return
        if self.comm.size > 1:
            state = pytree.tree_map(
                lambda t: self.comm.allreduce(t, "mean")
                if torch.is_tensor(t) and t.is_floating_point() else t,
                state)
        self._set(updater, state)

    def __call__(self, trainer) -> None:
        self.allreduce_persistent(trainer.updater)
