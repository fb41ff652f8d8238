"""Interval triggers for the trainer loop (the JAX package's
``training/triggers.py``): extensions fire on ``(period, 'epoch' |
'iteration')``."""

from __future__ import annotations

__all__ = ["IntervalTrigger", "get_trigger"]


class IntervalTrigger:
    def __init__(self, period: float, unit: str):
        if unit not in ("epoch", "iteration"):
            raise ValueError(f"unit must be epoch|iteration, got {unit!r}")
        self.period = period
        self.unit = unit
        # the iteration unit fires when a multiple of the period is
        # crossed, as the epoch unit does
        self._seen_iteration = None
        self._seen_fire = False

    def initialize(self, trainer) -> None:
        """Seed the crossing state from the current iteration, so a
        resumed run does not fire at once."""
        if self._seen_iteration is None and self.unit == "iteration":
            self._seen_iteration = trainer.updater.iteration

    def __call__(self, trainer) -> bool:
        if self.unit == "iteration":
            it = trainer.updater.iteration
            if it == self._seen_iteration:
                return self._seen_fire
            prev = self._seen_iteration or 0
            self._seen_iteration = it
            self._seen_fire = it > 0 and \
                int(it / self.period) > int(prev / self.period)
            return self._seen_fire
        prev = trainer.updater.previous_epoch_detail
        cur = trainer.updater.epoch_detail
        return int(cur / self.period) > int(prev / self.period)

    def __repr__(self):  # pragma: no cover
        return f"IntervalTrigger({self.period}, {self.unit!r})"


def get_trigger(trigger):
    if trigger is None:
        return lambda trainer: False
    if callable(trigger):
        return trigger
    period, unit = trigger
    return IntervalTrigger(period, unit)
