"""Fail fast on a non-finite training loss (Chainer's
``FailOnNonNumber``; the JAX package's
``extensions/fail_on_non_number.py``): a NaN or Inf loss on any rank
raises at once instead of training garbage.  With
:func:`add_global_except_hook` the raise ends the whole job.

It runs as an ``observe`` hook, so every iteration is checked whatever
the trigger; reading the loss is one scalar the log reads anyway.
"""

from __future__ import annotations

import math

__all__ = ["FailOnNonNumber"]


class FailOnNonNumber:
    """Raise ``RuntimeError`` when a watched observation is not finite.

    Args:
      keys: the observations to watch (default ``main/loss``).
    """

    priority = 400  # before the log writers: fail the iteration that broke

    def __init__(self, keys=("main/loss",)):
        self.keys = tuple(keys)

    def observe(self, trainer):
        for key in self.keys:
            val = trainer.observation.get(key)
            if val is None:
                continue
            val = float(val)
            if not math.isfinite(val):
                raise RuntimeError(
                    f"non-finite {key} ({val}) at iteration "
                    f"{trainer.updater.iteration}: stopping before the "
                    "divergence trains further")

    def __call__(self, trainer):  # the trigger path: the same check
        self.observe(trainer)
