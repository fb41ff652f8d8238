"""ObservationAggregator — ChainerMN's ``observation_aggregator`` (the
JAX package's ``extensions/observation_aggregator.py``): the mean over
ranks of the logged scalars each iteration, so a rank-0 log shows
global means, not rank 0's own view.

The port's updater already logs the global mean of the loss; this is
for host-side values a rank observes alone (step timings, counters).
With one rank it passes everything through.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ObservationAggregator"]


class ObservationAggregator:
    priority = 90  # before LogReport's observe reads the dict

    def __init__(self, comm, keys: Optional[list] = None):
        """Average ``keys`` (every scalar observation when ``None``)
        over the ranks, every iteration."""
        self.comm = comm
        self.keys = keys

    def observe(self, trainer) -> None:
        if self.comm.size == 1:
            return
        obs = trainer.observation
        keys = self.keys or [
            k for k, v in obs.items()
            if isinstance(v, (int, float)) or getattr(v, "ndim", None) == 0
        ]
        local = {k: float(obs[k]) for k in keys if k in obs}
        # ranks may report different keys (rank-0-only extensions): each
        # key is averaged over the ranks that reported it
        gathered = self.comm.allgather_obj(local)
        union = set().union(*(d.keys() for d in gathered))
        for k in union:
            vals = [d[k] for d in gathered if k in d]
            trainer.observation[k] = sum(vals) / len(vals)

    def __call__(self, trainer) -> None:
        # the work is done in observe(); the triggered call does nothing
        pass
