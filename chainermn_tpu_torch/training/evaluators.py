"""Multi-node evaluation (the JAX package's ``training/evaluators.py``;
ChainerMN's ``create_multi_node_evaluator`` and
``GenericMultiNodeEvaluator``).

Each rank evaluates every row of its own validation shard; the
multi-node wrapper then averages the metric dicts over the ranks with
``allreduce_obj``.  The JAX package splits each batch over its devices
and evaluates the rows that do not divide the world size in a padded
remainder step; a port rank splits nothing, so that step has no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from chainermn_tpu_torch.iterators import default_converter

__all__ = ["Evaluator", "GenericMultiNodeEvaluator",
           "create_multi_node_evaluator"]


class Evaluator:
    """Runs ``metrics_fn(params, *batch) -> dict`` over a non-repeating
    iterator, without gradients, and averages the per-batch dicts
    weighted by batch size.  Each metric must be the mean over the
    batch's rows."""

    trigger = (1, "epoch")
    priority = 80
    name = "validation"

    def __init__(self, iterator, metrics_fn: Callable, comm,
                 converter: Callable = default_converter,
                 get_params: Optional[Callable] = None):
        self.iterator = iterator
        self.comm = comm
        self.converter = converter
        self._get_params = get_params
        self._metrics_fn = metrics_fn

    def evaluate(self, params) -> Dict[str, float]:
        if getattr(self.iterator, "repeat", False):
            raise ValueError(
                "evaluation iterator must not repeat (pass repeat=False) — "
                "a repeating iterator never exhausts and would hang the "
                "epoch trigger")
        self.iterator.reset()
        totals, weight = {}, 0
        with torch.no_grad():
            for batch in self.iterator:
                arrays = tuple(torch.as_tensor(a).to(self.comm.device)
                               for a in self.converter(batch))
                b = arrays[0].shape[0]
                for k, v in self._metrics_fn(params, *arrays).items():
                    totals[k] = totals.get(k, 0.0) + float(v) * b
                weight += b
        return {k: v / max(weight, 1) for k, v in totals.items()}

    def _resolve_params(self, trainer):
        return (self._get_params(trainer) if self._get_params
                else trainer.updater.params)

    def __call__(self, trainer):
        obs = self.evaluate(self._resolve_params(trainer))
        trainer.observation.update(
            {f"{self.name}/{k}": v for k, v in obs.items()})
        return obs


class _MultiNodeEvaluator:
    """Wraps an evaluator: local evaluate, then the mean of the metric
    dict over the ranks."""

    def __init__(self, evaluator, comm):
        self._evaluator = evaluator
        self._comm = comm
        for attr in ("trigger", "priority", "name", "iterator"):
            if hasattr(evaluator, attr):
                setattr(self, attr, getattr(evaluator, attr))

    def evaluate(self, params):
        return self._comm.allreduce_obj(self._evaluator.evaluate(params),
                                        op="mean")

    def __call__(self, trainer):
        resolve = getattr(self._evaluator, "_resolve_params", None)
        params = (resolve(trainer) if resolve
                  else getattr(trainer.updater, "params", None))
        obs = self.evaluate(params)
        name = getattr(self, "name", "validation")
        trainer.observation.update({f"{name}/{k}": v for k, v in obs.items()})
        return obs

    def __getattr__(self, item):
        return getattr(self._evaluator, item)


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Wrap ``actual_evaluator`` so its results are averaged over every
    rank."""
    return _MultiNodeEvaluator(actual_evaluator, communicator)


class GenericMultiNodeEvaluator(Evaluator):
    """Custom aggregation: subclasses override ``aggregate`` to combine
    the per-rank result dicts."""

    def __init__(self, comm, iterator, metrics_fn,
                 converter=default_converter, get_params=None):
        super().__init__(iterator, metrics_fn, comm, converter, get_params)

    def aggregate(self, results):
        out = {}
        for r in results:
            for k, v in r.items():
                out.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in out.items()}

    def evaluate(self, params):
        return self.aggregate(self.comm.allgather_obj(
            super().evaluate(params)))
