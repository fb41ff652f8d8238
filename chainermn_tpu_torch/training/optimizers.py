"""optax's ``adamw`` and ``sgd`` over ``torch.optim``.

The JAX package's ``make_train_step(..., optimizer)`` takes an optax
``GradientTransformation`` (``bench_transformer.py`` passes
``optax.adamw(3e-4)``, its tests ``optax.sgd``).  The port's
:func:`~chainermn_tpu_torch.models.make_train_step` takes one of these:
``init(params)`` returns the optimizer state, a ``torch.optim``
optimizer over the leaves of ``params``, and ``update(grads, opt_state,
params)`` applies one step to ``params`` in place.  Each is configured
to optax's defaults and update rule:

- ``adamw``: ``p ← p − lr·(m̂/(√v̂ + eps) + weight_decay·p)`` with bias
  correction, which ``torch.optim.AdamW``'s decoupled decay computes
  too.  optax's ``weight_decay`` defaults to 1e-4, torch's to 1e-2; the
  port takes optax's.  optax decays every leaf (norm scales and the
  embedding included), and so does the port.
- ``sgd``: ``p ← p − lr·g``.
"""

from __future__ import annotations

import torch

__all__ = ["adamw", "sgd"]


def tree_leaves(tree: dict) -> list:
    """Every tensor of a nested dict, depth first in insertion order."""
    return [x for v in tree.values()
            for x in (tree_leaves(v) if isinstance(v, dict) else [v])]


class _TorchOptimizer:
    """An optax-style ``init``/``update`` pair over one ``torch.optim``
    optimizer class and its arguments."""

    def __init__(self, cls, **kwargs):
        self._cls, self._kwargs = cls, kwargs

    def init(self, params) -> torch.optim.Optimizer:
        return self._cls(tree_leaves(params), **self._kwargs)

    def update(self, grads, opt_state: torch.optim.Optimizer, params):
        leaves = tree_leaves(params)
        held = [p for group in opt_state.param_groups
                for p in group["params"]]
        if len(held) != len(leaves) or any(
                a is not b for a, b in zip(held, leaves)):
            raise ValueError(
                "opt_state was made by init() for other parameter tensors; "
                "the port updates params in place, so pass the same ones")
        for p, g in zip(leaves, tree_leaves(grads)):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4, *,
          mu_dtype=None) -> _TorchOptimizer:
    """``optax.adamw`` with optax's defaults.  ``mu_dtype`` (a
    lower-precision first moment) is not ported yet and raises."""
    if mu_dtype is not None:
        raise NotImplementedError(
            "adamw(mu_dtype=...) is not ported to chainermn_tpu_torch yet; "
            "the first moment stays in the parameters' dtype (fp32)")
    return _TorchOptimizer(torch.optim.AdamW, lr=learning_rate,
                           betas=(b1, b2), eps=eps,
                           weight_decay=weight_decay)


def sgd(learning_rate: float) -> _TorchOptimizer:
    """``optax.sgd`` without momentum."""
    return _TorchOptimizer(torch.optim.SGD, lr=learning_rate)
