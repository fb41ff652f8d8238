"""optax's ``adamw`` and ``sgd`` over ``torch.optim``, and ChainerMN's
multi-node optimizer over a communicator.

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
- ``sgd``: ``p ← p − lr·g``; with ``momentum`` optax's ``trace``,
  ``v ← g + μ·v``, ``p ← p − lr·v`` (``torch.optim.SGD`` with
  ``dampening=0``).

:func:`create_multi_node_optimizer` wraps one of these with the mean of
the gradients over a communicator (the JAX package's
``training/optimizers.py:640``): its ``update`` exchanges the gradient
tree through ``comm.multi_node_mean_grad`` (fused bf16 buckets) and then
steps the inner optimizer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["adamw", "create_multi_node_optimizer", "cross_replica_mean",
           "load_optimizer_state_tree", "optimizer_state_tree", "sgd"]


def tree_leaves(tree) -> list:
    """Every tensor of a nested dict/list/tuple tree, depth first in
    insertion order."""
    return pytree.tree_leaves(tree)


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


def _numeric(v) -> bool:
    """A number, or a tuple of numbers (Adam's ``betas``): what a
    ``param_groups`` entry may put in the snapshot's leaves."""
    if isinstance(v, tuple):
        return bool(v) and all(_numeric(x) for x in v)
    return (isinstance(v, (int, float)) and not isinstance(v, bool)) \
        or torch.is_tensor(v)


def optimizer_state_tree(opt_state: torch.optim.Optimizer) -> dict:
    """The optimizer's state as a tree of tensors and numbers:
    ``{"state": [one dict a parameter, in the order of init's leaves:
    SGD's ``momentum_buffer``, Adam's ``exp_avg``, ``exp_avg_sq`` and
    ``step``], "param_groups": [the numeric entries of each group]}``.
    The non-numeric entries (``params``, the flags, ``foreach``) stay
    out of the leaves, as the JAX container keeps strings out; the
    optimizer built over the same parameters already holds them.  The
    tensors are the optimizer's own, not copies."""
    sd = opt_state.state_dict()
    n = sum(len(g["params"]) for g in sd["param_groups"])
    return {
        "state": [dict(sd["state"].get(i, {})) for i in range(n)],
        "param_groups": [{k: v for k, v in g.items() if _numeric(v)}
                         for g in sd["param_groups"]],
    }


def _plain(v):
    """A loaded number (a 0-d array, or a tuple of them) as Python's."""
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v if torch.is_tensor(v) else np.asarray(v).item()


def load_optimizer_state_tree(opt_state: torch.optim.Optimizer,
                              tree: dict) -> None:
    """Load :func:`optimizer_state_tree`'s tree (as saved, or as
    ``load_state`` returns it) into ``opt_state``, a fresh optimizer
    built by ``init`` over the same parameter tensors.  The tensors are
    copied onto each parameter's device by ``load_state_dict``; Adam's
    ``step`` keeps its dtype, so a resumed AdamW step is bitwise the
    straight one."""
    sd = opt_state.state_dict()
    n = sum(len(g["params"]) for g in sd["param_groups"])
    if len(tree["state"]) != n \
            or len(tree["param_groups"]) != len(sd["param_groups"]):
        raise ValueError(
            f"optimizer state for {len(tree['state'])} parameters in "
            f"{len(tree['param_groups'])} groups does not fit an optimizer "
            f"over {n} parameters in {len(sd['param_groups'])} groups")
    state = {}
    for i, st in enumerate(tree["state"]):
        if st:
            state[i] = {k: torch.as_tensor(v) if v is not None else None
                        for k, v in st.items()}
    for group, saved in zip(sd["param_groups"], tree["param_groups"]):
        group.update({k: _plain(v) for k, v in saved.items()})
    sd["state"] = state
    opt_state.load_state_dict(sd)


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


def sgd(learning_rate: float, momentum=None) -> _TorchOptimizer:
    """``optax.sgd``: plain, or with optax's momentum ``trace``."""
    return _TorchOptimizer(torch.optim.SGD, lr=learning_rate,
                           momentum=momentum or 0.0, dampening=0.0)


class _CrossReplicaMean:
    """An optax-style transformation whose ``update`` returns the mean
    of the gradient tree over ``comm``'s ranks (a new tree)."""

    def __init__(self, comm, dtype, fused, bucket_bytes):
        self.comm, self.dtype = comm, dtype
        self.fused, self.bucket_bytes = fused, bucket_bytes

    def init(self, params):
        return None

    def update(self, grads, state=None, params=None):
        return self.comm.multi_node_mean_grad(
            grads, self.dtype, fused=self.fused,
            bucket_bytes=self.bucket_bytes), state


def cross_replica_mean(comm, dtype=None, fused: bool = False,
                       bucket_bytes=None) -> _CrossReplicaMean:
    """The mean of the gradients over ``comm``: cast to ``dtype`` (the
    ``allreduce_grad_dtype``) for the wire and back.  ``fused`` packs
    the tree into dtype-grouped buckets of ``bucket_bytes``, one
    all-reduce a bucket.

    The JAX package differentiates a ``pmean``'d loss, so its gradients
    already leave the step as the fp32 global mean and this mean only
    rounds them through the wire dtype; the port differentiates each
    rank's local loss, so this is where the ranks' gradients meet (what
    ``allreduce_grad_dtype`` documents).  At one rank both are
    ``dtype(g)`` cast back; at N ranks they differ by bf16 rounding."""
    return _CrossReplicaMean(comm, dtype, fused, bucket_bytes)


class _MultiNodeOptimizer:
    """``init`` is the inner optimizer's; ``update`` exchanges the
    gradients, then steps the inner optimizer in place."""

    def __init__(self, mean: _CrossReplicaMean, inner):
        self.mean, self.inner = mean, inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, opt_state, params):
        grads, _ = self.mean.update(grads)
        self.inner.update(grads, opt_state, params)


def _not_ported(what, item):
    return NotImplementedError(
        f"create_multi_node_optimizer({what}) is not ported to "
        f"chainermn_tpu_torch yet (ROADMAP Queue A item {item})")


def create_multi_node_optimizer(
    actual_optimizer,
    comm=None,
    double_buffering: bool = False,
    zero1: bool = False,
    zero2: bool = False,
    accum_steps: int = 1,
    axis_name=None,
    allreduce_grad_dtype=None,
    fused: bool = True,
    bucket_bytes=None,
    inter_axis_name=None,
    plan=None,
    overlap=False,
) -> _MultiNodeOptimizer:
    """Wrap ``actual_optimizer`` (:func:`sgd`, :func:`adamw`) with the
    mean of the gradients over ``comm`` — ChainerMN's
    ``create_multi_node_optimizer``.

    ``allreduce_grad_dtype`` is the wire dtype (``torch.bfloat16``);
    ``fused`` (the default) packs the gradients into flat dtype-grouped
    buckets of ``bucket_bytes`` (default 4 MiB), one all-reduce a
    bucket.  The parameters start equal on every rank
    (:class:`~chainermn_tpu_torch.training.StandardUpdater` broadcasts
    them), so every rank takes the same step.

    Not ported yet, each raising: ``double_buffering``, ``accum_steps >
    1``, ``overlap`` and ``inter_axis_name`` (Queue A item 2), ``zero1``
    and ``zero2`` (item 8), ``plan`` (item 10), and ``axis_name`` (the
    port reduces over a communicator, not a mesh axis)."""
    if comm is None:
        raise ValueError("create_multi_node_optimizer needs comm")
    if axis_name is not None:
        raise ValueError("the port reduces over comm; axis_name names a "
                         "mesh axis of the JAX package")
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} must be >= 1")
    for what, on, item in (("double_buffering=True", double_buffering, 2),
                           ("accum_steps > 1", accum_steps > 1, 2),
                           ("overlap=...", overlap, 2),
                           ("inter_axis_name=...",
                            inter_axis_name is not None, 2),
                           ("zero1=True", zero1, 8),
                           ("zero2=True", zero2, 8),
                           ("plan=...", plan is not None, 10)):
        if on:
            raise _not_ported(what, item)
    return _MultiNodeOptimizer(
        cross_replica_mean(comm, allreduce_grad_dtype, fused=fused,
                           bucket_bytes=bucket_bytes), actual_optimizer)
