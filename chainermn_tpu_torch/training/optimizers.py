"""optax's optimizers, and ChainerMN's multi-node optimizer over a
communicator.

The JAX package's ``make_train_step(..., optimizer)`` takes an optax
``GradientTransformation`` (``bench_transformer.py`` passes
``optax.adamw(3e-4)``, its tests ``optax.sgd``).  The port's
:func:`~chainermn_tpu_torch.models.make_train_step` takes one of these:
``init(params)`` returns the optimizer state, an :class:`OptaxRule` (a
``torch.optim`` optimizer) over the leaves of ``params``, and
``update(grads, opt_state, params)`` applies one step to ``params`` in
place.  Each rule is optax's, with optax's defaults, written over
``torch._foreach_*``: ``sgd`` (with ``momentum``, optax's ``trace``),
``adam``, ``adamw`` (optax's decoupled decay, ``weight_decay`` 1e-4 on every
leaf; ``mu_dtype`` keeps the first moment in a lower precision),
``lars`` and ``lamb``.  A learning rate is a number or a schedule (a
callable of the update count,
:mod:`~chainermn_tpu_torch.training.schedules`).  The state is made at
``init`` and updated in place, its count a tensor on the parameters'
device, so a captured CUDA graph replays it.

:func:`create_multi_node_optimizer` wraps one of these with the mean of
the gradients over a communicator (the JAX package's
``training/optimizers.py:640``): its ``update`` exchanges the gradient
tree (fused bf16 buckets, two-stage over the nodes, or the
backward-overlapped buckets) and then steps the inner optimizer, with
gradient accumulation and ChainerMN's double buffering around it.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch.ops import fused as _fused

__all__ = ["MultiNodeState", "OptaxRule", "Zero1Transformation",
           "Zero2Transformation", "adam", "adamw", "create_multi_node_optimizer",
           "cross_replica_mean", "lamb", "lars",
           "load_optimizer_state_tree", "map_state_moments",
           "optimizer_state_tree", "sgd", "shard_opt_state", "zero1_init"]


def tree_leaves(tree) -> list:
    """Every tensor of a nested dict/list/tuple tree, depth first in
    insertion order."""
    return pytree.tree_leaves(tree)


class _TorchOptimizer:
    """An optax-style ``init``/``update`` pair over one
    :class:`OptaxRule` class and its arguments."""

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
    """A number: what a ``param_groups`` entry may put in the snapshot's
    leaves."""
    return (isinstance(v, (int, float)) and not isinstance(v, bool)) \
        or torch.is_tensor(v)


def optimizer_state_tree(opt_state) -> dict:
    """The optimizer's state as a tree of tensors and numbers:
    ``{"state": [one dict a parameter, in the order of init's leaves:
    its ``count``, and SGD's and LARS's ``trace``, AdamW's and LAMB's
    ``mu`` and ``nu``], "param_groups": [the numeric entries of each
    group]}``.  The non-numeric entries (``params``, a schedule,
    ``mu_dtype``) stay out of the leaves, as the JAX container keeps
    strings out; the optimizer built over the same parameters already
    holds them.  The tensors are the optimizer's own, not copies.

    A :class:`MultiNodeState` (accumulation, double buffering) gives
    ``{"inner": the inner optimizer's tree, "accum": {"count", "acc"},
    "prev_grads": [...]}``, the last two where they exist: the JAX
    package keeps all of it in ``opt_state`` too."""
    if isinstance(opt_state, MultiNodeState):
        opt_state.join()
        tree = {"inner": optimizer_state_tree(opt_state.inner)}
        if opt_state.acc is not None:
            tree["accum"] = {"count": opt_state.count,
                             "acc": list(opt_state.acc)}
        if opt_state.prev is not None:
            tree["prev_grads"] = list(opt_state.prev)
        return tree
    sd = opt_state.state_dict()
    n = sum(len(g["params"]) for g in sd["param_groups"])
    return {
        "state": [dict(sd["state"].get(i, {})) for i in range(n)],
        "param_groups": [{k: v for k, v in g.items() if _numeric(v)}
                         for g in sd["param_groups"]],
    }


def map_state_moments(tree: dict, params, fn) -> dict:
    """:func:`optimizer_state_tree`'s ``tree`` with ``fn`` applied to
    each of its per-leaf moments (``mu``, ``nu``, ``trace``) as one tree
    of ``params``' structure: a whole saved state brought to a rank's
    shard (``params_from_jax`` with a mesh), or a rank's gathered into
    the whole one (``params_to_numpy`` with it).  ``fn``'s tree must
    have ``params``' keys; its leaves are taken in ``params``' order."""

    def in_order(out, like):
        # ``out``'s leaves in the order of ``like``'s keys
        return [x for k, v in like.items() for x in (
            in_order(out[k], v) if isinstance(v, dict) else [out[k]])]

    spec = pytree.tree_structure(params)
    state = [dict(s) for s in tree["state"]]
    for key in [k for k in state[0] if k != "count"] if state else ():
        moved = in_order(fn(pytree.tree_unflatten(
            [torch.as_tensor(s[key]) for s in state], spec)), params)
        for s, t in zip(state, moved):
            s[key] = t
    return dict(tree, state=state)


def _plain(v):
    """A loaded number (a 0-d array) as Python's."""
    return v if torch.is_tensor(v) else np.asarray(v).item()


def load_optimizer_state_tree(opt_state, tree: dict) -> None:
    """Load :func:`optimizer_state_tree`'s tree (as saved, or as
    ``load_state`` returns it) into ``opt_state``, a fresh optimizer
    built by ``init`` over the same parameter tensors.  The tensors are
    copied into the optimizer's own in their dtypes
    (:meth:`OptaxRule.load_state_dict`), so a resumed step is bitwise
    the straight one and a captured graph keeps reading the same
    storage; a :class:`MultiNodeState`'s are copied in place too."""
    if isinstance(opt_state, MultiNodeState):
        opt_state.join()
        load_optimizer_state_tree(opt_state.inner, tree["inner"])
        with torch.no_grad():
            if opt_state.acc is not None:
                opt_state.count.copy_(torch.as_tensor(
                    tree["accum"]["count"]))
                for t, v in zip(opt_state.acc, tree["accum"]["acc"]):
                    t.copy_(torch.as_tensor(v))
                opt_state.phase = int(opt_state.count) % opt_state.every
            if opt_state.prev is not None:
                for t, v in zip(opt_state.prev, tree["prev_grads"]):
                    t.copy_(torch.as_tensor(v))
        return
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



class OptaxRule(torch.optim.Optimizer):
    """An optax update rule written over ``torch._foreach_*``.

    The state is made for every parameter at construction (optax's
    ``init``), so nothing is created lazily under a CUDA graph capture;
    ``count`` (int32, on the parameter's device) is optax's update
    count, the argument of a schedule ``lr``.  :meth:`load_state_dict`
    copies into the live tensors in their own dtypes: a bf16 moment
    stays bf16, and a captured graph keeps reading the same storage.
    Each subclass's ``_rule`` returns the update ``u`` of optax's chain;
    the parameter becomes ``p + u``, optax's ``apply_updates``."""

    def __init__(self, params, lr, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))
        for group in self.param_groups:
            for p in group["params"]:
                st = {"count": torch.zeros((), dtype=torch.int32,
                                           device=p.device)}
                st.update(self._init_state(p, group))
                self.state[p] = st

    def _init_state(self, p, group) -> dict:
        return {}

    @torch.no_grad()
    def updates(self) -> list:
        """Optax's ``update``: each parameter's update ``u`` from its
        ``.grad``, the state moved, in the parameters' order (those with
        a gradient); the parameters are not touched."""
        out = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            count = states[0]["count"]
            lr = group["lr"]
            lr = lr(count) if callable(lr) else lr
            out += self._rule(group, params, [p.grad for p in params],
                              states, count, lr)
            torch._foreach_add_([st["count"] for st in states], 1)
        return out

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups
                  for p in group["params"] if p.grad is not None]
        updates = self.updates()
        if params:
            torch._foreach_add_(params, updates)

    def _scaled(self, updates, lr):
        # optax's scale_by_learning_rate: u ← (−lr)·u, one rounding
        return torch._foreach_mul(updates, -lr)

    def load_state_dict(self, state_dict):
        params = [p for g in self.param_groups for p in g["params"]]
        with torch.no_grad():
            for i, p in enumerate(params):
                saved = state_dict["state"][i]
                for k, t in self.state[p].items():
                    t.copy_(torch.as_tensor(saved[k]))
        for group, saved in zip(self.param_groups,
                                state_dict["param_groups"]):
            group.update({k: v for k, v in saved.items() if k != "params"})


def _decayed(updates, params, weight_decay):
    # optax's add_decayed_weights: u + wd·p, the product rounded first
    return torch._foreach_add(updates,
                              torch._foreach_mul(params, weight_decay))


def _trust_scaled(updates, params, coefficient, eps):
    """optax's ``scale_by_trust_ratio``: each leaf's update times
    ``coefficient·‖p‖ / (‖u‖ + eps)``, or 1 where a norm is 0."""
    pn = torch._foreach_norm(params)
    un = torch._foreach_norm(updates)
    ratios = [torch.where((a == 0) | (b == 0), 1.0, coefficient * a
                          / (b + eps)) for a, b in zip(pn, un)]
    return torch._foreach_mul(updates, ratios)


def _adam_moments(grads, states, count, b1, b2, eps):
    """optax's ``scale_by_adam`` (eps_root 0): the moments move in place
    (the first kept in its own dtype, computed in the gradient's), and
    the update ``m̂ / (√v̂ + eps)`` is returned."""
    mus = [st["mu"] for st in states]
    nus = [st["nu"] for st in states]
    # (1 − b1)·g + b1·m: with JAX's weak types b1 is first rounded to
    # m's dtype and the product taken in it
    b1_m = torch.tensor(b1, dtype=mus[0].dtype).item()
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), [
        t.to(g.dtype) for t, g in zip(torch._foreach_mul(mus, b1_m),
                                      grads)])
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    c = (count + 1).float()
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    den = torch._foreach_add(torch._foreach_sqrt(
        torch._foreach_div(nus, bc2)), eps)
    update = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    torch._foreach_copy_(mus, mu)
    return update


class _SGD(OptaxRule):
    """``optax.sgd``: ``t ← g + μ·t``, ``u = −lr·t`` (plain: ``t = g``)."""

    def _init_state(self, p, group):
        return {"trace": torch.zeros_like(p)} if group["momentum"] else {}

    def _rule(self, group, params, grads, states, count, lr):
        if group["momentum"]:
            traces = [st["trace"] for st in states]
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, grads)
            grads = traces
        return self._scaled(grads, lr)


class _Adam(OptaxRule):
    """``optax.adam``: ``m̂ / (√v̂ + eps)`` times ``−lr``; the first
    moment in ``mu_dtype``."""

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p, dtype=group["mu_dtype"]
                                       or p.dtype),
                "nu": torch.zeros_like(p)}

    def _rule(self, group, params, grads, states, count, lr):
        return self._scaled(_adam_moments(grads, states, count, group["b1"],
                                          group["b2"], group["eps"]), lr)


class _AdamW(_Adam):
    """``optax.adamw``: adam's update, plus ``wd·p``, times ``−lr``;
    the first moment in ``mu_dtype``."""

    def _rule(self, group, params, grads, states, count, lr):
        u = _adam_moments(grads, states, count, group["b1"], group["b2"],
                          group["eps"])
        return self._scaled(_decayed(u, params, group["weight_decay"]), lr)


class _LARS(OptaxRule):
    """``optax.lars``: ``u = g + wd·p``, times the trust ratio
    (``coefficient·‖p‖/(‖u‖ + eps)``), times ``−lr``, then the momentum
    trace ``t ← u + μ·t`` is the update."""

    def _init_state(self, p, group):
        return {"trace": torch.zeros_like(p)}

    def _rule(self, group, params, grads, states, count, lr):
        u = _decayed(grads, params, group["weight_decay"])
        u = self._scaled(_trust_scaled(u, params,
                                       group["trust_coefficient"],
                                       group["eps"]), lr)
        traces = [st["trace"] for st in states]
        torch._foreach_mul_(traces, group["momentum"])
        torch._foreach_add_(traces, u)
        return traces


class _LAMB(OptaxRule):
    """``optax.lamb``: adam's update, plus ``wd·p``, times the trust
    ratio (coefficient 1), times ``−lr``."""

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _rule(self, group, params, grads, states, count, lr):
        u = _adam_moments(grads, states, count, group["b1"], group["b2"],
                          group["eps"])
        u = _decayed(u, params, group["weight_decay"])
        return self._scaled(_trust_scaled(u, params, 1.0, 0.0), lr)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, *, mu_dtype=None) -> _TorchOptimizer:
    """``optax.adam`` with optax's defaults (``eps_root`` 0); with
    ``mu_dtype`` the first moment is kept in it."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)
    return _TorchOptimizer(_Adam, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                           mu_dtype=mu_dtype)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4, *,
          mu_dtype=None) -> _TorchOptimizer:
    """``optax.adamw`` with optax's defaults; with ``mu_dtype`` (e.g.
    ``torch.bfloat16``) the first moment is kept in it."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)
    return _TorchOptimizer(_AdamW, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, mu_dtype=mu_dtype)


def sgd(learning_rate, momentum=None) -> _TorchOptimizer:
    """``optax.sgd``: plain, or with optax's momentum ``trace``."""
    return _TorchOptimizer(_SGD, lr=learning_rate, momentum=momentum or 0.0)


def lars(learning_rate, weight_decay: float = 0.0,
         trust_coefficient: float = 0.001, eps: float = 0.0,
         momentum: float = 0.9) -> _TorchOptimizer:
    """``optax.lars`` (You et al. 2017) with optax's defaults, every
    leaf decayed and trust-scaled (optax's default masks), no
    Nesterov."""
    return _TorchOptimizer(_LARS, lr=learning_rate,
                           weight_decay=weight_decay,
                           trust_coefficient=trust_coefficient, eps=eps,
                           momentum=momentum)


def lamb(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.0) -> _TorchOptimizer:
    """``optax.lamb`` (You et al. 2020) with optax's defaults
    (``eps_root`` 0, no mask)."""
    return _TorchOptimizer(_LAMB, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay)


class _CrossReplicaMean:
    """An optax-style transformation whose ``update`` returns the mean
    of the gradient tree over ``comm``'s ranks (a new tree): fused
    buckets, every bucket two-stage with ``two_stage``, or the overlap
    schedule's buckets with ``overlap``."""

    def __init__(self, comm, dtype, fused, bucket_bytes, two_stage=False,
                 overlap=False):
        self.comm, self.dtype = comm, dtype
        self.fused = fused
        self.bucket_bytes = bucket_bytes or _fused.DEFAULT_BUCKET_BYTES
        self.two_stage, self.overlap = two_stage, overlap
        self.schedule = None

    def init(self, params):
        if self.overlap:
            self.schedule = _fused.build_overlap_schedule(
                params, self.bucket_bytes, self.dtype)
        return None

    def _comms(self):
        return self.comm.hierarchy() if self.two_stage \
            else (self.comm, None)

    def overlapped(self, params) -> "_fused.OverlapExchange":
        """An :class:`~chainermn_tpu_torch.ops.fused.OverlapExchange` of
        the schedule over ``params``' leaves, to be fed gradients as the
        backward produces them."""
        comm, inter = self._comms()
        leaves, treedef = pytree.tree_flatten(params)
        return _fused.OverlapExchange(leaves, treedef, comm, self.schedule,
                                      "mean", self.dtype, inter)

    def update(self, grads, state=None, params=None):
        if self.overlap:
            comm, inter = self._comms()
            return _fused.overlap_exchange(
                grads, comm, schedule=self.schedule, wire_dtype=self.dtype,
                inter_comm=inter), state
        if self.two_stage:
            comm, inter = self._comms()
            return _fused.fused_allreduce(
                grads, comm, "mean", self.bucket_bytes, self.dtype,
                inter_comm=inter), state
        return self.comm.multi_node_mean_grad(
            grads, self.dtype, fused=self.fused,
            bucket_bytes=self.bucket_bytes), state


def cross_replica_mean(comm, dtype=None, fused: bool = False,
                       bucket_bytes=None,
                       inter_axis_name=None) -> _CrossReplicaMean:
    """The mean of the gradients over ``comm``: cast to ``dtype`` (the
    ``allreduce_grad_dtype``) for the wire and back.  ``fused`` packs
    the tree into dtype-grouped buckets of ``bucket_bytes``, one
    all-reduce a bucket.  ``inter_axis_name`` (any value: the port
    reduces over communicators, not named axes) makes every bucket
    two-stage over ``comm.hierarchy()``.

    The JAX package differentiates a ``pmean``'d loss, so its gradients
    already leave the step as the fp32 global mean and this mean only
    rounds them through the wire dtype; the port differentiates each
    rank's local loss, so this is where the ranks' gradients meet (what
    ``allreduce_grad_dtype`` documents).  At one rank both are
    ``dtype(g)`` cast back; at N ranks they differ by bf16 rounding."""
    return _CrossReplicaMean(comm, dtype, fused, bucket_bytes,
                             two_stage=inter_axis_name is not None)


class MultiNodeState:
    """``opt_state`` of a multi-node optimizer that accumulates or
    double-buffers: the inner optimizer and the tensors around it, all
    updated in place.

    ``acc`` (accumulation): the running sums of the reduced gradients,
    in the parameters' dtypes, and ``count``, the micro-steps (int32 on
    the device; ``phase`` is ``count % every`` on the host, which decides
    when the parameters move).  ``prev`` (double buffering): the reduced
    gradients the next update applies, zeros at first.  ``event``: on
    the card, the communication stream's event behind the last write of
    these tensors; :meth:`join` makes the current stream wait for it."""

    def __init__(self, inner, params, every, double_buffering):
        leaves = pytree.tree_leaves(params)
        self.inner, self.every, self.phase = inner, every, 0
        self.acc = self.count = self.prev = None
        if every > 1:
            self.acc = [torch.zeros_like(p) for p in leaves]
            self.count = torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device)
        if double_buffering:
            self.prev = [torch.zeros_like(p) for p in leaves]
        self.event = None

    def join(self) -> None:
        if self.event is not None:
            torch.cuda.current_stream(self.event.device).wait_event(
                self.event)
            self.event = None


class _MultiNodeOptimizer:
    """``init`` makes the inner optimizer's state (a
    :class:`MultiNodeState` around it when accumulating or
    double-buffering); ``update`` exchanges the gradients, then
    :meth:`apply` moves the parameters in place.

    The composition is the JAX package's (``optimizers.py:768-786``):
    the exchange, then accumulation (the parameters move every
    ``every`` calls with the mean of the reduced gradients), inside it
    double buffering (the inner optimizer applies the previous update's
    gradients, zeros first), so staleness counts updates, not
    micro-steps.

    On the card, with double buffering or ``overlap``, the exchange runs
    on a communication stream forked from the compute stream by an
    event (ChainerMN's ``_DoubleBufferingOptimizer``): the inner update
    waits only for the previous update's stash, so this update's
    all-reduce overlaps the next forward and backward.  The order of
    every operation on each tensor is the stream-free order, so the
    numbers are its bits."""

    def __init__(self, mean: _CrossReplicaMean, inner, every=1,
                 double_buffering=False):
        self.mean, self.inner = mean, inner
        self.every, self.double_buffering = every, double_buffering
        self.overlap = mean is not None and mean.overlap
        self._stream = None

    def init(self, params):
        self.mean.init(params)
        inner = self.inner.init(params)
        if self.every > 1 or self.double_buffering:
            return MultiNodeState(inner, params, self.every,
                                  self.double_buffering)
        return inner

    def _side_stream(self, device):
        if device.type != "cuda" or not (self.double_buffering
                                         or self.overlap):
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    @contextlib.contextmanager
    def on_comm_stream(self, tensors):
        """Run the body on the communication stream (on the card, with
        double buffering or overlap; otherwise where it is), after the
        work behind ``tensors`` on the current stream."""
        stream = self._side_stream(tensors[0].device) if tensors else None
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        for t in tensors:
            t.record_stream(stream)
        with torch.cuda.stream(stream):
            yield

    def overlapped(self, params):
        """The overlap schedule's exchange over ``params``
        (``overlap=True``): feed it each gradient under
        :meth:`on_comm_stream` as the backward makes it, then pass its
        ``result()`` to :meth:`apply`."""
        return self.mean.overlapped(params)

    def update(self, grads, opt_state, params):
        with self.on_comm_stream(pytree.tree_leaves(grads)):
            reduced, _ = self.mean.update(grads)
        self.apply(reduced, opt_state, params)

    def apply(self, reduced, opt_state, params):
        """Accumulate and step with gradients already exchanged (made on
        the communication stream where there is one)."""
        leaves = pytree.tree_leaves(reduced)
        stream = self._side_stream(leaves[0].device) if leaves else None
        st = opt_state if isinstance(opt_state, MultiNodeState) else None
        g = leaves
        if self.every > 1:
            with self._on(stream):
                torch._foreach_add_(st.acc, g)
                st.count.add_(1)
                st.phase = (st.phase + 1) % self.every
                if st.phase:
                    st.event = self._record(stream)
                    return
                g = torch._foreach_div(st.acc, self.every)
                torch._foreach_zero_(st.acc)
        treedef = pytree.tree_structure(params)
        if not self.double_buffering:
            if stream is not None:
                here = torch.cuda.current_stream(stream.device)
                here.wait_stream(stream)
                for t in g:
                    t.record_stream(here)
            if st is not None:
                st.event = None
            self._step(pytree.tree_unflatten(list(g), treedef),
                       st.inner if st is not None else opt_state, params)
            return
        st.join()                   # the previous update's stash is in
        self._step(pytree.tree_unflatten(list(st.prev), treedef),
                   st.inner, params)
        if stream is None:
            torch._foreach_copy_(st.prev, g)
            return
        # the stash waits for the inner update's read of the last one
        stream.wait_event(self._record(
            torch.cuda.current_stream(stream.device)))
        with torch.cuda.stream(stream):
            torch._foreach_copy_(st.prev, g)
        st.event = self._record(stream)

    def _step(self, grads, inner_state, params):
        """The inner optimizer's step with the exchanged gradients."""
        self.inner.update(grads, inner_state, params)

    @staticmethod
    def _on(stream):
        return torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()

    @staticmethod
    def _record(stream):
        """An event behind ``stream``'s work so far (None: no stream)."""
        if stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event


def _not_ported(what, item):
    return NotImplementedError(
        f"create_multi_node_optimizer({what}) is not ported to "
        f"chainermn_tpu_torch yet (ROADMAP Queue A item {item})")


# --------------------------------------------------------------------- #
# ZeRO-1 and ZeRO-2: the optimizer state sharded over the data group
# --------------------------------------------------------------------- #


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _padded(leaf, n: int):
    """``leaf`` flattened and zero-padded to ``n·s`` elements, ``s =
    ceil(numel/n)``, as an ``(n, s)`` matrix: row ``r`` is rank ``r``'s
    shard."""
    flat = leaf.reshape(-1)
    s = _ceil_div(flat.numel(), n)
    if s * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(s * n - flat.numel())])
    return flat.reshape(n, s)


def _leaf_shard(leaf, idx: int, n: int):
    """Rank ``idx``'s 1-D shard of ``leaf`` (zero-padded to ``n·s``)."""
    return _padded(leaf, n)[idx]


def _zero2_buckets(leaves, n: int, bucket_bytes):
    """Exchange buckets over ``leaves`` in tree order: grouped by dtype
    (first seen first), split so one bucket's per-rank shard stays under
    ``bucket_bytes`` (``None``: one bucket a dtype).  The same on every
    rank, from the tree alone."""
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    buckets = []
    for dt, idxs in by_dtype.items():
        cur, cur_b = [], 0
        for i in idxs:
            b = _ceil_div(leaves[i].numel(), n) * leaves[i].element_size()
            if cur and bucket_bytes is not None \
                    and cur_b + b > bucket_bytes:
                buckets.append((dt, cur))
                cur, cur_b = [], 0
            cur.append(i)
            cur_b += b
        if cur:
            buckets.append((dt, cur))
    return buckets


class _ZeroExchange:
    """The overlap form of a ZeRO exchange: :meth:`put` takes each
    gradient as the backward makes it and reduce-scatters it (ZeRO-1:
    at once; ZeRO-2: when its bucket is whole); :meth:`result` is the
    shards in leaf order."""

    def __init__(self, opt, leaves):
        self.opt, self.n_leaves = opt, len(leaves)
        self.grads = [None] * len(leaves)
        self.shards = [None] * len(leaves)
        self.buckets = opt._buckets(leaves)
        self.bucket_of = {i: b for b, (_, idxs) in enumerate(self.buckets)
                          for i in idxs}
        self.waiting = [len(idxs) for _, idxs in self.buckets]

    def put(self, i: int, grad) -> None:
        self.grads[i] = grad
        b = self.bucket_of[i]
        self.waiting[b] -= 1
        if not self.waiting[b]:
            idxs = self.buckets[b][1]
            for j, shard in zip(idxs, self.opt._scatter(
                    [self.grads[j] for j in idxs])):
                self.shards[j] = shard
                self.grads[j] = None

    def result(self) -> list:
        if any(s is None for s in self.shards):
            raise RuntimeError("a ZeRO overlap exchange was read before "
                               "every gradient was put")
        return self.shards


class Zero1Transformation(_MultiNodeOptimizer):
    """ZeRO-1 (the JAX ``zero1_optimizer``): the inner optimizer's state
    sharded over ``comm``'s ranks.  Its type marks the layout, which
    :class:`~chainermn_tpu_torch.training.StandardUpdater` detects
    (``sharding``, ``zero1``).

    Per update and per leaf: the gradient flattened, zero-padded to
    ``n·s`` and reduce-scattered as a mean (in the wire dtype, divided
    there, cast back), so rank ``r`` holds shard ``r`` of the mean; the
    inner rule runs on that shard with its shard-width state, given a
    shard-width scratch parameter holding this rank's shard of the
    parameter (the port's rules update in place; the JAX rule takes
    ``params`` as an argument); its update ``u`` (not the updated
    parameter: a bf16 wire would round the parameters themselves) is
    all-gathered and ``p + u`` applied on every rank, so the parameters
    stay replicated.  Padding lanes run through the rule and are dropped
    at the gather.  The rule must be elementwise: LARS's and LAMB's
    trust ratio sees the norms of the shard only, as in the JAX package.

    ``init`` returns the inner rule over the scratch shards, or a
    :class:`MultiNodeState` around it whose accumulator and double
    buffer are shard-width too (accumulation and double buffering sit
    inside ZeRO, as the JAX package composes them).  Rank ``r``'s state
    is the JAX world-stacked state's ``[r]``."""

    sharding = "zero1"

    def __init__(self, comm, inner, wire_dtype=None, every=1,
                 double_buffering=False, overlap=False,
                 bucket_bytes=None):
        # the base's exchange is replaced by update / overlapped below
        super().__init__(None, inner, every, double_buffering)
        self.overlap = bool(overlap)
        self.comm, self.wire_dtype = comm, wire_dtype
        self.bucket_bytes = bucket_bytes

    def init(self, params):
        n, r = self.comm.size, self.comm.rank
        leaves, spec = pytree.tree_flatten(params)
        scratch = pytree.tree_unflatten(
            [_leaf_shard(p.detach(), r, n).clone() for p in leaves], spec)
        inner = self.inner.init(scratch)
        if self.every > 1 or self.double_buffering:
            return MultiNodeState(inner, scratch, self.every,
                                  self.double_buffering)
        return inner

    def _buckets(self, leaves):
        """ZeRO-1 reduces leaf by leaf."""
        return [(leaf.dtype, [i]) for i, leaf in enumerate(leaves)]

    def _wire(self, dtype):
        return _fused._wire_dtype_for(dtype, self.wire_dtype)

    def _scatter(self, grads) -> list:
        """One reduce-scatter mean over ``grads`` (a bucket): each
        padded to ``(n, s_i)``, the bucket ``(n, Σ s_i)``; returns the
        shards.  The reduce-scatter is an all-to-all (rank ``j`` gets
        every rank's row ``j``) and the rows' sum in rank order, so each
        element meets the same additions in the same order however the
        leaves are bucketed: ZeRO-2 is ZeRO-1's bits at any
        ``bucket_bytes``, on NCCL and gloo alike (their own
        reduce-scatters order the sum by the element's place in the
        buffer)."""
        n = self.comm.size
        dt = grads[0].dtype
        mats = [_padded(g, n) for g in grads]
        buf = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
        rows = self.comm.alltoall(buf.to(self._wire(dt)))
        red = rows[0].clone()
        for j in range(1, n):
            red += rows[j]
        red = (red / n).to(dt)
        return list(red.split([m.shape[1] for m in mats]))

    def _gather(self, updates, leaves) -> list:
        """The updates' shards all-gathered (in the wire dtype) back to
        the leaves' shapes, a bucket at a time."""
        n = self.comm.size
        out = [None] * len(leaves)
        for _, idxs in self._buckets(leaves):
            cat = torch.cat([updates[i] for i in idxs]) if len(idxs) > 1 \
                else updates[idxs[0]]
            wire = self._wire(cat.dtype)
            full = self.comm.allgather(cat.to(wire)).to(cat.dtype)
            off = 0
            for i in idxs:
                w = updates[i].numel()
                out[i] = full[:, off:off + w].reshape(-1)[
                    :leaves[i].numel()].reshape(leaves[i].shape)
                off += w
        return out

    def exchange(self, grads) -> list:
        """The gradient tree's reduce-scattered mean: this rank's shard
        of every leaf, in leaf order."""
        leaves = pytree.tree_leaves(grads)
        shards = [None] * len(leaves)
        for _, idxs in self._buckets(leaves):
            for i, shard in zip(idxs, self._scatter([leaves[i]
                                                     for i in idxs])):
                shards[i] = shard
        return shards

    def overlapped(self, params):
        """The exchange fed a gradient at a time (``overlap=True``)."""
        return _ZeroExchange(self, pytree.tree_leaves(params))

    def update(self, grads, opt_state, params):
        with self.on_comm_stream(pytree.tree_leaves(grads)):
            shards = self.exchange(grads)
        self.apply(pytree.tree_unflatten(
            shards, pytree.tree_structure(grads)), opt_state, params)

    def _step(self, grads, inner_state, params):
        n, r = self.comm.size, self.comm.rank
        leaves = pytree.tree_leaves(params)
        scratch = [p for g in inner_state.param_groups for p in g["params"]]
        with torch.no_grad():
            for s, p, g in zip(scratch, leaves, pytree.tree_leaves(grads)):
                s.copy_(_leaf_shard(p, r, n))
                s.grad = g
            updates = inner_state.updates()
            for s in scratch:
                s.grad = None
            torch._foreach_add_(leaves, self._gather(updates, leaves))


class Zero2Transformation(Zero1Transformation):
    """ZeRO-2 (the JAX ``zero2_optimizer``): ZeRO-1's state layout with
    the exchange bucketed — the leaves packed rank-major into
    dtype-grouped buckets (each leaf padded to ``(n, s)``, the bucket
    their concatenation along the shard axis), one reduce-scatter and
    one all-gather a bucket.  ``bucket_bytes`` caps a bucket's per-rank
    shard (``None``: one bucket a dtype)."""

    sharding = "zero2"

    def _buckets(self, leaves):
        return _zero2_buckets(leaves, self.comm.size, self.bucket_bytes)


def shard_opt_state(optimizer, params):
    """``optimizer.init(params)`` over this rank's parameters as they
    lie: under FSDP the shards, so the elementwise moments are made at
    shard width (the JAX ``shard_opt_state`` pins shardings for the same
    end; a rank holds only its own)."""
    return optimizer.init(params)


def zero1_init(tx, params):
    """A :class:`Zero1Transformation`'s (or ZeRO-2's) state on this rank:
    the JAX ``zero1_init``'s world-stacked state's row ``comm.rank``."""
    if not isinstance(tx, Zero1Transformation):
        raise TypeError(f"zero1_init takes a ZeRO optimizer, got "
                        f"{type(tx).__name__}")
    return tx.init(params)


# one warning a process for plan= under ZeRO
_ZERO1_PLAN_WARNED = False


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
    """Wrap ``actual_optimizer`` (:func:`sgd`, :func:`adam`, :func:`adamw`,
    :func:`lars`, :func:`lamb`) with the mean of the gradients over
    ``comm`` — ChainerMN's ``create_multi_node_optimizer``.

    ``allreduce_grad_dtype`` is the wire dtype (``torch.bfloat16``);
    ``fused`` (the default) packs the gradients into flat dtype-grouped
    buckets of ``bucket_bytes`` (default 4 MiB), one all-reduce a
    bucket.  The parameters start equal on every rank
    (:class:`~chainermn_tpu_torch.training.StandardUpdater` broadcasts
    them), so every rank takes the same step.

    - ``double_buffering``: the update applies the previous update's
      reduced gradients (zeros at the first), and on the card the
      exchange overlaps the next step on a communication stream.
    - ``accum_steps``: the parameters move every ``accum_steps`` calls
      with the mean of the accumulated reduced gradients; the exchange
      still runs every call (``StandardUpdater(accum_steps=...)`` makes
      one exchange a window instead; do not stack both).
    - ``inter_axis_name``: any value selects the two-stage exchange over
      ``comm.hierarchy()`` (the node's ranks, then the nodes).
    - ``overlap=True``: the static backward-overlapped plan
      (:func:`~chainermn_tpu_torch.ops.build_overlap_schedule` from
      ``bucket_bytes`` and the wire dtype); ``StandardUpdater`` then
      exchanges each bucket from gradient hooks as the backward of a
      window's last microbatch produces it.
    - ``zero1``: the optimizer state sharded over ``comm``
      (:class:`Zero1Transformation`: a reduce-scatter mean a leaf, the
      rule on the shard, an all-gather of the updates); accumulation and
      double buffering sit inside it at shard width; ``fused`` and
      ``inter_axis_name`` are ignored, and ``overlap`` makes
      ``StandardUpdater`` feed the reduce-scatters from the backward's
      gradient hooks.
    - ``zero2``: the same state layout, the exchange bucketed
      (:class:`Zero2Transformation`; ``bucket_bytes`` caps a bucket's
      shard, ``None`` one bucket a dtype).  Exclusive with ``zero1``.
      Under either, ``plan`` is ignored with a one-time warning.

    Not ported yet, each raising: a string ``overlap`` and ``plan`` (the
    measured autotuner, Queue A item 10) without ZeRO, and
    ``axis_name`` (the port reduces over a communicator, not a mesh
    axis)."""
    if comm is None:
        raise ValueError("create_multi_node_optimizer needs comm")
    if axis_name is not None:
        raise ValueError("the port reduces over comm; axis_name names a "
                         "mesh axis of the JAX package")
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} must be >= 1")
    if zero1 and zero2:
        raise ValueError(
            "zero1=True and zero2=True are mutually exclusive — "
            "ZeRO-2 subsumes ZeRO-1's state sharding; pick one")
    if zero1 or zero2:
        if plan is not None:
            global _ZERO1_PLAN_WARNED
            if not _ZERO1_PLAN_WARNED:
                _ZERO1_PLAN_WARNED = True
                warnings.warn(
                    "create_multi_node_optimizer: plan= is ignored under "
                    "zero1/zero2 — ZeRO exchanges gradients through its "
                    "own reduce-scatter/all-gather pair, so the analytic "
                    "path is used instead of the tuned plan (warning "
                    "shown once per process)", RuntimeWarning,
                    stacklevel=2)
        cls = Zero2Transformation if zero2 else Zero1Transformation
        return cls(comm, actual_optimizer, allreduce_grad_dtype,
                   accum_steps, double_buffering, overlap=bool(overlap),
                   bucket_bytes=bucket_bytes)
    for what, on, item in (("overlap='auto'", isinstance(overlap, str), 10),
                           ("plan=...", plan is not None, 10)):
        if on:
            raise _not_ported(what, item)
    mean = _CrossReplicaMean(comm, allreduce_grad_dtype, fused, bucket_bytes,
                             two_stage=inter_axis_name is not None,
                             overlap=bool(overlap))
    return _MultiNodeOptimizer(mean, actual_optimizer, accum_steps,
                               double_buffering)
