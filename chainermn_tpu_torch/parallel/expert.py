"""Expert parallelism: Switch/GShard mixture-of-experts with all-to-all
token dispatch over the mesh's expert axis (the JAX package's
``parallel/expert.py``).

The JAX function routes each token to its top-k experts, queues the
assignments into per-expert capacity slots and moves tokens into and out
of the slots with two ``(N, E, C)`` one-hot einsums.  A one-hot product
only selects, so the port moves the same values by index:

- the routing (:func:`route`) is the JAX one step for step: the router
  product in the compute dtype, cast to fp32, softmax, top-k with ties
  to the lower expert index (``lax.top_k``'s rule; a stable descending
  sort, where ``torch.topk`` promises no order), Switch gates at k=1 and
  renormalised GShard gates above, and the queue positions rank by rank
  (every rank-0 assignment before any rank-1 one), counted exactly in
  integers; assignments past ``C = ceil(cf·k·N/E)`` are dropped;
- the slot table ``(E, C)`` holds the token of each filled slot (``N``,
  a zero row, for an empty one): the slots are one gather of ``x``;
- the combine is a gather too: each token's kept assignments read their
  expert's output row, weighted by the gate rounded to the compute
  dtype (the JAX combine mask's dtype) and summed in fp32, cast once; a
  token whose every assignment was dropped comes out exactly zero, and
  the residual carries it.

Between the two, one tiled all-to-all over the expert communicator
each way (:func:`~.ulysses.all_to_all_tiled`, ``(E, C, D) → (E/S, S·C,
D)`` and back; its backward is the inverse exchange), and the experts'
FFNs as one batched product over the rank's local experts.  The Switch
balancing loss uses the rank-0 choice and is meaned over the expert
communicator only.  :func:`_moe_dense_reference` is the JAX function's
one-hot einsums line by line, the plain version the index path is held
to; :func:`simulate_expert_parallel` runs every rank of an expert
grouping on one device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from chainermn_tpu_torch.ops.collectives import pmean

from .ulysses import all_to_all_tiled

__all__ = ["Routing", "SimulatedExpertAxis", "expert_parallel_moe",
           "route", "simulate_expert_parallel"]


class Routing(NamedTuple):
    """One rank's routing of ``N`` tokens to ``E`` experts of ``C``
    slots each, top-``k``."""

    probs: torch.Tensor       # (N, E) fp32 router softmax
    top_i: torch.Tensor       # (N, k) int64 chosen experts, best first
    gates: torch.Tensor       # (N, k) fp32 gate of each assignment
    pos: torch.Tensor         # (N, k) int64 queue position in its expert
    keep: torch.Tensor        # (N, k) bool: position < C
    slot_token: torch.Tensor  # (E, C) int64 token of each slot, N if empty
    capacity: int

    @property
    def dropped(self) -> torch.Tensor:
        """The number of assignments past capacity (a 0-d tensor)."""
        return (~self.keep).sum()


def capacity(n_tokens: int, n_experts: int, capacity_factor: float,
             top_k: int) -> int:
    """Slots an expert: ``ceil(cf·k·N/E)``, at least one."""
    return max(1, math.ceil(capacity_factor * top_k * n_tokens / n_experts))


def _top_k(probs, k: int):
    """``lax.top_k`` along the last axis: descending, and on equal values
    the lower index first (a stable sort keeps the index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x, router_w, *, capacity_factor: float = 1.25,
          top_k: int = 1) -> Routing:
    """The JAX routing of ``x (N, D)`` by ``router_w (D, E)`` (both in
    the compute dtype) as a slot table, see the module docstring."""
    N = x.shape[0]
    E = router_w.shape[-1]
    if not 1 <= top_k <= E:
        raise ValueError(f"top_k={top_k} must be in [1, E={E}]")
    cap = capacity(N, E, capacity_factor, top_k)
    logits = (x @ router_w).float()                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, top_k)                   # (N, k)
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    pos = torch.empty_like(top_i)
    experts = torch.arange(E, device=x.device)[:, None]
    for r in range(top_k):
        e = top_i[:, r]
        # (E, N): each expert's queue a row, counted along the row (an
        # inner-dim scan; int32 counts are exact)
        oh = (e[None, :] == experts).to(torch.int32)
        before = oh.cumsum(1).gather(0, e[None, :])[0] - 1
        pos[:, r] = before + counts[e]
        counts += oh.sum(1)
    keep = pos < cap
    slot_token = torch.full((E * cap,), N, dtype=torch.int64,
                            device=x.device)
    tok = torch.arange(N, device=x.device)[:, None].expand_as(top_i)
    slot_token[(top_i * cap + pos)[keep]] = tok[keep]
    return Routing(probs, top_i, gates, pos, keep,
                   slot_token.reshape(E, cap), cap)


def dispatch(x, routing: Routing):
    """The ``(E, C, D)`` slots: each filled slot's token, zero rows for
    the empty ones (the JAX ``einsum("nec,nd->ecd", dispatch, x)``)."""
    xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
    E, C = routing.slot_token.shape
    # index_select's backward is an index_add: a token's row gets its k
    # slots' gradients, which for k <= 2 sum to the same bits in any
    # order
    return xz.index_select(0, routing.slot_token.reshape(-1)).reshape(
        E, C, x.shape[1])


def combine(hidden, routing: Routing, dtype):
    """``(N, D)`` in ``dtype``: each token's kept assignments' expert
    outputs from ``hidden (E, C, D)``, gate-weighted and summed in fp32
    (the JAX ``einsum("ecd,nec->nd", hidden, combine)``, its gates in
    ``dtype``)."""
    E, C, D = hidden.shape
    flat = hidden.reshape(E * C, D)
    out = None
    for r in range(routing.top_i.shape[1]):
        keep = routing.keep[:, r]
        # a dropped assignment reads slot 0 at weight zero
        idx = torch.where(keep, routing.top_i[:, r] * C + routing.pos[:, r],
                          0)
        w = torch.where(keep, routing.gates[:, r].to(dtype).float(), 0.0)
        term = flat.index_select(0, idx).float() * w[:, None]
        out = term if out is None else out + term
    return out.to(dtype)


def _frac_tokens(routing: Routing, E: int):
    """The fraction of the tokens whose rank-0 choice is each expert
    (the mean of the one-hot rows: exact counts over ``N``)."""
    return torch.bincount(routing.top_i[:, 0], minlength=E).float() \
        / routing.top_i.shape[0]


def aux_loss(routing: Routing, comm=None):
    """The Switch balancing loss ``E·Σ frac_tokens·frac_probs``: the
    fraction of tokens whose rank-0 choice is each expert and the mean
    router probability, each meaned over ``comm`` (the expert
    communicator) only."""
    probs = routing.probs
    E = probs.shape[-1]
    frac_tokens = _frac_tokens(routing, E)
    frac_probs = probs.mean(0)
    if comm is not None and comm.size > 1:
        # both fractions in one exchange (their gradient: frac_probs')
        frac_tokens, frac_probs = pmean(
            torch.stack([frac_tokens, frac_probs]), comm).unbind(0)
    return E * (frac_tokens * frac_probs).sum()


class SimulatedExpertAxis:
    """Every rank of an expert grouping on one device, for
    :func:`expert_parallel_moe`'s ``comm``: the tokens are ``groups``
    ranks' blocks in rank order (``groups = data·size``, row-major over
    (data, expert)), each block is routed alone, and each data row's
    ``size`` blocks of slots are concatenated in rank order where the
    all-to-all would exchange them.  Not a communicator: nothing runs
    over it but the simulation."""

    def __init__(self, size: int, data: int = 1):
        self.size, self.data = size, data

    @property
    def groups(self) -> int:
        return self.size * self.data


def simulate_expert_parallel(x, router_w, expert_params,
                             expert_fn: Callable, *, axis: SimulatedExpertAxis,
                             capacity_factor: float = 1.25, top_k: int = 1):
    """:func:`expert_parallel_moe` of every rank of ``axis`` on one
    device.  ``x (G·n, D)`` is the ranks' tokens in rank order
    (``G = axis.groups``), ``expert_params`` the whole ``(E, ...)``
    stacks.  Returns ``(out (G·n, D), aux)``, ``aux`` the mean of the
    data rows' balancing losses (each the expert-meaned one a rank of
    that row returns).  Each rank's :class:`Routing` is recorded as
    :func:`expert_parallel_moe` records its own."""
    G, X = axis.groups, axis.size
    if x.shape[0] % G:
        raise ValueError(f"{x.shape[0]} tokens do not split over {G} ranks")
    E = router_w.shape[-1]
    if E % X:
        raise ValueError(f"{E} experts not divisible by axis size {X}")
    outs, auxes = [], []
    for xd in x.chunk(axis.data):
        rs = [route(xr, router_w, capacity_factor=capacity_factor,
                    top_k=top_k) for xr in xd.chunk(X)]
        _record(rs)
        # expert e's queue after the exchange: every rank's slots of e,
        # in rank order
        slots = torch.cat([dispatch(xr, r) for xr, r in
                           zip(xd.chunk(X), rs)], dim=1)     # (E, X·C, D)
        hidden = expert_fn(expert_params, slots)
        outs += [combine(hr, r, x.dtype)
                 for hr, r in zip(hidden.chunk(X, dim=1), rs)]
        # the pmean over the expert axis, as the ranks of row d take it
        ft = torch.stack([_frac_tokens(r, E) for r in rs]).mean(0)
        fp = torch.stack([r.probs.mean(0) for r in rs]).mean(0)
        auxes.append(E * (ft * fp).sum())
    return torch.cat(outs), torch.stack(auxes).mean()


def _record(routings):
    log = expert_parallel_moe.routings
    if log is not None:
        log.extend(routings)


def expert_parallel_moe(x, router_w, expert_params, expert_fn: Callable, *,
                        comm=None, capacity_factor: float = 1.25,
                        top_k: int = 1, a2a_plan=None):
    """Top-k mixture-of-experts over ``comm``, the expert communicator
    (None or one rank: no exchange), called by every rank of it.

    ``top_k=1`` is Switch routing (the gate is the winning
    probability); ``top_k>1`` is GShard's, the k gates renormalised to
    sum to one, and later choices queue behind earlier ones for the
    slots.

    Args:
      x: ``(N, D)`` this rank's tokens (batch × sequence flattened).
      router_w: ``(D, E)`` router weights, replicated; ``E`` is the
        global expert count, the communicator's size times the local
        experts.
      expert_params: a tree whose leaves lead with this rank's
        ``E/S`` local experts (its block of the ``(E, ...)`` stacks).
      expert_fn: ``expert_fn(expert_params, slots)``: the local experts
        on their ``(E/S, S·C, D)`` queues at once, the leading axis of
        both being the expert's (the JAX per-expert function, vmapped).
      capacity_factor: slots an expert ``ceil(cf·k·N/E)``.
      top_k: experts a token, ``1 <= k <= E``.
      a2a_plan: the collective-plan IR's lowering; not ported.

    Returns ``(out, aux)``: ``out (N, D)`` in ``x``'s dtype with the
    dropped tokens zero, and ``aux`` the balancing loss (an fp32
    scalar).  A :class:`SimulatedExpertAxis` as ``comm`` runs
    :func:`simulate_expert_parallel` instead.  While
    ``expert_parallel_moe.routings`` is a list (None by default), each
    call appends its :class:`Routing` to it: the drops a layer, read
    after a run."""
    if a2a_plan is not None:
        raise NotImplementedError(
            "a2a_plan=... is not ported: the collective-plan IR is "
            "ROADMAP Queue A item 10")
    if isinstance(comm, SimulatedExpertAxis):
        return simulate_expert_parallel(
            x, router_w, expert_params, expert_fn, axis=comm,
            capacity_factor=capacity_factor, top_k=top_k)
    S = 1 if comm is None else comm.size
    E = router_w.shape[-1]
    if E % S:
        raise ValueError(f"{E} experts not divisible by axis size {S}")
    r = route(x, router_w, capacity_factor=capacity_factor, top_k=top_k)
    _record([r])
    slots = dispatch(x, r)                                # (E, C, D)
    if S > 1:
        # (E, C, D) → (E/S, S·C, D): each expert's queue from every rank
        slots = all_to_all_tiled(slots, comm, 0, 1)
    hidden = expert_fn(expert_params, slots)
    if S > 1:
        hidden = all_to_all_tiled(hidden, comm, 1, 0)
    return combine(hidden, r, x.dtype), aux_loss(r, comm)


def _moe_dense_reference(x, router_w, expert_params, expert_fn: Callable, *,
                         capacity_factor: float = 1.25, top_k: int = 1):
    """The JAX ``expert_parallel_moe`` at one rank, line by line: the
    ``(N, E, C)`` dispatch and combine masks built from fp32 cumsums and
    the two one-hot einsums.  Returns ``(out, aux, slots)``; the plain
    version the index path is held to (``O(N·E·C·D)`` work and two
    ``(N, E, C)`` fp32 masks)."""
    N, D = x.shape
    E = router_w.shape[-1]
    cap = capacity(N, E, capacity_factor, top_k)
    logits = (x @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, top_k)
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    onehots = torch.nn.functional.one_hot(top_i, E).float()   # (N, k, E)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    disp = torch.zeros((N, E, cap), dtype=torch.float32, device=x.device)
    comb = torch.zeros_like(disp)
    for r in range(top_k):
        oh = onehots[:, r]
        pos = (oh.cumsum(0) - 1.0 + counts) * oh
        keep = pos < cap
        # one_hot of a position past capacity is zero in JAX; torch's
        # refuses it, and keep zeroes the row anyway
        slot = torch.nn.functional.one_hot(pos.long().clamp(max=cap - 1),
                                           cap).float()
        d_r = oh[..., None] * slot * keep[..., None]
        disp = disp + d_r
        comb = comb + d_r * gates[:, r][:, None, None]
        counts = counts + oh.sum(0)
    disp, comb = disp.to(x.dtype), comb.to(x.dtype)
    slots = torch.einsum("nec,nd->ecd", disp, x)
    hidden = expert_fn(expert_params, slots)
    out = torch.einsum("ecd,nec->nd", hidden, comb)
    aux = E * (onehots[:, 0].mean(0) * probs.mean(0)).sum()
    return out, aux, slots


expert_parallel_moe.routings = None
