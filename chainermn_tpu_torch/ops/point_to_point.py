"""Differentiable point-to-point communication for model parallelism
(the JAX package's ``ops/point_to_point.py``; ChainerMN's ``Send`` and
``Recv`` FunctionNodes and ``pseudo_connect``, SURVEY.md §3.3).

The JAX package states a transfer once, as a ``lax.ppermute`` inside one
SPMD program, and its transpose is the backward.  The port works per
rank, as ChainerMN did: every rank calls the same function on its own
tensor, and each transfer is a ``torch.autograd.Function`` whose forward
posts the sends and receives of ``perm`` (``comm.permute``, a
``batch_isend_irecv``, so a general permutation cannot deadlock) and
whose backward posts the other way: the output's gradient goes back to
the source along the inverse permutation.  The semantics are JAX's, per
rank: rank ``r``'s tensor is the JAX world-stacked array's ``[r]``; a
rank with no source gets zeros; ``shift_*(wrap=True)`` is a ring.

A rank that only sends still gets a tensor back: zeros that carry the
transfer's ``grad_fn``.  Its backward is what receives the gradient, so
that tensor must reach the loss, or the receiver's backward waits in
its send for ever.  :func:`pseudo_connect` ties it in with a
zero-valued dependency, ChainerMN's own remedy.  Every rank must post
its transfers in the same order in the backward too;
:class:`~chainermn_tpu_torch.links.MultiNodeChainList` threads a token
through its transfers for that, and code that calls these functions
several times in one graph must order them itself.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

__all__ = [
    "ppermute", "pseudo_connect", "recv", "send", "send_recv",
    "shift_down", "shift_up",
]


class _Transfer(torch.autograd.Function):
    """``comm.permute`` with its inverse as the backward.  ``x`` may be
    None on a rank that sends nothing; ``like``, a ``(shape, dtype)``,
    is then what this rank receives (a rank that receives nothing may
    name an empty shape for its zeros).  ``token``, when given, is
    passed through as the second output: a chain of tokens fixes the
    order in which a rank's transfers run backward."""

    @staticmethod
    def forward(ctx, x, token, comm, perm, like):
        perm = [(int(s), int(d)) for s, d in perm]
        ctx.comm, ctx.perm = comm, perm
        ctx.x_meta = None if x is None else (x.shape, x.dtype)
        recv = None if like is None else torch.empty(
            like[0], dtype=like[1], device=comm.device)
        out = comm.permute(x, perm, recv=recv)
        return out, (None if token is None else token.clone())

    @staticmethod
    def backward(ctx, g, g_token):
        comm, me = ctx.comm, ctx.comm.rank
        inverse = [(d, s) for s, d in ctx.perm]
        receives = any(d == me for _, d in ctx.perm)
        recv = None
        if ctx.x_meta is not None:
            shape, dtype = ctx.x_meta
            recv = torch.empty(shape, dtype=dtype, device=comm.device)
        gx = comm.permute(g.contiguous() if receives else None, inverse,
                          recv=recv)
        return (gx if ctx.x_meta is not None else None, g_token, None,
                None, None)


def _permute(x, comm, perm, token=None, like=None):
    return _Transfer.apply(x, token, comm, perm, like)


def ppermute(x, comm, perm: Sequence[Tuple[int, int]], like=None):
    """Raw collective permute: ``perm`` is ``[(source, dest), ...]``;
    ranks with no source receive zeros.  Backward: the inverse
    permutation.  A rank that sends nothing passes ``x=None`` and
    ``like``, the ``(shape, dtype)`` it receives."""
    return _permute(x, comm, perm, like=like)[0]


def send(x, comm, dest: int, source: int):
    """Move ``x`` from rank ``source`` to ``dest`` (zeros elsewhere).
    Every rank calls it, as every rank traces the JAX package's; the
    backward moves the gradient ``dest → source``."""
    return ppermute(x, comm, [(source, dest)])


# recv is the same op seen from the receiving side; parity alias
recv = send


def send_recv(x, comm, perm: Sequence[Tuple[int, int]]):
    """Simultaneous multi-pair exchange (the general ChainerMN use)."""
    return ppermute(x, comm, perm)


def _shift_perm(n: int, delta: int, wrap: bool) -> List[Tuple[int, int]]:
    if wrap:
        return [(i, (i + delta) % n) for i in range(n)]
    return [(i, i + delta) for i in range(n) if 0 <= i + delta < n]


def shift_up(x, comm, axis_size: Optional[int] = None, wrap: bool = False):
    """Stage ``i`` → stage ``i+1`` (activation flow in a pipeline).
    Stage 0 receives zeros unless ``wrap`` (ring)."""
    return ppermute(x, comm, _shift_perm(axis_size or comm.size, +1, wrap))


def shift_down(x, comm, axis_size: Optional[int] = None,
               wrap: bool = False):
    """Stage ``i`` → stage ``i-1`` (gradient flow, ring reverse)."""
    return ppermute(x, comm, _shift_perm(axis_size or comm.size, -1, wrap))


def pseudo_connect(delegate, *actuals):
    """Tie ``delegate`` (a tree of tensors, such as a ``send`` result
    this rank does not use) into ``actuals`` with a zero-valued
    dependency, so that ``backward()`` of the actuals runs the
    delegate's backward: the send side's backward receives the
    gradient.  Returns the actuals (one value if one was passed)."""
    tie = torch.zeros((), dtype=torch.float32, device=actuals[0].device)
    for leaf in pytree.tree_leaves(delegate):
        tie = tie + leaf.sum().float() * 0.0
    tied = tuple(a + tie.to(a.dtype) for a in actuals)
    return tied[0] if len(tied) == 1 else tied
