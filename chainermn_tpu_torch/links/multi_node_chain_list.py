"""Cross-rank model graph — ``MultiNodeChainList`` (the JAX package's
``links/multi_node_chain_list.py``; ChainerMN's
``chainermn/links/multi_node_chain_list.py``, SURVEY.md §3.3).

The JAX package declares the global graph once and traces it on every
rank inside ``shard_map``, masking the outputs to zero off each
component's owner.  The port takes ChainerMN's per-rank form, which that
layer was written to mirror: every rank declares the same list of
components with ``add_link(..., owner=, rank_in=, rank_out=)``, but a
rank holds the parameters of, and runs, only the components it owns.
Inputs are received and outputs sent with the differentiable transfers
of :mod:`chainermn_tpu_torch.ops.point_to_point`, whose backward sends
the gradients the other way, and with ``broadcast_output=True`` the last
component's output reaches every rank through the differentiable
:func:`~chainermn_tpu_torch.ops.bcast`.

Each transfer is matched FIFO per ``(source, dest)`` pair in declaration
order, the JAX package's channels.  The receiver of a message must know
its shape and dtype: the first time the chain sees a shape and dtype of
``x``, each sender posts them on the communicator's object group before
the tensor, and both sides keep them for that ``x``, so later forwards
send tensors only.  So, as in the JAX package, where ``x`` is one array
traced on every rank, every rank passes an ``x`` of the same shape and
dtype, and the shapes a component outputs follow from them.  A rank
threads a token through its transfers and the final broadcast (a zero
tied to one parameter it owns, passed through each transfer), so its
backward runs them in exactly the reverse of their forward order, the
order the peer uses too; and the token is tied into the output, so a
rank that only sends still runs its transfers' backward, ChainerMN's
``pseudo_connect``.  Every rank of ``comm`` must call the chain and run
``backward()`` on a loss computed from its output.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from chainermn_tpu_torch.ops.collectives import bcast
from chainermn_tpu_torch.ops.point_to_point import _permute, pseudo_connect

__all__ = ["MultiNodeChainList"]


def _as_rank_list(r) -> Optional[List[int]]:
    if r is None:
        return None
    if isinstance(r, int):
        return [r]
    return list(r)


@dataclass
class _Component:
    init: Callable[..., Any]
    apply: Callable[..., Any]
    owner: int
    rank_in: Optional[List[int]]
    rank_out: Optional[List[int]]
    name: str = ""


class MultiNodeChainList(nn.Module):
    """Cross-rank sequential or DAG model over the ranks of ``comm``.

    Usage, on every rank::

        mn = MultiNodeChainList(comm)
        mn.add_link(init0, apply0, owner=0, rank_out=1)   # reads input x
        mn.add_link(init1, apply1, owner=1, rank_in=0)    # makes the output
        mn.load_params(mn.init(seed=0))
        y = mn(x)          # on every rank with broadcast_output=True
        loss_fn(y).backward()
        grads = mn.reduce_grads(mn.grads())

    ``init_fn(seed) -> params`` in numpy layout, ``apply_fn(params,
    *inputs) -> tensor``.  ``rank_in``/``rank_out`` take an int or a
    list, as the reference's did; transfers between the same (src, dst)
    pair are matched FIFO in declaration order.  ``self.params`` and the
    lists the methods take and return hold one entry a component: its
    parameters on its owner, None on every other rank.
    """

    def __init__(self, comm, broadcast_output: bool = True):
        super().__init__()
        self.comm = comm
        self.broadcast_output = broadcast_output
        self.components: List[_Component] = []
        self.params: List[Any] = []
        self._holders = nn.ModuleDict()
        # (shape, dtype) of x -> the (shape, dtype) of each message this
        # rank sends or receives across ranks, in order, then the output's
        self._metas: dict = {}

    def add_link(
        self,
        init_fn: Callable[..., Any],
        apply_fn: Callable[..., Any],
        *,
        owner: int,
        rank_in: Union[int, Sequence[int], None] = None,
        rank_out: Union[int, Sequence[int], None] = None,
        name: str = "",
    ) -> "MultiNodeChainList":
        """Append a component.  ``rank_in=None`` means the component
        reads the model input ``x`` (entry stage); otherwise it consumes,
        in order, one message from each listed source rank."""
        self.components.append(_Component(
            init=init_fn, apply=apply_fn, owner=int(owner),
            rank_in=_as_rank_list(rank_in), rank_out=_as_rank_list(rank_out),
            name=name or f"component_{len(self.components)}"))
        self.params.append(None)
        self._metas.clear()
        return self

    def owns(self, i: int) -> bool:
        return self.components[i].owner == self.comm.rank

    def init(self, seed: int = 0) -> List[Any]:
        """``init_fn(seed + i)`` of every component ``i`` this rank
        owns (numpy trees), None for the others."""
        return [c.init(seed + i) if self.owns(i) else None
                for i, c in enumerate(self.components)]

    def load_params(self, params_list: Sequence[Any]) -> List[Any]:
        """Hold the owned entries of ``params_list`` (trees of numpy
        arrays or tensors) as parameters on ``comm.device``; returns
        ``self.params``."""
        self._check_len(params_list, "param sets")
        for i, tree in enumerate(params_list):
            if not self.owns(i):
                continue
            if tree is None:
                raise ValueError(f"{self.components[i].name}: no "
                                 "parameters for a component this rank owns")
            tree = pytree.tree_map(
                lambda a: nn.Parameter(torch.as_tensor(
                    np.asarray(a) if not torch.is_tensor(a) else a.detach()
                ).to(self.comm.device)), tree)
            self._holders[str(i)] = nn.ParameterList(
                pytree.tree_leaves(tree))
            self.params[i] = tree
        return self.params

    def grads(self) -> List[Any]:
        """The ``.grad`` trees of the owned components' parameters."""
        return [None if p is None else pytree.tree_map(lambda t: t.grad, p)
                for p in self.params]

    def _check_len(self, items, what):
        if len(items) != len(self.components):
            raise ValueError(f"got {len(items)} {what} for "
                             f"{len(self.components)} components")

    def _check_channels(self) -> None:
        """The JAX package's trace-time bookkeeping: every rank checks
        the whole graph before any transfer, so all raise alike."""
        pending = collections.Counter()
        for comp in self.components:
            for src in comp.rank_in or ():
                if not pending[(src, comp.owner)]:
                    raise ValueError(
                        f"{comp.name}: no pending message from rank "
                        f"{src} to {comp.owner} — check rank_in/"
                        f"rank_out pairing and declaration order")
                pending[(src, comp.owner)] -= 1
            for dst in comp.rank_out or ():
                pending[(comp.owner, dst)] += 1
        leftover = {k: v for k, v in pending.items() if v}
        if leftover:
            raise ValueError(f"unconsumed messages on channels {leftover}")

    def _anchor(self, params_list):
        """The token's start: a zero tied to one owned parameter, so
        that a backward restricted to the parameters
        (``torch.autograd.grad``) still runs every transfer."""
        for p in params_list:
            for leaf in pytree.tree_leaves(p):
                if torch.is_tensor(leaf) and leaf.requires_grad \
                        and leaf.numel():
                    return leaf.reshape(-1)[:1].sum().float() * 0.0
        return torch.zeros((), device=self.comm.device,
                           requires_grad=torch.is_grad_enabled())

    def _meta(self, metas, fresh: bool, mine, peer: int, name: str):
        """The ``(shape, dtype)`` of the next cross-rank message: posted
        to or taken from ``peer`` on a ``fresh`` forward (``mine`` is
        the sender's, None on the receiver), read back later."""
        if fresh:
            if mine is None:
                meta = self.comm.recv_obj(peer)
            else:
                meta = mine
                self.comm.send_obj(mine, peer)
            metas.append(meta)
            return meta
        meta = next(metas)
        if mine is not None and mine != meta:
            raise ValueError(
                f"{name}: output {mine} where an earlier forward with the "
                f"same shape of x sent {meta}; a component's output shape "
                f"must follow from the shape of x")
        return meta

    def _transfer(self, y, token, src: int, dst: int, metas, fresh, name):
        me = self.comm.rank
        like = None
        if src != dst:
            mine = (tuple(y.shape), y.dtype) if me == src else None
            like = self._meta(metas, fresh, mine, dst if me == src else src,
                              name)
            if me == src:
                like = ((0,), y.dtype)    # a sender keeps no zeros
        return _permute(y if me == src else None, self.comm, [(src, dst)],
                        token=token, like=like)

    def apply(self, params_list: Sequence[Any], x):
        """Run the graph on this rank.  With ``broadcast_output`` every
        rank returns the last component's output; without it, its owner
        returns it and every other rank zeros of its shape, tied to this
        rank's transfers."""
        self._check_len(params_list, "param sets")
        self._check_channels()
        comm, me = self.comm, self.comm.rank
        key = (tuple(x.shape), x.dtype) if torch.is_tensor(x) else None
        fresh = key not in self._metas
        metas = [] if fresh else iter(self._metas[key])
        token = self._anchor(params_list)
        channels = collections.defaultdict(collections.deque)
        out = None
        for comp, p in zip(self.components, params_list):
            y = None
            if comp.owner == me:
                inputs = [x] if comp.rank_in is None else [
                    channels[(src, me)].popleft() for src in comp.rank_in]
                y = out = comp.apply(p, *inputs)
            for dst in comp.rank_out or ():
                if me in (comp.owner, dst):
                    got, token = self._transfer(y, token, comp.owner, dst,
                                                metas, fresh, comp.name)
                    if dst == me:
                        channels[(comp.owner, me)].append(got)
        final = self.components[-1].owner
        mine = (tuple(out.shape), out.dtype) if me == final else None
        if fresh:
            meta = comm.bcast_obj(mine, root=final)
            self._metas[key] = metas + [meta]
        else:
            meta = self._meta(metas, False, mine, final,
                              self.components[-1].name)
        if me != final:
            out = torch.zeros(meta[0], dtype=meta[1], device=comm.device)
        out = pseudo_connect(token, out)
        if self.broadcast_output:
            out = bcast(out, comm, root=final)
        return out

    def forward(self, x):
        return self.apply(self.params, x)

    def reduce_grads(self, grads_list):
        """The JAX package's gradients of the owned components.

        - ``broadcast_output=True``: every rank back-propagates its copy
          of the same loss, so the owner receives the sum of
          ``comm.size`` identical cotangents; their mean (the JAX
          package's ``pmean``) is the gradient of the one loss.
        - ``broadcast_output=False``: only the final owner's loss is
          non-zero, and the owner's gradient is already the JAX
          package's ``psum`` of it and the other ranks' zeros.

        Entries of components this rank does not own stay None: the
        rank holds no copy of their parameters.
        """
        self._check_len(grads_list, "gradient sets")
        n = self.comm.size
        return [None if g is None
                else pytree.tree_map(lambda t: t / n, g)
                if self.broadcast_output else g
                for g in grads_list]
