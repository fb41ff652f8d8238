"""``loopback`` communicator — a single-rank world with no process group
(the JAX package's ``communicators/loopback.py``).  Every collective is
an identity or a copy, so the whole training stack runs on one device
with no communication at all."""

from __future__ import annotations

import pickle
from typing import Any, Optional, Sequence

import torch

from chainermn_tpu_torch._device import resolve_device

from .base import CommunicatorBase, check_perm

_REDUCE_OPS = ("sum", "mean", "max", "min", "prod")


class LoopbackCommunicator(CommunicatorBase):
    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._queue: list = []
        self.n_collectives = 0      # none is ever issued
        self.store = None           # no world, no key-value store

    size = property(lambda self: 1)
    rank = property(lambda self: 0)
    intra_rank = property(lambda self: 0)
    inter_rank = property(lambda self: 0)
    inter_size = property(lambda self: 1)
    device = property(lambda self: self._device)

    def split(self, color: int, key: int) -> "LoopbackCommunicator":
        return self

    def _stacked(self, x, what):
        if x.shape[:1] != (1,):
            raise ValueError(f"{what} needs a leading dim of size 1, got "
                             f"{tuple(x.shape)}")
        return x.clone()

    def bcast(self, x, root: int = 0):
        return x.clone()

    def allreduce_sum_(self, x):
        return x

    def allreduce(self, x, op: str = "sum"):
        if op not in _REDUCE_OPS:
            raise ValueError(f"op must be one of {_REDUCE_OPS}")
        # the mean of integers is a float, as in the JAX package's pmean
        return x / 1 if op == "mean" else x.clone()

    def allgather(self, x):
        return x[None].clone()

    def alltoall(self, x):
        return self._stacked(x, "alltoall")

    def gather(self, x, root: int = 0):
        return self.allgather(x)

    def scatter(self, x, root: int = 0):
        return self._stacked(x, "scatter")[0]

    def reduce_scatter(self, x):
        return self._stacked(x, "reduce_scatter")[0]

    def send(self, x, dest: int, source: int):
        return x.clone()

    def permute(self, x, perm, recv=None):
        check_perm(perm, 1)
        like = x if x is not None else recv
        return x.clone() if (0, 0) in perm else torch.zeros_like(like)

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        return obj

    def gather_obj(self, obj: Any, root: int = 0):
        return [obj]

    def allgather_obj(self, obj: Any) -> Sequence[Any]:
        return [obj]

    def allreduce_obj(self, obj: Any, op: str = "sum") -> Any:
        return obj

    def scatter_obj(self, objs: Optional[Sequence[Any]], root: int = 0) -> Any:
        return objs[0] if objs else None

    def alltoall_obj(self, objs: Sequence[Any]) -> Sequence[Any]:
        if len(objs) != 1:
            raise ValueError(f"alltoall_obj expects 1 send object at size "
                             f"1, got {len(objs)}")
        # a pickle round trip keeps loopback faithful to the transport
        return [pickle.loads(pickle.dumps(o)) for o in objs]

    def send_obj(self, obj: Any, dest: int) -> None:
        self._queue.append(pickle.dumps(obj))

    def recv_obj(self, source: int) -> Any:
        if not self._queue:
            raise RuntimeError("recv_obj: empty mailbox")
        return pickle.loads(self._queue.pop(0))

    def barrier(self) -> None:
        pass

    def bcast_data(self, params, root: int = 0):
        return params

    def multi_node_mean_grad(self, grads, dtype=None, fused=True,
                             bucket_bytes=None, plan=None):
        # a size-1 world: the mean is the identity, with no wire cast
        # (the JAX package's loopback does the same)
        if plan is not None:
            raise NotImplementedError(
                "multi_node_mean_grad(plan=...) is not ported "
                "(ROADMAP Queue A item 10)")
        return grads


__all__ = ["LoopbackCommunicator"]
