"""A ``torch.distributed`` communicator — the port of the JAX package's
``tpu_xla`` backend (ChainerMN's ``pure_nccl``).

Two process groups, ChainerMN's MPI-plus-NCCL split: tensor collectives
run on an NCCL group when the communicator's device is CUDA and on a
gloo group when it is the CPU; the ``*_obj`` collectives and
:meth:`barrier` run on a separate gloo group, so a pickle never stages
through CUDA memory.  A tensor on the wrong device raises; nothing
falls back from NCCL to gloo.

``multi_node_mean_grad`` takes the fused path of
:func:`~chainermn_tpu_torch.ops.fused_allreduce` (the JAX package's
``_fused_mean``), two-stage over :meth:`hierarchy` when the world spans
several nodes of as many ranks each (``communicators/tpu_xla.py:549-610``
of the JAX package); on one node it stays flat.  Not ported: ``plan=``
and its autotuner (ROADMAP Queue A item 10).

``n_collectives`` counts the tensor collectives this communicator
issued, so a caller can count the all-reduces of one gradient exchange.
``store`` is the world's key-value store when ``init_distributed``
started the world (the training watchdog's heartbeats go there), and
``_obj_channel`` a :class:`~chainermn_tpu_torch.communicators.
_obj_channel.KVObjectChannel` over it, the JAX communicators'
attribute, which an elastic membership fences to its epoch; the
``*_obj`` collectives stay on the communicator's own gloo group, new
for each communicator.  :meth:`close` destroys the two groups (the
default group excepted) once a live resize has moved off them.
"""

from __future__ import annotations

import pickle
import socket
from datetime import timedelta
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from chainermn_tpu_torch.ops import fused as _fused

from ._obj_channel import KVObjectChannel
from .base import CommunicatorBase, check_perm, tree_reduce

_REDUCE_OPS = ("sum", "mean", "max", "min", "prod")
DEFAULT_TIMEOUT = timedelta(minutes=5)


def _reduce_op(op):
    return {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "prod": dist.ReduceOp.PRODUCT}[op]


class TorchDistCommunicator(CommunicatorBase):
    """Collectives over the ranks of a ``torch.distributed`` group.

    Built by :func:`~chainermn_tpu_torch.communicators.create_communicator`
    (the world) or :meth:`split`; ``group`` and ``obj_group`` are this
    communicator's tensor and object groups, ``ranks`` their global
    ranks in communicator-rank order."""

    def __init__(self, group, obj_group, ranks: Sequence[int],
                 device: torch.device, grad_dtype=None,
                 timeout: timedelta = DEFAULT_TIMEOUT, store=None):
        self._group, self._obj_group = group, obj_group
        # the world's key-value store (init_distributed's rendezvous), or
        # None when the default group was started elsewhere
        self.store = store
        self._ranks = list(ranks)
        self._device = device
        self._grad_dtype = grad_dtype
        self._timeout = timeout
        self.n_collectives = 0
        self._rank = dist.get_rank(group)
        # the members name a group alike (it is their rendezvous), so
        # the name tags the channel's keys
        self._obj_channel = KVObjectChannel(
            tag=f"cmnobj/{getattr(obj_group, 'group_name', 'world')}",
            store=store)
        self.closed = False
        # node layout: every member's host, in rank order
        hosts = self.allgather_obj(socket.gethostname())
        nodes = sorted(set(hosts), key=hosts.index)
        mine = hosts[self._rank]
        self._intra_rank = hosts[:self._rank].count(mine)
        self._inter_rank = nodes.index(mine)
        self._inter_size = len(nodes)
        self._node_sizes = [hosts.count(h) for h in nodes]
        if device.type == "cuda":
            # NCCL starts a group's communicator at its first collective,
            # which every member must join; start it now, so that a later
            # batch of sends between some of the members (``permute``)
            # finds it started
            dist.all_reduce(torch.zeros(1, device=device), group=group)

    # -- topology ------------------------------------------------------ #

    size = property(lambda self: len(self._ranks))
    rank = property(lambda self: self._rank)
    intra_rank = property(lambda self: self._intra_rank)
    inter_rank = property(lambda self: self._inter_rank)
    inter_size = property(lambda self: self._inter_size)
    device = property(lambda self: self._device)

    def split(self, color: int, key: int) -> "TorchDistCommunicator":
        """MPI_Comm_split: every rank passes its own ``(color, key)``;
        the members of this rank's color are ranked by ``(key, rank)``.
        Only the members create the new groups."""
        pairs = self.allgather_obj((int(color), int(key)))
        members = sorted((r for r in range(self.size)
                          if pairs[r][0] == int(color)),
                         key=lambda r: (pairs[r][1], r))
        ranks = [self._ranks[r] for r in members]
        backend = "nccl" if self._device.type == "cuda" else "gloo"
        kw = dict(timeout=self._timeout, use_local_synchronization=True)
        if ranks != sorted(ranks):
            kw["sort_ranks"] = False      # keep the key order as ranks
        group = dist.new_group(ranks, backend=backend, **kw)
        obj_group = dist.new_group(ranks, backend="gloo", **kw)
        return TorchDistCommunicator(group, obj_group, ranks, self._device,
                                     self._grad_dtype, self._timeout,
                                     self.store)

    def close(self) -> None:
        """Destroy this communicator's groups — its tensor group (unless
        it is the default group) and its object group — and those of
        its :meth:`hierarchy`.  Every member calls it, after the last
        collective on them; a second call does nothing.  Without it
        every live resize would leave an NCCL communicator and its
        buffers behind."""
        if self.closed:
            return
        self.closed = True
        sub = getattr(self, "_hierarchy", None)
        if sub is not None:
            for c in sub:
                if c is not self:
                    c.close()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        for g in (self._group, self._obj_group):
            if g is not dist.group.WORLD:
                dist.destroy_process_group(g)

    # -- tensor collectives -------------------------------------------- #

    def _check(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_tensor(x):
            raise TypeError(f"expected a tensor, got {type(x).__name__}")
        if x.device.type != self._device.type:
            raise ValueError(
                f"tensor on {x.device} given to a communicator on "
                f"{self._device} ({'NCCL' if self._device.type == 'cuda' else 'gloo'}); "
                "move it there first")
        return x

    def _stacked(self, x, what):
        self._check(x)
        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"{what} needs a leading dim of {self.size}, "
                             f"got {tuple(x.shape)}")
        return x.contiguous()

    def _global(self, r: int) -> int:
        return self._ranks[r]

    def allreduce_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over ranks in place (a bool tensor: logical or).
        The one all-reduce of the gradient exchange."""
        self._check(x)
        self.n_collectives += 1
        if x.dtype == torch.bool:
            dist.all_reduce(x.view(torch.uint8), op=dist.ReduceOp.MAX,
                            group=self._group)
        else:
            dist.all_reduce(x, group=self._group)
        return x

    def bcast(self, x, root: int = 0):
        out = self._check(x).clone()
        self.n_collectives += 1
        dist.broadcast(out, src=self._global(root), group=self._group)
        return out

    def allreduce(self, x, op: str = "sum"):
        if op not in _REDUCE_OPS:
            raise ValueError(f"op must be one of {_REDUCE_OPS}")
        out = self._check(x).clone()
        self.n_collectives += 1
        dist.all_reduce(out, op=_reduce_op(op), group=self._group)
        # the mean of integers is a float, as in the JAX package's pmean
        return out / self.size if op == "mean" else out

    def allgather(self, x):
        x = self._check(x).contiguous()
        out = torch.empty(self.size * x.numel(), dtype=x.dtype,
                          device=x.device)
        self.n_collectives += 1
        # the flat form works on NCCL and gloo alike
        ag = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        ag(out, x.view(-1), group=self._group)
        return out.view(self.size, *x.shape)

    def alltoall(self, x):
        x = self._stacked(x, "alltoall")
        out = torch.empty_like(x)
        self.n_collectives += 1
        dist.all_to_all_single(out, x, group=self._group)
        return out

    def gather(self, x, root: int = 0):
        return self.allgather(x)

    def scatter(self, x, root: int = 0):
        x = self._stacked(x, "scatter")
        out = torch.empty_like(x[0])
        self.n_collectives += 1
        dist.scatter(out, list(x.unbind(0)) if self.rank == root else None,
                     src=self._global(root), group=self._group)
        return out

    def reduce_scatter(self, x):
        x = self._stacked(x, "reduce_scatter")
        out = torch.empty_like(x[0])
        self.n_collectives += 1
        # the flat form works on NCCL and gloo alike
        rs = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        rs(out.view(-1), x.view(-1), group=self._group)
        return out

    def send(self, x, dest: int, source: int):
        x = self._check(x)
        if source == dest:
            return x.clone() if self.rank == dest else torch.zeros_like(x)
        self.n_collectives += 1
        if self.rank == source:
            dist.send(x.contiguous(), dst=self._global(dest),
                      group=self._group)
        elif self.rank == dest:
            out = torch.empty_like(x)
            dist.recv(out, src=self._global(source), group=self._group)
            return out
        return torch.zeros_like(x)

    def permute(self, x, perm, recv=None):
        perm = check_perm(perm, self.size)
        me = self.rank
        dests = [d for s, d in perm if s == me]
        sources = [s for s, d in perm if d == me]
        if dests and x is None:
            raise ValueError(f"rank {me} sends in {perm} but has no tensor")
        like = recv if recv is not None else x
        if like is None:
            raise ValueError("permute needs x or recv for the result's "
                             "shape")
        self._check(like)
        if not sources:
            out = torch.zeros_like(like)
        elif sources == [me]:
            out = x.clone()
        else:
            out = torch.empty_like(like) if recv is None else recv
        ops = [dist.P2POp(dist.isend, x.contiguous(), self._global(d),
                          self._group) for d in dests if d != me]
        ops += [dist.P2POp(dist.irecv, out, self._global(s), self._group)
                for s in sources if s != me]
        if ops:
            self.n_collectives += 1
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    # -- object collectives (the gloo group) ----------------------------- #

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(root),
                                   group=self._obj_group)
        return box[0]

    def allgather_obj(self, obj: Any) -> Sequence[Any]:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._obj_group)
        return out

    def gather_obj(self, obj: Any, root: int = 0):
        out = [None] * self.size if self.rank == root else None
        dist.gather_object(obj, out, dst=self._global(root),
                           group=self._obj_group)
        return out

    def allreduce_obj(self, obj: Any, op: str = "sum") -> Any:
        return tree_reduce(self.allgather_obj(obj), op)

    def scatter_obj(self, objs, root: int = 0) -> Any:
        if self.rank == root and (objs is None or len(objs) != self.size):
            raise ValueError(f"scatter_obj needs {self.size} objects on "
                             f"the root")
        box = [None]
        dist.scatter_object_list(box, list(objs) if self.rank == root
                                 else None, src=self._global(root),
                                 group=self._obj_group)
        return box[0]

    def alltoall_obj(self, objs: Sequence[Any]) -> Sequence[Any]:
        """Pickles cross as bytes in one all-to-all of their lengths and
        one of their payloads (each rank holds only what it sends and
        receives)."""
        if len(objs) != self.size:
            raise ValueError(f"alltoall_obj expects {self.size} send "
                             f"objects (one per rank), got {len(objs)}")
        blobs = [pickle.dumps(o) for o in objs]
        lens = torch.tensor([len(b) for b in blobs], dtype=torch.int64)
        got = torch.empty_like(lens)
        dist.all_to_all_single(got, lens, group=self._obj_group)
        send = torch.frombuffer(bytearray(b"".join(blobs)),
                                dtype=torch.uint8) if sum(map(len, blobs)) \
            else torch.empty(0, dtype=torch.uint8)
        recv = torch.empty(int(got.sum()), dtype=torch.uint8)
        dist.all_to_all_single(recv, send, output_split_sizes=got.tolist(),
                               input_split_sizes=lens.tolist(),
                               group=self._obj_group)
        data, out, off = recv.numpy().tobytes(), [], 0
        for n in got.tolist():
            out.append(pickle.loads(data[off:off + n]))
            off += n
        return out

    def send_obj(self, obj: Any, dest: int) -> None:
        dist.send_object_list([obj], dst=self._global(dest),
                              group=self._obj_group)

    def recv_obj(self, source: int) -> Any:
        box = [None]
        dist.recv_object_list(box, src=self._global(source),
                              group=self._obj_group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self._obj_group)

    # -- model/training helpers ----------------------------------------- #

    def bcast_data(self, params, root: int = 0):
        with torch.no_grad():
            for leaf in pytree.tree_leaves(params):
                self._check(leaf)
                self.n_collectives += 1
                dist.broadcast(leaf.data, src=self._global(root),
                               group=self._group)
        return params

    def multi_node_mean_grad(self, grads, dtype=None, fused=True,
                             bucket_bytes=None, plan=None):
        if plan is not None:
            raise NotImplementedError(
                "multi_node_mean_grad(plan=...) is not ported: the "
                "measured exchange planner is ROADMAP Queue A item 10")
        dtype = dtype or self._grad_dtype
        if fused:
            comm, inter = self, None
            if self._inter_size > 1 and len(set(self._node_sizes)) == 1:
                comm, inter = self.hierarchy()
            return _fused.fused_allreduce(
                grads, comm, op="mean",
                bucket_bytes=bucket_bytes or _fused.DEFAULT_BUCKET_BYTES,
                wire_dtype=dtype, inter_comm=inter)
        def one(g):
            wire = dtype if dtype is not None \
                and g.dtype.is_floating_point else g.dtype
            w = g.to(wire, copy=True)
            self.allreduce_sum_(w)
            w = w.div_(self.size) if w.dtype.is_floating_point \
                else w / self.size
            return w.to(g.dtype)

        return pytree.tree_map(one, grads)


__all__ = ["DEFAULT_TIMEOUT", "TorchDistCommunicator"]
