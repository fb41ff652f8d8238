"""Communicator protocol — ChainerMN's ``CommunicatorBase`` for the
port (the JAX package's ``communicators/base.py``).

Process model: one process drives one GPU, which is ChainerMN's own
model (``mpiexec`` then, ``torchrun`` now).  The JAX package runs one
controller per host over *world-stacked* arrays, whose leading axis
holds one slice per rank.  Here every tensor is **per rank**: rank
``r``'s argument is what the JAX package holds at ``x_stacked[r]``, and
rank ``r``'s result is the JAX result's ``[r]``.  So the JAX package's
``local()`` has no counterpart.

``rank``/``size`` index the processes of this communicator;
``intra_rank`` is the process's index among the members on its node
(``LOCAL_RANK`` under ``torchrun``), ``inter_rank``/``inter_size`` the
node's index and the number of nodes.
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Sequence


class CommunicatorBase(abc.ABC):
    """Abstract communicator with ChainerMN's collective surface over
    per-rank tensors.  Array collectives are issued on every rank with
    this rank's tensor and return this rank's result."""

    # ------------------------------------------------------------------ #
    # topology
    # ------------------------------------------------------------------ #

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of ranks (processes) in this communicator."""

    @property
    @abc.abstractmethod
    def rank(self) -> int:
        """This process's rank in this communicator."""

    @property
    @abc.abstractmethod
    def intra_rank(self) -> int:
        """This process's index among the members on its node — the
        device-placement contract (ChainerMN picked the GPU with it)."""

    @property
    @abc.abstractmethod
    def inter_rank(self) -> int:
        """Index of this process's node."""

    @property
    @abc.abstractmethod
    def inter_size(self) -> int:
        """Number of nodes."""

    @property
    @abc.abstractmethod
    def device(self):
        """The ``torch.device`` tensor collectives run on."""

    @abc.abstractmethod
    def split(self, color: int, key: int) -> "CommunicatorBase":
        """New communicator over the ranks that pass the same ``color``,
        ranked by ``key`` (MPI_Comm_split: every rank calls it with its
        own pair)."""

    def hierarchy(self):
        """``(intra, inter)``: the communicator of this rank's node
        (ranked by ``intra_rank``) and that of the ranks with its
        ``intra_rank`` on every node (ranked by ``inter_rank``), the two
        stages of :func:`~chainermn_tpu_torch.ops.hierarchical_allreduce`.
        Built once, by two ``split`` calls every rank makes together.
        Every node must hold as many ranks (the JAX package's mesh is a
        rectangle); otherwise every rank raises ``ValueError``."""
        if getattr(self, "_hierarchy", None) is None:
            nodes = self.allgather_obj(self.inter_rank)
            sizes = [nodes.count(n) for n in sorted(set(nodes))]
            if len(set(sizes)) != 1:
                raise ValueError(
                    f"hierarchy() needs as many ranks on every node; the "
                    f"nodes hold {sizes}: reduce over the flat "
                    f"communicator instead")
            intra = self.split(self.inter_rank, self.intra_rank)
            inter = self.split(self.intra_rank, self.inter_rank)
            self._hierarchy = (intra, inter)
        return self._hierarchy

    # ------------------------------------------------------------------ #
    # per-rank array collectives
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def bcast(self, x, root: int = 0):
        """Every rank gets ``root``'s ``x``."""

    @abc.abstractmethod
    def allreduce(self, x, op: str = "sum"):
        """Elementwise ``op`` (sum, mean, max, min, prod) over ranks."""

    @abc.abstractmethod
    def allgather(self, x):
        """Every rank gets ``(size, ...)``: row ``j`` is rank ``j``'s
        ``x``."""

    @abc.abstractmethod
    def alltoall(self, x):
        """``x`` is ``(size, ...)``: row ``j`` goes to rank ``j``; row
        ``i`` of the result came from rank ``i``."""

    @abc.abstractmethod
    def gather(self, x, root: int = 0):
        """The stack ``(size, ...)`` of every rank's ``x``.  As in the
        JAX package it is computed on every rank; ``root`` is
        advisory."""

    @abc.abstractmethod
    def scatter(self, x, root: int = 0):
        """Rank ``i`` gets row ``i`` of ``root``'s ``(size, ...)``
        ``x``."""

    @abc.abstractmethod
    def reduce_scatter(self, x):
        """``x`` is ``(size, ...)``: rank ``i`` gets the sum over ranks
        of row ``i``."""

    @abc.abstractmethod
    def send(self, x, dest: int, source: int):
        """Move ``source``'s ``x`` to ``dest`` (the JAX package's
        ``ppermute`` of one pair): ``dest`` returns it, every other rank
        returns zeros of ``x``'s shape."""

    @abc.abstractmethod
    def permute(self, x, perm, recv=None):
        """The JAX package's ``ppermute`` of ``perm``, ``[(source, dest),
        ...]`` (each rank at most once a source and once a dest): this
        rank sends ``x`` to its dest and returns what its source sent,
        or zeros where it has none.  ``x`` may be None on a rank that
        sends nothing; ``recv``, a tensor of the message's shape and
        dtype, is then what it receives into.  Not differentiable
        (:mod:`chainermn_tpu_torch.ops.point_to_point` is)."""

    # ------------------------------------------------------------------ #
    # object (control-plane) collectives
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def bcast_obj(self, obj: Any, root: int = 0) -> Any: ...

    @abc.abstractmethod
    def gather_obj(self, obj: Any, root: int = 0) -> Optional[Sequence[Any]]:
        """``root`` gets every rank's object in rank order; the others
        get ``None``."""

    @abc.abstractmethod
    def allgather_obj(self, obj: Any) -> Sequence[Any]: ...

    @abc.abstractmethod
    def allreduce_obj(self, obj: Any, op: str = "sum") -> Any: ...

    @abc.abstractmethod
    def scatter_obj(self, objs: Optional[Sequence[Any]], root: int = 0) -> Any: ...

    @abc.abstractmethod
    def alltoall_obj(self, objs: Sequence[Any]) -> Sequence[Any]:
        """``objs[j]`` goes to rank ``j``; returns what every rank sent
        this one, in rank order (the member order of
        :meth:`allgather_obj`, which ``shuffle_data_blocks`` relies
        on)."""

    @abc.abstractmethod
    def send_obj(self, obj: Any, dest: int) -> None: ...

    @abc.abstractmethod
    def recv_obj(self, source: int) -> Any: ...

    @abc.abstractmethod
    def barrier(self) -> None: ...

    # ------------------------------------------------------------------ #
    # model/training helpers (ChainerMN: bcast_data, multi_node_mean_grad)
    # ------------------------------------------------------------------ #

    @abc.abstractmethod
    def bcast_data(self, params, root: int = 0):
        """Broadcast a tree of tensors from ``root`` in place, so every
        rank holds the same values (ChainerMN's first-update weight
        sync); returns ``params``."""

    @abc.abstractmethod
    def multi_node_mean_grad(self, grads, dtype=None, fused: bool = True,
                             bucket_bytes=None, plan=None):
        """Mean a tree of gradient tensors across ranks; returns a new
        tree.

        ``dtype`` is ``allreduce_grad_dtype``: the gradients are cast to
        it for the wire and back after (ChainerMN's fp16 all-reduce; use
        ``torch.bfloat16``).  ``fused`` (the default) packs the tree
        into dtype-grouped flat buckets of ``bucket_bytes`` and issues
        one all-reduce per bucket (:func:`~chainermn_tpu_torch.ops.fused_allreduce`);
        ``fused=False`` issues one per leaf.  When the world spans
        several nodes with as many ranks each, the fused exchange is the
        two-stage one over :meth:`hierarchy` (the JAX package's
        ``tpu_xla`` does the same when its world factors over hosts).
        ``plan`` (a tuned exchange) is not ported and raises."""

    # alias, ChainerMN kept both names
    def allreduce_grad(self, grads, dtype=None, fused: bool = True,
                       bucket_bytes=None, plan=None):
        return self.multi_node_mean_grad(grads, dtype, fused=fused,
                                         bucket_bytes=bucket_bytes,
                                         plan=plan)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<{type(self).__name__} size={self.size} rank={self.rank} "
                f"device={self.device}>")


def check_perm(perm, size: int):
    """``perm`` as a list of ``(source, dest)`` pairs of ranks below
    ``size``, each rank at most once a source and once a dest."""
    perm = [(int(s), int(d)) for s, d in perm]
    for what, ranks in (("source", [s for s, _ in perm]),
                        ("dest", [d for _, d in perm])):
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"perm {perm} names a {what} twice")
        if any(not 0 <= r < size for r in ranks):
            raise ValueError(f"perm {perm} names a rank outside "
                             f"0..{size - 1}")
    return perm


def tree_reduce(objs, op: str):
    """Reduce a list of (possibly nested dict/list/tuple) scalar
    objects — what ``allreduce_obj`` applies to the gathered list."""
    first = objs[0]
    if isinstance(first, dict):
        return {k: tree_reduce([o[k] for o in objs], op) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_reduce([o[i] for o in objs], op)
                           for i in range(len(first)))
    if op == "sum":
        out = objs[0]
        for o in objs[1:]:
            out = out + o
        return out
    if op == "mean":
        return tree_reduce(objs, "sum") / len(objs)
    if op == "max":
        return max(objs)
    if op == "min":
        return min(objs)
    raise ValueError(f"unsupported op {op!r} for object allreduce")
