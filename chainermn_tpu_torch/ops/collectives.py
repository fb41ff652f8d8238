"""Differentiable collectives over a communicator (the JAX package's
``ops/collectives.py``; ChainerMN's collective ``FunctionNode``\\ s).

Each is a ``torch.autograd.Function`` whose backward runs the reverse
collective, the transposes JAX's ``lax`` collectives carry:

- ``psum`` / ``pmean``: backward is ``psum`` / ``pmean`` of the output
  gradients (every rank's output depends on every rank's input);
- ``allgather``: backward is ``reduce_scatter``, and the reverse;
- ``alltoall``: backward is the ``alltoall`` with the axes swapped;
- ``bcast``: the root gets the sum of every rank's output gradient, the
  others zero; ``gather``: every rank gets its slice of the root's
  output gradient; ``scatter``: the root gets every rank's output
  gradient stacked, the others zero.

They take a communicator where the JAX functions take a mesh axis
name; tensors are per rank.  ``allreduce`` with ``max`` or ``min`` is
forward only.  The point-to-point transfers are in
``ops/point_to_point.py``.
"""

from __future__ import annotations

import torch

__all__ = [
    "allgather", "allreduce", "alltoall", "bcast", "gather", "pmean",
    "psum", "reduce_scatter", "scatter",
]


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, mean):
        ctx.comm, ctx.mean = comm, mean
        return comm.allreduce(x, "mean" if mean else "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g.contiguous(),
                                  "mean" if ctx.mean else "sum"), None, None


def psum(x, comm):
    """Sum over ranks."""
    return _Sum.apply(x, comm, False)


def pmean(x, comm):
    """Mean over ranks — what synchronised batch normalisation reduces
    its moments with."""
    return _Sum.apply(x, comm, True)


def allreduce(x, comm, op: str = "sum"):
    """ChainerMN-parity all-reduce; ``op`` in {sum, mean, max, min}.
    ``max`` and ``min`` carry no gradient."""
    if op in ("sum", "mean"):
        return _Sum.apply(x, comm, op == "mean")
    if op in ("max", "min"):
        with torch.no_grad():
            return comm.allreduce(x, op)
    raise ValueError(f"unsupported allreduce op {op!r}")


def _to_front(x, axis):
    return x.movedim(axis, 0).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, tiled):
        ctx.comm, ctx.axis, ctx.tiled = comm, axis, tiled
        ctx.n = x.shape[axis] if tiled else None
        full = comm.allgather(x.contiguous())            # (size, ...)
        if tiled:
            return torch.cat(list(full.unbind(0)), dim=axis)
        return full.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        comm, axis = ctx.comm, ctx.axis
        if ctx.tiled:
            g = torch.stack(g.split(ctx.n, dim=axis))    # (size, ...)
        else:
            g = _to_front(g, axis)
        return comm.reduce_scatter(g.contiguous()), None, None, None


def allgather(x, comm, axis: int = 0, tiled: bool = False):
    """Every rank's ``x`` on every rank: stacked on a new ``axis``, or
    concatenated along it when ``tiled``.  Backward: reduce-scatter."""
    return _AllGather.apply(x, comm, axis, tiled)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tiled):
        ctx.comm, ctx.dim, ctx.tiled = comm, dim, tiled
        if tiled:
            if x.shape[dim] % comm.size:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {comm.size} ranks")
            x = torch.stack(x.chunk(comm.size, dim=dim))
        else:
            x = _to_front(x, dim)
        return comm.reduce_scatter(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        full = ctx.comm.allgather(g.contiguous())
        out = torch.cat(list(full.unbind(0)), dim=ctx.dim) if ctx.tiled \
            else full.movedim(0, ctx.dim)
        return out, None, None, None


def reduce_scatter(x, comm, scatter_dimension: int = 0, tiled: bool = True):
    """Sum over ranks, then rank ``r`` keeps slice ``r`` of
    ``scatter_dimension`` (a chunk when ``tiled``).  Backward:
    all-gather."""
    return _ReduceScatter.apply(x, comm, scatter_dimension, tiled)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return _alltoall(x, comm, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_alltoall(g, ctx.comm, concat_axis, split_axis), None,
                None, None)


def _alltoall(x, comm, split_axis, concat_axis):
    n = comm.size
    if x.shape[split_axis] != n:
        raise ValueError(f"alltoall needs split_axis {split_axis} of "
                         f"{tuple(x.shape)} to have the world size {n}")
    got = comm.alltoall(x.movedim(split_axis, 0).contiguous())
    return got.movedim(0, concat_axis)


def alltoall(x, comm, split_axis: int = 0, concat_axis: int = 0):
    """``lax.all_to_all`` (not tiled): ``split_axis`` has the world
    size; its index ``j`` goes to rank ``j``, and what rank ``i`` sent
    lands at index ``i`` of a new axis at ``concat_axis`` of the result
    (``split_axis`` removed).  Its own transpose, the axes swapped."""
    return _AllToAll.apply(x, comm, split_axis, concat_axis)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x.contiguous(), root)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.allreduce(g.contiguous(), "sum")
        return (total if ctx.comm.rank == ctx.root
                else torch.zeros_like(total)), None, None


def bcast(x, comm, root: int = 0):
    """Every rank returns ``root``'s ``x``.  Backward: the root gets the
    sum of every rank's output gradient, the others zero."""
    return _Bcast.apply(x, comm, root)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root, axis):
        ctx.comm, ctx.root, ctx.axis = comm, root, axis
        full = comm.allgather(x.contiguous()).movedim(0, axis)
        return full if comm.rank == root else torch.zeros_like(full)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.scatter(_to_front(g, ctx.axis), ctx.root), None,
                None, None)


def gather(x, comm, root: int = 0, axis: int = 0):
    """``root`` gets every rank's ``x`` stacked on a new ``axis``; the
    other ranks get zeros of that shape (the JAX package's contract).
    Backward: every rank gets its slice of the root's output
    gradient."""
    return _Gather.apply(x, comm, root, axis)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, root, axis):
        ctx.comm, ctx.root, ctx.axis = comm, root, axis
        return comm.scatter(_to_front(x, axis), root)

    @staticmethod
    def backward(ctx, g):
        full = ctx.comm.allgather(g.contiguous()).movedim(0, ctx.axis)
        return (full if ctx.comm.rank == ctx.root
                else torch.zeros_like(full)), None, None, None


def scatter(x, comm, root: int = 0, axis: int = 0):
    """Rank ``i`` returns slice ``i`` (along ``axis``) of ``root``'s
    ``x``.  Backward: the root gets every rank's output gradient
    stacked along ``axis``, the others zero."""
    return _Scatter.apply(x, comm, root, axis)
