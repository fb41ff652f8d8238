"""Megatron-style dense layers over the model axis (the JAX package's
``parallel/tensor.py``).

A column→row pair keeps one all-reduce in the forward and one in the
backward:

    column: Y_k = f(X) · W1[:, k]          (no forward collective)
    row:    Z   = g(Σ_k Y_k · W2[k, :])    (one all-reduce)

``f`` is the identity forward and an all-reduce of the input's gradient
backward: ``x`` is the same on every member of the model communicator
and each member's product consumes it, so its gradient is the sum of
the members' partials (the psum shard_map's AD inserts because ``x`` is
model-invariant).  ``g`` is an all-reduce forward and the identity
backward (the transpose of a psum whose output is model-invariant).
The products go to ``torch.matmul`` (cuBLAS on the card), as the JAX
package leaves them to XLA.  With ``comm=None`` or a communicator of one
rank, both functions are the plain products.
"""

from __future__ import annotations

import torch

__all__ = ["column_parallel_dense", "row_parallel_dense"]


class _CopyToModel(torch.autograd.Function):
    """``f``: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g.contiguous(), "sum"), None


class _ReduceFromModel(torch.autograd.Function):
    """``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.allreduce(x.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _wide(comm) -> bool:
    return comm is not None and comm.size > 1


def copy_to_model(x, comm=None):
    """``f`` over ``comm``; ``x`` itself when it holds one rank."""
    return _CopyToModel.apply(x, comm) if _wide(comm) else x


def reduce_from_model(x, comm=None):
    """``g`` over ``comm``; ``x`` itself when it holds one rank."""
    return _ReduceFromModel.apply(x, comm) if _wide(comm) else x


def column_parallel_dense(x, w, b=None, comm=None):
    """``x (..., d_in)``, the same on every member of ``comm`` (the model
    communicator), times this member's column block ``w (d_in,
    d_out/M)`` (+ its bias shard ``b``): the feature-sharded ``(...,
    d_out/M)``."""
    y = copy_to_model(x, comm) @ w
    return y if b is None else y + b


def row_parallel_dense(x, w, b=None, comm=None):
    """The feature-sharded ``x (..., d_in/M)`` times this member's row
    block ``w (d_in/M, d_out)``, summed over ``comm`` (+ the full bias
    ``b``, once, after the sum): ``(..., d_out)``, the same on every
    member."""
    y = reduce_from_model(x @ w, comm)
    return y if b is None else y + b
