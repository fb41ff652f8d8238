"""FSDP / ZeRO-3 for any parameter tree over a data communicator (the
JAX package's ``parallel/fsdp.py``).

A leaf lives at rest as this rank's slice of one dim (:func:`fsdp_dims`
picks it, :func:`fsdp_shard` cuts it) and is all-gathered just before
use (:func:`fsdp_gather`).  The gather is
:func:`~chainermn_tpu_torch.ops.collectives.allgather`, an autograd
Function whose backward is the reduce-scatter, so each leaf's gradient
leaves the backward already summed over the data group and cut to this
rank's slice: ZeRO's gradient reduce-scatter falls out of autograd.
An optimizer made over the shards (``opt.init(shards)``) keeps its
moments at shard width too.

The JAX ``fsdp_specs`` builds ``PartitionSpec``s for ``device_put``;
the port works per rank, so its counterpart :func:`fsdp_shard` cuts
rank ``r``'s slice, and the dims other axes already claim come in as
a tree of claimed dims (``taken``) where JAX reads the specs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch.ops.collectives import allgather
from chainermn_tpu_torch.ops.fused import _wire_dtype_for

__all__ = ["fsdp_dims", "fsdp_gather", "fsdp_shard"]


def _claimed(taken) -> tuple:
    """A leaf's claimed dims: ``None`` (none), an int, or a sequence."""
    if taken is None:
        return ()
    if isinstance(taken, int):
        return (taken,)
    return tuple(taken)


def _leaves_up_to(params, tree):
    """``tree``'s entries matched leaf for leaf with ``params`` (``tree``
    has ``params``' structure with ``None``, ints or tuples at its
    leaves)."""
    return pytree.tree_structure(params).flatten_up_to(tree)


def fsdp_dims(params, axis_size: int, taken=None, min_size: int = 2):
    """Choose, per leaf, the dim FSDP shards over the data axis.

    Returns a tree of ``Optional[int]`` in ``params``' structure: the
    LARGEST dim whose length the axis size divides (ties: the first), or
    ``None`` when no dim fits or every candidate is shorter than
    ``min_size * axis_size`` (sharding a tiny vector buys nothing and
    costs a collective).  ``taken`` (a tree of ``params``' structure
    whose leaves are ``None``, a dim or a tuple of dims) marks the dims
    another axis (model, expert) already shards, which are skipped so
    the layouts compose."""
    leaves, spec = pytree.tree_flatten(params)
    claims = [None] * len(leaves) if taken is None \
        else _leaves_up_to(params, taken)

    def pick(leaf, claim) -> Optional[int]:
        shape = tuple(leaf.shape)
        skip = set(_claimed(claim))
        best = None
        for d, n in enumerate(shape):
            if d in skip or n % axis_size or n < min_size * axis_size:
                continue
            if best is None or n > shape[best]:
                best = d
        return best

    return pytree.tree_unflatten(
        [pick(leaf, c) for leaf, c in zip(leaves, claims)], spec)


def fsdp_shard(params, dims, rank: int, size: int, taken=None):
    """Rank ``rank``'s at-rest slice of every leaf (of ``size`` ranks):
    the block ``rank`` of its dim in ``dims``, a tensor of its own; a
    leaf whose dim is ``None`` is kept whole.  A dim ``taken`` already
    claims raises with the JAX ``fsdp_specs`` message."""
    leaves, spec = pytree.tree_flatten(params)
    dim_list = _leaves_up_to(params, dims)
    claims = [None] * len(leaves) if taken is None \
        else _leaves_up_to(params, taken)
    out = []
    for leaf, d, claim in zip(leaves, dim_list, claims):
        if d is None:
            out.append(leaf)
            continue
        if d in _claimed(claim):
            raise ValueError(
                f"fsdp dim {d} already sharded as {claim}; pass this "
                "claim to fsdp_dims so it picks a free dim")
        if leaf.shape[d] % size:
            raise ValueError(
                f"fsdp dim {d} of {tuple(leaf.shape)} does not divide "
                f"over {size} ranks")
        out.append(leaf.detach().chunk(size, dim=d)[rank].clone())
    return pytree.tree_unflatten(out, spec)


def fsdp_gather(params, dims, comm, wire_dtype=None, *, plan=None):
    """All-gather the FSDP-sharded leaves over ``comm`` (the data
    communicator) back to full width, just before they are used.  The
    gradient reduce-scatters through the gather's backward.

    ``wire_dtype`` (e.g. ``torch.bfloat16``) casts before the gather
    and back after it, inside autograd, so the backward's reduce-scatter
    also runs in it (the cast's backward converts the gradient to
    ``wire_dtype`` before the scatter and back after); the forward and
    backward compute see the parameters' own dtype.  Non-float leaves
    are exempt: rounding an int through bf16 corrupts it.  An empty leaf
    gathers to zeros of the full shape; over one member a leaf is its
    own gather (the wire's casts still apply).  ``plan`` (the collective-plan
    IR's lowering) is not ported and raises."""
    if plan is not None:
        raise NotImplementedError(
            "fsdp_gather(plan=...) is not ported to chainermn_tpu_torch "
            "yet: the collective-plan IR comes with ROADMAP Queue A "
            "item 10")
    if isinstance(wire_dtype, str):
        wire_dtype = getattr(torch, wire_dtype)

    def gather(leaf, dim):
        if dim is None:
            return leaf
        if leaf.numel() == 0:
            shape = list(leaf.shape)
            shape[dim] *= comm.size
            return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
        orig = leaf.dtype
        eff = orig if wire_dtype is None \
            else _wire_dtype_for(orig, wire_dtype)
        x = leaf.to(eff) if eff != orig else leaf
        # over one member the gather is the identity: the leaf itself
        # (a copy would move the weights to another address, and a
        # product's kernel may round otherwise there)
        out = x if comm.size == 1 else allgather(x, comm, axis=dim,
                                                 tiled=True)
        return out.to(orig) if eff != orig else out

    leaves, spec = pytree.tree_flatten(params)
    dim_list = _leaves_up_to(params, dims)
    fsdp_gather.gathers += sum(d is not None for d in dim_list)
    return pytree.tree_unflatten(
        [gather(leaf, d) for leaf, d in zip(leaves, dim_list)], spec)


# the gathers issued (one a sharded leaf a call), forward and remat's
# recompute alike; set to 0 before a run and read after: every member
# of a data group must count the same
fsdp_gather.gathers = 0
