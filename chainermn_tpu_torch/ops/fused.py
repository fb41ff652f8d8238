"""Fused bucketed gradient all-reduce (the JAX package's ``ops/fused.py``):
ChainerMN's ``batched_copy`` arena for ``torch.distributed``.

- **flatten**: the gradient tree is flattened and grouped by dtype
  (mixed fp32/bf16 trees never share a buffer);
- **bucket**: leaves of at least ``ceil(bucket_bytes / itemsize)``
  wire elements become *direct* buckets, one all-reduce on the leaf
  itself; the small remainder is copied into one flat arena split at
  exact ``bucket_bytes`` boundaries (the last bucket ragged, leaves
  straddling bucket edges).  Within a dtype group direct buckets come
  before arena buckets; zero-size leaves ride the spec only;
- **compress**: with ``wire_dtype`` (bf16) float buckets cross the wire
  in it and every leaf is cast back to its own dtype on unpack.
  Integer and bool leaves never take a float wire dtype.

The bucket boundaries and :class:`FusedSpec` groups equal the JAX
package's for the same ordered list of leaves.  A dtype group emits at
most ``ceil(group_bytes / bucket_bytes)`` all-reduces, so a tree emits
at most :func:`fused_collective_budget` of them.

Not ported, each raising: ``hierarchical_allreduce`` (NCCL picks its
own ring or tree on one node), ``overlap_exchange`` and
``plan_allreduce`` (ROADMAP Queue A items 2 and 10).
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

__all__ = [
    "DEFAULT_BUCKET_BYTES",
    "FusedSpec",
    "flatten_buckets",
    "fused_allreduce",
    "fused_collective_budget",
    "hierarchical_allreduce",
    "overlap_exchange",
    "plan_allreduce",
    "unflatten_buckets",
]

# 4 MiB: large enough that an all-reduce's latency is small against its
# wire time, small enough to keep the arena copies short
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


class FusedSpec(NamedTuple):
    """Static unpack plan made by :func:`flatten_buckets`.

    For each ``(wire_dtype, direct_members, arena_members,
    n_arena_buckets)`` group, ``len(direct_members)`` single-leaf
    buckets are followed by ``n_arena_buckets`` arena slices whose
    concatenation unpacks to ``arena_members`` in order.  Members are
    ``(leaf_index, shape, dtype)``; ``treedef`` rebuilds the tree;
    ``empties`` are the zero-size leaves (never packed)."""

    treedef: Any
    groups: Tuple[Tuple[torch.dtype,
                        Tuple[Tuple[int, Tuple[int, ...], torch.dtype], ...],
                        Tuple[Tuple[int, Tuple[int, ...], torch.dtype], ...],
                        int], ...]
    empties: Tuple[Tuple[int, Tuple[int, ...], torch.dtype], ...]
    n_leaves: int


def fused_collective_budget(total_bytes: int, bucket_bytes: int,
                            n_dtype_groups: int = 1) -> int:
    """Most all-reduces the fused exchange may issue for ``total_bytes``
    of wire traffic in ``n_dtype_groups`` dtype groups: each group emits
    ``ceil(group_bytes / bucket)``, and splitting ``total_bytes`` over
    ``g`` groups adds at most ``g - 1`` ragged buckets (the port's copy
    of the JAX package's ``utils/comm_model.py``)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes {bucket_bytes} must be positive")
    return -(-int(total_bytes) // int(bucket_bytes)) \
        + max(0, n_dtype_groups - 1)


def _bucket_elems(bucket_bytes: int, itemsize: int) -> int:
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes {bucket_bytes} must be positive")
    # ceil: a direct leaf really carries a full bucket's bytes, and the
    # arena splits into at most ceil(arena_bytes / bucket_bytes) slices
    return -(-bucket_bytes // itemsize)


def _wire_dtype_for(dtype: torch.dtype, wire_dtype) -> torch.dtype:
    """The dtype a leaf crosses the wire in: compression applies to
    float leaves under a float wire dtype only; an int32 or bool round
    tripped through bf16's 8 mantissa bits would be corrupted."""
    if wire_dtype is not None and dtype.is_floating_point \
            and wire_dtype.is_floating_point:
        return wire_dtype
    return dtype


def flatten_buckets(
    grads,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    wire_dtype: Optional[torch.dtype] = None,
) -> Tuple[List[torch.Tensor], FusedSpec]:
    """Pack a gradient tree into dtype-grouped 1-D buckets in the wire
    dtype; returns ``(buckets, spec)``.  A direct bucket is a view of
    its leaf when no cast is needed; the arena is one new tensor that
    every small leaf is copied (and cast) into, its buckets views of
    it."""
    leaves, treedef = pytree.tree_flatten(grads)

    def member(i):
        return (i, tuple(leaves[i].shape), leaves[i].dtype)

    by_dtype: dict = {}
    empties = []
    for i, leaf in enumerate(leaves):
        if leaf.numel() == 0:
            empties.append(member(i))
        else:
            by_dtype.setdefault(leaf.dtype, []).append(i)

    buckets: List[torch.Tensor] = []
    groups = []
    for dtype, idxs in by_dtype.items():
        wire = _wire_dtype_for(dtype, wire_dtype)
        per = _bucket_elems(bucket_bytes, wire.itemsize)
        direct = [i for i in idxs if leaves[i].numel() >= per]
        small = [i for i in idxs if leaves[i].numel() < per]
        buckets += [leaves[i].reshape(-1).to(wire) for i in direct]
        n_arena = 0
        if small:
            arena = torch.empty(sum(leaves[i].numel() for i in small),
                                dtype=wire, device=leaves[small[0]].device)
            off = 0
            for i in small:            # the pack: one copy (and cast) a leaf
                n = leaves[i].numel()
                arena[off:off + n].copy_(leaves[i].reshape(-1))
                off += n
            n_arena = -(-arena.numel() // per)
            buckets += [arena[b * per:(b + 1) * per] for b in range(n_arena)]
        groups.append((wire, tuple(member(i) for i in direct),
                       tuple(member(i) for i in small), n_arena))
    return buckets, FusedSpec(treedef, tuple(groups), tuple(empties),
                              len(leaves))


def unflatten_buckets(buckets: Sequence[torch.Tensor], spec: FusedSpec):
    """Invert :func:`flatten_buckets`: split the buckets into leaves,
    cast each back to its own dtype and rebuild the tree."""
    out: List[Optional[torch.Tensor]] = [None] * spec.n_leaves
    pos = 0

    def restore(flat, i, shape, dtype):
        out[i] = flat.reshape(shape).to(dtype)

    for _, direct, arena, n_arena in spec.groups:
        for i, shape, dtype in direct:
            restore(buckets[pos], i, shape, dtype)
            pos += 1
        if n_arena:
            chunk = buckets[pos] if n_arena == 1 else torch.cat(
                list(buckets[pos:pos + n_arena]))
            pos += n_arena
            off = 0
            for i, shape, dtype in arena:
                n = math.prod(shape)
                restore(chunk[off:off + n], i, shape, dtype)
                off += n
    for i, shape, dtype in spec.empties:
        out[i] = torch.zeros(shape, dtype=dtype, device=buckets[0].device
                             if buckets else None)
    return pytree.tree_unflatten(out, spec.treedef)


def fused_allreduce(
    grads,
    comm,
    op: str = "mean",
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    wire_dtype: Optional[torch.dtype] = None,
):
    """All-reduce a gradient tree over ``comm`` in fused flat buckets:
    one all-reduce per bucket instead of one per leaf.  ``op`` is
    ``"mean"`` (sum, then a divide in the wire dtype, as the JAX
    package's ``pmean``) or ``"sum"``.  A bucket that is a view of its
    leaf (no cast, a direct bucket) is reduced in place, so pass
    gradients the caller owns.  Returns a new tree in the leaves' own
    dtypes; at ``comm.size == 1`` the pack, the all-reduce and the
    unpack all still run, so the result is the leaves rounded through
    the wire dtype."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported fused allreduce op {op!r}")
    buckets, spec = flatten_buckets(grads, bucket_bytes, wire_dtype)
    if not buckets:
        return grads
    reduced = []
    for b in buckets:
        comm.allreduce_sum_(b)
        if op == "mean":
            # a float bucket divides in its wire dtype (pmean); an int or
            # bool one divides as the JAX package's pmean does (a float32
            # quotient), and the unpack casts it back
            b = b.div_(comm.size) if b.dtype.is_floating_point \
                else b / comm.size
        reduced.append(b)
    return unflatten_buckets(reduced, spec)


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to chainermn_tpu_torch yet (ROADMAP "
            f"Queue A item {item})")
    fn.__name__ = name
    fn.__doc__ = f"Not ported yet (ROADMAP Queue A item {item}); raises."
    return fn


hierarchical_allreduce = _not_ported("hierarchical_allreduce", 2)
overlap_exchange = _not_ported("overlap_exchange", 2)
plan_allreduce = _not_ported("plan_allreduce", 10)
