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

The exchange's other forms (the JAX package's ``ops/fused.py:215-608``),
each reducing one flat bucket or a tree over communicators where the
JAX package names mesh axes:

- :func:`reduce_scatter_allgather`: the two halves of a ring all-reduce
  issued apart, the mean's divide on the 1/n shard;
- :func:`hierarchical_allreduce`: reduce-scatter over the ranks of a
  node, all-reduce over the nodes, all-gather over the node (two
  communicators made with ``comm.split``, see
  ``CommunicatorBase.hierarchy``);
- :func:`overlap_exchange` over a schedule of
  :func:`build_overlap_schedule`: reverse-leaf-ordered contiguous
  buckets, each exchanged as soon as its gradients exist.  Its
  :class:`OverlapExchange` is what the updater's backward hooks drive.

Every form sends an int or bool bucket through the plain all-reduce, so
such leaves come out exact.  Not ported: ``plan_allreduce`` (the
measured planner, ROADMAP Queue A item 10), which raises.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

__all__ = [
    "DEFAULT_BUCKET_BYTES",
    "FusedSpec",
    "OverlapExchange",
    "build_overlap_schedule",
    "flatten_buckets",
    "fused_allreduce",
    "fused_collective_budget",
    "hierarchical_allreduce",
    "overlap_exchange",
    "plan_allreduce",
    "reduce_scatter_allgather",
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


def _plain_reduce(b, comm, op):
    """All-reduce one bucket in place over ``comm``: a float bucket
    divides in its wire dtype (``pmean``); an int or bool one divides as
    the JAX package's ``pmean`` does (a float32 quotient), and the
    unpack casts it back."""
    comm.allreduce_sum_(b)
    if op == "sum":
        return b
    return b.div_(comm.size) if b.dtype.is_floating_point \
        else b / comm.size


def _check_bucket(x, op, what):
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported {what} op {op!r}")
    if x.dim() != 1:
        raise ValueError(f"{what} wants a flat bucket, got shape "
                         f"{tuple(x.shape)}")


def _shards(x, n):
    """``x`` zero-padded to a multiple of ``n``, as ``(n, len / n)``."""
    pad = -x.numel() % n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.contiguous().view(n, -1)


def reduce_scatter_allgather(x: torch.Tensor, comm,
                             op: str = "mean") -> torch.Tensor:
    """Reduce one flat bucket over ``comm`` as reduce-scatter then
    all-gather: the ring bytes of an all-reduce in two launches, the
    mean's divide on the 1/n shard (in the bucket's dtype).  An int or
    bool bucket goes through the plain all-reduce instead.  Returns a
    new tensor."""
    _check_bucket(x, op, "reduce_scatter")
    if not x.dtype.is_floating_point:
        return _plain_reduce(x.clone(), comm, op)
    n = comm.size
    shard = comm.reduce_scatter(_shards(x, n))
    if op == "mean":
        shard = shard.div_(n)
    return comm.allgather(shard).view(-1)[:x.numel()]


def hierarchical_allreduce(x: torch.Tensor, intra_comm, inter_comm,
                           op: str = "mean") -> torch.Tensor:
    """Two-stage all-reduce of one flat bucket: reduce-scatter over
    ``intra_comm`` (the ranks of a node), all-reduce of the shard over
    ``inter_comm`` (one rank a node), all-gather over ``intra_comm``.
    The slow inter-node links carry 1/k of the bucket (k the ranks a
    node); the mean's divide runs on the shard.  An int or bool bucket
    is summed over both communicators in full and divided once, so it
    agrees exactly with the flat all-reduce.  Returns a new tensor."""
    _check_bucket(x, op, "hierarchical")
    world = intra_comm.size * inter_comm.size
    if not x.dtype.is_floating_point:
        b = x.clone()
        intra_comm.allreduce_sum_(b)
        inter_comm.allreduce_sum_(b)
        if op == "sum":
            return b
        return b / world
    shard = intra_comm.reduce_scatter(_shards(x, intra_comm.size))
    inter_comm.allreduce_sum_(shard)
    if op == "mean":
        shard = shard.div_(world)
    return intra_comm.allgather(shard).view(-1)[:x.numel()]


def fused_allreduce(
    grads,
    comm,
    op: str = "mean",
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    wire_dtype: Optional[torch.dtype] = None,
    inter_comm=None,
):
    """All-reduce a gradient tree over ``comm`` in fused flat buckets:
    one all-reduce per bucket instead of one per leaf.  ``op`` is
    ``"mean"`` (sum, then a divide in the wire dtype, as the JAX
    package's ``pmean``) or ``"sum"``.  With ``inter_comm``, ``comm`` is
    the node's communicator and every bucket takes the two-stage
    :func:`hierarchical_allreduce`.  A bucket that is a view of its leaf
    (no cast, a direct bucket) is reduced in place on the flat path, so
    pass gradients the caller owns.  Returns a new tree in the leaves'
    own dtypes; at ``comm.size == 1`` the pack, the all-reduce and the
    unpack all still run, so the result is the leaves rounded through
    the wire dtype."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported fused allreduce op {op!r}")
    buckets, spec = flatten_buckets(grads, bucket_bytes, wire_dtype)
    if not buckets:
        return grads
    if inter_comm is not None:
        reduced = [hierarchical_allreduce(b, comm, inter_comm, op)
                   for b in buckets]
    else:
        reduced = [_plain_reduce(b, comm, op) for b in buckets]
    return unflatten_buckets(reduced, spec)


# --------------------------------------------------------------------- #
# the backward-overlapped exchange
# --------------------------------------------------------------------- #
#
# A window-end exchange waits for the last gradient of the backward.
# The overlap form cuts the leaves, walked in REVERSE flatten order (the
# order the backward produces them), into contiguous buckets; a bucket
# depends only on its own leaves, so its collective can start while the
# backward still produces the next bucket's gradients.  In the JAX
# package the scheduler starts it; here the updater's gradient hooks do
# (:class:`OverlapExchange`), in schedule order on the communication
# stream.


def _normalize_schedule(schedule) -> Tuple[Tuple[int, str, str], ...]:
    """Coerce a schedule (dicts from a JSON plan, tuples or lists) to
    ``((n_leaves, mode, via), ...)`` and validate it."""
    out = []
    for entry in schedule:
        if isinstance(entry, dict):
            leaves = entry.get("leaves")
            mode = entry.get("mode", "eager")
            via = entry.get("via", "rs")
        else:
            seq = tuple(entry)
            leaves = seq[0]
            mode = seq[1] if len(seq) > 1 else "eager"
            via = seq[2] if len(seq) > 2 else "rs"
        if not isinstance(leaves, int) or leaves < 1:
            raise ValueError(
                f"schedule entry wants a positive leaf count, got "
                f"{leaves!r}")
        if mode not in ("eager", "deferred"):
            raise ValueError(
                f"schedule mode {mode!r} not one of ('eager', "
                f"'deferred')")
        if via not in ("rs", "ar"):
            raise ValueError(
                f"schedule via {via!r} not one of ('rs', 'ar')")
        out.append((leaves, mode, via))
    if not out:
        raise ValueError("empty overlap schedule")
    return tuple(out)


def build_overlap_schedule(grads, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                           wire_dtype=None) -> Tuple[dict, ...]:
    """The default (all-eager) overlap schedule of a gradient tree: the
    REVERSED non-empty-leaf sequence cut into contiguous buckets of at
    least ``bucket_bytes`` wire bytes (floats counted at ``wire_dtype``'s
    itemsize; the last bucket ragged).  Returns ``({"leaves": k,
    "mode": "eager", "via": "rs"}, ...)``, the JSON-stable form, whose
    counts sum to the tree's non-empty leaves."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes {bucket_bytes} must be positive")
    leaves = [t for t in pytree.tree_leaves(grads) if t.numel()]
    schedule = []
    run, run_bytes = 0, 0
    for leaf in reversed(leaves):
        run += 1
        run_bytes += leaf.numel() * _wire_dtype_for(
            leaf.dtype, wire_dtype).itemsize
        if run_bytes >= bucket_bytes:
            schedule.append({"leaves": run, "mode": "eager", "via": "rs"})
            run, run_bytes = 0, 0
    if run:
        schedule.append({"leaves": run, "mode": "eager", "via": "rs"})
    if not schedule:
        # every leaf empty: a one-bucket schedule keeps callers simple
        schedule.append({"leaves": 1, "mode": "eager", "via": "rs"})
    return tuple(schedule)


class OverlapExchange:
    """One exchange of a gradient tree's leaves in the buckets of an
    overlap schedule.  :meth:`put` hands it leaf ``i``'s gradient (in
    the leaf's dtype) in any order; each ``eager`` bucket is exchanged
    as soon as it is complete and every bucket before it has gone, so
    buckets go in schedule order; :meth:`result` exchanges the
    ``deferred`` buckets and returns the tree of means.

    ``leaves`` are the tree's leaves (the parameters, or gradients of
    their shapes and dtypes), ``treedef`` its structure.  With
    ``inter_comm`` every bucket takes the two-stage
    :func:`hierarchical_allreduce` (``comm`` the node's) in place of its
    ``via``.  ``launched`` lists the buckets in the order they went."""

    def __init__(self, leaves, treedef, comm, schedule, op="mean",
                 wire_dtype=None, inter_comm=None):
        if op not in ("sum", "mean"):
            raise ValueError(f"unsupported overlap exchange op {op!r}")
        self._meta = [(tuple(t.shape), t.dtype) for t in leaves]
        self._treedef = treedef
        self._comm, self._op = comm, op
        self._wire, self._inter = wire_dtype, inter_comm
        order = [i for i in range(len(leaves) - 1, -1, -1)
                 if leaves[i].numel()]
        sched = _normalize_schedule(schedule)
        n_sched = sum(k for k, _, _ in sched)
        if order and n_sched != len(order):
            raise ValueError(
                f"overlap schedule covers {n_sched} leaves, grad tree has "
                f"{len(order)} non-empty leaves — the plan was made for "
                f"another tree")
        self._buckets, pos = [], 0
        for k, mode, via in sched if order else ():
            self._buckets.append((order[pos:pos + k], mode, via))
            pos += k
        self._bucket_of = {i: b for b, (idxs, _, _) in
                           enumerate(self._buckets) for i in idxs}
        # an empty leaf is never exchanged: it comes back as itself
        self._empties = {i: t.new_zeros(t.shape)
                         for i, t in enumerate(leaves) if not t.numel()}
        self._grads = [None] * len(leaves)
        self._missing = [len(idxs) for idxs, _, _ in self._buckets]
        self._out = [None] * len(leaves)
        self._next = 0              # the next eager bucket to launch
        self.launched: List[int] = []

    def put(self, i: int, grad: torch.Tensor) -> None:
        """Leaf ``i``'s gradient is ready."""
        if self._grads[i] is not None:
            raise RuntimeError(f"leaf {i} got a second gradient in one "
                               "exchange")
        self._grads[i] = grad
        b = self._bucket_of.get(i)
        if b is not None:
            self._missing[b] -= 1
        self._launch_ready()

    def _launch_ready(self):
        while self._next < len(self._buckets):
            idxs, mode, via = self._buckets[self._next]
            if mode == "eager":
                if self._missing[self._next]:
                    return
                self._exchange(self._next)
            self._next += 1

    def _exchange(self, b):
        idxs, _, via = self._buckets[b]
        self.launched.append(b)
        # maximal runs of ADJACENT leaves with the same wire dtype: only
        # neighbours share a concatenation
        runs = []
        for i in idxs:
            w = _wire_dtype_for(self._meta[i][1], self._wire)
            if runs and runs[-1][0] == w:
                runs[-1][1].append(i)
            else:
                runs.append((w, [i]))
        for w, run in runs:
            flat = [self._grads[i].reshape(-1).to(w) for i in run]
            vec = flat[0] if len(flat) == 1 else torch.cat(flat)
            if self._inter is not None:
                r = hierarchical_allreduce(vec, self._comm, self._inter,
                                           self._op)
            elif via == "rs":
                r = reduce_scatter_allgather(vec, self._comm, self._op)
            else:
                # reduced in place: never in the caller's gradient
                r = _plain_reduce(vec.clone() if len(flat) == 1 else vec,
                                  self._comm, self._op)
            off = 0
            for i in run:
                shape, dtype = self._meta[i]
                n = math.prod(shape)
                self._out[i] = r[off:off + n].reshape(shape).to(dtype)
                off += n
            for i in run:
                self._grads[i] = None

    def result(self):
        """Exchange the deferred buckets (after the eager stream) and
        return the tree of means; an empty leaf comes back as zeros."""
        missing = [i for idxs, _, _ in self._buckets for i in idxs
                   if self._out[i] is None and self._grads[i] is None]
        if missing:
            raise RuntimeError(f"leaves {missing} got no gradient")
        self._launch_ready()
        for b, (_, mode, _) in enumerate(self._buckets):
            if mode == "deferred":
                self._exchange(b)
        out = [self._empties[i] if o is None else o
               for i, o in enumerate(self._out)]
        return pytree.tree_unflatten(out, self._treedef)


def overlap_exchange(grads, comm, op: str = "mean", schedule=None,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     wire_dtype=None, inter_comm=None):
    """Exchange a gradient tree in reverse-leaf-ordered contiguous
    buckets: the backward-overlapped form, here run at the window's end
    (all gradients present), which gives the same numbers as the hooked
    run.  ``schedule`` is ``({"leaves": k, "mode": "eager"|"deferred",
    "via": "rs"|"ar"}, ...)`` over the REVERSED non-empty leaves
    (:func:`build_overlap_schedule` from ``bucket_bytes`` when None):
    ``eager`` buckets go in order, ``deferred`` ones after them; ``via``
    picks :func:`reduce_scatter_allgather` or one all-reduce.  With
    ``inter_comm`` (``comm`` the node's) every bucket is two-stage.  A
    bucket packs each run of adjacent same-wire-dtype leaves into one
    vector; ints and bools never take a float wire."""
    leaves, treedef = pytree.tree_flatten(grads)
    if not any(t.numel() for t in leaves):
        return grads
    if schedule is None:
        schedule = build_overlap_schedule(grads, bucket_bytes, wire_dtype)
    ex = OverlapExchange(leaves, treedef, comm, schedule, op, wire_dtype,
                         inter_comm)
    for i, g in enumerate(leaves):
        if g.numel():
            ex.put(i, g)
    return ex.result()


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to chainermn_tpu_torch yet (ROADMAP "
            f"Queue A item {item})")
    fn.__name__ = name
    fn.__doc__ = f"Not ported yet (ROADMAP Queue A item {item}); raises."
    return fn


plan_allreduce = _not_ported("plan_allreduce", 10)
