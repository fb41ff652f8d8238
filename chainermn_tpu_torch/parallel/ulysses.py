"""Ulysses sequence parallelism — the head↔sequence all-to-all (the JAX
package's ``parallel/ulysses.py``).

Every rank of the sequence-parallel communicator holds ``(B, T/S, H,
D)``.  One all-to-all scatters heads and gathers the sequence, so each
rank holds the FULL sequence for ``H/S`` heads; attention runs there
with no further communication (the flash kernel slots in as
``attn_fn``); the inverse all-to-all restores the sequence sharding.
The exchange is the tiled ``lax.all_to_all``, built here from the
port's untiled :func:`~chainermn_tpu_torch.ops.collectives.alltoall`
with reshapes around it (:func:`all_to_all_tiled`); its backward is the
inverse exchange.
"""

from __future__ import annotations

from math import gcd
from typing import Callable, Optional

from chainermn_tpu_torch.ops.collectives import alltoall

from .ring_attention import _group_rep, broadcast_kv, local_attention

__all__ = ["all_to_all_tiled", "ulysses_attention"]


def all_to_all_tiled(x, comm, split_axis: int, concat_axis: int):
    """``lax.all_to_all(..., tiled=True)`` per rank: ``split_axis`` is
    cut into ``comm.size`` equal chunks, chunk ``j`` goes to rank ``j``,
    and the chunks a rank receives are concatenated along
    ``concat_axis`` in source-rank order.  Differentiable (the
    transpose is the exchange with the axes swapped)."""
    n = comm.size
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    shape = list(x.shape)
    chunked = x.reshape(shape[:split_axis] + [n, shape[split_axis] // n]
                        + shape[split_axis + 1:])
    # the untiled exchange removes the rank axis and inserts the source
    # axis; put it just before the (chunk-sized) concat axis, then merge
    got = alltoall(chunked, comm, split_axis=split_axis,
                   concat_axis=concat_axis)
    out = list(got.shape)
    return got.reshape(out[:concat_axis]
                       + [out[concat_axis] * out[concat_axis + 1]]
                       + out[concat_axis + 2:])


def ulysses_attention(q, k, v, *, comm=None, causal: bool = False,
                      window=None, attn_fn: Optional[Callable] = None):
    """Sequence-parallel exact attention, called by every rank of
    ``comm`` (None: one rank) with its block ``(B, T/S, H, D)`` of Q
    and ``(B, T/S, G, D)`` of K/V.

    ``attn_fn(q, k, v, causal=..., window=...)`` runs on the
    full-sequence, head-sharded tensors with K/V broadcast to query
    width after the exchange; the default, :func:`local_attention`,
    reads the shared heads in place.  When ``S ∤ G`` the shared heads
    are first repeated consecutively up to ``lcm(G, S)``, so each
    destination's query heads find their K/V heads.  Returns ``(B, T/S,
    H, D)``."""
    S = 1 if comm is None else comm.size
    if S > 1:
        H, G = q.shape[2], k.shape[2]
        if H % S:
            raise ValueError(
                f"heads {H} not divisible by seq-axis size {S}")
        if G % S:
            # lcm(G, S) heads: S | lcm, and lcm | H as G | H and S | H
            k, v = broadcast_kv(k, v, S // gcd(G, S))
        # (B, T/S, H, D) → (B, T, H/S, D): scatter heads, gather sequence
        q, k, v = (all_to_all_tiled(t, comm, split_axis=2, concat_axis=1)
                   for t in (q, k, v))
    rep = _group_rep(q.shape[2], k.shape[2])
    if attn_fn is not None:
        k, v = broadcast_kv(k, v, rep)
    fn = attn_fn or local_attention
    out = fn(q, k, v, causal=causal, window=window)
    if S > 1:
        # inverse exchange: scatter sequence, gather heads
        out = all_to_all_tiled(out, comm, split_axis=1, concat_axis=2)
    return out
