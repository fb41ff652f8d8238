"""The local parts of ``chainermn_tpu/parallel/ring_attention.py``: plain
softmax attention on local blocks, the grouped (GQA/MQA) score and
value-mix products, and the K/V head broadcast for kernels that want
matching head counts.  The ring schedule itself (K/V blocks rotating
over a sequence-parallel group) comes with the parallel slice.

Layouts follow the JAX package: ``q`` ``(B, T, H, D)``, ``k``/``v``
``(B, S, G, D)`` with ``G | H``; query head ``h`` reads kv head
``h // (H / G)``.
"""

from __future__ import annotations

import torch

__all__ = ["local_attention", "broadcast_kv"]

_NEG = -1e30  # finite mask value: keeps the softmax max well-defined


def _group_rep(q_heads: int, kv_heads: int) -> int:
    if q_heads % kv_heads:
        raise ValueError(
            f"query heads {q_heads} not a multiple of kv heads {kv_heads}")
    return q_heads // kv_heads


def broadcast_kv(k, v, rep: int):
    """Broadcast shared K/V heads to query width: head ``g`` repeated
    ``rep`` times consecutively, the ``h // rep`` grouping that
    :func:`_qk_scores` reads in place."""
    if rep == 1:
        return k, v
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


def _qk_scores(q, k):
    """``(B,T,H,D) × (B,S,G,D) -> (B,H,T,S)`` scores; grouped when
    ``G < H``, without materialising K at query width."""
    H, G = q.shape[2], k.shape[2]
    if H == G:
        return torch.einsum("bthd,bshd->bhts", q, k)
    R = _group_rep(H, G)
    B, T, _, D = q.shape
    s = torch.einsum("btgrd,bsgd->bgrts", q.reshape(B, T, G, R, D), k)
    return s.reshape(B, H, T, -1)


def _pv_mix(p, v):
    """``(B,H,T,S) × (B,S,G,D) -> (B,H,T,D)``, grouped when ``G < H``."""
    H, G = p.shape[1], v.shape[2]
    if H == G:
        return torch.einsum("bhts,bshd->bhtd", p, v)
    R = _group_rep(H, G)
    B, _, T, S = p.shape
    o = torch.einsum("bgrts,bsgd->bgrtd", p.reshape(B, G, R, T, S), v)
    return o.reshape(B, H, T, -1)


def local_attention(q, k, v, *, causal: bool = False, window=None,
                    q_offset: int = 0, k_offset: int = 0):
    """Plain softmax attention in the inputs' dtype.  ``window`` (needs
    ``causal``): token t attends to ``(t - window, t]``.  A fully masked
    row averages V uniformly, as the JAX oracle does."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    scale = q.shape[-1] ** -0.5
    s = _qk_scores(q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        allow = qpos[:, None] >= kpos[None, :]
        if window is not None:
            allow &= (qpos[:, None] - kpos[None, :]) < window
        s = s.masked_fill(~allow, _NEG)
    p = torch.softmax(s, dim=-1)
    return _pv_mix(p, v).transpose(1, 2)
