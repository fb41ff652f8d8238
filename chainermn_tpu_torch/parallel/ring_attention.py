"""Ring attention — context parallelism over the ``seq`` axis (the JAX
package's ``parallel/ring_attention.py``), and the local attention
parts it shares with the rest of the port.

Rank ``r`` of a sequence-parallel group of ``S`` ranks holds Q/K/V for
its block of ``T`` tokens: ``[r·T, (r+1)·T)`` in the contiguous layout,
chunks ``r`` and ``2S−1−r`` of ``T/2`` tokens in the zigzag one
(:func:`zigzag_indices`).  K and V rotate around the ring for ``S``
steps (fewer under a window) while the resident Q attends each visiting
block, masking in GLOBAL positions, so the result is full-sequence
attention.  Two per-pair computes, as in the JAX package:

- the einsum scan: an online softmax (running max, normaliser,
  numerator) over the visiting blocks, with grouped (GQA) products that
  read the shared K/V heads in place;
- the kernel schedule (``use_flash=True``): one flash-attention call per
  contiguous (Q run × K run) pair — 1 a step in the contiguous layout, 4
  in the zigzag one — at the pair's global offsets, each returning its
  ``(o, lse)``; the partials merge exactly in log space.  The offsets
  are Python ints here, so a pair the causal or window mask empties
  entirely is not launched: its partial is neutral (``o = 0``,
  ``lse = -1e30``), and ``logaddexp(lse, -1e30)`` is ``lse`` in fp32.

K and V rotate packed as one ``(2, B, T, G, D)`` tensor at the shared
(G-head) width through the differentiable
:func:`~chainermn_tpu_torch.ops.point_to_point.ppermute`: one transfer
a step, whose backward is the reverse ring, so every rank posts its
backward transfers in the same order.  K/V are broadcast to query width
only at the kernel boundary.  :func:`simulate_ring` runs every rank's
ring body on one device, the visiting blocks held locally.

Layouts follow the JAX package: ``q`` ``(B, T, H, D)``, ``k``/``v``
``(B, T, G, D)`` with ``G | H``; query head ``h`` reads kv head
``h // (H / G)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.ops.point_to_point import ppermute, pseudo_connect

__all__ = ["broadcast_kv", "local_attention", "ring_attention",
           "simulate_ring", "zigzag_indices"]

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


def _allow(qpos, kpos, window):
    """The causal (and window) mask of query against key positions."""
    allow = qpos[:, None] >= kpos[None, :]
    if window is not None:
        allow &= (qpos[:, None] - kpos[None, :]) < window
    return allow


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
        s = s.masked_fill(~_allow(qpos, kpos, window), _NEG)
    p = torch.softmax(s, dim=-1)
    return _pv_mix(p, v).transpose(1, 2)


def _lse_attention_pair(q, kb, vb, *, causal, q_offset, k_offset,
                        window=None):
    """One (Q block × K/V block) partial with its log-sum-exp, computed
    in fp32 with grouped products: the semantics of
    ``flash_attention(..., return_lse=True)``, including its fully
    masked convention (``o = 0``, ``lse ≈ -1e30``).  ``o`` in q's dtype
    ``(B, T, H, D)``, ``lse`` fp32 ``(B, T, H)``."""
    scale = q.shape[-1] ** -0.5
    s = _qk_scores(q.float(), kb.float()) * scale
    allow = None
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(kb.shape[1], device=q.device)
        allow = _allow(qpos, kpos, window)
        s = s.masked_fill(~allow, _NEG)
    m = s.amax(dim=-1)                                   # (B,H,T)
    p = torch.exp(s - m[..., None])
    if allow is not None:
        p = p.masked_fill(~allow, 0.0)
    safe = p.sum(dim=-1).clamp_min(1e-30)
    o = _pv_mix(p, vb.float()) / safe[..., None]          # (B,H,T,D)
    lse = m + torch.log(safe)
    return o.transpose(1, 2).to(q.dtype), lse.transpose(1, 2)


def zigzag_indices(S: int, T_global: int):
    """Global-sequence permutation for the load-balanced causal layout:
    an ``(S, T_global // S)`` int array whose row ``r`` holds the global
    token indices rank ``r`` holds, chunks ``r`` and ``2S−1−r`` of the
    ``2S``-chunk sequence, in local order.  Permute inputs and targets by
    its flattening and pass ``layout="zigzag"``."""
    if T_global % (2 * S):
        raise ValueError(
            f"zigzag layout needs T ({T_global}) divisible by 2*S ({2*S})")
    C = T_global // (2 * S)
    rows = []
    for rr in range(S):
        rows.append(np.concatenate([
            np.arange(rr * C, (rr + 1) * C),
            np.arange((2 * S - 1 - rr) * C, (2 * S - rr) * C)]))
    return np.stack(rows)


def _block_offsets(rr, T, S, layout):
    """``(start, length, global offset)`` of the contiguous runs making
    up rank ``rr``'s block: one T-run (contiguous) or two T/2-runs
    (zigzag)."""
    if layout == "contiguous":
        return [(0, T, rr * T)]
    C = T // 2
    return [(0, C, rr * C), (C, C, (2 * S - 1 - rr) * C)]


def _block_positions(rr, T, S, layout, device=None):
    """The global positions of rank ``rr``'s ``T`` tokens."""
    parts = [off + torch.arange(ln, device=device) for _, ln, off in
             _block_offsets(rr, T, S, layout)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _merge_lse(o, lse, o_i, lse_i):
    """Exact log-space merge of two attention partials."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_i - lse_new)[..., None]
    return o * w_old + o_i * w_new, lse_new


def _pair_live(q_off, q_len, k_off, k_len, causal, window) -> bool:
    """Whether the mask leaves any (query, key) of the pair: positions
    ``[q_off, q_off + q_len)`` against ``[k_off, k_off + k_len)``."""
    if not causal:
        return True
    lo = q_off - (k_off + k_len - 1)         # the least q − k of the pair
    hi = q_off + q_len - 1 - k_off           # the largest
    return hi >= 0 and (window is None or lo < window)


def _ring_checks(q, k, v, causal, window, layout, permute_plan):
    if permute_plan is not None:
        raise NotImplementedError(
            "ring_attention(permute_plan=...) is not ported: the "
            "collective-plan IR is ROADMAP Queue A item 10")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout {layout!r} not in (contiguous, zigzag)")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _group_rep(q.shape[2], k.shape[2])   # validate G | H up front


def _n_steps(S, T, causal, window, layout):
    """Ring steps: ``S``, or, for a windowed contiguous causal ring, only
    the blocks the window can reach (blocks ahead are all future and
    blocks further back than ``ceil(W/T)`` all out of window)."""
    if window is not None and causal and layout == "contiguous":
        return min(S, -(-window // T) + 1)
    return S


def ring_launches(S, T, *, causal, window=None, layout="contiguous",
                  rank=None):
    """Flash-kernel forward launches of the kernel schedule on rank
    ``rank`` of one ring over a sequence of ``S·T`` tokens, or summed
    over the ``S`` ranks: the (Q run × K run) pairs the mask does not
    empty.  Each launched pair also launches the dq and dk/dv kernels
    once in the backward."""
    n = 0
    for r in range(S) if rank is None else (rank,):
        for i in range(_n_steps(S, T, causal, window, layout)):
            src = (r - i) % S
            for _, q_len, q_off in _block_offsets(r, T, S, layout):
                for _, k_len, k_off in _block_offsets(src, T, S, layout):
                    n += _pair_live(q_off, q_len, k_off, k_len, causal,
                                    window)
    return n


def _ring_body(q, kv, r, S, fetch, *, causal, window, remat, use_flash,
               layout):
    """Rank ``r``'s ring: its resident ``q`` against the K/V pair ``kv``
    (``(2, B, T, G, D)``) at step 0 and ``fetch(kv, i)`` at step ``i``
    (the block of rank ``(r - i) % S``)."""
    T = q.shape[1]
    if layout == "zigzag" and T % 2:
        raise ValueError(f"zigzag needs an even local length, got {T}")
    n_steps = _n_steps(S, T, causal, window, layout)
    if use_flash:
        return _ring_flash(q, kv, r, S, fetch, causal=causal,
                           window=window, layout=layout, n_steps=n_steps)
    scale = q.shape[-1] ** -0.5
    qpos = _block_positions(r, T, S, layout, q.device)

    def step_math(kb, vb, num, den, m, src):
        s = _qk_scores(q, kb) * scale
        if causal:
            kpos = _block_positions(src, T, S, layout, q.device)
            s = s.masked_fill(~_allow(qpos, kpos, window), _NEG)
        # online softmax update (the flash recurrence)
        m_new = torch.maximum(m, s.amax(dim=-1))         # (B,H,T)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])              # (B,H,T,Tk)
        num = num * alpha[..., None] + _pv_mix(p, vb)
        den = den * alpha + p.sum(dim=-1)
        return num, den, m_new

    B, _, H, D = q.shape
    num = q.new_zeros((B, H, T, D))
    den = q.new_zeros((B, H, T))
    m = torch.full_like(den, _NEG)
    for i in range(n_steps):
        if i:
            kv = fetch(kv, i)
        args = (kv[0], kv[1], num, den, m, (r - i) % S)
        if remat and torch.is_grad_enabled():
            num, den, m = checkpoint(step_math, *args, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            num, den, m = step_math(*args)
    return (num / den[..., None]).transpose(1, 2)        # (B,T,H,D)


def _ring_flash(q, kv, r, S, fetch, *, causal, window, layout, n_steps):
    """The ring with the flash kernel as the per-pair compute: one call
    per live (Q run × K run) pair at its global offsets; within a step
    the pairs of a Q run merge in log space into the step's partial,
    which merges into the run's running partial (the JAX package's
    order).  On CPU tensors the kernel's plain version runs."""
    T = q.shape[1]
    rep = _group_rep(q.shape[2], kv.shape[3])
    q_runs = _block_offsets(r, T, S, layout)
    acc = [None] * len(q_runs)                           # (o, lse) a run
    for i in range(n_steps):
        if i:
            kv = fetch(kv, i)
        src = (r - i) % S
        used = False
        for j, (q_start, q_len, q_off) in enumerate(q_runs):
            qq = q[:, q_start:q_start + q_len]
            part = None
            for k_start, k_len, k_off in _block_offsets(src, T, S, layout):
                if not _pair_live(q_off, q_len, k_off, k_len, causal,
                                  window):
                    continue         # neutral partial: nothing launched
                kb = kv[0, :, k_start:k_start + k_len]
                vb = kv[1, :, k_start:k_start + k_len]
                # the kernel wants matching head counts: broadcast the
                # visiting run only here, after the transfer
                kb, vb = broadcast_kv(kb, vb, rep)
                o_i, lse_i = flash_attention(
                    qq, kb, vb, causal=causal, window=window,
                    q_offset=q_off, k_offset=k_off, return_lse=True)
                o_i = o_i.float()
                used = True
                part = (o_i, lse_i) if part is None \
                    else _merge_lse(*part, o_i, lse_i)
            if part is not None:
                acc[j] = part if acc[j] is None else _merge_lse(*acc[j],
                                                                *part)
    outs = []
    for (_, q_len, _), a in zip(q_runs, acc):
        if a is None:            # every pair of the run masked: o = 0
            B, _, H, D = q.shape
            a = (q.new_zeros((B, q_len, H, D), dtype=torch.float32), None)
        outs.append(a[0])
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if n_steps > 1 and not used and torch.is_grad_enabled():
        # the last visiting block met only masked pairs here: tie it into
        # the output with a zero, so that its transfer's backward (the
        # reverse ring, which every rank posts) runs on this rank too
        o = pseudo_connect(kv, o)
    return o.to(q.dtype)


def ring_attention(q, k, v, *, comm=None, causal: bool = False,
                   window=None, remat: bool = True, use_flash: bool = False,
                   layout: str = "contiguous", permute_plan=None):
    """Blockwise ring attention, called by every rank of the
    sequence-parallel communicator ``comm`` (None: one rank) with its
    block ``(B, T, H, D)`` of Q and ``(B, T, G, D)`` of K/V; returns its
    attended block ``(B, T, H, D)``.

    Args:
      causal: masking in global token positions (offsets from the rank
        and ``layout``), so the result equals full-sequence causal
        attention.
      window: sliding causal window: token t attends to ``(t−W, t]``.
      remat: recompute each step of the einsum scan in the backward.
        The kernel schedule keeps each pair's ``(o, lse)``, from which
        the backward kernels recompute P.
      use_flash: each pair through the flash kernel
        (:func:`~chainermn_tpu_torch.ops.flash_attention.flash_attention`;
        its plain version on CPU tensors) instead of the einsum scan.
      layout: ``"contiguous"`` or ``"zigzag"`` (see
        :func:`zigzag_indices`).
      permute_plan: a tuned plan of the rotation, which raises (the plan
        IR is not ported).

    On one rank the kernel schedule returns the single pair's ``o`` cast
    to q's dtype: bitwise the whole-sequence flash call."""
    _ring_checks(q, k, v, causal, window, layout, permute_plan)
    S = 1 if comm is None else comm.size
    r = 0 if comm is None else comm.rank
    ring = [(i, (i + 1) % S) for i in range(S)]

    def fetch(kv, i):
        return ppermute(kv, comm, ring)

    return _ring_body(q, torch.stack([k, v]), r, S, fetch, causal=causal,
                      window=window, remat=remat, use_flash=use_flash,
                      layout=layout)


def simulate_ring(q, k, v, *, S: int, causal: bool = False, window=None,
                  remat: bool = False, use_flash: bool = False,
                  layout: str = "contiguous"):
    """Every rank's ring body of an ``S``-rank ring, run one after the
    other on this device: the sequences ``(B, S·T, H, D)`` / ``(B, S·T,
    G, D)`` are in the layout's order (permuted by
    :func:`zigzag_indices` for zigzag), rank ``r`` holds tokens
    ``[r·T, (r+1)·T)`` of them, and each visiting block is read locally
    instead of received.  Returns the ranks' outputs concatenated
    ``(B, S·T, H, D)``; gradients flow to ``q``, ``k`` and ``v`` as they
    would through the ring."""
    _ring_checks(q, k, v, causal, window, layout, None)
    if q.shape[1] % S:
        raise ValueError(f"length {q.shape[1]} does not split over {S}")
    qs = q.chunk(S, dim=1)
    kvs = torch.stack([k, v]).chunk(S, dim=2)
    outs = []
    for r in range(S):
        outs.append(_ring_body(
            qs[r], kvs[r], r, S, lambda kv, i, r=r: kvs[(r - i) % S],
            causal=causal, window=window, remat=remat,
            use_flash=use_flash, layout=layout))
    return torch.cat(outs, dim=1)
