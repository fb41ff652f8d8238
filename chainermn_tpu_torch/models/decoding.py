"""Autoregressive decoding with a KV cache for the flagship transformer,
on one device or over a mesh's data, expert, seq, model and pipe axes:
greedy generation, greedy speculative decoding with a draft model,
prompt-lookup decoding and beam search, each with int8 weights and an
int8 KV cache as options.

Counterpart of ``chainermn_tpu/models/decoding.py`` with the same
semantics step for step:

- the KV cache holds ``max_len`` slots at the shared (GQA) head width in
  the compute dtype, or with ``kv_cache_dtype="int8"`` int8 values plus
  fp32 per-(token, head) scales with a trailing singleton (the JAX
  ``_make_cache``); the port writes it in place;
- prefill runs prompt positions ``0..P-2`` as ONE chunk, attending the
  chunk's own raw K/V through plain ``local_attention`` (it is XLA in
  the reference, not the flash kernel; only what later steps read back
  is quantized); left-padded prompts take the cache-attending path
  instead, with per-row validity and per-row positions;
- token steps start at the last prompt position ``P-1``; each attends
  the whole cache with later slots masked, and the head is a full fp32
  product over the last position (every position of a verify chunk);
- ``eos_id >= 0`` freezes a row after it emits eos (later slots get
  ``pad_id``) and stops once every row is done;
- ``quantized=True`` takes the tree of
  :func:`~.quantization.quantize_params_int8`: each block product casts
  the int8 weight to the compute dtype and puts the per-output-channel
  scale on its output (the JAX ``_dense_q``), the embedding's gathered
  rows are dequantized and the head's logits take the per-row scale,
  the experts carry per-expert scales.  The product reads the weight
  twice (int8, then its cast), so int8 decode is not faster than bf16
  in the port yet.

Over a mesh (``mesh=``, or ``comm=`` as the mesh ``data=N``) each rank
decodes its rows of the batch (the data and expert axes), and every
rank runs the same number of steps (or rounds): the stop is taken when
no rank of the rows' group has an unfinished row, and a speculative
round's acceptance is the minimum over that group.  Under MoE each
block's MLP is the training one: every prefill chunk, token step and
verify chunk routes its own tokens, over the expert axis's all-to-alls
(a verify chunk routes ``B·(k+1)`` tokens at once, so at a finite
capacity it may drop other tokens than token steps do, as in the JAX
package).  A seq axis of ``R`` members blocks the cache's length
(sequence-parallel KV): member ``r`` holds positions ``[r·Tl,
(r+1)·Tl)``, ``Tl = max_len/R``; prefill writes each member's block, a
token step writes on the owning member only, and attention is the
distributed softmax (a max of the row maxima, then sums of the exp-sums
and of the value partials over the seq group).  A model axis of ``M``
members shards the heads (tensor parallelism): each member's cache
holds its ``Hkv/M`` K/V heads, each block runs its column→row products
over the model communicator, and under ``vocab_parallel`` the embedding
lookup is the masked gather with one all-reduce and the head the fp32
product over the member's vocab rows, all-gathered: every member holds
the same full logits, bit for bit, and takes the same argmax.  A pipe
axis of ``S`` stages shards the layers: each stage holds only its blocks
and their cache, ``(L/S, rows, kv_len, Hkv/M, Dh)``; stage ``p`` runs
its layers in phase ``p`` of each step only (the JAX package runs every
phase on every stage and masks), the hidden state goes ``p → p+1`` by
one transfer, and the last stage's logits reach every stage by a
broadcast.

Sampling (``temperature > 0``, ``top_k``, ``top_p``) comes with the
serving slice and raises here.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from chainermn_tpu_torch.communicators.loopback import LoopbackCommunicator
from chainermn_tpu_torch.ops.collectives import allgather
from chainermn_tpu_torch.parallel.expert import expert_parallel_moe
from chainermn_tpu_torch.parallel.pipeline import _edge_send, _from_stage
from chainermn_tpu_torch.parallel.ring_attention import (
    _NEG,
    _pv_mix,
    _qk_scores,
    local_attention,
)
from chainermn_tpu_torch.parallel.tensor import (
    column_parallel_dense,
    row_parallel_dense,
)

from .quantization import _BASE
from .transformer import (
    TransformerConfig,
    _check_mesh,
    _check_ported,
    _layers,
    _mlp,
    _resolve,
    _rms_norm,
    _rows,
    _vp_embed_lookup,
    apply_rope,
)

__all__ = ["make_beam_search_fn", "make_generate_fn",
           "make_lookup_generate_fn", "make_speculative_generate_fn"]

_SAMPLING = ("sampling (temperature > 0, top_k, top_p) is not ported yet; "
             "it comes with the serving slice (ROADMAP Queue A item 12)")


def _dense_q(dense, x, blk, name, cd, comm):
    """``dense(x, blk[name])`` over ``comm`` with optional weight-only
    int8 (the JAX ``_dense_q``): the weight, as a matrix of its
    contraction against its outputs, is cast to the compute dtype, and
    the per-output-channel scale multiplies the product's output (exact
    for scales constant along the contraction)."""
    w = blk[name]
    w2d = w.reshape(w.shape[0], -1) if _BASE[name][1] == (0,) \
        else w.reshape(-1, w.shape[-1])
    y = dense(x, w2d.to(cd), comm=comm)
    scale = blk.get(name + "_scale")
    if scale is not None:
        y = y * scale.reshape(-1).to(cd)
    return y


def _decode_mlp(cfg: TransformerConfig, h, blk, model, expert):
    """The block's MLP: the training one (:func:`~.transformer._mlp`)
    for fp weights; with int8 weights each product scales its output, and
    the int8 experts their per-expert channels (the JAX decode's
    ``expert_fn``)."""
    if "w1_scale" not in blk:
        return _mlp(cfg, h, blk, model, expert)[0]
    cd = cfg.compute_dtype
    x = _rms_norm(h, blk["ln2"])
    if not cfg.moe:
        y = torch.relu(_dense_q(column_parallel_dense, x, blk, "w1", cd,
                                model))
        return h + _dense_q(row_parallel_dense, y, blk, "w2", cd, model)
    B, T, D = x.shape

    def expert_fn(p, tokens):
        # the local experts at once, each scale (E/X, F/M) or (E/X, D)
        y = column_parallel_dense(tokens, p["w1"].to(cd), comm=model)
        y = torch.relu(y * p["w1_scale"][:, None, :].to(cd))
        out = row_parallel_dense(y, p["w2"].to(cd), comm=model)
        return out * p["w2_scale"][:, None, :].to(cd)

    out, _ = expert_parallel_moe(
        x.reshape(B * T, D), blk["router"].to(cd),
        {k: blk[k] for k in ("w1", "w2", "w1_scale", "w2_scale")},
        expert_fn, comm=expert, capacity_factor=cfg.capacity_factor,
        top_k=cfg.router_top_k)
    return h + out.reshape(B, T, D)


def _quantize_kv(t):
    """int8 KV (the JAX decode's ``quant``): the per-(token, head) absmax
    over ``Dh`` divided by 127 in ``t``'s dtype, floored at 1e-8, as an
    fp32 scale with a trailing singleton; the values clipped to ±127
    before the int8 cast (in bf16 the scale can round below
    absmax/127)."""
    s = (t.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8) \
        .to(torch.float32)
    q = torch.round(t / s.to(t.dtype)).clamp(-127, 127).to(torch.int8)
    return q, s


def _decode_block(cfg: TransformerConfig, h, blk, cache, pos: int, seq,
                  model, expert, chunk_attends_cache: bool = False,
                  pos_offset=None):
    """One block for a chunk of new tokens ``h`` (B, Tq, D) whose first
    token sits at position ``pos``.  ``cache`` is this layer's ``(ck,
    cv)`` pair of (B, kv_len_local, Hkv_local, Dh) buffers, or ``(ck,
    cv, ck_s, cv_s)`` under ``kv_cache_dtype="int8"`` (int8 values, fp32
    scales with a trailing singleton), written in place: the whole
    ``max_len`` (plus a speculative round's pad), or under
    sequence-parallel KV (``seq``, the seq communicator, of size R > 1)
    this member's block of ``max_len/R`` positions; ``blk`` is this
    rank's shard over ``model`` (the model communicator), whose heads
    the cache holds, and over ``expert`` (the expert communicator),
    whose experts the MoE MLP reaches.  ``chunk_attends_cache`` makes a
    chunk attend the cache (a left-padded prefill, a verify chunk at
    ``pos > 0``) instead of only its own K/V."""
    cd = cfg.compute_dtype
    ck, cv, *scales = cache
    ck_s, cv_s = scales if scales else (None, None)
    x = _rms_norm(h, blk["ln1"])
    B, Tq, D = x.shape
    R, r = seq.size, seq.rank
    Tl = ck.shape[1]
    if "wqkv" in blk:
        H = blk["wqkv"].shape[2]
        qkv = _dense_q(column_parallel_dense, x, blk, "wqkv", cd, model)
        qkv = qkv.reshape(B, Tq, 3, H, cfg.d_head)
        q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        H = blk["wq"].shape[1]
        Hkv = blk["wkv"].shape[2]
        q = _dense_q(column_parallel_dense, x, blk, "wq", cd, model
                     ).reshape(B, Tq, H, cfg.d_head)
        kv = _dense_q(column_parallel_dense, x, blk, "wkv", cd, model
                      ).reshape(B, Tq, 2, Hkv, cfg.d_head)
        k_new, v_new = kv[:, :, 0], kv[:, :, 1]
    qpos = pos + torch.arange(Tq, device=x.device)             # (Tq,)
    if cfg.pos_embedding == "rope":
        # left-padded rows: slot s holds the row's token number s - offset
        rpos = qpos if pos_offset is None else (
            qpos[None, :] - pos_offset[:, None]).clamp_min(0)
        q = apply_rope(q, rpos, cfg.rope_theta)
        k_new = apply_rope(k_new, rpos, cfg.rope_theta)
    # the chunk's own K/V at compute precision: prefill attends these
    k_raw, v_raw = k_new, v_new
    writes = [(ck, k_new), (cv, v_new)]
    if ck_s is not None:
        k_new, k_sc = _quantize_kv(k_new)
        v_new, v_sc = _quantize_kv(v_new)
        writes = [(ck, k_new), (cv, v_new), (ck_s, k_sc), (cv_s, v_sc)]
    if pos_offset is not None and R > 1:
        raise ValueError(
            "left-padded prompts (pos_offset) are not supported under "
            "sequence-parallel KV (seq axis > 1): shard batch/heads/"
            "layers instead")
    if Tq > 1 and R > 1 and chunk_attends_cache:
        raise ValueError(
            "chunked mid-sequence decode (Tq > 1 with "
            "chunk_attends_cache) is not supported under "
            "sequence-parallel KV (seq axis > 1): the blockwise cache "
            "write requires the prefill contract pos == 0")
    for buf, new in writes:
        if Tq > 1 and R > 1:
            # blockwise prefill write (pos == 0): this member's rows of
            # the chunk, [r·Tl, r·Tl + Tl) ∩ [0, Tq)
            lo, hi = r * Tl, min(r * Tl + Tl, Tq)
            if hi > lo:
                buf[:, :hi - lo] = new[:, lo:hi]
        elif R > 1:
            # a token step: member pos // Tl owns the position
            if pos // Tl == r:
                buf[:, pos % Tl:pos % Tl + Tq] = new
        else:
            buf[:, pos:pos + Tq] = new
    if Tq > 1 and not chunk_attends_cache:
        # prefill at pos 0: the chunk's own K/V (in hand on every
        # member) are all it may attend
        o = local_attention(q, k_raw, v_raw, causal=True,
                            window=cfg.attention_window or None)
    else:
        kk = ck.to(cd) * ck_s.to(cd) if ck_s is not None else ck
        vv = cv.to(cd) * cv_s.to(cd) if cv_s is not None else cv
        s = _qk_scores(q, kk) * (cfg.d_head ** -0.5)           # (B,H,Tq,Tl)
        kpos = torch.arange(Tl, device=x.device) + r * Tl
        allow = kpos[None, :] <= qpos[:, None]                 # (Tq, Tl)
        if cfg.attention_window:
            allow &= (qpos[:, None] - kpos[None, :]) < cfg.attention_window
        if pos_offset is not None:
            # per-row validity: slots before a row's first real token
            # hold pad K/V that no query may attend
            allow = allow[None] & (
                kpos[None, None, :] >= pos_offset[:, None, None])
            s = s.masked_fill(~allow[:, None], _NEG)
        else:
            s = s.masked_fill(~allow, _NEG)
        if R > 1:
            # the distributed softmax: the global row max, then the
            # exp-sums and the value partials summed over the seq group;
            # a member whose block lies past pos adds exp(_NEG - m) = 0
            m = seq.allreduce(s.amax(dim=-1, keepdim=True), "max")
            e = torch.exp(s - m)
            n = seq.allreduce(e.sum(dim=-1, keepdim=True), "sum")
            o = seq.allreduce(_pv_mix(e, vv), "sum")
            o = (o / n).transpose(1, 2)                        # (B,Tq,H,Dh)
        else:
            o = _pv_mix(torch.softmax(s, dim=-1), vv).transpose(1, 2)
    h = h + _dense_q(row_parallel_dense, o.reshape(B, Tq, -1), blk, "wo",
                     cd, model)
    # under MoE each call routes its own B·Tq tokens (a prefill chunk
    # and a token step have different capacities, and a step may drop
    # tokens, as the JAX decode does)
    return _decode_mlp(cfg, h, blk, model, expert)


def _decode_step(cfg: TransformerConfig, params, cache, tok, pos: int, ax,
                 with_logits: bool = True, all_logits: bool = False,
                 chunk_attends_cache=False, pos_offset=None):
    """Next-token fp32 logits (B, V) for ``tok`` — (B,) in the generation
    loop, or a (B, Tq) chunk starting at ``pos`` for prefill
    (``with_logits=False`` then skips the head) or a speculative verify
    (``all_logits=True``: every position's logits, (B, Tq, V)).
    ``cache`` is the tuple of (L_local, B, kv_len_local, Hkv_local, Dh)
    buffers (:func:`_make_cache`); ``params`` this rank's shard over
    ``model`` and ``pipe`` (its stage's layers); ``ax`` the mesh's
    communicators (:func:`_preamble`)."""
    seq, model, pipe, expert = ax.seq, ax.model, ax.pipe, ax.expert
    cd = cfg.compute_dtype
    Tq = tok.shape[1] if tok.dim() == 2 else 1
    emb_scale = params.get("embed_scale")
    if cfg.vocab_parallel:
        h = _vp_embed_lookup(params["embed"], tok, model,
                             scale_local=emb_scale).to(cd)
    else:
        h = params["embed"][tok].to(cd)              # (B, D) or (B, Tq, D)
        if emb_scale is not None:
            # int8 embedding rows: dequantize the gathered rows only
            h = h * emb_scale[tok][..., None].to(cd)
    if tok.dim() == 1:
        h = h[:, None, :]
    if cfg.pos_embedding == "learned":
        # per-index clipped gather: a chunk that overhangs the table (a
        # speculative round's last) spoils only its own out-of-range
        # rows; pad slots of left-padded rows clip to 0 (masked out)
        idx = pos + torch.arange(Tq, device=h.device)
        if pos_offset is not None:
            idx = idx[None, :] - pos_offset[:, None]
        rows = params["pos"][idx.clamp(0, params["pos"].shape[0] - 1)]
        h = h + (rows if pos_offset is not None else rows[None]).to(cd)
    h = h.to(cd)
    S, s = pipe.size, pipe.rank
    like = (h.shape, h.dtype)
    for p in range(S):
        if p == s:
            for i, blk in enumerate(_layers(cfg, params["blocks"])):
                h = _decode_block(cfg, h, blk, tuple(c[i] for c in cache),
                                  pos, seq, model, expert,
                                  chunk_attends_cache=chunk_attends_cache,
                                  pos_offset=pos_offset)
        if p < S - 1:
            # the one hand-off of phase p: stage p's output to p + 1
            got = _edge_send(h if s == p else None, pipe, [(p, p + 1)], like)
            if s == p + 1:
                h = got
    if not with_logits:
        return None
    B, V = h.shape[0], cfg.vocab_size
    if s != S - 1:
        # the last stage's logits, broadcast (every stage takes the same
        # argmax)
        shape = (B, Tq, V) if all_logits else (B, V)
        return _from_stage(torch.empty(shape, dtype=torch.float32,
                                       device=h.device), pipe, S - 1)
    # the decode head is a full fp32 product over the last position (every
    # position of a verify chunk); under vocab_parallel over this
    # member's rows, then the vocab shards all-gathered (the same bits on
    # every member, so every member takes the same argmax)
    hN = _rms_norm(h if all_logits else h[:, -1:], params["ln_f"])
    logits = hN.float() @ params["embed"].float().T
    if not all_logits:
        logits = logits[:, 0]
    if emb_scale is not None:
        # the per-vocab-row scale on the logits' output channel
        logits = logits * emb_scale
    if cfg.vocab_parallel and model.size > 1:
        logits = allgather(logits, model, axis=logits.dim() - 1, tiled=True)
    return _from_stage(logits, pipe, S - 1)


def _validate_prompt_lens(prompt, prompt_lens):
    P = prompt.shape[1]
    lens = np.asarray(torch.as_tensor(prompt_lens).cpu())
    if lens.shape != (prompt.shape[0],) \
            or (lens < 1).any() or (lens > P).any():
        raise ValueError(
            f"prompt_lens must be ({prompt.shape[0]},) ints in [1, {P}] "
            f"(rows RIGHT-aligned: real tokens are prompt[b, P-lens[b]:]), "
            f"got {lens}")
    return torch.as_tensor(lens, dtype=torch.int64, device=prompt.device)


def _validate_eos_pad(cfg: TransformerConfig, eos_id: int, pad_id: int):
    if eos_id >= cfg.vocab_size or (eos_id >= 0
                                    and not 0 <= pad_id < cfg.vocab_size):
        raise ValueError(
            f"eos_id={eos_id} / pad_id={pad_id} must be < vocab_size "
            f"{cfg.vocab_size} (pad in range when eos is enabled)")


def _refuse_sampling(temperature: float, top_k: int = 0,
                     top_p: float = 1.0):
    """The JAX filter checks' messages, then sampling's raise (item 12):
    every decoder here is greedy."""
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_k={top_k} must be >= 0 and top_p={top_p} in (0, 1]")
    if temperature > 0.0 or top_k > 0 or top_p < 1.0:
        raise NotImplementedError(_SAMPLING)


def _preamble(cfg: TransformerConfig, max_len: int, device, comm, mesh):
    """The decoders' shared checks (the JAX ``_decode_preamble``, its
    messages) and the mesh's communicators, loopbacks where it has no
    such axis: ``(max_len, ax)``, ``ax`` holding ``dev``, ``mesh``,
    ``seq``, ``model``, ``pipe``, ``expert`` and ``data`` (the rows'
    group over data and expert, None without a mesh)."""
    dev, mesh = _resolve(device, comm, mesh)
    if mesh is not None:
        _check_mesh(mesh, cfg)
    _check_ported(cfg, decoding=True)
    if cfg.fsdp:
        raise ValueError(
            "fsdp is a training-path layout (per-layer just-in-time "
            "weight gathers would land a collective on every generated "
            "token); decode with dataclasses.replace(cfg, fsdp=False, "
            "fsdp_wire_dtype='') and re-place the params")

    def axis(name):
        return LoopbackCommunicator(device=dev) if mesh is None \
            else mesh.comm(name)

    ax = SimpleNamespace(dev=dev, mesh=mesh, pipe=axis("pipe"),
                         seq=axis("seq"), model=axis("model"),
                         expert=axis("expert"),
                         data=None if mesh is None
                         else mesh.comm("data", "expert"))
    if ax.pipe.size > 1 and cfg.virtual_pipe > 1:
        raise ValueError(
            "pipe-parallel decode with virtual_pipe > 1 is out of "
            "scope: interleaved chunks put non-contiguous layers on "
            "each device, so the S-phase hand-off loop would need "
            "V*S phases for no capacity gain over repacking — decode "
            "with the blocks repacked to virtual_pipe=1 "
            "(V-chunk axes merge exactly; see init_transformer's "
            "layout note)")
    if cfg.n_layers % ax.pipe.size:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by the pipe mesh "
            f"axis ({ax.pipe.size})")
    max_len = max_len or cfg.max_seq
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds cfg.max_seq {cfg.max_seq}")
    if max_len % ax.seq.size:
        raise ValueError(
            f"sequence-parallel KV decode blocks the cache over the "
            f"seq axis: max_len={max_len} must be divisible by the seq "
            f"mesh axis ({ax.seq.size})")
    return max_len, ax


def _make_cache(cfg: TransformerConfig, rows: int, kv_len: int, ax):
    """The zero KV cache of this rank: ``(ck, cv)``, each
    ``(L_local, rows, kv_len_local, Hkv_local, Dh)`` (this stage's
    layers, this seq member's block of ``kv_len`` positions, this model
    member's heads) in the compute dtype, or under
    ``kv_cache_dtype="int8"`` ``(ck, cv, ck_s, cv_s)``: int8 values
    and fp32 scales ``(..., 1)``."""
    shape = (cfg.n_layers // ax.pipe.size, rows, kv_len // ax.seq.size,
             cfg.kv_heads // ax.model.size, cfg.d_head)
    if cfg.kv_cache_dtype != "int8":
        return tuple(torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=ax.dev) for _ in range(2))
    return tuple(torch.zeros(shape, dtype=torch.int8, device=ax.dev)
                 for _ in range(2)) + tuple(
        torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=ax.dev)
        for _ in range(2))


def _check_quantized(params, quantized: bool, what: str = "params"):
    if quantized != ("embed_scale" in params):
        raise ValueError(
            f"quantized={quantized} but {what} "
            + ("hold no int8 tree: pass quantize_params_int8's output"
               if quantized else
               "are an int8 tree: pass quantized=True"))


def _running(done, ax) -> bool:
    """Whether any rank of the batch rows' group (data and expert) has an
    unfinished row: the same answer on every rank of the mesh, so every
    rank takes the same number of steps (the JAX ``pmax`` over the batch
    axes)."""
    left = (~done.all()).to(torch.int32).reshape(1)
    if ax.data is not None:
        left = ax.data.allreduce(left, "max")
    return bool(left.item())


def _prefill(cfg, params, cache, prompt, offsets, ax):
    """Positions ``0..P-2`` of ``prompt`` into ``cache`` as one chunk."""
    if prompt.shape[1] > 1:
        _decode_step(cfg, params, cache, prompt[:, :-1], 0, ax,
                     with_logits=False,
                     chunk_attends_cache=offsets is not None,
                     pos_offset=offsets)


def _entry(prompt, prompt_lens, max_len, ax):
    """The global ``prompt`` as int32 on the device and this rank's rows
    of it, with the pad offsets of ``prompt_lens`` (None without)."""
    prompt = torch.as_tensor(prompt, device=ax.dev).to(torch.int32)
    if prompt.dim() != 2 or not 1 <= prompt.shape[1] <= max_len:
        raise ValueError(
            f"prompt {tuple(prompt.shape)} must be (B, P) with "
            f"1 <= P <= max_len {max_len}")
    offsets = None
    if prompt_lens is not None:
        offsets = _rows(ax.mesh, prompt.shape[1] - _validate_prompt_lens(
            prompt, prompt_lens))
    return _rows(ax.mesh, prompt), offsets


def make_generate_fn(cfg: TransformerConfig, *, max_len: int = 0,
                     temperature: float = 0.0, eos_id: int = -1,
                     pad_id: int = 0, quantized: bool = False,
                     with_row_state: bool = False,
                     with_logits: bool = False, device=None, comm=None,
                     mesh=None):
    """Build ``generate(params, prompt, prompt_lens=None) -> (B, max_len)``
    int32 tokens: greedy decoding, the JAX package's contract.

    ``prompt`` (B, P) fills positions ``0..P-1``; generation fills
    ``P..max_len-1``.  Variable-length prompts are RIGHT-aligned (real
    tokens at ``prompt[b, P-lens[b]:]``) with ``prompt_lens`` (B,).
    ``with_row_state=True`` returns ``(tokens, done, gen_len)``: rows that
    stopped on ``eos_id`` and each row's generated-token count (eos
    included, padding excluded).  ``with_logits=True`` appends the fp32
    logits of every step, ``(B, steps, V)``; step ``i`` predicts position
    ``P + i``.  ``quantized=True`` takes an int8 tree
    (:func:`~.quantization.quantize_params_int8`, sharded by
    :func:`~.transformer.shard_params` like any other).  Runs on
    ``device`` (CUDA unless ``"cpu"`` is named) under
    ``torch.inference_mode()``.

    With a ``mesh`` (a :class:`~chainermn_tpu_torch.parallel.MeshConfig`;
    ``comm`` alone is the mesh ``data=comm.size``) ``prompt`` (and
    ``prompt_lens``) is the global batch: each rank decodes and returns
    its rows over the data and expert axes, a seq axis blocks the KV
    cache over its members (``max_len`` must divide over it; left-padded
    prompts are not supported there), a model axis shards the heads (and under
    ``vocab_parallel`` the vocabulary) and a pipe axis the layers:
    ``params`` are then this rank's shard
    (:func:`~.transformer.shard_params`), and every member of a model
    group and every stage returns the same tokens."""
    _refuse_sampling(temperature)
    max_len, ax = _preamble(cfg, max_len, device, comm, mesh)
    _validate_eos_pad(cfg, eos_id, pad_id)

    def run(params, prompt, offsets):
        B, P = prompt.shape
        cache = _make_cache(cfg, B, max_len, ax)
        # with eos the loop can stop early: seed with pad so the unwritten
        # tail reads as padding
        buf = torch.full((B, max_len), max(pad_id, 0) if eos_id >= 0
                         else 0, dtype=torch.int32, device=ax.dev)
        buf[:, :P] = prompt
        _prefill(cfg, params, cache, prompt, offsets, ax)
        done = torch.zeros((B,), dtype=torch.bool, device=ax.dev)
        gen_len = torch.full((B,), max_len - P if eos_id < 0 else 0,
                             dtype=torch.int32, device=ax.dev)
        steps = []
        for t in range(P - 1, max_len - 1):
            if eos_id >= 0:
                if not _running(done, ax):
                    break
                gen_len += (~done).to(torch.int32)
            logits = _decode_step(cfg, params, cache, buf[:, t], t, ax,
                                  pos_offset=offsets)
            if with_logits:
                steps.append(logits)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if eos_id >= 0:
                # frozen rows emit pad; eos itself is written first
                nxt = torch.where(done, pad_id, nxt)
                done |= nxt == eos_id
            buf[:, t + 1] = nxt
        out = (buf, done, gen_len) if with_row_state else (buf,)
        if with_logits:
            V = cfg.vocab_size
            out += (torch.stack(steps, dim=1) if steps
                    else torch.empty((B, 0, V), device=ax.dev),)
        return out if len(out) > 1 else out[0]

    def generate(params, prompt, prompt_lens=None):
        _check_quantized(params, quantized)
        prompt, offsets = _entry(prompt, prompt_lens, max_len, ax)
        with torch.inference_mode():
            return run(params, prompt, offsets)

    return generate


def _commit_round(buf, pos: int, prop, bonus, n_acc: int):
    """Land one speculative round's outcome in ``buf``: the accepted
    prefix ``prop[:, :n_acc]`` then the ``bonus`` token; the slots past
    ``n_acc`` stay as they are."""
    buf[:, pos + 1:pos + 1 + n_acc] = prop[:, :n_acc]
    buf[:, pos + 1 + n_acc] = bonus


def _apply_eos_round(buf, pos: int, n_acc: int, k: int, done, eos_id: int,
                     pad_id: int):
    """The eos bookkeeping of one speculative or lookup round, which
    committed slots ``pos+1 .. pos+n_acc+1`` (the JAX
    ``_apply_eos_round``): per row everything after the first committed
    eos becomes ``pad_id`` (the eos itself kept), and a row that was
    already done has all its committed slots padded.  Returns the new
    ``done``."""
    slab = buf[:, pos + 1:pos + k + 2]
    j = torch.arange(k + 1, device=buf.device)
    committed = j[None, :] <= n_acc                       # (1, k+1)
    is_eos = (slab == eos_id) & committed
    # first committed eos per row; k+1 = none this round
    first = torch.where(is_eos, j[None, :], k + 1).amin(dim=1)
    mask_pad = committed & (done[:, None] | (j[None, :] > first[:, None]))
    slab.masked_fill_(mask_pad, pad_id)
    return done | (first <= n_acc)


def _verify_and_commit(cfg, params, cache, buf, pos: int, prop, k: int, ax,
                       pos_offset=None, done=None):
    """The greedy speculative round's second half, shared by the draft
    model and prompt lookup (the JAX ``_verify_and_commit``): the target
    verifies ``prop`` (B, k) in ONE (k+1)-token chunk that attends the
    cache, the accepted prefix plus the target's corrective (or bonus)
    token land in ``buf``, and the acceptance is the minimum over the
    rows' group (data and expert), one collective a round, so every
    rank runs the same rounds.  ``done`` (B,) marks eos-frozen rows,
    which report a full-``k`` acceptance so their pad-context proposals
    never bind the minimum.  Returns ``n_acc``."""
    chunk = torch.cat([buf[:, pos:pos + 1], prop], dim=1)
    tlog = _decode_step(cfg, params, cache, chunk, pos, ax, all_logits=True,
                        chunk_attends_cache=True, pos_offset=pos_offset)
    g = torch.argmax(tlog, dim=-1).to(torch.int32)        # (B, k+1)
    # g[:, j] is the target's token for position pos+j+1 given the chunk
    # through pos+j; prop[:, j] the proposer's for the same position,
    # comparable only while every earlier proposal matched
    lead = torch.cumprod((prop == g[:, :k]).to(torch.int32), dim=1)
    row_acc = lead.sum(dim=1)
    if done is not None:
        row_acc = torch.where(done, k, row_acc)
    n_acc = row_acc.amin().to(torch.int32).reshape(1)
    if ax.data is not None:
        n_acc = ax.data.allreduce(n_acc, "min")
    n_acc = int(n_acc.item())
    _commit_round(buf, pos, prop, g[:, n_acc], n_acc)
    return n_acc


def _rounds(cfg, params, prompt, offsets, max_len, k, eos_id, pad_id, ax,
            propose, extra_prefill=None):
    """The greedy speculative loop of both proposers: the target's cache
    and the token buffer padded by ``k+1`` (a round may overshoot
    ``max_len``), the prompt prefilled, then rounds while
    ``pos < max_len - 1`` (and, with eos, a row of the group runs):
    ``propose(buf, pos) -> (B, k)`` proposals, verified and committed.
    Returns ``(tokens (B, max_len), mean accepted proposals a round)``,
    the mean an fp32 scalar."""
    B, P = prompt.shape
    pad = k + 1
    cache = _make_cache(cfg, B, max_len + pad, ax)
    # pad-seed when eos can exit early (see make_generate_fn)
    buf = torch.full((B, max_len + pad), max(pad_id, 0) if eos_id >= 0
                     else 0, dtype=torch.int32, device=ax.dev)
    buf[:, :P] = prompt
    _prefill(cfg, params, cache, prompt, offsets, ax)
    if extra_prefill is not None:
        extra_prefill()
    done = torch.zeros((B,), dtype=torch.bool, device=ax.dev)
    pos, acc_sum, rounds = P - 1, 0, 0
    while pos < max_len - 1 and (eos_id < 0 or _running(done, ax)):
        prop = propose(buf, pos)
        n_acc = _verify_and_commit(cfg, params, cache, buf, pos, prop, k, ax,
                                   pos_offset=offsets,
                                   done=done if eos_id >= 0 else None)
        if eos_id >= 0:
            done = _apply_eos_round(buf, pos, n_acc, k, done, eos_id, pad_id)
        pos, acc_sum, rounds = pos + n_acc + 1, acc_sum + n_acc, rounds + 1
    mean = torch.tensor(acc_sum, dtype=torch.float32) \
        / torch.tensor(max(rounds, 1), dtype=torch.float32)
    return buf[:, :max_len], mean


def make_speculative_generate_fn(cfg: TransformerConfig,
                                 draft_cfg: TransformerConfig, *,
                                 k: int = 4, max_len: int = 0,
                                 temperature: float = 0.0,
                                 top_k: int = 0, top_p: float = 1.0,
                                 eos_id: int = -1, pad_id: int = 0,
                                 quantized: bool = False,
                                 draft_quantized: bool = False,
                                 with_stats: bool = False, device=None,
                                 comm=None, mesh=None):
    """Greedy speculative decoding (the JAX
    ``make_speculative_generate_fn`` at ``temperature=0``): a cheap
    draft model proposes ``k`` tokens a round by its own greedy steps
    (plus one cache fill for the last proposal), and the target verifies
    them in ONE ``(k+1)``-token chunk that attends its cache; the
    accepted prefix and the target's own next token land together, so a
    round emits ``1..k+1`` tokens for one read of the target's weights.
    Only verified matches are accepted, so the tokens are the target's
    own greedy decode for a dense model; under MoE a verify chunk routes
    its tokens together and can drop others than token steps drop, so
    there the tokens are the JAX package's, not necessarily greedy's.
    Acceptance is the minimum over the rows of the batch (over the
    rows' group of a mesh): every rank runs the same rounds.

    ``eos_id``/``pad_id`` stop as :func:`make_generate_fn` does (frozen
    rows report full-``k`` acceptance); ``prompt_lens`` right-aligns
    rows as there.  ``draft_cfg`` must share the vocabulary; the mesh's
    seq axis must be 1 (a verify chunk at ``pos > 0`` does not block
    over seq-KV); ``quantized``/``draft_quantized`` take int8 trees.
    Returns ``generate(params, draft_params, prompt, prompt_lens=None)
    -> (B, max_len)``, or with ``with_stats=True`` ``(tokens,
    mean_accepted)``, the mean accepted proposals a round (fp32).
    Sampling (``temperature``, ``top_k``, ``top_p``) raises (item 12)."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if temperature < 0.0:
        raise ValueError(f"temperature {temperature} must be >= 0")
    _refuse_sampling(temperature, top_k, top_p)
    _validate_eos_pad(cfg, eos_id, pad_id)
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target "
            f"{cfg.vocab_size}")
    max_len, ax = _preamble(cfg, max_len, device, comm, mesh)
    if ax.seq.size != 1:
        raise ValueError(
            "speculative decoding writes mid-sequence chunks, which "
            "the seq-KV blockwise layout does not support: use a "
            "seq=1 mesh (shard batch/heads/layers instead)")
    _preamble(draft_cfg, max_len, device, comm, mesh)

    def generate(params, draft_params, prompt, prompt_lens=None):
        _check_quantized(params, quantized)
        _check_quantized(draft_params, draft_quantized, "draft_params")
        prompt, offsets = _entry(prompt, prompt_lens, max_len, ax)
        B = prompt.shape[0]
        d_cache = _make_cache(draft_cfg, B, max_len + k + 1, ax)

        def draft_prefill():
            _prefill(draft_cfg, draft_params, d_cache, prompt, offsets, ax)

        def propose(buf, pos):
            d_cur, props = buf[:, pos], []
            for j in range(k):
                dlog = _decode_step(draft_cfg, draft_params, d_cache, d_cur,
                                    pos + j, ax, pos_offset=offsets)
                d_cur = torch.argmax(dlog, dim=-1).to(torch.int32)
                props.append(d_cur)
            # the last proposal's K/V: after a fully accepted round the
            # next one starts past pos + k, and an unwritten slot there
            # would stay a zero hole every later draft query attends
            _decode_step(draft_cfg, draft_params, d_cache, d_cur, pos + k,
                         ax, with_logits=False, pos_offset=offsets)
            return torch.stack(props, dim=1)

        with torch.inference_mode():
            toks, mean = _rounds(cfg, params, prompt, offsets, max_len, k,
                                 eos_id, pad_id, ax, propose, draft_prefill)
        return (toks, mean) if with_stats else toks

    return generate


def make_lookup_generate_fn(cfg: TransformerConfig, *, k: int = 4,
                            ngram: int = 2, max_len: int = 0,
                            eos_id: int = -1, pad_id: int = 0,
                            quantized: bool = False,
                            with_stats: bool = False, device=None,
                            comm=None, mesh=None):
    """Greedy prompt-lookup decoding (the JAX
    ``make_lookup_generate_fn``): speculative decoding whose proposer is
    an n-gram match over the token buffer, with no second model.  Each
    round takes the last ``ngram`` tokens, finds their most recent
    earlier occurrence in the ``(B, max_len + k + 1)`` buffer, proposes
    the ``k`` tokens that followed it (the buffer's first ``k`` when none
    matches), and lets the target verify them as
    :func:`make_speculative_generate_fn` does: the same tokens as greedy
    for a dense model, the same acceptance over the rows' group.
    Prompts must be at least ``ngram`` long; the mesh's seq axis must be
    1.  ``eos_id``, ``prompt_lens``, ``quantized`` and ``with_stats`` as
    there.  Returns ``generate(params, prompt, prompt_lens=None)``."""
    if k < 1 or ngram < 1:
        raise ValueError(f"k={k} and ngram={ngram} must be >= 1")
    _validate_eos_pad(cfg, eos_id, pad_id)
    max_len, ax = _preamble(cfg, max_len, device, comm, mesh)
    if ax.seq.size != 1:
        raise ValueError(
            "prompt-lookup decoding writes mid-sequence chunks, which "
            "the seq-KV blockwise layout does not support: use a "
            "seq=1 mesh (shard batch/heads/layers instead)")
    L = max_len + k + 1
    # the static window table: window w covers buf[w .. w+ngram-1] and
    # ends at position w+ngram-1
    widx = (torch.arange(L - ngram + 1)[:, None]
            + torch.arange(ngram)).to(ax.dev)
    ends = (torch.arange(L - ngram + 1) + ngram - 1).to(ax.dev)
    steps_k = torch.arange(k, device=ax.dev)

    def propose(buf, pos):
        suffix = buf[:, pos - (ngram - 1):pos + 1]
        hit = (buf[:, widx] == suffix[:, None, :]).all(-1) \
            & (ends[None, :] < pos)                       # (B, W)
        # the most recent earlier occurrence; -1 (none) proposes the
        # buffer's head, which verification corrects
        j = torch.where(hit, ends[None, :], -1).amax(dim=1)
        src = (j[:, None] + 1 + steps_k[None]).clamp(0, L - 1)
        return torch.gather(buf, 1, src)

    def generate(params, prompt, prompt_lens=None):
        _check_quantized(params, quantized)
        prompt, offsets = _entry(prompt, prompt_lens, max_len, ax)
        if prompt.shape[1] < ngram:
            raise ValueError(
                f"prompt length {prompt.shape[1]} < ngram {ngram}: the "
                "first lookup window would cross the buffer start")
        with torch.inference_mode():
            toks, mean = _rounds(cfg, params, prompt, offsets, max_len, k,
                                 eos_id, pad_id, ax, propose)
        return (toks, mean) if with_stats else toks

    return generate


def _top_k_stable(x, K: int):
    """``lax.top_k`` along the last axis: the K largest, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def make_beam_search_fn(cfg: TransformerConfig, *, beam_size: int,
                        max_len: int = 0, eos_id: int = -1,
                        length_penalty: float = 0.0,
                        quantized: bool = False, device=None, comm=None,
                        mesh=None):
    """Build ``beam_search(params, prompt, prompt_lens=None) -> (tokens,
    scores)`` (the JAX ``make_beam_search_fn``): ``K = beam_size``
    hypotheses a row advance together, each step expanding every live
    beam by the full vocabulary's log-probabilities and keeping the
    row's top K by cumulative score (ties to the lower candidate, as
    ``lax.top_k``).  The prompt is prefilled once a row and its cache
    tiled to the beams; each step then reorders every layer's cache by
    the beams' origins, in place (a gather along the rows, the int8
    scales with their values), each pipe stage its own layers and each
    seq member its own block.

    ``eos_id >= 0`` freezes a hypothesis that emits it (its score kept,
    later slots ``eos_id``); ``length_penalty`` α > 0 divides the final
    scores by GNMT's ``((5 + len)/6)^α``, ``len`` the tokens up to the
    first eos.  ``prompt_lens`` right-aligns rows as in
    :func:`make_generate_fn` (the beams share their row's offset).
    Returns ``tokens`` (B, K, max_len) int32, best first, and
    ``scores`` (B, K) fp32; over a mesh each rank its rows."""
    if beam_size < 1:
        raise ValueError(f"beam_size {beam_size} must be >= 1")
    max_len, ax = _preamble(cfg, max_len, device, comm, mesh)
    K = beam_size

    def run(params, prompt, offsets):
        B, P = prompt.shape
        # prefill at width B (the beams are identical inside the prompt)
        cache_b = _make_cache(cfg, B, max_len, ax)
        _prefill(cfg, params, cache_b, prompt, offsets, ax)
        offs = None if offsets is None else offsets.repeat_interleave(K)
        # flat row b·K + j holds row b's beam j
        cache = tuple(c.repeat_interleave(K, dim=1) for c in cache_b)
        del cache_b
        buf = torch.zeros((B, K, max_len), dtype=torch.int32, device=ax.dev)
        buf[:, :, :P] = prompt[:, None]
        # beam 0 carries the prompt; the others start dead, so the first
        # expansion draws K distinct continuations from beam 0
        scores = torch.where(torch.arange(K, device=ax.dev) == 0, 0.0,
                             _NEG)[None].expand(B, K).float()
        finished = torch.zeros((B, K), dtype=torch.bool, device=ax.dev)
        pad_tok = max(eos_id, 0)
        base = torch.arange(B, device=ax.dev)[:, None] * K
        for t in range(P - 1, max_len - 1):
            logits = _decode_step(cfg, params, cache,
                                  buf.reshape(B * K, max_len)[:, t], t, ax,
                                  pos_offset=offs)
            logp = torch.log_softmax(logits, dim=-1).reshape(B, K, -1)
            V = logp.shape[-1]
            # a finished beam proposes one candidate, itself (the last
            # column); a live one the vocabulary
            cand = torch.where(finished[..., None], _NEG, logp) \
                + scores[..., None]
            keep = torch.where(finished, scores, _NEG)
            cand = torch.cat([cand, keep[..., None]], dim=-1)
            top, idx = _top_k_stable(cand.reshape(B, K * (V + 1)), K)
            origin, token = idx // (V + 1), idx % (V + 1)
            stay = token == V
            token = torch.where(stay, pad_tok, token).to(torch.int32)
            finished = finished.gather(1, origin) | stay
            if eos_id >= 0:
                finished |= token == eos_id
            buf = buf.gather(1, origin[..., None].expand(B, K, max_len))
            buf[:, :, t + 1] = token
            flat = (base + origin).reshape(-1)
            for c in cache:
                c.copy_(c.index_select(1, flat))
            scores = top
        if length_penalty > 0.0:
            # the generated length per beam: up to its first eos
            gen = buf[:, :, P:]
            n = torch.full(gen.shape[:2], gen.shape[-1], device=ax.dev)
            if eos_id >= 0:
                is_eos = gen == eos_id
                n = torch.where(is_eos.any(-1),
                                is_eos.to(torch.int32).argmax(-1), n)
            norm = ((5.0 + n.float()) / 6.0) ** length_penalty
            scores = scores / norm.clamp_min(1e-6)
        order = torch.argsort(-scores, dim=1, stable=True)
        buf = buf.gather(1, order[..., None].expand(B, K, max_len))
        return buf, scores.gather(1, order)

    def beam_search(params, prompt, prompt_lens=None):
        _check_quantized(params, quantized)
        prompt, offsets = _entry(prompt, prompt_lens, max_len, ax)
        with torch.inference_mode():
            return run(params, prompt, offsets)

    return beam_search
