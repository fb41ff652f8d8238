"""Greedy autoregressive decoding with a KV cache for the flagship
transformer, on one device or over a mesh's data, seq and model axes.

Counterpart of ``make_generate_fn`` in ``chainermn_tpu/models/decoding.py``
with the same semantics step for step:

- the KV cache holds ``max_len`` slots at the shared (GQA) head width in
  the compute dtype; the port writes it in place;
- prefill runs prompt positions ``0..P-2`` as ONE chunk, attending the
  chunk's own K/V through plain ``local_attention`` (it is XLA in the
  reference, not the flash kernel); left-padded prompts take the
  cache-attending path instead, with per-row validity and per-row
  positions;
- token steps start at the last prompt position ``P-1``; each attends
  the whole cache with later slots masked, and the head is a full fp32
  product over the last position;
- ``eos_id >= 0`` freezes a row after it emits eos (later slots get
  ``pad_id``) and stops once every row is done.

Over a mesh (``mesh=``, or ``comm=`` as the mesh ``data=N``) each rank
decodes its rows of the batch (the data and expert axes), and every
rank runs the same number of steps: the stop is taken when no rank of
the rows' group has an unfinished row.  Under MoE each block's MLP is
the training one: every prefill chunk and every token step routes its
own tokens, over the expert axis's all-to-alls.  A seq axis of ``R``
members blocks the cache's length (sequence-parallel KV): member ``r``
holds positions ``[r·Tl, (r+1)·Tl)``, ``Tl = max_len/R``; prefill
writes each member's block, a token step writes on the owning member
only, and attention is the distributed softmax (a max of the row
maxima, then sums of the exp-sums and of the value partials over the
seq group).  A model axis of ``M`` members shards the heads (tensor
parallelism): each member's cache holds its ``Hkv/M`` K/V heads, each
block runs its column→row products over the model communicator, and
under ``vocab_parallel`` the embedding lookup is the masked gather with
one all-reduce and the head the fp32 product over the member's vocab
rows, all-gathered: every member holds the same full logits, bit for
bit, and takes the same argmax.  A pipe axis of ``S`` stages shards the
layers: each stage holds only its blocks and their cache, ``(L/S, rows,
kv_len, Hkv/M, Dh)``; stage ``p`` runs its layers in phase ``p`` of
each step only (the JAX package runs every phase on every stage and
masks), the hidden state goes ``p → p+1`` by one transfer, and the last
stage's logits reach every stage by a broadcast.

Sampling (``temperature > 0``) and int8 weights and int8 KV cache come
in later slices and raise here.
"""

from __future__ import annotations

import numpy as np
import torch

from chainermn_tpu_torch.communicators.loopback import LoopbackCommunicator
from chainermn_tpu_torch.ops.collectives import allgather
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

__all__ = ["make_generate_fn"]


def _decode_block(cfg: TransformerConfig, h, blk, ck, cv, pos: int, seq,
                  model, expert, chunk_attends_cache: bool = False,
                  pos_offset=None):
    """One block for a chunk of new tokens ``h`` (B, Tq, D) whose first
    token sits at position ``pos``.  ``ck``/``cv`` are this layer's
    (B, kv_len_local, Hkv_local, Dh) cache, written in place: the whole
    ``max_len``, or under sequence-parallel KV (``seq``, the seq
    communicator, of size R > 1) this member's block of ``max_len/R``
    positions; ``blk`` is this rank's shard over ``model`` (the model
    communicator), whose heads the cache holds, and over ``expert`` (the
    expert communicator), whose experts the MoE MLP reaches."""
    cd = cfg.compute_dtype
    x = _rms_norm(h, blk["ln1"])
    B, Tq, D = x.shape
    R, r = seq.size, seq.rank
    Tl = ck.shape[1]
    if "wqkv" in blk:
        H = blk["wqkv"].shape[2]
        qkv = column_parallel_dense(x, blk["wqkv"].reshape(D, -1).to(cd),
                                    comm=model)
        qkv = qkv.reshape(B, Tq, 3, H, cfg.d_head)
        q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        H = blk["wq"].shape[1]
        Hkv = blk["wkv"].shape[2]
        q = column_parallel_dense(x, blk["wq"].reshape(D, -1).to(cd),
                                  comm=model).reshape(B, Tq, H, cfg.d_head)
        kv = column_parallel_dense(x, blk["wkv"].reshape(D, -1).to(cd),
                                   comm=model
                                   ).reshape(B, Tq, 2, Hkv, cfg.d_head)
        k_new, v_new = kv[:, :, 0], kv[:, :, 1]
    qpos = pos + torch.arange(Tq, device=x.device)             # (Tq,)
    if cfg.pos_embedding == "rope":
        # left-padded rows: slot s holds the row's token number s - offset
        rpos = qpos if pos_offset is None else (
            qpos[None, :] - pos_offset[:, None]).clamp_min(0)
        q = apply_rope(q, rpos, cfg.rope_theta)
        k_new = apply_rope(k_new, rpos, cfg.rope_theta)
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
    if Tq > 1 and R > 1:
        # blockwise prefill write (pos == 0): this member's rows of the
        # chunk, [r·Tl, r·Tl + Tl) ∩ [0, Tq)
        lo, hi = r * Tl, min(r * Tl + Tl, Tq)
        if hi > lo:
            ck[:, :hi - lo] = k_new[:, lo:hi]
            cv[:, :hi - lo] = v_new[:, lo:hi]
    elif R > 1:
        # a token step: member pos // Tl owns the position
        if pos // Tl == r:
            ck[:, pos % Tl:pos % Tl + Tq] = k_new
            cv[:, pos % Tl:pos % Tl + Tq] = v_new
    else:
        ck[:, pos:pos + Tq] = k_new
        cv[:, pos:pos + Tq] = v_new
    if Tq > 1 and not chunk_attends_cache:
        # prefill at pos 0: the chunk's own K/V (in hand on every
        # member) are all it may attend
        o = local_attention(q, k_new, v_new, causal=True,
                            window=cfg.attention_window or None)
    else:
        s = _qk_scores(q, ck) * (cfg.d_head ** -0.5)           # (B,H,Tq,Tl)
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
            o = seq.allreduce(_pv_mix(e, cv), "sum")
            o = (o / n).transpose(1, 2)                        # (B,Tq,H,Dh)
        else:
            o = _pv_mix(torch.softmax(s, dim=-1), cv).transpose(1, 2)
    h = h + row_parallel_dense(
        o.reshape(B, Tq, -1), blk["wo"].reshape(-1, D).to(cd), comm=model)
    # the training MLP: under MoE each call routes its own B·Tq tokens
    # (a prefill chunk and a token step have different capacities, and a
    # step may drop tokens, as the JAX decode does)
    return _mlp(cfg, h, blk, model, expert)[0]


def _decode_step(cfg: TransformerConfig, params, caches, tok, pos: int,
                 seq, model, pipe, expert, with_logits: bool = True,
                 chunk_attends_cache=False, pos_offset=None):
    """Next-token fp32 logits (B, V) for ``tok`` — (B,) in the generation
    loop, or a (B, Tq) chunk starting at ``pos`` for prefill
    (``with_logits=False`` then skips the head).  ``caches`` is the
    ``(ck, cv)`` pair of (L_local, B, kv_len_local, Hkv_local, Dh)
    buffers; ``params`` this rank's shard over ``model`` and ``pipe``
    (its stage's layers)."""
    cd = cfg.compute_dtype
    Tq = tok.shape[1] if tok.dim() == 2 else 1
    if cfg.vocab_parallel:
        h = _vp_embed_lookup(params["embed"], tok, model).to(cd)
    else:
        h = params["embed"][tok].to(cd)              # (B, D) or (B, Tq, D)
    if tok.dim() == 1:
        h = h[:, None, :]
    if cfg.pos_embedding == "learned":
        # per-index clipped gather (pad slots of left-padded rows clip
        # to 0; attention masks them out)
        idx = pos + torch.arange(Tq, device=h.device)
        if pos_offset is not None:
            idx = idx[None, :] - pos_offset[:, None]
        rows = params["pos"][idx.clamp(0, params["pos"].shape[0] - 1)]
        h = h + (rows if pos_offset is not None else rows[None]).to(cd)
    h = h.to(cd)
    ck, cv = caches
    S, s = pipe.size, pipe.rank
    like = (h.shape, h.dtype)
    for p in range(S):
        if p == s:
            for i, blk in enumerate(_layers(cfg, params["blocks"])):
                h = _decode_block(cfg, h, blk, ck[i], cv[i], pos, seq, model,
                                  expert,
                                  chunk_attends_cache=chunk_attends_cache,
                                  pos_offset=pos_offset)
        if p < S - 1:
            # the one hand-off of phase p: stage p's output to p + 1
            got = _edge_send(h if s == p else None, pipe, [(p, p + 1)], like)
            if s == p + 1:
                h = got
    if not with_logits:
        return None
    if s != S - 1:
        # the last stage's logits, broadcast (every stage takes the same
        # argmax)
        V = cfg.vocab_size
        return _from_stage(torch.empty((h.shape[0], V), dtype=torch.float32,
                                       device=h.device), pipe, S - 1)
    # the decode head is a full fp32 product over the last position;
    # under vocab_parallel over this member's rows, then the vocab
    # shards all-gathered (the same bits on every member, so every
    # member takes the same argmax)
    hN = _rms_norm(h[:, -1:], params["ln_f"])
    logits = (hN.float() @ params["embed"].float().T)[:, 0]
    if cfg.vocab_parallel and model.size > 1:
        logits = allgather(logits, model, axis=1, tiled=True)
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
    ``P + i``.  Runs on ``device`` (CUDA unless ``"cpu"`` is named) under
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
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported yet; it comes with the "
            "serving slice (ROADMAP Queue A item 12)")
    if quantized:
        raise NotImplementedError(
            "int8 weights are not ported yet; they come with the "
            "quantization slice (ROADMAP Queue A item 9)")
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
    pipe = LoopbackCommunicator(device=dev) if mesh is None \
        else mesh.comm("pipe")
    if pipe.size > 1 and cfg.virtual_pipe > 1:
        raise ValueError(
            "pipe-parallel decode with virtual_pipe > 1 is out of "
            "scope: interleaved chunks put non-contiguous layers on "
            "each device, so the S-phase hand-off loop would need "
            "V*S phases for no capacity gain over repacking — decode "
            "with the blocks repacked to virtual_pipe=1 "
            "(V-chunk axes merge exactly; see init_transformer's "
            "layout note)")
    if cfg.n_layers % pipe.size:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by the pipe mesh "
            f"axis ({pipe.size})")
    _validate_eos_pad(cfg, eos_id, pad_id)
    max_len = max_len or cfg.max_seq
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds cfg.max_seq {cfg.max_seq}")
    seq = LoopbackCommunicator(device=dev) if mesh is None \
        else mesh.comm("seq")
    model = LoopbackCommunicator(device=dev) if mesh is None \
        else mesh.comm("model")
    if max_len % seq.size:
        raise ValueError(
            f"sequence-parallel KV decode blocks the cache over the "
            f"seq axis: max_len={max_len} must be divisible by the seq "
            f"mesh axis ({seq.size})")
    expert = LoopbackCommunicator(device=dev) if mesh is None \
        else mesh.comm("expert")
    data = None if mesh is None else mesh.comm("data", "expert")

    def running(done):
        """Whether any rank of the batch rows' group (data and expert)
        has an unfinished row: the same answer on every rank of the
        mesh, so every rank takes the same number of steps (the JAX
        ``pmax`` over the batch axes)."""
        left = (~done.all()).to(torch.int32).reshape(1)
        if data is not None:
            left = data.allreduce(left, "max")
        return bool(left.item())

    def run(params, prompt, offsets):
        B, P = prompt.shape
        cd = cfg.compute_dtype
        # this stage's layers only
        cache = torch.zeros((2, cfg.n_layers // pipe.size, B,
                             max_len // seq.size,
                             cfg.kv_heads // model.size, cfg.d_head),
                            dtype=cd, device=dev)
        caches = (cache[0], cache[1])
        # with eos the loop can stop early: seed with pad so the unwritten
        # tail reads as padding
        buf = torch.full((B, max_len), max(pad_id, 0) if eos_id >= 0
                         else 0, dtype=torch.int32, device=dev)
        buf[:, :P] = prompt
        if P > 1:
            _decode_step(cfg, params, caches, prompt[:, :P - 1], 0, seq,
                         model, pipe, expert, with_logits=False,
                         chunk_attends_cache=offsets is not None,
                         pos_offset=offsets)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        gen_len = torch.full((B,), max_len - P if eos_id < 0 else 0,
                             dtype=torch.int32, device=dev)
        steps = []
        for t in range(P - 1, max_len - 1):
            if eos_id >= 0:
                if not running(done):
                    break
                gen_len += (~done).to(torch.int32)
            logits = _decode_step(cfg, params, caches, buf[:, t], t, seq,
                                  model, pipe, expert, pos_offset=offsets)
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
                    else torch.empty((B, 0, V), device=dev),)
        return out if len(out) > 1 else out[0]

    def generate(params, prompt, prompt_lens=None):
        prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
        if prompt.dim() != 2 or not 1 <= prompt.shape[1] <= max_len:
            raise ValueError(
                f"prompt {tuple(prompt.shape)} must be (B, P) with "
                f"1 <= P <= max_len {max_len}")
        offsets = None
        if prompt_lens is not None:
            offsets = _rows(mesh, prompt.shape[1] - _validate_prompt_lens(
                prompt, prompt_lens))
        with torch.inference_mode():
            return run(params, _rows(mesh, prompt), offsets)

    return generate
