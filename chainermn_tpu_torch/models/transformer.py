"""The flagship decoder-only transformer's inference forward, on one
device.

Counterpart of ``chainermn_tpu/models/transformer.py`` at a trivial mesh
(every axis of size 1): the same config, the same parameter layout (with
the pipe axis squeezed, see :mod:`.convert`) and the same mixed
precision:

- params fp32; the residual stream in the compute dtype (bf16) from the
  embedding on; products take compute-dtype operands;
- :func:`_rms_norm` in fp32 with ``eps=1e-6`` inside the ``rsqrt``, cast
  back to the input dtype;
- the weight-tied LM head takes compute-dtype operands with fp32
  accumulation and returns fp32 logits.

``attention="flash"`` runs the Hopper flash-attention kernel wherever
:func:`flash_attention_supported` passes (K/V broadcast to query width
first) and ``local_attention`` otherwise; ``attention="local"`` is the
plain path.  Training (loss, backward kernels, optimizer) is the next
slice; MoE, FSDP, vocab parallelism, ring/Ulysses attention and pipeline
micro-batching come with the parallel slice and raise here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_supported,
)
from chainermn_tpu_torch.parallel.ring_attention import (
    broadcast_kv,
    local_attention,
)
from chainermn_tpu_torch.parallel.tensor import (
    column_parallel_dense,
    row_parallel_dense,
)

__all__ = [
    "TransformerConfig",
    "apply_rope",
    "make_forward_fn",
    "transformer_backbone",
    "transformer_forward",
]

_PARALLEL_SLICE = "the parallel slice (ROADMAP Queue A item 8)"


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field (see its comments for
    what each field means).  Fields read only by training (``remat*``,
    ``flash_bwd_block_*``, ``loss_chunk``, ``pipeline_schedule``) are
    kept so one config describes the model in both packages."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 0    # 0 => n_heads (MHA); fewer => GQA, 1 => MQA
    d_head: int = 64
    d_ff: int = 2048
    n_layers: int = 4
    max_seq: int = 2048
    attention: str = "ring"    # "ring" | "ulysses" | "local" | "flash"
    flash_bwd_block_q: int = 0
    flash_bwd_block_k: int = 0
    attention_window: int = 0  # 0 => full causal; W>0 => (t-W, t]
    pos_embedding: str = "learned"  # "learned" | "rope"
    rope_theta: float = 10000.0
    seq_layout: str = "contiguous"
    moe: bool = False
    n_experts: int = 8
    router_top_k: int = 1
    capacity_factor: float = 1.25
    num_microbatches: int = 1
    pipeline_schedule: str = "gpipe"
    virtual_pipe: int = 1
    fsdp: bool = False
    fsdp_wire_dtype: str = ""
    vocab_parallel: bool = False
    loss_chunk: int = 0
    kv_cache_dtype: str = ""   # "" => compute dtype; "int8" not ported
    remat: bool = True
    remat_policy: str = "full"
    dtype: str = "bfloat16"    # compute dtype (params stay fp32)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def __post_init__(self):
        if self.attention_window < 0:
            raise ValueError(
                f"attention_window {self.attention_window} must be >= 0")
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding {self.pos_embedding!r} not in "
                "(learned, rope)")
        if self.pos_embedding == "rope" and self.d_head % 2:
            raise ValueError(
                f"rope needs an even d_head, got {self.d_head}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy {self.remat_policy!r} not in (full, dots)")
        if self.kv_cache_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r} not in "
                "('', 'int8')")
        if self.loss_chunk < 0:
            raise ValueError(
                f"loss_chunk={self.loss_chunk} must be >= 0")
        if self.moe and not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]")
        if self.virtual_pipe < 1:
            raise ValueError(
                f"virtual_pipe={self.virtual_pipe} must be >= 1")
        if self.virtual_pipe > 1 and self.pipeline_schedule != "interleaved":
            raise ValueError(
                f"virtual_pipe={self.virtual_pipe} needs "
                'pipeline_schedule="interleaved" (got '
                f"{self.pipeline_schedule!r})")
        if not 0 <= self.n_kv_heads <= self.n_heads:
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be in "
                f"[0, n_heads={self.n_heads}] (0 means MHA)")
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must be a multiple of "
                f"n_kv_heads={self.kv_heads}")
        if self.fsdp_wire_dtype:
            wire = getattr(torch, self.fsdp_wire_dtype, None)
            if not (isinstance(wire, torch.dtype)
                    and wire.is_floating_point):
                raise ValueError(
                    f"fsdp_wire_dtype {self.fsdp_wire_dtype!r} must "
                    "name a floating dtype")
        if self.fsdp_wire_dtype and not self.fsdp:
            raise ValueError("fsdp_wire_dtype is set but fsdp=False")
        _torch_dtype(self.dtype)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not (isinstance(dt, torch.dtype) and dt.is_floating_point):
        raise ValueError(f"dtype {name!r} is not a floating torch dtype")
    return dt


def _check_ported(cfg: TransformerConfig, *, decoding: bool):
    """Raise ``NotImplementedError`` for options a later slice ports."""
    unported = [
        ("moe", cfg.moe, _PARALLEL_SLICE),
        ("vocab_parallel", cfg.vocab_parallel, _PARALLEL_SLICE),
        ("virtual_pipe > 1", cfg.virtual_pipe > 1, _PARALLEL_SLICE),
    ]
    if decoding:
        unported.append(
            ('kv_cache_dtype="int8"', cfg.kv_cache_dtype == "int8",
             "the quantization slice (ROADMAP Queue A item 9)"))
    else:
        unported += [
            ("fsdp", cfg.fsdp, _PARALLEL_SLICE),
            (f"attention={cfg.attention!r}",
             cfg.attention in ("ring", "ulysses"), _PARALLEL_SLICE),
            ('seq_layout="zigzag"', cfg.seq_layout == "zigzag",
             _PARALLEL_SLICE),
            ("num_microbatches > 1", cfg.num_microbatches > 1,
             _PARALLEL_SLICE),
        ]
    for name, hit, where in unported:
        if hit:
            raise NotImplementedError(
                f"{name} is not ported to chainermn_tpu_torch yet; it "
                f"comes with {where}")
    if not decoding and cfg.attention not in ("local", "flash"):
        raise ValueError(cfg.attention)


def _rms_norm(x, scale):
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * r * scale).to(x.dtype)


def _lm_head(cd, h, embed):
    """Weight-tied head: ``cd``-rounded operands, fp32 accumulation and
    fp32 logits.  On CUDA a half-precision product writes fp32 output
    directly (cuBLAS); elsewhere the same function runs as an fp32
    product of the rounded operands' values."""
    a, w = h.to(cd), embed.to(cd)
    if a.is_cuda and cd in (torch.bfloat16, torch.float16):
        out = torch.mm(a.reshape(-1, a.shape[-1]), w.T,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[0])
    return a.float() @ w.float().T


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary embedding (rotate-half) on ``x`` (..., T, H, D) at absolute
    ``positions``: ``(T,)`` shared across the batch or ``(B, T)`` per
    row."""
    half = x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs           # (..., T, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)       # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(cfg: TransformerConfig, h, blk):
    """Pre-LN attention: QKV projection, the attention core, output
    projection and residual."""
    cd = cfg.compute_dtype
    win = cfg.attention_window or None
    x = _rms_norm(h, blk["ln1"])
    B, T, D = x.shape
    if "wqkv" in blk:
        H = blk["wqkv"].shape[2]
        qkv = column_parallel_dense(x, blk["wqkv"].reshape(D, -1).to(cd))
        qkv = qkv.reshape(B, T, 3, H, cfg.d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        # GQA/MQA: one fused projection over the concatenated weights,
        # as the JAX package does; K/V stay at the shared width
        H = blk["wq"].shape[1]
        Hkv = blk["wkv"].shape[2]
        dq = H * cfg.d_head
        fused = torch.cat(
            [blk["wq"].reshape(D, -1), blk["wkv"].reshape(D, -1)],
            dim=1).to(cd)
        qkv = column_parallel_dense(x, fused)
        q = qkv[..., :dq].reshape(B, T, H, cfg.d_head)
        kv = qkv[..., dq:].reshape(B, T, 2, Hkv, cfg.d_head)
        k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.pos_embedding == "rope":
        pos = torch.arange(T, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.attention == "flash" and flash_attention_supported(
            T, T, cfg.d_head):
        k, v = broadcast_kv(k, v, q.shape[2] // k.shape[2])
        o = flash_attention(q, k, v, causal=True, window=win)
    else:
        # "local", or a shape the kernel does not take (grouped K/V read
        # in place, no broadcast)
        o = local_attention(q, k, v, causal=True, window=win)
    o = row_parallel_dense(
        o.reshape(B, T, -1), blk["wo"].reshape(-1, D).to(cd))
    return h + o


def _mlp(cfg: TransformerConfig, h, blk):
    cd = cfg.compute_dtype
    x = _rms_norm(h, blk["ln2"])
    y = torch.relu(column_parallel_dense(x, blk["w1"].to(cd)))
    return h + row_parallel_dense(y, blk["w2"].to(cd))


def _layer(params, i: int) -> dict:
    """Layer ``i``'s block parameters (views into the stacked leaves)."""
    return {name: leaf[i] for name, leaf in params["blocks"].items()}


def transformer_backbone(cfg: TransformerConfig, params, tokens):
    """Embedding → block stack → final norm: the normed
    ``(B, T, d_model)`` hidden states in the compute dtype."""
    cd = cfg.compute_dtype
    B, T = tokens.shape
    if T > cfg.max_seq:
        raise ValueError(f"sequence length {T} exceeds max_seq "
                         f"{cfg.max_seq}")
    h = params["embed"][tokens]                          # (B, T, D) fp32
    if cfg.pos_embedding == "rope":
        h = h.to(cd)              # rotations happen inside attention
    else:
        h = (h + params["pos"][:T]).to(cd)
    for i in range(cfg.n_layers):
        blk = _layer(params, i)
        h = _mlp(cfg, _attention(cfg, h, blk), blk)
    return _rms_norm(h, params["ln_f"])


def transformer_forward(cfg: TransformerConfig, params, tokens):
    """``(B, T, vocab)`` fp32 logits through the weight-tied head."""
    h = transformer_backbone(cfg, params, tokens)
    return _lm_head(cfg.compute_dtype, h, params["embed"])


def make_forward_fn(cfg: TransformerConfig, device=None):
    """``fn(params, tokens) -> logits``: the scoring entry point.

    Runs on ``device`` (CUDA unless ``device="cpu"`` is given) under
    ``torch.inference_mode()``.  ``params`` come from
    :func:`.convert.params_from_jax` on the same device; ``tokens`` is
    ``(B, T)`` integers (array or tensor)."""
    dev = resolve_device(device)
    _check_ported(cfg, decoding=False)

    def forward(params, tokens):
        tokens = torch.as_tensor(tokens, device=dev)
        with torch.inference_mode():
            return transformer_forward(cfg, params, tokens)

    return forward
