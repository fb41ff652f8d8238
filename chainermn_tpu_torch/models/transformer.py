"""The flagship decoder-only transformer: the scoring forward and
training, on one device or over a mesh's data, seq and model axes.

Counterpart of ``chainermn_tpu/models/transformer.py``: the same
config, the same parameter layout (with the pipe axis squeezed, see
:mod:`.convert`) and the same mixed precision:

- params fp32; the residual stream in the compute dtype (bf16) from the
  embedding on; products take compute-dtype operands;
- :func:`_rms_norm` in fp32 with ``eps=1e-6`` inside the ``rsqrt``, cast
  back to the input dtype;
- the weight-tied LM head takes compute-dtype operands with fp32
  accumulation and returns fp32 logits; its backward (the JAX custom
  VJP) runs both gradient products on compute-dtype operands too.

``attention="flash"`` runs the Hopper flash-attention kernels (forward,
and the dq and dk/dv kernels in the backward) wherever
:func:`flash_attention_supported` passes (K/V broadcast to query width
first) and ``local_attention`` otherwise; ``attention="local"`` is the
plain path.  Training is :func:`lm_loss` (optionally with the chunked
head of ``loss_chunk``), remat (each block under
``torch.utils.checkpoint``: ``remat_policy="full"`` keeps only the
block's input, ``"dots"`` also the JAX policy's saves, see
:func:`_dots_context`) and :func:`make_train_step`.

The mesh has a pipe, a data, an expert, a sequence and a model axis (a
:class:`MeshConfig` over the world communicator; ``comm=`` alone is the
mesh ``data=N``).
:func:`make_value_and_grad_fn`, :func:`make_train_step` and
:func:`make_forward_fn` work per rank, one process a device: rank ``r``
takes its rows of the global batch over ``data`` and ``expert`` and
its block of columns over ``seq`` (the JAX ``_BATCH_SPEC``), and holds
its shard of
the parameters over ``model`` (:func:`shard_params`, the JAX
``param_specs``: the heads of ``wqkv``/``wq``/``wkv`` and ``wo``,
``w1``'s columns and ``w2``'s rows, and under ``vocab_parallel``
``embed``'s rows).  Each block's QKV and ``w1`` products are
column-parallel and its ``wo`` and ``w2`` products row-parallel over the
model communicator (one all-reduce a pair forward, one backward), and
the attention core runs on the rank's ``H/M`` query and ``Hkv/M`` K/V
heads.  ``vocab_parallel`` looks the embedding up by a masked gather
and one all-reduce, and takes the loss over the vocab shards with three
query-sized reductions (Megatron's vocab-parallel cross-entropy).
``attention="ring"``
rotates K/V over the seq communicator and runs the flash kernel once a
pair (:func:`~chainermn_tpu_torch.parallel.ring_attention`, in the
``contiguous`` or ``zigzag`` ``seq_layout``); ``"ulysses"`` exchanges
heads for the sequence and runs the kernel on the whole sequence.  RoPE
and learned positions are the block's GLOBAL positions.  The loss is
meaned over the batch-like group ``(data, expert, seq)`` and so are the
gradients, in fp32 by ``multi_node_mean_grad``: every parameter is
replicated over those axes, and the ring's (or the exchange's) backward
has already delivered the other blocks' contributions to each rank; a
model-sharded leaf's mean is over its own shard's group.

The mesh's pipe axis shards the layers (:mod:`..parallel.pipeline`):
each rank holds its stage's blocks, ``(L/S, ...)``, or under
``virtual_pipe = V`` its ``V`` chunks, ``(V, L/(S·V), ...)`` (chunk
``c`` of stage ``s`` is virtual stage ``c·S + s``), cut from the whole
tree by :func:`shard_params` (the JAX ``param_specs``' pipe entries).
The block stack runs as GPipe (:func:`~..parallel.pipeline.
pipeline_apply`) whenever the pipe axis or ``num_microbatches`` is
above 1, the ``V`` chunk rings one after the other when ``virtual_pipe
> 1``, with remat a stage application at a time; ``pipeline_schedule=
"1f1b"|"interleaved"`` puts the final norm, the tied head and the loss
inside the schedule (:func:`_grad_1f1b`, the JAX ``_make_1f1b_grad``).
The leaves replicated over pipe (``embed``, ``pos``, ``ln_f``) get the
same gradient bits on every pipe rank: every stage computes the same
head and embedding on the same broadcast values.

``moe=True`` makes every block's MLP a Switch (``router_top_k=1``) or
GShard (``> 1``) mixture of ``n_experts`` experts
(:func:`~chainermn_tpu_torch.parallel.expert.expert_parallel_moe`),
whose balancing loss rides the block stack (``(h, aux)`` through the
blocks and the pipeline schedules) into the loss as ``0.01·aux``.  The
mesh's expert axis holds ``E/X`` experts a rank (``w1``/``w2``'s expert
dim, :func:`shard_params`) and is a batch axis outside the MLP: the
rows of the batch are split over ``(data, expert)`` together, and
inside each MoE MLP one all-to-all each way moves the tokens to their
experts' ranks and back.  An expert's gradient already holds the
contributions of every rank of its expert group (the all-to-all's
backward brings them), so ``w1``/``w2`` are summed over ``(data, seq)``
only and divided by the batch-like group's size; every other leaf is
meaned over ``(data, expert, seq)``.

``fsdp=True`` (ZeRO-3, the JAX ``fsdp``) keeps every block matrix's
d_model dim sharded over ``data`` at rest (:func:`_fsdp_dims`, cut last
by :func:`shard_params`; the norm scales, ``embed`` and ``pos`` stay
whole).  Each block all-gathers its weights over the data communicator
just before use (:func:`_fsdp_gather`, in ``fsdp_wire_dtype`` when
set), so the flash kernels see the full weights and launch as often as
without FSDP, and the gathers' backward reduce-scatters the gradients:
a sharded leaf's gradient leaves the backward summed over ``data`` at
shard width, is then summed over ``(expert, seq)`` (the experts'
``w1``/``w2`` over ``seq``) and divided by ``D·X·S``.  Gradients and
the optimizer's moments stay at shard width.  Under remat the block's
recompute gathers again and the gathered weights do not outlive the
block; without remat autograd keeps every block's gathered weights for
the backward, as XLA does in the JAX package.  Decoding refuses an
``fsdp`` config, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
    set_checkpoint_early_stop,
)

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.communicators.loopback import LoopbackCommunicator
from chainermn_tpu_torch.ops.collectives import allgather, allreduce
from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_supported,
)
from chainermn_tpu_torch.parallel.expert import expert_parallel_moe
from chainermn_tpu_torch.parallel.fsdp import fsdp_gather
from chainermn_tpu_torch.parallel.mesh import BATCH_AXES, MeshConfig
from chainermn_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_train_1f1b,
    pipeline_train_interleaved,
)
from chainermn_tpu_torch.parallel.ring_attention import (
    _block_positions,
    broadcast_kv,
    local_attention,
    ring_attention,
)
from chainermn_tpu_torch.parallel.ulysses import ulysses_attention
from chainermn_tpu_torch.parallel.tensor import (
    column_parallel_dense,
    reduce_from_model,
    row_parallel_dense,
)

__all__ = [
    "TransformerConfig",
    "apply_rope",
    "lm_loss",
    "make_forward_fn",
    "make_train_step",
    "make_value_and_grad_fn",
    "gather_params",
    "regroup_blocks",
    "reshard_train_state",
    "shard_params",
    "transformer_backbone",
    "transformer_forward",
]

# the JAX MeshConfig's axes
_MESH_AXES = ("pipe", "data", "expert", "seq", "model")
# the coefficient of the Switch balancing loss in the training objective
# (the JAX _AUX_WEIGHT, the same on every schedule)
_AUX_WEIGHT = 0.01


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
    kv_cache_dtype: str = ""   # "" => compute dtype; "int8": int8 + scales
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


def _check_ported(cfg: TransformerConfig, *, decoding: bool = False,
                  training: bool = False):
    """The config checks of an entry point: the JAX package's messages
    for a schedule, an attention or a layout it does not know."""
    if training and cfg.pipeline_schedule not in ("gpipe", "1f1b",
                                                  "interleaved"):
        raise ValueError(
            "pipeline_schedule must be gpipe|1f1b|interleaved, got "
            f"{cfg.pipeline_schedule!r}")
    if not decoding and cfg.attention not in ("local", "flash", "ring",
                                              "ulysses"):
        raise ValueError(cfg.attention)
    if not decoding and cfg.seq_layout == "zigzag" \
            and cfg.attention != "ring":
        raise ValueError(
            'seq_layout="zigzag" is a ring-attention layout; '
            f'attention={cfg.attention!r} expects contiguous shards')


def _check_mesh(mesh, cfg: TransformerConfig):
    """The JAX ``_check_mesh``'s config/mesh divisibility checks, with
    its messages, on ``mesh``: a :class:`MeshConfig` or a mapping of
    axis sizes (``{"data": 4}``; missing axes are 1)."""
    mesh = getattr(mesh, "shape", mesh)
    unknown = set(mesh) - set(_MESH_AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} not in {_MESH_AXES}")
    mp = mesh.get("model", 1)
    sp = mesh.get("seq", 1)
    if cfg.n_heads % mp:
        raise ValueError(
            f"n_heads={cfg.n_heads} must be divisible by the model mesh "
            f"axis ({mp})")
    if cfg.kv_heads % mp:
        raise ValueError(
            f"n_kv_heads={cfg.kv_heads} must be divisible by the model "
            f"mesh axis ({mp}); raise n_kv_heads or shrink the model "
            "axis (shared kv heads shard over the same axis as query "
            "heads)")
    if cfg.attention == "ulysses" and sp > 1 \
            and (cfg.n_heads // mp) % sp:
        raise ValueError(
            f"attention='ulysses' splits query heads over the seq axis: "
            f"n_heads/model ({cfg.n_heads}/{mp}) must be divisible by "
            f"the seq mesh axis ({sp}).  Shared kv heads need NOT "
            "divide — they replicate up to lcm for the exchange — and "
            "ring attention keeps them at true width if the surplus "
            "factor matters")
    if cfg.vocab_parallel and cfg.vocab_size % mp:
        raise ValueError(
            f"vocab_parallel shards the vocab dim over the model axis: "
            f"vocab_size={cfg.vocab_size} must be divisible by {mp}")
    dp = mesh.get("data", 1)
    if cfg.fsdp and cfg.d_model % dp:
        raise ValueError(
            f"fsdp shards every matrix's d_model dim over the data "
            f"axis: d_model={cfg.d_model} must be divisible by the "
            f"data mesh axis ({dp})")


def _rms_norm(x, scale):
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * r * scale).to(x.dtype)


def _mm32(a, b):
    """``a @ b`` of 2-D compute-dtype operands with fp32 accumulation and
    fp32 output.  On CUDA a half-precision product writes fp32 directly
    (cuBLAS); elsewhere the same function runs as an fp32 product of the
    operands' values."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LMHead(torch.autograd.Function):
    """The JAX ``_lm_head`` custom VJP: the logit cotangent, which is
    unit-scale, goes to the compute dtype, so both gradient products take
    compute-dtype operands; the gradients leave in the primal dtypes.
    With a ``model`` communicator ``embed`` is this member's vocab shard
    (the JAX ``_vp_head``): ``h`` is the same on every member and each
    shard's slice consumes it, so ``dh`` is summed over ``model`` after
    its cast to the primal dtype; the shard's ``dw`` is never summed."""

    @staticmethod
    def forward(ctx, h, embed, cd, model):
        ctx.save_for_backward(h, embed)
        ctx.cd, ctx.model = cd, model
        a = h.reshape(-1, h.shape[-1]).to(cd)
        out = _mm32(a, embed.to(cd).T)
        return out.reshape(*h.shape[:-1], embed.shape[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, embed = ctx.saved_tensors
        gl = g.reshape(-1, g.shape[-1]).to(ctx.cd)
        w = embed.to(ctx.cd)
        dh = reduce_from_model(_mm32(gl, w).to(h.dtype), ctx.model)
        dw = _mm32(gl.T, h.reshape(-1, h.shape[-1]).to(ctx.cd))
        return dh.reshape(h.shape), dw.to(embed.dtype), None, None


def _lm_head(cd, h, embed, model=None):
    """Weight-tied head: ``cd``-rounded operands, fp32 accumulation and
    fp32 logits; under ``vocab_parallel`` ``embed`` is this member's
    shard of ``model`` and the logits its slice."""
    return _LMHead.apply(h, embed, cd, model)


class _HeadNLL(torch.autograd.Function):
    """The JAX ``_head_nll`` custom VJP: the summed next-token NLL with
    the head applied ``chunk`` positions at a time, so only ``(B, chunk,
    V)`` fp32 logits are ever live.  The backward recomputes each chunk's
    logits, forms ``(softmax - onehot)·g`` in the compute dtype, and
    accumulates the embed gradient over the chunks in fp32."""

    @staticmethod
    def forward(ctx, h, embed, targets, cd, chunk):
        T = h.shape[1]
        if T % chunk:
            raise ValueError(f"loss_chunk={chunk} must divide the sequence "
                             f"length {T}")
        ctx.save_for_backward(h, embed, targets)
        ctx.cd, ctx.chunk = cd, chunk
        ew = embed.to(cd)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, T, chunk):
            logits = _mm32(h[:, c0:c0 + chunk].reshape(-1, h.shape[2])
                           .to(cd), ew.T)
            logp = torch.log_softmax(logits, dim=-1)
            tgt = targets[:, c0:c0 + chunk].reshape(-1, 1)
            total = total - logp.gather(-1, tgt).sum()
        return total

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, embed, targets = ctx.saved_tensors
        cd, chunk = ctx.cd, ctx.chunk
        B, T, D = h.shape
        ew = embed.to(cd)
        g32 = g.float()
        dh = torch.empty_like(h)
        dw = torch.zeros(embed.shape, dtype=torch.float32,
                         device=embed.device)
        for c0 in range(0, T, chunk):
            hcd = h[:, c0:c0 + chunk].reshape(-1, D).to(cd)
            p = torch.softmax(_mm32(hcd, ew.T), dim=-1)
            tgt = targets[:, c0:c0 + chunk].reshape(-1)
            p[torch.arange(p.shape[0], device=p.device), tgt] -= 1.0
            dl = (p * g32).to(cd)
            dh[:, c0:c0 + chunk] = _mm32(dl, ew).to(h.dtype).reshape(
                B, chunk, D)
            dw += _mm32(dl.T, hcd)
        return dh, dw.to(embed.dtype), None, None, None


def _vp_shard_index(Vl: int, tokens, rank: int):
    """Vocab ownership in one place: member ``rank`` of the model
    communicator owns rows ``[rank·Vl, (rank+1)·Vl)``.  ``(ok, idx)``:
    whether each token's row lives on this member, and its clipped local
    index (meaningful only where ``ok``; callers mask)."""
    loc = tokens - rank * Vl
    return (loc >= 0) & (loc < Vl), loc.clamp(0, Vl - 1)


def _vp_embed_lookup(embed_local, tokens, model, scale_local=None):
    """The vocab-parallel embedding gather (Megatron's
    VocabParallelEmbedding): out-of-shard tokens contribute zero and one
    all-reduce over ``model`` assembles the full ``(..., D)`` rows.  The
    backward scatter-adds each member's gradient rows into its own shard
    only.  ``scale_local`` (an int8 embedding's per-row fp32 scales,
    sharded like the rows) dequantizes the gathered rows before the one
    all-reduce."""
    ok, idx = _vp_shard_index(embed_local.shape[0], tokens, model.rank)
    rows = embed_local[idx]
    if scale_local is not None:
        rows = rows.to(scale_local.dtype) * scale_local[idx][..., None]
    rows = torch.where(ok[..., None], rows, 0.0)
    return reduce_from_model(rows, model)


def _vp_nll_sum(cd, h, embed_local, targets, model):
    """The vocab-parallel cross-entropy's NLL sum: each member computes
    only its logits slice, and the softmax reduces across the shards
    with three query-sized collectives (a max of the row maxima, which
    only anchors the exp; a sum of the exp-sums; a sum of the owner's
    target logit)."""
    logits = _lm_head(cd, h, embed_local, model)
    m = allreduce(logits.detach().amax(dim=-1), model, "max")  # (B, T)
    se = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1),
                           model)
    lse = torch.log(se) + m
    ok, idx = _vp_shard_index(embed_local.shape[0], targets, model.rank)
    tl = logits.gather(-1, idx[..., None])[..., 0]
    tl = reduce_from_model(torch.where(ok, tl, 0.0), model)
    return (lse - tl).sum()


class _VPHeadNLL(torch.autograd.Function):
    """The JAX ``_vp_head_nll`` custom VJP: :class:`_HeadNLL`'s token
    chunks and :func:`_vp_nll_sum`'s vocab shards together, so the live
    logits are ``(B, chunk, V/M)``.  Each chunk pays the three
    query-sized reductions; the backward recomputes each chunk's slice
    and its global softmax, sums ``dh`` over ``model`` after the cast to
    the primal dtype, and accumulates the shard's gradient in fp32."""

    @staticmethod
    def forward(ctx, h, embed_local, targets, cd, chunk, model):
        T = h.shape[1]
        if T % chunk:
            raise ValueError(f"loss_chunk={chunk} must divide the sequence "
                             f"length {T}")
        ctx.save_for_backward(h, embed_local, targets)
        ctx.cd, ctx.chunk, ctx.model = cd, chunk, model
        Vl = embed_local.shape[0]
        ew = embed_local.to(cd)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, T, chunk):
            logits = _mm32(h[:, c0:c0 + chunk].reshape(-1, h.shape[2])
                           .to(cd), ew.T)
            m = allreduce(logits.amax(dim=-1), model, "max")
            se = reduce_from_model(
                torch.exp(logits - m[:, None]).sum(dim=-1), model)
            lse = torch.log(se) + m
            ok, idx = _vp_shard_index(
                Vl, targets[:, c0:c0 + chunk].reshape(-1), model.rank)
            tl = logits.gather(-1, idx[:, None])[:, 0]
            tl = reduce_from_model(torch.where(ok, tl, 0.0), model)
            total = total + (lse - tl).sum()
        return total

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, embed_local, targets = ctx.saved_tensors
        cd, chunk, model = ctx.cd, ctx.chunk, ctx.model
        B, T, D = h.shape
        Vl = embed_local.shape[0]
        ew = embed_local.to(cd)
        g32 = g.float()
        dh = torch.empty_like(h)
        dw = torch.zeros(embed_local.shape, dtype=torch.float32,
                         device=embed_local.device)
        for c0 in range(0, T, chunk):
            hcd = h[:, c0:c0 + chunk].reshape(-1, D).to(cd)
            logits = _mm32(hcd, ew.T)
            # the global softmax's denominator again (the forward's two
            # query-sized collectives)
            m = allreduce(logits.amax(dim=-1), model, "max")
            se = reduce_from_model(
                torch.exp(logits - m[:, None]).sum(dim=-1), model)
            p = torch.exp(logits - (torch.log(se) + m)[:, None])
            ok, idx = _vp_shard_index(
                Vl, targets[:, c0:c0 + chunk].reshape(-1), model.rank)
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, idx] -= ok.to(p.dtype)
            dl = (p * g32).to(cd)
            dh[:, c0:c0 + chunk] = reduce_from_model(
                _mm32(dl, ew).to(h.dtype), model).reshape(B, chunk, D)
            dw += _mm32(dl.T, hcd)
        return dh, dw.to(embed_local.dtype), None, None, None, None


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


@torch.library.custom_op("chainermn_tpu_torch::attn_out", mutates_args=())
def _attn_out(o: torch.Tensor) -> torch.Tensor:
    """The JAX ``checkpoint_name(o, "attn_out")`` for the plain attention
    path: a copy of ``o`` as an operator of its own, which the "dots"
    policy saves.  (The flash path needs no mark: its forward is the
    ``flash_fwd`` operator, whose outputs the policy saves.)"""
    return o.clone()


_attn_out.register_autograd(lambda ctx, g: g)

# what the JAX "dots" policy saves of a block: every product of an
# activation with a weight (dots_with_no_batch_dims_saveable: in a block
# these are the 2-D ``mm``s of the dense layers, while the attention
# core's products carry batch dims) and the attention core's output
# (save_only_these_names("attn_out")).  Norms, casts, RoPE, the K/V
# broadcast and the elementwise ops are recomputed.
_DOTS_SAVED = [torch.ops.aten.mm.default,
               torch.ops.chainermn_tpu_torch.flash_fwd.default,
               torch.ops.chainermn_tpu_torch.attn_out.default]


def _dots_context():
    """``torch.utils.checkpoint``'s contexts for ``remat_policy="dots"``:
    the forward caches the outputs of :data:`_DOTS_SAVED`, and the
    recompute in the backward reuses them (no product and no flash
    forward runs again)."""
    return create_selective_checkpoint_contexts(_DOTS_SAVED)


def _attention(cfg: TransformerConfig, h, blk, seq, model):
    """Pre-LN attention: the column-parallel QKV projection (this rank's
    heads over ``model``, the model communicator), the attention core on
    them (ring or Ulysses over ``seq``, the seq communicator), the
    row-parallel output projection and the residual."""
    cd = cfg.compute_dtype
    win = cfg.attention_window or None
    x = _rms_norm(h, blk["ln1"])
    B, T, D = x.shape
    if "wqkv" in blk:
        H = blk["wqkv"].shape[2]            # local heads, H / model size
        qkv = column_parallel_dense(x, blk["wqkv"].reshape(D, -1).to(cd),
                                    comm=model)
        qkv = qkv.reshape(B, T, 3, H, cfg.d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        # GQA/MQA: one fused projection over the concatenated weights,
        # as the JAX package does; K/V stay at the shared width.  Local
        # grouping is global grouping: H and Hkv shard over the same
        # axis, so local query head i reads local K/V head i // (H/Hkv)
        H = blk["wq"].shape[1]
        Hkv = blk["wkv"].shape[2]
        dq = H * cfg.d_head
        fused = torch.cat(
            [blk["wq"].reshape(D, -1), blk["wkv"].reshape(D, -1)],
            dim=1).to(cd)
        qkv = column_parallel_dense(x, fused, comm=model)
        q = qkv[..., :dq].reshape(B, T, H, cfg.d_head)
        kv = qkv[..., dq:].reshape(B, T, 2, Hkv, cfg.d_head)
        k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.pos_embedding == "rope":
        # each token's GLOBAL position, before any rotation or exchange
        pos = _block_positions(
            seq.rank, T, seq.size,
            cfg.seq_layout if cfg.attention == "ring" else "contiguous",
            x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.attention == "ring":
        # the kernel a pair wherever the block (each zigzag half) fits it
        t_run = T // 2 if cfg.seq_layout == "zigzag" else T
        o = ring_attention(
            q, k, v, comm=seq, causal=True, window=win,
            remat=cfg.remat, layout=cfg.seq_layout,
            use_flash=flash_attention_supported(t_run, t_run, cfg.d_head))
    elif cfg.attention == "ulysses":
        # after the exchange each rank holds the whole sequence for its
        # heads: the kernel runs there, at zero offsets
        t_full = T * seq.size
        fa = flash_attention if flash_attention_supported(
            t_full, t_full, cfg.d_head) else None
        o = ulysses_attention(q, k, v, comm=seq, causal=True,
                              window=win, attn_fn=fa)
    elif cfg.attention == "flash" and seq.size != 1:
        raise ValueError(
            'attention="flash" covers only the unsharded-sequence '
            f'case (mesh seq axis is {seq.size}); use attention="ring" '
            "to shard the sequence")
    elif cfg.attention == "flash" and flash_attention_supported(
            T, T, cfg.d_head):
        k, v = broadcast_kv(k, v, q.shape[2] // k.shape[2])
        o = flash_attention(q, k, v, causal=True, window=win)
    else:
        # "local", or a shape the kernel does not take (grouped K/V read
        # in place, no broadcast)
        o = local_attention(q, k, v, causal=True, window=win)
        if cfg.remat and cfg.remat_policy == "dots" \
                and torch.is_grad_enabled():
            o = _attn_out(o)
    o = row_parallel_dense(
        o.reshape(B, T, -1), blk["wo"].reshape(-1, D).to(cd), comm=model)
    return h + o


def _mlp(cfg: TransformerConfig, h, blk, model, expert):
    """Pre-LN MLP: the dense column→row pair over ``model`` (one
    all-reduce), or the mixture of experts over ``expert`` (the expert
    communicator; two all-to-alls), each expert's FFN that same pair.
    Returns ``(h, aux)``: the balancing loss, None for the dense MLP."""
    cd = cfg.compute_dtype
    x = _rms_norm(h, blk["ln2"])
    if not cfg.moe:
        y = torch.relu(column_parallel_dense(x, blk["w1"].to(cd),
                                             comm=model))
        return h + row_parallel_dense(y, blk["w2"].to(cd), comm=model), None
    B, T, D = x.shape

    def expert_fn(p, tokens):
        # the local experts at once: (E/X, S·C, D) by (E/X, D, F/M)
        y = torch.relu(column_parallel_dense(tokens, p["w1"], comm=model))
        return row_parallel_dense(y, p["w2"], comm=model)

    out, aux = expert_parallel_moe(
        x.reshape(B * T, D), blk["router"].to(cd),
        {"w1": blk["w1"].to(cd), "w2": blk["w2"].to(cd)}, expert_fn,
        comm=expert, capacity_factor=cfg.capacity_factor,
        top_k=cfg.router_top_k)
    return h + out.reshape(B, T, D), aux


def _fsdp_dims(cfg: TransformerConfig) -> dict:
    """The dim of each block leaf's base shape (after the ``(L, ...)``
    or ``(V, L/V, ...)`` prefix) that FSDP shards over ``data``: the
    JAX ``_fsdp_dims``, the d_model dim of every matrix, which neither
    the model axis (heads, d_ff) nor the expert axis (experts) claims.
    The norm scales are left out."""
    dims = {"wo": 2}
    if cfg.kv_heads == cfg.n_heads:
        dims["wqkv"] = 0
    else:
        dims.update(wq=0, wkv=0)
    if cfg.moe:
        dims.update(router=0, w1=1, w2=2)
    else:
        dims.update(w1=0, w2=1)
    return dims


def _fsdp_gather(cfg: TransformerConfig, blk, data):
    """One layer's FSDP-sharded leaves all-gathered over ``data`` (the
    data communicator), inside the block: once a layer a use, and again
    in remat's recompute.  The gathers' backward reduce-scatters the
    gradients (:func:`~chainermn_tpu_torch.parallel.fsdp.fsdp_gather`),
    in ``cfg.fsdp_wire_dtype`` when it is set."""
    dims = _fsdp_dims(cfg)
    return fsdp_gather(blk, {k: dims.get(k) for k in blk}, data,
                       cfg.fsdp_wire_dtype or None)


def _block(cfg: TransformerConfig, h, blk, seq, model, expert, data):
    """One block: ``(h, aux)``, aux None for a dense MLP.  Under
    ``fsdp`` its weights are gathered over ``data`` first."""
    if cfg.fsdp:
        blk = _fsdp_gather(cfg, blk, data)
    return _mlp(cfg, _attention(cfg, h, blk, seq, model), blk, model,
                expert)


def _add_aux(total, a):
    return a if total is None else (total if a is None else total + a)


def _layer(params, i: int) -> dict:
    """Layer ``i``'s block parameters (views into the stacked leaves)."""
    return {name: leaf[i] for name, leaf in params["blocks"].items()}


def _layers(cfg: TransformerConfig, blocks) -> list:
    """This rank's blocks as one dict a layer, in the order it runs them
    (its stage's; chunk after chunk under ``virtual_pipe``): views into
    the stacked leaves, or ``blocks`` itself when it is such a list."""
    if isinstance(blocks, list):
        return blocks
    if cfg.virtual_pipe > 1:
        blocks = {k: v.flatten(0, 1) for k, v in blocks.items()}
    n = next(iter(blocks.values())).shape[0]
    return [{k: v[i] for k, v in blocks.items()} for i in range(n)]


def _stage(cfg: TransformerConfig, layers, h, seq, model, expert, data):
    """One pipeline stage (or chunk): its blocks in order.  Under MoE
    ``(h, aux)``, the aux summed over the blocks (the JAX ``_stage``)."""
    aux = None
    for blk in layers:
        h, a = _block(cfg, h, blk, seq, model, expert, data)
        aux = _add_aux(aux, a)
    return (h, aux) if cfg.moe else h


def _dots_checkpoint(early_stop: bool):
    """The ``checkpoint_fn`` of a stage under ``remat_policy="dots"``:
    the stage under the policy's selective checkpoint (the JAX
    ``cfg.checkpoint_fn`` around the stage)."""
    def wrap(fn):
        def run(p, mb):
            with set_checkpoint_early_stop(early_stop):
                return checkpoint(fn, p, mb, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=_dots_context)
        return run
    return wrap


def _embed(cfg: TransformerConfig, params, tokens, seq, model):
    """The token embedding plus positions (the block's global ones), in
    the compute dtype: the residual stream's start."""
    cd = cfg.compute_dtype
    T = tokens.shape[1]
    if T * seq.size > cfg.max_seq:
        raise ValueError(f"sequence length {T * seq.size} exceeds max_seq "
                         f"{cfg.max_seq}")
    if cfg.vocab_parallel:
        h = _vp_embed_lookup(params["embed"], tokens, model)  # (B, T, D)
    else:
        h = params["embed"][tokens]                      # (B, T, D) fp32
    if cfg.pos_embedding == "rope":
        return h.to(cd)           # rotations happen inside attention
    if cfg.seq_layout == "zigzag":
        # position rows follow the zigzag permutation of this block
        return (h + params["pos"][_block_positions(
            seq.rank, T, seq.size, "zigzag", h.device)]).to(cd)
    r = seq.rank
    return (h + params["pos"][r * T:(r + 1) * T]).to(cd)


def _loopbacks(dev, *comms):
    """Each of ``comms``, or a loopback communicator where it is None."""
    return tuple(LoopbackCommunicator(device=dev) if c is None else c
                 for c in comms)


def _backbone(cfg: TransformerConfig, params, tokens, seq, model, pipe,
              expert, data):
    """:func:`transformer_backbone` and the MoE balancing loss summed
    over the layers: ``(h, aux)``, aux None for a dense model (the JAX
    ``transformer_backbone``'s pair)."""
    seq, model, pipe, expert, data = _loopbacks(
        tokens.device, seq, model, pipe, expert, data)
    h = _embed(cfg, params, tokens, seq, model)
    layers = _layers(cfg, params["blocks"])
    remat = cfg.remat and torch.is_grad_enabled()
    # when an axis inside the block is sharded the recompute runs the
    # whole block on every rank: stopping it early, after the block's
    # last saved tensor, would stop the ranks at different collectives
    # (a seq rank skips other masked pairs of the ring and saves other
    # tensors; the model axis's all-reduces and the expert axis's
    # all-to-alls must all be replayed).  Under "dots" too: the
    # recompute returns the saved outputs in place of the products and
    # the flash forward, and posts the collectives again in order
    early_stop = seq.size == 1 and model.size == 1 and expert.size == 1
    aux = None
    if pipe.size > 1 or cfg.num_microbatches > 1 or cfg.virtual_pipe > 1:
        V = cfg.virtual_pipe
        n = len(layers) // V
        kw = dict(remat=remat, with_aux=cfg.moe)
        if remat and cfg.remat_policy == "dots":
            kw["checkpoint_fn"] = _dots_checkpoint(early_stop)
        for c in range(V):
            # chunk c of every stage as one GPipe pass: virtual stage
            # order c·S + s; the chunks' aux added (the JAX loop's)
            out = pipeline_apply(
                lambda p, mb: _stage(cfg, p, mb, seq, model, expert, data),
                layers[c * n:(c + 1) * n], h, comm=pipe,
                num_microbatches=cfg.num_microbatches, **kw)
            h, a = out if cfg.moe else (out, None)
            aux = _add_aux(aux, a)
        return _rms_norm(h, params["ln_f"]), aux
    context_fn = _dots_context if cfg.remat_policy == "dots" \
        else noop_context_fn
    for blk in layers:
        if remat:
            # the blocks draw no random numbers: no RNG state to replay
            with set_checkpoint_early_stop(early_stop):
                h, a = checkpoint(_block, cfg, h, blk, seq, model, expert,
                                  data, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=context_fn)
        else:
            h, a = _block(cfg, h, blk, seq, model, expert, data)
        aux = _add_aux(aux, a)
    return _rms_norm(h, params["ln_f"]), aux


def transformer_backbone(cfg: TransformerConfig, params, tokens, seq=None,
                         model=None, pipe=None, expert=None, data=None):
    """Embedding → block stack → final norm: the normed
    ``(B, T, d_model)`` hidden states in the compute dtype.  ``tokens``
    is this rank's block of the sequence when ``seq`` (the seq
    communicator; None: one rank) is sharded; positions are the block's
    global ones (the zigzag rows under ``seq_layout="zigzag"``).
    ``params`` are this rank's shard over ``model`` (the model
    communicator; None: one rank), ``pipe`` (the pipe communicator) and
    ``expert`` (the expert communicator, which under MoE exchanges the
    tokens with the other ranks' experts) and, under ``fsdp``, ``data``
    (the data communicator, over which each block gathers its weights),
    see :func:`shard_params`.
    With ``cfg.remat`` and gradients enabled each block runs under
    ``torch.utils.checkpoint``.  ``remat_policy="full"`` keeps only its
    input, and its forward (the flash kernel and the ring's transfers
    included, in the same order on every rank) runs again in the
    backward; ``"dots"`` also keeps the dense products and the attention
    core's output, so the backward recomputes only the norms, the
    elementwise ops and (the same on every rank) the collectives of the
    seq, model and expert axes.

    Over a pipe axis of ``S > 1`` stages, or with ``num_microbatches >
    1`` on one, the stack runs as GPipe (the ``V`` chunk rings one after
    the other under ``virtual_pipe``), every stage receiving the
    output; remat is then a stage application's (the stage's input
    kept, the stage recomputed in the backward)."""
    return _backbone(cfg, params, tokens, seq, model, pipe, expert,
                     data)[0]


def transformer_forward(cfg: TransformerConfig, params, tokens, seq=None,
                        model=None, pipe=None, expert=None, data=None):
    """``(B, T, vocab)`` fp32 logits through the weight-tied head.  Under
    ``vocab_parallel`` each member of ``model`` computes its vocab
    slice and the slices are all-gathered: the full logits, the same
    bits on every member (and on every stage of ``pipe``)."""
    if model is None:
        model = LoopbackCommunicator(device=tokens.device)
    h = transformer_backbone(cfg, params, tokens, seq, model, pipe, expert,
                             data)
    if cfg.vocab_parallel:
        logits = _lm_head(cfg.compute_dtype, h, params["embed"], model)
        if model.size == 1:
            return logits
        return allgather(logits, model, axis=logits.dim() - 1, tiled=True)
    return _lm_head(cfg.compute_dtype, h, params["embed"])


def _shard_nll_sum(cfg: TransformerConfig, h, embed, targets, model):
    """Summed next-token NLL through the configured head:
    ``vocab_parallel`` reduces over the model communicator's vocab
    shards, ``loss_chunk > 0`` takes the chunked head, and the two
    compose (:class:`_VPHeadNLL`); else the whole logits once through
    :func:`_lm_head`."""
    if cfg.vocab_parallel:
        if cfg.loss_chunk > 0:
            return _VPHeadNLL.apply(h, embed, targets, cfg.compute_dtype,
                                    cfg.loss_chunk, model)
        return _vp_nll_sum(cfg.compute_dtype, h, embed, targets, model)
    if cfg.loss_chunk > 0:
        return _HeadNLL.apply(h, embed, targets, cfg.compute_dtype,
                              cfg.loss_chunk)
    logp = torch.log_softmax(_lm_head(cfg.compute_dtype, h, embed), dim=-1)
    return -logp.gather(-1, targets[..., None]).sum()


def lm_loss(cfg: TransformerConfig, params, inputs, targets, seq=None,
            model=None, pipe=None, expert=None, data=None):
    """Mean next-token cross-entropy of ``(B, T)`` ``inputs`` against
    ``targets`` (this rank's block under a sharded ``seq``; ``params``
    this rank's shard over ``model``, ``pipe`` and ``expert``), plus
    ``0.01·aux`` under MoE: the balancing loss summed over the layers
    (the JAX ``lm_loss``)."""
    _check_ported(cfg, training=True)
    if model is None:
        model = LoopbackCommunicator(device=inputs.device)
    targets = targets.long()
    h, aux = _backbone(cfg, params, inputs, seq, model, pipe, expert, data)
    loss = _shard_nll_sum(cfg, h, params["embed"], targets,
                          model) / targets.numel()
    return loss if aux is None else loss + _AUX_WEIGHT * aux


def _grad_1f1b(cfg: TransformerConfig, params, inputs, targets, seq, model,
               pipe, expert, data):
    """The JAX ``_make_1f1b_grad``'s body on this rank: the embedding
    outside the schedule (its backward takes the schedule's ``dx``), the
    block stack as the 1F1B (or interleaved) stages, the final norm, the
    tied head and the cross-entropy as the in-schedule ``loss_fn``; under
    MoE the stages' balancing loss rides the schedule, its gradient
    seeded at ``0.01``.  ``params["blocks"]`` is this rank's list of
    layers.  Returns this rank's loss (the mean over its micro-batches,
    plus ``0.01·aux`` under MoE), the gradients of the top-level leaves
    (``embed``: the lookup side plus the head side) and one dict of
    gradients a layer."""
    targets = targets.long()
    top = [params["embed"]] + ([params["pos"]] if "pos" in params else [])
    with torch.enable_grad():
        h = _embed(cfg, params, inputs, seq, model)

    def stage_fn(layers, mb):
        return _stage(cfg, layers, mb, seq, model, expert, data)

    def loss_fn(lp, y, tgt):
        hN = _rms_norm(y, lp["ln_f"])
        return _shard_nll_sum(cfg, hN, lp["embed"], tgt,
                              model) / tgt.numel()

    lp = {"ln_f": params["ln_f"], "embed": params["embed"]}
    layers, M = params["blocks"], cfg.num_microbatches
    kw = dict(with_aux=True, aux_weight=_AUX_WEIGHT) if cfg.moe else {}
    if cfg.pipeline_schedule == "interleaved":
        V = cfg.virtual_pipe
        n = len(layers) // V
        *head, g_chunks, g_lp, dx = pipeline_train_interleaved(
            stage_fn, loss_fn, [layers[c * n:(c + 1) * n] for c in range(V)],
            lp, h.detach(), targets, comm=pipe, num_microbatches=M,
            num_chunks=V, **kw)
        g_layers = [g for chunk in g_chunks for g in chunk]
    else:
        *head, g_layers, g_lp, dx = pipeline_train_1f1b(
            stage_fn, loss_fn, layers, lp, h.detach(), targets, comm=pipe,
            num_microbatches=M, **kw)
    # the scalar the GPipe path's lm_loss reports
    loss = head[0] if len(head) == 1 else head[0] + _AUX_WEIGHT * head[1]
    d_top = torch.autograd.grad(h, top, dx)
    grads = {"embed": d_top[0] + g_lp["embed"], "ln_f": g_lp["ln_f"]}
    if "pos" in params:
        grads["pos"] = d_top[1]
    return loss, grads, g_layers


def _resolve(device, comm, mesh):
    """``(device, mesh)`` of an entry point: a :class:`MeshConfig` given
    as ``mesh``, or ``comm`` as the mesh ``data=comm.size``, or none;
    the device is the mesh's (``device``, if named too, must agree),
    else :func:`resolve_device`'s rule."""
    if comm is not None and mesh is not None:
        raise ValueError("pass a mesh or a communicator, not both")
    if comm is None and mesh is None:
        return resolve_device(device), None
    dev = (comm or mesh).device
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device {device} but the communicator runs on "
                         f"{dev}")
    return dev, mesh or MeshConfig(comm, data=comm.size)


def _rows(mesh, x):
    """This rank's rows of the global batch ``x``: block ``i`` of ``n``
    over the data and expert axes together (``i = d·X + e``, the JAX
    ``P(("data", "expert"))``); all of it without a mesh."""
    x = torch.as_tensor(x)
    if mesh is None:
        return x
    X = mesh.axis_size("expert")
    B, n = x.shape[0], mesh.axis_size("data") * X
    if B % n:
        raise ValueError(f"global batch {B} does not divide over the data "
                         f"and expert axes ({n} ranks)")
    i = mesh.axis_index("data") * X + mesh.axis_index("expert")
    return x[i * (B // n):(i + 1) * (B // n)]


def _shard(mesh, x, dev):
    """This rank's block of the global ``(B, T)`` batch ``x`` on ``dev``:
    its rows (:func:`_rows`), columns ``s·T/S … (s+1)·T/S`` over seq
    (the JAX ``_BATCH_SPEC``); all of it without a mesh."""
    x = _rows(mesh, x)
    if mesh is not None:
        T, S = x.shape[1], mesh.axis_size("seq")
        if T % S:
            raise ValueError(f"sequence length {T} does not divide over "
                             f"the seq axis ({S} ranks)")
        s = mesh.axis_index("seq")
        x = x[:, s * (T // S):(s + 1) * (T // S)]
    return x.to(dev)


def _check_layers(S: int, cfg: TransformerConfig):
    """The block stack must divide over ``S`` pipe stages and their
    chunks (the JAX ``init_transformer``'s check and message)."""
    V = cfg.virtual_pipe
    if cfg.n_layers % (S * V):
        raise ValueError(
            f"{cfg.n_layers} layers not divisible by "
            f"pipe·virtual_pipe = {S}·{V}")


def _axes(mesh, dev):
    """The seq, model, pipe, expert and data communicators of ``mesh``
    (loopback ones without a mesh)."""
    if mesh is None:
        return _loopbacks(dev, None, None, None, None, None)
    return (mesh.comm("seq"), mesh.comm("model"), mesh.comm("pipe"),
            mesh.comm("expert"), mesh.comm("data"))


def make_forward_fn(cfg: TransformerConfig, device=None, comm=None,
                    mesh=None):
    """``fn(params, tokens) -> logits``: the scoring entry point.

    Runs on ``device`` (CUDA unless ``device="cpu"`` is given) under
    ``torch.inference_mode()``.  ``params`` come from
    :func:`.convert.params_from_jax` on the same device; ``tokens`` is
    ``(B, T)`` integers (array or tensor).  With a ``mesh`` (or
    ``comm``, the mesh ``data=comm.size``) ``tokens`` is the global
    batch and each rank returns the logits of its rows and its block of
    the sequence, its shard of the JAX function's output; ``params`` are
    then its shard (:func:`shard_params`), and the logits are the full
    vocabulary on every member of the model axis and every stage of the
    pipe axis (the last stage's, broadcast)."""
    dev, mesh = _resolve(device, comm, mesh)
    if mesh is not None:
        _check_mesh(mesh, cfg)
    _check_layers(1 if mesh is None else mesh.axis_size("pipe"), cfg)
    _check_ported(cfg, decoding=False)
    seq, model, pipe, expert, data = _axes(mesh, dev)

    def forward(params, tokens):
        tokens = _shard(mesh, tokens, dev)
        with torch.inference_mode():
            return transformer_forward(cfg, params, tokens, seq, model,
                                       pipe, expert, data)

    return forward


def make_value_and_grad_fn(cfg: TransformerConfig, device=None, comm=None,
                           mesh=None):
    """``fn(params, inputs, targets) -> (loss, grads)``: :func:`lm_loss`
    and its gradient with respect to every parameter leaf, ``grads`` in
    the structure of ``params`` — the gradient half of the JAX
    ``make_train_step``.  ``params`` are read, not modified.  Runs on
    ``device`` (CUDA unless ``device="cpu"`` is given).

    With a ``mesh`` (or ``comm``, the mesh ``data=comm.size``; ``device``
    is then the communicator's) ``inputs``/``targets`` are the global
    batch: each rank takes its rows and its block of the sequence, and
    ``loss`` and ``grads`` are the means over the batch-like group
    ``(data, expert, seq)``, the gradients meaned in fp32 by
    ``multi_node_mean_grad`` (under MoE the experts' ``w1``/``w2``
    summed over ``(data, seq)`` and divided by that group's size: the
    expert group's members hold different experts).  On one rank that
    mean is a copy, so the result is bitwise the step without a mesh.
    Over a model axis ``params`` are this rank's shard
    (:func:`shard_params`) and so are
    ``grads``; a leaf replicated over model (the norm scales, ``pos``,
    ``embed`` without ``vocab_parallel``) comes out the same on every
    member: the column products' backward all-reduce makes it so.  Over
    a pipe axis ``params`` hold this rank's stage; the leaves replicated
    over pipe (``embed``, ``pos``, ``ln_f``) come out the same on every
    stage.  ``pipeline_schedule="1f1b"|"interleaved"`` runs the loss
    inside the schedule (:func:`_grad_1f1b`); ``"gpipe"`` differentiates
    :func:`lm_loss`."""
    dev, mesh = _resolve(device, comm, mesh)
    if mesh is not None:
        _check_mesh(mesh, cfg)
    _check_layers(1 if mesh is None else mesh.axis_size("pipe"), cfg)
    _check_ported(cfg, training=True)
    seq, model, pipe, expert, data = _axes(mesh, dev)
    group = None if mesh is None else mesh.comm(*BATCH_AXES)
    # the experts' own gradients are summed over (data, seq) only: the
    # members of the expert group hold different experts, and the
    # all-to-all's backward has already brought each expert the other
    # members' contributions
    split_experts = cfg.moe and expert.size > 1
    data_seq = mesh.comm("data", "seq") if split_experts else None
    # under fsdp (data > 1) the gathers' backward has already summed each
    # sharded leaf over data and cut it to this rank's slice: it is
    # summed over (expert, seq) only, the experts' w1/w2 over seq only,
    # and each divided by the batch-like group's size D·X·S
    D = data.size
    fsdp_leaves = set(_fsdp_dims(cfg)) if cfg.fsdp and D > 1 else set()
    expert_seq = mesh.comm("expert", "seq") if fsdp_leaves else None

    def value_and_grad(params, inputs, targets):
        inputs = _shard(mesh, inputs, dev)
        targets = _shard(mesh, targets, dev)
        top = [k for k in params if k != "blocks"]
        live = {k: params[k].detach().requires_grad_() for k in top}
        # each layer's slice of a stacked (L, ...) block leaf is a leaf of
        # its own: a gradient into a view of the stacked tensor would be
        # scattered into a zero-filled full-size tensor, once per layer
        layers = [{k: x.requires_grad_() for k, x in blk.items()}
                  for blk in _layers(cfg, {k: p.detach() for k, p in
                                           params["blocks"].items()})]
        live["blocks"] = layers
        if cfg.pipeline_schedule in ("1f1b", "interleaved"):
            loss, out, g_layers = _grad_1f1b(cfg, live, inputs, targets,
                                             seq, model, pipe, expert, data)
        else:
            with torch.enable_grad():
                loss = lm_loss(cfg, live, inputs, targets, seq, model, pipe,
                               expert, data)
                grads = torch.autograd.grad(
                    loss, [live[k] for k in top]
                    + [x for blk in layers for x in blk.values()])
            out = dict(zip(top, grads))
            rest = iter(grads[len(top):])
            g_layers = [{k: next(rest) for k in blk} for blk in layers]
        out["blocks"] = {
            k: torch.stack([g[k] for g in g_layers]).reshape(p.shape)
            for k, p in params["blocks"].items()}
        grads = {k: out[k] for k in params}
        loss = loss.detach()
        if group is not None:
            # fp32 on the wire, as the JAX step's psum: no bf16 wire here
            own = ("w1", "w2") if split_experts else ()
            blocks = grads["blocks"]
            grads = group.multi_node_mean_grad(dict(grads, blocks={
                k: g for k, g in blocks.items()
                if k not in own and k not in fsdp_leaves}), torch.float32)
            done = dict(grads["blocks"])
            if own:
                # Σ over (data, seq) / (D·X·S): the (data, seq) mean / X,
                # or under fsdp the seq mean / (D·X)
                over, div = (seq, D * expert.size) if fsdp_leaves \
                    else (data_seq, expert.size)
                mean = over.multi_node_mean_grad(
                    {k: blocks[k] for k in own}, torch.float32)
                done.update({k: mean[k] / div for k in own})
            rest = [k for k in blocks if k in fsdp_leaves and k not in own]
            if rest:
                # Σ over (data, expert, seq) / (D·X·S): the scatter's
                # data sum, the (expert, seq) mean / D
                mean = expert_seq.multi_node_mean_grad(
                    {k: blocks[k] for k in rest}, torch.float32)
                done.update({k: mean[k] / D for k in rest})
            grads["blocks"] = {k: done[k] for k in blocks}
            loss = group.allreduce(loss, "mean")
        return loss, grads

    return value_and_grad


def make_train_step(cfg: TransformerConfig, optimizer, device=None,
                    comm=None, mesh=None):
    """``step(params, opt_state, inputs, targets) -> (params, opt_state,
    loss)``: the JAX ``make_train_step`` at a mesh with pipe, data,
    expert, seq and model axes, under ``cfg.pipeline_schedule``.
    ``optimizer`` is one of :mod:`chainermn_tpu_torch.training`'s
    (``adamw``, ``sgd``) and ``opt_state`` its ``init(params)``.
    ``loss`` is the loss before the update.  Where JAX returns new
    arrays, the port updates ``params`` and ``opt_state`` in place and
    returns them.  With a ``mesh`` (or ``comm``, the mesh
    ``data=comm.size``) each rank steps on its block of the global batch
    and applies the same rule to the same fp32 mean of the gradients
    (see :func:`make_value_and_grad_fn`), so the ranks' parameters (over
    a model axis: the members' of one shard, over an expert axis: all
    but the experts) stay equal; ``loss`` is the mean over the
    batch-like group."""
    value_and_grad = make_value_and_grad_fn(cfg, device, comm, mesh)

    def step(params, opt_state, inputs, targets):
        loss, grads = value_and_grad(params, inputs, targets)
        optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


# --------------------------------------------------------------------- #
# the layout over the model and pipe axes
# --------------------------------------------------------------------- #


def _shard_dims(cfg: TransformerConfig, axis: str = "model",
                quantized: bool = False) -> dict:
    """The dim each leaf shards over ``axis`` (``"model"``, ``"expert"``
    or ``"data"``) in the port's layout (blocks ``(L, ...)``, or ``(V,
    L/V, ...)`` under ``virtual_pipe``), None for a leaf replicated over
    it: the JAX ``param_specs``' model, vocab, expert and FSDP entries
    with the pipe axis squeezed.  Under MoE ``w1 (L, E, D, F)`` and
    ``w2 (L, E, F, D)`` shard their experts over ``expert`` and ``F``
    over ``model``; the router is replicated over both.  Under ``fsdp``
    every matrix shards its d_model dim over ``data``
    (:func:`_fsdp_dims` past the prefix).  A ``quantized`` tree
    (:func:`~.quantization.quantize_params_int8`) cuts each scale leaf
    as its weight with the contraction axes removed (the JAX
    ``scale_spec``) and ``embed_scale`` as ``embed``; it is never
    FSDP-sharded (the JAX ``param_specs(quantized=True)``)."""
    if axis == "expert":
        blocks = {"w1": 1, "w2": 1} if cfg.moe else {}
        top = {}
    elif axis == "data":
        blocks = {k: d + 1 for k, d in _fsdp_dims(cfg).items()} \
            if cfg.fsdp and not quantized else {}
        top = {}
    else:
        blocks = {"wo": 1, "w1": 3, "w2": 2} if cfg.moe \
            else {"wo": 1, "w1": 2, "w2": 1}
        if cfg.kv_heads == cfg.n_heads:
            blocks["wqkv"] = 3
        else:
            blocks.update(wq=2, wkv=3)
        top = {"embed": 0} if cfg.vocab_parallel else {}
    if cfg.virtual_pipe > 1:
        # the chunk axis before the layers
        blocks = {k: d + 1 for k, d in blocks.items()}
    if quantized:
        from .quantization import scale_dims

        blocks.update(scale_dims(blocks, cfg))
        top.update({"embed_scale": top["embed"]} if "embed" in top else {})
    return {"top": top, "blocks": blocks}


def _map_sharded(cfg, params, fn, axis: str = "model"):
    """``params`` with ``fn(leaf, dim)`` on every leaf that shards over
    ``axis`` (the others kept), in ``params``' order."""
    dims = _shard_dims(cfg, axis, quantized="embed_scale" in params)

    def one(t, dim):
        return t if dim is None else fn(t, dim)

    out = {k: one(v, dims["top"].get(k)) for k, v in params.items()
           if k != "blocks"}
    out["blocks"] = {k: one(v, dims["blocks"].get(k))
                     for k, v in params["blocks"].items()}
    return {k: out[k] for k in params}


def regroup_blocks(blocks, from_pipe: int, to_pipe: int,
                   from_virtual: int = 1, to_virtual: int = 1):
    """Regroup a block stack in the JAX layout between pipeline
    groupings (the JAX ``regroup_blocks``; numpy or torch leaves).

    Leaves are ``(P, L/P, *base)``, or ``(P, V, L/(P·V), *base)`` under
    ``virtual_pipe = V > 1`` (chunk ``c`` of stage ``s`` is virtual stage
    ``g = c·P + s``, the ``g``-th contiguous layer slice).  Each leaf is
    flattened to global layer order and grouped for the target, so a
    state trained on any (pipe, virtual) grouping resumes or decodes on
    any other."""

    def leaf(a):
        if from_virtual > 1:
            if a.shape[0] != from_pipe or a.shape[1] != from_virtual:
                raise ValueError(
                    f"block leaf {tuple(a.shape)} does not match from_pipe="
                    f"{from_pipe}, from_virtual={from_virtual}")
            base = a.shape[3:]
            # (P, V, lpc) -> (V, P, lpc) -> layer order g·lpc + i
            layers = a.swapaxes(0, 1).reshape(-1, *base)
        else:
            if a.shape[0] != from_pipe:
                raise ValueError(
                    f"block leaf {tuple(a.shape)} does not match "
                    f"from_pipe={from_pipe}")
            base = a.shape[2:]
            layers = a.reshape(-1, *base)
        L = layers.shape[0]
        if L % (to_pipe * to_virtual):
            raise ValueError(
                f"{L} layers not divisible by to_pipe·to_virtual = "
                f"{to_pipe}·{to_virtual}")
        if to_virtual > 1:
            lpc = L // (to_pipe * to_virtual)
            return layers.reshape(
                to_virtual, to_pipe, lpc, *base).swapaxes(0, 1)
        return layers.reshape(to_pipe, L // to_pipe, *base)

    return pytree.tree_map(leaf, blocks)


def _stage_blocks(cfg: TransformerConfig, blocks, S: int, s: int) -> dict:
    """Stage ``s`` of ``S``'s blocks, cut from the whole stack (the
    port's one-stage layout): ``(L/S, ...)``, or ``(V, L/(S·V), ...)``
    under ``virtual_pipe``; tensors of their own."""
    V = cfg.virtual_pipe
    grouped = regroup_blocks({k: v[None] for k, v in blocks.items()},
                             1, S, V, V)
    return {k: v[s].clone() for k, v in grouped.items()}


def _whole_blocks(cfg: TransformerConfig, blocks, pipe) -> dict:
    """The whole stack from every stage's blocks: an all-gather over
    ``pipe``, regrouped to one stage."""
    V = cfg.virtual_pipe
    stacked = {k: pipe.allgather(v.detach().contiguous())
               for k, v in blocks.items()}
    return {k: v[0] for k, v in regroup_blocks(stacked, pipe.size, 1, V,
                                               V).items()}


def shard_params(mesh, cfg: TransformerConfig, params) -> dict:
    """This rank's shard of the whole tree ``params`` (the port's layout
    at pipe and model size 1, on every rank alike) over ``mesh``: the
    JAX ``shard_params``, where rank ``r`` is device ``r``.  Pipe
    coordinate ``s`` of ``S`` keeps its stage's blocks (the JAX
    ``param_specs``' pipe entries: ``(L/S, ...)``, or under
    ``virtual_pipe`` its chunks ``(V, L/(S·V), ...)``, virtual stages
    ``c·S + s``); model coordinate ``m`` of ``M`` keeps block ``m`` of
    the head dim of ``wqkv``/``wq``/``wkv`` and ``wo``, of ``w1``'s
    columns and ``w2``'s rows, and under ``vocab_parallel`` of
    ``embed``'s rows; expert coordinate ``e`` of ``X`` keeps block ``e``
    of the experts of ``w1``/``w2`` under MoE; the other leaves are kept
    whole; under ``fsdp`` data coordinate ``d`` of ``D`` keeps block
    ``d`` of every matrix's d_model dim (the JAX ``param_specs``' FSDP
    entries), cut last.  The shards are tensors of their own.  At pipe,
    model, expert and (under ``fsdp``) data size 1 the tree is returned
    as it is."""
    _check_mesh(mesh, cfg)
    S = mesh.axis_size("pipe")
    if S > 1:
        params = dict(params, blocks=_stage_blocks(
            cfg, params["blocks"], S, mesh.axis_index("pipe")))
    for axis in ("model", "expert", "data"):
        params = _shard_tree(cfg, params, mesh.axis_size(axis),
                             mesh.axis_index(axis), axis=axis)
    return params


def _shard_tree(cfg: TransformerConfig, params, M: int, m: int,
                axis: str = "model") -> dict:
    """Member ``m``'s shard of ``params`` over a model (expert, data)
    axis of ``M`` members (:func:`shard_params`' part of that axis,
    without a mesh)."""
    if M == 1:
        return params
    return _map_sharded(cfg, params,
                        lambda t, d: t.chunk(M, dim=d)[m].clone(), axis)


def gather_params(mesh, cfg: TransformerConfig, params) -> dict:
    """The inverse of :func:`shard_params`: the whole tree from every
    rank's shard (parameters, or a tree of their structure such as
    gradients or an optimizer's moments), by all-gathers over ``mesh``'s
    data communicator (under ``fsdp``), its model communicator, its
    expert communicator, then its pipe communicator; every rank gets it.
    At pipe, model, expert and data size 1 the tree is returned as it
    is."""
    pipe = mesh.comm("pipe")
    for axis in ("data", "model", "expert"):
        group = mesh.comm(axis)
        if group.size > 1:
            params = _map_sharded(cfg, params, lambda t, d: torch.cat(
                list(group.allgather(t.detach().contiguous()).unbind(0)),
                dim=d), axis)
    if pipe.size > 1:
        params = dict(params, blocks=_whole_blocks(cfg, params["blocks"],
                                                   pipe))
    return params


def reshard_train_state(mesh, cfg: TransformerConfig, optimizer, params,
                        opt_state, from_pipe: int = 1,
                        from_virtual: int = 1):
    """Lay a saved training state onto ``mesh``: the JAX
    ``reshard_train_state`` (elastic resume) for the port.

    ``params`` is a tree in the JAX layout (numpy, as a checkpoint keeps
    it) grouped for ``from_pipe`` stages of ``from_virtual`` chunks, and
    ``opt_state`` the optimizer's state tree
    (:func:`~chainermn_tpu_torch.training.optimizer_state_tree`'s form)
    whose param-shaped moments are in the same layout.  The blocks of
    both are regrouped for ``mesh``'s pipe axis and
    ``cfg.virtual_pipe`` (:func:`regroup_blocks`), and each rank keeps
    its shard (:func:`.convert.params_from_jax`).  Returns ``(params,
    opt_state)`` on the mesh's device: this rank's parameters and
    ``optimizer.init`` of them with the moments loaded.  The saved tree
    is the whole one whatever its run's layout, so ``cfg.fsdp`` takes
    FSDP on or off in either direction (the JAX "fsdp on/off"): under
    it the matrices and their moments are cut to this rank's d_model
    block and stay at that width."""
    from chainermn_tpu_torch.training import (
        load_optimizer_state_tree,
        map_state_moments,
    )

    from .convert import params_from_jax

    to_pipe = mesh.axis_size("pipe")

    def place(tree):
        tree = dict(tree, blocks=regroup_blocks(
            tree["blocks"], from_pipe, to_pipe, from_virtual,
            cfg.virtual_pipe))
        return params_from_jax(tree, cfg, mesh.device, mesh=mesh)

    new = place(params)
    state = optimizer.init(new)
    load_optimizer_state_tree(state, map_state_moments(opt_state, new,
                                                       place))
    return new, state
