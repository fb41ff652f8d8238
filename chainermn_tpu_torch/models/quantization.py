"""Weight-only int8 quantization of the flagship's tree for decoding.

Counterpart of ``chainermn_tpu/models/quantization.py``, on the port's
tree (blocks ``(L, ...)``, or ``(V, L/V, ...)`` under ``virtual_pipe``)
and the JAX layout's alike: every block weight is stored as ``int8``
with a per-output-channel fp32 scale (absmax / 127 over the contraction
axes) in a ``<name>_scale`` leaf; the embedding quantizes per vocab row
(``embed_scale``), which serves both its uses (the gathered rows are
dequantized, and the head's logits take the scale per vocab output).
MoE expert stacks quantize per expert; the router stays fp32 (it feeds
an argmax, and weight noise there would flip routing for nothing).  The
norm scales and the learned positions stay fp32.

The int8 values and the scales are bitwise the JAX package's for the
same fp32 weights: ``torch.round`` and ``jnp.round`` both round half to
even, and ``w / scale`` is one correctly rounded fp32 division.

Quantize the whole tree (a scale spans its weight's whole contraction),
then shard it (:func:`~.transformer.shard_params` detects an int8 tree
by its ``embed_scale``).  Decoding reads such a tree with
``quantized=True``
(:func:`~.decoding.make_generate_fn` and the other decoders): a product
casts the int8 weight to the compute dtype, multiplies, and puts the
scale on the output.  Training is out of scope.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["base_layout", "quantize_params_int8", "scale_dims"]

# base (per-layer, prefix-free) layouts: rank and contraction axes of
# each quantizable block weight
_BASE = {
    "wqkv": (4, (0,)),   # (D, 3, H, Dh)   contracts D
    "wq":   (3, (0,)),   # (D, H, Dh)
    "wkv":  (4, (0,)),   # (D, 2, Hkv, Dh)
    "wo":   (3, (0, 1)),  # (H, Dh, D)     contracts H·Dh
    "w1":   (2, (0,)),   # (D, F)
    "w2":   (2, (0,)),   # (F, D)
}

# MoE expert stacks carry a leading expert axis: their scales are per
# expert and per output channel
_MOE_OVERRIDE = {
    "w1": (3, (1,)),     # (E, D, F)  contracts D
    "w2": (3, (1,)),     # (E, F, D)  contracts F
}


def base_layout(moe: bool) -> dict:
    """Each quantizable block weight's base rank and contraction axes."""
    return {**_BASE, **_MOE_OVERRIDE} if moe else _BASE


def _quantize_leaf(w, axes):
    """``(int8 values, fp32 scales)`` of ``w`` over the contraction
    ``axes`` (the scales drop them)."""
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(axes).to(torch.float32)


def quantize_params_int8(cfg, params) -> dict:
    """A decode-ready tree: block and embedding weights as int8 plus
    ``<name>_scale`` fp32 leaves; everything else passes through.
    ``params`` holds fp32 tensors or numpy arrays in the port's layout or
    the JAX one (any prefix before the base shape: the contraction axes
    shift by it, as the JAX ``prefix = w.ndim - base_rank``), and the
    result holds the same kind."""
    to_np = not torch.is_tensor(params["embed"])

    def run(w, axes):
        q, s = _quantize_leaf(torch.as_tensor(np.asarray(w)) if to_np
                              else w, axes)
        return (q.numpy(), s.numpy()) if to_np else (q, s)

    out = dict(params)
    blocks = dict(params["blocks"])
    for name, (base_rank, base_axes) in base_layout(cfg.moe).items():
        if name not in blocks:
            continue
        w = blocks[name]
        prefix = w.ndim - base_rank
        blocks[name], blocks[name + "_scale"] = run(
            w, tuple(prefix + a for a in base_axes))
    out["blocks"] = blocks
    out["embed"], out["embed_scale"] = run(params["embed"], (1,))
    return out


def scale_dims(dims: dict, cfg) -> dict:
    """The shard dims of the scale leaves, from ``dims`` (block leaf →
    the dim it shards over an axis, after the layout's prefix): a
    weight's dim with its contraction axes removed (the JAX
    ``scale_spec``); a scale whose weight shards along a contraction axis
    is left out (it is taken over the whole contraction, so it is
    replicated there)."""
    out = {}
    prefix = 2 if cfg.virtual_pipe > 1 else 1
    for name, (_, axes) in base_layout(cfg.moe).items():
        d = dims.get(name)
        if d is None:
            continue
        drop = {prefix + a for a in axes}
        if d not in drop:
            out[name + "_scale"] = d - sum(1 for a in drop if a < d)
    return out
