"""Parameters in the JAX package's layout, brought to torch.

``chainermn_tpu.models.init_transformer`` returns a tree of fp32 arrays:
``embed (V, D)``, ``pos (max_seq, D)`` (learned positions only),
``ln_f (D,)`` and ``blocks`` whose leaves carry a leading
``(pipe=1, L, ...)`` stack: ``ln1``/``ln2 (D,)``, ``wo (H, Dh, D)``,
``wqkv (D, 3, H, Dh)`` (MHA) or ``wq (D, H, Dh)`` + ``wkv (D, 2, Hkv,
Dh)`` (GQA/MQA), ``w1 (D, F)``, ``w2 (F, D)``.  :func:`params_from_jax`
takes that tree as numpy arrays (``jax.tree.map(np.asarray, params)``),
checks every shape, squeezes the pipe axis and returns a dict of fp32
tensors with the same names, blocks stacked ``(L, ...)``;
:func:`params_to_numpy` is its inverse.

It needs numpy only, so :func:`init_numpy_params` can make seeded weights
in the same layout (and at the same scales as ``init_transformer``) on a
machine without JAX; its numbers are numpy's, not ``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from chainermn_tpu_torch._device import resolve_device

from .transformer import TransformerConfig

__all__ = ["params_from_jax", "params_to_numpy", "init_numpy_params"]


def _block_shapes(cfg: TransformerConfig) -> dict:
    """Per-layer block leaf shapes, with each leaf's fan-in (None for the
    norm scales, which initialise to one)."""
    D, H, Dh, F = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    shapes = {
        "ln1": ((D,), None),
        "ln2": ((D,), None),
        "wo": ((H, Dh, D), H * Dh),
        "w1": ((D, F), D),
        "w2": ((F, D), F),
    }
    if cfg.kv_heads == H:
        shapes["wqkv"] = ((D, 3, H, Dh), D)
    else:
        shapes["wq"] = ((D, H, Dh), D)
        shapes["wkv"] = ((D, 2, cfg.kv_heads, Dh), D)
    return shapes


def _top_shapes(cfg: TransformerConfig) -> dict:
    shapes = {"embed": (cfg.vocab_size, cfg.d_model),
              "ln_f": (cfg.d_model,)}
    if cfg.pos_embedding == "learned":
        shapes["pos"] = (cfg.max_seq, cfg.d_model)
    return shapes


def _check_config(cfg: TransformerConfig):
    if cfg.moe or cfg.virtual_pipe > 1:
        raise NotImplementedError(
            "MoE and interleaved (virtual_pipe > 1) block stacks are not "
            "ported yet; they come with the parallel slice")


def params_from_jax(tree, cfg: TransformerConfig, device=None) -> dict:
    """The JAX package's parameter tree (numpy leaves, pipe axis of size
    1) as fp32 tensors on ``device`` (CUDA unless ``"cpu"`` is named)."""
    dev = resolve_device(device)
    _check_config(cfg)

    def leaf(name, a, shape):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(
                f"param {name!r} has shape {a.shape}, config wants {shape}")
        return torch.tensor(a, dtype=torch.float32, device=dev)

    want_top = _top_shapes(cfg)
    want_blocks = _block_shapes(cfg)
    extra = (set(tree) - set(want_top) - {"blocks"}) \
        | (set(tree["blocks"]) - set(want_blocks))
    if extra:
        raise ValueError(f"params {sorted(extra)} do not belong to this "
                         "config (quantized trees are not ported yet)")
    out = {name: leaf(name, tree[name], shape)
           for name, shape in want_top.items()}
    L = cfg.n_layers
    out["blocks"] = {
        name: leaf(f"blocks/{name}", tree["blocks"][name],
                   (1, L, *shape))[0]
        for name, (shape, _) in want_blocks.items()}
    return out


def params_to_numpy(params, cfg: TransformerConfig) -> dict:
    """The inverse of :func:`params_from_jax`: a port tree (parameters,
    or gradients in their structure) as fp32 numpy leaves in the JAX
    package's layout, the ``(pipe=1, ...)`` axis re-added to the blocks,
    so it compares leaf by leaf with the JAX tree."""
    _check_config(cfg)
    want_top, want_blocks = _top_shapes(cfg), _block_shapes(cfg)
    if set(params) != set(want_top) | {"blocks"} \
            or set(params["blocks"]) != set(want_blocks):
        raise ValueError(f"params {sorted(params)} / blocks "
                         f"{sorted(params['blocks'])} do not match this "
                         "config")

    def leaf(name, t, shape):
        if tuple(t.shape) != shape:
            raise ValueError(f"param {name!r} has shape "
                             f"{tuple(t.shape)}, config wants {shape}")
        # a copy: the train step updates the tensors in place
        return t.detach().to("cpu", torch.float32).numpy().copy()

    out = {name: leaf(name, params[name], shape)
           for name, shape in want_top.items()}
    L = cfg.n_layers
    out["blocks"] = {
        name: leaf(f"blocks/{name}", params["blocks"][name],
                   (L, *shape))[None]
        for name, (shape, _) in want_blocks.items()}
    return out


def init_numpy_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Seeded fp32 weights in the JAX package's layout: dense leaves
    ``normal * fan_in**-0.5``, ``embed``/``pos`` ``normal * 0.02``, norm
    scales one — ``init_transformer``'s scales with numpy's numbers."""
    _check_config(cfg)
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    L = cfg.n_layers
    blocks = {}
    for name, (shape, fan_in) in _block_shapes(cfg).items():
        full = (1, L, *shape)
        blocks[name] = np.ones(full, np.float32) if fan_in is None \
            else normal(full, fan_in ** -0.5)
    params = {"embed": normal(_top_shapes(cfg)["embed"], 0.02),
              "ln_f": np.ones((cfg.d_model,), np.float32),
              "blocks": blocks}
    if cfg.pos_embedding == "learned":
        params["pos"] = normal((cfg.max_seq, cfg.d_model), 0.02)
    return params
