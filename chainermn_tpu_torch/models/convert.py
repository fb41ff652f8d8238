"""Parameters in the JAX package's layout, brought to torch.

``chainermn_tpu.models.init_transformer`` returns a tree of fp32 arrays:
``embed (V, D)``, ``pos (max_seq, D)`` (learned positions only),
``ln_f (D,)`` and ``blocks`` whose leaves carry a leading
``(pipe, L/pipe, ...)`` stack (``(pipe, V, L/(pipe·V), ...)`` under
``virtual_pipe = V``): ``ln1``/``ln2 (D,)``, ``wo (H, Dh, D)``,
``wqkv (D, 3, H, Dh)`` (MHA) or ``wq (D, H, Dh)`` + ``wkv (D, 2, Hkv,
Dh)`` (GQA/MQA), ``w1 (D, F)``, ``w2 (F, D)``, or under MoE ``router
(D, E)``, ``w1 (E, D, F)`` and ``w2 (E, F, D)``.  :func:`params_from_jax`
takes that tree as numpy arrays (``jax.tree.map(np.asarray, params)``),
checks every shape, keeps this rank's stage (the whole stack at pipe 1)
and returns a dict of fp32 tensors with the same names, blocks stacked
``(L/pipe, ...)`` (``(V, L/(pipe·V), ...)``); :func:`params_to_numpy`
is its inverse.

It needs numpy only, so :func:`init_numpy_params` can make seeded weights
in the same layout (and at the same scales as ``init_transformer``) on a
machine without JAX; its numbers are numpy's, not ``jax.random``'s.
:func:`init_transformer` is the port's ``init_transformer``: the same
leaves, shapes, dtypes and scales drawn from a ``torch.Generator``, as
tensors in the port's layout (blocks ``(L, ...)``).  Given a ``mesh``
with a pipe or model axis, each of the three works on every rank with
the whole tree and keeps (or, :func:`params_to_numpy`, gathers) this
rank's shard over pipe, model and expert
(:func:`~.transformer.shard_params`), so the weights are
the one-card model's; the JAX tree is then grouped for the mesh's pipe
axis, as the JAX ``shard_params`` takes it
(:func:`~.transformer.regroup_blocks` moves a tree between groupings).

The same for the data-parallel models: :func:`resnet_params_from_jax`
takes ``init_resnet``'s ``(params, state)`` (conv weights HWIO, BN
``{"gamma", "beta"}`` and ``BatchNormState(mean, var, n)``, ``fc``
``{"w" (in, out), "b"}``) and returns torch trees with the conv weights
OIHW in ``channels_last`` memory format; :func:`resnet_to_numpy`
inverts it (for parameters, gradients or state);
:func:`init_resnet_numpy` makes seeded trees in the JAX layout at
``init_resnet``'s scales.  :func:`mlp_params_from_jax` and
:func:`init_mlp_numpy` do the same for ``init_mlp``'s list of layers.
"""

from __future__ import annotations

import numpy as np
import torch

from chainermn_tpu_torch._device import resolve_device

from chainermn_tpu_torch.links.batch_normalization import BatchNormState
from chainermn_tpu_torch.utils.serialization import sorted_keys

from .convnets import _AUX_AFTER, _INCEPTION, ConvNetConfig, _flatten_fin
from .convnets import _rows as _convnet_rows
from .resnet import ResNetConfig
from .seq2seq import Seq2seqConfig
from .transformer import (
    TransformerConfig,
    _check_layers,
    gather_params,
    regroup_blocks,
    shard_params,
)

__all__ = ["chain_params_from_jax", "convnet_params_from_jax",
           "convnet_to_numpy", "init_convnet_numpy", "init_mlp_numpy",
           "init_numpy_params", "init_resnet_numpy", "init_seq2seq_numpy",
           "init_transformer", "mlp_params_from_jax", "params_from_jax",
           "params_to_numpy", "resnet_params_from_jax", "resnet_to_numpy",
           "seq2seq_params_from_jax", "tree_to_numpy", "tree_to_tensors"]


def _block_shapes(cfg: TransformerConfig) -> dict:
    """Per-layer block leaf shapes, with each leaf's fan-in (None for the
    norm scales, which initialise to one)."""
    D, H, Dh, F = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    shapes = {
        "ln1": ((D,), None),
        "ln2": ((D,), None),
        "wo": ((H, Dh, D), H * Dh),
    }
    if cfg.moe:
        E = cfg.n_experts
        shapes.update(router=((D, E), D), w1=((E, D, F), D),
                      w2=((E, F, D), F))
    else:
        shapes.update(w1=((D, F), D), w2=((F, D), F))
    if cfg.kv_heads == H:
        shapes["wqkv"] = ((D, 3, H, Dh), D)
    else:
        shapes["wq"] = ((D, H, Dh), D)
        shapes["wkv"] = ((D, 2, cfg.kv_heads, Dh), D)
    return shapes


def _top_shapes(cfg: TransformerConfig, quantized: bool = False) -> dict:
    shapes = {"embed": (cfg.vocab_size, cfg.d_model),
              "ln_f": (cfg.d_model,)}
    if cfg.pos_embedding == "learned":
        shapes["pos"] = (cfg.max_seq, cfg.d_model)
    if quantized:
        shapes["embed_scale"] = (cfg.vocab_size,)
    return shapes


def _leaf_kinds(cfg: TransformerConfig, quantized: bool):
    """``(top, blocks)``: each leaf's per-layer shape and dtype (blocks'
    without the stack), for a plain tree or an int8 one
    (:func:`~.quantization.quantize_params_int8`: its weights int8, a
    ``<name>_scale`` fp32 leaf each, the weight's shape without the
    contraction axes, and ``embed_scale``)."""
    f32, i8 = torch.float32, torch.int8
    top = {k: (v, f32) for k, v in _top_shapes(cfg, quantized).items()}
    blocks = {k: (v, f32) for k, (v, _) in _block_shapes(cfg).items()}
    if quantized:
        from .quantization import base_layout

        top["embed"] = (top["embed"][0], i8)
        for name, (_, axes) in base_layout(cfg.moe).items():
            if name in blocks:
                shape = blocks[name][0]
                blocks[name] = (shape, i8)
                blocks[name + "_scale"] = (tuple(
                    n for i, n in enumerate(shape) if i not in axes), f32)
    return top, blocks


def _grouping(cfg: TransformerConfig, mesh) -> tuple:
    """The leading dims of a block leaf in the JAX layout grouped for
    ``mesh``'s pipe axis (1 without a mesh)."""
    S = 1 if mesh is None else mesh.axis_size("pipe")
    V = cfg.virtual_pipe
    _check_layers(S, cfg)
    return (S, cfg.n_layers // S) if V == 1 \
        else (S, V, cfg.n_layers // (S * V))


def _one_stage(cfg: TransformerConfig, blocks, S: int) -> dict:
    """JAX-layout blocks grouped for ``S`` stages as the port's whole
    stack (one stage, squeezed)."""
    V = cfg.virtual_pipe
    return {k: v[0] for k, v in regroup_blocks(blocks, S, 1, V, V).items()}


def params_from_jax(tree, cfg: TransformerConfig, device=None,
                    mesh=None) -> dict:
    """The JAX package's parameter tree (numpy leaves, blocks grouped
    for the mesh's pipe axis: ``(pipe, L/pipe, ...)``, pipe 1 without a
    mesh) as tensors on ``device`` (CUDA unless ``"cpu"`` is named):
    fp32, or for an int8 tree (``quantize_params_int8``'s, detected by
    its ``embed_scale``) the int8 weights as int8 beside their fp32
    scales.  With a ``mesh``, every rank converts the whole tree and
    keeps its shard over the pipe, model and expert axes
    (:func:`~.transformer.shard_params`, which cuts a scale leaf as its
    weight without the contraction axes)."""
    dev = resolve_device(device)
    lead = _grouping(cfg, mesh)
    want_top, want_blocks = _leaf_kinds(cfg, "embed_scale" in tree)

    def leaf(name, a, shape, dtype):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(
                f"param {name!r} has shape {a.shape}, config wants {shape}")
        return torch.tensor(a, dtype=dtype, device=dev)

    extra = (set(tree) - set(want_top) - {"blocks"}) \
        | (set(tree["blocks"]) - set(want_blocks))
    if extra:
        raise ValueError(f"params {sorted(extra)} do not belong to this "
                         "config")
    out = {name: leaf(name, tree[name], shape, dt)
           for name, (shape, dt) in want_top.items()}
    out["blocks"] = _one_stage(cfg, {
        name: leaf(f"blocks/{name}", tree["blocks"][name], (*lead, *shape),
                   dt)
        for name, (shape, dt) in want_blocks.items()}, lead[0])
    return out if mesh is None else shard_params(mesh, cfg, out)


def params_to_numpy(params, cfg: TransformerConfig, mesh=None) -> dict:
    """The inverse of :func:`params_from_jax`: a port tree (parameters,
    or gradients in their structure) as numpy leaves in the JAX
    package's layout (fp32; an int8 tree's weights int8), the blocks
    grouped for the mesh's pipe axis (pipe 1 without a mesh), so it
    compares leaf by leaf with the JAX tree.  With a ``mesh`` the tree
    is this rank's shard over the pipe, model and expert axes, and the
    whole one is gathered first (:func:`~.transformer.gather_params`,
    collective over the model, expert and pipe communicators)."""
    lead = _grouping(cfg, mesh)
    if mesh is not None:
        params = gather_params(mesh, cfg, params)
    want_top, want_blocks = _leaf_kinds(cfg, "embed_scale" in params)
    if set(params) != set(want_top) | {"blocks"} \
            or set(params["blocks"]) != set(want_blocks):
        raise ValueError(f"params {sorted(params)} / blocks "
                         f"{sorted(params['blocks'])} do not match this "
                         "config")

    def leaf(name, t, shape, dtype):
        if tuple(t.shape) != shape:
            raise ValueError(f"param {name!r} has shape "
                             f"{tuple(t.shape)}, config wants {shape}")
        # a copy: the train step updates the tensors in place
        return t.detach().to("cpu", dtype).numpy().copy()

    out = {name: leaf(name, params[name], shape, dt)
           for name, (shape, dt) in want_top.items()}
    whole = _grouping(cfg, None)[1:]
    V = cfg.virtual_pipe
    out["blocks"] = regroup_blocks({
        name: leaf(f"blocks/{name}", params["blocks"][name],
                   (*whole, *shape), dt)[None]
        for name, (shape, dt) in want_blocks.items()}, 1, lead[0], V, V)
    return out


def init_numpy_params(cfg: TransformerConfig, seed: int = 0,
                      pipe_size: int = 1) -> dict:
    """Seeded fp32 weights in the JAX package's layout, the blocks
    grouped for ``pipe_size`` stages (and ``cfg.virtual_pipe`` chunks):
    dense leaves ``normal * fan_in**-0.5``, ``embed``/``pos`` ``normal *
    0.02``, norm scales one — ``init_transformer``'s scales with numpy's
    numbers, the same numbers in global layer order for every
    grouping."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    L, V = cfg.n_layers, cfg.virtual_pipe
    _check_layers(pipe_size, cfg)
    blocks = {}
    for name, (shape, fan_in) in _block_shapes(cfg).items():
        full = (1, L, *shape)
        blocks[name] = np.ones(full, np.float32) if fan_in is None \
            else normal(full, fan_in ** -0.5)
    params = {"embed": normal(_top_shapes(cfg)["embed"], 0.02),
              "ln_f": np.ones((cfg.d_model,), np.float32),
              "blocks": regroup_blocks(blocks, 1, pipe_size, 1, V)}
    if cfg.pos_embedding == "learned":
        params["pos"] = normal((cfg.max_seq, cfg.d_model), 0.02)
    return params


def init_transformer(generator: torch.Generator, cfg: TransformerConfig,
                     pipe_size: int = 1, device=None, mesh=None) -> dict:
    """The JAX ``init_transformer`` for the port: the same tree of fp32
    leaves at the same scales (dense weights ``N(0,1)·fan_in^-0.5``,
    ``embed`` and ``pos`` ``N(0,1)·0.02``, norm scales one), drawn on the
    CPU from ``generator`` (so a seed gives the same numbers on every
    device; they are torch's, not ``jax.random``'s) and returned on
    ``device`` (CUDA unless ``"cpu"`` is named) in the port's layout:
    blocks stacked ``(L, ...)`` (``(V, L/V, ...)`` under ``virtual_pipe
    = V``).  :func:`params_to_numpy` gives the JAX layout.  With a
    ``mesh`` every rank draws the whole tree from its ``generator`` (the
    same seed on every rank) and keeps its shard over the pipe and model
    axes.  ``pipe_size`` is the JAX argument: the tree drawn is the same
    for every grouping, the layers must divide over ``pipe_size·V``
    stages, and a mesh's pipe axis must then be ``pipe_size``."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"init_transformer takes a torch.Generator, got "
                        f"{type(generator).__name__}")
    V = cfg.virtual_pipe
    _check_layers(pipe_size, cfg)
    if mesh is not None and pipe_size > 1 \
            and mesh.axis_size("pipe") != pipe_size:
        raise ValueError(f"pipe_size={pipe_size} but the mesh's pipe axis "
                         f"is {mesh.axis_size('pipe')}")
    dev = resolve_device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator,
                            dtype=torch.float32) * std).to(dev)

    L = cfg.n_layers
    blocks = {name: torch.ones((L, *shape), device=dev) if fan_in is None
              else normal((L, *shape), fan_in ** -0.5)
              for name, (shape, fan_in) in _block_shapes(cfg).items()}
    if V > 1:
        blocks = {k: v.reshape(V, L // V, *v.shape[1:])
                  for k, v in blocks.items()}
    # the leaf order of params_from_jax, which an optimizer's saved
    # state follows
    params = {"embed": normal(_top_shapes(cfg)["embed"], 0.02),
              "ln_f": torch.ones((cfg.d_model,), device=dev)}
    if cfg.pos_embedding == "learned":
        params["pos"] = normal((cfg.max_seq, cfg.d_model), 0.02)
    params["blocks"] = blocks
    return params if mesh is None else shard_params(mesh, cfg, params)


# --------------------------------------------------------------------- #
# ResNet and MLP
# --------------------------------------------------------------------- #


def _resnet_shapes(cfg: ResNetConfig):
    """``{path: (JAX shape, kind)}`` of ``init_resnet``'s tree, kind in
    conv / gamma / gamma0 (zero-initialised) / beta / fc_w / fc_b, and
    the BN layer paths with their channel counts."""
    shapes, bns = {"conv1": ((7, 7, 3, cfg.width), "conv")}, {}
    bns["bn1"] = cfg.width
    cin = cfg.width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * 2 ** i
        cout = cmid * 4
        for j in range(n_blocks):
            name = f"stage{i + 1}_block{j + 1}"
            shapes[f"{name}/conv1"] = ((1, 1, cin, cmid), "conv")
            shapes[f"{name}/conv2"] = ((3, 3, cmid, cmid), "conv")
            shapes[f"{name}/conv3"] = ((1, 1, cmid, cout), "conv")
            bns.update({f"{name}/bn1": cmid, f"{name}/bn2": cmid,
                        f"{name}/bn3": cout})
            if j == 0:
                shapes[f"{name}/proj"] = ((1, 1, cin, cout), "conv")
                bns[f"{name}/bn_proj"] = cout
            cin = cout
    for path, c in bns.items():
        gamma = "gamma0" if path.endswith("/bn3") else "gamma"
        shapes[f"{path}/gamma"] = ((c,), gamma)
        shapes[f"{path}/beta"] = ((c,), "beta")
    shapes["fc/w"] = ((cin, cfg.num_classes), "fc_w")
    shapes["fc/b"] = ((cfg.num_classes,), "fc_b")
    return shapes, bns


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _put(tree, path, value):
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def resnet_params_from_jax(params, state, cfg: ResNetConfig, device=None):
    """``init_resnet``'s ``(params, state)`` (numpy leaves) as torch
    trees on ``device`` (CUDA unless ``"cpu"`` is named): fp32, conv
    weights HWIO → OIHW in ``channels_last`` format, every shape
    checked."""
    dev = resolve_device(device)
    shapes, bns = _resnet_shapes(cfg)
    out_p, out_s = {}, {}
    for path, (shape, kind) in shapes.items():
        a = np.asarray(_get(params, path))
        if a.shape != shape:
            raise ValueError(f"param {path!r} has shape {a.shape}, config "
                             f"wants {shape}")
        t = torch.tensor(a, dtype=torch.float32, device=dev)
        if kind == "conv":
            t = t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        _put(out_p, path, t)
    for path, c in bns.items():
        mean, var, n = _get(state, path)
        _put(out_s, path, BatchNormState(
            torch.tensor(np.asarray(mean), dtype=torch.float32, device=dev),
            torch.tensor(np.asarray(var), dtype=torch.float32, device=dev),
            torch.tensor(np.asarray(n), dtype=torch.int32, device=dev)))
    return out_p, out_s


def resnet_to_numpy(tree):
    """A port ResNet tree (parameters, their gradients, or the BN
    state) as numpy in the JAX layout: 4-D conv leaves back to HWIO,
    ``BatchNormState`` kept."""
    def leaf(t):
        a = t.detach().to("cpu").numpy().copy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = resnet_to_numpy(v)
        elif isinstance(v, BatchNormState):
            out[k] = BatchNormState(*(leaf(t) for t in v))
        else:
            out[k] = leaf(v)
    return out


def init_resnet_numpy(cfg: ResNetConfig, seed: int = 0):
    """Seeded ``(params, state)`` in ``init_resnet``'s layout and
    scales, with numpy's numbers: conv weights ``normal·√(2/fan_in)``,
    ``fc.w`` ``normal·√(1/in)``, γ one (zero for each bottleneck's last
    BN), β and ``fc.b`` zero, running mean zero, variance one."""
    rng = np.random.default_rng(seed)
    shapes, bns = _resnet_shapes(cfg)
    params, state = {}, {}
    for path, (shape, kind) in shapes.items():
        if kind == "conv":
            fan_in = shape[0] * shape[1] * shape[2]
            a = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(np.sqrt(2.0 / fan_in))
        elif kind == "fc_w":
            a = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(np.sqrt(1.0 / shape[0]))
        else:
            a = np.full(shape, 1.0 if kind == "gamma" else 0.0, np.float32)
        _put(params, path, a)
    for path, c in bns.items():
        _put(state, path, BatchNormState(np.zeros(c, np.float32),
                                         np.ones(c, np.float32),
                                         np.zeros((), np.int32)))
    return params, state


def mlp_params_from_jax(params, device=None) -> list:
    """``init_mlp``'s list of ``{"w", "b"}`` layers as fp32 tensors."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(layer[k]), dtype=torch.float32,
                             device=dev) for k in ("w", "b")}
            for layer in params]


def chain_params_from_jax(params_list, chain) -> list:
    """A JAX ``MultiNodeChainList.init`` list for the port's ``chain``:
    the components ``chain``'s rank owns as fp32 tensors on its
    communicator's device (any tree of arrays: an MLP's ``{"w", "b"}``
    layer or a list of them, an n-step RNN stage's list of ``{"w", "u",
    "b"}``), None for the others; pass it to ``chain.load_params``."""
    if len(params_list) != len(chain.components):
        raise ValueError(f"got {len(params_list)} param sets for "
                         f"{len(chain.components)} components")
    return [tree_to_tensors(p, chain.comm.device) if chain.owns(i)
            else None for i, p in enumerate(params_list)]


def init_mlp_numpy(sizes, seed: int = 0) -> list:
    """Seeded layers in ``init_mlp``'s layout and scales (He normal
    weights, zero biases), with numpy's numbers."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((i, o), dtype=np.float32)
             * np.float32(np.sqrt(2.0 / i)),
             "b": np.zeros((o,), np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


# --------------------------------------------------------------------- #
# any tree; seq2seq; the convnets
# --------------------------------------------------------------------- #


def tree_to_tensors(tree, device):
    """A nested dict/list of arrays as fp32 tensors on ``device`` (an
    already resolved device: the caller's communicator's or entry
    point's)."""
    if isinstance(tree, dict):
        return {k: tree_to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_tensors(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), dtype=torch.float32, device=device)


def tree_to_numpy(tree):
    """A nested dict/list of tensors (parameters or gradients) as numpy
    copies."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return tree.detach().to("cpu").numpy().copy()


def _seq2seq_shapes(cfg: Seq2seqConfig) -> dict:
    """``{path: (shape, scale)}`` of ``init_seq2seq``'s tree (scale None:
    zeros)."""
    E, H = cfg.d_embed, cfg.d_hidden
    shapes = {"src_embed": ((cfg.src_vocab, E), 0.1),
              "tgt_embed": ((cfg.tgt_vocab, E), 0.1)}
    for stack in ("encoder", "decoder"):
        for i in range(cfg.n_layers):
            d_in = E if i == 0 else H
            shapes[f"{stack}/{i}/w"] = ((d_in, 4 * H), d_in ** -0.5)
            shapes[f"{stack}/{i}/u"] = ((H, 4 * H), H ** -0.5)
            shapes[f"{stack}/{i}/b"] = ((4 * H,), None)
    shapes["proj/w"] = ((H, cfg.tgt_vocab), H ** -0.5)
    shapes["proj/b"] = ((cfg.tgt_vocab,), None)
    return shapes


def _seq2seq_tree(cfg: Seq2seqConfig, leaf) -> dict:
    """The seq2seq tree with ``leaf(path, shape, scale)`` at each
    place (the encoder and decoder as lists; keys sorted)."""
    out: dict = {}
    for path, (shape, scale) in _seq2seq_shapes(cfg).items():
        _put(out, path, leaf(path, shape, scale))
    for stack in ("encoder", "decoder"):
        out[stack] = [out[stack][str(i)] for i in range(cfg.n_layers)]
    return sorted_keys(out)


def init_seq2seq_numpy(cfg: Seq2seqConfig, seed: int = 0) -> dict:
    """Seeded parameters in ``init_seq2seq``'s layout and scales, with
    numpy's numbers: embeddings ``normal·0.1``, LSTM ``w``
    ``normal·d_in^-½``, ``u`` ``normal·H^-½``, ``proj.w``
    ``normal·H^-½``, biases zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape, scale):
        if scale is None:
            return np.zeros(shape, np.float32)
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(scale)

    return _seq2seq_tree(cfg, leaf)


def seq2seq_params_from_jax(tree, cfg: Seq2seqConfig, device=None) -> dict:
    """``init_seq2seq``'s tree (numpy leaves) as fp32 tensors on
    ``device`` (CUDA unless ``"cpu"`` is named), every shape checked."""
    dev = resolve_device(device)

    def leaf(path, shape, _):
        parts = path.split("/")
        node = tree
        for k in parts:
            node = node[int(k)] if isinstance(node, (list, tuple)) \
                else node[k]
        a = np.asarray(node)
        if a.shape != shape:
            raise ValueError(f"param {path!r} has shape {a.shape}, config "
                             f"wants {shape}")
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return _seq2seq_tree(cfg, leaf)


def _googlenet_shapes(cfg: ConvNetConfig) -> dict:
    """``{path: (JAX shape, kind)}`` of GoogLeNet's tree, kind conv /
    bias / dense."""
    if cfg.head == "flatten" and cfg.insize != 224:
        raise ValueError(
            f"googlenet reference geometry (head='flatten') is fixed at "
            f"224px; got image_size={cfg.insize} — use head='gap' for "
            "other input sizes")
    shapes = {}

    def conv(path, kh, kw, cin, cout):
        shapes[f"{path}/w"] = ((kh, kw, cin, cout), "conv")
        shapes[f"{path}/b"] = ((cout,), "bias")

    def dense(path, fin, fout):
        shapes[f"{path}/w"] = ((fin, fout), "dense")
        shapes[f"{path}/b"] = ((fout,), "bias")

    conv("stem/0", 7, 7, 3, 64)
    conv("stem/1", 1, 1, 64, 64)
    conv("stem/2", 3, 3, 64, 192)
    for name, cin, b1, b3r, b3, b5r, b5, pp in _INCEPTION:
        conv(f"inc/{name}/b1", 1, 1, cin, b1)
        conv(f"inc/{name}/b3r", 1, 1, cin, b3r)
        conv(f"inc/{name}/b3", 3, 3, b3r, b3)
        conv(f"inc/{name}/b5r", 1, 1, cin, b5r)
        conv(f"inc/{name}/b5", 5, 5, b5r, b5)
        conv(f"inc/{name}/pp", 1, 1, cin, pp)
    dense("fc", 1024, cfg.num_classes)
    for tap, cin in zip(_AUX_AFTER, (512, 528)):
        conv(f"aux_{tap}/conv", 1, 1, cin, 128)
        dense(f"aux_{tap}/fc1", 128 * 4 * 4 if cfg.head == "flatten"
              else 128, 1024)
        dense(f"aux_{tap}/fc2", 1024, cfg.num_classes)
    return shapes


def _convnet_rows_shapes(cfg: ConvNetConfig) -> list:
    """One ``{name: (JAX shape, kind)}`` a row of a row-built arch ({}
    for the rows without parameters)."""
    fin = _flatten_fin(cfg) if cfg.head == "flatten" else None
    out = []
    for row in _convnet_rows(cfg):
        kind = row[0]
        if kind in ("c", "cl"):
            _, kh, kw, cin, cout, _, _ = row
            out.append({"w": ((kh, kw, cin, cout), "conv"),
                        "b": ((cout,), "bias")})
        elif kind in ("f", "fl"):
            f_in = fin if row[1] == -1 else row[1]
            out.append({"w": ((f_in, row[2]), "dense"),
                        "b": ((row[2],), "bias")})
        else:
            out.append({})
    return out


def _convnet_tree(cfg: ConvNetConfig, leaf):
    """The arch's tree with ``leaf(path, shape, kind)`` at each place:
    a list of row dicts, or GoogLeNet's nested dict (``stem`` a list;
    keys sorted)."""
    if cfg.arch != "googlenet":
        return [{k: leaf(f"{i}/{k}", shape, kind)
                 for k, (shape, kind) in sorted(row.items())}
                for i, row in enumerate(_convnet_rows_shapes(cfg))]
    out: dict = {}
    for path, (shape, kind) in _googlenet_shapes(cfg).items():
        _put(out, path, leaf(path, shape, kind))
    out["stem"] = [out["stem"][str(i)] for i in range(3)]
    return sorted_keys(out)


def init_convnet_numpy(cfg: ConvNetConfig, seed: int = 0):
    """Seeded parameters in ``init_convnet``'s layout and scales, with
    numpy's numbers: conv kernels (HWIO) and dense weights
    ``normal·√(2/fan_in)``, biases zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape, kind):
        if kind == "bias":
            return np.zeros(shape, np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(np.sqrt(2.0 / fan_in))

    return _convnet_tree(cfg, leaf)


def convnet_params_from_jax(params, cfg: ConvNetConfig, device=None):
    """``init_convnet``'s tree (numpy leaves) as fp32 tensors on
    ``device`` (CUDA unless ``"cpu"`` is named): conv kernels HWIO →
    OIHW in ``channels_last`` format, every shape checked."""
    dev = resolve_device(device)

    def leaf(path, shape, kind):
        node = params
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, (list, tuple)) \
                else node[k]
        a = np.asarray(node)
        if a.shape != shape:
            raise ValueError(f"param {path!r} has shape {a.shape}, config "
                             f"wants {shape}")
        t = torch.tensor(a, dtype=torch.float32, device=dev)
        if kind == "conv":
            t = t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return t

    return _convnet_tree(cfg, leaf)


def convnet_to_numpy(tree):
    """A port convnet tree (parameters or gradients) as numpy in the JAX
    layout: 4-D conv leaves back to HWIO."""
    if isinstance(tree, dict):
        return {k: convnet_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(convnet_to_numpy(v) for v in tree)
    a = tree.detach().to("cpu").numpy().copy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
