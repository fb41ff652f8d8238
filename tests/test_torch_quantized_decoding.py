"""Weight-only int8 and the int8 KV cache in the port against the JAX
package: ``quantize_params_int8`` (the tree bitwise the JAX one's, for a
dense, a GQA, an MoE, a pipe-grouped and a two-chunk ``virtual_pipe``
config, on the JAX layout and on the port's), the converters and
``shard_params`` on an int8 tree (each shard bitwise the JAX
``shard_params``' at model=2, at pipe=2 and at expert=2), and greedy
decoding with ``quantized=True``, ``kv_cache_dtype="int8"`` and both,
dense and MoE, at the JAX tests' ``tiny_cfg`` size (d_model 32, 4
heads, d_head 8, 2 layers, fp32).  Decoded tokens are held bitwise; the
int8 per-step logits to the JAX package's teacher-forced ones at 1e-5
(fp32 on both sides, they differ in summation order only), and to the
fp path's at 5% of its logit range, the bound of
``tests/model_tests/test_quantization.py``.  The mesh cases (int8 at
data=2, model=2, pipe=2) run in ``test_torch_tensor_parallel.py``'s
world."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import make_generate_fn as jax_gen
from chainermn_tpu.models import param_specs
from chainermn_tpu.models import quantize_params_int8 as jax_quantize
from chainermn_tpu.models import shard_params as jax_shard
from chainermn_tpu.models.decoding import _decode_step, _make_cache
from chainermn_tpu.parallel import MeshConfig
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_generate_fn,
    params_from_jax,
    params_to_numpy,
    quantize_params_int8,
    regroup_blocks,
)

VOCAB, B, PLEN, T = 64, 4, 4, 16
TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=4, d_head=8, d_ff=64,
            n_layers=2, max_seq=T, attention="local", dtype="float32",
            remat=False)
# name: (config fields, pipe grouping of the JAX tree)
TREES = {
    "dense": (dict(), 1),
    "gqa": (dict(n_kv_heads=2, vocab_parallel=True), 1),
    "moe": (dict(moe=True, n_experts=4), 1),
    "pipe2": (dict(n_layers=4, n_kv_heads=2, vocab_parallel=True), 2),
    "virtual2": (dict(n_layers=4, virtual_pipe=2,
                      pipeline_schedule="interleaved", moe=True,
                      n_experts=2), 1),
}
# name: (config fields, quantized weights): each option, and dense and
# MoE; both options at once in test_int8_step_logits_match_jax too
DECODE = {
    "dense_w8": (dict(n_kv_heads=2, pos_embedding="rope"), True),
    "dense_kv8": (dict(n_kv_heads=2, kv_cache_dtype="int8"), False),
    "moe_both": (dict(moe=True, n_experts=4, router_top_k=2,
                      kv_cache_dtype="int8"), True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: its decode steps are many small
    ops, which a thread pool only slows (and under a busy machine's
    other test workers, by far)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(fields):
    jcfg = JaxConfig(**dict(TINY, **fields))
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def jax_tree(jcfg, seed=1):
    """Seeded weights in the JAX layout (numpy; ``jax.random`` draws them
    eagerly, an op at a time, for seconds)."""
    return init_numpy_params(TransformerConfig(**dataclasses.asdict(jcfg)),
                             seed=seed)


def quantized(jcfg, tree, eager=False):
    """The JAX ``quantize_params_int8`` of ``tree`` as numpy.  The JAX
    package calls it eagerly, an op at a time, each a compilation the
    first time its shape comes (seconds for a tree); compiled as one
    program, XLA's algebraic simplifier turns the division by 127 into
    a product by its reciprocal, an ulp off.  So it is compiled with
    that pass off (``xla_disable_hlo_passes=algsimp``): every division
    the function writes is done, as eagerly; ``eager=True`` calls it
    op by op (the first TREES case, which holds the two the same)."""
    if eager:
        return jax.tree.map(np.asarray, jax_quantize(jcfg, tree))
    fn = jax.jit(lambda t: jax_quantize(jcfg, t)).lower(tree).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return jax.tree.map(np.asarray, fn(tree))


def prompt(seed=0, length=PLEN):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (B, length)).astype(np.int32)


def one_mesh():
    return MeshConfig(data=1, devices=jax.devices()[:1])


def assert_trees_bitwise(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(
            path))


# --------------------------------------------------------------------- #
# the tree
# --------------------------------------------------------------------- #


_TREES = {}


def tree_case(name):
    """``(jcfg, cfg, tree, JAX's int8 tree)`` of a TREES case, the tree
    grouped for its pipe axis; computed once (each new leaf shape costs
    the eager JAX ops a compilation)."""
    if name not in _TREES:
        fields, pipe = TREES[name]
        jcfg, cfg = configs(fields)
        tree = init_numpy_params(cfg, seed=0, pipe_size=pipe)
        want = quantized(jcfg, tree)
        if name == "dense":
            # the compiled program's bits are the eager calls'
            assert_trees_bitwise(want, quantized(jcfg, tree, eager=True))
        _TREES[name] = (jcfg, cfg, tree, want)
    return _TREES[name]


@pytest.mark.parametrize("name", list(TREES))
def test_int8_tree_is_bitwise_jax(name):
    jcfg, cfg, tree, want = tree_case(name)
    pipe = TREES[name][1]
    # on the JAX layout (numpy in, numpy out)
    assert_trees_bitwise(quantize_params_int8(cfg, tree), want)
    # on the port's layout: the blocks (L, ...) or (V, L/V, ...), back to
    # the JAX grouping through params_to_numpy
    # the whole stack at pipe 1 (the scales are a layer's each, so the
    # JAX tree regroups as the weights do)
    whole = dict(want, blocks=regroup_blocks(want["blocks"], pipe, 1))
    port = quantize_params_int8(cfg, params_from_jax(
        init_numpy_params(cfg, seed=0), cfg, "cpu"))
    assert port["blocks"]["w1"].dtype == torch.int8
    assert "router_scale" not in port["blocks"]
    assert_trees_bitwise(params_to_numpy(port, cfg), whole)
    # and the int8 tree in: the same tensors, kinds and shapes
    again = params_from_jax(whole, cfg, "cpu")
    assert set(again) == set(port)
    for k in port:
        if k != "blocks":
            assert torch.equal(again[k], port[k]), k
    assert set(again["blocks"]) == set(port["blocks"])
    for k, v in port["blocks"].items():
        assert torch.equal(again["blocks"][k], v), k


def test_int8_tree_error_bound():
    # round to nearest: each weight within half its channel's scale
    jcfg, cfg = configs(dict(moe=True, n_experts=4))
    tree = init_numpy_params(cfg, seed=2)
    q = quantize_params_int8(cfg, tree)
    w, wq, s = (tree["blocks"]["w1"], q["blocks"]["w1"],
                q["blocks"]["w1_scale"])               # (1, L, E, D, F)
    err = np.abs(wq.astype(np.float32) * s[..., None, :] - w)
    assert (err <= s[..., None, :] * 0.5 + 1e-8).all()
    np.testing.assert_array_equal(q["blocks"]["router"],
                                  tree["blocks"]["router"])
    np.testing.assert_array_equal(q["ln_f"], tree["ln_f"])


class _Mesh:
    """The coordinates ``shard_params`` reads of one rank of a mesh."""

    device = torch.device("cpu")

    def __init__(self, axes, coords):
        self.shape = {a: axes.get(a, 1) for a in
                      ("pipe", "data", "expert", "seq", "model")}
        self.coords = coords

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords.get(a, 0)


@pytest.mark.parametrize("axes", [dict(model=2), dict(pipe=2),
                                  dict(expert=2)], ids=lambda a: str(a))
def test_int8_shards_match_jax_shard_params(axes):
    # each rank's shard of an int8 tree (the weights, and the scales cut
    # as their weights without the contraction axes) is the JAX
    # shard_params' shard on that device, bitwise
    (axis, n), = axes.items()
    jcfg, cfg, _, tree = tree_case("moe" if axis == "expert" else "pipe2")
    if axis != "pipe":
        tree = dict(tree, blocks=regroup_blocks(
            tree["blocks"], TREES["pipe2"][1] if axis == "model" else 1, 1))
    mesh = MeshConfig(devices=jax.devices()[:n], **axes)
    placed = jax_shard(mesh, jcfg, tree)
    for r in range(n):
        got = params_from_jax(tree, cfg, "cpu", mesh=_Mesh(axes, {axis: r}))
        dev = mesh.mesh.devices.flat[r]
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            keys = [k.key for k in path]
            t = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
            shard = np.asarray(next(s.data for s in leaf.addressable_shards
                                    if s.device == dev))
            if keys[0] == "blocks":
                # the JAX leaf leads with the pipe group (this stage's 1)
                shard = shard[0]
            assert t.numpy().dtype == shard.dtype, keys
            np.testing.assert_array_equal(t.numpy(), shard,
                                          err_msg=str(keys))


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(DECODE))
def test_int8_greedy_matches_jax(name):
    fields, quant = DECODE[name]
    jcfg, cfg = configs(fields)
    tree = jax_tree(jcfg)
    # the port's int8 tree, bitwise the JAX one's (above)
    qtree = quantize_params_int8(cfg, tree) if quant else tree
    p = prompt(1)
    want = np.asarray(jax_gen(one_mesh(), jcfg, max_len=T, quantized=quant)(
        jax_shard(one_mesh(), jcfg, qtree), p))
    got, logits = make_generate_fn(cfg, max_len=T, quantized=quant,
                                   with_logits=True, device="cpu")(
        params_from_jax(qtree, cfg, "cpu"), p)
    np.testing.assert_array_equal(got.numpy(), want)
    if cfg.moe:
        # weight noise flips near-tied routes: the JAX package bounds the
        # dense model's logits only
        return
    # the fp path's logits on the same tokens: int8 tracks them within
    # 5% of their range (teacher-forced: the fp model takes the int8
    # run's tokens)
    plain = dataclasses.replace(cfg, kv_cache_dtype="")
    _, ref = make_generate_fn(plain, max_len=T, with_logits=True,
                              device="cpu")(
        params_from_jax(tree, plain, "cpu"), got[:, :-1])
    scale = float(ref[:, -1].abs().max())
    assert float((logits[:, -1] - ref[:, -1]).abs().max()) < 0.05 * scale


def test_int8_step_logits_match_jax():
    # the JAX decode step teacher-forced over the port's tokens, int8
    # weights and the int8 KV cache both: every step's logits at 1e-5
    jcfg, cfg = configs(dict(kv_cache_dtype="int8"))
    qtree = quantize_params_int8(cfg, jax_tree(jcfg))
    toks, logits = make_generate_fn(cfg, max_len=T, quantized=True,
                                    with_logits=True, device="cpu")(
        params_from_jax(qtree, cfg, "cpu"), prompt(2))
    mc = one_mesh()

    def body(params, tk):
        # the prompt prefilled as one chunk (its raw K/V attended), then
        # a step a position, as make_generate_fn runs them
        caches = _make_cache(jcfg, B, T, jcfg.kv_heads, jcfg.n_layers)
        _, caches = _decode_step(jcfg, params, caches, tk[:, :PLEN - 1], 0,
                                 with_logits=False)

        def step(caches, t):
            out, caches = _decode_step(jcfg, params, caches, tk[:, t], t)
            return caches, out

        _, outs = jax.lax.scan(step, caches, jnp.arange(PLEN - 1, T - 1))
        return outs.transpose(1, 0, 2)

    fn = jax.jit(jax.shard_map(
        body, mesh=mc.mesh,
        in_specs=(param_specs(jcfg, quantized=True), P(("data", "expert"))),
        out_specs=P(("data", "expert"))))
    want = np.asarray(fn(jax_shard(mc, jcfg, qtree), toks.numpy()))
    np.testing.assert_allclose(logits.numpy(), want,
                               rtol=0, atol=1e-5)


def test_int8_kv_cache_layout():
    # int8 values, fp32 per-(token, head) scales with a trailing one,
    # and the values clipped to ±127 (the scale rounds in the K/V dtype)
    from chainermn_tpu_torch.models.decoding import _quantize_kv

    t = torch.randn(2, 3, 4, 8, dtype=torch.bfloat16) * 3
    q, s = _quantize_kv(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (2, 3, 4, 1) and int(q.abs().max()) <= 127
    import ml_dtypes

    tj = jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
    sj = jnp.maximum(jnp.max(jnp.abs(tj), axis=-1, keepdims=True) / 127.0,
                     1e-8).astype(jnp.float32)
    qj = jnp.clip(jnp.round(tj / sj.astype(tj.dtype)), -127,
                  127).astype(jnp.int8)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


def test_quantized_flag_must_match_the_tree():
    _, cfg = configs(dict())
    tree = init_numpy_params(cfg, seed=0)
    params = params_from_jax(tree, cfg, "cpu")
    with pytest.raises(ValueError, match="no int8 tree"):
        make_generate_fn(cfg, quantized=True, device="cpu")(params,
                                                            prompt())
    qparams = quantize_params_int8(cfg, params)
    with pytest.raises(ValueError, match="pass quantized=True"):
        make_generate_fn(cfg, device="cpu")(qparams, prompt())
