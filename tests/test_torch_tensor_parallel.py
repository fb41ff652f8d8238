"""The mesh's model axis in the port against the JAX package's: the
column→row pair, ``shard_params`` and its gather, the flagship's
forward (``vocab_parallel`` on and off) at model=4 and data=2,model=2,
its loss, gradients and one AdamW step at data=2,model=2 (the vocab
shards alone, and with ``loss_chunk``) and model=2,seq=2 (the ring),
greedy decoding at data=2,model=2 with GQA and the vocab shards, and
``train_lm_torch.py``/``generate_torch.py`` at data=2,model=2 against
data=4, all at a small size (d_model 64, 4 query / 2 or 4 KV heads,
d_head 16, 2 layers, T = 32, batch 4, fp32).

Every port case runs in one 4-rank gloo world for the module
(``battery_tensor_parallel`` in ``test_torch_world.py``), started in a
thread so that the JAX side, on 4 of the conftest's 8 virtual CPU
devices, computes meanwhile.  The JAX gradients are its
``make_train_step``'s grad body (the loss pmean'd over the batch-like
axes inside ``jax.value_and_grad``, in ``shard_map`` over the mesh),
and its step optax's ``adamw`` on them.  Tolerances: fp32 everywhere,
the packages differ in summation order only, so outputs, logits and
gradients agree to 1e-5 (max abs for outputs and logits, relative L2 a
leaf for gradients), the loss to 1e-5 relative, and each parameter leaf
after one AdamW step to 1e-5 relative L2 (as
``test_torch_sequence_parallel.py`` holds a step).  The layout is held
bitwise: each rank's shard is the JAX device's, and the gather gives
back the tree.  Decoding takes argmaxes of fp32 logits, so its tokens
are held bitwise.  The examples are held port against port: the
model-axis run's losses to the data-axis run's at 1e-5 relative, and
its decoded tokens bitwise.
"""

import concurrent.futures

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import make_forward_fn as jax_fwd
from chainermn_tpu.models import make_generate_fn as jax_gen
from chainermn_tpu.models import shard_params as jax_shard_params
from chainermn_tpu.models.transformer import _BATCH_SPEC, param_specs
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu.parallel import MeshConfig as JaxMesh
from chainermn_tpu.parallel import column_parallel_dense as jax_col
from chainermn_tpu.parallel import row_parallel_dense as jax_row
from chainermn_tpu_torch.models import TransformerConfig, init_numpy_params
from chainermn_tpu_torch.parallel.ring_attention import ring_launches

from test_torch_world import run_world

N, B, T, VOCAB, LR = 4, 4, 32, 128, 1e-3
ATOL = 1e-5

BASE = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=256, n_layers=2, max_seq=T, dtype="float32",
            remat=False, attention="local")
MHA = dict(n_kv_heads=4)      # model=4 shards the K/V heads too
# name: (mesh axes, config fields)
FWD_CASES = {
    "model4": (dict(model=4), dict(MHA, attention="flash")),
    "model4_vp": (dict(model=4), dict(MHA, vocab_parallel=True)),
    "data2_model2": (dict(data=2, model=2), dict(attention="flash")),
    "data2_model2_vp": (dict(data=2, model=2), dict(vocab_parallel=True)),
}
STEP_CASES = {
    "data2_model2_vp": (dict(data=2, model=2),
                        dict(vocab_parallel=True, attention="flash",
                             remat=True)),
    "data2_model2_vp_chunk": (dict(data=2, model=2),
                              dict(vocab_parallel=True, loss_chunk=8)),
    "model2_seq2_ring": (dict(model=2, seq=2),
                         dict(attention="ring", remat=True)),
}
LAYOUT_CASES = {"model4": FWD_CASES["model4"],
                "data2_model2_vp": FWD_CASES["data2_model2_vp"]}
GEN_CASE = (dict(data=2, model=2),
            dict(vocab_parallel=True, pos_embedding="rope"))
GEN_MAX_LEN = 32
# train_lm_torch.py at data=2,model=2 (the vocab sharded) and data=4,
# each checkpoint then resumed at the other model size
EXAMPLE_ARGV = ["--device", "cpu", "--n-layers", "2", "--batchsize", "4",
                "--lr", str(LR)]
TP_FLAGS = ["--mesh", "data=2,model=2", "--vocab-parallel"]
DP_FLAGS = ["--mesh", "data=4"]


def fields(case):
    return dict(BASE, **case[1])


def full(cases):
    """``{name: (axes, the whole config's fields)}``."""
    return {n: (c[0], fields(c)) for n, c in cases.items()}


# the int8 decoders over meshes (``_serving`` in test_torch_world.py):
# the JAX tests' tiny_cfg with GQA, RoPE, the vocabulary sharded over
# the model axis and the int8 KV cache
SERVE = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
             d_head=8, d_ff=64, n_layers=2, max_seq=16, attention="local",
             dtype="float32", remat=False, pos_embedding="rope",
             vocab_parallel=True, kv_cache_dtype="int8")


def tree_of(case):
    """Seeded weights for the case in the JAX layout (numpy), fed to
    both packages."""
    return init_numpy_params(TransformerConfig(**fields(case)), seed=0)


def batch():
    toks = np.random.RandomState(3).randint(0, VOCAB, (B, T + 1)) \
        .astype(np.int32)
    return toks[:, :T], toks[:, 1:]


def dense_inputs():
    rng = np.random.RandomState(9)
    return [rng.randn(*s).astype(np.float32)
            for s in ((2, 8, 16), (16, 32), (32, 16), (2, 8, 16))]


def gen_prompt():
    return np.random.RandomState(5).randint(0, VOCAB, (B, 8)) \
        .astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The port's 4-rank world, started with the module's first test and
    running in a thread: ``.result()`` is every rank's battery output.
    The tests compute their JAX side before they wait."""
    ck = tmp_path_factory.mktemp("tp_examples")
    x, y = batch()
    payload = dict(
        dense=dense_inputs(), x=x, y=y, lr=LR,
        layout_cases=full(LAYOUT_CASES), fwd_cases=full(FWD_CASES),
        step_cases=full(STEP_CASES),
        tree={n: tree_of(c) for n, c in
              {**FWD_CASES, **STEP_CASES}.items()},
        gen_case=(GEN_CASE[0], fields(GEN_CASE)),
        gen_tree=tree_of(GEN_CASE),
        gen_prompt=gen_prompt(), gen_max_len=GEN_MAX_LEN,
        example_argv=EXAMPLE_ARGV,
        example_runs=[
            ("tp", TP_FLAGS + ["--steps", "3"], str(ck / "tp")),
            ("dp", DP_FLAGS + ["--steps", "3"], str(ck / "dp")),
            ("tp_resumed_at_data4", DP_FLAGS + ["--steps", "5"],
             str(ck / "tp")),
            ("dp_resumed_at_model2", TP_FLAGS + ["--steps", "5"],
             str(ck / "dp"))],
        saved_after="tp", example_ck=str(ck / "tp"),
        generate_runs={
            "tp": ["--device", "cpu", "--n-layers", "2"] + TP_FLAGS,
            "dp": ["--device", "cpu", "--n-layers", "2"] + DP_FLAGS},
        serving=dict(fields=SERVE, max_len=SERVE["max_seq"], k=3,
                     tree=init_numpy_params(TransformerConfig(**SERVE),
                                            seed=2),
                     prompt=gen_prompt()[:, :4],
                     pattern=np.tile(gen_prompt()[:, :3], 3)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("tensor_parallel"),
                      N, "battery_tensor_parallel", payload)
    # the JAX steps' compilations meanwhile, a few at a time
    jax_pool = concurrent.futures.ThreadPoolExecutor(3)
    for name in STEP_CASES:
        _JAX_STEP[name] = jax_pool.submit(_jax_step, name)
    yield fut
    jax_pool.shutdown(wait=True)
    pool.shutdown(wait=True)


def jax_mesh(**axes):
    return JaxMesh(devices=jax.devices()[:N], **axes)


def rows(res, axes):
    """The global rows rank ``res`` holds: its data index's."""
    n_model = axes.get("model", 1) * axes.get("seq", 1)
    d = res["rank"] // n_model
    per = B // axes.get("data", 1)
    return slice(d * per, (d + 1) * per)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------------- #
# the column→row pair and the layout
# --------------------------------------------------------------------- #


def test_dense_pair_matches_jax(world):
    x, w1, w2, dz = dense_inputs()
    f = jax.shard_map(
        lambda a, b, c: jax_row(jax.nn.relu(jax_col(a, b)), c),
        mesh=jax_mesh(model=4).mesh,
        in_specs=(P(), P(None, "model"), P("model", None)), out_specs=P())

    def fwd_bwd(a, b, c, d):
        z, vjp = jax.vjp(f, a, b, c)
        return (z, *vjp(d))

    want = [np.asarray(t) for t in jax.jit(fwd_bwd)(x, w1, w2, dz)]
    results = world.result()
    got = [results[0]["dense"][0], results[0]["dense"][1],
           np.concatenate([r["dense"][2] for r in results], axis=1),
           np.concatenate([r["dense"][3] for r in results], axis=0)]
    for name, a, b in zip(("z", "dx", "dw1", "dw2"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
    for res in results[1:]:        # the replicated output and input grad
        np.testing.assert_array_equal(res["dense"][0], got[0])
        np.testing.assert_array_equal(res["dense"][1], got[1])


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_shard_params_is_jax_layout_and_gathers_back(world, name):
    axes, _ = LAYOUT_CASES[name]
    jcfg = JaxConfig(**fields(LAYOUT_CASES[name]))
    tree = tree_of(LAYOUT_CASES[name])
    placed = jax_shard_params(jax_mesh(**axes), jcfg, tree)
    for res in world.result():
        mine = res["layout"][name]
        jax.tree.map(np.testing.assert_array_equal, mine["gathered"], tree)
        shard = dict(mine["shard"])
        shard["blocks"] = {k: v[None] for k, v in shard["blocks"].items()}
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(shard),
                jax.tree.leaves(placed)):
            want = next(s.data for s in b.addressable_shards
                        if s.device.id == res["rank"])
            np.testing.assert_array_equal(
                a, np.asarray(want), err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------- #
# the flagship: forward, loss, gradients and a step
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_matches_jax(world, name):
    axes, _ = FWD_CASES[name]
    jcfg = JaxConfig(**fields(FWD_CASES[name]))
    mc = jax_mesh(**axes)
    x, _ = batch()
    logits = np.asarray(jax_fwd(mc, jcfg)(
        jax_shard_params(mc, jcfg, tree_of(FWD_CASES[name])), x))
    for res in world.result():
        want = logits[rows(res, axes)]
        got = res["fwd"][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# the JAX side of each step case, computed in the fixture's threads
_JAX_STEP = {}


def jax_step(name):
    return _JAX_STEP[name].result()


def _jax_step(name):
    """The JAX side of a step case: the loss and gradients of its
    ``make_train_step``'s grad body, and the parameters after optax's
    ``adamw`` applies them (remat changes no value; the JAX side
    compiles faster without it)."""
    axes, _ = STEP_CASES[name]
    jcfg = JaxConfig(**dict(fields(STEP_CASES[name]), remat=False))
    mc = jax_mesh(**axes)
    specs = param_specs(jcfg)
    grad_fn = jax.jit(jax.shard_map(
        lambda p, xx, yy: jax.value_and_grad(
            lambda q: jax.lax.pmean(jax_lm_loss(jcfg, q, xx, yy),
                                    ("data", "expert", "seq")))(p),
        mesh=mc.mesh, in_specs=(specs, _BATCH_SPEC, _BATCH_SPEC),
        out_specs=(P(), specs)))
    params = jax_shard_params(mc, jcfg, tree_of(STEP_CASES[name]))
    loss, grads = grad_fn(params, *batch())
    opt = optax.adamw(LR)

    def apply(g, p):
        return optax.apply_updates(p, opt.update(g, opt.init(p), p)[0])

    new = jax.jit(apply)(grads, params)    # eager optax takes seconds
    return (float(loss), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, new))


def assert_tree_rel(got, want, bar):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        err = rel_l2(a, b)
        assert err < bar, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_loss_and_grads_match_jax(world, name):
    loss, grads, _ = jax_step(name)
    for res in world.result():
        mine = res["step"][name]
        np.testing.assert_allclose(mine["loss"], loss, rtol=1e-5)
        assert_tree_rel(mine["grads"], grads, 1e-5)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_adamw_step_matches_jax(world, name):
    loss, _, params = jax_step(name)
    results = world.result()
    first = results[0]["step"][name]
    np.testing.assert_allclose(first["step_loss"], loss, rtol=1e-5)
    assert_tree_rel(first["params"], params, 1e-5)
    for res in results[1:]:        # every rank gathers the same tree
        assert res["step"][name]["step_loss"] == first["step_loss"]
        jax.tree.map(np.testing.assert_array_equal,
                     res["step"][name]["params"], first["params"])


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_keeps_replicas_bitwise(world, name):
    # the leaves replicated over model (norm scales, pos, embed without
    # vocab_parallel) the same bits on every model member, and every
    # leaf the same bits across the batch-like group, after the step
    for res in world.result():
        assert res["step"][name]["model_bitwise"], res["rank"]
        assert res["step"][name]["batch_bitwise"], res["rank"]


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_kernel_calls_per_rank(world, name):
    # each layer's flash calls on this rank's heads: the forward twice
    # under remat (the checkpoint recomputes the whole block), the
    # backward once; the ring's share of live pairs a call; the model
    # axis adds none
    axes, f = STEP_CASES[name]
    f = dict(BASE, **f)
    L = f["n_layers"]
    for res in world.result():
        if f["attention"] == "flash":
            live = 1
        elif f["attention"] == "ring":
            S = axes["seq"]
            live = ring_launches(S, T // S, causal=True,
                                 rank=(res["rank"] // axes["model"]) % S)
        else:
            live = 0
        want = ((2 if f["remat"] else 1) * L * live, L * live)
        assert res["step"][name]["calls"] == want, res["rank"]


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #


def test_generate_matches_jax(world):
    axes, _ = GEN_CASE
    jcfg = JaxConfig(**fields(GEN_CASE))
    want = np.asarray(jax_gen(jax_mesh(**axes), jcfg, max_len=GEN_MAX_LEN)(
        tree_of(GEN_CASE), gen_prompt()))
    for res in world.result():
        np.testing.assert_array_equal(res["gen"], want[rows(res, axes)])


# --------------------------------------------------------------------- #
# the examples
# --------------------------------------------------------------------- #


def test_train_lm_torch_model_axis_matches_data_axis(world):
    for res in world.result():
        ex = res["example"]
        assert len(ex["tp"]["losses"]) == 3
        np.testing.assert_allclose(ex["tp"]["losses"], ex["dp"]["losses"],
                                   rtol=1e-5)
        assert ex["tp"]["losses"] == world.result()[0]["example"]["tp"][
            "losses"]


def test_train_lm_torch_checkpoint_is_the_jax_layout(world):
    # saved at data=2,model=2 with the vocab sharded: the whole params and
    # the whole AdamW moments (the optimizer's tree: one a leaf) in the
    # JAX layout's shapes, blocks stacked (pipe=1, L, ...)
    saved = world.result()[0]["saved"]
    cfg = TransformerConfig(**dict(BASE, vocab_size=128, n_heads=4,
                                   n_kv_heads=0, d_ff=256))
    want = init_numpy_params(cfg, seed=0)
    shapes = jax.tree.map(np.shape, want)
    assert jax.tree.map(np.shape, saved["params"]) == shapes
    assert int(saved["step"]) == 3
    whole = jax.tree.leaves(shapes, is_leaf=lambda s: isinstance(s, tuple))
    state = saved["opt"]["state"]
    for key in ("mu", "nu"):
        assert sorted(np.shape(s[key]) for s in state) == sorted(whole)


def test_train_lm_torch_resumes_across_model_sizes(world):
    # the model=2 checkpoint resumed at model=1, and the model=1 one at
    # model=2: both runs take steps 3 and 4 from (nearly) the same state
    ex = world.result()[0]["example"]
    a, b = ex["tp_resumed_at_data4"], ex["dp_resumed_at_model2"]
    assert a["start"] == b["start"] == 3
    assert len(a["losses"]) == len(b["losses"]) == 2
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)


def test_generate_torch_model_axis_matches_data_axis(world):
    for res in world.result():
        got = res["generate"]
        assert got["tp"].shape == (8, 32)
        np.testing.assert_array_equal(got["tp"], got["dp"])


# --------------------------------------------------------------------- #
# the int8 decoders over meshes
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("what", ["greedy", "spec", "lookup", "beam"])
def test_int8_decoders_over_data2_and_model2_match_one_rank(world, what):
    # int8 weights and the int8 KV cache: each decoder over a 2-rank data
    # axis returns the rank's rows of its one-rank run, and over a
    # 2-rank model axis (heads and vocabulary sharded) every row; the
    # speculative and lookup means are the one-rank run's (the
    # acceptance is the minimum over the rows' group; the target drafts
    # for itself, so rounds commit several tokens).  The one-rank
    # runs are held against the JAX package in
    # test_torch_quantized_decoding.py and test_torch_spec_decoding.py
    for res in world.result():
        one, got = res["serving"]["one"][what], res["serving"]["half"][what]
        rows = slice(None) if res["rank"] >= 2 \
            else slice(2 * res["rank"], 2 * res["rank"] + 2)
        if what == "greedy":
            np.testing.assert_array_equal(got, one[rows])
        elif what == "beam":
            np.testing.assert_array_equal(got[0], one[0][rows])
            np.testing.assert_allclose(got[1], one[1][rows], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[0], one[0][rows])
            assert got[1] == one[1]
            if what == "spec":
                assert got[1] > 0


def test_int8_seq_kv_beam_matches_one_rank(world):
    # beam search at data=2, seq=2: each seq member reorders its block of
    # the int8 cache (values and scales); the one-rank beams and scores
    for res in world.result():
        one = res["serving"]["one"]["beam"]
        toks, scores = res["serving"]["seq_beam"]
        rows = slice(2 * (res["rank"] // 2), 2 * (res["rank"] // 2) + 2)
        np.testing.assert_array_equal(toks, one[0][rows])
        np.testing.assert_allclose(scores, one[1][rows], rtol=1e-5)


def test_int8_tree_and_greedy_at_pipe2_model2(world):
    # the int8 tree through shard_params and gather_params bitwise (the
    # scales cut as their weights without the contraction axes: wkv's
    # (L/2, 2, Hkv/2, Dh) on a rank), and greedy decoding on it
    for res in world.result():
        serving = res["serving"]
        assert serving["pp_round_trip"], res["rank"]
        assert serving["pp_scale_shape"] == (1, 2, 1, 8)
        np.testing.assert_array_equal(serving["pp_greedy"],
                                      serving["one"]["greedy"])
