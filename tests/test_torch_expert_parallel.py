"""The mesh's expert axis in the port against the JAX package's: the MoE
layer (``expert_parallel_moe``) at expert groupings of 1, 2 and 4 ranks,
top-1 and top-2, at ample and clipping capacity, with forced ties and
the JAX ``test_matches_dense_top1`` oracle; the index dispatch against
the one-hot einsums of ``_moe_dense_reference``; the flagship with
``moe=True``: its forward at expert=4 and expert=2,model=2, its loss,
gradients and one AdamW step at expert=4, data=2,expert=2 (top-2),
expert=2,model=2 and pipe=2,expert=2 under GPipe, 1F1B and the
interleaved schedule (two virtual stages), MoE greedy decoding at
data=2,expert=2, and ``train_lm_torch.py``/``generate_torch.py`` with
``--moe`` over data=2,expert=2 (the JAX ``train_lm.py`` at the same
mesh, a resume at data=4, and decoding at data=4, where each rank routes
the same rows alone).  Small sizes: the layer at 32 tokens a rank, d 8,
F 16, 8 experts; the flagship at d_model 64, 4 query / 2 KV heads,
d_head 16, 2 layers (4 interleaved), T = 32, batch 8, 4 or 8 experts,
fp32.

Every port case runs in one 4-rank gloo world for the module
(``battery_expert_parallel`` in ``test_torch_world.py``), started in a
thread so that the JAX side, on 4 of the conftest's 8 virtual CPU
devices, computes meanwhile.  Tolerances: the routing (each token's
experts, queue positions, kept assignments, the slot table and the drop
count) and the slots are held bitwise, and so are decoded tokens; the
layer's output to 1e-5 max abs and its aux to 1e-5 relative; logits to
1e-5 max abs, the loss to 1e-5 relative, each gradient leaf and each
parameter leaf after the AdamW step to 1e-5 relative L2 (fp32: the
packages differ in summation order only).  The gradient of the experts
(``w1``/``w2``) is the sum over (data, seq) divided by the batch-like
group's size: a mean over the whole group would be off by the expert
axis's factor.
"""

import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import make_forward_fn as jax_fwd
from chainermn_tpu.models import make_generate_fn as jax_gen
from chainermn_tpu.models import shard_params as jax_shard_params
from chainermn_tpu.models.transformer import (
    _BATCH_SPEC,
    _make_1f1b_grad,
    param_specs,
)
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu.parallel import MeshConfig as JaxMesh
from chainermn_tpu.parallel.expert import expert_parallel_moe as jax_moe
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_value_and_grad_fn,
    params_from_jax,
)
from chainermn_tpu_torch.models.transformer import lm_loss
from chainermn_tpu_torch.parallel import expert as ep

from test_torch_world import (fsdp_step_matches_dense, moe_expert_fn,
                              run_world)

N, B, T, VOCAB, LR = 4, 8, 32, 128, 1e-3
ATOL = 1e-5

# the layer: 32 tokens a rank, d 8, F 16, 8 experts (4 for the oracle)
L_TOK, L_D, L_F = 32, 8, 16


def layer_case(S, k, cf, E=8, seed=0, tie=False):
    rng = np.random.RandomState(seed)
    router = rng.randn(L_D, E).astype(np.float32)
    if tie:
        # columns in equal pairs: each token's probabilities tie in pairs,
        # and a quarter of the tokens are zero, tying every expert
        router[:, 1::2] = router[:, 0::2]
    x = rng.randn(N * L_TOK, L_D).astype(np.float32)
    if tie:
        x[::4] = 0.0
    return dict(S=S, k=k, cf=cf, x=x, router=router,
                w1=(rng.randn(E, L_D, L_F) * 0.3).astype(np.float32),
                w2=(rng.randn(E, L_F, L_D) * 0.3).astype(np.float32))


LAYER_CASES = {
    f"s{S}_top{k}_{cap}": layer_case(S, k, 8 / k if cap == "ample" else 0.5,
                                     seed=10 * S + k)
    for S in (1, 2, 4) for k in (1, 2) for cap in ("ample", "clip")}
LAYER_CASES["tie_s2_top2"] = layer_case(2, 2, 1.0, seed=7, tie=True)
LAYER_CASES["tie_s4_top1"] = layer_case(4, 1, 1.0, seed=8, tie=True)
LAYER_CASES["oracle_s4_top1"] = layer_case(4, 1, 4.0, E=4, seed=11)

BASE = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, n_layers=2, max_seq=T, dtype="float32",
            remat=False, attention="local", moe=True, n_experts=4)
# name: (mesh axes, config fields)
FWD_CASES = {
    "expert4": (dict(expert=4), dict(n_experts=8)),
    "expert2_model2": (dict(expert=2, model=2), dict(vocab_parallel=True)),
}
STEP_CASES = {
    "gpipe_expert4": (dict(expert=4), dict(n_experts=8)),
    "gpipe_data2_expert2_top2": (dict(data=2, expert=2),
                                 dict(router_top_k=2, capacity_factor=1.0)),
    "gpipe_expert2_model2": (dict(expert=2, model=2),
                             dict(attention="flash", remat=True)),
    "gpipe_pipe2_expert2": (dict(pipe=2, expert=2),
                            dict(num_microbatches=2, remat=True)),
    "1f1b_pipe2_expert2": (dict(pipe=2, expert=2),
                           dict(num_microbatches=2,
                                pipeline_schedule="1f1b")),
    "interleaved_pipe2_expert2_v2": (dict(pipe=2, expert=2),
                                     dict(n_layers=4, num_microbatches=2,
                                          virtual_pipe=2,
                                          pipeline_schedule="interleaved")),
}
# the step cases held under "dots" remat against full remat: top-2 at
# data=2,expert=2, top-1 at expert=2,model=2 (the flash kernels), and
# 1F1B at pipe=2,expert=2
DOTS_CASES = ("gpipe_data2_expert2_top2", "gpipe_expert2_model2",
              "1f1b_pipe2_expert2")
GEN_CASES = {
    "data2_expert2": (dict(data=2, expert=2),
                      dict(pos_embedding="rope", capacity_factor=2.0)),
}
GEN_MAX_LEN = 24

# train_lm_torch.py with --moe over data=2,expert=2 (4 experts), its
# checkpoint resumed at data=4 (its 4 experts); generate_torch.py on it
EXAMPLE_STEPS = 3
EXAMPLE_ARGV = ["--device", "cpu", "--moe", "--mesh", "data=2,expert=2",
                "--steps", str(EXAMPLE_STEPS)]
RESUME_ARGV = ["--device", "cpu", "--moe", "--mesh", "data=4",
               "--steps", str(EXAMPLE_STEPS + 2)]
GENERATE_RUNS = {
    "data2_expert2": ["--device", "cpu", "--mesh", "data=2,expert=2"],
    "data4": ["--device", "cpu", "--mesh", "data=4"],
}
# train_lm.py's defaults (fp32, no remat), its MoE at expert=2
LM_CFG = dict(vocab_size=128, d_model=64, n_heads=4, d_head=16, d_ff=256,
              n_layers=4, max_seq=32, attention="local", dtype="float32",
              remat=False, moe=True, n_experts=4)


def fields(case):
    return dict(BASE, **case[1])


def full(cases):
    return {n: (c[0], fields(c)) for n, c in cases.items()}


def tree_of(case):
    """Seeded weights for the case in the JAX layout grouped for its pipe
    axis (numpy), fed to both packages."""
    return init_numpy_params(TransformerConfig(**fields(case)), seed=0,
                             pipe_size=case[0].get("pipe", 1))


def batch():
    toks = np.random.RandomState(3).randint(0, VOCAB, (B, T + 1)) \
        .astype(np.int32)
    return toks[:, :T], toks[:, 1:]


def gen_prompt():
    return np.random.RandomState(5).randint(0, VOCAB, (B, 8)) \
        .astype(np.int32)


def example_tree():
    from chainermn_tpu.models import init_transformer as jax_init

    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                             JaxConfig(**LM_CFG)))


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The port's 4-rank world, started with the module's first test and
    running in a thread: ``.result()`` is every rank's battery output.
    The tests compute their JAX side before they wait."""
    ck = tmp_path_factory.mktemp("moe_example")
    xs, ys = batch()
    payload = dict(
        layer_cases=LAYER_CASES, x=xs, y=ys, lr=LR,
        fwd_cases=full(FWD_CASES), step_cases=full(STEP_CASES),
        dots_cases=DOTS_CASES,
        tree={n: tree_of(c) for n, c in {**FWD_CASES, **STEP_CASES}.items()},
        gen_cases=full(GEN_CASES),
        gen_tree={n: tree_of(c) for n, c in GEN_CASES.items()},
        gen_prompt=gen_prompt(), gen_max_len=GEN_MAX_LEN,
        example_argv=EXAMPLE_ARGV, example_tree=example_tree(),
        resume_argv=RESUME_ARGV, example_ck=str(ck),
        generate_runs=GENERATE_RUNS)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("expert"), N,
                      "battery_expert_parallel", payload)
    # the JAX side's compilations meanwhile, a few at a time
    jax_pool = concurrent.futures.ThreadPoolExecutor(3)
    for name in STEP_CASES:
        _JAX[("step", name)] = jax_pool.submit(_jax_step, name)
    for name in LAYER_CASES:
        _JAX[("layer", name)] = jax_pool.submit(_jax_layer, name)
        _JAX[("routes", name)] = jax_pool.submit(_jax_routes, name)
    for name in FWD_CASES:
        _JAX[("fwd", name)] = jax_pool.submit(_jax_fwd, name)
    for name in GEN_CASES:
        _JAX[("gen", name)] = jax_pool.submit(_jax_gen, name)
    yield fut
    jax_pool.shutdown(wait=True)
    pool.shutdown(wait=True)


# the JAX side of each case, computed in the fixture's threads
_JAX = {}


def jax_mesh(**axes):
    n = int(np.prod(list(axes.values()))) if axes else 1
    return JaxMesh(devices=jax.devices()[:n], **axes)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def coords(rank, axes):
    """Rank ``rank``'s coordinates on the mesh ``axes`` (row-major over
    pipe, data, expert, seq, model)."""
    out = {}
    for a in reversed(("pipe", "data", "expert", "seq", "model")):
        n = axes.get(a, 1)
        out[a] = rank % n
        rank //= n
    return out


def rows(res, axes):
    """The rank's rows of the global batch: block ``d·X + e``."""
    c = coords(res["rank"], axes)
    X = axes.get("expert", 1)
    per = B // (axes.get("data", 1) * X)
    i = c["data"] * X + c["expert"]
    return slice(i * per, (i + 1) * per)


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #


def _jax_expert_fn(p, tokens):
    return jax.nn.relu(tokens @ p["w1"]) @ p["w2"]


def _jax_layer(name):
    """The JAX layer of case ``name`` in ``shard_map`` over the mesh
    ``data=4/S, expert=S``: ``(out (4·n, D), aux (4,))``, aux a rank."""
    c = LAYER_CASES[name]
    S = c["S"]
    mesh = jax_mesh(data=N // S, expert=S).mesh

    def body(x, rw, params):
        out, aux = jax_moe(x, rw, params, _jax_expert_fn,
                           axis_name="expert", capacity_factor=c["cf"],
                           top_k=c["k"])
        return out, aux[None]

    f = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(("data", "expert")), P(), P("expert")),
        out_specs=(P(("data", "expert")), P(("data", "expert")))))
    out, aux = f(c["x"], c["router"], {"w1": c["w1"], "w2": c["w2"]})
    return np.asarray(out), np.asarray(aux)


def jax_layer(name):
    return _JAX[("layer", name)].result()


def jax_routing(x, router, cf, k):
    """The JAX function's routing lines on one rank's tokens: each
    token's experts (``lax.top_k``), its queue position in each and
    whether it is kept, and the slot table (the token of each filled
    slot, ``N`` for an empty one)."""
    n, E = x.shape[0], router.shape[1]
    cap = max(1, math.ceil(cf * k * n / E))
    probs = jax.nn.softmax((jnp.asarray(x) @ jnp.asarray(router))
                           .astype(jnp.float32), axis=-1)
    _, top_i = lax.top_k(probs, k)
    onehots = jax.nn.one_hot(top_i, E, dtype=jnp.float32)
    counts = jnp.zeros((E,), jnp.float32)
    pos = []
    for r in range(k):
        oh = onehots[:, r]
        pos.append(((jnp.cumsum(oh, axis=0) - 1.0 + counts) * oh).sum(-1))
        counts = counts + oh.sum(axis=0)
    top_i = np.asarray(top_i)
    pos = np.asarray(jnp.stack(pos, axis=1)).astype(np.int64)
    keep = pos < cap
    table = np.full((E, cap), n, np.int64)
    tok = np.broadcast_to(np.arange(n)[:, None], top_i.shape)
    table[top_i[keep], pos[keep]] = tok[keep]
    return top_i, pos, keep, table


def _jax_routes(name):
    """:func:`jax_routing` of each of the 4 ranks' blocks of tokens."""
    c = LAYER_CASES[name]
    return [jax_routing(xr, c["router"], c["cf"], c["k"])
            for xr in np.split(c["x"], N)]


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_routing_and_slots_match_jax(world, name):
    c = LAYER_CASES[name]
    routes = _JAX[("routes", name)].result()
    for res in world.result():
        got = res["layer"][name]
        # the rank's block over (data, expert), row-major: its rank
        top_i, pos, keep, table = routes[res["rank"]]
        np.testing.assert_array_equal(got["top_i"], top_i)
        np.testing.assert_array_equal(got["pos"], pos)
        np.testing.assert_array_equal(got["keep"], keep)
        np.testing.assert_array_equal(got["slot_token"], table)
        assert got["dropped"] == int((~keep).sum())
        # the index dispatch is the one-hot einsum's slots, bitwise
        np.testing.assert_array_equal(got["slots"], got["dense_slots"])
    if name.endswith("_clip"):
        assert sum(r["layer"][name]["dropped"] for r in world.result()) > 0
    if name.endswith("_ample") or name.startswith("oracle"):
        assert all(r["layer"][name]["dropped"] == 0
                   for r in world.result())


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_output_and_aux_match_jax(world, name):
    out, aux = jax_layer(name)
    for res in world.result():
        got = res["layer"][name]
        i = res["rank"]      # the rank's block over (data, expert)
        np.testing.assert_allclose(got["out"], np.split(out, N)[i], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got["aux"], aux[i], rtol=1e-5)


def test_ties_go_to_the_lower_expert(world):
    # the tie cases' probabilities come in equal pairs: the chosen expert
    # of a pair is always the even one, as lax.top_k picks
    for name in ("tie_s2_top2", "tie_s4_top1"):
        for res in world.result():
            first = res["layer"][name]["top_i"][:, 0]
            assert (first % 2 == 0).all(), (name, res["rank"])


def test_layer_matches_dense_top1_oracle(world):
    # the JAX test_matches_dense_top1: ample capacity and top-1, so every
    # token is its argmax expert's output times its probability
    c = LAYER_CASES["oracle_s4_top1"]
    x, rw = c["x"], c["router"]
    logits = x @ rw
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    choice, gate = probs.argmax(-1), probs.max(-1)
    ref = np.stack([
        (np.maximum(x[i] @ c["w1"][choice[i]], 0) @ c["w2"][choice[i]])
        * gate[i] for i in range(x.shape[0])])
    got = np.concatenate([r["layer"]["oracle_s4_top1"]["out"]
                          for r in world.result()])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    assert all(r["layer"]["oracle_s4_top1"]["aux"] > 0
               for r in world.result())


@pytest.mark.parametrize("dtype,k", [(torch.float32, 1),
                                     (torch.float32, 2),
                                     (torch.bfloat16, 2)])
def test_index_path_matches_dense_reference(dtype, k):
    # one rank: the gather dispatch and combine against the one-hot
    # einsums, forward and backward, at clipping capacity
    c = LAYER_CASES["s1_top2_clip"]
    x = torch.as_tensor(c["x"][:64]).to(dtype)
    rw = torch.as_tensor(c["router"]).to(dtype)
    params = {n: torch.as_tensor(c[n]).to(dtype) for n in ("w1", "w2")}

    def run(fn):
        leaves = [x.clone().requires_grad_(), rw.clone().requires_grad_()]
        ps = {n: v.clone().requires_grad_() for n, v in params.items()}
        out, aux, *rest = fn(leaves[0], leaves[1], ps, moe_expert_fn,
                             capacity_factor=0.5, top_k=k)
        ((out.float() ** 2).sum() + aux).backward()
        return out, aux, [t.grad for t in leaves] + [ps["w1"].grad,
                                                    ps["w2"].grad], rest

    ep.expert_parallel_moe.routings = log = []
    out, aux, grads, _ = run(ep.expert_parallel_moe)
    ep.expert_parallel_moe.routings = None
    d_out, d_aux, d_grads, (d_slots,) = run(ep._moe_dense_reference)
    torch.testing.assert_close(ep.dispatch(x, log[0]), d_slots, rtol=0,
                               atol=0)
    assert int(log[0].dropped) > 0
    assert bool((out[~log[0].keep.any(1)] == 0).all())
    tol = dict(rtol=0, atol=0) if dtype == torch.float32 and k == 1 \
        else dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out, d_out, **tol)
    torch.testing.assert_close(aux, d_aux, rtol=1e-6, atol=0)
    for g, d in zip(grads, d_grads):
        torch.testing.assert_close(g.float(), d.float(), rtol=2e-2
                                   if dtype == torch.bfloat16 else 1e-5,
                                   atol=2e-2 if dtype == torch.bfloat16
                                   else 1e-5)


@pytest.mark.parametrize("name", ["s2_top2_clip", "s4_top1_clip",
                                  "tie_s2_top2"])
def test_simulated_expert_axis_matches_the_world(world, name):
    # every rank of the grouping on one device: the world's outputs in
    # rank order, and the mean of its ranks' aux
    c = LAYER_CASES[name]
    S = c["S"]
    out, aux = ep.simulate_expert_parallel(
        torch.as_tensor(c["x"]), torch.as_tensor(c["router"]),
        {n: torch.as_tensor(c[n]) for n in ("w1", "w2")}, moe_expert_fn,
        axis=ep.SimulatedExpertAxis(S, data=N // S), capacity_factor=c["cf"],
        top_k=c["k"])
    results = world.result()
    np.testing.assert_array_equal(
        out.numpy(), np.concatenate([r["layer"][name]["out"]
                                     for r in results]))
    np.testing.assert_allclose(
        float(aux), np.mean([r["layer"][name]["aux"] for r in results]),
        rtol=1e-6)


def test_unported_moe_options_raise():
    # the collective-plan IR is item 10; "dots" remat with an expert axis
    # is ported (test_dots_remat_is_full_remat_and_matches_jax): its
    # config builds a step over an expert axis
    from chainermn_tpu_torch.communicators import LoopbackCommunicator

    loop = LoopbackCommunicator(device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        ep.expert_parallel_moe(torch.zeros(4, 2), torch.zeros(2, 2), {},
                               moe_expert_fn, comm=loop, a2a_plan=object())
    cfg = TransformerConfig(**dict(BASE, remat=True, remat_policy="dots"))
    assert callable(make_value_and_grad_fn(cfg, mesh=_FakeMesh()))
    # FSDP is ported (test_torch_fsdp.py): the MoE flagship at one data
    # member is the same config's without it, bit for bit
    losses, dense, same = fsdp_step_matches_dense(
        TransformerConfig(**dict(BASE, fsdp=True)))
    assert losses == dense and same


class _FakeMesh:
    """A one-process stand-in for a mesh with an expert axis of 2: only
    what the checks before any exchange read."""

    shape = dict(pipe=1, data=1, expert=2, seq=1, model=1)
    device = torch.device("cpu")

    def axis_size(self, a):
        return self.shape[a]

    def comm(self, *axes):
        import types

        return types.SimpleNamespace(size=int(np.prod(
            [self.shape[a] for a in axes])), device=self.device)


# --------------------------------------------------------------------- #
# the flagship
# --------------------------------------------------------------------- #


def _jax_fwd(name):
    axes, _ = FWD_CASES[name]
    jcfg = JaxConfig(**fields(FWD_CASES[name]))
    mc = jax_mesh(**axes)
    return np.asarray(jax_fwd(mc, jcfg)(
        jax_shard_params(mc, jcfg, tree_of(FWD_CASES[name])), batch()[0]))


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_matches_jax(world, name):
    axes, _ = FWD_CASES[name]
    logits = _JAX[("fwd", name)].result()
    for res in world.result():
        want = logits[rows(res, axes)]
        got = res["fwd"][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def jax_step(name):
    return _JAX[("step", name)].result()


def _jax_step(name):
    """The JAX side of a step case: the loss and gradients of its
    ``make_train_step``'s grad body, and the parameters after optax's
    ``adamw`` applies them."""
    axes, _ = STEP_CASES[name]
    jcfg = JaxConfig(**dict(fields(STEP_CASES[name]), remat=False))
    mc = jax_mesh(**axes)
    specs = param_specs(jcfg)
    if jcfg.pipeline_schedule == "gpipe":
        body = lambda p, xx, yy: jax.value_and_grad(  # noqa: E731
            lambda q: jax.lax.pmean(jax_lm_loss(jcfg, q, xx, yy),
                                    ("data", "expert", "seq")))(p)
    else:
        body = _make_1f1b_grad(jcfg)
    grad_fn = jax.jit(jax.shard_map(
        body, mesh=mc.mesh, in_specs=(specs, _BATCH_SPEC, _BATCH_SPEC),
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
def test_expert_replicated_leaves_are_bitwise_across_the_group(world, name):
    # the router, attention, norms and embedding: the same parameter bits
    # on every member of the expert group after the step; and each layer
    # of each micro-batch routed once a forward (the drops recorded)
    for res in world.result():
        mine = res["step"][name]
        assert mine["expert_bitwise"], res["rank"]
        assert len(mine["dropped"]) >= BASE["n_layers"]
    # top-2 at capacity factor 1 drops some assignments
    assert sum(sum(r["step"]["gpipe_data2_expert2_top2"]["dropped"])
               for r in world.result()) > 0


def test_expert_gradients_are_the_data_seq_sum_over_the_group(world):
    # the factor the expert group's mean would put on w1/w2: their
    # gradient is the sum over (data, seq) divided by D·X·S, not the
    # group mean of members that hold different experts
    _, grads, _ = jax_step("gpipe_expert4")
    mine = world.result()[0]["step"]["gpipe_expert4"]["grads"]["blocks"]
    for k in ("w1", "w2"):
        assert rel_l2(mine[k], grads["blocks"][k]) < 1e-5
        assert rel_l2(4 * mine[k], grads["blocks"][k]) > 1


@pytest.mark.parametrize("name", DOTS_CASES)
def test_dots_remat_is_full_remat_and_matches_jax(world, name):
    # "dots" with an expert axis: the gradients bitwise full remat's, the
    # recompute's all-to-alls the same as full remat's and the same on
    # every rank, the flash forward once a layer (never in the
    # recompute), and the gradients JAX's at 1e-5 relative L2.  (The
    # 1F1B schedule recomputes each stage in its backward slot whatever
    # the policy, in both packages.)
    loss, grads, _ = jax_step(name)
    fields_ = fields(STEP_CASES[name])
    results = world.result()

    def coll(calls):
        return {k: v for k, v in calls.items() if not k.startswith("flash")}

    want = coll(results[0]["dots"][name]["calls"]["dots"])
    assert want.get("all_to_all_single")
    for res in results:
        d = res["dots"][name]
        assert d["bitwise"], res["rank"]
        calls = d["calls"]
        assert coll(calls["dots"]) == coll(calls["full"]) == want
        L = fields_["n_layers"]
        if fields_["attention"] == "flash":
            assert (calls["dots"]["flash_fwd"], calls["full"]["flash_fwd"],
                    calls["dots"]["flash_bwd"]) == (L, 2 * L, L)
        np.testing.assert_allclose(d["loss"], loss, rtol=1e-5)
        assert_tree_rel(d["grads"], grads, 1e-5)


def test_simulated_expert_axis_loss_matches_the_world(world):
    # the flagship's loss at expert=4 from one device: every rank's
    # routing simulated (SimulatedExpertAxis), the world's mean loss
    axes, _ = STEP_CASES["gpipe_expert4"]
    cfg = TransformerConfig(**fields(STEP_CASES["gpipe_expert4"]))
    params = params_from_jax(tree_of(STEP_CASES["gpipe_expert4"]), cfg,
                             "cpu")
    x, y = batch()
    with torch.no_grad():
        loss = lm_loss(cfg, params, torch.as_tensor(x), torch.as_tensor(y),
                       expert=ep.SimulatedExpertAxis(4))
    np.testing.assert_allclose(
        float(loss), world.result()[0]["step"]["gpipe_expert4"]["loss"],
        rtol=1e-5)


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #


def _jax_gen(name):
    axes, _ = GEN_CASES[name]
    jcfg = JaxConfig(**fields(GEN_CASES[name]))
    return np.asarray(jax_gen(jax_mesh(**axes), jcfg, max_len=GEN_MAX_LEN)(
        tree_of(GEN_CASES[name]), gen_prompt()))


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_matches_jax(world, name):
    axes, _ = GEN_CASES[name]
    want = _JAX[("gen", name)].result()
    for res in world.result():
        np.testing.assert_array_equal(res["gen"][name], want[rows(res, axes)])


# --------------------------------------------------------------------- #
# the examples
# --------------------------------------------------------------------- #


def test_train_lm_torch_moe_matches_jax_example(world, monkeypatch, capsys):
    import sys

    from test_torch_lm_examples import load, printed_losses

    from chainermn_tpu import parallel

    real = parallel.MeshConfig
    # the JAX example's mesh on 4 of the 8 virtual devices
    monkeypatch.setattr(parallel, "MeshConfig", lambda **axes: real(
        devices=jax.devices()[:4], **axes))
    ex = load("examples/transformer/train_lm.py", "train_lm")
    monkeypatch.setattr(sys, "argv", [
        "train_lm.py", "--moe", "--mesh", "data=2,expert=2", "--steps",
        str(EXAMPLE_STEPS)])
    last = ex.main()
    want = printed_losses(capsys.readouterr().out)
    mine = world.result()[0]["example"]
    got = printed_losses(mine["printed"])
    assert len(got) == len(want) == 3
    # the first loss, before any update, to the printed precision; after
    # the updates the runs part a little: an expert's ReLU meets
    # pre-activations within an ulp of zero (a 1-ulp difference of the
    # input flips its gradient), and AdamW's first steps move every
    # weight by about the learning rate whatever its gradient's size, so
    # the routing then flips for a few tokens
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3)
    np.testing.assert_allclose(mine["losses"][-1], last, rtol=1e-3)
    assert len(mine["losses"]) == EXAMPLE_STEPS
    for res in world.result()[1:]:                 # the ranks' means
        assert res["example"]["losses"] == mine["losses"]


def test_train_lm_torch_moe_resumes_at_another_expert_grouping(world):
    ex = world.result()[0]["example"]
    assert ex["start"] == EXAMPLE_STEPS and len(ex["resumed"]) == 2
    assert np.isfinite(ex["resumed"]).all()


def test_generate_torch_moe_expert_axis_matches_data_axis(world):
    # each rank routes its own rows alone on both meshes: the same tokens
    for res in world.result():
        got = res["example"]["generate"]
        assert got["data2_expert2"].shape == (8, 32)
        np.testing.assert_array_equal(got["data2_expert2"], got["data4"])
