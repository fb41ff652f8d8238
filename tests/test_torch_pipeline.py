"""The mesh's pipe axis in the port against the JAX package's: the GPipe,
1F1B and interleaved schedules on a toy stage, ``_interleaved_tables``,
the pipe layout (``shard_params``, its gather, ``regroup_blocks``), the
flagship's forward at pipe=4 and pipe=2,data=2, its loss, gradients and
one AdamW step under each schedule (gpipe at pipe=2,data=2, 1F1B at
pipe=4 and at pipe=2,model=2 with the vocabulary sharded, interleaved
at pipe=2 with two virtual stages, and gpipe's micro-batches on one
rank), pipe-sharded greedy decoding at pipe=4 and pipe=2,model=2, and
``train_lm_torch.py``/``generate_torch.py`` at pipe=2,data=2 against
data=4, all at a small size (d_model 64, 4 query / 2 KV heads, d_head
16, 4 or 8 layers, T = 32, batch 8, fp32, plain attention where the
kernel's calls are not counted).

Every port case runs in one 4-rank gloo world for the module
(``battery_pipeline`` in ``test_torch_world.py``), started in a thread
so that the JAX side, on 4 of the conftest's 8 virtual CPU devices,
computes meanwhile.  The JAX schedules run in ``shard_map`` over the
mesh's pipe axis; the JAX gradients of the flagship are its
``make_train_step``'s grad body (GPipe: the loss pmean'd over the
batch-like axes inside ``jax.value_and_grad``; 1F1B and interleaved:
``_make_1f1b_grad``), and its step optax's ``adamw`` on them.
Tolerances: fp32 everywhere, the packages differ in summation order
only, so outputs, logits and gradients agree to 1e-5 (max abs for
outputs, logits and the toy schedules' results, relative L2 a leaf for
the flagship's gradients), the loss to 1e-5 relative, and each parameter
leaf after one AdamW step to 1e-5 relative L2.  The layout and
``_interleaved_tables`` are held bitwise, decoding's tokens bitwise, and
the leaves replicated over pipe (``embed``, ``pos``, ``ln_f``) must have
the same gradient and parameter bits on every stage.  The examples are
held port against port: the pipe run's losses to the data-axis run's at
1e-5 relative, its decoded tokens bitwise.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
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
from chainermn_tpu.models.transformer import regroup_blocks as jax_regroup
from chainermn_tpu.parallel import MeshConfig as JaxMesh
from chainermn_tpu.parallel.pipeline import (
    _interleaved_tables as jax_tables,
    pipeline_apply as jax_apply,
    pipeline_train_1f1b as jax_1f1b,
    pipeline_train_interleaved as jax_interleaved,
)
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    params_from_jax,
    params_to_numpy,
    regroup_blocks,
)
from chainermn_tpu_torch.parallel.pipeline import _interleaved_tables

from test_torch_world import run_world

N, B, T, VOCAB, LR = 4, 8, 32, 128, 1e-3
ATOL = 1e-5

BASE = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=256, n_layers=4, max_seq=T, dtype="float32",
            remat=False, attention="local")
# name: (mesh axes, config fields); None: no mesh (one rank)
FWD_CASES = {
    "pipe4": (dict(pipe=4), dict(n_layers=8, num_microbatches=4)),
    "pipe2_data2": (dict(pipe=2, data=2), dict(num_microbatches=2)),
}
STEP_CASES = {
    "gpipe_pipe2_data2": (dict(pipe=2, data=2),
                          dict(num_microbatches=2, attention="flash",
                               remat=True)),
    "1f1b_pipe4": (dict(pipe=4),
                   dict(n_layers=8, num_microbatches=4, attention="flash",
                        pipeline_schedule="1f1b")),
    "interleaved_pipe2_v2": (dict(pipe=2, data=2),
                             dict(num_microbatches=2, virtual_pipe=2,
                                  pipeline_schedule="interleaved")),
    "1f1b_pipe2_model2_vp": (dict(pipe=2, model=2),
                             dict(num_microbatches=2, vocab_parallel=True,
                                  pipeline_schedule="1f1b")),
    "gpipe_one_rank_m4": (None, dict(num_microbatches=4)),
}
LAYOUT_CASES = {
    "pipe4": (dict(pipe=4), dict(n_layers=8)),
    "pipe2_model2": (dict(pipe=2, model=2), dict(vocab_parallel=True)),
    "pipe2_v2": (dict(pipe=2, data=2),
                 dict(virtual_pipe=2, pipeline_schedule="interleaved")),
}
GEN_CASES = {
    "pipe4": (dict(pipe=4), dict(n_layers=8, pos_embedding="rope")),
    "pipe2_model2": (dict(pipe=2, model=2), dict(vocab_parallel=True)),
}
GEN_MAX_LEN = 32

# the toy schedules: (kind, S, M, extra); V virtual stages of S·V toy
# stages for the interleaved ones
TOY_DIM, TOY_B, AUX_WEIGHT = 5, 16, 0.5
TOY_CASES = {
    "apply_m4": dict(kind="apply", S=4, M=4, remat=True),
    "apply_m8_no_remat": dict(kind="apply", S=4, M=8, remat=False),
    "apply_m4_aux": dict(kind="apply", S=4, M=4, remat=True, aux=True,
                         aux_weight=AUX_WEIGHT),
    "apply_m8_aux_no_remat": dict(kind="apply", S=4, M=8, remat=False,
                                  aux=True, aux_weight=AUX_WEIGHT),
    "1f1b_m8_aux": dict(kind="1f1b", S=4, M=8, aux=True,
                        aux_weight=AUX_WEIGHT),
    "interleaved_s2_v2_m4": dict(kind="interleaved", S=2, V=2, M=4),
    "interleaved_s4_v2_m8": dict(kind="interleaved", S=4, V=2, M=8),
}

# train_lm_torch.py at pipe=2,data=2 (1F1B) and data=4, each checkpoint
# then resumed at the other grouping
EXAMPLE_ARGV = ["--device", "cpu", "--n-layers", "4", "--batchsize", "4",
                "--lr", str(LR)]
PP_FLAGS = ["--mesh", "pipe=2,data=2", "--schedule", "1f1b"]
DP_FLAGS = ["--mesh", "data=4"]


def fields(case):
    return dict(BASE, **case[1])


def full(cases):
    return {n: (c[0], fields(c)) for n, c in cases.items()}


def pipe_of(case):
    return (case[0] or {}).get("pipe", 1)


def tree_of(case):
    """Seeded weights for the case in the JAX layout grouped for its pipe
    axis (numpy), fed to both packages."""
    return init_numpy_params(TransformerConfig(**fields(case)), seed=0,
                             pipe_size=pipe_of(case))


def batch():
    toks = np.random.RandomState(3).randint(0, VOCAB, (B, T + 1)) \
        .astype(np.int32)
    return toks[:, :T], toks[:, 1:]


def gen_prompt():
    return np.random.RandomState(5).randint(0, VOCAB, (B, 8)) \
        .astype(np.int32)


def toy_inputs():
    rng = np.random.RandomState(1)
    stages = [{"w": (rng.randn(TOY_DIM, TOY_DIM) * 0.3).astype(np.float32),
               "b": (rng.randn(TOY_DIM) * 0.1).astype(np.float32)}
              for _ in range(8)]
    lp = {"head": (rng.randn(TOY_DIM, 2) * 0.3).astype(np.float32)}
    x = rng.randn(TOY_B, TOY_DIM).astype(np.float32)
    y = rng.randn(TOY_B, 2).astype(np.float32)
    return stages, lp, x, y


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The port's 4-rank world, started with the module's first test and
    running in a thread: ``.result()`` is every rank's battery output.
    The tests compute their JAX side before they wait."""
    ck = tmp_path_factory.mktemp("pp_examples")
    stages, lp, x, y = toy_inputs()
    xs, ys = batch()
    payload = dict(
        toy=dict(stages=stages, lp=lp, x=x, y=y, cases=TOY_CASES),
        x=xs, y=ys, lr=LR,
        layout_cases=full(LAYOUT_CASES), fwd_cases=full(FWD_CASES),
        step_cases=full(STEP_CASES),
        tree={n: tree_of(c) for n, c in
              {**LAYOUT_CASES, **FWD_CASES, **STEP_CASES}.items()},
        gen_cases=full(GEN_CASES),
        gen_tree={n: tree_of(c) for n, c in GEN_CASES.items()},
        gen_prompt=gen_prompt(), gen_max_len=GEN_MAX_LEN,
        example_argv=EXAMPLE_ARGV,
        example_runs=[
            ("pp", PP_FLAGS + ["--steps", "3"], str(ck / "pp")),
            ("dp", DP_FLAGS + ["--steps", "3"], str(ck / "dp")),
            ("pp_resumed_at_data4", DP_FLAGS + ["--steps", "5"],
             str(ck / "pp")),
            ("dp_resumed_at_pipe2", PP_FLAGS + ["--steps", "5"],
             str(ck / "dp"))],
        example_ck=str(ck / "pp"),
        generate_runs={
            "pp": ["--device", "cpu", "--n-layers", "4", "--mesh",
                   "pipe=2,data=2"],
            "dp": ["--device", "cpu", "--n-layers", "4", "--mesh",
                   "data=4"]})
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("pipeline"), N,
                      "battery_pipeline", payload)
    # the JAX side's compilations meanwhile, a few at a time
    jax_pool = concurrent.futures.ThreadPoolExecutor(3)
    for name in STEP_CASES:
        _JAX_STEP[name] = jax_pool.submit(_jax_step, name)
    for name in TOY_CASES:
        _JAX_TOY[name] = jax_pool.submit(_jax_toy, name)
    yield fut
    jax_pool.shutdown(wait=True)
    pool.shutdown(wait=True)


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
    d = coords(res["rank"], axes)["data"]
    per = B // axes.get("data", 1)
    return slice(d * per, (d + 1) * per)


# --------------------------------------------------------------------- #
# the schedules on the toy stage
# --------------------------------------------------------------------- #


def _toy_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _toy_stage_aux(p, x):
    y = _toy_stage(p, x)
    return y, jnp.mean(y * y) * 0.1


def _toy_loss(lp, y, tgt):
    return jnp.mean((y @ lp["head"] - tgt) ** 2)


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


# the JAX side of each case, computed in the fixture's threads
_JAX_TOY = {}


def jax_toy(name):
    return _JAX_TOY[name].result()


def _jax_toy(name):
    """The JAX schedule of toy case ``name`` in ``shard_map`` over a mesh
    ``pipe=S, data=4/S`` (the batch the same on every data member), as
    world-stacked results (leading axis: pipe)."""
    case = TOY_CASES[name]
    S, M = case["S"], case["M"]
    aux = case.get("aux", False)
    fn = _toy_stage_aux if aux else _toy_stage
    stages, lp, x, y = toy_inputs()
    mesh = jax_mesh(pipe=S, data=N // S).mesh
    if case["kind"] == "apply":
        def loss(p, xs):
            res = jax_apply(fn, p, xs, axis_name="pipe", num_microbatches=M,
                            remat=case["remat"], with_aux=aux)
            o, a = res if aux else (res, jnp.zeros((), jnp.float32))
            return _toy_loss(lp, o, y) + case.get("aux_weight", 0) * a, (o, a)

        def body(p, xs):
            # x is replicated: its gradient comes out summed over pipe
            (_, (o, a)), (gp, dx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(p, xs)
            return o, a, gp, dx

        f = jax.shard_map(body, mesh=mesh, in_specs=(P("pipe"), P()),
                          out_specs=(P(), P(), P("pipe"), P()))
        o, a, gp, dx = jax.jit(f)(_stack(stages[:S]), x)
        res = dict(out=np.asarray(o), aux=float(a) if aux else None,
                   gp=jax.tree.map(np.asarray, gp), dx=np.asarray(dx))
    else:
        kw = dict(axis_name="pipe", num_microbatches=M, with_aux=aux)
        if aux:
            kw["aux_weight"] = case["aux_weight"]
        if case["kind"] == "1f1b":
            params = _stack(stages[:S])
            call = jax_1f1b
        else:
            V = case["V"]
            params = jax.tree.map(
                lambda a: a.reshape(V, S, *a.shape[1:]).swapaxes(0, 1),
                _stack(stages[:S * V]))
            call, kw["num_chunks"] = jax_interleaved, V
        n_out = 5 if aux else 4
        specs = (P(), P()) if aux else (P(),)
        f = jax.shard_map(
            lambda p, lpp, xs, ys: call(fn, _toy_loss, p, lpp, xs, ys, **kw),
            mesh=mesh, in_specs=(P("pipe"), P(), P(), P()),
            out_specs=specs + (P("pipe"), P(), P()))
        out = jax.jit(f)(params, lp, x, y)
        assert len(out) == n_out
        res = jax.tree.map(np.asarray, out)
    return res


def _pipe_index(res, S):
    return coords(res["rank"], dict(pipe=S, data=N // S))["pipe"]


@pytest.mark.parametrize("name", list(TOY_CASES))
def test_toy_schedule_matches_jax(world, name):
    case = TOY_CASES[name]
    S = case["S"]
    want = jax_toy(name)
    for res in world.result():
        got, s = res["toy"][name], _pipe_index(res, S)
        if case["kind"] == "apply":
            np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(got["dx"], want["dx"], rtol=0,
                                       atol=ATOL)
            if case.get("aux"):
                np.testing.assert_allclose(got["aux"], want["aux"],
                                           rtol=1e-5)
            for k in ("w", "b"):
                np.testing.assert_allclose(got["gp"][k], want["gp"][k][s],
                                           rtol=0, atol=ATOL, err_msg=k)
            continue
        # (loss, [aux,] stage_grads, loss_grads, dx)
        head, gp, glp, dx = got[:-3], got[-3], got[-2], got[-1]
        w_head, w_gp, w_glp, w_dx = want[:-3], want[-3], want[-2], want[-1]
        for a, b in zip(head, w_head):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        np.testing.assert_allclose(dx, w_dx, rtol=0, atol=ATOL)
        np.testing.assert_allclose(glp["head"], w_glp["head"], rtol=0,
                                   atol=ATOL)
        chunks = gp if isinstance(gp, list) else [gp]
        for c, g in enumerate(chunks):
            for k in ("w", "b"):
                w = w_gp[k][s] if case["kind"] == "1f1b" else w_gp[k][s][c]
                np.testing.assert_allclose(g[k], w, rtol=0, atol=ATOL,
                                           err_msg=f"chunk {c} {k}")


def test_stack_stage_params_matches_jax():
    import torch

    from chainermn_tpu.parallel import stack_stage_params as jax_stack
    from chainermn_tpu_torch.parallel import (
        stack_stage_params,
        unstack_stage_params,
    )

    stages = toy_inputs()[0][:4]
    mine = stack_stage_params(
        [{k: torch.as_tensor(v) for k, v in st.items()} for st in stages])
    want = jax_stack(stages)
    for k in ("w", "b"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(want[k]))
    for a, st in zip(unstack_stage_params(mine), stages):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k].numpy(), st[k])


def test_unported_pipeline_options_raise():
    # the collective-plan IR's edge lowering is item 10; FSDP's
    # shard-width moments are ported (test_torch_fsdp.py): at one data
    # member reshard_train_state lays out the config's tree without
    # FSDP, bit for bit
    import torch

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.models import reshard_train_state
    from chainermn_tpu_torch.parallel import MeshConfig, pipeline_apply

    loop = LoopbackCommunicator(device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        pipeline_apply(lambda p, x: x, {}, torch.zeros(2, 3), comm=loop,
                       num_microbatches=1, edge_plan=object())
    cfg = TransformerConfig(**dict(BASE, fsdp=True))
    tree = init_numpy_params(cfg, seed=0)
    opt = training.adamw(1e-3)
    params = params_from_jax(tree, cfg, "cpu")
    state = training.optimizer_state_tree(opt.init(params))
    for t in state["state"]:
        t["mu"] = t["mu"] + 1.0
    # the moments in the JAX layout, as a checkpoint keeps them
    state = training.map_state_moments(
        state, params, lambda t: params_to_numpy(t, cfg))
    mesh = MeshConfig(loop)
    got = [reshard_train_state(mesh, c, opt, tree, state)
           for c in (cfg, TransformerConfig(**BASE))]
    leaves = torch.utils._pytree.tree_leaves
    (p1, s1), (p2, s2) = got
    m1, m2 = (training.optimizer_state_tree(s)["state"] for s in (s1, s2))
    for a, b in zip(leaves(p1) + leaves(m1), leaves(p2) + leaves(m2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,V,M", [(1, 1, 3), (2, 1, 4), (2, 2, 2),
                                   (2, 2, 6), (3, 2, 6), (4, 2, 8),
                                   (4, 3, 4), (2, 4, 4)])
def test_interleaved_tables_match_jax(S, V, M):
    for a, b in zip(_interleaved_tables(S, V, M), jax_tables(S, V, M)):
        np.testing.assert_array_equal(a, b)


def test_interleaved_tables_need_divisible_microbatches():
    with pytest.raises(ValueError) as got:
        _interleaved_tables(4, 2, 6)
    with pytest.raises(ValueError) as want:
        jax_tables(4, 2, 6)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# the layout
# --------------------------------------------------------------------- #


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


def test_regroup_blocks_is_jax_bitwise():
    cfg = TransformerConfig(**dict(BASE, n_layers=8))
    blocks = init_numpy_params(cfg, seed=0)["blocks"]
    mine, theirs, at = blocks, blocks, (1, 1)
    for to in ((2, 1), (2, 2), (4, 1), (1, 1)):
        mine = regroup_blocks(mine, at[0], to[0], at[1], to[1])
        theirs = jax_regroup(theirs, at[0], to[0], at[1], to[1])
        jax.tree.map(np.testing.assert_array_equal, mine,
                     jax.tree.map(np.asarray, theirs))
        at = to
    jax.tree.map(np.testing.assert_array_equal, mine, blocks)


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
    mc = jax_mesh(**(axes or {}))
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


@pytest.mark.parametrize("name", [n for n, c in STEP_CASES.items()
                                  if c[0] is not None])
def test_pipe_replicated_leaves_are_bitwise_across_stages(world, name):
    # embed, pos and ln_f: their gradients and their parameters after the
    # step the same bits on every stage
    for res in world.result():
        assert res["step"][name]["pipe_bitwise"], res["rank"]


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_kernel_calls_per_rank(world, name):
    # each of the rank's layers, on each micro-batch: the forward twice
    # (the stage's forward, then its recompute: GPipe's remat, or the
    # 1F1B backward slot), the backward once; no call under "local"
    axes, f = STEP_CASES[name]
    f = dict(BASE, **f)
    per_rank = f["n_layers"] // (axes or {}).get("pipe", 1)
    fwd = 2 if f["remat"] or f.get("pipeline_schedule", "gpipe") != \
        "gpipe" else 1
    n = per_rank * f["num_microbatches"] if f["attention"] == "flash" else 0
    for res in world.result():
        assert res["step"][name]["calls"] == (fwd * n, n), res["rank"]


# --------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_matches_jax(world, name):
    axes, _ = GEN_CASES[name]
    jcfg = JaxConfig(**fields(GEN_CASES[name]))
    want = np.asarray(jax_gen(jax_mesh(**axes), jcfg, max_len=GEN_MAX_LEN)(
        tree_of(GEN_CASES[name]), gen_prompt()))
    for res in world.result():
        np.testing.assert_array_equal(res["gen"][name], want[rows(res, axes)])


# --------------------------------------------------------------------- #
# the examples
# --------------------------------------------------------------------- #


def test_train_lm_torch_pipe_axis_matches_data_axis(world):
    first = world.result()[0]["example"]
    for res in world.result():
        ex = res["example"]
        assert len(ex["pp"]["losses"]) == 3
        np.testing.assert_allclose(ex["pp"]["losses"], ex["dp"]["losses"],
                                   rtol=1e-5)
        assert ex["pp"]["losses"] == first["pp"]["losses"]


def test_train_lm_torch_resumes_across_pipe_groupings(world):
    # the pipe=2 checkpoint resumed at pipe=1, and the pipe=1 one at
    # pipe=2: both runs take steps 3 and 4 from (nearly) the same state
    ex = world.result()[0]["example"]
    a, b = ex["pp_resumed_at_data4"], ex["dp_resumed_at_pipe2"]
    assert a["start"] == b["start"] == 3
    assert len(a["losses"]) == len(b["losses"]) == 2
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)


def test_generate_torch_pipe_axis_matches_data_axis(world):
    for res in world.result():
        got = res["generate"]
        assert got["pp"].shape == (8, 32)
        np.testing.assert_array_equal(got["pp"], got["dp"])
