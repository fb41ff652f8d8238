"""FSDP / ZeRO-3 in the port against the JAX package's: the generic
utilities (``parallel/fsdp.py``: the dim selection case for case, the
gather's wire and empty leaves, the generic MLP at data=4 against the
JAX package's FSDP MLP and the replicated one), the layer stream of
``parallel/sharded_state.py`` (its forward against the plain forward
and the JAX oracle, its window), and the flagship under ``fsdp=True``
(the counterpart of ``tests/model_tests/test_fsdp.py``) at data=4,
data=2,seq=2 (ring), data=2,model=2, data=2,expert=2 (MoE) and
data=2,pipe=2 under GPipe, 1F1B and interleaved (two virtual stages).

The port's cases run in one 4-rank gloo world (``battery_fsdp`` in
``test_torch_world.py``), started in a thread while the JAX side, on 4
of the conftest's 8 virtual CPU devices, computes a few cases at a
time.  Each mesh trains 3 steps of ``adam(1e-2)`` from the same seeded
weights with FSDP and without, and the JAX package trains its
``fsdp=True`` on the same mesh: losses within 1e-5 and parameters
within 2e-5 (the JAX test's bars; fp32, the packages and the exchanges
sum in other orders), elementwise against the port's run without FSDP
and as each leaf's relative L2 against the JAX package's (adam's first
steps move the few elements whose gradient is near zero by up to 1e-4
on either package's rounding).  The bf16 wire is held as the JAX test holds it
(the loss falls, within 0.05 of the fp32 wire's).  Small sizes: the
JAX tests' ``tiny_cfg`` (d_model 32, 4 heads of 8, d_ff 64, 2-8
layers, T=16, batch 8, fp32).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import make_train_step as jax_train_step
from chainermn_tpu.models import shard_params as jax_shard_params
from chainermn_tpu.parallel import MeshConfig as JaxMesh
from chainermn_tpu.parallel import fsdp as jfsdp
from chainermn_tpu.training import shard_opt_state as jax_shard_opt_state
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_forward_fn,
    make_generate_fn,
    make_train_step,
)
from chainermn_tpu_torch.parallel import fsdp, sharded_state

from test_torch_world import run_world

N, VOCAB, B, T, LR, STEPS = 4, 64, 8, 16, 1e-2, 3
LOSS_TOL, PARAM_TOL = 1e-5, 2e-5

TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=4, d_head=8, d_ff=64,
            n_layers=2, max_seq=T, attention="local", dtype="float32",
            remat=False)
# name: (mesh axes, config fields), held against the JAX package
CASES = {
    "data4": (dict(data=4), {}),
    "data2_seq2_ring": (dict(data=2, seq=2), dict(attention="ring")),
    "data2_model2": (dict(data=2, model=2), {}),
    "data2_expert2_moe": (dict(data=2, expert=2),
                          dict(moe=True, n_experts=4)),
    "data2_pipe2_gpipe": (dict(data=2, pipe=2),
                          dict(n_layers=4, num_microbatches=2)),
    "data2_pipe2_1f1b": (dict(data=2, pipe=2),
                         dict(n_layers=4, num_microbatches=2,
                              pipeline_schedule="1f1b")),
    "data2_pipe2_interleaved": (dict(data=2, pipe=2),
                                dict(n_layers=8, num_microbatches=2,
                                     pipeline_schedule="interleaved",
                                     virtual_pipe=2)),
}
# the port alone: the kernels' path (flash) under full and "dots" remat,
# whose recompute gathers again
PORT_CASES = {
    "data4_flash_remat": (dict(data=4), dict(attention="flash",
                                             remat=True)),
    "data4_flash_dots": (dict(data=4), dict(attention="flash", remat=True,
                                            remat_policy="dots")),
}
# gathers a rank over the 3 steps: a sharded leaf (wqkv, wo, w1, w2) a
# layer a step, twice under remat (the recompute)
GATHERS = {"data4": STEPS * 2 * 4, "data4_flash_remat": 2 * STEPS * 2 * 4,
           "data4_flash_dots": 2 * STEPS * 2 * 4}

EXAMPLE_ARGV = ["--device", "cpu", "--mesh", "data=4", "--steps", "3"]
RESUME_ARGV = ["--device", "cpu", "--mesh", "data=4", "--steps", "5"]


def tree_of(case):
    cfg = TransformerConfig(**dict(TINY, **case[1]))
    return init_numpy_params(cfg, seed=0, pipe_size=case[0].get("pipe", 1))


def batch():
    toks = np.random.RandomState(0).randint(0, VOCAB, (B, T + 1)) \
        .astype(np.int32)
    return toks[:, :T], toks[:, 1:]


def mlp_params():
    r = np.random.RandomState(0)
    return {"w1": (r.randn(16, 64) * 0.25).astype(np.float32),
            "b1": np.zeros((64,), np.float32),
            "w2": (r.randn(64, 4) * 0.125).astype(np.float32)}


def mlp_data():
    r = np.random.RandomState(1)
    return r.randn(32, 16).astype(np.float32), \
        r.randn(32, 4).astype(np.float32)


def stream_params():
    r = np.random.RandomState(2)
    return {"l0": {"w": (r.randn(16, 64) * 0.25).astype(np.float32),
                   "b": (r.randn(64) * 0.1).astype(np.float32)},
            "l1": {"w": (r.randn(64, 8) * 0.125).astype(np.float32),
                   "b": (r.randn(8) * 0.1).astype(np.float32)}}


def stream_x():
    return np.random.RandomState(3).randn(32, 16).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    xs, ys = batch()
    mx, my = mlp_data()
    cases = {**CASES, **PORT_CASES}
    payload = dict(
        x=xs, y=ys, lr=LR, steps=STEPS,
        cases={n: (c[0], dict(TINY, **c[1])) for n, c in cases.items()},
        tree={n: tree_of(c) for n, c in cases.items()},
        mlp=mlp_params(), mlp_x=mx, mlp_y=my, mlp_steps=4,
        stream_params=stream_params(), stream_x=stream_x(),
        example_argv=EXAMPLE_ARGV, resume_argv=RESUME_ARGV,
        example_ck=str(tmp_path_factory.mktemp("fsdp_example")))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("fsdp"), N,
                      "battery_fsdp", payload)
    jax_pool = concurrent.futures.ThreadPoolExecutor(3)
    for name in CASES:
        _JAX[name] = jax_pool.submit(_jax_train, name)
    _JAX["mlp"] = jax_pool.submit(_jax_mlp)
    yield fut
    jax_pool.shutdown(wait=True)
    pool.shutdown(wait=True)


_JAX = {}


def _jax_train(name):
    """The JAX package's ``fsdp=True`` on the case's mesh (its
    ``test_fsdp.py::_train``), from the same weights: the losses and
    the whole parameters after 3 steps."""
    axes, fields = CASES[name]
    cfg = JaxConfig(**dict(TINY, **fields, fsdp=True))
    mc = JaxMesh(devices=jax.devices()[:N], **axes)
    params = jax_shard_params(mc, cfg, tree_of(CASES[name]))
    opt = optax.adam(LR)
    state = jax_shard_opt_state(opt, params)
    step = jax_train_step(mc, cfg, opt)
    losses = []
    xs, ys = batch()
    for _ in range(STEPS):
        params, state, loss = step(params, state, xs, ys)
        losses.append(float(loss))
    return losses, jax.tree.map(lambda a: np.asarray(jax.device_get(a)),
                                params)


def _jax_mlp():
    """``test_fsdp_generic.py``'s MLP at data=4: the FSDP run and the
    replicated one (losses, final parameters)."""
    mesh = JaxMesh(devices=jax.devices()[:N], data=N).mesh
    x, y = mlp_data()
    runs = {}
    for use in (True, False):
        params = {k: jnp.asarray(v) for k, v in mlp_params().items()}
        dims = jfsdp.fsdp_dims(params, N) if use else jax.tree.map(
            lambda _: None, params)
        specs = jfsdp.fsdp_specs(params, dims)
        params = jax.tree.map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
            params, specs)
        opt = optax.adam(LR)
        state = jax_shard_opt_state(opt, params)

        def loss_fn(p, xb, yb, dims=dims):
            full = jfsdp.fsdp_gather(p, dims, "data")
            h = jax.nn.relu(xb @ full["w1"] + full["b1"])
            return jnp.mean((h @ full["w2"] - yb) ** 2)

        grad_fn = jax.shard_map(
            lambda p, xb, yb, loss_fn=loss_fn: jax.value_and_grad(
                lambda q: jax.lax.pmean(loss_fn(q, xb, yb), "data"))(p),
            mesh=mesh, in_specs=(specs, P("data"), P("data")),
            out_specs=(P(), specs))

        @jax.jit
        def step(p, s, xb, yb, grad_fn=grad_fn, opt=opt):
            loss, g = grad_fn(p, xb, yb)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s, loss

        losses = []
        for _ in range(4):
            params, state, loss = step(params, state, x, y)
            losses.append(float(loss))
        runs[use] = (losses, jax.tree.map(np.asarray, params))
    return runs


def results(world):
    return world.result()


# --------------------------------------------------------------------- #
# parallel/fsdp.py
# --------------------------------------------------------------------- #


def test_fsdp_dims_selection_matches_jax():
    shapes = {"w1": (16, 64), "w2": (64, 16), "b": (7,), "tiny": (8,),
              "scalar": ()}
    mine = fsdp.fsdp_dims({k: torch.zeros(s) for k, s in shapes.items()}, 8)
    want = jfsdp.fsdp_dims({k: jnp.zeros(s) for k, s in shapes.items()}, 8)
    assert mine == want == {"w1": 1, "w2": 0, "b": None, "tiny": None,
                            "scalar": None}


def test_fsdp_dims_skip_claimed_dims_and_collide():
    # a dim another axis claims (the JAX specs' entry) is skipped; a cut
    # on it raises with the JAX message
    mine = fsdp.fsdp_dims({"w": torch.zeros(64, 64), "v": torch.zeros(64,
                                                                      64)},
                          8, taken={"w": 0, "v": None})
    want = jfsdp.fsdp_dims({"w": jnp.zeros((64, 64)),
                            "v": jnp.zeros((64, 64))}, 8,
                           specs={"w": P("model", None), "v": P()})
    assert mine == want == {"w": 1, "v": 0}
    with pytest.raises(ValueError, match="already sharded"):
        fsdp.fsdp_shard({"w": torch.zeros(64, 64)}, {"w": 0}, 0, 8,
                        taken={"w": 0})
    cut = fsdp.fsdp_shard({"w": torch.arange(64.).reshape(8, 8)},
                          {"w": 1}, 3, 4)
    np.testing.assert_array_equal(cut["w"].numpy(),
                                  np.arange(64.).reshape(8, 8)[:, 6:8])


def test_fsdp_gather_wire_non_float_and_empty():
    # over one member: the leaf itself, or its bf16 rounding with the
    # gradient bf16-rounded too; an int leaf exempt; an empty leaf zeros
    loop = LoopbackCommunicator(device="cpu")
    w = (torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
         .requires_grad_())
    ids = torch.arange(6, dtype=torch.int32)
    out = fsdp.fsdp_gather({"w": w, "ids": ids, "e": torch.zeros(0, 3)},
                           {"w": 1, "ids": 0, "e": 0}, loop,
                           wire_dtype=torch.bfloat16)
    assert out["w"].dtype == torch.float32
    assert torch.equal(out["w"], w.detach().to(torch.bfloat16).float())
    assert out["ids"] is ids and out["e"].shape == (0, 3)
    g = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    (out["w"] * g).sum().backward()
    assert torch.equal(w.grad, g.to(torch.bfloat16).float())
    plain = fsdp.fsdp_gather({"w": w}, {"w": 1}, loop)
    assert plain["w"] is w
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        fsdp.fsdp_gather({"w": w}, {"w": 1}, loop, plan=object())


def test_fsdp_mlp_matches_jax_and_replicated(world):
    runs = _JAX["mlp"].result()
    losses_f, final_f = runs[True]
    losses_d, final_d = runs[False]
    for res in results(world):
        got = res["mlp"]
        np.testing.assert_allclose(got["losses"], losses_f, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(got["losses"], losses_d, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        for k in final_f:
            np.testing.assert_allclose(got["whole"][k], final_f[k],
                                       rtol=PARAM_TOL, atol=PARAM_TOL)
            np.testing.assert_allclose(got["whole"][k], final_d[k],
                                       rtol=PARAM_TOL, atol=PARAM_TOL)
        # at rest and in the moments: 1/4 of every leaf's chosen dim
        assert got["dims"] == {"w1": 1, "b1": 0, "w2": 0}
        assert got["local"] == {"w1": (16, 16), "b1": (16,), "w2": (16, 4)}
        assert got["mu"] == [(16, 16), (16,), (16, 4)]
        # the bf16 wire trains
        assert res["mlp_bf16"][-1] < res["mlp_bf16"][0]


# --------------------------------------------------------------------- #
# parallel/sharded_state.py: the layer stream and the ZeRO-3 table
# --------------------------------------------------------------------- #


def _oracle(params, x):
    h = np.maximum(x @ params["l0"]["w"] + params["l0"]["b"], 0)
    return h @ params["l1"]["w"] + params["l1"]["b"]


def test_layer_stream_forward_matches_the_oracles(world):
    params = stream_params()
    x = stream_x()
    jax_oracle = np.asarray(jax.jit(
        lambda p, xb: jax.nn.relu(xb @ p["l0"]["w"] + p["l0"]["b"])
        @ p["l1"]["w"] + p["l1"]["b"])(params, x))
    t = {k: {n: torch.tensor(v) for n, v in layer.items()}
         for k, layer in params.items()}
    xt = torch.tensor(x)
    plain = (torch.relu(xt @ t["l0"]["w"] + t["l0"]["b"]) @ t["l1"]["w"]
             + t["l1"]["b"]).numpy()
    for res in results(world):
        rows = slice(res["rank"] * 8, (res["rank"] + 1) * 8)
        for window in (1, 2):
            got = res["stream"][window]["out"]
            np.testing.assert_array_equal(got, plain[rows])
            np.testing.assert_allclose(got, jax_oracle[rows], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got, _oracle(params, x)[rows],
                                       rtol=1e-5, atol=1e-5)


def test_layer_stream_window_bounds_and_names(world):
    for res in results(world):
        one, two = res["stream"][1], res["stream"][2]
        assert one["names"] == two["names"] == ["l0", "l1"]
        assert one["live"] == [1, 1] and one["issued"] == [0, 1]
        # layer 1 prefetched with layer 0, then layer 0 retired
        assert two["live"] == [2, 1] and two["issued"] == [0, 1]
    stream = sharded_state.LayerGatherStream(
        {"a": {"w": torch.zeros(2)}}, {"a": {"w": None}},
        comm=LoopbackCommunicator(device="cpu"), window=0)
    assert stream.window == 1 and len(stream) == 1
    with pytest.raises(IndexError):
        stream.layer(1)


def test_sharded_state_table_and_bytes_match_jax():
    from chainermn_tpu.parallel import sharded_state as jss

    params = {k: {n: np.asarray(v) for n, v in sorted(layer.items())}
              for k, layer in stream_params().items()}
    dims = {"l0": {"b": 0, "w": 1}, "l1": {"b": None, "w": 0}}
    state = {"count": np.zeros((), np.int32), "mu": params, "nu": params}
    mine = sharded_state.state_layout_table("zero3", params, state,
                                            world=8, dims=dims, axis="data")
    want = jss.state_layout_table("zero3", params, state, world=8,
                                  dims=dims, axis="data")
    for part in ("params", "opt_state"):
        assert sharded_state.layout_records(mine[part]) == \
            jss.layout_records(want[part])
        assert [(m.path, m.kind, m.dim) for m in mine[part]] == \
            [(w.path, w.kind, w.dim) for w in want[part]]
    loop = LoopbackCommunicator(device="cpu")
    t = {k: {n: torch.tensor(v) for n, v in layer.items()}
         for k, layer in stream_params().items()}
    ss = sharded_state.ShardedState(t, loop)
    ss.place(t)
    from chainermn_tpu_torch import training

    ss.init_opt_state(training.adamw(1e-2))
    table = ss.layouts()
    # one member: the whole tree, every moment mirroring its parameter
    assert ss.local_bytes() == sum(v.nbytes for layer in stream_params()
                                   .values() for v in layer.values()) * 3 \
        + 4
    assert [m.kind for m in table["opt_state"]][0] == "rep"
    assert [tuple(t.shape) for layer in ss.local_template().values()
            for t in layer.values()] == [(16, 64), (64,), (64, 8), (8,)]
    for what in ("payload_descs", "auto_window", "register_memory"):
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            getattr(ss, what)(*([1.0] if what == "auto_window" else []))
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        ss.tune_gather_plan(loop)


# --------------------------------------------------------------------- #
# the flagship under fsdp
# --------------------------------------------------------------------- #


def step_of(res, name, fsdp=True):
    return res["step"][(name, fsdp)]


@pytest.mark.parametrize("name", list(CASES))
def test_flagship_fsdp_matches_jax(world, name):
    losses, params = _JAX[name].result()
    for res in results(world):
        got = step_of(res, name)
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        # jax.tree.leaves sorts both dicts' keys alike; each leaf within
        # 2e-5 relative L2 (adam's first steps move a few elements whose
        # gradient is near zero by up to 1e-4 on the packages' rounding;
        # the port's run without FSDP is as far from JAX's)
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(params)):
            assert np.linalg.norm(a - b) <= PARAM_TOL * np.linalg.norm(b)


@pytest.mark.parametrize("name", list(CASES) + list(PORT_CASES))
def test_flagship_fsdp_matches_dense(world, name):
    for res in results(world):
        got, dense = step_of(res, name), step_of(res, name, False)
        # the first step's forward runs on the gathered fp32 weights: the
        # dense step's loss
        assert got["losses"][0] == dense["losses"][0]
        np.testing.assert_allclose(got["losses"], dense["losses"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        for a, b in zip(torch.utils._pytree.tree_leaves(got["params"]),
                        torch.utils._pytree.tree_leaves(dense["params"])):
            np.testing.assert_allclose(a, b, rtol=PARAM_TOL, atol=PARAM_TOL)


@pytest.mark.parametrize("name", list(CASES) + list(PORT_CASES))
def test_flagship_shard_width_and_matched_gathers(world, name):
    axes, fields = {**CASES, **PORT_CASES}[name]
    D = axes["data"]
    cfg = TransformerConfig(**dict(TINY, **fields, fsdp=True))
    from chainermn_tpu_torch.models.transformer import _shard_dims

    dims = _shard_dims(cfg, "data")["blocks"]
    counts = {res["rank"]: step_of(res, name)["gathers"]
              for res in results(world)}
    # every rank issues the same gathers (a mismatch hangs the world):
    # the members of a data group share every other coordinate
    assert len(set(counts.values())) == 1, counts
    assert counts[0] > 0 and counts[0] == GATHERS.get(name, counts[0])
    for res in results(world):
        got, dense = step_of(res, name), step_of(res, name, False)
        for k, shape in got["shapes"].items():
            want = list(dense["shapes"][k])
            if k in dims:
                want[dims[k]] //= D
            assert shape == tuple(want), (k, shape, want)
            # the moments stay at the parameters' width
            assert got["mu"][k] == shape
        # the leaves replicated over data are the same bits on each
        assert got["data_bitwise"] and dense["data_bitwise"]


def test_fsdp_bf16_wire_trains(world):
    for res in results(world):
        fp32 = step_of(res, "data4")["losses"]
        assert res["bf16"][-1] < res["bf16"][0]
        np.testing.assert_allclose(res["bf16"], fp32, rtol=0.05, atol=0.05)


def test_reshard_fsdp_on_and_off_give_the_next_loss(world):
    for res in results(world):
        got = res["reshard"]
        for src in (True, False):
            # the same saved state laid out with FSDP on and off
            assert abs(got[(src, True)]["loss"]
                       - got[(src, False)]["loss"]) < 1e-6
            assert got[(src, True)]["w1"] == (2, 8, 64)
            assert got[(src, True)]["mu"] == (2, 8, 64)
            assert got[(src, False)]["w1"] == (2, 32, 64)
        # either run's state gives the same next loss
        assert abs(got[(True, True)]["loss"]
                   - got[(False, False)]["loss"]) < 1e-5


def test_train_lm_torch_fsdp_resumes_on_and_off(world):
    for res in results(world):
        got = res["example"]
        assert got["start"] == (3, 3) and len(got["first"]) == 3
        np.testing.assert_allclose(got["on"], got["off"], rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    assert len({tuple(r["example"]["on"]) for r in results(world)}) == 1


def test_fsdp_decode_raises_the_jax_message():
    cfg = TransformerConfig(**dict(TINY, fsdp=True))
    with pytest.raises(ValueError, match="fsdp is a training-path layout "
                       r"\(per-layer just-in-time weight gathers"):
        make_generate_fn(cfg, max_len=T, device="cpu")


def test_fsdp_dmodel_divisibility_and_wire_need_fsdp():
    cfg = TransformerConfig(**dict(TINY, fsdp=True, d_model=36))
    from chainermn_tpu_torch.models.transformer import _check_mesh

    with pytest.raises(ValueError, match="divisible by the data"):
        _check_mesh({"data": 8}, cfg)
    with pytest.raises(ValueError, match="fsdp=False"):
        TransformerConfig(**dict(TINY, fsdp_wire_dtype="bfloat16"))
    # scoring under fsdp on one member is the dense forward's bits
    cfg = TransformerConfig(**dict(TINY, fsdp=True))
    dense = TransformerConfig(**TINY)
    from chainermn_tpu_torch.models import params_from_jax

    params = params_from_jax(init_numpy_params(cfg, 0), cfg, "cpu")
    xs, _ = batch()
    assert torch.equal(make_forward_fn(cfg, device="cpu")(params, xs),
                       make_forward_fn(dense, device="cpu")(params, xs))
    assert make_train_step(cfg, None, device="cpu") is not None

