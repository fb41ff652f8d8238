"""ZeRO-1 and ZeRO-2 in the port against the JAX package's, and the
sharded-state layer's ZeRO records (the counterparts of
``tests/optimizer_tests/test_zero1.py``, ``test_zero2.py``,
``test_zero1_updater.py`` and the ZeRO half of
``tests/parallel_tests/test_sharded_state.py``).

The port's cases run in one 4-rank gloo world (``battery_zero`` in
``test_torch_world.py``), started in a thread while the JAX side, on 4
of the conftest's 8 virtual CPU devices, computes.  The same per-rank
gradients (odd leaf sizes, so the padding lanes are exercised) go
through ``create_multi_node_optimizer`` in both packages for 3 steps.
Tolerances: fp32 parameters to 1e-6 absolute and 1e-5 relative against
the JAX package's and the port's replicated exchange (the packages and
the exchanges sum the ranks in other orders); ZeRO-2 against ZeRO-1,
at any ``bucket_bytes``, bitwise; the bf16 wire's exchange within 2
bf16 ulps of the largest share's magnitude of the exact mean, its
3-step update within 1e-2 relative L2 of the fp32 one; a resumed
ZeRO-1 trainer bitwise the straight one.
"""

import concurrent.futures
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from chainermn_tpu import create_multi_node_optimizer as jax_mno
from chainermn_tpu.parallel import sharded_state as jss
from chainermn_tpu.training.elastic import _zero1_leaf_layout as jax_z1_layout
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.parallel import sharded_state as ss
from chainermn_tpu_torch.training import elastic
from chainermn_tpu_torch.training import optimizers as topt

from test_torch_world import run_world

N, STEPS, AX = 4, 3, "world"
ATOL, RTOL = 1e-6, 1e-5
WIRE_ULPS = 2.0
WIRE_REL_L2 = 1e-2


def _params():
    # odd sizes on purpose: 15 and 7 elements do not divide over 4 ranks
    r = np.random.RandomState(0)
    return {"w": r.randn(5, 3).astype(np.float32),
            "b": r.randn(7).astype(np.float32),
            "s": np.asarray(r.randn(), np.float32)}


def _grads():
    r = np.random.RandomState(1)
    return [{k: np.asarray(r.randn(*v.shape), np.float32)
             for k, v in _params().items()} for _ in range(N)]


# name: (inner, create_multi_node_optimizer's keywords)
RUNS = {
    "rep_sgd": dict(inner="sgd"),
    "z1_sgd": dict(inner="sgd", zero1=True),
    "z2_sgd": dict(inner="sgd", zero2=True),
    "rep_adam": dict(inner="adam"),
    "z1_adam": dict(inner="adam", zero1=True),
    "z2_adam": dict(inner="adam", zero2=True),
    "z2_bucket8_adam": dict(inner="adam", zero2=True, bucket_bytes=8),
    "z1_bf16_adam": dict(inner="adam", zero1=True,
                         allreduce_grad_dtype=torch.bfloat16),
    "rep_db_accum_sgd": dict(inner="sgd", double_buffering=True,
                             accum_steps=2),
    "z1_db_accum_sgd": dict(inner="sgd", zero1=True, double_buffering=True,
                            accum_steps=2),
    "z2_db_accum_sgd": dict(inner="sgd", zero2=True, double_buffering=True,
                            accum_steps=2),
}
# the updater: sharding mode, fused windows, the overlap hooks
UPDATER = {
    "rep": dict(inner="sgd", steps_per_execution=2),
    "z1": dict(inner="sgd", zero1=True, steps_per_execution=2),
    "z2": dict(inner="sgd", zero2=True, steps_per_execution=2),
    "z1_accum": dict(inner="adam", zero1=True, accum_steps=2),
    "z1_accum_overlap": dict(inner="adam", zero1=True, accum_steps=2,
                             overlap=True),
    "z2_accum_overlap": dict(inner="adam", zero2=True, accum_steps=2,
                             overlap=True),
}


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    payload = dict(params=_params(), grads=_grads(), steps=STEPS,
                   runs=RUNS, updater=UPDATER,
                   root=str(tmp_path_factory.mktemp("zero_ckpt")))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("zero"), N,
                      "battery_zero", payload)
    for name in ("rep_sgd", "z1_sgd", "z2_sgd", "rep_adam", "z1_adam",
                 "z1_bf16_adam", "z1_db_accum_sgd"):
        _JAX[name] = _jax_run(name)
    yield fut
    pool.shutdown(wait=True)


_JAX = {}


def _jax_inner(name):
    return {"sgd": optax.sgd(0.1, momentum=0.9),
            "adam": optax.adam(1e-2)}[name]


def _jax_run(name):
    """The JAX ``create_multi_node_optimizer`` of case ``name`` over a
    4-device axis, 3 steps on the per-rank gradients: the world-stacked
    parameters and the optimizer state (world-stacked under ZeRO)."""
    kw = dict(RUNS[name])
    inner = _jax_inner(kw.pop("inner"))
    if "allreduce_grad_dtype" in kw:
        kw["allreduce_grad_dtype"] = jnp.bfloat16
    opt = jax_mno(inner, axis_name=AX, **kw)
    mesh = Mesh(np.array(jax.devices()[:N]), (AX,))
    grads = {k: np.stack([g[k] for g in _grads()]) for k in _params()}

    def body(params, g):
        g = jax.tree.map(lambda x: x[0], g)
        state = opt.init(params)
        for _ in range(STEPS):
            updates, state = opt.update(g, state, params)
            params = optax.apply_updates(params, updates)
        return (jax.tree.map(lambda p: p[None], params),
                jax.tree.map(lambda x: jnp.asarray(x)[None], state))

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P(AX)),
                              out_specs=P(AX), check_vma=False))
    params, state = f(_params(), grads)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray,
                                                           state))


def run(world, name, rank=0):
    return world.result()[rank]["runs"][name]


@pytest.mark.parametrize("name", ["z1_sgd", "z2_sgd", "z1_adam",
                                  "z1_db_accum_sgd"])
def test_zero_matches_jax_and_replicated(world, name):
    jax_params, _ = _JAX[name]
    rep = "rep_db_accum_sgd" if "db" in name else \
        "rep_" + name.split("_")[-1]
    for res in world.result():
        got = res["runs"][name]["params"]
        for k in got:
            np.testing.assert_allclose(got[k], jax_params[k][res["rank"]],
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got[k], res["runs"][rep]["params"][k],
                                       rtol=RTOL, atol=ATOL)
            # the parameters stay replicated
            np.testing.assert_array_equal(got[k],
                                          run(world, name)["params"][k])


def test_replicated_matches_jax(world):
    for name in ("rep_sgd", "rep_adam"):
        jax_params, _ = _JAX[name]
        for res in world.result():
            for k, v in res["runs"][name]["params"].items():
                np.testing.assert_allclose(v, jax_params[k][0], rtol=RTOL,
                                           atol=ATOL)


@pytest.mark.parametrize("name", ["z1_adam", "z2_adam"])
def test_state_is_shard_width_and_jax_row(world, name):
    # rank r's moments are the JAX world-stacked state's row r
    _, jax_state = _JAX["z1_adam"]
    adam = jax_state[0]
    for res in world.result():
        state = res["runs"][name]["state"]["state"]
        for i, k in enumerate(_params()):
            n = _params()[k].size
            assert state[i]["mu"].shape == (-(-n // N),)
            np.testing.assert_allclose(state[i]["mu"],
                                       adam.mu[k][res["rank"]], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(state[i]["nu"],
                                       adam.nu[k][res["rank"]], rtol=RTOL,
                                       atol=ATOL)
            assert int(state[i]["count"]) == STEPS


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_zero2_is_zero1_bitwise(world, inner):
    for res in world.result():
        for k in _params():
            np.testing.assert_array_equal(
                res["runs"][f"z2_{inner}"]["params"][k],
                res["runs"][f"z1_{inner}"]["params"][k])


def test_bucket_bytes_changes_no_bit(world):
    for res in world.result():
        for k in _params():
            np.testing.assert_array_equal(
                res["runs"]["z2_bucket8_adam"]["params"][k],
                res["runs"]["z2_adam"]["params"][k])
        for a, b in zip(res["runs"]["z2_bucket8_adam"]["state"]["state"],
                        res["runs"]["z1_adam"]["state"]["state"]):
            for key in ("mu", "nu"):
                np.testing.assert_array_equal(a[key], b[key])


def test_double_buffering_and_accumulation(world):
    # inside ZeRO, at shard width: ZeRO-2 is ZeRO-1's bits, both the
    # replicated stack's numbers (JAX above)
    for res in world.result():
        for k in _params():
            np.testing.assert_array_equal(
                res["runs"]["z2_db_accum_sgd"]["params"][k],
                res["runs"]["z1_db_accum_sgd"]["params"][k])
        tree = res["runs"]["z1_db_accum_sgd"]["state"]
        sizes = [-(-v.size // N) for v in _params().values()]
        assert [a.shape for a in tree["accum"]["acc"]] == \
            [(s,) for s in sizes]
        assert [a.shape for a in tree["prev_grads"]] == [(s,) for s in sizes]


def test_bf16_wire_holds_its_bound(world):
    # the exchange alone against the exact mean, on rank 0's shards
    comm = LoopbackCommunicator(device="cpu")
    grads = _grads()
    for mode in (training.Zero1Transformation,
                 training.Zero2Transformation):
        opt = mode(comm, training.sgd(0.1), torch.bfloat16)
        for k in _params():
            shares = np.stack([g[k].reshape(-1) for g in grads])
            # the rank-ordered sum of the four bf16 shares, as each rank
            # reduces its shard
            bf = torch.tensor(shares).to(torch.bfloat16)
            got = bf[0].clone()
            for j in range(1, N):
                got += bf[j]
            got = (got / N).float().numpy()
            exact = shares.astype(np.float64).mean(0)
            m = np.abs(shares).max(0)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(m, 1e-30))) - 7)
            assert (np.abs(got - exact) <= WIRE_ULPS * ulp).all(), k
            single = opt._scatter([torch.tensor(grads[0][k])])[0]
            assert single.dtype == torch.float32
    for res in world.result():
        fp32 = res["runs"]["z1_adam"]["params"]
        bf16 = res["runs"]["z1_bf16_adam"]["params"]
        d_f = np.concatenate([(fp32[k] - _params()[k]).ravel()
                              for k in fp32])
        d_b = np.concatenate([(bf16[k] - _params()[k]).ravel()
                              for k in fp32])
        assert np.linalg.norm(d_b - d_f) / np.linalg.norm(d_f) \
            < WIRE_REL_L2
        jax_bf16, _ = _JAX["z1_bf16_adam"]
        d_j = np.concatenate([(jax_bf16[k][res["rank"]]
                               - _params()[k]).ravel() for k in fp32])
        assert np.linalg.norm(d_b - d_j) / np.linalg.norm(d_j) \
            < WIRE_REL_L2


def test_factory_exclusions_and_plan_warning():
    loop = LoopbackCommunicator(device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        training.create_multi_node_optimizer(training.sgd(0.1), loop,
                                             zero1=True, zero2=True)
    topt._ZERO1_PLAN_WARNED = False
    with pytest.warns(RuntimeWarning, match="plan= is ignored"):
        opt = training.create_multi_node_optimizer(
            training.sgd(0.1), loop, zero1=True, plan="auto")
    assert isinstance(opt, training.Zero1Transformation)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # once a process
        training.create_multi_node_optimizer(training.sgd(0.1), loop,
                                             zero2=True, plan="auto")
    # overlap="auto" under ZeRO marks the overlap, as in the JAX package
    assert training.create_multi_node_optimizer(
        training.sgd(0.1), loop, zero1=True, overlap="auto").overlap
    with pytest.raises(TypeError, match="ZeRO optimizer"):
        training.zero1_init(training.sgd(0.1), {})


def test_zero_types_and_init_on_one_rank():
    loop = LoopbackCommunicator(device="cpu")
    params = {k: torch.tensor(v) for k, v in _params().items()}
    for zero1, zero2, cls in ((True, False, training.Zero1Transformation),
                              (False, True, training.Zero2Transformation)):
        opt = training.create_multi_node_optimizer(
            training.adamw(1e-2), loop, zero1=zero1, zero2=zero2)
        assert type(opt) is cls
        state = training.zero1_init(opt, params)
        shapes = [st["mu"].shape for st in
                  training.optimizer_state_tree(state)["state"]]
        assert shapes == [(v.size,) for v in _params().values()]
    moments = training.shard_opt_state(training.adamw(1e-2), params)
    assert moments.state[params["w"]]["mu"].shape == (5, 3)


@pytest.mark.parametrize("mode", ["z1", "z2"])
def test_updater_detects_the_mode_and_trains(world, mode):
    for res in world.result():
        got = res["updater"][mode]
        assert got["status"]["sharding"] == ("zero1" if mode == "z1"
                                             else "zero2")
        assert got["status"]["zero1"] is True
        rep = res["updater"]["rep"]
        assert rep["status"]["sharding"] is None \
            and rep["status"]["zero1"] is False
        np.testing.assert_allclose(got["losses"], rep["losses"], rtol=RTOL)
        for k in got["params"]:
            np.testing.assert_allclose(got["params"][k], rep["params"][k],
                                       rtol=RTOL, atol=ATOL)


def test_updater_overlap_hooks_feed_the_scatters(world):
    # the reduce-scatters fed from the last microbatch's gradient hooks:
    # each leaf's sum is the window-end exchange's, bit for bit
    for res in world.result():
        base = res["updater"]["z1_accum"]
        for name in ("z1_accum_overlap", "z2_accum_overlap"):
            got = res["updater"][name]
            assert got["losses"] == base["losses"]
            for k in got["params"]:
                np.testing.assert_array_equal(got["params"][k],
                                              base["params"][k])


def test_zero1_checkpoint_resumes_bitwise(world):
    for res in world.result():
        got = res["resume"]
        assert got["at"] == 12
        for k in got["straight"]:
            np.testing.assert_array_equal(got["again"][k],
                                          got["straight"][k])
        for a, b in zip(torch.utils._pytree.tree_leaves(got["again_state"]),
                        torch.utils._pytree.tree_leaves(
                            got["straight_state"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_zero1_checkpoint_under_another_mode_raises(world):
    for res in world.result():
        msg = res["resume"]["other_mode"]
        assert msg is not None and "'zero1'" in msg and "'zero2'" in msg


# --------------------------------------------------------------------- #
# the signature and the sharded-state layer's ZeRO records
# --------------------------------------------------------------------- #


def _stacked_adam_tree(world=8):
    """An adam carry, world-stacked, as a sorted-key dict tree both
    packages flatten alike; and its parameters."""
    params = {"b": np.zeros((7,), np.float32),
              "w": np.zeros((5, 3), np.float32)}
    state = {"count": np.zeros((world,), np.int32),
             "mu": {k: np.zeros((world, -(-v.size // world)), np.float32)
                    for k, v in params.items()},
             "nu": {k: np.zeros((world, -(-v.size // world)), np.float32)
                    for k, v in params.items()}}
    return params, state


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_zero_layout_table_is_jax_json(mode):
    params, state = _stacked_adam_tree()
    mine = ss.state_layout_table(mode, params, state, world=8, axis=AX)
    want = jss.state_layout_table(mode, params, state, world=8, axis=AX)
    for part in ("params", "opt_state"):
        assert ss.layout_records(mine[part]) == \
            jss.layout_records(want[part])
        assert [(m.path, m.kind, m.shape, m.dtype, m.size) for m in
                mine[part]] == [(w.path, w.kind, w.shape, w.dtype, w.size)
                                for w in want[part]]
    assert ss.layout_records(mine["opt_state"]) == [
        {"kind": "stack"}, {"kind": "shard", "size": 7},
        {"kind": "shard", "size": 15}, {"kind": "shard", "size": 7},
        {"kind": "shard", "size": 15}]
    assert elastic._zero1_leaf_layout(state, params, 8) == \
        jax_z1_layout(state, params, 8)


def test_leaf_layout_records_geometry_and_validation():
    shard = ss.LeafLayout(("mu", "w"), "shard", (8, 2), "float32", 8,
                          size=15)
    fsdp = ss.LeafLayout(("w",), "fsdp", (16, 64), "float32", 8, dim=1)
    for mine, kw in ((shard, dict(size=15)), (fsdp, dict(dim=1))):
        want = jss.LeafLayout(mine.path, mine.kind, mine.shape, mine.dtype,
                              8, **kw)
        assert mine.to_record() == want.to_record()
        assert mine.local_shape() == want.local_shape()
        assert mine.local_shape(4) == want.local_shape(4)
        assert mine.local_bytes() == want.local_bytes()
        assert mine.global_bytes() == want.global_bytes()
    back = ss.LeafLayout.from_record(fsdp.to_record(), path=("w",),
                                     shape=(16, 64), world=8)
    assert back.kind == "fsdp" and back.dim == 1
    assert ss.LeafLayout(("c",), "stack", (8,), "int32", 8
                         ).to_record() == {"kind": "stack"}
    assert ss.LeafLayout(("x",), "rep", (3,), "bfloat16", 8
                         ).local_bytes() == 6
    with pytest.raises(ValueError, match="not divisible"):
        fsdp.local_shape(world=5)
    with pytest.raises(ValueError, match="unknown layout kind"):
        ss.LeafLayout((), "bogus", (), "float32", 8)
    with pytest.raises(ValueError, match="size="):
        ss.LeafLayout(("x",), "shard", (8, 2), "float32", 8)
    with pytest.raises(ValueError, match="dim="):
        ss.LeafLayout(("x",), "fsdp", (16, 64), "float32", 8)
    with pytest.raises(ValueError, match="unknown sharding mode"):
        ss.state_layout_table("zero4", {}, world=8)
    with pytest.raises(ValueError, match="dims"):
        ss.state_layout_table("zero3", {"w": np.zeros((8, 8))}, world=8)


def test_gather_shard_leaves_round_trip_and_jax():
    layouts = [{"kind": "shard", "size": 15}, {"kind": "stack"},
               {"kind": "rep"}]
    tree = {"a": np.arange(16, dtype=np.float32).reshape(8, 2),
            "b": np.tile(np.arange(3.0), (8, 1)),
            "c": np.float32(7.0)}
    tree["a"][-1, -1] = 0      # the pad lane
    full = ss.gather_state_leaves(tree, layouts)
    want = jss.gather_state_leaves(tree, layouts)
    for k in tree:
        np.testing.assert_array_equal(full[k], want[k])
    assert full["a"].shape == (15,)
    back = ss.shard_state_leaves(full, layouts, 8)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    with pytest.raises(elastic.RelayoutError, match=r"\['mu'\]\['w'\]"):
        ss.gather_state_leaves({"mu": {"w": np.zeros((8, 2))}},
                               [{"kind": "mystery"}])
    with pytest.raises(elastic.RelayoutError, match="mystery"):
        ss.shard_state_leaves({"mu": {"w": np.zeros((8, 2))}},
                              [{"kind": "mystery"}], 8)
    # the deprecated shims delegate, warning once a process
    elastic._ZERO1_LEAVES_WARNED = False
    with pytest.warns(DeprecationWarning, match="deprecated"):
        again = elastic.gather_zero1_leaves(tree, layouts)
    np.testing.assert_array_equal(again["a"], full["a"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        elastic.shard_zero1_leaves(full, layouts, 8)


def test_signature_sharding_and_same_topology(world):
    loop = LoopbackCommunicator(device="cpu")
    base = elastic.topology_signature(loop)
    z1 = elastic.topology_signature(loop, zero1=True)
    z2 = elastic.topology_signature(loop, sharding="zero2")
    assert "sharding" not in base and z1["sharding"] == "zero1"
    assert z2["zero1"] is True and z2["sharding"] == "zero2"
    assert not elastic.same_topology(z1, z2)
    assert not elastic.same_topology(base, z1)
    # an old ZeRO-1 stamp without the key matches a new one
    assert elastic.same_topology(dict(z1, sharding=None), z1)
    # a rank's ZeRO state: one shard record a moment, its parameter's
    # size, as the JAX world-stacked carry records them
    _, jax_state = _JAX["z1_adam"]
    jax_recs = jax_z1_layout(jax_state, _params(), N)
    for res in world.result():
        sig = res["runs"]["z1_adam"]["signature"]
        assert sig["sharding"] == "zero1" and sig["world_size"] == N
        shards = sorted(r["size"] for r in sig["opt_leaves"]
                        if r["kind"] == "shard")
        assert shards == sorted(r["size"] for r in jax_recs
                                if r["kind"] == "shard")
        assert "opt_leaves" not in res["runs"]["rep_adam"]["signature"]
