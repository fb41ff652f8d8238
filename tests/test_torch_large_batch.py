"""ChainerMN's large-batch recipe in the port against the JAX package:
the exchange's other forms, the multi-node optimizer's accumulation and
double buffering, the copies of optax's rules and schedules, and the
updater's accumulation and windows.

In this process: the schedules and rules against optax, the overlap
schedule and the window contract against the JAX package's, and the
port's own properties (prefetch, triggers, resume) on a loopback
communicator.  In one 4-process gloo world
(``test_torch_world.battery_large_batch``, once for the module): the
exchange's forms, the optimizer stack and the updater, each against the
JAX package on 4 devices of the 8-device virtual CPU mesh, fed the same
global batches (each rank its quarter of the rows).

Tolerances: the exchange's inputs are multiples of 1/8 below 8 in
magnitude, whose sums of four and quotients by four are exact in fp32
and bf16 in any order, so the forms are held bitwise (ints too).  The
rules and schedules against optax: 1e-6 relative (the same operations
in fp32; LAMB's norms sum in another order).  The optimizer stack and
the MLP updater: 1e-5 relative, 1e-6 absolute (gloo and XLA add the
ranks' gradients in different orders), the JAX package's own bar for
these tests.  The tiny ResNet with sync BN: 1e-4 relative L2 of the
parameters' update over the tree (53 layers of CPU convolutions in
other orders, ``test_torch_data_parallel``'s bar for a step) and 1e-3 a
leaf (see the test).  Port against port (windows against
unfused steps, prefetch against the serial feed, a resume): bitwise.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import create_communicator as jax_create_communicator
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.iterators import prefetch as jax_prefetch
from chainermn_tpu.links.batch_normalization import (
    BatchNormState as JaxBNState,
)
from chainermn_tpu.models import (
    ResNetConfig as JaxResNetConfig,
    mlp_apply as jax_mlp_apply,
    resnet_apply as jax_resnet_apply,
    softmax_cross_entropy as jax_xent,
)
from chainermn_tpu.ops import fused as jax_fused
from chainermn_tpu.training import (
    StandardUpdater as JaxUpdater,
    create_multi_node_optimizer as jax_multi_node_optimizer,
)
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.links import BatchNormState
from chainermn_tpu_torch.iterators import (
    PrefetchIterator,
    SerialIterator,
    assemble_window,
    put_window,
)
from chainermn_tpu_torch.models import (
    ResNetConfig,
    init_mlp_numpy,
    init_resnet_numpy,
    mlp_apply,
    mlp_params_from_jax,
    softmax_cross_entropy,
)
from chainermn_tpu_torch.ops import fused
from test_torch_world import run_world

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "imagenet" / "train_imagenet_large_batch_torch.py"
N = 4
BUCKET = 256
RESNET = dict(depth=50, num_classes=8, width=4, dtype="float32")

# (name, model, global batch, accum_steps, steps_per_execution, rows,
#  repeat, optimizer, lr, updates)
JOBS = [
    ("accum", "mlp", 16, 4, 1, 256, True, "sgd", 0.05, 3),
    ("big", "mlp", 64, 1, 1, 256, True, "sgd", 0.05, 3),
    ("accum_adam", "mlp", 16, 4, 1, 256, True, "adam", 0.05, 3),
    ("big_adam", "mlp", 64, 1, 1, 256, True, "adam", 0.05, 3),
    ("fused", "mlp", 16, 2, 2, 256, True, "sgd", 0.05, 2),
    ("unfused", "mlp", 32, 1, 1, 256, True, "sgd", 0.05, 4),
    ("windows", "mlp", 16, 1, 3, 96, True, "sgd", 0.05, 2),
    ("plain", "mlp", 16, 1, 1, 96, True, "sgd", 0.05, 6),
    ("flush", "mlp", 8, 4, 1, 80, False, "sgd", 0.05, 3),
    ("fused_flush", "mlp", 16, 1, 4, 40, False, "sgd", 0.05, 1),
    ("weighted", "mlp", 16, 2, 2, 56, False, "sgd", 0.0, 1),
    ("weighted_plain", "mlp", 16, 1, 1, 56, False, "sgd", 0.0, 4),
    ("resnet", "resnet", 8, 2, 2, 32, True, "momentum", 0.1, 1),
    ("resnet_unfused", "resnet", 8, 2, 1, 32, True, "momentum", 0.1, 2),
]
JOB = {j[0]: dict(zip(("name", "model", "G", "M", "spe", "n", "repeat",
                       "opt", "lr", "updates"), j)) for j in JOBS}


def _eighths(rng, *shape):
    """Multiples of 1/8 in [-8, 8]: sums of four and their quarters are
    exact in fp32 and bf16."""
    return (rng.randint(-64, 65, shape) / 8).astype(np.float32)


def _jax_leaf(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else a.dtype)


TREE_DTYPES = {"a": "float32", "b": "float32", "c": "bfloat16",
               "d": "int32", "e": "float32", "f": "float32"}
SCHEDULES = [
    (None, None),
    (None, "bfloat16"),
    (({"leaves": 2, "mode": "eager", "via": "ar"},
      {"leaves": 1, "mode": "deferred", "via": "rs"},
      {"leaves": 2, "mode": "eager", "via": "rs"}), "bfloat16"),
    (((1, "deferred", "ar"), (4, "eager", "rs")), None),
]


@pytest.fixture(scope="module")
def payload():
    rng = np.random.RandomState(11)
    mlp_params = [{k: np.asarray(v) for k, v in layer.items()}
                  for layer in init_mlp_numpy([6, 12, 3], 0)]
    resnet_params, resnet_state = init_resnet_numpy(ResNetConfig(**RESNET),
                                                    0)
    base = np.tile(np.array([[1.0, 2.0]], np.float32), (N, 1))
    scale = (np.arange(N, dtype=np.float32)[:, None] + 0.5) * 2 / N
    return dict(
        buckets={"f32": (_eighths(rng, N, 37), "float32"),
                 "bf16": (_eighths(rng, N, 64), "bfloat16"),
                 "i32": (rng.randint(-50, 50, (N, 13)).astype(np.int32),
                         "int32")},
        tree={"a": _eighths(rng, N, 5, 3), "b": _eighths(rng, N, 40),
              "c": _eighths(rng, N, 7),
              "d": rng.randint(-50, 50, (N, 4)).astype(np.int32),
              "e": np.zeros((N, 0), np.float32), "f": _eighths(rng, N, 100)},
        tree_dtypes=TREE_DTYPES, schedules=SCHEDULES, bucket=BUCKET,
        # normal shares at three scales, each leaf (N, 1000)
        rounding=[np.random.RandomState(12 + i).randn(N, 1000).astype(
            np.float32) * 10.0 ** -i for i in range(3)],
        g1=rng.randn(N, 6).astype(np.float32),
        g2=rng.randn(N, 6).astype(np.float32),
        recipe_g=base * scale, example=str(EXAMPLE),
        mlp_params=mlp_params,
        mlp_x=rng.randn(256, 6).astype(np.float32),
        mlp_y=(np.arange(256) % 3).astype(np.int32),
        resnet_cfg=RESNET, resnet_params=resnet_params,
        resnet_state=resnet_state,
        # 64 px: stage 4's BN sees 2 x 2 of each of 8 images a window
        # step, where at 16 px it sees 1 x 1 (ill-conditioned moments)
        images=rng.randn(32, 64, 64, 3).astype(np.float32),
        labels=(np.arange(32) % 8).astype(np.int32),
        jobs=list(JOB.values()))


@pytest.fixture(scope="module")
def world(tmp_path_factory, payload):
    return run_world(tmp_path_factory.mktemp("large_batch"), N,
                     "battery_large_batch", payload)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _mesh(*axes):
    devices = np.asarray(jax.devices()[:N])
    return Mesh(devices.reshape((2, 2) if len(axes) == 2 else (N,)), axes)


def _shard(fn, mesh, spec):
    return jax.jit(jax.shard_map(
        lambda *xs: jax.tree.map(lambda y: y[None],
                                 fn(*jax.tree.map(lambda x: x[0], xs))),
        mesh=mesh, in_specs=spec, out_specs=spec))


def _assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(want.dtype), want)


# --------------------------------------------------------------------- #
# optax's schedules and rules: the port's copies
# --------------------------------------------------------------------- #

SCHEDS = {
    "linear": (lambda m: m.linear_schedule(0.1, 0.4, 5, 2)),
    "cosine": (lambda m: m.cosine_decay_schedule(0.4, 7, alpha=0.1)),
    "joined": (lambda m: m.join_schedules(
        [m.linear_schedule(0.1, 0.4, 3), m.cosine_decay_schedule(0.4, 6)],
        [3])),
}


@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_schedules_match_optax(name):
    want, got = SCHEDS[name](optax), SCHEDS[name](training)
    for count in range(12):
        np.testing.assert_allclose(float(got(count)), float(want(count)),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(got(torch.tensor(count, dtype=torch.int32))),
            float(want(jnp.asarray(count, jnp.int32))), rtol=1e-6)


def _sched(m):
    return SCHEDS["joined"](m)


RULES = {
    "lars": (lambda: optax.lars(_sched(optax), weight_decay=1e-4),
             lambda: training.lars(_sched(training), weight_decay=1e-4)),
    "lamb": (lambda: optax.lamb(_sched(optax), weight_decay=1e-4),
             lambda: training.lamb(_sched(training), weight_decay=1e-4)),
    "sgd_schedule": (lambda: optax.sgd(_sched(optax), momentum=0.9),
                     lambda: training.sgd(_sched(training), momentum=0.9)),
    "adamw_mu_bf16": (
        lambda: optax.adamw(1e-2, mu_dtype=jnp.bfloat16),
        lambda: training.adamw(1e-2, mu_dtype=torch.bfloat16)),
    "adamw_schedule": (lambda: optax.adamw(_sched(optax)),
                       lambda: training.adamw(_sched(training))),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_rules_match_optax(name):
    rng = np.random.RandomState(0)
    p0 = {"b": rng.randn(3).astype(np.float32),
          "w": rng.randn(4, 3).astype(np.float32)}
    make_jax, make_port = RULES[name]
    jopt, topt = make_jax(), make_port()
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = topt.init(tp)
    for _ in range(5):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in p0.items()}
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_mu_dtype_trajectory_keeps_a_bf16_moment():
    """The JAX package's ``TestMuDtypeBf16``: the first moment is stored
    in bf16, the trajectory stays close to the fp32 moment's, and the
    port's trajectory is optax's (grads from the same loss)."""
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    comm = LoopbackCommunicator(device="cpu")

    def port(mu_dtype):
        opt = training.create_multi_node_optimizer(
            training.adamw(1e-2, weight_decay=0.0, mu_dtype=mu_dtype), comm)
        params = {"w": torch.full((4, 4), 0.5)}
        params["w"].requires_grad_(True)
        st = opt.init(params)
        losses = []
        for _ in range(20):
            loss = ((params["w"] - torch.tensor(x)) ** 2).mean()
            losses.append(float(loss.detach()))
            (g,) = torch.autograd.grad(loss, [params["w"]])
            with torch.no_grad():
                opt.update({"w": g}, st, params)
        return losses, st

    def jax_run(mu_dtype):
        opt = optax.adam(1e-2, mu_dtype=mu_dtype)
        params = {"w": jnp.ones((4, 4)) * 0.5}
        st = opt.init(params)
        grad = jax.grad(lambda p: jnp.mean((p["w"] - x) ** 2))
        losses = []
        for _ in range(20):
            losses.append(float(jnp.mean((params["w"] - x) ** 2)))
            u, st = opt.update(grad(params), st, params)
            params = optax.apply_updates(params, u)
        return losses

    fp, _ = port(None)
    bf, st = port(torch.bfloat16)
    mus = [t for s in st.state.values() for t in s.values()
           if t.dtype == torch.bfloat16]
    assert mus, "no bf16 moment in the optimizer state"
    np.testing.assert_allclose(bf, fp, rtol=2e-2)
    np.testing.assert_allclose(bf, jax_run(jnp.bfloat16), rtol=1e-5)
    np.testing.assert_allclose(fp, jax_run(None), rtol=1e-5)


# --------------------------------------------------------------------- #
# the overlap schedule and the window contract
# --------------------------------------------------------------------- #

def _schedule_tree():
    rng = np.random.RandomState(1)
    return [rng.randn(*s).astype(np.float32) for s in
            ((3,), (17, 5), (0, 4), (129,), (301, 7), (11,))] + [
        np.arange(6, dtype=np.int32)]


@pytest.mark.parametrize("bucket", [16, 256, 1024, 1 << 20])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_overlap_schedule_matches_jax(bucket, wire):
    leaves = _schedule_tree()
    want = jax_fused.build_overlap_schedule(
        [jnp.asarray(a) for a in leaves], bucket,
        None if wire is None else jnp.bfloat16)
    got = fused.build_overlap_schedule(
        [torch.tensor(a) for a in leaves], bucket,
        None if wire is None else torch.bfloat16)
    assert got == want
    assert fused._normalize_schedule(got) == \
        jax_fused._normalize_schedule(want)


def test_overlap_schedule_is_checked():
    for bad, match in (([{"leaves": 0}], "positive"),
                       ([(1, "later")], "mode"), ([(1, "eager", "x")], "via"),
                       ([], "empty")):
        with pytest.raises(ValueError, match=match):
            fused._normalize_schedule(bad)
        with pytest.raises(ValueError, match=match):
            jax_fused._normalize_schedule(bad)
    comm = LoopbackCommunicator(device="cpu")
    with pytest.raises(ValueError, match="covers 3 leaves"):
        fused.overlap_exchange([torch.ones(2), torch.ones(3)], comm,
                               schedule=[(3, "eager", "rs")])


@pytest.mark.parametrize("n_steps", [1, 3, 4])
def test_window_contract_matches_jax(n_steps):
    """``assemble_window`` and ``put_window``'s stacking against the JAX
    package's over an epoch of 5 batches of 4 and a ragged batch of 2."""
    rng = np.random.RandomState(2)
    X, Y = rng.randn(22, 3).astype(np.float32), np.arange(22)

    def pulls(module_iter):
        it = module_iter((X, Y), 4, repeat=False)
        return lambda: tuple(next(it))

    port_pull, jax_pull = pulls(SerialIterator), pulls(JaxSerialIterator)
    while True:
        try:
            want, want_pending = jax_prefetch.assemble_window(jax_pull,
                                                              n_steps)
        except StopIteration:
            with pytest.raises(StopIteration):
                assemble_window(port_pull, n_steps)
            break
        window, pending = assemble_window(port_pull, n_steps)
        arrays, k, tail = put_window(window, pending)
        assert k == len(want)
        stacked = want[0] if k == 1 else tuple(np.stack(c)
                                               for c in zip(*want))
        for a, b in zip(arrays, stacked):
            _assert_bitwise(a, b)
        assert (tail is None) == (want_pending is None)
        if tail is not None:
            for a, b in zip(tail, want_pending):
                _assert_bitwise(a, b)


@pytest.mark.parametrize("scan_batches", [True, False])
def test_fuse_steps_matches_jax(scan_batches):
    """``fuse_steps`` on the CPU (named) against the JAX package's
    ``lax.scan`` program: a momentum step on a linear model, its carry
    and its stacked metrics over 3 steps, at 1e-5 relative and 1e-6
    absolute (the same fp32 operations; XLA's and torch's products sum
    in other orders, and the momentum carries the difference on)."""
    from chainermn_tpu.training import fuse_steps as jax_fuse_steps

    rng = np.random.RandomState(3)
    w0, x = rng.randn(4).astype(np.float32), rng.randn(3, 5, 4)
    x = x.astype(np.float32) if scan_batches else x[0].astype(np.float32)

    def step(lib):
        def fn(carry, xb):
            w, m = carry
            loss = lib.mean((xb @ w) ** 2)
            g = 2 * xb.T @ (xb @ w) / xb.shape[0]
            m = 0.9 * m + g
            return (w - 0.1 * m, m), {"loss": loss}
        return fn

    want = jax.jit(jax_fuse_steps(step(jnp), 3, scan_batches=scan_batches))(
        (jnp.asarray(w0), jnp.zeros(4)), jnp.asarray(x))
    got = training.fuse_steps(step(torch), 3, scan_batches=scan_batches,
                              device="cpu")(
        (torch.tensor(w0), torch.zeros(4)), torch.tensor(x))
    for a, b in zip(pytree.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert got[1]["loss"].shape == (3,)


# --------------------------------------------------------------------- #
# the exchange's forms in the 4-rank world
# --------------------------------------------------------------------- #

def test_reduce_scatter_and_two_stage_match_jax(world, payload):
    flat = _mesh("world")
    grid = _mesh("inter", "intra")
    for name, (a, dtype) in payload["buckets"].items():
        x = _jax_leaf(a, dtype)
        rs = _np(_shard(lambda b: jax_fused.reduce_scatter_allgather(
            b, "world"), flat, P("world"))(x))
        rs_sum = _np(_shard(lambda b: jax_fused.reduce_scatter_allgather(
            b, "world", op="sum"), flat, P("world"))(x))
        hier = _np(_shard(lambda b: jax_fused.hierarchical_allreduce(
            b, "intra", "inter"), grid, P(("inter", "intra")))(x))
        for r in range(N):
            _assert_bitwise(world[r][f"rs_{name}"], rs[r])
            _assert_bitwise(world[r][f"rs_sum_{name}"], rs_sum[r])
            _assert_bitwise(world[r][f"hier_{name}"], hier[r])
        # the flat mean, and ints come out exact (the wire exemption)
        np.testing.assert_array_equal(rs[0], _np(x).mean(0).astype(rs.dtype))


def _jax_tree(payload):
    return {k: _jax_leaf(a, payload["tree_dtypes"][k])
            for k, a in payload["tree"].items()}


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_overlap_exchange_matches_jax(world, payload, case):
    sched, wire = SCHEDULES[case]
    wire = None if wire is None else jnp.bfloat16
    tree = _jax_tree(payload)
    kw = dict(schedule=sched, bucket_bytes=BUCKET, wire_dtype=wire)
    flat = _np(_shard(lambda t: jax_fused.overlap_exchange(
        t, "world", **kw), _mesh("world"), P("world"))(tree))
    hier = _np(_shard(lambda t: jax_fused.overlap_exchange(
        t, "intra", inter_axis_name="inter", **kw),
        _mesh("inter", "intra"), P(("inter", "intra")))(tree))
    for r in range(N):
        for k in tree:
            _assert_bitwise(world[r][f"overlap_{case}"][k], flat[k][r])
            _assert_bitwise(world[r][f"overlap_hier_{case}"][k], hier[k][r])
    assert world[0]["schedule"] == jax_fused.build_overlap_schedule(
        jax.tree.map(lambda a: a[0], tree), BUCKET, jnp.bfloat16)


def test_two_stage_mean_grad_matches_jax(world, payload):
    tree = _jax_tree(payload)
    want = _np(_shard(lambda t: jax_fused.fused_allreduce(
        t, "intra", bucket_bytes=BUCKET, wire_dtype=jnp.bfloat16,
        inter_axis_name="inter"), _mesh("inter", "intra"),
        P(("inter", "intra")))(tree))
    for r in range(N):
        assert world[r]["hierarchy_sizes"] == [2, 2]
        # nothing on the world; a reduce-scatter, an all-gather (the
        # node's) and an all-reduce (the nodes') a float bucket
        flat, intra, inter = world[r]["two_stage_collectives"]
        assert flat == 0 and intra > 0 and inter > 0
        for k in tree:
            _assert_bitwise(world[r]["mean_two_stage"][k], want[k][r])


def test_bf16_mean_is_within_rounding_of_the_exact_mean(world, payload):
    # chip_smoke.py --four-cards' exchange witness, on gloo: a mean of
    # four shares through a bf16 wire, summed in any order, is off the
    # exact mean by at most 1.75 bf16 ulps taken at the element's
    # largest share (four casts of half an ulp, three sums rounded within
    # 1, 2 and 2 ulps, over four); a missing share is 32 ulps off or more
    for i, shares in enumerate(payload["rounding"]):
        exact = shares.astype(np.float64).mean(0)
        big = np.abs(shares).max(0).astype(np.float64)
        ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
        for r in range(N):
            got = world[r]["mean_bf16_rounding"][i].astype(np.float64)
            assert (np.abs(got - exact) / ulp).max() <= 1.75
            _assert_bitwise(got, world[0]["mean_bf16_rounding"][i])


def test_uneven_nodes_refuse_the_two_stage_exchange(world):
    # a 3-rank communicator of two nodes (2 + 1 ranks) has no rectangle
    # to reduce over: hierarchy() and the inter_axis_name optimizer raise
    # on each member, where they would hang or mean wrongly
    for r in range(3):
        assert world[r]["uneven"] == [
            "hierarchy() needs as many ranks on every node; the nodes "
            "hold [2, 1]: reduce over the flat communicator instead"] * 2
    assert "uneven" not in world[3]


# --------------------------------------------------------------------- #
# the multi-node optimizer: ports of the JAX package's tests
# --------------------------------------------------------------------- #

def _jax_opt_steps(opt, params, grads_list, mesh):
    def body(p, s, g):
        u, s = opt.update(jax.tree.map(lambda a: a[0], g), s, p)
        return optax.apply_updates(p, u), s

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), P(), P("world")),
                              out_specs=(P(), P())))
    state = jax.jit(opt.init)(params)
    out = []
    for g in grads_list:
        params, state = f(params, state, g)
        out.append(jax.tree.map(np.asarray, params))
    return out


def _jax_world():
    return jax_create_communicator("tpu_xla", devices=jax.devices()[:N])


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_two_micro_steps_equal_one_big(world, payload, inner):
    # test_multi_node_optimizer.py:221
    make = {"sgd": lambda: optax.sgd(0.5), "adam": lambda: optax.adam(1e-2)}
    jc = _jax_world()
    g1, g2 = ({"w": jnp.asarray(payload[k])} for k in ("g1", "g2"))
    mid, acc = _jax_opt_steps(jax_multi_node_optimizer(
        make[inner](), jc, accum_steps=2), {"w": jnp.ones(6)}, [g1, g2],
        jc.mesh)
    for r in range(N):
        got = world[r][f"opt_accum_{inner}"]
        np.testing.assert_array_equal(got["mid"], np.ones(6))
        np.testing.assert_array_equal(mid["w"], np.ones(6))
        np.testing.assert_allclose(got["acc"], acc["w"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["acc"], got["big"], rtol=1e-5,
                                   atol=1e-6)
        # the accumulator and its count ride the optimizer's tree
        assert int(got["tree"]["accum"]["count"]) == 1
        np.testing.assert_allclose(got["tree"]["accum"]["acc"][0],
                                   payload["g1"].mean(0), rtol=1e-6)


def test_double_buffering_is_one_step_stale(world):
    # test_multi_node_optimizer.py:120: the first update applies zeros
    jc = _jax_world()
    grads = [{"w": jnp.tile(jnp.asarray([g]), (N, 1))}
             for g in ([1.0, 2.0], [10.0, 20.0])]
    want = _jax_opt_steps(jax_multi_node_optimizer(
        optax.sgd(1.0), jc, double_buffering=True), {"w": jnp.zeros(2)},
        grads, jc.mesh)
    for r in range(N):
        w1, w2 = world[r]["double_buffer"]
        np.testing.assert_array_equal(w1, [0.0, 0.0])
        np.testing.assert_array_equal(w2, [-1.0, -2.0])
        np.testing.assert_array_equal(w2, want[1]["w"])


def test_large_batch_recipe_composition(world, payload):
    # test_multi_node_optimizer.py:142: lr(t) times the mean gradient of
    # step t - 1 through a bf16 wire
    import sys

    sys.path.insert(0, str(ROOT / "examples" / "imagenet"))
    from train_imagenet_large_batch import make_lr_schedule

    sched = make_lr_schedule(base_lr=0.1, global_batch=1024,
                             warmup_epochs=1, total_epochs=3,
                             steps_per_epoch=4)
    jc = _jax_world()
    g = {"w": jnp.asarray(payload["recipe_g"])}
    want = _jax_opt_steps(jax_multi_node_optimizer(
        optax.sgd(sched), jc, double_buffering=True,
        allreduce_grad_dtype=jnp.bfloat16), {"w": jnp.zeros(2)}, [g, g],
        jc.mesh)
    lr1 = float(sched(1))
    for r in range(N):
        np.testing.assert_allclose(
            world[r]["sched"], [float(sched(c)) for c in (0, 1, 4, 8)],
            rtol=1e-6)
        w0, w1 = world[r]["recipe"]
        np.testing.assert_array_equal(w0, [0.0, 0.0])
        np.testing.assert_allclose(w1, [-lr1, -2 * lr1], rtol=2e-2)
        np.testing.assert_allclose(w1, want[1]["w"], rtol=1e-5)


# --------------------------------------------------------------------- #
# the updater: accumulation, windows, flushes, the window loss
# --------------------------------------------------------------------- #

def _jax_job(payload, job):
    jc = _jax_world()
    n = job["n"]
    if job["model"] == "mlp":
        data = (payload["mlp_x"][:n], payload["mlp_y"][:n])
        params, state = payload["mlp_params"], None

        def loss_fn(p, x, y):
            return jax_xent(jax_mlp_apply(p, x), y)
    else:
        data = (payload["images"][:n], payload["labels"][:n])
        cfg = JaxResNetConfig(**RESNET)
        params = payload["resnet_params"]
        # the JAX package's own state type: its scan carries must match
        state = jax.tree.map(
            lambda s: JaxBNState(*s), payload["resnet_state"],
            is_leaf=lambda s: isinstance(s, BatchNormState))

        def loss_fn(p, s, x, y):
            logits, new = jax_resnet_apply(cfg, p, s, x, train=True,
                                           axis_name=jc.axis_name)
            return jax_xent(logits, y), new
    inner = {"sgd": optax.sgd, "adam": optax.adam,
             "momentum": lambda lr: optax.sgd(lr, momentum=0.9)}[
        job["opt"]](job["lr"])
    up = JaxUpdater(
        JaxSerialIterator(data, job["G"], repeat=job["repeat"],
                          shuffle=False),
        jax_multi_node_optimizer(inner, jc), loss_fn, params, jc,
        state=state, accum_steps=job["M"],
        steps_per_execution=job["spe"])
    losses, iterations = [], []
    for _ in range(job["updates"]):
        up.update()
        losses.append(float(up.observation["main/loss"]))
        iterations.append(up.iteration)
    return dict(losses=losses, iterations=iterations, params=_np(up.params),
                state=None if state is None else _np(up.state))


def _assert_trees_close(got, want, rtol=1e-5, atol=1e-6):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["accum", "accum_adam", "fused", "flush",
                                  "fused_flush", "weighted"])
def test_mlp_updater_matches_jax(world, payload, name):
    # test_accum.py:64,75,189,233 and test_fused_steps.py:122
    want = _jax_job(payload, JOB[name])
    for r in range(N):
        got = world[r][name]
        assert got["iterations"] == want["iterations"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, atol=1e-6)
        _assert_trees_close(got["params"], want["params"])


def test_updater_properties_hold_in_the_world(world):
    """Port against port: M microbatches equal one M-times batch
    (sgd, adam), a window equals its unfused updates (bitwise for
    windows of one-microbatch updates and for the stateful ResNet), a
    tail flushes through groups and singles, the window loss weights
    microbatches."""
    for r in range(N):
        got = world[r]
        for a, b in (("accum", "big"), ("accum_adam", "big_adam"),
                     ("fused", "unfused")):
            _assert_trees_close(got[a]["params"], got[b]["params"],
                                rtol=1e-5 if "adam" not in a else 2e-4,
                                atol=1e-6 if "adam" not in a else 1e-5)
        for a, b in zip(jax.tree.leaves(got["windows"]["params"]),
                        jax.tree.leaves(got["plain"]["params"])):
            np.testing.assert_array_equal(a, b)
        # stateful too (test_fused_steps.py:149): the ResNet's window of
        # two updates is its two unfused updates, BN statistics included
        for k in ("params", "state"):
            for a, b in zip(jax.tree.leaves(got["resnet"][k]),
                            jax.tree.leaves(got["resnet_unfused"][k])):
                np.testing.assert_array_equal(a, b)
        assert got["windows"]["iterations"] == [3, 6]
        assert got["flush"]["iterations"] == [4, 8, 10]
        assert got["fused_flush"]["iterations"] == [3]
        np.testing.assert_allclose(got["weighted"]["losses"][0],
                                   np.mean(got["weighted_plain"]["losses"]),
                                   rtol=1e-6)


def test_resnet_window_matches_jax(world, payload):
    """A window of two updates of two microbatches on the tiny ResNet
    with sync BN, fp32: the parameters' update within 1e-4 relative L2
    of the JAX updater's over the tree and 1e-3 a leaf (a branch
    convolution behind a BN γ that starts at 0 gets its first update in
    the window's second step, a product of small numbers), the BN
    statistics within 1e-4."""
    want = _jax_job(payload, JOB["resnet"])
    start = payload["resnet_params"]
    for r in range(N):
        got = world[r]["resnet"]
        assert got["iterations"] == want["iterations"] == [4]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        moved, off = [], []
        for (path, a), b, s in zip(
                jax.tree_util.tree_flatten_with_path(want["params"])[0],
                jax.tree.leaves(got["params"]), jax.tree.leaves(start)):
            d = a - s
            moved.append(d.ravel())
            off.append(((b - s) - d).ravel())
            if np.linalg.norm(d):
                rel = np.linalg.norm((b - s) - d) / np.linalg.norm(d)
                assert rel < 1e-3, (jax.tree_util.keystr(path), rel)
        assert np.linalg.norm(np.concatenate(off)) < 1e-4 * np.linalg.norm(
            np.concatenate(moved))
        _assert_trees_close(got["state"], want["state"], rtol=1e-4,
                            atol=1e-5)


# --------------------------------------------------------------------- #
# the port's own: prefetch, triggers, a resume mid-window
# --------------------------------------------------------------------- #

def _dataset(n=96, seed=5):
    rng = np.random.RandomState(seed)
    protos = rng.randn(10, 20).astype(np.float32)
    return [(protos[i % 10] + 0.3 * rng.randn(20).astype(np.float32),
             np.int32(i % 10)) for i in range(n)]


def _updater(comm, seed=1, prefetch=0, n=96, opt_kw=None, **kw):
    params = mlp_params_from_jax(init_mlp_numpy([20, 16, 10], 0), "cpu")
    it = SerialIterator(_dataset(n), 8, shuffle=True, seed=seed)
    opt = training.create_multi_node_optimizer(
        training.sgd(0.1, momentum=0.9), comm, **(opt_kw or {}))
    return training.StandardUpdater(
        it, opt, lambda p, x, y: softmax_cross_entropy(mlp_apply(p, x), y),
        params, comm, prefetch=prefetch, **kw)


def _params(up):
    return [t.detach().clone() for layer in up.params for t in layer.values()]


@pytest.fixture
def comm():
    return LoopbackCommunicator(device="cpu")


@pytest.mark.parametrize("kw", [dict(accum_steps=4),
                                dict(accum_steps=2, steps_per_execution=2)])
def test_prefetched_windows_are_bitwise_the_serial_feed(comm, kw):
    # test_accum.py:112
    serial, pre = _updater(comm, **kw), _updater(comm, prefetch=2, **kw)
    assert pre.iterator._n_steps == 4 and pre.max_inflight == 2
    for _ in range(5):                          # crosses an epoch end
        serial.update()
        pre.update()
        assert serial.epoch_detail == pre.epoch_detail
    pre.finalize()
    assert all(torch.equal(a, b)
               for a, b in zip(_params(serial), _params(pre)))
    # on the CPU nothing is in flight: both observe the window's loss
    assert float(pre.observation["main/loss"]) == float(
        serial.observation["main/loss"])
    assert "main/accum_time" in serial.observation


def test_trainer_triggers_count_microbatches(comm):
    # test_accum.py:264: 96 / 8 = 12 microbatches an epoch, window 4
    up = _updater(comm, accum_steps=4)
    trainer = training.Trainer(up, (2, "epoch"))
    trainer.run()
    assert up.iteration == 24 and up.epoch == 2
    obs = up.observation
    np.testing.assert_allclose(obs["main/accum_time"],
                               obs["main/step_time"] * 4, rtol=1e-9)


def test_resume_mid_accumulation_is_bitwise(comm, tmp_path):
    """The optimizer accumulates over 2 calls and double-buffers: a save
    after an odd update (the accumulator holds a gradient, the stash the
    last mean) resumes bitwise, with both in the snapshot."""
    kw = dict(opt_kw=dict(accum_steps=2, double_buffering=True))
    straight = _updater(comm, **kw)
    cp = create_multi_node_checkpointer(comm, str(tmp_path))
    losses = []
    for _ in range(7):
        straight.update()
        losses.append(float(straight.observation["main/loss"]))
        if straight.iteration == 3:
            assert straight.opt_state.phase == 1
            assert any(t.abs().sum() > 0 for t in straight.opt_state.acc)
            assert any(t.abs().sum() > 0 for t in straight.opt_state.prev)
            cp.save(straight)
    resumed = _updater(comm, seed=99, **kw)
    assert create_multi_node_checkpointer(
        comm, str(tmp_path)).maybe_load(resumed) == 3
    assert resumed.opt_state.phase == 1
    got = []
    for _ in range(4):
        resumed.update()
        got.append(float(resumed.observation["main/loss"]))
    assert got == losses[3:]
    assert all(torch.equal(a, b)
               for a, b in zip(_params(straight), _params(resumed)))


def test_updater_window_errors(comm):
    it = PrefetchIterator(SerialIterator(_dataset(), 8), comm,
                          steps_per_execution=4)
    with pytest.raises(ValueError, match="8-deep window"):
        training.StandardUpdater(it, None, None, [], comm,
                                 steps_per_execution=2, accum_steps=4)
    it.close()
    for kw, match in ((dict(accum_steps=0), "accum_steps"),
                      (dict(steps_per_execution=0), "steps_per_execution"),
                      (dict(max_inflight=0), "max_inflight")):
        with pytest.raises(ValueError, match=match):
            _updater(comm, **kw)
