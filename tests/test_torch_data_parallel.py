"""ChainerMN's data-parallel path in the port against the JAX package.

In this process: the fused buckets' layout (bitwise), the data
partition and the iterator order (bitwise, resume included), the ResNet
forward and gradients, and the MNIST trainer at world size 1.  In one
4-process gloo world (``test_torch_world.battery_data_parallel``, once
for the module): the gradient exchange, synchronised BN, and one
updater step of the ResNet and three of the MLP, each against the JAX
package on 4 devices of the 8-device virtual CPU mesh, fed the same
global batch (each rank its quarter of the rows).

Tolerances, fp32: the exchange 1e-6 (gloo and XLA add four numbers in
different orders); BN 1e-5; the ResNet 1e-4 of each leaf's largest
element (53 layers of convolutions that cuDNN-free CPU torch and XLA
sum in different orders; measured ~5e-5); the updater steps 1e-5 (loss)
and 1e-4 relative L2 of each parameter update.  bf16 wire: bf16 keeps
8 significant bits (one rounding is at most 2^-9 relative), and the
port rounds each rank's gradient to bf16 before the sum and the sum
itself, where the JAX package rounds the fp32 global mean once
(``cross_replica_mean``), so the port's mean is held to the fp32 mean
within the JAX package's own bf16-wire tolerance (3e-2, its
``test_fused.py``) and to 1e-2 relative L2 of the JAX bf16 result; the
MLP's bf16-wire update is held to 1e-2 relative L2 over the whole tree
(a leaf whose ranks' shares cancel carries their rounding).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.utils._pytree as pytree

from chainermn_tpu import create_communicator as jax_create_communicator
from chainermn_tpu.datasets import _partition as jax_partition
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.links.batch_normalization import (
    BatchNormState as JaxBNState,
    multi_node_batch_normalization as jax_bn,
)
from chainermn_tpu.models import (
    ResNetConfig as JaxResNetConfig,
    init_mlp,
    init_resnet,
    mlp_apply as jax_mlp_apply,
    resnet_apply as jax_resnet_apply,
    softmax_cross_entropy as jax_xent,
)
from chainermn_tpu.ops import fused as jax_fused
from chainermn_tpu.training import (
    StandardUpdater as JaxUpdater,
    create_multi_node_optimizer as jax_multi_node_optimizer,
)
from chainermn_tpu.utils.comm_model import fused_collective_budget
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import init_distributed
from chainermn_tpu_torch.datasets import _partition
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import (
    ResNetConfig,
    init_resnet_numpy,
    resnet_apply,
    resnet_params_from_jax,
    resnet_to_numpy,
    softmax_cross_entropy,
)
from chainermn_tpu_torch.ops import fused
from test_torch_world import run_world

ROOT = Path(__file__).resolve().parent.parent
N = 4
BUCKET = 1024
RESNET = dict(depth=50, num_classes=8, width=8, dtype="float32")


def _odd_tree(n, seed=0):
    """Per-rank gradient trees (world-stacked leaves): small, odd,
    straddling and direct leaves, an empty leaf and a nested dict."""
    rng = np.random.RandomState(seed)

    def leaf(*shape):
        return rng.randn(n, *shape).astype(np.float32)

    return {"tiny": leaf(3), "odd": leaf(17, 5), "mid": leaf(129),
            "big": leaf(301, 7), "empty": np.zeros((n, 0, 4), np.float32),
            "nest": {"a": leaf(11), "b": leaf(2, 2, 2)}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_resnet():
    # init_resnet_numpy's trees (init_resnet's layout and scales; running
    # init_resnet itself op by op costs ~15 s here)
    return JaxResNetConfig(**RESNET), *init_resnet_numpy(
        ResNetConfig(**RESNET), 0)


def test_init_resnet_numpy_has_init_resnets_layout():
    cfg = JaxResNetConfig(**RESNET)
    want = jax.eval_shape(lambda key: init_resnet(key, cfg),
                          jax.random.PRNGKey(0))
    got = init_resnet_numpy(ResNetConfig(**RESNET), 0)
    wl, wt = jax.tree_util.tree_flatten_with_path(want)
    gl, gt = jax.tree_util.tree_flatten_with_path(got)
    assert [jax.tree_util.keystr(k) for k, _ in gl] == \
        [jax.tree_util.keystr(k) for k, _ in wl]
    for (_, a), (path, b) in zip(gl, wl):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    params = got[0]
    assert not params["stage1_block1"]["bn3"]["gamma"].any()
    w = params["stage3_block2"]["conv2"]
    assert abs(w.std() / np.sqrt(2.0 / (9 * w.shape[2])) - 1) < 0.05


def _residual_gamma(params, value):
    """``params`` with every bottleneck's last BN γ set to ``value``
    (``init_resnet`` starts them at zero, which stops the gradient of
    the branch's convolutions)."""
    out = jax.tree.map(lambda a: a, params)
    for name in out:
        if name.startswith("stage"):
            out[name]["bn3"]["gamma"] = np.full_like(
                out[name]["bn3"]["gamma"], value)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_resnet):
    _, params, state = jax_resnet
    rng = np.random.RandomState(7)
    payload = dict(
        grads=_odd_tree(N, seed=1), bucket=BUCKET,
        bn_x=rng.randn(N, 3, 5, 5, 6).astype(np.float32) * 2 + 0.5,
        bn_w=rng.randn(N, 3, 5, 5, 6).astype(np.float32),
        bn_gamma=rng.rand(6).astype(np.float32) + 0.5,
        bn_beta=rng.randn(6).astype(np.float32),
        bn_mean=rng.randn(6).astype(np.float32),
        bn_var=rng.rand(6).astype(np.float32) + 0.5,
        n_data=23,
        resnet_cfg=RESNET, resnet_params=params, resnet_state=state,
        # a global batch of 9: the policy drops one row, 2 a rank
        images=rng.randn(9, 32, 32, 3).astype(np.float32),
        labels=(np.arange(9) % 8).astype(np.int32),
        mlp_params=_np(init_mlp(jax.random.PRNGKey(1), [20, 16, 5])),
        mlp_x=rng.randn(12, 20).astype(np.float32),
        mlp_y=(np.arange(12) % 5).astype(np.int32),
    )
    got = run_world(tmp_path_factory.mktemp("dp"), N,
                    "battery_data_parallel", payload)
    return payload, got


def _jax_comm():
    return jax_create_communicator("tpu_xla", devices=jax.devices()[:N])


# --------------------------------------------------------------------- #
# buckets
# --------------------------------------------------------------------- #

def _leaf_lists():
    rng = np.random.RandomState(3)
    f32 = [rng.randn(*s).astype(np.float32)
           for s in ((3,), (17, 5), (129,), (301, 7), (0, 4), (11,),
                     (2, 2, 2))]
    mixed = [rng.randn(40).astype(np.float32),
             rng.randn(9, 3).astype(jnp.bfloat16),
             np.asarray([1000003, -7654321, 1 << 20], np.int32),
             np.asarray([True, False, True]),
             np.zeros((0,), np.int32),
             rng.randn(300).astype(np.float32),
             rng.randn(5).astype(jnp.bfloat16)]
    return {"fp32": f32, "mixed": mixed}


def _torch_leaf(a):
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _spec_rows(spec, dtype_name):
    return ([(dtype_name(w), [(i, tuple(s), dtype_name(d)) for i, s, d in
                              direct],
              [(i, tuple(s), dtype_name(d)) for i, s, d in arena], n)
             for w, direct, arena, n in spec.groups],
            [(i, tuple(s), dtype_name(d)) for i, s, d in spec.empties],
            spec.n_leaves)


@pytest.mark.parametrize("bucket", [15, 128, 1000, 1024, 4097, 1 << 20])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("tree", ["fp32", "mixed"])
def test_buckets_match_jax_bitwise(tree, wire, bucket):
    leaves = _leaf_lists()[tree]
    jb, jspec = jax_fused.flatten_buckets(
        [jnp.asarray(a) for a in leaves], bucket,
        None if wire is None else jnp.bfloat16)
    tb, tspec = fused.flatten_buckets(
        [_torch_leaf(a) for a in leaves], bucket,
        None if wire is None else torch.bfloat16)
    assert _spec_rows(tspec, lambda d: str(d).replace("torch.", "")) == \
        _spec_rows(jspec, lambda d: str(np.dtype(d)))
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    # unpack: the leaves in their own dtypes, bitwise what JAX gives
    out = fused.unflatten_buckets(tb, tspec)
    want = jax_fused.unflatten_buckets(jb, jspec)
    for t, j in zip(out, want):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    total = sum(b.numel() * b.element_size() for b in tb)
    assert len(tb) <= fused.fused_collective_budget(
        total, bucket, len(tspec.groups))


def test_bad_bucket_and_op_raise():
    with pytest.raises(ValueError, match="positive"):
        fused.flatten_buckets([torch.ones(3)], bucket_bytes=0)
    with pytest.raises(ValueError, match="unsupported"):
        fused.fused_allreduce([torch.ones(3)], None, op="max")


# --------------------------------------------------------------------- #
# the exchange, sync BN, the data partition: the 4-rank world
# --------------------------------------------------------------------- #

def test_mean_grad_matches_jax(world):
    p, got = world
    tree = p["grads"]
    jc = _jax_comm()
    want32 = _np(jc.multi_node_mean_grad(tree, bucket_bytes=BUCKET))
    want16 = _np(jc.multi_node_mean_grad(tree, dtype=jnp.bfloat16,
                                         bucket_bytes=BUCKET))
    mean = jax.tree.map(lambda a: a.mean(0), tree)
    names = [k for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    for r in range(N):
        for kind in ("fp32", "fp32_leaf"):
            for path, a in jax.tree_util.tree_flatten_with_path(want32)[0]:
                b = got[r][f"mean_{kind}"]
                for k in path:
                    b = b[k.key]
                np.testing.assert_allclose(b, a[r], rtol=1e-6, atol=1e-6)
        for kind in ("bf16", "bf16_leaf"):
            for path, a in jax.tree_util.tree_flatten_with_path(want16)[0]:
                b, m = got[r][f"mean_{kind}"], mean
                for k in path:
                    b, m = b[k.key], m[k.key]
                assert b.dtype == np.float32 and b.shape == a[r].shape
                np.testing.assert_allclose(b, m, rtol=3e-2, atol=3e-2)
                if a[r].size:
                    rel = np.linalg.norm(b - a[r]) / np.linalg.norm(a[r])
                    assert rel < 1e-2, (path, rel)
    assert len(names) == 7
    total = sum(a[0].size * 4 for a in jax.tree.leaves(tree))
    for r in range(N):
        assert 0 < got[r]["count_fp32"] <= fused_collective_budget(
            total, BUCKET)
        assert 0 < got[r]["count_bf16"] <= fused_collective_budget(
            total // 2, BUCKET)
        assert got[r]["count_fp32_leaf"] == 7      # one a leaf


def test_sync_bn_matches_jax_shard_map(world):
    p, got = world
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:N]), ("world",))
    state = JaxBNState(jnp.asarray(p["bn_mean"]), jnp.asarray(p["bn_var"]),
                       jnp.zeros((), jnp.int32))

    def total(x, gamma, beta):
        def local(x, w, gamma, beta):
            y, new = jax_bn({"gamma": gamma, "beta": beta}, state, x[0],
                            axis_name="world")
            return (jnp.sum(y * w[0])[None], y[None], new.mean[None],
                    new.var[None], new.n[None])

        loss, y, mean, var, n = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("world"), P("world"), P(), P()),
            out_specs=(P("world"),) * 5)(x, jnp.asarray(p["bn_w"]), gamma,
                                          beta)
        return loss.sum(), (y, mean, var, n)

    (_, (y, mean, var, n)), (gx, gg, gb) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(p["bn_x"]), jnp.asarray(p["bn_gamma"]),
        jnp.asarray(p["bn_beta"]))
    for r in range(N):
        bn = got[r]["bn"]
        np.testing.assert_allclose(bn["y"], y[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn["gx"], gx[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn["ggamma"], gg, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn["gbeta"], gb, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn["mean"], mean[r], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn["var"], var[r], rtol=1e-5, atol=1e-6)
        assert int(bn["n"]) == int(n[r]) == 1


def test_partition_and_shuffle_blocks(world):
    p, got = world
    n = p["n_data"]
    shuffled = jax_partition(n, N, True, 5, True)
    plain = jax_partition(n, N, False, None, False)
    padded = jax_partition(n, N, False, None, True)
    for r in range(N):
        np.testing.assert_array_equal(got[r]["scatter"], shuffled[r])
        np.testing.assert_array_equal(got[r]["scatter_eq"], plain[r])
        np.testing.assert_array_equal(got[r]["scatter_index"], padded[r])
    # shuffle_data_blocks: the permuted concatenation of every block,
    # cut into balanced contiguous shares
    blocks = [("r", r, i) for r in range(N) for i in range(3 + r)]
    perm = np.random.RandomState(3).permutation(len(blocks))
    order = [blocks[i] for i in perm]
    bounds = [len(blocks) * j // N for j in range(N + 1)]
    for r in range(N):
        assert got[r]["shuffled"] == order[bounds[r]:bounds[r + 1]]


@pytest.mark.parametrize("n,size,shuffle,seed,equal", [
    (23, 4, True, 5, True), (23, 4, False, None, False), (8, 3, True, None,
                                                          True),
    (1000, 7, True, 11, False), (5, 8, True, 2, True)])
def test_partition_matches_jax_bitwise(n, size, shuffle, seed, equal):
    for a, b in zip(_partition(n, size, shuffle, seed, equal),
                    jax_partition(n, size, shuffle, seed, equal)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["list", "array", "tuple"])
def test_serial_iterator_order_and_resume(kind):
    x = np.arange(23 * 2).reshape(23, 2).astype(np.float32)
    y = np.arange(23).astype(np.int32)
    data = {"list": list(zip(x, y)), "array": x, "tuple": (x, y)}[kind]

    def flat(batch):
        if isinstance(batch, list):
            return [np.asarray(e[0]).tolist() for e in batch]
        if isinstance(batch, tuple):
            return batch[0].tolist()
        return batch.tolist()

    ours = SerialIterator(data, 5, shuffle=True, seed=9)
    ref = JaxSerialIterator(data, 5, shuffle=True, seed=9)
    for _ in range(7):
        assert flat(next(ours)) == flat(next(ref))
        assert (ours.epoch, ours.is_new_epoch, ours.epoch_detail) == \
            (ref.epoch, ref.is_new_epoch, ref.epoch_detail)
    resumed = SerialIterator(data, 5, shuffle=True, seed=0)
    resumed.load_state_dict(ours.state_dict())
    for _ in range(9):
        assert flat(next(resumed)) == flat(next(ref))
    finite = SerialIterator(data, 10, repeat=False)
    assert [len(flat(b)) for b in finite] == [10, 10, 3]


# --------------------------------------------------------------------- #
# the ResNet and the updaters
# --------------------------------------------------------------------- #

def _leaf_errors(got, want):
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
        b = got
        for k in path:
            b = b[getattr(k, "key", getattr(k, "idx", None))] \
                if not hasattr(k, "name") else getattr(b, k.name)
        a = np.asarray(a)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(b - a).max() / max(np.abs(a).max(), 1e-12))
    return out


@pytest.fixture(scope="module")
def jax_resnet_fns(jax_resnet):
    """The JAX package's jitted loss-and-gradient and evaluation of the
    test ResNet, parameters as arguments, so one compile serves every
    parameter tree of one shape."""
    jcfg = jax_resnet[0]

    def loss(p, state, x, y):
        logits, new = jax_resnet_apply(jcfg, p, state, x)
        return jax_xent(logits, y), (logits, new)

    return (jax.jit(jax.value_and_grad(loss, has_aux=True)),
            jax.jit(lambda p, state, x: jax_resnet_apply(
                jcfg, p, state, x, train=False)[0]))


def _resnet_both(fns, params, state, batch, px):
    """Logits (train and eval), loss, gradients and new state of both
    packages on the same images."""
    x = np.random.RandomState(px).randn(batch, px, px, 3).astype(np.float32)
    y = np.arange(batch) % 8
    grad, evaluate = fns
    (jl, (jlogits, jstate)), jg = grad(params, state, jnp.asarray(x),
                                       jnp.asarray(y))
    jeval = evaluate(params, state, jnp.asarray(x))

    cfg = ResNetConfig(**RESNET)
    tp, ts = resnet_params_from_jax(params, state, cfg, device="cpu")
    leaves, spec = pytree.tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    logits, new = resnet_apply(cfg, tp, ts, torch.tensor(x))
    tl = softmax_cross_entropy(logits, torch.tensor(y))
    grads = resnet_to_numpy(pytree.tree_unflatten(
        list(torch.autograd.grad(tl, leaves)), spec))
    with torch.no_grad():
        evals, same = resnet_apply(cfg, tp, ts, torch.tensor(x), train=False)
    # evaluation reads the running statistics and leaves them as they are
    assert all(a is b for a, b in zip(pytree.tree_leaves(same),
                                      pytree.tree_leaves(ts)))
    return dict(jax=(float(jl), np.asarray(jlogits), np.asarray(jeval),
                     _np(jg), _np(jstate)),
                port=(tl.item(), logits.detach().numpy(), evals.numpy(),
                      grads, resnet_to_numpy(new)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("px", [32, 33])
def test_resnet_forward_and_gradients_match_jax(jax_resnet, jax_resnet_fns,
                                                px):
    _, params, state = jax_resnet
    got = _resnet_both(jax_resnet_fns, params, state, batch=4, px=px)
    jl, jlogits, jeval, jg, jstate = got["jax"]
    tl, logits, evals, grads, state = got["port"]
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(evals, jeval, rtol=1e-4, atol=1e-4)
    assert abs(tl - jl) < 1e-5
    errs = _leaf_errors(grads, jg)
    assert max(errs.values()) < 1e-4, max(errs.items(), key=lambda kv: kv[1])
    assert max(_leaf_errors(state, jstate).values()) < 1e-4


def test_resnet_gradients_through_residual_branches(jax_resnet,
                                                    jax_resnet_fns):
    # with γ = 0.5 the bottlenecks' convolutions carry gradient; the
    # statistics of few rows (4 images at 1x1 or 2x2 in stage 4) make
    # the fp32 gradient ill-conditioned: the JAX package's own gradient
    # moves by 1.5e-2 (relative L2, worst leaf) when the images move by
    # 1e-6, and the port and the JAX package sit 2 % and 5 % on either
    # side of a central finite difference of the worst leaf.  So the
    # whole tree is held to 5e-2 relative L2 here, and each leaf
    # tightly at the JAX initialisation above.
    _, params, state = jax_resnet
    got = _resnet_both(jax_resnet_fns, _residual_gamma(params, 0.5), state,
                       4, 33)
    jl, jlogits, _, jg, _ = got["jax"]
    tl, logits, _, grads, _ = got["port"]
    assert _rel(logits, jlogits) < 2e-3
    a = np.concatenate([g.ravel() for g in jax.tree.leaves(grads)])
    b = np.concatenate([g.ravel() for g in jax.tree.leaves(jg)])
    assert _rel(a, b) < 5e-2


def _jax_updater_step(p, dtype, jax_resnet):
    jcfg, params, state = jax_resnet
    jc = _jax_comm()

    def loss_fn(params, state, x, y):
        logits, new = jax_resnet_apply(jcfg, params, state, x, train=True,
                                       axis_name=jc.axis_name)
        return jax_xent(logits, y), new

    opt = jax_multi_node_optimizer(optax.sgd(0.1, momentum=0.9), jc,
                                   allreduce_grad_dtype=dtype)
    it = JaxSerialIterator((p["images"], p["labels"]), 9)
    up = JaxUpdater(it, opt, loss_fn, params, jc, state=state)
    up.update()
    return float(up.observation["main/loss"]), _np(up.params), \
        _np(up.state)


def _update_errors(got, want, start):
    """Relative L2 of the port's parameter update against JAX's, a
    leaf."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
        b, s = got, start
        for k in path:
            b, s = b[k.key], s[k.key]
        d = np.asarray(a) - s
        norm = np.linalg.norm(d)
        if norm:
            out[jax.tree_util.keystr(path)] = float(
                np.linalg.norm((b - s) - d) / norm)
    return out


@pytest.fixture(scope="module")
def jax_resnet_step(world, jax_resnet):
    return _jax_updater_step(world[0], None, jax_resnet)


def test_resnet_updater_step_matches_jax(world, jax_resnet,
                                         jax_resnet_step):
    # each leaf's update to 1e-4 relative L2 of the JAX updater's
    p, got = world
    _, params, _ = jax_resnet
    loss, jparams, jstate = jax_resnet_step
    for r in range(N):
        assert abs(got[r]["resnet"]["loss"] - loss) < 1e-5 * max(1, abs(loss))
        errs = _update_errors(got[r]["resnet"]["params"], jparams, params)
        assert max(errs.values()) < 1e-4, max(errs.items(),
                                              key=lambda kv: kv[1])
        assert max(_leaf_errors(got[r]["resnet"]["state"],
                                jstate).values()) < 1e-4


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def test_mlp_updater_steps_match_jax(world):
    p, got = world
    jc = _jax_comm()
    opt = jax_multi_node_optimizer(optax.sgd(0.05), jc)
    up = JaxUpdater(JaxSerialIterator((p["mlp_x"], p["mlp_y"]), 12), opt,
                    lambda prm, x, y: jax_xent(jax_mlp_apply(prm, x), y),
                    p["mlp_params"], jc)
    losses = []
    for _ in range(3):
        up.update()
        losses.append(float(up.observation["main/loss"]))
    want = _np(up.params)
    start = {"all": _flat(p["mlp_params"])}
    for r in range(N):
        np.testing.assert_allclose(got[r]["mlp"]["losses"], losses,
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(want, got[r]["mlp"]["params"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                           atol=1e-6)
        # the bf16 wire against the JAX fp32 steps: the first loss is
        # the same forward; later ones and the update carry the rounding
        # of each rank's share (1e-2 relative L2 of the whole update)
        bf = got[r]["mlp_bf16"]
        assert bf["losses"][0] == got[r]["mlp"]["losses"][0]
        np.testing.assert_allclose(bf["losses"], losses, rtol=1e-3)
        assert _update_errors({"all": _flat(bf["params"])},
                              {"all": _flat(want)}, start)["['all']"] < 1e-2


def test_unported_options_raise():
    # ZeRO-1 is ported (test_torch_zero.py): over one rank its update is
    # the replicated exchange's, bit for bit
    from chainermn_tpu_torch.communicators import LoopbackCommunicator

    loop = LoopbackCommunicator(device="cpu")
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(5, 3), "b": rng.randn(7)}
    got = []
    for zero1 in (True, False):
        opt = training.create_multi_node_optimizer(
            training.adamw(1e-2), loop, zero1=zero1)
        assert isinstance(opt, training.Zero1Transformation) == zero1
        params = {k: torch.tensor(v, dtype=torch.float32)
                  for k, v in tree.items()}
        state = opt.init(params)
        for _ in range(2):
            opt.update({k: torch.ones_like(v) for k, v in params.items()},
                       state, params)
        got.append(params)
    for k in tree:
        assert torch.equal(got[0][k], got[1][k])
    for kw in (dict(plan="auto"), dict(overlap="auto")):
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            training.create_multi_node_optimizer(training.sgd(0.1),
                                                 object(), **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        fused.plan_allreduce([], None, {})
    with pytest.raises(NotImplementedError, match="item 10"):
        training.StandardUpdater(iter([]), None, None, {}, None,
                                 exchange_probe_every=5)


def test_large_batch_options_run():
    """What the list above raised for A2 and A4 now runs (held against
    the JAX package in test_torch_large_batch.py): double buffering, the
    two-stage and overlapped exchanges, and the updater's windows,
    accumulation and inflight windows."""
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.iterators import SerialIterator

    comm = LoopbackCommunicator(device="cpu")
    opt = training.create_multi_node_optimizer(
        training.sgd(1.0), comm, double_buffering=True)
    w = {"w": torch.zeros(2)}
    st = opt.init(w)
    opt.update({"w": torch.ones(2)}, st, w)
    assert torch.equal(w["w"], torch.zeros(2))       # zeros applied
    opt.update({"w": torch.ones(2)}, st, w)
    assert torch.equal(w["w"], -torch.ones(2))       # one step stale
    x = torch.arange(5.0)
    assert torch.equal(fused.hierarchical_allreduce(x, comm, comm), x)
    assert torch.equal(fused.overlap_exchange({"x": x}, comm)["x"], x)
    rng = np.random.RandomState(0)
    data = (rng.randn(48, 6).astype(np.float32),
            (np.arange(48) % 3).astype(np.int32))
    up = training.StandardUpdater(
        SerialIterator(data, 4), training.create_multi_node_optimizer(
            training.sgd(0.1), comm),
        lambda p, x, y: softmax_cross_entropy(p["w"][None] * x[:, :3], y),
        {"w": torch.ones(3)}, comm, steps_per_execution=2, accum_steps=2,
        max_inflight=2)
    up.update()
    assert up.iteration == 4 and up.window_steps == 4
    assert "main/accum_time" in up.observation


def test_sgd_momentum_is_optax_trace():
    rng = np.random.RandomState(0)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(3)]
    opt = optax.sgd(0.1, momentum=0.9)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    port_opt = training.sgd(0.1, momentum=0.9)
    tp = {"p": torch.tensor(p0)}
    ts = port_opt.init(tp)
    for g in grads:
        u, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        port_opt.update({"p": torch.tensor(g)}, ts, tp)
    np.testing.assert_allclose(tp["p"].numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


# --------------------------------------------------------------------- #
# the MNIST example at world size 1
# --------------------------------------------------------------------- #

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mnist_trainer_trajectory_matches_jax_example(tmp_path,
                                                      monkeypatch):
    jax_example = _load(ROOT / "examples/mnist/train_mnist.py",
                        "jax_train_mnist")
    port_example = _load(ROOT / "examples/mnist/train_mnist_torch.py",
                         "port_train_mnist")
    monkeypatch.setattr(sys, "argv", [
        "train_mnist.py", "--communicator", "loopback", "--epoch", "2",
        "--out", str(tmp_path / "jax")])
    want = jax_example.main().log
    params = _np(init_mlp(jax.random.PRNGKey(0), [784, 256, 256, 10]))
    init_distributed(init_method=f"file://{tmp_path / 'store'}",
                     world_size=1, rank=0, device="cpu")
    try:
        from chainermn_tpu_torch.models import mlp_params_from_jax

        args = port_example.parse_args(
            ["--epoch", "2", "--device", "cpu", "--out",
             str(tmp_path / "port")])
        got = port_example.train(args, mlp_params_from_jax(params, "cpu"),
                                 quiet=True).log
    finally:
        torch.distributed.destroy_process_group()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["epoch"], g["iteration"]) == (w["epoch"], w["iteration"])
        for k in ("main/loss", "validation/loss", "validation/accuracy"):
            assert abs(g[k] - w[k]) <= 1e-5, (k, g[k], w[k])


def test_modules_wrap_the_functions(jax_resnet):
    from chainermn_tpu_torch.links import (
        BatchNormState,
        MultiNodeBatchNormalization,
        multi_node_batch_normalization,
    )
    from chainermn_tpu_torch.models import (
        MLP,
        ResNet,
        init_mlp_numpy,
        mlp_apply,
        mlp_params_from_jax,
    )

    _, params, state = jax_resnet
    cfg = ResNetConfig(**RESNET)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    tp, ts = resnet_params_from_jax(params, state, cfg, device="cpu")
    want, want_state = resnet_apply(cfg, tp, ts, x)
    net = ResNet(cfg, *resnet_params_from_jax(params, state, cfg,
                                              device="cpu"))
    assert sum(p.numel() for p in net.parameters()) == sum(
        t.numel() for t in pytree.tree_leaves(tp))
    torch.testing.assert_close(net(x), want, rtol=0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(net.state), pytree.tree_leaves(want_state)))
    net.eval()
    with torch.no_grad():
        torch.testing.assert_close(
            net(x), resnet_apply(cfg, tp, want_state, x, train=False)[0])

    bn = MultiNodeBatchNormalization(5)
    h = torch.randn(4, 5, 3, 3)
    y, s = multi_node_batch_normalization(
        {"gamma": torch.ones(5), "beta": torch.zeros(5)},
        BatchNormState(torch.zeros(5), torch.ones(5),
                       torch.tensor(0, dtype=torch.int32)), h)
    torch.testing.assert_close(bn(h), y)
    assert torch.equal(bn.avg_var, s.var) and int(bn.avg_n) == 1

    layers = mlp_params_from_jax(init_mlp_numpy([6, 4, 3], 0), "cpu")
    xm = torch.randn(2, 6)
    torch.testing.assert_close(MLP(layers)(xm), mlp_apply(layers, xm))
