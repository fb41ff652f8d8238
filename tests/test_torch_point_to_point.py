"""The port's point-to-point transfers and ``MultiNodeChainList`` against
the JAX package's, and its model-parallel MNIST example.

The port runs one 4-process gloo world for the whole module
(``test_torch_world.battery_point_to_point``); the JAX package runs
``chainermn_tpu.ops.point_to_point`` and its ``MultiNodeChainList``
under ``shard_map`` on 4 of the 8 virtual CPU devices.  Rank ``r``'s
tensor is the JAX world-stacked array's ``[r]``.  The transfers are pure
moves, so their outputs and gradients must match bitwise.  The chains'
outputs, losses and the owners' reduced gradients, with the JAX
package's weights carried by ``chain_params_from_jax``, match within
rel 1e-6 (elementwise for outputs and losses, relative L2 a gradient
tensor: XLA and torch round an fp32 tanh or product an ulp apart here
and there; the port's output broadcast sums the ranks' cotangents where
JAX's ``psum`` transpose does not; ``reduce_grads`` divides by the
world).  The example runs 2 iterations in each 2-rank half of the world
(pipe=2, data=1) and must equal a plain sequential run of the same MLP.
"""

import collections
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import ops as J
from chainermn_tpu.links import MultiNodeChainList as JaxChain
from test_torch_world import (
    CHAIN_ERRORS,
    CHAINS,
    P2P_CASES,
    chain_apply,
    run_world,
)

N = 4
AX = "x"
ROOT = Path(__file__).resolve().parent.parent


def _mesh():
    return Mesh(np.asarray(jax.devices()[:N]), (AX,))


def _smap(fn, in_specs=P(AX), out_specs=P(AX)):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(), in_specs=in_specs,
                                 out_specs=out_specs))


def _jax_chain(spec):
    mn = JaxChain(axis_name=AX, broadcast_output=spec["broadcast"])
    for i, (kind, owner, rank_in, rank_out, (d_in, d_out)) in enumerate(
            spec["comps"]):
        def init(key, d_in=d_in, d_out=d_out, i=i):
            rng = np.random.RandomState(10 + i)
            return {"w": jnp.asarray(rng.randn(d_in, d_out).astype(
                        np.float32) * 0.5),
                    "b": jnp.asarray(rng.randn(d_out).astype(
                        np.float32) * 0.1)}
        mn.add_link(init, chain_apply(kind, jnp.tanh), owner=owner,
                    rank_in=rank_in, rank_out=rank_out, name=kind)
    return mn


def _sequential_grads(spec, params, x):
    """The gradients of ``sum(y ** 2)`` for the chain run as one plain
    program: every component in declaration order on the messages sent
    to it, FIFO a (source, dest) pair."""
    def as_list(r):
        return [] if r is None else [r] if isinstance(r, int) else list(r)

    def loss(ps):
        channels = collections.defaultdict(collections.deque)
        for (kind, owner, rank_in, rank_out, _), q in zip(spec["comps"], ps):
            ins = [x] if rank_in is None else [
                channels[(src, owner)].popleft() for src in as_list(rank_in)]
            y = chain_apply(kind, jnp.tanh)(q, *ins)
            for dst in as_list(rank_out):
                channels[(owner, dst)].append(y)
        return jnp.sum(y ** 2)

    return jax.grad(loss)(params)


def _rel(a, b):
    """Relative L2 error of ``a`` against ``b``: XLA's and torch's fp32
    tanh and matmul round differently, by an ulp here and there."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _payload():
    rng = np.random.RandomState(7)
    chain_params, chain_x = {}, {}
    for name, spec in CHAINS.items():
        params = _jax_chain(spec).init(jax.random.key(0))
        chain_params[name] = jax.tree.map(np.asarray, params)
        chain_x[name] = rng.randn(*spec["x"]).astype(np.float32)
    return dict(x=rng.randn(N, 3, 2).astype(np.float32),
                w=rng.randn(N, 3, 2).astype(np.float32),
                chain_params=chain_params, chain_x=chain_x)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    p = _payload()
    return p, run_world(tmp_path_factory.mktemp("p2p"), N,
                        "battery_point_to_point", p)


@pytest.mark.parametrize("name", sorted(P2P_CASES))
def test_transfer_matches_jax_bitwise(world, name):
    p, got = world
    op, kw = P2P_CASES[name]
    kw = {k: (v if k != "perm" else [tuple(e) for e in v])
          for k, v in kw.items()}
    fn = getattr(J, op)

    def loss(xs):
        y = _smap(lambda s: fn(s[0], AX, **kw)[None])(xs)
        return jnp.sum(y * p["w"]), y

    (_, want), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(p["x"]))
    for r in range(N):
        y, gx = got[r]["ops"][name]
        np.testing.assert_array_equal(y, np.asarray(want)[r])
        np.testing.assert_array_equal(gx, np.asarray(grad)[r])


def test_pseudo_connect_sender_gets_its_gradient(world):
    """Rank 0 only sends and uses nothing it received; the tie still
    runs the transfer's backward on both sides (the JAX package's
    ``test_pseudo_connect_keeps_transfer_alive``)."""
    p, got = world

    def loss(xs):
        def inner(s):
            phi = J.send(s, AX, dest=1, source=0)
            y = J.pseudo_connect(phi, s * 2.0)
            w = (jax.lax.axis_index(AX) + 1.0).astype(y.dtype)
            return jnp.sum(y * w)[None]
        return _smap(inner)(xs).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(p["x"])))
    for r in range(N):
        np.testing.assert_array_equal(got[r]["pseudo_connect"], want[r])
        np.testing.assert_array_equal(want[r], 2.0 * (r + 1.0))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_jax(world, name):
    """Forward, loss and the owners' reduced gradients of each graph:
    a 3-stage sequence, the same without the output broadcast, the
    branch/join DAG, two messages on one pair, and self-sends."""
    p, got = world
    spec = CHAINS[name]
    mn = _jax_chain(spec)
    params = jax.tree.map(jnp.asarray, p["chain_params"][name])
    x = jnp.asarray(p["chain_x"][name])

    def step(ps, xs):
        def dist_loss(q):
            y = mn.apply(q, xs)
            return jnp.sum(y ** 2), y
        (loss, y), g = jax.value_and_grad(dist_loss, has_aux=True)(ps)
        return loss[None], y[None], mn.reduce_grads(g)

    losses, ys, grads = _smap(step, in_specs=(P(), P()),
                              out_specs=(P(AX), P(AX), P()))(params, x)
    final = spec["comps"][-1][1]
    want_y = np.asarray(ys)[final]
    # without the output broadcast the JAX package's reduce_grads psums
    # gradients that vma-typed shard_map AD has already summed over the
    # axis (replicated parameters), so its gradients are N times the
    # plain sequential ones; the port's are the sequential ones (ROADMAP
    # Queue C).  Both are held against the sequential gradients below.
    scale = 1.0 if spec["broadcast"] else float(N)
    plain = _sequential_grads(spec, params, x)
    for r in range(N):
        y, port_loss, port_grads = got[r]["chains"][name]
        if spec["broadcast"] or r == final:
            np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(port_loss, float(losses[r]),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(y, np.zeros_like(want_y))
        for i, (_, owner, *_rest) in enumerate(spec["comps"]):
            if owner != r:
                assert port_grads[i] is None
                continue
            for k in ("w", "b"):
                seq = np.asarray(plain[i][k])
                assert np.abs(seq).max() > 0
                assert _rel(np.asarray(grads[i][k]), scale * seq) <= 1e-6
                assert _rel(port_grads[i][k], seq) <= 1e-6, (i, k)
                want = np.asarray(grads[i][k]) / scale
                assert _rel(port_grads[i][k], want) <= 1e-6, (i, k)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_sends_shapes_once_per_shape_of_x(world, name):
    """A second forward on an ``x`` of a shape already seen posts no
    object message and gives the same output, its gradients adding up
    to twice the first; an ``x`` of a new shape exchanges the shapes
    again and gives the first rows."""
    _, got = world
    final = CHAINS[name]["comps"][-1][1]
    for r in range(N):
        y, _, grads = got[r]["chains"][name]
        again, new_shape, same_y, grads2, y_first = \
            got[r]["chain_cache"][name]
        assert again == 0 and new_shape > 0 and same_y
        for g, g2 in zip(grads, grads2):
            assert (g is None) == (g2 is None)
            for k in g or ():
                np.testing.assert_array_equal(g2[k], 2.0 * g[k])
        if CHAINS[name]["broadcast"] or r == final:
            np.testing.assert_allclose(y_first, y[:1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,match", [("unconsumed", "unconsumed"),
                                        ("missing", "no pending message")])
def test_chain_errors_match_jax(world, name, match):
    _, got = world
    spec = dict(broadcast=True, comps=CHAIN_ERRORS[name])
    mn = _jax_chain(spec)
    params = mn.init(jax.random.key(0))
    with pytest.raises(ValueError, match=match):
        _smap(lambda xs: mn.apply(params, xs), in_specs=P(),
              out_specs=P())(np.zeros((2, 4), np.float32))
    for r in range(N):
        assert got[r]["errors"][name] is not None
        assert match in got[r]["errors"][name]


def test_model_parallel_example_equals_sequential(world):
    """Two iterations of the model-parallel example in each 2-rank half
    (pipe=2, data=1) against the same MLP run sequentially in this
    process: same losses, and every rank of a half reports them."""
    _, got = world
    sys.path.insert(0, str(ROOT / "examples" / "mnist"))
    from train_mnist_torch import make_dataset

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        init_mlp_numpy, mlp_apply, softmax_cross_entropy)

    lower = [{k: torch.tensor(v) for k, v in layer.items()}
             for layer in init_mlp_numpy([784, 256, 256], 0)]
    upper = [{k: torch.tensor(v) for k, v in layer.items()}
             for layer in init_mlp_numpy([256, 10], 1)]
    params = [lower, upper]
    for leaf in (t for part in params for layer in part
                 for t in layer.values()):
        leaf.requires_grad_(True)
    opt = training.sgd(0.05)
    state = opt.init(params)
    train, _ = make_dataset()
    xs = np.stack([x for x, _ in train])
    ys = np.stack([y for _, y in train])
    perm = np.random.RandomState(0).permutation(len(xs))
    want = []
    for i in range(2):
        idx = perm[i * 128:(i + 1) * 128]
        x, y = torch.tensor(xs[idx]), torch.tensor(ys[idx])
        loss = softmax_cross_entropy(mlp_apply(upper, mlp_apply(lower, x)),
                                     y)
        leaves = [t for part in params for layer in part
                  for t in layer.values()]
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        opt.update([[{k: next(it) for k in layer} for layer in part]
                    for part in params], state, params)
        want.append(float(loss))
    coords = sorted(g["example"]["coords"] for g in got)
    assert coords == [(0, 0), (0, 0), (1, 0), (1, 0)]
    for r in range(N):
        ex = got[r]["example"]
        assert len(ex["losses"]) == 2
        np.testing.assert_allclose(ex["losses"], want, rtol=1e-6)
        assert 0.0 <= ex["epochs"][0]["validation/accuracy"] <= 1.0
