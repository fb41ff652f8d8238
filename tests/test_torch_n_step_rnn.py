"""The port's ``create_multi_node_n_step_rnn`` against the JAX package's
(the counterpart of ``tests/link_tests/test_n_step_rnn.py``).

The port's cases run in one 4-rank gloo world (``battery_n_step_rnn``
in ``test_torch_world.py``), started in a thread while the JAX side
computes the sequential stack (``_stage_apply`` over every stage's
layers) on the same numpy parameters and inputs.  Tolerances: the
chain's outputs against the JAX stack to 1e-5 relative and 1e-6
absolute, and bitwise the port's own sequential stack (each stage runs
the same products on the same values); the reduced gradients against
JAX's to 1e-4 relative and 1e-5 absolute (the JAX test's), and against
the port's sequential stack to 1e-6 relative (the owner sums four equal
cotangents, then divides by four).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chainermn_tpu.links import create_multi_node_n_step_rnn as jax_rnn
from chainermn_tpu.links.n_step_rnn import _stage_apply
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.links import create_multi_node_n_step_rnn

from test_torch_world import run_world

N = 4
B, T, D_IN, D_H = 4, 6, 5, 8
RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-5


def _data(seed=0, ragged=False, t=T):
    rng = np.random.RandomState(seed)
    xs = rng.randn(B, t, D_IN).astype(np.float32)
    if ragged:
        lens = rng.randint(2, t + 1, size=B)
        mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        xs = xs * mask[:, :, None]
    else:
        mask = np.ones((B, t), np.float32)
    return xs, mask


def _params(n_layers, n_stages, cell, seed):
    """Every stage's layers, from the port's initialisers (numpy)."""
    chain = create_multi_node_n_step_rnn(
        n_layers, D_IN, D_H, n_stages, cell=cell,
        comm=LoopbackCommunicator(device="cpu"))
    return [c.init(seed + i) for i, c in enumerate(chain.components)]


def _cases():
    cases = {}
    for cell in ("lstm", "gru", "tanh"):
        for ragged in (False, True):
            xs, mask = _data(ragged=ragged)
            cases[f"fwd_{cell}_{'ragged' if ragged else 'dense'}"] = dict(
                n_layers=4, n_stages=4, cell=cell, xs=xs, mask=mask,
                params=_params(4, 4, cell, 0), grad=False)
    xs, mask = _data(seed=3, ragged=True)
    cases["bwd_lstm_2"] = dict(n_layers=4, n_stages=2, cell="lstm", xs=xs,
                               mask=mask, params=_params(4, 2, "lstm", 1),
                               grad=True)
    cases["bwd_gru_4"] = dict(n_layers=4, n_stages=4, cell="gru", xs=xs,
                              mask=mask, params=_params(4, 4, "gru", 2),
                              grad=True)
    # the pad carry: a padded batch and its truncated dense version
    rng = np.random.RandomState(5)
    short = rng.randn(B, 3, D_IN).astype(np.float32)
    padded = np.concatenate(
        [short, rng.randn(B, T - 3, D_IN).astype(np.float32)], axis=1)
    pad_mask = np.concatenate([np.ones((B, 3), np.float32),
                               np.zeros((B, T - 3), np.float32)], axis=1)
    pp = _params(2, 2, "lstm", 7)
    cases["pad_long"] = dict(n_layers=2, n_stages=2, cell="lstm",
                             xs=padded, mask=pad_mask, params=pp,
                             grad=False)
    cases["pad_short"] = dict(n_layers=2, n_stages=2, cell="lstm",
                              xs=short, mask=np.ones((B, 3), np.float32),
                              params=pp, grad=False)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, tmp_path_factory.mktemp("rnn"), N,
                      "battery_n_step_rnn",
                      dict(cases=CASES, d_hidden=D_H))
    yield fut
    pool.shutdown(wait=True)


def _jax_stack(case):
    layers = [jax.tree.map(jnp.asarray, layer)
              for stage in case["params"] for layer in stage]
    return _stage_apply(layers, jnp.asarray(case["xs"]),
                        jnp.asarray(case["mask"]), case["cell"])


def _jax_grads(case):
    def loss(params):
        layers = [layer for stage in params for layer in stage]
        ys, _, _ = _stage_apply(layers, jnp.asarray(case["xs"]),
                                jnp.asarray(case["mask"]), case["cell"])
        return jnp.sum(ys ** 2)

    return jax.tree.map(np.asarray, jax.grad(loss)(
        jax.tree.map(jnp.asarray, case["params"])))


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("fwd")])
def test_forward_matches_sequential(world, name):
    case = CASES[name]
    o_ys, o_hy, o_cy = _jax_stack(case)
    for r, res in enumerate(world.result()):
        got = res[name]
        np.testing.assert_allclose(got["ys"], np.asarray(o_ys), rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        # the chain returns the LAST stage's (1-layer) final states
        np.testing.assert_allclose(got["hy"], np.asarray(o_hy[-1:]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["cy"], np.asarray(o_cy[-1:]),
                                   rtol=RTOL, atol=ATOL)
        for k in ("ys", "hy", "cy"):
            want = got["seq"][k] if k == "ys" else got["seq"][k][-1:]
            np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("name", ["bwd_lstm_2", "bwd_gru_4"])
def test_backward_matches_sequential_and_jax(world, name):
    case = CASES[name]
    want = _jax_grads(case)
    owned = 0
    for r, res in enumerate(world.result()):
        got = res[name]
        for s, g in enumerate(got["grads"]):
            if s != r:
                assert g is None      # a rank holds its own stage only
                continue
            owned += 1
            for layer, w_layer, seq_layer in zip(g, want[s],
                                                 got["seq"]["grads"][s]):
                for k in ("w", "u", "b"):
                    np.testing.assert_allclose(
                        layer[k], w_layer[k], rtol=G_RTOL, atol=G_ATOL,
                        err_msg=f"{name} stage {s} {k}")
                    np.testing.assert_allclose(
                        layer[k], seq_layer[k], rtol=1e-6, atol=1e-7)
    assert owned == case["n_stages"]


def test_mask_carries_state_through_pads(world):
    res = world.result()[0]
    long_, short = res["pad_long"], res["pad_short"]
    np.testing.assert_allclose(long_["hy"], short["hy"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(long_["cy"], short["cy"], rtol=RTOL,
                               atol=ATOL)
    # the carried h is the output at a pad step
    np.testing.assert_array_equal(long_["ys"][:, 3:],
                                  np.repeat(long_["ys"][:, 2:3], T - 3, 1))
    o_ys, o_hy, o_cy = _jax_stack(CASES["pad_long"])
    np.testing.assert_allclose(long_["cy"], np.asarray(o_cy[-1:]),
                               rtol=RTOL, atol=ATOL)


def test_uneven_layer_split():
    chain = create_multi_node_n_step_rnn(
        5, D_IN, D_H, n_stages=3, comm=LoopbackCommunicator(device="cpu"))
    params = [c.init(i) for i, c in enumerate(chain.components)]
    assert [len(p) for p in params] == [2, 2, 1]
    assert params[0][0]["w"].shape == (D_IN, 4 * D_H)
    assert params[0][1]["w"].shape == (D_H, 4 * D_H)
    want = jax_rnn(5, D_IN, D_H, n_stages=3).init(jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, want) == jax.tree.map(np.shape, params)
    assert [c.owner for c in chain.components] == [0, 1, 2]


def test_validation():
    loop = LoopbackCommunicator(device="cpu")
    with pytest.raises(ValueError, match="cell"):
        create_multi_node_n_step_rnn(2, 4, 4, 2, cell="conv", comm=loop)
    with pytest.raises(ValueError, match="n_stages"):
        create_multi_node_n_step_rnn(2, 4, 4, 3, comm=loop)
