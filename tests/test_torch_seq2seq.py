"""The port's seq2seq NMT, ``adam`` and the seq2seq example against the
JAX package's (the counterparts of ``tests/model_tests/test_seq2seq.py``
and of ``examples/seq2seq/seq2seq.py``).

The same numpy parameters and ragged batches go through both packages
on the CPU in fp32.  Tolerances: the loss and every gradient leaf to
1e-5 relative (of the leaf's largest element; the packages sum the
products in other orders); padding columns change the port's loss by
at most 1e-6 relative; greedy tokens equal; ``adam`` against
``optax.adam`` bitwise (the same rule in the same rounding), and under
ZeRO-1/2 at world 1 bitwise the plain rule; a 5-step ``adam`` run's
losses to 1e-5 relative and parameters to 1e-5 absolute; the example's
data bitwise, and its epoch losses against the JAX example's to 1e-4
relative (29 ``adam`` steps from the same weights).  The port's side
runs on one torch thread.
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

from chainermn_tpu.models import seq2seq as js
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import (
    LoopbackCommunicator,
    init_distributed,
)
from chainermn_tpu_torch.models import (
    Seq2seqConfig,
    init_seq2seq,
    init_seq2seq_numpy,
    seq2seq_loss,
    seq2seq_params_from_jax,
    tree_to_numpy,
    seq2seq_translate,
)
from chainermn_tpu_torch.models.seq2seq import EOS, PAD

ROOT = Path(__file__).resolve().parent.parent
KW = dict(src_vocab=20, tgt_vocab=20, d_embed=16, d_hidden=16, n_layers=2)
CFG, JCFG = Seq2seqConfig(**KW), js.Seq2seqConfig(**KW)
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: an LSTM step is many small
    ops, which a thread pool only slows (and under a busy machine's
    other test workers, by far)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ragged_batch(n, max_len=8, seed=0):
    """The JAX test's ragged reverse-task batch (numpy)."""
    rng = np.random.RandomState(seed)
    src = np.full((n, max_len), PAD, np.int32)
    tgt = np.full((n, max_len + 1), PAD, np.int32)
    for i in range(n):
        ln = rng.randint(2, max_len + 1)
        s = rng.randint(3, 20, size=ln)
        src[i, :ln] = s
        tgt[i, :ln] = s[::-1]
        tgt[i, ln] = EOS
    return src, tgt


def _jax_tree(seed=0):
    return jax.tree.map(np.asarray,
                        js.init_seq2seq(jax.random.PRNGKey(seed), JCFG))


def _port(tree):
    params = seq2seq_params_from_jax(tree, CFG, device="cpu")
    for leaf in pytree.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _leaf_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_loss_and_gradients_match_jax():
    tree = _jax_tree(0)
    src, tgt = ragged_batch(8)
    jl, jg = jax.value_and_grad(lambda p: js.seq2seq_loss(
        JCFG, p, jnp.asarray(src), jnp.asarray(tgt)))(
        jax.tree.map(jnp.asarray, tree))
    params = _port(tree)
    loss = seq2seq_loss(CFG, params, src, tgt)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= REL * abs(float(jl))
    got = tree_to_numpy(pytree.tree_map(lambda t: t.grad, params))
    want = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        assert _leaf_rel(g, w) <= REL


def test_loss_is_padding_invariant():
    params = _port(_jax_tree(0))
    src, tgt = ragged_batch(8)
    with torch.no_grad():
        loss = float(seq2seq_loss(CFG, params, src, tgt))
        pad = np.full((8, 4), PAD, np.int32)
        loss2 = float(seq2seq_loss(CFG, params,
                                   np.concatenate([src, pad], 1),
                                   np.concatenate([tgt, pad], 1)))
    assert np.isfinite(loss)
    assert abs(loss - loss2) <= 1e-6 * abs(loss)


def test_greedy_tokens_equal_jax():
    tree = _jax_tree(1)
    src, _ = ragged_batch(16, seed=2)
    want = np.asarray(js.seq2seq_translate(
        JCFG, jax.tree.map(jnp.asarray, tree), jnp.asarray(src),
        max_len=12))
    got = seq2seq_translate(CFG, _port(tree), src, max_len=12)
    assert got.dtype == torch.int32 and got.shape == (16, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    for row in got.numpy():              # PAD after EOS
        hit = np.where(row == EOS)[0]
        if hit.size:
            assert (row[hit[0] + 1:] == PAD).all()


def test_init_is_seeded_in_the_jax_layout():
    a, b = init_seq2seq_numpy(CFG, 3), _jax_tree(0)
    assert jax.tree.map(np.shape, a) == jax.tree.map(np.shape, b)
    np.testing.assert_array_equal(
        init_seq2seq(CFG, 3, device="cpu")["proj"]["w"].numpy(),
        a["proj"]["w"])
    assert not a["encoder"][0]["b"].any()
    with pytest.raises(ValueError, match="proj/w"):
        bad = init_seq2seq_numpy(CFG, 0)
        bad["proj"]["w"] = bad["proj"]["w"][:, :3]
        seq2seq_params_from_jax(bad, CFG, device="cpu")


def _adam_grads():
    r = np.random.RandomState(0)
    shapes = {"w": (5, 3), "b": (7,), "s": ()}
    return ({k: np.asarray(r.randn(*s), np.float32)
             for k, s in shapes.items()},
            [{k: np.asarray(r.randn(*s), np.float32)
              for k, s in shapes.items()} for _ in range(4)])


def test_adam_matches_optax_bitwise():
    params, grads = _adam_grads()
    jp = jax.tree.map(jnp.asarray, params)
    jo = optax.adam(1e-2)
    js_ = jo.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = training.adam(1e-2)
    st = opt.init(tp)
    for g in grads:
        u, js_ = jo.update(jax.tree.map(jnp.asarray, g), js_, jp)
        jp = optax.apply_updates(jp, u)
        opt.update({k: torch.tensor(v) for k, v in g.items()}, st, tp)
    for k in params:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # the state: optax's count, mu and nu
    tree = training.optimizer_state_tree(st)
    np.testing.assert_array_equal(
        tree["state"][list(params).index("w")]["mu"].numpy(),
        np.asarray(js_[0].mu["w"]))
    assert int(tree["state"][0]["count"]) == len(grads)


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_adam_under_zero_at_world_one(mode):
    params, grads = _adam_grads()
    loop = LoopbackCommunicator(device="cpu")
    runs = {}
    for name, kw in (("plain", {}), (mode, {mode: True})):
        tp = {k: torch.tensor(v) for k, v in params.items()}
        opt = training.create_multi_node_optimizer(training.adam(1e-2),
                                                   loop, **kw)
        st = opt.init(tp)
        for g in grads:
            opt.update({k: torch.tensor(v) for k, v in g.items()}, st, tp)
        runs[name] = tp
    for k in params:
        torch.testing.assert_close(runs[mode][k], runs["plain"][k],
                                   rtol=0, atol=0)


def test_five_adam_steps_match_jax():
    tree = _jax_tree(4)
    batches = [ragged_batch(8, seed=10 + i) for i in range(5)]
    jo = optax.adam(5e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jo.init(jp)
    want = []
    for src, tgt in batches:
        loss, g = jax.value_and_grad(lambda p: js.seq2seq_loss(
            JCFG, p, jnp.asarray(src), jnp.asarray(tgt)))(jp)
        u, jst = jo.update(g, jst, jp)
        jp = optax.apply_updates(jp, u)
        want.append(float(loss))
    params = _port(tree)
    opt = training.adam(5e-3)
    st = opt.init(params)
    got = []
    for src, tgt in batches:
        loss = seq2seq_loss(CFG, params, src, tgt)
        grads = torch.autograd.grad(loss, pytree.tree_leaves(params))
        opt.update(pytree.tree_unflatten(
            list(grads), pytree.tree_structure(params)), st, params)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=REL)
    for a, b in zip(jax.tree.leaves(tree_to_numpy(params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_dataset_is_bitwise_the_jax_examples():
    jex = _load("examples/seq2seq/seq2seq.py", "jax_seq2seq_example")
    pex = _load("examples/seq2seq/seq2seq_torch.py", "port_seq2seq_example")
    for a, b in zip(jex.make_dataset(), pex.make_dataset()):
        assert len(a) == len(b)
        for (s1, t1), (s2, t2) in zip(a, b):
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(t1, t2)
            assert s1.dtype == s2.dtype == np.int32
    batch = pex.make_dataset()[1][:5]
    for x, y in zip(jex.make_converter(16, 17)(batch),
                    pex.make_converter(16, 17)(batch)):
        np.testing.assert_array_equal(x, y)


def test_example_losses_match_the_jax_example(tmp_path, monkeypatch):
    jex = _load("examples/seq2seq/seq2seq.py", "jax_seq2seq_example")
    pex = _load("examples/seq2seq/seq2seq_torch.py", "port_seq2seq_example")
    argv = ["--epoch", "1", "--unit", "32"]
    logs = {}

    class Capture:
        """The JAX example's LogReport entries (its ``main`` returns the
        exact-match only)."""

    import chainermn_tpu as jcmn

    real = jcmn.LogReport

    def capture(*a, **kw):
        Capture.log = real(*a, **kw)
        return Capture.log

    monkeypatch.setattr(jcmn, "LogReport", capture)
    monkeypatch.setattr(sys, "argv", ["seq2seq.py", "--communicator",
                                      "loopback", "--out",
                                      str(tmp_path / "jax")] + argv)
    want_match = jex.main()
    logs["jax"] = Capture.log.log
    cfg = js.Seq2seqConfig(src_vocab=50, tgt_vocab=50, d_embed=32,
                           d_hidden=32, n_layers=2)
    tree = jax.tree.map(np.asarray,
                        js.init_seq2seq(jax.random.PRNGKey(0), cfg))
    init_distributed(init_method=f"file://{tmp_path / 'store'}",
                     world_size=1, rank=0, device="cpu")
    got = pex.main(argv + ["--device", "cpu", "--out",
                           str(tmp_path / "port")], init=tree, quiet=True)
    assert len(got.log) == len(logs["jax"]) == 1
    for g, w in zip(got.log, logs["jax"]):
        assert (g["epoch"], g["iteration"]) == (w["epoch"], w["iteration"])
        for k in ("main/loss", "validation/loss"):
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (k, g[k], w[k])
    assert 0.0 <= got.match <= 1.0 and abs(got.match - want_match) <= 0.05
