"""The port's training path against the JAX package's on shared weights
(``init_transformer``, handed over as numpy): ``lm_loss`` and its
gradients against ``jax.grad(lm_loss)`` inside ``shard_map`` on a
one-device mesh, and ``make_train_step`` with the port's ``sgd``/``adamw``
against the JAX ``make_train_step`` with ``optax.sgd``/``optax.adamw``.

``attention="flash"`` reaches the Pallas kernels (forward and both
backward kernels) in interpret mode on the JAX side, and the kernels'
plain versions on the port's CPU path.  Everything is fp32, so the two
packages differ only in summation order: losses agree to 1e-5 relative,
gradients to rtol 1e-4 / atol 1e-6 (gradient entries are 1e-4..1e-1),
and updated parameters to rtol 1e-4 / atol 1e-6.  AdamW divides each
gradient entry by its own running magnitude, so an entry whose gradient
is far below the rest (3e-6 where the median is 5e-4) moves by
``m̂/√v̂`` ratios that summation-order differences of a few ulps
decide: after three steps at lr 1e-2 parameters agree to atol 5e-5
(0.5 % of the learning rate), while the losses still agree to 1e-5.
In bf16 both packages round every activation and its gradient, each
in its own order, so the port's bf16 gradients are held to the JAX
package's own bf16 error against fp32 (several percent at this size),
not to the JAX bf16 gradients.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import init_transformer, shard_params
from chainermn_tpu.models import make_train_step as jax_train_step
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu.models.transformer import param_specs
from chainermn_tpu.parallel import MeshConfig
from chainermn_tpu_torch import training
from chainermn_tpu_torch.models import (
    TransformerConfig,
    lm_loss,
    make_train_step,
    make_value_and_grad_fn,
    params_from_jax,
    params_to_numpy,
)
from test_torch_world import fsdp_step_matches_dense

VOCAB, BATCH, T = 64, 4, 16
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def configs(**kw):
    base = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, n_layers=2, max_seq=T, attention="flash",
                dtype="float32", remat=False)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def jax_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        init_transformer(jax.random.PRNGKey(seed), jcfg))


def batch(seed=0):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (BATCH, T + 1)) \
        .astype(np.int32)
    return toks[:, :T], toks[:, 1:]


def one_device():
    return MeshConfig(data=1, devices=jax.devices()[:1])


def jax_value_and_grad(jcfg, tree, x, y):
    # make_train_step's GPipe grad body: the loss pmean'd over the
    # batch-like axes (all of size 1 here) inside the differentiated
    # function
    spec = P(("data", "expert"), "seq")
    specs = param_specs(jcfg)
    fn = jax.jit(jax.shard_map(
        lambda p, xx, yy: jax.value_and_grad(
            lambda q: jax.lax.pmean(jax_lm_loss(jcfg, q, xx, yy),
                                    ("data", "expert", "seq")))(p),
        mesh=one_device().mesh, in_specs=(specs, spec, spec),
        out_specs=(P(), specs)))
    loss, grads = fn(tree, x, y)
    return float(loss), jax.tree.map(np.asarray, grads)


def assert_trees_close(got, want, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **tol),
                 got, want)


LOSS_CASES = [
    dict(attention="flash"),
    dict(attention="flash", pos_embedding="rope", loss_chunk=8, remat=True),
    dict(attention="local", loss_chunk=4),
    dict(attention="local", pos_embedding="rope", remat=True),
]


@pytest.mark.parametrize("kw", LOSS_CASES, ids=[str(c) for c in LOSS_CASES])
def test_loss_and_grads_match_jax(kw):
    jcfg, cfg = configs(**kw)
    tree = jax_tree(jcfg)
    x, y = batch()
    want_loss, want_grads = jax_value_and_grad(jcfg, tree, x, y)
    params = params_from_jax(tree, cfg, device="cpu")
    loss, grads = make_value_and_grad_fn(cfg, device="cpu")(params, x, y)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert_trees_close(params_to_numpy(grads, cfg), want_grads, **GRAD_TOL)
    # the value-and-grad function reads params and leaves them alone
    assert_trees_close(params_to_numpy(params, cfg), tree, rtol=0, atol=0)
    assert not any(p.requires_grad for p in params["blocks"].values())


def tree_rel_err(a, b):
    num = sum(float(((x - y) ** 2).sum()) for x, y in
              zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    return (num / sum(float((y ** 2).sum())
                      for y in jax.tree.leaves(b))) ** 0.5


def test_bf16_gradients_as_close_to_fp32_as_jax():
    jcfg32, _ = configs(attention="local")    # fp32 flash == local here
    jcfg16, cfg16 = configs(dtype="bfloat16")
    tree = jax_tree(jcfg32)
    x, y = batch(5)
    _, exact = jax_value_and_grad(jcfg32, tree, x, y)
    _, jax16 = jax_value_and_grad(jcfg16, tree, x, y)
    _, port16 = make_value_and_grad_fn(cfg16, device="cpu")(
        params_from_jax(tree, cfg16, device="cpu"), x, y)
    err_jax = tree_rel_err(jax16, exact)
    err_port = tree_rel_err(params_to_numpy(port16, cfg16), exact)
    assert 0 < err_port < 1.5 * err_jax + 5e-3, (err_port, err_jax)


@pytest.mark.parametrize("kw", [dict(), dict(loss_chunk=8)])
def test_remat_does_not_change_gradients(kw):
    _, cfg = configs(**kw)
    params = params_from_jax(jax_tree(configs()[0], 1), cfg, device="cpu")
    x, y = batch(1)
    plain = make_value_and_grad_fn(cfg, device="cpu")(params, x, y)
    remat = make_value_and_grad_fn(dataclasses.replace(cfg, remat=True),
                                   device="cpu")(params, x, y)
    torch.testing.assert_close(remat[0], plain[0], rtol=0, atol=0)
    assert_trees_close(params_to_numpy(remat[1], cfg),
                       params_to_numpy(plain[1], cfg), rtol=0, atol=0)


def test_lm_loss_is_mean_cross_entropy():
    _, cfg = configs(attention="local")
    params = params_from_jax(jax_tree(configs()[0]), cfg, device="cpu")
    x, y = batch(2)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    from chainermn_tpu_torch.models import transformer_forward

    logits = transformer_forward(cfg, params, x)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, VOCAB), y.reshape(-1).long())
    torch.testing.assert_close(lm_loss(cfg, params, x, y), want,
                               rtol=1e-6, atol=1e-6)


def run_jax_steps(jcfg, opt, n, x, y):
    mc = one_device()
    params = shard_params(mc, jcfg, init_transformer(jax.random.PRNGKey(0),
                                                     jcfg))
    state = jax.jit(opt.init)(params)
    step = jax_train_step(mc, jcfg, opt)
    losses = []
    for _ in range(n):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def run_port_steps(jcfg, cfg, opt, n, x, y):
    params = params_from_jax(jax_tree(jcfg), cfg, device="cpu")
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu")
    losses = []
    for _ in range(n):
        out, state, loss = step(params, state, x, y)
        assert out is params            # updated in place
        losses.append(float(loss))
    return losses, params_to_numpy(params, cfg)


def test_sgd_step_matches_jax():
    jcfg, cfg = configs()
    x, y = batch(3)
    want_losses, want = run_jax_steps(jcfg, optax.sgd(0.1), 1, x, y)
    losses, got = run_port_steps(jcfg, cfg, training.sgd(0.1), 1, x, y)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert_trees_close(got, want, rtol=1e-4, atol=1e-6)


def test_adamw_steps_match_jax():
    jcfg, cfg = configs(attention="local", pos_embedding="rope")
    x, y = batch(4)
    want_losses, want = run_jax_steps(jcfg, optax.adamw(1e-2), 3, x, y)
    losses, got = run_port_steps(jcfg, cfg, training.adamw(1e-2), 3, x, y)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert_trees_close(got, want, rtol=1e-4, atol=5e-5)


def test_adamw_decays_every_leaf_at_optax_default():
    # zero gradients: AdamW's step is the decay alone, p − lr·(1e-4·p),
    # optax.adamw's own arithmetic on every leaf
    _, cfg = configs()
    params = params_from_jax(jax_tree(configs()[0]), cfg, device="cpu")
    before = params_to_numpy(params, cfg)
    opt = training.adamw(0.5)
    state = opt.init(params)
    grads = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                 if isinstance(v, dict) else torch.zeros_like(v))
             for k, v in params.items()}
    opt.update(grads, state, params)
    tx = optax.adamw(0.5)
    ref = jax.tree.map(jax.numpy.asarray, before)
    upd, _ = tx.update(jax.tree.map(jax.numpy.zeros_like, ref), tx.init(ref), ref)
    assert_trees_close(params_to_numpy(params, cfg),
                       optax.apply_updates(ref, upd), rtol=1e-7, atol=0)


def test_optimizer_refuses_other_params():
    _, cfg = configs()
    tree = jax_tree(configs()[0])
    a = params_from_jax(tree, cfg, device="cpu")
    b = params_from_jax(tree, cfg, device="cpu")
    opt = training.sgd(0.1)
    state = opt.init(a)
    step = make_train_step(cfg, opt, device="cpu")
    x, y = batch()
    with pytest.raises(ValueError, match="other parameter tensors"):
        step(b, state, x, y)


# remat_policy="dots", the ring, Ulysses, the zigzag layout,
# vocab_parallel, micro-batches, the pipeline schedules, MoE and FSDP are
# ported (test_torch_lm_data_parallel.py, test_torch_sequence_parallel.py,
# test_torch_tensor_parallel.py, test_torch_pipeline.py,
# test_torch_expert_parallel.py, test_torch_fsdp.py); their places here
# hold FSDP beside them
MOE_TRAINING = [dict(virtual_pipe=2, pipeline_schedule="interleaved",
                     moe=True),
                dict(pipeline_schedule="interleaved", moe=True),
                dict(moe=True), dict(num_microbatches=2, moe=True)]


@pytest.mark.parametrize("kw", [
    dict(virtual_pipe=2, pipeline_schedule="interleaved", moe=True,
         fsdp=True),
    dict(pipeline_schedule="1f1b", fsdp=True),
    dict(pipeline_schedule="interleaved", moe=True, fsdp=True),
    dict(moe=True, fsdp=True), dict(fsdp=True),
    dict(vocab_parallel=True, num_microbatches=2, fsdp=True),
    dict(attention="ring", remat=True, remat_policy="dots", fsdp=True),
    dict(num_microbatches=2, moe=True, fsdp=True),
])
def test_unported_training_options_raise(kw):
    # FSDP at one data member: the same config's steps, bit for bit
    _, cfg = configs(**kw)
    assert cfg.fsdp
    losses, dense, same = fsdp_step_matches_dense(cfg)
    assert losses == dense and same


@pytest.mark.parametrize("kw", MOE_TRAINING)
def test_moe_training_options_now_run(kw):
    # the options that raised beside MoE: a step on one device, whose
    # loss (the schedule's, the balancing loss in it) is lm_loss's
    jcfg, cfg = configs(**dict(dict(attention="local"), **kw))
    params = params_from_jax(jax_tree(jcfg), cfg, device="cpu")
    x, y = batch()
    want = lm_loss(cfg, params, torch.as_tensor(x), torch.as_tensor(y))
    opt = training.adamw(1e-3)
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu")
    _, _, loss = step(params, state, x, y)
    torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=0)
    _, _, after = step(params, state, x, y)
    assert torch.isfinite(after) and float(after) != float(loss)


def test_unported_optimizer_options_raise():
    # adamw(mu_dtype=...) is ported (held against optax in
    # test_torch_large_batch.py): the first moment is kept in bf16
    opt = training.adamw(3e-4, mu_dtype="bfloat16")
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    opt.update({"w": torch.ones(3)}, state, params)
    st = state.state[params["w"]]
    assert st["mu"].dtype == torch.bfloat16 and st["nu"].dtype == torch.float32
    assert int(st["count"]) == 1 and bool((params["w"] < 1).all())
