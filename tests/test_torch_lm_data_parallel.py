"""The flagship's data-parallel training in the port against the JAX
package's: ``make_train_step(cfg, adamw, comm=...)`` on 4 gloo ranks
against the JAX ``make_train_step(MeshConfig(data=4), ...)`` on four of
the 8 virtual CPU devices, from the same weights (``init_transformer``,
handed over as numpy) on the same global batches.

Every port case runs in one 4-rank gloo world for the module
(``battery_lm_data_parallel`` in ``test_torch_world.py``).  The config
is 2 layers, d_model 64, 4 query / 2 KV heads, vocab 128, seq 32, a
global batch of 8 (2 rows a rank), 3 AdamW steps at lr 1e-3.  In fp32
the two packages differ in summation order only (the port means the
gradients after the sum, JAX sums the already-divided gradients).

Three free steps agree to 1e-5 in the loss, but their parameters need
not stay within 1e-5: AdamW's first step moves a weight whose gradient
is near ``eps`` (1e-8) by an amount those last bits decide, and a ReLU
whose input sits within that distance of zero then switches on one
trajectory and not the other (at this config the flash case's second
step has an MLP unit at +5.8e-7 in the port and -3.0e-6 in JAX, which
moves the gradient by 6e-3).  So every leaf is held to 1e-5 relative L2
step by step: each of the three port steps starts from the JAX run's
state before it (parameters, moments, count) and must land on the JAX
state after it.  In bf16 each package rounds every activation in its
own order, so the port is held to the JAX package's own bf16 error
against fp32, as ``test_torch_training.py`` holds the one-device step.
``attention="flash"`` reaches the Pallas kernels in interpret mode on
the JAX side and the kernels' plain versions on the port's CPU path.
"""

import concurrent.futures
import importlib
import types

import jax
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import init_transformer, shard_params
from chainermn_tpu.models import make_train_step as jax_train_step
from chainermn_tpu.models.transformer import _check_mesh as jax_check_mesh
from chainermn_tpu.parallel import MeshConfig
from chainermn_tpu_torch.models import (
    TransformerConfig,
    make_forward_fn,
    make_value_and_grad_fn,
)
from chainermn_tpu_torch.models.transformer import _check_mesh

from test_torch_world import fsdp_step_matches_dense, run_world

VOCAB, T, BATCH, STEPS, LR, N = 128, 32, 8, 3, 1e-3, 4
BASE = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=256, n_layers=2, max_seq=T, attention="flash",
            dtype="float32", remat=False)
CASES = {
    "local": dict(attention="local"),
    "flash": dict(),
    "flash_bf16": dict(dtype="bfloat16"),
    "dots": dict(remat=True, remat_policy="dots"),
}


def fields(name):
    return dict(BASE, **CASES[name])


def batches():
    rng = np.random.RandomState(7)
    toks = rng.randint(0, VOCAB, (STEPS, BATCH, T + 1)).astype(np.int32)
    return [(t[:, :T], t[:, 1:]) for t in toks]


_TREE = []


@pytest.fixture(scope="module")
def tree():
    _TREE.append(jax.tree.map(np.asarray, init_transformer(
        jax.random.PRNGKey(0), JaxConfig(**BASE))))
    return _TREE[0]


# the cases whose steps are also held one by one from the JAX states
FORCED = ("local", "flash", "dots")
# each case's JAX run, computed in threads (the forced cases' before the
# world starts, as its payload; the others while it runs)
_JAX_RUNS = {}
_POOL = concurrent.futures.ThreadPoolExecutor(len(CASES))


def jax_run(name):
    if name not in _JAX_RUNS:
        _JAX_RUNS[name] = _POOL.submit(_jax_run, name)
    return _JAX_RUNS[name].result()


def _jax_run(name):
    """``STEPS`` steps of the JAX step at mesh data=4: the losses, the
    final parameters, and the state before each step (parameters, adam
    moments, count) as numpy."""
    jcfg = JaxConfig(**fields(name))
    mc = MeshConfig(data=N, devices=jax.devices()[:N])
    # the module's tree: every case's parameters have BASE's shapes, so
    # init_transformer draws the same numbers for each (eagerly, in
    # seconds)
    params = shard_params(mc, jcfg, _TREE[0])
    opt = optax.adamw(LR)
    state = jax.jit(opt.init)(params)
    step = jax_train_step(mc, jcfg, opt)
    losses, before = [], []
    for x, y in batches():
        adam = state[0]
        before.append(jax.tree.map(np.asarray, (
            params, adam.mu, adam.nu, adam.count)))
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), before


@pytest.fixture(scope="module")
def port(tmp_path_factory, tree):
    for name in CASES:
        _JAX_RUNS[name] = _POOL.submit(_jax_run, name)
    payload = dict(cases=[(n, fields(n), LR) for n in CASES], tree=tree,
                   batches=batches(),
                   forced={n: jax_run(n)[2] for n in FORCED})
    return run_world(tmp_path_factory.mktemp("lm_dp"), N,
                     "battery_lm_data_parallel", payload)


def leaf_rel_errs(got, want):
    return {jax.tree_util.keystr(k): float(
        np.linalg.norm(a - b) / np.linalg.norm(b))
        for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                             jax.tree.leaves(want))}


def rel_l2(got, want):
    num = sum(float(((a - b) ** 2).sum())
              for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    return (num / sum(float((b ** 2).sum())
                      for b in jax.tree.leaves(want))) ** 0.5


def assert_ranks_bitwise(port, name):
    # every rank applied the same rule to the same mean
    first = port[0][name]["free"]
    for r in range(1, N):
        got = port[r][name]["free"]
        assert got[0] == first[0]
        jax.tree.map(np.testing.assert_array_equal, got[1], first[1])


def assert_steps_match_jax(port, name):
    """The free losses at 1e-5, and each step from the JAX state before
    it: its loss at 1e-5 and every leaf at 1e-5 relative L2."""
    losses, params = port[0][name]["free"]
    want_losses, want, before = jax_run(name)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    after = [b[0] for b in before[1:]] + [want]
    for k, ((loss, got), target) in enumerate(zip(port[0][name]["forced"],
                                                   after)):
        np.testing.assert_allclose(loss, want_losses[k:k + 1], rtol=1e-5)
        errs = leaf_rel_errs(got, target)
        assert max(errs.values()) < 1e-5, (k, errs)
    assert len(port[0][name]["forced"]) == STEPS


@pytest.mark.parametrize("name", ["local", "flash"])
def test_dp_steps_match_jax(port, name):
    assert_steps_match_jax(port, name)
    assert_ranks_bitwise(port, name)


def test_dp_bf16_steps_as_close_to_fp32_as_jax(port, tree):
    # the updates (final minus initial parameters), held against the
    # JAX fp32 run's: the port's bf16 error within the JAX package's own
    losses, params = port[0]["flash_bf16"]["free"]
    jax16_losses, jax16, _ = jax_run("flash_bf16")
    exact_losses, exact, _ = jax_run("flash")

    def update(p):
        return jax.tree.map(lambda a, b: a - b, p, tree)

    err_port = rel_l2(update(params), update(exact))
    err_jax = rel_l2(update(jax16), update(exact))
    assert 0 < err_port < 1.5 * err_jax + 5e-3, (err_port, err_jax)
    loss_port = np.abs(np.subtract(losses, exact_losses)).max()
    loss_jax = np.abs(np.subtract(jax16_losses, exact_losses)).max()
    assert loss_port < 1.5 * loss_jax + 5e-3 * abs(exact_losses[0]), \
        (loss_port, loss_jax)
    assert_ranks_bitwise(port, "flash_bf16")


def test_dp_remat_dots_matches_jax(port):
    # against "full" (bitwise): test_remat_dots_recomputes_no_flash_forward
    assert_steps_match_jax(port, "dots")
    assert_ranks_bitwise(port, "dots")


def test_remat_dots_recomputes_no_flash_forward(monkeypatch):
    # one device: "dots" runs the forward once a layer, "full" twice
    # (the recompute), and both give the same gradients bitwise
    from chainermn_tpu_torch.models import params_from_jax

    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    calls = []
    real = fa.flash_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    jcfg = JaxConfig(**BASE)
    tree = jax.tree.map(np.asarray, init_transformer(
        jax.random.PRNGKey(1), jcfg))
    x, y = batches()[0]
    out = {}
    for policy in ("full", "dots"):
        cfg = TransformerConfig(**dict(BASE, remat=True,
                                       remat_policy=policy))
        params = params_from_jax(tree, cfg, device="cpu")
        calls.clear()
        out[policy] = make_value_and_grad_fn(cfg, device="cpu")(
            params, x, y)
        out[policy] += (len(calls),)
    assert out["full"][2] == 2 * BASE["n_layers"]
    assert out["dots"][2] == BASE["n_layers"]
    torch.testing.assert_close(out["dots"][0], out["full"][0], rtol=0,
                               atol=0)
    for a, b in zip(torch.utils._pytree.tree_leaves(out["dots"][1]),
                    torch.utils._pytree.tree_leaves(out["full"][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _mesh(**axes):
    # what the JAX _check_mesh reads of a MeshConfig
    return types.SimpleNamespace(mesh=types.SimpleNamespace(shape=axes))


MESH_FAULTS = [
    (dict(model=3), dict()),
    (dict(model=4), dict(n_kv_heads=2)),
    (dict(model=2, seq=2), dict(attention="ulysses", n_heads=2,
                                n_kv_heads=0)),
    (dict(model=2), dict(vocab_parallel=True, vocab_size=127)),
    (dict(data=3), dict(fsdp=True)),
]


@pytest.mark.parametrize("axes,kw", MESH_FAULTS,
                         ids=[str(a) for a, _ in MESH_FAULTS])
def test_check_mesh_raises_as_jax(axes, kw):
    base = dict(BASE, **kw)
    with pytest.raises(ValueError) as want:
        jax_check_mesh(_mesh(**axes), JaxConfig(**base))
    with pytest.raises(ValueError) as got:
        _check_mesh(axes, TransformerConfig(**base))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", ["pipe", "model", "seq", "expert"])
def test_check_mesh_wide_axes_are_a8(axis):
    # every axis of item 8's mesh is ported: each beside data, beside the
    # expert axis and beside the others, as JAX takes them
    cfg = TransformerConfig(**BASE)
    jax_check_mesh(_mesh(**{axis: 2}), JaxConfig(**BASE))   # JAX takes it
    _check_mesh({axis: 2, "data": 2}, cfg)
    _check_mesh({axis: 2, "expert": 2}, cfg)
    _check_mesh({"seq": 2, "model": 2, "pipe": 2, "expert": 2}, cfg)
    with pytest.raises(ValueError, match="not in"):
        _check_mesh({axis: 2, "replica": 2}, cfg)
    _check_mesh({"data": 8, axis: 1}, cfg)


@pytest.mark.parametrize("kw", [
    # vocab_parallel is ported (test_torch_tensor_parallel.py), and so is
    # "dots" under Ulysses and the ring (test_torch_sequence_parallel.py):
    # their places hold them beside FSDP; MoE is ported
    # (test_torch_expert_parallel.py): its places hold it beside FSDP
    dict(moe=True, fsdp=True), dict(fsdp=True),
    dict(attention="ulysses", remat=True, remat_policy="dots", fsdp=True),
    # micro-batches and the pipeline schedules are ported
    # (test_torch_pipeline.py): their places hold them beside FSDP
    dict(num_microbatches=2, moe=True, fsdp=True),
    dict(pipeline_schedule="1f1b", fsdp=True),
    dict(pipeline_schedule="interleaved", virtual_pipe=2, moe=True,
         fsdp=True),
    dict(attention="ring", remat=True, remat_policy="dots", fsdp=True),
])
def test_unported_training_options_are_a8(kw):
    # every option of item 8 is ported: FSDP (test_torch_fsdp.py) at one
    # data member steps as the same config without it, bit for bit,
    # beside each of them
    cfg = TransformerConfig(**dict(BASE, **kw))
    assert cfg.fsdp
    losses, dense, same = fsdp_step_matches_dense(cfg)
    assert losses == dense and same


def test_forward_and_step_take_this_ranks_rows():
    # a one-member data axis: the loopback communicator; rows must divide
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import init_transformer as port_init

    comm = create_communicator("loopback", device="cpu")
    cfg = TransformerConfig(**BASE)
    params = port_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x, y = batches()[0]
    plain = make_value_and_grad_fn(cfg, device="cpu")(params, x, y)
    dp = make_value_and_grad_fn(cfg, comm=comm)(params, x, y)
    torch.testing.assert_close(dp[0], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(
        make_forward_fn(cfg, comm=comm)(params, x),
        make_forward_fn(cfg, device="cpu")(params, x), rtol=0, atol=0)
    # a communicator's device is the step's; a batch must divide
    meta = types.SimpleNamespace(device=torch.device("meta"), size=1,
                                 rank=0)
    with pytest.raises(ValueError, match="communicator runs on"):
        make_value_and_grad_fn(cfg, device="cpu", comm=meta)
    three = types.SimpleNamespace(device=torch.device("cpu"), size=3,
                                  rank=0)
    with pytest.raises(ValueError, match="does not divide"):
        make_value_and_grad_fn(cfg, comm=three)(params, x, y)
