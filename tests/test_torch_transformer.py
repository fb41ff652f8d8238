"""The port's scoring forward against the JAX package's ``make_forward_fn``
on shared weights (initialised by ``init_transformer``, handed over as
numpy).

The JAX side runs on a one-device mesh; ``attention="flash"`` reaches the
Pallas kernel in interpret mode there, and the port's CPU path runs the
kernel's plain version.  Tolerances: in fp32 the two packages differ
only in summation order, so logits agree to 1e-4.  In bf16 every
activation is rounded to bf16 (relative 2^-9 per rounding) at points
that the two frameworks place alike but sum in other orders; over two
layers that leaves logits of magnitude ~0.5 within 2e-2.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import init_transformer, make_forward_fn as jax_fwd
from chainermn_tpu.parallel import MeshConfig
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_forward_fn,
    params_from_jax,
)
from test_torch_world import one_thread

VOCAB, BATCH, T = 128, 2, 32


def configs(**kw):
    base = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=128, n_layers=2, max_seq=T,
                attention="flash", dtype="float32", remat=False)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        init_transformer(jax.random.PRNGKey(seed), jcfg))


def tokens(seed=0, t=T):
    return np.random.RandomState(seed).randint(0, VOCAB, (BATCH, t)) \
        .astype(np.int32)


def both_logits(jcfg, cfg, toks):
    tree = jax_params(jcfg)
    one = MeshConfig(data=1, devices=jax.devices()[:1])
    ref = np.asarray(jax_fwd(one, jcfg)(tree, toks))
    out = make_forward_fn(cfg, device="cpu")(
        params_from_jax(tree, cfg, device="cpu"), toks)
    return out, ref


FP32_CASES = [
    dict(attention="flash"),
    dict(attention="flash", pos_embedding="rope", attention_window=8,
         n_kv_heads=0),
    dict(attention="local", pos_embedding="rope"),
    dict(attention="local", attention_window=8, n_kv_heads=0),
    # d_head 8 fails the port's kernel gate (the JAX one still passes):
    # the port falls back to local attention and must agree all the same
    dict(attention="flash", d_head=8),
]


@pytest.mark.parametrize("kw", FP32_CASES, ids=[str(c) for c in FP32_CASES])
def test_forward_matches_jax_fp32(kw):
    jcfg, cfg = configs(**kw)
    out, ref = both_logits(jcfg, cfg, tokens())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_forward_matches_jax_bf16():
    jcfg, cfg = configs(dtype="bfloat16")
    out, ref = both_logits(jcfg, cfg, tokens(1))
    assert out.dtype == torch.float32     # fp32 logits from bf16 operands
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2, atol=2e-2)


def test_flash_and_local_paths_agree():
    _, cfg = configs()
    params = params_from_jax(init_numpy_params(cfg, 3), cfg, device="cpu")
    toks = tokens(2)
    flash = make_forward_fn(cfg, device="cpu")(params, toks)
    local = make_forward_fn(dataclasses.replace(cfg, attention="local"),
                            device="cpu")(params, toks)
    torch.testing.assert_close(flash, local, rtol=1e-4, atol=1e-4)


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TransformerConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    assert TransformerConfig() == TransformerConfig(
        **dataclasses.asdict(JaxConfig()))


def test_params_from_jax_round_trips():
    jcfg, cfg = configs()
    tree = jax_params(jcfg)
    params = params_from_jax(tree, cfg, device="cpu")
    for name in ("embed", "pos", "ln_f"):
        np.testing.assert_array_equal(params[name].numpy(), tree[name])
    assert set(params["blocks"]) == set(tree["blocks"])
    for name, leaf in tree["blocks"].items():
        assert leaf.shape[0] == 1            # the squeezed pipe axis
        np.testing.assert_array_equal(params["blocks"][name].numpy(),
                                      leaf[0])
    # numpy init produces the same layout
    fresh = init_numpy_params(cfg, 0)
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, tree)


def test_params_from_jax_rejects_wrong_shapes():
    jcfg, cfg = configs()
    tree = jax_params(jcfg)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, dataclasses.replace(cfg, d_ff=64),
                        device="cpu")
    _, mha = configs(n_kv_heads=0)
    with pytest.raises(ValueError, match="do not belong"):
        params_from_jax(tree, mha, device="cpu")


# vocab_parallel, micro-batches, the virtual stages, MoE and FSDP are
# ported (test_torch_tensor_parallel.py, test_torch_pipeline.py,
# test_torch_expert_parallel.py, test_torch_fsdp.py): their places hold
# FSDP beside them
MOE_FORWARD = [dict(moe=True),
               dict(attention="ring", num_microbatches=2, moe=True),
               dict(virtual_pipe=2, pipeline_schedule="interleaved",
                    moe=True)]


@pytest.mark.parametrize("kw", [
    dict(moe=True, fsdp=True), dict(fsdp=True),
    dict(vocab_parallel=True, fsdp=True),
    dict(attention="ring", num_microbatches=2, moe=True, fsdp=True),
    dict(attention="ulysses", fsdp=True),
    dict(num_microbatches=2, fsdp=True),
    dict(virtual_pipe=2, pipeline_schedule="interleaved", moe=True,
         fsdp=True),
])
def test_unported_options_raise(kw):
    # scoring under FSDP over one data member: the logits without it,
    # bit for bit (each block's gather is the weights themselves)
    _, cfg = configs(**kw)
    dense = dataclasses.replace(cfg, fsdp=False)
    params = params_from_jax(init_numpy_params(cfg, 0), cfg, device="cpu")
    got, want = (one_thread(lambda c=c: make_forward_fn(c, device="cpu")(
        params, tokens())) for c in (cfg, dense))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", MOE_FORWARD)
def test_moe_options_now_run(kw):
    # the options that raised beside MoE: the MoE forward on one device
    # against the JAX one (plain attention, the flash path's parity is
    # above)
    jcfg, cfg = configs(**dict(dict(attention="local"), **kw))
    out, ref = both_logits(jcfg, cfg, tokens())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)

