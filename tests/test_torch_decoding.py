"""The port's greedy KV-cache generation against the JAX package's
``make_generate_fn`` on shared weights, in fp32: tokens must be
identical.  The port's per-step decode logits are also held against the
JAX full forward over the generated sequence ("prefill plus decode
equals the full forward"), to 1e-4: fp32 on both sides, differing only
in summation order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import init_transformer
from chainermn_tpu.models import make_forward_fn as jax_fwd
from chainermn_tpu.models import make_generate_fn as jax_gen
from chainermn_tpu.parallel import MeshConfig
from chainermn_tpu_torch.models import (
    TransformerConfig,
    make_generate_fn,
    params_from_jax,
)

VOCAB, BATCH, PLEN, MAX_LEN = 64, 3, 6, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: its decode steps are many small
    ops, which a thread pool only slows (and under a busy machine's
    other test workers, by far)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(**kw):
    base = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, n_layers=2, max_seq=MAX_LEN,
                attention="local", dtype="float32", remat=False)
    base.update(kw)
    jcfg = JaxConfig(**base)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray,
                        init_transformer(jax.random.PRNGKey(1), jcfg))
    return jcfg, cfg, tree, params_from_jax(tree, cfg, device="cpu")


def prompt(seed=0):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (BATCH, PLEN)).astype(np.int32)


def one_mesh():
    return MeshConfig(data=1, devices=jax.devices()[:1])


def test_greedy_matches_jax_and_full_forward():
    jcfg, cfg, tree, params = setup()
    p = prompt()
    ref = np.asarray(jax_gen(one_mesh(), jcfg, max_len=MAX_LEN)(tree, p))
    toks, logits = make_generate_fn(cfg, max_len=MAX_LEN, with_logits=True,
                                    device="cpu")(params, p)
    np.testing.assert_array_equal(toks.numpy(), ref)
    # step i consumed position PLEN-1+i; the full forward's logits there
    full = np.asarray(jax_fwd(one_mesh(), jcfg)(tree, ref))
    np.testing.assert_allclose(logits.numpy(), full[:, PLEN - 1:-1],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(pos_embedding="rope", n_kv_heads=0),
                                dict(attention_window=4)])
def test_left_padded_prompts_match_jax(kw):
    jcfg, cfg, tree, params = setup(**kw)
    p = prompt(1)
    lens = np.array([PLEN, 2, 4], np.int32)
    ref = np.asarray(jax_gen(one_mesh(), jcfg, max_len=MAX_LEN)(
        tree, p, prompt_lens=lens))
    out = make_generate_fn(cfg, max_len=MAX_LEN, device="cpu")(
        params, p, prompt_lens=lens)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_eos_row_state_matches_jax():
    jcfg, cfg, tree, params = setup(pos_embedding="rope")
    p = prompt(2)
    plain = make_generate_fn(cfg, max_len=MAX_LEN, device="cpu")(params, p)
    # eos = a token row 0 generates mid-way, so the early stop really runs
    eos = int(plain[0, PLEN + 3])
    kw = dict(max_len=MAX_LEN, eos_id=eos, pad_id=VOCAB - 1,
              with_row_state=True)
    ref = [np.asarray(x) for x in jax_gen(one_mesh(), jcfg, **kw)(tree, p)]
    out = [x.numpy() for x in
           make_generate_fn(cfg, device="cpu", **kw)(params, p)]
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got, want)
    toks, done, gen_len = out
    assert done[0] and gen_len[0] <= 4
    n = gen_len[0]
    assert toks[0, PLEN + n - 1] == eos
    assert np.all(toks[0, PLEN + n:] == VOCAB - 1)


def test_validation_and_unported_options():
    # sampling is item 12; int8 weights and the int8 KV cache are ported
    # (test_torch_quantized_decoding.py): they build, and the int8 tree
    # is asked for
    _, cfg, _, params = setup()
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        make_generate_fn(cfg, temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="int8 tree"):
        make_generate_fn(cfg, quantized=True, device="cpu")(params,
                                                            prompt())
    kv8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    out = make_generate_fn(kv8, max_len=MAX_LEN, device="cpu")(params,
                                                               prompt())
    assert out.shape == (BATCH, MAX_LEN)
    with pytest.raises(ValueError, match="max_len"):
        make_generate_fn(cfg, max_len=MAX_LEN + 1, device="cpu")
    with pytest.raises(ValueError, match="eos_id"):
        make_generate_fn(cfg, eos_id=VOCAB, device="cpu")
    gen = make_generate_fn(cfg, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="prompt_lens"):
        gen(params, prompt(), prompt_lens=[PLEN, 0, 1])
