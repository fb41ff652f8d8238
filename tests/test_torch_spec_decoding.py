"""The port's speculative, prompt-lookup and beam-search decoders against
the JAX package's, at the JAX tests' ``tiny_cfg`` size (d_model 32, 4
query / 2 KV heads, d_head 8, 2 layers, fp32), on the same numpy weights
and prompts.  Tokens and ``mean_accepted`` are held bitwise (argmaxes of
fp32 logits; the mean is the same integer count over the same rounds),
beam scores to 1e-5 relative (sums of fp32 log-probabilities that differ
in summation order only).  The port's own invariants (speculative and
lookup tokens are its greedy tokens for a dense model, beam 1 is greedy,
a padded row decodes as it does alone) are held on the port alone.  The
mesh cases run in ``test_torch_tensor_parallel.py``'s world."""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import make_beam_search_fn as jax_beam
from chainermn_tpu.models import make_lookup_generate_fn as jax_lookup
from chainermn_tpu.models import make_speculative_generate_fn as jax_spec
from chainermn_tpu.parallel import MeshConfig
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_beam_search_fn,
    make_generate_fn,
    make_lookup_generate_fn,
    make_speculative_generate_fn,
    params_from_jax,
    quantize_params_int8,
)

VOCAB, B, T, K = 64, 4, 16, 3
TINY = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, n_layers=2, max_seq=T, attention="local",
            dtype="float32", remat=False)
PAD = VOCAB - 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: its decode steps are many small
    ops, which a thread pool only slows (and under a busy machine's
    other test workers, by far)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    jcfg = JaxConfig(**dict(TINY, **kw))
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def tree_of(cfg, seed=1):
    return init_numpy_params(cfg, seed=seed)


def first_layers(tree, n):
    """The draft: the tree's first ``n`` blocks with the shared
    embedding and norms (``generate.py``'s truncated draft)."""
    return dict(tree, blocks={k: v[:, :n] for k, v in tree["blocks"].items()})


def prompt(seed=0, length=4):
    return np.random.RandomState(seed).randint(
        0, VOCAB - 1, (B, length)).astype(np.int32)


def pattern_prompt():
    """Rows that repeat a 3-token pattern: the n-gram proposer finds
    matches, so some rounds accept proposals."""
    rng = np.random.RandomState(7)
    return np.stack([np.tile(rng.randint(0, VOCAB - 1, 3), 3)
                     for _ in range(B)]).astype(np.int32)


def one():
    return MeshConfig(data=1, devices=jax.devices()[:1])


def greedy(cfg, params, p, **kw):
    return make_generate_fn(cfg, max_len=T, device="cpu", **kw)(
        params, p).numpy()


# --------------------------------------------------------------------- #
# speculative and prompt lookup
# --------------------------------------------------------------------- #

# name: (options, int8 weights, prompt_lens): the draft is the target's
# first layer; "self" drafts with the target itself (every proposal
# accepted)
SPEC = {
    "draft1_eos": (dict(), False, None),
    "self_int8_lens": (dict(), True, [4, 2, 3, 1]),
}


@pytest.mark.parametrize("name", list(SPEC))
def test_speculative_matches_jax(name):
    kw, quant, lens = SPEC[name]
    jcfg, cfg = configs()
    tree = tree_of(cfg)
    self_draft = name.startswith("self")
    d_layers = 2 if self_draft else 1
    jd, dcfg = configs(n_layers=d_layers)
    d_tree = first_layers(tree, d_layers)
    if quant:
        # the port's int8 tree is bitwise the JAX one's
        # (test_torch_quantized_decoding.py), and costs no eager JAX ops
        tree, d_tree = (quantize_params_int8(c, t)
                        for c, t in ((cfg, tree), (dcfg, d_tree)))
    p = prompt(3)
    params = params_from_jax(tree, cfg, "cpu")
    d_params = params_from_jax(d_tree, dcfg, "cpu")
    if name.endswith("eos"):
        # a token the first row generates mid-way: the early stop runs
        kw = dict(eos_id=int(greedy(cfg, params, p)[0, 7]), pad_id=PAD)
    opts = dict(k=K, max_len=T, quantized=quant, draft_quantized=quant,
                with_stats=True, **kw)
    want, w_acc = jax_spec(one(), jcfg, jd, **opts)(
        tree, d_tree, p, prompt_lens=lens)
    got, acc = make_speculative_generate_fn(cfg, dcfg, device="cpu",
                                            **opts)(
        params, d_params, p, prompt_lens=lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(acc) == float(w_acc)
    if self_draft:
        assert float(acc) > K - 1
    # the same tokens as greedy (a dense model)
    np.testing.assert_array_equal(got.numpy(), make_generate_fn(
        cfg, max_len=T, quantized=quant, device="cpu", **kw)(
        params, p, prompt_lens=lens).numpy())


# name: (prompt_lens, eos)
LOOKUP = {"eos": (None, True), "lens": ([9, 3, 6, 2], False)}


@pytest.mark.parametrize("name", list(LOOKUP))
def test_lookup_matches_jax(name):
    lens, eos = LOOKUP[name]
    jcfg, cfg = configs(pos_embedding="rope")
    tree = tree_of(cfg, seed=4)
    params = params_from_jax(tree, cfg, "cpu")
    p = pattern_prompt()
    kw = dict(k=K, ngram=2, max_len=T, with_stats=True)
    if eos:
        kw.update(eos_id=int(greedy(cfg, params, p)[1, 11]), pad_id=PAD)
    want, w_acc = jax_lookup(one(), jcfg, **kw)(tree, p, prompt_lens=lens)
    got, acc = make_lookup_generate_fn(cfg, device="cpu", **kw)(
        params, p, prompt_lens=lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(acc) == float(w_acc)
    kw.pop("with_stats"), kw.pop("k"), kw.pop("ngram")
    np.testing.assert_array_equal(got.numpy(), make_generate_fn(
        cfg, device="cpu", **kw)(params, p, prompt_lens=lens).numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_speculative_and_lookup_are_greedy(quant):
    # the port alone: a dense model's speculative and lookup tokens are
    # its greedy tokens, whatever the draft proposes (a two-layer draft
    # of another seed: few proposals accepted)
    _, cfg = configs(n_layers=3, pos_embedding="rope")
    _, dcfg = configs(n_layers=2)
    params = params_from_jax(tree_of(cfg, seed=5), cfg, "cpu")
    d_params = params_from_jax(tree_of(dcfg, seed=6), dcfg, "cpu")
    if quant:
        params = quantize_params_int8(cfg, params)
        d_params = quantize_params_int8(dcfg, d_params)
    for p in (prompt(8), pattern_prompt()):
        want = greedy(cfg, params, p, quantized=quant)
        for k in (1, 4):
            spec = make_speculative_generate_fn(
                cfg, dcfg, k=k, max_len=T, quantized=quant,
                draft_quantized=quant, device="cpu")(params, d_params, p)
            np.testing.assert_array_equal(spec.numpy(), want)
            look = make_lookup_generate_fn(
                cfg, k=k, max_len=T, quantized=quant, device="cpu")(
                params, p)
            np.testing.assert_array_equal(look.numpy(), want)


def test_decoder_raises_match_jax():
    jcfg, cfg = configs()
    jd, dcfg = configs(vocab_size=32)
    seq2 = MeshConfig(data=1, seq=2, devices=jax.devices()[:2])

    class _Seq2:
        # the coordinates a decoder's checks read of a seq=2 mesh
        shape = dict(pipe=1, data=1, expert=1, seq=2, model=1)
        device = torch.device("cpu")

        def comm(self, *axes):
            return SimpleNamespace(size=int(np.prod(
                [self.shape[a] for a in axes])))

    def messages(jfn, fn):
        with pytest.raises(ValueError) as want:
            jfn()
        with pytest.raises(ValueError) as got:
            fn()
        assert str(got.value) == str(want.value)

    same = configs()
    messages(lambda: jax_spec(one(), jcfg, jd),
             lambda: make_speculative_generate_fn(cfg, dcfg, device="cpu"))
    messages(lambda: jax_spec(one(), jcfg, same[0], k=0),
             lambda: make_speculative_generate_fn(cfg, same[1], k=0,
                                                  device="cpu"))
    messages(lambda: jax_lookup(one(), jcfg, ngram=0),
             lambda: make_lookup_generate_fn(cfg, ngram=0, device="cpu"))
    messages(lambda: jax_spec(seq2, jcfg, same[0]),
             lambda: make_speculative_generate_fn(cfg, same[1],
                                                  mesh=_Seq2()))
    messages(lambda: jax_lookup(seq2, jcfg),
             lambda: make_lookup_generate_fn(cfg, mesh=_Seq2()))
    messages(lambda: jax_beam(one(), jcfg, beam_size=0),
             lambda: make_beam_search_fn(cfg, beam_size=0, device="cpu"))
    # sampling is the serving slice's (item 12)
    for kw in (dict(temperature=0.7), dict(top_k=5), dict(top_p=0.9)):
        with pytest.raises(NotImplementedError, match="Queue A item 12"):
            make_speculative_generate_fn(cfg, same[1], device="cpu", **kw)
    with pytest.raises(ValueError, match="ngram"):
        make_lookup_generate_fn(cfg, ngram=5, device="cpu")(
            params_from_jax(tree_of(cfg), cfg, "cpu"), prompt(length=4))


# --------------------------------------------------------------------- #
# beam search
# --------------------------------------------------------------------- #

# name: (config fields, options, prompt_lens, int8 weights)
BEAM = {
    "eos_penalty": (dict(), dict(length_penalty=0.6), None, False),
    "lens_int8_kv8": (dict(pos_embedding="rope", kv_cache_dtype="int8"),
                      dict(), [4, 1, 3, 2], True),
}


@pytest.mark.parametrize("name", list(BEAM))
def test_beam_matches_jax(name):
    fields, kw, lens, quant = BEAM[name]
    jcfg, cfg = configs(**fields)
    tree = tree_of(cfg, seed=2)
    if quant:
        tree = quantize_params_int8(cfg, tree)
    p = prompt(9)
    params = params_from_jax(tree, cfg, "cpu")
    if name.startswith("eos"):
        # a token the best beam of row 0 emits mid-way, so hypotheses
        # freeze on it
        toks, _ = make_beam_search_fn(cfg, beam_size=K, max_len=T,
                                      device="cpu")(params, p)
        kw = dict(kw, eos_id=int(toks[0, 0, 8]))
    want, w_scores = jax_beam(one(), jcfg, beam_size=K, max_len=T,
                              quantized=quant, **kw)(tree, p,
                                                     prompt_lens=lens)
    got, scores = make_beam_search_fn(cfg, beam_size=K, max_len=T,
                                      quantized=quant, device="cpu", **kw)(
        params, p, prompt_lens=lens)
    assert got.shape == (B, K, T) and scores.shape == (B, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(w_scores),
                               rtol=1e-5)
    # best first
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()
    if "eos_id" in kw:
        # a hypothesis that emitted eos is padded with it
        toks = got.numpy()[:, :, 4:]
        hit = toks == kw["eos_id"]
        assert hit.any()
        first = np.where(hit.any(-1), hit.argmax(-1), toks.shape[-1])
        for b, j in zip(*np.nonzero(hit.any(-1))):
            assert (toks[b, j, first[b, j]:] == kw["eos_id"]).all()


def test_beam_one_is_greedy_and_padded_rows_decode_alone():
    _, cfg = configs(pos_embedding="rope")
    params = params_from_jax(tree_of(cfg, seed=3), cfg, "cpu")
    p = prompt(10)
    toks, _ = make_beam_search_fn(cfg, beam_size=1, max_len=T,
                                  device="cpu")(params, p)
    np.testing.assert_array_equal(toks.numpy()[:, 0], greedy(cfg, params, p))
    # each row right-aligned among longer ones: its beams and scores are
    # its solo run's
    lens = [4, 2, 3, 1]
    beam = make_beam_search_fn(cfg, beam_size=K, max_len=T, device="cpu")
    got, scores = beam(params, p, prompt_lens=lens)
    for b, n in enumerate(lens):
        solo, s_solo = make_beam_search_fn(
            cfg, beam_size=K, max_len=T - (4 - n), device="cpu")(
            params, p[b:b + 1, 4 - n:])
        np.testing.assert_array_equal(got.numpy()[b, :, 4 - n:],
                                      solo.numpy()[0])
        np.testing.assert_allclose(scores.numpy()[b], s_solo.numpy()[0],
                                   rtol=1e-5)
