"""The LM examples' pieces in the port against the JAX package's: the
byte-level BPE tokenizer (the same merges, ids and ``bpe.json``),
``init_transformer`` (the same tree, shapes, dtypes and scales), and
``examples/transformer/train_lm_torch.py`` in a 2-rank gloo world
against the JAX ``train_lm.py`` at ``--mesh data=2`` from the same
weights (both examples draw the same batches from the same numpy
streams; fp32, so their printed losses agree to 1e-4 relative); then a
train → save → resume → ``generate_torch.py`` round trip over a text
file with a BPE vocabulary.  The port's side of the world is
``battery_lm_examples`` in ``test_torch_world.py``."""

import dataclasses
import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.datasets import BPETokenizer as JaxBPE
from chainermn_tpu.datasets import train_bpe as jax_train_bpe
from chainermn_tpu.models import TransformerConfig as JaxConfig
from chainermn_tpu.models import init_transformer as jax_init
from chainermn_tpu_torch.datasets import BPETokenizer, train_bpe
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_transformer,
    params_to_numpy,
)

from test_torch_world import one_thread, run_world

ROOT = Path(__file__).resolve().parent.parent
SURVEY = ROOT / "SURVEY.md"
# train_lm.py's defaults at --mesh data=2 (fp32, no remat)
LM_CFG = dict(vocab_size=128, d_model=64, n_heads=4, d_head=16, d_ff=256,
              n_layers=4, max_seq=32, attention="local", dtype="float32",
              remat=False)
STEPS = 12


def load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------- #
# the tokenizer
# --------------------------------------------------------------------- #


def test_bpe_matches_jax(tmp_path):
    data = SURVEY.read_bytes()[:20_000]
    port, ref = train_bpe(data, 512), jax_train_bpe(data, 512)
    assert port.merges == ref.merges and port.vocab_size > 300
    text = SURVEY.read_bytes()
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == text
    assert port.n_bytes(ids) == ref.n_bytes(ids) == len(text)
    # a file written by either package loads in the other
    port.save(tmp_path / "port.json")
    ref.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "jax.json").read_bytes()
    assert JaxBPE.load(tmp_path / "port.json").merges == port.merges
    assert BPETokenizer.load(tmp_path / "jax.json").encode(text) == ids


def test_bpe_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="must exceed 256"):
        train_bpe(b"abc", 256)
    with pytest.raises(ValueError, match="not yet"):
        BPETokenizer([(256, 1)])
    assert train_bpe(b"", 300).merges == []


# --------------------------------------------------------------------- #
# init_transformer
# --------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def jax_tree(**kw):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                             JaxConfig(**LM_CFG, **kw)))


@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=2,
                                             pos_embedding="rope")])
def test_init_transformer_matches_jax_layout_and_scales(kw):
    fields = dict(LM_CFG, **kw)
    cfg = TransformerConfig(**fields)
    want = jax_tree(**kw)
    params = init_transformer(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    got = params_to_numpy(params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if b.std() == 0:           # the norm scales: ones
            np.testing.assert_array_equal(a, b)
        else:
            assert abs(a.std() / b.std() - 1) < 0.05, \
                (jax.tree_util.keystr(path), a.std(), b.std())
            assert abs(a.mean()) < 0.1 * b.std()
    again = init_transformer(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    other = init_transformer(torch.Generator().manual_seed(1), cfg,
                             device="cpu")
    torch.testing.assert_close(again["embed"], params["embed"], rtol=0,
                               atol=0)
    assert not torch.equal(other["embed"], params["embed"])


def test_init_transformer_refuses():
    # blocks grouped for a pipe axis and MoE blocks are ported
    # (test_torch_pipeline.py, test_torch_expert_parallel.py): MoE blocks
    # come out in the JAX tree's shapes; the layers must divide over the
    # stages
    cfg = TransformerConfig(**LM_CFG)
    moe = init_transformer(torch.Generator(),
                           dataclasses.replace(cfg, moe=True, n_experts=4),
                           device="cpu")
    assert {k: tuple(v.shape) for k, v in moe["blocks"].items()
            if k in ("router", "w1", "w2")} == {
        "router": (4, 64, 4), "w1": (4, 4, 64, 256),
        "w2": (4, 4, 256, 64)}
    with pytest.raises(ValueError, match="not divisible by pipe"):
        init_transformer(torch.Generator(), cfg, pipe_size=3, device="cpu")
    with pytest.raises(TypeError, match="torch.Generator"):
        init_transformer(0, cfg, device="cpu")


# --------------------------------------------------------------------- #
# the examples
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ck = tmp_path_factory.mktemp("lm_ck")
    payload = dict(
        argv=["--device", "cpu", "--mesh", "data=2", "--steps", str(STEPS)],
        tree=jax_tree(),
        text_argv=["--device", "cpu", "--mesh", "data=2", "--text-file",
                   str(SURVEY), "--tokenizer-vocab", "384", "--seq", "32",
                   "--batchsize", "8", "--n-layers", "2"],
        gen_argv=["--device", "cpu", "--vocab", "384", "--n-layers", "2",
                  "--prompt-text", "ChainerMN", "--max-len", "32",
                  "--batchsize", "2"],
        ck=str(ck))
    return run_world(tmp_path_factory.mktemp("lm_examples"), 2,
                     "battery_lm_examples", payload)


def printed_losses(text):
    steps = [float(m) for m in re.findall(r"step +\d+  loss ([\d.]+)", text)]
    first, last = re.search(r"loss ([\d.]+) -> ([\d.]+) over", text).groups()
    return steps + [float(first), float(last)]


def test_train_lm_torch_matches_jax_example(port, monkeypatch, capsys):
    from chainermn_tpu import parallel

    real = parallel.MeshConfig
    # the JAX example's mesh on 2 of the 8 virtual devices
    monkeypatch.setattr(parallel, "MeshConfig", lambda **axes: real(
        devices=jax.devices()[:2], **axes))
    ex = load("examples/transformer/train_lm.py", "train_lm")
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--mesh", "data=2",
                                      "--steps", str(STEPS)])
    last = ex.main()
    want = printed_losses(capsys.readouterr().out)
    got = printed_losses(port[0]["printed"])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(port[0]["losses"][-1], last, rtol=1e-4)
    assert len(port[0]["losses"]) == STEPS
    assert port[1]["losses"] == port[0]["losses"]     # the ranks' means
    assert port[1]["printed"] == ""                   # rank 0 prints


def test_train_save_resume_generate(port):
    text = port[0]["text"]
    assert len(text["first"]) == 4 and len(text["resumed"]) == 2
    assert text["start"] == 4 and text["steps"] == (4, 6)
    assert "resumed at step 4" in text["printed"]
    assert "trained BPE" in text["printed"] \
        and "loaded tokenizer" in text["printed"]
    # the saved state is the run's, bitwise
    np.testing.assert_array_equal(text["saved_embed"], text["first_embed"])
    tok_ppl, byte_ppl = text["perplexity"]
    assert 1 < byte_ppl < tok_ppl < 384
    gen = port[0]["generate"]
    np.testing.assert_array_equal(gen["embed"], text["final_embed"])
    assert "generated text: 'ChainerMN" in gen["printed"]
    assert gen["tokens"].shape == (2, 32)
    # decode logits against the full forward over the generated sequence
    np.testing.assert_allclose(gen["logits"], gen["full"], rtol=1e-4,
                               atol=1e-4)
    assert (gen["logits"].argmax(-1)
            == gen["tokens"][:, -gen["logits"].shape[1]:]).all()


# --vocab-parallel, the model, pipe and expert axes, the schedules,
# --moe and --fsdp are ported (the config checks below,
# test_torch_tensor_parallel.py, test_torch_pipeline.py,
# test_torch_expert_parallel.py, test_torch_fsdp.py): their places hold
# them beside --fsdp
TRAIN_UNPORTED = [["--moe", "--fsdp"], ["--fsdp"],
                  ["--vocab-parallel", "--moe", "--fsdp"],
                  ["--schedule", "1f1b", "--moe", "--fsdp"],
                  ["--schedule", "interleaved", "--fsdp"],
                  ["--mesh", "expert=2,model=2", "--fsdp"],
                  ["--mesh", "pipe=2,expert=2", "--fsdp"],
                  ["--mesh", "expert=2", "--fsdp"]]


@pytest.mark.parametrize("flags", TRAIN_UNPORTED,
                         ids=[" ".join(f) for f in TRAIN_UNPORTED])
def test_train_lm_torch_unported_flags_raise(flags):
    # --fsdp builds the config without it plus fsdp; on one rank (no
    # --mesh) two steps are the run's without --fsdp, bit for bit
    ex = load("examples/transformer/train_lm_torch.py", "train_lm_torch")
    dense = [f for f in flags if f != "--fsdp"]
    cfg = ex.config(ex.parse_args(["--device", "cpu"] + flags))
    assert cfg.fsdp and dataclasses.replace(cfg, fsdp=False) == ex.config(
        ex.parse_args(["--device", "cpu"] + dense))
    if "--mesh" in flags:
        return

    def steps(f):
        run = ex.build(ex.parse_args(["--device", "cpu", "--steps", "2"]
                                     + f), quiet=True)
        return ex.train(run), run.params

    # the builds start a one-rank world in this process: end it after,
    # so no later test finds a process group
    started = not torch.distributed.is_initialized()
    try:
        (lf, pf), (ld, pd) = (one_thread(lambda f=f: steps(f))
                              for f in (flags, dense))
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert lf == ld
    for a, b in zip(torch.utils._pytree.tree_leaves(pf),
                    torch.utils._pytree.tree_leaves(pd)):
        assert torch.equal(a, b)


# the sequence and model axes (ported): the config builds before any
# world, the zigzag layout needs the ring, the vocab must divide over the
# model axis, and the mesh must make up the world
TRAIN_SEQ = [(["--attention", "ring", "--seq-layout", "zigzag"], None),
             (["--mesh", "data=2,seq=2", "--attention", "ulysses"], None),
             (["--seq-layout", "zigzag"], "ring-attention layout"),
             (["--mesh", "seq=2", "--attention", "ring"], "needs 2 ranks"),
             (["--mesh", "data=2,model=2", "--vocab-parallel"], None),
             (["--mesh", "model=3", "--n-heads", "3", "--vocab-parallel"],
              "vocab_size=128 must be divisible by 3"),
             (["--mesh", "model=2,seq=2", "--attention", "ring"],
              "needs 4 ranks"),
             (["--mesh", "pipe=2,data=2", "--schedule", "1f1b"], None),
             (["--mesh", "pipe=2", "--schedule", "interleaved"], None),
             (["--mesh", "pipe=3", "--schedule", "1f1b"],
              "4 layers not divisible by pipe"),
             (["--mesh", "pipe=2,model=2"], "needs 4 ranks"),
             # the expert axis and --moe (ported), which the places above
             # held
             (["--moe"], None), (["--vocab-parallel", "--moe"], None),
             (["--schedule", "1f1b", "--moe"], None),
             (["--mesh", "expert=2,model=2", "--moe"], "needs 4 ranks"),
             (["--mesh", "pipe=2,expert=2", "--moe", "--schedule", "1f1b"],
              "needs 4 ranks"),
             (["--mesh", "expert=2", "--moe", "--router-top-k", "2"],
              "needs 2 ranks")]


@pytest.mark.parametrize("flags,error", TRAIN_SEQ,
                         ids=[" ".join(f) for f, _ in TRAIN_SEQ])
def test_train_lm_torch_seq_flags(flags, error):
    ex = load("examples/transformer/train_lm_torch.py", "train_lm_torch")
    args = ex.parse_args(["--device", "cpu"] + flags)
    if error and error.startswith("needs"):
        # on one rank: the mesh is checked against the world
        ex.config(args)
        with pytest.raises(SystemExit, match=error):
            ex.parse_mesh(args.mesh, world=1)
    elif error:
        with pytest.raises(ValueError, match=error):
            ex.config(args)
    else:
        cfg = ex.config(args)
        assert cfg.attention == args.attention
        assert cfg.seq_layout == args.seq_layout
        assert cfg.vocab_parallel == args.vocab_parallel
        # train_lm.py's experts: max(2 x expert, 2)
        expert = ex.parse_mesh(args.mesh).get("expert", 1)
        assert cfg.moe == args.moe
        assert cfg.n_experts == max(2 * expert, 2)
        # train_lm.py's schedule settings under a pipe axis
        pipe = ex.parse_mesh(args.mesh).get("pipe", 1)
        assert cfg.num_microbatches == (2 if pipe > 1 else 1)
        assert cfg.virtual_pipe == (2 if args.schedule == "interleaved"
                                    else 1)


# (flags, the Queue A item its raise names, or the SystemExit message)
# under the ids the cases have always had: --beam, --speculative-k,
# --lookup-k, --int8 and --kv-int8 are ported
# (test_generate_torch_decoders_match_generate_py): their places hold
# each beside a sampling flag (item 12), and --lookup-k beside sampling
# or another decode mode (generate.py's exclusions)
GEN_UNPORTED = [(["--temperature", "0.7"], 12), (["--top-k", "5"], 12),
                (["--top-p", "0.9"], 12),
                (["--beam", "4", "--temperature", "0.7"], 12),
                (["--speculative-k", "3", "--top-k", "5"], 12),
                (["--lookup-k", "2", "--top-p", "0.9"], "exact-GREEDY"),
                (["--int8", "--temperature", "0.7"], 12),
                (["--kv-int8", "--top-p", "0.9"], 12),
                # --vocab-parallel and the model, pipe and expert axes
                # are ported (test_torch_tensor_parallel.py,
                # test_torch_pipeline.py, test_torch_expert_parallel.py):
                # the expert axis's places hold it beside int8 weights
                (["--mesh", "pipe=2,expert=2", "--int8", "--top-k", "5"],
                 12),
                (["--mesh", "expert=2", "--kv-int8", "--lookup-k", "2",
                  "--beam", "2"], "own decode mode")]
GEN_UNPORTED_IDS = ["--temperature 0.7", "--top-k 5", "--top-p 0.9",
                    "--beam 4", "--speculative-k 3", "--lookup-k 2",
                    "--int8", "--kv-int8", "--mesh pipe=2,expert=2 --int8",
                    "--mesh expert=2 --kv-int8"]


@pytest.mark.parametrize("flags,item", GEN_UNPORTED, ids=GEN_UNPORTED_IDS)
def test_generate_torch_unported_flags_raise(flags, item):
    ex = load("examples/transformer/generate_torch.py", "generate_torch")
    if isinstance(item, str):
        with pytest.raises(SystemExit, match=item):
            ex.main(["--device", "cpu"] + flags)
        return
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}"):
        ex.main(["--device", "cpu"] + flags)


# generate_torch.py's decoders, each of the five flags once at the
# example's defaults, from one checkpoint both scripts load
GEN_MODES = {
    "beam_int8": ["--beam", "4", "--int8"],
    "speculative_kv_int8": ["--speculative-k", "3", "--kv-int8"],
    "lookup": ["--lookup-k", "3", "--prompt", "1,2,3,1,2,3,1,2"],
}


@pytest.fixture(scope="module")
def decode_ck(tmp_path_factory):
    """One seeded tree in a checkpoint of each package's container (each
    reads only its own): ``{"jax": dir, "port": dir}``."""
    from chainermn_tpu.utils.serialization import save_state as jax_save
    from chainermn_tpu_torch.models import init_numpy_params
    from chainermn_tpu_torch.utils.serialization import save_state

    state = {"params": init_numpy_params(TransformerConfig(**LM_CFG),
                                         seed=0),
             "pipe": 1, "virtual_pipe": 1}
    dirs = {k: tmp_path_factory.mktemp(f"decode_ck_{k}")
            for k in ("jax", "port")}
    jax_save(str(dirs["jax"] / "lm_state.npz"), state)
    save_state(str(dirs["port"] / "lm_state.npz"), state)
    return dirs


def _stats(text):
    """The statistics lines of a run: acceptance, and each beam's
    score."""
    return [ln for ln in text.splitlines()
            if "accepted" in ln or ln.startswith(("beam ", "speculative"))]


@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_generate_torch_decoders_match_generate_py(mode, decode_ck,
                                                   monkeypatch, capsys):
    from chainermn_tpu import parallel

    flags = GEN_MODES[mode]
    real = parallel.MeshConfig
    # the JAX example's mesh on one of the virtual devices
    monkeypatch.setattr(parallel, "MeshConfig", lambda **axes: real(
        devices=jax.devices()[:1], **axes))
    monkeypatch.setattr(sys, "argv", ["generate.py"] + flags + [
        "--checkpoint", str(decode_ck["jax"])])
    # as a script, generate.py finds its sibling train_lm.py on its path
    monkeypatch.syspath_prepend(str(ROOT / "examples" / "transformer"))
    want = np.asarray(load("examples/transformer/generate.py",
                           "generate").main())
    printed = capsys.readouterr().out
    # the port's decode steps on one thread (many small ops)
    res = one_thread(lambda: load(
        "examples/transformer/generate_torch.py", "generate_torch").main(
        ["--device", "cpu"] + flags + ["--checkpoint",
                                       str(decode_ck["port"])]))
    mine = capsys.readouterr().out
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert _stats(mine) == _stats(printed) and _stats(mine)
    if mode == "speculative_kv_int8":
        # the draft is the checkpoint's first n_layers/2 blocks
        assert "2-layer draft: draft = target's first layers" in mine


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_generate_torch_moe_runs(pos):
    # an MoE model decodes on one rank from seeded weights: train_lm.py's
    # max(2 x expert, 2) experts, top-1
    ex = load("examples/transformer/generate_torch.py", "generate_torch")
    res = ex.main(["--device", "cpu", "--max-len", "16", "--batchsize",
                   "2", "--moe", "--pos-embedding", pos])
    assert res.tokens.shape == (2, 16)
    assert res.cfg.moe and res.cfg.n_experts == 2
    assert res.cfg.router_top_k == 1
    assert res.params["blocks"]["router"].shape[-1] == res.cfg.n_experts
