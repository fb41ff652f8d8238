"""Flagship transformer LM training on the PyTorch/CUDA port — the pipe,
data, expert, sequence and model axes of ``train_lm.py`` through
``chainermn_tpu_torch``: ChainerMN's data parallelism for the language
model, ring or Ulysses attention over a sequence axis for long
contexts, Megatron tensor parallelism (with ``--vocab-parallel``, the
vocabulary too) over a model axis for a model too wide for one card,
pipeline parallelism (GPipe, 1F1B or interleaved, ``--schedule``) over
a pipe axis for one too deep, and with ``--moe`` a Switch (or, with
``--router-top-k 2``, GShard) mixture of experts in every block whose
experts shard over an expert axis.

One process a GPU, launched by ``torchrun`` (ChainerMN's ``mpiexec``);
``--mesh pipe=P,data=D,expert=X,model=M,seq=S`` must name the world
(``data=-1``, the default, absorbs what the other axes leave of it).
The weights come from ``torch.Generator`` seed 0, ``bcast_data`` gives
rank 0's to every rank, and each rank keeps its shard over ``pipe``,
``model`` and ``expert``; each step takes the global batch, each rank
its rows over ``data`` and ``expert`` and its block of the sequence over
``seq``, and the gradients are meaned in fp32 over them
(``make_train_step(mesh=...)``):

    torchrun --nproc_per_node 8 examples/transformer/train_lm_torch.py \\
        --mesh data=8 --attention flash --dtype bfloat16 --remat
    # the flagship: 299.2 M parameters, 8 x 2048 tokens a card
    torchrun --nproc_per_node 8 examples/transformer/train_lm_torch.py \\
        --vocab 32000 --d-model 1024 --n-heads 16 --n-kv-heads 4 \\
        --n-layers 24 --seq 2048 --batchsize 64 --attention flash \\
        --dtype bfloat16 --remat --lr 3e-4
    # 2-way data x 2-way sequence, the zigzag ring
    torchrun --nproc_per_node 4 examples/transformer/train_lm_torch.py \\
        --mesh data=2,seq=2 --attention ring --seq-layout zigzag \\
        --dtype bfloat16 --remat
    # 2-way data x 2-way tensor parallelism, the vocabulary sharded
    torchrun --nproc_per_node 4 examples/transformer/train_lm_torch.py \\
        --mesh data=2,model=2 --vocab-parallel --loss-chunk 8 \\
        --attention flash --dtype bfloat16 --remat
    # 2 pipeline stages x 2-way data, the 1F1B schedule
    torchrun --nproc_per_node 4 examples/transformer/train_lm_torch.py \\
        --mesh pipe=2,data=2 --schedule 1f1b --attention flash \\
        --dtype bfloat16
    # 4-way expert parallelism: 8 experts, 2 a card, top-2 routing
    torchrun --nproc_per_node 4 examples/transformer/train_lm_torch.py \\
        --mesh expert=4 --moe --router-top-k 2 --attention flash \\
        --dtype bfloat16 --remat
    # the CPU over gloo, with a BPE vocabulary over a text file
    torchrun --nproc_per_node 2 examples/transformer/train_lm_torch.py \\
        --device cpu --mesh data=2 --text-file SURVEY.md \\
        --tokenizer-vocab 512 --checkpoint ck --steps 30

The data is ``train_lm.py``'s: synthetic sequences with an affine
next-token rule, or ``--text-file`` windows (raw bytes, or BPE ids with
``--tokenizer-vocab``), drawn from the same ``np.random.RandomState``
streams, so the batches are bitwise the JAX example's.  Under
``--seq-layout zigzag`` inputs and targets are permuted by
``zigzag_indices`` before the step, as ``train_lm.py`` does.  The config
is the JAX example's (fp32, no remat) unless ``--dtype``, ``--d-ff``,
``--remat`` and ``--remat-policy`` (``TransformerConfig``'s fields) say
otherwise.  ``--remat-policy dots`` recomputes less on the card but runs
its selective checkpoint's Python dispatch on every op, which makes the
host-bound flagship step slower than the full policy, so the flagship
command above uses ``--remat`` alone.
With a pipe axis the run takes ``train_lm.py``'s schedule settings: two
micro-batches, and two virtual stages a rank under ``--schedule
interleaved``.
``--checkpoint DIR`` saves ``lm_state.npz`` (the port's container: params
and the optimizer's moments gathered into the JAX layout, its blocks
grouped for the run's pipe axis and virtual stages, which it records,
the optimizer's state, the step) at the end and resumes from it, each
rank taking its shard (``reshard_train_state``): a run saved at
``model=2`` resumes at ``model=1``, one saved at ``pipe=2`` at
``pipe=1``, one saved at ``expert=2`` at ``expert=1``, and the
reverse.  Under ``--moe`` a new run has ``train_lm.py``'s
``max(2·expert, 2)`` experts, and a resumed one its checkpoint's.
``--fsdp`` (ZeRO-3) keeps every block matrix's d_model dim sharded
over the data axis, its gradient and its AdamW moments too; each block
gathers its weights just before use and the gathers' backward
reduce-scatters the gradients.  It composes with every ``--mesh`` axis,
``--moe`` and ``--schedule``, and the checkpoint, in the JAX layout,
resumes with ``--fsdp`` on or off.
"""

import argparse
import dataclasses
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def parse_mesh(spec: str, world=None):
    """``"data=2,seq=2"`` as ``{"data": 2, "seq": 2}``.  With ``world``,
    ``data=-1`` (or no ``data``) absorbs what the other axes leave of
    the world, and the axes must then make up the world: one process a
    device."""
    axes = {}
    for part in filter(None, spec.split(",")):
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    if world is not None:
        rest = 1
        for k, v in axes.items():
            if k != "data":
                rest *= v
        data = axes.get("data", -1)
        if data == -1:
            data = max(world // rest, 1)
        if data * rest != world:
            raise SystemExit(
                f"--mesh {spec} needs {data * rest} ranks, but the world "
                f"has {world}: the port runs one process a device "
                f"(launch with torchrun --nproc_per_node {data * rest})")
        axes["data"] = data
    return axes


def check_text_args(path, vocab, seq, tokenized=False):
    """Fail fast on --text-file misconfiguration, before any model
    work."""
    if vocab < 256 and not tokenized:
        raise SystemExit(
            f"--text-file is byte-level: --vocab {vocab} must be >= 256"
            " (or pass --tokenizer-vocab for a subword vocabulary)")
    if not os.path.exists(path):
        raise SystemExit(f"--text-file {path}: no such file")
    if os.path.getsize(path) < seq + 1:
        raise SystemExit(
            f"{path}: {os.path.getsize(path)} bytes < seq+1 = {seq + 1}")


def _text_windows(data, batch, seq, steps, seed):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        starts = rng.randint(0, data.size - seq, batch)
        x = np.stack([data[s:s + seq + 1] for s in starts]).astype(
            np.int32)
        yield x[:, :-1], x[:, 1:]


def load_text(path, vocab, seq):
    """Byte corpus split 90/10 into train/held-out ranges (held-out = the
    file's tail, never sampled by training).  A tail too small for one
    window folds into training and disables eval."""
    check_text_args(path, vocab, seq)
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    cut = int(0.9 * data.size)
    if cut < seq + 1 or data.size - cut < seq + 1:
        return data, None
    return data[:cut], data[cut:]


def load_text_tokenized(path, tok_vocab, seq, ckpt_dir, comm, quiet=False):
    """--tokenizer-vocab path: split the raw bytes 90/10, train a
    byte-level BPE on the train split only, encode both sides.  Merges
    persist as ``bpe.json`` beside the checkpoint and a resume loads
    them.  Rank 0 trains or loads the tokenizer and broadcasts its
    merges, so every rank encodes with the same one."""
    from chainermn_tpu_torch.datasets import BPETokenizer, train_bpe

    check_text_args(path, 256, seq, tokenized=True)
    with open(path, "rb") as f:
        raw = f.read()
    cut = int(0.9 * len(raw))
    bpe_path = os.path.join(ckpt_dir, "bpe.json") if ckpt_dir else None
    say = print if comm.rank == 0 and not quiet else (lambda *a: None)
    merges = None
    if comm.rank == 0:
        if bpe_path and os.path.exists(bpe_path):
            tok = BPETokenizer.load(bpe_path)
            if tok.vocab_size > tok_vocab:
                raise SystemExit(
                    f"{bpe_path} holds {tok.vocab_size} ids > "
                    f"--tokenizer-vocab {tok_vocab}: stale tokenizer from "
                    "an earlier run — delete the file or match the flag")
            say(f"loaded tokenizer {bpe_path} ({tok.vocab_size} ids; "
                "delete the file to retrain)")
        else:
            t0 = time.perf_counter()
            tok = train_bpe(raw[:cut], tok_vocab)
            say(f"trained BPE: {tok.vocab_size} ids "
                f"({time.perf_counter() - t0:.1f}s)")
            if bpe_path:
                os.makedirs(ckpt_dir, exist_ok=True)
                tok.save(bpe_path)
                say(f"saved {bpe_path}")
        merges = tok.merges
    tok = BPETokenizer(comm.bcast_obj(merges))
    train = np.asarray(tok.encode(raw[:cut]), np.int32)
    held = np.asarray(tok.encode(raw[cut:]), np.int32)
    if train.size < seq + 1:
        raise SystemExit(
            f"{path}: {train.size} train tokens < seq+1 = {seq + 1}")
    if held.size < seq + 1:
        held = None
    return train, held, tok


def make_batches(vocab, batch, seq, steps, seed=0):
    """Sequences following tok[t+1] = (a*tok[t] + b) % vocab with 10%
    noise — enough structure that a few dozen steps visibly cut loss."""
    rng = np.random.RandomState(seed)
    a, b = 7, 3
    for _ in range(steps):
        x = np.empty((batch, seq + 1), np.int32)
        x[:, 0] = rng.randint(0, vocab, batch)
        for t in range(seq):
            nxt = (a * x[:, t] + b) % vocab
            noise = rng.randint(0, vocab, batch)
            take = rng.rand(batch) < 0.1
            x[:, t + 1] = np.where(take, noise, nxt)
        yield x[:, :-1], x[:, 1:]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh", default="data=-1",
                   help="comma list of axis sizes over pipe, data, "
                        "expert, seq and model; they must make up the "
                        "world (data=-1 absorbs what the others leave)")
    p.add_argument("--attention", default="local",
                   choices=["local", "flash", "ring", "ulysses"])
    p.add_argument("--schedule", default="gpipe",
                   choices=["gpipe", "1f1b", "interleaved"])
    p.add_argument("--pos-embedding", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--window", type=int, default=0)
    p.add_argument("--text-file", default=None,
                   help="train on a real text file, byte-level tokens "
                        "(needs --vocab >= 256); default is synthetic "
                        "data")
    p.add_argument("--tokenizer-vocab", type=int, default=0,
                   help="with --text-file: train/load a byte-level BPE "
                        "vocabulary of up to this many ids (0 = raw "
                        "bytes), saved as bpe.json beside --checkpoint; "
                        "held-out perplexity is then reported per token "
                        "and per byte")
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="chunked-vocab cross-entropy chunk size "
                        "(0 = whole-shard logits)")
    p.add_argument("--vocab-parallel", action="store_true",
                   help="shard the embedding's rows over the model axis "
                        "(the vocab-parallel lookup and cross-entropy)")
    p.add_argument("--moe", action="store_true")
    p.add_argument("--router-top-k", type=int, default=1,
                   help="experts per token (1=Switch, 2=GShard top-2)")
    p.add_argument("--seq-layout", default="contiguous",
                   choices=["contiguous", "zigzag"])
    p.add_argument("--fsdp", action="store_true",
                   help="shard the block matrices, their gradients and "
                        "moments over the data axis (ZeRO-3)")
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=0,
                   help="MLP width (0 = 4 x d_model, the JAX example's)")
    p.add_argument("--dtype", default="float32",
                   help="compute dtype (params stay fp32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "dots"])
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--batchsize", type=int, default=32,
                   help="global batch; each rank takes batchsize/world rows")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--checkpoint", default=None,
                   help="directory for a final-state snapshot (resumes "
                        "from it if one exists)")
    p.add_argument("--device", default=None,
                   help="cpu runs on the CPU over gloo; default the card")
    args = p.parse_args(argv)
    if args.tokenizer_vocab and not args.text_file:
        raise SystemExit("--tokenizer-vocab needs --text-file")
    if args.tokenizer_vocab and args.tokenizer_vocab <= 256:
        raise SystemExit(
            f"--tokenizer-vocab {args.tokenizer_vocab} must exceed 256 "
            "(ids 0-255 are the raw bytes; merges come on top)")
    if args.text_file:
        # fail fast, before the world and the model
        check_text_args(args.text_file, args.vocab, args.seq,
                        tokenized=bool(args.tokenizer_vocab))
    return args


def config(args):
    """The run's ``TransformerConfig``, checked against ``--mesh`` and
    what the port has, before any world is started."""
    from chainermn_tpu_torch.models import TransformerConfig
    from chainermn_tpu_torch.models.transformer import (
        _check_layers, _check_mesh, _check_ported)

    axes = parse_mesh(args.mesh)
    pipe = axes.get("pipe", 1)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_heads=args.n_heads, d_head=args.d_model // args.n_heads,
        n_kv_heads=args.n_kv_heads, d_ff=args.d_ff or 4 * args.d_model,
        n_layers=args.n_layers, max_seq=args.seq,
        attention=args.attention, attention_window=args.window,
        pos_embedding=args.pos_embedding, seq_layout=args.seq_layout,
        moe=args.moe,
        n_experts=max(2 * axes.get("expert", 1), 2),
        router_top_k=args.router_top_k if args.moe else 1,
        loss_chunk=args.loss_chunk,
        vocab_parallel=args.vocab_parallel,
        # train_lm.py's schedule settings
        num_microbatches=2 if pipe > 1 else 1,
        pipeline_schedule=args.schedule,
        virtual_pipe=2 if args.schedule == "interleaved" else 1,
        fsdp=args.fsdp, dtype=args.dtype, remat=args.remat,
        remat_policy=args.remat_policy)
    _check_mesh(axes, cfg)
    _check_layers(pipe, cfg)
    _check_ported(cfg, training=True)
    return cfg


def build(args, init=None, quiet=False):
    """The run, before its steps: a namespace of ``comm``, ``cfg``,
    ``axes``, ``mesh``, ``params``, ``opt``, ``opt_state``, ``step`` (the
    train step over the mesh), ``start`` (the resumed step), ``batches``
    (the global batches still to take, permuted for the zigzag layout),
    ``heldout``, ``tok`` and ``ckpt_file``.  ``init``, a parameter tree
    in the JAX package's layout (numpy), replaces the seeded initial
    weights; parity tests start both packages from the same weights with
    it."""
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        init_transformer, make_train_step, params_from_jax,
        reshard_train_state, shard_params)
    from chainermn_tpu_torch.parallel import MeshConfig, zigzag_indices
    from chainermn_tpu_torch.utils.serialization import load_state

    # fail fast, before the world: the mesh, then what is not ported yet
    cfg = config(args)
    comm = cmn.create_communicator(device=args.device)
    say = print if comm.rank == 0 and not quiet else (lambda *a: None)
    say(f"world: {comm.size} ranks on {comm.inter_size} nodes, device "
        f"{comm.device}")
    axes = parse_mesh(args.mesh, comm.size)
    mesh = MeshConfig(comm, **axes)

    tok = tok_train = tok_held = None
    if args.text_file and args.tokenizer_vocab:
        # before cfg: the learned vocabulary decides the model's vocab
        tok_train, tok_held, tok = load_text_tokenized(
            args.text_file, args.tokenizer_vocab, args.seq,
            args.checkpoint, comm, quiet)
        vocab = max(args.vocab, -(-tok.vocab_size // 128) * 128)
        if vocab != args.vocab:
            say(f"model vocab {vocab} (tokenizer {tok.vocab_size} ids, "
                "padded up to a 128-multiple)")
            args.vocab = vocab
            cfg = dataclasses.replace(cfg, vocab_size=vocab)
    rows = axes["data"] * axes.get("expert", 1)
    if args.batchsize % rows:
        raise SystemExit(f"--batchsize {args.batchsize} does not divide "
                         f"over the data and expert axes ({rows} ranks)")

    opt = training.adamw(args.lr)
    ckpt_file = (os.path.join(args.checkpoint, "lm_state.npz")
                 if args.checkpoint else None)
    saved = (load_state(ckpt_file)
             if ckpt_file and os.path.exists(ckpt_file) else None)
    start = 0
    if saved is not None and "router" in saved["params"]["blocks"]:
        # an MoE run keeps its experts at any expert grouping
        cfg = dataclasses.replace(
            cfg, n_experts=saved["params"]["blocks"]["router"].shape[-1])
    if saved is not None:
        saved_pipe = int(saved.get("pipe", 1))
        saved_v = int(saved.get("virtual_pipe", 1))
        # every rank reads the same file (the JAX layout, grouped for the
        # run that saved it) and keeps its shard of the parameters and of
        # the optimizer's moments, regrouped for this mesh
        params, opt_state = reshard_train_state(
            mesh, cfg, opt, saved["params"], saved["opt"],
            from_pipe=saved_pipe, from_virtual=saved_v)
        start = int(saved["step"])
        if (saved_pipe, saved_v) != (axes.get("pipe", 1), cfg.virtual_pipe):
            say(f"regrouped checkpoint pipe={saved_pipe}/V={saved_v} -> "
                f"pipe={axes.get('pipe', 1)}/V={cfg.virtual_pipe}")
        say(f"resumed at step {start}")
    else:
        if init is not None:
            params = params_from_jax(init, cfg, comm.device)
        else:
            params = init_transformer(torch.Generator().manual_seed(0),
                                      cfg, device=comm.device)
        # ChainerMN's first moment: every rank takes rank 0's weights,
        # then keeps its shard over the pipe and model axes
        comm.bcast_data(params)
        params = shard_params(mesh, cfg, params)
        opt_state = opt.init(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    # the zigzag layout's contract: tokens permuted by zigzag_indices
    # (inputs and targets alike, so next-token pairs stay aligned)
    perm = None
    if cfg.seq_layout == "zigzag":
        perm = zigzag_indices(axes.get("seq", 1), args.seq).reshape(-1)

    heldout = None
    steps = max(args.steps - start, 0)
    if args.text_file:
        if tok is not None:
            train_data, heldout = tok_train, tok_held
        else:
            train_data, heldout = load_text(args.text_file, args.vocab,
                                            args.seq)
        batches = _text_windows(train_data, args.batchsize, args.seq,
                                steps, seed=start)
    else:
        batches = make_batches(args.vocab, args.batchsize, args.seq, steps,
                               seed=start)
    if perm is not None:
        batches = ((x[:, perm], y[:, perm]) for x, y in batches)
    return types.SimpleNamespace(
        args=args, comm=comm, cfg=cfg, axes=axes, mesh=mesh, perm=perm,
        params=params, opt=opt, opt_state=opt_state, step=step,
        start=start, batches=batches,
        heldout=heldout, tok=tok, ckpt_file=ckpt_file, say=say, losses=[],
        perplexity=None)


def train(run):
    """The step loop; returns the losses (each the mean over the
    ranks)."""
    args, say = run.args, run.say
    if run.start >= args.steps:
        say(f"nothing to do: resumed step {run.start} >= --steps "
            f"{args.steps}")
        return run.losses
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(run.batches):
        run.params, run.opt_state, loss = run.step(
            run.params, run.opt_state, x, y)
        loss = float(loss)
        run.losses.append(loss)
        if (run.start + i) % 10 == 0:
            say(f"step {run.start + i:4d}  loss {loss:.4f}")
    first, last = run.losses[0], run.losses[-1]
    say(f"loss {first:.4f} -> {last:.4f} over {args.steps - run.start} "
        f"steps ({time.perf_counter() - t0:.1f}s) on mesh {run.axes}")
    if not np.isfinite(last):
        # never persist a diverged state
        raise SystemExit("non-finite loss")
    return run.losses


def evaluate(run):
    """Held-out perplexity on the text file's tail: each rank forwards
    its block of each batch (its rows, its block of the sequence) and
    the nll sums are all-reduced over the batch-like group (the members
    of a model group hold the same logits).  Returns ``(token_ppl,
    byte_ppl)``, or None without a held-out split."""
    import torch

    from chainermn_tpu_torch.models import make_forward_fn
    from chainermn_tpu_torch.models.transformer import _shard
    from chainermn_tpu_torch.parallel.mesh import BATCH_AXES

    args, say, comm, mesh = run.args, run.say, run.comm, run.mesh
    if run.heldout is None:
        say("held-out eval skipped: file too small for a 90/10 split at "
            "this --seq")
        return None
    fwd = make_forward_fn(run.cfg, mesh=mesh)
    nll = torch.zeros((), dtype=torch.float64, device=comm.device)
    total_tokens = total_bytes = 0.0
    for x, y in _text_windows(run.heldout, args.batchsize, args.seq, 4,
                              seed=99):
        if run.perm is not None:
            x, y = x[:, run.perm], y[:, run.perm]
        logp = torch.log_softmax(fwd(run.params, x), dim=-1)
        mine = _shard(mesh, y, comm.device).long()
        nll += -logp.gather(-1, mine[..., None]).sum().double()
        total_tokens += y.size
        total_bytes += (run.tok.n_bytes(y.reshape(-1))
                        if run.tok is not None else y.size)
    total_nll = float(mesh.comm(*BATCH_AXES).allreduce(nll, "sum"))
    tok_ppl = float(np.exp(total_nll / total_tokens))
    byte_ppl = float(np.exp(total_nll / total_bytes))
    if run.tok is not None:
        say(f"held-out token perplexity {tok_ppl:.2f} (uniform over the "
            f"{run.tok.vocab_size} tokenizer ids would be "
            f"{run.tok.vocab_size}); byte perplexity {byte_ppl:.2f} at "
            f"{total_bytes / total_tokens:.2f} bytes/token")
    else:
        say(f"held-out byte perplexity {byte_ppl:.2f} (uniform would be "
            f"{args.vocab})")
    return tok_ppl, byte_ppl


def save(run):
    """Rank 0 writes ``lm_state.npz``: params and the optimizer's moments
    in the JAX package's layout (gathered over the pipe and model axes by
    every rank, the blocks grouped for the run's pipe axis), the
    optimizer's state, the step, the pipe grouping and the router's
    top-k."""
    from chainermn_tpu_torch.models import params_to_numpy
    from chainermn_tpu_torch.training import (
        map_state_moments, optimizer_state_tree)
    from chainermn_tpu_torch.utils.serialization import save_state

    params = params_to_numpy(run.params, run.cfg, mesh=run.mesh)
    opt = map_state_moments(optimizer_state_tree(run.opt_state),
                            run.params, lambda t: params_to_numpy(
                                t, run.cfg, mesh=run.mesh))
    if run.comm.rank == 0:
        save_state(run.ckpt_file, {
            "params": params,
            "opt": opt,
            "step": run.args.steps,
            "pipe": run.axes.get("pipe", 1),
            "virtual_pipe": run.cfg.virtual_pipe,
            "router_top_k": run.cfg.router_top_k,
        })
        run.say(f"saved {run.ckpt_file}")
    run.comm.barrier()


def main(argv=None, init=None):
    import torch.distributed as dist

    owns_world = not dist.is_initialized()
    run = build(parse_args(argv), init=init)
    if train(run):
        if run.args.text_file:
            run.perplexity = evaluate(run)
        if run.ckpt_file:
            save(run)
    if owns_world and dist.is_initialized():
        dist.destroy_process_group()
    return run


if __name__ == "__main__":
    main()
