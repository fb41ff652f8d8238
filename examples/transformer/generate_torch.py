"""Text generation with the flagship transformer on the PyTorch/CUDA
port — ``generate.py``'s KV-cache decoders through
``chainermn_tpu_torch`` (greedy, ``--beam``, ``--speculative-k``,
``--lookup-k``, each with ``--int8`` weights and a ``--kv-int8``
cache), on one rank or over a mesh's pipe, data, expert, seq and model
axes.
It runs from ``lm_state.npz`` written by ``train_lm_torch.py
--checkpoint`` (so train → generate is a complete loop) or from seeded
random weights for a smoke run:

    python examples/transformer/generate_torch.py --checkpoint ck \\
        --prompt 5,11,2 --max-len 32
    python examples/transformer/generate_torch.py --device cpu \\
        --checkpoint ck --tokenizer ck/bpe.json --vocab 512 \\
        --prompt-text "ChainerMN is"
    # 2-way data x 2-way sequence-parallel KV cache, one process a card
    torchrun --nproc_per_node 4 examples/transformer/generate_torch.py \\
        --mesh data=2,seq=2 --max-len 64
    # 2-way data x 2-way tensor parallelism, the vocabulary sharded
    torchrun --nproc_per_node 4 examples/transformer/generate_torch.py \\
        --mesh data=2,model=2 --vocab-parallel --max-len 64
    # 2 pipeline stages x 2-way data, from any checkpoint's grouping
    torchrun --nproc_per_node 4 examples/transformer/generate_torch.py \\
        --mesh pipe=2,data=2 --checkpoint ck --max-len 64
    # an MoE checkpoint's experts over 4 cards
    torchrun --nproc_per_node 4 examples/transformer/generate_torch.py \\
        --mesh expert=4 --checkpoint ck --max-len 64
    # beam search over int8 weights and an int8 KV cache
    python examples/transformer/generate_torch.py --beam 4 --int8 --kv-int8
    # speculative decoding, the draft the checkpoint's first 2 layers
    python examples/transformer/generate_torch.py --checkpoint ck \\
        --speculative-k 4 --draft-layers 2
    # prompt lookup: the proposals copied from the context
    python examples/transformer/generate_torch.py --lookup-k 4 \\
        --prompt 5,6,7,5,6,7,5,6

``--mesh pipe=P,data=D,expert=X,seq=R,model=M`` decodes on a world of
``P·D·X·R·M`` ranks: each data and expert member its rows of the batch,
the seq members of a row each a block of the KV cache, the model
members each its shard of the heads (and with ``--vocab-parallel`` of
the vocabulary), the expert members each its share of an MoE model's
experts, the pipe stages each its layers and their cache; rank 0
prints the whole batch.  A checkpoint trained at any pipe grouping (the
file records it) is regrouped for the decode mesh; an MoE checkpoint
(its blocks hold a router) decodes as MoE with its own expert count,
routed top-k as it trained (the file records it).  Without an axis
above 1 one rank decodes.  Pass the model flags the training run used
(``--vocab`` as the training run printed it, with a tokenizer).
``--lookup-k`` excludes ``--speculative-k`` and ``--beam``, and
``--speculative-k`` takes precedence over ``--beam``, as in
``generate.py``; the speculative draft is the checkpoint's first
``--draft-layers`` blocks when a checkpoint is loaded at pipe 1, and a
model of that depth from ``--seed + 1`` otherwise.  The speculative and
lookup runs print their mean accepted proposals a round.  Sampling
(``--temperature``, ``--top-k``, ``--top-p``) comes with the serving
slice (ROADMAP Queue A item 12) and raises.
"""

import argparse
import dataclasses
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(__file__))

from train_lm_torch import parse_mesh  # noqa: E402  (sibling example)

_UNPORTED = (
    # (flag, its value is set, the Queue A item it comes with)
    ("--temperature > 0", lambda a: a.temperature > 0, 12),
    ("--top-k", lambda a: a.top_k > 0, 12),
    ("--top-p", lambda a: a.top_p < 1.0, 12),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh", default="data=-1",
                   help="pipe=P,data=D,expert=X,seq=R,model=M over a "
                        "world of P*D*X*R*M ranks (the layers over pipe, "
                        "rows over data and expert, the experts over "
                        "expert, the KV cache's length over seq, the "
                        "heads over model); without an axis above 1 one "
                        "rank decodes")
    p.add_argument("--moe", action="store_true",
                   help="an MoE model of max(2 x expert axis, 2) experts, "
                        "top-1 (an MoE checkpoint implies its own)")
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=0,
                   help="MLP width (0 = 4 x d_model)")
    p.add_argument("--dtype", default="float32",
                   help="compute dtype (params stay fp32)")
    p.add_argument("--pos-embedding", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--max-len", type=int, default=32)
    p.add_argument("--prompt", default="1,2,3",
                   help="comma-separated token ids (one sequence, "
                        "repeated across the batch)")
    p.add_argument("--tokenizer", default=None,
                   help="bpe.json written by train_lm_torch.py "
                        "--tokenizer-vocab: enables --prompt-text and "
                        "decodes generated ids back to text")
    p.add_argument("--prompt-text", default=None,
                   help="text prompt, encoded with --tokenizer "
                        "(overrides --prompt)")
    p.add_argument("--prompt-file", default=None,
                   help="file with one prompt per line — text (with "
                        "--tokenizer) or comma-separated ids; rows may "
                        "differ in length (right-aligned with padding); "
                        "the batch is the line count")
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="early stopping: rows that emit this token "
                        "freeze (later positions = --pad-id) and "
                        "generation ends when every row is done")
    p.add_argument("--pad-id", type=int, default=0)
    p.add_argument("--beam", type=int, default=0,
                   help="beam size; 0 = greedy")
    p.add_argument("--speculative-k", type=int, default=0,
                   help="speculative decoding: the draft proposes k "
                        "tokens a round (0 = off); the same tokens as "
                        "greedy for a dense model")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="the draft's depth (default n_layers/2)")
    p.add_argument("--lookup-k", type=int, default=0,
                   help="prompt-lookup decoding: propose k tokens from "
                        "the last n-gram's most recent earlier "
                        "occurrence in the context (no draft model); "
                        "the same tokens as greedy for a dense model")
    p.add_argument("--lookup-ngram", type=int, default=2)
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decode")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache with per-(token, head) scales")
    p.add_argument("--vocab-parallel", action="store_true",
                   help="shard the vocabulary over the model axis too")
    p.add_argument("--checkpoint", default=None,
                   help="train_lm_torch.py checkpoint dir to load params "
                        "from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cpu runs on the CPU; default the card")
    return p.parse_args(argv)


def main(argv=None, keep_logits=False):
    """Generate; returns a namespace of ``tokens`` ``(B, max_len)`` (the
    whole batch, on every rank of a mesh; ``(B, beam, max_len)`` best
    first with ``--beam``, and ``scores`` ``(B, beam)``),
    ``mean_accepted`` (speculative and lookup runs, else None),
    ``cfg``, ``params``, ``prompt``, ``prompt_lens`` and, with
    ``keep_logits``, ``logits``: the fp32 logits of every greedy decode
    step (``make_generate_fn(with_logits=True)``)."""
    args = parse_args(argv)
    if args.lookup_k > 0 and (args.speculative_k > 0 or args.beam > 0):
        raise SystemExit(
            "--lookup-k is its own decode mode; drop --speculative-k/"
            "--beam")
    if args.lookup_k > 0 and (args.temperature > 0 or args.top_k > 0
                              or args.top_p < 1.0):
        raise SystemExit(
            "--lookup-k is exact-GREEDY decoding; --temperature/"
            "--top-k/--top-p have no effect there — drop them (for "
            "sampled speculation use --speculative-k)")
    for what, hit, item in _UNPORTED:
        if hit(args):
            raise NotImplementedError(
                f"{what} is not ported to chainermn_tpu_torch yet "
                f"(ROADMAP Queue A item {item})")
    import torch

    from chainermn_tpu_torch import resolve_device
    from chainermn_tpu_torch.datasets import BPETokenizer
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_transformer, make_beam_search_fn,
        make_generate_fn, make_lookup_generate_fn,
        make_speculative_generate_fn, params_from_jax,
        quantize_params_int8, regroup_blocks, shard_params)
    from chainermn_tpu_torch.models.transformer import _check_mesh
    from chainermn_tpu_torch.utils.serialization import load_state

    axes = parse_mesh(args.mesh)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_heads=args.n_heads, d_head=args.d_model // args.n_heads,
        n_kv_heads=args.n_kv_heads, d_ff=args.d_ff or 4 * args.d_model,
        n_layers=args.n_layers, max_seq=args.max_len, attention="local",
        pos_embedding=args.pos_embedding, dtype=args.dtype, remat=False,
        vocab_parallel=args.vocab_parallel, moe=args.moe,
        n_experts=max(2 * axes.get("expert", 1), 2),
        kv_cache_dtype="int8" if args.kv_int8 else "")
    _check_mesh(axes, cfg)
    mesh = None
    if any(n > 1 for n in axes.values()):
        # a world: one process a device, the axes must make it up
        import chainermn_tpu_torch as cmn
        from chainermn_tpu_torch.parallel import MeshConfig

        import torch.distributed as dist

        owns_world = not dist.is_initialized()
        comm = cmn.create_communicator(device=args.device)
        mesh = MeshConfig(comm, **parse_mesh(args.mesh, comm.size))
        dev = comm.device
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.world.rank == 0
    say = print if lead else (lambda *a: None)

    ckpt_file = (os.path.join(args.checkpoint, "lm_state.npz")
                 if args.checkpoint else None)
    if ckpt_file and os.path.exists(ckpt_file):
        saved = load_state(ckpt_file)
        # the blocks are grouped for the pipe axis that trained them (the
        # file records it): regroup them for this decode mesh's
        saved_pipe = int(saved.get("pipe", 1))
        saved_v = int(saved.get("virtual_pipe", 1))
        saved["params"] = dict(saved["params"], blocks=regroup_blocks(
            saved["params"]["blocks"], saved_pipe, axes.get("pipe", 1),
            saved_v, 1))
        if "pos" in saved["params"]:
            # the position table the run trained: up to its length
            cfg = dataclasses.replace(
                cfg, max_seq=saved["params"]["pos"].shape[0])
        if "router" in saved["params"]["blocks"]:
            # the MoE run's experts, however many ranks held them
            cfg = dataclasses.replace(
                cfg, moe=True, router_top_k=int(saved["router_top_k"]),
                n_experts=saved["params"]["blocks"]["router"].shape[-1])
        # the whole tree (JAX layout) is quantized before it is sharded:
        # a scale spans its weight's whole contraction
        host = saved["params"]
        if args.int8:
            host = quantize_params_int8(cfg, host)
        params = params_from_jax(host, cfg, dev, mesh=mesh)
        say(f"loaded {ckpt_file}")
    else:
        host = None
        params = init_transformer(torch.Generator().manual_seed(args.seed),
                                  cfg, device=dev)
        if args.int8:
            params = quantize_params_int8(cfg, params)
        if mesh is not None:
            params = shard_params(mesh, cfg, params)

    tok = BPETokenizer.load(args.tokenizer) if args.tokenizer else None

    def check_ids(ids, what):
        if not ids or any(not 0 <= t < args.vocab for t in ids):
            raise SystemExit(
                f"{what}: prompt ids must be in [0, {args.vocab}) "
                f"and non-empty")
        return ids

    def parse_int_ids(text, what):
        ids = []
        for t in text.split(","):
            if not t.strip():
                continue
            if not t.strip().lstrip("-").isdigit():
                raise SystemExit(
                    f"{what}: expected comma-separated token ids (got "
                    f"{text[:40]!r}) — for text prompts pass --tokenizer")
            ids.append(int(t))
        return ids

    prompt_lens = None
    if args.prompt_file is not None:
        rows = []
        with open(args.prompt_file) as f:
            for i, ln in enumerate(f):
                if not ln.strip():
                    continue
                ln = ln.rstrip("\r\n")
                rows.append(check_ids(
                    tok.encode(ln) if tok is not None else
                    parse_int_ids(ln, f"line {i + 1}"), f"line {i + 1}"))
        if not rows:
            raise SystemExit(f"{args.prompt_file}: no prompts in file")
        P_len = max(len(r) for r in rows)
        prompt_lens = np.asarray([len(r) for r in rows])
        prompt = np.zeros((len(rows), P_len), np.int32)
        for b, r in enumerate(rows):      # right-aligned
            prompt[b, P_len - len(r):] = r
    else:
        if args.prompt_text is not None:
            if tok is None:
                raise SystemExit("--prompt-text needs --tokenizer")
            toks = tok.encode(args.prompt_text)
        else:
            toks = parse_int_ids(args.prompt, "--prompt")
        check_ids(toks, "--prompt")
        prompt = np.tile(np.asarray(toks, np.int32), (args.batchsize, 1))

    def show(ids, label="generated"):
        say(f"{label}:", list(map(int, ids)))
        if tok is not None:
            say(f"{label} text:", repr(tok.decode_text(ids)))

    rows_group = None if mesh is None else mesh.comm("data", "expert")

    def whole(t):
        """The whole batch from each data and expert member's rows."""
        t = t.cpu().numpy()
        if rows_group is not None:
            t = np.concatenate(rows_group.allgather_obj(t))
        return t

    def show_batch(out_np):
        """Each row of a ragged batch, else the first row."""
        if prompt_lens is not None:
            for b in range(out_np.shape[0]):
                start = prompt.shape[1] - int(prompt_lens[b])
                show(out_np[b, start:].tolist(), label=f"row {b}")
        else:
            show(out_np[0].tolist())

    where = dict(device=None if mesh else dev, mesh=mesh)
    logits = scores = mean_acc = None
    if args.lookup_k > 0:
        lk = make_lookup_generate_fn(
            cfg, k=args.lookup_k, ngram=args.lookup_ngram,
            max_len=args.max_len, eos_id=args.eos_id, pad_id=args.pad_id,
            quantized=args.int8, with_stats=True, **where)
        out, mean_acc = lk(params, prompt, prompt_lens=prompt_lens)
        mean_acc = float(mean_acc)
        say(f"prompt-lookup k={args.lookup_k} ngram={args.lookup_ngram}: "
            f"mean accepted proposals/round {mean_acc:.2f} "
            f"(~{mean_acc + 1:.2f} tokens per target read)")
        out_np = whole(out)
        show_batch(out_np)
    elif args.speculative_k > 0:
        d_layers = args.draft_layers or max(1, args.n_layers // 2)
        d_cfg = dataclasses.replace(cfg, n_layers=d_layers)
        if host is not None and axes.get("pipe", 1) == 1:
            # the checkpoint's first d_layers blocks with the shared
            # embedding and norms: a draft whose acceptance reflects the
            # trained model
            d_params = params_from_jax(dict(host, blocks={
                k: v[:, :d_layers] for k, v in host["blocks"].items()}),
                d_cfg, dev, mesh=mesh)
            d_quant = args.int8
            note = "draft = target's first layers"
        else:
            d_params = init_transformer(
                torch.Generator().manual_seed(args.seed + 1), d_cfg,
                device=dev, mesh=mesh)
            d_quant = False
            note = "random draft (mechanics demo — expect ~1 tok/round)"
        say(f"speculative k={args.speculative_k}, {d_layers}-layer "
            f"draft: {note}")
        spec = make_speculative_generate_fn(
            cfg, d_cfg, k=args.speculative_k, max_len=args.max_len,
            eos_id=args.eos_id, pad_id=args.pad_id, quantized=args.int8,
            draft_quantized=d_quant, with_stats=True, **where)
        out, mean_acc = spec(params, d_params, prompt,
                             prompt_lens=prompt_lens)
        mean_acc = float(mean_acc)
        say(f"mean accepted proposals/round: {mean_acc:.2f} "
            f"of k={args.speculative_k} "
            f"(~{mean_acc + 1:.2f} tokens per target read)")
        out_np = whole(out)
        show_batch(out_np)
    elif args.beam > 0:
        bs = make_beam_search_fn(
            cfg, beam_size=args.beam, max_len=args.max_len,
            eos_id=args.eos_id, length_penalty=0.6, quantized=args.int8,
            **where)
        out, scores = bs(params, prompt, prompt_lens=prompt_lens)
        out_np, scores = whole(out), whole(scores)
        if prompt_lens is not None:
            for b in range(out_np.shape[0]):        # best beam per row
                start = prompt.shape[1] - int(prompt_lens[b])
                show(out_np[b, 0, start:].tolist(),
                     label=f"row {b} best (score {scores[b, 0]:+.3f})")
        else:
            for k in range(args.beam):
                show(out_np[0, k].tolist(),
                     label=f"beam {k} (score {scores[0, k]:+.3f})")
    else:
        gen = make_generate_fn(cfg, max_len=args.max_len,
                               eos_id=args.eos_id, pad_id=args.pad_id,
                               quantized=args.int8,
                               with_logits=keep_logits, **where)
        out = gen(params, prompt, prompt_lens=prompt_lens)
        if keep_logits:
            out, logits = out
        out_np = whole(out)
        show_batch(out_np)
    if mesh is not None and owns_world:
        dist.destroy_process_group()
    return types.SimpleNamespace(tokens=torch.as_tensor(out_np),
                                 logits=logits, scores=scores,
                                 mean_accepted=mean_acc, cfg=cfg,
                                 params=params, prompt=prompt,
                                 prompt_lens=prompt_lens, tok=tok)


if __name__ == "__main__":
    main()
