"""Greedy text generation with the flagship transformer on the
PyTorch/CUDA port — ``generate.py``'s greedy KV-cache path through
``chainermn_tpu_torch``, on one rank or over a mesh's pipe, data,
expert, seq and model axes.
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
Sampling
(``--temperature``, ``--top-k``, ``--top-p``) comes with the serving
slice (ROADMAP Queue A item 12); ``--beam``, ``--speculative-k``,
``--lookup-k``, ``--int8`` and ``--kv-int8`` with the remaining models
and decoders (item 9).  Each raises.
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
    ("--beam", lambda a: a.beam > 0, 9),
    ("--speculative-k", lambda a: a.speculative_k > 0, 9),
    ("--lookup-k", lambda a: a.lookup_k > 0, 9),
    ("--int8", lambda a: a.int8, 9),
    ("--kv-int8", lambda a: a.kv_int8, 9),
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
    p.add_argument("--beam", type=int, default=0)
    p.add_argument("--speculative-k", type=int, default=0)
    p.add_argument("--lookup-k", type=int, default=0)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--kv-int8", action="store_true")
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
    whole batch, on every rank of a mesh),
    ``cfg``, ``params``, ``prompt``, ``prompt_lens`` and, with
    ``keep_logits``, ``logits``: the fp32 logits of every decode step
    (``make_generate_fn(with_logits=True)``)."""
    args = parse_args(argv)
    for what, hit, item in _UNPORTED:
        if hit(args):
            raise NotImplementedError(
                f"{what} is not ported to chainermn_tpu_torch yet "
                f"(ROADMAP Queue A item {item})")
    import torch

    from chainermn_tpu_torch import resolve_device
    from chainermn_tpu_torch.datasets import BPETokenizer
    from chainermn_tpu_torch.models import (
        TransformerConfig, init_transformer, make_generate_fn,
        params_from_jax, regroup_blocks)
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
        n_experts=max(2 * axes.get("expert", 1), 2))
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
        params = params_from_jax(saved["params"], cfg, dev, mesh=mesh)
        say(f"loaded {ckpt_file}")
    else:
        params = init_transformer(torch.Generator().manual_seed(args.seed),
                                  cfg, device=dev, mesh=mesh)

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

    gen = make_generate_fn(cfg, max_len=args.max_len, eos_id=args.eos_id,
                           pad_id=args.pad_id, with_logits=keep_logits,
                           device=None if mesh else dev, mesh=mesh)
    out = gen(params, prompt, prompt_lens=prompt_lens)
    logits = None
    if keep_logits:
        out, logits = out
    out_np = out.cpu().numpy()
    if mesh is not None:
        # the whole batch: each data and expert member's rows, in order
        out_np = np.concatenate(
            mesh.comm("data", "expert").allgather_obj(out_np))
        out = torch.as_tensor(out_np)
    if prompt_lens is not None:
        for b in range(out_np.shape[0]):
            start = prompt.shape[1] - int(prompt_lens[b])
            show(out_np[b, start:].tolist(), label=f"row {b}")
    else:
        show(out_np[0].tolist())
    if mesh is not None and owns_world:
        dist.destroy_process_group()
    return types.SimpleNamespace(tokens=out, logits=logits, cfg=cfg,
                                 params=params, prompt=prompt,
                                 prompt_lens=prompt_lens, tok=tok)


if __name__ == "__main__":
    main()
