"""Seq2seq NMT data-parallel training on the PyTorch/CUDA port — the same
program as ``seq2seq.py`` through ``chainermn_tpu_torch``: a 2-layer
encoder-decoder LSTM on the synthetic "reverse translation" task
(target = reversed source + EOS, lengths 3-16), each batch padded to one
static shape, ``adam(lr)`` under ``create_multi_node_optimizer``, a
multi-node evaluator an epoch, and greedy exact-match on 64 held-out
pairs at the end.

One process a GPU, launched by ``torchrun`` (ChainerMN's ``mpiexec``):

    torchrun --nproc_per_node 8 examples/seq2seq/seq2seq_torch.py
    python examples/seq2seq/seq2seq_torch.py --device cpu --epoch 1

The data is bitwise ``seq2seq.py``'s (``np.random.RandomState``).  The
weights are numpy's seeded numbers (``init_seq2seq_numpy``), or a JAX
``init_seq2seq`` tree passed to :func:`main` as ``init=``.
``--platform cpu`` is taken as ``--device cpu`` (the JAX example's flag
picks JAX's platform).
"""

import argparse
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

VOCAB, MAX_SRC, MAX_TGT = 50, 16, 17


def make_dataset(n=2048, vocab=50, min_len=3, max_len=16, seed=0):
    """(src, tgt) int32 pairs, tgt = reversed(src) + EOS, variable length
    (``seq2seq.py``'s, number for number)."""
    from chainermn_tpu_torch.models.seq2seq import EOS

    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        length = rng.randint(min_len, max_len + 1)
        src = rng.randint(3, vocab, size=length).astype(np.int32)
        tgt = np.concatenate([src[::-1], [EOS]]).astype(np.int32)
        pairs.append((src, tgt))
    return pairs[: n * 9 // 10], pairs[n * 9 // 10:]


def make_converter(max_src, max_tgt):
    """Pad a ragged batch to ONE static shape."""
    from chainermn_tpu_torch.models.seq2seq import PAD

    def convert(batch):
        srcs, tgts = zip(*batch)
        src = np.full((len(batch), max_src), PAD, np.int32)
        tgt = np.full((len(batch), max_tgt), PAD, np.int32)
        for i, (s, t) in enumerate(zip(srcs, tgts)):
            src[i, : len(s)] = s
            tgt[i, : len(t)] = t
        return src, tgt

    return convert


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--communicator", default="tpu_xla")
    p.add_argument("--batchsize", type=int, default=64)
    p.add_argument("--epoch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--unit", type=int, default=128)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU (the JAX example's flag)")
    p.add_argument("--device", default=None,
                   help="cuda (default: the card, NCCL) or cpu (gloo)")
    p.add_argument("--out", default="result")
    return p.parse_args(argv)


def build(args, init=None, quiet=False):
    """The example's trainer, not yet run: a namespace of ``comm``,
    ``cfg``, ``updater``, ``trainer``, ``log`` (``LogReport``), ``test``
    (this rank's held-out pairs) and ``convert``."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        Seq2seqConfig, init_seq2seq_numpy, seq2seq_loss,
        seq2seq_params_from_jax)

    comm = cmn.create_communicator(args.communicator,
                                   device=args.device or args.platform)
    if comm.rank == 0 and not quiet:
        print(f"world: {comm.size} ranks on {comm.inter_size} nodes, "
              f"device {comm.device}")

    train, test = make_dataset(vocab=VOCAB, max_len=MAX_SRC)
    train = cmn.scatter_dataset(train, comm, shuffle=True, seed=0)
    test = cmn.scatter_dataset(test, comm)
    convert = make_converter(MAX_SRC, MAX_TGT)

    cfg = Seq2seqConfig(src_vocab=VOCAB, tgt_vocab=VOCAB,
                        d_embed=args.unit, d_hidden=args.unit, n_layers=2)
    tree = init if init is not None else init_seq2seq_numpy(cfg, 0)
    params = seq2seq_params_from_jax(tree, cfg, device=comm.device)
    opt = cmn.create_multi_node_optimizer(training.adam(args.lr), comm)

    def loss_fn(params, src, tgt):
        return seq2seq_loss(cfg, params, src, tgt)

    train_it = cmn.SerialIterator(train, args.batchsize, shuffle=True,
                                  seed=1)
    test_it = cmn.SerialIterator(test, args.batchsize, repeat=False)
    updater = cmn.StandardUpdater(train_it, opt, loss_fn, params, comm,
                                  converter=convert)
    trainer = cmn.Trainer(updater, (args.epoch, "epoch"), out=args.out)

    def metrics_fn(params, src, tgt):
        return {"loss": seq2seq_loss(cfg, params, src, tgt)}

    evaluator = cmn.create_multi_node_evaluator(
        cmn.Evaluator(test_it, metrics_fn, comm, converter=convert), comm)
    trainer.extend(evaluator, trigger=(1, "epoch"))
    log = cmn.LogReport(trigger=(1, "epoch"))
    trainer.extend(log)
    if comm.rank == 0 and not quiet:
        trainer.extend(cmn.PrintReport(
            ["epoch", "main/loss", "validation/loss", "elapsed_time"],
            log_report=log))
    return types.SimpleNamespace(comm=comm, cfg=cfg, updater=updater,
                                 trainer=trainer, log=log, test=test,
                                 convert=convert)


def main(argv=None, init=None, quiet=False):
    """Train, then greedy-decode 64 held-out pairs; returns a namespace
    of ``match`` (the exact-match share), ``log`` (the ``LogReport``
    entries) and ``tokens`` (the decoded rows, numpy)."""
    import torch.distributed as dist

    from chainermn_tpu_torch.models import seq2seq_translate

    run = build(parse_args(argv), init=init, quiet=quiet)
    run.trainer.run()
    # the reference printed BLEU; on the synthetic reverse task
    # exact-match is the honest metric
    src, tgt = run.convert(run.test[:64])
    out = seq2seq_translate(run.cfg, run.updater.params, src,
                            max_len=MAX_TGT).cpu().numpy()
    match = float(np.mean(np.all(out == tgt, axis=1)))
    if run.comm.rank == 0 and not quiet:
        print(f"greedy exact-match on {len(src)} held-out pairs: "
              f"{match:.3f}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return types.SimpleNamespace(match=match, log=run.log.log, tokens=out)


if __name__ == "__main__":
    main()
