"""Model-parallel MNIST on the PyTorch/CUDA port — the same program as
``train_mnist_model_parallel.py`` through ``chainermn_tpu_torch``.

The MLP is split across two pipeline ranks with
:class:`~chainermn_tpu_torch.links.MultiNodeChainList`: pipe rank 0 owns
``[784, 256, 256]``, pipe rank 1 owns ``[256, 10]``; activations go
0 → 1 over a differentiable send and the gradients come back in its
backward.  Every other rank is a data-parallel replica: the JAX
example's mesh is ``(pipe=2, data=world/2)``, and global rank ``r``
sits at ``(r // (world/2), r % (world/2))`` as in the JAX package's
``MeshConfig``, so each data replica holds the same rows of each batch
on both stages as the JAX run does.  The pipe and data groups come from
``comm.split``; each stage averages its gradients over its data group
through ``create_multi_node_optimizer``.

One process a GPU, launched by ``torchrun``:

    torchrun --nproc_per_node 4 examples/mnist/train_mnist_model_parallel_torch.py
    torchrun --nproc_per_node 2 examples/mnist/train_mnist_model_parallel_torch.py --device cpu

``--batchsize`` is the global batch.  Weights come from numpy's seeds 0
(lower half) and 1 (upper half).  ``--iterations`` stops early;
``--out DIR`` has rank 0 write every iteration's loss to
``DIR/log.json``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batchsize", type=int, default=128)
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after this many iterations")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="cuda (default: the card, NCCL) or cpu (gloo)")
    p.add_argument("--out", default=None,
                   help="rank 0 writes the losses and epochs to "
                        "OUT/log.json")
    return p.parse_args(argv)


def train(args, comm=None, quiet=False):
    """Run the example on ``comm`` (default: the world).  Returns, on
    every rank, a dict of the per-iteration losses (the mean over the
    data group) and wall times in ms (host clock; each iteration ends
    by reading its loss, which waits for the device), the per-epoch
    mean losses and validation accuracies, and this rank's ``(pipe,
    data)`` coordinates."""
    import time

    import numpy as np
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.links import MultiNodeChainList
    from chainermn_tpu_torch.models import (
        accuracy, init_mlp_numpy, mlp_apply, softmax_cross_entropy)
    from train_mnist_torch import make_dataset   # the same dataset

    if comm is None:
        comm = cmn.create_communicator(device=args.device)
    if comm.size < 2 or comm.size % 2:
        raise SystemExit(f"needs an even world of >= 2 ranks for pipe=2, "
                         f"have {comm.size}")
    dp = comm.size // 2
    pipe_idx, data_idx = divmod(comm.rank, dp)
    pipe = comm.split(color=data_idx, key=pipe_idx)
    data = comm.split(color=pipe_idx, key=data_idx)
    if comm.rank == 0 and not quiet:
        print(f"mesh: pipe=2 data={dp}, device {comm.device}")

    mn = MultiNodeChainList(pipe)
    mn.add_link(lambda s: init_mlp_numpy([784, 256, 256], s), mlp_apply,
                owner=0, rank_out=1, name="lower_half")
    mn.add_link(lambda s: init_mlp_numpy([256, 10], s), mlp_apply,
                owner=1, rank_in=0, name="upper_half")
    mn.load_params(mn.init(seed=0))
    params = mn.params[pipe_idx]

    train_set, test_set = make_dataset()
    xs = np.stack([x for x, _ in train_set])
    ys = np.stack([y for _, y in train_set])
    xt = np.stack([x for x, _ in test_set])
    yt = np.stack([y for _, y in test_set])

    opt = cmn.create_multi_node_optimizer(training.sgd(args.lr), data)
    opt_state = opt.init(params)

    def rows(a, idx):
        # this data replica's share of the global rows, P("data")
        b = len(idx) // dp
        return torch.as_tensor(a[idx[data_idx * b:(data_idx + 1) * b]],
                               device=comm.device)

    bs = max(args.batchsize // dp, 1) * dp      # divisible by the data axis
    n_eval = len(xt) // dp * dp
    n_batches = len(xs) // bs
    losses, times, epochs = [], [], []
    for epoch in range(args.epoch):
        perm = np.random.RandomState(epoch).permutation(len(xs))
        total = 0.0
        for i in range(n_batches):
            t0 = time.perf_counter()
            idx = perm[i * bs:(i + 1) * bs]
            x, y = rows(xs, idx), rows(ys, idx)
            loss = softmax_cross_entropy(mn(x), y)
            loss.backward()
            grads = mn.reduce_grads(mn.grads())[pipe_idx]
            opt.update(grads, opt_state, params)
            for t in mn.parameters():
                t.grad = None
            losses.append(float(data.allreduce(loss.detach(), "mean")))
            times.append((time.perf_counter() - t0) * 1e3)
            total += losses[-1]
            if args.iterations and len(losses) >= args.iterations:
                break
        with torch.no_grad():
            idx = np.arange(n_eval)
            acc = float(data.allreduce(accuracy(mn(rows(xt, idx)),
                                                rows(yt, idx)), "mean"))
        epochs.append({"epoch": epoch + 1,
                       "main/loss": total / (i + 1),
                       "validation/accuracy": acc})
        if comm.rank == 0 and not quiet:
            print(f"epoch={epoch + 1}  main/loss={total / (i + 1):.4f}  "
                  f"validation/accuracy={acc:.4f}")
        if args.iterations and len(losses) >= args.iterations:
            break
    out = {"losses": losses, "iteration_ms": times, "epochs": epochs,
           "coords": (pipe_idx, data_idx)}
    if args.out and comm.rank == 0:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "log.json"), "w") as f:
            json.dump(dict(out, world=comm.size, device=str(comm.device)),
                      f, indent=1)
    return out


def main(argv=None):
    import torch.distributed as dist

    out = train(parse_args(argv))
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
