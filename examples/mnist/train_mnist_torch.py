"""MNIST MLP data-parallel training on the PyTorch/CUDA port — the same
program as ``train_mnist.py`` through ``chainermn_tpu_torch``.

One process a GPU, launched by ``torchrun`` (ChainerMN's ``mpiexec``):

    torchrun --nproc_per_node 4 examples/mnist/train_mnist_torch.py
    torchrun --nproc_per_node 4 examples/mnist/train_mnist_torch.py --device cpu
    python examples/mnist/train_mnist_torch.py --device cpu   # one rank

``--batchsize`` is the global batch, as in ``train_mnist.py``; each rank
iterates its ``scatter_dataset`` shard with ``batchsize // world``.  The
data is the same synthetic MNIST-shaped set unless ``--mnist-npz``
names a downloaded ``mnist.npz``.  Weights come from numpy's seed 0.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def make_dataset(npz_path=None, n=4096, seed=0):
    import numpy as np

    if npz_path and os.path.exists(npz_path):
        d = np.load(npz_path)
        train = list(zip(d["x_train"].astype("float32") / 255.0,
                         d["y_train"].astype("int32")))
        test = list(zip(d["x_test"].astype("float32") / 255.0,
                        d["y_test"].astype("int32")))
        return train, test
    # synthetic, linearly-separable-ish 10-class images
    rng = np.random.RandomState(seed)
    protos = rng.randn(10, 784).astype("float32")
    xs = []
    for i in range(n):
        c = i % 10
        xs.append((protos[c] + 0.3 * rng.randn(784).astype("float32"),
                   np.int32(c)))
    return xs[: n * 9 // 10], xs[n * 9 // 10:]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--communicator", default="tpu_xla")
    p.add_argument("--batchsize", type=int, default=128,
                   help="global batch size")
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="cuda (default: the card, NCCL) or cpu (gloo)")
    p.add_argument("--mnist-npz", default=None)
    p.add_argument("--out", default="result")
    return p.parse_args(argv)


def train(args, params=None, quiet=False):
    """Run the example; returns rank 0's ``LogReport`` (None on the
    other ranks).  ``params`` (a list of ``{"w", "b"}`` tensors)
    replaces the seeded initial weights."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.models import (
        accuracy, init_mlp_numpy, mlp_apply, mlp_params_from_jax,
        softmax_cross_entropy)

    comm = cmn.create_communicator(args.communicator, device=args.device)
    if comm.rank == 0 and not quiet:
        print(f"world: {comm.size} ranks on {comm.inter_size} nodes, "
              f"device {comm.device}")
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} does not divide "
                         f"over {comm.size} ranks")
    local_batch = args.batchsize // comm.size

    train_set, test_set = make_dataset(args.mnist_npz)
    train_set = cmn.scatter_dataset(train_set, comm, shuffle=True, seed=0)
    test_set = cmn.scatter_dataset(test_set, comm)
    train_it = cmn.SerialIterator(train_set, local_batch, shuffle=True,
                                  seed=1)
    test_it = cmn.SerialIterator(test_set, local_batch, repeat=False)

    if params is None:
        params = mlp_params_from_jax(init_mlp_numpy([784, 256, 256, 10], 0),
                                     device=comm.device)
    opt = cmn.create_multi_node_optimizer(training.sgd(args.lr), comm)

    def loss_fn(params, x, y):
        return softmax_cross_entropy(mlp_apply(params, x), y)

    def metrics_fn(params, x, y):
        logits = mlp_apply(params, x)
        return {"loss": softmax_cross_entropy(logits, y),
                "accuracy": accuracy(logits, y)}

    updater = cmn.StandardUpdater(train_it, opt, loss_fn, params, comm)
    trainer = cmn.Trainer(updater, (args.epoch, "epoch"), out=args.out)
    evaluator = cmn.create_multi_node_evaluator(
        cmn.Evaluator(test_it, metrics_fn, comm), comm)
    trainer.extend(evaluator, trigger=(1, "epoch"))
    log = None
    if comm.rank == 0:   # rank 0 reports, ChainerMN's convention
        log = cmn.LogReport(trigger=(1, "epoch"))
        trainer.extend(log)
        if not quiet:
            trainer.extend(cmn.PrintReport(
                ["epoch", "main/loss", "validation/loss",
                 "validation/accuracy", "elapsed_time"], log_report=log))
    trainer.run()
    if log is not None and log.log and not quiet:
        print(f"final validation accuracy: "
              f"{log.log[-1].get('validation/accuracy', float('nan')):.4f}")
    return log


def main(argv=None):
    import torch.distributed as dist

    log = train(parse_args(argv))
    if dist.is_initialized():
        dist.destroy_process_group()
    return log


if __name__ == "__main__":
    main()
