"""Large-batch ResNet-50 on the PyTorch/CUDA port — the same recipe as
``train_imagenet_large_batch.py`` (the "15-minute ImageNet"
configuration, BASELINE.md config 5) through ``chainermn_tpu_torch``:

- linear LR scaling, lr = base_lr × global_batch / 256, with a linear
  warm-up over ``--warmup-epochs`` and cosine decay after it;
- a bf16 gradient wire (``--grad-dtype``);
- ChainerMN's double buffering: one-step-stale reduced gradients, the
  exchange of step t on a communication stream under step t+1
  (``--no-double-buffering`` turns it off);
- ``--optimizer lars`` or ``lamb`` (layer-wise trust ratios) or
  ``sgd`` with momentum;
- ``--steps-per-execution N``: N updates a window, one CUDA graph on the
  card;
- ``--resumable``: the checkpointer and the SIGTERM preemption
  checkpointer under ``--out``, resuming where a job stopped.

One process a GPU, launched by ``torchrun`` (ChainerMN's ``mpiexec``):

    torchrun --nproc_per_node 8 examples/imagenet/train_imagenet_large_batch_torch.py --optimizer lars
    python examples/imagenet/train_imagenet_large_batch_torch.py --tiny --platform cpu

``--batchsize`` is the global batch (1024, as in the JAX example); each
rank iterates its ``scatter_dataset`` shard with ``batchsize // world``.
``--platform cpu`` runs on the CPU over gloo (the JAX example's flag
picks JAX's platform).  ``--tiny`` is the 32 px, width-8 smoke run on
512 images.  Weights come from numpy seed 0; the data is
``train_imagenet_torch.py``'s (lazy synthetic images unless
``--train-npz`` names arrays ``x``/``y``).
"""

import argparse
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(__file__))

from train_imagenet_torch import make_dataset  # noqa: E402  (sibling)


def make_lr_schedule(base_lr, global_batch, warmup_epochs, total_epochs,
                     steps_per_epoch):
    """Linear scaling, gradual warm-up, cosine decay (the JAX example's
    schedule over the port's copies of optax's schedules)."""
    from chainermn_tpu_torch import training

    scaled = base_lr * global_batch / 256.0
    warmup_steps = max(int(warmup_epochs * steps_per_epoch), 1)
    decay_steps = max(
        int((total_epochs - warmup_epochs) * steps_per_epoch), 1)
    return training.join_schedules(
        [training.linear_schedule(base_lr, scaled, warmup_steps),
         training.cosine_decay_schedule(scaled, decay_steps)],
        boundaries=[warmup_steps])


def make_inner(name, schedule):
    """The inner optimizer the JAX example picks by ``--optimizer``."""
    from chainermn_tpu_torch import training

    return {
        # LARS per You et al. / MLPerf: trust ratio over weight-decayed
        # gradients, momentum 0.9
        "lars": lambda: training.lars(schedule, weight_decay=1e-4,
                                      momentum=0.9),
        "lamb": lambda: training.lamb(schedule, weight_decay=1e-4),
        "sgd": lambda: training.sgd(schedule, momentum=0.9),
    }[name]()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--communicator", default="tpu_xla")
    p.add_argument("--batchsize", type=int, default=1024,
                   help="global batch (the paper used 32k over 1024 GPUs)")
    p.add_argument("--epoch", type=int, default=4)
    p.add_argument("--base-lr", type=float, default=0.1)
    p.add_argument("--warmup-epochs", type=float, default=1.0)
    p.add_argument("--no-double-buffering", action="store_true")
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "lars", "lamb"],
                   help="inner optimizer; lars/lamb are the layer-wise "
                        "adaptive large-batch recipes")
    p.add_argument("--steps-per-execution", type=int, default=1,
                   help="optimizer updates a window (one CUDA graph)")
    p.add_argument("--resumable", action="store_true",
                   help="periodic + preemption (SIGTERM) checkpoints "
                        "under --out, with automatic resume")
    p.add_argument("--grad-dtype", default="bfloat16")
    p.add_argument("--train-npz", default=None)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU over gloo; default the card")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default="result_large_batch")
    return p.parse_args(argv)


def build(args, quiet=False, accum_steps=1, iterator=None, n_images=None):
    """The example's trainer, not yet run: a namespace of ``comm``,
    ``cfg``, ``image``, ``schedule``, ``updater``, ``trainer``,
    ``checkpointer`` (None without ``--resumable``), ``resumed_at`` and
    ``log`` (rank 0's ``LogReport``; None on the other ranks).
    ``accum_steps``, ``iterator`` (this rank's batch iterator, in place
    of a ``SerialIterator`` over the shard) and ``n_images`` are for
    callers that drive the recipe at other settings; the command line
    leaves them at their defaults."""
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.datasets import SubDataset
    from chainermn_tpu_torch.models import (
        ResNetConfig, accuracy, init_resnet_numpy, resnet_apply,
        resnet_params_from_jax, softmax_cross_entropy)

    comm = cmn.create_communicator(args.communicator, device=args.platform)
    if comm.rank == 0 and not quiet:
        print(f"world: {comm.size} ranks on {comm.inter_size} nodes, "
              f"device {comm.device}")

    if args.tiny:
        image, classes, n = 32, 8, 512
        batch = min(args.batchsize, 128)
        cfg = ResNetConfig(depth=50, num_classes=classes, width=8,
                           dtype="float32")
    else:
        image, classes, n = 224, 1000, 50000
        batch = args.batchsize
        cfg = ResNetConfig(depth=50, num_classes=classes)
    if batch % comm.size:
        raise SystemExit(f"--batchsize {batch} does not divide over "
                         f"{comm.size} ranks")
    local_batch = batch // comm.size

    data = make_dataset(n_images or n, image, classes, npz=args.train_npz)
    split = len(data) * 9 // 10
    train = cmn.scatter_dataset(SubDataset(data, np.arange(split)), comm,
                                shuffle=True, seed=0)
    test = cmn.scatter_dataset(SubDataset(data, np.arange(split, len(data))),
                               comm)

    # an update takes accum_steps local batches: the schedule counts
    # updates, and an epoch is one sweep of this rank's shard
    steps_per_epoch = max(len(train) // (local_batch * accum_steps), 1)
    schedule = make_lr_schedule(args.base_lr, batch * accum_steps,
                                args.warmup_epochs, args.epoch,
                                steps_per_epoch)

    params, state = resnet_params_from_jax(
        *init_resnet_numpy(cfg, 0), cfg, device=comm.device)

    def loss_fn(params, state, x, y):
        logits, new_state = resnet_apply(cfg, params, state, x, train=True,
                                         comm=comm)
        return softmax_cross_entropy(logits, y), new_state

    opt = cmn.create_multi_node_optimizer(
        make_inner(args.optimizer, schedule), comm,
        double_buffering=not args.no_double_buffering,
        allreduce_grad_dtype=(getattr(torch, args.grad_dtype)
                              if args.grad_dtype else None))
    train_it = iterator if iterator is not None else cmn.SerialIterator(
        train, local_batch, shuffle=True, seed=1)
    test_it = cmn.SerialIterator(test, local_batch, repeat=False)
    updater = cmn.StandardUpdater(
        train_it, opt, loss_fn, params, comm, state=state,
        steps_per_execution=args.steps_per_execution,
        accum_steps=accum_steps)
    trainer = cmn.Trainer(updater, (args.epoch, "epoch"), out=args.out)

    cp, resumed_at = None, None
    if args.resumable:
        cp = cmn.extensions.create_multi_node_checkpointer(comm, args.out)
        resumed_at = cp.maybe_load(updater, trainer)
        if resumed_at is not None and comm.rank == 0 and not quiet:
            print(f"resumed at iteration {resumed_at}")
        # the checkpointer's trigger counts iterations, which count
        # microbatches: once an epoch
        trainer.extend(cp, trigger=(max(len(train) // local_batch, 1),
                                    "iteration"))
        trainer.extend(cmn.extensions.PreemptionCheckpointer(cp, comm))

    def metrics_fn(bundle, x, y):
        params, state = bundle
        logits, _ = resnet_apply(cfg, params, state, x, train=False)
        return {"loss": softmax_cross_entropy(logits, y),
                "accuracy": accuracy(logits, y)}

    evaluator = cmn.create_multi_node_evaluator(
        cmn.Evaluator(test_it, metrics_fn, comm,
                      get_params=lambda tr: (tr.updater.params,
                                             tr.updater.state)), comm)
    trainer.extend(evaluator, trigger=(1, "epoch"))
    log = None
    if comm.rank == 0:   # rank 0 reports, ChainerMN's convention
        log = cmn.LogReport(trigger=(1, "epoch"))
        trainer.extend(log)
        if not quiet:
            trainer.extend(cmn.PrintReport(
                ["epoch", "main/loss", "validation/loss",
                 "validation/accuracy", "elapsed_time"], log_report=log))
    return types.SimpleNamespace(
        comm=comm, cfg=cfg, image=image, schedule=schedule,
        updater=updater, trainer=trainer, checkpointer=cp,
        resumed_at=resumed_at, log=log)


def main(argv=None):
    import torch.distributed as dist

    run = build(parse_args(argv))
    run.trainer.run()
    log = run.log
    if log is not None and log.log:
        print(f"final validation accuracy: "
              f"{log.log[-1].get('validation/accuracy', float('nan')):.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return log


if __name__ == "__main__":
    main()
