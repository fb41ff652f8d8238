"""ImageNet data-parallel training on the PyTorch/CUDA port — the same
program as ``train_imagenet.py`` through ``chainermn_tpu_torch``:
ResNet-50 with synchronised BN (or ``--arch alex``, ``nin``, ``vgg16``,
``googlenet``), bf16 compute, ``sgd(0.1, momentum=0.9)`` and, with
``--grad-dtype bfloat16``, a bf16 gradient wire.

One process a GPU, launched by ``torchrun`` (ChainerMN's ``mpiexec``):

    torchrun --nproc_per_node 8 examples/imagenet/train_imagenet_torch.py --grad-dtype bfloat16
    python examples/imagenet/train_imagenet_torch.py --tiny --device cpu

``--batchsize`` is the global batch, as in ``train_imagenet.py``; each
rank iterates its ``scatter_dataset`` shard with ``batchsize // world``.
The data is the lazy synthetic ImageNet-shaped set unless
``--train-npz`` names arrays ``x``/``y``; ``--tiny`` is the 32 px
CPU smoke run (ResNet at width 8; the convnets with the
global-average-pool head in fp32); at full size the convnets take the
reference geometry at 224 px (``head="flatten"``), and GoogLeNet trains
on ``main + 0.3·(aux_4a + aux_4d)``.  Weights come from numpy's seed
``--seed`` (0).  ``--loader native`` materialises this rank's shard
once and batches it with the C++ loader (``chainermn_tpu_torch.native``,
built with ``g++`` on first use).
"""

import argparse
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


class SyntheticImages:
    """Lazy ImageNet-shaped dataset: images are generated per __getitem__
    (a full list would be ~30 GB at 50k × 224²×3 fp32), deterministically
    from the index so every process sees the same logical dataset."""

    def __init__(self, n, image, classes, seed=0):
        self.n, self.image, self.classes = n, image, classes
        self.protos = np.random.RandomState(seed).randn(
            classes, 8).astype("float32")

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        i = int(i)
        c = i % self.classes
        rng = np.random.RandomState(1_000_003 + i)
        # class signal in a low-dim projection so tiny runs can learn it
        x = 0.3 * rng.randn(self.image, self.image, 3).astype("float32")
        x[:8, 0, 0] += self.protos[c]
        return x, np.int32(c)


def make_dataset(n, image, classes, npz=None, seed=0):
    if npz and os.path.exists(npz):
        d = np.load(npz)
        return list(zip(d["x"].astype("float32"), d["y"].astype("int32")))
    return SyntheticImages(n, image, classes, seed)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--communicator", default="tpu_xla")
    p.add_argument("--arch", default="resnet50",
                   choices=["resnet50", "resnet101", "resnet152",
                            "alex", "nin", "vgg16", "googlenet"])
    p.add_argument("--batchsize", type=int, default=256,
                   help="global batch size")
    p.add_argument("--epoch", type=int, default=2)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop (and evaluate) after this many iterations "
                        "instead of --epoch epochs")
    p.add_argument("--n-images", type=int, default=None,
                   help="synthetic dataset size (default 512 with --tiny, "
                        "else 50000)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0,
                   help="numpy seed of the initial weights")
    p.add_argument("--grad-dtype", default=None,
                   help="allreduce_grad_dtype, e.g. bfloat16")
    p.add_argument("--train-npz", default=None)
    p.add_argument("--loader", default="serial",
                   choices=["serial", "native"])
    p.add_argument("--device", default=None,
                   help="cuda (default: the card, NCCL) or cpu (gloo)")
    p.add_argument("--tiny", action="store_true",
                   help="32px/width-8 model on 512 images (CPU smoke run)")
    p.add_argument("--out", default="result")
    return p.parse_args(argv)


def build(args, quiet=False, init=None):
    """The example's trainer, not yet run (from ``init``, a JAX-layout
    parameter tree — ``(params, state)`` for ResNet — where given, else
    numpy's seeded weights): a namespace of ``comm``,
    ``cfg``, ``image`` (the side in pixels), ``updater``, ``trainer``,
    ``evaluator`` and ``log`` (rank 0's ``LogReport``; None on the other
    ranks, so they do not write the same file)."""
    import torch

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.datasets import SubDataset
    from chainermn_tpu_torch.models import (
        ConvNetConfig, ResNetConfig, accuracy, convnet_apply,
        convnet_params_from_jax, init_convnet_numpy, init_resnet_numpy,
        resnet_apply, resnet_params_from_jax, softmax_cross_entropy)

    resnet = args.arch.startswith("resnet")
    comm = cmn.create_communicator(args.communicator, device=args.device)
    if comm.rank == 0 and not quiet:
        print(f"world: {comm.size} ranks on {comm.inter_size} nodes, "
              f"device {comm.device}")
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} does not divide "
                         f"over {comm.size} ranks")
    local_batch = args.batchsize // comm.size

    if args.tiny:
        image, classes, n = 32, 8, 512
        # the flatten heads need near-native sizes (32 px collapses)
        cfg = (ResNetConfig(depth=50, num_classes=classes, width=8,
                            dtype="float32") if resnet
               else ConvNetConfig(arch=args.arch, num_classes=classes,
                                  dtype="float32", head="gap"))
    else:
        image, classes, n = 224, 1000, 50000
        cfg = (ResNetConfig(depth=int(args.arch[6:]), num_classes=classes)
               if resnet
               else ConvNetConfig(arch=args.arch, num_classes=classes,
                                  image_size=image))
    n = args.n_images or n

    data = make_dataset(n, image, classes, npz=args.train_npz)
    split = len(data) * 9 // 10
    train_set = SubDataset(data, np.arange(split))
    test_set = SubDataset(data, np.arange(split, len(data)))
    train_set = cmn.scatter_dataset(train_set, comm, shuffle=True, seed=0)
    test_set = cmn.scatter_dataset(test_set, comm)

    if resnet:
        params, state = resnet_params_from_jax(
            *(init or init_resnet_numpy(cfg, args.seed)), cfg,
            device=comm.device)

        def loss_fn(params, state, x, y):
            logits, new_state = resnet_apply(cfg, params, state, x,
                                             train=True, comm=comm)
            return softmax_cross_entropy(logits, y), new_state
    else:
        params, state = convnet_params_from_jax(
            init if init is not None else init_convnet_numpy(cfg, args.seed),
            cfg, device=comm.device), None
        if args.arch == "googlenet":
            # the Inception recipe: main + 0.3·(aux_4a + aux_4d)
            def loss_fn(params, x, y):
                logits, a1, a2 = convnet_apply(cfg, params, x,
                                               with_aux=True)
                return (softmax_cross_entropy(logits, y)
                        + 0.3 * (softmax_cross_entropy(a1, y)
                                 + softmax_cross_entropy(a2, y)))
        else:
            def loss_fn(params, x, y):
                return softmax_cross_entropy(convnet_apply(cfg, params, x),
                                             y)

    opt = cmn.create_multi_node_optimizer(
        training.sgd(args.lr, momentum=0.9), comm,
        allreduce_grad_dtype=(getattr(torch, args.grad_dtype)
                              if args.grad_dtype else None))
    if args.loader == "native":
        from chainermn_tpu_torch.native import NativeBatchIterator

        # the native loader batches memory-resident field arrays:
        # materialise this rank's shard once up front — bounded, because
        # a full-size synthetic shard would be tens of GB
        # (SyntheticImages is lazy for exactly that reason)
        est = len(train_set) * image * image * 3 * 4
        if est > 4 << 30:
            raise SystemExit(
                f"--loader native materialises the local shard "
                f"(~{est / 2**30:.0f} GB here): use --tiny or point "
                "--train-npz at a real on-disk dataset")
        xs = np.stack([train_set[i][0] for i in range(len(train_set))])
        ys = np.asarray([train_set[i][1] for i in range(len(train_set))],
                        np.int32)
        # its batches are views into recycled slots; the updater's move
        # to the device (a synchronous copy on the card) has read a
        # batch, and on the CPU the step has used it, before the next
        # pull releases the slot, so no converter copies them out
        train_it = NativeBatchIterator([xs, ys], local_batch, shuffle=True,
                                       seed=1)
    else:
        train_it = cmn.SerialIterator(train_set, local_batch, shuffle=True,
                                      seed=1)
    test_it = cmn.SerialIterator(test_set, local_batch, repeat=False)
    updater = cmn.StandardUpdater(train_it, opt, loss_fn, params, comm,
                                  state=state)
    stop = ((args.iterations, "iteration") if args.iterations
            else (args.epoch, "epoch"))
    trainer = cmn.Trainer(updater, stop, out=args.out)

    def metrics_fn(bundle, x, y):
        params, state = bundle
        logits = (resnet_apply(cfg, params, state, x, train=False)[0]
                  if resnet else convnet_apply(cfg, params, x))
        return {"loss": softmax_cross_entropy(logits, y),
                "accuracy": accuracy(logits, y)}

    evaluator = cmn.create_multi_node_evaluator(
        cmn.Evaluator(test_it, metrics_fn, comm,
                      get_params=lambda tr: (tr.updater.params,
                                             tr.updater.state)), comm)
    trigger = (args.iterations, "iteration") if args.iterations \
        else (1, "epoch")
    trainer.extend(evaluator, trigger=trigger)
    log = None
    if comm.rank == 0:   # rank 0 reports, ChainerMN's convention
        log = cmn.LogReport(trigger=trigger)
        trainer.extend(log)
        if not quiet:
            trainer.extend(cmn.PrintReport(
                ["epoch", "iteration", "main/loss", "validation/loss",
                 "validation/accuracy", "elapsed_time"], log_report=log),
                trigger=trigger)
    return types.SimpleNamespace(comm=comm, cfg=cfg, image=image,
                                 updater=updater,
                                 trainer=trainer, evaluator=evaluator,
                                 log=log)


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
