"""chainermn_tpu_torch — the PyTorch/CUDA port of ``chainermn_tpu`` for
NVIDIA Hopper (H100).

It imports neither JAX nor ``chainermn_tpu``.  The port grows slice by
slice (ROADMAP.md).  It holds the flagship transformer on one card —
scoring through :func:`models.make_forward_fn`, whose attention runs a
hand-written flash-attention forward kernel (``csrc/flash_fwd.cu``),
greedy KV-cache generation through :func:`models.make_generate_fn`,
and training through :func:`models.make_train_step`, whose backward
runs the hand-written dq and dk/dv kernels (``csrc/flash_bwd.cu``) —
and ChainerMN's data-parallel training path: :func:`create_communicator`
(``torch.distributed``, NCCL on the card), :func:`scatter_dataset`,
:class:`SerialIterator`, :func:`create_multi_node_optimizer` (fused
bf16 bucket all-reduce), :class:`StandardUpdater`, :class:`Trainer` and
:func:`create_multi_node_evaluator`, running ResNet with synchronised
BN or the MNIST MLP — and its fault tolerance
(:mod:`chainermn_tpu_torch.extensions`: per-rank CRC-checked
checkpoints with fallback resume, preemption, the except hook, the
watchdog).  Entry points run on CUDA unless the caller passes
``device="cpu"`` (see :func:`resolve_device`).
"""

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch import (
    communicators,
    datasets,
    extensions,
    iterators,
    links,
    models,
    ops,
    parallel,
    training,
    utils,
)
from chainermn_tpu_torch.communicators import (
    create_communicator,
    init_distributed,
)
from chainermn_tpu_torch.datasets import scatter_dataset
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.training import (
    Evaluator,
    LogReport,
    PrintReport,
    StandardUpdater,
    Trainer,
    create_multi_node_evaluator,
    create_multi_node_optimizer,
)

__all__ = [
    "Evaluator", "LogReport", "PrintReport", "SerialIterator",
    "StandardUpdater", "Trainer", "communicators", "create_communicator",
    "create_multi_node_checkpointer", "create_multi_node_evaluator",
    "create_multi_node_optimizer", "datasets", "extensions",
    "init_distributed", "iterators", "links", "models", "ops", "parallel",
    "resolve_device", "scatter_dataset", "training", "utils",
]
