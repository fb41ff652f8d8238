"""Communicator factory and the process group's start — the port of the
JAX package's ``communicators/__init__.py``.

ChainerMN shipped seven communicators that were all all-reduce
algorithms over MPI/NCCL; the JAX package collapsed them into
``tpu_xla`` plus ``loopback``, and so does the port: ``"tpu_xla"`` and
the legacy names (which warn) map to :class:`TorchDistCommunicator`,
NCCL on the card and gloo on the CPU.

The process model is ChainerMN's: one process a GPU, launched by
``torchrun`` (``mpiexec`` then).  :func:`init_distributed` reads
torchrun's environment, or starts a one-rank world when there is none.
``create_communicator(ranks=)`` builds a communicator over some of the
launch's ranks (the JAX factory's ``devices=``): the live resize's
worlds, each a prefix of the launch.
"""

from __future__ import annotations

import os
import socket
import warnings
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from chainermn_tpu_torch._device import resolve_device

from ._obj_channel import (
    DataSizeError,
    KVObjectChannel,
    StaleGenerationError,
)
from .base import CommunicatorBase
from .loopback import LoopbackCommunicator
from .torch_dist import DEFAULT_TIMEOUT, TorchDistCommunicator

_LEGACY_ALIASES = {
    "naive": "tpu_xla",
    "flat": "tpu_xla",
    "hierarchical": "tpu_xla",
    "two_dimensional": "tpu_xla",
    "single_node": "tpu_xla",
    "non_cuda_aware": "tpu_xla",
    "pure_nccl": "tpu_xla",
}

__all__ = [
    "CommunicatorBase",
    "DataSizeError",
    "KVObjectChannel",
    "LoopbackCommunicator",
    "StaleGenerationError",
    "TorchDistCommunicator",
    "create_communicator",
    "init_distributed",
]


# the key-value store of the world init_distributed started (None when
# the default group was started elsewhere)
_STORE = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device=None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Start the default process group — the ``mpiexec -n N`` moment.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    without that environment it starts a one-rank world on a free local
    port.  ``init_method`` (e.g. ``file://...``) with ``world_size`` and
    ``rank`` names the rendezvous explicitly.  The rendezvous's
    key-value store is kept: communicators built on this world carry it
    as ``comm.store``.  On CUDA (the default
    device) it selects ``cuda:LOCAL_RANK`` before NCCL starts and uses
    the NCCL backend, which must be present; ``device="cpu"`` uses gloo.
    A second call does nothing."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    if init_method is None and "RANK" in env and "WORLD_SIZE" in env:
        init_method = "env://"
        rank = int(env["RANK"]) if rank is None else rank
        world_size = int(env["WORLD_SIZE"]) if world_size is None \
            else world_size
    elif init_method is None:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        rank, world_size = 0, 1
    if rank is None or world_size is None:
        raise ValueError(f"init_method {init_method!r} needs rank and "
                         "world_size")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL backend; the port "
                               "does not fall back to gloo on CUDA")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    # the rendezvous that init_process_group would run, made here so the
    # world's key-value store stays reachable (the watchdog's cross-rank
    # heartbeats); the group gets its own prefix, as it would itself
    global _STORE
    store, rank, world_size = next(dist.rendezvous(
        init_method, rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    _STORE = store


def create_communicator(
    communicator_name: str = "tpu_xla",
    allreduce_grad_dtype=None,
    device=None,
    batched_copy: bool = True,
    timeout: timedelta = DEFAULT_TIMEOUT,
    ranks=None,
) -> CommunicatorBase:
    """Create a communicator over every rank of the default process
    group (started by :func:`init_distributed` here if it is not yet),
    or over ``ranks``.

    Args:
      communicator_name: ``"tpu_xla"`` (``torch.distributed``: NCCL on
        CUDA, gloo on the CPU), ``"loopback"`` (size 1, no process
        group), or a legacy ChainerMN name (mapped to ``tpu_xla`` with a
        warning).
      allreduce_grad_dtype: the wire dtype of ``multi_node_mean_grad``
        (ChainerMN's fp16 all-reduce; ``torch.bfloat16`` here).
      device: ``None`` or ``"cuda"`` (the card), or ``"cpu"``.  The
        default group's backend must match it: NCCL for CUDA, gloo for
        the CPU.
      batched_copy: accepted for parity; the fused exchange always packs.
      ranks: the global ranks of the new communicator, in rank order
        (the JAX factory's ``devices=``).  Its two groups are new ones.
        EVERY rank of the launch calls this, in the same order; a rank
        outside ``ranks`` gets ``None`` (it only counts the groups, with
        no store traffic and no wait).  A group built with
        ``use_local_synchronization=True``, which only its members
        create, is named by its ranks and the count of groups the
        process holds; once a group is destroyed that name comes round
        again, its rendezvous keys are still on the store, and the next
        group of the same name hangs.  The launch-wide count names each
        group once.
    """
    name = communicator_name
    if name in _LEGACY_ALIASES:
        warnings.warn(
            f"communicator {name!r} is a ChainerMN legacy alias; using "
            f"{_LEGACY_ALIASES[name]!r} (NCCL chooses the collective "
            "algorithm)", stacklevel=2)
        name = _LEGACY_ALIASES[name]
    if name == "loopback":
        return LoopbackCommunicator(device=device)
    if name != "tpu_xla":
        raise ValueError(
            f"unknown communicator {communicator_name!r}; choose from "
            f"['tpu_xla', 'loopback'] or legacy {sorted(_LEGACY_ALIASES)}")
    dev = resolve_device(device)
    init_distributed(device=dev, timeout=timeout)
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(
            f"the default process group runs {backend!r} and a "
            f"communicator on {dev.type} needs {want!r}; start it with "
            f"init_distributed(device={dev.type!r})")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        if not ranks:
            raise ValueError("create_communicator(ranks=[]): no rank")
        kw = dict(timeout=timeout)
        if ranks != sorted(ranks):
            kw["sort_ranks"] = False
        group = dist.new_group(ranks, backend=want, **kw)
        obj_group = dist.new_group(ranks, backend="gloo", **kw)
        if dist.get_rank() not in ranks:
            return None
        return TorchDistCommunicator(
            group, obj_group, ranks, dev, grad_dtype=allreduce_grad_dtype,
            timeout=timeout, store=_STORE)
    obj_group = dist.new_group(backend="gloo", timeout=timeout)
    return TorchDistCommunicator(
        dist.group.WORLD, obj_group, list(range(dist.get_world_size())),
        dev, grad_dtype=allreduce_grad_dtype, timeout=timeout,
        store=_STORE)
