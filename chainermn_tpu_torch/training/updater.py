"""StandardUpdater — one data-parallel training step (the JAX package's
``training/updater.py``; ChainerMN's ``StandardUpdater`` loop).

One ``update()`` is ``iterator → converter → forward and backward of
this rank's loss → multi-node optimizer`` (whose exchange averages the
gradients over the ranks, ChainerMN's ``multi_node_mean_grad``) — the
path of SURVEY §3.1.  Each rank runs its own process on its own batch;
the JAX package runs one program over a batch sharded across devices.
So the JAX package differentiates the ``pmean`` of the loss and the port
differentiates the local loss and means the gradients in the optimizer;
the two agree up to the rounding of the wire dtype.

``main/loss`` is the global mean of the ranks' losses (one all-reduce
of the scalar), as in the JAX package.  A ragged last batch of an epoch
runs as an ordinary step of its own size.

With ``prefetch`` the iterator is wrapped in a
:class:`~chainermn_tpu_torch.iterators.PrefetchIterator`, whose worker
pulls, converts and copies the next batch to the device while this one
computes; ``update()`` takes its :class:`DeviceWindow` as it is.  The
port's step is already asynchronous on the card (the host enqueues a
step while the card runs the last), so ``max_inflight`` stays 1.

Not ported yet, each raising: ``steps_per_execution > 1``,
``accum_steps > 1``, ``max_inflight > 1`` and :func:`fuse_steps`
(ROADMAP Queue A item 4; on the card a fused window would be a CUDA
graph), ``exchange_probe_every`` and the telemetry hooks
``mark_steady``/``register_memory`` (item 10), and ``rebind_world``
(elastic training, item 11).
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch.iterators import (
    PrefetchIterator,
    default_converter,
)

__all__ = ["StandardUpdater", "fuse_steps"]


def _not_ported(what, item):
    return NotImplementedError(
        f"StandardUpdater {what} is not ported to chainermn_tpu_torch yet "
        f"(ROADMAP Queue A item {item})")


def fuse_steps(step_fn, n_steps: int, **kwargs):
    """Not ported: several steps in one program (on the card, a CUDA
    graph of the window) is ROADMAP Queue A item 4."""
    raise _not_ported("fuse_steps", 4)


class StandardUpdater:
    """Drives ``iterator → converter → local forward/backward →
    multi-node optimizer``.

    Args:
      iterator: yields this rank's batches (a
        :class:`~chainermn_tpu_torch.iterators.SerialIterator` over its
        ``scatter_dataset`` shard, with the local batch size).
      optimizer: normally ``create_multi_node_optimizer(...)``; its
        ``update(grads, opt_state, params)`` exchanges the gradients and
        updates ``params`` in place.
      loss_fn: ``loss_fn(params, *batch) -> scalar`` on this rank's
        batch; with ``state``, ``loss_fn(params, state, *batch) ->
        (scalar, new_state)`` (BN running statistics).  ``new_state``
        must come out the same on every rank (synchronised BN's are).
      params: a tree of tensors on ``comm.device``; they are broadcast
        from rank 0 (ChainerMN's first-update ``bcast_data``), marked as
        requiring gradients, and updated in place.
      comm: the communicator.
      converter: batch → tuple of columns (arrays or tensors); each is
        moved to ``comm.device``.
      drop_remainder: the JAX package's policy for a global batch that
        does not divide by the world size; every port rank is fed its
        own batch, so no batch is split and nothing is dropped.
      state: optional tree of non-trained tensors, broadcast like
        ``params`` and replaced by ``loss_fn``'s ``new_state`` each step.
      prefetch: the depth of a :class:`PrefetchIterator` around
        ``iterator`` (``True`` → 2; 0 keeps the serial feed); the
        default converter then becomes the prefetcher's
        :class:`StagingConverter` (pinned on the card).  A
        ``PrefetchIterator`` passed as ``iterator`` is adopted; its
        window and ``drop_remainder`` must agree with this updater's.
        ``self.iterator`` is the prefetcher, whose ``state_dict`` is the
        base iterator's at the consumer's position, so checkpoints
        resume as in the serial feed.

    Observations: ``main/loss`` (global mean), ``main/host_time``
    (pull, convert, move to the device), ``main/device_time`` (the wait
    for the previous step's work on the card), ``main/step_time`` (their
    sum), in seconds.
    """

    def __init__(
        self,
        iterator,
        optimizer,
        loss_fn: Callable,
        params,
        comm,
        converter: Callable = default_converter,
        drop_remainder: bool = True,
        state=None,
        steps_per_execution: int = 1,
        prefetch: int = 0,
        max_inflight=None,
        accum_steps: int = 1,
        accum_dtype=None,
        exchange_probe_every: int = 0,
    ):
        for what, on, item in (
                ("steps_per_execution > 1", steps_per_execution != 1, 4),
                ("accum_steps > 1", accum_steps != 1 or accum_dtype, 4),
                ("max_inflight > 1", max_inflight not in (None, 1), 4),
                ("exchange_probe_every", exchange_probe_every, 10)):
            if on:
                raise _not_ported(what, item)
        self.prefetch = 2 if prefetch is True else int(prefetch or 0)
        if self.prefetch < 0:
            raise ValueError("prefetch depth must be >= 0")
        if isinstance(iterator, PrefetchIterator):
            # a pre-built prefetcher implies prefetch mode, and must
            # agree with this updater's window contract
            if iterator._n_steps != steps_per_execution:
                raise ValueError(
                    f"PrefetchIterator was built with steps_per_execution="
                    f"{iterator._n_steps}, updater wants "
                    f"{steps_per_execution}")
            if iterator._drop_remainder != drop_remainder:
                raise ValueError("PrefetchIterator and updater disagree "
                                 "on drop_remainder")
            self.prefetch = iterator.depth
        elif self.prefetch:
            iterator = PrefetchIterator(
                iterator, comm,
                converter=(None if converter is default_converter
                           else converter),
                depth=self.prefetch, drop_remainder=drop_remainder)
        self.iterator = iterator
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.comm = comm
        self.converter = converter
        self.drop_remainder = drop_remainder
        self.device = comm.device

        self.params = comm.bcast_data(params)
        for leaf in pytree.tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.state = None if state is None else comm.bcast_data(state)
        self.opt_state = optimizer.init(self.params)

        self.iteration = 0
        self.epoch_detail = 0.0
        self.previous_epoch_detail = 0.0
        self.observation = {}
        self._previous_step = None      # CUDA event of the last step

    @property
    def epoch(self) -> int:
        return getattr(self.iterator, "epoch", 0)

    def status(self) -> dict:
        """Where the loop is: iteration, epoch and world size."""
        return {"iteration": int(self.iteration), "epoch": int(self.epoch),
                "world_size": int(self.comm.size)}

    def mark_steady(self) -> None:
        raise _not_ported("mark_steady (the program ledger)", 10)

    def register_memory(self, accountant=None, prefix: str = "train"):
        raise _not_ported("register_memory (the memory accountant)", 10)

    def rebind_world(self, comm, optimizer) -> None:
        raise _not_ported("rebind_world (elastic training)", 11)

    def finalize(self):
        """Release the feed: a prefetching iterator's worker is joined
        and its unconsumed lookahead returned to the base iterator.  The
        trainer calls this when ``run()`` exits; the feed restarts if
        training resumes."""
        if isinstance(self.iterator, PrefetchIterator):
            self.iterator.close()

    def _to_device(self, a):
        return torch.as_tensor(a).to(self.device)

    def update(self):
        t0 = time.perf_counter()
        if self.prefetch:
            # a DeviceWindow, already on the device
            arrays = next(self.iterator).arrays
        else:
            arrays = tuple(self._to_device(a)
                           for a in self.converter(next(self.iterator)))
        host_time = time.perf_counter() - t0

        leaves, treedef = pytree.tree_flatten(self.params)
        if self.state is not None:
            loss, new_state = self.loss_fn(self.params, self.state, *arrays)
        else:
            loss = self.loss_fn(self.params, *arrays)
        grads = pytree.tree_unflatten(
            list(torch.autograd.grad(loss, leaves)), treedef)
        self.optimizer.update(grads, self.opt_state, self.params)
        if self.state is not None:
            self.state = pytree.tree_map(
                lambda t: t.detach() if torch.is_tensor(t) else t,
                new_state)
        loss = self.comm.allreduce(loss.detach(), "mean")

        # wait for the previous step, never this one: the host enqueues
        # this step while the card finishes the last
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if self._previous_step is not None:
                self._previous_step.synchronize()
            self._previous_step = torch.cuda.Event()
            self._previous_step.record()
        device_time = time.perf_counter() - t0

        self.iteration += 1
        self.previous_epoch_detail = self.epoch_detail
        self.epoch_detail = getattr(self.iterator, "epoch_detail",
                                    self.iteration)
        self.observation = {
            "main/loss": loss,
            "main/host_time": host_time,
            "main/device_time": device_time,
            "main/step_time": host_time + device_time,
        }
