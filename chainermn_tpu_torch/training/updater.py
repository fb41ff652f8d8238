"""StandardUpdater — one data-parallel training window (the JAX
package's ``training/updater.py``; ChainerMN's ``StandardUpdater``
loop).

One ``update()`` is ``iterator → converter → forward and backward of
this rank's loss → multi-node optimizer`` (whose exchange averages the
gradients over the ranks, ChainerMN's ``multi_node_mean_grad``) — the
path of SURVEY §3.1.  Each rank runs its own process on its own batch;
the JAX package runs one program over a batch sharded across devices.
So the JAX package differentiates the ``pmean`` of the loss and the port
differentiates the local loss and means the gradients in the optimizer;
the two agree up to the rounding of the wire dtype.

A window is ``steps_per_execution`` optimizer updates of
``accum_steps`` microbatches each: the local gradients of an update's
microbatches are summed in ``accum_dtype`` in order, divided by
``accum_steps`` and cast to each parameter's dtype, and go through ONE
exchange, the multi-node optimizer's.  With
``create_multi_node_optimizer(overlap=True)`` the exchange of each
bucket starts from gradient hooks during the backward of the update's
last microbatch.  On the card a full window of ``steps_per_execution >
1`` runs as one CUDA graph (:func:`fuse_steps`).  A window cut short at
an epoch's end is flushed eagerly: full ``accum_steps`` groups first,
then single steps, and a ragged batch as a step of its own.

``main/loss`` is the global mean of the ranks' losses (one all-reduce
of the scalar an update), averaged over the window by microbatches.
``iteration`` counts microbatches, so the trainer's triggers fire on
data consumed.

With ``prefetch`` the iterator is wrapped in a
:class:`~chainermn_tpu_torch.iterators.PrefetchIterator`, whose worker
pulls, converts, stacks and copies the next window to the device while
this one computes; ``update()`` takes its :class:`DeviceWindow` as it
is.  ``max_inflight`` windows may be enqueued on the card before the
oldest is waited for (its CUDA event), and the observed loss is then
the retired window's.

:meth:`StandardUpdater.rebind_world` moves the loop onto another
world mid-run (the live resize's last step): the windows in flight are
waited for and every captured window dropped (a CUDA graph baked the
old group's NCCL calls), a prefetching feed is closed and re-wrapped
over the new communicator with its converter, and a global-batch
converter (:class:`~chainermn_tpu_torch.iterators.GlobalBatchConverter`)
is re-pointed.  A per-rank shard feed re-slices when the world changes,
so a change of world size with one raises.

Not ported yet, each raising: ``exchange_probe_every`` and the
telemetry hooks ``mark_steady``/``register_memory`` (ROADMAP Queue A
item 10).
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.iterators import (
    GlobalBatchConverter,
    PrefetchIterator,
    StagingConverter,
    assemble_window,
    default_converter,
    put_window,
)

from .optimizers import (
    MultiNodeState,
    Zero1Transformation,
    Zero2Transformation,
)

__all__ = ["StandardUpdater", "fuse_steps"]


def _not_ported(what, item):
    return NotImplementedError(
        f"StandardUpdater {what} is not ported to chainermn_tpu_torch yet "
        f"(ROADMAP Queue A item {item})")


def _run_steps(step_fn, n_steps, scan_batches, carry, batch):
    metrics = []
    for i in range(n_steps):
        b = tuple(x[i] for x in batch) if scan_batches else batch
        carry, m = step_fn(carry, *b)
        metrics.append(m)
    return carry, pytree.tree_map(lambda *ms: torch.stack(ms), *metrics)


def fuse_steps(step_fn, n_steps: int, *, scan_batches: bool = False,
               device=None, finish: Callable = None):
    """``n_steps`` training steps as one unit — on the card, one CUDA
    graph (the JAX package's ``lax.scan`` program).

    ``step_fn(carry, *batch) -> (carry, metrics)`` is one step: the
    carry is a tree of tensors the step replaces (BN statistics), and
    whatever else it updates in place (parameters, optimizer state)
    keeps its storage.  With ``scan_batches`` every batch tensor has a
    leading axis of ``n_steps`` and step ``i`` takes slice ``i``;
    otherwise every step takes the same batch.  ``finish()``, if given,
    runs after the last step (the updater joins its communication
    stream there, as a capture must end on the stream it began on).
    Returns ``fused(carry, *batch) -> (carry, metrics)``, each metric
    gaining a leading ``n_steps`` axis.

    ``device`` is where the steps run: CUDA unless ``"cpu"`` is named
    (``None`` needs a card and raises without one).  On the CPU it is
    the plain loop of steps.  On CUDA the first
    call runs the loop on a side stream (the warm-up: lazily made state,
    cuBLAS workspaces, NCCL's communicators); the second captures it
    into a graph, with the batch copied into static input tensors and
    the carry's final values copied back into the carry's tensors, and
    replays it; later calls copy and replay.  A capture that fails
    raises: there is no eager substitute.  A replay runs no Python, so
    a step must keep every value that changes between calls in tensors
    (a learning rate from a schedule, a counter)."""
    if resolve_device(device).type == "cpu":
        def fused(carry, *batch):
            out = _run_steps(step_fn, n_steps, scan_batches, carry, batch)
            if finish is not None:
                finish()
            return out

        return fused
    return _GraphedSteps(step_fn, n_steps, scan_batches, finish)


class _GraphedSteps:
    """:func:`fuse_steps` on the card: warm-up, capture, replay."""

    def __init__(self, step_fn, n_steps, scan_batches, finish):
        self.step_fn, self.n_steps = step_fn, n_steps
        self.scan_batches, self.finish = scan_batches, finish
        self.graph = None
        self.warm = False
        self.replays = 0

    def _run(self, carry, batch):
        out = _run_steps(self.step_fn, self.n_steps, self.scan_batches,
                         carry, batch)
        if self.finish is not None:
            self.finish()
        return out

    def __call__(self, carry, *batch):
        here = torch.cuda.current_stream()
        if not self.warm:
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                out = self._run(carry, batch)
            here.wait_stream(side)
            for t in pytree.tree_leaves(out):
                if torch.is_tensor(t):      # a model without state: None
                    t.record_stream(here)
            self.warm = True
            return out
        leaves, treedef = pytree.tree_flatten(carry)
        if self.graph is None:
            self._capture(leaves, treedef, batch)
        else:
            if len(batch) != len(self.static_batch) or any(
                    a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(batch, self.static_batch)):
                raise ValueError("fuse_steps: a captured window replays "
                                 "batches of the captured shapes only")
            for dst, src in zip(self.static_batch, batch):
                dst.copy_(src)
            for dst, src in zip(self.static_carry, leaves):
                if dst is not src:
                    dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        carry = pytree.tree_unflatten(list(self.static_carry), treedef)
        # the next replay rewrites the graph's outputs: hand out copies
        return carry, pytree.tree_map(torch.clone, self.static_metrics)

    def _capture(self, leaves, treedef, batch):
        if self.finish is not None:
            self.finish()           # no fork from before may stay open
        self.static_batch = [b.clone() for b in batch]
        self.static_carry = list(leaves)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the prefetch worker and the autograd engine's
        # threads keep issuing CUDA calls during the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            carry, metrics = self._run(
                pytree.tree_unflatten(list(leaves), treedef),
                self.static_batch)
            for dst, src in zip(self.static_carry,
                                pytree.tree_leaves(carry)):
                if dst is not src:
                    dst.copy_(src)
        self.static_metrics = metrics
        self.graph = graph


class StandardUpdater:
    """Drives ``iterator → converter → local forward/backward →
    multi-node optimizer``, a window at a time.

    Args:
      iterator: yields this rank's batches (a
        :class:`~chainermn_tpu_torch.iterators.SerialIterator` over its
        ``scatter_dataset`` shard, with the local batch size).
      optimizer: normally ``create_multi_node_optimizer(...)``; its
        ``update(grads, opt_state, params)`` exchanges the gradients and
        updates ``params`` in place.  A ZeRO-1 or ZeRO-2 one
        (``zero1=True``/``zero2=True``) is detected by its type:
        ``sharding`` is ``"zero1"``/``"zero2"``, ``zero1`` is true, and
        ``opt_state`` is this rank's shard state; under ``overlap=True``
        its reduce-scatters are fed from the gradient hooks of a
        window's last microbatch.
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
        does not divide by the world size: drop the remainder rows, or
        raise.  A per-rank feed gives each rank its own batch, so no
        batch is split; the global-batch feed's
        :class:`~chainermn_tpu_torch.iterators.GlobalBatchConverter`
        splits each batch over the world and takes this policy from
        the updater that adopts it.
      state: optional tree of non-trained tensors, broadcast like
        ``params`` and replaced by ``loss_fn``'s ``new_state`` each
        microbatch.
      steps_per_execution: optimizer updates a window (one CUDA graph on
        the card when above 1); ``iteration`` advances by the window's
        microbatches.
      prefetch: the depth of a :class:`PrefetchIterator` around
        ``iterator`` (``True`` → 2; 0 keeps the serial feed); the
        default converter then becomes the prefetcher's
        :class:`StagingConverter` (pinned on the card).  A
        ``PrefetchIterator`` passed as ``iterator`` is adopted; its
        window and ``drop_remainder`` must agree with this updater's.
        ``self.iterator`` is the prefetcher, whose ``state_dict`` is the
        base iterator's at the consumer's position, so checkpoints
        resume as in the serial feed.
      max_inflight: windows enqueued on the card before the oldest is
        waited for (its CUDA event); default 2 with ``prefetch``, else
        1.  Above 1 the observed loss is the last retired window's,
        ``max_inflight`` windows behind.  On the CPU every window is
        done when ``update()`` returns, and its own loss is observed.
      accum_steps: microbatches an optimizer update takes, their local
        gradients summed in ``accum_dtype`` (default float32) in order
        and meaned before the one exchange.  The optimizer must be a
        multi-node one: its exchange is then the only one.

    Observations: ``main/loss`` (global mean), ``main/host_time``
    (pull, convert, stack, move to the device), ``main/device_time``
    (the wait for the oldest window past ``max_inflight``),
    ``main/step_time`` (their sum), each a microbatch, in seconds, and
    with ``accum_steps > 1`` ``main/accum_time`` (their sum an
    optimizer update).
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
        if exchange_probe_every:
            raise _not_ported("exchange_probe_every", 10)
        if steps_per_execution < 1:
            raise ValueError("steps_per_execution must be >= 1")
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        self.steps_per_execution = steps_per_execution
        self.accum_steps = accum_steps
        self.accum_dtype = accum_dtype or torch.float32
        self.window_steps = steps_per_execution * accum_steps
        self.prefetch = 2 if prefetch is True else int(prefetch or 0)
        if self.prefetch < 0:
            raise ValueError("prefetch depth must be >= 0")
        if isinstance(converter, StagingConverter) and \
                converter._n_buffers < self.window_steps + 1:
            raise ValueError(
                f"StagingConverter(n_buffers={converter._n_buffers}) "
                f"cannot hold a steps_per_execution × accum_steps = "
                f"{self.window_steps} window (needs >= window + 1 "
                f"buffers)")
        if isinstance(iterator, PrefetchIterator):
            # a pre-built prefetcher implies prefetch mode, and must
            # agree with this updater's window contract
            if iterator._n_steps != self.window_steps:
                raise ValueError(
                    f"PrefetchIterator was built with steps_per_execution="
                    f"{iterator._n_steps}, updater wants a "
                    f"{self.window_steps}-deep window "
                    f"(steps_per_execution × accum_steps)")
            if iterator._drop_remainder != drop_remainder:
                raise ValueError("PrefetchIterator and updater disagree "
                                 "on drop_remainder")
            self.prefetch = iterator.depth
        elif self.prefetch:
            iterator = PrefetchIterator(
                iterator, comm,
                converter=(None if converter is default_converter
                           else converter),
                steps_per_execution=self.window_steps,
                depth=self.prefetch, drop_remainder=drop_remainder)
        if max_inflight is None:
            max_inflight = 2 if self.prefetch else 1
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self.iterator = iterator
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.comm = comm
        self.converter = converter
        self.drop_remainder = drop_remainder
        conv = self._feed_converter()
        if isinstance(conv, GlobalBatchConverter):
            conv.drop_remainder = drop_remainder
        self.device = comm.device

        self.params = comm.bcast_data(params)
        for leaf in pytree.tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.state = None if state is None else comm.bcast_data(state)
        # the sharding mode from the optimizer's type: ZeRO-1 and ZeRO-2
        # carry this rank's shard state alike (zero1 is the switch for
        # both, as in the JAX updater)
        self.sharding = (
            "zero2" if isinstance(optimizer, Zero2Transformation)
            else "zero1" if isinstance(optimizer, Zero1Transformation)
            else None)
        self.zero1 = self.sharding in ("zero1", "zero2")
        self.opt_state = optimizer.init(self.params)
        # on the card a window of several updates is one CUDA graph
        self.graphs = self.device.type == "cuda" and steps_per_execution > 1
        if self.graphs:
            self._prepare_capture()
        self._windows = {}              # graph key -> fused window

        self.iteration = 0
        self.epoch_detail = 0.0
        self.previous_epoch_detail = 0.0
        self.observation = {}
        self._inflight = collections.deque()   # (event, window loss)
        self._last_retired = None

    def _prepare_capture(self):
        every = getattr(self.optimizer, "every", 1)
        if self.steps_per_execution % every:
            raise ValueError(
                f"a captured window of {self.steps_per_execution} updates "
                f"must span whole accumulation cycles of the optimizer's "
                f"accum_steps={every}: the host decides when the "
                f"parameters move")

    @property
    def epoch(self) -> int:
        return getattr(self.iterator, "epoch", 0)

    def status(self) -> dict:
        """Where the loop is: iteration, epoch, world size and the
        optimizer state's sharding."""
        return {"iteration": int(self.iteration), "epoch": int(self.epoch),
                "world_size": int(self.comm.size),
                "steps_per_execution": int(self.steps_per_execution),
                "inflight_windows": len(self._inflight),
                "zero1": bool(self.zero1), "sharding": self.sharding}

    def mark_steady(self) -> None:
        raise _not_ported("mark_steady (the program ledger)", 10)

    def register_memory(self, accountant=None, prefix: str = "train"):
        raise _not_ported("register_memory (the memory accountant)", 10)

    def _feed_converter(self):
        """The converter the feed runs: the prefetcher's resolved one,
        or the updater's."""
        if isinstance(self.iterator, PrefetchIterator):
            return self.iterator._converter
        return self.converter

    def check_world_change(self, world_size: int) -> None:
        """Raise unless the feed can follow a live resize to
        ``world_size``: a change of world size needs the global-batch
        feed, whose stream every rank iterates (a per-rank shard feed
        re-slices its dataset when the world changes)."""
        if int(world_size) == int(self.comm.size) or isinstance(
                self._feed_converter(), GlobalBatchConverter):
            return
        raise ValueError(
            f"a live resize from world {self.comm.size} to {world_size} "
            "needs the global-batch feed: every rank iterating the same "
            "stream with converter=GlobalBatchConverter(comm) (the rows "
            "of iterators.local_rows).  A per-rank shard feed "
            "(scatter_dataset) re-slices when the world changes: resume "
            "at the new world size from a checkpoint "
            "(create_multi_node_checkpointer(..., elastic=True)) instead")

    def drain(self) -> None:
        """Wait for the windows in flight (their CUDA events) and drop
        every captured window: its CUDA graph holds the world's NCCL
        calls, so it must go before the world's groups do."""
        for event, _ in self._inflight:
            event.synchronize()
        self._inflight.clear()
        self._windows = {}

    def rebind_world(self, comm, optimizer) -> None:
        """Re-bind the loop to a NEW communicator and optimizer mid-run
        (the JAX package's ``rebind_world``; the live resize's
        ``ResizeController`` calls it at the paused boundary).  The
        windows in flight are drained and the captured ones dropped; a
        prefetching feed is closed (its lookahead returned to the base
        iterator) and re-wrapped over ``comm`` with the prefetcher's
        resolved converter; a :class:`GlobalBatchConverter` is
        re-pointed at ``comm``; ``opt_state`` is the new optimizer's
        fresh state, into which the caller installs the re-laid one
        (with the parameters, the model state and the train state).
        A switch of sharding mode, or of world size with a per-rank
        shard feed, raises."""
        sharding = (
            "zero2" if isinstance(optimizer, Zero2Transformation)
            else "zero1" if isinstance(optimizer, Zero1Transformation)
            else None)
        if sharding != self.sharding:
            raise ValueError(
                f"rebind_world cannot switch sharding mode mid-run "
                f"({self.sharding!r} -> {sharding!r}, zero1="
                f"{sharding in ('zero1', 'zero2')}): the carried "
                "optimizer state's layout would not match the new "
                "transformation")
        self.check_world_change(comm.size)
        self.drain()
        conv = self._feed_converter()
        if isinstance(self.iterator, PrefetchIterator):
            base, depth = self.iterator._base, self.iterator.depth
            self.iterator.close()
            self.iterator = PrefetchIterator(
                base, comm, converter=conv,
                steps_per_execution=self.window_steps, depth=depth,
                drop_remainder=self.drop_remainder)
        if isinstance(conv, GlobalBatchConverter):
            conv.comm = comm
        self.comm = comm
        self.device = comm.device
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params)

    def finalize(self):
        """Release the feed and the captured windows: a prefetching
        iterator's worker is joined and its unconsumed lookahead
        returned to the base iterator; once the windows in flight are
        done, each window's CUDA graph is freed (NCCL does not destroy a
        communicator while a graph holds its collectives, so a
        ``destroy_process_group`` after training would wait forever).
        The trainer calls this when ``run()`` exits; if training
        resumes, the feed restarts and a full window is captured
        again."""
        if isinstance(self.iterator, PrefetchIterator):
            self.iterator.close()
        for event, _ in self._inflight:
            event.synchronize()
        self._windows = {}

    # ------------------------------------------------------------------ #
    # the feed
    # ------------------------------------------------------------------ #

    def _pull(self):
        arrays = self.converter(next(self.iterator))
        if self.window_steps > 1:
            # the next pull of a window may recycle a buffer of this one
            probes = [p for p in (
                getattr(self.converter, "owns_buffers", None),
                getattr(self.iterator, "owns_buffers", None))
                if p is not None]
            arrays = tuple(
                a.copy() if any(p((a,)) for p in probes) else a
                for a in arrays)
        return arrays

    def _to_device(self, a):
        return torch.as_tensor(a).to(self.device)

    def _next_window(self):
        """``(arrays, k, tail)`` on the device: the same window the
        prefetcher delivers, assembled here."""
        if self.prefetch:
            rec = next(self.iterator)
            return rec.arrays, rec.k, rec.tail
        window, pending = assemble_window(self._pull, self.window_steps)
        arrays, k, tail = put_window(window, pending, self.converter)
        arrays = tuple(self._to_device(a) for a in arrays)
        if tail is not None:
            tail = tuple(self._to_device(a) for a in tail)
        return arrays, k, tail

    # ------------------------------------------------------------------ #
    # one optimizer update
    # ------------------------------------------------------------------ #

    def _forward(self, state, batch):
        if self.state is not None:
            loss, new_state = self.loss_fn(self.params, state, *batch)
            return loss, pytree.tree_map(
                lambda t: t.detach() if torch.is_tensor(t) else t,
                new_state)
        return self.loss_fn(self.params, *batch), None

    def _update(self, state, batches):
        """One optimizer update over ``batches`` (its microbatches):
        returns the new model state and the global mean loss."""
        leaves, treedef = pytree.tree_flatten(self.params)
        M = len(batches)
        overlap = getattr(self.optimizer, "overlap", False)
        acc, losses, reduced = None, [], None
        for j, batch in enumerate(batches):
            loss, state = self._forward(state, batch)
            losses.append(loss.detach())
            if overlap and j == M - 1:
                reduced = self._overlapped_backward(loss, leaves, acc, M)
                break
            grads = torch.autograd.grad(loss, leaves)
            if M == 1:
                acc = list(grads)
            elif acc is None:
                acc = [g.to(self.accum_dtype) for g in grads]
            else:
                torch._foreach_add_(acc, [g.to(self.accum_dtype)
                                          for g in grads])
        if reduced is not None:
            self.optimizer.apply(reduced, self.opt_state, self.params)
        else:
            if M > 1:
                acc = [(a / M).to(p.dtype) for a, p in zip(acc, leaves)]
            self.optimizer.update(pytree.tree_unflatten(acc, treedef),
                                  self.opt_state, self.params)
        loss = losses[0] if M == 1 else torch.stack(losses).mean()
        return state, self.comm.allreduce(loss, "mean")

    def _overlapped_backward(self, loss, leaves, acc, M):
        """The backward of an update's last microbatch, each gradient
        handed (with the update's earlier ones, meaned and cast) to the
        overlap schedule's exchange as it is made; returns the means."""
        ex = self.optimizer.overlapped(self.params)

        def hook(i):
            def fn(p):
                g, p.grad = p.grad, None
                if M > 1:
                    g = ((acc[i] + g.to(acc[i].dtype)) / M).to(p.dtype)
                with self.optimizer.on_comm_stream([g]):
                    ex.put(i, g)
            return fn

        for p in leaves:
            p.grad = None
        handles = [p.register_post_accumulate_grad_hook(hook(i))
                   for i, p in enumerate(leaves)]
        try:
            loss.backward()
        finally:
            for h in handles:
                h.remove()
        with self.optimizer.on_comm_stream(leaves[:1]):
            return ex.result()

    def _step(self, state, *block):
        """``fuse_steps``' step: one update, its microbatches stacked
        along ``block``'s first axis when ``accum_steps > 1``."""
        if self.accum_steps == 1:
            return self._update(state, [block])
        return self._update(state, [tuple(b[j] for b in block)
                                    for j in range(self.accum_steps)])

    def _finish(self):
        if isinstance(self.opt_state, MultiNodeState):
            self.opt_state.join()

    def _fused(self, n_args):
        """The captured window of the optimizer's accumulation phase."""
        key = (n_args, getattr(self.opt_state, "phase", 0))
        if key not in self._windows:
            self._windows[key] = fuse_steps(
                self._step, self.steps_per_execution, scan_batches=True,
                device=self.device, finish=self._finish)
        return self._windows[key]

    def _dispatch(self, state, arrays, k):
        """Run a ``k``-microbatch window: a full one as
        ``steps_per_execution`` updates (through :func:`fuse_steps`'s
        graph when ``self.graphs``, else their plain loop), a shorter one
        flushed as full
        ``accum_steps`` groups and then single steps.  Returns ``(state,
        losses, weights, n_updates)``, ``weights`` the microbatches
        behind each loss."""
        M, S = self.accum_steps, self.steps_per_execution
        if k == self.window_steps and k > 1:
            block = tuple(a.reshape((S, M) + a.shape[1:]) if M > 1 else a
                          for a in arrays)
            if self.graphs:
                state, losses = self._fused(len(arrays))(state, *block)
            else:
                state, losses = _run_steps(self._step, S, True, state, block)
            return state, list(losses.unbind(0)), [M] * S, S
        if k == 1:
            state, loss = self._update(state, [arrays])
            return state, [loss], [1], 1
        losses, weights = [], []
        q = k // M if M > 1 else 0
        for i in range(q):
            state, loss = self._update(state, [
                tuple(a[j] for a in arrays) for j in range(i * M,
                                                           (i + 1) * M)])
            losses.append(loss)
            weights.append(M)
        for j in range(q * M, k):
            state, loss = self._update(state, [tuple(a[j] for a in arrays)])
            losses.append(loss)
            weights.append(1)
        return state, losses, weights, len(losses)

    def update(self):
        t0 = time.perf_counter()
        arrays, k, tail = self._next_window()
        host_time = time.perf_counter() - t0

        state, losses, weights, n_updates = self._dispatch(
            self.state, arrays, k)
        n_iters = k
        if tail is not None:
            state, loss = self._update(state, [tail])
            losses.append(loss)
            weights.append(1)
            n_iters += 1
            n_updates += 1
        self.state = state
        loss = torch.stack(losses)
        if len(set(weights)) == 1:
            window_loss = loss.mean()
        else:
            # M-deep update means beside single steps: weight each by its
            # microbatches, so the loss stays a per-microbatch mean
            w = torch.tensor(weights, dtype=loss.dtype, device=loss.device)
            window_loss = (loss * w).sum() / w.sum()

        # retire the oldest windows past max_inflight, never this one;
        # on the CPU a window is done when its update returns
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._inflight.append((event, window_loss))
            while len(self._inflight) > self.max_inflight:
                event, self._last_retired = self._inflight.popleft()
                event.synchronize()
        else:
            self._last_retired = window_loss
        device_time = time.perf_counter() - t0

        self.iteration += n_iters
        self.previous_epoch_detail = self.epoch_detail
        self.epoch_detail = getattr(self.iterator, "epoch_detail",
                                    self.iteration)
        obs_loss = window_loss
        if self.max_inflight > 1 and self._last_retired is not None:
            obs_loss = self._last_retired
        self.observation = {
            "main/loss": obs_loss,
            "main/host_time": host_time / n_iters,
            "main/device_time": device_time / n_iters,
            "main/step_time": (host_time + device_time) / n_iters,
        }
        if self.accum_steps > 1:
            self.observation["main/accum_time"] = \
                (host_time + device_time) / max(n_updates, 1)
