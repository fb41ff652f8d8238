"""Overlapped input pipeline: the prefetching host → device feed (the
JAX package's ``iterators/prefetch.py``).

A serial ``StandardUpdater.update()`` pays pull → convert → stack → copy
to the card → step in series, with the card idle while the host
assembles the batch.  :class:`PrefetchIterator` runs the pull, the
conversion and the copy on a daemon worker thread up to ``depth``
batches ahead of the consumer, so the steady-state step takes
``max(host, device)`` instead of their sum.

Three layers, lowest first:

- :class:`StagingConverter` — batch → tuple of host arrays stacked into
  a small ring of preallocated buffers reused across steps.  With
  ``pin_memory`` (the prefetcher's default on the card) the buffers are
  page-locked host memory (``torch.empty(..., pin_memory=True)``, with
  ``.numpy()`` views for ``np.stack(out=)``), and already-stacked
  columns (a :class:`~chainermn_tpu_torch.native.NativeBatchIterator`
  slot) are copied into the ring too: the copy out of a recycled slot,
  and the source of an asynchronous copy to the card.
- :func:`assemble_window` and :func:`put_window` — the window-fill
  contract and the window's stacked copy, shared by the serial
  updater's feed and the worker: up to ``steps_per_execution`` batches
  of one shape (an ``accum_steps`` window's microbatches too), stacked
  into ``(k, batch, ...)`` columns (into a pinned staging window on the
  card's path), a ragged end-of-epoch batch riding along as the tail.
- :class:`PrefetchIterator` — the slot-ring worker.  It yields
  :class:`DeviceWindow` records (tensors already on ``comm.device``),
  re-raises a worker's exception from ``next()``, joins its worker on
  ``close()``, and implements ``state_dict``/``load_state_dict``:
  ``state_dict`` stops the worker and returns the base iterator's state
  as of the oldest unconsumed pull, keeping the lookahead buffered, so a
  checkpoint resumes where the consumer stood and a save replays no
  pull; ``load_state_dict`` rewinds the base iterator to such a state.

On the card the worker owns a side stream: it sets the device and the
stream in its own thread, copies each pinned buffer with
``non_blocking=True`` on that stream and records an event behind the
copies.  The consumer's stream waits on the event, and each delivered
tensor is marked with ``record_stream`` for the consumer's stream.  A
staging buffer is written again only after the event recorded behind
its last copy has completed: the torch form of the JAX package's rule
that a transfer from a recycled buffer must finish first
(``put_window``).  On the CPU nothing is pinned, and an array that a
converter or the source recycles is copied before it is handed on, as
``put_window`` copies it.

Like the port's serial updater, the feed splits no batch: every rank
is fed its own, so the JAX package's divisibility policy is not
applied (``drop_remainder`` is kept for the updater's agreement check).

Not ported: the telemetry spans and occupancy counter and
``utils.comm_model.choose_prefetch_depth`` (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "DeviceWindow",
    "PrefetchIterator",
    "StagingConverter",
    "assemble_window",
    "put_window",
]


class _Buffer:
    """One staging buffer: its numpy view, the tensor that holds it
    (pinned on the card's path; None for a plain numpy buffer) and the
    CUDA event behind the last copy read from it."""

    __slots__ = ("array", "tensor", "fence")

    def __init__(self, shape, dtype, pin_memory):
        if pin_memory:
            tdtype = torch.from_numpy(np.empty((), dtype)).dtype
            self.tensor = torch.empty(shape, dtype=tdtype, pin_memory=True)
            self.array = self.tensor.numpy()
        else:
            self.tensor = None
            self.array = np.empty(shape, dtype)
        self.fence = None


class StagingConverter:
    """The default converter minus the per-step allocation.

    Stacks each column directly into a preallocated staging buffer
    (``np.stack(col, out=buf)``) reused across steps when the column's
    (length, element shape, dtype) repeat.  Buffers rotate through a
    ring of ``n_buffers`` per column, so the last ``n_buffers - 1``
    batches stay valid while in flight; :class:`PrefetchIterator`'s
    default sizes it ``depth + 3``.  Before a buffer is written again
    its fence (the CUDA event :meth:`fence` attached behind the copy
    that read it) is waited for.

    ``pin_memory=False`` (the JAX package's converter): already-stacked
    columns pass through untouched.  ``pin_memory=True`` (needs a card):
    the buffers are pinned, and already-stacked numpy columns are copied
    into the ring as well.
    """

    def __init__(self, n_buffers: int = 4, pin_memory: bool = False):
        if n_buffers < 2:
            raise ValueError("need at least 2 staging buffers "
                             "(one filling, one in flight)")
        self._n_buffers = n_buffers
        self.pin_memory = pin_memory
        self._rings: dict = {}      # key -> [_Buffer, ...]
        self._turn: dict = {}       # key -> next ring index
        self._by_id: dict = {}      # id(view) -> _Buffer

    def _staging(self, key, shape, dtype) -> np.ndarray:
        ring = self._rings.setdefault(key, [])
        i = self._turn.get(key, 0)
        if len(ring) <= i:
            buf = _Buffer(shape, dtype, self.pin_memory)
            ring.append(buf)
            self._by_id[id(buf.array)] = buf
        buf = ring[i]
        # a stacked window is read by one fenced copy only, so two
        # buffers suffice; a batch must outlive its window's assembly
        n = 2 if key[0] == "window" else self._n_buffers
        self._turn[key] = (i + 1) % n
        if buf.fence is not None:
            buf.fence.synchronize()     # its last copy has read it
            buf.fence = None
        return buf.array

    def owns_buffers(self, arrays) -> bool:
        """True if any of ``arrays`` IS one of this converter's ring
        buffers (overwritten when the ring wraps)."""
        return any(id(a) in self._by_id for a in arrays)

    def pinned_tensor(self, array) -> Optional[torch.Tensor]:
        """The pinned tensor behind ``array`` if it is a pinned ring
        buffer of this converter, else None."""
        buf = self._by_id.get(id(array))
        return None if buf is None else buf.tensor

    def fence(self, arrays, event) -> None:
        """Attach ``event`` (recorded behind the copies that read
        ``arrays``) to those of them that are ring buffers."""
        for a in arrays:
            buf = self._by_id.get(id(a))
            if buf is not None:
                buf.fence = event

    def _stack(self, col_idx, col):
        first = col[0]
        if isinstance(first, np.ndarray) and all(
                isinstance(v, np.ndarray)
                and v.shape == first.shape and v.dtype == first.dtype
                for v in col):
            key = (col_idx, len(col), first.shape, first.dtype)
            buf = self._staging(key, (len(col),) + first.shape,
                                first.dtype)
            return np.stack(col, out=buf)
        # mixed / non-array elements (python scalars, ragged): numpy
        # decides the dtype exactly as default_converter would
        return np.stack(col)

    def stack_window(self, col_idx, col) -> np.ndarray:
        """Stack one column of a window of batches into ``(k, batch,
        ...)``: into a ring buffer of this converter (pinned with
        ``pin_memory``), or a fresh array without ``pin_memory``, whose
        stack is the copy out of any recycled buffer."""
        if not self.pin_memory:
            return np.stack(col)
        first = col[0]
        buf = self._staging(("window", col_idx, len(col), first.shape,
                             first.dtype), (len(col),) + first.shape,
                            first.dtype)
        return np.stack(col, out=buf)

    def _stage(self, col_idx, a):
        if not self.pin_memory or not isinstance(a, np.ndarray):
            return a
        buf = self._staging(("stacked", col_idx, a.shape, a.dtype),
                            a.shape, a.dtype)
        np.copyto(buf, a)
        return buf

    def __call__(self, batch):
        if not len(batch):
            raise ValueError("empty batch")
        stacked = (np.ndarray, torch.Tensor)
        if isinstance(batch, stacked):
            return (self._stage(0, batch),)
        if isinstance(batch, tuple) and all(isinstance(c, stacked)
                                            for c in batch):
            if not self.pin_memory:
                return batch
            return tuple(self._stage(i, c) for i, c in enumerate(batch))
        first = batch[0]
        if isinstance(first, (tuple, list)):
            cols = list(zip(*batch))
            return tuple(self._stack(i, col) for i, col in enumerate(cols))
        return (self._stack(0, batch),)


def assemble_window(pull_fn, n_steps: int):
    """The window-fill contract shared with the JAX package's feeds:
    fill up to ``n_steps`` same-shape batches from ``pull_fn``; stop
    early on exhaustion or a ragged (end-of-epoch) batch, which rides
    along as the pending tail.  Returns ``(window, pending)``; the first
    pull's StopIteration propagates."""
    first = pull_fn()
    window, pending = [first], None
    while len(window) < n_steps:
        try:
            nxt = pull_fn()
        except StopIteration:
            break
        if any(a.shape != b.shape for a, b in zip(nxt, first)):
            pending = nxt
            break
        window.append(nxt)
    return window, pending


def put_window(window, pending, converter=None):
    """The host side of a window's transfer: ``(arrays, k, tail)``,
    where ``arrays`` is the lone batch's columns when ``k == 1`` and
    each column stacked into ``(k, batch, ...)`` otherwise (through the
    converter's ``stack_window`` when it has one: its pinned staging
    window on the card's path), and ``tail`` the ragged batch or None.
    Both feeds then copy these to the device their own way."""
    k = len(window)
    if k == 1:
        return tuple(window[0]), 1, pending
    stack = getattr(converter, "stack_window", None)
    arrays = tuple(
        stack(i, col) if stack is not None and all(
            isinstance(a, np.ndarray) for a in col) else np.stack(col)
        for i, col in enumerate(zip(*window)))
    return arrays, k, pending


class DeviceWindow:
    """One prefetched window, already on the device.

    ``arrays``: tensors on ``comm.device`` — the batch's columns when
    ``k == 1``, ``(k, batch, ...)`` stacks of ``k`` batches otherwise.
    ``tail``: the ragged end-of-epoch batch that could not stack into
    the window (tensors on the device), or None.  ``event``: on the
    card, the CUDA event behind the copies (the consumer's stream waits
    on it); None on the CPU.  The epoch bookkeeping is the base
    iterator's state after the window's last pull — what the serial
    path would observe at the same consumption point.
    """

    __slots__ = ("arrays", "k", "tail", "epoch", "is_new_epoch",
                 "epoch_detail", "event")

    def __init__(self, arrays, k, tail, epoch, is_new_epoch,
                 epoch_detail, event=None):
        self.arrays = arrays
        self.k = k
        self.tail = tail
        self.epoch = epoch
        self.is_new_epoch = is_new_epoch
        self.epoch_detail = epoch_detail
        self.event = event

    @property
    def n_iterations(self) -> int:
        """Training iterations this window advances (k and the tail)."""
        return self.k + (1 if self.tail is not None else 0)


class PrefetchIterator:
    """Bounded slot-ring prefetcher: background host assembly and copy
    to the device ahead of consumption.

    Wraps a batch iterator (``SerialIterator`` protocol) and yields
    :class:`DeviceWindow` records.  The batch stream is what the port's
    serial ``StandardUpdater`` assembles (same converter, same batches),
    so training with prefetch on and off is bitwise equal.  A worker
    exception is re-raised from ``next()``; ``close()`` joins the
    worker; ``state_dict()`` returns the base iterator's state as of the
    oldest unconsumed pull, without rewinding it.

    Args:
      iterator: base batch iterator (``next``/``epoch``/
        ``epoch_detail``; ``state_dict``/``load_state_dict`` for resume).
      comm: the communicator; its ``device`` is where batches go.
      converter: batch → tuple of host arrays; default a
        :class:`StagingConverter` with ``max(depth, steps_per_execution
        + 1) + 3`` buffers, pinned on the card.
      steps_per_execution: batches a window stacks (the updater's
        ``steps_per_execution × accum_steps``).
      depth: slot-ring length — batches prefetched ahead.
      drop_remainder: the updater's setting, checked against it.
      join_timeout: seconds ``state_dict``/``reset``/``close`` wait for
        the worker to stop; a base iterator blocked inside ``next()``
        cannot see the stop flag, so after the timeout
        ``state_dict``/``reset`` raise and ``close`` warns and abandons
        the daemon worker.
    """

    def __init__(self, iterator, comm, converter: Optional[Callable] = None,
                 steps_per_execution: int = 1, depth: int = 2,
                 drop_remainder: bool = True, join_timeout: float = 60.0):
        if steps_per_execution < 1:
            raise ValueError("steps_per_execution must be >= 1")
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        if isinstance(converter, StagingConverter) \
                and converter._n_buffers < steps_per_execution + 1:
            # the ring would wrap inside a window: duplicated batches
            raise ValueError(
                f"StagingConverter(n_buffers={converter._n_buffers}) is "
                f"too small for steps_per_execution={steps_per_execution}"
                f": it must hold the whole unstacked window and the tail "
                f"(>= {steps_per_execution + 1})")
        self._base = iterator
        self._comm = comm
        self._device = torch.device(comm.device)
        on_card = self._device.type == "cuda"
        # during a window's assembly up to steps_per_execution + 1 pulled
        # batches are live, beside the windows still being copied
        self._converter = converter if converter is not None else \
            StagingConverter(n_buffers=max(depth, steps_per_execution + 1)
                             + 3, pin_memory=on_card)
        self._n_steps = steps_per_execution
        self.depth = depth
        self._drop_remainder = drop_remainder
        self.join_timeout = join_timeout
        self._stream = torch.cuda.Stream(self._device) if on_card else None
        self._can_rewind = (hasattr(iterator, "state_dict")
                            and hasattr(iterator, "load_state_dict"))

        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._buffer: list = []        # drained-but-unconsumed items
        self._spill: list = []         # worker's undelivered item on halt
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._finished = False

        self.epoch = getattr(iterator, "epoch", 0)
        self.is_new_epoch = getattr(iterator, "is_new_epoch", False)
        self._epoch_detail = float(getattr(iterator, "epoch_detail", 0.0))

    # ------------------------------------------------------------------ #
    # worker side
    # ------------------------------------------------------------------ #

    def _snapshot(self):
        return self._base.state_dict() if self._can_rewind else None

    def _pull(self):
        arrays = self._converter(next(self._base))
        if self._n_steps > 1:
            # the next pull of a window may recycle the base's buffer
            owns = getattr(self._base, "owns_buffers", None)
            if owns is not None:
                arrays = tuple(np.array(a) if owns((a,)) else a
                               for a in arrays)
        return arrays

    def _recycled(self, a) -> bool:
        probes = [getattr(self._converter, "owns_buffers", None),
                  getattr(self._base, "owns_buffers", None)]
        return any(p is not None and p((a,)) for p in probes)

    def _host_tensor(self, a):
        if torch.is_tensor(a):
            return a
        pinned = getattr(self._converter, "pinned_tensor", None)
        t = None if pinned is None else pinned(a)
        if t is not None:
            return t
        if self._stream is not None:
            # pageable memory: the copy below has read it when it
            # returns, so a recycled slot may be reused after it
            return torch.from_numpy(np.ascontiguousarray(a))
        return torch.as_tensor(np.array(a) if self._recycled(a) else a)

    def _to_device(self, arrays):
        host = [self._host_tensor(a) for a in arrays]
        event = None
        if self._stream is None:
            out = tuple(t.to(self._device) for t in host)
        else:
            # the worker's side stream is current (see _worker)
            out = tuple(t.to(self._device, non_blocking=True)
                        for t in host)
            event = torch.cuda.Event()
            event.record(self._stream)
            fence = getattr(self._converter, "fence", None)
            if fence is not None:
                fence(arrays, event)
        return out, event

    def _window(self):
        window, pending = assemble_window(self._pull, self._n_steps)
        arrays, k, tail = put_window(window, pending, self._converter)
        n = len(arrays)
        moved, event = self._to_device(arrays + (tail or ()))
        return DeviceWindow(
            moved[:n], k, moved[n:] if tail is not None else None,
            epoch=getattr(self._base, "epoch", 0),
            is_new_epoch=getattr(self._base, "is_new_epoch", False),
            epoch_detail=float(getattr(self._base, "epoch_detail", 0.0)),
            event=event)

    def _deliver(self, item) -> bool:
        """Put with stop-polling; on halt the item goes to the spill
        list instead of being dropped (its pre-pull snapshot is the
        rewind point when the consumer checkpoints mid-flight)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        self._spill.append(item)
        return False

    def _produce(self):
        while not self._stop.is_set():
            snap = self._snapshot()
            try:
                rec = self._window()
            except StopIteration:
                self._deliver(("stop", None, snap))
                return
            if not self._deliver(("window", rec, snap)):
                return

    def _worker(self):
        try:
            if self._stream is None:
                self._produce()
            else:
                with torch.cuda.device(self._device), \
                        torch.cuda.stream(self._stream):
                    self._produce()
        except BaseException as e:  # noqa: BLE001 — re-raised on next()
            self._deliver(("error", e, None))

    # ------------------------------------------------------------------ #
    # consumer side
    # ------------------------------------------------------------------ #

    def _ensure_worker(self):
        if self._thread is None and not self._finished \
                and self._error is None:
            self._thread = threading.Thread(
                target=self._worker, name="PrefetchIterator-worker",
                daemon=True)
            self._thread.start()

    def _take(self):
        if self._buffer:
            return self._buffer.pop(0)
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    # the worker may have delivered its last item between
                    # the timeout and its exit: look once more
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        pass
                    if self._spill:
                        return self._spill.pop(0)
                    raise RuntimeError(
                        "prefetch worker exited without a result")

    def __iter__(self):
        return self

    def __next__(self) -> DeviceWindow:
        if self._error is not None:
            raise self._error
        if self._finished:
            raise StopIteration
        self._ensure_worker()
        kind, rec, _snap = self._take()
        if kind == "error":
            self._error = rec
            self._join()
            raise rec
        if kind == "stop":
            self._finished = True
            self._join()
            raise StopIteration
        if rec.event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(rec.event)
            for t in rec.arrays:
                t.record_stream(consumer)
        self.epoch = rec.epoch
        self.is_new_epoch = rec.is_new_epoch
        self._epoch_detail = rec.epoch_detail
        return rec

    next = __next__

    @property
    def epoch_detail(self) -> float:
        """Consumed position (not the read-ahead position)."""
        return self._epoch_detail

    # wrapper-owned attribute names; anything else reads and writes
    # through to the base iterator (``create_synchronized_iterator``'s
    # ``it._rng = ...``; ``it.dataset = new; it.reset()``)
    _OWN_ATTRS = frozenset((
        "_base", "_comm", "_device", "_converter", "_n_steps", "depth",
        "_drop_remainder", "_stream", "_can_rewind", "_q", "_buffer",
        "_spill", "_stop", "_thread", "_error", "_finished", "epoch",
        "is_new_epoch", "_epoch_detail", "join_timeout",
    ))

    def __getattr__(self, name):
        # only fires for names not set on the wrapper — no recursion
        return getattr(self._base, name)

    def __setattr__(self, name, value):
        if name in self._OWN_ATTRS or "_base" not in self.__dict__ \
                or not hasattr(self._base, name):
            object.__setattr__(self, name, value)
        else:
            setattr(self._base, name, value)

    # ------------------------------------------------------------------ #
    # shutdown / halt
    # ------------------------------------------------------------------ #

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _halt(self):
        """Stop the worker and collect everything it produced, in order:
        drained queue items first, then the spilled in-flight item.
        Leaves the iterator restartable.  Raises RuntimeError after
        ``join_timeout`` if the worker never stops."""
        if self._thread is None:
            return
        self._stop.set()
        deadline = time.monotonic() + self.join_timeout
        while self._thread.is_alive():
            try:
                self._buffer.append(self._q.get(timeout=0.05))
            except queue.Empty:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"prefetch worker did not stop within "
                    f"{self.join_timeout}s — the base iterator's "
                    f"next() appears to be blocked; raise join_timeout or "
                    f"unblock the source before checkpointing")
        self._thread.join()
        self._thread = None
        while True:
            try:
                self._buffer.append(self._q.get_nowait())
            except queue.Empty:
                break
        self._buffer.extend(self._spill)
        self._spill = []
        self._stop = threading.Event()

    def close(self):
        """Join the worker, keeping what it pulled buffered: a later
        ``next()`` serves that first and restarts the worker behind it.
        Idempotent.  A worker stuck in a blocked ``next(base)`` is
        abandoned with a warning rather than hanging shutdown (it is a
        daemon)."""
        try:
            self._halt()
        except RuntimeError as e:
            warnings.warn(f"PrefetchIterator.close: {e}", RuntimeWarning)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # pragma: no cover
        stop = self.__dict__.get("_stop")
        if stop is not None:
            stop.set()

    # ------------------------------------------------------------------ #
    # resume protocol
    # ------------------------------------------------------------------ #

    def _oldest_snapshot(self):
        """Base-iterator state as of the oldest unconsumed pull.  An
        error at the head carries no snapshot (the failed pull never
        completed): the exception stays sticky and the live base state
        is returned."""
        for kind, rec, snap in self._buffer:
            if kind == "error":
                self._error = rec
                return self._snapshot()
            return snap
        return self._snapshot()

    def _rewind_to(self, st):
        if st is None:
            return
        # copy arrays: load_state_dict may keep them (SerialIterator
        # shuffles its order in place) and the caller holds this dict
        self._base.load_state_dict({
            k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in st.items()})

    def state_dict(self) -> dict:
        """Stop the worker and return the base iterator's state as of
        the oldest unconsumed pull — the dict the serial path would have
        produced here, so a snapshot taken under prefetch restores into
        either path.  The base is not rewound: the pulled lookahead stays
        buffered (``_take`` serves it first), so a save costs no replayed
        pull."""
        self._halt()
        if not self._can_rewind:
            return {"non_resumable": True}
        return dict(self._oldest_snapshot())   # the buffer keeps its own

    def load_state_dict(self, st: dict) -> None:
        self._halt()
        self._buffer = []
        self._error = None
        self._finished = False
        if st and not st.get("non_resumable") and self._can_rewind:
            self._rewind_to(st)
        self.epoch = getattr(self._base, "epoch", 0)
        self.is_new_epoch = getattr(self._base, "is_new_epoch", False)
        self._epoch_detail = float(
            getattr(self._base, "epoch_detail", 0.0))

    def reset(self):
        self._halt()
        self._buffer = []
        self._error = None
        self._finished = False
        self._base.reset()
        self.epoch = getattr(self._base, "epoch", 0)
        self.is_new_epoch = getattr(self._base, "is_new_epoch", False)
        self._epoch_detail = float(
            getattr(self._base, "epoch_detail", 0.0))
