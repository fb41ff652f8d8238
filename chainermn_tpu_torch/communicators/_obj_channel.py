"""Object p2p and group allgather over the world's key-value store (the
JAX package's ``communicators/_obj_channel.py``, on a c10d ``Store``
where the JAX package uses its coordination service).

- A message is named ``(src, dst, seq)``: both ends keep a sequence
  counter a lane, so messages match in order, as MPI's do, with no
  header exchange.
- A payload is pickled and cut into frames of :data:`FRAME_BYTES`, set
  under their own keys before the metadata key, so a reader that sees
  the metadata finds every frame.  A receiver deletes what it read.
- Transient store errors (``DistNetworkError``, a connection reset, a
  broken pipe) are retried with a bounded exponential backoff
  (:data:`KV_RETRIES`).  A timeout is not retried (the caller sized it
  to detect a deadlock), and a lane's counters advance only once its
  message is known to exist, so a retried or timed-out verb never
  desynchronises the lane.  Retries feed the metrics registry
  (``comm/kv_retries``, ``comm/kv_wait``).
- Every payload carries the channel's GENERATION
  (:meth:`KVObjectChannel.set_generation`, the elastic membership
  epoch).  A message published under another generation is rejected at
  receipt with :class:`StaleGenerationError` (and counted as
  ``comm/stale_generation_rejected``), never consumed as live traffic.

The store is the one :func:`~chainermn_tpu_torch.communicators.
init_distributed` keeps (``comm.store``), or any c10d ``Store`` given
as ``store=``.  ``Store.get`` blocks until the store's own timeout, so a
read first waits for its key with the channel's ``timeout_ms``; a
presence test is ``check([key])``.  This is a control-plane channel
(membership agreement, resize intents); tensors ride NCCL.
"""

from __future__ import annotations

import json
import pickle
import time
from datetime import timedelta
from typing import Any, Optional

import torch.distributed as dist

__all__ = ["DataSizeError", "FRAME_BYTES", "KVObjectChannel",
           "MAX_OBJ_BYTES", "StaleGenerationError", "kv_get_json",
           "read_json_file", "world_store"]


class StaleGenerationError(RuntimeError):
    """A received message was published under another generation than
    the channel's.  After a resize the members fence their channels to
    the new membership epoch (:class:`~chainermn_tpu_torch.training.
    elastic.ElasticMembership`); a message of the old incarnation still
    on the store surfaces as this error.  On a p2p lane the rejected
    message IS consumed (the lane advances and its keys are deleted:
    the receiver is its only reader), so the lane stays usable; a group
    allgather rejects WITHOUT deleting (its other readers may still be
    reading) and the members re-enter the collective together."""


class DataSizeError(ValueError):
    """A single object over the channel's hard size cap
    (:data:`MAX_OBJ_BYTES`, MPI's 2**31 count limit): move bulk data
    through the tensor collectives instead."""


# one store value a frame
FRAME_BYTES = 2 * 1024 * 1024
MAX_OBJ_BYTES = 2**31

KV_RETRIES = 4
KV_BACKOFF_BASE_S = 0.05
KV_BACKOFF_MAX_S = 2.0
_TRANSIENT_MARKERS = ("connection reset", "broken pipe")


def _is_transient(exc: BaseException) -> bool:
    """A store error worth retrying: a network error, a reset
    connection or a broken pipe; never a timeout."""
    msg = str(exc).lower()
    if "timeout" in msg or "timed out" in msg:
        return False
    if isinstance(exc, dist.DistNetworkError):
        return True
    return any(m in msg for m in _TRANSIENT_MARKERS)


def world_store():
    """The world's key-value store (``init_distributed``'s
    rendezvous), or ``None``."""
    from chainermn_tpu_torch import communicators

    return communicators._STORE


def _kv_set(store, key: str, value) -> None:
    """Retrying set.  A c10d set overwrites, so a retry of a first
    attempt that landed before its error was reported writes the same
    value again."""
    _kv_retry(lambda: store.set(key, value), "key set")


def _kv_delete(store, key: str) -> None:
    """Retrying delete; a key already gone is fine (``delete_key``
    answers False)."""
    _kv_retry(lambda: store.delete_key(key), "key delete")


def _kv_get(store, key: str, timeout_ms: int) -> bytes:
    """Wait up to ``timeout_ms`` for ``key``, then read it (retried on
    transient errors; a timeout raises at once)."""
    def once():
        store.wait([key], timedelta(milliseconds=timeout_ms))
        return store.get(key)

    return _kv_retry(once, "key get")


def kv_get_json(store, key: str):
    """The JSON value under ``key``, or ``None`` when the key is absent
    or its value is not JSON: a presence test first (``check``), so
    this never blocks."""
    if not store.check([key]):
        return None
    try:
        return json.loads(store.get(key).decode())
    except (ValueError, UnicodeDecodeError):
        return None


def read_json_file(path: str) -> dict:
    """The JSON object in ``path``, or ``{}`` when the file is absent or
    unreadable: the membership record beside the snapshots, written
    atomically, read the same tolerant way as its store key."""
    try:
        with open(path) as fh:
            out = json.load(fh)
    except (OSError, ValueError):
        return {}
    return out if isinstance(out, dict) else {}


def _kv_retry(fn, what: str):
    """``fn()``, retrying transient errors up to :data:`KV_RETRIES`
    times with exponential backoff; anything else propagates at once.
    Every store verb of this module goes through here, so this is where
    retries are counted: ``comm/kv_retries`` (the retry attempts) and
    ``comm/kv_wait`` (each verb's wall time, backoff included).  A
    disabled registry costs one attribute read."""
    from chainermn_tpu_torch.utils.metrics import get_registry

    reg = get_registry()
    # armed whatever the registry's state, so a registry enabled during
    # the verb records its real duration
    t0 = time.perf_counter()

    def _observe(attempt: int) -> None:
        if not reg.enabled:
            return
        if attempt:
            reg.inc("comm/kv_retries", attempt)
        reg.observe("comm/kv_wait", time.perf_counter() - t0)

    delay = KV_BACKOFF_BASE_S
    for attempt in range(KV_RETRIES + 1):
        try:
            out = fn()
        except dist.DistError as e:
            if attempt >= KV_RETRIES or not _is_transient(e):
                _observe(attempt)
                raise
            time.sleep(delay)
            delay = min(delay * 2, KV_BACKOFF_MAX_S)
        else:
            _observe(attempt)
            return out


# the envelope's marker: a reader of another channel version fails
# loudly instead of handing user code a tuple it never sent
_GEN_ENVELOPE = "cmnobj-gen1"


class KVObjectChannel:
    """MPI-ordered object p2p and group allgather between processes over
    a key-value store."""

    def __init__(self, tag: str = "cmnobj", timeout_ms: int = 120_000,
                 store=None):
        self._tag = tag
        self._timeout_ms = timeout_ms
        self._store = store
        self._send_seq: dict = {}
        self._recv_seq: dict = {}
        self._ag_seq = 0
        self._ag_frames: dict = {}  # seq -> own frame count (lazy GC)
        # the membership epoch every payload carries and every receipt
        # checks; 0 before any resize
        self._generation = 0

    @property
    def generation(self) -> int:
        return self._generation

    def set_generation(self, generation: int) -> None:
        """Fence the channel to ``generation`` (the agreed membership
        epoch): later messages carry it, and received ones must."""
        self._generation = int(generation)

    @property
    def _client(self):
        store = self._store if self._store is not None else world_store()
        if store is None:
            raise RuntimeError(
                "KVObjectChannel needs a key-value store: the world's "
                "(call chainermn_tpu_torch.communicators.init_distributed "
                "first) or store=")
        return store

    def _key(self, src: int, dst: int, seq: int, part: str) -> str:
        return f"{self._tag}/{src}.{dst}.{seq}/{part}"

    def _publish(self, obj: Any, keyfn, what: str) -> int:
        """Pickle and cap-check ``obj`` and set it as frames, the
        metadata key last.  Returns the frame count."""
        payload = pickle.dumps((_GEN_ENVELOPE, self._generation, obj))
        if len(payload) > MAX_OBJ_BYTES:
            raise DataSizeError(
                f"{what} payload is {len(payload)} bytes, over the "
                f"{MAX_OBJ_BYTES}-byte cap; move bulk data through the "
                "tensor collectives instead")
        store = self._client
        nframes = max(1, -(-len(payload) // FRAME_BYTES))
        for k in range(nframes):
            _kv_set(store, keyfn(f"c{k}"),
                    payload[k * FRAME_BYTES:(k + 1) * FRAME_BYTES])
        _kv_set(store, keyfn("meta"), f"{nframes},{len(payload)}")
        return nframes

    def _collect(self, keyfn, what: str, meta: Optional[str] = None) -> Any:
        """Blocking read of a message :meth:`_publish` wrote; ``meta``
        when the caller read the metadata key already."""
        store = self._client
        if meta is None:
            meta = _kv_get(store, keyfn("meta"), self._timeout_ms).decode()
        nframes, total = (int(v) for v in meta.split(","))
        buf = bytearray()
        for k in range(nframes):
            buf += _kv_get(store, keyfn(f"c{k}"), self._timeout_ms)
        if len(buf) != total:
            raise RuntimeError(
                f"{what} corruption: expected {total} bytes, "
                f"reassembled {len(buf)}")
        msg = pickle.loads(bytes(buf))
        if not (isinstance(msg, tuple) and len(msg) == 3
                and msg[0] == _GEN_ENVELOPE):
            raise RuntimeError(
                f"{what}: payload is not a generation-tagged envelope — "
                "sender and receiver run different channel versions")
        gen, obj = msg[1], msg[2]
        if gen != self._generation:
            from chainermn_tpu_torch.utils.metrics import get_registry

            get_registry().inc("comm/stale_generation_rejected")
            raise StaleGenerationError(
                f"{what}: message from mesh generation {gen} rejected "
                f"(this channel is fenced to generation "
                f"{self._generation}) — traffic from a different "
                "membership epoch must not be consumed as live")
        return obj

    def send(self, obj: Any, src: int, dst: int) -> None:
        """Send ``obj`` on the (src, dst) lane; returns when published."""
        seq = self._send_seq.get((src, dst), 0)
        self._send_seq[(src, dst)] = seq + 1
        self._publish(
            obj, lambda part: self._key(src, dst, seq, part), "send_obj")

    def allgather(self, obj: Any, group, me: int):
        """Allgather over the store among the ranks of ``group`` (``me``
        one of them); the objects in sorted ``group`` order.  Ranks
        outside ``group`` never enter, so it serves a group no process
        group spans.

        Lazy GC: entering call ``s`` deletes this rank's keys of call
        ``s-2``.  Every member reading call ``s-1``'s payloads, which
        any member needs to reach ``s``, means every member finished its
        read of ``s-2``."""
        if me not in group:
            raise ValueError(f"process {me} not in group {sorted(group)}")
        store = self._client
        s = self._ag_seq
        self._ag_seq += 1
        old = self._ag_frames.pop(s - 2, None)
        if old is not None:
            for k in range(old):
                _kv_delete(store, self._key(me, -1, s - 2, f"gc{k}"))
            _kv_delete(store, self._key(me, -1, s - 2, "gmeta"))

        def keyfn(p):
            return lambda part: self._key(
                p, -1, s, "gmeta" if part == "meta" else "g" + part)

        self._ag_frames[s] = self._publish(obj, keyfn(me), "allgather_obj")
        # a stale frame raises WITHOUT deleting the member's keys: a
        # peer may still be reading them
        return [
            obj if p == me else self._collect(
                keyfn(p), f"obj allgather from process {p}")
            for p in sorted(group)
        ]

    def recv(self, src: int, dst: int) -> Any:
        """Receive the next in-order object on the (src, dst) lane."""
        store = self._client
        seq = self._recv_seq.get((src, dst), 0)
        meta = _kv_get(store, self._key(src, dst, seq, "meta"),
                       self._timeout_ms).decode()
        # the lane advances once the message is known to exist: a
        # timed-out recv can be retried in order
        self._recv_seq[(src, dst)] = seq + 1
        nframes = int(meta.split(",")[0])

        def _delete_message():
            for k in range(nframes):
                _kv_delete(store, self._key(src, dst, seq, f"c{k}"))
            _kv_delete(store, self._key(src, dst, seq, "meta"))

        try:
            obj = self._collect(
                lambda part: self._key(src, dst, seq, part),
                "obj channel", meta=meta)
        except StaleGenerationError:
            # consumed all the same: a dead slot must not shadow a later
            # publish at the same (src, dst, seq)
            _delete_message()
            raise
        _delete_message()
        return obj
