"""Flight recorder — structured span tracing (the JAX package's
``utils/telemetry.py``).

- :class:`TraceRecorder` — a bounded ring of structured span events
  (name, category, t0 and duration, step, rank, thread, metadata).
  Disabled, ``span()`` returns one shared no-op context manager (no
  allocation, one attribute read).  Exports:

  * **Chrome trace-event JSON** (:meth:`~TraceRecorder.export_chrome`),
    for https://ui.perfetto.dev: the rank is the pid, a thread the
    tid; :func:`merge_traces` fuses the ranks' files into one document.
  * **streaming JSONL** (``stream_path=``): every event is appended as
    one line as it completes, so a killed process leaves its timeline on
    disk up to the kill; :meth:`~TraceRecorder.export_jsonl` dumps the
    ring after the fact.

- :class:`MetricsExport` — a JSONL time series of
  ``trainer.observation``, one line a trigger, each written whole.

Failure paths: the :class:`~chainermn_tpu_torch.extensions.
TrainingWatchdog` stall report embeds the ring's tail (``trace_tail``)
and :func:`~chainermn_tpu_torch.extensions.add_global_except_hook`
dumps the trace beside the crash.

The global recorder starts disabled: ``get_recorder().enable()``, or
``CHAINERMN_TPU_TRACE=1`` (with ``CHAINERMN_TPU_TRACE_CAPACITY`` and
``CHAINERMN_TPU_TRACE_STREAM=<path>``) before import — the JAX
package's variables.  A recorder's rank is ``torch.distributed``'s,
read when first needed (0 without a process group).

Not ported, each raising: the phase-stats channels
(:meth:`~TraceRecorder.open_phase_channel`,
:meth:`~TraceRecorder.drain_phase_stats`) and :class:`StragglerReport`,
which read the updater's step phases (ROADMAP Queue A item 10), and
:class:`RequestTraceStore`, the serving engine's request traces (item
12).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from chainermn_tpu_torch.utils.metrics import append_jsonl

__all__ = [
    "MetricsExport",
    "RequestTraceStore",
    "SpanEvent",
    "StragglerReport",
    "TraceRecorder",
    "get_recorder",
    "merge_traces",
    "set_recorder",
]

# Chrome trace-event phase codes used here: "X" complete (span with
# duration), "i" instant, "C" counter, "M" metadata.
_PH_SPAN, _PH_INSTANT, _PH_COUNTER = "X", "i", "C"


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to chainermn_tpu_torch yet (ROADMAP Queue "
        f"A item {item})")


def _default_rank() -> int:
    """The process's rank in the default process group (0 without
    one), read when first needed, so a recorder can exist before the
    group starts."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class SpanEvent:
    """One recorded event.  ``dur`` is seconds for spans, ``None`` for
    instants, and carries the counter value for counter events."""

    __slots__ = ("name", "cat", "ph", "t0", "dur", "step", "tid", "meta")

    def __init__(self, name, cat, ph, t0, dur, step, tid, meta):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.t0 = t0
        self.dur = dur
        self.step = step
        self.tid = tid
        self.meta = meta

    def to_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "t0": self.t0}
        if self.dur is not None:
            d["dur"] = self.dur
        if self.step is not None:
            d["step"] = self.step
        if self.tid is not None:
            d["tid"] = self.tid
        if self.meta:
            d["meta"] = self.meta
        return d


class _NullSpan:
    """The disabled-path context manager: ONE shared instance, so a
    disabled recorder allocates nothing per span (pinned by test)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **meta):
        return self


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_rec", "_name", "_cat", "_step", "_meta", "_t0")

    def __init__(self, rec, name, cat, step, meta):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._step = step
        self._meta = meta

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set(self, **meta):
        """Attach metadata discovered inside the block (measured values,
        outcome flags); merged into the event on exit."""
        if self._meta is None:
            self._meta = meta
        else:
            self._meta.update(meta)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rec._append(SpanEvent(
            self._name, self._cat, _PH_SPAN, self._t0, t1 - self._t0,
            self._step, threading.get_ident(), self._meta))
        return False


class TraceRecorder:
    """Bounded flight recorder of structured span events.

    Args:
      capacity: ring length — oldest events drop when full.  65536
        events ≈ a few MB; at ~6 spans per training step that is hours
        of history.
      enabled: start recording immediately (default False — the
        instrumented hot paths pay one attribute read and nothing else
        until :meth:`enable` is called).
      rank: the pid this recorder's events map to in the Chrome export.
        Default: the default process group's rank, read at export
        time.
      stream_path: when set, every completed event is ALSO appended to
        this file as one JSON line at record time (crash-durable
        streaming export; the ring is unaffected).

    Thread-safe: spans may open/close on any thread (the prefetch
    worker, checkpoint writer and watchdog monitor all record); the
    thread id rides each event and becomes the Chrome tid.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = False,
                 rank: Optional[int] = None,
                 stream_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._rank = rank
        self.stream_path = stream_path
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._stream_file = None
        self._thread_names: Dict[int, str] = {}
        # wall-clock anchor: perf_counter is monotonic but arbitrary;
        # the pair lets exports (and merge across processes) place
        # events on the wall clock
        self._anchor_wall = time.time()
        self._anchor_perf = time.perf_counter()
        self.dropped = 0          # events displaced by ring wrap

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #

    @property
    def rank(self) -> int:
        if self._rank is None:
            self._rank = _default_rank()
        return self._rank

    @rank.setter
    def rank(self, value: int) -> None:
        self._rank = int(value)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def __len__(self) -> int:
        return len(self._ring)

    def span(self, name: str, cat: str = "default",
             step: Optional[int] = None, **meta):
        """Context manager timing a block into the ring.  Disabled →
        returns the shared no-op singleton (zero allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, step, meta or None)

    def record(self, name: str, duration: float, cat: str = "default",
               step: Optional[int] = None, t0: Optional[float] = None,
               **meta) -> None:
        """Record an already-measured span (duration seconds; ``t0`` on
        the ``time.perf_counter`` clock, default now-minus-duration)."""
        if not self.enabled:
            return
        if t0 is None:
            t0 = time.perf_counter() - duration
        self._append(SpanEvent(name, cat, _PH_SPAN, t0, float(duration),
                               step, threading.get_ident(), meta or None))

    def instant(self, name: str, cat: str = "default",
                step: Optional[int] = None, **meta) -> None:
        """Zero-duration marker (heartbeats, plan changes, faults)."""
        if not self.enabled:
            return
        self._append(SpanEvent(name, cat, _PH_INSTANT,
                               time.perf_counter(), None, step,
                               threading.get_ident(), meta or None))

    def counter(self, name: str, value: float, cat: str = "counter",
                step: Optional[int] = None) -> None:
        """Sampled value rendered as a counter track in Perfetto
        (prefetch occupancy, queue depths)."""
        if not self.enabled:
            return
        self._append(SpanEvent(name, cat, _PH_COUNTER,
                               time.perf_counter(), float(value), step,
                               threading.get_ident(), None))

    def _append(self, ev: SpanEvent) -> None:
        tid = ev.tid
        if tid is not None and tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)      # deque.append is atomic
        if self.stream_path is not None:
            self._stream(ev)

    def _stream(self, ev: SpanEvent) -> None:
        with self._lock:
            if self.stream_path is None:    # closed under our feet
                return
            try:
                if self._stream_file is None:
                    self._stream_file = open(self.stream_path, "a")
                self._stream_file.write(
                    json.dumps(ev.to_dict(), default=str) + "\n")
                self._stream_file.flush()
            except OSError:
                # a full disk must degrade the stream, never training
                if self._stream_file is not None:
                    try:
                        self._stream_file.close()
                    except OSError:
                        pass
                self.stream_path = None
                self._stream_file = None

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    def tail(self, n: int = 64) -> List[dict]:
        """The newest ``n`` events as JSON-safe dicts — what the
        watchdog embeds in a stall report and the except hook dumps on
        crash: the timeline of the seconds before things went wrong.
        ``n <= 0`` means none (the opt-out, not the whole ring)."""
        if n <= 0:
            return []
        return [ev.to_dict() for ev in list(self._ring)[-n:]]

    def events(self) -> List[dict]:
        # list(deque) is a C-atomic snapshot: concurrent appends from
        # other threads (prefetch worker, watchdog monitor) must never
        # fault an export with "deque mutated during iteration"
        return [ev.to_dict() for ev in list(self._ring)]

    def open_phase_channel(self, key: str, names=None) -> str:
        """Not ported: the phase-stats channels feed the goodput and
        straggler reports (ROADMAP Queue A item 10)."""
        raise _not_ported("TraceRecorder.open_phase_channel", 10)

    def drain_phase_stats(self, names=None, channel: str = "") -> dict:
        """Not ported (ROADMAP Queue A item 10)."""
        raise _not_ported("TraceRecorder.drain_phase_stats", 10)

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #

    def _ts_us(self, t0: float) -> float:
        """perf_counter → wall-clock microseconds (the Chrome ``ts``
        axis; wall-anchored so independently-exported per-rank shards
        land on one comparable timeline, modulo host clock skew)."""
        return (t0 - self._anchor_perf + self._anchor_wall) * 1e6

    def chrome_events(self) -> List[dict]:
        """The ring as Chrome trace-event dicts (rank → pid, thread →
        tid), prefixed with the process/thread-name metadata events
        Perfetto uses to label the lanes."""
        pid = self.rank
        events: List[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"rank {pid}"},
        }]
        ring = list(self._ring)     # atomic snapshot (see events())
        tids = sorted({ev.tid for ev in ring if ev.tid is not None})
        tid_map = {ident: i for i, ident in enumerate(tids)}
        for ident in tids:
            events.append({
                "ph": "M", "pid": pid, "tid": tid_map[ident],
                "name": "thread_name",
                "args": {"name": self._thread_names.get(
                    ident, f"thread-{ident}")},
            })
        for ev in ring:
            rec = {
                "name": ev.name,
                "cat": ev.cat,
                "ph": ev.ph,
                "pid": pid,
                "tid": tid_map.get(ev.tid, 0),
                "ts": self._ts_us(ev.t0),
            }
            if ev.ph == _PH_SPAN:
                rec["dur"] = ev.dur * 1e6
            args = dict(ev.meta) if ev.meta else {}
            if ev.step is not None:
                args["step"] = ev.step
            if ev.ph == _PH_COUNTER:
                args["value"] = ev.dur
            if args:
                rec["args"] = args
            events.append(rec)
        return events

    def export_chrome(self, path: str) -> str:
        """Write the Perfetto-loadable Chrome trace JSON document."""
        doc = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "metadata": {
                "rank": self.rank,
                "capacity": self.capacity,
                "dropped": self.dropped,
                "anchor_wall_s": self._anchor_wall,
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path

    def export_jsonl(self, path: str) -> str:
        """Dump the ring as JSON lines (one event per line) — the
        after-the-fact form of the ``stream_path`` live export."""
        with open(path, "w") as f:
            for ev in list(self._ring):     # atomic snapshot
                f.write(json.dumps(ev.to_dict(), default=str) + "\n")
        return path

    def close(self) -> None:
        """End the streaming export: close the file AND clear
        ``stream_path``, so a straggler thread recording afterwards
        (prefetch worker, watchdog monitor) cannot silently reopen the
        file a reader already treated as end-of-stream."""
        with self._lock:
            self.stream_path = None
            if self._stream_file is not None:
                try:
                    self._stream_file.close()
                except OSError:
                    pass
                self._stream_file = None


def merge_traces(paths, out: Optional[str] = None) -> dict:
    """Fuse per-rank Chrome trace shards into ONE Perfetto document.

    ``paths`` may be a sequence of shard files, a DIRECTORY (every
    ``*.json`` inside), or a GLOB pattern (``"traces/rank*.json"``).
    However they arrive, shards are sorted deterministically by their
    recorded rank (``metadata.rank``; rankless shards sort after, by
    file name) BEFORE pid assignment — so the same shard set always
    produces the same Perfetto pid lanes, regardless of listing order
    (callers used to have to pre-sort paths themselves to keep pids
    stable across merges).

    Each shard keeps its own pid lane (rank → pid).  If two shards
    claim the same pid — e.g. single-process drills exporting twice —
    the later shard's pids are shifted past every pid already taken,
    so lanes never silently overlay.  Events merge in shard order;
    Perfetto sorts by ``ts`` itself (shards are wall-clock anchored).

    Returns the merged document; writes it to ``out`` when given.
    """
    import glob as _glob

    if isinstance(paths, (str, os.PathLike)):
        root = os.fspath(paths)
        if os.path.isdir(root):
            paths = [os.path.join(root, f) for f in os.listdir(root)
                     if f.endswith(".json")]
        else:
            paths = _glob.glob(root)
        if not paths:
            # a typo'd glob or empty/missing directory must not
            # succeed with an empty Perfetto doc (an explicit path
            # list still raises at open(), as it always did)
            raise FileNotFoundError(
                f"merge_traces: no trace shards found at {root!r}")

    shards: List[tuple] = []
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        rank = (doc.get("metadata", {}).get("rank")
                if isinstance(doc, dict) else None)
        shards.append((path, rank, doc))
    shards.sort(key=lambda s: (s[1] is None,
                               s[1] if isinstance(s[1], int) else 0,
                               os.path.basename(s[0])))

    merged: List[dict] = []
    meta: List[dict] = []
    used_pids: set = set()
    for path, rank, doc in shards:
        # both standard Chrome forms: object with traceEvents, or a
        # bare event array
        events = (doc.get("traceEvents", []) if isinstance(doc, dict)
                  else doc if isinstance(doc, list) else [])
        shard_pids = {ev.get("pid", 0) for ev in events}
        shift = 0
        if shard_pids & used_pids:
            shift = (max(used_pids) + 1) - min(shard_pids)
        used_pids |= {p + shift for p in shard_pids}
        for ev in events:
            if shift:
                ev = dict(ev)
                ev["pid"] = ev.get("pid", 0) + shift
            merged.append(ev)
        meta.append({"path": os.path.basename(path),
                     "pid_shift": shift,
                     **({} if rank is None else {"rank": rank})})
    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "metadata": {"merged_from": meta}}
    if out is not None:
        with open(out, "w") as f:
            json.dump(doc, f, default=str)
    return doc


class RequestTraceStore:
    """Not ported: the serving engine's per-request traces (ROADMAP
    Queue A item 12)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("RequestTraceStore", 12)


# ---------------------------------------------------------------------- #
# global recorder
# ---------------------------------------------------------------------- #

def _from_env() -> TraceRecorder:
    enabled = os.environ.get("CHAINERMN_TPU_TRACE", "") not in ("", "0")
    try:
        capacity = int(os.environ.get(
            "CHAINERMN_TPU_TRACE_CAPACITY", 65536))
        if capacity < 1:
            raise ValueError(capacity)
    except ValueError:
        # observability must never kill training: a typo'd env var
        # (runs at package import) degrades to the default, not a crash
        capacity = 65536
    stream = os.environ.get("CHAINERMN_TPU_TRACE_STREAM") or None
    return TraceRecorder(capacity=capacity, enabled=enabled,
                         stream_path=stream)


_GLOBAL = _from_env()


def get_recorder() -> TraceRecorder:
    """The process-global flight recorder every instrumented subsystem
    records into (disabled by default — see module docstring)."""
    return _GLOBAL


def set_recorder(recorder: TraceRecorder) -> TraceRecorder:
    """Swap the global recorder (tests, custom capacities); returns the
    previous one so callers can restore it."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = recorder
    return prev


# ---------------------------------------------------------------------- #
# trainer extensions
# ---------------------------------------------------------------------- #

class StragglerReport:
    """Not ported: the cross-rank straggler attribution, which drains
    the updater's step phases (ROADMAP Queue A item 10)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("StragglerReport", 10)


class MetricsExport:
    """JSONL time-series appender for ``trainer.observation``.

    Each trigger appends ONE line — iteration, epoch, elapsed wall
    clock, wall timestamp, and every float-coercible observation
    (optionally filtered by ``keys``) — to ``<trainer.out>/<filename>``.
    Each line lands via the atomic single-write append
    (:func:`chainermn_tpu_torch.utils.metrics.append_jsonl`), so the series
    survives a crash — including a SIGKILL mid-write — with no torn
    last line.  The structured, machine-readable sibling of LogReport's
    interval-averaged ``log`` (which rewrites the whole file each
    fire): this one is append-only and per-tick, the format scrapers
    and dashboards want.
    """

    trigger = (1, "iteration")
    priority = 45   # after ObservationAggregator (90) and the straggler
    # report (85) so aggregated/derived values are in the dict

    def __init__(self, path: Optional[str] = None,
                 filename: str = "metrics.jsonl",
                 keys: Optional[Sequence[str]] = None):
        self.path = path
        self.filename = filename
        self.keys = None if keys is None else list(keys)
        self._dir_made = False

    def initialize(self, trainer) -> None:
        if self.path is None:
            self.path = os.path.join(
                getattr(trainer, "out", "."), self.filename)

    def __call__(self, trainer) -> None:
        if self.path is None:       # used without initialize()
            self.initialize(trainer)
        obs = trainer.observation
        keys = self.keys if self.keys is not None else list(obs)
        entry = {
            "iteration": trainer.updater.iteration,
            "epoch": trainer.updater.epoch,
            "elapsed_time": trainer.elapsed_time,
            "ts": time.time(),
        }
        for k in keys:
            if k not in obs:
                continue
            try:
                entry[k] = float(obs[k])
            except (TypeError, ValueError):
                continue
        try:
            if not self._dir_made:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._dir_made = True
            append_jsonl(self.path, entry)
        except OSError:
            pass                    # observability must never kill training

    def finalize(self, trainer=None) -> None:
        pass                        # nothing held open between lines
