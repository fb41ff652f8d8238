"""Runtime watchdog — a hung collective or a dead peer surfaces in
seconds (the JAX package's ``extensions/watchdog.py``).

ChainerMN had no failure detection: a rank wedged inside a collective
stalled the job silently.  :class:`TrainingWatchdog` is a daemon monitor
fed step-boundary heartbeats.  On a stall longer than its threshold it

1. writes a JSON stall report (rank, iteration, seconds stalled, every
   thread's Python stack, the peers' heartbeat ages) next to the
   trainer's output,
2. dumps every thread's stack with :mod:`faulthandler` to the standard
   error descriptor (safe even when the main thread is wedged in a
   collective that never returns to the interpreter),
3. optionally escalates: ``os._exit(exit_code)``, the global except
   hook's abort, so the launcher tears the job down.

Each stall episode is reported once, locally and per peer; a heartbeat
re-arms it.

Across ranks: with ``comm=`` on a world of more than one rank whose
communicator carries the world's key-value store
(``init_distributed``'s rendezvous), every heartbeat sets
``watchdog/hb/<rank>`` there, and the monitor reads the other ranks'
keys each check (``store.check`` first: ``get`` would block until the
key exists).  A peer whose key stops advancing is reported even when
this rank is healthy.  Ages are taken on this process's clock from the
moment a peer's beat count last changed; a peer that never published is
aged from the monitor's start.  The store lives in rank 0's process, so
rank 0's death makes it unreachable: the first read that fails marks
every peer stalled (the report names the error under
``store_unreachable``), the store is not probed again, and the local
check runs on.

The report carries the flight recorder's newest events
(``trace_tail``, ``trace_tail_events`` of them; empty when tracing is
off): what this process did in the seconds before the stall, beside the
stacks that show where it is stuck now.  Each heartbeat is an instant
event (``watchdog/heartbeat``) and a ``watchdog/heartbeats`` count; a
report counts ``watchdog/stalls``.  With an enabled metrics registry on
a world of several ranks, every rank publishes its snapshot on the store
at most every ``metrics_publish_interval`` seconds
(``watchdog/metrics/<rank>``), and the report embeds the merge of the
local registry with the peers' last snapshots (``metrics``, and as
Prometheus text ``metrics_prom``), computed with no collective: a hung
job cannot run one.

Not ported (ROADMAP Queue A item 10): the burn-rate alerts' state; the
report names it under ``not_ported``.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import torch.distributed as dist

from chainermn_tpu_torch.communicators._obj_channel import kv_get_json
from chainermn_tpu_torch.utils.metrics import (
    MetricsRegistry,
    get_registry,
    to_prometheus,
)
from chainermn_tpu_torch.utils.telemetry import get_recorder

__all__ = ["TrainingWatchdog"]

_KV_PREFIX = "watchdog/hb"
_KV_METRICS_PREFIX = "watchdog/metrics"
_NOT_PORTED = {
    "alerts": "the burn-rate alerts, ROADMAP Queue A item 10",
}


def _thread_stacks() -> dict:
    """The Python stack of every live thread, by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return {f"{names.get(ident, 'unknown')}-{ident}":
            traceback.format_stack(frame)
            for ident, frame in sys._current_frames().items()}


class TrainingWatchdog:
    """Trainer extension: stall detection with stack-dump reports.

    Args:
      stall_timeout: seconds without a heartbeat before a stall is
        reported.  The watchdog arms at the first heartbeat, so a slow
        first step (cuDNN's autotuning, a kernel build) never fires it.
      check_interval: the monitor's wake period (default a quarter of
        ``stall_timeout``).
      comm: optional communicator; on more than one rank with a store,
        cross-rank heartbeats (see the module's docstring).
      escalate: after reporting a local stall, ``os._exit(exit_code)``.
      on_stall: ``fn(report)`` called after the report is written; an
        exception it raises is swallowed, so the watchdog never crashes
        a healthy job.
      report_path: where the JSON report goes (default
        ``<trainer.out>/stall_report.json``, or the working directory).
      exit_code: the escalation's exit status.
      trace_tail_events: how many flight-recorder events the report
        embeds (``trace_tail``).
      metrics_publish_interval: the least seconds between two store
        publications of this rank's metrics snapshot.
    """

    trigger = (1, "iteration")
    # first on its tick: the heartbeat marks the step boundary before
    # slow extensions (evaluation, checkpoint writes) take wall time
    priority = 1000

    def __init__(self, stall_timeout: float = 300.0,
                 check_interval: Optional[float] = None,
                 comm=None, escalate: bool = False,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 report_path: Optional[str] = None,
                 exit_code: int = 42,
                 trace_tail_events: int = 64,
                 metrics_publish_interval: float = 2.0):
        if stall_timeout <= 0:
            raise ValueError("stall_timeout must be > 0")
        self.stall_timeout = float(stall_timeout)
        self.check_interval = (float(check_interval) if check_interval
                               else self.stall_timeout / 4.0)
        if self.check_interval <= 0:
            raise ValueError("check_interval must be > 0")
        self.comm = comm
        self.escalate = escalate
        self.on_stall = on_stall
        self.report_path = report_path
        self.exit_code = exit_code
        self.trace_tail_events = int(trace_tail_events)
        self.metrics_publish_interval = float(metrics_publish_interval)
        self._metrics_published_m = None
        self.stall_count = 0          # reports fired
        self.last_report: Optional[dict] = None
        self._beats = 0
        self._last_beat: Optional[float] = None   # armed at the first
        self._iteration = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reported_current_stall = False
        self._reported_peers: set = set()
        self._peer_seen: dict = {}    # rank -> (beats, monotonic seen)
        self._store_error: Optional[str] = None   # the store is gone
        self._was_running = False     # stopped while parked (rebind)
        self._started_m = None

    # ------------------------------------------------------------------ #
    # cross-rank heartbeats on the world's store
    # ------------------------------------------------------------------ #

    @property
    def _rank(self) -> int:
        return self.comm.rank if self.comm is not None else 0

    @property
    def _kv(self):
        """The world's key-value store, or None: no communicator, one
        rank, or a world started without ``init_distributed``."""
        if self.comm is None or self.comm.size <= 1:
            return None
        return getattr(self.comm, "store", None)

    def _publish_beat(self) -> None:
        kv = self._kv
        if kv is not None:
            kv.set(f"{_KV_PREFIX}/{self._rank}",
                   f"{self._beats},{time.time()}")

    def _publish_metrics(self) -> None:
        """This rank's registry snapshot on the store, at most every
        ``metrics_publish_interval`` seconds (a world of several ranks
        with an enabled registry only), so a peer's stall report can
        merge it."""
        kv = self._kv
        reg = get_registry()
        if kv is None or not reg.enabled:
            return
        now_m = time.monotonic()
        if self._metrics_published_m is not None and \
                now_m - self._metrics_published_m \
                < self.metrics_publish_interval:
            return
        self._metrics_published_m = now_m
        kv.set(f"{_KV_METRICS_PREFIX}/{self._rank}",
               json.dumps(reg.snapshot(), default=float))

    def _merged_metrics(self) -> dict:
        """The local registry's snapshot folded with every peer's last
        published one, with no collective (a hung job cannot run one);
        an unreachable store leaves the local snapshot."""
        merged = MetricsRegistry(enabled=True)
        merged.load(get_registry().snapshot())
        kv = self._kv
        if kv is None or self._store_error is not None:
            return merged.snapshot()
        for rank in range(self.comm.size):
            if rank == self._rank:
                continue          # the local registry is fresher
            try:
                snap = kv_get_json(kv, f"{_KV_METRICS_PREFIX}/{rank}")
            except dist.DistError:
                break
            if isinstance(snap, dict):
                merged.load(snap)
        return merged.snapshot()

    def _peer_beats(self, kv) -> dict:
        """``{rank: beat count, or None if never published}`` of every
        other rank, read without blocking."""
        beats = {}
        for rank in range(self.comm.size):
            if rank != self._rank:
                key = f"{_KV_PREFIX}/{rank}"
                beats[rank] = (int(kv.get(key).decode().split(",")[0])
                               if kv.check([key]) else None)
        return beats

    def _peer_ages(self) -> dict:
        """``{rank: seconds since this process saw its beat count
        change}`` of every other rank; a peer never seen is aged from
        the monitor's start."""
        kv = self._kv
        if kv is None:
            return {}
        beats = {}
        if self._store_error is None:
            try:
                beats = self._peer_beats(kv)
            except dist.DistError as e:
                # the store's host, rank 0's process, is gone: the
                # failure the cross-rank heartbeats exist to catch; a
                # new episode for every peer, reported once
                self._store_error = f"{type(e).__name__}: " \
                    f"{str(e).splitlines()[0]}"
                self._reported_peers.clear()
        now_m = time.monotonic()
        ages = {}
        for rank in range(self.comm.size):
            if rank == self._rank:
                continue
            seen = self._peer_seen.get(rank)
            b = beats.get(rank)
            if b is not None and (seen is None or seen[0] != b):
                self._peer_seen[rank] = (b, now_m)
                seen = self._peer_seen[rank]
            ages[rank] = round(
                now_m - (seen[1] if seen else self._started_m), 3)
        return ages

    # ------------------------------------------------------------------ #
    # heartbeat and monitor
    # ------------------------------------------------------------------ #

    def heartbeat(self, iteration=None) -> None:
        """Mark a step boundary; the first call arms the watchdog."""
        self._beats += 1
        self._iteration = iteration
        self._last_beat = time.monotonic()
        self._reported_current_stall = False
        get_recorder().instant("watchdog/heartbeat", cat="watchdog",
                               step=iteration, beats=self._beats)
        get_registry().inc("watchdog/heartbeats")
        self._publish_beat()
        self._publish_metrics()

    def rebind_world(self, comm) -> None:
        """Follow a live resize.  ``None``: this rank is parked and
        beats no heartbeat, so the monitor stops (a parked rank is not a
        stall).  A communicator: the peers are the new world's; the
        monitor restarts, armed again at the next heartbeat."""
        running = self._thread is not None or self._was_running
        self.stop()
        self._last_beat = None
        self._peer_seen.clear()
        self._reported_peers.clear()
        self._was_running = running and comm is None
        if comm is None:
            return
        if self.comm is not None:
            self.comm = comm
        if running:
            self._started_m = time.monotonic()
            self.start()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        if self._started_m is None:
            self._started_m = time.monotonic()
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._monitor, name="training-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        th = self._thread
        if th is not None:
            th.join(timeout=self.check_interval + 5)
        self._thread = None

    def _monitor(self) -> None:
        while not self._stop_evt.wait(self.check_interval):
            last = self._last_beat
            if last is None:        # not armed yet
                continue
            stalled_s = time.monotonic() - last
            peer_ages = self._peer_ages()
            # an unreachable store stalls every peer
            stalled_peers = {r: a for r, a in peer_ages.items()
                             if a > self.stall_timeout
                             or self._store_error is not None}
            # one report an episode, per peer too; a peer that beats
            # again re-arms
            self._reported_peers &= set(stalled_peers)
            new_peers = {r: a for r, a in stalled_peers.items()
                         if r not in self._reported_peers}
            local_stall = stalled_s > self.stall_timeout
            if not (local_stall and not self._reported_current_stall) \
                    and not new_peers:
                continue
            self._reported_peers |= set(new_peers)
            self._fire(local_stall, stalled_s, peer_ages, new_peers)

    # ------------------------------------------------------------------ #
    # a stall
    # ------------------------------------------------------------------ #

    def _fire(self, local_stall, stalled_s, peer_ages, stalled_peers):
        if local_stall:
            # a peer-only report leaves the local episode armed
            self._reported_current_stall = True
        self.stall_count += 1
        get_registry().inc("watchdog/stalls")
        recorder = get_recorder()
        metrics = self._merged_metrics()
        report = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "rank": self._rank,
            "kind": "local-stall" if local_stall else "peer-stall",
            # rounded up to the ms: never below the threshold it crossed
            "seconds_since_heartbeat": math.ceil(stalled_s * 1e3) / 1e3,
            "stall_timeout_s": self.stall_timeout,
            "iteration": self._iteration,
            "beats": self._beats,
            "peer_heartbeats": self._kv is not None,
            "peer_heartbeat_ages_s": peer_ages,
            "store_unreachable": self._store_error,
            "stalled_peers": stalled_peers,
            "threads": _thread_stacks(),
            "escalating": bool(self.escalate and local_stall),
            # what this process did before the beats stopped
            "trace_tail": recorder.tail(self.trace_tail_events),
            "trace_enabled": recorder.enabled,
            # the job's last metrics, merged over the ranks' snapshots
            "metrics": metrics,
            "metrics_prom": to_prometheus(metrics,
                                          labels={"rank": "merged"}),
            "metrics_enabled": get_registry().enabled,
            "not_ported": dict(_NOT_PORTED),
        }
        self.last_report = report
        path = self.report_path or "stall_report.json"
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=str)
        sys.stderr.write(
            f"\n[chainermn_tpu_torch watchdog] rank {self._rank}: "
            f"{report['kind']}: no step-boundary heartbeat for "
            f"{stalled_s:.1f}s (threshold {self.stall_timeout}s, "
            f"iteration {self._iteration}); report at {path}\n")
        sys.stderr.flush()
        # the crash-safe dump, to the descriptor itself: it walks every
        # thread even when the interpreter is wedged
        faulthandler.dump_traceback(file=2, all_threads=True)
        if self.on_stall is not None:
            try:
                self.on_stall(report)
            except Exception:
                pass    # a failing callback must not crash a healthy job
        if self.escalate and local_stall:
            os._exit(self.exit_code)

    # ------------------------------------------------------------------ #
    # the trainer's extension protocol
    # ------------------------------------------------------------------ #

    def initialize(self, trainer) -> None:
        if self.report_path is None:
            self.report_path = os.path.join(
                getattr(trainer, "out", "."), "stall_report.json")
        self.start()

    def __call__(self, trainer) -> None:
        self.heartbeat(iteration=trainer.updater.iteration)

    def finalize(self, trainer=None) -> None:
        self.stop()
