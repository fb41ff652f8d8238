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

Not ported (ROADMAP Queue A item 10): the report's flight-recorder tail,
merged metrics and alert state; the report names them under
``not_ported``.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import torch.distributed as dist

__all__ = ["TrainingWatchdog"]

_KV_PREFIX = "watchdog/hb"
_NOT_PORTED = {
    "trace_tail": "the flight recorder, ROADMAP Queue A item 10",
    "metrics": "the merged metrics registry, ROADMAP Queue A item 10",
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
                 exit_code: int = 42):
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
        self._publish_beat()

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
        report = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "rank": self._rank,
            "kind": "local-stall" if local_stall else "peer-stall",
            "seconds_since_heartbeat": round(stalled_s, 3),
            "stall_timeout_s": self.stall_timeout,
            "iteration": self._iteration,
            "beats": self._beats,
            "peer_heartbeats": self._kv is not None,
            "peer_heartbeat_ages_s": peer_ages,
            "store_unreachable": self._store_error,
            "stalled_peers": stalled_peers,
            "threads": _thread_stacks(),
            "escalating": bool(self.escalate and local_stall),
            "not_ported": dict(_NOT_PORTED),
        }
        self.last_report = report
        path = self.report_path or "stall_report.json"
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
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
