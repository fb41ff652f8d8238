"""Trainer — the host-side training loop with Chainer's extension
protocol (the JAX package's ``training/trainer.py``): interval
triggers, prioritised extensions, an observation dict an iteration,
``LogReport`` and ``PrintReport``.  Printing on rank 0 only is the
caller's choice, as in ChainerMN's examples."""

from __future__ import annotations

import json
import numbers
import os
import time
from typing import Optional

from .triggers import get_trigger

__all__ = ["Trainer", "LogReport", "PrintReport", "make_extension"]


def _scalar(v):
    """``float(v)`` for a number or a one-element array or tensor (an
    observation LogReport averages); None for anything else."""
    if isinstance(v, numbers.Real):
        return float(v)
    if hasattr(v, "shape") and getattr(v, "size", None) is not None:
        n = v.size if isinstance(v.size, int) else v.numel()
        return float(v) if n == 1 else None
    return None


class _ExtensionEntry:
    def __init__(self, ext, trigger, name, priority):
        self.ext = ext
        self.trigger = get_trigger(trigger)
        self.name = name
        self.priority = priority


def make_extension(trigger=(1, "epoch"), priority=100):
    """Decorator marking a function as a trainer extension (parity with
    ``chainer.training.make_extension``)."""

    def wrap(fn):
        fn.trigger = trigger
        fn.priority = priority
        return fn

    return wrap


class Trainer:
    def __init__(self, updater, stop_trigger, out: str = "result"):
        self.updater = updater
        period, unit = stop_trigger
        self._stop_period = period
        self._stop_unit = unit
        self.out = out
        self._extensions = []
        self.observation = {}
        self.elapsed_time = 0.0
        self._start = None
        self._stop_requested = False
        self.stop_reason = None

    def stop(self, reason: str = None):
        """Request a clean stop: the loop exits after the current
        iteration's extensions run (used by preemption handling)."""
        self._stop_requested = True
        self.stop_reason = reason

    def extend(self, extension, trigger=None, name=None, priority=None):
        trig = trigger if trigger is not None else getattr(
            extension, "trigger", (1, "epoch"))
        prio = priority if priority is not None else getattr(
            extension, "priority", 100)
        nm = name or getattr(extension, "name", None) or getattr(
            extension, "__name__", type(extension).__name__)
        self._extensions.append(_ExtensionEntry(extension, trig, nm, prio))
        self._extensions.sort(key=lambda e: -e.priority)
        return self

    def _done(self) -> bool:
        if self._stop_requested:
            return True
        if self._stop_unit == "epoch":
            return self.updater.epoch_detail >= self._stop_period
        return self.updater.iteration >= self._stop_period

    def run(self):
        # resume-aware clock: a restored elapsed_time offsets the start so
        # the logged timeline continues instead of restarting at zero
        self._start = time.perf_counter() - self.elapsed_time
        os.makedirs(self.out, exist_ok=True)
        # initialize-phase extensions (e.g. checkpointer.maybe_load ran
        # before run(); extensions with an initialize hook fire here)
        for e in self._extensions:
            init = getattr(e.ext, "initialize", None)
            if init:
                init(self)
            trig_init = getattr(e.trigger, "initialize", None)
            if trig_init:
                trig_init(self)
        try:
            while not self._done():
                self.updater.update()
                self.observation = dict(self.updater.observation)
                self.elapsed_time = time.perf_counter() - self._start
                for e in self._extensions:
                    # extensions with an ``observe`` hook see EVERY
                    # iteration's observation (LogReport interval
                    # averaging); ``__call__`` still fires on the trigger
                    obs_hook = getattr(e.ext, "observe", None)
                    if obs_hook:
                        obs_hook(self)
                for e in self._extensions:
                    if e.trigger(self):
                        e.ext(self)
        finally:
            # finalize even when update() raises: an in-flight async
            # checkpoint write must not be lost to the crash it exists
            # to protect against
            for e in self._extensions:
                fin = getattr(e.ext, "finalize", None)
                if fin:
                    fin(self)
            # release the updater's feed (joins a prefetching
            # iterator's worker thread; restarts transparently if
            # run() is called again)
            up_fin = getattr(self.updater, "finalize", None)
            if up_fin:
                up_fin()


class LogReport:
    """Collects observations into ``out/log`` (JSON list), averaging scalar
    entries over the report interval — rank-0 printing stays the user's
    choice exactly as in the reference examples."""

    def __init__(self, trigger=(1, "epoch"), filename: str = "log"):
        self.trigger = trigger
        self.priority = 50
        self._filename = filename
        self._accum = {}
        self._count = 0
        self.log = []

    def observe(self, trainer):
        """Called by the trainer every iteration (interval accumulation)."""
        for k, v in trainer.observation.items():
            f = _scalar(v)
            if f is not None:
                self._accum[k] = self._accum.get(k, 0.0) + f
        self._count += 1

    def state_dict(self) -> dict:
        return {"log": list(self.log), "accum": dict(self._accum),
                "count": self._count}

    def load_state_dict(self, st: dict) -> None:
        # a loaded snapshot holds 0-d arrays: back to Python numbers
        self.log = [{k: v.item() if hasattr(v, "item") else v
                     for k, v in e.items()} for e in st["log"]]
        self._accum = {k: float(v) for k, v in st["accum"].items()}
        self._count = int(st["count"])

    def __call__(self, trainer):
        # average of every observation since the last fire
        entry = {k: v / max(self._count, 1) for k, v in self._accum.items()}
        # plus values produced at trigger time by earlier-priority
        # extensions this same fire (e.g. the evaluator's validation/*)
        for k, v in trainer.observation.items():
            f = _scalar(v)
            if k not in entry and f is not None:
                entry[k] = f
        entry.update(
            iteration=trainer.updater.iteration,
            epoch=trainer.updater.epoch,
            elapsed_time=trainer.elapsed_time,
        )
        self.log.append(entry)
        self._accum, self._count = {}, 0
        path = os.path.join(trainer.out, self._filename)
        with open(path, "w") as f:
            json.dump(self.log, f, indent=1, default=float)


class PrintReport:
    def __init__(self, keys, log_report: Optional[LogReport] = None):
        self.trigger = (1, "epoch")
        self.priority = 40
        self._keys = keys
        self._log_report = log_report

    def __call__(self, trainer):
        src = (self._log_report.log[-1]
               if self._log_report and self._log_report.log
               else {**trainer.observation,
                     "iteration": trainer.updater.iteration,
                     "epoch": trainer.updater.epoch})
        parts = []
        for k in self._keys:
            v = src.get(k)
            parts.append(f"{k}={float(v):.6g}" if v is not None else f"{k}=--")
        print("  ".join(parts))
