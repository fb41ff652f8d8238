"""The port's flight recorder (``chainermn_tpu_torch/utils/telemetry.py``)
against the JAX package's.

The cases of the JAX package's ``tests/util_tests/test_telemetry.py``
run against the port, all but the phase-stats channels, the straggler
report and the request traces, which are not ported and raise (checked
here); the instrumentation cases are the port's recordings (the
checkpoint's serialization spans, the watchdog's heartbeats and stall
report, the except hook's dump) on the port's trainer.  Parity: the
same spans under a clock fixed in both packages give the same Chrome
events, and ``merge_traces`` of the same rank files gives the JAX
merge's document, exactly.
"""

import json
import time

import numpy as np
import pytest
import torch

from chainermn_tpu.utils import telemetry as JT
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.extensions import TrainingWatchdog
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import mlp_apply, softmax_cross_entropy
from chainermn_tpu_torch.testing import FaultInjector, FaultPlan
from chainermn_tpu_torch.utils.telemetry import (
    MetricsExport,
    RequestTraceStore,
    StragglerReport,
    TraceRecorder,
    merge_traces,
    set_recorder,
)


@pytest.fixture()
def recorder():
    """Fresh enabled recorder installed as the global one (the
    instrumented subsystems all record into get_recorder()); the
    previous global is restored afterwards."""
    rec = TraceRecorder(capacity=4096, enabled=True, rank=0)
    prev = set_recorder(rec)
    yield rec
    set_recorder(prev)


def _dataset(n=64, dim=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(dim).astype(np.float32), np.int32(i % classes))
            for i in range(n)]


def _make_trainer(comm, out, epochs=2, **updater_kw):
    rng = np.random.RandomState(0)
    params = [{"w": torch.tensor(rng.randn(6, 12).astype(np.float32)),
               "b": torch.zeros(12)},
              {"w": torch.tensor(rng.randn(12, 3).astype(np.float32)),
               "b": torch.zeros(3)}]
    it = SerialIterator(_dataset(), 16, shuffle=True, seed=3)
    opt = training.create_multi_node_optimizer(training.sgd(0.05), comm)

    def loss_fn(p, x, y):
        return softmax_cross_entropy(mlp_apply(p, x), y)

    upd = training.StandardUpdater(it, opt, loss_fn, params, comm,
                                   **updater_kw)
    return training.Trainer(upd, (epochs, "epoch"), out=str(out))


@pytest.fixture()
def comm():
    return LoopbackCommunicator(device="cpu")


# ---------------------------------------------------------------------- #
# ring buffer
# ---------------------------------------------------------------------- #

class TestRing:
    def test_bound_enforced_oldest_dropped(self):
        rec = TraceRecorder(capacity=8, enabled=True, rank=0)
        for i in range(30):
            rec.record(f"ev{i}", 0.001)
        assert len(rec) == 8
        assert rec.dropped == 22
        names = [e["name"] for e in rec.events()]
        assert names == [f"ev{i}" for i in range(22, 30)]

    def test_tail_returns_newest(self):
        rec = TraceRecorder(capacity=100, enabled=True, rank=0)
        for i in range(10):
            rec.record(f"ev{i}", 0.001, step=i)
        tail = rec.tail(3)
        assert [e["name"] for e in tail] == ["ev7", "ev8", "ev9"]
        assert tail[-1]["step"] == 9
        # n <= 0 is the opt-out, not a whole-ring dump
        assert rec.tail(0) == [] and rec.tail(-1) == []

    def test_bad_capacity_rejected(self):
        with pytest.raises(ValueError):
            TraceRecorder(capacity=0)

    def test_malformed_env_capacity_degrades_not_crashes(self,
                                                         monkeypatch):
        """A typo'd CHAINERMN_TPU_TRACE_CAPACITY runs at package import
        — it must fall back to the default, never break `import
        chainermn_tpu_torch`."""
        from chainermn_tpu_torch.utils import telemetry as T

        monkeypatch.setenv("CHAINERMN_TPU_TRACE_CAPACITY", "64k")
        assert T._from_env().capacity == 65536
        monkeypatch.setenv("CHAINERMN_TPU_TRACE_CAPACITY", "0")
        assert T._from_env().capacity == 65536
        monkeypatch.setenv("CHAINERMN_TPU_TRACE_CAPACITY", "128")
        assert T._from_env().capacity == 128


# ---------------------------------------------------------------------- #
# disabled path
# ---------------------------------------------------------------------- #

class TestDisabled:
    def test_span_returns_shared_singleton(self):
        """Zero allocation when disabled: every span() call hands back
        the SAME no-op object, and nothing reaches the ring."""
        rec = TraceRecorder(enabled=False)
        a = rec.span("x", cat="step", step=1, k=2)
        b = rec.span("y")
        assert a is b
        with a:
            pass
        rec.record("z", 1.0)
        rec.instant("i")
        rec.counter("c", 3)
        assert len(rec) == 0

    def test_enable_disable_toggle(self):
        rec = TraceRecorder(enabled=False)
        rec.enable()
        with rec.span("x"):
            pass
        rec.disable()
        with rec.span("y"):
            pass
        assert [e["name"] for e in rec.events()] == ["x"]


# ---------------------------------------------------------------------- #
# export: Chrome trace schema + merge
# ---------------------------------------------------------------------- #

class TestExport:
    def test_chrome_schema_round_trip(self, tmp_path):
        rec = TraceRecorder(enabled=True, rank=3)
        with rec.span("step/host", cat="step", step=7, k=4):
            time.sleep(0.002)
        rec.instant("watchdog/heartbeat", cat="watchdog", step=7)
        rec.counter("prefetch/occupancy", 2)
        path = str(tmp_path / "trace.json")
        rec.export_chrome(path)

        doc = json.load(open(path))
        assert doc["displayTimeUnit"] == "ms"
        assert doc["metadata"]["rank"] == 3
        events = doc["traceEvents"]
        # lane labels: process_name metadata carries the rank mapping
        meta = [e for e in events if e["ph"] == "M"]
        assert any(e["name"] == "process_name"
                   and e["args"]["name"] == "rank 3" for e in meta)
        assert all(e["pid"] == 3 for e in events)
        by_name = {e["name"]: e for e in events if e["ph"] != "M"}
        span = by_name["step/host"]
        assert span["ph"] == "X" and span["cat"] == "step"
        assert span["dur"] >= 2e3          # microseconds
        assert span["args"]["step"] == 7 and span["args"]["k"] == 4
        assert by_name["watchdog/heartbeat"]["ph"] == "i"
        counter = by_name["prefetch/occupancy"]
        assert counter["ph"] == "C" and counter["args"]["value"] == 2.0
        # a counter recorded with a step keeps it alongside the value
        rec.counter("stepped", 5, step=9)
        stepped = [e for e in rec.chrome_events()
                   if e["name"] == "stepped"][0]
        assert stepped["args"] == {"step": 9, "value": 5.0}
        # ts is wall-anchored microseconds: recent, monotone-ish
        assert span["ts"] == pytest.approx(time.time() * 1e6, rel=0.01)

    def test_merge_traces_distinct_pids(self, tmp_path):
        paths = []
        for rank in range(3):
            rec = TraceRecorder(enabled=True, rank=rank)
            with rec.span("step/host", cat="step", step=1):
                pass
            p = str(tmp_path / f"trace.{rank}.json")
            rec.export_chrome(p)
            paths.append(p)
        out = str(tmp_path / "merged.json")
        doc = merge_traces(paths, out=out)
        assert json.load(open(out)) == doc
        pids = {e["pid"] for e in doc["traceEvents"]}
        assert pids == {0, 1, 2}
        # every rank's lane is labelled
        labels = {e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "process_name"}
        assert labels == {"rank 0", "rank 1", "rank 2"}

    def test_merge_accepts_bare_event_array_shard(self, tmp_path):
        """The other standard Chrome form — a bare JSON event array
        (external tracers emit it) — must merge, not AttributeError."""
        rec = TraceRecorder(enabled=True, rank=0)
        with rec.span("ours"):
            pass
        p0 = str(tmp_path / "ours.json")
        rec.export_chrome(p0)
        p1 = str(tmp_path / "bare.json")
        with open(p1, "w") as f:
            json.dump([{"name": "theirs", "ph": "X", "ts": 1.0,
                        "dur": 2.0, "pid": 7, "tid": 0}], f)
        doc = merge_traces([p0, p1])
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"ours", "theirs"} <= names
        assert {e["pid"] for e in doc["traceEvents"]} == {0, 7}

    def test_merge_shifts_colliding_pids(self, tmp_path):
        paths = []
        for i in range(2):                 # both shards claim pid 0
            rec = TraceRecorder(enabled=True, rank=0)
            with rec.span(f"shard{i}"):
                pass
            p = str(tmp_path / f"t{i}.json")
            rec.export_chrome(p)
            paths.append(p)
        doc = merge_traces(paths)
        pids = {e["pid"] for e in doc["traceEvents"]}
        assert len(pids) == 2, "colliding shards must not overlay lanes"

    def test_export_tolerates_concurrent_appends(self):
        """Exports snapshot the ring: a recorder thread (prefetch
        worker, watchdog monitor) appending mid-export must never fault
        the export — the crash-dump path runs exactly while other
        threads are still alive and recording."""
        import threading

        rec = TraceRecorder(capacity=512, enabled=True, rank=0)
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                rec.record("bg", 0.001)

        th = threading.Thread(target=hammer, daemon=True)
        th.start()
        try:
            for _ in range(200):
                rec.chrome_events()
                rec.events()
                rec.tail(16)
        finally:
            stop.set()
            th.join()

    def test_jsonl_exports(self, tmp_path):
        stream = str(tmp_path / "live.jsonl")
        rec = TraceRecorder(enabled=True, rank=0, stream_path=stream)
        with rec.span("a", cat="step"):
            pass
        rec.instant("b")
        rec.close()
        live = [json.loads(l) for l in open(stream)]
        assert [e["name"] for e in live] == ["a", "b"]
        dumped = str(tmp_path / "dump.jsonl")
        rec.export_jsonl(dumped)
        again = [json.loads(l) for l in open(dumped)]
        assert [e["name"] for e in again] == ["a", "b"]
        # close() ends the stream for good: a straggler thread's event
        # after close must not silently reopen the file
        rec.instant("after-close")
        assert len(open(stream).readlines()) == 2


# ---------------------------------------------------------------------- #
# instrumentation: the stack records into the recorder
# ---------------------------------------------------------------------- #

class TestInstrumentation:
    def test_checkpoint_spans_recorded(self, comm, recorder, tmp_path):
        from chainermn_tpu_torch.utils.serialization import (
            load_state,
            save_state,
            verify_state,
        )

        path = str(tmp_path / "snap")
        save_state(path, {"a": np.arange(8), "b": np.float32(3.0)})
        load_state(path)
        verify_state(path)
        names = [e["name"] for e in recorder.events()]
        assert names == ["checkpoint/save", "checkpoint/load",
                         "checkpoint/crc_walk"]
        save_ev = next(e for e in recorder.events()
                       if e["name"] == "checkpoint/save")
        assert save_ev["meta"]["n_leaves"] == 2
        assert save_ev["meta"]["nbytes"] > 0

    def test_watchdog_heartbeat_instants(self, recorder):
        wd = TrainingWatchdog(stall_timeout=60)
        wd.heartbeat(iteration=5)
        ev = recorder.events()[-1]
        assert ev["name"] == "watchdog/heartbeat"
        assert ev["ph"] == "i" and ev["step"] == 5


# ---------------------------------------------------------------------- #
# failure paths
# ---------------------------------------------------------------------- #

class TestFailurePaths:
    def test_stall_report_embeds_ring_tail_under_delay_drill(
            self, comm, recorder, tmp_path):
        """The acceptance drill: a FaultPlan delay-rank stall past the
        watchdog threshold must produce a stall report whose
        ``trace_tail`` carries the flight recorder's timeline of the
        steps leading up to the stall."""
        trainer = _make_trainer(comm, tmp_path, epochs=2)
        reports = []
        wd = TrainingWatchdog(stall_timeout=0.3, check_interval=0.1,
                              on_stall=reports.append)
        trainer.extend(wd)
        plan = FaultPlan(delay_at_iteration=3, delay_rank=0,
                         delay_seconds=0.8)
        injector = FaultInjector(plan, comm=comm)
        trainer.extend(injector)
        trainer.run()

        assert ("delay", 3) in injector.fired
        assert wd.stall_count >= 1
        rep = reports[0]
        assert rep["kind"] == "local-stall"
        assert rep["trace_enabled"] is True
        tail = rep["trace_tail"]
        assert tail, "stall report carried no flight-recorder tail"
        tail_names = {e["name"] for e in tail}
        # the tail shows the beats that came BEFORE the stall — the
        # timeline half of the post-mortem (the updater's step phases
        # join it with ROADMAP Queue A item 10)
        assert {"watchdog/heartbeat"} & tail_names
        assert {e["step"] for e in tail
                if e["name"] == "watchdog/heartbeat"} >= {1, 2, 3}
        # and the on-disk report carries it too
        on_disk = json.load(open(tmp_path / "stall_report.json"))
        assert on_disk["trace_tail"]

    def test_stall_report_tail_empty_when_disabled(self, tmp_path):
        prev = set_recorder(TraceRecorder(enabled=False))
        try:
            reports = []
            wd = TrainingWatchdog(stall_timeout=0.15, check_interval=0.05,
                                  on_stall=reports.append,
                                  report_path=str(tmp_path / "s.json"))
            wd.start()
            try:
                wd.heartbeat(iteration=1)
                deadline = time.monotonic() + 0.8
                while not reports and time.monotonic() < deadline:
                    time.sleep(0.02)
            finally:
                wd.stop()
            assert reports and reports[0]["trace_tail"] == []
            assert reports[0]["trace_enabled"] is False
        finally:
            set_recorder(prev)

    def test_except_hook_dumps_trace(self, recorder, tmp_path,
                                     monkeypatch):
        from chainermn_tpu_torch.extensions import global_except_hook as geh

        with recorder.span("step/host", cat="step", step=1):
            pass
        # a not-yet-existing directory is created, not silently skipped
        monkeypatch.setenv("CHAINERMN_TPU_TRACE_DIR",
                           str(tmp_path / "made" / "later"))
        geh._dump_trace(rank=0)
        doc = json.load(
            open(tmp_path / "made" / "later" / "trace_crash.rank0.json"))
        assert any(e.get("name") == "step/host"
                   for e in doc["traceEvents"])

    def test_add_hook_preserves_trace_dir(self, monkeypatch):
        from chainermn_tpu_torch.extensions import add_global_except_hook
        from chainermn_tpu_torch.extensions import global_except_hook as geh

        monkeypatch.setattr(geh, "_installed", True)  # don't touch sys
        monkeypatch.setattr(geh, "_trace_dir", ".")
        add_global_except_hook(trace_dir="/logs/traces")
        assert geh._trace_dir == "/logs/traces"
        add_global_except_hook()   # a later no-arg call must not clobber
        assert geh._trace_dir == "/logs/traces"


class TestMetricsExport:
    def test_appends_jsonl_series(self, comm, tmp_path):
        trainer = _make_trainer(comm, tmp_path, epochs=2)
        trainer.extend(MetricsExport())
        trainer.run()
        lines = [json.loads(l)
                 for l in open(tmp_path / "metrics.jsonl")]
        assert len(lines) == trainer.updater.iteration
        assert lines[-1]["iteration"] == trainer.updater.iteration
        for entry in lines:
            assert {"iteration", "epoch", "elapsed_time", "ts",
                    "main/loss", "main/step_time"} <= set(entry)
        # append-only across runs: a second trainer continues the file
        trainer2 = _make_trainer(comm, tmp_path, epochs=1)
        trainer2.extend(MetricsExport())
        trainer2.run()
        more = open(tmp_path / "metrics.jsonl").read().splitlines()
        assert len(more) > len(lines)

    def test_keys_filter(self, comm, tmp_path):
        trainer = _make_trainer(comm, tmp_path, epochs=1)
        trainer.extend(MetricsExport(keys=["main/loss"]))
        trainer.run()
        entry = json.loads(
            open(tmp_path / "metrics.jsonl").readline())
        assert "main/loss" in entry
        assert "main/step_time" not in entry


class TestMergeTraceDiscovery:
    """merge_traces accepts a directory or glob and sorts shards by
    recorded rank BEFORE pid assignment, so the same shard set always
    yields the same Perfetto lanes regardless of filesystem listing
    order."""

    def _shards(self, tmp_path, ranks):
        for i, rank in enumerate(ranks):
            rec = TraceRecorder(enabled=True, rank=rank)
            with rec.span(f"work.{rank}", cat="step"):
                pass
            # file names deliberately NOT in rank order
            rec.export_chrome(str(tmp_path / f"shard_{i}.json"))

    def test_directory_input_sorts_by_rank(self, tmp_path):
        self._shards(tmp_path, [2, 0, 1])
        doc = merge_traces(str(tmp_path))
        ranks = [m["rank"] for m in doc["metadata"]["merged_from"]]
        assert ranks == [0, 1, 2]
        assert {e["pid"] for e in doc["traceEvents"]} == {0, 1, 2}

    def test_glob_input_matches_directory(self, tmp_path):
        self._shards(tmp_path, [1, 0])
        via_glob = merge_traces(str(tmp_path / "shard_*.json"))
        via_dir = merge_traces(str(tmp_path))
        assert via_glob["traceEvents"] == via_dir["traceEvents"]

    def test_colliding_pids_shift_deterministically(self, tmp_path):
        """Two rankless same-pid shards: the basename-sorted SECOND
        one is shifted, however the paths are listed."""
        for name in ("zzz.json", "aaa.json"):
            with open(tmp_path / name, "w") as f:
                json.dump([{"name": name, "ph": "X", "ts": 1.0,
                            "dur": 1.0, "pid": 5, "tid": 0}], f)
        doc = merge_traces([str(tmp_path / "zzz.json"),
                            str(tmp_path / "aaa.json")])
        by_name = {e["name"]: e["pid"] for e in doc["traceEvents"]}
        assert by_name == {"aaa.json": 5, "zzz.json": 6}

    def test_explicit_sequence_still_rank_sorted(self, tmp_path):
        self._shards(tmp_path, [1, 0])
        paths = [str(tmp_path / "shard_0.json"),   # rank 1 first
                 str(tmp_path / "shard_1.json")]
        doc = merge_traces(paths)
        ranks = [m["rank"] for m in doc["metadata"]["merged_from"]]
        assert ranks == [0, 1]

    def test_empty_glob_or_missing_dir_raises(self, tmp_path):
        """A typo'd glob or missing directory must not succeed with an
        empty merged document."""
        with pytest.raises(FileNotFoundError, match="no trace shards"):
            merge_traces(str(tmp_path / "rnk*.json"))
        with pytest.raises(FileNotFoundError, match="no trace shards"):
            merge_traces(str(tmp_path / "does-not-exist"))


# ---------------------------------------------------------------------- #
# not ported: each raises, naming its ROADMAP item
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("call,item", [
    (lambda: TraceRecorder(enabled=True).open_phase_channel("goodput"), 10),
    (lambda: TraceRecorder(enabled=True).drain_phase_stats(), 10),
    (lambda: StragglerReport(None), 10),
    (lambda: RequestTraceStore(), 12),
])
def test_unported_parts_raise(call, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue A item {item}"):
        call()


# ---------------------------------------------------------------------- #
# parity with the JAX recorder
# ---------------------------------------------------------------------- #

@pytest.fixture()
def fixed_clock(monkeypatch):
    """``time.perf_counter`` and ``time.time`` stepping by fixed amounts
    from fixed origins, the same clock in both packages."""
    ticks = {"perf": 100.0, "wall": 1.7e9}

    def perf():
        ticks["perf"] += 0.125
        return ticks["perf"]

    def wall():
        ticks["wall"] += 0.5
        return ticks["wall"]

    monkeypatch.setattr(time, "perf_counter", perf)
    monkeypatch.setattr(time, "time", wall)
    return ticks


def _script(rec):
    with rec.span("step/host", cat="step", step=7, k=4) as sp:
        sp.set(nbytes=12)
    rec.record("checkpoint/save", 0.25, cat="checkpoint", step=7,
               path="snap")
    rec.instant("watchdog/heartbeat", cat="watchdog", step=8, beats=3)
    rec.counter("prefetch/occupancy", 2, step=8)
    with rec.span("elastic/live_resize", cat="elastic", world=2):
        pass


def test_same_spans_same_chrome_events(fixed_clock, tmp_path):
    """Exact: the same clock and the same calls give the same events,
    metadata and document."""
    docs = []
    for mod in (JT, __import__("chainermn_tpu_torch.utils.telemetry",
                               fromlist=["x"])):
        fixed_clock.update(perf=100.0, wall=1.7e9)
        rec = mod.TraceRecorder(capacity=16, enabled=True, rank=2)
        _script(rec)
        path = str(tmp_path / f"{mod.__name__}.json")
        rec.export_chrome(path)
        docs.append((rec.chrome_events(), rec.events(), rec.tail(2),
                     json.load(open(path))))
    assert docs[0] == docs[1]


def test_merge_traces_equals_the_jax_merge(tmp_path):
    paths = []
    for rank in (1, 0):
        rec = TraceRecorder(enabled=True, rank=rank)
        with rec.span(f"work.{rank}", cat="step", step=rank):
            pass
        rec.instant("beat", step=rank)
        paths.append(str(tmp_path / f"shard_{rank}.json"))
        rec.export_chrome(paths[-1])
    # a third shard colliding with rank 0's pid
    with open(tmp_path / "shard_x.json", "w") as f:
        json.dump([{"name": "x", "ph": "X", "ts": 1.0, "dur": 1.0,
                    "pid": 0, "tid": 0}], f)
    for arg in (paths, str(tmp_path), str(tmp_path / "shard_*.json")):
        got = merge_traces(arg, out=str(tmp_path.parent / "port.json"))
        want = JT.merge_traces(arg, out=str(tmp_path.parent / "jax.json"))
        assert got == want
        assert json.load(open(tmp_path.parent / "port.json")) == \
            json.load(open(tmp_path.parent / "jax.json"))
