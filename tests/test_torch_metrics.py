"""The port's metrics registry (``chainermn_tpu_torch/utils/metrics.py``)
against the JAX package's.

The cases of the JAX package's ``tests/util_tests/test_metrics.py`` run
against the port (all but ``GoodputReport``'s, which is not ported and
raises), then parity: the same observations through both registries give
equal ``snapshot()`` s and byte-identical Prometheus text, and
``merge_metrics`` over a 2-rank gloo world folds the same rows into the
JAX fold's snapshot and text.  Exact equality throughout: both packages
run the same float64 arithmetic in the same order.
"""

import json
import math

import numpy as np
import pytest

from chainermn_tpu.utils import metrics as JM
from chainermn_tpu_torch.utils import metrics as M
from chainermn_tpu_torch.utils.metrics import (
    Histogram,
    LATTICE_EDGES,
    MetricsRegistry,
    MetricsTextfile,
    bucket_index,
    export_jsonl,
    export_prometheus,
    histogram_from_prometheus,
    merge_metrics,
    parse_prometheus_text,
    set_registry,
    to_prometheus,
)


@pytest.fixture()
def registry():
    """Fresh enabled registry installed as the global one; the previous
    global is restored afterwards."""
    reg = MetricsRegistry(enabled=True)
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


class FakeComm:
    """N-rank allgather fake: rank 0's row is the caller's object, the
    rest are supplied — the merge-math harness (a single-process world
    only ever allgathers one row)."""

    inter_rank = 0
    inter_size = 3

    def __init__(self, *other_rows):
        self.rows = list(other_rows)

    def allgather_obj(self, obj):
        return [obj] + self.rows


# ---------------------------------------------------------------------- #
# lattice
# ---------------------------------------------------------------------- #

class TestLattice:
    def test_edges_are_log_spaced_and_monotonic(self):
        ratios = [LATTICE_EDGES[i + 1] / LATTICE_EDGES[i]
                  for i in range(len(LATTICE_EDGES) - 1)]
        assert all(r == pytest.approx(10 ** (1 / 8)) for r in ratios)
        assert list(LATTICE_EDGES) == sorted(LATTICE_EDGES)

    def test_boundary_exactness(self):
        """A value EXACTLY on an edge belongs to that edge's bucket
        (Prometheus ``le`` semantics), with no float-log wobble at any
        edge; the next representable value up crosses into the next
        bucket."""
        for i, edge in enumerate(LATTICE_EDGES):
            assert bucket_index(edge) == i
            assert bucket_index(math.nextafter(edge, math.inf)) == i + 1
        assert bucket_index(0.0) == 0
        assert bucket_index(float(LATTICE_EDGES[-1]) * 2) \
            == len(LATTICE_EDGES)

    def test_observe_lands_on_edge_bucket(self):
        h = Histogram()
        edge = LATTICE_EDGES[17]
        h.observe(edge)
        assert h.bucket_counts() == {17: 1}

    def test_count_above_is_strict_and_exact(self):
        """The burn-rate bad-count read: strictly-above buckets only,
        identical to the sparse bucket_counts sum."""
        h = Histogram()
        edge = LATTICE_EDGES[17]
        h.observe(edge)                 # IN bucket 17: not above it
        h.observe(edge * 1.01)          # bucket 18
        h.observe(float(LATTICE_EDGES[-1]) * 2)     # overflow bucket
        h.observe(1e-9)                 # bucket 0
        assert h.count_above(17) == 2
        assert h.count_above(17) == sum(
            c for i, c in h.bucket_counts().items() if i > 17)
        assert h.count_above(len(LATTICE_EDGES)) == 0


# ---------------------------------------------------------------------- #
# histogram percentiles
# ---------------------------------------------------------------------- #

class TestHistogram:
    def test_small_n_percentiles_exact_numpy_identical(self):
        rng = np.random.RandomState(0)
        vals = list(rng.lognormal(-4, 2, size=100))
        h = Histogram()
        for v in vals:
            h.observe(v)
        assert h.exact
        for q in (0, 10, 50, 90, 95, 99, 100):
            assert h.percentile(q) == pytest.approx(
                float(np.percentile(vals, q)), rel=1e-12)
        assert h.mean == pytest.approx(float(np.mean(vals)))

    def test_over_cap_interpolated_within_bucket_width(self):
        """Past the cap, samples drop and quantiles interpolate within
        a lattice bucket — error bounded by one bucket's width
        (10^(1/8) ≈ 1.33×)."""
        rng = np.random.RandomState(1)
        vals = list(rng.uniform(0.01, 0.1, size=2000))
        h = Histogram(sample_cap=64)
        for v in vals:
            h.observe(v)
        assert not h.exact and h.count == 2000
        for q in (50, 99):
            true = float(np.percentile(vals, q))
            est = h.percentile(q)
            assert true / 10 ** (1 / 8) <= est <= true * 10 ** (1 / 8)
        # extrema clamp the interpolation
        assert h.percentile(0) >= h.min
        assert h.percentile(100) <= h.max

    def test_empty_histogram(self):
        h = Histogram()
        assert h.percentile(50) is None and h.mean is None

    def test_merge_is_bucket_sum_and_keeps_exactness_under_cap(self):
        a, b = Histogram(), Histogram()
        vals_a, vals_b = [0.001, 0.02, 0.3], [0.004, 5.0]
        for v in vals_a:
            a.observe(v)
        for v in vals_b:
            b.observe(v)
        a.merge(b.to_snapshot())
        whole = Histogram()
        for v in vals_a + vals_b:
            whole.observe(v)
        assert a.bucket_counts() == whole.bucket_counts()
        assert a.count == 5 and a.exact
        assert a.percentile(50) == pytest.approx(whole.percentile(50))
        assert a.min == min(vals_a + vals_b)
        assert a.max == max(vals_a + vals_b)

    def test_merge_past_cap_drops_samples_keeps_buckets(self):
        a = Histogram(sample_cap=4)
        b = Histogram(sample_cap=4)
        for v in (0.001, 0.002, 0.003):
            a.observe(v)
        for v in (0.004, 0.005):
            b.observe(v)
        a.merge(b.to_snapshot())
        assert not a.exact and a.count == 5
        assert sum(a.bucket_counts().values()) == 5
        assert a.percentile(50) is not None

    def test_snapshot_round_trip_post_json(self):
        h = Histogram()
        for v in (0.001, 0.5, 30.0):
            h.observe(v)
        snap = json.loads(json.dumps(h.to_snapshot()))  # str keys
        back = Histogram.from_snapshot(snap)
        assert back.bucket_counts() == h.bucket_counts()
        assert back.percentile(99) == pytest.approx(h.percentile(99))


# ---------------------------------------------------------------------- #
# registry: disabled path + discipline
# ---------------------------------------------------------------------- #

class TestRegistry:
    def test_disabled_returns_shared_noop_singleton(self):
        """Allocation-free when disabled: every instrument getter hands
        back the SAME no-op object, the recorders early-return, and
        nothing reaches the table (the TraceRecorder _NULL_SPAN
        discipline)."""
        reg = MetricsRegistry(enabled=False)
        a = reg.counter("serve/admits")
        b = reg.histogram("serve/ttft")
        c = reg.gauge("serve/queue_depth")
        assert a is b is c is M._NULL_INSTRUMENT
        a.inc()
        b.observe(0.5)
        c.set(3)
        reg.inc("x")
        reg.observe("y", 1.0)
        reg.set("z", 2.0)
        assert len(reg) == 0 and reg.snapshot() == {}

    def test_enable_disable_toggle(self):
        reg = MetricsRegistry()
        reg.inc("a")
        reg.enable()
        reg.inc("a")
        reg.disable()
        reg.inc("a")
        assert reg.snapshot()["a"]["value"] == 1.0

    def test_name_keeps_first_type(self):
        reg = MetricsRegistry(enabled=True)
        reg.inc("x")
        with pytest.raises(TypeError):
            reg.histogram("x")

    def test_env_switch(self, monkeypatch):
        monkeypatch.delenv("CHAINERMN_TPU_METRICS", raising=False)
        assert not M._from_env().enabled
        monkeypatch.setenv("CHAINERMN_TPU_METRICS", "0")
        assert not M._from_env().enabled
        monkeypatch.setenv("CHAINERMN_TPU_METRICS", "1")
        assert M._from_env().enabled

    def test_snapshot_prefix_filter(self):
        reg = MetricsRegistry(enabled=True)
        reg.inc("serve/admits")
        reg.inc("train/iterations")
        assert set(reg.snapshot(prefix="serve/")) == {"serve/admits"}


# ---------------------------------------------------------------------- #
# cross-rank merge
# ---------------------------------------------------------------------- #

class TestMerge:
    def _rank_row(self, n_admits, depth, ttfts, extra=None):
        reg = MetricsRegistry(enabled=True)
        reg.inc("serve/admits", n_admits)
        reg.set("serve/queue_depth", depth)
        for v in ttfts:
            reg.observe("serve/ttft", v)
        if extra:
            reg.inc(extra)
        return reg.snapshot()

    def test_counter_gauge_histogram_merge_math(self, registry):
        registry.inc("serve/admits", 3)
        registry.set("serve/queue_depth", 2)
        for v in (0.01, 0.02):
            registry.observe("serve/ttft", v)
        comm = FakeComm(
            self._rank_row(5, 9, [0.04], extra="rank1/only"),
            self._rank_row(1, 4, [0.08, 0.5]),
        )
        merged = merge_metrics(comm, registry)
        s = merged.snapshot()
        # counters sum
        assert s["serve/admits"]["value"] == 9.0
        # gauges keep the fleet max
        assert s["serve/queue_depth"]["last"] == 9.0
        assert s["serve/queue_depth"]["max"] == 9.0
        # histograms bucket-sum on the shared lattice, exactly
        h = Histogram.from_snapshot(s["serve/ttft"])
        whole = Histogram()
        for v in (0.01, 0.02, 0.04, 0.08, 0.5):
            whole.observe(v)
        assert h.bucket_counts() == whole.bucket_counts()
        assert h.count == 5 and h.max == 0.5
        assert h.percentile(99) == pytest.approx(whole.percentile(99))
        # divergent name sets union (the ObservationAggregator
        # convention): a rank-1-only metric survives
        assert s["rank1/only"]["value"] == 1.0

    def test_merge_deterministic_identical_everywhere(self, registry):
        """The fold over rank-ordered rows is deterministic — every
        rank folding the same allgathered rows produces ONE identical
        snapshot (what rank-0-only exposition gates on)."""
        rows = [self._rank_row(i + 1, i, [0.01 * (i + 1)])
                for i in range(3)]

        class RowsComm:
            def allgather_obj(self, obj):
                return [json.loads(json.dumps(r)) for r in rows]

        snaps = [merge_metrics(RowsComm(), registry).snapshot()
                 for _ in range(3)]
        assert json.dumps(snaps[0], sort_keys=True, default=float) \
            == json.dumps(snaps[1], sort_keys=True, default=float) \
            == json.dumps(snaps[2], sort_keys=True, default=float)

    def test_merge_over_real_communicator(self, registry):
        """The collective path at one rank (the port's loopback; the
        2-rank gloo world is ``test_merge_over_gloo_equals_jax_fold``)."""
        from chainermn_tpu_torch.communicators import LoopbackCommunicator

        comm = LoopbackCommunicator(device="cpu")
        registry.inc("train/iterations", 7)
        registry.observe("train/step_time", 0.012)
        merged = merge_metrics(comm, registry)
        s = merged.snapshot()
        assert s["train/iterations"]["value"] == 7.0
        assert s["train/step_time"]["count"] == 1


# ---------------------------------------------------------------------- #
# exposition: Prometheus + JSONL
# ---------------------------------------------------------------------- #

class TestPrometheus:
    def test_round_trip_all_instrument_types(self):
        reg = MetricsRegistry(enabled=True)
        reg.inc("serve/admits", 42)
        reg.set("serve/queue_depth", 5)
        vals = [1e-8, 0.001, 0.0012, 0.5, 3.0, 1e6]
        for v in vals:
            reg.observe("serve/ttft", v)
        text = to_prometheus(reg, labels={"rank": "3"})
        assert '# TYPE serve_admits counter' in text
        assert 'rank="3"' in text
        parsed = parse_prometheus_text(text)
        assert parsed["serve_admits"] == {"type": "counter",
                                          "value": 42.0}
        assert parsed["serve_queue_depth"]["last"] == 5.0
        h = histogram_from_prometheus(parsed["serve_ttft"])
        orig = reg.histogram("serve/ttft")
        # cumulative-bucket diffs reconstruct the exact lattice counts
        # (underflow and overflow included)
        assert h.bucket_counts() == orig.bucket_counts()
        assert h.count == len(vals)
        assert h.sum == pytest.approx(orig.sum)

    def test_overflow_percentile_survives_wire_round_trip(self):
        """min/max don't survive the exposition wire; a quantile
        landing in the overflow bucket must degrade to the last lattice
        edge (a lower bound), not crash."""
        reg = MetricsRegistry(enabled=True)
        reg.observe("h", 0.5)
        reg.observe("h", 5e5)           # past the last edge
        h = histogram_from_prometheus(
            parse_prometheus_text(to_prometheus(reg))["h"])
        assert h.percentile(99.99) == pytest.approx(LATTICE_EDGES[-1])
        # with the live histogram the observed max bounds it instead
        live = reg.histogram("h")
        assert live.percentile(99.99) <= 5e5

    def test_histogram_has_mandatory_inf_bucket(self):
        reg = MetricsRegistry(enabled=True)
        reg.observe("h", 0.5)
        text = to_prometheus(reg)
        assert 'h_bucket{le="+Inf"} 1' in text
        parsed = parse_prometheus_text(text)
        assert parsed["h"]["buckets"][-1] == (math.inf, 1)

    def test_name_sanitization(self):
        reg = MetricsRegistry(enabled=True)
        reg.inc("serve/queue-wait.p99")
        parsed = parse_prometheus_text(to_prometheus(reg))
        assert "serve_queue_wait_p99" in parsed

    def test_export_atomic_file(self, tmp_path):
        reg = MetricsRegistry(enabled=True)
        reg.inc("c", 2)
        path = str(tmp_path / "metrics.prom")
        export_prometheus(path, reg, labels={"rank": "0"})
        parsed = parse_prometheus_text(open(path).read())
        assert parsed["c"]["value"] == 2.0
        assert not (tmp_path / "metrics.prom.tmp").exists()


class TestJsonl:
    def test_snapshot_schema(self, tmp_path):
        reg = MetricsRegistry(enabled=True)
        reg.inc("serve/admits", 2)
        reg.observe("serve/ttft", 0.01)
        path = str(tmp_path / "metrics.jsonl")
        export_jsonl(path, reg, rank=0)
        export_jsonl(path, reg, rank=0)
        lines = [json.loads(l) for l in open(path)]
        assert len(lines) == 2
        for entry in lines:
            assert {"ts", "rank", "metrics"} <= set(entry)
            m = entry["metrics"]
            assert m["serve/admits"] == {"type": "counter", "value": 2.0}
            h = m["serve/ttft"]
            assert h["type"] == "histogram"
            assert {"count", "sum", "min", "max", "counts",
                    "samples"} <= set(h)
            assert h["count"] == 1


# ---------------------------------------------------------------------- #
# MetricsTextfile + trainer integration
# ---------------------------------------------------------------------- #

class TestMetricsTextfile:
    def test_writes_rank_labeled_promfile(self, tmp_path, registry):
        registry.inc("serve/admits", 4)
        mt = MetricsTextfile(registry=registry,
                             path=str(tmp_path / "metrics.prom"))
        mt()
        text = open(tmp_path / "metrics.prom").read()
        parsed = parse_prometheus_text(text)
        assert parsed["serve_admits"]["value"] == 4.0
        assert 'rank="0"' in text


class TestExemplars:
    """Bounded per-bucket exemplars link a histogram percentile to the
    causal trace of a concrete observation."""

    def test_one_exemplar_per_bucket_newest_wins(self):
        h = Histogram()
        h.observe(0.0101, exemplar="first")
        h.observe(0.0102, exemplar="second")     # same lattice bucket
        h.observe(0.5, exemplar="tail")
        assert bucket_index(0.0101) == bucket_index(0.0102)
        ex = h.exemplars()
        assert len(ex) == 2                      # bounded by buckets
        same_bucket = ex[bucket_index(0.0101)]
        assert same_bucket[0] == "second"
        assert same_bucket[1] == pytest.approx(0.0102)

    def test_exemplar_free_observe_allocates_no_table(self):
        h = Histogram()
        h.observe(0.010)
        assert h._exemplars is None
        assert h.exemplars() == {}
        assert h.exemplar_for(99) is None

    def test_exemplar_for_resolves_percentile_to_tail(self):
        h = Histogram()
        for _ in range(99):
            h.observe(0.001, exemplar="fast")
        h.observe(1.0, exemplar="slow")
        assert h.exemplar_for(99)[0] == "slow"
        assert h.exemplar_for(50)[0] == "fast"

    def test_exemplar_for_prefers_bucket_above(self):
        # no exemplar in the p99 bucket itself: the nearest ABOVE wins
        # (the offending request lives in the tail)
        h = Histogram()
        for _ in range(100):
            h.observe(0.001)
        h.observe(2.0, exemplar="outlier")
        assert h.exemplar_for(50)[0] == "outlier"

    def test_snapshot_merge_keeps_newest_ts(self):
        a, b = Histogram(), Histogram()
        a.observe(0.0101, exemplar="old")
        b.observe(0.0102, exemplar="new")       # same lattice bucket
        a._exemplars[bucket_index(0.0101)][2] = 1.0     # force ordering
        b._exemplars[bucket_index(0.0102)][2] = 2.0
        merged = Histogram()
        merged.merge(a.to_snapshot())
        merged.merge(b.to_snapshot())
        assert merged.exemplars()[bucket_index(0.0101)][0] == "new"
        # reversed fold order: same winner (deterministic)
        m2 = Histogram()
        m2.merge(b.to_snapshot())
        m2.merge(a.to_snapshot())
        assert m2.exemplars()[bucket_index(0.0101)][0] == "new"

    def test_registry_observe_exemplar_and_disabled_noop(self, registry):
        registry.observe("serve/ttft", 0.25, exemplar="tr-1")
        assert registry.histogram("serve/ttft").exemplar_for(99)[0] \
            == "tr-1"
        off = MetricsRegistry(enabled=False)
        off.observe("serve/ttft", 0.25, exemplar="tr-1")    # no-op
        assert len(off) == 0
        null = off.histogram("serve/ttft")
        assert null.exemplar_for(99) is None
        assert null.exemplars() == {}
        assert null.count_above(0) == 0

    def test_prometheus_round_trip_with_exemplars(self):
        h = Histogram()
        h.observe(0.01, exemplar="fast-trace")
        h.observe(0.8, exemplar="slow-trace")
        h.observe(0.011)
        text = to_prometheus({"serve/ttft": h.to_snapshot()},
                             openmetrics=True)
        assert ' # {trace_id="slow-trace"} ' in text
        # the DEFAULT is exemplar-free: classic 0.0.4 consumers
        # (textfile, watchdog stall reports) must never see the suffix
        assert "trace_id=" not in to_prometheus(
            {"serve/ttft": h.to_snapshot()})
        parsed = parse_prometheus_text(text)
        h2 = histogram_from_prometheus(parsed["serve_ttft"])
        assert h2.count == h.count
        assert h2.exemplar_for(99)[0] == "slow-trace"
        assert h2.exemplar_for(99)[1] == pytest.approx(0.8)
        # bucket counts identical to the exemplar-free round trip
        assert h2.bucket_counts() == h.bucket_counts()

    def test_digest_is_counters_and_gauges_only(self):
        """The cheap live read: counter values + gauge lasts,
        histograms omitted (their samples/exemplars never
        serialized)."""
        reg = MetricsRegistry(enabled=True)
        reg.inc("serve/admits", 3)
        reg.set("serve/queue_depth", 7)
        reg.observe("serve/ttft", 0.2)
        assert reg.digest() == {"serve/admits": 3.0,
                                "serve/queue_depth": 7.0}
        assert MetricsRegistry(enabled=False).digest() == {}

    def test_textfile_export_is_exemplar_free_by_default(self,
                                                         tmp_path):
        """The node-exporter textfile collector speaks classic 0.0.4,
        whose parsers reject the OpenMetrics exemplar suffix — turning
        tracing on must never break an existing scrape."""
        reg = MetricsRegistry(enabled=True)
        reg.observe("serve/ttft", 0.8, exemplar="tr-1")
        path = str(tmp_path / "m.prom")
        export_prometheus(path, reg)
        text = open(path).read()
        assert "trace_id=" not in text and " # {" not in text
        export_prometheus(path, reg, openmetrics=True)  # the opt-in
        assert 'trace_id="tr-1"' in open(path).read()

    def test_exemplar_id_sanitized_in_exposition(self):
        """Caller-propagated trace ids are arbitrary strings; a quote
        or brace must not corrupt the exposition or break the
        round-trip."""
        h = Histogram()
        h.observe(0.8, exemplar='ab"cd}ef gh')
        text = to_prometheus({"serve/ttft": h.to_snapshot()},
                             openmetrics=True)
        assert '"' not in text.split(' # {trace_id="', 1)[1] \
            .split('"', 1)[1].split("}")[0]
        parsed = parse_prometheus_text(text)
        h2 = histogram_from_prometheus(parsed["serve_ttft"])
        assert h2.count == 1
        assert h2.bucket_counts() == h.bucket_counts()
        assert h2.exemplar_for(99)[0] == "ab_cd_ef_gh"

    def test_pre_exemplar_text_still_parses(self):
        """Back-compat both directions: exemplar-free emission has no
        suffix, and text from a pre-exemplar emitter parses cleanly."""
        h = Histogram()
        h.observe(0.01)
        h.observe(0.8)
        text = to_prometheus({"serve/ttft": h.to_snapshot()})
        assert " # {" not in text           # no suffix when none held
        # simulate pre-exemplar text by stripping any suffix form
        legacy = "\n".join(l.split(" # ")[0]
                           for l in text.splitlines()) + "\n"
        h2 = histogram_from_prometheus(
            parse_prometheus_text(legacy)["serve_ttft"])
        assert h2.count == 2
        assert h2.bucket_counts() == h.bucket_counts()
        assert h2.exemplar_for(99) is None


class TestAppendJsonl:
    """The atomic JSONL append every report flushes through: one
    O_APPEND write per line, so no crash — SIGKILL included — can
    leave a torn last line."""

    def test_appends_parseable_lines(self, tmp_path):
        path = str(tmp_path / "x.jsonl")
        M.append_jsonl(path, {"a": 1})
        M.append_jsonl(path, {"b": [1, 2]})
        lines = [json.loads(l) for l in open(path)]
        assert lines == [{"a": 1}, {"b": [1, 2]}]

    def test_sigkill_mid_stream_never_tears_a_line(self, tmp_path):
        """The kill drill the satellite demands: a child appends fat
        JSON lines in a tight loop, SIGKILL lands mid-stream, and
        every line on disk still parses — the last one included."""
        import os
        import signal
        import subprocess
        import sys
        import time as _time

        path = str(tmp_path / "killed.jsonl")
        metrics_py = os.path.abspath(M.__file__)
        child_src = (
            "import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location("
            f"'m', {metrics_py!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "pad = 'x' * 700\n"
            "i = 0\n"
            "while True:\n"
            f"    m.append_jsonl({path!r}, "
            "{'i': i, 'pad': pad})\n"
            "    i += 1\n")
        proc = subprocess.Popen([sys.executable, "-c", child_src])
        try:
            deadline = _time.monotonic() + 30
            while _time.monotonic() < deadline:
                if os.path.exists(path) \
                        and os.path.getsize(path) > 50_000:
                    break
                _time.sleep(0.01)
            assert os.path.exists(path), "child never wrote"
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.wait(timeout=30)
        raw = open(path, "rb").read()
        assert len(raw) > 50_000
        assert raw.endswith(b"\n"), "torn final line"
        lines = raw.decode().splitlines()
        parsed = [json.loads(l) for l in lines]     # every line whole
        assert [p["i"] for p in parsed] == list(range(len(parsed)))


# ---------------------------------------------------------------------- #
# the port's own: GoodputReport raises, MetricsTextfile in a trainer
# ---------------------------------------------------------------------- #

def test_goodput_report_is_not_ported():
    from chainermn_tpu_torch.utils.metrics import GoodputReport

    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        GoodputReport()


def test_textfile_flushes_a_port_trainers_counters(tmp_path, registry):
    """``MetricsTextfile`` as a trainer extension: each epoch it writes
    the registry, rank-labelled, atomically, where the checkpointer's
    counters land."""
    import torch

    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.communicators import LoopbackCommunicator
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.iterators import SerialIterator

    comm = LoopbackCommunicator(device="cpu")
    rng = np.random.RandomState(0)
    data = [(rng.randn(3).astype(np.float32), np.float32(i))
            for i in range(8)]
    up = training.StandardUpdater(
        SerialIterator(data, 4, shuffle=False),
        training.create_multi_node_optimizer(training.sgd(0.1), comm),
        lambda p, x, y: ((x @ p["w"] - y) ** 2).mean(),
        {"w": torch.zeros(3)}, comm)
    trainer = training.Trainer(up, (2, "epoch"), out=str(tmp_path))
    cp = create_multi_node_checkpointer(comm, str(tmp_path / "ck"))
    trainer.extend(cp, trigger=(1, "epoch"))
    # after the checkpointer (priority 30) on the same tick
    trainer.extend(MetricsTextfile(), priority=10)
    trainer.run()
    parsed = parse_prometheus_text((tmp_path / "metrics.prom").read_text())
    assert parsed["checkpoint_snapshots_written"]["value"] == 2.0
    assert 'rank="0"' in (tmp_path / "metrics.prom").read_text()
    assert not (tmp_path / "metrics.prom.tmp").exists()


# ---------------------------------------------------------------------- #
# parity with the JAX registry
# ---------------------------------------------------------------------- #

def _observe_script(reg, seed):
    """One seeded sequence of observations of every kind, exemplars and
    an overflow among them, with fixed exemplar timestamps."""
    rng = np.random.RandomState(seed)
    for v in rng.lognormal(-4, 2, size=700):      # past the sample cap
        reg.observe("serve/ttft", float(v))
    for i, v in enumerate(rng.uniform(1e-3, 2.0, size=9)):
        reg.observe("train/step_time", float(v),
                    exemplar=f"trace-{i}" if i % 3 == 0 else None)
    reg.observe("train/step_time", 5e5)           # overflow bucket
    reg.inc("checkpoint/snapshots_written", 3)
    reg.inc("comm/kv_retries", 2.5)
    reg.set("serve/queue_depth", 7)
    reg.set("serve/queue_depth", 4)
    h = reg.histogram("train/step_time")
    for e in h._exemplars.values():
        e[2] = 1.5e9


@pytest.mark.parametrize("seed", [0, 1])
def test_same_observations_same_snapshot_and_text(seed):
    """Exact: the same float64 folds in the same order."""
    port, jax_reg = MetricsRegistry(enabled=True), \
        JM.MetricsRegistry(enabled=True)
    _observe_script(port, seed)
    _observe_script(jax_reg, seed)
    assert port.snapshot() == jax_reg.snapshot()
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(jax_reg.snapshot(), sort_keys=True)
    for kw in ({}, {"labels": {"rank": "3"}}, {"openmetrics": True}):
        assert to_prometheus(port, **kw) == JM.to_prometheus(jax_reg, **kw)
    text = to_prometheus(port, openmetrics=True)
    assert parse_prometheus_text(text) == JM.parse_prometheus_text(text)
    got = histogram_from_prometheus(parse_prometheus_text(text)[
        "train_step_time"])
    want = JM.histogram_from_prometheus(JM.parse_prometheus_text(text)[
        "train_step_time"])
    assert got.to_snapshot() == want.to_snapshot()
    assert LATTICE_EDGES == JM.LATTICE_EDGES


def test_merge_over_gloo_equals_jax_fold(tmp_path):
    """``merge_metrics`` on a 2-rank gloo world: every rank folds the
    same rank-ordered rows into the snapshot and the text the JAX
    fold of the same rows gives."""
    from test_torch_world import run_world

    rows = []
    for seed in (3, 4):
        reg = JM.MetricsRegistry(enabled=True)
        _observe_script(reg, seed)
        reg.inc(f"rank{seed}/only")
        rows.append(reg.snapshot())

    class RowsComm:
        def allgather_obj(self, obj):
            return [json.loads(json.dumps(r)) for r in rows]

    want = JM.merge_metrics(RowsComm(), JM.MetricsRegistry(enabled=True))
    got = run_world(tmp_path, 2, "battery_merge_metrics", rows)
    for snap, text in got:
        assert snap == want.snapshot()
        assert text == JM.to_prometheus(want, labels={"rank": "merged"})
