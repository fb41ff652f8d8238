"""Metrics registry — the JAX package's ``utils/metrics.py``: counters,
gauges and latency histograms with a cross-rank merge and Prometheus
and JSONL exposition.

The flight recorder (:mod:`chainermn_tpu_torch.utils.telemetry`)
answers "what happened, when"; this module is the distribution layer:

- :class:`Counter` — a monotonic total (snapshots written, stalls).
  The cross-rank merge is a sum.
- :class:`Gauge` — the last value set and the max it ever held.  The
  merge keeps the max of both.
- :class:`Histogram` — a distribution over a FIXED log-spaced bucket
  lattice shared by every histogram in every process
  (:data:`LATTICE_EDGES`), so the cross-rank merge is a bucket-wise
  sum.  Below :attr:`~Histogram.sample_cap` observations the raw
  samples are kept too, so small-n percentiles are exact (numpy's
  ``linear`` interpolation); past the cap they come from the bucket
  the rank lands in, within one bucket's width (``10^(1/8)``).
  ``observe(value, exemplar=...)`` keeps one exemplar a bucket.
- :class:`MetricsRegistry` — the process-global name → instrument
  table.  Disabled (the default), every record call returns at once and
  the getters hand back ONE shared no-op instrument; the instrumented
  paths pay one attribute read.  ``CHAINERMN_TPU_METRICS=1`` (the JAX
  package's variable) enables it at import.
- :func:`merge_metrics` — every rank's snapshot over the
  communicator's ``allgather_obj``, folded in rank order: counters sum,
  gauges max, histograms bucket-sum, name sets union.  Every rank
  computes the same merged registry.
- Exposition: :func:`to_prometheus` (the node-exporter textfile
  convention; :func:`export_prometheus` writes it atomically),
  :func:`parse_prometheus_text` and :func:`histogram_from_prometheus`
  (the round trip), :func:`append_jsonl` (one line a write, never
  torn) and :func:`export_jsonl`.

The trainer extension :class:`MetricsTextfile` writes the registry,
merged over the ranks when given a communicator of several, to
``<out>/metrics.prom`` on its trigger.  A port process is one rank, so
the merge runs whenever ``comm.size > 1`` and rank 0 writes, where the
JAX package counts processes (``inter_size``/``inter_rank``).

Not ported, raising: :class:`GoodputReport`, which drains the step
phases' spans that the port's updater does not emit yet (ROADMAP Queue
A item 10).

This module imports neither torch nor the communicators: the
communicator of :func:`merge_metrics` is the caller's.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional

__all__ = [
    "Counter",
    "Gauge",
    "GoodputReport",
    "Histogram",
    "LATTICE_EDGES",
    "MetricsRegistry",
    "MetricsTextfile",
    "append_jsonl",
    "export_jsonl",
    "export_prometheus",
    "get_registry",
    "histogram_from_prometheus",
    "merge_metrics",
    "parse_prometheus_text",
    "set_registry",
    "to_prometheus",
]

# ---------------------------------------------------------------------- #
# the shared bucket lattice
# ---------------------------------------------------------------------- #

# Fixed log-spaced upper edges from 100 ns to 100 ks, 8 buckets per
# decade.  FIXED is the point: every histogram in every process buckets
# against the same edges, so a cross-rank (or cross-run) merge is a
# plain bucket-wise sum.  The range covers everything this stack
# times — a µs-scale counter bump to a day-scale training window —
# and 8/decade bounds interpolated-quantile error at 10^(1/8) ≈ 1.33×.
_LAT_LO_EXP = -7
_LAT_HI_EXP = 5
_LAT_PER_DECADE = 8

LATTICE_EDGES: tuple = tuple(
    10.0 ** (_LAT_LO_EXP + i / _LAT_PER_DECADE)
    for i in range((_LAT_HI_EXP - _LAT_LO_EXP) * _LAT_PER_DECADE + 1)
)
_N_BUCKETS = len(LATTICE_EDGES) + 1        # + overflow (> last edge)


def bucket_index(value: float) -> int:
    """The lattice bucket holding ``value``: the first bucket whose
    upper edge is ``>= value`` (Prometheus ``le`` semantics — a value
    exactly on an edge belongs to that edge's bucket), with the final
    index catching overflow.  ``bisect`` on the precomputed edges, so
    boundary membership is exact — no float-log wobble."""
    return bisect_left(LATTICE_EDGES, value)


# ---------------------------------------------------------------------- #
# instruments
# ---------------------------------------------------------------------- #

class Counter:
    """Monotonic total.  Merge = sum."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}

    @classmethod
    def from_snapshot(cls, d: dict) -> "Counter":
        return cls(float(d.get("value", 0.0)))

    def merge(self, d: dict) -> None:
        self.value += float(d.get("value", 0.0))


class Gauge:
    """Last-set value + the max it ever held.  Merge keeps the max of
    both (a merged queue-depth gauge answers "how deep did any rank's
    queue get", which is the fleet question)."""

    __slots__ = ("last", "max")

    def __init__(self, last: Optional[float] = None,
                 max: Optional[float] = None):
        self.last = last
        self.max = max

    def set(self, value: float) -> None:
        value = float(value)
        self.last = value
        self.max = value if self.max is None else builtins_max(
            self.max, value)

    def to_snapshot(self) -> dict:
        return {"type": "gauge", "last": self.last, "max": self.max}

    @classmethod
    def from_snapshot(cls, d: dict) -> "Gauge":
        return cls(d.get("last"), d.get("max"))

    def merge(self, d: dict) -> None:
        for attr in ("last", "max"):
            v = d.get(attr)
            if v is None:
                continue
            cur = getattr(self, attr)
            setattr(self, attr,
                    v if cur is None else builtins_max(cur, v))


builtins_max = max      # `Gauge.max` shadows the builtin in its scope


class Histogram:
    """Latency distribution on the shared lattice.

    Exact below the cap: until ``sample_cap`` observations the raw
    samples are retained, and :meth:`percentile` computes the
    numpy-``linear``-identical exact quantile.  Past the cap the
    samples are dropped (memory stays bounded however long the job
    runs) and quantiles interpolate within the lattice bucket the
    target rank lands in, clamped to the observed ``[min, max]``.

    Merge (:meth:`merge`) is bucket-wise sum + count/sum/min/max
    folds; exactness survives a merge whenever the combined sample
    count still fits the cap.

    **Exemplars.**  ``observe(value, exemplar="<trace_id>")`` retains
    ONE exemplar per lattice bucket (newest wins — bounded by the
    bucket count, never by traffic), so a percentile resolves to a
    concrete causal trace: :meth:`exemplar_for` maps the bucket a
    quantile lands in back to the retained ``(trace_id, value, ts)``.
    Exemplars ride snapshots, merges and the Prometheus exposition
    (OpenMetrics ``# {trace_id="..."} value ts`` suffix on ``_bucket``
    rows); observations without an exemplar cost nothing extra.
    """

    SAMPLE_CAP = 512

    __slots__ = ("count", "sum", "min", "max", "_counts", "_samples",
                 "sample_cap", "_exemplars")

    def __init__(self, sample_cap: Optional[int] = None):
        self.sample_cap = (self.SAMPLE_CAP if sample_cap is None
                           else int(sample_cap))
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._counts = [0] * _N_BUCKETS
        self._samples: Optional[List[float]] = []
        # {bucket_index: [exemplar_id, value, wall_ts]} — allocated on
        # the first exemplar-carrying observe, so exemplar-free
        # histograms pay one None check
        self._exemplars: Optional[Dict[int, list]] = None

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        idx = bucket_index(value)
        self._counts[idx] += 1
        if exemplar is not None:
            if self._exemplars is None:
                self._exemplars = {}
            self._exemplars[idx] = [str(exemplar), value, time.time()]
        if self._samples is not None:
            if len(self._samples) < self.sample_cap:
                self._samples.append(value)
            else:
                self._samples = None    # over the cap: buckets only

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    @property
    def exact(self) -> bool:
        """True while every observation is still individually retained
        (percentiles are exact, not interpolated)."""
        return (self._samples is not None
                and len(self._samples) == self.count)

    def percentile(self, q: float) -> Optional[float]:
        """The ``q``-th percentile (``0 <= q <= 100``); ``None`` when
        empty.  Exact (numpy ``linear``) below the cap, interpolated
        bucket quantile above it."""
        if self.count == 0:
            return None
        if self.exact:
            s = sorted(self._samples)
            rank = (q / 100.0) * (len(s) - 1)
            lo = int(math.floor(rank))
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (s[hi] - s[lo]) * (rank - lo)
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo_edge = 0.0 if i == 0 else LATTICE_EDGES[i - 1]
                if i < len(LATTICE_EDGES):
                    hi_edge = LATTICE_EDGES[i]
                else:
                    # overflow bucket: the observed max bounds it; a
                    # wire round trip loses min/max, so degrade to the
                    # last edge (a lower bound) rather than crash
                    hi_edge = self.max if self.max is not None \
                        else lo_edge
                est = lo_edge + (hi_edge - lo_edge) * (
                    (target - cum) / c)
                # the observed extrema tighten the bucket's edges
                if self.min is not None:
                    est = builtins_max(est, self.min)
                if self.max is not None:
                    est = min(est, self.max)
                return est
            cum += c
        return self.max

    def bucket_counts(self) -> Dict[int, int]:
        """Sparse ``{bucket_index: count}`` (the merge/export wire
        form; index ``len(LATTICE_EDGES)`` is the overflow bucket)."""
        return {i: c for i, c in enumerate(self._counts) if c}

    def count_above(self, index: int) -> int:
        """Exact count of observations in buckets STRICTLY above
        ``index`` — the burn-rate bad-count read (a latency SLO's
        threshold rounds to a lattice edge, so this is never
        interpolated).  O(buckets) over the raw counts list; the
        alert-evaluation hot path, so no dict is built."""
        return sum(self._counts[index + 1:])

    def exemplars(self) -> Dict[int, tuple]:
        """``{bucket_index: (exemplar_id, value, wall_ts)}`` for every
        bucket holding a retained exemplar."""
        if not self._exemplars:
            return {}
        return {i: tuple(e) for i, e in dict(self._exemplars).items()}

    def exemplar_for(self, q: float) -> Optional[tuple]:
        """The retained exemplar nearest the ``q``-th percentile:
        the bucket that percentile lands in, else the closest bucket
        ABOVE it (a p99 inquiry wants the offending tail request, so
        ties resolve upward), else the closest below.  Returns
        ``(exemplar_id, value, wall_ts)`` or ``None`` when no exemplar
        was ever retained."""
        if not self._exemplars:
            return None
        p = self.percentile(q)
        if p is None:
            return None
        idx = bucket_index(p)
        held = sorted(self._exemplars)
        above = [i for i in held if i >= idx]
        best = above[0] if above else held[-1]
        return tuple(self._exemplars[best])

    def to_snapshot(self) -> dict:
        snap = {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "counts": self.bucket_counts(),
            "samples": (list(self._samples)
                        if self._samples is not None else None),
        }
        if self._exemplars:
            # dict() is a single C-level copy under the GIL — a
            # concurrent observe() landing a first exemplar in a new
            # bucket (a recording thread vs a scrape) can never
            # surface as dictionary-changed-size mid-iteration
            snap["exemplars"] = {i: list(e)
                                 for i, e
                                 in dict(self._exemplars).items()}
        return snap

    @classmethod
    def from_snapshot(cls, d: dict) -> "Histogram":
        h = cls()
        h.merge(d)
        return h

    def merge(self, d: dict) -> None:
        """Fold a snapshot dict in: bucket-wise sum (the shared lattice
        makes this exact), count/sum adds, min/max folds, samples kept
        only while the combined count still fits the cap."""
        self.count += int(d.get("count", 0))
        self.sum += float(d.get("sum", 0.0))
        for attr, fold in (("min", min), ("max", builtins_max)):
            v = d.get(attr)
            if v is not None:
                cur = getattr(self, attr)
                setattr(self, attr, v if cur is None else fold(cur, v))
        for i, c in (d.get("counts") or {}).items():
            self._counts[int(i)] += int(c)     # str keys post-JSON
        for i, e in (d.get("exemplars") or {}).items():
            idx = int(i)
            if self._exemplars is None:
                self._exemplars = {}
            cur = self._exemplars.get(idx)
            # newest wall timestamp wins per bucket (a None ts — a
            # wire round trip that lost it — loses to any real one);
            # EQUAL timestamps tie-break on the exemplar id so the
            # merged winner is identical whatever order ranks fold in
            ts_new, ts_cur = ((e[2] or 0.0),
                              0.0 if cur is None else (cur[2] or 0.0))
            if cur is None or ts_new > ts_cur or (
                    ts_new == ts_cur and str(e[0]) > str(cur[0])):
                self._exemplars[idx] = [str(e[0]), float(e[1]),
                                        e[2] if e[2] is None
                                        else float(e[2])]
        other = d.get("samples")
        if (self._samples is not None and other is not None
                and len(self._samples) + len(other) <= self.sample_cap):
            self._samples.extend(float(v) for v in other)
        else:
            self._samples = None


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _NullInstrument:
    """The disabled-path instrument: ONE shared instance answering
    every record method as a no-op, so a disabled registry allocates
    nothing per record (pinned by test — the TraceRecorder
    ``_NULL_SPAN`` discipline).  The READ surface answers like an
    empty histogram/counter (count 0, ``percentile``/``mean`` →
    ``None``) so consumers that read live instruments — e.g. a
    service-time predictor over ``registry.histogram("serve/ttft")``
    — degrade to "no data" instead of crashing when the registry is
    disabled."""

    __slots__ = ()

    count = 0
    sum = 0.0
    min = None
    max = None
    value = 0.0
    last = None
    mean = None

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        pass

    def percentile(self, q: float) -> None:
        return None

    def count_above(self, index: int) -> int:
        return 0

    def exemplar_for(self, q: float) -> None:
        return None

    def exemplars(self) -> dict:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


# ---------------------------------------------------------------------- #
# registry
# ---------------------------------------------------------------------- #

class MetricsRegistry:
    """Process-global name → instrument table.

    Disabled (the production default until ``CHAINERMN_TPU_METRICS=1``
    or :meth:`enable`): the instrument getters return the shared
    no-op singleton and the convenience recorders early-return — the
    instrumented paths (the checkpoint save, the object channel's store
    verbs) pay one attribute read and nothing else.

    Instrument names are slash-namespaced like span names
    (``serve/ttft``, ``train/step_time``, ``checkpoint/quarantined``);
    a name keeps its first-registered type for the registry's lifetime
    (re-registering under another type raises — silent shadowing would
    corrupt the merge math).
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def __len__(self) -> int:
        return len(self._metrics)

    def _get(self, name: str, cls):
        if not self.enabled:
            return _NULL_INSTRUMENT
        inst = self._metrics.get(name)
        if inst is None:
            with self._lock:
                inst = self._metrics.get(name)
                if inst is None:
                    inst = cls()
                    self._metrics[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, not a "
                f"{cls.__name__} — one name, one instrument type")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # convenience recorders (what the instrumented call sites use) --- #

    def inc(self, name: str, n: float = 1.0) -> None:
        if not self.enabled:
            return
        self.counter(name).inc(n)

    def set(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauge(name).set(value)

    def observe(self, name: str, value: float,
                exemplar: Optional[str] = None) -> None:
        if not self.enabled:
            return
        self.histogram(name).observe(value, exemplar=exemplar)

    # snapshot / lifecycle ------------------------------------------- #

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, dict]:
        """Name → snapshot-dict (JSON-safe, detached from the live
        instruments), optionally restricted to a name prefix."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: inst.to_snapshot() for name, inst in items
                if prefix is None or name.startswith(prefix)}

    def digest(self) -> Dict[str, Optional[float]]:
        """Counter values and gauge lasts only — the cheap live read
        a status page wants per scrape (a full :meth:`snapshot` would
        also serialize every histogram's retained samples and
        exemplars just to be discarded)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Optional[float]] = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                out[name] = inst.value
            elif isinstance(inst, Gauge):
                out[name] = inst.last
        return out

    def load(self, snapshot: Dict[str, dict]) -> None:
        """Fold a snapshot into this registry (merge semantics per
        instrument type) — the inverse of :meth:`snapshot` and the
        worker half of :func:`merge_metrics`."""
        for name in sorted(snapshot):
            d = snapshot[name]
            cls = _TYPES.get(d.get("type"))
            if cls is None:
                continue
            inst = self._metrics.get(name)
            if inst is None:
                with self._lock:
                    inst = self._metrics.setdefault(name, cls())
            if isinstance(inst, cls):   # divergent-type rows are dropped
                inst.merge(d)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def _from_env() -> MetricsRegistry:
    enabled = os.environ.get("CHAINERMN_TPU_METRICS", "") \
        not in ("", "0")
    return MetricsRegistry(enabled=enabled)


_GLOBAL = _from_env()


def get_registry() -> MetricsRegistry:
    """The process-global registry every instrumented subsystem records
    into (disabled by default — see module docstring)."""
    return _GLOBAL


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests, scoped benches); returns the
    previous one so callers can restore it."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = registry
    return prev


# ---------------------------------------------------------------------- #
# cross-rank merge
# ---------------------------------------------------------------------- #

def merge_metrics(comm, registry: Optional[MetricsRegistry] = None
                  ) -> MetricsRegistry:
    """Allgather every process's snapshot and fold them into ONE merged
    registry — counters sum, gauges keep max-of-{last,max}, histograms
    bucket-wise sum on the shared lattice, divergent name sets union
    (ranks may run different extensions — each metric merges over the
    ranks that reported it, the ``ObservationAggregator`` convention).

    COLLECTIVE: every process must call.  ``allgather_obj`` hands every
    rank the same rank-ordered rows and the fold is deterministic, so
    the merged snapshot is identical on every rank — safe to gate
    rank-0-only exposition on.
    """
    reg = registry if registry is not None else get_registry()
    rows = comm.allgather_obj(reg.snapshot())
    merged = MetricsRegistry(enabled=True)
    for row in rows:
        merged.load(row)
    return merged


# ---------------------------------------------------------------------- #
# exposition: Prometheus text + JSONL
# ---------------------------------------------------------------------- #

def _prom_name(name: str) -> str:
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return "_" + n if n and n[0].isdigit() else n


def _prom_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _prom_float(v: float) -> str:
    return format(float(v), ".17g")     # round-trips doubles exactly


def to_prometheus(snapshot, labels: Optional[Dict[str, str]] = None,
                  openmetrics: bool = False) -> str:
    """Render a registry (or a :meth:`MetricsRegistry.snapshot` dict)
    as Prometheus exposition text, node-exporter-textfile style.

    ``openmetrics=True`` emits the OpenMetrics dialect: exemplar
    suffixes on bucket rows that hold one, and counter samples under
    the mandatory ``_total`` name (a strict OM parser — Prometheus's
    own when the scrape negotiated openmetrics — rejects both missing
    ``_total`` and, in the classic dialect, the exemplar grammar).
    The default stays classic ``text/plain; version=0.0.4`` with
    neither (every pre-exemplar caller keeps emitting parseable
    0.0.4: :func:`export_prometheus` / ``MetricsTextfile`` / watchdog
    stall reports); the negotiating pull surface (``/metricsz``) opts
    in per scrape, and :func:`parse_prometheus_text` accepts both
    dialects.

    Histograms emit cumulative ``_bucket{le=...}`` rows for every
    NON-EMPTY lattice bucket plus the mandatory ``le="+Inf"``, and
    ``_sum`` / ``_count`` — successive-row differences reconstruct the
    exact bucket counts (:func:`histogram_from_prometheus`), and the
    17-digit ``le`` values match the lattice edges float-exactly.
    ``labels`` (e.g. ``{"rank": "0"}``) ride every sample.
    """
    if isinstance(snapshot, MetricsRegistry):
        snapshot = snapshot.snapshot()
    lines: List[str] = []
    lab = _prom_labels(labels)
    for name in sorted(snapshot):
        d = snapshot[name]
        pname = _prom_name(name)
        kind = d.get("type")
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            sample = f"{pname}_total" if openmetrics else pname
            lines.append(f"{sample}{lab} {_prom_float(d['value'])}")
        elif kind == "gauge":
            if d.get("last") is None:
                continue
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname}{lab} {_prom_float(d['last'])}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            counts = {int(i): int(c)
                      for i, c in (d.get("counts") or {}).items()}
            exes = ({} if not openmetrics else
                    {int(i): e
                     for i, e in (d.get("exemplars") or {}).items()})
            cum = 0
            for i in sorted(counts):
                cum += counts[i]
                le = ("+Inf" if i >= len(LATTICE_EDGES)
                      else _prom_float(LATTICE_EDGES[i]))
                blab = _prom_labels(dict(labels or {}, le=le))
                row = f"{pname}_bucket{blab} {cum}"
                ex = exes.get(i)
                if ex is not None:
                    # OpenMetrics exemplar syntax: the bucket row links
                    # straight to the causal trace of one observation
                    # that landed in it.  Caller-propagated trace ids
                    # are arbitrary strings — sanitize to the label
                    # charset so a quote/brace can never corrupt the
                    # exposition (or defeat the parser's round-trip)
                    exid = re.sub(r"[^A-Za-z0-9_.:\-]", "_",
                                  str(ex[0]))
                    row += (f' # {{trace_id="{exid}"}} '
                            f"{_prom_float(ex[1])}")
                    if ex[2] is not None:
                        row += f" {_prom_float(ex[2])}"
                lines.append(row)
            if not counts or max(counts) < len(LATTICE_EDGES):
                blab = _prom_labels(dict(labels or {}, le="+Inf"))
                lines.append(f"{pname}_bucket{blab} {cum}")
            lines.append(f"{pname}_sum{lab} {_prom_float(d['sum'])}")
            lines.append(f"{pname}_count{lab} {int(d['count'])}")
    if openmetrics:
        # the mandatory document terminator — a strict OM parser
        # rejects an exposition without it as truncated
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")


_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)"
    # optional OpenMetrics exemplar suffix: # {labels} value [ts]
    r"(?:\s+#\s+\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>\S+)"
    r"(?:\s+(?P<exts>\S+))?)?$")


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse :func:`to_prometheus` output back into snapshot-shaped
    dicts: ``{name: {"type", "value"|"last"|("count","sum","buckets")}}``
    where histogram ``buckets`` is ``[(le, cumulative_count), ...]`` in
    emission order (``le`` is ``math.inf`` for ``+Inf``) and
    ``exemplars`` (when present) maps ``le`` to
    ``[trace_id, value, ts]`` parsed from the OpenMetrics exemplar
    suffix.  Pre-exemplar text parses identically to before — the
    suffix is optional in both the grammar and the output (the
    back-compat half the tests pin, both directions)."""
    types: Dict[str, str] = {}
    out: Dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, labels, value = (m.group("name"), m.group("labels") or "",
                               m.group("value"))
        base, suffix = name, None
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and types.get(name[: -len(suf)]) \
                    == "histogram":
                base, suffix = name[: -len(suf)], suf
                break
        # the OpenMetrics dialect samples counters under _total
        if suffix is None and name.endswith("_total") \
                and types.get(name[: -len("_total")]) == "counter":
            base = name[: -len("_total")]
        kind = types.get(base)
        if kind == "histogram":
            entry = out.setdefault(base, {"type": "histogram",
                                          "buckets": [], "count": 0,
                                          "sum": 0.0})
            if suffix == "_bucket":
                le_m = re.search(r'le="([^"]+)"', labels)
                if le_m:
                    le = (math.inf if le_m.group(1) == "+Inf"
                          else float(le_m.group(1)))
                    entry["buckets"].append((le, int(float(value))))
                    if m.group("exvalue") is not None:
                        ex_id = re.search(r'trace_id="([^"]*)"',
                                          m.group("exlabels") or "")
                        ts = m.group("exts")
                        entry.setdefault("exemplars", {})[le] = [
                            ex_id.group(1) if ex_id else "",
                            float(m.group("exvalue")),
                            float(ts) if ts is not None else None]
            elif suffix == "_sum":
                entry["sum"] = float(value)
            elif suffix == "_count":
                entry["count"] = int(float(value))
        elif kind == "counter":
            out[base] = {"type": "counter", "value": float(value)}
        elif kind == "gauge":
            out[base] = {"type": "gauge", "last": float(value)}
    return out


def histogram_from_prometheus(entry: dict) -> Histogram:
    """Rebuild a lattice :class:`Histogram` from a parsed exposition
    entry.  Bucket counts are exact (cumulative differences mapped back
    to lattice indices by float-equal ``le`` match); raw samples and
    min/max do not survive the wire, so percentiles come from the
    interpolated-bucket path.  Exemplars round-trip onto their lattice
    buckets (the exemplar→trace link survives exposition)."""
    h = Histogram()
    h._samples = None
    h.count = int(entry.get("count", 0))
    h.sum = float(entry.get("sum", 0.0))
    exemplars = entry.get("exemplars") or {}

    def lattice_idx(le: float) -> int:
        if math.isinf(le):
            return len(LATTICE_EDGES)
        idx = bisect_left(LATTICE_EDGES, le)
        if idx >= len(LATTICE_EDGES) or LATTICE_EDGES[idx] != le:
            raise ValueError(
                f"le={le!r} is not a lattice edge — was this text "
                "produced by a different lattice version?")
        return idx

    prev = 0
    for le, cum in entry.get("buckets", []):
        c = cum - prev
        prev = cum
        if c <= 0:
            continue
        h._counts[lattice_idx(le)] += c
    for le, ex in exemplars.items():
        if h._exemplars is None:
            h._exemplars = {}
        h._exemplars[lattice_idx(le)] = [str(ex[0]), float(ex[1]),
                                         None if ex[2] is None
                                         else float(ex[2])]
    return h


def export_prometheus(path: str, registry=None,
                      labels: Optional[Dict[str, str]] = None,
                      openmetrics: bool = False) -> str:
    """Write the exposition text atomically (tmp + rename — the
    node-exporter textfile-collector contract: a scraper must never
    read a half-written file).  The OpenMetrics dialect (exemplars,
    ``_total`` counters) defaults OFF here: the textfile collector
    speaks classic 0.0.4, whose parsers reject the OM grammar —
    turning request tracing on must never break an existing scrape."""
    reg = registry if registry is not None else get_registry()
    text = to_prometheus(reg, labels=labels, openmetrics=openmetrics)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def append_jsonl(path: str, entry: dict) -> str:
    """Append ``entry`` as ONE JSON line, crash-atomically: the line is
    fully serialized first and lands via a single ``O_APPEND`` write
    syscall, so a SIGKILL (or a concurrent appender) can never leave a
    TORN last line — a reader sees the line entirely or not at all.
    The JSONL sibling of :func:`export_prometheus`'s tmp+rename
    contract; every ``*.jsonl`` report in the stack (metrics/straggler/
    goodput/alert logs) flushes through here."""
    data = (json.dumps(entry, default=float) + "\n").encode()
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        view = memoryview(data)
        while view:
            # a short write (ENOSPC mid-line, signal) would be exactly
            # the torn tail this function promises away — finish or
            # raise, never return with bytes unwritten
            view = view[os.write(fd, view):]
    finally:
        os.close(fd)
    return path


def export_jsonl(path: str, registry=None, **extra) -> str:
    """Append ONE JSON line ``{"ts", ..., "metrics": snapshot}`` — the
    time-series form (each flush is a point; dashboards diff
    counters/buckets between lines).  Atomic per line
    (:func:`append_jsonl`)."""
    reg = registry if registry is not None else get_registry()
    entry = {"ts": time.time(), **extra, "metrics": reg.snapshot()}
    return append_jsonl(path, entry)


# ---------------------------------------------------------------------- #
# trainer extensions
# ---------------------------------------------------------------------- #

class GoodputReport:
    """Not ported: the goodput decomposition, which drains the
    updater's step-phase spans (ROADMAP Queue A item 10)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GoodputReport is not ported to chainermn_tpu_torch yet: it "
            "drains the updater's step-phase spans, which come with "
            "ROADMAP Queue A item 10")


class MetricsTextfile:
    """Trainer extension flushing the registry to a Prometheus textfile
    on trigger (node-exporter textfile-collector convention: atomic
    tmp+rename writes of ``<out>/metrics.prom``).

    With ``comm=`` on a world of several ranks the flush is COLLECTIVE:
    every rank enters :func:`merge_metrics` and rank 0 writes the one
    merged file (samples labeled ``rank="merged"``).  Without a comm
    (or single-process) each process writes its own file, rank-labeled.
    """

    trigger = (1, "epoch")
    priority = 40

    def __init__(self, comm=None, filename: str = "metrics.prom",
                 path: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.comm = comm
        self.filename = filename
        self.path = path
        self.registry = registry

    def initialize(self, trainer) -> None:
        if self.path is None:
            self.path = os.path.join(getattr(trainer, "out", "."),
                                     self.filename)

    def __call__(self, trainer=None) -> None:
        if self.path is None:
            self.path = self.filename
        reg = (self.registry if self.registry is not None
               else get_registry())
        # a port process is one rank: size and rank, where the JAX
        # package counts processes (inter_size, inter_rank)
        if self.comm is not None and self.comm.size > 1:
            merged = merge_metrics(self.comm, reg)
            if self.comm.rank != 0:
                return
            reg, labels = merged, {"rank": "merged"}
        else:
            rank = self.comm.rank if self.comm is not None else 0
            labels = {"rank": str(rank)}
        try:
            export_prometheus(self.path, reg, labels=labels)
        except OSError:
            pass                # a full disk must never kill training
