# Port of analytics_zoo_tpu/core/metrics.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Process-wide telemetry registry: counters, gauges, histograms.

Production ML systems treat monitoring as a first-class subsystem with
uniform counters and latency distributions across every layer (the
TensorFlow system paper makes the point explicitly), and pod-scale TPU
work leans on step-time/throughput breakdowns as the primary tool for
finding input-pipeline vs. device bottlenecks.  Before this module the
repo had five unrelated observability surfaces (``ClusterServing._counters``,
the resilient client's ``conn.stats``, the HTTP frontend's ad-hoc
``/stats`` dict, ``Estimator.history``, heartbeat files); this registry is
the one substrate they all report through.

Design:

- **Cheap on hot paths.**  ``Counter.inc`` / ``Histogram.observe`` are a
  lock + an integer bump (histograms add one ``bisect``); handles are
  created once (``registry.counter(name)``) and reused, so the per-event
  cost is independent of registry size.  ``registry.enabled = False``
  turns every write into an attribute check + return (the overhead-guard
  test's baseline).
- **Named labels.**  A metric identity is ``(name, sorted(labels))`` —
  ``inc("faults.fired", point="serving.conn_drop")`` and
  ``observe("frontend.request_ms", dt, route="/predict")`` create
  distinct series, rendered as ``name{k=v,...}`` in snapshots and as
  real Prometheus labels in the exposition.
- **Fixed-bucket histograms.**  Latency/size distributions use fixed
  bucket edges (Prometheus ``le`` semantics: bucket *i* counts values
  ``<= edges[i]``, plus a +Inf overflow), so p50/p99 come from bucket
  interpolation with zero per-observation allocation.
- **Three read paths.**  ``snapshot()`` for programmatic reads (tests,
  bench records), ``export_jsonl()`` for append-only trajectory files,
  ``prometheus()`` for the HTTP frontend's ``GET /metrics`` scrape
  endpoint (text exposition format 0.0.4).

One process-global instance (``get_registry()``) serves the default
wiring; components accept an explicit registry for isolation.
``reset()`` zeroes values **in place** so long-lived handles held by a
running server stay valid across test boundaries.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: Default latency bucket edges, in milliseconds: 100 µs to 10 s.
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

#: Default size bucket edges (batch sizes, queue depths, row counts).
SIZE_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(name: str, labels: _LabelKey) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _parse_series(series: str) -> Tuple[str, _LabelKey]:
    """Inverse of ``_series_name``: ``"a.b{k=v,j=w}"`` → name + sorted
    label key.  Metric names never contain ``{``, and label values in
    this framework never contain ``,``/``=`` (routes, replica addresses,
    point names), so the split is unambiguous."""
    if "{" not in series:
        return series, ()
    name, _, body = series.partition("{")
    pairs = []
    for part in body.rstrip("}").split(","):
        k, _, v = part.partition("=")
        pairs.append((k, v))
    return name, tuple(sorted(pairs))


def _bucket_percentile(edges: Tuple[float, ...], counts: List[int],
                       q: float) -> float:
    """q-quantile by linear interpolation within the winning bucket —
    the shared math behind ``Histogram.percentile`` and merged-snapshot
    summaries."""
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        if seen + c >= target and c > 0:
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i] if i < len(edges) else edges[-1]
            frac = (target - seen) / c
            return lo + frac * (hi - lo)
        seen += c
    return edges[-1]


class Counter:
    """Monotonic counter.  ``inc()`` only goes up; ``reset()`` (via the
    registry) zeroes it for test isolation."""

    __slots__ = ("name", "labels", "_lock", "value", "_registry",
                 "_pinned")

    def __init__(self, name: str, labels: _LabelKey, registry:
                 "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0
        self._registry = registry
        self._pinned = False

    def inc(self, value: float = 1) -> None:
        if not self._registry.enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {value})")
        with self._lock:
            self.value += value

    def _reset(self) -> None:
        with self._lock:
            self.value = 0

    def _snapshot(self) -> Any:
        with self._lock:
            return self.value


class Gauge:
    """Point-in-time value with a high-water mark (``max``) — queue
    depths, in-flight request counts.  ``add()`` for up/down deltas."""

    __slots__ = ("name", "labels", "_lock", "value", "max", "_registry",
                 "_pinned")

    def __init__(self, name: str, labels: _LabelKey,
                 registry: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0
        self.max = 0.0
        self._registry = registry
        self._pinned = False

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value = value
            if value > self.max:
                self.max = value

    def add(self, delta: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value += delta
            if self.value > self.max:
                self.max = self.value

    def _reset(self) -> None:
        with self._lock:
            self.value = 0.0
            self.max = 0.0

    def _snapshot(self) -> Any:
        with self._lock:
            return {"value": self.value, "max": self.max}


class Histogram:
    """Fixed-bucket distribution (Prometheus ``le`` semantics): bucket
    ``i`` counts observations ``<= edges[i]``; one overflow bucket
    (+Inf) catches the rest.  Quantiles are linear interpolation within
    the winning bucket — exact enough for p50/p99 dashboards, free of
    per-observation allocation."""

    __slots__ = ("name", "labels", "edges", "_lock", "counts", "sum",
                 "count", "_registry", "_pinned")

    def __init__(self, name: str, labels: _LabelKey,
                 registry: "MetricsRegistry",
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.edges = tuple(float(b) for b in (buckets or LATENCY_BUCKETS_MS))
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram {name} bucket edges must be "
                             f"strictly increasing, got {self.edges}")
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self._registry = registry
        self._pinned = False

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        i = bisect.bisect_left(self.edges, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def time(self) -> "_HistogramTimer":
        """Context manager observing the block's wall time in ms:
        ``with hist.time(): ...`` — the idiom the pipelined serving
        stages use for their per-stage latency series."""
        return _HistogramTimer(self)

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) from bucket counts."""
        with self._lock:
            counts = list(self.counts)
        return _bucket_percentile(self.edges, counts, q)

    def quantile(self, q: float) -> float:
        """Public q-quantile accessor (q in [0, 1]) — the name control
        loops use (``percentile`` predates it and stays as an alias).
        Lifetime distribution; pair with :func:`snapshot_delta` +
        :func:`quantile_from_snapshot` for a recent-window quantile."""
        return self.percentile(q)

    def _reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.edges) + 1)
            self.sum = 0.0
            self.count = 0

    def _snapshot(self) -> Any:
        # bucket edges + counts ride along so cross-process snapshots can
        # be MERGED exactly (``MetricsRegistry.merge`` bucket-adds them);
        # the summary keys keep their pre-merge meaning for readers
        with self._lock:
            count, total = self.count, self.sum
            counts = list(self.counts)
        return {"count": count, "sum": round(total, 6),
                "mean": round(total / count, 6) if count else 0.0,
                "p50": round(_bucket_percentile(self.edges, counts,
                                                0.50), 6),
                "p99": round(_bucket_percentile(self.edges, counts,
                                                0.99), 6),
                "bucket_edges": list(self.edges),
                "bucket_counts": counts}


class _HistogramTimer:
    """``with hist.time():`` — observe elapsed milliseconds on exit
    (monotonic clock; observes even when the block raises, so error
    paths stay visible in the latency distribution)."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._hist.observe((time.monotonic() - self._t0) * 1000.0)


class MetricsRegistry:
    """Thread-safe registry of named metric series.

    Get-or-create handles (``counter``/``gauge``/``histogram``) for hot
    paths; one-shot ``inc``/``observe``/``set_gauge`` for cold ones.
    Creating the same ``(name, labels)`` under a different metric type
    raises — a name means one thing everywhere."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], Any] = {}
        self._types: Dict[str, type] = {}  # name → metric class
        self.enabled = True

    # -- handle creation ------------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, Any],
             pin: bool = True, **kw: Any):
        key = (name, _label_key(labels))
        with self._lock:
            # type uniqueness is per NAME, not per (name, labels): the
            # exposition renders all of a name's label series under one
            # # TYPE line, so a counter and a histogram sharing a name
            # (differing only in labels) would corrupt the scrape
            known = self._types.get(name)
            if known is not None and known is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{known.__name__}, not {cls.__name__}")
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], self, **kw)
                self._metrics[key] = m
                self._types[name] = cls
            if pin:
                # a caller holding a handle expects the series to survive
                # reset() (zeroed in place); one-shot writes (pin=False)
                # create EPHEMERAL series reset() retires entirely — see
                # reset()'s docstring for why the distinction matters
                m._pinned = True
            return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def remove(self, name: str, **labels: Any) -> None:
        """Retire one ``(name, labels)`` series — for label values with
        bounded lifetimes (e.g. a served model VERSION that was
        unloaded): without retirement every value ever seen stays in
        every future scrape, and monotone values (v1, v2, ...) grow the
        registry without bound.  Outstanding handles to the removed
        series keep working but no longer export.  The name's type
        registration is dropped with its last series."""
        key = (name, _label_key(labels))
        with self._lock:
            self._metrics.pop(key, None)
            if not any(k[0] == name for k in self._metrics):
                self._types.pop(name, None)

    # -- one-shot writes ------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        self._get(Counter, name, labels, pin=False).inc(value)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        self._get(Gauge, name, labels, pin=False).set(value)

    def observe(self, name: str, value: float,
                buckets: Optional[Tuple[float, ...]] = None,
                **labels: Any) -> None:
        self._get(Histogram, name, labels, pin=False,
                  buckets=buckets).observe(value)

    # -- reads ----------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """{series: value} over every registered series.  Counters are
        numbers, gauges ``{"value", "max"}``, histograms
        ``{"count", "sum", "mean", "p50", "p99"}``."""
        with self._lock:
            items = list(self._metrics.items())
        return {_series_name(name, labels): m._snapshot()
                for (name, labels), m in sorted(items, key=lambda kv:
                                                _series_name(*kv[0]))}

    def flat(self, prefix: str = "") -> Dict[str, float]:
        """Back-compat flat view: counters and gauge values only, as
        plain numbers (the shape the old ad-hoc stats dicts had).
        ``prefix`` filters to series whose name starts with it, and is
        stripped from the keys."""
        out: Dict[str, float] = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labels), m in items:
            if not name.startswith(prefix):
                continue
            series = _series_name(name[len(prefix):], labels)
            if isinstance(m, Counter):
                out[series] = m._snapshot()
            elif isinstance(m, Gauge):
                out[series] = m._snapshot()["value"]
        return out

    def prometheus(self) -> str:
        """Text exposition format 0.0.4 — what ``GET /metrics`` serves.
        Dots in metric names become underscores under a ``zoo_`` prefix
        (Prometheus names admit ``[a-zA-Z0-9_:]`` only)."""
        by_name: Dict[str, List[Tuple[_LabelKey, Any]]] = {}
        with self._lock:
            for (name, labels), m in self._metrics.items():
                by_name.setdefault(name, []).append((labels, m))
        lines: List[str] = []
        for name in sorted(by_name):
            prom = "zoo_" + "".join(
                c if c.isalnum() or c == "_" else "_" for c in name)
            series = by_name[name]
            kind = series[0][1]
            if isinstance(kind, Counter):
                lines.append(f"# TYPE {prom} counter")
                for labels, m in sorted(series, key=lambda s: s[0]):
                    lines.append(f"{prom}{_prom_labels(labels)} "
                                 f"{_prom_num(m._snapshot())}")
            elif isinstance(kind, Gauge):
                lines.append(f"# TYPE {prom} gauge")
                for labels, m in sorted(series, key=lambda s: s[0]):
                    snap = m._snapshot()
                    lines.append(f"{prom}{_prom_labels(labels)} "
                                 f"{_prom_num(snap['value'])}")
                    lines.append(f"{prom}_max{_prom_labels(labels)} "
                                 f"{_prom_num(snap['max'])}")
            else:
                lines.append(f"# TYPE {prom} histogram")
                for labels, m in sorted(series, key=lambda s: s[0]):
                    with m._lock:
                        counts = list(m.counts)
                        total, count = m.sum, m.count
                    cum = 0
                    for edge, c in zip(m.edges, counts):
                        cum += c
                        lab = _prom_labels(labels, le=_prom_num(edge))
                        lines.append(f"{prom}_bucket{lab} {cum}")
                    lab = _prom_labels(labels, le="+Inf")
                    lines.append(f"{prom}_bucket{lab} {count}")
                    lines.append(f"{prom}_sum{_prom_labels(labels)} "
                                 f"{_prom_num(total)}")
                    lines.append(f"{prom}_count{_prom_labels(labels)} "
                                 f"{count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_jsonl(self, path: str,
                     max_bytes: Optional[int] = None) -> None:
        """Append one ``{"wall": ..., "metrics": snapshot()}`` line —
        the trajectory-file format ``metrics.jsonl`` readers parse.

        ``max_bytes``: size-based rotation — when the file already
        exceeds it, the file is renamed to ``<path>.1`` (replacing the
        previous generation) before the append, so a long-running
        exporter holds at most ~2×``max_bytes`` on disk while readers
        keep a full recent window."""
        rec = {"wall": time.time(), "metrics": self.snapshot()}
        append_jsonl_rotating(path, json.dumps(rec), max_bytes)

    # -- lifecycle ------------------------------------------------------------

    def reset(self) -> None:
        """Zero every HANDLE-HELD series in place and retire the rest.

        Series created through the handle API (``counter()`` /
        ``gauge()`` / ``histogram()``) stay registered and zeroed, so
        handles cached by long-lived components (a running server's
        counters) keep working across test boundaries.  Series created
        only by one-shot writes (``inc``/``observe``/``set_gauge`` —
        e.g. a label value minted per event) are REMOVED: leaving them
        zeroed made a reset registry's exposition differ from a fresh
        registry's under identical traffic (zero-valued label series the
        fresh registry never saw), which is exactly the dangling-series
        bug tests tripped over with pre-created handles."""
        with self._lock:
            keep = {}
            for key, m in self._metrics.items():
                if m._pinned:
                    keep[key] = m
            self._metrics = keep
            live_names = {k[0] for k in keep}
            self._types = {n: t for n, t in self._types.items()
                           if n in live_names}
            metrics = list(keep.values())
        for m in metrics:
            m._reset()

    # -- cross-process aggregation -------------------------------------------

    @staticmethod
    def merge(snapshots: List[Dict[str, Any]],
              drop_labels: Tuple[str, ...] = ()) -> Dict[str, Any]:
        """Fold N ``snapshot()`` dicts (from N processes / replicas /
        gang workers) into one cluster-level snapshot:

        - **counters** sum (each process counted disjoint events);
        - **gauges** sum their current values (cluster queue depth is
          the sum of per-replica depths) and **max-merge** their
          high-water marks;
        - **histograms** bucket-add (exact when bucket edges agree —
          they do for same-version processes; on an edge mismatch the
          buckets are dropped and only count/sum/mean merge), with
          p50/p99 recomputed from the merged buckets.

        ``drop_labels`` removes those label keys before merging, so a
        cluster view folds ``client.request_ms{replica=...}`` series
        into one unlabeled distribution."""
        out: Dict[str, Any] = {}
        for snap in snapshots:
            for series, val in snap.items():
                name, labels = _parse_series(series)
                if drop_labels:
                    labels = tuple((k, v) for k, v in labels
                                   if k not in drop_labels)
                key = _series_name(name, labels)
                cur = out.get(key)
                if cur is None:
                    out[key] = (dict(val) if isinstance(val, dict)
                                else val)
                elif isinstance(val, dict) and "count" in val:
                    _merge_hist(cur, val)
                elif isinstance(val, dict):
                    cur["value"] = cur.get("value", 0) + val.get("value",
                                                                0)
                    cur["max"] = max(cur.get("max", 0), val.get("max", 0))
                else:
                    out[key] = cur + val
        for val in out.values():
            if isinstance(val, dict) and "bucket_counts" in val:
                edges = tuple(val["bucket_edges"])
                counts = val["bucket_counts"]
                val["mean"] = (round(val["sum"] / val["count"], 6)
                               if val["count"] else 0.0)
                val["p50"] = round(_bucket_percentile(edges, counts,
                                                      0.50), 6)
                val["p99"] = round(_bucket_percentile(edges, counts,
                                                      0.99), 6)
        return dict(sorted(out.items()))

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        """Materialize a registry from a ``snapshot()``-shaped dict (a
        merged cluster view, a worker's exported jsonl line) so it can
        be rendered with ``prometheus()`` or re-merged."""
        reg = cls()
        for series, val in snap.items():
            name, labels = _parse_series(series)
            kw = dict(labels)
            if isinstance(val, dict) and "count" in val:
                edges = tuple(val.get("bucket_edges")
                              or LATENCY_BUCKETS_MS)
                h = reg._get(Histogram, name, kw, buckets=edges)
                counts = val.get("bucket_counts")
                with h._lock:
                    h.count = int(val["count"])
                    h.sum = float(val["sum"])
                    if counts is not None and len(counts) == len(
                            h.counts):
                        h.counts = [int(c) for c in counts]
                    else:
                        h.counts[-1] = int(val["count"])
            elif isinstance(val, dict):
                g = reg._get(Gauge, name, kw)
                with g._lock:
                    g.value = float(val.get("value", 0.0))
                    g.max = float(val.get("max", 0.0))
            else:
                c = reg._get(Counter, name, kw)
                with c._lock:
                    c.value = val
        return reg


def snapshot_delta(prev: Dict[str, Any],
                   cur: Dict[str, Any]) -> Dict[str, Any]:
    """The WINDOW between two ``snapshot()`` dicts — what changed since
    ``prev`` was taken.  Control loops need *recent* behavior (the p99
    of the last control tick, the requests admitted since the last
    decision), and lifetime distributions answer a different question:
    an hour of calm traffic drowns a 10-second latency spike that
    should trigger a scale-up.

    Per series:

    - **counters** subtract (``cur - prev``; a series absent from
      ``prev`` — e.g. first tick — contributes its full value);
    - **gauges** pass through ``cur`` (a point-in-time value has no
      meaningful delta; the high-water ``max`` stays lifetime);
    - **histograms** subtract bucket counts / count / sum, with
      p50/p99/mean recomputed from the WINDOW's buckets.  On a bucket-
      edge mismatch (a series re-registered with different buckets
      between ticks) the current snapshot passes through untouched.

    Series that vanished between snapshots (``remove()``d) are absent
    from the delta.  Counter resets between ticks (``reset()``) clamp
    to the current value rather than going negative."""
    out: Dict[str, Any] = {}
    for series, val in cur.items():
        old = prev.get(series)
        if isinstance(val, dict) and "count" in val:  # histogram
            if (old is None or "count" not in old
                    or list(old.get("bucket_edges") or ())
                    != list(val.get("bucket_edges") or ())):
                out[series] = dict(val)
                continue
            edges = tuple(val["bucket_edges"])
            counts = [max(0, c - p) for c, p in
                      zip(val["bucket_counts"], old["bucket_counts"])]
            count = max(0, val["count"] - old["count"])
            total = max(0.0, round(val["sum"] - old["sum"], 6))
            out[series] = {
                "count": count, "sum": total,
                "mean": round(total / count, 6) if count else 0.0,
                "p50": round(_bucket_percentile(edges, counts, 0.50), 6),
                "p99": round(_bucket_percentile(edges, counts, 0.99), 6),
                "bucket_edges": list(edges),
                "bucket_counts": counts}
        elif isinstance(val, dict):  # gauge: point-in-time, no delta
            out[series] = dict(val)
        else:  # counter
            out[series] = (val if not isinstance(old, (int, float))
                           else max(0, val - old))
    return out


def quantile_from_snapshot(val: Any, q: float) -> Optional[float]:
    """q-quantile of one snapshot entry's histogram — works on the
    dicts ``snapshot()`` / ``snapshot_delta`` / ``merge`` produce, so a
    controller can read a windowed p99 without materializing a registry.
    None when the entry is not a histogram, carries no buckets (edge-
    mismatch merge), or observed nothing."""
    if (not isinstance(val, dict) or "bucket_counts" not in val
            or not val.get("count")):
        return None
    return _bucket_percentile(tuple(val["bucket_edges"]),
                              val["bucket_counts"], q)


def _merge_hist(cur: Dict[str, Any], val: Dict[str, Any]) -> None:
    """In-place histogram-summary merge (summaries recomputed by the
    caller once every snapshot folded in)."""
    cur["count"] = cur.get("count", 0) + val.get("count", 0)
    cur["sum"] = round(cur.get("sum", 0.0) + val.get("sum", 0.0), 6)
    ce, ve = cur.get("bucket_edges"), val.get("bucket_edges")
    if ce is not None and ve is not None and list(ce) == list(ve):
        cur["bucket_counts"] = [a + b for a, b in
                                zip(cur["bucket_counts"],
                                    val["bucket_counts"])]
    else:
        # edge mismatch (version skew): exact bucket math is impossible;
        # drop the buckets so the merged summary never lies about p50/p99
        cur.pop("bucket_edges", None)
        cur.pop("bucket_counts", None)


def append_jsonl_rotating(path: str, line: str,
                          max_bytes: Optional[int] = None) -> None:
    """Append one line to ``path`` with optional size-based rotation to
    ``<path>.1`` — shared by ``export_jsonl`` and the zoo-launch
    supervisor's ``metrics_w<rank>.jsonl`` writers.  Rotation happens
    BEFORE the append (whole lines only, so readers keep their
    torn-file tolerance and never see a line split across
    generations)."""
    import os
    if max_bytes is not None:
        try:
            if os.path.getsize(path) >= max_bytes:
                os.replace(path, path + ".1")
        except OSError:
            pass  # no file yet, or a racing rotation — append wins
    with open(path, "a") as f:
        f.write(line + "\n")


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _prom_labels(labels: _LabelKey, **extra: str) -> str:
    pairs = [(k, v) for k, v in labels] + sorted(extra.items())
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry — the default wiring of every
    instrumented component in the framework."""
    return _REGISTRY
