# Port of analytics_zoo_tpu/core/trace.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""End-to-end request tracing: a span tree over a bounded in-process ring.

Before span trees this module kept flat per-component ``TraceRecord``s — one
"server.batch" and one "client" view per request, correlated only by the
shared 16-hex trace id.  Now that the system is genuinely distributed
(gang workers, multi-process decode, replica sets with hedging, a
multi-stage serving pipeline), "where did this request's latency go?"
needs CAUSALITY, not just correlation: a hedged request's two replica
attempts must show up as sibling spans under one root, and a slow reply
must localize to admission wait vs staging vs inference vs the reply
writer.

So every record is now a **span**: the 16-hex trace id names the
request, an 8-hex span id names one timed piece of work, and
``parent_id`` links spans into a tree that ``tree(tid)`` reconstructs.
The parent span id rides the serving frame header (``span``) so
server-side stage spans attach under the client attempt that sent them
— across processes, with no clock-sync assumptions (every duration is
measured locally with ``time.monotonic`` and shipped as a number).

Usage::

    with trace.span('myapp.work') as sp:          # root span
        with trace.span('myapp.sub', trace_id=sp.trace_id,
                        parent=sp.span_id):
            ...
    roots = trace.tree(sp.trace_id)               # SpanNode tree
    for rec in trace.find(sp.trace_id):           # flat, arrival order
        print(rec.where, rec.stages)

Requests slower than ``SLOW_MS`` are logged at WARNING with the
correlatable id and the per-stage breakdown (server-side stage spans in
the ring are folded into the line even when the caller only measured a
total).  ``SLOW_MS`` and the ring capacity are configurable via
``ZooConfig(trace_slow_ms=..., trace_ring=...)`` → :func:`configure`;
ring evictions are counted in the ``trace.spans_dropped`` metric.
``enabled = False`` turns recording into a no-op (the instrumentation
kill switch the overhead guards measure against, alongside
``MetricsRegistry.enabled``).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from typing import Dict, List, Optional

logger = logging.getLogger("analytics_zoo_tpu")

#: Defaults for :func:`configure` (and what the module attributes start
#: at) — kept as named constants so tests can restore them.
DEFAULT_SLOW_MS = 1000.0
DEFAULT_MAX_RECORDS = 512

#: Requests whose client-observed total exceeds this many milliseconds
#: are logged at WARNING with their trace id + stage breakdown.
SLOW_MS = DEFAULT_SLOW_MS

#: How many completed spans the ring buffer keeps.
MAX_RECORDS = DEFAULT_MAX_RECORDS

#: Module-wide recording kill switch: ``False`` makes ``record()`` (and
#: therefore every span) a no-op.  The overhead guards flip this together
#: with ``MetricsRegistry.enabled`` to measure the uninstrumented
#: baseline.
enabled = True


def new_trace_id() -> str:
    """16 hex chars — short enough for log lines, unique enough for a
    process's ring buffer."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """8 hex chars — one timed piece of work inside a trace."""
    return uuid.uuid4().hex[:8]


class TraceRecord:
    """One span: ``where`` names the work ("client", "server.batch",
    "server.inference", ...), ``stages`` maps stage name → value
    (usually milliseconds), ``span_id``/``parent_id`` link it into the
    trace's tree, ``dur_ms`` is the span's own wall time when it was
    produced by :func:`span` (None for point records)."""

    __slots__ = ("trace_id", "where", "stages", "wall", "span_id",
                 "parent_id", "dur_ms")

    def __init__(self, trace_id: str, where: str,
                 stages: Dict[str, float],
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 dur_ms: Optional[float] = None):
        self.trace_id = trace_id
        self.where = where
        self.stages = dict(stages)
        self.wall = time.time()
        self.span_id = span_id or new_span_id()
        self.parent_id = parent_id
        self.dur_ms = dur_ms

    @property
    def name(self) -> str:
        """Span-vocabulary alias for ``where``."""
        return self.where

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready form — what the flight recorder dumps."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.where,
                "wall": self.wall, "dur_ms": self.dur_ms,
                "stages": dict(self.stages)}

    def __repr__(self) -> str:
        return (f"TraceRecord({self.trace_id}, {self.where}, "
                f"span={self.span_id}, parent={self.parent_id}, "
                f"{self.stages})")


class SpanNode:
    """One node of the tree :func:`tree` reconstructs."""

    __slots__ = ("record", "children")

    def __init__(self, record: TraceRecord):
        self.record = record
        self.children: List["SpanNode"] = []

    @property
    def name(self) -> str:
        return self.record.where

    def find(self, name: str) -> List["SpanNode"]:
        """Every descendant (including self) whose span name matches."""
        out = [self] if self.record.where == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def __repr__(self) -> str:
        return (f"SpanNode({self.record.where}, "
                f"{len(self.children)} children)")


_lock = threading.Lock()
_records: "collections.deque[TraceRecord]" = collections.deque(
    maxlen=MAX_RECORDS)
_dropped_handle = None  # cached trace.spans_dropped counter handle


def configure(slow_ms: Optional[float] = None,
              max_records: Optional[int] = None) -> None:
    """Apply ``ZooConfig(trace_slow_ms=..., trace_ring=...)``: the
    slow-request WARNING threshold and the span-ring capacity (resized
    in place, keeping the newest spans).  ``init_orca_context`` calls
    this; module attributes keep working for direct assignment."""
    global SLOW_MS, MAX_RECORDS, _records
    if slow_ms is not None:
        SLOW_MS = float(slow_ms)
    if max_records is not None:
        if max_records < 1:
            raise ValueError(
                f"trace ring capacity must be >= 1, got {max_records}")
        with _lock:
            MAX_RECORDS = int(max_records)
            _records = collections.deque(_records, maxlen=MAX_RECORDS)


def _count_dropped() -> None:
    """One ring eviction → ``trace.spans_dropped`` (lazy import: metrics
    must stay importable without trace and vice versa)."""
    global _dropped_handle
    if _dropped_handle is None:
        from . import metrics as metrics_lib
        _dropped_handle = metrics_lib.get_registry().counter(
            "trace.spans_dropped")
    _dropped_handle.inc()


def record(trace_id: Optional[str], where: str,
           stages: Dict[str, float],
           span_id: Optional[str] = None,
           parent: Optional[str] = None,
           dur_ms: Optional[float] = None) -> Optional[TraceRecord]:
    """Record one span for ``trace_id``.  A None id (an untraced legacy
    request) — or tracing disabled — is a no-op, so call sites never
    need to branch.  ``parent`` links this span under another span of
    the same trace; a missing/unknown parent makes it a root."""
    if trace_id is None or not enabled:
        return None
    rec = TraceRecord(trace_id, where, stages, span_id=span_id,
                      parent_id=parent, dur_ms=dur_ms)
    dropped = False
    with _lock:
        if len(_records) == _records.maxlen:
            dropped = True
        _records.append(rec)
    if dropped:
        _count_dropped()
    return rec


class Span:
    """A timed span: created open, recorded into the ring on ``end()``
    (or context-manager exit).  Mutate ``stages`` freely while open."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "stages",
                 "_t0", "_done")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent: Optional[str] = None,
                 stages: Optional[Dict[str, float]] = None):
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_id = parent
        self.stages = dict(stages or {})
        self._t0 = time.monotonic()
        self._done = False

    def child(self, name: str, **stages: float) -> "Span":
        """A new open span under this one (same trace)."""
        return Span(name, trace_id=self.trace_id, parent=self.span_id,
                    stages=stages)

    def end(self) -> Optional[TraceRecord]:
        """Close and record the span; idempotent."""
        if self._done:
            return None
        self._done = True
        return record(self.trace_id, self.name, self.stages,
                      span_id=self.span_id, parent=self.parent_id,
                      dur_ms=(time.monotonic() - self._t0) * 1000.0)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: object) -> None:
        self.end()


def span(name: str, trace_id: Optional[str] = None,
         parent: Optional[str] = None,
         **stages: float) -> Span:
    """Open a span: ``with trace.span("feed.decode", trace_id=tid,
    parent=root) as sp: ...`` — recorded with its wall duration on
    exit."""
    return Span(name, trace_id=trace_id, parent=parent, stages=stages)


def find(trace_id: str) -> List[TraceRecord]:
    """Every recorded span of ``trace_id``, in arrival order."""
    with _lock:
        return [r for r in _records if r.trace_id == trace_id]


def tree(trace_id: str) -> List[SpanNode]:
    """The span tree for ``trace_id``: a list of root :class:`SpanNode`
    (spans whose parent is absent from the ring are roots — eviction or
    a parent recorded in another process degrades gracefully to a
    forest, never an error).  Children keep arrival order."""
    recs = find(trace_id)
    nodes = {r.span_id: SpanNode(r) for r in recs}
    roots: List[SpanNode] = []
    for r in recs:
        node = nodes[r.span_id]
        parent = nodes.get(r.parent_id) if r.parent_id else None
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            roots.append(node)
    return roots


def recent(n: Optional[int] = None) -> List[TraceRecord]:
    with _lock:
        out = list(_records)
    return out if n is None else out[-n:]


def reset() -> None:
    with _lock:
        _records.clear()


def _fmt_stage(v: object) -> str:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return str(v)
    return f"{v:.1f}ms"


def maybe_log_slow(trace_id: Optional[str], what: str, total_ms: float,
                   stages: Dict[str, float]) -> None:
    """One WARNING line for a slow request, with the correlatable id and
    the per-stage breakdown.  Server-side stage spans already in the
    ring for this trace are folded in, so the line localizes the latency
    even when the caller only measured a total."""
    if total_ms < SLOW_MS:
        return
    stages = dict(stages)
    if trace_id is not None:
        for rec in find(trace_id):
            if rec.where.startswith("server."):
                for k, v in rec.stages.items():
                    stages.setdefault(k, v)
    breakdown = ", ".join(f"{k}={_fmt_stage(v)}"
                          for k, v in stages.items())
    logger.warning("slow request %s (trace %s): %.1f ms total [%s]",
                   what, trace_id or "-", total_ms, breakdown)
