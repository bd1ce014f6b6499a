# Port of analytics_zoo_tpu/core/faults.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Deterministic fault injection for resilience tests.

MLPerf-scale TPU pods treat transient host/network faults as routine, and
the TensorFlow system paper makes the point directly: fault tolerance must
be a first-class subsystem with *injectable* faults, not an emergent
property.  This module is the injection side of that contract — a seedable
registry of named injection points that production code calls at its
failure-prone seams.  Disabled (the default) a hit is a dict lookup and a
counter bump; tests (or a ZooConfig) arm individual points with a bounded
fire count, a seeded probability, a delay, or an exception.

Registered points (new subsystems add theirs via ``register_point``):

- ``serving.conn_drop``      server closes a client connection mid-request
- ``serving.model_latency``  extra latency before a serving batch runs
- ``serving.queue_reject``   serving queue push rejected ("queue full")
- ``serving.health_fail``    server swallows a health ping (no pong)
- ``serving.replica_down``   serving replica dies hard (SIGKILL-equivalent)
- ``checkpoint.write_fail``  transient checkpoint write failure (OSError)
- ``checkpoint.slow_write``  async checkpoint writer stalls before writing
- ``feed.stall``             data feed stalls before yielding a batch
- ``feed.read_fail``         one sample-loader read fails (streaming feed)
- ``worker.crash``           training worker dies hard (os._exit) mid-step
- ``worker.hang``            training worker wedges (long sleep) mid-step
- ``step.nan``               one train batch is poisoned to non-finite
- ``batch.shard_fail``       one batch-scoring shard fails before scoring
- ``serving.slow_wire``      per-frame send/recv jitter on the wire protocol
- ``serving.net_partition``  replica's client conns severed, process lives
- ``controller.tick_fail``   one autoscaler tick raises mid-observe
- ``registry.swap_fail``     hot swap raises mid-warm, before the flip

Usage in a test::

    from analytics_zoo_tpu_torch.core import faults
    with faults.get_registry().armed("serving.queue_reject", times=2):
        ...  # first two queue pushes are rejected, then normal service

Usage at an injection point (production code)::

    faults.get_registry().raise_if("checkpoint.write_fail")   # raising
    if faults.get_registry().fire("serving.queue_reject"):    # control flow
        ok = False

Determinism: probabilistic faults draw from a ``random.Random(seed)`` owned
by the spec, so two runs with the same seed fire on exactly the same hits —
never from global random state.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple, Type

logger = logging.getLogger("analytics_zoo_tpu")

#: The framework's known injection points.  ``enable()`` rejects names not
#: in this set so a typo in a test arms nothing silently.
KNOWN_POINTS = {
    "serving.conn_drop",
    "serving.model_latency",
    "serving.queue_reject",
    "serving.health_fail",
    "serving.replica_down",
    "checkpoint.write_fail",
    "checkpoint.slow_write",
    "feed.stall",
    "feed.read_fail",
    "worker.crash",
    "worker.hang",
    "step.nan",
    "batch.shard_fail",
    "serving.slow_wire",
    "serving.net_partition",
    "controller.tick_fail",
    "registry.swap_fail",
}

#: Guards KNOWN_POINTS mutation: the chaos scheduler (core/chaos.py) arms
#: points from its own thread while subsystems register theirs at import
#: time and conn threads read the set through ``enable`` — a bare
#: ``set.add`` racing an ``enable`` membership check is a torn read under
#: free-threaded builds, and two concurrent registrations must both win.
_POINTS_LOCK = threading.Lock()


def register_point(name: str) -> str:
    """Add a new injection point name (for subsystems grown later).
    Thread-safe and idempotent; returns the name so it can be used as a
    module constant."""
    if not name or not isinstance(name, str):
        raise ValueError(f"injection point name must be a non-empty "
                         f"string, got {name!r}")
    with _POINTS_LOCK:
        KNOWN_POINTS.add(name)
    return name


class _Spec:
    """Armed state of one injection point."""

    __slots__ = ("times", "prob", "exc", "message", "delay", "after", "rng")

    def __init__(self, times: Optional[int], prob: float,
                 exc: Optional[Type[BaseException]], message: Optional[str],
                 delay: float, after: int, seed: int):
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1 or None, got {times}")
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {prob}")
        if after < 0:
            raise ValueError(f"after must be >= 0, got {after}")
        self.times = times          # remaining fires; None = unlimited
        self.prob = prob
        self.exc = exc
        self.message = message
        self.delay = delay
        self.after = after          # hits to pass through before eligibility
        self.rng = random.Random(seed)


class FaultRegistry:
    """Thread-safe registry of armed faults + per-point hit/fire counters.

    One process-global instance (``get_registry()``) serves the default
    wiring; components accept an explicit registry for isolation."""

    #: Bound on the ordered fired-event log — a long soak with an
    #: unlimited-``times`` point must not grow memory without limit.
    #: Old events are dropped oldest-first past the cap (the sequence
    #: numbers stay monotonic so consumers can detect the truncation).
    MAX_FIRED_EVENTS = 65536

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._specs: Dict[str, _Spec] = {}
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        # ordered (seq, point) log of every firing — the reproducibility
        # evidence a seeded chaos storm (core/chaos.py) is asserted on:
        # two runs with the same seed must produce the identical sequence
        self._events: List[Tuple[int, str]] = []
        self._event_seq = 0
        # chaos schedules currently attached to this registry (weak:
        # an abandoned schedule object must not be kept alive by the
        # leak-check bookkeeping itself)
        self._schedules: "weakref.WeakSet" = weakref.WeakSet()

    # -- arming ---------------------------------------------------------------

    def enable(self, name: str, *, times: Optional[int] = None,
               prob: float = 1.0, exc: Optional[Type[BaseException]] = None,
               message: Optional[str] = None, delay: float = 0.0,
               after: int = 0, seed: int = 0) -> None:
        """Arm ``name``: fire on the next ``times`` matching hits (None =
        every hit), each hit firing with probability ``prob`` drawn from a
        ``seed``-ed RNG.  A firing hit sleeps ``delay`` seconds and, if
        ``exc`` is set, raises ``exc(message)``.  ``after`` lets the first
        ``after`` hits pass through untouched — "crash on step K" is
        ``enable("worker.crash", times=1, after=K-1)``."""
        with _POINTS_LOCK:  # consistent read against register_point
            known = name in KNOWN_POINTS
        if not known:
            raise ValueError(
                f"unknown injection point {name!r}; known points: "
                f"{sorted(KNOWN_POINTS)} (add new ones via register_point)")
        with self._lock:
            self._specs[name] = _Spec(times, prob, exc, message, delay,
                                      after, seed)
        # telemetry mirror (core/metrics.py): resilience tests can assert
        # arming/firing via public metrics instead of private state
        from . import metrics as metrics_lib
        metrics_lib.get_registry().inc("faults.armed", point=name)

    def disable(self, name: str) -> None:
        with self._lock:
            self._specs.pop(name, None)

    def reset(self) -> None:
        """Disarm every point and zero the counters + fired-event log."""
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()
            self._events.clear()
            self._event_seq = 0

    @contextlib.contextmanager
    def armed(self, name: str, **kwargs: Any) -> Iterator["FaultRegistry"]:
        """``with registry.armed("serving.conn_drop", times=1): ...`` —
        scoped enable/disable for tests."""
        self.enable(name, **kwargs)
        try:
            yield self
        finally:
            self.disable(name)

    def configure(self, mapping: Optional[Dict[str, Dict[str, Any]]]) -> None:
        """Arm points from a config dict, e.g. ZooConfig.faults =
        ``{"serving.queue_reject": {"times": 3, "seed": 7}}``.  Exception
        types may be given by name ("OSError")."""
        import builtins
        for name, kw in (mapping or {}).items():
            kw = dict(kw)
            exc = kw.get("exc")
            if isinstance(exc, str):
                resolved = getattr(builtins, exc, None)
                if not (isinstance(resolved, type)
                        and issubclass(resolved, BaseException)):
                    raise ValueError(f"faults config: {exc!r} is not an "
                                     f"exception type")
                kw["exc"] = resolved
            self.enable(name, **kw)

    # -- injection points -----------------------------------------------------

    def fire(self, name: str) -> bool:
        """One hit on point ``name``; True iff the fault fires.  A firing
        hit consumes one ``times`` charge and sleeps the spec's ``delay``
        (outside the lock).  Disarmed points cost a lock + two dict ops."""
        delay = 0.0
        fired = False
        with self._lock:
            self._hits[name] = self._hits.get(name, 0) + 1
            spec = self._specs.get(name)
            if spec is not None and spec.after > 0:
                spec.after -= 1
                spec = None         # this hit passes through untouched
            if spec is not None and (spec.prob >= 1.0
                                     or spec.rng.random() < spec.prob):
                fired = True
                delay = spec.delay
                self._fired[name] = self._fired.get(name, 0) + 1
                self._log_event(name)
                if spec.times is not None:
                    spec.times -= 1
                    if spec.times <= 0:
                        del self._specs[name]
        if fired:
            logger.debug("fault %s fired", name)
            from . import metrics as metrics_lib
            metrics_lib.get_registry().inc("faults.fired", point=name)
            if delay > 0:
                time.sleep(delay)
        return fired

    def raise_if(self, name: str,
                 default_exc: Type[BaseException] = RuntimeError) -> None:
        """One hit on ``name``; raises the armed exception type if it fires.

        ``default_exc``: what to raise when the armed spec names no ``exc``
        — the CALL SITE knows which failure mode it simulates (e.g. the
        checkpoint writer passes OSError so a config-armed fault exercises
        the same except-clause a real filesystem blip would)."""
        with self._lock:
            spec = self._specs.get(name)
            exc = (spec.exc if spec is not None and spec.exc is not None
                   else default_exc)
            message = (spec.message if spec is not None else None) \
                or f"injected fault: {name}"
        if self.fire(name):
            raise exc(message)

    def absorb(self, name: str, hits: int = 0, fired: int = 0) -> None:
        """Fold hit/fire counts observed in FORKED worker processes back
        into this (parent) registry.  A forked child inherits the armed
        specs copy-on-write, so its fire decisions are deterministic but
        its counter updates and ``times`` charges land in the child's
        copy only — the streaming feed's process backend mirrors them
        through shared memory and calls this at epoch end, so
        ``fired()``, the ``faults.fired`` metric, and auto-disarm on an
        exhausted ``times`` budget stay coherent with the thread
        backend.  (With several children each holding its own copy of a
        bounded spec the total can overshoot ``times``; the budget is
        consumed by the TOTAL fired count, clamped at disarm.)"""
        if hits <= 0 and fired <= 0:
            return
        with self._lock:
            if hits > 0:
                self._hits[name] = self._hits.get(name, 0) + hits
            if fired > 0:
                self._fired[name] = self._fired.get(name, 0) + fired
                # the child's intra-process firing order is lost by the
                # counter mirror; the events land at absorb time, in
                # absorb order — ordering across forked workers is a
                # per-process property, not a cross-process one
                for _ in range(fired):
                    self._log_event(name)
                spec = self._specs.get(name)
                if spec is not None and spec.times is not None:
                    spec.times -= fired
                    if spec.times <= 0:
                        del self._specs[name]
        if fired > 0:
            from . import metrics as metrics_lib
            metrics_lib.get_registry().inc("faults.fired", fired,
                                           point=name)

    def _log_event(self, name: str) -> None:
        """Append one firing to the ordered event log (lock held)."""
        self._event_seq += 1
        self._events.append((self._event_seq, name))
        if len(self._events) > self.MAX_FIRED_EVENTS:
            del self._events[:len(self._events) - self.MAX_FIRED_EVENTS]

    # -- chaos-schedule bookkeeping -------------------------------------------

    def attach_schedule(self, schedule: Any) -> None:
        """Record a chaos schedule (core/chaos.py) driving this registry,
        weakly, so leak checks can see schedules still running after a
        test body finished.  Idempotent."""
        with self._lock:
            self._schedules.add(schedule)

    def running_schedules(self) -> List[Any]:
        """Every attached schedule object whose ``running`` is truthy —
        the conftest leak guard stops (and fails on) these."""
        with self._lock:
            scheds = list(self._schedules)
        return [s for s in scheds if getattr(s, "running", False)]

    def schedule_state(self) -> List[str]:
        """Sorted human-readable descriptions of the RUNNING attached
        schedules (empty = nothing running; the leak-clean state)."""
        return sorted(str(getattr(s, "name", None) or repr(s))
                      for s in self.running_schedules())

    # -- observability --------------------------------------------------------

    def hits(self, name: str) -> int:
        """How many times the point was reached (armed or not)."""
        with self._lock:
            return self._hits.get(name, 0)

    def fired(self, name: str) -> int:
        """How many times the point actually fired."""
        with self._lock:
            return self._fired.get(name, 0)

    def fired_events(self, points: Optional[Any] = None) -> List[str]:
        """Point names in the ORDER they fired (the seeded-storm
        reproducibility evidence: same seed + same traffic shape ⇒ the
        identical sequence).  ``points`` (an iterable of names) filters
        to just those points — the usual call passes a storm's point
        list so unrelated background firings don't pollute the
        comparison.  Bounded by :data:`MAX_FIRED_EVENTS` oldest-first."""
        with self._lock:
            events = list(self._events)
        if points is not None:
            keep = set(points)
            return [name for _, name in events if name in keep]
        return [name for _, name in events]

    def is_armed(self, name: str) -> bool:
        with self._lock:
            return name in self._specs

    def armed_points(self) -> list:
        """Sorted names of every currently armed point (leak checks: a test
        that arms without the scoped helper must disarm before it ends)."""
        with self._lock:
            return sorted(self._specs)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """{point: {"hits": n, "fired": m}} for every point ever reached."""
        with self._lock:
            return {name: {"hits": self._hits.get(name, 0),
                           "fired": self._fired.get(name, 0)}
                    for name in set(self._hits) | set(self._fired)}


_REGISTRY = FaultRegistry()


def get_registry() -> FaultRegistry:
    """The process-global registry, the default wiring of every injection
    point in the framework."""
    return _REGISTRY
