# Port of analytics_zoo_tpu/serving/controller.py: a copy with its imports pointed at
# the port, changed where it reaches the model (see "Port" below).
"""Load-adaptive control plane: the ``ServingController`` supervision
loop.

Reference (SURVEY.md §2.3): the reference Cluster Serving leaned on
external supervisors — Kubernetes HPA scaled Flink task managers on CPU
utilisation, and Redis simply queued what the pipeline couldn't absorb.
Neither signal is the one users care about (tail latency vs an SLO), and
neither path could warm a replica before exposing it to traffic.  This
module closes the loop *inside* the serving tier, on the telemetry the
dashboard already exports:

- **signals** — per-tick windowed p99 of ``client.request_ms`` (a
  ``snapshot_delta`` against the previous tick's snapshot, so the p99 is
  of *recent* traffic, not the lifetime histogram) plus the
  ``server.queue_depth`` gauge, scraped cluster-wide over the TCP
  ``metrics`` frame when the replicas live in other processes;
- **decisions** — a pluggable :class:`ScalingPolicy`; the default
  :class:`HysteresisPolicy` scales UP when p99 breaches the SLO or queue
  depth crosses the high-water mark, and DOWN only after ``down_ticks``
  consecutive calm ticks and a cooldown, so a noisy minute never flaps
  the pool;
- **actuation** — scale-up creates a replica through a
  :class:`ReplicaFactory` (in-process :class:`~.server.ClusterServing`
  for tests/bench, a ``zoo-serving`` subprocess for production), which
  warms the model BEFORE :meth:`~.router.ReplicaSet.add_replica` makes
  it routable — no client ever eats a cold compile; scale-down runs the
  zero-error sequence *stop routing → drain → retire* via
  :meth:`~.router.ReplicaSet.remove_replica`, and every scale-down
  decision dumps a flight record naming the retired replica and the
  triggering metric values;
- **hedge retune** — when the router was built with ``hedge_ms="auto"``
  the controller calls :meth:`~.router.ReplicaSet.retune_hedge` every
  tick, so the hedge threshold tracks the observed latency distribution
  instead of a hand-tuned constant.

Deterministic by construction: the loop thread only calls the public
:meth:`ServingController.tick`, so tests drive ticks manually and never
need to sleep through wall-clock intervals.

Port: ``InProcessReplicaFactory`` serves port ``ClusterServing``
instances as the JAX package's does; ``SubprocessReplicaFactory`` starts
``python -m analytics_zoo_tpu_torch.serving.server`` children through the
port's ``core/launcher.py``.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from ..core import faults as faults_lib
from ..core import flightrec
from ..core import metrics as metrics_lib
from .router import ReplicaSet

logger = logging.getLogger("analytics_zoo_tpu")

#: Every constructed controller, weakly: the test-suite leak guard asks
#: :func:`live_controllers` after each test whether someone left a
#: supervision thread running.
_LIVE: "weakref.WeakSet[ServingController]" = weakref.WeakSet()


def live_controllers() -> List["ServingController"]:
    """Controllers whose supervision thread is currently running."""
    return [c for c in _LIVE if c.running]


# -- replica factories ---------------------------------------------------------


class ReplicaHandle:
    """An opaque backend the controller created and may later retire.

    ``host``/``port`` is what joins the router; ``obj`` is whatever the
    factory needs back at retirement (a ``ClusterServing``, a
    ``subprocess.Popen``, ...).
    """

    __slots__ = ("host", "port", "obj")

    def __init__(self, host: str, port: int, obj: Any = None) -> None:
        self.host = host
        self.port = port
        self.obj = obj

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ReplicaHandle({self.name})"


class ReplicaFactory:
    """How the controller obtains (and disposes of) backend capacity.

    ``create()`` must return a handle whose backend is LISTENING and
    WARM — the controller joins it to the router immediately, and the
    router routes to it on the very next request.  ``retire()`` is
    called only after the router has stopped routing to it and drained
    its in-flight requests.
    """

    def create(self) -> ReplicaHandle:
        raise NotImplementedError

    def retire(self, handle: ReplicaHandle) -> None:
        raise NotImplementedError


class InProcessReplicaFactory(ReplicaFactory):
    """Backends are in-process ``ClusterServing`` instances — the
    tests/bench factory.  ``server_factory`` builds ONE server per call;
    it should warm the model (e.g. ``InferenceModel`` with
    ``batch_buckets`` precompiled) before returning, because the replica
    takes traffic as soon as ``create()`` returns.  Servers not yet
    started are started here."""

    def __init__(self, server_factory: Callable[[], Any]) -> None:
        self._server_factory = server_factory

    def create(self) -> ReplicaHandle:
        srv = self._server_factory()
        srv.start()  # idempotent: factories may return started servers
        return ReplicaHandle(srv.host, srv.port, obj=srv)

    def retire(self, handle: ReplicaHandle) -> None:
        handle.obj.stop()


class SubprocessReplicaFactory(ReplicaFactory):
    """Backends are ``zoo-serving`` child processes — the production
    factory behind the CLI's ``--autoscale``.  ``extra_args`` is the
    tail of the child's command line (model flags etc.); the factory
    picks a free port, spawns the child via
    :func:`~..core.launcher.launch_serving_replica`, and blocks until
    the child accepts TCP connections (the CLI warms its model before
    binding traffic threads, so ready implies warm)."""

    def __init__(self, extra_args: Optional[List[str]] = None,
                 host: str = "127.0.0.1",
                 startup_timeout: float = 60.0,
                 grace: float = 10.0) -> None:
        self.extra_args = list(extra_args or [])
        self.host = host
        self.startup_timeout = startup_timeout
        self.grace = grace

    def create(self) -> ReplicaHandle:
        from ..core import launcher
        proc, port = launcher.launch_serving_replica(
            self.extra_args, host=self.host)
        if not launcher.wait_serving_ready(self.host, port, proc=proc,
                                           timeout=self.startup_timeout):
            launcher._terminate_gang([proc], self.grace)
            raise OSError(f"serving replica on port {port} did not become "
                          f"ready within {self.startup_timeout:.0f}s")
        return ReplicaHandle(self.host, port, obj=proc)

    def retire(self, handle: ReplicaHandle) -> None:
        from ..core import launcher
        launcher._terminate_gang([handle.obj], self.grace)


# -- scaling policies ----------------------------------------------------------


class ScalingPolicy:
    """Maps one tick's signals to a replica-count delta (-1, 0, +1).

    ``signals`` carries at least ``replicas`` (current pool size),
    ``p99_ms`` (windowed client p99, ``None`` when the window had no
    traffic), ``queue_depth`` and ``now`` (monotonic seconds, injected
    so tests control time).  Policies are stateful — cooldowns and
    hysteresis live here, not in the controller.
    """

    min_replicas = 1
    max_replicas = 4

    def decide(self, signals: Dict[str, Any]) -> int:
        raise NotImplementedError


class HysteresisPolicy(ScalingPolicy):
    """The default policy: SLO-breach scale-up with hysteresis-guarded
    scale-down.

    UP (+1) when the windowed p99 exceeds ``slo_p99_ms`` or queue depth
    reaches ``queue_high``, at most once per ``up_cooldown_s`` and never
    past ``max_replicas``.  DOWN (-1) only after ``down_ticks``
    CONSECUTIVE ticks that are calm — p99 under ``low_water_frac`` of
    the SLO (an empty window counts as calm: an idle pool shrinks) and
    depth under the same fraction of the high-water mark — and at least
    ``down_cooldown_s`` since the last scale event in either direction,
    so a pool never retires the replica it just added.
    """

    def __init__(self, slo_p99_ms: float,
                 queue_high: Optional[float] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 30.0,
                 low_water_frac: float = 0.5,
                 down_ticks: int = 3) -> None:
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.slo_p99_ms = float(slo_p99_ms)
        self.queue_high = queue_high
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.low_water_frac = float(low_water_frac)
        self.down_ticks = int(down_ticks)
        self._last_event = float("-inf")
        self._calm = 0

    def decide(self, signals: Dict[str, Any]) -> int:
        now = signals.get("now")
        if now is None:
            now = time.monotonic()
        n = int(signals["replicas"])
        p99 = signals.get("p99_ms")
        depth = float(signals.get("queue_depth") or 0.0)
        hot = ((p99 is not None and p99 > self.slo_p99_ms)
               or (self.queue_high is not None
                   and depth >= self.queue_high))
        calm = ((p99 is None or p99 <= self.slo_p99_ms
                 * self.low_water_frac)
                and (self.queue_high is None
                     or depth <= self.queue_high * self.low_water_frac))
        if hot:
            self._calm = 0
            if (n < self.max_replicas
                    and now - self._last_event >= self.up_cooldown_s):
                self._last_event = now
                return 1
            return 0
        if not calm:
            self._calm = 0
            return 0
        self._calm += 1
        if (n > self.min_replicas and self._calm >= self.down_ticks
                and now - self._last_event >= self.down_cooldown_s):
            self._calm = 0
            self._last_event = now
            return -1
        return 0


# -- the controller ------------------------------------------------------------


class ServingController:
    """The supervision loop: observe → decide → actuate, once per
    ``interval_s`` (or per explicit :meth:`tick` in tests).

    The controller only RETIRES replicas it created (or was handed via
    :meth:`adopt`) — seed replicas the application constructed are never
    torn down behind its back.  Signals default to the local registry;
    with ``scrape_cluster=True`` queue depth comes from
    :meth:`~.router.ReplicaSet.cluster_metrics` instead (required when
    replicas are other processes with their own registries).

    Metrics: ``controller.ticks``, ``controller.scale_ups``,
    ``controller.scale_downs``, ``controller.errors``,
    ``controller.degraded`` counters and ``controller.p99_ms`` /
    ``controller.queue_depth`` gauges (the signals as the policy saw
    them).  Every scale-down decision dumps a flight record (reason
    ``scale_down``) naming the retired replica and the triggering
    metrics.

    Degraded mode: ``DEGRADED_AFTER`` (3) CONSECUTIVE tick failures put
    the loop in bounded exponential backoff (doubling per further
    failure, capped at ``MAX_BACKOFF_S``) and dump ONE flight record
    (reason ``controller_degraded``) naming the failing tick stage
    (``observe`` | ``decide`` | ``actuate``) — a persistently broken
    signal source must not burn a tight error loop against the router,
    and the dump, not a silently growing ``controller.errors`` counter,
    is the on-call evidence.  One successful tick restores the normal
    interval.  The ``controller.tick_fail`` injection point
    (core/faults.py) fires at the top of every tick so chaos storms can
    exercise exactly this path.
    """

    #: consecutive tick failures before degraded mode (backoff + dump)
    DEGRADED_AFTER = 3
    #: ceiling on the degraded-mode tick interval, seconds
    MAX_BACKOFF_S = 30.0

    def __init__(self, router: ReplicaSet, factory: ReplicaFactory,
                 policy: Optional[ScalingPolicy] = None,
                 interval_s: float = 1.0,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 scrape_cluster: bool = False,
                 flightrec_dir: Optional[str] = None) -> None:
        self._router = router
        self._factory = factory
        self.policy = policy or HysteresisPolicy(slo_p99_ms=100.0)
        self.interval_s = float(interval_s)
        self._metrics = metrics or metrics_lib.get_registry()
        self._scrape_cluster = scrape_cluster
        self._flightrec_dir = flightrec_dir
        self._managed: Dict[str, ReplicaHandle] = {}
        self._prev: Dict[str, Any] = {}  # last tick's client.request_ms series
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick_lock = threading.Lock()
        #: Scale-event records ({"t", "direction", "replica", "p99_ms",
        #: "queue_depth", "replicas"}) — the bench reads the timestamps.
        self.events: List[Dict[str, Any]] = []
        self._m_ticks = self._metrics.counter("controller.ticks")
        self._m_ups = self._metrics.counter("controller.scale_ups")
        self._m_downs = self._metrics.counter("controller.scale_downs")
        self._m_errors = self._metrics.counter("controller.errors")
        self._m_degraded = self._metrics.counter("controller.degraded")
        self._m_p99 = self._metrics.gauge("controller.p99_ms")
        self._m_depth = self._metrics.gauge("controller.queue_depth")
        self._faults = faults_lib.get_registry()
        #: which tick stage ran last (``observe``/``decide``/``actuate``/
        #: ``idle``) — named by the ``controller_degraded`` flight record
        self._last_stage = "idle"
        #: consecutive failed ticks (0 = healthy); read by tests and the
        #: degraded-mode backoff
        self.consecutive_failures = 0
        _LIVE.add(self)

    # -- lifecycle ------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ServingController":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zoo-serving-controller")
        self._thread.start()
        logger.info("ServingController started (interval=%.2fs, policy=%s)",
                    self.interval_s, type(self.policy).__name__)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the supervision loop.  Replicas the controller created
        stay up (use :meth:`close` to retire them too)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def close(self, retire_managed: bool = True,
              drain_timeout: float = 30.0) -> None:
        """Stop the loop and (by default) retire every replica this
        controller created: remove from the router (drained) when still
        in the pool, then ``factory.retire``."""
        self.stop()
        if not retire_managed:
            return
        for name, handle in list(self._managed.items()):
            try:
                in_pool = any(r.name == name
                              for r in self._router.replicas)
                if in_pool and len(self._router.replicas) > 1:
                    self._router.remove_replica(
                        (handle.host, handle.port), drain=True,
                        timeout=drain_timeout)
            except Exception:  # teardown must not mask the test body
                logger.exception("retiring replica %s from the router "
                                 "failed", name)
            try:
                self._factory.retire(handle)
            except Exception:
                logger.exception("factory.retire(%s) failed", name)
            self._managed.pop(name, None)

    def __enter__(self) -> "ServingController":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def adopt(self, handle: ReplicaHandle) -> None:
        """Hand the controller a replica it did not create, making it
        eligible for scale-down retirement (``factory.retire`` will be
        called on it)."""
        self._managed[handle.name] = handle

    def _loop(self) -> None:
        delay = self.interval_s
        while not self._stop.wait(delay):
            try:
                self.tick()
            except Exception:
                self._m_errors.inc()
                self.consecutive_failures += 1
                logger.exception("controller tick failed (stage=%s, "
                                 "%d consecutive)", self._last_stage,
                                 self.consecutive_failures)
                if self.consecutive_failures >= self.DEGRADED_AFTER:
                    # bounded exponential backoff: a persistently failing
                    # signal source (scrape wedge, dead router) must not
                    # burn a tight error loop; double per further failure
                    delay = min(
                        self.interval_s
                        * 2 ** (self.consecutive_failures
                                - self.DEGRADED_AFTER + 1),
                        self.MAX_BACKOFF_S)
                    if self.consecutive_failures == self.DEGRADED_AFTER:
                        # ONE dump per degradation episode, at entry —
                        # the on-call evidence, not a dump per failure
                        self._m_degraded.inc()
                        flightrec.dump(
                            "controller_degraded",
                            dump_dir=self._flightrec_dir,
                            extra={"stage": self._last_stage,
                                   "consecutive_failures":
                                       self.consecutive_failures,
                                   "backoff_s": delay,
                                   "replicas":
                                       len(self._router.replicas)})
                        logger.warning(
                            "controller degraded: %d consecutive tick "
                            "failures (stage=%s); backing off to %.2fs",
                            self.consecutive_failures, self._last_stage,
                            delay)
                continue
            if self.consecutive_failures:
                logger.info("controller recovered after %d failed "
                            "tick(s)", self.consecutive_failures)
            self.consecutive_failures = 0
            delay = self.interval_s

    # -- observe --------------------------------------------------------------

    def signals(self) -> Dict[str, Any]:
        """One tick's view of the world: windowed client p99, queue
        depth, pool size.  The latency window is this tick's
        ``snapshot_delta`` over ``client.request_ms`` — the baseline
        ALWAYS advances, so each tick judges only traffic since the
        last one."""
        snap = self._metrics.snapshot()
        cur = {s: v for s, v in snap.items()
               if metrics_lib._parse_series(s)[0] == "client.request_ms"}
        delta = metrics_lib.snapshot_delta(self._prev, cur)
        self._prev = cur
        window = metrics_lib.MetricsRegistry.merge(
            [{"client.request_ms": v} for v in delta.values()],
            drop_labels=("replica",)).get("client.request_ms")
        count = int((window or {}).get("count", 0))
        p99 = (metrics_lib.quantile_from_snapshot(window, 0.99)
               if count else None)
        if self._scrape_cluster:
            cm = self._router.cluster_metrics()
            depth = float((cm.get("server.queue_depth") or {})
                          .get("value", 0.0))
        else:
            depth = float((snap.get("server.queue_depth") or {})
                          .get("value", 0.0))
        return {"now": time.monotonic(), "p99_ms": p99,
                "queue_depth": depth,
                "replicas": len(self._router.replicas),
                "window_requests": count}

    # -- decide + actuate -----------------------------------------------------

    def tick(self) -> int:
        """One observe→decide→actuate round.  Returns the policy's
        decision (-1, 0, +1) — tests call this directly for
        deterministic control flow."""
        with self._tick_lock:
            self._last_stage = "observe"
            # ``controller.tick_fail`` (core/faults.py): an armed fault
            # fails the whole tick — the seam chaos storms use to prove
            # the degraded-mode backoff above survives a broken tick
            self._faults.raise_if("controller.tick_fail")
            sig = self.signals()
            self._m_p99.set(sig["p99_ms"] if sig["p99_ms"] is not None
                            else 0.0)
            self._m_depth.set(sig["queue_depth"])
            if self._router.hedge_auto:
                self._router.retune_hedge()
            self._last_stage = "decide"
            decision = self.policy.decide(sig)
            self._last_stage = "actuate"
            if decision > 0:
                self._scale_up(sig)
            elif decision < 0:
                self._scale_down(sig)
            self._m_ticks.inc()
            self._last_stage = "idle"
            return decision

    def _event(self, direction: str, replica: str,
               sig: Dict[str, Any]) -> None:
        self.events.append({"t": time.time(), "direction": direction,
                            "replica": replica, "p99_ms": sig["p99_ms"],
                            "queue_depth": sig["queue_depth"],
                            "replicas": len(self._router.replicas)})

    def _scale_up(self, sig: Dict[str, Any]) -> None:
        try:
            handle = self._factory.create()  # listening AND warm
        except Exception:
            self._m_errors.inc()
            logger.exception("scale-up: replica creation failed")
            return
        try:
            rep = self._router.add_replica((handle.host, handle.port))
        except Exception:
            self._m_errors.inc()
            logger.exception("scale-up: join failed; retiring %s",
                             handle.name)
            try:
                self._factory.retire(handle)
            except Exception:
                logger.exception("factory.retire(%s) failed", handle.name)
            return
        self._managed[rep.name] = handle
        self._m_ups.inc()
        self._event("up", rep.name, sig)
        logger.info("scaled UP: %s joined (p99=%s ms, depth=%.0f)",
                    rep.name, sig["p99_ms"], sig["queue_depth"])

    def _scale_down(self, sig: Dict[str, Any]) -> None:
        victims = [r for r in self._router.replicas
                   if r.name in self._managed]
        if not victims:
            logger.debug("scale-down requested but no managed replica "
                         "is in the pool; skipping")
            return
        victim = min(victims, key=lambda r: r.pending)
        # decision record FIRST: the dump must exist even if the drain
        # or retirement below misbehaves
        flightrec.dump("scale_down", dump_dir=self._flightrec_dir,
                       extra={"replica": victim.name,
                              "p99_ms": sig["p99_ms"],
                              "queue_depth": sig["queue_depth"],
                              "replicas": sig["replicas"],
                              "window_requests": sig["window_requests"]})
        try:
            self._router.remove_replica(victim, drain=True)
        except ValueError:
            self._m_errors.inc()
            logger.exception("scale-down: removing %s failed", victim.name)
            return
        handle = self._managed.pop(victim.name, None)
        if handle is not None:
            try:
                self._factory.retire(handle)
            except Exception:
                self._m_errors.inc()
                logger.exception("factory.retire(%s) failed", victim.name)
        self._m_downs.inc()
        self._event("down", victim.name, sig)
        logger.info("scaled DOWN: %s retired (p99=%s ms, depth=%.0f)",
                    victim.name, sig["p99_ms"], sig["queue_depth"])
