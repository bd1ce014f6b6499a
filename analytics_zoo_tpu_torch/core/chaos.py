# Port of analytics_zoo_tpu/core/chaos.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Deterministic chaos-sweep harness: seeded multi-fault storms + a
system-wide invariant checker.

Every injection point in core/faults.py is exercised one at a time by
targeted resilience tests, but production failures are CORRELATED — a
replica dies while the wire is slow, while the autoscaler is mid-tick,
while a batch job is resuming and an upgrade is mid-warm.  The TensorFlow
systems paper (PAPERS.md) argues fault tolerance must be a first-class
dataflow property, and TPU serving practice (the Gemma-on-Cloud-TPU
deployment, PAPERS.md) treats overload and partial failure as steady
state.  This module is the harness that proves the stack holds under
that steady state:

- :class:`ChaosSchedule` composes fault points into a **seeded,
  time-ordered storm**: the full timeline (which point, when, armed with
  what parameters) is computed from ``seed`` alone at construction, so
  two storms with the same seed arm the identical schedule — and, with
  ``max_concurrent=1`` and windows sized so every armed budget fires
  fully, produce the identical ordered firing sequence in
  ``FaultRegistry.fired_events()``.
- :class:`InvariantChecker` continuously asserts the conservation laws
  the codebase documents piecemeal: per-replica request conservation
  (``requests == replies + errors + pending``), zero client-visible
  failures while >=1 replica is routable, batch-journal row-exactness,
  no stale-version predictions after a swap flip, registry metric/series
  coherence, and no leaked threads/shm/fds at teardown.

Usage (the acceptance-test shape)::

    checker = InvariantChecker(servers=[s1, s2], router=rs)
    checker.start()
    storm = ChaosSchedule(seed=7, duration_s=8.0,
                          points=["serving.slow_wire",
                                  "serving.replica_down",
                                  "serving.net_partition"])
    with storm:                      # arms points on the storm's clock
        ...  # drive traffic, run the batch job, swap mid-storm
    checker.stop()
    checker.assert_ok()
    seq = storm.fired_sequence()     # replay evidence: same seed -> same seq

Telemetry: ``chaos.events`` counts armed storm events.  A running
schedule registers itself with the fault registry
(``FaultRegistry.attach_schedule``) so the conftest leak guard fails any
test that leaks a live storm.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import faults as faults_lib
from . import metrics as metrics_lib

logger = logging.getLogger("analytics_zoo_tpu")


@dataclass
class ChaosEvent:
    """One storm event: arm ``point`` with ``kwargs`` at offset ``t``
    seconds, disarm (if the fire budget didn't already self-disarm) at
    ``t + duration_s``."""

    idx: int
    t: float
    duration_s: float
    point: str
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        kw = {k: (v.__name__ if isinstance(v, type) else v)
              for k, v in self.kwargs.items()}
        return {"idx": self.idx, "t": round(self.t, 4),
                "duration_s": round(self.duration_s, 4),
                "point": self.point, "kwargs": kw}


class ChaosSchedule:
    """A seeded, time-ordered storm of fault-point armings.

    The plan is fully determined by the constructor arguments — built
    once from ``random.Random(seed)``, never from wall-clock state — so
    ``ChaosSchedule(seed=7, ...).plan`` is byte-identical across runs
    and the seed printed in a failing test's output reproduces the
    exact storm.  ``start()`` replays the plan against the fault
    registry from a background thread; each event arms its point with a
    bounded fire budget (so points self-disarm once consumed) and the
    scheduler disarms whatever is left when the event's window closes.

    ``points`` cycles round-robin through the storm (every point gets
    scheduled even in short storms); ``max_concurrent`` bounds how many
    events' windows may overlap — ``1`` serializes the storm, which
    (with windows long enough for every budget to fire) makes the
    ordered firing sequence itself deterministic, the property THE
    acceptance test replays.  Two windows of the SAME point never
    overlap regardless (arming twice would overwrite the first spec).

    ``point_params`` overrides the generated enable() kwargs per point,
    e.g. ``{"serving.slow_wire": {"times": 20, "delay": 0.002}}``.
    """

    #: generated per-event window length bounds (seconds)
    WINDOW_RANGE = (0.6, 1.4)
    #: generated gap between consecutive event STARTS (seconds)
    GAP_RANGE = (0.15, 0.6)

    def __init__(self, seed: int, duration_s: float,
                 points: Sequence[str], max_concurrent: int = 2,
                 point_params: Optional[Dict[str, Dict[str, Any]]] = None,
                 registry: Optional[faults_lib.FaultRegistry] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 name: Optional[str] = None):
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        if not points:
            raise ValueError("a storm needs at least one fault point")
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}")
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.points = list(points)
        self.max_concurrent = int(max_concurrent)
        self.name = name or f"chaos-seed{self.seed}"
        self._point_params = {k: dict(v)
                              for k, v in (point_params or {}).items()}
        self._registry = registry or faults_lib.get_registry()
        self._metrics = metrics or metrics_lib.get_registry()
        self._m_events = self._metrics.counter("chaos.events")
        unknown = [p for p in self.points
                   if p not in faults_lib.KNOWN_POINTS]
        if unknown:
            raise ValueError(
                f"unknown fault point(s) {unknown}; known: "
                f"{sorted(faults_lib.KNOWN_POINTS)}")
        self.plan: List[ChaosEvent] = self._build_plan()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: events actually armed so far (monotonic append; read by tests)
        self.armed_log: List[ChaosEvent] = []

    # -- plan ------------------------------------------------------------------

    def _default_kwargs(self, point: str,
                        rng: random.Random) -> Dict[str, Any]:
        """Generated enable() parameters per point class.  Every spec
        carries its own derived seed so probabilistic points replay."""
        spec_seed = rng.randrange(1 << 30)
        if point == "serving.slow_wire":
            # jitter fires on a handful of frames per window; the delay
            # is visible in p99 but never near a request timeout
            return {"times": rng.randint(4, 10),
                    "delay": round(rng.uniform(0.005, 0.03), 4),
                    "seed": spec_seed}
        if point == "serving.model_latency":
            return {"times": rng.randint(1, 3),
                    "delay": round(rng.uniform(0.01, 0.05), 4),
                    "seed": spec_seed}
        if point == "checkpoint.slow_write":
            # wedge the background checkpoint writer, never the step
            # loop: long enough to overlap the next trigger (so the
            # in-flight policy is exercised), short enough to drain
            # inside the window
            return {"times": rng.randint(1, 3),
                    "delay": round(rng.uniform(0.02, 0.1), 4),
                    "seed": spec_seed}
        if point == "checkpoint.write_fail":
            # enough consecutive failures to exhaust the save's retry
            # budget at least once, so the writer's error path (forced
            # full, tip rewind) runs — not just a retried blip
            return {"times": rng.randint(2, 4), "seed": spec_seed}
        if point == "controller.tick_fail":
            # >= DEGRADED_AFTER consecutive failures so storms exercise
            # the degraded-mode backoff, bounded so the loop recovers
            # inside the window
            return {"times": rng.randint(3, 5), "seed": spec_seed}
        if point in ("serving.replica_down", "serving.net_partition",
                     "serving.conn_drop", "registry.swap_fail"):
            return {"times": 1, "seed": spec_seed}
        return {"times": 1, "seed": spec_seed}

    def _build_plan(self) -> List[ChaosEvent]:
        rng = random.Random(self.seed)
        events: List[ChaosEvent] = []
        # (start, end) windows already planned, for the concurrency bound
        windows: List[Tuple[float, float, str]] = []
        t = 0.0
        idx = 0
        while True:
            t += rng.uniform(*self.GAP_RANGE)
            if t >= self.duration_s:
                break
            point = self.points[idx % len(self.points)]
            t = round(t, 4)  # the plan publishes 4 decimals; keep the
            dur = round(rng.uniform(*self.WINDOW_RANGE), 4)  # books equal
            # push the start past older windows until (a) fewer than
            # max_concurrent overlap and (b) no window of the SAME point
            # overlaps — deterministic because it only reads the plan
            while True:
                live = [(s, e, p) for s, e, p in windows if e > t]
                same = [e for s, e, p in live if p == point]
                if len(live) >= self.max_concurrent:
                    t = min(e for s, e, p in live)
                    continue
                if same:
                    t = min(same)
                    continue
                break
            if t >= self.duration_s:
                break
            kwargs = self._default_kwargs(point, rng)
            kwargs.update(self._point_params.get(point, {}))
            events.append(ChaosEvent(idx=idx, t=t, duration_s=dur,
                                     point=point, kwargs=kwargs))
            windows.append((t, t + dur, point))
            idx += 1
        return events

    def describe(self) -> Dict[str, Any]:
        """The storm as data — logged by the bench so a recorded seed
        plus this dict is a complete replay recipe."""
        return {"name": self.name, "seed": self.seed,
                "duration_s": self.duration_s, "points": self.points,
                "max_concurrent": self.max_concurrent,
                "events": [e.to_dict() for e in self.plan]}

    # -- lifecycle -------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ChaosSchedule":
        if self.running:
            return self
        self._stop.clear()
        self._registry.attach_schedule(self)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"zoo-{self.name}")
        self._thread.start()
        logger.info("chaos storm %s started: %d event(s) over %.1fs",
                    self.name, len(self.plan), self.duration_s)
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the storm finishes replaying its plan; True iff
        it finished within ``timeout``."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout)
        return not t.is_alive()

    def stop(self) -> None:
        """Stop the storm and disarm every storm point that is still
        armed.  Idempotent; always leaves the registry storm-clean."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None
        for p in self.points:
            if self._registry.is_armed(p):
                self._registry.disable(p)

    def __enter__(self) -> "ChaosSchedule":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- the storm loop --------------------------------------------------------

    def _run(self) -> None:
        t0 = time.monotonic()
        active: List[Tuple[float, ChaosEvent]] = []  # (end, event)
        i = 0
        try:
            while not self._stop.is_set():
                now = time.monotonic()
                # close expired windows (budget may have self-disarmed)
                still: List[Tuple[float, ChaosEvent]] = []
                for end, ev in active:
                    if now >= end:
                        self._registry.disable(ev.point)
                    else:
                        still.append((end, ev))
                active = still
                if i >= len(self.plan) and not active:
                    return
                wake: List[float] = [end for end, _ in active]
                if i < len(self.plan):
                    wake.append(t0 + self.plan[i].t)
                next_t = min(wake) if wake else None
                if next_t is not None and next_t > now:
                    if self._stop.wait(next_t - now):
                        return
                if i < len(self.plan) \
                        and time.monotonic() >= t0 + self.plan[i].t:
                    ev = self.plan[i]
                    self._registry.enable(ev.point, **ev.kwargs)
                    self.armed_log.append(ev)
                    self._m_events.inc()
                    logger.debug("storm %s: armed %s (%s)", self.name,
                                 ev.point, ev.kwargs)
                    active.append((t0 + ev.t + ev.duration_s, ev))
                    i += 1
        finally:
            # whatever happened, never leak an armed storm point
            for _, ev in active:
                self._registry.disable(ev.point)

    # -- evidence --------------------------------------------------------------

    def fired_sequence(self) -> List[str]:
        """The ordered storm-point firing sequence observed so far —
        the replay evidence THE acceptance test compares across two
        same-seed runs."""
        return self._registry.fired_events(points=self.points)

    def report(self) -> Dict[str, Any]:
        """Per-point armed/hit/fired accounting plus the sequence."""
        return {
            "name": self.name, "seed": self.seed,
            "events_armed": len(self.armed_log),
            "events_planned": len(self.plan),
            "per_point": {p: {"hits": self._registry.hits(p),
                              "fired": self._registry.fired(p)}
                          for p in self.points},
            "fired_sequence": self.fired_sequence(),
        }


class InvariantChecker:
    """Continuously asserted system-wide conservation laws.

    The checker watches a live topology — in-process
    :class:`~analytics_zoo_tpu_torch.serving.server.ClusterServing` objects, a
    :class:`~analytics_zoo_tpu_torch.serving.router.ReplicaSet`, a
    :class:`~analytics_zoo_tpu_torch.serving.model_registry.ModelRegistry` —
    and records VIOLATIONS (strings naming the broken law and the
    evidence) instead of raising mid-storm, so one broken invariant
    can't mask the rest.  ``assert_ok()`` raises at the end with the
    full list.

    Invariant catalog (docs/robustness.md "Chaos sweeps"):

    1. **Request conservation** per replica: ``replies + errors`` never
       exceeds ``requests`` (continuously), and at quiescence a
       still-serving replica satisfies
       ``requests == replies + errors + pending`` exactly.  A killed or
       partitioned replica is exempt from the exact form — its in-flight
       work died with its sockets, which is precisely the failure the
       router's failover re-enqueue absorbs.
    2. **Routable availability**: a client-visible failure while the
       router still had >=1 routable replica is a violation
       (:meth:`note_client_error` feeds these in).
    3. **Batch row-exactness**: the journal's shard ranges tile
       ``[0, n_rows)`` exactly — no lost and no duplicated rows across
       kills + resumes (:meth:`check_batch_job`).
    4. **Swap atomicity / no stale versions**: after a flip recorded by
       the registry's swap hook, the active version must be the flip's
       target; a failed swap must leave the old version active
       (:meth:`watch_registry`, :meth:`check_registry`).
    5. **Metric/series coherence**: the ``faults.fired`` telemetry
       mirror equals the fault registry's own counts; ``registry.swaps``
       equals the number of observed flips.
    6. **No leaked threads / fds / shm** at teardown:
       :meth:`baseline` before the topology comes up,
       :meth:`assert_teardown` after it is torn down.
    7. **Manifest consistency**: every generation visible in
       a checkpoint manager's ``MANIFEST.jsonl`` is complete and
       crc-clean, and no base+delta restore chain was broken by GC —
       asserted after kill/write-fail storms against the async writer
       (:meth:`check_manifest`).
    """

    def __init__(self, servers: Sequence[Any] = (),
                 router: Optional[Any] = None,
                 faults: Optional[faults_lib.FaultRegistry] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 interval_s: float = 0.05):
        self._servers: List[Any] = list(servers)
        self._router = router
        self._faults = faults or faults_lib.get_registry()
        self._metrics = metrics or metrics_lib.get_registry()
        self.interval_s = float(interval_s)
        self.violations: List[str] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._checks = 0
        # registries under watch: (registry, model name, flips list)
        self._watched: List[Tuple[Any, str, List[Dict[str, Any]]]] = []
        # ``registry.swaps`` when watching began: the counter is
        # process-global and cumulative, so coherence is a DELTA check
        self._swaps_base: Optional[float] = None
        # ``faults.fired`` mirror baselines (metric value, registry
        # count) per point at construction — the metric registry is
        # process-global while the fault registry is reset per storm
        # run, so coherence compares GROWTH on both sides
        self._fired_base: Dict[str, Tuple[float, int]] = {}
        for series, val in self._metrics.snapshot().items():
            base, labels = metrics_lib._parse_series(series)
            if base != "faults.fired":
                continue
            point = dict(labels).get("point")
            if point:
                v = val.get("value", 0) if isinstance(val, dict) else val
                self._fired_base[point] = (float(v),
                                           self._faults.fired(point))

    # -- topology --------------------------------------------------------------

    def add_server(self, server: Any) -> Any:
        """Track a replica created after the checker started (the
        autoscaler's factory calls this for scale-ups).  Returns the
        server so it wraps a factory expression."""
        with self._lock:
            self._servers.append(server)
        return server

    def watch_registry(self, registry: Any,
                       name: Optional[str] = None) -> None:
        """Record every swap flip on ``registry`` (via its swap hook)
        so :meth:`check_registry` can assert flip/metric coherence and
        no-stale-active post-conditions."""
        from analytics_zoo_tpu_torch.serving.model_registry import ModelRegistry
        name = name or ModelRegistry.DEFAULT
        flips: List[Dict[str, Any]] = []

        def hook(n: str, old: Any, new: Any) -> None:
            flips.append({"name": n, "old": old, "new": new,
                          "t": time.monotonic()})

        registry.on_swap(hook)
        with self._lock:
            if self._swaps_base is None:
                snap = self._metrics.snapshot()
                base = snap.get("registry.swaps", 0)
                self._swaps_base = float(
                    base.get("value", 0) if isinstance(base, dict)
                    else base)
            self._watched.append((registry, name, flips))

    def flips(self) -> List[Dict[str, Any]]:
        """Every swap flip observed across watched registries."""
        with self._lock:
            return [f for _, _, fl in self._watched for f in fl]

    # -- violations ------------------------------------------------------------

    def _violate(self, law: str, detail: str) -> None:
        msg = f"[{law}] {detail}"
        with self._lock:
            # dedupe: a persistent breach is one violation, not one per
            # 50ms poll
            if msg not in self.violations:
                self.violations.append(msg)
                logger.warning("invariant violated: %s", msg)

    def note_client_error(self, error: Any) -> None:
        """Feed one client-visible failure (exception or timeout) in;
        a failure while >=1 replica was routable breaks invariant 2."""
        routable = None
        if self._router is not None:
            try:
                hz = self._router.healthz()
                routable = sum(1 for r in hz["replicas"].values()
                               if r.get("available"))
            except Exception:  # noqa: BLE001 — router mid-teardown
                routable = None
        if routable is None or routable >= 1:
            self._violate(
                "routable_availability",
                f"client-visible failure while {routable} replica(s) "
                f"were routable: {str(error)[:200]}")

    # -- continuous checks -----------------------------------------------------

    def check_once(self) -> List[str]:
        """One pass over the cheap continuously-checkable laws.
        Returns the violation list so far (cumulative)."""
        self._checks += 1
        with self._lock:
            servers = list(self._servers)
        for s in servers:
            try:
                st = s.stats()
            except Exception:  # noqa: BLE001 — server mid-teardown
                continue
            req = st.get("requests", 0)
            done = st.get("replies", 0) + st.get("errors", 0)
            if done > req:
                self._violate(
                    "request_conservation",
                    f"replica {s.host}:{s.port}: replies+errors={done} "
                    f"> requests={req} (double reply or lost request "
                    f"accounting)")
        self._check_fault_mirror()
        with self._lock:
            return list(self.violations)

    def _check_fault_mirror(self) -> None:
        """Invariant 5 (fault half): the ``faults.fired`` telemetry
        mirror must equal the fault registry's own per-point counts.
        Compared point-by-point; the metric may only LAG (inc happens
        after the lock), so only a mirror EXCEEDING the registry is a
        coherence breach."""
        snap = self._metrics.snapshot()
        for series, val in snap.items():
            base, labels = metrics_lib._parse_series(series)
            if base != "faults.fired":
                continue
            point = dict(labels).get("point")
            if point is None:
                continue
            mirrored = val.get("value", 0) if isinstance(val, dict) else val
            m_base, t_base = self._fired_base.get(point, (0.0, 0))
            growth = mirrored - m_base
            truth = self._faults.fired(point) - t_base
            if growth > truth:
                self._violate(
                    "metric_coherence",
                    f"faults.fired{{point={point}}} grew by {growth} "
                    f"but the fault registry's own count grew by "
                    f"{truth}")

    def start(self) -> "InvariantChecker":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zoo-invariant-checker")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the checker must outlive
                # any transient topology race it happens to poll through
                logger.exception("invariant check pass failed")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "InvariantChecker":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- quiescent / terminal checks -------------------------------------------

    def check_quiescent(self) -> List[str]:
        """The EXACT conservation law, valid only once traffic has
        stopped: a still-serving replica must satisfy
        ``requests == replies + errors + pending``.  Killed/stopped/
        draining replicas are exempt (their in-flight work legitimately
        died with their sockets)."""
        with self._lock:
            servers = list(self._servers)
        for s in servers:
            try:
                st = s.stats()
            except Exception:  # noqa: BLE001
                continue
            if st.get("state") != "serving":
                continue
            req = st.get("requests", 0)
            rhs = (st.get("replies", 0) + st.get("errors", 0)
                   + st.get("pending", 0))
            if req != rhs:
                self._violate(
                    "request_conservation",
                    f"replica {s.host}:{s.port} at quiescence: "
                    f"requests={req} != replies+errors+pending={rhs} "
                    f"(stats: { {k: st.get(k) for k in ('requests', 'replies', 'errors', 'pending')} })")
        with self._lock:
            return list(self.violations)

    def check_batch_job(self, out_dir: str, n_rows: int) -> List[str]:
        """Invariant 3: the journal's shard ranges must tile
        ``[0, n_rows)`` exactly — every row scored once, none twice,
        none lost, across any number of kills and resumes."""
        from analytics_zoo_tpu_torch.serving import batch as batch_lib
        entries = batch_lib._read_journal(out_dir)
        if not entries:
            self._violate("batch_row_exactness",
                          f"no journaled shards under {out_dir}")
            with self._lock:
                return list(self.violations)
        last: Dict[int, Dict[str, Any]] = {}
        for e in entries:
            last[int(e["shard"])] = e  # resume may re-journal a shard
        ranges = sorted((int(e["lo"]), int(e["hi"]))
                        for e in last.values())
        cursor = 0
        for lo, hi in ranges:
            if lo != cursor:
                kind = "overlap" if lo < cursor else "gap"
                self._violate(
                    "batch_row_exactness",
                    f"{out_dir}: shard range [{lo}, {hi}) leaves a "
                    f"{kind} at row {cursor}")
                cursor = max(cursor, hi)
                continue
            cursor = hi
        if cursor != n_rows:
            self._violate(
                "batch_row_exactness",
                f"{out_dir}: journal covers [0, {cursor}) but the job "
                f"had {n_rows} rows")
        with self._lock:
            return list(self.violations)

    def check_manifest(self, ckpt_dir: str) -> List[str]:
        """Invariant 7: every visible generation in the checkpoint
        manager's manifest at ``ckpt_dir`` is complete and crc-clean,
        and GC never broke a live base+delta chain.  Chain gaps caused
        by failed (never-landed) writes are NOT violations — restore
        falls back across them by design; ``verify_path`` reports those
        as warnings only."""
        from . import ckpt_manager as ckpt_mgr_lib
        errors, _warns = ckpt_mgr_lib.verify_path(ckpt_dir)
        for err in errors:
            self._violate("manifest_consistency", f"{ckpt_dir}: {err}")
        with self._lock:
            return list(self.violations)

    def check_registry(self) -> List[str]:
        """Invariants 4 + 5 (swap half) over every watched registry:
        the active version equals the LAST observed flip's target (a
        failed swap must not have moved it), and the ``registry.swaps``
        counter equals the number of observed flips."""
        with self._lock:
            watched = list(self._watched)
            base = self._swaps_base
        total_flips = 0
        for reg, name, flips in watched:
            total_flips += len(flips)
            mine = [f for f in flips if f["name"] == name]
            if not mine:
                continue
            want = mine[-1]["new"]
            got = reg.active_version(name)
            if got != want:
                self._violate(
                    "swap_atomicity",
                    f"model {name!r}: active version {got!r} but the "
                    f"last observed flip set {want!r}")
        if watched:
            snap = self._metrics.snapshot()
            swaps = snap.get("registry.swaps", 0)
            mirrored = (swaps.get("value", 0)
                        if isinstance(swaps, dict) else swaps)
            delta = mirrored - (base or 0.0)
            if delta != total_flips:
                self._violate(
                    "metric_coherence",
                    f"registry.swaps grew by {delta} while watched but "
                    f"{total_flips} flip(s) were observed via swap "
                    f"hooks (a failed swap must not count)")
        with self._lock:
            return list(self.violations)

    # -- teardown checks -------------------------------------------------------

    @staticmethod
    def baseline() -> Dict[str, Any]:
        """Snapshot process resources BEFORE the topology comes up:
        thread idents, open-fd count, and shm segments."""
        return {
            "threads": {t.ident for t in threading.enumerate()},
            "fds": InvariantChecker._fd_count(),
            "shm": set(InvariantChecker._shm_files()),
        }

    @staticmethod
    def _fd_count() -> Optional[int]:
        try:
            return len(os.listdir("/proc/self/fd"))
        except OSError:  # pragma: no cover - non-procfs platform
            return None

    @staticmethod
    def _shm_files() -> List[str]:
        try:
            from analytics_zoo_tpu_torch.data.shm_pool import SHM_PREFIX
        except Exception:  # pragma: no cover - optional subsystem
            return []
        try:
            return [f for f in os.listdir("/dev/shm")
                    if f.startswith(SHM_PREFIX)]
        except OSError:  # pragma: no cover - no /dev/shm
            return []

    def assert_teardown(self, baseline: Dict[str, Any],
                        timeout: float = 5.0,
                        fd_slack: int = 4) -> None:
        """Invariant 6, asserted AFTER the topology is torn down: no
        threads, fds, or shm segments beyond the baseline.  Waits up to
        ``timeout`` for daemon threads and closed sockets to unwind
        (teardown is asynchronous by design) before declaring a leak;
        ``fd_slack`` absorbs the interpreter's own lazily-opened fds."""
        deadline = time.monotonic() + timeout
        leaked_threads: List[str] = []
        while time.monotonic() < deadline:
            leaked_threads = [
                t.name for t in threading.enumerate()
                if t.ident not in baseline["threads"] and t.is_alive()]
            fds = self._fd_count()
            fd_ok = (fds is None or baseline["fds"] is None
                     or fds <= baseline["fds"] + fd_slack)
            shm = set(self._shm_files()) - baseline["shm"]
            if not leaked_threads and fd_ok and not shm:
                break
            time.sleep(0.05)
        if leaked_threads:
            self._violate("teardown_leaks",
                          f"threads still alive: {sorted(leaked_threads)}")
        fds = self._fd_count()
        if (fds is not None and baseline["fds"] is not None
                and fds > baseline["fds"] + fd_slack):
            self._violate("teardown_leaks",
                          f"fd count {fds} > baseline {baseline['fds']} "
                          f"+ slack {fd_slack}")
        shm = set(self._shm_files()) - baseline["shm"]
        if shm:
            self._violate("teardown_leaks",
                          f"shm segments leaked: {sorted(shm)}")
        self.assert_ok()

    def assert_ok(self) -> None:
        """Raise AssertionError naming every violation recorded so far
        (the checks run `` {self._checks}`` passes)."""
        with self._lock:
            bad = list(self.violations)
        assert not bad, (
            f"{len(bad)} invariant violation(s) over {self._checks} "
            "check passes:\n  " + "\n  ".join(bad))
