# Port of analytics_zoo_tpu/serving/router.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""High-availability routing across replicated ClusterServing backends.

The reference stack got availability from Flink restarts + Redis
persistence; the single-process redesign (serving/server.py) traded that
away.  This module buys it back at the CLIENT layer, the way production
TPU serving stacks do (see the Gemma-on-TPU serving comparison in
PAPERS.md): N independent replicas behind a router that

- routes each request to the **least-pending available** replica;
- **fails over** a dead/erroring attempt to a sibling replica, reusing
  the client's idempotent-uuid re-enqueue (the retry carries the SAME uuid,
  so a duplicate execution is invisible to the caller) bounded by the
  shared :class:`~analytics_zoo_tpu_torch.serving.client.RetryPolicy`;
- keeps a per-replica **circuit breaker**: ``closed`` → ``open`` after
  ``breaker_threshold`` consecutive failures, then ``half-open`` probes
  after an exponentially growing reset timeout — a dead replica costs
  one failed attempt per reset window instead of one per request;
- runs an **active health checker**: a ``ping`` frame (answered by the
  server's assembly stage, see serving/protocol.py) every
  ``health_interval`` seconds, so a wedged-but-connected backend — the
  failure a TCP connect check cannot see — is ejected by probe timeout,
  and a ``draining`` backend is taken out of rotation *before* it
  rejects anything;
- optionally **hedges** requests near their deadline: when a deadline'd
  request has waited ``hedge_ms`` without a reply, the same uuid is
  enqueued on a second replica and the first answer wins.

Failure-mode accounting rides the process metrics registry
(``router.*`` series, per-replica ``client.*{replica=...}`` labels) and
every served request's trace names the replica that answered it.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid as uuid_mod
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from .client import RETRYABLE_ERRORS, RetryPolicy, _Conn
from . import protocol  # noqa: F401  (ping frame type lives there)

logger = logging.getLogger("analytics_zoo_tpu")

Backend = Union[str, Tuple[str, int]]


def _addr(backend: Backend) -> Tuple[str, int]:
    if isinstance(backend, str):
        host, port_s = backend.rsplit(":", 1)
        return host, int(port_s)
    host, port = backend
    return host, int(port)


class CircuitBreaker:
    """Per-replica failure gate: ``closed`` (normal) → ``open`` after
    ``threshold`` consecutive failures → ``half-open`` probes after
    ``reset_s`` (growing by ``backoff_factor`` each time a probe fails,
    capped at ``max_reset_s``) → ``closed`` again on the first success.

    ``allow()`` is the routing-time gate; callers MUST follow every
    allowed attempt with ``record_success()`` or ``record_failure()``.
    Half-open probes are rate-limited (one per current reset window)
    rather than strictly single-flight, so an attempt that concludes
    with flow control (neither success nor failure) cannot wedge the
    breaker."""

    def __init__(self, threshold: int = 3, reset_s: float = 1.0,
                 backoff_factor: float = 2.0, max_reset_s: float = 30.0,
                 on_open=None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.reset_s = reset_s
        self.backoff_factor = backoff_factor
        self.max_reset_s = max_reset_s
        self._on_open = on_open
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self.opens = 0  # closed/half-open -> open transitions, lifetime
        self._timeout = reset_s
        self._opened_at = 0.0
        self._last_probe = 0.0

    def allow(self) -> bool:
        """May the caller attempt a request right now?"""
        with self._lock:
            if self.state == "closed":
                return True
            now = time.monotonic()
            if self.state == "open":
                if now - self._opened_at < self._timeout:
                    return False
                self.state = "half-open"
                self._last_probe = now
                return True
            # half-open: one probe per reset window keeps a broken
            # replica's cost bounded without single-flight bookkeeping
            if now - self._last_probe >= self._timeout:
                self._last_probe = now
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state != "closed":
                logger.info("circuit breaker re-closed")
            self.state = "closed"
            self.consecutive_failures = 0
            self._timeout = self.reset_s

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self.consecutive_failures += 1
            if self.state == "half-open":
                # failed probe: back to open, with a longer wait
                self.state = "open"
                self._opened_at = time.monotonic()
                self._timeout = min(self._timeout * self.backoff_factor,
                                    self.max_reset_s)
                self.opens += 1
                opened = True
            elif (self.state == "closed"
                  and self.consecutive_failures >= self.threshold):
                self.state = "open"
                self._opened_at = time.monotonic()
                self.opens += 1
                opened = True
        if opened and self._on_open is not None:
            self._on_open()


class Replica:
    """One backend: a lazily-created resilient connection, a circuit
    breaker, the health checker's latest view, and an in-flight count
    (the router's least-pending routing key)."""

    def __init__(self, host: str, port: int, retry: RetryPolicy,
                 metrics: metrics_lib.MetricsRegistry,
                 breaker: CircuitBreaker,
                 labels: Optional[Dict[str, str]] = None):
        self.host, self.port = host, port
        self.name = f"{host}:{port}"
        self.retry = retry
        self.breaker = breaker
        self.healthy = True        # optimistic until a probe says otherwise
        self.state = "serving"     # last pong's (or reply's) lifecycle state
        self._state_ts = 0.0       # when the non-serving state was learned
        self.health_fails = 0      # consecutive failed probes
        self.pending = 0           # requests enqueued, not yet concluded
        self._metrics = metrics
        self._labels = dict(labels or {})
        self._conn: Optional[_Conn] = None
        self._conn_lock = threading.Lock()
        self._closed = False
        # held (non-blocking) by a cluster_metrics scrape of this
        # replica: a scrape thread wedged on a partitioned backend must
        # make LATER scrapes skip the replica, not stack a new blocked
        # thread per tick
        self._scrape_busy = threading.Lock()

    @property
    def conn(self) -> _Conn:
        """The replica's connection, created on first use (creation
        raises OSError while the backend is down — callers treat that
        exactly like a dead socket).  After ``close()`` the connection
        is NEVER recreated — a predict still polling at close time must
        not resurrect a socket (and its reader thread) nobody will
        close again."""
        with self._conn_lock:
            if self._closed:
                raise OSError(f"replica {self.name} is closed")
            if self._conn is None or self._conn._closed:
                self._conn = _Conn(self.host, self.port, retry=self.retry,
                                   metrics=self._metrics,
                                   labels=self._labels)
            return self._conn

    @property
    def connected(self) -> bool:
        return self._conn is not None and self._conn.alive

    def set_state(self, state: str) -> None:
        self.state = state
        self._state_ts = time.monotonic()

    def routable_state(self, ttl: float) -> str:
        """``state``, except that a non-``serving`` state EXPIRES after
        ``ttl`` seconds without reconfirmation.  With the health checker
        running, pongs refresh the state well inside the ttl; without it
        (single-backend sets), a ``draining`` reply must not take the
        only replica out of rotation forever — after the ttl the router
        probes it with real traffic again, whose retryable replies keep
        the caller safe either way."""
        if (self.state != "serving"
                and time.monotonic() - self._state_ts > ttl):
            return "serving"
        return self.state

    def enqueue(self, uid: str, arr: np.ndarray,
                deadline: Optional[float], trace_id: str,
                model: Optional[str] = None,
                version: Optional[str] = None,
                parent_span: Optional[str] = None,
                klass: Optional[str] = None) -> None:
        """Send one request under an EXPLICIT uuid (failover and hedging
        re-enqueue the same uuid on another replica — the idempotency
        contract of the client, stretched across backends).  ``model`` /
        ``version`` route within a multi-model backend, exactly like
        ``InputQueue.enqueue``.

        ``parent_span``: the router's root span id — each enqueue mints
        an ATTEMPT span id under it (riding the frame header so the
        server's stage spans attach there); a hedged request's two
        replica attempts thereby become sibling spans under one root."""
        sid = (trace_lib.new_span_id()
               if trace_lib.enabled and parent_span is not None else None)
        header = protocol.request_header(
            uid, trace=trace_id, span=sid, model=model, version=version,
            deadline_ms=(max(1, int(deadline * 1000))
                         if deadline is not None else None),
            klass=klass)
        self.conn.send_request(header, np.asarray(arr))

    def forget(self, uid: str
               ) -> Optional[Tuple[str, float, Optional[str]]]:
        """Drop the connection's resend record for ``uid``; returns its
        (trace id, enqueue time, attempt span id) so the router can
        close out the attempt span."""
        if self._conn is not None:
            return self._conn.forget(uid)
        return None

    def close(self) -> None:
        with self._conn_lock:
            self._closed = True
            if self._conn is not None:
                self._conn.close()


class ReplicaSet:
    """Resilient client over N ClusterServing replicas — the HA layer
    the HTTP frontend (and any binary client) talks to instead of one
    hard-wired backend.

    ``predict(arr)`` mirrors ``HTTPFrontend.predict``'s contract: the
    reply ndarray, ``None`` on overall timeout, ``RuntimeError`` on a
    non-retryable serving error, ``OSError`` when no replica could be
    reached at all."""

    #: reply-poll slice while awaiting a single replica (small enough to
    #: notice a dead connection fast; failover latency ~ one slice)
    _POLL = 0.05

    def __init__(self, backends: Sequence[Backend],
                 retry: Optional[RetryPolicy] = None,
                 query_timeout: float = 30.0,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 1.0,
                 health_interval: float = 0.25,
                 health_timeout: float = 1.0,
                 unhealthy_after: int = 2,
                 hedge_ms: Union[float, str, None] = None,
                 hedge_quantile: float = 0.95,
                 hedge_margin_ms: float = 5.0,
                 hedge_min_ms: float = 1.0,
                 hedge_max_ms: float = 1000.0,
                 hedge_min_samples: int = 20,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 start_health: bool = True):
        """``hedge_ms``: enable hedged reads — a deadline'd request that
        has waited this long without a reply is re-enqueued (same uuid)
        on a second replica, first answer wins.  None (default) = off.
        ``"auto"`` = self-tuning: each :meth:`retune_hedge` call (the
        controller runs one per control tick) re-derives the threshold
        from the RECENT ``client.request_ms`` distribution —
        ``hedge_quantile`` of the window plus ``hedge_margin_ms``,
        clamped to [``hedge_min_ms``, ``hedge_max_ms``]; windows with
        fewer than ``hedge_min_samples`` observations are accumulated
        instead of acted on (a quiet tick must not swing the threshold),
        and hedging stays OFF until the first tuned value exists.

        ``unhealthy_after``: consecutive failed pings before a replica
        is ejected from rotation (it keeps being probed and returns on
        the first pong)."""
        if not backends:
            raise ValueError("ReplicaSet needs at least one backend")
        self.retry = retry or RetryPolicy()
        self.query_timeout = query_timeout
        self.health_interval = health_interval
        self.health_timeout = health_timeout
        self.unhealthy_after = unhealthy_after
        self.hedge_auto = hedge_ms == "auto"
        if isinstance(hedge_ms, str) and not self.hedge_auto:
            raise ValueError(
                f"hedge_ms must be a number, None, or 'auto'; "
                f"got {hedge_ms!r}")
        self._hedge_ms: Optional[float] = (
            None if self.hedge_auto else hedge_ms)
        self.hedge_quantile = hedge_quantile
        self.hedge_margin_ms = hedge_margin_ms
        self.hedge_min_ms = hedge_min_ms
        self.hedge_max_ms = hedge_max_ms
        self.hedge_min_samples = hedge_min_samples
        # the retune window's baseline: client.request_ms series at the
        # last CONSUMED window (advanced only when enough samples landed)
        self._hedge_prev: Dict[str, Any] = {}
        # how long a learned non-serving state holds without a pong
        # reconfirming it (see Replica.routable_state)
        self._state_ttl = max(4 * health_interval, 1.0)
        self._metrics = metrics or metrics_lib.get_registry()
        self._lock = threading.Lock()
        self._closed = False
        # replica labels only when there is more than one replica to
        # tell apart — the single-backend case keeps the exact metric
        # series names the pre-router frontend emitted.  (add_replica
        # always labels: a growing pool is multi-replica by intent.)
        self._label = len(backends) > 1
        self._start_health_opt = start_health
        self._replicas: List[Replica] = []
        for b in backends:
            host, port = _addr(b)
            name = f"{host}:{port}"
            self._replicas.append(Replica(
                host, port, self.retry, self._metrics,
                self._make_breaker(name, breaker_threshold,
                                   breaker_reset_s),
                labels={"replica": name} if self._label else None))
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self._m_failovers = self._metrics.counter("router.failovers")
        self._m_hedges = self._metrics.counter("router.hedges")
        self._m_hedge_wins = self._metrics.counter("router.hedge_wins")
        self._m_no_replica = self._metrics.counter("router.no_replica")
        self._m_requests = {r.name: self._metrics.counter(
            "router.requests", replica=r.name) for r in self._replicas}
        # pool-membership telemetry: current size + scale
        # events by direction — what the autoscale bench and the
        # controller's post-mortems read
        self._m_replicas = self._metrics.gauge("router.replicas")
        self._m_replicas.set(len(self._replicas))
        self._m_scale = {
            d: self._metrics.counter("router.scale_events", direction=d)
            for d in ("up", "down")}
        # async predict (submit()): lazy executor, built on first use so
        # router-only callers never pay a thread pool
        self._pool = None
        self.submit_workers = 16
        self._stop_health = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        if start_health and len(self._replicas) > 1:
            self.start_health()

    def _make_breaker(self, name: str, threshold: int,
                      reset_s: float) -> CircuitBreaker:
        return CircuitBreaker(threshold=threshold, reset_s=reset_s,
                              on_open=self._make_on_open(name))

    @property
    def hedge_ms(self) -> Optional[float]:
        """The EFFECTIVE hedge threshold (ms): the constructor value
        for numeric configs, the latest tuned value under
        ``hedge_ms="auto"`` (None until the first window with enough
        samples), None when hedging is off."""
        return self._hedge_ms

    @hedge_ms.setter
    def hedge_ms(self, value: Optional[float]) -> None:
        self._hedge_ms = value

    def _make_on_open(self, name: str):
        """Breaker-open hook: count the transition AND dump the flight
        record (no-op without a configured dump dir) — a breaker opening
        is precisely the "replica just failed repeatedly" moment whose
        lead-up (spans, metric movement, warnings) is worth keeping."""
        counter = self._metrics.counter("router.breaker_opens",
                                        replica=name)

        def on_open() -> None:
            counter.inc()
            from analytics_zoo_tpu_torch.core import flightrec
            flightrec.dump("breaker_open", extra={"replica": name})

        return on_open

    # -- health ---------------------------------------------------------------

    def start_health(self) -> None:
        if self._health_thread is not None:
            return
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="zoo-router-health")
        self._health_thread.start()

    def _health_loop(self) -> None:
        while not self._stop_health.wait(self.health_interval):
            # snapshot: add_replica/remove_replica mutate the list
            # concurrently (a probe of a just-retired replica is
            # harmless — its closed conn fails the ping and it is
            # already out of rotation)
            with self._lock:
                reps = list(self._replicas)
            for r in reps:
                if self._closed:
                    return
                self._probe(r)

    def _probe(self, r: Replica) -> None:
        hdr = None
        try:
            conn = r.conn
            if not conn.alive:
                conn.reconnect()
            hdr = conn.ping(self.health_timeout)
        except OSError:
            hdr = None
        if hdr is None or hdr.get("error") or hdr.get("state") == "stopped":
            r.health_fails += 1
            if r.health_fails >= self.unhealthy_after and r.healthy:
                r.healthy = False
                self._metrics.inc("router.health_ejections",
                                  replica=r.name)
                logger.warning("replica %s ejected: %d consecutive "
                               "failed health probes", r.name,
                               r.health_fails)
        else:
            prev = (r.healthy, r.state)
            r.health_fails = 0
            r.healthy = True
            r.set_state(hdr.get("state", "serving"))
            if prev != (True, r.state):
                logger.info("replica %s health: healthy, state=%s",
                            r.name, r.state)

    # -- pool membership (runtime scale up/down) ----------------------------------

    def add_replica(self, backend: Backend) -> Replica:
        """JOIN a new backend to the pool at runtime — the scale-UP
        actuation.  The replica is routable the moment this returns
        (atomically: ``_pick`` snapshots the list under the same lock),
        so callers warm the backend's model BEFORE calling this — the
        controller's ``ReplicaFactory.create()`` contract — and no
        client ever eats a cold compile.

        The new replica always carries a ``replica=`` metric label (a
        growing pool is multi-replica by intent; a pool constructed
        single-backend keeps its original replica's unlabeled series).
        Emits ``router.replicas`` and ``router.scale_events``, and
        starts the health checker once the pool is >1."""
        host, port = _addr(backend)
        name = f"{host}:{port}"
        rep = Replica(host, port, self.retry, self._metrics,
                      self._make_breaker(name, self._breaker_threshold,
                                         self._breaker_reset_s),
                      labels={"replica": name})
        with self._lock:
            if self._closed:
                raise OSError("ReplicaSet is closed")
            if any(r.name == name for r in self._replicas):
                raise ValueError(f"replica {name} is already in the pool")
            self._replicas.append(rep)
            self._m_requests[name] = self._metrics.counter(
                "router.requests", replica=name)
            n = len(self._replicas)
        self._m_replicas.set(n)
        self._m_scale["up"].inc()
        logger.info("replica %s joined the pool (%d replicas)", name, n)
        if self._start_health_opt and n > 1:
            self.start_health()
        return rep

    def remove_replica(self, backend: Union[Backend, Replica],
                       drain: bool = True,
                       timeout: float = 30.0) -> bool:
        """RETIRE a backend from the pool at runtime — the scale-DOWN
        actuation.  Routing stops immediately (the replica leaves the
        list under the lock ``_pick`` snapshots); with ``drain`` (the
        default) the call then waits for the replica's in-flight
        requests to conclude — predicts hold their own ``Replica``
        reference, so they finish normally — before closing the
        connection.  Returns True when the replica drained inside
        ``timeout`` (False = closed with requests still pending, whose
        replies the closed conn turns into failovers).

        The caller (the controller) drains and stops the BACKEND
        process afterwards: stop routing → drain → retire, the
        zero-error sequence.  The replica's ``router.requests`` series
        is retired with it — an autoscaled pool mints monotone
        addresses, and without retirement every address ever scraped
        stays in every future scrape."""
        name = (backend.name if isinstance(backend, Replica)
                else "%s:%d" % _addr(backend))
        with self._lock:
            rep = next((r for r in self._replicas if r.name == name),
                       None)
            if rep is None:
                raise ValueError(f"replica {name} is not in the pool")
            if len(self._replicas) <= 1:
                raise ValueError(
                    "cannot remove the last replica from the pool")
            self._replicas.remove(rep)
            self._m_requests.pop(name, None)
            n = len(self._replicas)
        self._metrics.remove("router.requests", replica=name)
        drained = True
        if drain:
            deadline = time.monotonic() + timeout
            while rep.pending > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            drained = rep.pending == 0
            if not drained:
                logger.warning("replica %s retired with %d request(s) "
                               "still pending after %.1fs", name,
                               rep.pending, timeout)
        rep.close()
        self._m_replicas.set(n)
        self._m_scale["down"].inc()
        logger.info("replica %s left the pool (%d replicas, drained=%s)",
                    name, n, drained)
        return drained

    # -- self-tuning hedging (hedge_ms="auto") ----------------------------------

    def retune_hedge(self) -> Optional[float]:
        """Re-derive the hedge threshold from the RECENT
        ``client.request_ms`` distribution — one call per control tick.

        The window is everything observed since the last CONSUMED
        window (``snapshot_delta`` against a stored baseline, summed
        across per-replica label series).  Windows with fewer than
        ``hedge_min_samples`` observations accumulate instead of
        retuning — the threshold FREEZES at its last value through
        quiet periods rather than swinging on a handful of samples.
        The tuned value is ``hedge_quantile`` of the window plus
        ``hedge_margin_ms``, clamped to [``hedge_min_ms``,
        ``hedge_max_ms``]; ``router.hedge_ms`` gauges it and
        ``router.hedge_retunes`` counts the updates.

        No-op (returns the current value) unless the set was built with
        ``hedge_ms="auto"`` — a numeric config stays byte-identical to
        the pre-auto router."""
        if not self.hedge_auto:
            return self._hedge_ms
        snap = self._metrics.snapshot()
        cur = {s: v for s, v in snap.items()
               if metrics_lib._parse_series(s)[0] == "client.request_ms"}
        delta = metrics_lib.snapshot_delta(self._hedge_prev, cur)
        # fold per-replica series into one window distribution
        window = metrics_lib.MetricsRegistry.merge(
            [{"client.request_ms": v} for v in delta.values()],
            drop_labels=("replica",)).get("client.request_ms")
        count = (window or {}).get("count", 0)
        if count < self.hedge_min_samples:
            return self._hedge_ms  # frozen: accumulate, don't consume
        self._hedge_prev = cur  # consume the window
        q = metrics_lib.quantile_from_snapshot(window,
                                               self.hedge_quantile)
        tuned = min(self.hedge_max_ms,
                    max(self.hedge_min_ms, q + self.hedge_margin_ms))
        self._hedge_ms = tuned
        self._metrics.gauge("router.hedge_ms").set(tuned)
        self._metrics.counter("router.hedge_retunes").inc()
        logger.debug("hedge_ms retuned to %.2fms (window p%d=%.2fms, "
                     "n=%d)", tuned, round(self.hedge_quantile * 100),
                     q, count)
        return tuned

    # -- routing --------------------------------------------------------------

    def _pick(self, exclude: Set[str]) -> Optional[Replica]:
        """Least-pending replica that is healthy, serving, and whose
        breaker admits an attempt.  ``breaker.allow()`` is consumed only
        by the replica actually chosen (it has side effects: half-open
        probe budget)."""
        with self._lock:
            cands = sorted(
                (r for r in self._replicas
                 if r.name not in exclude and r.healthy
                 and r.routable_state(self._state_ttl) == "serving"),
                key=lambda r: (r.pending, r.name))
        for r in cands:
            if r.breaker.allow():
                return r
        self._m_no_replica.inc()
        return None

    def predict(self, arr: np.ndarray, deadline: Optional[float] = None,
                trace_id: Optional[str] = None,
                timeout: Optional[float] = None,
                model: Optional[str] = None,
                version: Optional[str] = None,
                klass: Optional[str] = None) -> Optional[np.ndarray]:
        """One request through the replica set; failover, circuit
        breaking and (optional) hedging happen underneath.

        ``deadline``: per-request budget in seconds, propagated to the
        serving frame header exactly like ``InputQueue.enqueue``.
        ``timeout``: overall client-side wait (default ``query_timeout``,
        bounded near the deadline the way the frontend bounds it).
        ``model``/``version``: multi-model routing, propagated verbatim
        to every attempt (failover and hedge included).
        ``klass``: request class for the server's per-class admission
        gate (``"interactive"`` | ``"batch"``), likewise propagated to
        every attempt."""
        if timeout is None:
            timeout = (self.query_timeout if deadline is None
                       else min(self.query_timeout, deadline + 1.0))
        until = time.monotonic() + timeout
        uid = f"rs-{uuid_mod.uuid4()}"
        tid = trace_id or trace_lib.new_trace_id()
        # the request's ROOT span: every replica attempt (primary,
        # failover, hedge) becomes a child span, and each attempt's
        # server-side stage spans hang beneath it — trace.tree(tid)
        # reconstructs root → attempts → server stages
        root_sid = trace_lib.new_span_id() if trace_lib.enabled else None
        t0 = time.monotonic()
        attempts = 0
        tried: Set[str] = set()      # replicas that failed this request
        touched: List[Replica] = []  # replicas holding this uid
        try:
            while time.monotonic() < until:
                if self._closed:
                    raise OSError("ReplicaSet is closed")
                r = self._pick(tried)
                if r is None and tried:
                    # every untried replica is unavailable: clear the
                    # exclusion (a replica that failed earlier may have
                    # recovered) and back off before going again
                    tried.clear()
                    r = self._pick(tried)
                if r is None:
                    delay = self.retry.delay(min(attempts + 1, 8))
                    time.sleep(min(delay,
                                   max(0.0, until - time.monotonic())))
                    continue
                attempts += 1
                if attempts > 1:
                    self._m_failovers.inc()
                try:
                    with self._lock:
                        r.pending += 1
                    touched.append(r)
                    r.enqueue(uid, arr, deadline, tid, model=model,
                              version=version, parent_span=root_sid,
                              klass=klass)
                except OSError:
                    r.breaker.record_failure()
                    tried.add(r.name)
                    continue
                kind, payload, rep = self._await(r, uid, arr, until,
                                                 deadline, tid, tried,
                                                 touched, model=model,
                                                 version=version,
                                                 root_span=root_sid,
                                                 klass=klass)
                if kind == "ok":
                    out, header = payload
                    rep.breaker.record_success()
                    self._m_requests[rep.name].inc()
                    hedge_win = rep is not r
                    if hedge_win:
                        self._m_hedge_wins.inc()
                    # close out the CLIENT half of the trace exactly the
                    # way OutputQueue.query does — the per-request
                    # histogram and the "client" record with the
                    # server's stage breakdown must not disappear just
                    # because a router sits in between.  (_conn direct:
                    # the property would raise if the set closed in the
                    # same instant the reply landed.)
                    conn = rep._conn
                    info = conn.forget(uid) if conn is not None else None
                    if info is not None:
                        _tid, t0c, att_sid = info
                        total = (time.monotonic() - t0c) * 1000.0
                        stages = {"client.total_ms": round(total, 3),
                                  "client.replica": rep.name}
                        if (header or {}).get("stages"):
                            stages.update(header["stages"])
                        conn._m_request.observe(total)
                        # the WINNING attempt span: its id rode the
                        # frame header, so the serving replica's stage
                        # spans already sit beneath it in the tree
                        trace_lib.record(tid, "client", stages,
                                         span_id=att_sid,
                                         parent=root_sid, dur_ms=total)
                        trace_lib.maybe_log_slow(tid, uid, total, stages)
                    trace_lib.record(tid, "router", {
                        "router.replica": rep.name,
                        "router.attempts": attempts,
                        "router.hedge_win": int(hedge_win),
                        "router.total_ms": round(
                            (time.monotonic() - t0) * 1000.0, 3)},
                        span_id=root_sid)
                    return out
                if kind == "error":
                    raise RuntimeError(
                        f"serving error for {uid} (replica "
                        f"{rep.name}): {payload}")
                if kind == "closed":
                    raise OSError("ReplicaSet is closed")
                # "dead" / "failover" / "timeout": try elsewhere.  When
                # no OTHER replica is available, wait out a backoff so a
                # lone flapping replica isn't hammered in a hot loop.
                if rep is not None:
                    tried.add(rep.name)
                if self._pick_would_block(tried):
                    delay = self.retry.delay(min(attempts, 8))
                    time.sleep(min(delay,
                                   max(0.0, until - time.monotonic())))
            self._metrics.inc("client.timeouts")
            return None
        finally:
            for rep in touched:
                info = rep.forget(uid)
                with self._lock:
                    rep.pending = max(0, rep.pending - 1)
                if info is not None and info[2] is not None:
                    # a LOSING attempt (failed primary, abandoned hedge,
                    # timeout): close its span so the tree shows every
                    # replica this request touched, not just the winner
                    trace_lib.record(
                        tid, "client.attempt",
                        {"client.total_ms": round(
                            (time.monotonic() - info[1]) * 1000.0, 3),
                         "client.replica": rep.name,
                         "client.won": 0},
                        span_id=info[2], parent=root_sid)

    def submit(self, arr: np.ndarray, **kwargs: Any
               ) -> "concurrent.futures.Future":
        """Asynchronous :meth:`predict`: returns a Future resolving to
        the same result (ndarray, None on timeout, or the raised
        error).  The executor is lazy and bounded — the batch-scoring
        engine (serving/batch.py) uses this to keep a WINDOW of shards
        in flight without one thread per outstanding shard; its own
        semaphore bounds the window, so the pool here just needs enough
        threads to cover it (grown on demand up to ``submit_workers``,
        default 16)."""
        with self._lock:
            if self._closed:
                raise OSError("ReplicaSet is closed")
            if self._pool is None:
                import concurrent.futures
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.submit_workers,
                    thread_name_prefix="rs-submit")
        return self._pool.submit(self.predict, arr, **kwargs)

    def _pick_would_block(self, tried: Set[str]) -> bool:
        with self._lock:
            return not any(
                r.name not in tried and r.healthy
                and r.routable_state(self._state_ttl) == "serving"
                and r.breaker.state != "open"
                for r in self._replicas)

    def _await(self, r: Replica, uid: str, arr: np.ndarray, until: float,
               deadline: Optional[float], tid: str, tried: Set[str],
               touched: List[Replica], model: Optional[str] = None,
               version: Optional[str] = None,
               root_span: Optional[str] = None,
               klass: Optional[str] = None
               ) -> Tuple[str, Any, Optional[Replica]]:
        """Wait for ``uid``'s reply on ``r`` (and on a hedge replica,
        once launched).  Returns ``(kind, payload, replica)`` where kind
        is ``ok`` / ``error`` (non-retryable, payload = message) /
        ``failover`` / ``dead`` / ``timeout`` / ``closed``.  A hedge
        replica is appended to ``touched`` so the caller's cleanup
        (forget + pending decrement) covers it."""
        waiting = [r]
        hedged = False
        t0 = time.monotonic()
        last: Tuple[str, Any, Optional[Replica]] = ("timeout", None, None)
        while waiting and time.monotonic() < until:
            if self._closed:
                return ("closed", None, None)
            poll = min(self._POLL / max(1, len(waiting)),
                       max(0.001, until - time.monotonic()))
            for rep in list(waiting):
                try:
                    res = rep.conn.wait(uid, poll)
                    alive = rep.conn.alive
                except OSError:  # replica closed underneath us
                    res, alive = None, False
                if res is not None:
                    arr, err, header = res
                    if err is None:
                        return ("ok", (arr, header), rep)
                    if "draining" in err:
                        rep.set_state("draining")
                    if "server shutting down" in err:
                        rep.breaker.record_failure()
                    if any(m in err for m in RETRYABLE_ERRORS) or \
                            "deadline unattainable" in err:
                        waiting.remove(rep)
                        last = ("failover", err, rep)
                        continue
                    return ("error", err, rep)
                if not alive:
                    rep.breaker.record_failure()
                    waiting.remove(rep)
                    last = ("dead", None, rep)
                    continue
            if (not hedged and self.hedge_ms is not None
                    and deadline is not None and waiting
                    and (time.monotonic() - t0) * 1000.0 >= self.hedge_ms):
                hedged = True  # one hedge per request, even if it fails
                h = self._pick(tried | {rep.name for rep in waiting})
                if h is not None:
                    with self._lock:
                        h.pending += 1
                    touched.append(h)  # caller cleans up forget/pending
                    try:
                        h.enqueue(uid, arr, deadline, tid, model=model,
                                  version=version, parent_span=root_span,
                                  klass=klass)
                        waiting.append(h)
                        self._m_hedges.inc()
                        logger.debug("hedged %s onto %s", uid, h.name)
                    except OSError:
                        h.breaker.record_failure()
        return last

    # -- introspection --------------------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        """The health view ``/healthz`` serves: overall status (``ok`` =
        every replica routable, ``degraded`` = some, ``down`` = none)
        plus each replica's health, lifecycle state, breaker state and
        in-flight count."""
        replicas: Dict[str, Any] = {}
        n_avail = 0
        with self._lock:
            reps = list(self._replicas)
        for r in reps:
            # availability through the same TTL lens routing uses: a
            # learned "draining" with no health checker to refresh it
            # (single-backend sets) must not report 503 forever after
            # the drained backend was replaced
            state = r.routable_state(self._state_ttl)
            avail = (r.healthy and state == "serving"
                     and r.breaker.state != "open")
            n_avail += avail
            replicas[r.name] = {
                "healthy": r.healthy, "state": state,
                "available": avail, "breaker": r.breaker.state,
                "breaker_opens": r.breaker.opens,
                "consecutive_failures": r.breaker.consecutive_failures,
                "pending": r.pending, "connected": r.connected,
            }
        status = ("ok" if n_avail == len(reps)
                  else "degraded" if n_avail else "down")
        return {"status": status, "replicas": replicas}

    def cluster_metrics(self, timeout: float = 2.0) -> Dict[str, Any]:
        """One cluster-level registry snapshot: scrape every ROUTABLE
        replica's registry over the TCP ``metrics`` frame and fold the
        snapshots with :meth:`MetricsRegistry.merge`, dropping
        ``replica=`` labels so per-backend series merge into one
        cluster series (counters sum, gauge high-water marks
        max-merge, histogram buckets add).  Unreachable replicas are
        skipped — a scrape must never block on a dead backend longer
        than ``timeout``: the scrape threads are joined against one
        shared deadline, and a replica whose PREVIOUS scrape is still
        wedged (partitioned backend: the send blocks, the reply never
        comes) is skipped outright instead of stacking another blocked
        thread per controller tick."""
        with self._lock:
            reps = [r for r in self._replicas if r.healthy]
        results: List[Optional[Dict[str, Any]]] = [None] * len(reps)

        def scrape(i: int, r: Replica) -> None:
            if not r._scrape_busy.acquire(blocking=False):
                return  # previous scrape still wedged on this backend
            try:
                results[i] = r.conn.metrics_snapshot(timeout)
            except OSError:
                pass
            finally:
                r._scrape_busy.release()

        # concurrent scrape: N wedged-but-connected replicas must cost
        # ~one timeout total, not timeout × N (a Prometheus scrape job
        # would give up long before a sequential sweep finished)
        threads = [threading.Thread(target=scrape, args=(i, r),
                                    daemon=True)
                   for i, r in enumerate(reps)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout + 0.5
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return metrics_lib.MetricsRegistry.merge(
            [s for s in results if s], drop_labels=("replica",))

    def stats(self) -> Dict[str, Any]:
        """Per-replica resilience counters (each connection's
        ``conn.stats``) plus the health/breaker view."""
        out: Dict[str, Any] = {"replicas": {}}
        hz = self.healthz()["replicas"]
        with self._lock:
            reps = list(self._replicas)
        for r in reps:
            st = dict(r._conn.stats) if r._conn is not None else {}
            st.update(hz.get(r.name, {}))
            out["replicas"][r.name] = st
        return out

    @property
    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Stop the health checker and close every replica connection.
        Bounded: in-flight ``predict`` calls observe ``_closed`` on
        their next poll slice and raise ``OSError`` instead of waiting
        out their timeouts."""
        self._closed = True
        self._stop_health.set()
        t = self._health_thread
        if t is not None:
            t.join(timeout=2.0)
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            # in-flight submits observe _closed on their next poll slice
            pool.shutdown(wait=False)
        with self._lock:
            reps = list(self._replicas)
        for r in reps:
            r.close()

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
