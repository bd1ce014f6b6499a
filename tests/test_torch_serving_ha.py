"""Twin of ``tests/test_ha.py`` for the port, against a small BERT served
by the port's ``InferenceModel`` on the CPU: replicated backends behind
the ``ReplicaSet`` router (health-checked routing, circuit breakers,
failover, hedged reads), graceful drain, admission control, and the
acceptance scenario: hard-kill a replica under sustained load with no
client-visible failure, then a rolling restart that drops nothing.

Faults come from per-server private ``FaultRegistry`` instances (or the
port's global one, disarmed after each test), retry policies are seeded,
and no injected delay exceeds 0.5 s.  Where the JAX test's model doubles
its input, a reply here is held against the BERT's own ``predict`` of the
row within ``TOL``.  Waits that the JAX test makes as fixed sleeps
(a replica's ejection after a kill) poll for the state under a deadline.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from analytics_zoo_tpu_torch.core.faults import FaultRegistry, get_registry
from analytics_zoo_tpu_torch.serving import (CircuitBreaker, ClusterServing,
                                             HTTPFrontend, InputQueue,
                                             OutputQueue, ReplicaSet)
from analytics_zoo_tpu_torch.serving.client import RetryPolicy

from _torch_serving import (Served, bert, close, expect, ids,
                            no_leaked_port_controllers, one_torch_thread,
                            port_faults_disarmed, port_telemetry_reset)

pytestmark = pytest.mark.faults

MODEL = bert(0)
X = ids(1, seed=200)[0]
WANT = expect(MODEL, X)


def _model(delay=0.0):
    """The shared BERT behind a fresh row counter (and an optional
    per-batch sleep)."""
    return Served(MODEL, delay=delay)


def _fast_retry(**kw) -> RetryPolicy:
    kw.setdefault("max_attempts", 3)
    kw.setdefault("base_delay", 0.02)
    kw.setdefault("max_delay", 0.1)
    kw.setdefault("seed", 0)
    return RetryPolicy(**kw)


def _serve(model=None, faults=None, port=0, **kw) -> ClusterServing:
    kw.setdefault("batch_size", 8)
    kw.setdefault("batch_timeout_ms", 2)
    return ClusterServing(model or _model(), port=port, faults=faults,
                          **kw).start()


def _restart_on_port(model, port, faults=None, timeout=15.0, **kw):
    """Start a replacement server on a just-released port (the OS may
    need a beat to free it)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return _serve(model, faults=faults, port=port, **kw)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# -- circuit breaker (pure unit) ----------------------------------------------

def test_breaker_opens_after_threshold_and_recloses():
    b = CircuitBreaker(threshold=3, reset_s=0.1)
    assert b.state == "closed" and b.allow()
    b.record_failure()
    b.record_failure()
    assert b.state == "closed" and b.allow()  # under threshold
    b.record_failure()
    assert b.state == "open" and b.opens == 1
    assert not b.allow()                      # open: fail fast
    time.sleep(0.12)
    assert b.allow()                          # reset elapsed: half-open probe
    assert b.state == "half-open"
    b.record_success()
    assert b.state == "closed" and b.allow()
    assert b.consecutive_failures == 0


def test_breaker_failed_probe_reopens_with_backoff():
    b = CircuitBreaker(threshold=1, reset_s=0.05, backoff_factor=2.0,
                       max_reset_s=1.0)
    b.record_failure()
    assert b.state == "open"
    time.sleep(0.06)
    assert b.allow()                          # half-open probe
    b.record_failure()                        # probe failed
    assert b.state == "open" and b.opens == 2
    assert b._timeout == pytest.approx(0.1)   # grew 2x
    assert not b.allow()                      # new window not elapsed
    time.sleep(0.11)
    assert b.allow()
    b.record_success()
    assert b.state == "closed" and b._timeout == pytest.approx(0.05)


def test_breaker_half_open_probe_budget_is_rate_limited():
    b = CircuitBreaker(threshold=1, reset_s=0.1)
    b.record_failure()
    time.sleep(0.11)
    assert b.allow()          # the transition probe
    assert not b.allow()      # second caller inside the window: rejected


# -- health pings -------------------------------------------------------------

def test_ping_round_trip_carries_state_and_depth():
    with _serve() as srv:
        iq = InputQueue(srv.host, srv.port, retry=_fast_retry())
        pong = iq.conn.ping(timeout=2.0)
        assert pong and pong.get("pong") is True
        assert pong["state"] == "serving"
        assert "queue_depth" in pong
        assert srv.stats()["pings"] == 1
        s = srv.stats()
        assert s["requests"] == s["replies"] == s["errors"] == 0
        iq.close()


def test_health_fail_fault_swallows_the_pong():
    faults = get_registry()
    with _serve() as srv:
        iq = InputQueue(srv.host, srv.port, retry=_fast_retry())
        with faults.armed("serving.health_fail", times=1):
            assert iq.conn.ping(timeout=0.4) is None  # probe lost
        assert faults.fired("serving.health_fail") == 1
        assert iq.conn.ping(timeout=2.0) is not None  # next probe lands
        iq.close()


def test_wedged_assembly_fails_the_ping_by_timeout():
    private = FaultRegistry()
    with _serve(faults=private) as srv:
        iq = InputQueue(srv.host, srv.port, retry=_fast_retry())
        assert iq.conn.ping(timeout=2.0) is not None  # healthy baseline
        private.enable("serving.model_latency", times=1, delay=0.4)
        assert iq.conn.ping(timeout=0.15) is None     # wedged: no pong
        iq.close()


# -- drain + admission control ------------------------------------------------

def test_drain_rejects_new_work_retryably_and_finishes_in_flight():
    srv = _serve(_model(delay=0.2), batch_size=1, batch_timeout_ms=1)
    iq = InputQueue(srv.host, srv.port, retry=_fast_retry(max_attempts=2))
    oq = OutputQueue(input_queue=iq)
    uid_in = iq.enqueue("in-flight", t=X)
    time.sleep(0.05)  # the request reaches the pipeline
    assert srv.drain(wait=False)
    assert srv.state == "draining"
    assert iq.conn.ping(timeout=2.0)["state"] == "draining"
    uid_new = iq.enqueue("late", t=X)
    with pytest.raises(RuntimeError, match="draining"):
        oq.query(uid_new, timeout=10.0)
    assert srv.drain(wait=True, timeout=10.0)
    close(oq.query(uid_in, timeout=10.0), WANT)
    s = srv.stats()
    assert s["draining_rejected"] >= 1
    assert s["requests"] == s["replies"] + s["errors"]
    srv.stop()
    iq.close()


def test_admission_queue_limit_rejects_retryably():
    private = FaultRegistry()
    with _serve(_model(), batch_size=1, batch_timeout_ms=1,
                admission_queue_limit=1, faults=private) as srv:
        iq = InputQueue(srv.host, srv.port,
                        retry=_fast_retry(max_attempts=1))
        oq = OutputQueue(input_queue=iq)
        private.enable("serving.model_latency", times=1, delay=0.4)
        uid_a = iq.enqueue("a", t=X)      # popped, wedged in assembly
        time.sleep(0.05)
        uid_b = iq.enqueue("b", t=X)      # sits in the queue (depth 1)
        time.sleep(0.05)
        uid_c = iq.enqueue("c", t=X)      # over the soft cap
        with pytest.raises(RuntimeError, match="queue full"):
            oq.query(uid_c, timeout=10.0)
        close(oq.query(uid_a, timeout=10.0), WANT)
        close(oq.query(uid_b, timeout=10.0), WANT)
        assert srv.stats()["admission_rejected"] >= 1
        iq.close()


def test_admission_rejects_unattainable_deadline():
    private = FaultRegistry()
    model = _model()
    with _serve(model, batch_size=1, batch_timeout_ms=1,
                faults=private) as srv:
        iq = InputQueue(srv.host, srv.port,
                        retry=_fast_retry(max_attempts=1))
        oq = OutputQueue(input_queue=iq)
        private.enable("serving.model_latency", times=3, delay=0.3)
        uid_a = iq.enqueue("a", t=X)          # wedges assembly
        time.sleep(0.02)
        uid_b = iq.enqueue("b", t=X)          # waits ~0.3s -> EWMA rises
        rows_before = model.rows_seen
        deadline = time.monotonic() + 5
        while model.rows_seen < rows_before + 1 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        uid_c = iq.enqueue("c", t=X)          # keeps queue depth >= 1
        uid_d = iq.enqueue("doomed", deadline=0.01, t=X)
        with pytest.raises(RuntimeError, match="deadline unattainable"):
            oq.query(uid_d, timeout=10.0)
        for uid in (uid_a, uid_b, uid_c):
            close(oq.query(uid, timeout=10.0), WANT)
        s = srv.stats()
        assert s["admission_rejected"] == 1
        assert s["requests"] == s["replies"] + s["errors"]
        iq.close()


# -- replica set: routing + health --------------------------------------------

def _replica_set(servers, **kw):
    kw.setdefault("retry", _fast_retry())
    kw.setdefault("health_interval", 0.08)
    kw.setdefault("health_timeout", 0.5)
    kw.setdefault("breaker_reset_s", 0.25)
    return ReplicaSet([(s.host, s.port) for s in servers], **kw)


def test_replica_set_routes_and_both_replicas_serve():
    m1, m2 = _model(delay=0.03), _model(delay=0.03)
    s1 = _serve(m1, batch_size=1, batch_timeout_ms=1)
    s2 = _serve(m2, batch_size=1, batch_timeout_ms=1)
    rs = _replica_set([s1, s2])
    rows = ids(4, seed=201)
    want = MODEL.predict(rows)
    errors = []

    def client(i):
        for _ in range(6):
            try:
                close(rs.predict(rows[i], timeout=15.0), want[i])
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:3]
        assert m1.rows_seen > 0 and m2.rows_seen > 0
        assert m1.rows_seen + m2.rows_seen == 24
        hz = rs.healthz()
        assert hz["status"] == "ok"
        assert all(v["available"] for v in hz["replicas"].values())
    finally:
        rs.close()
        s1.stop()
        s2.stop()


def test_health_checker_ejects_wedged_replica_and_readmits_it():
    private = FaultRegistry()
    s1 = _serve(_model(), faults=private)
    s2 = _serve(_model())
    rs = _replica_set([s1, s2], health_timeout=0.15)
    name1 = f"{s1.host}:{s1.port}"
    try:
        close(rs.predict(X, timeout=10.0), WANT)
        private.enable("serving.model_latency", times=5, delay=0.4)
        _wait(lambda: not rs.healthz()["replicas"][name1]["healthy"],
              "replica never ejected", timeout=10)
        for _ in range(6):
            close(rs.predict(X, timeout=10.0), WANT)
        snap = metrics_lib.get_registry().snapshot()
        assert snap[f"router.health_ejections{{replica={name1}}}"] >= 1
        _wait(lambda: rs.healthz()["replicas"][name1]["healthy"],
              "replica never re-admitted", timeout=15)
    finally:
        rs.close()
        s1.stop()
        s2.stop()


def test_hedged_read_wins_on_a_slow_replica():
    """A deadline'd request that has waited ``hedge_ms`` is re-enqueued
    on the second replica; the fast replica's answer wins."""
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    ports.sort(key=lambda p: f"127.0.0.1:{p}")
    slow, fast = _model(delay=0.4), _model()
    s1 = _serve(slow, port=ports[0], batch_size=1, batch_timeout_ms=1)
    s2 = _serve(fast, port=ports[1], batch_size=1, batch_timeout_ms=1)
    rs = _replica_set([s1, s2], hedge_ms=50.0, start_health=False)
    try:
        tid = trace_lib.new_trace_id()
        t0 = time.monotonic()
        out = rs.predict(X, deadline=5.0, trace_id=tid, timeout=10.0)
        elapsed = time.monotonic() - t0
        close(out, WANT)
        assert fast.rows_seen >= 1          # the hedge replica answered
        assert elapsed < 0.35, elapsed      # won before the slow reply
        _wait(lambda: slow.rows_seen >= 1, "slow replica never ran",
              timeout=5)
        snap = metrics_lib.get_registry().snapshot()
        assert snap["router.hedges"] >= 1
        assert snap["router.hedge_wins"] >= 1
        router_recs = [r for r in trace_lib.find(tid)
                       if r.where == "router"]
        assert router_recs, "router trace record missing"
        assert router_recs[-1].stages["router.replica"] == \
            f"{s2.host}:{s2.port}"
    finally:
        rs.close()
        s1.stop()
        s2.stop()


# -- client replay cap --------------------------------------------------------

def test_replay_cap_fails_uid_visibly_instead_of_looping_forever():
    faults = get_registry()
    with _serve(_model()) as srv:
        retry = _fast_retry(max_attempts=3)
        iq = InputQueue(srv.host, srv.port, retry=retry)
        oq = OutputQueue(input_queue=iq)
        with faults.armed("serving.conn_drop"):  # drop EVERY frame
            uid = iq.enqueue("t", t=X)
            with pytest.raises(RuntimeError,
                               match="replay budget exhausted"):
                oq.query(uid, timeout=30.0)
        assert iq.conn.stats["replayed"] == retry.max_attempts
        snap = metrics_lib.get_registry().snapshot()
        assert snap["client.replayed"] == retry.max_attempts
        uid2 = iq.enqueue("after", t=X)
        close(oq.query(uid2, timeout=20.0), WANT)
        iq.close()


# -- shutdown races -----------------------------------------------------------

def test_stop_during_client_reconnect_terminates_bounded():
    faults = get_registry()
    srv = _serve(_model(delay=0.2), batch_size=1, batch_timeout_ms=1)
    iq = InputQueue(srv.host, srv.port, retry=_fast_retry())
    oq = OutputQueue(input_queue=iq)
    uids = [iq.enqueue(f"r{i}", t=X) for i in range(3)]
    faults.enable("serving.conn_drop", times=1)
    iq.enqueue("dropper", t=X)
    outcomes = {}

    def q(uid):
        try:
            outcomes[uid] = ("ok", oq.query(uid, timeout=10.0))
        except (RuntimeError, OSError) as e:
            outcomes[uid] = ("error", str(e))

    threads = [threading.Thread(target=q, args=(u,)) for u in uids]
    for t in threads:
        t.start()
    time.sleep(0.05)
    srv.stop()
    for t in threads:
        t.join(timeout=20)
    faults.disable("serving.conn_drop")  # the charge may be unspent
    assert not any(t.is_alive() for t in threads), "hung query() calls"
    assert len(outcomes) == 3, outcomes
    s = srv.stats()
    assert s["pending"] == 0
    assert s["requests"] == s["replies"] + s["errors"]
    iq.close()


def test_frontend_close_with_hedged_request_in_flight_is_bounded():
    s1 = _serve(_model(delay=1.0), batch_size=1, batch_timeout_ms=1)
    s2 = _serve(_model(delay=1.0), batch_size=1, batch_timeout_ms=1)
    rs = _replica_set([s1, s2], hedge_ms=30.0, start_health=False)
    fe = HTTPFrontend(router=rs).start()
    outcome = {}

    def call():
        try:
            outcome["result"] = fe.predict(X, deadline=8.0)
        except OSError as e:
            outcome["error"] = str(e)

    t = threading.Thread(target=call)
    t.start()
    time.sleep(0.3)  # request sent; hedge_ms elapsed -> hedge launched
    t0 = time.monotonic()
    fe.close()
    close_s = time.monotonic() - t0
    t.join(timeout=5)
    assert not t.is_alive(), "predict hung past close()"
    assert close_s < 3.0, close_s
    assert "error" in outcome and "closed" in outcome["error"], outcome
    s1.stop()
    s2.stop()


# -- the acceptance test ------------------------------------------------------

def test_ha_acceptance_replica_kill_and_rolling_restart_zero_failures():
    """2 replicas behind the router under sustained load; hard-kill one
    (``serving.replica_down``): no client-visible failure, the dead
    replica is ejected and re-admitted when it returns; then a rolling
    restart (drain -> stop -> start, one replica at a time) completes with
    no dropped request, ``/healthz`` reflecting the transitions."""
    f1 = FaultRegistry()
    servers = [_serve(_model(), faults=f1), _serve(_model())]
    names = [f"{s.host}:{s.port}" for s in servers]
    ports = [s.port for s in servers]
    rs = ReplicaSet([(s.host, s.port) for s in servers],
                    retry=_fast_retry(max_attempts=4),
                    health_interval=0.08, health_timeout=0.5,
                    breaker_threshold=3, breaker_reset_s=0.2)
    fe = HTTPFrontend(router=rs).start()
    url = f"http://{fe.host}:{fe.port}/healthz"
    rows = ids(4, seed=202)
    want = MODEL.predict(rows)

    stop_load = threading.Event()
    failures, served = [], []
    hz_samples = []

    def load(i):
        while not stop_load.is_set():
            try:
                out = fe.predict(rows[i], deadline=15.0)
            except Exception as e:  # noqa: BLE001 — the failure record
                failures.append(f"{type(e).__name__}: {e}")
                continue
            if out is None:
                failures.append("timeout")
            elif not np.allclose(out, want[i], atol=1e-4, rtol=1e-4):
                failures.append(f"row {i}: wrong logits {out}")
            else:
                served.append(1)

    def poll_healthz():
        while not stop_load.is_set():
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    hz_samples.append(json.load(r))
            except urllib.error.HTTPError as e:
                hz_samples.append(json.load(e))
            except OSError:
                pass
            time.sleep(0.04)

    def back(i):
        rep = rs.healthz()["replicas"][names[i]]
        return rep["available"] and rep["breaker"] == "closed"

    threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
    poller = threading.Thread(target=poll_healthz)
    for t in threads + [poller]:
        t.start()
    try:
        _wait(lambda: len(served) >= 20 or failures, "no steady load")
        n_steady = len(served)
        assert n_steady > 0 and not failures

        # ---- phase 1: hard-kill replica 0 under load --------------------
        f1.enable("serving.replica_down", times=1)
        _wait(servers[0]._stop.is_set, "kill fault never fired", 10)
        # the dead replica leaves rotation while the load keeps flowing
        # on the sibling; its circuit opened (the breaker), so it costs
        # nothing
        _wait(lambda: not rs.healthz()["replicas"][names[0]]["available"],
              "killed replica still available")
        snap = metrics_lib.get_registry().snapshot()
        assert snap.get(f"router.breaker_opens{{replica={names[0]}}}",
                        0) >= 1
        n_killed = len(served)
        _wait(lambda: len(served) >= n_killed + 20 or failures,
              "no load on the surviving replica")

        # ---- replica returns: health re-admits, circuit closed ----------
        servers[0] = _restart_on_port(_model(), ports[0])
        _wait(lambda: back(0), "replica never re-admitted")

        # ---- phase 2: rolling restart under load ------------------------
        for i in range(len(servers)):
            assert servers[i].drain(timeout=15.0), "drain never settled"
            servers[i].stop()
            servers[i] = _restart_on_port(_model(), ports[i])
            _wait(lambda: back(i), f"replica {names[i]} never returned")
        n_restarted = len(served)
        _wait(lambda: len(served) >= n_restarted + 20 or failures,
              "no load after the restarts")
        time.sleep(0.2)  # a few healthz samples of the final state
    finally:
        stop_load.set()
        for t in threads + [poller]:
            t.join(timeout=20)
        fe.stop()
        for s in servers:
            s.stop()
    assert not any(t.is_alive() for t in threads + [poller])

    assert failures == [], failures[:5]
    assert len(served) > n_steady            # load really ran throughout
    statuses = [h["status"] for h in hz_samples]
    assert "degraded" in statuses or "down" in statuses
    assert statuses[-1] == "ok", statuses[-10:]
    seen_states = {rep["state"] for h in hz_samples
                   for rep in h["replicas"].values()}
    assert "draining" in seen_states or "stopped" in seen_states, \
        seen_states
    assert all(s.stats()["replies"] > 0 for s in servers)
