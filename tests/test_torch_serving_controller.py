"""Twin of ``tests/test_controller.py`` for the port, against a small BERT
served by the port's ``InferenceModel`` on the CPU: windowed metrics
helpers, runtime pool membership, per-class admission, self-tuning
hedging, and the ``ServingController`` observe -> decide -> actuate loop
over ``InProcessReplicaFactory`` (``SubprocessReplicaFactory`` waits for
the state plane).

Ticks are driven by hand.  The scale-up test sets its SLO from the
latency it measures for calm traffic on this host (eight times the median
calm request), so that a burst of sixteen closed-loop clients on one-row
batches, which queue about fifteen requests deep, breaches it, while
calm traffic stays under the policy's low-water mark (half the SLO) even
when a busy host slows a calm request three- or fourfold.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core.faults import FaultRegistry
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             HysteresisPolicy,
                                             InProcessReplicaFactory,
                                             InputQueue, OutputQueue,
                                             ReplicaSet, RetryPolicy,
                                             ServingController)
from analytics_zoo_tpu_torch.serving import controller as controller_lib
from analytics_zoo_tpu_torch.serving import protocol

from _torch_serving import (Served, bert, close, expect, ids,
                            no_leaked_port_controllers, one_torch_thread,
                            port_faults_disarmed, port_telemetry_reset)

MODEL = bert(0)
X = ids(1, seed=300)[0]
WANT = expect(MODEL, X)


def _serve(delay: float = 0.0, **kw) -> ClusterServing:
    kw.setdefault("batch_size", 4)
    kw.setdefault("batch_timeout_ms", 2)
    return ClusterServing(Served(MODEL, delay), port=0, **kw).start()


def _fast_retry(**kw) -> RetryPolicy:
    kw.setdefault("max_attempts", 3)
    kw.setdefault("base_delay", 0.02)
    kw.setdefault("max_delay", 0.1)
    kw.setdefault("seed", 0)
    return RetryPolicy(**kw)


# -- metrics: public windowed-quantile API --------------------------------------

def test_histogram_quantile_and_snapshot_delta():
    reg = metrics_lib.MetricsRegistry()
    h = reg.histogram("t.ms")
    for _ in range(90):
        h.observe(5.0)
    prev = reg.snapshot()
    assert h.quantile(0.5) == pytest.approx(h.percentile(0.5))
    for _ in range(10):
        h.observe(500.0)
    reg.counter("t.count").inc(7)
    delta = metrics_lib.snapshot_delta(prev, reg.snapshot())
    assert delta["t.count"] == 7
    w = delta["t.ms"]
    assert w["count"] == 10
    assert metrics_lib.quantile_from_snapshot(w, 0.5) > 100.0
    assert metrics_lib.quantile_from_snapshot(delta["t.count"], 0.5) is None
    empty = metrics_lib.snapshot_delta(reg.snapshot(), reg.snapshot())
    assert metrics_lib.quantile_from_snapshot(
        empty.get("t.ms", {"count": 0}), 0.5) in (None,)


def test_snapshot_delta_series_absent_from_baseline():
    reg = metrics_lib.MetricsRegistry()
    prev = reg.snapshot()
    reg.counter("fresh.count").inc(3)
    delta = metrics_lib.snapshot_delta(prev, reg.snapshot())
    assert delta["fresh.count"] == 3


# -- router: runtime pool membership --------------------------------------------

def test_add_remove_replica_updates_pool_and_metrics():
    reg = metrics_lib.get_registry()
    a, b = _serve(), _serve()
    rs = ReplicaSet([(a.host, a.port)], start_health=False)
    try:
        assert len(rs.replicas) == 1
        rep = rs.add_replica((b.host, b.port))
        assert len(rs.replicas) == 2
        snap = reg.snapshot()
        assert snap["router.replicas"]["value"] == 2
        assert snap["router.scale_events{direction=up}"] == 1
        for _ in range(8):
            close(rs.predict(X), WANT)
        with pytest.raises(ValueError):
            rs.add_replica((b.host, b.port))
        assert rs.remove_replica(rep, drain=True) is True
        assert len(rs.replicas) == 1
        snap = reg.snapshot()
        assert snap["router.replicas"]["value"] == 1
        assert snap["router.scale_events{direction=down}"] == 1
        assert f"router.requests{{replica={rep.name}}}" not in snap
        with pytest.raises(ValueError):
            rs.remove_replica((b.host, b.port))
        with pytest.raises(ValueError):
            rs.remove_replica((a.host, a.port))
    finally:
        rs.close()
        a.stop()
        b.stop()


# -- per-class admission ---------------------------------------------------------

def test_admission_gate_sheds_batch_first():
    srv = _serve()
    try:
        srv._wait_ewma = 50.0
        srv._m_depth.set(2)
        assert srv._admission_reject(80.0, klass="interactive") is None
        assert srv._admission_reject(80.0, klass=None) is None
        rej = srv._admission_reject(80.0, klass="batch")
        assert rej is not None and "batch margin" in rej
        srv._wait_ewma = 0.0
        srv.admission_queue_limit = 4
        assert srv._admission_reject(None, klass="interactive") is None
        assert "queue full" in srv._admission_reject(None, klass="batch")
    finally:
        srv._m_depth.set(0)
        srv.stop()


def test_klass_rides_header_and_counts():
    h = protocol.request_header("u", klass="batch")
    assert h["klass"] == "batch"
    assert "klass" not in protocol.request_header("u")
    srv = _serve()
    iq = InputQueue(srv.host, srv.port)
    oq = OutputQueue(input_queue=iq)
    try:
        for klass in ("interactive", "batch", None):
            uid = iq.enqueue("t", klass=klass, t=X)
            close(oq.query(uid, timeout=10.0), WANT)
        snap = metrics_lib.get_registry().snapshot()
        assert snap["server.requests{klass=interactive}"] == 1
        assert snap["server.requests{klass=batch}"] == 1
        assert snap["server.requests"] == 3
    finally:
        iq.close()
        srv.stop()


def test_interactive_holds_while_batch_sheds():
    private = FaultRegistry()
    srv = _serve(batch_size=1, batch_timeout_ms=1, faults=private,
                 admission_queue_limit=6)
    iq = InputQueue(srv.host, srv.port, retry=_fast_retry(max_attempts=2))
    oq = OutputQueue(input_queue=iq)
    try:
        private.enable("serving.model_latency", times=1, delay=0.5)
        uids = [iq.enqueue("t", klass="interactive", t=X)
                for _ in range(4)]
        time.sleep(0.1)  # let depth register
        with pytest.raises(RuntimeError, match="queue full"):
            uid_b = iq.enqueue("t", klass="batch", t=X)
            oq.query(uid_b, timeout=5.0)
        for uid in uids:
            close(oq.query(uid, timeout=10.0), WANT)
        snap = metrics_lib.get_registry().snapshot()
        assert snap.get("server.admission_rejected{klass=batch}", 0) >= 1
        assert "server.admission_rejected{klass=interactive}" not in snap
    finally:
        iq.close()
        srv.stop()


# -- self-tuning hedging ---------------------------------------------------------

def test_hedge_auto_retunes_freezes_and_tracks():
    reg = metrics_lib.get_registry()
    rs = ReplicaSet([("127.0.0.1", 1)], hedge_ms="auto",
                    hedge_min_samples=20, hedge_margin_ms=5.0,
                    start_health=False)
    try:
        assert rs.hedge_auto and rs.hedge_ms is None
        h = reg.histogram("client.request_ms", replica="127.0.0.1:1")
        for _ in range(50):
            h.observe(20.0)
        first = rs.retune_hedge()
        assert first is not None and first < 60.0
        for _ in range(5):
            h.observe(500.0)
        assert rs.retune_hedge() == first
        for _ in range(45):
            h.observe(500.0)
        shifted = rs.retune_hedge()
        assert shifted > first and shifted > 100.0
        snap = reg.snapshot()
        assert snap["router.hedge_retunes"] == 2
        assert snap["router.hedge_ms"]["value"] == pytest.approx(shifted)
    finally:
        rs.close()


def test_hedge_numeric_is_untouched_by_retune():
    rs = ReplicaSet([("127.0.0.1", 1)], hedge_ms=50.0, start_health=False)
    try:
        assert not rs.hedge_auto
        assert rs.retune_hedge() == 50.0
        assert rs.hedge_ms == 50.0
        assert metrics_lib.get_registry().snapshot().get(
            "router.hedge_retunes", 0) == 0
    finally:
        rs.close()


def test_hedge_auto_tracks_injected_latency_shift():
    private = FaultRegistry()
    srv = _serve(faults=private)
    rs = ReplicaSet([(srv.host, srv.port)], hedge_ms="auto",
                    hedge_min_samples=10, start_health=False)
    try:
        for _ in range(15):
            rs.predict(X)
        fast = rs.retune_hedge()
        assert fast is not None
        private.enable("serving.model_latency", times=15, delay=0.12)
        for _ in range(15):
            rs.predict(X)
        slow = rs.retune_hedge()
        assert slow > fast and slow >= 100.0
    finally:
        rs.close()
        srv.stop()


# -- scaling policy (pure unit) ---------------------------------------------------

def test_hysteresis_policy_decisions():
    pol = HysteresisPolicy(slo_p99_ms=100.0, queue_high=50.0,
                           min_replicas=1, max_replicas=3,
                           up_cooldown_s=10.0, down_cooldown_s=30.0,
                           low_water_frac=0.5, down_ticks=2)

    def sig(now, p99, depth, n):
        return {"now": now, "p99_ms": p99, "queue_depth": depth,
                "replicas": n, "window_requests": 100}

    assert pol.decide(sig(0.0, 150.0, 0.0, 1)) == 1      # SLO breach
    assert pol.decide(sig(5.0, 150.0, 0.0, 2)) == 0      # up cooldown
    assert pol.decide(sig(20.0, 50.0, 60.0, 2)) == 1     # queue high-water
    assert pol.decide(sig(40.0, 150.0, 0.0, 3)) == 0     # at max
    assert pol.decide(sig(60.0, 10.0, 0.0, 3)) == 0
    assert pol.decide(sig(61.0, 80.0, 0.0, 3)) == 0      # not calm: resets
    assert pol.decide(sig(62.0, 10.0, 0.0, 3)) == 0
    assert pol.decide(sig(63.0, None, 0.0, 3)) == -1     # idle counts calm
    assert pol.decide(sig(64.0, 10.0, 0.0, 2)) == 0
    assert pol.decide(sig(65.0, 10.0, 0.0, 2)) == 0
    assert pol.decide(sig(94.0, 10.0, 0.0, 2)) == -1
    assert pol.decide(sig(200.0, 10.0, 0.0, 1)) == 0
    assert pol.decide(sig(201.0, 10.0, 0.0, 1)) == 0
    with pytest.raises(ValueError):
        HysteresisPolicy(slo_p99_ms=10.0, min_replicas=3, max_replicas=2)


# -- the controller ---------------------------------------------------------------

def test_controller_scales_up_then_down_with_zero_errors(tmp_path):
    """A load step pushes p99 over the SLO -> the controller creates a
    warm in-process replica and joins it; when load drops it drains and
    retires the same replica: no client error end to end, and the
    scale-down leaves a flight record naming the retired replica and the
    triggering metrics."""
    def serve():
        return _serve(delay=0.01, batch_size=1, batch_timeout_ms=1)

    seed = serve()
    rs = ReplicaSet([(seed.host, seed.port)], start_health=False)
    created = []

    def make():
        created.append(serve())
        return created[-1]

    pol = HysteresisPolicy(slo_p99_ms=1e9, min_replicas=1,
                           max_replicas=2, up_cooldown_s=0.0,
                           down_cooldown_s=0.0, down_ticks=2)
    ctl = ServingController(rs, InProcessReplicaFactory(make), policy=pol,
                            interval_s=60.0, flightrec_dir=str(tmp_path))
    errors = []
    calm_ms = []

    def drive(n, times=None):
        for _ in range(n):
            t0 = time.monotonic()
            try:
                close(rs.predict(X, deadline=10.0), WANT)
            except Exception as e:  # noqa: BLE001 - counted, not masked
                errors.append(e)
            if times is not None:
                times.append((time.monotonic() - t0) * 1e3)

    try:
        # calm baseline: a sequential trickle, timed on this host (after
        # one request that opens the router's connection)
        drive(1)
        drive(5, calm_ms)
        pol.slo_p99_ms = 8.0 * float(np.median(calm_ms))
        assert ctl.tick() == 0 and len(rs.replicas) == 1
        # the step: sixteen closed-loop clients queue behind one-row
        # batches, about fifteen requests deep
        threads = [threading.Thread(target=drive, args=(8,))
                   for _ in range(16)]
        for t in threads:
            t.start()
        time.sleep(0.3)  # mid-burst: the tick sees hot signals
        assert ctl.tick() == 1, (pol.slo_p99_ms, calm_ms)
        assert len(rs.replicas) == 2
        for t in threads:
            t.join(timeout=60)
        # the tick that closes the burst's window: the requests answered
        # after the mid-burst tick (hot, but the pool is at its maximum)
        assert ctl.tick() == 0 and len(rs.replicas) == 2
        # load drops: two calm ticks later the added replica drains out
        drive(3)
        ctl.tick()
        assert ctl.tick() == -1
        assert len(rs.replicas) == 1
        assert not errors, errors
        assert [e["direction"] for e in ctl.events] == ["up", "down"]
        snap = metrics_lib.get_registry().snapshot()
        assert snap["controller.scale_ups"] == 1
        assert snap["controller.scale_downs"] == 1
        assert snap.get("controller.errors", 0) == 0
        dumps = [f for f in os.listdir(tmp_path) if "flightrec" in f]
        assert dumps, os.listdir(tmp_path)
        rec = json.loads((tmp_path / dumps[0]).read_text())
        assert rec["reason"] == "scale_down"
        ctx = rec["context"]
        assert ctx["replica"] == ctl.events[-1]["replica"]
        assert "p99_ms" in ctx and "queue_depth" in ctx
        assert all(s.state == "stopped" for s in created)
    finally:
        ctl.close()
        rs.close()
        seed.stop()


def test_controller_retunes_auto_hedge_each_tick():
    seed = _serve()
    rs = ReplicaSet([(seed.host, seed.port)], hedge_ms="auto",
                    hedge_min_samples=5, start_health=False)
    ctl = ServingController(rs, InProcessReplicaFactory(_serve),
                            policy=HysteresisPolicy(slo_p99_ms=1e9),
                            interval_s=60.0)
    try:
        for _ in range(10):
            rs.predict(X)
        assert rs.hedge_ms is None
        ctl.tick()
        assert rs.hedge_ms is not None
        assert metrics_lib.get_registry().snapshot()[
            "router.hedge_retunes"] == 1
    finally:
        ctl.close()
        rs.close()
        seed.stop()


def test_controller_loop_thread_and_leak_accounting():
    seed = _serve()
    rs = ReplicaSet([(seed.host, seed.port)], start_health=False)
    ctl = ServingController(rs, InProcessReplicaFactory(_serve),
                            policy=HysteresisPolicy(slo_p99_ms=1e9),
                            interval_s=0.05)
    try:
        assert not ctl.running
        assert ctl not in controller_lib.live_controllers()
        ctl.start()
        assert ctl.running
        assert ctl in controller_lib.live_controllers()
        deadline = time.monotonic() + 5.0
        reg = metrics_lib.get_registry()
        while time.monotonic() < deadline:
            if reg.snapshot().get("controller.ticks", 0) >= 2:
                break
            time.sleep(0.02)
        assert reg.snapshot().get("controller.ticks", 0) >= 2
        ctl.stop()
        assert not ctl.running
        assert ctl not in controller_lib.live_controllers()
    finally:
        ctl.close()
        rs.close()
        seed.stop()


def test_controller_close_retires_managed_replicas():
    seed = _serve(delay=0.01)
    rs = ReplicaSet([(seed.host, seed.port)], start_health=False)
    created = []

    def make():
        srv = _serve(delay=0.01)
        created.append(srv)
        return srv

    pol = HysteresisPolicy(slo_p99_ms=1.0, min_replicas=1, max_replicas=2,
                           up_cooldown_s=0.0)
    ctl = ServingController(rs, InProcessReplicaFactory(make), policy=pol,
                            interval_s=60.0)
    try:
        threads = [threading.Thread(
            target=lambda: [rs.predict(X) for _ in range(5)])
            for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        assert ctl.tick() == 1 and len(rs.replicas) == 2
        for t in threads:
            t.join(timeout=60)
    finally:
        ctl.close()  # retires the created replica: pool back to 1
        assert len(rs.replicas) == 1
        assert all(s.state == "stopped" for s in created)
        rs.close()
        seed.stop()
