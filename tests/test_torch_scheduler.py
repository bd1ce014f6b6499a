"""Twin of ``tests/test_scheduler.py`` for the port, against a small BERT
served by the port's ``InferenceModel`` on the CPU.

The scheduler subsystem (window against continuous admission,
weighted-fair dequeue across models, the backlog drained at ``stop()``),
the ``ModelRegistry`` (routing, version pins, in-flight drain accounting),
the warm-before-flip hot swap (a version swap under four client threads
with no client-visible failure and no key prepared once traffic flows:
``compile_count`` asserted), the executables' manifest across versions,
and the HTTP frontend's routing by model.  Where the JAX test's stand-in
multiplies by ``k``, here a model version is a BERT made from seed ``k``
and a reply is held against that version's own ``predict`` of the row
within ``TOL``.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np
import pytest

from analytics_zoo_tpu_torch.core import metrics
from analytics_zoo_tpu_torch.core.config import ZooConfig
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             ContinuousScheduler,
                                             HTTPFrontend, InputQueue,
                                             ModelRegistry, OutputQueue,
                                             WindowScheduler)
from analytics_zoo_tpu_torch.serving import scheduler as scheduler_lib
from analytics_zoo_tpu_torch.serving.server import _Pending

from _torch_serving import (SEQ, TOL, Served, bert, close, expect, ids,
                            no_leaked_port_controllers, one_torch_thread,
                            port_faults_disarmed, port_telemetry_reset)

ROW = ids(1, seed=100)[0]


def _roundtrip(srv, arr, model=None, version=None, timeout=15.0):
    iq = InputQueue(srv.host, srv.port)
    oq = OutputQueue(input_queue=iq)
    try:
        uid = iq.enqueue("t", model=model, version=version, t=arr)
        return oq.query(uid, timeout=timeout)
    finally:
        iq.close()


def _pend(uid, model=None):
    return _Pending(uid, ROW, None, None, None, model=model)


# -- scheduler construction ---------------------------------------------------

def test_scheduler_factory_and_default():
    assert isinstance(scheduler_lib.make("window"), WindowScheduler)
    assert isinstance(scheduler_lib.make("continuous"),
                      ContinuousScheduler)
    pre = ContinuousScheduler(backlog_factor=2)
    assert scheduler_lib.make(pre) is pre
    with pytest.raises(ValueError, match="unknown scheduler"):
        scheduler_lib.make("nope")
    with pytest.raises(ValueError):
        ContinuousScheduler(backlog_factor=0)
    srv = ClusterServing(bert(0), batch_size=4)
    try:
        assert srv.scheduler.name == "window"  # bisection default
        assert srv.stats()["scheduler"] == "window"
        assert srv.inference_workers == ZooConfig().inference_workers == 2
    finally:
        srv.stop()


def test_zoo_config_grows_scheduler_and_models_knobs():
    cfg = ZooConfig.from_dict({"scheduler": "continuous",
                               "models": {"a": "/models/a"}})
    assert cfg.scheduler == "continuous"
    assert cfg.models == {"a": "/models/a"}
    assert ZooConfig().scheduler == "window"


# -- continuous admission -----------------------------------------------------

def test_continuous_round_trip_and_invariant():
    """Rows of three lengths (three shape groups) through continuous
    admission, each answered with its own logits."""
    model = bert(0)
    with ClusterServing(model, batch_size=4,
                        scheduler="continuous") as srv:
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        rows = [ids(1, seed=i, seq=10 + i % 3)[0] for i in range(12)]
        uids = [iq.enqueue("t", t=r) for r in rows]
        for r, uid in zip(rows, uids):
            close(oq.query(uid, timeout=15.0), expect(model, r))
        st = srv.stats()
        assert st["requests"] == st["replies"] + st["errors"] \
            + st["pending"]
        assert st["pending"] == 0
        iq.close()


def test_continuous_has_no_window_tail():
    """A lone request must NOT wait out ``batch_timeout_ms``: the window
    batcher holds the batch open hoping for more rows; continuous
    admission dispatches what has arrived."""
    model = bert(0)

    def lone_latency(scheduler):
        with ClusterServing(model, batch_size=8, batch_timeout_ms=150,
                            scheduler=scheduler) as srv:
            iq = InputQueue(srv.host, srv.port)
            oq = OutputQueue(input_queue=iq)
            # warm the path (connection setup out of the clock)
            oq.query(iq.enqueue("w", t=ROW), 15.0)
            t0 = time.monotonic()
            assert oq.query(iq.enqueue("t", t=ROW), 15.0) is not None
            dt = time.monotonic() - t0
            iq.close()
        return dt

    assert lone_latency("window") > 0.12       # the tail is real
    assert lone_latency("continuous") < 0.10   # and continuous skips it


def test_continuous_answers_health_pings():
    with ClusterServing(bert(0), scheduler="continuous") as srv:
        iq = InputQueue(srv.host, srv.port)
        pong = iq.conn.ping(timeout=5.0)
        assert pong is not None and pong["state"] == "serving"
        iq.close()


def test_continuous_stop_drains_backlog_with_explicit_replies():
    """Rows parked in the scheduler's backlog at stop() must get the
    explicit ``server shutting down`` reply, not a silent timeout."""
    with ClusterServing(Served(bert(0), delay=0.3), batch_size=1,
                        inference_workers=1,
                        scheduler="continuous") as srv:
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        uids = [iq.enqueue("t", t=ROW) for _ in range(6)]
        time.sleep(0.15)  # let the scheduler pull rows into its backlog
        outcomes = []

        def drain_queries():
            for uid in uids:
                try:
                    r = oq.query(uid, timeout=10.0)
                    outcomes.append("ok" if r is not None else "timeout")
                except (RuntimeError, OSError):
                    outcomes.append("error")

        t = threading.Thread(target=drain_queries)
        t.start()
        srv.stop()
        t.join(timeout=30)
        assert not t.is_alive()
        assert len(outcomes) == len(uids)
        assert "timeout" not in outcomes, outcomes
        st = srv.stats()
        assert st["drained"] >= 1, st
        assert st["replies"] + st["errors"] >= len(uids), st
        iq.close()


def test_weighted_fair_admission_across_models():
    """With both backlogs full, one admission round realizes the weight
    ratio (3:1 over a batch of 8 -> 6 and 2 rows); a higher-priority
    tier drains before any lower-tier row is admitted."""
    reg = ModelRegistry()
    reg.register("heavy", bert(0), weight=3.0)
    reg.register("light", bert(1), weight=1.0)
    reg.register("urgent", bert(2), weight=1.0, priority=1)
    srv = ClusterServing(models=reg, batch_size=8,
                         scheduler="continuous")
    try:
        sched = srv.scheduler

        def pend(name, n):
            return deque(_pend(f"{name}-{i}", model=name) for i in range(n))

        sched._backlog = {"heavy": pend("heavy", 20),
                          "light": pend("light", 20),
                          "urgent": pend("urgent", 3)}
        batch = sched._admit(srv)
        assert len(batch) == 8
        by_model = {}
        for p in batch:
            by_model[p.model] = by_model.get(p.model, 0) + 1
        assert by_model["urgent"] == 3  # the whole priority tier
        assert by_model["heavy"] > by_model["light"] >= 1, by_model

        sched._backlog = {"heavy": pend("heavy", 20),
                          "light": pend("light", 20)}
        batch = sched._admit(srv)
        counts = {}
        for p in batch:
            counts[p.model] = counts.get(p.model, 0) + 1
        assert counts == {"heavy": 6, "light": 2}, counts
    finally:
        # the synthetic rows have no sockets for stop()'s drain replies
        sched._backlog.clear()
        srv.stop()


def test_continuous_per_model_backlog_cap_and_held_row():
    """The backlog bound is PER MODEL: a flooding model parks at
    ``batch_size * backlog_factor`` rows (plus one held) while another
    model's rows still reach their own backlog; held rows stay visible to
    stats and to stop()'s drain."""
    reg = ModelRegistry()
    reg.register("heavy", bert(0))
    reg.register("light", bert(1), weight=3.0)

    rows = ([_pend(f"heavy-{i}", "heavy") for i in range(4)]
            + [_pend("light-0", "light"), _pend("light-1", "light")]
            + [_pend("heavy-4", "heavy"), _pend("heavy-5", "heavy")])

    class _Queue:
        def __init__(self, items):
            self.items = deque(items)

        def pop(self, timeout=0.0):
            return (self.items.popleft(),) if self.items else None

    class _Srv:
        batch_size = 4
        _default_name = "default"
        registry = reg
        _queue = _Queue(rows)

        @staticmethod
        def _take(p):
            return p

    sched = ContinuousScheduler(backlog_factor=1)  # per-model cap = 4
    assert sched._fill(_Srv)
    assert len(sched._backlog["heavy"]) == 4
    assert len(sched._backlog["light"]) == 2
    assert sched._held is not None and sched._held.model == "heavy"
    assert len(_Srv._queue.items) == 1
    assert sched.backlog() == 7  # 4 + 2 + held
    batch = sched._admit(_Srv)
    by_model = {}
    for p in batch:
        by_model[p.model] = by_model.get(p.model, 0) + 1
    assert by_model["light"] >= 2  # weight 3 model is not starved
    assert sched._fill(_Srv)
    assert sched._held is None and not _Srv._queue.items
    sched._held = _pend("heavy-9", "heavy")
    drained = sched.drain_rows()
    assert {p.uuid for p in drained} >= {"heavy-9"} \
        and sched.backlog() == 0


def test_scheduler_attach_rejects_second_server():
    sched = ContinuousScheduler()
    a = ClusterServing(bert(0), scheduler=sched)
    try:
        with pytest.raises(ValueError, match="already attached"):
            ClusterServing(bert(0), scheduler=sched)
    finally:
        a.stop()


def test_admission_gate_counts_scheduler_backlog():
    """The continuous scheduler drains the native queue into its backlog,
    so the admission gate counts backlog rows too."""
    srv = ClusterServing(bert(0), batch_size=4, scheduler="continuous",
                         admission_queue_limit=3)
    try:
        assert srv._admission_reject(None) is None
        srv.scheduler._backlog = {"default": deque(
            _pend(f"u{i}") for i in range(3))}
        reason = srv._admission_reject(None)
        assert reason is not None and "queue full" in reason
        srv.scheduler._backlog["default"] = deque([_pend("u")])
        srv._wait_ewma = 50.0
        assert "deadline unattainable" in srv._admission_reject(1)
    finally:
        srv.scheduler._backlog.clear()
        srv.stop()


def test_init_failure_closes_listening_socket():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(ValueError, match="unknown scheduler"):
        ClusterServing(bert(0), port=port, scheduler="continuos")
    srv = ClusterServing(bert(0), port=port)  # port must be free
    srv.stop()


# -- model registry -----------------------------------------------------------

def test_resolve_begin_is_atomic_with_drain():
    reg = ModelRegistry()
    reg.register("m", bert(0))
    m, name, ver = reg.resolve("m", begin=True)
    assert reg.inflight("m", ver) == 1
    assert not reg.drain_version("m", ver, timeout=0.05)
    reg.done(name, ver)
    assert reg.drain_version("m", ver, timeout=0.05)


def test_unload_retires_per_version_metric_series():
    reg = metrics.MetricsRegistry()
    v1, v2 = bert(0), bert(1)
    with ClusterServing(v1, batch_size=4, metrics=reg) as srv:
        close(_roundtrip(srv, ROW), expect(v1, ROW))
        v1_series = "server.requests{model=default,version=v1}"
        assert v1_series in reg.snapshot()
        srv.update_model(v2)  # keep_old=False: unloads v1
        close(_roundtrip(srv, ROW), expect(v2, ROW))
        snap = reg.snapshot()
        assert v1_series not in snap, "v1 series must retire with v1"
        assert "server.requests{model=default,version=v2}" in snap
        assert ("default", "v1") not in srv._m_model_series
        c, hist = srv._model_series("default", "v1")
        c.inc()
        hist.observe(4)
        assert v1_series not in reg.snapshot(), "series resurrected"


def test_stopped_servers_deregister_registry_unload_hook():
    reg = ModelRegistry()
    reg.register("m", bert(0))
    for _ in range(3):
        srv = ClusterServing(models=reg, batch_size=4)
        srv.stop()
    assert not reg._unload_hooks


def test_registry_metrics_repoint_across_server_lifecycles():
    reg = ModelRegistry()
    reg.register("m", bert(0))
    m_a, m_b = metrics.MetricsRegistry(), metrics.MetricsRegistry()
    ClusterServing(models=reg, batch_size=4, metrics=m_a).stop()
    srv = ClusterServing(models=reg, batch_size=4, metrics=m_b)
    try:
        reg.swap("m", bert(1), keep_old=False)
        assert m_b.snapshot()["registry.swaps"] == 1
        assert m_a.snapshot()["registry.swaps"] == 0
    finally:
        srv.stop()
    own = metrics.MetricsRegistry()
    reg2 = ModelRegistry(metrics=own)
    reg2.register("m", bert(0))
    srv2 = ClusterServing(models=reg2, batch_size=4, metrics=m_a)
    try:
        reg2.swap("m", bert(1), keep_old=False)
        assert own.snapshot()["registry.swaps"] == 1
    finally:
        srv2.stop()


def test_canary_pin_on_active_version_merges_into_one_batch():
    model = bert(0)
    with ClusterServing(model, batch_size=4, batch_timeout_ms=400) as srv:
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        u1 = iq.enqueue("a", t=ROW)                 # unpinned
        u2 = iq.enqueue("b", version="v1", t=ROW)   # pinned to the active
        close(oq.query(u1, timeout=15.0), expect(model, ROW))
        close(oq.query(u2, timeout=15.0), expect(model, ROW))
        assert srv.stats()["batches"] == 1, srv.stats()
        iq.close()


def test_warm_from_rebuckets_to_incoming_models_buckets():
    """warm_from warms the shapes THIS model pads to, not the outgoing
    model's bucket keys verbatim."""
    im1 = bert(0, buckets=(16,))
    im1.predict(ids(3))                 # realizes old bucket 16
    im2 = bert(1, buckets=(4, 32))
    assert im2.warm_from(im1) == 2      # re-bucketed to im2's own 4 and 32
    pre = im2.compile_count
    im2.predict(ids(3))                 # pads to ITS bucket 4
    im2.predict(ids(20))                # pads to ITS bucket 32
    assert im2.compile_count == pre, "post-swap serve prepared cold"


def test_registry_routing_version_pin_and_swap_metric():
    reg = ModelRegistry()
    m1, m2 = bert(0), bert(1)
    v1 = reg.register("m", m1)
    assert v1 == "v1" and reg.active_version("m") == "v1"
    with ClusterServing(models=reg, batch_size=4,
                        scheduler="continuous") as srv:
        close(_roundtrip(srv, ROW, model="m"), expect(m1, ROW))
        v2 = reg.swap("m", m2)
        assert v2 == "v2" and reg.active_version("m") == "v2"
        close(_roundtrip(srv, ROW, model="m"), expect(m2, ROW))
        # canary pin: the old version stays loaded and addressable
        close(_roundtrip(srv, ROW, model="m", version="v1"),
              expect(m1, ROW))
        snap = metrics.get_registry().snapshot()
        assert snap["registry.swaps"] == 1
        assert snap["server.requests{model=m,version=v1}"] >= 2
        assert snap["server.requests{model=m,version=v2}"] >= 1
        assert snap["server.batch_size{model=m}"]["count"] >= 3
        assert any(k.startswith("scheduler.admitted_rows{")
                   for k in snap)


def test_unroutable_requests_get_explicit_errors():
    reg = ModelRegistry()
    reg.register("a", bert(0))
    reg.register("b", bert(1))
    with ClusterServing(models=reg, batch_size=4) as srv:
        with pytest.raises(RuntimeError, match="unknown model"):
            _roundtrip(srv, ROW, model="nope")
        with pytest.raises(RuntimeError, match="unknown version"):
            _roundtrip(srv, ROW, model="a", version="v9")
        with pytest.raises(RuntimeError, match="no model specified"):
            _roundtrip(srv, ROW)
        assert srv.stats()["unknown_model"] == 3


def test_registry_swap_drains_old_version_inflight():
    reg = ModelRegistry()
    reg.register("m", bert(0))
    reg.begin("m", "v1")
    state = {}

    def do_swap():
        reg.swap("m", bert(1), drain=True, drain_timeout=10.0)
        state["done"] = time.monotonic()

    t = threading.Thread(target=do_swap)
    t.start()
    deadline = time.monotonic() + 10
    while reg.active_version("m") != "v2":
        assert time.monotonic() < deadline, "the flip never happened"
        time.sleep(0.01)
    time.sleep(0.1)
    # flipped (new traffic goes to v2), still waiting on v1's batch
    assert "done" not in state
    reg.done("m", "v1")
    t.join(timeout=10)
    assert "done" in state
    assert reg.inflight("m", "v1") == 0


def test_registry_guards():
    reg = ModelRegistry()
    reg.register("m", bert(0))
    with pytest.raises(ValueError, match="already has a version"):
        reg.register("m", bert(1), version="v1")
    with pytest.raises(ValueError, match="weight"):
        reg.register("w", bert(0), weight=0.0)
    with pytest.raises(KeyError):
        reg.resolve("ghost")
    with pytest.raises(KeyError):
        reg.swap("ghost", bert(0))
    with pytest.raises(ValueError, match="active"):
        reg.unload("m", "v1")
    reg.register("m", bert(1))  # v2, becomes active
    reg.unload("m", "v1")
    assert reg.versions("m") == ["v2"]
    assert reg.route_error("m", "v1") is not None
    assert reg.stats()["m"]["active"] == "v2"
    assert reg.swap("m", bert(2)) == "v3"
    assert reg.swap("m", bert(3), keep_old=False) == "v4"
    assert "v3" not in reg.versions("m")
    assert reg.active_version("m") == "v4"


def test_update_model_keeps_single_resident_version():
    models = [bert(k) for k in range(6)]
    srv = ClusterServing(models[0], batch_size=4)
    try:
        for m in models[1:5]:
            srv.update_model(m)
        assert len(srv.registry.versions("default")) == 1
        assert srv.model is models[4]
        srv.model = models[5]  # raw setter: same replace semantics
        assert len(srv.registry.versions("default")) == 1
        assert srv.model is models[5]
    finally:
        srv.stop()


def test_concurrent_swaps_serialize_and_leak_nothing():
    models = [bert(k % 4) for k in range(9)]
    srv = ClusterServing(models[0], batch_size=4)
    try:
        threads = [threading.Thread(target=srv.update_model, args=(m,))
                   for m in models[1:]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(srv.registry.versions("default")) == 1
        assert any(srv.model is m for m in models[1:])
    finally:
        srv.stop()


def test_multi_model_server_model_accessors_raise_clearly():
    srv = ClusterServing(models={"a": bert(0), "b": bert(1)}, batch_size=4)
    try:
        with pytest.raises(AttributeError, match="no single .model"):
            srv.model
        with pytest.raises(AttributeError, match="no single .model"):
            srv.model = bert(2)
        with pytest.raises(ValueError, match="registry.swap"):
            srv.update_model(bert(2))
    finally:
        srv.stop()


def test_prebuilt_registry_follows_injected_metrics():
    reg = ModelRegistry()
    reg.register("m", bert(0))
    custom = metrics.MetricsRegistry()
    srv = ClusterServing(models=reg, batch_size=4, metrics=custom)
    try:
        reg.swap("m", bert(1))
        assert custom.snapshot().get("registry.swaps") == 1
    finally:
        srv.stop()


# -- hot swap: warm before flip ----------------------------------------------

def test_update_model_warms_before_flip():
    """The incoming model is prepared for the active version's keys
    BEFORE the flip."""
    v1 = bert(0, buckets=(1, 4))
    v1.predict(ids(1))   # bucket 1
    v1.predict(ids(3))   # bucket 4
    assert v1.compile_count == 2
    v2 = bert(1, buckets=(1, 4))
    srv = ClusterServing(v1, batch_size=4)
    try:
        srv.update_model(v2)
        assert set(v2._compiled) >= set(v1._compiled)
        assert v2.compile_count == 2  # warmed, not cold-swapped
        assert srv.model is v2
    finally:
        srv.stop()


def test_hot_swap_under_load_zero_failures_zero_compiles():
    """Swapping the version under 4-thread client load: no client-visible
    failure, no key prepared after the warm (compile_count asserted), and
    the replies flip from v1's logits to v2's."""
    v1 = bert(0, buckets=(1, 4))
    v1.warm([(SEQ,)], dtype=np.int32)  # every bucket before the port opens
    v2 = bert(1, buckets=(1, 4))
    rows = ids(4, seed=7)
    want = {1: v1.predict(rows), 2: bert(1).predict(rows)}
    with ClusterServing(v1, batch_size=4, scheduler="continuous") as srv:
        stop_flag = threading.Event()
        failures = []
        seen = {1: 0, 2: 0}
        seen_lock = threading.Lock()

        def client(i):
            iq = InputQueue(srv.host, srv.port)
            oq = OutputQueue(input_queue=iq)
            try:
                while not stop_flag.is_set():
                    out = oq.query(iq.enqueue(f"c{i}", t=rows[i]),
                                   timeout=15.0)
                    if out is None:
                        failures.append("timeout")
                        continue
                    hit = [v for v in (1, 2) if np.allclose(
                        out, want[v][i], atol=TOL, rtol=TOL)]
                    if len(hit) != 1:
                        failures.append(f"garbage value {out}")
                        continue
                    with seen_lock:
                        seen[hit[0]] += 1
            except Exception as e:  # noqa: BLE001 — recorded
                failures.append(f"{type(e).__name__}: {e}")
            finally:
                iq.close()

        def wait_for(version, n):
            deadline = time.monotonic() + 30
            while seen[version] < n and not failures:
                assert time.monotonic() < deadline, (seen, failures)
                time.sleep(0.01)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            wait_for(1, 20)           # load flowing on v1
            srv.update_model(v2)      # warm -> flip, under load
            compiles_after_swap = v2.compile_count
            wait_for(2, 20)           # load flowing on v2
        finally:
            stop_flag.set()
            for t in threads:
                t.join(timeout=30)
        assert not failures, failures[:5]
        assert seen[1] > 0 and seen[2] > 0, seen
        assert v2.compile_count == compiles_after_swap
        assert v2.compile_count == len(v1._compiled)
        st = srv.stats()
        assert st["errors"] == 0, st
        assert st["requests"] == st["replies"], st
    assert metrics.get_registry().snapshot()["registry.swaps"] == 1


# -- executables' manifest across versions ------------------------------------

def test_aot_executables_persist_across_versions(tmp_path):
    """``save_executables``/``load_executables`` across two loaded versions
    of the same model: v2 (same structure, other weights) prepares v1's
    keys without counting them, and serves v2's logits."""
    x = ids(3, seed=8)
    im1 = bert(0, buckets=(1, 4))
    out1 = im1.predict(x)            # bucket 4
    im1.predict(x[:1])               # bucket 1
    assert im1.compile_count == 2
    assert im1.save_executables(str(tmp_path)) == 2

    im2 = bert(1, buckets=(1, 4))
    assert im2.load_executables(str(tmp_path)) == 2
    out2 = im2.predict(x)
    assert im2.compile_count == 0
    close(out2, bert(1, buckets=(1, 4)).predict(x))
    assert not np.allclose(out1, out2)


# -- HTTP frontend routing ----------------------------------------------------

def test_http_frontend_routes_by_model():
    reg = ModelRegistry()
    a, b = bert(0), bert(1)
    reg.register("a", a)
    reg.register("b", b)
    with ClusterServing(models=reg, batch_size=4) as srv:
        with HTTPFrontend(srv.host, srv.port) as fe:
            url = f"http://{fe.host}:{fe.port}/predict"

            def post(body):
                req = urllib.request.Request(
                    url, data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=15) as r:
                    return np.asarray(json.load(r)["predictions"],
                                      np.float32)

            row = {"instances": ROW.tolist(), "dtype": "int32"}
            close(post(dict(row, model="a")), expect(a, ROW))
            close(post(dict(row, model="b")), expect(b, ROW))
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(dict(row, model="ghost"))
            assert ei.value.code == 404
