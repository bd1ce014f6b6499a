"""The port's twin of ``tests/test_telemetry_cluster.py``: span tracing,
registry merging, the flight recorder and the step profiler of the port
(``analytics_zoo_tpu_torch/core/``'s copies of the JAX package's modules,
the port's ``ClusterServing``, ``ReplicaSet``, ``HTTPFrontend`` and
Estimator).

Covers: the span-tree primitives and their ``ZooConfig`` knobs, ring
eviction accounting, the registry reset's dangling-series fix,
``MetricsRegistry.merge`` (counters sum, gauge high-water max, bucket add,
replica labels dropped), jsonl rotation, a hedged two-replica request
whose ``trace.tree`` reconstructs root, attempt spans and server-side
spans, a hard-killed replica whose flight record names its in-flight
trace ids with zero client-visible failures, the on-demand dump, the
cluster-scope scrape, the estimator's step profiler and its flight record
on a non-finite loss, the streaming feed's decode spans, and the serving
instrumentation overhead guard (slow).  The gang cases (the supervisor's
snapshot fold, its worker-metrics reader, rotation and metrics port, and
the heartbeat's registry payload) are twinned in
``tests/test_torch_gang.py``.
"""

import json
import logging
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
from analytics_zoo_tpu_torch import nn
from analytics_zoo_tpu_torch.core import flightrec
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from analytics_zoo_tpu_torch.core.config import ZooConfig
from analytics_zoo_tpu_torch.core.faults import FaultRegistry
from analytics_zoo_tpu_torch.core.metrics import MetricsRegistry
from analytics_zoo_tpu_torch.serving import (ClusterServing, HTTPFrontend,
                                             InputQueue, OutputQueue,
                                             ReplicaSet)


class _Model:
    """Doubles its input; counts rows; optional fixed delay."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.calls = []
        self._lock = threading.Lock()

    def predict(self, x):
        if self.delay:
            time.sleep(self.delay)
        with self._lock:
            self.calls.append(np.asarray(x).shape[0])
        return np.asarray(x) * 2.0


def _two_ports():
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    ports.sort(key=lambda p: f"127.0.0.1:{p}")
    return ports


@pytest.fixture
def _restore_trace_config():
    yield
    trace_lib.configure(slow_ms=trace_lib.DEFAULT_SLOW_MS,
                        max_records=trace_lib.DEFAULT_MAX_RECORDS)


@pytest.fixture
def _flight_dir(tmp_path):
    d = str(tmp_path / "flight")
    flightrec.configure(d)
    yield d
    flightrec.configure(None)


# -- span-tree primitives -----------------------------------------------------

def test_span_context_manager_builds_a_tree():
    with trace_lib.span("a.root") as root:
        with root.child("a.mid") as mid:
            with mid.child("a.leaf", work_ms=1.5):
                pass
    roots = trace_lib.tree(root.trace_id)
    assert len(roots) == 1 and roots[0].name == "a.root"
    assert roots[0].record.dur_ms is not None
    (mid_node,) = roots[0].children
    assert mid_node.name == "a.mid"
    (leaf,) = mid_node.children
    assert leaf.name == "a.leaf" and leaf.record.stages["work_ms"] == 1.5
    # find() walks descendants by name
    assert roots[0].find("a.leaf") == [leaf]


def test_orphan_parent_degrades_to_forest_not_error():
    tid = trace_lib.new_trace_id()
    trace_lib.record(tid, "a.child", {}, parent="deadbeef")  # evicted parent
    roots = trace_lib.tree(tid)
    assert [r.name for r in roots] == ["a.child"]


def test_trace_knobs_configurable_via_zooconfig(_restore_trace_config):
    # the JAX package applies these at context init; the port's
    # configure takes them from the config object
    cfg = ZooConfig(trace_slow_ms=5.0, trace_ring=16)
    trace_lib.configure(slow_ms=cfg.trace_slow_ms,
                        max_records=cfg.trace_ring)
    assert trace_lib.SLOW_MS == 5.0
    assert trace_lib.MAX_RECORDS == 16
    tid = trace_lib.new_trace_id()
    for _ in range(40):
        trace_lib.record(tid, "t.x", {})
    assert len(trace_lib.find(tid)) == 16  # ring resized
    snap = metrics_lib.get_registry().snapshot()
    assert snap["trace.spans_dropped"] == 24  # evictions counted


def test_disabled_tracing_records_nothing():
    trace_lib.enabled = False
    try:
        tid = trace_lib.new_trace_id()
        assert trace_lib.record(tid, "t.x", {}) is None
        with trace_lib.span("t.y", trace_id=tid):
            pass
        assert trace_lib.find(tid) == []
    finally:
        trace_lib.enabled = True


def test_slow_warning_folds_server_stage_breakdown(caplog,
                                                   _restore_trace_config):
    """Satellite: the slow-request WARNING carries the per-stage
    breakdown — server-side stage spans in the ring are folded in even
    when the caller only measured a total."""
    tid = trace_lib.new_trace_id()
    trace_lib.record(tid, "server.batch",
                     {"server.queue_wait_ms": 40.0,
                      "server.inference_ms": 1500.0})
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu"):
        trace_lib.maybe_log_slow(tid, "req-1", 1600.0,
                                 {"client.total_ms": 1600.0})
    (line,) = [r.message for r in caplog.records
               if "slow request" in r.message]
    assert "client.total_ms=1600.0ms" in line
    assert "server.inference_ms=1500.0ms" in line
    assert "server.queue_wait_ms=40.0ms" in line


# -- registry reset: the dangling label-series fix ----------------------------

def test_reset_registry_exposition_equals_fresh_for_identical_traffic():
    """Satellite regression: series minted by ONE-SHOT writes before a
    reset used to linger as zero-valued label series no fresh registry
    would have — reset() now retires them (handle-held series still
    survive, zeroed)."""
    def traffic(reg, route):
        reg.counter("t.pinned").inc(2)          # handle API: pinned
        reg.inc("t.req", route=route)           # one-shot: ephemeral
        reg.observe("t.lat_ms", 3.0, route=route)

    used = MetricsRegistry()
    traffic(used, "/old")      # pre-reset traffic mints {route=/old}
    used.reset()
    traffic(used, "/new")
    fresh = MetricsRegistry()
    traffic(fresh, "/new")
    assert used.prometheus() == fresh.prometheus()
    # and the handle contract still holds: pinned series survive reset
    c = used.counter("t.survivor")
    c.inc(5)
    used.reset()
    assert c.value == 0
    c.inc()
    assert used.snapshot()["t.survivor"] == 1


# -- MetricsRegistry.merge ----------------------------------------------------

def test_merge_sums_counters_maxes_gauges_adds_buckets():
    a, b = MetricsRegistry(), MetricsRegistry()
    for reg, n, depth, hwm in ((a, 3, 2, 9), (b, 4, 5, 4)):
        reg.counter("m.req").inc(n)
        g = reg.gauge("m.depth")
        g.set(hwm)
        g.set(depth)
        h = reg.histogram("m.lat", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(5.0)
    merged = MetricsRegistry.merge([a.snapshot(), b.snapshot()])
    assert merged["m.req"] == 7
    assert merged["m.depth"]["value"] == 7    # cluster load = sum
    assert merged["m.depth"]["max"] == 9      # hwm = max
    h = merged["m.lat"]
    assert h["count"] == 4 and h["bucket_counts"] == [2, 2, 0]
    assert h["mean"] == pytest.approx(2.75)
    # summaries recomputed from the MERGED buckets
    assert 0.0 < h["p50"] <= 10.0


def test_merge_drops_replica_labels_into_one_series():
    reg = MetricsRegistry()
    reg.counter("client.retries", replica="h:1").inc(2)
    reg.counter("client.retries", replica="h:2").inc(3)
    reg.counter("router.requests", replica="h:1").inc(1)
    merged = MetricsRegistry.merge([reg.snapshot()],
                                   drop_labels=("replica",))
    assert merged == {"client.retries": 5, "router.requests": 1}


def test_merge_bucket_edge_mismatch_drops_buckets_keeps_totals():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("m.h", buckets=(1.0, 2.0)).observe(0.5)
    b.histogram("m.h", buckets=(5.0, 9.0)).observe(6.0)
    merged = MetricsRegistry.merge([a.snapshot(), b.snapshot()])
    assert merged["m.h"]["count"] == 2
    assert "bucket_counts" not in merged["m.h"]  # never lie about p50


def test_from_snapshot_round_trips_to_prometheus():
    reg = MetricsRegistry()
    reg.counter("m.c", route="/x").inc(2)
    reg.gauge("m.g").set(3)
    reg.histogram("m.h", buckets=(1.0,)).observe(0.5)
    rebuilt = MetricsRegistry.from_snapshot(reg.snapshot())
    assert rebuilt.prometheus() == reg.prometheus()


def test_export_jsonl_size_rotation(tmp_path):
    reg = MetricsRegistry()
    reg.counter("r.c").inc()
    path = str(tmp_path / "metrics.jsonl")
    for _ in range(50):
        reg.export_jsonl(path, max_bytes=2000)
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) < 4000  # bounded, not unbounded growth
    for p in (path, path + ".1"):
        for line in open(p):
            assert json.loads(line)["metrics"]["r.c"] == 1


# -- acceptance: hedged request reconstructs the span tree --------------------

@pytest.mark.faults
def test_hedged_request_tree_root_attempts_server_stages():
    """The tracing acceptance: a request served through ReplicaSet with
    a hedge fired reconstructs root → (attempt spans per replica) →
    server-side assembly/inference/reply spans, live across two
    replicas."""
    ports = _two_ports()
    slow, fast = _Model(delay=0.4), _Model()
    s1 = ClusterServing(slow, port=ports[0], batch_size=1,
                        batch_timeout_ms=1).start()
    s2 = ClusterServing(fast, port=ports[1], batch_size=1,
                        batch_timeout_ms=1).start()
    rs = ReplicaSet([f"{s1.host}:{s1.port}", f"{s2.host}:{s2.port}"],
                    hedge_ms=50.0, start_health=False)
    try:
        tid = trace_lib.new_trace_id()
        out = rs.predict(np.arange(4, dtype=np.float32), deadline=5.0,
                         trace_id=tid, timeout=10.0)
        np.testing.assert_allclose(out, np.arange(4) * 2.0)
        # the losing (slow) attempt finishes its server-side work late:
        # poll until its stage spans landed in the ring
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            roots = trace_lib.tree(tid)
            if (len(roots) == 1
                    and len(roots[0].find("server.reply")) >= 2):
                break
            time.sleep(0.02)
        (root,) = trace_lib.tree(tid)
        assert root.name == "router"
        attempts = [c for c in root.children
                    if c.name in ("client", "client.attempt")]
        assert len(attempts) == 2, [c.name for c in root.children]
        replicas = {c.record.stages["client.replica"] for c in attempts}
        assert replicas == {f"{s1.host}:{s1.port}",
                            f"{s2.host}:{s2.port}"}
        # the WINNER is the fast replica's sibling span
        winner = [c for c in attempts if c.name == "client"]
        assert winner and winner[0].record.stages["client.replica"] == \
            f"{s2.host}:{s2.port}"
        # every attempt hangs its own server-side stage spans
        for att in attempts:
            (batch,) = att.find("server.batch")
            stage_names = {c.name for c in batch.children}
            assert stage_names == {"server.assembly", "server.inference",
                                   "server.reply"}, stage_names
        # and the slow attempt's inference span shows the armed delay
        loser = [c for c in attempts if c.name == "client.attempt"][0]
        (inf,) = loser.find("server.inference")
        assert inf.record.stages["inference_ms"] >= 300.0
    finally:
        rs.close()
        s1.stop()
        s2.stop()


# -- acceptance: flight recorder on replica hard-kill -------------------------

@pytest.mark.faults
def test_replica_down_dump_names_in_flight_traces_zero_client_failures(
        _flight_dir):
    """The flight-recorder acceptance: hard-killing a replica under
    load produces a dump naming the in-flight trace ids lost on that
    replica, with zero client-visible failures (the router absorbs the
    kill exactly as before)."""
    ports = _two_ports()
    doomed_faults = FaultRegistry()
    # one inference worker + a slow model: requests QUEUE on the doomed
    # replica, so the kill reliably catches work in flight
    doomed = ClusterServing(_Model(delay=0.25), port=ports[0],
                            batch_size=1, batch_timeout_ms=1,
                            inference_workers=1,
                            faults=doomed_faults).start()
    survivor = ClusterServing(_Model(), port=ports[1], batch_size=1,
                              batch_timeout_ms=1).start()
    rs = ReplicaSet([f"{doomed.host}:{doomed.port}",
                     f"{survivor.host}:{survivor.port}"],
                    query_timeout=30.0, start_health=False)
    stop_load = threading.Event()
    tids: list = []
    failures: list = []
    served: list = []
    tids_lock = threading.Lock()

    def load(i):
        x = np.full((4,), float(i), np.float32)
        while not stop_load.is_set():
            tid = trace_lib.new_trace_id()
            with tids_lock:
                tids.append(tid)
            try:
                out = rs.predict(x, trace_id=tid, deadline=15.0,
                                 timeout=30.0)
            except Exception as e:  # noqa: BLE001 — the failure record
                failures.append(f"{type(e).__name__}: {e}")
                continue
            if out is None or not np.allclose(out, x * 2.0):
                failures.append("timeout/wrong answer")
            else:
                served.append(1)

    threads = [threading.Thread(target=load, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.4)  # steady state: the slow replica queues work
        assert not failures
        # the NEXT frame the doomed replica sees kills it.  Arm it while
        # the doomed replica holds a request and send that frame at once
        # (a probe straight to the replica), so the kill lands with work
        # in flight however busy the machine is (the router alone may
        # leave the slow replica idle at the moment it fires)
        deadline = time.monotonic() + 10
        while doomed.stats()["pending"] < 1:
            assert time.monotonic() < deadline, "the replica queued nothing"
            time.sleep(0.005)
        doomed_faults.enable("serving.replica_down", times=1)
        probe = None
        try:
            probe = InputQueue(port=doomed.port)
            probe.enqueue("probe", t=np.ones((4,), np.float32))
        except OSError:
            pass  # a load client's frame killed it first
        while not doomed._stop.is_set():
            assert time.monotonic() < deadline, "kill fault never fired"
            time.sleep(0.01)
        if probe is not None:
            probe.close()
        time.sleep(0.5)  # load keeps flowing through the survivor
    finally:
        stop_load.set()
        for t in threads:
            t.join(timeout=30)
        doomed_faults.disable("serving.replica_down")
        rs.close()
        survivor.stop()
        doomed.stop()
    # zero client-visible failures — the original HA contract holds
    assert failures == [], failures[:5]
    assert served
    # the kill dumped a flight record naming the dying replica's
    # in-flight requests (a later breaker-open dump may have rotated it
    # to .1 — search both generations)
    base = os.path.join(_flight_dir, f"flightrec_{os.getpid()}.json")
    dumps = [json.load(open(p)) for p in (base, base + ".1")
             if os.path.exists(p)]
    kills = [d for d in dumps
             if d["reason"] == "serving.replica_down"]
    assert kills, [d["reason"] for d in dumps]
    ctx = kills[0]["context"]
    assert ctx["replica"] == f"{doomed.host}:{doomed.port}"
    lost = set(ctx["in_flight_traces"])
    assert lost, "no in-flight trace ids recorded at kill time"
    assert lost <= set(tids), "dump names requests we never sent"


def test_dump_flight_record_on_demand(_flight_dir):
    srv = ClusterServing(_Model(), batch_size=4).start()
    try:
        inq = InputQueue(port=srv.port)
        outq = OutputQueue(input_queue=inq)
        uid = inq.enqueue("t", t=np.ones((4,), np.float32))
        assert outq.query(uid, timeout=30) is not None
        path = srv.dump_flight_record()
        assert path and os.path.exists(path)
        dump = json.load(open(path))
        assert dump["reason"] == "on_demand"
        assert dump["context"]["state"] == "serving"
        # the served request's spans are in the dumped ring
        tid = inq.trace_id(uid) or ""
        names = {s["name"] for s in dump["spans"]}
        assert "server.batch" in names
        # counters moved since the recorder's baseline
        assert dump["metrics_delta"].get("server.replies", 0) >= 1
        inq.close()
    finally:
        srv.stop()


def test_estimator_dumps_flight_record_on_nonfinite_loss(tmp_path):
    from analytics_zoo_tpu_torch.core import faults
    from analytics_zoo_tpu_torch.orca.learn import (Estimator,
                                                    NonFiniteLossError)
    rng = np.random.default_rng(0)
    model_dir = str(tmp_path / "ckpt")
    est = Estimator.from_keras(nn.Sequential([nn.Dense(4, 1)]), loss="mse",
                               learning_rate=1e-3, nan_policy="raise",
                               model_dir=model_dir, device="cpu")
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    with faults.get_registry().armed("step.nan", times=1):
        with pytest.raises(NonFiniteLossError):
            est.fit((x, y), epochs=1, batch_size=32, verbose=False)
    path = os.path.join(model_dir, f"flightrec_{os.getpid()}.json")
    assert os.path.exists(path)
    dump = json.load(open(path))
    assert dump["reason"] == "train.NonFiniteLossError"
    assert dump["context"]["step"] >= 1


# -- cluster-scope scrape -----------------------------------------------------

def test_cluster_scope_scrape_merges_replica_registries():
    """Two replicas with PRIVATE registries: /metrics?scope=cluster
    folds both over the TCP metrics frame, replica labels dropped."""
    m1, m2 = MetricsRegistry(), MetricsRegistry()
    s1 = ClusterServing(_Model(), batch_size=4, metrics=m1).start()
    s2 = ClusterServing(_Model(), batch_size=4, metrics=m2).start()
    rs = ReplicaSet([f"{s1.host}:{s1.port}", f"{s2.host}:{s2.port}"],
                    start_health=False)
    fe = HTTPFrontend(router=rs).start()
    try:
        # drive traffic to EACH replica directly (the router would
        # least-pending everything onto one)
        for srv, n in ((s1, 2), (s2, 3)):
            inq = InputQueue(port=srv.port)
            outq = OutputQueue(input_queue=inq)
            for i in range(n):
                uid = inq.enqueue("t", t=np.full((4,), float(i),
                                                 np.float32))
                assert outq.query(uid, timeout=30) is not None
            inq.close()
        merged = rs.cluster_metrics()
        assert merged["server.requests"] == 5   # 2 + 3
        assert merged["server.replies"] == 5
        assert merged["server.inference_ms"]["count"] >= 2
        url = f"http://{fe.host}:{fe.port}"
        with urllib.request.urlopen(url + "/metrics?scope=cluster",
                                    timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert "zoo_server_requests 5" in text
        assert "zoo_server_replies 5" in text
        # the plain process scrape is unchanged by the new route
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert "# TYPE" in r.read().decode()
    finally:
        fe.stop()
        s1.stop()
        s2.stop()


# -- step profiler ------------------------------------------------------------

def test_step_profiler_mfu_compiles_and_fit_span_tree():
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    y = rng.normal(size=(128, 1)).astype(np.float32)
    model = nn.Sequential([nn.Dense(4, 8, activation="relu"),
                           nn.Dense(8, 1)])
    est = Estimator.from_keras(model, loss="mse", learning_rate=1e-3,
                               device="cpu",
                               profile={"flops_per_sample": 1e6,
                                        "peak_flops": 1e9})
    est.fit((x, y), epochs=2, batch_size=32, verbose=False)
    snap = metrics_lib.get_registry().snapshot()
    # compile events: the first step's key (a capture on the card)
    assert snap["train.compiles"] >= 1
    assert est.compile_count >= 1
    # MFU: flops_per_sample × samples/s ÷ (peak × devices) — positive
    # and consistent with the declared analytics
    mfu = snap["train.mfu"]["value"]
    assert mfu > 0
    assert snap["train.mfu"]["max"] >= mfu
    # the fit's span tree: train.fit → train.epoch ×2 → train.step ×4
    (root,) = trace_lib.tree(est.trace_id)
    assert root.name == "train.fit"
    epochs = [c for c in root.children if c.name == "train.epoch"]
    assert len(epochs) == 2
    for ep in epochs:
        steps = [c for c in ep.children if c.name == "train.step"]
        assert len(steps) == 4
        assert all("data_wait_ms" in s.record.stages for s in steps)
    compiles = root.find("train.compile")
    assert len(compiles) >= 1


def test_profiler_off_registers_no_profiler_series():
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    rng = np.random.default_rng(0)
    est = Estimator.from_keras(nn.Sequential([nn.Dense(4, 1)]), loss="mse",
                               learning_rate=1e-3, device="cpu")
    est.fit((rng.normal(size=(64, 4)).astype(np.float32),
             rng.normal(size=(64, 1)).astype(np.float32)),
            epochs=1, batch_size=32, verbose=False)
    snap = metrics_lib.get_registry().snapshot()
    # profiler series may linger (zeroed) from another test's pinned
    # handles on the process-global registry — what matters is that an
    # unprofiled fit never MOVES them
    assert snap.get("train.mfu", {"value": 0})["value"] == 0
    assert snap.get("train.compiles", 0) == 0


# -- feed decode spans --------------------------------------------------------

def test_streaming_feed_records_decode_spans():
    from analytics_zoo_tpu_torch.data.stream import StreamingDataFeed

    def load(i, rng=None):
        return {"x": np.full((4,), float(i), np.float32)}

    feed = StreamingDataFeed(num_samples=32, load_sample=load,
                             batch_size=8, shuffle=False, num_workers=2)
    n = sum(1 for _ in feed.epoch(torch.device("cpu"), 0))
    assert n == 4
    assert feed.trace_id is not None
    (root,) = trace_lib.tree(feed.trace_id)
    assert root.name == "feed.epoch"
    decodes = [c for c in root.children if c.name == "feed.decode"]
    assert len(decodes) == 4
    assert {c.record.stages["step"] for c in decodes} == {0, 1, 2, 3}


# -- overhead guard (serving) -------------------------------------------------

@pytest.mark.slow
def test_serving_span_and_metrics_overhead_under_5_percent():
    """Acceptance: the full span+metrics instrumentation adds <5% to
    serving closed-loop throughput vs the kill switches off
    (registry.enabled=False + trace disabled).  Best-of-3 runs per
    mode; a small absolute slack absorbs CPU scheduling noise, same
    pattern as the PR-3 train-loop guard."""
    reg = metrics_lib.get_registry()
    srv = ClusterServing(_Model(), batch_size=8, batch_timeout_ms=1
                         ).start()
    inq = InputQueue(port=srv.port)
    outq = OutputQueue(input_queue=inq)
    x = np.ones((16,), np.float32)

    def closed_loop(n=300):
        best = float("inf")
        for _ in range(3):
            t0 = time.monotonic()
            for _i in range(n):
                uid = inq.enqueue("t", t=x)
                assert outq.query(uid, timeout=30) is not None
            best = min(best, time.monotonic() - t0)
        return best

    try:
        closed_loop(50)  # warm every code path
        reg.enabled = False
        trace_lib.enabled = False
        t_off = closed_loop()
        reg.enabled = True
        trace_lib.enabled = True
        t_on = closed_loop()
    finally:
        reg.enabled = True
        trace_lib.enabled = True
        inq.close()
        srv.stop()
    assert t_on <= t_off * 1.05 + 0.05, (t_on, t_off)
