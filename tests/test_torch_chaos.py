"""The port's twin of ``tests/test_chaos.py``: seeded multi-fault storms
(the port's ``core/chaos.py``, a copy of the JAX package's) and the
system-wide :class:`InvariantChecker` over the port's ``ClusterServing``,
``ReplicaSet``, ``ServingController``, ``ModelRegistry``, ``BatchScorer``
and ``core/ckpt_manager.py``: the fault points ``serving.slow_wire``,
``serving.net_partition``, ``controller.tick_fail`` and
``registry.swap_fail``, the controller's degraded-mode backoff, the swap
failure's atomicity, the async checkpoint writer under write failures and
under SIGKILL (``tests/_torch_ckpt_chaos_worker.py``, the port's NeuralCF
on the CPU), and the acceptance storm: all five fault classes over a
2-replica supervised pool with a 10k-row batch job in flight, zero
client-visible errors, a row-exact journal, every invariant green, and a
same-seed rerun firing the same fault sequence.  The JAX file's
``test_bench_has_chaos_config`` reads bench.py's JAX benchmark configs and
has no twin here.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
from analytics_zoo_tpu_torch.core import faults as faults_lib
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core.chaos import (ChaosSchedule,
                                                InvariantChecker)
from analytics_zoo_tpu_torch.serving import (BatchScorer, ClusterServing,
                                             HysteresisPolicy,
                                             InProcessReplicaFactory,
                                             InputQueue, ModelRegistry,
                                             OutputQueue, ReplicaSet,
                                             RetryPolicy, ServingController)


class _Model:
    """Multiplies by ``factor`` — distinguishable outputs make stale
    post-swap predictions detectable."""

    def __init__(self, factor: float = 2.0):
        self.factor = factor

    def predict(self, x):
        return np.asarray(x, np.float32) * self.factor


def _serve(**kw) -> ClusterServing:
    kw.setdefault("batch_size", 8)
    kw.setdefault("batch_timeout_ms", 2)
    if "models" not in kw:
        kw.setdefault("model", _Model())
    return ClusterServing(port=0, **kw).start()


def _trees_equal(got, want):
    """Two checkpoint trees leaf for leaf, bit for bit."""
    from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
    assert ckpt_io.leaf_paths(got) == ckpt_io.leaf_paths(want)
    for g, w in zip(ckpt_io.flatten(got)[0], ckpt_io.flatten(want)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _retry(**kw) -> RetryPolicy:
    kw.setdefault("max_attempts", 8)
    kw.setdefault("base_delay", 0.02)
    kw.setdefault("max_delay", 0.3)
    kw.setdefault("seed", 0)
    return RetryPolicy(**kw)


# -- the storm plan is pure seed ----------------------------------------------

def test_storm_plan_is_seed_deterministic():
    points = ["serving.slow_wire", "serving.replica_down",
              "serving.net_partition"]
    a = ChaosSchedule(seed=7, duration_s=12.0, points=points)
    b = ChaosSchedule(seed=7, duration_s=12.0, points=points)
    assert [e.to_dict() for e in a.plan] == [e.to_dict() for e in b.plan]
    assert a.describe() == b.describe()
    c = ChaosSchedule(seed=8, duration_s=12.0, points=points)
    assert [e.to_dict() for e in a.plan] != [e.to_dict() for e in c.plan]
    # every point gets scheduled (round-robin), events stay in-window
    assert {e.point for e in a.plan} == set(points)
    for e in a.plan:
        assert 0.0 <= e.t < 12.0
    # serialized storms: no two windows overlap
    s = ChaosSchedule(seed=3, duration_s=12.0, points=points,
                      max_concurrent=1)
    spans = sorted((e.t, e.t + e.duration_s) for e in s.plan)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert start >= end


def test_storm_rejects_bad_arguments():
    with pytest.raises(ValueError):
        ChaosSchedule(seed=0, duration_s=0.0, points=["step.nan"])
    with pytest.raises(ValueError):
        ChaosSchedule(seed=0, duration_s=1.0, points=[])
    with pytest.raises(ValueError):
        ChaosSchedule(seed=0, duration_s=1.0, points=["no.such_point"])
    with pytest.raises(ValueError):
        ChaosSchedule(seed=0, duration_s=1.0, points=["step.nan"],
                      max_concurrent=0)


# -- fired-event log + schedule accounting ------------------------------------

@pytest.mark.faults
def test_fired_events_are_ordered_and_filterable():
    reg = faults_lib.get_registry()
    reg.reset()
    reg.enable("feed.stall", times=2)
    reg.enable("step.nan", times=1)
    assert reg.fire("feed.stall")
    assert reg.fire("step.nan")
    assert reg.fire("feed.stall")
    assert not reg.fire("feed.stall")  # budget spent: not logged
    assert reg.fired_events() == ["feed.stall", "step.nan", "feed.stall"]
    assert reg.fired_events(points=["step.nan"]) == ["step.nan"]
    reg.reset()
    assert reg.fired_events() == []


def test_register_point_is_thread_safe_and_idempotent():
    names = [f"chaostest.p{i % 4}" for i in range(32)]
    errs = []

    def worker(n):
        try:
            assert faults_lib.register_point(n) == n
        except Exception as e:  # noqa: BLE001 — collected
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert {f"chaostest.p{i}" for i in range(4)} <= faults_lib.KNOWN_POINTS
    with pytest.raises(ValueError):
        faults_lib.register_point("")
    with pytest.raises(ValueError):
        faults_lib.register_point(None)
    # keep the runtime vocabulary pristine for later tests
    for i in range(4):
        faults_lib.KNOWN_POINTS.discard(f"chaostest.p{i}")


@pytest.mark.faults
def test_running_schedules_are_visible_until_stopped():
    reg = faults_lib.get_registry()
    reg.reset()
    storm = ChaosSchedule(seed=1, duration_s=60.0, points=["feed.stall"],
                          name="leakcheck")
    assert reg.schedule_state() == []
    storm.start()
    try:
        assert storm.running
        assert reg.running_schedules() == [storm]
        assert reg.schedule_state() == ["leakcheck"]
    finally:
        storm.stop()
    assert not storm.running
    assert reg.schedule_state() == []
    assert reg.armed_points() == []  # stop() disarmed the storm's points


# -- serving.slow_wire --------------------------------------------------------

@pytest.mark.faults
def test_slow_wire_adds_latency_but_never_corrupts():
    reg = faults_lib.get_registry()
    reg.reset()
    srv = _serve()
    try:
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        x = np.ones((4,), np.float32)
        uid = iq.enqueue("warm", t=x)
        assert oq.query(uid, timeout=20.0) is not None
        # one request round trip crosses the wire 4 times (request
        # send/recv + reply send/recv); each armed fire adds `delay`
        with reg.armed("serving.slow_wire", times=4, delay=0.05):
            t0 = time.perf_counter()
            uid = iq.enqueue("jit", t=x)
            out = oq.query(uid, timeout=20.0)
            elapsed = time.perf_counter() - t0
        assert out is not None
        np.testing.assert_allclose(out, x * 2.0, rtol=1e-6)
        assert reg.fired("serving.slow_wire") == 4
        assert elapsed >= 0.15  # 4 x 50ms of injected jitter, some slop
        iq.close()
    finally:
        srv.stop()


# -- serving.net_partition ----------------------------------------------------

@pytest.mark.faults
def test_net_partition_severs_conns_but_replica_lives():
    reg = faults_lib.get_registry()
    reg.reset()
    srv = _serve()
    rs = ReplicaSet([(srv.host, srv.port)], retry=_retry(),
                    start_health=False)
    try:
        x = np.ones((4,), np.float32)
        assert rs.predict(x, deadline=10.0) is not None
        with reg.armed("serving.net_partition", times=1):
            out = rs.predict(x, deadline=15.0)
        # the partition severed the conn mid-request; the client's
        # reconnect + idempotent same-uuid replay absorbed it
        assert out is not None
        np.testing.assert_allclose(out, x * 2.0, rtol=1e-6)
        assert reg.fired("serving.net_partition") == 1
        st = srv.stats()
        # the PROCESS survived: listener up, state serving — only the
        # client sockets died (what distinguishes it from replica_down)
        assert st["state"] == "serving"
        assert rs.predict(x, deadline=10.0) is not None
    finally:
        rs.close()
        srv.stop()


# -- controller.tick_fail -> degraded mode --------------------------------------

@pytest.mark.faults
def test_controller_backs_off_and_dumps_once_under_tick_storm(tmp_path):
    """>=3 consecutive tick failures: bounded exponential backoff plus
    EXACTLY ONE controller_degraded flight record naming the failing
    stage; one good tick restores the interval and zeroes the streak."""
    reg = faults_lib.get_registry()
    reg.reset()
    m = metrics_lib.get_registry()
    degraded0 = m.snapshot().get("controller.degraded", 0)
    srv = _serve()
    rs = ReplicaSet([(srv.host, srv.port)], start_health=False)
    ctl = ServingController(rs, InProcessReplicaFactory(_serve),
                            interval_s=0.02,
                            flightrec_dir=str(tmp_path))
    try:
        reg.enable("controller.tick_fail", times=5)
        ctl.start()
        deadline = time.monotonic() + 15.0
        # the storm: 5 failed ticks (backoff after the 3rd), then the
        # budget is spent and the next tick succeeds
        while time.monotonic() < deadline:
            if (reg.fired("controller.tick_fail") == 5
                    and ctl.consecutive_failures == 0
                    and m.snapshot().get("controller.ticks", 0) > 0):
                break
            time.sleep(0.02)
        assert reg.fired("controller.tick_fail") == 5
        assert ctl.consecutive_failures == 0  # recovered
    finally:
        reg.disable("controller.tick_fail")
        ctl.close()
        rs.close()
        srv.stop()
    snap = metrics_lib.get_registry().snapshot()
    assert snap.get("controller.degraded", 0) - degraded0 == 1
    assert snap.get("controller.errors", 0) >= 5
    dumps = [f for f in os.listdir(tmp_path) if "flightrec" in f]
    # ONE dump per degradation episode — not one per failed tick
    assert len(dumps) == 1, dumps
    rec = json.loads((tmp_path / dumps[0]).read_text())
    assert rec["reason"] == "controller_degraded"
    assert rec["context"]["stage"] == "observe"  # where raise_if sits
    assert rec["context"]["consecutive_failures"] == 3
    assert rec["context"]["backoff_s"] > 0.02  # backed off the interval


# -- registry.swap_fail -> atomicity ------------------------------------------

@pytest.mark.faults
def test_swap_failure_leaves_old_version_active_and_uncounted(tmp_path):
    reg = faults_lib.get_registry()
    reg.reset()
    models = ModelRegistry()
    models.register("default", _Model(2.0), version="v1")
    srv = _serve(models=models)
    rs = ReplicaSet([(srv.host, srv.port)], retry=_retry(),
                    start_health=False)
    swaps0 = metrics_lib.get_registry().snapshot().get(
        "registry.swaps", 0)
    stop = threading.Event()
    errors: list = []
    x = np.ones((4,), np.float32)

    def client():  # in-flight traffic across the failed swap
        while not stop.is_set():
            try:
                out = rs.predict(x, deadline=10.0)
                if out is None:
                    errors.append("timeout")
                elif not np.allclose(out, x * 2.0):
                    errors.append(f"unexpected output {out[:2]}")
            except Exception as e:  # noqa: BLE001 — counted
                errors.append(f"{type(e).__name__}: {e}"[:200])

    threads = [threading.Thread(target=client) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.1)
        with reg.armed("registry.swap_fail", times=1):
            with pytest.raises(RuntimeError):
                models.swap("default", _Model(3.0))
        time.sleep(0.2)  # in-flight batches complete on the old model
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        rs.close()
        srv.stop()
    # atomicity: the failure hit BEFORE the flip — old version active,
    # still routable (all in-flight traffic answered by v1), and the
    # swap counter never moved
    assert models.active_version("default") == "v1"
    assert not errors, errors[:3]
    snap = metrics_lib.get_registry().snapshot()
    assert snap.get("registry.swaps", 0) == swaps0
    # the registry is not wedged: the next (un-faulted) swap lands
    v2 = models.swap("default", _Model(3.0), drain=False)
    assert models.active_version("default") == v2
    assert snap.get("registry.swaps", 0) + 1 == metrics_lib.get_registry(
        ).snapshot().get("registry.swaps", 0)


# -- the fault-point doc table covers the port's points -----------------------

def test_fault_point_docs_match_code():
    """``dev/check_fault_docs.py``'s rule over the port: the
    ``KNOWN_POINTS`` literal of the port's ``core/faults.py`` and every
    ``register_point`` call under ``analytics_zoo_tpu_torch/`` are the
    rows of docs/robustness.md's injection-point table."""
    import importlib.util
    import pathlib
    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "check_fault_docs", repo / "dev" / "check_fault_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.PKG = repo / "analytics_zoo_tpu_torch"
    assert mod.code_points() == mod.documented()


# -- async checkpoint crash storms ------------------------------------------------

CKPT_WORKER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "_torch_ckpt_chaos_worker.py")


def _spawn_ckpt_worker(model_dir, mirror_dir):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, CKPT_WORKER, str(model_dir), str(mirror_dir)],
        env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_sigkill_mid_async_save_restores_consistent_generation(tmp_path):
    """The crash-consistency acceptance: SIGKILL a trainer
    that is streaming async full+delta generations, at seeded offsets —
    the survivor must always restore a COMPLETE crc-clean generation
    whose every leaf (embedding rows included) is bit-identical to the
    synchronous mirror the worker wrote for that step."""
    import random

    from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
    from analytics_zoo_tpu_torch.core import ckpt_manager as ckpt_mgr_lib

    rng = random.Random(20150815)
    for rep in range(2):
        model_dir = tmp_path / f"m{rep}"
        mirror_dir = tmp_path / f"mirror{rep}"
        proc = _spawn_ckpt_worker(model_dir, mirror_dir)
        try:
            # let >=2 trigger firings land: under the block in-flight
            # policy the 2nd TRIGGERED line implies the 1st generation's
            # manifest line is already durable — the kill can tear the
            # tail but never leave the directory unrestorable
            want = 2 + rng.randrange(0, 3)
            seen = 0
            deadline = time.time() + 240
            while seen < want:
                assert time.time() < deadline, "worker never triggered"
                line = proc.stdout.readline()
                assert line, "worker exited early"
                if "TRIGGERED" in line:
                    seen += 1
            time.sleep(rng.uniform(0.0, 0.05))  # land mid-write
            proc.kill()  # SIGKILL: no handlers, no flush, no goodbye
            proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)

        errors, _warns = ckpt_mgr_lib.verify_path(str(model_dir))
        assert errors == [], errors
        assert InvariantChecker().check_manifest(str(model_dir)) == []
        tree, rec = ckpt_mgr_lib.restore_path(str(model_dir))
        mirror = str(mirror_dir / f"step_{rec['step']}")
        assert ckpt_io.exists(mirror), \
            f"restored step {rec['step']} has no mirror"
        want_tree = ckpt_io.restore(mirror)
        _trees_equal({k: tree[k] for k in ("params", "state", "opt_state")},
                     {k: want_tree[k]
                      for k in ("params", "state", "opt_state")})
        assert int(np.asarray(tree["step"])) == int(rec["step"])


def test_async_ckpt_survives_write_fail_and_slow_write_storm(tmp_path):
    """``checkpoint.write_fail`` exhausting the writer's retry budget
    plus ``checkpoint.slow_write`` stalls, mid-async-fit: the failed
    generation must not poison the manifest (law 7), the next save is
    forced full, and a post-storm restore is bit-identical to the live
    train state."""
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    from analytics_zoo_tpu_torch.orca.learn.trigger import SeveralIteration

    def ncf():
        return NeuralCF(user_count=64, item_count=40, class_num=2,
                        user_embed=8, item_embed=8, hidden_layers=(16, 8),
                        mf_embed=8, sharded_embeddings=True)

    d = str(tmp_path / "m")
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, 64, 256),
                  rng.integers(0, 40, 256)], 1).astype(np.int32)
    y = (rng.random(256) < 0.5).astype(np.int32)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-2, seed=7, device="cpu")
    est = Estimator.from_keras(ncf(), model_dir=d, checkpoint_async=True,
                               checkpoint_inflight="block", **kw)
    # 4 injected write errors: 3 exhaust one save's retry budget (the
    # save FAILS), the 4th is absorbed by the next save's retries
    faults_lib.get_registry().enable("checkpoint.write_fail", times=4)
    faults_lib.get_registry().enable("checkpoint.slow_write", times=2,
                                     delay=0.02)
    est.fit((x, y), epochs=2, batch_size=64,
            checkpoint_trigger=SeveralIteration(2), verbose=False)
    est._ckpt_mgr.flush(raise_error=False)
    snap = metrics_lib.get_registry().snapshot()
    assert snap.get("ckpt.write_errors", 0) >= 1, snap
    assert est._ckpt_mgr.verify() == []
    assert InvariantChecker().check_manifest(d) == []
    # post-storm blocking save must land cleanly and restore exactly
    est.save()
    est2 = Estimator.from_keras(ncf(), model_dir=d,
                                checkpoint_async=True, **kw)
    est2.load(d)
    got, want = est2._save_tree(), est._save_tree()
    _trees_equal({k: got[k] for k in ("params", "state", "opt_state")},
                 {k: want[k] for k in ("params", "state", "opt_state")})
    assert est2._py_step == est._py_step


# -- THE acceptance storm -----------------------------------------------------

STORM_POINTS = ("serving.slow_wire", "serving.replica_down",
                "serving.net_partition", "registry.swap_fail",
                "controller.tick_fail")
STORM_SEED = 20140807
STORM_DURATION_S = 9.0


def _storm_run(tmp_path, run_id: str):
    """One full acceptance run: 2-replica supervised pool sharing one
    ModelRegistry, 4 closed-loop clients, a 10k-row journaled batch job,
    a swapper attempting a hot swap every 150ms, and a reviver standing
    in for the process supervisor — all under the seeded storm.
    Returns the evidence dict the caller asserts on."""
    reg = faults_lib.get_registry()
    reg.reset()  # a clean fired-event log: the replay evidence
    resources = InvariantChecker.baseline()
    models = ModelRegistry()
    models.register("default", _Model(2.0), version="v1")

    def new_server() -> ClusterServing:
        return _serve(models=models)

    servers = [new_server(), new_server()]
    rs = ReplicaSet([(s.host, s.port) for s in servers], retry=_retry(),
                    health_interval=0.1, breaker_reset_s=0.3)
    # autoscaling ON (the controller ticks — and fails ticks — through
    # the storm); the slack SLO keeps the pool from churning so the
    # fault timeline, not scaling, drives the run
    ctl = ServingController(
        rs, InProcessReplicaFactory(new_server),
        policy=HysteresisPolicy(slo_p99_ms=5000.0, min_replicas=1,
                                max_replicas=3, down_cooldown_s=600.0),
        interval_s=0.05, flightrec_dir=str(tmp_path / f"rec-{run_id}"))
    checker = InvariantChecker(servers=servers, router=rs,
                               interval_s=0.05)
    checker.watch_registry(models)
    storm = ChaosSchedule(
        seed=STORM_SEED, duration_s=STORM_DURATION_S, max_concurrent=1,
        points=list(STORM_POINTS),
        # pin the budget so the window always fits 3 failed ticks at
        # interval_s=0.05 even once backoff stretches the loop
        point_params={"controller.tick_fail": {"times": 3}})
    # the storm must exercise every fault class (seed chosen for that)
    assert {e.point for e in storm.plan} == set(STORM_POINTS)

    stop = threading.Event()
    errors: list = []
    expected = {"factor": 2.0}
    swaps = {"ok": 0, "injected": 0}

    def reviver():  # k8s stand-in: replace storm-killed replicas
        replaced: set = set()
        while not stop.wait(0.1):
            for s in list(servers):
                if id(s) in replaced:
                    continue
                try:
                    # kill() reports "stopped" (SIGKILL leaves no
                    # distinct lifecycle state) — nothing else stops a
                    # server mid-run here.
                    dead = s.stats().get("state") == "stopped"
                except Exception:  # noqa: BLE001 — treat as dead
                    dead = True
                if not dead:
                    continue
                replaced.add(id(s))
                try:
                    rs.remove_replica((s.host, s.port), drain=False)
                except Exception:  # noqa: BLE001 — already gone
                    pass
                ns = checker.add_server(new_server())
                servers.append(ns)
                try:
                    rs.add_replica((ns.host, ns.port))
                except Exception:  # noqa: BLE001 — pool mid-teardown
                    ns.stop()
                    servers.remove(ns)

    def swapper():  # the mid-storm upgrade the swap_fail window hits
        factor = 2.0
        while not stop.wait(0.15):
            nxt = 5.0 - factor  # alternate x2 <-> x3
            try:
                models.swap("default", _Model(nxt), drain=False,
                            keep_old=False)
            except RuntimeError:
                swaps["injected"] += 1  # the injected mid-warm abort
                continue
            factor = nxt
            expected["factor"] = factor
            swaps["ok"] += 1

    x = np.ones((8,), np.float32)

    def client():
        while not stop.is_set():
            try:
                out = rs.predict(x, deadline=20.0)
            except Exception as e:  # noqa: BLE001 — client-visible
                errors.append(f"{type(e).__name__}: {e}"[:200])
                checker.note_client_error(e)
                continue
            if out is None:
                errors.append("timeout")
                checker.note_client_error("timeout")
            elif not (np.allclose(out, x * 2.0)
                      or np.allclose(out, x * 3.0)):
                # neither live version produced this: a stale or torn
                # model served the request
                errors.append(f"stale/corrupt output {out[:2]}")

    rows = np.arange(10_000 * 4, dtype=np.float32).reshape(10_000, 4)
    job_dir = str(tmp_path / f"job-{run_id}")
    job: dict = {}

    def run_job():
        try:
            with BatchScorer(rs, job_dir, shard_size=250, max_inflight=4,
                             retry=_retry(max_attempts=8,
                                          base_delay=0.05, seed=1),
                             request_timeout=30.0) as sc:
                job["report"] = sc.score(rows)
        except Exception as e:  # noqa: BLE001 — recorded
            job["error"] = f"{type(e).__name__}: {e}"[:300]

    threads = [threading.Thread(target=f)
               for f in (reviver, swapper, client, client, client,
                         client)]
    jt = threading.Thread(target=run_job)
    try:
        ctl.start()
        checker.start()
        for t in threads:
            t.start()
        jt.start()
        with storm:
            assert storm.wait(timeout=STORM_DURATION_S + 20.0)
        jt.join(timeout=120.0)
        assert not jt.is_alive(), "batch job wedged under the storm"
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        time.sleep(0.5)  # quiesce: let final replies land
        # no stale version after the last flip: a fresh request must
        # serve the LAST successfully swapped model
        out = rs.predict(x, deadline=10.0)
        assert out is not None
        np.testing.assert_allclose(out, x * expected["factor"],
                                   rtol=1e-6)
        checker.check_quiescent()
        checker.check_registry()
        checker.check_batch_job(job_dir, len(rows))
    finally:
        stop.set()
        storm.stop()
        checker.stop()
        ctl.close()
        rs.close()
        for s in servers:
            s.stop()
    return {"storm": storm, "checker": checker, "errors": errors,
            "job": job, "swaps": swaps, "resources": resources,
            "fired": storm.fired_sequence()}


@pytest.mark.faults
def test_acceptance_seeded_storm_zero_errors_and_reproducible(tmp_path):
    """The acceptance bar, run TWICE with the same seed: the
    storm (replica kill + net partition + slow wire + swap_fail +
    tick_fail) over 2 replicas with autoscaling on and a 10k-row batch
    job in flight completes with zero client-visible errors, a
    row-exact journal, and every invariant green — and the second run
    reproduces the first run's exact fault firing sequence."""
    runs = [_storm_run(tmp_path, run_id) for run_id in ("a", "b")]
    for r in runs:
        assert r["job"].get("error") is None, r["job"]
        assert r["job"]["report"].rows == 10_000
        assert not r["errors"], r["errors"][:5]
        # the storm actually bit: every fault class fired
        assert set(r["fired"]) == set(STORM_POINTS)
        assert r["swaps"]["injected"] >= 1  # swap_fail hit a live swap
        assert r["swaps"]["ok"] >= 1        # and real swaps landed too
        r["checker"].assert_ok()
        # teardown hygiene: no leaked threads/fds/shm vs the run's own
        # pre-topology baseline
        r["checker"].assert_teardown(r["resources"], fd_slack=8)
    # same seed -> identical ordered fault firing sequence (the
    # faults.fired event log IS the replay evidence)
    assert runs[0]["fired"] == runs[1]["fired"]
    assert runs[0]["fired"], "storm fired nothing"
