"""The port's gang: ``init_orca_context("multihost")`` over
``torch.distributed``, the ``zoo-launch`` supervisor (``core/launcher.py``)
and what it reads from its workers, on CPU processes over gloo.

Twins of ``tests/test_multihost.py`` (which the JAX package skips on the
CPU; the port's runs, and its checkpoint is held to the JAX package's
``checkpoint.restore``), of ``tests/test_failover.py``'s supervisor cases,
of ``tests/test_observability.py``'s heartbeat and gang-status cases, of
``tests/test_telemetry_cluster.py``'s gang fold, worker-metrics reader,
rotation, metrics port and heartbeat payload, and of
``tests/test_faults.py``'s config wiring at context init.  Each gang of
worker processes runs under one ``launch`` with its own timeout (a hang
fails the test instead of holding the suite).
"""

import glob
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_serving import one_torch_thread  # noqa: F401
from analytics_zoo_tpu.core import checkpoint as jckpt
from analytics_zoo_tpu.core import launcher as jlauncher
from analytics_zoo_tpu_torch.core import context as ctx
from analytics_zoo_tpu_torch.core import launcher
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core.config import ZooConfig
from analytics_zoo_tpu_torch.core.faults import get_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTIHOST = os.path.join(REPO, "tests", "_torch_multihost_worker.py")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _clean_context(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    ctx.stop_orca_context()
    yield
    ctx.stop_orca_context()
    get_registry().reset()


def _script(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(body)
    return str(p)


# -- the multi-process fit and its checkpoint (test_multihost.py) ------------

@pytest.mark.parametrize("nprocs", [2, 4])
def test_multiprocess_fit_eval_sharded_checkpoint(tmp_path, nprocs):
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ)
    procs = []
    coordinator = f"127.0.0.1:{launcher._free_port()}"
    for pid in range(nprocs):
        penv = launcher._child_env(coordinator, nprocs, pid,
                                   devices_per_proc=None, platform="cpu")
        penv["PYTHONPATH"] = env["PYTHONPATH"]
        procs.append(subprocess.Popen(
            [sys.executable, MULTIHOST, str(ckpt)], env=penv, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        launcher._terminate_gang(procs, grace=1.0)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-3000:]
    # global (not process-local) metrics: every process prints the same
    lines = [next(l for l in out.splitlines() if "MULTIHOST_OK" in l)
             for out in outs]
    assert len(set(lines)) == 1, lines
    # one shard file a process on disk
    names = sorted(p.name for p in ckpt.iterdir())
    for pid in range(nprocs):
        assert any(n.startswith("shards_") and n.endswith(f"_p{pid}.npz")
                   for n in names), (pid, names)
    # the JAX package's restore reads the port's multi-process layout whole
    tree = jckpt.restore(str(ckpt))
    mine = np.load(tmp_path / "params_p0.npz")
    for key in mine.files:
        layer, leaf = key.split("/")
        np.testing.assert_array_equal(np.asarray(tree["params"][layer][leaf]),
                                      mine[key])
    meta = json.loads((ckpt / "treedef.json").read_text())
    kernels = [e for e in meta["sharded"] if e and e.get("spec")]
    assert kernels and all(e["spec"][0] == "fsdp" for e in kernels)
    assert all(len(e["shards"]) == nprocs for e in kernels)


def test_zoo_launch_cli(tmp_path):
    """The launcher's command line end to end on CPU ranks."""
    script = tmp_path / "job.py"
    script.write_text(
        "from analytics_zoo_tpu_torch.core.context import "
        "init_orca_context\n"
        "m = init_orca_context('multihost', mesh_shape={'data': 0})\n"
        "print(f'LAUNCH_OK {m.rank}/{m.size} {m.backend}', flush=True)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.core.launcher",
         "--nprocs", "2", "--platform", "cpu", str(script)],
        env=dict(os.environ), cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LAUNCH_OK 0/2 gloo" in proc.stdout
    assert "LAUNCH_OK 1/2 gloo" in proc.stdout


def test_child_env_maps_platform_and_devices():
    env = launcher._child_env("h:1", 4, 2, devices_per_proc=2,
                              platform="cuda")
    assert (env["ZOO_COORDINATOR"], env["ZOO_NUM_PROCESSES"],
            env["ZOO_PROCESS_ID"]) == ("h:1", "4", "2")
    assert env["CUDA_VISIBLE_DEVICES"] == "4,5"
    cpu = launcher._child_env("h:1", 2, 0, None, "cpu",
                              extra={"ZOO_RESTART_COUNT": "3"})
    assert cpu["CUDA_VISIBLE_DEVICES"] == ""
    assert cpu["ZOO_RESTART_COUNT"] == "3"
    assert launcher.EXIT_CRASH_LOOP == jlauncher.EXIT_CRASH_LOOP


def _fake_cards(monkeypatch, env, cards):
    """The cards a worker started with ``env`` would see on a host of
    ``cards``: ``CUDA_VISIBLE_DEVICES`` narrows them."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    seen = cards if visible is None else len([v for v in visible.split(",")
                                              if v])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: seen > 0,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: seen,
                        raising=False)
    for key in ("ZOO_LOCAL_RANK", "ZOO_LOCAL_WORLD_SIZE",
                "ZOO_DEVICES_PER_PROC"):
        monkeypatch.delenv(key, raising=False)
        if key in env:
            monkeypatch.setenv(key, env[key])


@pytest.mark.parametrize("cards,nprocs,per_proc,platform,want", [
    # zoo-launch --devices-per-proc 1: each rank its own card, NCCL
    (2, 2, 1, None, [("nccl", 0), ("nccl", 0)]),
    (4, 4, 1, None, [("nccl", 0)] * 4),
    # the default: every rank sees every card and takes its own
    (2, 2, None, None, [("nccl", 0), ("nccl", 1)]),
    (4, 4, None, None, [("nccl", r) for r in range(4)]),
    # more ranks than cards: they share, gloo over CUDA tensors
    (1, 2, None, None, [("gloo", 0), ("gloo", 0)]),
    (2, 4, None, None, [("gloo", 0), ("gloo", 1), ("gloo", 0), ("gloo", 1)]),
    # --platform cpu hides the cards
    (4, 2, None, "cpu", [("gloo", None), ("gloo", None)]),
])
def test_backend_follows_the_cards(monkeypatch, cards, nprocs, per_proc,
                                   platform, want):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    got = []
    for pid in range(nprocs):
        env = launcher._child_env("h:1", nprocs, pid, per_proc, platform)
        _fake_cards(monkeypatch, env, cards)
        got.append(ctx.choose_backend(*ctx.local_topology(pid, nprocs)))
    assert got == want


def test_one_process_a_host_takes_nccl(monkeypatch):
    """zoo-launch --process-id: one process on each 4-card host of a world
    of 8 is local rank 0 of 1, so NCCL on its card 0."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = launcher._child_env("h:1", 8, 5, None, None, local=(0, 1))
    assert (env["ZOO_LOCAL_RANK"], env["ZOO_LOCAL_WORLD_SIZE"]) == ("0", "1")
    _fake_cards(monkeypatch, env, 4)
    assert ctx.choose_backend(*ctx.local_topology(5, 8)) == ("nccl", 0)


def test_init_binds_the_rank_to_its_card(monkeypatch):
    """init_orca_context("multihost") makes the rank's card the current
    CUDA device, so that bare "cuda" tensors land on it."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = launcher._child_env("h:1", 2, 1, None, None)
    _fake_cards(monkeypatch, env, 2)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append,
                        raising=False)
    ctx.init_orca_context(
        "multihost", coordinator_address=f"127.0.0.1:{launcher._free_port()}",
        num_processes=1, process_id=0, backend="gloo")
    assert bound == [1]


# -- the supervisor (test_failover.py's gang cases) --------------------------

@pytest.mark.gang
def test_supervisor_restarts_crashed_gang(tmp_path):
    s = _script(tmp_path, "s.py",
                "import os, sys\n"
                "sys.exit(1 if os.environ['ZOO_RESTART_COUNT'] == '0' "
                "else 0)\n")
    events = []
    rc = launcher.launch(s, [], nprocs=2, max_restarts=1, backoff=0.05,
                         grace=1.0,
                         on_event=lambda k, i: events.append((k, i)))
    assert rc == 0
    assert [k for k, _ in events] == ["crash", "restart", "ok"]
    assert events[0][1]["rc"] == 1


@pytest.mark.gang
def test_supervisor_detects_dead_worker_promptly(tmp_path):
    s = _script(tmp_path, "s.py",
                "import os, sys, time\n"
                "sys.exit(2) if os.environ['ZOO_PROCESS_ID'] == '0' "
                "else time.sleep(60)\n")
    t0 = time.monotonic()
    rc = launcher.launch(s, [], nprocs=3, max_restarts=0, grace=0.5)
    assert rc == 2
    assert time.monotonic() - t0 < 20


@pytest.mark.gang
def test_supervisor_crash_loop_aborts_with_diagnosis(tmp_path):
    s = _script(tmp_path, "s.py",
                "import os, sys, time\n"
                "sys.exit(3) if os.environ['ZOO_PROCESS_ID'] == '1' "
                "else time.sleep(60)\n")
    events = []
    rc = launcher.launch(s, [], nprocs=2, max_restarts=10, backoff=0.05,
                         grace=0.5, crash_loop_threshold=2,
                         on_event=lambda k, i: events.append((k, i)))
    assert rc == launcher.EXIT_CRASH_LOOP
    assert events[-1][0] == "crash_loop" and events[-1][1]["rank"] == 1
    assert sum(1 for k, _ in events if k == "crash") == 2


@pytest.mark.gang
def test_supervisor_restart_budget_exhausted_returns_rc(tmp_path):
    s = _script(tmp_path, "s.py", "import sys\nsys.exit(7)\n")
    rc = launcher.launch(s, [], nprocs=1, max_restarts=1, backoff=0.05,
                         grace=0.5, crash_loop_threshold=5)
    assert rc == 7


@pytest.mark.gang
def test_supervisor_kills_and_restarts_on_heartbeat_loss(tmp_path):
    s = _script(tmp_path, "s.py",
                "import os, sys, time\n"
                "time.sleep(60) if os.environ['ZOO_RESTART_COUNT'] == '0' "
                "else sys.exit(0)\n")
    events = []
    t0 = time.monotonic()
    rc = launcher.launch(s, [], nprocs=2, max_restarts=1, backoff=0.05,
                         grace=0.5, heartbeat_timeout=1.0,
                         on_event=lambda k, i: events.append((k, i)))
    assert rc == 0
    assert [k for k, _ in events] == ["hang", "restart", "ok"]
    assert time.monotonic() - t0 < 30


@pytest.mark.gang
def test_supervisor_slow_but_beating_worker_is_left_alone(tmp_path):
    s = _script(tmp_path, "s.py",
                "import os, time\n"
                "hb = os.environ['ZOO_HEARTBEAT_FILE']\n"
                "for _ in range(8):\n"
                "    time.sleep(0.25)\n"
                "    os.utime(hb, None)\n")
    events = []
    rc = launcher.launch(s, [], nprocs=2, max_restarts=1, backoff=0.05,
                         grace=0.5, heartbeat_timeout=1.0,
                         on_event=lambda k, i: events.append((k, i)))
    assert rc == 0
    assert [k for k, _ in events] == ["ok"]


GANG_TRAIN = """
import os, sys
import numpy as np
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.core import faults
from analytics_zoo_tpu_torch.core.context import init_orca_context
from analytics_zoo_tpu_torch.orca.learn import Estimator
import torch
out = sys.argv[1]
torch.set_num_threads(1)
mesh = init_orca_context("multihost")
if (os.environ["ZOO_RESTART_COUNT"] == "0"
        and os.environ["ZOO_PROCESS_ID"] == "1"):
    faults.get_registry().enable("worker.crash", times=1, after=10)
torch.manual_seed(0)
m = tnn.Sequential([tnn.Dense(4, 8, activation="relu"), tnn.Dense(8, 1)])
rng = np.random.default_rng(0)
x = rng.normal(size=(8 * 12, 4)).astype(np.float32)
y = rng.normal(size=(8 * 12, 1)).astype(np.float32)
est = Estimator.from_keras(m, loss="mse", learning_rate=1e-2, seed=0,
                           device="cpu", model_dir=os.path.join(out, "ckpt"))
est.fit((x, y), epochs=3, batch_size=12, checkpoint_trigger="every_epoch",
        auto_resume=True, verbose=False)
open(os.path.join(out, f"done_w{mesh.rank}"), "w").write(str(est._py_step))
"""


@pytest.mark.gang
def test_gang_crash_restart_resumes_to_completion(tmp_path):
    """The acceptance contract: a 3-worker gang with ``worker.crash`` armed
    on worker 1 mid-epoch 2 finishes with the right final step: the
    supervisor stops the gang on the crash and relaunches it, and every
    worker resumes from its epoch checkpoint (collective, over gloo)."""
    s = _script(tmp_path, "train.py", GANG_TRAIN)
    events = []
    rc = launcher.launch(s, [str(tmp_path)], nprocs=3, platform="cpu",
                         max_restarts=2, backoff=0.1, grace=15.0,
                         timeout=240,
                         on_event=lambda k, i: events.append((k, i)))
    assert rc == 0, events
    assert [k for k, _ in events] == ["crash", "restart", "ok"], events
    for pid in range(3):
        done = tmp_path / f"done_w{pid}"
        assert done.exists(), f"worker {pid} never finished"
        assert int(done.read_text()) == 24  # 3 epochs x 8 steps


# -- heartbeats, gang status and the gang's metrics ---------------------------

def _tiny_fit(epochs=1):
    import torch
    from analytics_zoo_tpu_torch import nn as tnn
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    est = Estimator.from_keras(tnn.Sequential([tnn.Dense(4, 1)]), loss="mse",
                               learning_rate=1e-3, device="cpu")
    return est.fit((rng.normal(size=(64, 4)).astype(np.float32),
                    rng.normal(size=(64, 1)).astype(np.float32)),
                   epochs=epochs, batch_size=16, verbose=False)


def test_heartbeat_file_carries_json_status(tmp_path):
    hb = tmp_path / "hb"
    ctx.init_orca_context("local", config=ZooConfig(
        heartbeat_file=str(hb), heartbeat_interval=0.0))
    _tiny_fit(epochs=1)
    payload = json.loads(hb.read_text())
    assert payload["step"] == 4
    assert "loss" in payload and "samples_per_sec" in payload
    assert payload["wall"] <= time.time()


def test_gang_status_aggregates_heartbeats(tmp_path, caplog):
    class FakeProc:
        def poll(self):
            return None

    hb_files = []
    for rank in range(2):
        hb = tmp_path / f"hb_w{rank}"
        hb.write_text(json.dumps({"step": 10 + rank, "loss": 0.5,
                                  "samples_per_sec": 100.0,
                                  "wall": time.time()}))
        hb_files.append(str(hb))
    status = launcher._GangStatus(interval=0.0,
                                  metrics_dir=str(tmp_path / "m"))
    procs = [FakeProc(), FakeProc()]
    with caplog.at_level(logging.INFO, logger="analytics_zoo_tpu_torch"):
        status.maybe_emit(procs, hb_files, attempt=0)
        status.maybe_emit(procs, hb_files, attempt=0)
    lines = [r.message for r in caplog.records if "gang status" in r.message]
    assert lines and "step=10" in lines[0] and "step=11" in lines[0]
    for rank in range(2):
        recs = [json.loads(ln) for ln in
                (tmp_path / "m" / f"metrics_w{rank}.jsonl").open()]
        assert len(recs) == 2
        assert recs[0]["rank"] == rank and recs[0]["step"] == 10 + rank


def test_gang_status_tolerates_legacy_touch_files(tmp_path):
    hb = tmp_path / "hb"
    hb.write_text("")
    assert launcher._read_heartbeat_payload(str(hb)) == {}
    assert launcher._read_heartbeat_payload(str(tmp_path / "missing")) == {}
    hb.write_text("{half a json")
    assert launcher._read_heartbeat_payload(str(hb)) == {}


def test_gang_fold_counters_sum_across_worker_restart():
    by = {(0, 0): {"train.steps": 10,
                   "q.depth": {"value": 3.0, "max": 7.0}},
          (0, 1): {"train.steps": 4,
                   "q.depth": {"value": 2.0, "max": 5.0}},
          (1, 0): {"train.steps": 9,
                   "q.depth": {"value": 1.0, "max": 2.0}}}
    merged = launcher._fold_gang_snapshots(by)
    assert merged["train.steps"] == 23
    assert merged["q.depth"]["value"] == 3.0
    assert merged["q.depth"]["max"] == 7.0
    assert merged == jlauncher._fold_gang_snapshots(by)


def test_aggregate_worker_metrics_tolerates_empty_torn_and_silent(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "metrics_w0.jsonl"), "w") as f:
        f.write(json.dumps({"rank": 0, "attempt": 0, "step": 3,
                            "metrics": {"c": 1}}) + "\n")
        f.write(json.dumps({"rank": 0, "attempt": 0, "step": 9,
                            "metrics": {"c": 5}}) + "\n")
        f.write('{"torn half-line')
    open(os.path.join(d, "metrics_w1.jsonl"), "w").close()
    with open(os.path.join(d, "metrics_w2.jsonl"), "w") as f:
        f.write(json.dumps({"rank": 2, "attempt": 0, "step": 1}) + "\n")
    assert launcher.aggregate_worker_metrics(d) == {"c": 5}
    with open(os.path.join(d, "metrics_w0.jsonl.1"), "w") as f:
        f.write(json.dumps({"rank": 0, "attempt": 0, "step": 1,
                            "metrics": {"c": 2}}) + "\n")
    assert launcher.aggregate_worker_metrics(d) == {"c": 5}
    assert jlauncher.aggregate_worker_metrics(d) == {"c": 5}


def test_gang_status_rotates_and_serves_merged_snapshot(tmp_path):
    import urllib.request as rq

    class FakeProc:
        def poll(self):
            return None

    hb = tmp_path / "hb_w0"
    d = str(tmp_path / "m")
    status = launcher._GangStatus(interval=0.0, metrics_dir=d,
                                  rotate_bytes=400)
    for step in range(6):
        hb.write_text(json.dumps({"step": step, "wall": time.time(),
                                  "metrics": {"train.steps": step}}))
        status.maybe_emit([FakeProc()], [str(hb)], attempt=0)
    assert os.path.exists(os.path.join(d, "metrics_w0.jsonl.1"))
    for path in glob.glob(os.path.join(d, "metrics_w0.jsonl*")):
        for line in open(path):
            json.loads(line)
    lines = [json.loads(ln) for ln in
             open(os.path.join(d, "gang_metrics.jsonl"))]
    assert lines[-1]["metrics"]["train.steps"] == 5
    srv = launcher._GangMetricsServer(0, status)
    try:
        text = rq.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                          timeout=10).read().decode()
        assert "zoo_train_steps 5" in text
    finally:
        srv.stop()


def test_heartbeat_embeds_registry_snapshot_when_supervised(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("ZOO_HEARTBEAT_METRICS", "1")
    hb = tmp_path / "hb"
    ctx.init_orca_context("local", config=ZooConfig(
        heartbeat_file=str(hb), heartbeat_interval=0.0))
    metrics_lib.get_registry().reset()
    _tiny_fit(epochs=1)
    snap = json.loads(hb.read_text())["metrics"]
    assert snap["train.steps"] == 4
    assert snap["train.step_ms"]["count"] == 4
    merged = launcher._fold_gang_snapshots({(0, 0): snap, (1, 0): snap})
    assert merged["train.steps"] == 8


def test_config_wiring_arms_global_registry():
    cfg = ZooConfig(faults={"serving.queue_reject": {"times": 1}})
    ctx.init_orca_context("local", config=cfg)
    assert get_registry().is_armed("serving.queue_reject")
    assert get_registry().fire("serving.queue_reject")


def test_context_mesh_layouts_by_strategy():
    """``make_mesh`` lays out ranks as the JAX package lays out devices:
    the same axes, sizes and row-major order."""
    from analytics_zoo_tpu.core.context import make_mesh as jmake
    import jax
    for shape, n in (("2d", 8), ("fsdp", 4), ({"data": 2, "model": 2}, 4),
                     ("tp", 2), ({"data": 0}, 1)):
        mine = ctx.make_mesh(shape, n_devices=n)
        theirs = jmake(shape, devices=jax.devices()[:n])
        assert mine.axis_names == theirs.axis_names
        assert mine.devices.shape == theirs.devices.shape
        ids = np.vectorize(lambda d: d.id)(theirs.devices)
        np.testing.assert_array_equal(mine.devices, ids - ids.min())
