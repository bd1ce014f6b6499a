"""The port's preemption-safe training (``core/failover.py``) on the CPU:
twins of ``tests/test_failover.py``'s guard and preemption tests (its
gang-supervisor cases are twinned in ``tests/test_torch_gang.py``),
a SIGTERM to a training subprocess that checkpoints and resumes, and the
in-process preemption of a fit whose ``Preempted.step`` is the restored
state's step."""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
from analytics_zoo_tpu_torch.core import ckpt_manager as cm
from analytics_zoo_tpu_torch.core import failover
from analytics_zoo_tpu_torch.core.failover import (Preempted,
                                                   PreemptionGuard)
from analytics_zoo_tpu_torch.orca.learn import Estimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_preemption_worker.py")


def _spawn(model_dir, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, WORKER, str(model_dir), *args], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sigterm_checkpoints_and_resumes(tmp_path, mode):
    model_dir = tmp_path / "ckpt"
    proc = _spawn(model_dir, "100000", mode)
    try:
        line = ""
        deadline = time.time() + 120
        while "TRAINING_STARTED" not in line:
            assert time.time() < deadline, "worker never started training"
            line = proc.stdout.readline()
        time.sleep(1.0)  # let a few steps run
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 143, out[-3000:]
    m = re.search(r"PREEMPTED step=(\d+) durable=True", out)
    assert m, out[-3000:]
    preempted_step = int(m.group(1))
    assert preempted_step > 0 and preempted_step % 2 == 0  # sync_every=2
    if mode == "sync":
        assert ckpt_io.latest_step(str(model_dir)) == preempted_step
        saved_epoch = ckpt_io.load_extra(str(model_dir)).get("epoch", 0)
    else:
        rec = cm.visible_generations(str(model_dir))[-1]
        assert rec["step"] == preempted_step
        saved_epoch = rec["extra"].get("epoch", 0)
    # epochs is the TOTAL target: two more than the saved epoch
    proc2 = _spawn(model_dir, str(saved_epoch + 2), mode)
    out2, _ = proc2.communicate(timeout=180)
    assert proc2.returncode == 0, out2[-3000:]
    m2 = re.search(r"FINISHED step=(\d+)", out2)
    assert m2, out2[-3000:]
    # the interrupted epoch runs again from its start, the count carried on
    assert int(m2.group(1)) == preempted_step + 2 * 8


def test_guard_consensus_single_process():
    g = PreemptionGuard(sync_every=4)
    g.active = True
    assert not g.should_checkpoint(4)
    g._on_signal(signal.SIGTERM, None)
    assert not g.should_checkpoint(5)
    assert g.should_checkpoint(8)


def test_guard_inactive_signal_chains_to_default():
    g = PreemptionGuard(sync_every=2).install()
    try:
        assert g._installed
        with pytest.raises(KeyboardInterrupt):
            g._on_signal(signal.SIGINT, None)
        assert not g.flagged
    finally:
        g.uninstall()


def test_preempted_reports_durable_step_exactly():
    landed = Preempted(0, "/ckpt")
    assert landed.step == 0 and landed.durable
    missed = Preempted(7, "/ckpt", durable=False)
    assert missed.step == 7 and not missed.durable
    assert "NOT durable" in str(missed)
    assert not isinstance(missed, Exception)  # a BaseException


def test_guard_inactive_signal_chains_to_callable_prev():
    calls = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: calls.append(s))
    g = PreemptionGuard(sync_every=2).install()
    try:
        assert g.active is False
        g._on_signal(signal.SIGTERM, None)
        assert calls == [signal.SIGTERM]
        assert not g.flagged
        g._on_signal(signal.SIGTERM, None)
        assert calls == [signal.SIGTERM] * 2
    finally:
        g.uninstall()
        signal.signal(signal.SIGTERM, prev)


def test_guard_inactive_signal_sig_dfl_reraises():
    from unittest import mock
    g = PreemptionGuard(sync_every=2)
    g._prev_handlers[signal.SIGTERM] = signal.SIG_DFL
    g._installed = True
    try:
        with mock.patch.object(failover.signal, "signal") as m_sig, \
                mock.patch.object(failover.signal,
                                  "raise_signal") as m_raise:
            g._on_signal(signal.SIGTERM, None)
        m_sig.assert_called_once_with(signal.SIGTERM, signal.SIG_DFL)
        m_raise.assert_called_once_with(signal.SIGTERM)
        assert not g.flagged
    finally:
        g._installed = False
        g._prev_handlers.clear()


def test_uninstall_restores_handlers_exactly_once():
    h0 = lambda s, f: None  # noqa: E731
    prev = signal.signal(signal.SIGTERM, h0)
    try:
        g = PreemptionGuard(sync_every=2).install()
        assert signal.getsignal(signal.SIGTERM) == g._on_signal
        g.uninstall()
        assert signal.getsignal(signal.SIGTERM) is h0
        h1 = lambda s, f: None  # noqa: E731
        signal.signal(signal.SIGTERM, h1)
        g.uninstall()
        assert signal.getsignal(signal.SIGTERM) is h1
        g.install()
        assert signal.getsignal(signal.SIGTERM) == g._on_signal
        g.uninstall()
        assert signal.getsignal(signal.SIGTERM) is h1
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_signal_handler_is_lock_free():
    import logging
    from unittest import mock
    g = PreemptionGuard(sync_every=1)
    g.active = True
    with mock.patch.object(failover.logger, "warning",
                           side_effect=AssertionError(
                               "logging inside the signal handler")), \
         mock.patch.object(logging.Handler, "acquire",
                           side_effect=AssertionError(
                               "lock acquire inside the signal handler")):
        g._on_signal(signal.SIGTERM, None)
        assert g._flag
    assert g.flagged
    assert g.should_checkpoint(1)


def _model():
    return tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                           tnn.Dense(8, 1)])


@pytest.mark.parametrize("use_async", [False, True])
def test_in_process_preemption_checkpoints_the_live_state(tmp_path,
                                                          use_async):
    """SIGTERM from a timer thread mid-fit: ``Preempted.step`` is the
    checkpoint's step, and the restored tree is the live state there."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    y = rng.normal(size=(512, 1)).astype(np.float32)
    d = str(tmp_path / "m")
    est = Estimator.from_keras(_model(), loss="mse", learning_rate=1e-3,
                               device="cpu", model_dir=d,
                               preemption_checkpoint=True,
                               preemption_sync_every=3,
                               checkpoint_async=use_async)
    timer = threading.Timer(0.5, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        with pytest.raises(Preempted) as info:
            est.fit((x, y), epochs=10000, batch_size=8, verbose=False)
    finally:
        timer.cancel()
        est._preempt.uninstall()
    assert info.value.durable and info.value.step == est._py_step
    assert info.value.step % 3 == 0
    back = Estimator.from_keras(_model(), loss="mse", learning_rate=1e-3,
                                device="cpu", model_dir=d,
                                checkpoint_async=use_async)
    back.load(d)
    assert back._py_step == info.value.step
    assert back._epoch == est._epoch
    got, want = back._save_tree(), est._save_tree()
    for key in ("params", "opt_state"):
        gl, gs = ckpt_io.flatten(got[key])
        wl, ws = ckpt_io.flatten(want[key])
        assert gs == ws
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
