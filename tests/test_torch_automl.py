"""The port's automl (``analytics_zoo_tpu_torch/automl``) against the JAX
package on the CPU, and the Estimator's device lock.

- ``hp``: every sampler and ``grid`` give the JAX package's values for one
  numpy seed; ``RandomSearchEngine.configs`` and ``GridSearchEngine``'s
  draw the JAX engines' configs for the same seed.
- The engines' twins of ``tests/test_automl.py``: ASHA prunes bad trials
  (the same trials as the JAX engine's), a failing trial does not end the
  search, trials overlap with ``max_concurrent=2``, a trial past its wall
  clock is ``timeout`` (at the hard wall and at ``report``), transient
  failures are retried and a spent budget is ``error``; each trial
  records ``automl.trial_ms`` and ``automl.trials`` in the port's
  registry.
- ``AutoEstimator`` over port modules end to end, ``"asha"`` and a
  pre-existing engine.
- Three threads' ``fit``s through the port's Estimator never overlap
  inside the device lock, and each gives the losses it gives alone.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import analytics_zoo_tpu.automl as jautoml
from analytics_zoo_tpu.automl import hp as jhp
import analytics_zoo_tpu_torch.nn as tnn
from analytics_zoo_tpu_torch import automl
from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.core import metrics as telemetry
from analytics_zoo_tpu_torch.models.common import init_weights
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.orca.learn.estimator import ZooEstimator


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(h):
    return {"a": h.choice([1, 2, 3]), "b": h.uniform(0.0, 1.0),
            "c": h.randint(5, 10), "d": h.loguniform(1e-4, 1e-1),
            "e": h.quniform(0, 10, 2), "g": h.grid_search(["x", "y"]),
            "fixed": 7}


def test_hp_samples_and_grid_equal_jax():
    got = [hp.sample(_space(hp), r) for r in [np.random.default_rng(0)]
           for _ in range(25)]
    want = [jhp.sample(_space(jhp), r) for r in [np.random.default_rng(0)]
            for _ in range(25)]
    assert got == want
    for s in got:
        assert s["a"] in (1, 2, 3) and 5 <= s["c"] < 10
        assert 1e-4 <= s["d"] <= 1e-1 and s["e"] % 2 == 0
    assert hp.grid(_space(hp)) == jhp.grid(_space(jhp))


@pytest.mark.parametrize("engine", ["RandomSearchEngine",
                                    "GridSearchEngine"])
def test_engine_configs_equal_jax_for_the_seed(engine):
    got = getattr(automl, engine)(seed=11).configs(_space(hp), 6)
    want = getattr(jautoml, engine)(seed=11).configs(_space(jhp), 6)
    assert got == want and len(got) == 6


def test_random_search_finds_good_config():
    def trial(config, report):
        m = (config["x"] - 3.0) ** 2
        report(m, 1)
        return m

    eng = automl.RandomSearchEngine(metric_mode="min", seed=0)
    best = eng.run(trial, {"x": hp.uniform(-10, 10)}, n_trials=40)
    assert abs(best.config["x"] - 3.0) < 2.0
    assert len(eng.trials) == 40


def _asha_run(pkg, h):
    def trial(config, report):
        for step in range(1, 10):
            report(config["level"], step)
        return config["level"]

    sched = pkg.ASHAScheduler(metric_mode="min", grace_period=1,
                              reduction_factor=3, max_t=9)
    eng = pkg.RandomSearchEngine(metric_mode="min", scheduler=sched, seed=1)
    best = eng.run(trial, {"level": h.uniform(0, 1)}, n_trials=12)
    return eng, best


def test_asha_prunes_the_trials_jax_prunes():
    eng, best = _asha_run(automl, hp)
    jeng, jbest = _asha_run(jautoml, jhp)
    pruned = [t.status for t in eng.trials]
    assert "pruned" in pruned
    assert pruned == [t.status for t in jeng.trials]
    assert [t.history for t in eng.trials] == [t.history
                                               for t in jeng.trials]
    assert best.metric == jbest.metric == min(
        t.metric for t in eng.trials if t.metric is not None)


def test_search_survives_failing_trials():
    def trial(config, report):
        if config["x"] < 0:
            raise RuntimeError("boom")
        return config["x"]

    eng = automl.RandomSearchEngine(metric_mode="min", seed=0)
    best = eng.run(trial, {"x": hp.uniform(-1, 1)}, n_trials=16)
    assert best.metric is not None and best.metric >= 0
    assert any(t.status == "error" for t in eng.trials)


def test_trials_run_concurrently():
    active, peak = [0], [0]
    lock = threading.Lock()

    def trial_fn(config, report):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.2)
        with lock:
            active[0] -= 1
        return config["x"]

    eng = automl.RandomSearchEngine(metric_mode="min", max_concurrent=2,
                                    seed=0)
    best = eng.run(trial_fn, {"x": hp.uniform(0, 1)}, n_trials=4)
    assert peak[0] >= 2, f"never overlapped (peak={peak[0]})"
    assert best.metric == min(t.metric for t in eng.trials)


def test_trial_timeout_does_not_wedge_search():
    def trial(config, report):
        if config["x"] == 0:
            time.sleep(3.0)  # never reports: only the hard wall stops it
        return float(config["x"])

    eng = automl.GridSearchEngine(metric_mode="min", trial_timeout_s=0.4)
    best = eng.run(trial, {"x": hp.choice([0, 1, 2])}, n_trials=3)
    statuses = {t.config["x"]: t.status for t in eng.trials}
    assert statuses[0] == "timeout"
    assert statuses[1] == statuses[2] == "done"
    assert best.metric == 1.0
    slow = next(t for t in eng.trials if t.config["x"] == 0)
    assert slow.duration_s < 2.5


def test_trial_timeout_cooperative_via_report():
    def trial(config, report):
        for step in range(100):
            time.sleep(0.05)
            report(10.0 - step, step)
        return 0.0

    eng = automl.RandomSearchEngine(metric_mode="min", trial_timeout_s=0.3,
                                    seed=0)
    best = eng.run(trial, {"x": hp.uniform(0, 1)}, n_trials=1)
    t = eng.trials[0]
    assert t.status == "timeout" and t.history
    assert t.metric == min(t.history) and best is t


def test_trial_transient_failure_retried_and_budget_spent():
    attempts = {}

    def flaky(config, report):
        key = round(config["x"], 6)
        attempts[key] = attempts.get(key, 0) + 1
        if attempts[key] == 1:
            raise ConnectionError("transient blip")
        return config["x"]

    eng = automl.RandomSearchEngine(metric_mode="min", trial_retries=1,
                                    seed=0)
    assert eng.run(flaky, {"x": hp.uniform(0, 1)}, n_trials=4) is not None
    assert [(t.status, t.retries) for t in eng.trials] == [("done", 1)] * 4

    def broken(config, report):
        raise RuntimeError("always broken")

    eng = automl.RandomSearchEngine(metric_mode="min", trial_retries=2,
                                    seed=0)
    with pytest.raises(RuntimeError, match="all 2 trials failed"):
        eng.run(broken, {"x": hp.uniform(0, 1)}, n_trials=2)
    assert [(t.status, t.retries) for t in eng.trials] == [("error", 2)] * 2


def test_trials_record_the_ports_metrics():
    reg = telemetry.get_registry()
    before = reg.counter("automl.trials", status="done").value
    eng = automl.RandomSearchEngine(seed=0)
    eng.run(lambda config, report: config["x"], {"x": hp.uniform(0, 1)},
            n_trials=3)
    assert reg.counter("automl.trials", status="done").value == before + 3
    assert reg.histogram("automl.trial_ms").count >= 3


def _regression(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return x, x @ rng.normal(size=(8, 1)).astype(np.float32)


def _mlp(config):
    return init_weights(
        tnn.Sequential([tnn.Dense(8, config["hidden"], activation="relu"),
                        tnn.Dense(config["hidden"], 1)]),
        torch.Generator().manual_seed(0))


def test_auto_estimator_end_to_end():
    x, y = _regression()
    auto = automl.AutoEstimator.from_keras(_mlp, loss="mse", metric="mse",
                                           device="cpu")
    auto.fit((x, y), epochs=2, batch_size=16, n_sampling=3,
             search_space={"hidden": hp.choice([4, 8]),
                           "lr": hp.choice([1e-2, 1e-3])},
             scheduler="asha", max_concurrent=2)
    assert auto.get_best_config()["hidden"] in (4, 8)
    assert isinstance(auto.engine.scheduler, automl.ASHAScheduler)
    est = auto.get_best_estimator()
    assert est.device.type == "cpu"
    # the refitted winner has learned: below its own untrained start
    untrained = Estimator.from_keras(_mlp(auto.get_best_config()),
                                     loss="mse", metrics=["mse"],
                                     device="cpu")
    assert est.evaluate((x, y), batch_size=16)["mse"] < \
        untrained.evaluate((x, y), batch_size=16)["mse"]
    assert auto.get_best_model() is est.model
    assert len(auto.trials) == 3


def test_fit_args_apply_to_preexisting_engine():
    eng = automl.GridSearchEngine(metric_mode="min")
    auto = automl.AutoEstimator(
        lambda cfg: tnn.Sequential([tnn.Dense(4, 2)]),
        loss="sparse_categorical_crossentropy", search_engine=eng,
        device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    sched = automl.ASHAScheduler(metric_mode="min")
    auto.fit((x, y), epochs=1, n_sampling=2,
             search_space={"lr": hp.choice([1e-3, 1e-2])},
             scheduler=sched, max_concurrent=2)
    assert eng.max_concurrent == 2 and eng.scheduler is sched


def test_threads_fits_never_overlap_inside_the_device_lock():
    """Each train step of three estimators fitting from three threads at
    once (the interpreter switching threads every 10 us) runs while no
    other is inside one; each fit gives the losses it gives alone."""
    inside, peak, steps = [0], [0], [0]
    guard = threading.Lock()

    def estimator():
        est = Estimator.from_keras(_mlp({"hidden": 6}), loss="mse",
                                   optimizer="adam", learning_rate=1e-2,
                                   device="cpu")
        inner = est._train_step

        def step(batch):
            assert ZooEstimator._device_lock._is_owned()
            with guard:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
                steps[0] += 1
            time.sleep(0.002)  # room for another thread to step in
            try:
                return inner(batch)
            finally:
                with guard:
                    inside[0] -= 1

        est._train_step = step
        return est

    data = [_regression(96, seed=s) for s in (1, 2, 3)]
    alone = [estimator().fit(d, epochs=3, batch_size=16,
                             verbose=False)["loss"] for d in data]
    ests = [estimator() for _ in data]
    out = [None] * len(data)

    def run(i):
        out[i] = ests[i].fit(data[i], epochs=3, batch_size=16,
                             verbose=False)["loss"]
        ests[i].evaluate(data[i], batch_size=16)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(data))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert out == alone
    assert steps[0] == 2 * 3 * 3 * 6 and peak[0] == 1
