"""The port's twin of ``tests/test_faults.py``: the fault-injection
registry of ``analytics_zoo_tpu_torch/core/faults.py`` (a copy of the JAX
package's) and its seams in the port.

The registry itself must be boring and exact: disabled points are no-ops,
armed points fire deterministically (seeded), counts are bounded, and the
scoped helpers always disarm.  The config case arms the registry from a
``ZooConfig``'s ``faults`` directly; its twin at context init
(``init_orca_context``) is in ``tests/test_torch_gang.py``.
"""

import threading
import time

import pytest

from analytics_zoo_tpu_torch.core.faults import (FaultRegistry,
                                                 KNOWN_POINTS, get_registry,
                                                 register_point)

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _clean_global_registry():
    get_registry().reset()
    yield
    get_registry().reset()


def test_disarmed_point_is_noop():
    r = FaultRegistry()
    assert not r.fire("serving.conn_drop")
    r.raise_if("checkpoint.write_fail")  # must not raise
    assert r.hits("serving.conn_drop") == 1
    assert r.fired("serving.conn_drop") == 0


def test_enable_unknown_point_raises():
    r = FaultRegistry()
    with pytest.raises(ValueError, match="unknown injection point"):
        r.enable("serving.conn_dorp")  # typo must fail loudly


def test_register_point_extends_known_set():
    name = register_point("serving.test_only_point")
    try:
        r = FaultRegistry()
        r.enable(name, times=1)
        assert r.fire(name)
    finally:
        KNOWN_POINTS.discard(name)


def test_times_bounds_fires_then_disarms():
    r = FaultRegistry()
    r.enable("serving.queue_reject", times=3)
    fires = [r.fire("serving.queue_reject") for _ in range(10)]
    assert fires == [True] * 3 + [False] * 7
    assert not r.is_armed("serving.queue_reject")
    assert r.fired("serving.queue_reject") == 3
    assert r.hits("serving.queue_reject") == 10


def test_prob_is_seeded_and_deterministic():
    def run(seed):
        r = FaultRegistry()
        r.enable("feed.stall", prob=0.5, seed=seed)
        return [r.fire("feed.stall") for _ in range(64)]

    a, b = run(7), run(7)
    assert a == b  # same seed, same firing pattern
    assert any(a) and not all(a)  # actually probabilistic
    assert run(7) != run(8)  # and seed-dependent


def test_raise_if_uses_armed_exception_type():
    r = FaultRegistry()
    r.enable("checkpoint.write_fail", times=1, exc=OSError,
             message="disk on fire")
    with pytest.raises(OSError, match="disk on fire"):
        r.raise_if("checkpoint.write_fail")
    r.raise_if("checkpoint.write_fail")  # charge consumed: no-op now


def test_raise_if_default_exception_is_runtime_error():
    r = FaultRegistry()
    r.enable("checkpoint.write_fail", times=1)
    with pytest.raises(RuntimeError, match="injected fault"):
        r.raise_if("checkpoint.write_fail")


def test_delay_sleeps_on_fire_only():
    r = FaultRegistry()
    r.enable("serving.model_latency", times=1, delay=0.05)
    t0 = time.monotonic()
    assert r.fire("serving.model_latency")
    assert time.monotonic() - t0 >= 0.05
    t0 = time.monotonic()
    assert not r.fire("serving.model_latency")  # disarmed: no sleep
    assert time.monotonic() - t0 < 0.04


def test_armed_context_manager_disarms_on_exit():
    r = FaultRegistry()
    with r.armed("serving.conn_drop"):
        assert r.is_armed("serving.conn_drop")
        assert r.fire("serving.conn_drop")
    assert not r.is_armed("serving.conn_drop")
    assert not r.fire("serving.conn_drop")


def test_armed_disarms_on_exception():
    r = FaultRegistry()
    with pytest.raises(KeyError):
        with r.armed("serving.conn_drop"):
            raise KeyError("boom")
    assert not r.is_armed("serving.conn_drop")


def test_reset_clears_specs_and_counters():
    r = FaultRegistry()
    r.enable("feed.stall")
    r.fire("feed.stall")
    r.reset()
    assert not r.is_armed("feed.stall")
    assert r.hits("feed.stall") == 0
    assert r.snapshot() == {}


def test_configure_from_dict_with_string_exception():
    r = FaultRegistry()
    r.configure({"checkpoint.write_fail": {"times": 1, "exc": "OSError"}})
    with pytest.raises(OSError):
        r.raise_if("checkpoint.write_fail")


def test_configure_rejects_non_exception_name():
    r = FaultRegistry()
    with pytest.raises(ValueError, match="not an .*exception"):
        r.configure({"feed.stall": {"exc": "print"}})


def test_configure_none_is_noop():
    r = FaultRegistry()
    r.configure(None)
    r.configure({})
    assert not r.is_armed("feed.stall")


def test_enable_validates_times_and_prob():
    r = FaultRegistry()
    with pytest.raises(ValueError, match="times"):
        r.enable("feed.stall", times=0)
    with pytest.raises(ValueError, match="prob"):
        r.enable("feed.stall", prob=0.0)
    with pytest.raises(ValueError, match="prob"):
        r.enable("feed.stall", prob=1.5)


def test_snapshot_reports_hits_and_fired():
    r = FaultRegistry()
    r.enable("serving.queue_reject", times=1)
    r.fire("serving.queue_reject")
    r.fire("serving.queue_reject")
    r.fire("serving.conn_drop")
    snap = r.snapshot()
    assert snap["serving.queue_reject"] == {"hits": 2, "fired": 1}
    assert snap["serving.conn_drop"] == {"hits": 1, "fired": 0}


def test_thread_safety_times_never_oversubscribed():
    """N threads hammering an armed point must fire EXACTLY ``times``
    faults in total — the charge decrement is atomic under the lock."""
    r = FaultRegistry()
    r.enable("serving.queue_reject", times=50)
    fired = []
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        count = sum(r.fire("serving.queue_reject") for _ in range(100))
        fired.append(count)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sum(fired) == 50
    assert r.hits("serving.queue_reject") == 800


def test_config_wiring_arms_global_registry():
    """``ZooConfig.faults`` arms the process-global registry (the "via
    config" half of the per-test-or-via-config contract; the JAX package
    applies it at context init, which the port does not have yet)."""
    from analytics_zoo_tpu_torch.core.config import ZooConfig
    cfg = ZooConfig(faults={"serving.queue_reject": {"times": 1}})
    get_registry().configure(cfg.faults)
    assert get_registry().is_armed("serving.queue_reject")
    assert get_registry().fire("serving.queue_reject")


def test_feed_stall_point_is_wired():
    """DataFeed.epoch hits ``feed.stall`` once per step."""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.data import DataFeed
    feed = DataFeed.from_arrays(np.zeros((8, 2), np.float32),
                                np.zeros((8, 1), np.float32),
                                batch_size=4, shuffle=False)
    before = get_registry().hits("feed.stall")
    list(feed.epoch(torch.device("cpu"), 0))
    assert get_registry().hits("feed.stall") - before == 2


def test_training_fault_points_are_known():
    # the gang-supervision and self-healing injection points
    for name in ("worker.crash", "worker.hang", "feed.read_fail",
                 "step.nan"):
        assert name in KNOWN_POINTS


def test_after_skips_initial_hits():
    """``after=K`` arms "fire on hit K+1": the deterministic handle for
    "crash at step N" in gang tests."""
    r = FaultRegistry()
    r.enable("step.nan", times=1, after=3)
    fires = [r.fire("step.nan") for _ in range(6)]
    assert fires == [False, False, False, True, False, False]
    assert r.hits("step.nan") == 6
    assert r.fired("step.nan") == 1


def test_after_validates_non_negative():
    r = FaultRegistry()
    with pytest.raises(ValueError, match="after"):
        r.enable("step.nan", after=-1)


def test_armed_points_lists_and_clears():
    r = FaultRegistry()
    assert r.armed_points() == []
    r.enable("feed.stall")
    r.enable("step.nan", times=1)
    assert r.armed_points() == ["feed.stall", "step.nan"]
    r.fire("step.nan")  # last charge consumed: auto-disarmed
    assert r.armed_points() == ["feed.stall"]
    r.reset()
    assert r.armed_points() == []


def test_feed_read_fail_point_is_wired_and_retried():
    """StreamingDataFeed hits ``feed.read_fail`` inside its retry loop: an
    armed one-shot failure is absorbed by retries=1 and every row still
    arrives exactly once."""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.data import StreamingDataFeed
    feed = StreamingDataFeed(
        num_samples=8,
        load_sample=lambda i, rng=None: {"x": np.full((2,), float(i),
                                                      np.float32)},
        batch_size=4, shuffle=False, num_workers=1, retries=1)
    with get_registry().armed("feed.read_fail", times=1):
        batches = list(feed.epoch(torch.device("cpu"), 0))
    assert get_registry().fired("feed.read_fail") == 1
    assert feed.load_failures == 1
    assert feed.skipped_rows == 0  # retried, not skipped
    rows = sorted(float(v) for b in batches
                  for v in np.asarray(b["x"])[:, 0])
    assert rows == [float(i) for i in range(8)]


def test_step_nan_point_is_wired():
    """The estimator hits ``step.nan`` once per train step; disarmed it
    must be a pure counter."""
    import numpy as np
    from analytics_zoo_tpu_torch import nn
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    est = Estimator.from_keras(nn.Sequential([nn.Dense(4, 1)]), loss="mse",
                               learning_rate=1e-3, device="cpu")
    rng = np.random.default_rng(0)
    before = get_registry().hits("step.nan")
    est.fit((rng.normal(size=(64, 4)).astype(np.float32),
             rng.normal(size=(64, 1)).astype(np.float32)),
            epochs=1, batch_size=32, verbose=False)
    assert get_registry().hits("step.nan") - before == 2  # 2 steps
    assert get_registry().fired("step.nan") == 0
