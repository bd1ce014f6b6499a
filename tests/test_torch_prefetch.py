"""The port's ``PrefetchIterator`` and ``Estimator.fit(prefetch=)`` on the
CPU: twins of ``tests/test_data.py::TestPrefetchIterator``,
``tests/test_stream_shm.py::TestPrefetchPlace`` and
``tests/test_estimator.py::test_fit_prefetch_*``, the fits held against
the JAX Estimator from one JAX init, and the step loop's telemetry.

Tolerances: a prefetched fit against the inline one, exactly (a
scheduling change: the same batches in the same order through the same
step); against the JAX Estimator, loss histories 1e-4 relative (the same
f32 math in another order, the JAX batch split over the 8 simulated CPU
devices; Adam at 1e-2 rescales each gradient's rounding by its own
magnitude, and 12 steps of it moved the MLP's losses by 2.3e-5).
"""

import itertools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.data import StreamingDataFeed as JaxStreamingDataFeed
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import metrics, trace
from analytics_zoo_tpu_torch.data import (PrefetchIterator,
                                          StreamingDataFeed, make_placer)
from analytics_zoo_tpu_torch.orca.learn import Estimator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- PrefetchIterator (tests/test_data.py::TestPrefetchIterator) ---------------

class TestPrefetchIterator:
    def test_order_preserved_and_complete(self):
        items = [np.full((3,), float(i)) for i in range(17)]
        got = list(PrefetchIterator(iter(items), depth=2))
        assert len(got) == 17
        for i, a in enumerate(got):
            np.testing.assert_array_equal(a, items[i])

    def test_producer_exception_reraises_in_consumer(self):
        def gen():
            yield 1
            yield 2
            raise OSError("loader died")

        it = PrefetchIterator(gen(), depth=2)
        assert next(it) == 1 and next(it) == 2
        with pytest.raises(OSError, match="loader died"):
            next(it)
        # after the error the iterator is exhausted, not wedged
        assert next(it, None) is None

    def test_close_mid_epoch_stops_producer(self):
        produced = []

        def gen():
            for i in itertools.count():
                produced.append(i)
                yield i

        it = PrefetchIterator(gen(), depth=2)
        assert next(it) == 0
        it.close()
        n_threads = threading.active_count()
        it.close()  # idempotent
        assert threading.active_count() == n_threads
        # the producer stopped near the depth bound, not at infinity
        assert len(produced) <= 8
        with pytest.raises(StopIteration):
            next(it)

    def test_depth_validated(self):
        with pytest.raises(ValueError, match="depth"):
            PrefetchIterator(iter([]), depth=0)

    def test_overlaps_slow_feed_with_slow_consumer(self):
        """With depth-2 double buffering a feed taking F per batch and a
        consumer taking C per step run in about max(F, C) per item, not
        F + C."""
        def slow_feed(n=8, per=0.03):
            for i in range(n):
                time.sleep(per)
                yield i

        t0 = time.monotonic()
        for _ in slow_feed():
            time.sleep(0.03)
        inline = time.monotonic() - t0
        t0 = time.monotonic()
        for _ in PrefetchIterator(slow_feed(), depth=2):
            time.sleep(0.03)
        overlapped = time.monotonic() - t0
        assert overlapped < inline * 0.8, (inline, overlapped)


# -- the place hook (tests/test_stream_shm.py::TestPrefetchPlace) -------------

class TestPrefetchPlace:
    def test_place_runs_in_producer_and_retires_slots(self):
        released = []

        class FakeSlot(dict):
            def __init__(self, i):
                super().__init__(x=np.full((2,), float(i)))
                self.i = i

            def release(self):
                released.append(self.i)

        placed_order, placed_on = [], set()

        def place(b):
            placed_order.append(b.i)
            placed_on.add(threading.current_thread().name)
            return dict(b)

        items = [FakeSlot(i) for i in range(5)]
        out = list(PrefetchIterator(iter(items), depth=2, place=place))
        assert len(out) == 5
        assert placed_order == [0, 1, 2, 3, 4]
        assert placed_on == {"zoo-prefetch"}
        assert sorted(released) == [0, 1, 2, 3, 4]
        # retirement trails placement by exactly one item
        assert released[0] == 0 and released[-1] == 4

    def test_plain_items_pass_through_unreleased(self):
        out = list(PrefetchIterator(iter([{"x": 1}, {"x": 2}]), depth=2,
                                    place=lambda b: b))
        assert out == [{"x": 1}, {"x": 2}]

    def test_cpu_placer_copies_a_slot_before_it_is_released(self):
        """On the CPU ``torch.from_numpy`` would alias the slot: the placed
        tensor must keep its values after the slot is overwritten."""
        from analytics_zoo_tpu_torch.data.shm_pool import (ShmBatchPool,
                                                           SlotBatch)
        pool = ShmBatchPool(2, 2, {"x": ((3,), np.float32)})
        try:
            s = pool.acquire(timeout=1)
            pool.views(s)["x"][:] = 7.0
            placed = make_placer("cpu")(SlotBatch(pool.views(s), s, pool))
            pool.views(s)["x"][:] = -1.0  # the slot reused
            assert torch.equal(placed["x"], torch.full((2, 3), 7.0))
        finally:
            pool.close()


# -- fit(prefetch=) (tests/test_estimator.py::test_fit_prefetch_*) -------------

def make_blobs(n=256, dim=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)) * 3
    y = rng.integers(0, classes, n)
    x = centers[y] + rng.normal(size=(n, dim)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def _mlps():
    """The JAX Estimator's MLP (its own init) and the port's over the same
    weights, adam at 1e-2."""
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-2, seed=3)
    jest = JaxEstimator.from_keras(
        jnn.Sequential([jnn.Dense(32, activation="relu"), jnn.Dense(4)]), **kw)
    jest._ensure_initialized(jnp.zeros((64, 8), jnp.float32))
    port = tnn.Sequential([tnn.Dense(8, 32, activation="relu"),
                           tnn.Dense(32, 4)])
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    return jest, Estimator.from_keras(port, device="cpu", **kw)


def test_fit_prefetch_matches_inline_bitwise():
    """fit(prefetch=2) is a scheduling change only: the loss history of
    prefetch=0, bit for bit, and the JAX Estimator's."""
    init_orca_context("local")
    x, y = make_blobs()
    hist = {}
    for prefetch in (0, 2):
        jest, test = _mlps()
        hist[prefetch] = test.fit((x, y), epochs=3, batch_size=64,
                                  verbose=False, prefetch=prefetch)
    assert hist[0]["loss"] == hist[2]["loss"]
    want = jest.fit((x, y), epochs=3, batch_size=64, verbose=False,
                    prefetch=2)
    np.testing.assert_allclose(hist[2]["loss"], want["loss"], rtol=1e-4)


def test_fit_prefetch_records_depth_gauge():
    reg = metrics.get_registry()
    reg.reset()
    x, y = make_blobs()
    _, est = _mlps()
    est.fit((x, y), epochs=1, batch_size=64, verbose=False, prefetch=2)
    snap = reg.snapshot()
    assert "train.prefetch_depth" in snap
    assert snap["train.prefetch_depth"]["max"] <= 2


def test_fit_records_the_jax_fits_step_metrics_and_spans():
    """train.steps, train.samples, train.step_ms, train.data_wait_ms under
    the JAX package's names; one train.step span a step under its
    train.epoch span."""
    reg = metrics.get_registry()
    reg.reset()
    x, y = make_blobs()
    _, est = _mlps()
    est.fit((x, y), epochs=2, batch_size=64, verbose=False)
    snap = reg.snapshot()
    assert snap["train.steps"] == 8 and snap["train.samples"] == 8 * 64
    assert snap["train.step_ms"]["count"] == 8
    assert snap["train.data_wait_ms"]["count"] == 8
    spans = trace.find(est.trace_id)
    steps = [s for s in spans if s.where == "train.step"]
    epochs = [s for s in spans if s.where == "train.epoch"]
    assert len(steps) == 8 and len(epochs) == 2
    assert {s.parent_id for s in steps} == {e.span_id for e in epochs}


def test_fit_default_prefetch_is_the_config_default():
    from analytics_zoo_tpu_torch.core.config import ZooConfig
    reg = metrics.get_registry()
    reg.reset()
    x, y = make_blobs()
    _, est = _mlps()
    est.fit((x, y), epochs=1, batch_size=64, verbose=False)
    assert ZooConfig.prefetch == 2
    assert "train.prefetch_depth" in reg.snapshot()


def test_fit_prefetch_with_streaming_feed():
    """StreamingDataFeed composes with the estimator-level prefetcher (the
    stream's host batches placed in the producer): row accounting stays
    exact, and the loss history is the JAX Estimator's over the same
    stream."""
    init_orca_context("local")
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(96, 8)).astype(np.float32)
    ys = (xs.sum(axis=1) > 0).astype(np.int32) * 3

    def load(i, rng=None):
        return {"x": xs[i], "y": ys[i]}

    kw = dict(batch_size=32, shuffle=False, num_workers=2)
    jest, test = _mlps()
    hist = test.fit(StreamingDataFeed(96, load, **kw), epochs=2,
                    batch_size=32, verbose=False, prefetch=2)
    assert len(hist["loss"]) == 2 and test._py_step == 6
    want = jest.fit(JaxStreamingDataFeed(96, load, **kw), epochs=2,
                    batch_size=32, verbose=False, prefetch=2)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-4)


def test_fit_closes_the_producer_when_a_step_raises():
    """A step that raises mid-epoch leaves no prefetch thread behind."""
    x, y = make_blobs()
    _, est = _mlps()
    calls = []

    def failing(batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return torch.zeros(())

    est._train_step = failing
    with pytest.raises(RuntimeError, match="step failed"):
        est.fit((x, y), epochs=1, batch_size=16, verbose=False, prefetch=2)
    time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.name == "zoo-prefetch" and t.is_alive()]
