"""The port's streaming input pipeline on the CPU, against the JAX package:
twins of ``tests/test_stream_shm.py``'s ``TestShmPool``,
``TestProcessBackend`` and ``TestTailThroughWorkerPool`` and of
``tests/test_image.py``'s six streaming-feed tests.  The image twins load
through the JAX package's ``ImageSet`` (numpy and PIL only), so that both
feeds decode the same files with the same loader; every batch of the
port's feed is held against the JAX feed's.

Tolerances: batches exactly (the same loader, the same step order);
the ResNet trained from the stream, loss history 1e-4 relative against
the JAX Estimator on the JAX feed (a depth-18 width-8 ResNet, cut from the
JAX test's depth 50 to keep the CPU run short; batch-norm training at 32 x
32 amplifies f32 summation-order differences, as
``tests/test_torch_image.py`` states).

Every test here has a time limit of its own (``_time_limit``): a wedged
worker process or queue fails its test instead of the run.
"""

import glob
import os
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.data import (DataFeed as JaxDataFeed, ImageNormalize,
                                    ImageRandomCrop, ImageRandomFlip,
                                    ImageResize, ImageSet)
from analytics_zoo_tpu.data import StreamingDataFeed as JaxStreamingDataFeed
from analytics_zoo_tpu.models import ResNet as JaxResNet
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import metrics
from analytics_zoo_tpu_torch.data import (ShmBatchPool, SlotBatch,
                                          StreamingDataFeed)
from analytics_zoo_tpu_torch.data import shm_pool
from analytics_zoo_tpu_torch.models import ResNet
from analytics_zoo_tpu_torch.orca.learn import Estimator

CPU = torch.device("cpu")
TIME_LIMIT_S = 60

needs_process = pytest.mark.skipif(
    not shm_pool.available(),
    reason="multiprocessing.shared_memory / fork unavailable")


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail a test that runs past TIME_LIMIT_S (SIGALRM on the test's
    thread) instead of letting it hold the run."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TIME_LIMIT_S} s")

    if threading.current_thread() is not threading.main_thread():
        yield  # signals reach the main thread only
        return
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shm_leaks():
    """This process's live pool segments."""
    return glob.glob(f"/dev/shm/{shm_pool.SHM_PREFIX}_{os.getpid()}_*")


def _det_load(i, rng=None):
    """Deterministic from the index (what a decode is), rng-free."""
    r = np.random.default_rng(i)
    return {"x": r.normal(size=(3,)).astype(np.float32),
            "y": np.int32(i % 5)}


def _host(batches):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)).copy() for k, v in b.items()}
            for b in batches]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _jax_batches(feed, **kw):
    mesh = init_orca_context("local")
    return _host(feed.epoch(mesh, 0, **kw))


# -- pool lifecycle (TestShmPool) ---------------------------------------------

class TestShmPool:
    def test_roundtrip_and_views_shared(self):
        pool = ShmBatchPool(2, 4, {"x": ((3,), np.float32),
                                   "y": ((), np.int32)})
        try:
            s = pool.acquire(timeout=1)
            v = pool.views(s)
            v["x"][:] = 7.0
            v["y"][:] = np.arange(4)
            again = pool.views(s)
            np.testing.assert_array_equal(again["x"], np.full((4, 3), 7.0))
            np.testing.assert_array_equal(again["y"], np.arange(4))
            pool.release(s)
            assert pool.acquire(timeout=1) is not None
        finally:
            pool.close()

    def test_acquire_blocks_at_capacity(self):
        pool = ShmBatchPool(2, 2, {"x": ((2,), np.float32)})
        try:
            a = pool.acquire(timeout=1)
            b = pool.acquire(timeout=1)
            assert a is not None and b is not None
            assert pool.acquire(timeout=0.1) is None  # the memory bound
            pool.release(a)
            assert pool.acquire(timeout=1) == a
        finally:
            pool.close()

    def test_close_unlinks_every_segment(self):
        assert not _shm_leaks()
        pool = ShmBatchPool(3, 4, {"x": ((8,), np.uint8)})
        assert len(_shm_leaks()) == 3
        pool.close()
        assert not _shm_leaks()
        pool.close()  # idempotent

    def test_slot_batch_release_idempotent_and_on_gc(self):
        pool = ShmBatchPool(2, 2, {"x": ((2,), np.float32)})
        try:
            s = pool.acquire(timeout=1)
            sb = SlotBatch(pool.views(s), s, pool)
            sb.release()
            sb.release()  # idempotent: slot must not enter the pool twice
            assert pool.acquire(timeout=1) is not None
            assert pool.acquire(timeout=1) is not None
            assert pool.acquire(timeout=0.1) is None
            pool2 = ShmBatchPool(2, 2, {"x": ((2,), np.float32)})
            try:
                s2 = pool2.acquire(timeout=1)
                SlotBatch(pool2.views(s2), s2, pool2)  # dropped at once
                assert pool2.acquire(timeout=1) is not None
            finally:
                pool2.close()
        finally:
            pool.close()


# -- process backend (TestProcessBackend) --------------------------------------

@needs_process
class TestProcessBackend:
    def test_bitwise_identical_to_thread_backend_and_to_jax(self):
        kw = dict(batch_size=4, shuffle=True, seed=11, num_workers=2)
        ft = StreamingDataFeed(24, _det_load, workers="thread", **kw)
        fp = StreamingDataFeed(24, _det_load, workers="process", **kw)
        bt, bp = _host(ft.epoch(CPU, 0)), _host(fp.epoch(CPU, 0))
        assert len(bp) == 6
        _assert_batches_equal(bp, bt)
        _assert_batches_equal(bp, _jax_batches(
            JaxStreamingDataFeed(24, _det_load, workers="process", **kw)))
        assert not _shm_leaks()

    def test_step_order_survives_straggler_decodes(self):
        def slow_early(i, rng=None):
            if i < 4:
                time.sleep(0.05)  # the first batch decodes last
            return {"x": np.full((2,), float(i), np.float32)}

        feed = StreamingDataFeed(16, slow_early, batch_size=4,
                                 shuffle=False, num_workers=3,
                                 workers="process")
        rows = [b["x"].numpy()[:, 0] for b in feed.epoch(CPU, 0)]
        flat = [float(v) for batch in rows for v in batch]
        assert flat == [float(i) for i in range(16)]  # strict step order

    def test_worker_crash_mid_write_releases_slot(self):
        main_pid = os.getpid()

        def killer(i, rng=None):
            if i == 6 and os.getpid() != main_pid:
                os._exit(3)  # hard death while its slot is checked out
            return {"x": np.full((2,), float(i), np.float32)}

        feed = StreamingDataFeed(32, killer, batch_size=4, shuffle=False,
                                 num_workers=2, workers="process")
        with pytest.raises(RuntimeError, match="died"):
            list(feed.epoch(CPU, 0))
        assert not _shm_leaks()

    def test_abandoned_epoch_unlinks_segments(self):
        feed = StreamingDataFeed(64, _det_load, batch_size=4,
                                 shuffle=False, num_workers=2,
                                 workers="process")
        it = feed.epoch(CPU, 0)
        next(it)
        assert _shm_leaks()    # the pool is live mid-epoch
        it.close()
        assert not _shm_leaks()

    def test_thread_fallback_when_shm_unavailable(self, monkeypatch):
        monkeypatch.setattr(shm_pool, "available", lambda: False)
        feed = StreamingDataFeed(8, _det_load, batch_size=4,
                                 shuffle=False, workers="process")
        assert feed.workers == "thread"
        assert len(list(feed.epoch(CPU, 0))) == 2

    def test_invalid_backend_rejected(self):
        with pytest.raises(ValueError, match="workers"):
            StreamingDataFeed(8, _det_load, batch_size=4, workers="actor")

    def test_host_batches_are_slot_views_and_release(self):
        feed = StreamingDataFeed(16, _det_load, batch_size=4,
                                 shuffle=False, num_workers=2,
                                 workers="process")
        seen = []
        for b in feed.epoch(CPU, 0, place=False):
            assert isinstance(b, SlotBatch)
            seen.append({k: np.asarray(v).copy() for k, v in b.items()})
            b.release()
        assert len(seen) == 4
        np.testing.assert_array_equal(seen[0]["x"][0], _det_load(0)["x"])
        assert not _shm_leaks()

    def test_multi_epoch_reuse_and_counter_sync(self):
        def corrupt(i, rng=None):
            if i == 2:
                raise OSError("bad sample")
            return {"x": np.full((2,), float(i), np.float32)}

        metrics.get_registry().reset()
        feed = StreamingDataFeed(8, corrupt, batch_size=4, shuffle=False,
                                 num_workers=2, on_error="skip",
                                 workers="process")
        first = _host(feed.epoch(CPU, 0))
        assert feed.skipped_rows == 1
        list(feed.epoch(CPU, 1))
        assert feed.skipped_rows == 2  # counters accumulate across epochs
        assert metrics.get_registry().snapshot()["feed.skipped_rows"] == 2
        # the substitute is the next loadable sample, as in JAX
        np.testing.assert_array_equal(first[0]["x"][:, 0], [0, 1, 3, 3])
        assert not _shm_leaks()


# -- pooled tail loading (TestTailThroughWorkerPool) --------------------------

class TestTailThroughWorkerPool:
    def test_remainder_values_and_parallelism(self):
        calls = []

        def load(i, rng=None):
            calls.append(i)
            return {"x": np.full((2,), float(i), np.float32)}

        feed = StreamingDataFeed(10, load, batch_size=4, shuffle=False,
                                 num_workers=4)
        rem = feed.remainder()
        np.testing.assert_array_equal(rem["x"][:, 0], [8.0, 9.0])
        assert sorted(calls) == [8, 9]

    def test_dropped_rows_match_epoch_permutation(self):
        feed = StreamingDataFeed(10, _det_load, batch_size=4, shuffle=True,
                                 seed=3, num_workers=4)
        jfeed = JaxStreamingDataFeed(10, _det_load, batch_size=4,
                                     shuffle=True, seed=3, num_workers=4)
        sel = feed.epoch_index(0)[8:]
        np.testing.assert_array_equal(sel, jfeed._epoch_index(0)[8:])
        dropped = feed.dropped_rows(0)
        for k, i in enumerate(sel):
            np.testing.assert_array_equal(dropped["x"][k],
                                          _det_load(int(i))["x"])


# -- image streaming (tests/test_image.py) ------------------------------------

def _write_dataset(root, n_per_class=8, size=48, classes=("cat", "dog")):
    from PIL import Image
    rng = np.random.default_rng(0)
    for c in classes:
        d = root / c
        d.mkdir(parents=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{c}_{i}.jpg")
    return str(root)


def _port_feed(jax_feed, **kw):
    """The port's feed over the JAX feed's loader (an ImageSet's bound
    ``load_sample``: its readahead and io-wait protocols come along)."""
    return StreamingDataFeed(jax_feed.num_rows, jax_feed._load, **kw)


def test_streaming_feed_matches_in_ram_feed(tmp_path):
    """One worker, no shuffle: the in-memory feed's batches, bit for bit,
    and the JAX stream's."""
    root = _write_dataset(tmp_path / "imgs")
    iset = ImageSet.read(root).transform(ImageResize(16, 16),
                                         ImageNormalize())
    jfeed = iset.to_feed(batch_size=8, shuffle=False, num_workers=1)
    stream = _port_feed(jfeed, batch_size=8, shuffle=False, num_workers=1)
    got = _host(stream.epoch(CPU, 0))
    plain = JaxDataFeed.from_shards(iset.to_shards(num_shards=2),
                                    batch_size=8, shuffle=False)
    want = _jax_batches(plain)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["x"], w["x"], rtol=1e-6)
        np.testing.assert_array_equal(g["y"], w["y"])
    _assert_batches_equal(got, _jax_batches(jfeed))


def test_streaming_feed_with_readahead_matches_direct_reads(tmp_path):
    """The loader's readahead path decodes the direct path's batches, and
    the feed surfaces its io wait through ``feed.io_wait_ms``."""
    root = _write_dataset(tmp_path / "imgs")
    iset = ImageSet.read(root).transform(ImageResize(16, 16),
                                         ImageNormalize())
    direct = _port_feed(iset.to_feed(batch_size=8), batch_size=8,
                        shuffle=False, num_workers=1)
    got_direct = [b["x"].numpy() for b in direct.epoch(CPU, 0)]
    metrics.get_registry().reset()
    ahead = _port_feed(iset.to_feed(batch_size=8, readahead=4),
                       batch_size=8, shuffle=False, num_workers=1)
    got_ahead = [b["x"].numpy() for b in ahead.epoch(CPU, 0)]
    for a, b in zip(got_direct, got_ahead):
        np.testing.assert_array_equal(a, b)
    assert iset.readahead == 0
    assert "feed.io_wait_ms" in metrics.get_registry().snapshot()


def test_streaming_feed_multiworker_covers_epoch(tmp_path):
    root = _write_dataset(tmp_path / "imgs")
    iset = ImageSet.read(root).transform(ImageResize(16, 16),
                                         ImageNormalize())
    stream = _port_feed(iset.to_feed(batch_size=8), batch_size=8,
                        shuffle=True, num_workers=3, prefetch_batches=2)
    ys = []
    for b in stream.epoch(CPU, 0):
        assert tuple(b["x"].shape) == (8, 16, 16, 3)
        ys.extend(b["y"].tolist())
    assert len(ys) == 16       # both batches, every row exactly once
    assert sorted(ys) == [0] * 8 + [1] * 8


def test_streaming_feed_propagates_loader_error():
    def bad_loader(i, rng=None):
        if i == 3:
            raise ValueError("corrupt sample")
        return {"x": np.zeros((4,), np.float32)}

    feed = StreamingDataFeed(num_samples=16, load_sample=bad_loader,
                             batch_size=8, shuffle=False, num_workers=2)
    with pytest.raises(ValueError, match="corrupt sample"):
        list(feed.epoch(CPU, 0))


def test_streaming_feed_trains_resnet_like_jax(tmp_path):
    """A ResNet trained from JPEG files through the streaming pipeline and
    the Estimator in both packages (one worker: the augmentation's draws
    follow the step order), then predict through the in-memory feed."""
    root = _write_dataset(tmp_path / "imgs", n_per_class=8, size=40)
    iset = ImageSet.read(root).transform(
        ImageResize(36, 36), ImageRandomCrop(32, 32), ImageRandomFlip(),
        ImageNormalize())
    kw = dict(batch_size=8, shuffle=True, num_workers=1)
    jfeed = iset.to_feed(**kw)
    fit_kw = dict(loss="sparse_categorical_crossentropy",
                  learning_rate=1e-3)
    jest = JaxEstimator.from_keras(JaxResNet(depth=18, class_num=2, width=8),
                                   **fit_kw)
    jest._ensure_initialized(jnp.zeros((8, 32, 32, 3), jnp.float32))
    port = ResNet(depth=18, class_num=2, width=8)
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(port, device="cpu", **fit_kw)
    hist = est.fit(_port_feed(jfeed, **kw), epochs=2, batch_size=8,
                   verbose=False)
    want = jest.fit(jfeed, epochs=2, batch_size=8, verbose=False)
    assert len(hist["loss"]) == 2
    assert all(np.isfinite(v) for v in hist["loss"])
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-4)
    sample = np.stack([iset.load_sample(i)["x"] for i in range(8)])
    assert est.predict(sample, batch_size=8).shape == (8, 2)


def test_predict_on_streaming_feed_covers_all_rows():
    """predict returns one row per input even when the feed drops the
    epoch's remainder."""
    def loader(i, rng=None):
        return {"x": np.full((4,), float(i), np.float32),
                "y": np.int32(i % 2)}

    feed = StreamingDataFeed(num_samples=20, load_sample=loader,
                             batch_size=8, shuffle=False, num_workers=2)
    est = Estimator.from_keras(tnn.Dense(4, 2),
                               loss="sparse_categorical_crossentropy",
                               learning_rate=1e-2, device="cpu")
    est.fit(feed, epochs=1, batch_size=8, verbose=False)
    preds = est.predict(feed, batch_size=8)
    assert preds.shape == (20, 2)   # 2 full batches + 4-row remainder
    with torch.no_grad():
        want = est.model.eval()(torch.arange(20, dtype=torch.float32)[
            :, None].repeat(1, 4))
    np.testing.assert_allclose(preds, want.numpy(), rtol=1e-6)
