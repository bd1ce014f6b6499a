"""The port's foreign-pipeline feeds (``data/interop.py``) against the JAX
package's: twins of ``tests/test_interop.py``'s ten tests, plus the
unknown length before a pass, ``predict``'s trim by ``num_rows``,
``fit(prefetch=)`` over a stream and the one-process seam.

Tolerances: batches and masks bit for bit; an Estimator fitted from the
same weights on the same stream, loss history 1e-5 relative; ``evaluate``
over a masked tail against the metric computed from ``predict``, 1e-5
(the JAX test's 1e-4 for the stream, its 1e-5 for the in-memory feeds).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import analytics_zoo_tpu.data as jdata
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.data import (DataFeed, IterableDataFeed,
                                          StreamingDataFeed, from_iterator,
                                          from_tf_dataset,
                                          from_torch_dataloader,
                                          from_torch_dataset)
from analytics_zoo_tpu_torch.data import interop
from analytics_zoo_tpu_torch.orca.learn import Estimator

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    yield


def _gen(n, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        x = rng.normal(size=dim).astype(np.float32)
        yield x, np.float32(x.sum())


def _host(batches):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)).copy() for k, v in b.items()}
            for b in batches]


def _jax_host(feed):
    return _host(feed.epoch(init_orca_context("local"), 0))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _dense_pair(**fit_kw):
    """A Dense(4 -> 1) estimator in each package from the JAX init."""
    jest = JaxEstimator.from_keras(jnn.Sequential([jnn.Dense(1)]),
                                   loss="mse", **fit_kw)
    jest._ensure_initialized(jnp.zeros((8, 4), jnp.float32))
    model = tnn.Sequential([tnn.Dense(4, 1)])
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    return Estimator.from_keras(model, loss="mse", device="cpu",
                                **fit_kw), jest


def test_from_iterator_rebatches_and_masks():
    feed = from_iterator(lambda e: _gen(37), batch_size=8)
    assert isinstance(feed, IterableDataFeed)
    assert feed.steps_per_epoch() == -1   # unknown before a pass
    got = _host(feed.epoch(CPU, 0))
    assert feed.num_rows == 37 and feed.steps_per_epoch() == 5
    assert len(got) == 5  # 4 full + 1 padded
    assert all(b["x"].shape == (8, 4) for b in got)
    assert "mask" not in got[0]
    np.testing.assert_array_equal(got[-1]["mask"], [1, 1, 1, 1, 1, 0, 0, 0])
    _assert_batches_equal(got, _jax_host(
        jdata.from_iterator(lambda e: _gen(37), batch_size=8)))


def test_from_iterator_drop_remainder():
    feed = from_iterator(lambda e: _gen(37), batch_size=8,
                         drop_remainder=True)
    got = _host(feed.epoch(CPU, 0))
    assert len(got) == 4
    assert all("mask" not in b for b in got)
    _assert_batches_equal(got, _jax_host(jdata.from_iterator(
        lambda e: _gen(37), batch_size=8, drop_remainder=True)))


def test_sample_forms_and_bad_tuples():
    """dicts pass through, (x,) and bare arrays are x alone; a 3-tuple is
    refused, as in the JAX package."""
    rows = [{"x": np.ones(2, np.float32), "w": np.float32(i)}
            for i in range(3)]
    got = _host(from_iterator(lambda e: iter(rows), 2).epoch(CPU, 0))
    assert sorted(got[0]) == ["w", "x"]
    bare = _host(from_iterator(lambda e: iter([np.ones(3)] * 2),
                               2).epoch(CPU, 0))
    assert sorted(bare[0]) == ["x"]
    with pytest.raises(ValueError, match=r"\(x,\) or \(x, y\)"):
        list(from_iterator(lambda e: iter([(1, 2, 3)]), 2).epoch(CPU, 0))


def test_estimator_fit_evaluate_on_iterator_feed():
    est, jest = _dense_pair(learning_rate=5e-2, metrics=["mae"])
    kw = dict(batch_size=16, drop_remainder=True)
    hist = est.fit(from_iterator(lambda e: _gen(64, seed=e), **kw),
                   epochs=3, batch_size=16, verbose=False)
    want = jest.fit(jdata.from_iterator(lambda e: _gen(64, seed=e), **kw),
                    epochs=3, batch_size=16, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)
    # evaluate over a 37-row stream: the padded, masked tail is exact
    res = est.evaluate(from_iterator(lambda e: _gen(37, seed=7),
                                     batch_size=16), batch_size=16)
    x = np.stack([s[0] for s in _gen(37, seed=7)])
    y = np.stack([s[1] for s in _gen(37, seed=7)])
    pred = est.predict(x, batch_size=16)
    assert abs(res["loss"] - float(np.square(pred[:, 0] - y).mean())) < 1e-5
    assert abs(res["mae"] - float(np.abs(pred[:, 0] - y).mean())) < 1e-5


def test_predict_and_prefetched_fit_on_iterator_feed():
    """predict over a stream returns num_rows rows in order; fit with a
    prefetch thread over a stream with a masked tail skips that batch."""
    est, _ = _dense_pair(learning_rate=5e-2)
    feed = from_iterator(lambda e: _gen(37, seed=3), batch_size=16)
    x = np.stack([s[0] for s in _gen(37, seed=3)])
    np.testing.assert_allclose(est.predict(feed, batch_size=16),
                               est.predict(x, batch_size=16), rtol=1e-6)
    steps = []
    inner = est._train_step
    est._train_step = lambda b: steps.append(1) or inner(b)
    est.fit(feed, epochs=2, batch_size=16, prefetch=2, verbose=False)
    assert len(steps) == 4  # 2 full batches an epoch; the masked one skipped


def test_evaluate_covers_tail_of_drop_remainder_feed():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    y = rng.normal(size=(10, 1)).astype(np.float32)
    est, _ = _dense_pair()
    est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    feed = DataFeed.from_arrays(x, y, batch_size=8, shuffle=False,
                                drop_remainder=True)
    res = est.evaluate(feed, batch_size=8)
    pred = est.predict(x, batch_size=8)
    assert abs(res["loss"] - float(np.square(pred - y).mean())) < 1e-5


def test_evaluate_shuffled_nondrop_feed_is_exact():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    y = rng.normal(size=(10, 1)).astype(np.float32)
    est, _ = _dense_pair()
    est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    feed = DataFeed.from_arrays(x, y, batch_size=8, shuffle=True,
                                drop_remainder=False)
    res = est.evaluate(feed, batch_size=8)
    pred = est.predict(x, batch_size=8)
    assert abs(res["loss"] - float(np.square(pred - y).mean())) < 1e-5


def test_evaluate_empty_iterable_feed_raises():
    est, _ = _dense_pair()
    with pytest.raises(ValueError, match="no batches"):
        est.evaluate(from_iterator(lambda e: iter([]), 32), batch_size=32)


def test_several_processes_wait_for_item_7(monkeypatch):
    monkeypatch.setattr(interop, "process_grid", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        list(from_iterator(lambda e: _gen(4), 2).epoch(CPU, 0))


class _DS(torch.utils.data.Dataset):
    def __len__(self):
        return 48

    def __getitem__(self, i):
        return torch.full((4,), float(i)), torch.tensor(float(i))


def test_from_torch_dataset_streaming():
    feed = from_torch_dataset(_DS(), batch_size=8, shuffle=False,
                              num_workers=2)
    assert isinstance(feed, StreamingDataFeed)
    got = _host(feed.epoch(CPU, 0))
    assert len(got) == 6
    np.testing.assert_array_equal(got[0]["x"][:, 0],
                                  np.arange(8, dtype=np.float32))
    _assert_batches_equal(got, _jax_host(jdata.from_torch_dataset(
        _DS(), batch_size=8, shuffle=False, num_workers=2)))
    # an iterable-style dataset rides IterableDataFeed
    it = from_torch_dataset(iter([(np.ones(2), np.float32(1))] * 3), 2)
    assert isinstance(it, IterableDataFeed)


def test_from_torch_dataloader_rebatch():
    xs = torch.arange(20, dtype=torch.float32).reshape(20, 1)
    ys = torch.arange(20, dtype=torch.float32)
    loader = torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(xs, ys), batch_size=6)
    feed = from_torch_dataloader(loader, batch_size=8)
    got = _host(feed.epoch(CPU, 0))
    assert feed.num_rows == 20
    assert [b["x"].shape[0] for b in got] == [8, 8, 8]
    assert "mask" in got[-1]
    flat = np.concatenate([b["x"][:, 0] for b in got])
    np.testing.assert_array_equal(flat[:20], np.arange(20, dtype=np.float32))
    _assert_batches_equal(got, _jax_host(
        jdata.from_torch_dataloader(loader, batch_size=8)))
    assert from_torch_dataloader(loader)._local_batch == 6


def test_from_tf_dataset_gated():
    tf = pytest.importorskip("tensorflow")
    ds = tf.data.Dataset.from_tensor_slices(
        (np.ones((10, 3), np.float32), np.zeros(10, np.float32)))
    feed = from_tf_dataset(ds, batch_size=4)
    got = _host(feed.epoch(CPU, 0))
    assert feed.num_rows == 10 and len(got) == 3


def test_from_tf_dataset_missing_tf_raises():
    import sys
    if "tensorflow" in sys.modules:
        pytest.skip("tensorflow available; error path not reachable")
    with pytest.raises(ImportError, match="tensorflow"):
        from_tf_dataset(object(), batch_size=4)
