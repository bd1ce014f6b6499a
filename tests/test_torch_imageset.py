"""The port's ``ImageSet`` and its transform chain (``data/image.py``)
against the JAX package's on the same JPEG files: twins of
``tests/test_image.py``'s ten tests (the readers' path on the card is in
``tests/test_torch_readers_cuda.py``, which imports no JAX).

Tolerances: decoded and transformed images, ImageSet samples and feed
batches bit for bit (the same PIL and numpy calls; the random transforms
draw from the feed's per-worker generator, one worker for shuffled
augmented feeds), both decode backends, readahead on and off; the ResNet
trained from the stream, loss history 1e-5 relative against the JAX
Estimator on the JAX ImageSet's feed (a depth-18 width-8 ResNet, cut from
the JAX test's depth 50 to keep the CPU run short).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import analytics_zoo_tpu.data as jdata
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.models import ResNet as JaxResNet
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.data import (DataFeed, ImageBrightness,
                                          ImageCenterCrop, ImageColorJitter,
                                          ImageContrast, ImageNormalize,
                                          ImageRandomCrop, ImageRandomFlip,
                                          ImageResize, ImageSaturation,
                                          ImageSet)
from analytics_zoo_tpu_torch.data import image as image_mod
from analytics_zoo_tpu_torch.data import shm_pool
from analytics_zoo_tpu_torch.models import ResNet
from analytics_zoo_tpu_torch.orca.learn import Estimator

CPU = torch.device("cpu")
BACKENDS = ["thread", pytest.param("process", marks=pytest.mark.skipif(
    not shm_pool.available(), reason="shared_memory / fork unavailable"))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _host(batches):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)).copy() for k, v in b.items()}
            for b in batches]


def _jax_batches(feed):
    return _host(feed.epoch(init_orca_context("local"), 0))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def _chains():
    """The augmented chain in both packages."""
    def chain(m):
        return [m.ImageResize(36, 36), m.ImageRandomCrop(32, 32),
                m.ImageRandomFlip(), m.ImageNormalize()]
    return chain(image_mod), chain(jdata)


# -- transforms ---------------------------------------------------------------

def test_transform_chain():
    img = np.arange(40 * 40 * 3, dtype=np.uint8).reshape(40, 40, 3)
    out = ImageResize(32, 32)(img)
    assert out.shape == (32, 32, 3)
    np.testing.assert_array_equal(out, jdata.ImageResize(32, 32)(img))
    crop = ImageCenterCrop(16, 16)(out)
    assert crop.shape == (16, 16, 3)
    np.testing.assert_array_equal(crop, jdata.ImageCenterCrop(16, 16)(out))
    norm = ImageNormalize(mean=(0.5,) * 3, std=(0.5,) * 3)(crop)
    assert norm.dtype == np.float32
    assert np.all(norm >= -1.001) and np.all(norm <= 1.001)
    np.testing.assert_array_equal(
        norm, jdata.ImageNormalize(mean=(0.5,) * 3, std=(0.5,) * 3)(crop))
    flipped = ImageRandomFlip(p=1.0)(crop, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(flipped, crop[:, ::-1])
    for seed in range(4):
        got = ImageRandomCrop(8, 8)(out, rng=np.random.default_rng(seed))
        want = jdata.ImageRandomCrop(8, 8)(out,
                                           rng=np.random.default_rng(seed))
        assert got.shape == (8, 8, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="resize first"):
        ImageCenterCrop(64, 64)(out)


def test_color_jitter_transforms():
    rng = np.random.default_rng(0)
    img = rng.integers(40, 200, (16, 16, 3)).astype(np.uint8)
    pairs = [(ImageBrightness(32), jdata.ImageBrightness(32)),
             (ImageContrast(), jdata.ImageContrast()),
             (ImageSaturation(), jdata.ImageSaturation()),
             (ImageColorJitter(), jdata.ImageColorJitter())]
    for t, jt in pairs:
        out = t(img, rng=np.random.default_rng(1))
        assert out.shape == img.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out, jt(img,
                                              rng=np.random.default_rng(1)))
    con = ImageContrast(2.0, 2.0)(img, rng=np.random.default_rng(2))
    f = img.astype(np.float32)
    want = np.clip((f - f.mean((0, 1), keepdims=True)) * 2.0
                   + f.mean((0, 1), keepdims=True), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(con, want)
    gray = np.full((8, 8, 3), 100, np.uint8)
    sat = ImageSaturation(0.2, 0.2)(gray, rng=np.random.default_rng(3))
    np.testing.assert_allclose(sat, gray, atol=1)
    jit = ImageColorJitter(brightness=50, contrast=(1.9, 2.0),
                           saturation=(1.9, 2.0))(
        img, rng=np.random.default_rng(4))
    assert not np.array_equal(jit, img)


def test_decode_equals_jax(tmp_path):
    root = _write_dataset(tmp_path / "imgs", n_per_class=2)
    iset = ImageSet.read(root)
    for p in iset.paths:
        got = image_mod.decode_image(p)
        np.testing.assert_array_equal(got, jdata.image.decode_image(p))
        with open(p, "rb") as f:
            raw = f.read()
        np.testing.assert_array_equal(image_mod.decode_image_bytes(raw), got)


# -- ImageSet -----------------------------------------------------------------

def test_imageset_read(tmp_path):
    root = _write_dataset(tmp_path / "imgs")
    (tmp_path / "imgs" / "cat" / "notes.txt").write_text("not an image")
    iset = ImageSet.read(root, with_label=True)
    jset = jdata.ImageSet.read(root, with_label=True)
    assert len(iset) == 16
    assert iset.class_names == jset.class_names == ["cat", "dog"]
    assert iset.paths == jset.paths
    np.testing.assert_array_equal(iset.labels, jset.labels)
    sample = iset.transform(ImageResize(32, 32),
                            ImageNormalize()).load_sample(0)
    want = jset.transform(jdata.ImageResize(32, 32),
                          jdata.ImageNormalize()).load_sample(0)
    assert sample["x"].shape == (32, 32, 3)
    assert sample["x"].dtype == np.float32
    np.testing.assert_array_equal(sample["x"], want["x"])
    assert sample["y"] == want["y"] == 0
    flat = ImageSet.read(str(tmp_path / "imgs" / "dog"), with_label=False)
    assert flat.labels is None and len(flat) == 8


def test_imageset_sharded_read_takes_its_slice(tmp_path, monkeypatch):
    """``read(sharded=True)`` keeps process i's slice of n, as the JAX
    ImageSet does under the same process index and count."""
    from analytics_zoo_tpu_torch.data import readers
    root = _write_dataset(tmp_path / "imgs")
    monkeypatch.setattr(readers, "process_grid", lambda: (1, 3))
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    iset = ImageSet.read(root, sharded=True)
    jset = jdata.ImageSet.read(root, sharded=True)
    assert iset.paths == jset.paths and len(iset) == 5
    np.testing.assert_array_equal(iset.labels, jset.labels)


# -- streaming feed -----------------------------------------------------------

def test_streaming_feed_matches_in_ram_feed(tmp_path):
    """One worker, no shuffle: the port's in-memory feed over
    ``to_shards``, and the JAX ImageSet's stream, bit for bit."""
    root = _write_dataset(tmp_path / "imgs")
    iset = ImageSet.read(root).transform(ImageResize(16, 16),
                                         ImageNormalize())
    stream = iset.to_feed(batch_size=8, shuffle=False, num_workers=1)
    got = _host(stream.epoch(CPU, 0))
    plain = DataFeed.from_shards(iset.to_shards(num_shards=2),
                                 batch_size=8, shuffle=False)
    assert len(got) == 2
    _assert_batches_equal(got, _host(plain.epoch(CPU, 0)))
    jset = jdata.ImageSet.read(root).transform(jdata.ImageResize(16, 16),
                                               jdata.ImageNormalize())
    _assert_batches_equal(got, _jax_batches(
        jset.to_feed(batch_size=8, shuffle=False, num_workers=1)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("readahead", [0, 4])
def test_augmented_batches_equal_jax(tmp_path, backend, readahead):
    """A shuffled, randomly cropped and flipped stream: the port's batches
    equal the JAX ImageSet's for the same seed, under each decode backend,
    readahead off and on (one worker: its generator draws in step order)."""
    root = _write_dataset(tmp_path / "imgs", size=40)
    chain, jchain = _chains()
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=1,
              workers=backend, readahead=readahead)
    got = _host(ImageSet.read(root).transform(*chain).to_feed(**kw)
                .epoch(CPU, 1))
    jfeed = jdata.ImageSet.read(root).transform(*jchain).to_feed(**kw)
    want = _host(jfeed.epoch(init_orca_context("local"), 1))
    assert len(got) == 4
    _assert_batches_equal(got, want)


def test_streaming_feed_with_readahead_matches_direct_reads(tmp_path):
    from analytics_zoo_tpu_torch.core import metrics
    root = _write_dataset(tmp_path / "imgs")
    iset = ImageSet.read(root).transform(ImageResize(16, 16),
                                         ImageNormalize())
    direct = iset.to_feed(batch_size=8, shuffle=False, num_workers=1)
    got_direct = _host(direct.epoch(CPU, 0))
    metrics.get_registry().reset()
    ahead = iset.to_feed(batch_size=8, shuffle=False, num_workers=1,
                         readahead=4)
    _assert_batches_equal(_host(ahead.epoch(CPU, 0)), got_direct)
    assert iset.readahead == 0  # to_feed(readahead=) leaves iset as it was
    assert "_ra" not in iset.__dict__
    assert "feed.io_wait_ms" in metrics.get_registry().snapshot()


def test_streaming_feed_multiworker_covers_epoch(tmp_path):
    root = _write_dataset(tmp_path / "imgs")
    iset = ImageSet.read(root).transform(ImageResize(16, 16),
                                         ImageNormalize())
    stream = iset.to_feed(batch_size=8, shuffle=True, num_workers=3,
                          prefetch_batches=2)
    ys = []
    for b in stream.epoch(CPU, 0):
        assert tuple(b["x"].shape) == (8, 16, 16, 3)
        ys.extend(b["y"].tolist())
    assert len(ys) == 16       # both batches, every row exactly once
    assert sorted(ys) == [0] * 8 + [1] * 8


@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_feed_propagates_loader_error(tmp_path, backend):
    """A file that does not decode fails the epoch with PIL's error, under
    either backend, as the JAX feed's does."""
    root = _write_dataset(tmp_path / "imgs")
    bad = tmp_path / "imgs" / "dog" / "dog_3.jpg"
    bad.write_bytes(b"not a jpeg")
    iset = ImageSet.read(root).transform(ImageResize(16, 16))
    feed = iset.to_feed(batch_size=8, shuffle=False, num_workers=2,
                        workers=backend)
    from PIL import UnidentifiedImageError
    with pytest.raises(UnidentifiedImageError):
        list(feed.epoch(CPU, 0))
    jfeed = jdata.ImageSet.read(root).transform(
        jdata.ImageResize(16, 16)).to_feed(batch_size=8, shuffle=False,
                                           num_workers=2, workers=backend)
    with pytest.raises(UnidentifiedImageError):
        list(jfeed.epoch(init_orca_context("local"), 0))


def test_streaming_feed_trains_resnet_like_jax(tmp_path):
    """A ResNet trained from JPEG files through each package's ImageSet
    stream and Estimator from the same weights: the loss histories at
    1e-5; then predict through the in-memory feed."""
    root = _write_dataset(tmp_path / "imgs", n_per_class=8, size=40)
    chain, jchain = _chains()
    kw = dict(batch_size=8, shuffle=True, num_workers=1)
    fit_kw = dict(loss="sparse_categorical_crossentropy",
                  learning_rate=1e-3)
    jest = JaxEstimator.from_keras(JaxResNet(depth=18, class_num=2, width=8),
                                   **fit_kw)
    jest._ensure_initialized(jnp.zeros((8, 32, 32, 3), jnp.float32))
    port = ResNet(depth=18, class_num=2, width=8)
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(port, device="cpu", **fit_kw)
    iset = ImageSet.read(root).transform(*chain)
    hist = est.fit(iset.to_feed(**kw), epochs=2, batch_size=8,
                   verbose=False)
    want = jest.fit(jdata.ImageSet.read(root).transform(*jchain)
                    .to_feed(**kw), epochs=2, batch_size=8, verbose=False)
    assert len(hist["loss"]) == 2
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)
    sample = np.stack([iset.load_sample(i)["x"] for i in range(8)])
    assert est.predict(sample, batch_size=8).shape == (8, 2)


def test_predict_on_streaming_feed_covers_all_rows(tmp_path):
    """predict over an ImageSet stream that drops its remainder returns one
    row per image, in order."""
    root = _write_dataset(tmp_path / "imgs", n_per_class=10, size=20)
    iset = ImageSet.read(root).transform(ImageResize(8, 8),
                                         ImageNormalize())
    feed = iset.to_feed(batch_size=8, shuffle=False, num_workers=2)
    from analytics_zoo_tpu_torch import nn as tnn
    model = tnn.Sequential([tnn.Flatten(), tnn.Dense(8 * 8 * 3, 2)])
    est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                               learning_rate=1e-2, device="cpu")
    preds = est.predict(feed, batch_size=8)
    assert preds.shape == (20, 2)   # 2 full batches + 4-row remainder
    direct = est.predict(np.stack([iset.load_sample(i)["x"]
                                   for i in range(20)]), batch_size=8)
    np.testing.assert_allclose(preds, direct, rtol=1e-6)
    with pytest.raises(ValueError, match="shuffle=False"):
        est.predict(iset.to_feed(batch_size=8), batch_size=8)


def test_resnet_space_to_depth_stem_matches_conv():
    """stem='space_to_depth' computes the plain 7x7/s2 SAME stem with an
    interchangeable weight tree, in the port as in the JAX package (JAX
    weights from eval_shape's layout, drawn with numpy)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    conv_net = ResNet(depth=18, class_num=5, width=8).eval()
    s2d_net = ResNet(depth=18, class_num=5, width=8,
                     stem="space_to_depth").eval()
    s2d_net.load_state_dict(conv_net.state_dict(), strict=True)
    with torch.no_grad():
        want = conv_net(torch.from_numpy(x)).numpy()
        got = s2d_net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    jnet = JaxResNet(depth=18, class_num=5, width=8, stem="space_to_depth")
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x))
    jvars = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if s.dtype == jnp.float32 else np.zeros(s.shape, s.dtype), shapes)
    jvars["state"] = jax.tree_util.tree_map(np.abs, jvars["state"])
    s2d_net.load_state_dict(from_jax_variables(jvars), strict=True)
    jout, _ = jnet.apply(jvars, x, training=False)
    with torch.no_grad():
        got = s2d_net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jout), atol=1e-4, rtol=1e-4)
