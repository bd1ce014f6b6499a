"""The port's NNFrames (``nnframes/``) against the JAX package's: twins of
``tests/test_nnframes.py``'s five tests.  Each fit starts both packages
from the same weights (the JAX estimator's own init: ``PRNGKey(seed)`` on
the first batch, loaded into the port's model), on the same frames.

Tolerances: the ``transform`` column equal to the port's
``Estimator.predict`` on the same features, bit for bit; the two
packages' transform columns within 1e-5 of the column's largest
magnitude (at least 1; regression) or equal classes (classifier); the
image frames of ``NNImageReader`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.data import XShards as JaxXShards
from analytics_zoo_tpu.nnframes import NNClassifier as JaxNNClassifier
from analytics_zoo_tpu.nnframes import NNEstimator as JaxNNEstimator
from analytics_zoo_tpu.nnframes import NNImageReader as JaxNNImageReader
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.data import (ImageNormalize, ImageResize,
                                          XShards)
from analytics_zoo_tpu_torch.nnframes import (NNClassifier,
                                              NNClassifierModel,
                                              NNEstimator, NNImageReader,
                                              NNModel)

pd = pytest.importorskip("pandas")


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlps(in_dim, out_dim, x):
    """The same MLP in both packages, the port's holding the weights the
    JAX estimator's init gives on ``x``."""
    jm = jnn.Sequential([jnn.Dense(16, activation="relu"),
                         jnn.Dense(out_dim)])
    variables = jm.init(jax.random.PRNGKey(0), np.asarray(x, np.float32),
                        training=True)
    pm = tnn.Sequential([tnn.Dense(in_dim, 16, activation="relu"),
                         tnn.Dense(16, out_dim)])
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return pm, jm


def _column(df, col="prediction"):
    return np.asarray(df[col].tolist())


def _close(got, want):
    """Within 1e-5 of the reference column's largest magnitude."""
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1.0), err


def test_nnestimator_fit_transform_regression():
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"f1": rng.normal(size=80), "f2": rng.normal(size=80),
                       "label": rng.normal(size=80)})
    x = df[["f1", "f2"]].to_numpy(np.float32)
    pm, jm = _mlps(2, 1, x[:16])
    models = []
    for cls, m, kw in ((NNEstimator, pm, {"device": "cpu"}),
                       (JaxNNEstimator, jm, {})):
        est = (cls(m, criterion="mse", **kw)
               .setFeaturesCol("f1", "f2").setLabelCol("label")
               .setBatchSize(16).setMaxEpoch(2).setLearningRate(1e-2))
        models.append(est.fit(df))
    model, jmodel = models
    assert isinstance(model, NNModel)
    out = model.transform(df)
    assert "prediction" in out.columns and len(out) == len(df)
    assert "prediction" not in df.columns  # transform copies
    got = _column(out)
    assert got.shape == (80, 1)
    np.testing.assert_array_equal(got, model.estimator.predict(
        x, batch_size=16))
    _close(got, _column(jmodel.transform(df)))


def test_nnclassifier_argmax_and_array_features():
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=4).astype(np.float32) for _ in range(60)]
    labels = [int(f.sum() > 0) for f in feats]
    df = pd.DataFrame({"features": feats, "label": labels})
    pm, jm = _mlps(4, 2, np.stack(feats[:16]))
    clf = (NNClassifier(pm, device="cpu")
           .setBatchSize(16).setMaxEpoch(8).setLearningRate(5e-2))
    model = clf.fit(df)
    assert isinstance(model, NNClassifierModel)
    out = model.setPredictionCol("cls").transform(df)
    preds = _column(out, "cls")
    assert preds.dtype.kind == "i"
    assert (preds == np.asarray(labels)).mean() > 0.7
    logits = model.estimator.predict(np.stack(feats), batch_size=16)
    np.testing.assert_array_equal(preds, np.argmax(logits, axis=-1))
    jmodel = (JaxNNClassifier(jm).setBatchSize(16).setMaxEpoch(8)
              .setLearningRate(5e-2)).fit(df)
    np.testing.assert_array_equal(
        preds, _column(jmodel.setPredictionCol("cls").transform(df), "cls"))


def test_nnmodel_transform_xshards():
    rng = np.random.default_rng(2)
    frames = [pd.DataFrame({"a": rng.normal(size=20),
                            "label": rng.normal(size=20)})
              for _ in range(3)]
    pm, jm = _mlps(1, 1, frames[0][["a"]].to_numpy()[:10])
    outs = []
    for cls, shards, m, kw in (
            (NNEstimator, XShards(frames), pm, {"device": "cpu"}),
            (JaxNNEstimator, JaxXShards(frames), jm, {})):
        model = (cls(m, criterion="mse", **kw).setFeaturesCol("a")
                 .setBatchSize(10).setMaxEpoch(1)).fit(shards)
        outs.append(model.transform(shards).collect())
    frames_out, jframes = outs
    assert len(frames_out) == 3
    for f, j in zip(frames_out, jframes):
        assert "prediction" in f.columns and len(f) == 20
        _close(_column(f), _column(j))


def test_preprocessing_hook():
    df = pd.DataFrame({"features": ["1,2", "3,4", "5,6", "2,1"] * 8,
                       "label": [0.5, 1.2, 1.8, 0.6] * 8})

    def parse(s):
        return np.asarray(s.split(","), np.float32)

    pm, jm = _mlps(2, 1, np.stack([parse(s) for s in df["features"][:8]]))
    model = (NNEstimator(pm, criterion="mse", feature_preprocessing=parse,
                         device="cpu").setBatchSize(8).setMaxEpoch(1)
             .fit(df))
    jmodel = (JaxNNEstimator(jm, criterion="mse",
                             feature_preprocessing=parse)
              .setBatchSize(8).setMaxEpoch(1).fit(df))
    out = model.transform(df)
    assert len(out) == 32
    _close(_column(out), _column(jmodel.transform(df)))
    with pytest.raises(ValueError, match="label column"):
        NNEstimator(pm, device="cpu").setFeaturesCol("features").fit(
            df.drop(columns=["label"]).assign(features=df["features"]
                                              .map(parse)))


def test_nnimage_reader_to_classifier(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    import analytics_zoo_tpu.data as jdata
    rng = np.random.default_rng(3)
    for c, base in (("cat", 40), ("dog", 200)):
        d = tmp_path / c
        d.mkdir()
        for i in range(6):
            arr = np.clip(rng.normal(base, 30, (24, 24, 3)), 0,
                          255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i}.jpg")
    df = NNImageReader.readImages(
        str(tmp_path), transforms=[ImageResize(16, 16),
                                   ImageNormalize((0.5,) * 3, (0.5,) * 3)])
    jdf = JaxNNImageReader.readImages(
        str(tmp_path), transforms=[jdata.ImageResize(16, 16),
                                   jdata.ImageNormalize((0.5,) * 3,
                                                        (0.5,) * 3)])
    assert set(df.columns) >= {"image", "origin", "label", "height"}
    assert len(df) == 12 and df["image"].iloc[0].shape == (16, 16, 3)
    pd.testing.assert_frame_equal(df.drop(columns=["image"]),
                                  jdf.drop(columns=["image"]))
    for a, b in zip(df["image"], jdf["image"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    model = tnn.Sequential([tnn.Flatten(),
                            tnn.Dense(16 * 16 * 3, 8, activation="relu"),
                            tnn.Dense(8, 2)])
    clf = (NNClassifier(model, device="cpu").setFeaturesCol("image")
           .setBatchSize(4).setMaxEpoch(10).setLearningRate(1e-2))
    nnmodel = clf.fit(df)
    out = nnmodel.transform(df)
    acc = (_column(out) == df["label"].to_numpy()).mean()
    assert acc > 0.7
    logits = nnmodel.estimator.predict(np.stack(df["image"].tolist()),
                                       batch_size=4)
    np.testing.assert_array_equal(_column(out), np.argmax(logits, -1))
