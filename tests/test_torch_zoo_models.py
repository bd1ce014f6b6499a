"""The port's TextClassifier, KNRM and AnomalyDetector against the JAX
package's: twins of ``tests/test_models.py``'s
``test_text_classifier_all_encoders``, ``test_knrm_ranking`` and
``test_anomaly_detector_pipeline``, each held to the JAX model at the same
weights, and the ties where JAX's gradient rules are not PyTorch's
defaults (``jnp.max`` over time, ``jnp.clip``'s maximum in KNRM).

Tolerances: outputs and gradients within 1e-5 of the reference tensor's
largest magnitude (TextClassifier, KNRM, AnomalyDetector; the JAX
models' initial weights); fit losses 1e-5 relative from those weights
(AnomalyDetector, dropout 0 as the JAX test has it); ``unroll`` and
``detect_anomalies`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import analytics_zoo_tpu.models as jmodels
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.models import (KNRM, AnomalyDetector,
                                            TextClassifier, unroll)
from analytics_zoo_tpu_torch.orca.learn import Estimator


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _within(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1e-12), (what, err)


def _twins(jcls, pcls, x, **kw):
    """The model in both packages at the JAX init's weights."""
    jm = jcls(**kw)
    variables = jm.init(jax.random.PRNGKey(0), x)
    pm = pcls(**kw)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return pm, jm, variables


def _grads_equal(pm, jm, variables, x, loss_of):
    """d loss / d params of both packages at the same weights;
    ``loss_of(out, xp)`` over the model output in either package's
    array type (xp: jnp or torch)."""
    def jax_loss(params):
        out, _ = jm.apply({"params": params,
                           "state": variables.get("state", {})},
                          jnp.asarray(x), training=False)
        return loss_of(out, jnp)

    want = from_jax_variables({"params": jax.grad(jax_loss)(
        variables["params"])})
    pm.eval()
    loss_of(pm(torch.from_numpy(x)), torch).backward()
    for name, p in pm.named_parameters():
        _within(p.grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("enc", ["cnn", "lstm", "gru"])
def test_text_classifier_all_encoders(enc):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (32, 20)).astype(np.int32)
    kw = dict(class_num=3, vocab_size=100, token_length=16,
              sequence_length=20, encoder=enc, encoder_output_dim=16)
    pm, jm, variables = _twins(jmodels.TextClassifier, TextClassifier,
                               x, **kw)
    want, _ = jm.apply(variables, x, training=False)
    with torch.no_grad():
        _within(pm.eval()(torch.from_numpy(x)).numpy(), want, enc)
    _grads_equal(pm, jm, variables, x, lambda o, xp: (o ** 2).sum())
    pm.compile(loss="sparse_categorical_crossentropy", learning_rate=0.01,
               device="cpu")
    y = rng.integers(0, 3, 32).astype(np.int32)
    hist = pm.fit((x, y), epochs=1, batch_size=16, verbose=False)
    assert np.isfinite(hist["loss"][0])
    assert pm.predict_classes(x).shape == (32,)


def test_text_classifier_max_pool_splits_ties():
    """Tied maxima over time share the gradient evenly, as jnp.max's: a
    sequence of one repeated token gives every step the same conv output
    away from the edges."""
    x = np.full((2, 12), 7, np.int32)
    kw = dict(class_num=2, vocab_size=10, token_length=8,
              sequence_length=12, encoder="cnn", encoder_output_dim=6)
    pm, jm, variables = _twins(jmodels.TextClassifier, TextClassifier,
                               x, **kw)
    _grads_equal(pm, jm, variables, x, lambda o, xp: (o ** 2).sum())


@pytest.mark.parametrize("mode", ["ranking", "classification"])
def test_knrm_outputs_and_gradients(mode):
    rng = np.random.default_rng(1)
    kw = dict(text1_length=5, text2_length=10, vocab_size=50, embed_size=16,
              kernel_num=11, target_mode=mode)
    x = rng.integers(0, 50, (16, 15)).astype(np.int32)
    x[:4, 5:10] = x[:4, :5]  # exact matches: the sharp kernel fires
    pm, jm, variables = _twins(jmodels.KNRM, KNRM, x, **kw)
    want, _ = jm.apply(variables, x, training=False)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (16, 2 if mode == "classification" else 1)
    _within(got, want, mode)
    _grads_equal(pm, jm, variables, x, lambda o, xp: (o ** 2).sum())


def test_knrm_clip_floor_tie_takes_half_the_gradient():
    """Where a kernel's pooled sum equals the 1e-10 floor exactly, JAX's
    clip (a maximum) passes half the gradient, and so does the port."""
    from analytics_zoo_tpu.models import textmatching as jtm
    s = np.asarray([1e-10, 2.0, 1e-12], np.float32)
    g_jax = jax.grad(lambda v: jnp.log(jnp.clip(v, 1e-10)).sum())(
        jnp.asarray(s))
    t = torch.tensor(s, requires_grad=True)
    torch.log(torch.maximum(t, torch.full_like(t, 1e-10))).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_jax),
                               rtol=1e-6)
    assert "jnp.clip(k.sum(axis=2), 1e-10)" in open(jtm.__file__).read()


def test_knrm_fits_like_jax():
    rng = np.random.default_rng(2)
    kw = dict(text1_length=5, text2_length=10, vocab_size=50, embed_size=16,
              kernel_num=11)
    x = rng.integers(0, 50, (64, 15)).astype(np.int32)
    y = np.array([1.0 if len(set(r[:5]) & set(r[5:])) else 0.0 for r in x],
                 np.float32)[:, None]
    fit_kw = dict(loss="binary_crossentropy", learning_rate=0.01)
    jest = JaxEstimator.from_keras(jmodels.KNRM(**kw), **fit_kw)
    jest._ensure_initialized(jnp.asarray(x[:32]))
    pm = KNRM(**kw)
    pm.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(pm, device="cpu", **fit_kw)
    hist = est.fit((x, y), epochs=3, batch_size=32, verbose=False)
    want = jest.fit((x, y), epochs=3, batch_size=32, verbose=False)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)


def test_anomaly_detector_pipeline():
    rng = np.random.default_rng(3)
    t = np.arange(300, dtype=np.float32)
    series = np.sin(t / 10) + 0.05 * rng.normal(size=300)
    series[250] += 5.0  # an injected anomaly
    x, y = unroll(series, unroll_length=10)
    jx, jy = jmodels.unroll(series, unroll_length=10)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape == (290, 10, 1) and y.shape == (290,)
    with pytest.raises(ValueError, match="shorter"):
        unroll(series[:5], unroll_length=10)
    kw = dict(feature_shape=(10, 1), hidden_layers=(8, 8),
              dropouts=(0.0, 0.0))
    fit_kw = dict(loss="mse", learning_rate=0.01)
    jm = jmodels.AnomalyDetector(**kw)
    jm.compile(**fit_kw)
    jest = jm.estimator
    jest._ensure_initialized(jnp.asarray(x[:64]))
    pm = AnomalyDetector(**kw)
    pm.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    want_out, _ = jm.apply(jest.get_model(), x[:64], training=False)
    with torch.no_grad():
        _within(pm.eval()(torch.from_numpy(x[:64])).numpy(), want_out)
    pm.compile(device="cpu", **fit_kw)
    hist = pm.fit((x, y[:, None]), epochs=3, batch_size=64, verbose=False)
    want = jm.fit((x, y[:, None]), epochs=3, batch_size=64, verbose=False)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)
    pred = pm.predict(x)
    anomalies = pm.detect_anomalies(y, pred, anomaly_fraction=0.01)
    np.testing.assert_array_equal(
        anomalies, jm.detect_anomalies(y, pred, anomaly_fraction=0.01))
    # the injected spike (unrolled index 240 = point 250) is flagged
    assert any(235 <= a <= 245 for a in anomalies)
