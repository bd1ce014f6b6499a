"""The port's ``TextSet`` (``data/text.py``), ``WordEmbedding``
(``nn/layers_zoo.py``) and ``TextClassifier`` against the JAX package's:
twins of ``tests/test_text.py``'s six tests, of the WordEmbedding tests of
``tests/test_layers_zoo.py`` and of
``tests/test_models.py::test_text_classifier_pretrained_embeddings_frozen``.

Tolerances: word indexes, ids and GloVe tables bit for bit; TextClassifier
outputs and fit losses 1e-5 relative, from the JAX Estimator's initial
weights, with the classifier's fixed ``Dropout(0.2)`` set to 0 on both
sides inside the test (the JAX layer's rate patched in memory by
``monkeypatch``); saved models loaded by the other package, predictions
1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.data import TextSet as JaxTextSet
from analytics_zoo_tpu.models import TextClassifier as JaxTextClassifier
from analytics_zoo_tpu.models import ZooModel as JaxZooModel
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.data import DataFeed, TextSet
from analytics_zoo_tpu_torch.models import TextClassifier, ZooModel
from analytics_zoo_tpu_torch.nn import WordEmbedding
from analytics_zoo_tpu_torch.orca.learn import Estimator

TEXTS = [
    "The cat sat on the mat",
    "Dogs chase the cat around",
    "I love training models on TPUs",
    "XLA compiles the whole step",
    "the mat was sat on by a cat",
    "models love big batches",
    "a dog and a cat met",
    "compilers fuse elementwise ops",
]
LABELS = [0, 0, 1, 1, 0, 1, 0, 1]


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(cls, texts=TEXTS, labels=LABELS, n=8, **kw):
    return (cls.from_texts(texts, labels).tokenize().normalize()
            .word2idx(**kw).shape_sequence(n).generate_sample())


def test_tokenize_normalize_word2idx():
    ts, js = _pipeline(TextSet), _pipeline(JaxTextSet)
    assert ts.word_index == js.word_index
    assert ts.word_index["the"] == 2  # 0 = pad, 1 = oov
    x, y = ts.to_numpy()
    jx, jy = js.to_numpy()
    assert x.shape == (8, 8) and x.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    toks = [w.lower() for w in TEXTS[0].split()]
    for tok, idx in zip(toks, x[0]):
        assert ts.word_index[tok] == idx


@pytest.mark.parametrize("mode", ["pre", "post"])
def test_shape_sequence_pad_and_truncate(mode):
    for texts in (["a b c d e f", "a b"], ["x y z"]):
        got = TextSet.from_texts(texts).word2idx().shape_sequence(
            4, trunc_mode=mode).to_numpy()[0]
        want = JaxTextSet.from_texts(texts).word2idx().shape_sequence(
            4, trunc_mode=mode).to_numpy()[0]
        np.testing.assert_array_equal(got, want)
    x = TextSet.from_texts(["a b c d e f", "a b"]).word2idx() \
        .shape_sequence(4, trunc_mode=mode).to_numpy()[0]
    assert np.all(x[1][2:] == 0)           # padded with PAD_ID
    with pytest.raises(ValueError, match="word2idx"):
        TextSet.from_texts(["a"]).shape_sequence(3)


def test_word2idx_existing_index_and_oov():
    train = TextSet.from_texts(TEXTS[:4]).word2idx()
    val = TextSet.from_texts(["the zebra sat"]).word2idx(
        existing_index=train.word_index).shape_sequence(4)
    jtrain = JaxTextSet.from_texts(TEXTS[:4]).word2idx()
    jval = JaxTextSet.from_texts(["the zebra sat"]).word2idx(
        existing_index=jtrain.word_index).shape_sequence(4)
    x, _ = val.to_numpy()
    np.testing.assert_array_equal(x, jval.to_numpy()[0])
    assert x[0][1] == 1                    # "zebra" unseen -> OOV id
    assert val.vocab_size() == train.vocab_size() == jval.vocab_size()


def test_word_index_round_trip(tmp_path):
    ts = TextSet.from_texts(TEXTS).word2idx(max_words_num=10)
    p = str(tmp_path / "wi.json")
    ts.save_word_index(p)
    assert TextSet.load_word_index(p) == ts.word_index
    assert JaxTextSet.load_word_index(p) == \
        JaxTextSet.from_texts(TEXTS).word2idx(max_words_num=10).word_index


def test_textset_min_freq_and_read_csv(tmp_path):
    ts = TextSet.from_texts(TEXTS).word2idx(min_freq=2)
    assert ts.word_index == JaxTextSet.from_texts(TEXTS).word2idx(
        min_freq=2).word_index
    assert "the" in ts.word_index and "compiles" not in ts.word_index
    import pandas as pd
    pd.DataFrame({"text": TEXTS, "label": LABELS}).to_csv(
        tmp_path / "news.csv", index=False)
    got = _pipeline_csv(TextSet, str(tmp_path / "news.csv"))
    want = _pipeline_csv(JaxTextSet, str(tmp_path / "news.csv"))
    for a, b in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(a, b)


def _pipeline_csv(cls, path):
    return cls.read_csv(path).tokenize().normalize().word2idx() \
        .shape_sequence(8)


def _fit_pair(monkeypatch, enc, ids, **model_kw):
    """The same TextClassifier fitted by both packages from the JAX
    Estimator's initial weights, dropout 0 on both sides."""
    base = jnn.Dropout
    monkeypatch.setattr(jnn, "Dropout", lambda rate, *a, **k: base(0.0, *a,
                                                                   **k))
    kw = dict(class_num=3, vocab_size=ids.max() + 1, token_length=16,
              sequence_length=ids.shape[1], encoder=enc,
              encoder_output_dim=16, **model_kw)
    fit_kw = dict(loss="sparse_categorical_crossentropy",
                  learning_rate=1e-2)
    jest = JaxEstimator.from_keras(JaxTextClassifier(**kw), **fit_kw)
    jest._ensure_initialized(jnp.asarray(ids[:8]))
    port = TextClassifier(**kw)
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    port.drop.rate = 0.0
    est = Estimator.from_keras(port, device="cpu", **fit_kw)
    return est, jest


@pytest.mark.parametrize("enc", ["cnn", "lstm", "gru"])
def test_textset_feeds_textclassifier_like_jax(monkeypatch, enc):
    """The reference flow, TextSet -> TextClassifier.fit, in both packages:
    the first step's gradients at 1e-5 of each tensor's max, the loss
    histories of a 2-epoch fit (the JAX test's) at 1e-5, then predict at
    the port's trained weights against the JAX forward at those weights,
    1e-5.  (adam at 1e-2 carries the steps' f32 rounding on: by a third
    epoch the cnn's loss moved 1.06e-5, and after 8 steps the two
    packages' trained gru logits differ by 1.3e-5 of their size.)"""
    import jax
    ts = _pipeline(TextSet, n=12)
    ids, y = ts.to_numpy()
    ids = np.concatenate([ids] * 4)
    y = np.concatenate([y] * 4)
    est, jest = _fit_pair(monkeypatch, enc, ids)
    jm = jest.model
    variables = jest.get_model()

    def jax_loss(params):
        out, _ = jm.apply({"params": params, "state": variables["state"]},
                          jnp.asarray(ids[:8]), training=True,
                          rng=jax.random.PRNGKey(1))
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(8), y[:8]])

    want_g = from_jax_variables({"params": jax.grad(jax_loss)(
        variables["params"])})
    out = est.model.train()(torch.from_numpy(ids[:8]))
    torch.nn.functional.cross_entropy(
        out, torch.from_numpy(y[:8]).long()).backward()
    for name, p in est.model.named_parameters():
        ref = want_g[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-5 * max(np.abs(ref).max(), 1e-12), (name, err)
        p.grad = None
    hist = est.fit(DataFeed.from_arrays(ids, y, batch_size=8), epochs=2,
                   batch_size=8, verbose=False)
    want = jest.fit((ids, y), epochs=2, batch_size=8, verbose=False)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-5)
    # predict at the port's trained weights against the JAX model's
    # forward at the same weights
    trained, _ = jm.apply(est.get_model(), jnp.asarray(ids),
                          training=False)
    np.testing.assert_allclose(est.predict(ids, batch_size=8),
                               np.asarray(trained), rtol=1e-5, atol=1e-5)


def test_word_embedding_glove_equals_jax(tmp_path):
    glove = tmp_path / "glove.txt"
    glove.write_text("999994 3\n"           # fastText header
                     "hello 1.0 2.0 3.0\n"
                     ". . . 9.9 9.9 9.9\n"   # word containing spaces
                     "world 4.0 5.0 6.0\n"
                     "trunc 7.0\n")          # truncated tail
    wi = {"hello": 1, "world": 2, "unseen": 3}
    layer = WordEmbedding.from_glove(str(glove), wi)
    want = jnn.WordEmbedding.from_glove(str(glove), wi)
    np.testing.assert_array_equal(layer.weights, want.weights)
    out = layer(torch.tensor([[1, 2, 3, 0]]))
    np.testing.assert_array_equal(out[0, :3].numpy(),
                                  [[1, 2, 3], [4, 5, 6], [0, 0, 0]])
    # frozen: a buffer (the JAX state), no parameter
    assert [n for n, _ in layer.named_buffers()] == ["embeddings"]
    assert not list(layer.parameters())
    t = WordEmbedding(np.ones((4, 3), np.float32), trainable=True)
    (t(torch.tensor([[1, 2]])) ** 2).sum().backward()
    assert float(t.embeddings.grad.abs().max()) > 0.0
    with pytest.raises(ValueError, match="vocab, dim"):
        WordEmbedding(np.ones(3))


def test_pretrained_embeddings_frozen_and_saved_both_ways(tmp_path):
    """A frozen pre-trained table stays as it was under adamw in the port
    as in JAX; a model saved by either package loads in the other with
    the table in ``state`` and predicts the same."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="vocab_size"):
        TextClassifier(class_num=2, vocab_size=99, embedding_weights=table)
    kw = dict(class_num=2, vocab_size=50, embedding_weights=table,
              encoder="cnn", encoder_output_dim=8)
    ids = rng.integers(0, 50, (32, 12)).astype(np.int32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    fit_kw = dict(loss="sparse_categorical_crossentropy", optimizer="adamw",
                  learning_rate=5e-3)
    m = TextClassifier(**kw)
    m.compile(device="cpu", **fit_kw)
    m.fit((ids, y), epochs=2, batch_size=16, verbose=False)
    np.testing.assert_array_equal(m.embed.embeddings.numpy(), table)
    assert m.estimator.get_model()["state"]["embed"]["embeddings"] \
        .shape == (50, 16)
    # the port's directory into the JAX package
    path = m.save_model(str(tmp_path / "port"))
    jm = JaxZooModel.load_model(path)
    assert jm.embedding_shape == [50, 16]
    jm.compile(loss="sparse_categorical_crossentropy")
    np.testing.assert_allclose(np.asarray(jm.predict(ids[:4])),
                               m.predict(ids[:4]), rtol=1e-5, atol=1e-5)
    # the JAX package's directory into the port
    jm2 = JaxTextClassifier(**kw)
    jest = JaxEstimator.from_keras(jm2, **fit_kw)
    jest.fit((ids, y), epochs=1, batch_size=16, verbose=False)
    jm2.set_estimator(jest)
    m2 = ZooModel.load_model(jm2.save_model(str(tmp_path / "jax")))
    assert isinstance(m2, TextClassifier) and m2.embedding_shape == [50, 16]
    np.testing.assert_array_equal(m2.embed.embeddings.numpy(), table)
    m2.compile(loss="sparse_categorical_crossentropy", device="cpu")
    np.testing.assert_allclose(m2.predict(ids[:4]),
                               np.asarray(jm2.predict(ids[:4])),
                               rtol=1e-5, atol=1e-5)
