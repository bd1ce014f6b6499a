"""The port's recommenders (``models/recommendation.py``) and the
``ZooModel`` training plumbing against the JAX package on the CPU: the
``NeuralCF`` forward with and without MF (replicated and sharded tables),
``NCFTail`` on the gathered vectors, ``WideAndDeep`` in its three
``model_type``s, ``recommend_for_user``/``recommend_for_item``, the GRU
``SessionRecommender`` (forward, fit, ``recommend_for_session``), a 3-epoch
``compile``/``fit`` loss history and ``predict_classes`` against the JAX
Estimator, an ``XShards`` fit through ``feature_cols``/``label_cols``, and
the converter's round trip of these trees.  Weights are initialised in JAX
and carried across with ``convert.py``; inputs are numpy from a seed.

Tolerances: forwards 1e-5 of max(1, max |ref|) (f32 in another summation
order); loss histories 1e-5 of max(1, |loss|); recommendation
probabilities 1e-5 absolute with the same ids in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.data import XShards as JaxXShards
from analytics_zoo_tpu.models import NCFTail as JaxNCFTail
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.models import \
    SessionRecommender as JaxSessionRecommender
from analytics_zoo_tpu.models import WideAndDeep as JaxWideAndDeep
from analytics_zoo_tpu_torch.convert import (from_jax_variables,
                                             to_jax_variables)
from analytics_zoo_tpu_torch.data import XShards
from analytics_zoo_tpu_torch.models import (NCFTail, NeuralCF,
                                            SessionRecommender, WideAndDeep)

LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _pairs(n, users, items, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, users, n),
                     rng.integers(0, items, n)], 1).astype(np.int32)


def _twin(jmodel, model, x, seed=0):
    """Init ``jmodel`` on ``x`` in JAX, load its variables into ``model``;
    returns the variables."""
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return variables


def _jax_forward(jmodel, variables, x):
    out, _ = jmodel.apply(variables, jnp.asarray(x))
    return np.asarray(out)


NCF_CASES = {
    "mf": dict(include_mf=True),
    "no_mf": dict(include_mf=False, hidden_layers=(12, 6)),
    "sharded": dict(include_mf=True, sharded_embeddings=True),
}


@pytest.mark.parametrize("case", sorted(NCF_CASES))
def test_neuralcf_forward_matches_jax(case):
    kw = dict(user_count=30, item_count=20, class_num=3, user_embed=6,
              item_embed=5, mf_embed=4, **NCF_CASES[case])
    x = _pairs(17, 30, 20, 1)
    model = NeuralCF(**kw)
    jmodel = JaxNeuralCF(**kw)
    variables = _twin(jmodel, model, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, _jax_forward(jmodel, variables, x), what=case)


@pytest.mark.parametrize("include_mf", [True, False])
def test_ncf_tail_on_gathered_vectors_matches_jax(include_mf):
    kw = dict(user_count=30, item_count=20, class_num=2, user_embed=6,
              item_embed=5, mf_embed=4, include_mf=include_mf)
    x = _pairs(9, 30, 20, 2)
    model, jmodel = NeuralCF(**kw), JaxNeuralCF(**kw)
    variables = _twin(jmodel, model, x)
    tables, tail, tail_vars = model.serving_split(
        to_jax_variables(model.state_dict()))
    jtables, jtail, jtail_vars = jmodel.serving_split(variables)
    assert isinstance(tail, NCFTail) and tables.keys() == jtables.keys()
    assert tail.input_dim() == jtail.input_dim()
    ids = {"user": x[:, 0], "item": x[:, 1]}
    feats = np.concatenate([tables[name][ids[which]] for name, which in
                            model.embedding_columns()], 1)
    tail.load_state_dict(from_jax_variables(tail_vars), strict=True)
    with torch.no_grad():
        got = tail(torch.from_numpy(feats)).numpy()
    _close(got, _jax_forward(jtail, jtail_vars, feats), what="tail")
    with torch.no_grad():  # the tail is the model after its gathers
        _close(got, model(torch.from_numpy(x)).numpy(), what="model")


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
@pytest.mark.parametrize("sharded", [False, True])
def test_wide_and_deep_forward_matches_jax(model_type, sharded):
    kw = dict(class_num=2, model_type=model_type, wide_base_dims=[4],
              wide_cross_dims=[6], indicator_dims=[3],
              embed_in_dims=[11, 7], embed_out_dims=[5, 4],
              continuous_cols=2, hidden_layers=(8, 4),
              sharded_embeddings=sharded)
    rng = np.random.default_rng(4)
    n = 13
    x = np.concatenate([
        (rng.random((n, 10)) < 0.3).astype(np.float32),
        (rng.random((n, 3)) < 0.5).astype(np.float32),
        rng.integers(0, 11, (n, 1)).astype(np.float32),
        rng.integers(0, 7, (n, 1)).astype(np.float32),
        rng.normal(size=(n, 2)).astype(np.float32)], axis=1)
    model, jmodel = WideAndDeep(**kw), JaxWideAndDeep(**kw)
    variables = _twin(jmodel, model, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, _jax_forward(jmodel, variables, x), what=model_type)


def test_wide_and_deep_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="model_type"):
        WideAndDeep(model_type="deep_n_wide")


SESSION_CASES = {
    "gru_only": dict(item_count=25, item_embed=6, rnn_hidden_layers=(8, 5),
                     session_length=6),
    "history": dict(item_count=25, item_embed=6, rnn_hidden_layers=(7,),
                    session_length=5, include_history=True,
                    mlp_hidden_layers=(9, 4), history_length=3),
}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_recommender_matches_jax(case):
    """The GRU session model: its forward, a 3-epoch fit's losses (1e-5 of
    max(1, |loss|)) and ``recommend_for_session``'s top-5 rows, whose
    probabilities are a softmax of its ``predict``."""
    kw = SESSION_CASES[case]
    width = kw["session_length"] + kw.get("history_length", 0) * \
        kw.get("include_history", False)
    rng = np.random.default_rng(9)
    x = rng.integers(0, kw["item_count"], (64, width)).astype(np.int32)
    y = rng.integers(0, kw["item_count"], 64).astype(np.int32)
    init_orca_context("local")
    jmodel, model = JaxSessionRecommender(**kw), SessionRecommender(**kw)
    ckw = dict(loss=LOSS, optimizer="adam", learning_rate=1e-2, seed=3)
    jmodel.compile(**ckw)
    jmodel.estimator._ensure_initialized(jnp.asarray(x[:32]))
    variables = jmodel.estimator.get_model()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.compile(device="cpu", **ckw)
    with torch.no_grad():
        got = model(torch.from_numpy(x[:9])).numpy()
    _close(got, _jax_forward(jmodel, variables, x[:9]), what=case)
    hj = jmodel.fit((x, y), epochs=3, batch_size=32, verbose=False)
    ht = model.fit((x, y), epochs=3, batch_size=32, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5, atol=1e-5)
    got = model.recommend_for_session(x[:4], max_items=5)
    want = jmodel.recommend_for_session(x[:4], max_items=5)
    assert [[i for i, _ in row] for row in got] == \
        [[i for i, _ in row] for row in want]
    np.testing.assert_allclose([p for row in got for _, p in row],
                               [p for row in want for _, p in row],
                               atol=1e-5)
    probs = torch.softmax(torch.from_numpy(model.predict(x[:4])), -1).numpy()
    for row, pr in zip(got, probs):
        assert [p for _, p in row] == [float(pr[i]) for i, _ in row]


@pytest.mark.parametrize("sharded", [False, True])
def test_convert_round_trips_recommender_trees(sharded):
    """JAX tree -> state_dict -> JAX tree, bit for bit, tables as
    ``(rows, dim)``."""
    kw = dict(user_count=12, item_count=9, user_embed=4, item_embed=4,
              mf_embed=3, hidden_layers=(6,), sharded_embeddings=sharded)
    variables = JaxNeuralCF(**kw).init(jax.random.PRNGKey(3),
                                       jnp.asarray(_pairs(4, 12, 9, 0)))
    model = NeuralCF(**kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    back = to_jax_variables(model.state_dict())
    leaf = "sharded_embeddings" if sharded else "embeddings"
    assert back["params"]["mlp_user_embed"][leaf].shape == (12, 4)
    for name, sub in variables["params"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(back["params"][name][k],
                                          np.asarray(v))


def _compiled_pair(x, **kw):
    """JAX and port NeuralCFs with one init, each compiled (adam 1e-2)."""
    init_orca_context("local")
    jmodel, model = JaxNeuralCF(**kw), NeuralCF(**kw)
    ckw = dict(loss=LOSS, optimizer="adam", learning_rate=1e-2, seed=5)
    jmodel.compile(**ckw)
    jmodel.estimator._ensure_initialized(jnp.asarray(x[:32]))
    model.load_state_dict(from_jax_variables(jmodel.estimator.get_model()),
                          strict=True)
    model.compile(device="cpu", **ckw)
    return jmodel, model


NCF_KW = dict(user_count=40, item_count=30, class_num=2, user_embed=8,
              item_embed=8, hidden_layers=(16, 8), mf_embed=8)


def test_compile_fit_and_predict_classes_match_jax():
    x = _pairs(320, 40, 30, 6)
    y = (np.random.default_rng(6).random(320) < 0.5).astype(np.int32)
    jmodel, model = _compiled_pair(x, **NCF_KW)
    hj = jmodel.fit((x, y), epochs=3, batch_size=64, verbose=False)
    ht = model.fit((x, y), epochs=3, batch_size=64, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5, atol=1e-5)
    assert ht["loss"][-1] < ht["loss"][0]
    np.testing.assert_array_equal(model.predict_classes(x, batch_size=64),
                                  jmodel.predict_classes(x, batch_size=64))
    ev_t = model.evaluate((x, y), batch_size=50)
    ev_j = jmodel.evaluate((x, y), batch_size=50)
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)


def test_zoo_model_needs_compile():
    with pytest.raises(ValueError, match="compile"):
        NeuralCF(4, 4).predict(np.zeros((1, 2), np.int32))


@pytest.mark.parametrize("per", ["user", "item"])
def test_recommend_matches_jax(per):
    kw = dict(NCF_KW, user_count=12, item_count=15)
    jmodel, model = _compiled_pair(_pairs(64, 12, 15, 7), **kw)
    if per == "user":
        got = model.recommend_for_user([0, 3, 11], max_items=4)
        want = jmodel.recommend_for_user([0, 3, 11], max_items=4)
    else:
        got = model.recommend_for_item([2, 14], max_users=5)
        want = jmodel.recommend_for_item([2, 14], max_users=5)
    assert [(r.user_id, r.item_id, r.prediction) for r in got] == \
        [(r.user_id, r.item_id, r.prediction) for r in want]
    np.testing.assert_allclose([r.probability for r in got],
                               [r.probability for r in want], atol=1e-5)


def test_xshards_fit_with_feature_cols_matches_jax():
    """DataFrame shards with ``feature_cols``/``label_cols`` through the
    port's ``XShards`` and the JAX package's: the same loss history."""
    rng = np.random.default_rng(8)
    df = pd.DataFrame({"user": rng.integers(0, 40, 256),
                       "item": rng.integers(0, 30, 256),
                       "label": rng.integers(0, 2, 256)})
    parts = np.array_split(np.arange(256), 4)
    shards = [df.iloc[p].reset_index(drop=True) for p in parts]
    x = df[["user", "item"]].to_numpy(np.int32)
    jmodel, model = _compiled_pair(x, **NCF_KW)
    cols = dict(feature_cols=["user", "item"], label_cols=["label"])
    hj = jmodel.estimator.fit(JaxXShards(shards), epochs=2, batch_size=64,
                              verbose=False, **cols)
    ht = model.estimator.fit(XShards(shards), epochs=2, batch_size=64,
                             verbose=False, **cols)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5, atol=1e-5)
    got = model.estimator.predict(XShards(shards), batch_size=64,
                                  feature_cols=["user", "item"])
    want = jmodel.estimator.predict(JaxXShards(shards), batch_size=64,
                                    feature_cols=["user", "item"])
    _close(got, want, what="predict")
