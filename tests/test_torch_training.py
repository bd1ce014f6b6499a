"""The port's training slice against the JAX package on the CPU: losses,
metrics, optimizers, the feed's batch order, and a tiny ``BERTSQuAD``
fine-tuned by both Estimators from the same (JAX-initialised) weights.

Tolerances: losses and metrics 1e-6 relative (the same f32 math); each
optimizer's parameters after 5 updates 1e-5 relative / 1e-6 absolute
(optax's update rules in another evaluation order: torch.optim's for
sgd, momentum, adam and adamw); the BERT fit's loss
history 1e-5 relative, and its final parameters 1e-4 absolute, except the
leaves whose gradient is zero in exact arithmetic (the span softmax is
invariant to a shift shared by every position, so ``span_head/bias`` and
the last block's ``ffn2/bias`` get gradients of rounding noise, about
1e-8, which Adam rescales to steps of up to the learning rate in either
direction): those are held to the Adam step bound, 2 x lr per update.
"""

import importlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn.losses as jlosses
import analytics_zoo_tpu.nn.metrics as jmetrics
import analytics_zoo_tpu.orca.learn.optimizers as jopt
from analytics_zoo_tpu.core import get_mesh
from analytics_zoo_tpu.data.feed import as_feed as jas_feed
from analytics_zoo_tpu.models.bert import BERTSQuAD as JaxBERTSQuAD
from analytics_zoo_tpu.models.bert import squad_span_loss as jsquad_loss
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import (from_jax_variables,
                                             to_jax_variables)
from analytics_zoo_tpu_torch.data import DataFeed, as_feed
from analytics_zoo_tpu_torch.models import BERTSQuAD, squad_span_loss
from analytics_zoo_tpu_torch.nn import losses, metrics
from analytics_zoo_tpu_torch.orca.learn import Estimator, optimizers

tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")

CFG = dict(vocab_size=100, hidden_size=64, n_layers=2, n_heads=4,
           max_position=40, dropout=0.0, use_flash=True)
SEQ = 40
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _squad_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], (n, SEQ)).astype(np.int32),
            rng.integers(0, SEQ, (n, 2)).astype(np.int32))


def _both(fn_j, fn_t, *arrays, **kw):
    """(JAX result, port result) as numpy on the same inputs."""
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kw)
    return want, got.numpy()


# -- losses -------------------------------------------------------------------

def _loss_inputs(name, rng):
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    if name == "sparse_categorical_crossentropy":
        return logits, rng.integers(0, 5, 6).astype(np.int32)
    if name in ("categorical_crossentropy", "kld"):
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        q = rng.dirichlet(np.ones(5), 6).astype(np.float32)
        return (p.astype(np.float32) if name == "kld" else logits), q
    if name == "binary_crossentropy":
        return logits[:, :1], rng.integers(0, 2, (6, 1)).astype(np.float32)
    if name in ("hinge", "squared_hinge"):
        return logits, np.sign(rng.normal(size=(6, 5))).astype(np.float32)
    if name in ("poisson", "msle", "mean_squared_logarithmic_error"):
        return np.abs(logits) + 0.1, np.abs(
            rng.normal(size=(6, 5))).astype(np.float32)
    return logits, rng.normal(size=(6, 5)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
def test_each_loss_matches_jax(name):
    assert sorted(losses.LOSSES) == sorted(jlosses.LOSSES)
    y_pred, y_true = _loss_inputs(name, np.random.default_rng(len(name)))
    want, got = _both(jlosses.get(name), losses.get(name), y_pred, y_true)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["sparse_categorical_crossentropy",
                                  "categorical_crossentropy",
                                  "binary_crossentropy"])
def test_probability_inputs_match_jax(name):
    """``from_logits=False``: clipped log of probabilities."""
    rng = np.random.default_rng(3)
    y_pred, y_true = _loss_inputs(name, rng)
    if name == "binary_crossentropy":
        y_pred = 1 / (1 + np.exp(-y_pred))
    else:
        y_pred = np.exp(y_pred) / np.exp(y_pred).sum(-1, keepdims=True)
    want, got = _both(jlosses.get(name), losses.get(name),
                      y_pred.astype(np.float32), y_true, from_logits=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_squad_span_loss_matches_jax():
    rng = np.random.default_rng(4)
    y_pred = rng.normal(size=(3, 17, 2)).astype(np.float32)
    y_true = rng.integers(0, 17, (3, 2)).astype(np.int32)
    want, got = _both(jsquad_loss, squad_span_loss, y_pred, y_true)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get("nope")


# -- metrics ------------------------------------------------------------------

def _metric_cases():
    rng = np.random.default_rng(5)
    cls = rng.normal(size=(8, 5)).astype(np.float32)
    lab = rng.integers(0, 5, 8).astype(np.int32)
    onehot = np.eye(5, dtype=np.float32)[lab]
    tok = rng.normal(size=(4, 6, 5)).astype(np.float32)
    tok_lab = rng.integers(0, 5, (4, 6)).astype(np.int32)
    bin_out = rng.normal(size=(8, 1)).astype(np.float32)
    bin_lab = rng.integers(0, 2, (8, 1)).astype(np.float32)
    reg_out = rng.normal(size=(8, 1)).astype(np.float32)
    reg_lab = rng.normal(size=8).astype(np.float32)
    mask8 = np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32)
    return [
        ("accuracy", {}, cls, lab, mask8),
        ("accuracy", {}, cls, onehot, None),
        ("accuracy", {}, bin_out, bin_lab, mask8),
        ("accuracy", {}, tok, tok_lab, np.array([1, 1, 0, 1], np.float32)),
        ("top_k", {"k": 2}, cls, lab, mask8),
        ("top5", {}, tok, tok_lab, None),
        ("mae", {}, reg_out, reg_lab, mask8),
        ("mse", {}, cls, rng.normal(size=(8, 5)).astype(np.float32), None),
        ("auc", {}, bin_out, bin_lab, mask8),
        ("auc", {"num_bins": 16}, rng.normal(size=(8, 3)).astype(np.float32),
         rng.integers(0, 2, (8, 3)).astype(np.float32), mask8),
    ]


@pytest.mark.parametrize("case", range(len(_metric_cases())))
def test_each_metric_matches_jax(case):
    name, kw, y_pred, y_true, mask = _metric_cases()[case]
    if name == "top_k":
        jm, tm = jmetrics.TopKAccuracy(**kw), metrics.TopKAccuracy(**kw)
    elif name == "auc":
        jm, tm = jmetrics.BinaryAUC(**kw), metrics.BinaryAUC(**kw)
    else:
        jm, tm = jmetrics.get(name), metrics.get(name)
    assert jm.name == tm.name
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    # two batches summed, as evaluate sums them
    jstats = sum(jm.update(jnp.asarray(y_pred), jnp.asarray(y_true), jmask)
                 for _ in range(2))
    tstats = sum(tm.update(torch.from_numpy(y_pred),
                           torch.from_numpy(y_true), tmask)
                 for _ in range(2))
    np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm.result(tstats)),
                               float(jm.result(jstats)), rtol=1e-6,
                               atol=1e-6)


def test_metric_names_resolve_like_jax():
    assert sorted(metrics.METRICS) == sorted(jmetrics.METRICS)
    for name in metrics.METRICS:
        assert metrics.get(name).name == jmetrics.get(name).name
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.get("nope")


# -- optimizers ---------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", {}, None, None),
    ("momentum", {}, None, None),
    ("sgd", {"momentum": 0.8, "nesterov": True}, None, None),
    ("adam", {}, None, None),
    ("adamw", {}, None, None),
    ("adamw", {"weight_decay": 0.05}, None, 0.5),
    ("rmsprop", {}, None, None),
    ("rmsprop", {"momentum": 0.9, "initial_scale": 0.5}, None, None),
    ("adagrad", {}, None, None),
    ("adam", {}, {"schedule": "warmup_cosine", "peak": 0.05,
                  "warmup_steps": 2, "decay_steps": 5}, None),
    ("sgd", {}, {"schedule": "exponential", "peak": 0.1, "decay_steps": 2,
                 "staircase": True}, None),
    ("sgd", {}, {"schedule": "poly", "lr": 0.1, "decay_steps": 4,
                 "power": 2.0}, 1.0),
    ("adagrad", {}, {"schedule": "cosine", "peak": 0.1, "decay_steps": 3},
     None),
    ("sgd", {}, {"schedule": "warmup_linear", "peak": 0.1,
                 "warmup_steps": 3}, None),
    ("adam", {}, {"schedule": "constant", "peak": 0.02}, None),
]


@pytest.mark.parametrize("case", range(len(OPTIMIZERS)))
def test_each_optimizer_matches_optax(case):
    """5 updates of a random tree of 3 tensors, fresh random gradients
    each step, against the JAX package's optax transformation."""
    _check_optimizer_against_optax(case, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [i for i, c in enumerate(OPTIMIZERS)
                                  if c[0] in ("sgd", "momentum", "adam",
                                              "adamw")])
def test_torch_optim_rules_are_fused_on_card_and_match_optax(case):
    """On the card the torch.optim-backed rules run fused and still give
    optax's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused optimizers run there")
    _check_optimizer_against_optax(case, "cuda")


def _check_optimizer_against_optax(case, device):
    name, kw, lr, clip = OPTIMIZERS[case]
    lr = 0.03 if lr is None else lr
    rng = np.random.default_rng(case)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]

    jtx = jopt.get(name, lr, clip, **kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    topt = optimizers.get(name, lr, clip, **kw)
    tp = [torch.from_numpy(p.copy()).to(device) for p in params]
    tstate = topt.init(tp)
    if device == "cuda":
        assert all(grp["fused"] for grp in tstate["optim"].param_groups)
    for g in grads:
        upd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = [a + b for a, b in zip(jp, upd)]
        tstate = topt.step(tp, [torch.from_numpy(x).to(device) for x in g],
                           tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.cpu().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


def test_optimizer_defaults_are_optax_not_torch():
    """adamw's weight decay is optax's 1e-4 (torch.optim.AdamW: 0.01);
    lamb and lars resolve by name; bad specs are refused as in the JAX
    package."""
    p = [torch.ones(3)]
    opt = optimizers.get("adamw", 1.0)
    opt.step(p, [torch.zeros(3)], opt.init(p))
    np.testing.assert_allclose(p[0].numpy(), 1 - 1e-4, rtol=1e-6)
    for name in ("lamb", "lars"):
        assert isinstance(optimizers.get(name, 0.1), optimizers.Layerwise)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get("nope", 0.1)
    with pytest.raises(ValueError, match="needs a 'schedule'"):
        optimizers.get("sgd", {"peak": 0.1})


# -- feed ---------------------------------------------------------------------

@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_feed_batch_order_matches_jax(shuffle, drop_remainder):
    """Same rows in the same batches for three epochs: the epoch's
    ``default_rng(seed + epoch)`` shuffle, the dropped or wrapped-around
    last batch and its mask, for (x, y) tuples and {"x", "y"} dicts."""
    x = np.arange(26 * 3, dtype=np.float32).reshape(26, 3)
    y = np.arange(26, dtype=np.int32)
    kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop_remainder)
    mesh = get_mesh()
    for data in ((x, y), {"x": x, "y": y}):
        jfeed, tfeed = jas_feed(data, 8, **kw), as_feed(data, 8, **kw)
        assert tfeed.steps_per_epoch() == jfeed.steps_per_epoch()
        for epoch in range(3):
            want = [{k: np.asarray(v) for k, v in b.items()}
                    for b in jfeed.epoch(mesh, epoch)]
            got = list(tfeed.epoch(torch.device("cpu"), epoch))
            assert len(got) == len(want)
            for step, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g["x"].numpy(), w["x"])
                np.testing.assert_array_equal(g["y"].numpy(), w["y"])
                np.testing.assert_array_equal(tfeed.step_mask(step),
                                              jfeed.step_mask(step))
        for a, b in ((tfeed.remainder(), jfeed.remainder()),
                     (tfeed.dropped_rows(1), jfeed.dropped_rows(1))):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a["x"], np.asarray(b["x"]))


# -- the BERT fine-tune -------------------------------------------------------

def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def squad_fit():
    """A tiny BERTSQuAD (2 layers, hidden 64, 4 heads, seq 40, vocab 100,
    f32, dropout 0, flash attention) initialised by the JAX Estimator,
    converted into the port, then fit by both for 3 single-batch epochs
    with adamw."""
    x, y = _squad_data(8)
    jest = JaxEstimator.from_keras(JaxBERTSQuAD(**CFG), loss=jsquad_loss,
                                   optimizer="adamw", learning_rate=LR)
    jest._ensure_initialized(jnp.asarray(x))
    init = jest.get_model()
    model = JaxBERTSQuAD(**CFG)
    grads0 = jax.grad(lambda p: jsquad_loss(
        model.apply({"params": p, "state": init["state"]},
                    jnp.asarray(x))[0], jnp.asarray(y)))(init["params"])
    port = BERTSQuAD(**CFG)
    port.load_state_dict(from_jax_variables(init), strict=True)
    test = Estimator.from_keras(port, loss=squad_span_loss,
                                optimizer="adamw", learning_rate=LR,
                                device="cpu")
    before = dict(tfa.KERNEL_LAUNCHES)
    hist_j = jest.fit((x, y), epochs=3, batch_size=8, verbose=False)
    hist_t = test.fit((x, y), epochs=3, batch_size=8, verbose=False)
    assert dict(tfa.KERNEL_LAUNCHES) == before  # the CPU runs no kernel
    return jest, test, hist_j, hist_t, grads0


def test_bert_squad_fit_matches_jax_estimator(squad_fit):
    jest, test, hist_j, hist_t, grads0 = squad_fit
    np.testing.assert_allclose(hist_t["loss"], hist_j["loss"], rtol=1e-5)
    assert hist_t["loss"][-1] < hist_t["loss"][0]
    got, want = test.get_model(), jest.get_model()
    g_max = max(float(np.abs(np.asarray(g)).max())
                for _, g in _leaves(grads0))
    noise_leaves = []
    for path, w in _leaves(want["params"]):
        g = _at(test.get_model()["params"], path)
        diff = float(np.abs(g - np.asarray(w)).max())
        if float(np.abs(np.asarray(_at(grads0, path))).max()) < 1e-6 * g_max:
            noise_leaves.append("/".join(path))
            assert diff <= 2 * LR * 3, path
        else:
            assert diff <= 1e-4, (path, diff)
    # exactly the shift-invariant leaves named in the module docstring
    assert sorted(noise_leaves) == ["bert/layer_1/ffn2/bias",
                                    "span_head/bias"]
    assert set(map(tuple, (p for p, _ in _leaves(got["params"])))) == \
        set(map(tuple, (p for p, _ in _leaves(want["params"]))))


def test_evaluate_and_predict_cover_every_row_like_jax(squad_fit):
    """13 rows at batch 4: three full batches and a padded, masked one."""
    jest, test, *_ = squad_fit
    x, y = _squad_data(13, seed=1)
    pred_t, pred_j = test.predict(x, batch_size=4), jest.predict(
        x, batch_size=4)
    assert pred_t.shape == pred_j.shape == (13, SEQ, 2)
    # the shift-invariant leaves (module docstring) move each example's
    # span logits by a constant over positions: compare them centred
    def centred(p):
        return p - p.mean(axis=1, keepdims=True)

    np.testing.assert_allclose(centred(pred_t), centred(pred_j), atol=1e-4,
                               rtol=1e-4)
    ev_t = test.evaluate((x, y), batch_size=4)
    ev_j = jest.evaluate((x, y), batch_size=4)
    assert set(ev_t) == set(ev_j) == {"loss"}
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-4)
    # the padded rows carry no weight: the mean over the 13 rows alone
    with torch.no_grad():
        exact = float(squad_span_loss(
            test.model.eval()(torch.from_numpy(x)), torch.from_numpy(y)))
    np.testing.assert_allclose(ev_t["loss"], exact, rtol=1e-5)


def test_evaluate_weights_out_padding_for_metrics():
    """A port-only classifier with an accuracy metric over 10 rows at batch
    4: the metric equals accuracy over exactly those rows."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(10, 6)).astype(np.float32)
    y = rng.integers(0, 3, 10).astype(np.int64)
    model = tnn.Dense(6, 3)
    est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                               metrics=["accuracy"], device="cpu")
    res = est.evaluate((x, y), batch_size=4)
    with torch.no_grad():
        pred = model(torch.from_numpy(x)).argmax(-1).numpy()
    assert res["accuracy"] == pytest.approx(float((pred == y).mean()))
    hist = est.fit((x, y), epochs=2, batch_size=4, verbose=False,
                   validation_data=(x, y))
    assert len(hist["loss"]) == len(hist["val_accuracy"]) == 2


def test_a_training_feed_still_evaluates_and_predicts_every_row():
    """A user-built feed that drops its remainder (the training default):
    evaluate adds the rows its epoch drops as a padded, masked batch, and
    predict adds the unshuffled tail, so both cover all 10 rows."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(10, 6)).astype(np.float32)
    y = rng.integers(0, 3, 10).astype(np.int64)
    est = Estimator.from_keras(tnn.Dense(6, 3),
                               loss="sparse_categorical_crossentropy",
                               metrics=["accuracy"], device="cpu")
    want = est.evaluate((x, y), batch_size=4)
    dropping = DataFeed({"x": x, "y": y}, 4, shuffle=True, seed=3,
                        drop_remainder=True)
    got = est.evaluate(dropping, batch_size=4)
    assert got == pytest.approx(want, rel=1e-6)
    ordered = DataFeed({"x": x}, 4, shuffle=False, drop_remainder=True)
    np.testing.assert_allclose(est.predict(ordered),
                               est.predict(x, batch_size=4), rtol=1e-6)
    with pytest.raises(ValueError, match="row order"):
        est.predict(DataFeed({"x": x}, 4, shuffle=True))


def test_to_jax_variables_round_trips(squad_fit):
    jest, test, *_ = squad_fit
    sd = test.model.state_dict()
    back = from_jax_variables(to_jax_variables(sd))
    assert list(back) == list(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    tree = jest.get_model()
    again = to_jax_variables(from_jax_variables(tree))
    for path, leaf in _leaves(tree["params"]):
        np.testing.assert_array_equal(_at(again["params"], path),
                                      np.asarray(leaf))
    bf = to_jax_variables({"a.b": torch.ones(2, dtype=torch.bfloat16),
                           "s": torch.zeros(1)}, state_keys=["s"])
    assert bf["params"]["a"]["b"].dtype == np.float32
    assert list(bf["state"]) == ["s"]


# -- estimator contract -------------------------------------------------------

def test_estimator_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        Estimator.from_keras(tnn.Dense(2, 2), loss="mse")


@pytest.mark.parametrize("knob,value", [
    ("sharding", "fsdp"), ("grad_compression", "int8"),
    ("aux_loss_weight", 0.5)])
def test_unported_knobs_raise(knob, value):
    # every knob of the JAX estimator is taken: sharding= and
    # grad_compression= since the multi-process slice (in one process they
    # run the one-process step), aux_loss_weight since the MoE slice; none
    # is left to raise NotImplementedError
    est = Estimator.from_keras(tnn.Dense(2, 2), loss="mse", device="cpu",
                               **{knob: value})
    assert getattr(est, knob) == value
    from analytics_zoo_tpu_torch.orca.learn import estimator as est_lib
    assert est_lib._UNPORTED_KNOBS == {}


def test_default_knobs_pass_and_unknown_ones_are_refused():
    est = Estimator.from_keras(tnn.Dense(2, 2), loss="mse", device="cpu",
                               grad_accum=1, sharding="dp",
                               profile_steps=[10, 20])
    with pytest.raises(TypeError, match="unexpected argument"):
        Estimator.from_keras(tnn.Dense(2, 2), loss="mse", device="cpu",
                             bogus=1)
    x = np.zeros((4, 2), np.float32)
    # the state plane's fit arguments and save are taken now: an unknown
    # trigger is refused as the JAX package refuses it, a known one saves
    with pytest.raises(ValueError, match="unknown trigger"):
        est.fit((x, x), batch_size=2, checkpoint_trigger="epoch")
    with pytest.raises(ValueError, match="no model_dir"):
        est.save()
    with tempfile.TemporaryDirectory() as d:
        assert est.save(d) == d
        est.fit((x, x), batch_size=2, verbose=False)
        est.load(d)
        assert est._py_step == 0
    with pytest.raises(ValueError, match="yields no batches"):
        est.fit((x, x), batch_size=8)


# -- dropout and remat --------------------------------------------------------

def _train_losses(seed, dropout, remat=False, steps=3):
    x, y = _squad_data(8)
    model = BERTSQuAD(**dict(CFG, dropout=dropout, use_flash=not remat,
                             remat=remat))
    model.init_weights(torch.Generator().manual_seed(0))
    est = Estimator.from_keras(model, loss=squad_span_loss, optimizer="adam",
                               learning_rate=LR, device="cpu", seed=seed)
    return est.fit((x, y), epochs=steps, batch_size=8,
                   verbose=False)["loss"]


def test_dropout_masks_repeat_with_the_seed():
    """Two fits with one seed give one loss history; another seed gives
    another (the masks come from the Estimator's seeded generator)."""
    a, b, c = (_train_losses(s, 0.3) for s in (1, 1, 2))
    assert a == b
    assert a != c


def test_dropout_draws_from_its_generator():
    drop = tnn.Dropout(0.25).train()
    x = torch.ones(4000)
    drop.generator = torch.Generator().manual_seed(3)
    y1 = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y1)
    assert set(y1.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((y1 == 0).float().mean()) - 0.25) < 0.03
    assert torch.equal(drop.eval()(x), x)


def test_remat_bert_loads_the_jax_remat_tree_and_matches_it():
    """``remat=True`` keeps the JAX tree's ``remat_{i}/layer_{i}`` names;
    the forward matches the JAX model's."""
    cfg = dict(CFG, use_flash=False, remat=True)
    x, _ = _squad_data(2)
    jm = JaxBERTSQuAD(**cfg)
    variables = jm.init(jax.random.PRNGKey(1), x)
    port = BERTSQuAD(**cfg)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    want, _ = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kind", ["remat", "remat_attention"])
def test_remat_gradients_equal_the_plain_ones(kind):
    """Recomputation changes no gradient, dropout included (the recompute
    replays the forward's masks from the rewound generator)."""
    x, y = _squad_data(4)
    grads = []
    for on in (False, True):
        cfg = dict(CFG, dropout=0.2, use_flash=False, **{kind: on})
        model = BERTSQuAD(**cfg).train()
        model.init_weights(torch.Generator().manual_seed(0))
        tnn.seed_dropout(model, 5, torch.device("cpu"))
        loss = squad_span_loss(model(torch.from_numpy(x)),
                               torch.from_numpy(y))
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_remat_with_flash_is_refused_like_jax():
    with pytest.raises(ValueError, match="dense attention path only"):
        tnn.MultiHeadAttention(32, 4, use_flash=True, remat=True)
    tnn.MultiHeadAttention(32, 4, use_flash="auto", remat=True)


def test_flash_bert_trains_through_the_flash_backward(monkeypatch):
    """Every layer's attention gradient goes through flash_attention_bwd,
    once per layer per step (no second forward outside remat)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd", count("bwd", bwd))
    _train_losses(0, 0.1, steps=2)
    assert calls == {"fwd": 2 * CFG["n_layers"], "bwd": 2 * CFG["n_layers"]}


@pytest.mark.cuda
def test_two_fits_with_one_seed_repeat_on_card():
    """On the card, with dropout and the flash kernels: one seed, one loss
    history (the kernels are deterministic: no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, y = _squad_data(8)
    hists = []
    for _ in range(2):
        model = BERTSQuAD(**dict(CFG, dropout=0.1))
        model.init_weights(torch.Generator().manual_seed(0))
        est = Estimator.from_keras(model, loss=squad_span_loss,
                                   optimizer="adamw", learning_rate=LR,
                                   seed=3)
        before = tfa.flash_attention_bwd.launches
        hists.append(est.fit((x, y), epochs=3, batch_size=4,
                             verbose=False)["loss"])
        assert tfa.flash_attention_bwd.launches - before == \
            CFG["n_layers"] * 6
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-6)
