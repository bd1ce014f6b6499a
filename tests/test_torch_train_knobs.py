"""The Estimator's single-device knobs in the port against the JAX package
on the CPU: LARS and LAMB, ``nan_policy`` (``skip_step`` inside the step,
``warn``, ``raise``, ``rollback``), ``fit``'s fault seams and flight
record, ``profile=`` and the ``log_dir`` summaries, and a BERT fit fed
segment ids.

Tolerances: LARS and LAMB after 5 updates, each parameter and moment
leaf within 1e-5 of the leaf's largest magnitude (the same f32 update
rule; the trust ratios' norms sum in another order), except the LARS
momentum of the ResNet, a sum of gradients whose batch-norm backward
carries rounding noise at 1e-5 of each leaf's largest entry in either
package: 1e-4; the fits' losses 1e-5 relative.  ``skip_step``'s run is held to the port's own run without
the poisoned batch bit for bit, and to the JAX run at the tolerances
above.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
import analytics_zoo_tpu.nn as jnn
import analytics_zoo_tpu.orca.learn.optimizers as jopt
from analytics_zoo_tpu.core import faults as jfaults
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.core.config import ZooConfig as JaxZooConfig
from analytics_zoo_tpu.models import BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu.models import ResNet as JaxResNet
from analytics_zoo_tpu.models.bert import BERT as JaxBERT
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
from analytics_zoo_tpu_torch.core import faults as faults_lib
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from analytics_zoo_tpu_torch.core.config import ZooConfig
from analytics_zoo_tpu_torch.models import BERTClassifier, ResNet
from analytics_zoo_tpu_torch.models.bert import BERT
from analytics_zoo_tpu_torch.orca.learn import (NAN_POLICIES, Estimator,
                                                NonFiniteLossError,
                                                optimizers)
from analytics_zoo_tpu_torch.orca.learn import estimator as est_lib

BERT_CFG = dict(vocab_size=50, hidden_size=32, n_layers=2, n_heads=4,
                max_position=16, dropout=0.0)
SEQ = 16


def _tree_np(tree):
    """A port tree (dicts, lists, tuples of tensors) as numpy leaves."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.is_floating_point() \
            else tree.detach().numpy()
    return np.asarray(tree)


def _leaves_close(got, want, tol=1e-5, what=""):
    """Leaf for leaf, each within ``tol`` of the leaf's largest magnitude
    (1 at least)."""
    gl = ckpt_io.leaf_paths(got)
    wl = ckpt_io.leaf_paths(want)
    assert gl == wl, (what, gl[:4], wl[:4])
    for p, g, w in zip(gl, ckpt_io.flatten(got)[0], ckpt_io.flatten(want)[0]):
        g = np.asarray(_tree_np(g), np.float64)
        w = np.asarray(w, np.float64)
        scale = max(1.0, float(np.abs(w).max()) if w.size else 1.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * scale, (what, p, err, scale)


def _trees_equal(a, b):
    for p, x, y in zip(ckpt_io.leaf_paths(a), ckpt_io.flatten(a)[0],
                       ckpt_io.flatten(b)[0]):
        assert torch.equal(torch.as_tensor(np.asarray(_tree_np(x))),
                           torch.as_tensor(np.asarray(_tree_np(y)))), p


# -- LARS and LAMB: the rules -------------------------------------------------

def test_exclusion_follows_the_jax_regexes():
    """The port's flags over the leaves' ``/``-joined paths (what the
    Estimator and the GANEstimator pass) equal the JAX package's
    ``_exclusion_tree`` over the same tree."""
    from analytics_zoo_tpu.parallel.sharding import _key_str
    tree = {"enc": {"dense": {"kernel": 0, "bias": 0},
                    "ln": {"gamma": 0, "beta": 0}},
            "head_bias": 0, "layers": [{"bias": 0}, {"kernel": 0}]}
    want = jopt._exclusion_tree(tree, jopt.EXCLUDE_DEFAULT)
    assert want["enc"]["dense"] == {"kernel": False, "bias": True}
    assert want["head_bias"] is False
    paths = ["/".join(_key_str(k) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert "layers/0/bias" in paths
    assert optimizers._exclusion_flags(paths, optimizers.EXCLUDE_DEFAULT) \
        == jax.tree_util.tree_leaves(want)


def test_layerwise_init_refuses_unnamed_parameters():
    """Without paths no leaf could be excluded: LARS and LAMB refuse, as
    every bias and norm scale would otherwise be decayed and adapted."""
    p = [torch.zeros(3), torch.zeros(2, 3)]
    for name in ("lars", "lamb"):
        opt = optimizers.get(name, 0.1)
        with pytest.raises(ValueError, match="path"):
            opt.init(p)
        with pytest.raises(ValueError, match="path"):
            opt.init(p, ["d/bias"])
        assert opt.init(p, ["d/bias", "d/kernel"])["excluded"] \
            == (True, False)


def test_trust_ratio_by_hand():
    tr = optimizers._trust_ratio
    w, u = torch.tensor(3.0), torch.tensor(4.0)
    assert float(tr(w, u, 0.5)) == pytest.approx(0.5 * 3 / 4)
    assert float(tr(torch.tensor(0.0), u, 0.5)) == 1.0  # zero weights
    assert float(tr(w, torch.tensor(0.0), 0.5)) == 1.0  # zero update
    want = jopt._trust_ratio(jnp.float32(3.0), jnp.float32(4.0), 0.5)
    assert float(tr(w, u, 0.5)) == float(want)


def _one_leaf_step(name, excluded):
    """One update of one leaf by hand, and by the port's rule."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    p = [torch.tensor(w)]
    opt = optimizers.get(name, 0.1)
    leaf = "layer/bias" if excluded else "layer/kernel"
    opt.step(p, [torch.tensor(g)], opt.init(p, [leaf]))
    return w.astype(np.float64), g.astype(np.float64), p[0].numpy()


@pytest.mark.parametrize("excluded", [False, True])
def test_lars_first_step_by_hand(excluded):
    w, g, got = _one_leaf_step("lars", excluded)
    if not excluded:  # weight decay 1e-4, then the trust ratio
        g = g + 1e-4 * w
        g = 0.001 * np.linalg.norm(w) / (np.linalg.norm(g) + 1e-9) * g
    # momentum 0.9 over a zero trace: the first step is the gradient
    np.testing.assert_allclose(got, w - 0.1 * g, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("excluded", [False, True])
def test_lamb_first_step_by_hand(excluded):
    w, g, got = _one_leaf_step("lamb", excluded)
    mu, nu = 0.1 * g / 0.1, 0.001 * g * g / 0.001  # bias-corrected
    u = mu / (np.sqrt(nu) + 1e-6)
    if not excluded:  # weight decay 0.01, then the trust ratio
        u = u + 0.01 * w
        u = np.linalg.norm(w) / np.linalg.norm(u) * u
    np.testing.assert_allclose(got, w - 0.1 * u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["lars", "lamb"])
@pytest.mark.parametrize("lr", [0.05, {"schedule": "warmup_cosine",
                                       "peak": 0.05, "warmup_steps": 2,
                                       "decay_steps": 10}])
def test_rules_match_the_jax_transformations(name, lr):
    """5 updates over a tree with excluded leaves: parameters and state,
    and the count after the increment (the JAX rules' convention)."""
    rng = np.random.default_rng(1)
    params = {"d": {"kernel": rng.normal(size=(6, 5)),
                    "bias": rng.normal(size=(5,))},
              "ln": {"gamma": 1 + 0.1 * rng.normal(size=(5,)),
                     "beta": rng.normal(size=(5,))},
              "e": {"embeddings": np.zeros((7, 5))}}  # zero norm: ratio 1
    params = jax.tree_util.tree_map(lambda a: np.float32(a), params)
    names = ["d/kernel", "d/bias", "ln/gamma", "ln/beta", "e/embeddings"]

    def flat(t):
        return [t["d"]["kernel"], t["d"]["bias"], t["ln"]["gamma"],
                t["ln"]["beta"], t["e"]["embeddings"]]

    def tree(ts):
        return {"d": {"kernel": ts[0], "bias": ts[1]},
                "ln": {"gamma": ts[2], "beta": ts[3]},
                "e": {"embeddings": ts[4]}}

    tx = jopt.get(name, lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = optimizers.get(name, lr)
    tp = [torch.tensor(a) for a in flat(params)]
    ts = opt.init(tp, names)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        u, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, u)
        ts = opt.step(tp, [torch.tensor(a) for a in flat(g)], ts)
    _leaves_close(tree(tp), jax.device_get(jp), what=name)
    _leaves_close(opt.optax_state(tp, ts, tree), jax.device_get(js),
                  what=f"{name} state")
    assert int(ts["count"]) == int(js["count"]) == 5


# -- LARS and LAMB through the Estimators -------------------------------------

def _bert_pair(seed=0):
    """A 2-layer BERT classifier from the JAX Estimator's init, in both
    packages, with 40 seeded rows (5 steps of 8)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, BERT_CFG["vocab_size"], (40, SEQ)).astype(np.int32)
    y = rng.integers(0, 3, 40).astype(np.int32)
    jest = JaxEstimator.from_keras(JaxBERTClassifier(3, **BERT_CFG),
                                   loss="sparse_categorical_crossentropy",
                                   optimizer="lamb", learning_rate=1e-3)
    jest._ensure_initialized(jnp.asarray(x[:8]))
    return jest, jest.get_model(), x, y


def _resnet_vars(port, seed):
    from test_torch_image import _random_variables
    return _random_variables(port, seed)


def _jax_from_vars(model, variables, **kw):
    """The JAX Estimator over ``model`` from ``variables``
    (``ZooModel.compile`` after ``_loaded_variables``) with the counter
    its ``_ensure_initialized`` would add."""
    model._loaded_variables = variables
    model.compile(**kw)
    est = model.estimator
    est._ts["bad_steps"] = jnp.zeros((), jnp.int32)
    return est


RESNET = dict(depth=18, class_num=5, width=4)
# the excluded batch-norm leaves take plain momentum steps of lr x their
# gradient, whose rounding noise (percents at a random init) a rate of 0.5
# amplifies past 1e-4 within 4 steps in either package
LARS_LR = 0.01
# LARS's momentum is the sum of the steps' gradients, each of which carries
# that rounding noise at 1e-5 of its largest entry
GRAD_SUM_TOL = 1e-4


def _resnet_data(seed=5, n=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int32))


def _resnet_pair(**kw):
    port = ResNet(**RESNET)
    v = _resnet_vars(port, 6)
    port.load_state_dict(from_jax_variables(v), strict=True)
    jest = _jax_from_vars(JaxResNet(**RESNET), v, **kw)
    test = Estimator.from_keras(port, device="cpu", **kw)
    return jest, test


def test_lamb_bert_and_lars_resnet_fits_match_jax(tmp_path):
    """5 steps of each: loss history, parameters, batch norm's running
    statistics and the optimizer state; then a checkpoint of each package
    resumes in the other for one more epoch."""
    jest, init, x, y = _bert_pair()
    port = BERTClassifier(3, **BERT_CFG)
    port.load_state_dict(from_jax_variables(init), strict=True)
    test = Estimator.from_keras(port, loss="sparse_categorical_crossentropy",
                                optimizer="lamb", learning_rate=1e-3,
                                device="cpu")
    hj = jest.fit((x, y), epochs=1, batch_size=8, verbose=False)
    ht = test.fit((x, y), epochs=1, batch_size=8, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    _leaves_close(test.get_model()["params"], jest.get_model()["params"],
                  what="lamb params")
    _leaves_close(test._optax_state(),
                  jax.device_get(jest._ts["opt_state"]), what="lamb state")
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(init["params"]),
                                jax.tree_util.tree_leaves(
                                    jest.get_model()["params"])))
    assert moved > 1e-4

    # JAX's checkpoint resumes in the port, the port's in JAX
    jest.save(str(tmp_path / "j"))
    test.save(str(tmp_path / "t"))
    port2 = BERTClassifier(3, **BERT_CFG)
    t2 = Estimator.from_keras(port2, loss="sparse_categorical_crossentropy",
                              optimizer="lamb", learning_rate=1e-3,
                              device="cpu")
    t2.load(str(tmp_path / "j"))
    j2 = JaxEstimator.from_keras(JaxBERTClassifier(3, **BERT_CFG),
                                 loss="sparse_categorical_crossentropy",
                                 optimizer="lamb", learning_rate=1e-3)
    j2._ensure_initialized(jnp.asarray(x[:8]))
    j2.load(str(tmp_path / "t"))
    h2t = t2.fit((x, y), epochs=2, batch_size=8, verbose=False)
    h2j = j2.fit((x, y), epochs=2, batch_size=8, verbose=False)
    np.testing.assert_allclose(h2t["loss"], h2j["loss"], rtol=1e-5)
    _leaves_close(t2.get_model()["params"], j2.get_model()["params"],
                  what="resumed lamb params")

    kw = dict(loss="sparse_categorical_crossentropy", optimizer="lars",
              learning_rate=LARS_LR)
    jr, tr = _resnet_pair(**kw)
    xr, yr = _resnet_data(n=40)
    hj = jr.fit((xr, yr), epochs=1, batch_size=8, verbose=False)
    ht = tr.fit((xr, yr), epochs=1, batch_size=8, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    got, want = tr.get_model(), jr.get_model()
    _leaves_close(got["params"], want["params"], what="lars params")
    _leaves_close(got["state"], want["state"], what="lars bn state")
    _leaves_close(tr._optax_state(), jax.device_get(jr._ts["opt_state"]),
                  tol=GRAD_SUM_TOL, what="lars state")


# -- nan_policy ---------------------------------------------------------------

def test_nan_policy_is_validated_and_every_policy_is_taken():
    for policy in NAN_POLICIES:
        Estimator.from_keras(tnn.Dense(2, 2), loss="mse", device="cpu",
                             nan_policy=policy)
    with pytest.raises(ValueError, match="nan_policy"):
        Estimator.from_keras(tnn.Dense(2, 2), loss="mse", device="cpu",
                             nan_policy="explode")


def test_skip_step_matches_jax_and_equals_the_run_without_the_batch():
    """``step.nan`` on step 3 of a LARS ResNet fit (32 rows, 4 steps):
    the port's parameters, running statistics, LARS state and bad_steps
    match the JAX run's; and equal, bit for bit, the port's run on the
    same data with that batch left out."""
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="lars",
              learning_rate=LARS_LR, nan_policy="skip_step")
    jr, tr = _resnet_pair(**kw)
    x, y = _resnet_data()
    with jfaults.get_registry().armed("step.nan", times=1, after=2):
        hj = jr.fit((x, y), epochs=1, batch_size=8, verbose=False)
    with faults_lib.get_registry().armed("step.nan", times=1, after=2):
        ht = tr.fit((x, y), epochs=1, batch_size=8, verbose=False)
    assert ht["bad_steps"] == hj["bad_steps"] == [1]
    assert tr.bad_steps == jr.bad_steps == 1
    assert int(tr._bad_steps) == int(jr._ts["bad_steps"]) == 1
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    got, want = tr.get_model(), jr.get_model()
    for part in ("params", "state"):
        _leaves_close(got[part], want[part], what=part)
        assert all(np.isfinite(a).all() for a in
                   ckpt_io.flatten(got[part])[0])
    _leaves_close(tr._optax_state(), jax.device_get(jr._ts["opt_state"]),
                  tol=GRAD_SUM_TOL, what="lars state")

    # the same data in the same order without the poisoned batch: the
    # feed's epoch-0 order, batch 2 taken out
    from analytics_zoo_tpu_torch.data import as_feed
    order = [b for b in as_feed((x, y), 8, seed=0).epoch(
        torch.device("cpu"), 0)]
    kept = [b for i, b in enumerate(order) if i != 2]
    ref = _resnet_pair(**kw)[1]
    for b in kept:
        ref._train_step(b)
    _trees_equal(ref.get_model(), tr.get_model())
    _trees_equal(ref._optax_state(), tr._optax_state())


def test_skip_step_guards_the_sparse_rows_and_counts_in_the_checkpoint(
        tmp_path):
    """A NeuralCF with ShardedEmbedding tables: a poisoned step moves no
    table row, and the checkpoint's bad_steps is the device counter."""
    from analytics_zoo_tpu_torch.models import NeuralCF
    ncf = dict(user_count=30, item_count=20, class_num=2, user_embed=4,
               item_embed=4, hidden_layers=(8,), mf_embed=4,
               sharded_embeddings=True)
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(0, 30, 32), rng.integers(0, 20, 32)],
                 1).astype(np.int32)
    y = (rng.random(32) < 0.5).astype(np.int32)
    # the ids are integer leaves, which step.nan leaves alone: the loss is
    # made NaN for one step instead
    model = NeuralCF(**ncf)
    est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=1e-2,
                               device="cpu", nan_policy="skip_step",
                               model_dir=str(tmp_path))
    est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    tables = {n: t.detach().clone() for n, t in est._sparse.items()}
    params = [p.detach().clone() for p in est._params]
    batch = {"x": torch.from_numpy(x[:8]), "y": torch.from_numpy(y[:8])}
    orig = est.loss_fn
    est.loss_fn = lambda out, yb: orig(out, yb) * float("nan")
    est._train_step(batch)
    est.loss_fn = orig
    for n, t in est._sparse.items():
        assert torch.equal(t, tables[n]), n
    for a, b in zip(est._params, params):
        assert torch.equal(a, b)
    assert int(est._bad_steps) == 1
    est.save(str(tmp_path))
    assert int(np.asarray(ckpt_io.restore(str(tmp_path))["bad_steps"])) == 1


def _small_fit_setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    init = tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                           tnn.Dense(8, 1)]).state_dict()

    def mkest(**kw):
        model = tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                                tnn.Dense(8, 1)])
        model.load_state_dict(init)
        return Estimator.from_keras(model, loss="mse", learning_rate=1e-3,
                                    device="cpu", **kw)

    return mkest, x, y


def test_nan_policy_warn_counts_and_continues():
    mkest, x, y = _small_fit_setup()
    est = mkest(nan_policy="warn")
    fired = faults_lib.get_registry().fired("step.nan")
    with faults_lib.get_registry().armed("step.nan", times=1, after=1):
        hist = est.fit((x, y), epochs=1, batch_size=32, verbose=False)
    assert est.bad_steps == 1
    assert hist["bad_steps"] == [1]
    assert faults_lib.get_registry().fired("step.nan") - fired == 1
    # warn applies the step: the parameters took the NaN
    assert not all(torch.isfinite(p).all() for p in est.model.parameters())


def test_nan_policy_skip_step_keeps_params_finite():
    mkest, x, y = _small_fit_setup()
    est = mkest(nan_policy="skip_step")
    with faults_lib.get_registry().armed("step.nan", times=1, after=1):
        hist = est.fit((x, y), epochs=1, batch_size=32, verbose=False)
    assert est.bad_steps == 1
    assert hist["bad_steps"] == [1]
    assert np.isfinite(hist["loss"][0])
    assert all(torch.isfinite(p).all() for p in est.model.parameters())


def test_nan_policy_raise_raises_and_dumps_the_flight_record(tmp_path):
    mkest, x, y = _small_fit_setup()
    model_dir = str(tmp_path / "ckpt")
    est = mkest(nan_policy="raise", model_dir=model_dir)
    with faults_lib.get_registry().armed("step.nan", times=1):
        with pytest.raises(NonFiniteLossError, match="non-finite loss"):
            est.fit((x, y), epochs=1, batch_size=32, verbose=False)
    assert est.bad_steps == 1
    path = os.path.join(model_dir, f"flightrec_{os.getpid()}.json")
    dump = json.load(open(path))
    assert dump["reason"] == "train.NonFiniteLossError"
    assert dump["context"]["step"] >= 1


def test_a_gradient_overflow_reads_as_a_nan_loss_to_the_host_policies():
    """A finite loss over a non-finite gradient: the host policies see
    NaN, as the JAX step folds the gradient norm into the loss."""
    mkest, x, y = _small_fit_setup()
    est = mkest(nan_policy="raise")
    orig = est.loss_fn

    def loss(out, yb):  # finite value, infinite gradient
        return orig(out, yb) + (torch.sqrt(out.abs() * 0.0).sum() * 0.0)

    est.loss_fn = loss
    with pytest.raises(NonFiniteLossError):
        est.fit((x, y), epochs=1, batch_size=32, verbose=False)


def test_nan_policy_rollback_recovers_the_pre_nan_checkpoint(tmp_path):
    mkest, x, y = _small_fit_setup()
    clean = mkest().fit((x, y), epochs=2, batch_size=32, verbose=False)
    est = mkest(nan_policy="rollback", model_dir=str(tmp_path / "ckpt"))
    with faults_lib.get_registry().armed("step.nan", times=1, after=2):
        hist = est.fit((x, y), epochs=2, batch_size=32,
                       checkpoint_trigger="every_epoch", verbose=False)
    assert est._rollbacks == 1
    assert est.bad_steps == 1
    assert est._py_step == 4
    np.testing.assert_allclose(hist["loss"], clean["loss"], rtol=1e-6)


def test_nan_policy_rollback_through_the_async_manager(tmp_path):
    mkest, x, y = _small_fit_setup()
    clean = mkest().fit((x, y), epochs=2, batch_size=32, verbose=False)
    est = mkest(nan_policy="rollback", model_dir=str(tmp_path / "ckpt"),
                checkpoint_async=True)
    with faults_lib.get_registry().armed("step.nan", times=1, after=2):
        hist = est.fit((x, y), epochs=2, batch_size=32,
                       checkpoint_trigger="every_epoch", verbose=False)
    assert est._rollbacks == 1
    assert hist["loss"] == clean["loss"]


def test_nan_policy_rollback_without_checkpoint_raises():
    mkest, x, y = _small_fit_setup()
    est = mkest(nan_policy="rollback")
    with faults_lib.get_registry().armed("step.nan", times=1):
        with pytest.raises(NonFiniteLossError, match="no checkpoint"):
            est.fit((x, y), epochs=1, batch_size=32, verbose=False)


def test_nan_policy_rollback_budget_is_bounded(tmp_path):
    mkest, x, y = _small_fit_setup()
    est = mkest(nan_policy="rollback", model_dir=str(tmp_path),
                nan_max_rollbacks=1)
    est.fit((x, y), epochs=1, batch_size=32, verbose=False,
            checkpoint_trigger="every_epoch")
    with faults_lib.get_registry().armed("step.nan"):  # every step
        with pytest.raises(NonFiniteLossError, match="budget"):
            est.fit((x, y), epochs=2, batch_size=32, verbose=False,
                    checkpoint_trigger="every_epoch")
    assert est._rollbacks == 2


# -- fault seams --------------------------------------------------------------

def test_step_nan_is_hit_once_a_step_and_disarmed_changes_nothing():
    mkest, x, y = _small_fit_setup()
    reg = faults_lib.get_registry()
    before, fired = reg.hits("step.nan"), reg.fired("step.nan")
    a = mkest().fit((x, y), epochs=1, batch_size=32, verbose=False)
    assert reg.hits("step.nan") - before == 2
    assert reg.fired("step.nan") == fired
    b = mkest().fit((x, y), epochs=1, batch_size=32, verbose=False)
    assert a == b


def test_poison_batch_fills_floats_and_passes_integers():
    batch = {"x": (torch.ones(2, 3), torch.arange(4, dtype=torch.int32)),
             "y": np.zeros(2, np.float32)}
    out = est_lib._poison_batch(batch)
    assert torch.isnan(out["x"][0]).all()
    assert torch.equal(out["x"][1], batch["x"][1])
    assert np.isnan(out["y"]).all()
    assert out["x"][0].shape == (2, 3) and out["x"][0].dtype == torch.float32


def test_worker_hang_delays_a_step():
    import time
    mkest, x, y = _small_fit_setup()
    est = mkest()
    with faults_lib.get_registry().armed("worker.hang", times=1, delay=0.3):
        t0 = time.monotonic()
        est.fit((x, y), epochs=1, batch_size=32, verbose=False)
        assert time.monotonic() - t0 >= 0.3
    assert faults_lib.get_registry().fired("worker.hang") == 1


def test_worker_crash_exits_the_process(tmp_path):
    import subprocess
    import sys
    code = (
        "import numpy as np\n"
        "from analytics_zoo_tpu_torch import nn\n"
        "from analytics_zoo_tpu_torch.core import faults\n"
        "from analytics_zoo_tpu_torch.orca.learn import Estimator\n"
        "est = Estimator.from_keras(nn.Dense(4, 1), loss='mse', "
        "device='cpu')\n"
        "faults.get_registry().enable('worker.crash', times=1, after=1)\n"
        "x = np.ones((64, 4), np.float32)\n"
        "est.fit((x, x[:, :1]), epochs=1, batch_size=32, verbose=False)\n"
        "print('survived')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": repo},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr[-2000:]
    assert "survived" not in out.stdout


# -- profile= -----------------------------------------------------------------

def test_step_profiler_mfu_compiles_trace_and_fit_span_tree(
        tmp_path, monkeypatch):
    """The JAX test's twin: compile events, MFU and the span tree; the
    MFU at the "cpu" nominal peak equals the JAX estimator's formula on
    the port's own throughput; the trace window writes a Chrome trace."""
    mkest, x, y = _small_fit_setup()
    x2, y2 = np.concatenate([x, x]), np.concatenate([y, y])
    est = mkest(profile={"flops_per_sample": 1e6,
                         "trace_dir": str(tmp_path / "trace"),
                         "trace_steps": (1, 3)})
    est.fit((x2, y2), epochs=2, batch_size=32, verbose=False)
    snap = metrics_lib.get_registry().snapshot()
    assert snap["train.compiles"] == est.compile_count == 1
    mfu = snap["train.mfu"]["value"]
    assert mfu > 0 and snap["train.mfu"]["max"] >= mfu
    (root,) = trace_lib.tree(est.trace_id)
    assert root.name == "train.fit"
    epochs = [c for c in root.children if c.name == "train.epoch"]
    assert len(epochs) == 2
    for ep in epochs:
        steps = [c for c in ep.children if c.name == "train.step"]
        assert len(steps) == 4
        assert all("data_wait_ms" in s.record.stages for s in steps)
    assert len(root.find("train.compile")) == 1
    (path,) = est.trace_files
    assert os.path.dirname(path) == str(tmp_path / "trace")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    # a second fit on the same key compiles nothing more
    est.fit((x2, y2), epochs=1, batch_size=32, verbose=False)
    assert est.compile_count == 1

    # train.mfu: flops_per_sample x samples/s / peak, the peak from the
    # profile dict, then ZooConfig, then the nominal table, as in JAX
    assert est._measure_mfu(1000.0) == pytest.approx(
        1e6 * 1000.0 / est_lib.NOMINAL_PEAK_FLOPS["cpu"])
    init_orca_context("local", config=JaxZooConfig())
    jest = JaxEstimator.from_keras(
        jnn.Sequential([jnn.Dense(1)]), loss="mse",
        profile={"flops_per_sample": 1e6})
    # the JAX package divides by its devices (8 on the CPU mesh), the port
    # runs on one
    assert est._measure_mfu(1000.0) == pytest.approx(
        jest._measure_mfu(1000.0) * jax.device_count())
    monkeypatch.setattr(ZooConfig, "device_peak_flops", 1e9)
    assert est._measure_mfu(1000.0) == pytest.approx(1.0)
    est._profile_cfg["peak_flops"] = 2e9
    assert est._measure_mfu(1000.0) == pytest.approx(0.5)


def test_nominal_peak_is_the_cards_by_compute_dtype(monkeypatch):
    """Without a configured peak, the card's comes from its name and the
    model's compute dtype; a card the table does not list gives no peak,
    and then no ``train.mfu``."""
    cuda = torch.device("cuda", 0)
    peak = est_lib.nominal_peak_flops
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert peak(cuda, torch.bfloat16) == 989e12
    assert peak(cuda, torch.float32) == 67e12
    assert peak(cuda, torch.float64) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert peak(cuda, torch.bfloat16) is None
    assert peak(torch.device("cpu"), torch.bfloat16) == 5e10
    assert est_lib._compute_dtype(
        ResNet(**dict(RESNET, dtype="bfloat16"))) == torch.bfloat16
    assert est_lib._compute_dtype(tnn.Dense(2, 3)) == torch.float32
    mkest, _, _ = _small_fit_setup()
    est = mkest(profile={"flops_per_sample": 1e6})
    assert est._measure_mfu(1000.0) == pytest.approx(1e6 * 1000.0 / 5e10)
    monkeypatch.setattr(est_lib, "nominal_peak_flops", lambda d, t: None)
    assert est._measure_mfu(1000.0) is None


def test_profile_dir_and_steps_constructor_knobs(tmp_path):
    mkest, x, y = _small_fit_setup()
    est = mkest(profile_dir=str(tmp_path), profile_steps=(0, 1))
    est.fit((x, y), epochs=1, batch_size=32, verbose=False)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert files == est.trace_files and len(files) == 1
    assert "steps0-1" in os.path.basename(files[0])
    # no profile= dict: no compile or MFU series
    snap = metrics_lib.get_registry().snapshot()
    assert snap.get("train.compiles", 0) == 0


def test_profiler_off_registers_no_profiler_series():
    mkest, x, y = _small_fit_setup()
    mkest().fit((x, y), epochs=1, batch_size=32, verbose=False)
    snap = metrics_lib.get_registry().snapshot()
    # the series may linger, zeroed, from another test's handles on the
    # process-wide registry: an unprofiled fit never moves them
    assert snap.get("train.mfu", {"value": 0})["value"] == 0
    assert snap.get("train.compiles", 0) == 0


# -- log_dir summaries ----------------------------------------------------------

def test_summaries_have_the_jax_tags_and_epochs(tmp_path):
    mkest, x, y = _small_fit_setup()
    est = mkest(log_dir=str(tmp_path / "t"), app_name="job",
                nan_policy="skip_step")
    est.fit((x, y), epochs=2, batch_size=32, verbose=False,
            validation_data=(x, y))
    init_orca_context("local")
    jest = JaxEstimator.from_keras(
        jnn.Sequential([jnn.Dense(8, activation="relu"), jnn.Dense(1)]),
        loss="mse", learning_rate=1e-3, log_dir=str(tmp_path / "j"),
        app_name="job", nan_policy="skip_step")
    jest.fit((x, y), epochs=2, batch_size=32, verbose=False,
             validation_data=(x, y))

    def tags(d):
        recs = [json.loads(line) for line in
                open(os.path.join(d, "job", "scalars.jsonl"))]
        return sorted({(r["tag"], r["step"]) for r in recs})

    assert tags(str(tmp_path / "t")) == tags(str(tmp_path / "j"))
    loss = est.get_train_summary("loss")
    assert [s for s, _ in loss] == [1, 2]
    assert est.get_validation_summary("loss") == \
        est.get_train_summary("val_loss")
    assert [s for s, _ in est.get_validation_summary("loss")] == [1, 2]
    with pytest.raises(ValueError, match="log_dir"):
        mkest().get_train_summary()


# -- segment ids ----------------------------------------------------------------

class _JaxSegClassifier(jnn.Module):
    def __init__(self):
        super().__init__()
        self.bert = JaxBERT(**BERT_CFG)

    def forward(self, scope, x):
        ids, seg = x
        h = scope.child(self.bert, ids, seg, name="bert")
        return scope.child(jnn.Dense(3), h[:, 0], name="head")


class _SegClassifier(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bert = BERT(segments=True, **BERT_CFG)
        self.head = tnn.Dense(BERT_CFG["hidden_size"], 3)

    def forward(self, x):
        ids, seg = x
        return self.head(self.bert(ids, seg)[:, 0])


def test_bert_fit_with_segment_ids_matches_jax():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, BERT_CFG["vocab_size"], (32, SEQ)).astype(np.int32)
    seg = (np.arange(SEQ)[None] >= rng.integers(4, 12, (32, 1))).astype(
        np.int32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    data = {"x": (ids, seg), "y": y}
    jest = JaxEstimator.from_keras(_JaxSegClassifier(),
                                   loss="sparse_categorical_crossentropy",
                                   optimizer="adamw", learning_rate=1e-3)
    jest._ensure_initialized((jnp.asarray(ids[:8]), jnp.asarray(seg[:8])))
    init = jest.get_model()
    assert "seg_embed" in init["params"]["bert"]
    port = _SegClassifier()
    port.load_state_dict(from_jax_variables(init), strict=True)
    test = Estimator.from_keras(port, loss="sparse_categorical_crossentropy",
                                optimizer="adamw", learning_rate=1e-3,
                                device="cpu")
    hj = jest.fit(data, epochs=2, batch_size=8, verbose=False)
    ht = test.fit(data, epochs=2, batch_size=8, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    _leaves_close(test.get_model()["params"], jest.get_model()["params"],
                  tol=1e-4, what="segment BERT")


# -- chip_smoke's phase ---------------------------------------------------------

def test_chip_smoke_train_knobs_phase_runs_on_the_cpu_at_tiny_sizes():
    """``chip_smoke.py``'s train_knobs phase end to end through its CPU
    seam (``TrainKnobsSizes(device="cpu")``, tiny widths; the kernel
    wrappers take their plain versions): the poisoned run equals the run
    without its batch, the rollback equals the checkpoint, raise dumps the
    flight record, the trace and the summaries are written."""
    import importlib
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    sizes = chip_smoke.TrainKnobsSizes(
        device="cpu", mlm=dict(vocab=64, d_model=32, heads=4, layers=2),
        seq=16, micro=2, accum=2, chunk=16, mlm_steps=2, window=2,
        resnet=dict(depth=18, class_num=5, width=4, stem="space_to_depth",
                    norm="batch", dtype="float32"),
        image=32, batch=8, resnet_steps=4, poison=2, bn_map=(64, 8))
    mods = [importlib.import_module(f"analytics_zoo_tpu_torch.ops.{m}")
            for m in ("flash_attention", "fused_bn", "fused_xent")]
    res = chip_smoke.phase_train_knobs(*mods, sizes)
    assert res["mlm_lamb"]["bad_steps"] == 0
    assert res["resnet_lars"]["bad_steps"] == 1
    assert res["resnet_lars"]["leaves_equal_bit_for_bit"] > 0
    assert res["rollback_raise"]["rollback"]["leaves_equal_checkpoint"] > 0
    assert set(res["nan_propagation"]) >= {"flash_fwd", "flash_bwd",
                                           "bn_fwd", "bn_bwd", "xent_fwd",
                                           "xent_bwd"}
    assert res["profile_summaries"]["compiles"] == 1
    assert all(v == 0 for v in res["kernel_launches"].values())
