"""Transfer learning in the port against the JAX package: the taps
(``nn.module.apply_with_taps``), ``GraphNet``, the Estimator's ``frozen=``
and ``autograd.CustomLoss`` (the twins of ``tests/test_transfer.py``).

Each JAX model gets its initial weights from the JAX Estimator
(``_ensure_initialized``) and the port's the same through
``convert.from_jax_variables``; fits are then held at 1e-5 of the loss, and
frozen parameters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu import autograd as JA
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.models import GraphNet as JaxGraphNet
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import autograd as A
from analytics_zoo_tpu_torch import nn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.models import GraphNet
from analytics_zoo_tpu_torch.nn.module import apply_with_taps, param_count
from analytics_zoo_tpu_torch.orca.learn import Estimator

LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    yield


class BackboneHead(torch.nn.Module):
    """``tests/test_transfer.py``'s model: ``backbone`` Dense(16, relu),
    ``head`` Dense(2)."""

    def __init__(self, d_in=8, names=("backbone", "head"), out=2):
        super().__init__()
        self.names = names
        self.add_module(names[0], nn.Dense(d_in, 16, activation="relu"))
        self.add_module(names[1], nn.Dense(16, out))

    def forward(self, x):
        return getattr(self, self.names[1])(getattr(self, self.names[0])(x))


def _jax_backbone_head(names=("backbone", "head"), out=2):
    class Model(jnn.Module):
        def forward(self, scope, x):
            h = scope.child(jnn.Dense(16, activation="relu"), x,
                            name=names[0])
            return scope.child(jnn.Dense(out), h, name=names[1])
    return Model()


def _twins(x, names=("backbone", "head"), out=2, **kw):
    """The JAX and the port estimator over the same initial weights."""
    jest = JaxEstimator.from_keras(_jax_backbone_head(names, out), **kw)
    jest._ensure_initialized(jnp.asarray(x[:1]))
    model = BackboneHead(x.shape[1], names, out)
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    return jest, Estimator.from_keras(model, device="cpu", **kw)


def _params(est):
    return est.get_model()["params"]


# -- frozen= --------------------------------------------------------------

def test_frozen_params_do_not_move():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.int32)
    jest, est = _twins(x, loss=LOSS, optimizer="adamw", learning_rate=5e-2,
                       frozen=["backbone"])
    before = _params(est)
    hist = est.fit((x, y), epochs=2, batch_size=32, verbose=False)
    jhist = jest.fit((x, y), epochs=2, batch_size=32, verbose=False)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    after = _params(est)
    # frozen: bit for bit, adamw's decay included; the head trained
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(after["backbone"][leaf],
                                      before["backbone"][leaf])
    assert not np.allclose(after["head"]["kernel"], before["head"]["kernel"])
    jp = jax.device_get(jest._ts["params"])
    np.testing.assert_allclose(after["head"]["kernel"],
                               jp["head"]["kernel"], atol=1e-5)
    # the optimizer saw the head only
    assert est._dense_names == ["head.kernel", "head.bias"]


def test_frozen_survives_save_load(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    _, est = _twins(x, loss=LOSS, frozen=["backbone"])
    est.fit((x, y), epochs=1, batch_size=16, verbose=False)
    d = str(tmp_path / "ck")
    est.save(d)
    _, est2 = _twins(x, loss=LOSS, frozen=["backbone"])
    est2.load(d)
    before = _params(est2)
    np.testing.assert_array_equal(before["backbone"]["kernel"],
                                  _params(est)["backbone"]["kernel"])
    est2.fit((x, y), epochs=1, batch_size=16, verbose=False)
    np.testing.assert_array_equal(_params(est2)["backbone"]["kernel"],
                                  before["backbone"]["kernel"])


def test_frozen_prefix_matches_component_boundaries():
    """``frozen=["enc"]`` leaves the sibling ``enc_head`` trainable."""
    x = np.random.default_rng(0).normal(size=(16, 3)).astype("float32")
    y = np.random.default_rng(1).normal(size=(16, 2)).astype("float32")
    jest, est = _twins(x, names=("enc", "enc_head"), loss="mse",
                       optimizer="sgd", learning_rate=0.5, frozen=["enc"])
    before = _params(est)
    hist = est.fit((x, y), epochs=2, batch_size=8, verbose=False)
    jhist = jest.fit((x, y), epochs=2, batch_size=8, verbose=False)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    got = _params(est)
    np.testing.assert_array_equal(got["enc"]["kernel"],
                                  before["enc"]["kernel"])
    assert np.abs(got["enc_head"]["kernel"]
                  - before["enc_head"]["kernel"]).max() > 1e-6
    pred = Estimator.from_keras(BackboneHead(), loss="mse", device="cpu",
                                frozen=lambda p: p.endswith("bias"))
    assert pred._frozen_names == {"backbone.bias", "head.bias"}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frozen_checkpoint_read_by_the_other_package(tmp_path, direction):
    """A frozen estimator's checkpoint (adam: optax.multi_transform's
    state tree) loads in the other package, weights and moments equal,
    and the next step's loss agrees at 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    kw = dict(loss=LOSS, optimizer="adam", learning_rate=1e-2,
              frozen=["backbone"])
    jest, est = _twins(x, **kw)
    d = str(tmp_path / "ck")
    if direction == "port_to_jax":
        est.fit((x, y), epochs=1, batch_size=16, verbose=False)
        est.save(d)
        src, dst = est, JaxEstimator.from_keras(_jax_backbone_head(), **kw)
        dst._ensure_initialized(jnp.asarray(x[:1]))
        dst.load(d)
        dst_opt = jax.device_get(dst._ts["opt_state"])
    else:
        jest.fit((x, y), epochs=1, batch_size=16, verbose=False)
        jest.save(d)
        src, dst = jest, _twins(x, **kw)[1]
        dst.load(d)
    for leaf in ("kernel", "bias"):
        for part in ("backbone", "head"):
            np.testing.assert_array_equal(
                np.asarray(dst.get_model()["params"][part][leaf]),
                np.asarray(src.get_model()["params"][part][leaf]))
    if direction == "port_to_jax":
        # MultiTransformState(inner_states={"freeze": ..., "train":
        # MaskedState(adam's)}): the head's moments are the port's
        mu = dst_opt.inner_states["train"].inner_state[0].mu
        live = est._optax_state()[0]["train"][0][0][1]
        np.testing.assert_array_equal(np.asarray(mu["head"]["kernel"]),
                                      live["head"]["kernel"].numpy())
    a = src.fit((x, y), epochs=1, batch_size=16, verbose=False)["loss"]
    b = dst.fit((x, y), epochs=1, batch_size=16, verbose=False)["loss"]
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_frozen_batch_norm_statistics_still_update():
    """Frozen parameters stay; running statistics are state and move."""
    model = nn.Sequential([("bn", nn.BatchNormalization(4)),
                           ("head", nn.Dense(4, 2))])
    x = np.random.default_rng(3).normal(2.0, 1.0, (32, 4)).astype("float32")
    y = np.random.default_rng(4).integers(0, 2, 32).astype(np.int32)
    est = Estimator.from_keras(model, loss=LOSS, device="cpu",
                               frozen=["bn"], learning_rate=0.1,
                               optimizer="sgd")
    gamma = model.bn.gamma.detach().clone()
    est.fit((x, y), epochs=1, batch_size=16, verbose=False)
    assert torch.equal(model.bn.gamma, gamma)
    assert float(model.bn.mean.abs().max()) > 0.0


# -- taps and GraphNet ----------------------------------------------------

def test_apply_with_taps_records_all_paths():
    model = nn.Sequential([("a", nn.Dense(5, 4)), ("b", nn.Dense(4, 3))])
    x = torch.ones(2, 5)
    out, taps = apply_with_taps(model, x)
    assert sorted(taps) == ["a", "b"]
    assert taps["a"].shape == (2, 4)
    assert torch.equal(out, taps["b"])
    # the JAX package's keys on the same model
    jmodel = jnn.Sequential([jnn.Dense(4, name="a"), jnn.Dense(3, name="b")])
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.ones((2, 5)))
    _, _, jtaps = jmodel.apply_with_taps(variables, jnp.ones((2, 5)))
    assert sorted(jtaps) == sorted(taps)


def test_apply_with_taps_leaves_no_hook_behind():
    class Boom(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("boom")

    model = nn.Sequential([("a", nn.Dense(3, 3)), ("b", Boom())])
    with pytest.raises(RuntimeError, match="boom"):
        apply_with_taps(model, torch.ones(1, 3))
    assert all(not m._forward_hooks for m in model.modules())
    apply_with_taps(model.a, torch.ones(1, 3))
    assert not model.a._forward_hooks


def test_graphnet_feature_extraction_shares_weights():
    """At top level a GraphNet's tree is the base's: the JAX base's
    variables load into it, and its output is the JAX GraphNet's."""
    x = np.random.default_rng(5).normal(size=(2, 8)).astype(np.float32)
    jbase = _jax_backbone_head()
    variables = jbase.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jout, _ = JaxGraphNet(jbase, ["backbone"]).apply(variables, x)
    base = BackboneHead()
    feat = GraphNet(base, ["backbone"])
    assert list(feat.state_dict()) == list(base.state_dict())
    assert [n for n, _ in feat.named_parameters()] == \
        [n for n, _ in base.named_parameters()]
    feat.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        out = feat(torch.as_tensor(x))
        _, taps = apply_with_taps(base, torch.as_tensor(x))
    assert out.shape == (2, 16)
    assert torch.equal(out, taps["backbone"])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    assert param_count(feat) == param_count(variables) == 8 * 16 + 16 + 34


def test_graphnet_selects_by_suffix_and_raises_when_absent():
    base = nn.Sequential([("enc", BackboneHead()), ("out", nn.Dense(2, 2))])
    two = GraphNet(base, ["backbone", "enc/head"])
    a, b = two(torch.ones(3, 8))
    assert a.shape == (3, 16) and b.shape == (3, 2)
    with pytest.raises(KeyError, match="no submodule output"):
        GraphNet(base, ["nowhere"])(torch.ones(3, 8))


def test_graphnet_embedded_in_new_model_trains_new_head():
    """Embedded, the base sits under ``base``: the JAX FineTune's tree
    loads into the port's, and ``frozen=["feats"]`` fits agree."""
    jbase = _jax_backbone_head()

    class JaxFineTune(jnn.Module):
        def forward(self, scope, x):
            feats = scope.child(JaxGraphNet(jbase, ["backbone"]), x,
                                name="feats")
            return scope.child(jnn.Dense(3), feats, name="new_head")

    class FineTune(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.feats = GraphNet(BackboneHead(), ["backbone"])
            self.new_head = nn.Dense(16, 3)

        def forward(self, x):
            return self.new_head(self.feats(x))

    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    jest = JaxEstimator.from_keras(JaxFineTune(), loss=LOSS,
                                   frozen=["feats"])
    jest._ensure_initialized(jnp.asarray(x[:1]))
    model = FineTune()
    assert "feats.base.backbone.kernel" in model.state_dict()
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(model, loss=LOSS, frozen=["feats"],
                               device="cpu")
    hist = est.fit((x, y), epochs=2, batch_size=16, verbose=False)
    jhist = jest.fit((x, y), epochs=2, batch_size=16, verbose=False)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    assert est.predict(x, batch_size=16).shape == (32, 3)


# -- CustomLoss and the autograd surface ----------------------------------

def test_custom_loss_autograd_surface():
    loss = A.CustomLoss(
        lambda y_true, y_pred: A.mean(A.square(y_true - y_pred), axis=-1))
    jloss = JA.CustomLoss(
        lambda y_true, y_pred: JA.mean(JA.square(y_true - y_pred), axis=-1))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = rng.normal(size=(32, 1)).astype(np.float32)
    jest = JaxEstimator.from_keras(jnn.Sequential([jnn.Dense(1)]),
                                   loss=jloss, learning_rate=5e-2)
    jest._ensure_initialized(jnp.asarray(x[:1]))
    model = nn.Sequential([nn.Dense(4, 1)])
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(model, loss=loss, learning_rate=5e-2,
                               device="cpu")
    hist = est.fit((x, y), epochs=3, batch_size=16, verbose=False)
    jhist = jest.fit((x, y), epochs=3, batch_size=16, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    v = torch.tensor([-2.0, 3.0])
    np.testing.assert_allclose(A.l2_normalize(v).numpy(),
                               np.asarray(JA.l2_normalize(jnp.asarray(v))),
                               rtol=1e-6)
    a, b = np.ones((2, 3, 4), np.float32), np.ones((2, 4, 5), np.float32)
    np.testing.assert_allclose(
        A.batch_dot(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(JA.batch_dot(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("name,args,kwargs", [
    ("sum", (), {"axis": -1}), ("mean", (), {"axis": (0, 1),
                                            "keepdims": True}),
    ("square", (), {}), ("sqrt", (), {}), ("exp", (), {}), ("log", (), {}),
    ("abs", (), {}), ("neg", (), {}), ("softsign", (), {}),
    ("softplus", (), {}), ("clip", (0.2, 0.7), {}), ("pow", (3,), {}),
    ("expand_dims", (), {"axis": 1}), ("l2_normalize", (), {"axis": 0}),
    ("maximum", (0.5,), {}), ("minimum", (0.5,), {}),
    ("contiguous", (), {}), ("squeeze", (), {"axis": 1})])
def test_autograd_functions_match_jax(name, args, kwargs):
    x = np.random.default_rng(6).uniform(0.1, 1.0, (3, 4)).astype("float32")
    if name == "squeeze":
        x = x[:, None]
    want = getattr(JA, name)(jnp.asarray(x), *args, **kwargs)
    got = getattr(A, name)(torch.as_tensor(x), *args, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_custom_loss_forward_keeps_the_graph():
    loss = A.CustomLoss(lambda y_true, y_pred: (y_pred - y_true) ** 2)
    p = torch.ones(4, 2, requires_grad=True)
    out = loss.forward(torch.zeros(4, 2), p)
    assert float(out.detach()) == pytest.approx(1.0)
    (g,) = torch.autograd.grad(out, p)
    assert torch.allclose(g, torch.full((4, 2), 0.25))
