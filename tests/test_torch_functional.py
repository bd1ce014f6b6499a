"""The functional Model API and ``keras2`` in the port against the JAX
package (the twins of ``tests/test_functional.py``).

Each graph is built in both packages with the same layers; the JAX
``Model.init`` tree loads into the port's ``Model`` with
``load_state_dict(strict=True)`` (so the node names agree), and the
outputs on one seeded input agree at 1e-6 (1e-5 for a trained fit's
losses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.keras2 as jkeras2
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import keras2, nn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.nn.module import apply_with_taps
from analytics_zoo_tpu_torch.orca.learn import Estimator


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    yield


def named(layer, name):
    layer.name = name
    return layer


def _load_and_run(model, jmodel, *xs):
    """The JAX model's init tree into the port's model, both outputs."""
    jx = [jnp.asarray(x) for x in xs]
    variables = jmodel.init(jax.random.PRNGKey(0), *jx)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    jout, _ = jmodel.apply(variables, *jx)
    with torch.no_grad():
        out = model(*(torch.as_tensor(x) for x in xs))
    return out, jout, variables


def _close(a, b, tol=1e-6):
    if isinstance(a, torch.Tensor):
        a = a.detach()
    if isinstance(b, torch.Tensor):
        b = b.detach()
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_single_input_graph_matches_sequential():
    inp = nn.Input((8,))
    h = named(nn.Dense(8, 16, activation="relu"), "d1")(inp)
    model = nn.Model(inp, named(nn.Dense(16, 2), "d2")(h))
    jinp = jnn.Input((8,))
    jh = jnn.Dense(16, activation="relu", name="d1")(jinp)
    jmodel = jnn.Model(jinp, jnn.Dense(2, name="d2")(jh))
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    out, jout, variables = _load_and_run(model, jmodel, x)
    assert set(variables["params"]) == {"d1", "d2"}
    assert [n for n, _ in model.named_children()] == ["d1", "d2"]
    assert out.shape == (4, 2)
    _close(out, jout)
    seq = nn.Sequential([("d1", model.d1), ("d2", model.d2)])
    with torch.no_grad():
        _close(out, seq(torch.as_tensor(x)))


def test_multi_input_two_tower():
    user, item = nn.Input((6,)), nn.Input((5,))
    merged = nn.Concatenate()([nn.Dense(6, 8, activation="relu")(user),
                               nn.Dense(5, 8, activation="relu")(item)])
    model = nn.Model([user, item], nn.Dense(16, 1)(merged))
    ju, ji = jnn.Input((6,)), jnn.Input((5,))
    jm = jnn.Concatenate()([jnn.Dense(8, activation="relu")(ju),
                            jnn.Dense(8, activation="relu")(ji)])
    jmodel = jnn.Model([ju, ji], jnn.Dense(1)(jm))
    rng = np.random.default_rng(1)
    xu = rng.normal(size=(4, 6)).astype(np.float32)
    xi = rng.normal(size=(4, 5)).astype(np.float32)
    out, jout, variables = _load_and_run(model, jmodel, xu, xi)
    assert sorted(k for k, v in variables["params"].items() if v) == \
        ["dense", "dense_1", "dense_2"]
    _close(out, jout)
    with torch.no_grad():  # one list of inputs works too
        _close(model([torch.as_tensor(xu), torch.as_tensor(xi)]), out)


def test_shared_layer_weights():
    shared = named(nn.Dense(3, 4, use_bias=False), "shared")
    a, b = nn.Input((3,)), nn.Input((3,))
    model = nn.Model([a, b], nn.Add()([shared(a), shared(b)]))
    assert list(model.state_dict()) == ["shared.kernel"]
    jshared = jnn.Dense(4, use_bias=False, name="shared")
    ja, jb = jnn.Input((3,)), jnn.Input((3,))
    jmodel = jnn.Model([ja, jb], jnn.Add()([jshared(ja), jshared(jb)]))
    xa, xb = np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)
    out, jout, _ = _load_and_run(model, jmodel, xa, xb)
    _close(out, jout)
    _close(out, torch.as_tensor(xa) @ shared.kernel.detach())


def test_multi_output_graph():
    inp = nn.Input((4,))
    h = nn.Dense(4, 8, activation="relu")(inp)
    model = nn.Model(inp, [named(nn.Dense(8, 2), "head_a")(h),
                           named(nn.Dense(8, 3), "head_b")(h)])
    jinp = jnn.Input((4,))
    jh = jnn.Dense(8, activation="relu")(jinp)
    jmodel = jnn.Model(jinp, [jnn.Dense(2, name="head_a")(jh),
                              jnn.Dense(3, name="head_b")(jh)])
    (ya, yb), (ja, jb), _ = _load_and_run(model, jmodel,
                                          np.ones((2, 4), np.float32))
    assert ya.shape == (2, 2) and yb.shape == (2, 3)
    _close(ya, ja)
    _close(yb, jb)


def test_symbolic_arithmetic_residual():
    inp = nn.Input((6,))
    h = named(nn.Dense(6, 6), "res")(inp)
    model = nn.Model(inp, h + inp)
    jinp = jnn.Input((6,))
    jmodel = jnn.Model(jinp, jnn.Dense(6, name="res")(jinp) + jinp)
    x = np.ones((2, 6), np.float32)
    out, jout, _ = _load_and_run(model, jmodel, x)
    _close(out, jout)
    with torch.no_grad():
        _, taps = apply_with_taps(model, torch.as_tensor(x))
    _close(out, taps["res"] + torch.as_tensor(x))
    assert "add" in taps


def test_functional_model_trains_in_estimator():
    inp = nn.Input((8,))
    model = nn.Model(inp, nn.Dense(16, 2)(
        nn.Dense(8, 16, activation="relu")(inp)))
    jinp = jnn.Input((8,))
    jmodel = jnn.Model(jinp, jnn.Dense(2)(jnn.Dense(16,
                                                    activation="relu")(jinp)))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    kw = dict(loss="sparse_categorical_crossentropy", learning_rate=5e-2,
              metrics=["accuracy"])
    jest = JaxEstimator.from_keras(jmodel, **kw)
    jest._ensure_initialized(jnp.asarray(x[:1]))
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(model, device="cpu", **kw)
    hist = est.fit((x, y), epochs=5, batch_size=16, verbose=False)
    jhist = jest.fit((x, y), epochs=5, batch_size=16, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    assert est.evaluate((x, y), batch_size=16)["accuracy"] > 0.8


def test_reflected_operators():
    inp = nn.Input((4,))
    gate = named(nn.Dense(4, 4), "g")(inp)
    model = nn.Model(inp, 1.0 - gate)
    jinp = jnn.Input((4,))
    jmodel = jnn.Model(jinp, 1.0 - jnn.Dense(4, name="g")(jinp))
    x = np.random.default_rng(3).normal(size=(2, 4)).astype(np.float32)
    out, jout, _ = _load_and_run(model, jmodel, x)
    _close(out, jout)
    with torch.no_grad():
        _, taps = apply_with_taps(model, torch.as_tensor(x))
    _close(out, 1.0 - taps["g"])
    for expr in (2 * gate, 1.0 + gate, gate * 3.0, gate - 1.0, gate * gate):
        with torch.no_grad():
            assert nn.Model(inp, expr)(torch.as_tensor(x)).shape == (2, 4)


def test_same_base_name_numbers_the_next_layer():
    """Two different layers with one name take ``h`` and ``h_1`` (the JAX
    ``Model``'s numbering); one layer called twice keeps one name."""
    inp = nn.Input((3,))
    h = named(nn.Dense(3, 4), "h")(inp)
    model = nn.Model(inp, named(nn.Dense(4, 8), "h")(h))
    jinp = jnn.Input((3,))
    jmodel = jnn.Model(jinp, jnn.Dense(8, name="h")(
        jnn.Dense(4, name="h")(jinp)))
    out, jout, variables = _load_and_run(model, jmodel,
                                         np.ones((2, 3), np.float32))
    assert sorted(k for k, v in variables["params"].items() if v) == \
        ["h", "h_1"]
    _close(out, jout)


def test_shared_layer_taps_keep_both_applications():
    shared = named(nn.Dense(3, 4, use_bias=False), "shared")
    a, b = nn.Input((3,)), nn.Input((3,))
    model = nn.Model([a, b], nn.Add()([shared(a), shared(b)]))
    with torch.no_grad():
        _, taps = apply_with_taps(model, torch.ones(2, 3), torch.zeros(2, 3))
    keys = sorted(k for k in taps if k.startswith("shared"))
    assert keys == ["shared", "shared#1"]
    vals = sorted(float(taps[k].abs().sum()) for k in keys)
    assert vals[0] == 0.0 and vals[1] > 0.0


def test_unlisted_input_raises():
    a, b = nn.Input((3,)), nn.Input((3,))
    out = nn.Add()([nn.Dense(3, 2)(a), nn.Dense(3, 2)(b)])
    with pytest.raises(ValueError, match="not in"):
        nn.Model(a, out)


def test_symbolic_shapes_and_modes():
    """A symbolic call propagates shapes on meta tensors, draws no dropout
    mask, moves no running statistic and leaves every mode as it was; an
    ordinary call after it computes as usual."""
    inp = nn.Input((8, 8, 3))
    conv = nn.Conv2D(3, 4, 3, strides=2)
    bn = nn.BatchNormalization(4)
    drop = nn.Dropout(0.5)
    h = drop(bn(conv(inp)))
    assert isinstance(h, nn.SymbolicTensor)
    assert tuple(h.shape) == (1, 4, 4, 4)
    assert bn.training and drop.training and drop.generator is None
    assert float(bn.mean.abs().sum()) == 0.0
    flat = nn.Flatten()(h)
    assert tuple(flat.shape) == (1, 64)
    model = nn.Model(inp, nn.Dense(64, 2)(flat))
    model.eval()
    with torch.no_grad():
        assert model(torch.randn(5, 8, 8, 3)).shape == (5, 2)
    with torch.no_grad():  # outside any graph the layers are ordinary
        assert not isinstance(conv(torch.randn(1, 8, 8, 3)),
                              nn.SymbolicTensor)


def test_models_nest_and_merge_records_a_node():
    inner_in = nn.Input((4,))
    inner = nn.Model(inner_in, nn.Dense(4, 4, activation="tanh")(inner_in))
    inp = nn.Input((4,))
    out = nn.merge([inner(inp), inp], mode="concat")
    model = nn.Model(inp, out)
    assert [n for n, _ in model.named_children()] == ["model", "merge"]
    assert list(model.state_dict()) == ["model.dense.kernel",
                                        "model.dense.bias"]
    with torch.no_grad():
        assert model(torch.ones(2, 4)).shape == (2, 8)


def test_keras2_namespace_is_the_ports_nn():
    assert set(keras2.layers.__all__) == set(nn.__all__)
    assert set(jkeras2.layers.__all__) - set(keras2.layers.__all__) == \
        {"Module", "Scope"}
    assert keras2.models.Model is nn.Model
    assert keras2.models.Sequential is nn.Sequential
    assert keras2.models.Input is nn.Input
    assert keras2.layers.Conv2D is nn.Conv2D
    inp = keras2.models.Input((3,))
    model = keras2.models.Model(inp, keras2.layers.Dense(3, 2)(inp))
    with torch.no_grad():
        assert model(torch.ones(1, 3)).shape == (1, 2)


def test_nn_namespace_covers_the_jax_one():
    """Every name of the JAX ``nn.__all__`` but ``Module`` and ``Scope``
    (``torch.nn.Module`` stands for both), the Keras-1 spellings bound to
    the same classes."""
    assert set(jnn.__all__) - set(nn.__all__) == {"Module", "Scope"}
    assert nn.Deconvolution2D is nn.Conv2DTranspose
    assert nn.SeparableConvolution2D is nn.SeparableConv2D
    assert nn.SparseDense is nn.Dense and nn.SparseEmbedding is nn.Embedding
    assert nn.param_count({"params": {"a": np.zeros((2, 3))},
                           "state": {"m": np.zeros(4)}}) == \
        jnn.param_count({"params": {"a": np.zeros((2, 3))},
                         "state": {"m": np.zeros(4)}}) == 6


def test_a_symbolic_call_that_raises_leaves_recording_off():
    """A layer whose forward raises on a symbolic input re-raises, restores
    the modes and leaves no recording on: the next calls record and
    compute as before."""

    class Boom(torch.nn.Module):
        def forward(self, x):
            raise ValueError("boom")

    inp = nn.Input((3,))
    seq = nn.Sequential([nn.Dense(3, 4), Boom()])
    with pytest.raises(ValueError, match="boom"):
        seq(inp)
    assert seq.training
    h = nn.Dense(3, 2)(inp)
    assert isinstance(h, nn.SymbolicTensor) and h.node is not None
    with torch.no_grad():
        assert not isinstance(nn.Dense(3, 2)(torch.ones(1, 3)),
                              nn.SymbolicTensor)


def test_hooks_live_only_while_symbolic_handles_do():
    """The recording hooks go with the last symbolic handle: a built
    ``Model`` keeps none alive and still runs; reading its ``outputs``
    gives handles that record again (a new head on a built model), and
    dropping them removes the hooks once more.  The dropout hands its
    symbolic input back as it is, which no node may keep alive."""
    import gc
    from analytics_zoo_tpu_torch.nn import functional
    mm = torch.nn.modules.module
    gc.collect()
    base = functional._live[0]

    def build():
        inp = nn.Input((4,))
        assert functional._hooks
        return nn.Model(inp, nn.Dense(4, 3, activation="tanh")(
            nn.Dropout(0.5)(inp)))

    model = build().eval()
    gc.collect()
    assert functional._live[0] == base
    if base == 0:
        assert not functional._hooks
        assert not mm._global_forward_hooks
        assert not mm._global_forward_pre_hooks
    x = torch.randn(2, 4)
    with torch.no_grad():
        y = model(x)
    feat = model.outputs[0]
    assert functional._hooks
    assert feat.node is model._out_nodes[0] and tuple(feat.shape) == (1, 3)
    inp = model.inputs[0]
    head = nn.Model(inp, nn.Dense(3, 2)(feat))
    assert list(head.state_dict()) == ["dense.kernel", "dense.bias",
                                       "dense_1.kernel", "dense_1.bias"]
    with torch.no_grad():
        torch.testing.assert_close(head.dense(x), y, rtol=0, atol=0)
        assert head(x).shape == (2, 2)
    del feat, inp
    gc.collect()
    assert functional._live[0] == base
    if base == 0:
        assert not functional._hooks
