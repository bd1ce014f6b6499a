"""The port's image slice against the JAX package on the CPU: the conv,
pooling and shape layers, ``ResNet`` (depths 18 and 50, width 8, both
stems, both norms, training and eval), one ``Estimator`` train step, LeNet's
loss history, the device augmentation chain and the converter's conv and
state handling.  Weights are made with numpy from a seed in the JAX tree
layout and carried across with ``convert.py``; inputs are numpy from a
seed.

Tolerances.  Layers: 1e-5 of max(1, max |ref|) (the same f32 math in
another order).  ResNet forward: 1e-4 of max(1, max |ref|) in eval and in
NF training; 2e-3 in batch-norm training, whose statistics at 32 x 32 come
from 8 rows a channel in the last stage, so a summation-order difference in
a variance is amplified through the later layers.  The train step: loss
1e-5 relative, parameters and running statistics 1e-5 absolute (one sgd
step at lr 0.1 moves them by up to 0.2).  LeNet's loss history: 1e-5
relative.  The eval augmentation chain: exact.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.data import augment as jaug
from analytics_zoo_tpu.models import ResNet as JaxResNet
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import (buffer_names, from_jax_variables,
                                             to_jax_variables)
from analytics_zoo_tpu_torch.data import augment as taug
from analytics_zoo_tpu_torch.models import ImageClassifier, ResNet, lenet
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.ops import fused_bn

timage = importlib.import_module("analytics_zoo_tpu_torch.models.image")
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _random_variables(model, seed):
    """``model``'s variables as a JAX ``{"params", "state"}`` tree of numpy
    arrays drawn from ``seed``: he-scaled kernels, gains near 1, small
    biases and shifts, running means near 0 and variances in [0.5, 1.5],
    SkipInit gains away from 0 (so every NF branch counts)."""
    rng = np.random.default_rng(seed)
    tree = to_jax_variables(model.state_dict(), buffer_names(model))

    def draw(path, a):
        leaf, shape = path[-1], a.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        if leaf in ("gamma", "ws_gain"):
            return 1.0 + 0.2 * rng.normal(size=shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        if leaf == "skip_gain":
            return 0.5 + 0.2 * rng.normal(size=shape)
        return 0.2 * rng.normal(size=shape)

    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v).astype(np.float32)
                for k, v in node.items()}

    return walk(tree, ())


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: err {err} > {tol} x {scale}"


def _twin(port_layer, jax_layer, x, seed=0, training=False):
    """(port output, JAX output) of one layer on ``x`` with the same random
    variables."""
    v = _random_variables(port_layer, seed)
    port_layer.load_state_dict(from_jax_variables(v), strict=True)
    port_layer.train(training)
    want, _ = jax_layer.apply(v, jnp.asarray(x), training=training)
    return port_layer(torch.from_numpy(x)), want


# -- layers -------------------------------------------------------------------

CONV_CASES = [
    # size, cin, filters, kernel, strides, padding, extra
    (8, 3, 4, 3, 1, "same", {}), (8, 3, 4, 3, 2, "same", {}),
    (7, 3, 4, 3, 2, "same", {}), (7, 3, 4, 3, 1, "valid", {}),
    (8, 3, 4, 3, 2, "valid", {}), (8, 3, 4, 3, 1, ((1, 2), (0, 1)), {}),
    (7, 3, 4, 3, 2, 1, {}), (8, 3, 4, 7, 2, "same", {}),
    (8, 3, 4, 3, 1, "same", {"dilation": 2}),
    (9, 4, 6, 3, 2, "same", {"dilation": 2}),
    (8, 4, 6, 3, 1, "same", {"groups": 2}),
    (8, 3, 5, 1, 1, "same", {}), (8, 3, 5, 1, 2, "same", {}),
    (7, 3, 4, 3, 1, "same", {"activation": "relu"}),
]


@pytest.mark.parametrize("size,cin,f,k,s,pad,extra", CONV_CASES)
def test_conv2d_matches_jax(size, cin, f, k, s, pad, extra):
    """SAME (XLA's, odd pad at the end), VALID and explicit pads at strides
    1 and 2 on even and odd sizes, dilation, groups, the 1x1 matmul path,
    bias and activation: outputs and input/kernel gradients."""
    x = np.random.default_rng(size * k + s).normal(
        size=(2, size, size, cin)).astype(np.float32)
    port = tnn.Conv2D(cin, f, k, strides=s, padding=pad, **extra)
    jl = jnn.Conv2D(f, k, strides=s, padding=pad, **extra)
    v = _random_variables(port, size)
    port.load_state_dict(from_jax_variables(v), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    want, _ = jl.apply(v, jnp.asarray(x))
    _close(got, want, 1e-5, "y")
    jgx, jgp = jax.grad(lambda x, p: jnp.sum(jnp.sin(jl.apply(
        {"params": p}, x)[0])), argnums=(0, 1))(jnp.asarray(x), v["params"])
    gx, gk = torch.autograd.grad(torch.sin(got).sum(), (xt, port.kernel))
    _close(gx, jgx, 1e-5, "dx")
    _close(gk.permute(2, 3, 1, 0), jgp["kernel"], 1e-5, "dkernel")


POOL_CASES = [
    ("max", 3, 2, "same", 8), ("max", 3, 2, "same", 7),
    ("max", 2, 2, "valid", 8), ("max", 3, 1, ((1, 1), (0, 2)), 7),
    ("avg", 3, 2, "same", 8), ("avg", 3, 1, "same", 7),
    ("avg", 2, 2, "valid", 7), ("avg", 3, 2, ((1, 0), (1, 1)), 8),
]


@pytest.mark.parametrize("kind,window,stride,pad,size", POOL_CASES)
def test_pool_matches_jax(kind, window, stride, pad, size):
    """Max pads with -inf; average divides by the real pixels under SAME
    and by the window under VALID or explicit pads."""
    x = np.random.default_rng(size).normal(
        size=(2, size, size, 3)).astype(np.float32)
    port = (tnn.MaxPooling2D if kind == "max" else tnn.AveragePooling2D)(
        window, strides=stride, padding=pad)
    jl = (jnn.MaxPooling2D if kind == "max" else jnn.AveragePooling2D)(
        window, strides=stride, padding=pad)
    want, _ = jl.apply({}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want, 1e-6, kind)


@pytest.mark.parametrize("skip_init", [False, True])
def test_scaled_ws_conv_matches_jax(skip_init):
    """Weight standardization over each output channel's fan in (OIHW dims
    1-3), with the SkipInit gain folded in: outputs and every parameter's
    gradient."""
    x = np.random.default_rng(1).normal(size=(2, 6, 6, 4)).astype(np.float32)
    port = tnn.ScaledWSConv2D(4, 5, 3, strides=2, use_bias=False,
                              skip_init=skip_init, branch_scale=0.2)
    jl = jnn.ScaledWSConv2D(5, 3, strides=2, use_bias=False,
                            skip_init=skip_init, branch_scale=0.2)
    got, want = _twin(port, jl, x)
    _close(got, want, 1e-5, "y")
    v = _random_variables(port, 0)
    jg = jax.grad(lambda p: jnp.sum(jnp.sin(jl.apply(
        {"params": p}, jnp.asarray(x))[0])))(v["params"])
    names = [n for n, _ in port.named_parameters()]
    tg = dict(zip(names, torch.autograd.grad(torch.sin(got).sum(),
                                             list(port.parameters()))))
    for name, g in tg.items():
        if name == "kernel":
            g = g.permute(2, 3, 1, 0)
        _close(g, jg[name], 1e-5, name)


def test_shape_layers_and_sequential_match_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 4, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    for port, jl in ((tnn.Flatten(), jnn.Flatten()),
                     (tnn.ZeroPadding2D((1, 2)), jnn.ZeroPadding2D((1, 2))),
                     (tnn.GlobalAveragePooling2D(),
                      jnn.GlobalAveragePooling2D()),
                     (tnn.GlobalMaxPooling2D(), jnn.GlobalMaxPooling2D())):
        _close(port(xt), jl.apply({}, jnp.asarray(x))[0], 1e-6,
               type(port).__name__)
    seq = tnn.Sequential([tnn.Flatten(), ("head", tnn.Dense(60, 2))])
    jseq = jnn.Sequential([jnn.Flatten(), jnn.Dense(2, name="head")])
    got, want = _twin(seq, jseq, x)
    _close(got, want, 1e-5, "sequential")
    assert [n for n, _ in seq.named_children()] == ["00_layer0", "head"]


# -- ResNet -------------------------------------------------------------------

CONFIGS = [(d, stem, norm) for d in (18, 50)
           for stem in ("conv", "space_to_depth") for norm in ("batch", "nf")]
# an NF ResNet computes the same in training and eval, and the two stems
# are one conv (test_space_to_depth_stem_equals_conv_stem): these cover
# both stems, both norms and both modes at each depth
FORWARD_CASES = [(18, "conv", "batch", True), (18, "conv", "batch", False),
                 (18, "space_to_depth", "nf", True),
                 (50, "conv", "batch", True),
                 (50, "space_to_depth", "nf", False)]


@pytest.mark.parametrize("depth,stem,norm", CONFIGS)
def test_resnet_tree_matches_jax_init(depth, stem, norm):
    """The port's variables, as a JAX tree, have exactly the paths and
    shapes of the JAX model's ``init`` (traced, not run)."""
    x = jnp.zeros((1, 32, 32, 3))
    jm = JaxResNet(depth=depth, class_num=10, width=8, stem=stem, norm=norm)
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    port = ResNet(depth=depth, class_num=10, width=8, stem=stem, norm=norm)
    got = to_jax_variables(port.state_dict(), buffer_names(port))
    for part in ("params", "state"):
        assert {p: a.shape for p, a in _leaves(got[part])} == \
            {p: tuple(a.shape) for p, a in _leaves(want[part])}, part


IMAGES = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(
    np.float32)


@pytest.mark.parametrize("depth,stem,norm,training", FORWARD_CASES)
def test_resnet_forward_matches_jax(depth, stem, norm, training):
    """Eval uses the running statistics (random here), training the batch
    statistics (the fused ``bn_train`` in every block) and the JAX state
    update; the updated running statistics match JAX's new state."""
    port = ResNet(depth=depth, class_num=10, width=8, stem=stem, norm=norm)
    jm = JaxResNet(depth=depth, class_num=10, width=8, stem=stem, norm=norm)
    v = _random_variables(port, depth)
    port.load_state_dict(from_jax_variables(v), strict=True)
    port.train(training)
    want, new_state = jm.apply(v, jnp.asarray(IMAGES), training=training)
    with torch.no_grad():
        got = port(torch.from_numpy(IMAGES))
    tol = 2e-3 if training and norm == "batch" else 1e-4
    _close(got, want, tol, "logits")
    state = to_jax_variables(port.state_dict(), buffer_names(port))["state"]
    for path, a in _leaves(state):
        _close(a, _at(new_state, path) if training else _at(v["state"], path),
               tol, "/".join(path))


def test_resnet_stages_features_and_bf16_match_jax():
    """``return_stages`` (stages 1-3), ``include_top=False`` and the bf16
    path, whose head stays f32."""
    x = IMAGES
    base = dict(depth=18, class_num=10, width=8)
    for kw in (dict(return_stages=True), dict(include_top=False),
               dict(dtype="bfloat16")):
        port = ResNet(**base, **kw)
        v = _random_variables(port, 3)
        port.load_state_dict(from_jax_variables(v), strict=True)
        want, _ = JaxResNet(**base, **kw).apply(v, jnp.asarray(x))
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x))
        if kw.get("return_stages"):
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                _close(g, w, 1e-4, "tap")
        elif kw.get("dtype"):
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            # bf16 activations through 18 layers: rounded at other places
            _close(got, want, 5e-2, "bf16 logits")
        else:
            _close(got, want, 1e-4, "features")


def test_resnet_variants_give_class_logits():
    """Twin of ``tests/test_models.py::test_resnet_variants``."""
    x = torch.from_numpy(IMAGES[:2])
    for depth, width in ((18, 64), (50, 16)):
        assert ResNet(depth=depth, class_num=10, width=width)(x).shape == \
            (2, 10)
    out = ResNet(depth=18, class_num=10, dtype="bfloat16")(x)
    assert out.dtype == torch.float32


def test_space_to_depth_stem_equals_conv_stem():
    """Twin of ``tests/test_image.py``'s test: the two stems are the same
    conv on one parameter tree."""
    conv = ResNet(depth=18, class_num=5, width=8).eval()
    s2d = ResNet(depth=18, class_num=5, width=8,
                 stem="space_to_depth").eval()
    s2d.load_state_dict(conv.state_dict(), strict=True)
    with torch.no_grad():
        x = torch.from_numpy(IMAGES[:2])
        torch.testing.assert_close(s2d(x), conv(x), atol=2e-4, rtol=2e-4)


def test_nf_resnet_block_is_identity_at_init():
    """Twin of ``test_nf_resnet_forward_and_identity_at_init``: SkipInit
    makes a non-transition NF block the identity at init."""
    out = ResNet(depth=50, class_num=10, norm="nf", width=16).train()(
        torch.from_numpy(IMAGES[:2]))
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    blk = timage._NFResBlock(16, 4, stride=1, bottleneck=True, beta=1.0,
                             alpha=0.2)
    h = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(blk(h), h, atol=1e-6, rtol=0)


def test_nf_depth18_stage0_variance_reset_matches_shortcut(monkeypatch):
    """Twin of the JAX test: depth-18 stage 0 block 0 keeps the identity
    shortcut, and the variance tracker asks the block's own predicate."""
    calls = []
    real = timage._nf_transition

    def spy(in_ch, out_ch, stride):
        r = real(in_ch, out_ch, stride)
        calls.append((in_ch, out_ch, stride, r))
        return r

    monkeypatch.setattr(timage, "_nf_transition", spy)
    m = ResNet(depth=18, class_num=2, norm="nf", width=8)
    assert m.stage0_block0.proj is None and m.stage1_block0.proj is not None
    stage0 = [c for c in calls if c[1] == 8]
    assert stage0 and all(r is False for *_, r in stage0)
    strided = [c for c in calls if c[2] == 2]
    assert strided and all(r is True for *_, r in strided)
    betas = [getattr(m, f"stage{s}_block{b}").beta for s in range(4)
             for b in range(2)]
    # identity shortcuts carry the variance (1 -> 1.04 -> 1.08), each
    # transition resets it to 1 before adding its branch's 0.2^2
    np.testing.assert_allclose(betas, np.sqrt([1.0, 1.04, 1.08, 1.04, 1.08,
                                               1.04, 1.08, 1.04]))


def test_nf_resnet_skip_gain_learns():
    """Twin of ``test_nf_resnet_skip_gain_learns``: the folded SkipInit
    gains get gradients at init and a small NF ResNet trains."""
    rng = np.random.default_rng(4)
    xs = rng.normal(0, 1, (128, 16, 16, 3)).astype(np.float32)
    ys = rng.integers(0, 2, 128).astype(np.int32)
    xs[ys == 1, :, :, 0] += 2.0
    torch.manual_seed(0)
    m = ResNet(depth=18, class_num=2, norm="nf", width=8)
    est = Estimator.from_keras(m, loss="sparse_categorical_crossentropy",
                               optimizer="adam", learning_rate=3e-3,
                               device="cpu")
    hist = est.fit((xs, ys), epochs=4, batch_size=32, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0] * 0.8, hist["loss"]
    gains = [p for n, p in m.named_parameters() if "skip_gain" in n]
    assert gains and any(abs(float(g.detach())) > 1e-5 for g in gains)


def test_image_classifier_top_n():
    labels = [f"class_{i}" for i in range(10)]
    m = ImageClassifier(depth=18, class_num=10, labels=labels)
    preds = m.predict_image_set(IMAGES[:4], top_n=3)
    assert len(preds) == 4 and all(len(p) == 3 for p in preds)
    with torch.no_grad():
        probs = torch.softmax(m.eval()(torch.from_numpy(IMAGES[:4])), -1)
    for row, p in zip(preds, probs.numpy()):
        assert row[0][0] == labels[int(p.argmax())]
        assert row[0][1] == pytest.approx(float(p.max()), rel=1e-6)
        assert row[0][1] >= row[1][1] >= row[2][1]


# -- the Estimator --------------------------------------------------------------

def _jax_estimator(model, variables, **kw):
    """A JAX Estimator over ``model`` that starts from ``variables`` (the
    package's own path for loaded weights, ``ZooModel.compile`` after
    ``_loaded_variables``), with the non-finite-step counter its
    ``_ensure_initialized`` would add."""
    model._loaded_variables = variables
    model.compile(**kw)
    est = model.estimator
    est._ts["bad_steps"] = jnp.zeros((), jnp.int32)
    return est


@pytest.fixture(scope="module")
def resnet_step():
    """One sgd step (lr 0.1) of a depth-18 width-8 batch-norm ResNet on 8
    images of 64 x 64, by both Estimators from the same variables."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    port = ResNet(depth=18, class_num=10, width=8)
    v = _random_variables(port, 6)
    port.load_state_dict(from_jax_variables(v), strict=True)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="sgd",
              learning_rate=0.1)
    jest = _jax_estimator(JaxResNet(depth=18, class_num=10, width=8), v,
                          **kw)
    test = Estimator.from_keras(port, device="cpu", **kw)
    before = dict(fused_bn.KERNEL_LAUNCHES)
    hist_j = jest.fit((x, y), epochs=1, batch_size=8, verbose=False)
    hist_t = test.fit((x, y), epochs=1, batch_size=8, verbose=False)
    assert dict(fused_bn.KERNEL_LAUNCHES) == before  # the CPU runs none
    return jest, test, hist_j, hist_t, v, x


def test_resnet_train_step_matches_jax_estimator(resnet_step):
    """Loss, updated parameters and updated running statistics; the
    running statistics come back under ``get_model()["state"]``."""
    jest, test, hist_j, hist_t, v, _ = resnet_step
    np.testing.assert_allclose(hist_t["loss"], hist_j["loss"], rtol=1e-5)
    got, want = test.get_model(), jest.get_model()
    assert {p for p, _ in _leaves(got["state"])} == \
        {p for p, _ in _leaves(v["state"])} != set()
    for part in ("params", "state"):
        moved = 0.0
        for path, a in _leaves(got[part]):
            w = np.asarray(_at(want[part], path))
            np.testing.assert_allclose(a, w, atol=1e-5, rtol=0,
                                       err_msg="/".join(path))
            moved = max(moved, float(np.abs(w - _at(v[part], path)).max()))
        assert moved > 1e-3, part  # the step changed them


def test_get_model_tree_runs_through_jax_resnet(resnet_step):
    """``get_model()`` is a JAX tree: ``ResNet.apply`` on it (eval, so
    through the running statistics) gives the port's ``predict``."""
    _, test, _, _, _, x = resnet_step
    want, _ = JaxResNet(depth=18, class_num=10, width=8).apply(
        test.get_model(), jnp.asarray(x), training=False)
    _close(test.predict(x, batch_size=4), want, 1e-4, "predict")
    ev = test.evaluate((x, np.zeros(8, np.int32)), batch_size=3)
    assert np.isfinite(ev["loss"])


def test_evaluate_and_predict_leave_buffers_fixed(resnet_step):
    _, test, *_ = resnet_step
    x = resnet_step[-1]
    state = {k: b.clone() for k, b in test.model.named_buffers()}
    test.predict(x, batch_size=8)
    test.evaluate((x, np.zeros(8, np.int32)), batch_size=5)
    for k, b in test.model.named_buffers():
        assert torch.equal(b, state[k]), k


def test_fit_trains_on_a_padded_last_batch_as_jax():
    """A ``DataFeed(drop_remainder=False)`` trains on its wrap-padded last
    batch, as the JAX Estimator does: 200 rows at batch 64 over 2 epochs
    are 8 steps, with the JAX loss history (1e-5 of max(1, |loss|)) and
    running statistics (1e-5 absolute).  A batch that carries a
    ``"mask"`` (a streaming feed's padded tail) is still skipped."""
    from analytics_zoo_tpu.data import DataFeed as JaxDataFeed
    from analytics_zoo_tpu_torch.data import DataFeed
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 4)).astype(np.float32) * 2 + 1
    y = rng.normal(size=(200, 2)).astype(np.float32)
    kw = dict(loss="mse", optimizer="adam", learning_rate=1e-2)
    jest = JaxEstimator.from_keras(
        jnn.Sequential([jnn.BatchNormalization(), jnn.Dense(2)]), **kw)
    jest._ensure_initialized(jnp.asarray(x[:64]))
    model = tnn.Sequential([tnn.BatchNormalization(4), tnn.Dense(4, 2)])
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    est = Estimator.from_keras(model, device="cpu", **kw)
    feed = dict(batch_size=64, shuffle=True, seed=0, drop_remainder=False)
    hist_j = jest.fit(JaxDataFeed({"x": x, "y": y}, **feed), epochs=2,
                      verbose=False)
    hist_t = est.fit(DataFeed({"x": x, "y": y}, **feed), epochs=2,
                     verbose=False)
    assert jest._py_step == est._py_step == 8
    np.testing.assert_allclose(hist_t["loss"], hist_j["loss"], rtol=1e-5,
                               atol=1e-5)
    want = jest.get_model()["state"]["00_layer0"]
    bn = model.get_submodule("00_layer0")
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), want[name],
                                   rtol=0, atol=1e-5, err_msg=name)

    class Masked(DataFeed):  # a stream's last batch, padded and masked
        def epoch(self, device, epoch_idx=0):
            for step, batch in enumerate(super().epoch(device, epoch_idx)):
                if step == self.steps_per_epoch() - 1:
                    batch = dict(batch, mask=torch.zeros(64))
                yield batch

    est.fit(Masked({"x": x, "y": y}, **feed), epochs=1, verbose=False)
    assert est._py_step == 8 + 3


def test_lenet_loss_history_matches_jax_estimator():
    """LeNet (``examples/lenet_mnist.py``), initialised by the JAX
    Estimator, converted, and fit by both for 3 epochs with adam."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        from lenet_mnist import build_lenet, synthetic_mnist
    finally:
        sys.path.remove(str(REPO / "examples"))
    x, y = synthetic_mnist(64, seed=3)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-3)
    jest = JaxEstimator.from_keras(build_lenet(), **kw)
    jest._ensure_initialized(jnp.asarray(x[:32]))
    port = lenet()
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    test = Estimator.from_keras(port, device="cpu", **kw)
    hist_j = jest.fit((x, y), epochs=3, batch_size=32, verbose=False)
    hist_t = test.fit((x, y), epochs=3, batch_size=32, verbose=False)
    np.testing.assert_allclose(hist_t["loss"], hist_j["loss"], rtol=1e-5)
    assert hist_t["loss"][-1] < hist_t["loss"][0]


# -- augmentation ---------------------------------------------------------------

def _chains():
    return (taug.DeviceAugment([taug.DeviceRandomCrop(24, 20),
                                taug.DeviceRandomFlip(),
                                taug.DeviceNormalize()]),
            jaug.DeviceAugment([jaug.DeviceRandomCrop(24, 20),
                                jaug.DeviceRandomFlip(),
                                jaug.DeviceNormalize()]))


UINT8 = np.random.default_rng(8).integers(0, 256, (6, 32, 30, 3),
                                          dtype=np.uint8)


def test_eval_chain_matches_jax_exactly():
    """Center crop, no flip, normalize: deterministic, so exact (JAX's
    random draws cannot be reproduced in torch; the train chain is checked
    on its own below)."""
    port, jchain = _chains()
    want = np.asarray(jchain(jnp.asarray(UINT8), None, training=False))
    for gen in (None, torch.Generator().manual_seed(0)):
        got = port(torch.from_numpy(UINT8), gen, training=False).numpy()
        np.testing.assert_array_equal(got, want)
    assert repr(port) == ("DeviceAugment([DeviceRandomCrop, "
                          "DeviceRandomFlip, DeviceNormalize])")


def test_train_chain_crops_at_drawn_offsets_flips_and_repeats():
    """Every image is an exact crop of its source at some offset, flipped
    or not; both happen across the batch; one seed repeats the batch."""
    crop = taug.DeviceAugment([taug.DeviceRandomCrop(24, 20),
                               taug.DeviceRandomFlip()])
    x = torch.from_numpy(UINT8)
    out = crop(x, torch.Generator().manual_seed(1), training=True)
    assert out.shape == (6, 24, 20, 3) and out.dtype == torch.uint8
    flips, offsets = [], set()
    for img, src in zip(out, x):
        found = [(t, l, f) for t in range(9) for l in range(11)
                 for f in (False, True)
                 if torch.equal(img, (src[t:t + 24, l:l + 20].flip(1) if f
                                      else src[t:t + 24, l:l + 20]))]
        assert len(found) == 1, found
        offsets.add(found[0][:2])
        flips.append(found[0][2])
    assert len(offsets) > 1 and any(flips) and not all(flips)
    again = crop(x, torch.Generator().manual_seed(1), training=True)
    assert torch.equal(out, again)


def test_estimator_augments_fit_and_evaluates_deterministically():
    """``augment=``: fit draws from the Estimator's seeded generator (two
    fits with one seed repeat), evaluate/predict take the deterministic
    chain."""
    y = np.arange(6, dtype=np.int32) % 2
    chain, _ = _chains()

    def fit(seed):
        torch.manual_seed(0)
        model = tnn.Sequential([tnn.Flatten(), tnn.Dense(24 * 20 * 3, 2)])
        est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                                   optimizer="sgd", learning_rate=0.01,
                                   device="cpu", augment=chain, seed=seed)
        return est, est.fit((UINT8, y), epochs=2, batch_size=3,
                            verbose=False)["loss"]

    est, losses = fit(0)
    assert losses == fit(0)[1] and losses != fit(1)[1]
    with torch.no_grad():
        want = est.model.eval()(chain(torch.from_numpy(UINT8), None,
                                      training=False)).numpy()
    np.testing.assert_allclose(est.predict(UINT8, batch_size=4), want,
                               rtol=1e-6)
    assert np.isfinite(est.evaluate((UINT8, y), batch_size=4)["loss"])


# -- the converter ------------------------------------------------------------

def test_conv_kernels_cross_as_hwio_and_state_under_state():
    port = ResNet(depth=18, class_num=4, width=8)
    tree = to_jax_variables(port.state_dict(), buffer_names(port))
    assert tree["params"]["stem"]["kernel"].shape == (7, 7, 3, 8)
    np.testing.assert_array_equal(tree["params"]["stem"]["kernel"],
                                  port.stem.kernel.detach().permute(
                                      2, 3, 1, 0).numpy())
    assert set(tree["state"]["stem_bn"]) == {"mean", "var"}
    assert "mean" not in tree["params"]["stem_bn"]
    back = from_jax_variables(tree)
    for k, t in port.state_dict().items():
        assert torch.equal(back[k], t), k


def test_int8_weights_are_refused_with_the_roadmap_item():
    """The roadmap item (Queue 1 item 1, the int8 serving path) is done, so
    the converter no longer refuses an int8 conv kernel: its three leaves
    map to three keys, ``q`` and ``scale`` transposed HWIO -> OIHW with the
    kernel, the values kept."""
    q = np.arange(18, dtype=np.int8).reshape(3, 3, 1, 2)
    tree = {"params": {"conv": {"kernel": {
        "__int8_weight__": np.int8(1), "q": q,
        "scale": np.full((1, 1, 1, 2), 0.5, np.float32)}}}}
    state = from_jax_variables(tree)
    assert set(state) == {"conv.kernel.__int8_weight__", "conv.kernel.q",
                          "conv.kernel.scale"}
    assert state["conv.kernel.q"].dtype == torch.int8
    assert torch.equal(state["conv.kernel.q"],
                       torch.from_numpy(q).permute(3, 2, 0, 1))
    assert state["conv.kernel.scale"].shape == (2, 1, 1, 1)


def test_optimizer_takes_a_gradient_in_another_layout():
    """A conv kernel's gradient comes back channels_last; the optimizer
    (fused on the card, which wants one layout) steps the OIHW parameter
    with it all the same."""
    from analytics_zoo_tpu_torch.orca.learn import optimizers
    p = torch.nn.Parameter(torch.randn(4, 3, 2, 2))
    g = torch.randn(4, 2, 2, 3).permute(0, 3, 1, 2)
    assert g.stride() != p.stride()
    want = p.detach() - 0.1 * g
    opt = optimizers.get("sgd", 0.1)
    opt.step([p], [g], opt.init([p]))
    assert p.is_contiguous()
    torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7)
