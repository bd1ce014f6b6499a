"""The port's int8 serving against the JAX package on the CPU: twins of the
JAX package's int8 tests (``tests/test_serving.py``), the same variables
and inputs served by the JAX ``InferenceModel`` and by the port's
``InferenceModel(device="cpu")``.

What must be equal: the quantized weights (``q`` and ``scale`` bit for bit,
both quantized by the same numpy statements), the calibrated layers' keys,
and their recorded ranges within 1e-6 relative (the float forwards differ
in summation order only).  What may differ: the int8 products are exact on
both sides, so the outputs differ only where the two round to bf16 in
another order (XLA on the CPU may keep a bf16 product at f32 until its
consumer), and, under calibration, where such a difference moves an
activation across a quantization step.  Tolerances, of max(1, max |JAX|):
``TOL_F32_NETS`` 1e-2 for the MLP and the conv nets, whose activations stay
f32 (seen: 3.6e-3 weight-only, 3.5e-7 calibrated); ``TOL_BERT`` 5e-2 for
the small BERT, whose encoder runs in bf16 from its bf16 embedding
(seen: 7.8e-3 to 2.5e-2), the bound the bf16 BERT trunk's parity keeps in
``tests/test_torch_bert_serving.py``.  The JAX tests' own bounds against
the f32 model hold for the port too.

The LSTM twin (``test_inference_model_int8_calibrated_with_lstm``) holds
the rule that calibration leaves the recurrent kernels dequantized (only
``Dense`` and plain ``Conv2D`` take int8 products); BERT's attention
projections, which stay weight-only under calibration, hold the same rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.models as jax_models
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.serving.inference_model import \
    _quantize_tree as jax_quantize_tree
import analytics_zoo_tpu_torch.models as port_models
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import (buffer_names, from_jax_variables,
                                             to_jax_variables)
from analytics_zoo_tpu_torch.nn import quant
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.serving import InferenceModel
from analytics_zoo_tpu_torch.serving.inference_model import _quantize_tree

TOL_F32_NETS = 1e-2
TOL_BERT = 5e-2
BERT_CFG = dict(vocab_size=100, hidden_size=64, n_layers=2, n_heads=4,
                max_position=16, dropout=0.0)
SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    """max |got - want| / max(1, max |want|)."""
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _jax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_same_quantized_weights(jax_im, port_im):
    """The port's stored variables, back in the JAX layout, are JAX's: int8
    leaves (q, scale, marker) bit for bit, the bf16 ones equal."""
    model = port_im._model
    back = to_jax_variables(model.state_dict(), buffer_names(model))
    want = dict(_jax_leaves(jax_im._variables["params"]))
    got = dict(_jax_leaves(back["params"]))
    assert set(got) == set(want)
    n_int8 = 0
    for path, w in want.items():
        g = got[path]
        w = np.asarray(w)
        if path[-1] in ("q", quant.MARKER):
            assert g.dtype == np.int8 and w.dtype == np.int8, path
            n_int8 += path[-1] == "q"
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=str(path))
    assert n_int8 > 0


def _mlp_pair():
    jm = jnn.Sequential([jnn.Dense(256, activation="relu"),
                         jnn.Dense(128, activation="relu"), jnn.Dense(10)])
    pm = tnn.Sequential([tnn.Dense(64, 256, "relu"),
                         tnn.Dense(256, 128, "relu"), tnn.Dense(128, 10)])
    return jm, pm


def _served(jm, pm, variables, x, **load):
    """(JAX f32, JAX int8, port int8) outputs and the two int8 models."""
    ref = np.asarray(JaxInferenceModel().load(jm, variables).predict(x),
                     np.float32)
    jim = JaxInferenceModel().load(jm, variables, **load)
    pim = InferenceModel(device="cpu").load(pm, variables, **load)
    return (ref, np.asarray(jim.predict(x), np.float32), pim.predict(x),
            jim, pim)


def test_int8_weight_quantization_matches_jax():
    """Weight-only int8: large float leaves stored int8 with per-channel
    scales (bit for bit JAX's), small ones bf16; outputs close to JAX's
    int8 and within its bound of the f32 model."""
    jm, pm = _mlp_pair()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, want, got, jim, pim = _served(jm, pm, variables, x, dtype="int8")
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(got, want) <= TOL_F32_NETS
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) < 0.08
    _assert_same_quantized_weights(jim, pim)
    layer0 = getattr(pm, "00_layer0")
    assert isinstance(layer0._modules["kernel"], quant.Int8Weight)
    assert layer0._modules["kernel"].q.dtype == torch.int8
    # (in, out) with `in` contiguous: cuBLASLt's int8 layout
    assert layer0._modules["kernel"].q.stride() == (1, 64)
    assert layer0.bias.dtype == torch.bfloat16
    # the weight-only form: bf16 product of q and scale, on every access
    w = layer0._modules["kernel"]
    assert torch.equal(layer0.kernel, w.q.to(torch.bfloat16)
                       * w.scale.to(torch.bfloat16))
    assert pim._quant_ctx is None and pim._quantized


def test_int8_calibrated_activations_match_jax():
    """Calibrated int8: one range per Dense from the calibration forward
    (JAX's keys, values within 1e-6), int8 x int8 -> int32 products,
    outputs close to JAX's and within its bounds of the f32 model."""
    jm, pm = _mlp_pair()
    rng = np.random.default_rng(3)
    calib = rng.normal(size=(32, 64)).astype(np.float32)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(calib))
    ref, want, got, jim, pim = _served(jm, pm, variables, x, dtype="int8",
                                       calibrate=calib)
    amax, jamax = pim._quant_ctx.amax, jim._quant_ctx.amax
    assert set(amax) == set(jamax) and len(amax) == 3
    for key, a in jamax.items():
        assert abs(amax[key] - a) <= 1e-6 * a, key
    assert all(a > 0 for a in amax.values())
    assert _rel(got, want) <= TOL_F32_NETS
    denom = np.maximum(np.abs(ref), 1.0)
    assert np.max(np.abs(got - ref) / denom) < 0.15
    assert np.mean(got.argmax(1) == ref.argmax(1)) >= 0.8
    _assert_same_quantized_weights(jim, pim)


@pytest.mark.parametrize("spelling", ["int8", "w8", np.int8, jnp.int8,
                                      torch.int8],
                         ids=["int8", "w8", "np", "jnp", "torch"])
def test_reload_and_int8_dtype_spellings(spelling):
    """Every int8 spelling means int8 quantization (never a cast that
    zeroes the weights); reloading one model object f32 -> int8 -> f32
    drops the prepared keys and gives the f32 outputs back."""
    jm = jnn.Sequential([jnn.Dense(128, activation="relu"), jnn.Dense(4)])
    pm = tnn.Sequential([tnn.Dense(64, 128, "relu"), tnn.Dense(128, 4)])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    im = InferenceModel(device="cpu")
    im.load(pm, variables)
    ref = im.predict(x)
    assert im._compiled
    im.load(pm, variables, dtype=spelling)
    assert not im._compiled
    out = im.predict(x)
    assert not np.allclose(out, 0.0)
    assert np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1.0)) < 0.08
    want = np.asarray(JaxInferenceModel().load(jm, variables,
                                               dtype="int8").predict(x))
    assert _rel(out, want) <= TOL_F32_NETS
    im.load(pm, variables)
    assert quant.base_class(getattr(pm, "00_layer0")) is tnn.Dense
    assert type(getattr(pm, "00_layer0")) is tnn.Dense
    np.testing.assert_array_equal(im.predict(x), ref)


def test_calibrate_without_int8_raises():
    pm = tnn.Sequential([tnn.Dense(3, 4)])
    jm = jnn.Sequential([jnn.Dense(4)])
    x = np.zeros((2, 3), np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="calibrate"):
        InferenceModel(device="cpu").load(pm, v, calibrate=x)
    with pytest.raises(ValueError, match="calibrate"):
        InferenceModel(device="cpu").load(pm, v, dtype=torch.bfloat16,
                                          calibrate=x)


def test_int8_calibrated_conv_matches_jax():
    """Calibrated int8 for CNNs: both plain convs and the Dense observed,
    the convs run as exact int8 -> int32 products; outputs close to JAX's
    and within its bounds of the f32 model."""
    jm = jnn.Sequential([jnn.Conv2D(32, 3, activation="relu"),
                         jnn.Conv2D(64, 3, strides=2, activation="relu"),
                         jnn.GlobalAveragePooling2D(), jnn.Dense(10)])
    pm = tnn.Sequential([tnn.Conv2D(3, 32, 3, activation="relu"),
                         tnn.Conv2D(32, 64, 3, strides=2, activation="relu"),
                         tnn.GlobalAveragePooling2D(), tnn.Dense(64, 10)])
    rng = np.random.default_rng(7)
    calib = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(calib))
    ref, want, got, jim, pim = _served(jm, pm, variables, x, dtype="int8",
                                       calibrate=calib)
    assert set(pim._quant_ctx.amax) == set(jim._quant_ctx.amax)
    assert len(pim._quant_ctx.amax) == 3
    assert _rel(got, want) <= TOL_F32_NETS
    denom = np.maximum(np.abs(ref), 1.0)
    assert np.max(np.abs(got - ref) / denom) < 0.2
    assert np.mean(got.argmax(1) == ref.argmax(1)) >= 0.75
    _assert_same_quantized_weights(jim, pim)
    conv1 = getattr(pm, "01_layer1")
    assert conv1._modules["kernel"].q.shape == (64, 32, 3, 3)
    assert conv1._modules["kernel"].scale.shape == (64, 1, 1, 1)


def test_ws_conv_stays_weight_only_under_calibration():
    """ScaledWSConv2D opts out of the activation-quantized path: only the
    Dense is observed, the WS conv's int8 kernel (13,824 elements, above
    the threshold) is standardized from its bf16 dequantization."""
    jm = jnn.Sequential([jnn.ScaledWSConv2D(64, 3, activation="relu"),
                         jnn.GlobalAveragePooling2D(), jnn.Dense(8)])
    pm = tnn.Sequential([tnn.ScaledWSConv2D(24, 64, 3, activation="relu"),
                         tnn.GlobalAveragePooling2D(), tnn.Dense(64, 8)])
    rng = np.random.default_rng(8)
    calib = rng.normal(size=(8, 12, 12, 24)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(calib))
    ref, want, got, jim, pim = _served(jm, pm, variables, calib,
                                       dtype="int8", calibrate=calib)
    assert list(pim._quant_ctx.amax) == list(jim._quant_ctx.amax) \
        == ["02_layer2"]
    assert isinstance(getattr(pm, "00_layer0")._modules["kernel"],
                      quant.Int8Weight)
    assert np.all(np.isfinite(got))
    assert _rel(got, want) <= TOL_F32_NETS
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) < 0.2


def test_inference_model_int8_calibrated_with_lstm():
    """The twin of the JAX test of that name: calibrated int8 leaves the
    LSTM's input and recurrent kernels dequantized (their int8 leaves
    stored, read back as bf16 through attribute access on every forward);
    only the two Dense layers are calibrated and take int8 products."""
    jm = jnn.Sequential([jnn.LSTM(64), jnn.Dense(16, activation="relu"),
                         jnn.Dense(4)])
    pm = tnn.Sequential([tnn.LSTM(16, 64), tnn.Dense(64, 16, "relu"),
                         tnn.Dense(16, 4)])
    rng = np.random.default_rng(5)
    calib = rng.normal(size=(8, 12, 16)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(calib))
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    ref, want, got, jim, pim = _served(jm, pm, variables, x, dtype="int8",
                                       calibrate=calib)
    assert sorted(pim._quant_ctx.amax) == sorted(jim._quant_ctx.amax) \
        == ["01_layer1", "02_layer2"]
    lstm = getattr(pm, "00_layer0")
    for name in ("kernel", "recurrent_kernel"):
        w = lstm._modules[name]
        assert isinstance(w, quant.Int8Weight), name
        assert torch.equal(getattr(lstm, name), w.dequantize(torch.bfloat16))
    _assert_same_quantized_weights(jim, pim)
    assert np.all(np.isfinite(got))
    assert _rel(got, want) <= TOL_F32_NETS
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) < 0.2


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["weight_only", "calibrated"])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_small_bert_int8_matches_jax(calibrated, use_flash):
    """A 2-layer BERT classifier (hidden 64, 4 heads, seq 16): the pooler
    and head (and, calibrated, every FFN Dense) take the int8 product;
    the attention projections, the embeddings and pos_embed stay
    weight-only (pos_embed, below the threshold here, bf16).  Outputs within TOL_BERT of JAX's int8 and within the
    JAX tests' 0.15 (weight-only: 0.08) of the f32 model."""
    jm = jax_models.BERTClassifier(3, use_flash=use_flash, **BERT_CFG)
    calib = np.random.default_rng(0).integers(
        0, BERT_CFG["vocab_size"], size=(16, SEQ)).astype(np.int32)
    x = np.random.default_rng(1).integers(
        0, BERT_CFG["vocab_size"], size=(5, SEQ)).astype(np.int32)
    variables = jm.init(jax.random.PRNGKey(0), calib[:1])
    pm = port_models.BERTClassifier(3, use_flash=use_flash, **BERT_CFG)
    load = dict(dtype="int8", calibrate=calib if calibrated else None)
    ref, want, got, jim, pim = _served(jm, pm, variables, x, **load)
    assert got.shape == (5, 3)
    assert _rel(got, want) <= TOL_BERT
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) \
        < (0.15 if calibrated else 0.08)
    _assert_same_quantized_weights(jim, pim)
    mha = pm.bert.layer_0.mha
    assert isinstance(mha._modules["wq"], quant.Int8Weight)
    assert isinstance(pm.bert.tok_embed._modules["embeddings"],
                      quant.Int8Weight)
    assert pm.bert.pos_embed.dtype == torch.bfloat16  # 1,024 elements
    if calibrated:
        amax, jamax = pim._quant_ctx.amax, jim._quant_ctx.amax
        assert set(amax) == set(jamax) == {
            "pooler", "head", "bert/layer_0/ffn1", "bert/layer_0/ffn2",
            "bert/layer_1/ffn1", "bert/layer_1/ffn2"}
        for key, a in jamax.items():
            assert abs(amax[key] - a) <= 1e-6 * a, key


def test_quantize_tree_is_jax_bit_for_bit():
    """The numpy copy of ``_quantize_tree`` gives JAX's q and scale bit for
    bit on a tree with a conv kernel, a 1-D leaf above the threshold (one
    scale for the whole leaf), small leaves and an integer leaf."""
    rng = np.random.default_rng(4)
    tree = {"params": {
        "conv": {"kernel": rng.normal(size=(3, 3, 16, 32)).astype(np.float32)},
        "head": {"kernel": rng.normal(size=(64, 100)).astype(np.float32),
                 "bias": rng.normal(size=(5000,)).astype(np.float32)},
        "ln": {"gamma": np.ones(64, np.float32)}},
        "state": {"count": np.arange(3, dtype=np.int32)}}
    want = jax_quantize_tree(tree, jnp.bfloat16)
    got = _quantize_tree(tree)
    for path, w in _jax_leaves(want):
        g = got
        for k in path:
            g = g[k]
        if isinstance(g, torch.Tensor):  # the small leaves: bf16
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, path
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got["params"]["head"]["bias"]["scale"].shape == (1,)
    assert got["params"]["conv"]["kernel"]["scale"].shape == (1, 1, 1, 32)


def test_converter_round_trips_an_int8_tree():
    """``from_jax_variables`` maps each leaf of a quantized JAX tree to one
    key (a conv kernel's q and scale transposed to OIHW) and
    ``to_jax_variables`` maps them back: q, scale and the marker bit for
    bit, bf16 leaves as f32 arrays of the same values."""
    jm = jnn.Sequential([jnn.Conv2D(32, 3), jnn.GlobalAveragePooling2D(),
                         jnn.Dense(200)])
    x = np.zeros((1, 8, 8, 16), np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    qtree = jax_quantize_tree(variables, jnp.bfloat16)
    state = from_jax_variables(qtree)
    assert state["00_layer0.kernel.q"].shape == (32, 16, 3, 3)
    assert state["00_layer0.kernel.scale"].shape == (32, 1, 1, 1)
    assert state[f"02_layer2.kernel.{quant.MARKER}"].dtype == torch.int8
    assert state["02_layer2.bias"].dtype == torch.bfloat16
    assert len(state) == len(list(_jax_leaves(qtree["params"])))
    back = to_jax_variables(state)
    want = dict(_jax_leaves(qtree["params"]))
    got = dict(_jax_leaves(back["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        assert got[path].dtype == w.dtype and got[path].shape == w.shape
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    # and a port model takes the quantized state as it is
    pm = tnn.Sequential([tnn.Conv2D(16, 32, 3), tnn.GlobalAveragePooling2D(),
                         tnn.Dense(32, 200)])
    quant.install(pm, state)
    assert torch.equal(getattr(pm, "00_layer0")._modules["kernel"].q,
                       state["00_layer0.kernel.q"])


@pytest.mark.parametrize("case", [
    dict(c=5, o=7, k=3, s=(1, 1), pad="SAME"),
    dict(c=5, o=7, k=3, s=(2, 2), pad="SAME"),
    dict(c=3, o=8, k=7, s=(2, 2), pad="SAME"),
    dict(c=6, o=4, k=(3, 2), s=(1, 2), pad="VALID"),
    dict(c=6, o=4, k=3, s=(1, 1), pad=((1, 2), (0, 1)), dil=(2, 1)),
    dict(c=6, o=9, k=3, s=(1, 1), pad="SAME", groups=3),
    dict(c=8, o=16, k=1, s=(2, 2), pad="SAME"),
    dict(c=8, o=16, k=1, s=(1, 1), pad="VALID", groups=2),
], ids=lambda c: "-".join(str(v) for v in c.values()))
def test_conv_int8_is_exact(case):
    """The int8 conv (GEMMs over strided positions or unfolded patches) is
    the exact integer convolution: equal to a float64 conv of the same
    int8 values at every padding, stride, dilation and group count."""
    g = torch.Generator().manual_seed(1)
    groups, dil = case.get("groups", 1), case.get("dil", (1, 1))
    k = case["k"] if isinstance(case["k"], tuple) else (case["k"],) * 2
    xq = torch.randint(-127, 128, (2, 11, 10, case["c"]), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (case["o"], case["c"] // groups, *k),
                       generator=g, dtype=torch.int8)
    got = quant.conv_int8(xq, wq, case["s"], case["pad"], dil, groups)
    want = tnn.layers.conv2d_nhwc(xq.double(), wq.double(), case["s"],
                                  case["pad"], dil, groups)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want)


def test_int_mm_is_exact_on_the_cpu():
    g = torch.Generator().manual_seed(2)
    a = torch.randint(-127, 128, (5, 13), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (13, 2), generator=g, dtype=torch.int8)
    assert torch.equal(quant.int_mm(a, b), a.int() @ b.int())


def test_load_zoo_model_waits_for_the_state_plane(tmp_path):
    """``load_zoo_model`` serves a ``save_model`` directory (here in int8,
    as ``load`` of the same weights does), and a missing one raises."""
    with pytest.raises(FileNotFoundError):
        InferenceModel(device="cpu").load_zoo_model("/nonexistent")
    model = port_models.BERTClassifier(2, **BERT_CFG)
    model.init_weights(torch.Generator().manual_seed(5))
    model.save_model(str(tmp_path))
    x = np.random.default_rng(5).integers(0, 100, (3, 16)).astype(np.int32)
    got = InferenceModel(device="cpu").load_zoo_model(
        str(tmp_path), dtype="int8").predict(x)
    want = InferenceModel(device="cpu").load(
        port_models.BERTClassifier(2, **BERT_CFG), model.state_dict(),
        dtype="int8").predict(x)
    np.testing.assert_array_equal(got, want)


def test_load_estimator_serves_a_copy_in_int8():
    """``load_estimator`` serves the Estimator's current variables from a
    copy of its model: int8 here, the Estimator's own model untouched."""
    model = tnn.Sequential([tnn.Dense(64, 128, "relu"), tnn.Dense(128, 4)])
    est = Estimator.from_keras(model, loss="mse", optimizer="sgd",
                               device="cpu")
    x = np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32)
    im = InferenceModel(device="cpu").load_estimator(est, dtype="int8")
    got = im.predict(x)
    assert im._model is not model
    assert type(getattr(model, "00_layer0")) is tnn.Dense
    want = InferenceModel(device="cpu").load(
        tnn.Sequential([tnn.Dense(64, 128, "relu"), tnn.Dense(128, 4)]),
        est.get_model(), dtype="int8").predict(x)
    np.testing.assert_array_equal(got, want)


def test_parameter_bytes_shrink_with_int8():
    """int8 stores each large weight at one byte an element (plus its
    scales), bf16 at two, f32 at four."""
    sizes = {}
    for dtype in (None, torch.bfloat16, "int8"):
        pm = tnn.Sequential([tnn.Dense(256, 512), tnn.Dense(512, 8)])
        variables = {k: v.detach().clone() for k, v in pm.state_dict().items()}
        sizes[str(dtype)] = InferenceModel(device="cpu").load(
            pm, variables, dtype=dtype).parameter_bytes()
    assert sizes["None"] == 4 * (256 * 512 + 512 + 512 * 8 + 8)
    assert sizes["torch.bfloat16"] == sizes["None"] // 2
    # both kernels (at least 4096 elements) int8 with f32 scales and a
    # one-byte marker each; the biases bf16
    assert sizes["int8"] == (256 * 512 + 4 * 512 + 1) + (512 * 8 + 4 * 8 + 1) \
        + 2 * (512 + 8)
