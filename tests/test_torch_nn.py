"""Differential tests: the PyTorch port's layers against the JAX package's
on the CPU.

Each layer is initialised in JAX, its variables go through
``convert.from_jax_variables`` into the port's module, and the same numpy
inputs go through both.  Tolerance 1e-5 (f32; the two frameworks sum in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
import analytics_zoo_tpu_torch.nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(jmod, tmod, *inputs, **kw):
    """Init ``jmod`` in JAX on ``inputs``, load its variables into
    ``tmod``, return (jax output, port output) as numpy."""
    variables = jmod.init(jax.random.PRNGKey(0), *inputs)
    tmod.load_state_dict(from_jax_variables(variables), strict=True)
    tmod.eval()
    want, _ = jmod.apply(variables, *(jnp.asarray(x) for x in inputs), **kw)
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(x) for x in inputs), **tkw)
    return np.asarray(want), got.numpy()


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("activation", [None, "gelu", "tanh"])
def test_dense_matches_jax(activation):
    """gelu must be the tanh approximation (jax.nn.gelu's default)."""
    x = _x(0, 3, 5, 16) * 3.0
    want, got = _run_both(jnn.Dense(24, activation=activation),
                          tnn.Dense(16, 24, activation=activation), x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_gelu_is_the_tanh_form_not_erf():
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    got = tnn.activations.get("gelu")(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    erf = torch.nn.functional.gelu(x).numpy()
    assert np.abs(erf - want).max() > 1e-4  # the trap this guards against


def test_activation_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown activation"):
        tnn.activations.get("no-such")


def test_layer_norm_matches_jax():
    x = _x(1, 2, 7, 32) * 4.0 + 1.0
    jm = jnn.LayerNormalization()
    variables = jm.init(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(2)  # non-trivial gamma / beta
    variables["params"]["gamma"] = rng.normal(size=32).astype(np.float32)
    variables["params"]["beta"] = rng.normal(size=32).astype(np.float32)
    tm = tnn.LayerNormalization(32)
    tm.load_state_dict(from_jax_variables(variables))
    want, _ = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_layer_norm_keeps_bf16_and_takes_f32_stats():
    x = torch.from_numpy(_x(3, 4, 32) * 100.0 + 1000.0).bfloat16()
    ln = tnn.LayerNormalization(32)
    y = ln(x)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (32,), eps=1e-6)
    assert (y.float() - ref).abs().max().item() < 2e-2


def test_embedding_matches_jax():
    ids = np.random.default_rng(4).integers(0, 50, size=(3, 9)).astype(
        np.int32)
    want, got = _run_both(jnn.Embedding(50, 16), tnn.Embedding(50, 16), ids)
    np.testing.assert_allclose(got, want, atol=0, rtol=0)


def test_dropout_is_identity_in_eval_and_drops_in_training():
    d = tnn.Dropout(0.5)
    x = torch.ones(1000)
    assert torch.equal(d.eval()(x), x)
    y = d.train()(x)
    assert 0 < (y == 0).sum().item() < 1000
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}


@pytest.mark.parametrize("use_flash", [True, False, "auto"])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_matches_jax(use_flash, causal):
    x = _x(5, 2, 13, 32)
    want, got = _run_both(
        jnn.MultiHeadAttention(4, use_flash=use_flash, causal=causal),
        tnn.MultiHeadAttention(32, 4, use_flash=use_flash, causal=causal), x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mha_cross_attention_with_head_dim_matches_jax():
    """kv of another length than x (Tq != Tk), head_dim != d_model / H."""
    x, kv = _x(10, 2, 7, 32), _x(11, 2, 12, 32)
    variables = jnn.MultiHeadAttention(4, head_dim=16).init(
        jax.random.PRNGKey(0), x, kv)
    jm = jnn.MultiHeadAttention(4, head_dim=16, use_flash=True)
    tm = tnn.MultiHeadAttention(32, 4, head_dim=16, use_flash=True)
    tm.load_state_dict(from_jax_variables(variables))
    want, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(kv))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_mha_with_mask_takes_the_dense_path_and_matches_jax():
    x = _x(6, 2, 11, 32)
    mask = (np.random.default_rng(7).random((2, 1, 11, 11)) > 0.3)
    mask[..., 0] = True  # every query attends somewhere
    want, got = _run_both(jnn.MultiHeadAttention(4, use_flash=True),
                          tnn.MultiHeadAttention(32, 4, use_flash=True),
                          x, mask=mask)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mha_flash_calls_the_kernel_wrapper(monkeypatch):
    """use_flash=True without a mask goes through ops.flash_attention."""
    import importlib
    tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    calls = []
    real = tfa.flash_attention_fwd

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    x = torch.randn(2, 9, 32)
    tnn.MultiHeadAttention(32, 4, use_flash=True)(x)
    assert calls == [(8, 9, 8)]
    tnn.MultiHeadAttention(32, 4, use_flash=False)(x)
    tnn.MultiHeadAttention(32, 4, use_flash="auto")(x)  # T < the threshold
    assert len(calls) == 1


def test_mha_rejects_bad_use_flash():
    with pytest.raises(ValueError, match="use_flash"):
        tnn.MultiHeadAttention(32, 4, use_flash="yes")


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("use_flash", [True, False])
def test_transformer_layer_matches_jax(pre_ln, use_flash):
    x = _x(8, 2, 10, 32)
    want, got = _run_both(
        jnn.TransformerLayer(4, pre_ln=pre_ln, use_flash=use_flash),
        tnn.TransformerLayer(32, 4, pre_ln=pre_ln, use_flash=use_flash), x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tq,tk", [(5, 5), (3, 7)])
def test_causal_mask_matches_jax(tq, tk):
    want = np.asarray(jnn.attention.causal_mask(tq, tk))
    np.testing.assert_array_equal(tnn.causal_mask(tq, tk).numpy(), want)


def test_dot_product_attention_matches_jax():
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    want = jnn.attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tnn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_initializers_draw_the_jax_distributions_from_a_generator():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tnn.initializers.glorot_uniform(torch.empty(300, 200), g())
    b = tnn.initializers.glorot_uniform(torch.empty(300, 200), g())
    assert torch.equal(a, b)  # same generator state, same numbers
    limit = np.sqrt(6.0 / 500)
    assert a.abs().max().item() <= limit and a.abs().max().item() > 0.9 * limit
    n = tnn.initializers.get("normal")(torch.empty(100000), g())
    assert abs(n.std().item() - 0.05) < 2e-3
    assert torch.equal(tnn.initializers.get("ones")(torch.empty(3)),
                       torch.ones(3))
    assert torch.equal(tnn.initializers.get("zeros")(torch.empty(3)),
                       torch.zeros(3))
    # he_normal on an OIHW conv kernel: a normal truncated at 2 std devs,
    # std sqrt(2 / (I * H * W)) after truncation
    k = tnn.initializers.get("he_normal")(torch.empty(64, 16, 3, 3),
                                          torch.Generator().manual_seed(3))
    std = np.sqrt(2.0 / (16 * 9))
    assert abs(k.std().item() - std) < 0.03 * std
    assert k.abs().max().item() <= 2.0 * std / 0.87962566103423978
    with pytest.raises(ValueError, match="unknown initializer"):
        tnn.initializers.get("lecun_uniform")
