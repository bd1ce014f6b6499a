"""The port's losses, top-k metric and activation registry against the JAX
package on the CPU, at the points where PyTorch's own primitives give
other gradients or another order: a clip's bound hit exactly (``jnp.clip``
and ``jnp.maximum`` split the gradient 0.5 / 0.5, ``torch.clamp`` does
not), an absolute value at 0 (``jnp.abs`` has gradient 1 there,
``torch.abs`` 0), ties among top-k scores (``jax.lax.top_k`` puts the lower
index first) and the kinks of the activations.  Also a ``Dense`` with no
bias loaded through ``convert``, and the dense attention core on bf16
operands (its own tolerance, in the test).

Tolerances: values and gradients 1e-6 relative and absolute (the same f32
arithmetic); top-k statistics exactly.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
import analytics_zoo_tpu.nn.activations as jacts
import analytics_zoo_tpu.nn.losses as jlosses
import analytics_zoo_tpu.nn.metrics as jmetrics
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.nn import activations, losses, metrics

TOL = 1e-6
F32 = np.float32


def _rng(seed):
    return np.random.default_rng(seed)


def _tie_inputs(name):
    """(y_pred, y_true) for loss ``name``, f32, with the values that hit its
    clip bounds and the zeros of its absolute values among random ones."""
    rng = _rng(zlib.crc32(name.encode()))
    if name in ("sparse_categorical_crossentropy", "sparse_probs"):
        p = rng.uniform(0.1, 0.9, (4, 5)).astype(F32)
        p[0] = [1.0, 0.0, 0.0, 0.0, 0.0]       # p = 1 and p = 0 at the clip
        p[1, 2] = F32(1e-7)
        return p, np.array([0, 2, 3, 4], np.int32)
    if name in ("categorical_crossentropy", "categorical_probs", "kld"):
        p = rng.uniform(0.1, 0.9, (4, 5)).astype(F32)
        p[0] = [1.0, 0.0, 0.0, 0.0, 0.0]
        p[1, 2] = F32(1e-7)
        t = rng.uniform(0.0, 1.0, (4, 5)).astype(F32)
        t[0] = [1.0, 0.0, 0.0, 0.0, 0.0]
        t[2, 1] = F32(1e-7)
        return p, t
    if name == "binary_crossentropy":               # logits: 0 ties both
        p = rng.normal(size=(6,)).astype(F32)
        p[:2] = 0.0
        return p, np.array([1, 0, 1, 0, 1, 1], F32)
    if name == "binary_probs":
        p = rng.uniform(0.1, 0.9, (6,)).astype(F32)
        p[0], p[1] = F32(1e-7), F32(1 - 1e-7)
        return p, np.array([1, 0, 1, 0, 1, 1], F32)
    if name in ("hinge", "squared_hinge"):          # margin exactly 1
        t = np.array([1, -1, 1, -1, 1, -1], F32)
        p = rng.normal(size=(6,)).astype(F32)
        p[:2] = t[:2]
        return p, t
    if name == "huber":                             # |err| 0 and delta
        t = rng.normal(size=(6,)).astype(F32)
        p = t + rng.normal(size=(6,)).astype(F32) * 2
        p[0], p[1], p[2] = t[0], t[1] + 1.0, t[2] - 1.0
        return p.astype(F32), t
    if name in ("msle", "poisson"):                 # y at 0 and at 1e-7
        p = rng.uniform(0.1, 3.0, (6,)).astype(F32)
        t = rng.uniform(0.0, 3.0, (6,)).astype(F32)
        p[0], t[1] = 0.0, 0.0
        p[2] = F32(1e-7)
        return p, t
    if name == "mape":                              # zero error, |y| 1e-7
        t = rng.normal(size=(6,)).astype(F32)
        t[1] = F32(1e-7)
        p = t + rng.normal(size=(6,)).astype(F32)
        p[0] = t[0]
        return p.astype(F32), t
    # mae, mse, cosine_proximity: zero errors and zero entries
    t = rng.normal(size=(4, 3)).astype(F32)
    p = t + rng.normal(size=(4, 3)).astype(F32)
    p[0] = t[0]
    p[1, 0] = 0.0
    return p.astype(F32), t


def _loss_cases():
    """(case name, JAX fn, port fn): every loss of the registry, and the
    probability forms of the crossentropies."""
    cases = [(name, jlosses.LOSSES[name], losses.LOSSES[name], name)
             for name in sorted(losses.LOSSES)]
    short = {"mean_squared_error": "mse", "mean_absolute_error": "mae",
             "mean_absolute_percentage_error": "mape",
             "mean_squared_logarithmic_error": "msle"}
    cases = [(n, j, t, short.get(k, k)) for n, j, t, k in cases]
    for name, inputs in (("sparse_categorical_crossentropy", "sparse_probs"),
                         ("categorical_crossentropy", "categorical_probs"),
                         ("binary_crossentropy", "binary_probs")):
        cases.append((f"{name}(from_logits=False)",
                      functools.partial(jlosses.LOSSES[name],
                                        from_logits=False),
                      functools.partial(losses.LOSSES[name],
                                        from_logits=False), inputs))
    return cases


def test_every_registered_loss_has_a_tie_case():
    assert sorted(losses.LOSSES) == sorted(jlosses.LOSSES)
    assert len(_loss_cases()) == len(losses.LOSSES) + 3


@pytest.mark.parametrize("case", [c[0] for c in _loss_cases()])
def test_loss_value_and_gradients_at_ties_match_jax(case):
    _, jfn, tfn, inputs = next(c for c in _loss_cases() if c[0] == case)
    y_pred, y_true = _tie_inputs(inputs)
    float_true = y_true.dtype == F32
    argnums = (0, 1) if float_true else (0,)
    want, jgrads = jax.value_and_grad(jfn, argnums=argnums)(
        jnp.asarray(y_pred), jnp.asarray(y_true))
    tp = torch.from_numpy(y_pred).requires_grad_()
    tt = torch.from_numpy(y_true)
    if float_true:
        tt.requires_grad_()
    got = tfn(tp, tt)
    tgrads = torch.autograd.grad(got, (tp, tt) if float_true else (tp,))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# the losses as torch.clamp and torch.abs would write them: what the tie
# cases guard against
_NAIVE = {
    "kld": lambda p, t: (torch.clamp(t, 1e-7, 1.0) * torch.log(
        torch.clamp(t, 1e-7, 1.0) / torch.clamp(p, 1e-7, 1.0))).sum(-1).mean(),
    "mae": lambda p, t: torch.abs(p - t).mean(),
    "hinge": lambda p, t: torch.clamp(1.0 - t * p, min=0.0).mean(),
    "msle": lambda p, t: torch.square(torch.log1p(torch.clamp(p, min=0.0))
                                      - torch.log1p(torch.clamp(t, min=0.0))
                                      ).mean(),
}


@pytest.mark.parametrize("name,point,target", [
    ("kld", 1.0, 1.0), ("mae", 0.0, 0.0), ("hinge", 1.0, 1.0),
    ("msle", 0.0, 0.5)])
def test_gradient_at_a_single_tie_is_jax_not_clamps(name, point, target):
    """One element at the tie: the port's gradient is JAX's, and
    torch.clamp / torch.abs would give another there."""
    def grad(fn):
        p = torch.tensor([point], requires_grad=True)
        (g,) = torch.autograd.grad(fn(p, torch.tensor([target])), (p,))
        return g.numpy()
    jg = jax.grad(jlosses.get(name))(jnp.asarray([point], jnp.float32),
                                     jnp.asarray([target], jnp.float32))
    np.testing.assert_allclose(grad(losses.get(name)), np.asarray(jg),
                               rtol=TOL, atol=TOL)
    assert np.abs(grad(_NAIVE[name]) - np.asarray(jg)).max() > 1e-3


def _topk_stats(k, y_pred, y_true):
    jm, tm = jmetrics.TopKAccuracy(k), metrics.TopKAccuracy(k)
    jstats = jm.update(jnp.asarray(y_pred, jnp.bfloat16), jnp.asarray(y_true))
    tstats = tm.update(torch.from_numpy(y_pred).to(torch.bfloat16),
                       torch.from_numpy(y_true))
    return tstats.numpy(), np.asarray(jstats)


@pytest.mark.parametrize("label", range(8))
def test_topk_breaks_ties_by_the_lower_index(label):
    """[1, 2, 2, 2, 2, 2, 2, 0]: six scores tie for first place; top 5 are
    indices 1-5, so label 6 misses, as in jax.lax.top_k."""
    y = np.array([[1, 2, 2, 2, 2, 2, 2, 0]], F32)
    got, want = _topk_stats(5, y, np.array([label], np.int32))
    np.testing.assert_array_equal(got, want)
    assert got[0] == float(1 <= label <= 5)


def test_topk_on_bf16_ties_matches_jax():
    """bf16 scores on a coarse grid tie often (and np.round leaves -0
    beside +0, which jax.lax.top_k ranks below it); every k agrees
    exactly."""
    rng = _rng(7)
    y = (np.round(rng.normal(size=(64, 40)) * 2) / 2).astype(F32)
    lab = rng.integers(0, 40, (64,)).astype(np.int32)
    for k in (1, 3, 5, 10):
        got, want = _topk_stats(k, y, lab)
        np.testing.assert_array_equal(got, want)


ACT_NAMES = sorted(k for k in jacts.ACTIVATIONS if k) + [None]


def test_activation_registry_has_every_jax_name():
    assert set(activations.ACTIVATIONS) == set(jacts.ACTIVATIONS)


@pytest.mark.parametrize("name", ACT_NAMES)
def test_activation_values_and_gradients_match_jax(name):
    """At 0, +-3, 6 (the kinks of relu, relu6, hard_sigmoid, leaky_relu)
    and random points; the gradient of sum(f(x) * w) for a random w (so
    softmax's gradient is not zero)."""
    rng = _rng(3)
    x = np.concatenate([[0.0, 3.0, -3.0, 6.0, -6.0],
                        rng.normal(size=11) * 4]).astype(F32).reshape(2, 8)
    w = rng.normal(size=x.shape).astype(F32)
    jf = jacts.get(name)
    want, jg = jax.value_and_grad(lambda a: (jf(a) * w).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tf = activations.get(name)
    got = (tf(tx) * torch.from_numpy(w)).sum()
    (tg,) = torch.autograd.grad(got, (tx,))
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)


def test_activation_get_takes_a_callable():
    def fn(x):
        return x * 2
    assert activations.get(fn) is fn
    with pytest.raises(ValueError, match="unknown activation"):
        activations.get("no-such")


def _x(seed, *shape):
    return _rng(seed).normal(size=shape).astype(F32)


def _dense_pair(jdense, tdense, x):
    variables = jdense.init(jax.random.PRNGKey(0), x)
    tdense.load_state_dict(from_jax_variables(variables), strict=True)
    want, _ = jdense.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tdense(torch.from_numpy(x))
    return variables, np.asarray(want), got.numpy()


@pytest.mark.parametrize("activation", ["linear", "sigmoid", "softmax",
                                        "relu6", "hard_sigmoid", "elu"])
def test_dense_with_any_activation_name_matches_jax(activation):
    x = _x(0, 3, 5, 16) * 3.0
    _, want, got = _dense_pair(jnn.Dense(24, activation=activation),
                               tnn.Dense(16, 24, activation=activation), x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dense_without_bias_loads_through_convert():
    x = _x(1, 4, 16)
    variables, want, got = _dense_pair(jnn.Dense(8, use_bias=False),
                                       tnn.Dense(16, 8, use_bias=False), x)
    assert set(from_jax_variables(variables)) == {"kernel"}
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert tnn.Dense(16, 8, use_bias=False).bias is None


def test_dense_takes_initializers_by_name_and_callable():
    def fill(t, generator=None):
        with torch.no_grad():
            return t.fill_(0.25)
    d = tnn.Dense(6, 3, kernel_init=fill, bias_init="ones")
    assert torch.all(d.kernel == 0.25) and torch.all(d.bias == 1.0)
    d = tnn.Dense(6, 3, kernel_init="zeros", activation=lambda y: y + 1)
    assert torch.all(d(torch.ones(2, 6)) == 1.0)


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_dense_attention_matches_jax(masked):
    """The dense attention core on bf16 q, k, v against the JAX package's
    (``preferred_element_type=jnp.float32`` logits): the output and the
    q, k, v gradients under one bf16 cotangent.  Both round to bf16 at the
    same places (the weights, the output, each gradient) from f32 values
    that differ only in summation order, so a value may land one bf16 step
    (2^-8 of its size) away: held to 2^-7 of each tensor's max |ref|."""
    from analytics_zoo_tpu.nn.attention import \
        dot_product_attention as jattn
    from analytics_zoo_tpu_torch.nn import dot_product_attention
    rng = _rng(21)
    q, k, v, g = (rng.normal(size=(2, 7, 3, 8)).astype(F32)
                  for _ in range(4))
    mask = (rng.random((2, 1, 7, 7)) < 0.7) if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    want, vjp = jax.vjp(lambda a, b, c: jattn(a, b, c, mask_j), jq, jk, jv)
    want_grads = vjp(jg)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    got = dot_product_attention(tq, tk, tv, mask_t)
    got.backward(torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16
    for name, t, j in (("out", got, want), ("dq", tq.grad, want_grads[0]),
                       ("dk", tk.grad, want_grads[1]),
                       ("dv", tv.grad, want_grads[2])):
        ref = np.asarray(j.astype(jnp.float32))
        np.testing.assert_allclose(t.detach().float().numpy(), ref, rtol=0,
                                   atol=2.0 ** -7 * np.abs(ref).max(),
                                   err_msg=name)
