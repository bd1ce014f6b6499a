"""The port's ``nn/layers_zoo.py`` against the JAX package: one
parametrised forward and gradient test over every deterministic layer
(``_torch_layers.held``: outputs and gradients at 1e-5 of the largest
magnitude, convs and the convolutional LSTMs 1e-4), the stochastic
layers' statistics, and the recurrences' shapes and step order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as J
from _torch_layers import held
from analytics_zoo_tpu_torch import nn as P
from analytics_zoo_tpu_torch.convert import from_jax_variables

CONV = 1e-4
POS = (0.2, 2.0)

CASES = {
    "conv_lstm2d": (
        lambda: J.ConvLSTM2D(4, 3),
        lambda: P.ConvLSTM2D(2, 4, 3), (2, 3, 5, 4, 2), (-1, 1), CONV),
    "conv_lstm2d_sequences_backwards_strided": (
        lambda: J.ConvLSTM2D(3, (3, 2), strides=2, padding="valid",
                             return_sequences=True, go_backwards=True),
        lambda: P.ConvLSTM2D(2, 3, (3, 2), strides=2, padding="valid",
                             return_sequences=True, go_backwards=True),
        (2, 4, 7, 6, 2), (-1, 1), CONV),
    "conv_lstm3d": (
        lambda: J.ConvLSTM3D(3, 2, return_sequences=True),
        lambda: P.ConvLSTM3D(2, 3, 2, return_sequences=True),
        (1, 3, 3, 4, 3, 2), (-1, 1), CONV),
    "conv_lstm2d_tanh_gates": (
        lambda: J.ConvLSTM2D(2, 3, recurrent_activation="sigmoid",
                             unit_forget_bias=False),
        lambda: P.ConvLSTM2D(3, 2, 3, recurrent_activation="sigmoid",
                             unit_forget_bias=False),
        (2, 2, 4, 4, 3), (-1, 1), CONV),
    "locally_connected_2d": (
        lambda: J.LocallyConnected2D(4, (3, 2), strides=(2, 1)),
        lambda: P.LocallyConnected2D(3, (7, 5), 4, (3, 2), strides=(2, 1)),
        (2, 7, 5, 3), (-2, 2), CONV),
    "conv3d_transpose": (
        lambda: J.Conv3DTranspose(3, (3, 2, 2), strides=2),
        lambda: P.Conv3DTranspose(2, 3, (3, 2, 2), strides=2),
        (2, 2, 3, 2, 2), (-2, 2), CONV),
    "conv3d_transpose_valid": (
        lambda: J.Conv3DTranspose(2, 2, padding="valid"),
        lambda: P.Conv3DTranspose(3, 2, 2, padding="valid"),
        (1, 2, 2, 3, 3), (-2, 2), CONV),
    "conv1d_transpose": (
        lambda: J.Conv1DTranspose(4, 3, strides=2, activation="tanh"),
        lambda: P.Conv1DTranspose(3, 4, 3, strides=2, activation="tanh"),
        (2, 5, 3), (-2, 2), CONV),
    "separable_conv1d": (
        lambda: J.SeparableConv1D(5, 3, strides=2, depth_multiplier=2),
        lambda: P.SeparableConv1D(3, 5, 3, strides=2, depth_multiplier=2),
        (2, 9, 3), (-2, 2), CONV),
    "softmax": (lambda: J.Softmax(axis=1), lambda: P.Softmax(axis=1),
                (2, 5, 3)),
    "lrn2d": (lambda: J.LRN2D(alpha=1e-2, n=3),
              lambda: P.LRN2D(alpha=1e-2, n=3), (2, 3, 3, 6)),
    "cos": (J.Cos, P.Cos, [(3, 6), (3, 6)]),
    "identity": (J.Identity, P.Identity, (2, 4)),
    "exp": (J.Exp, P.Exp, (2, 4)),
    "log": (J.Log, P.Log, (2, 4), POS),
    "sqrt": (J.Sqrt, P.Sqrt, (2, 4), POS),
    "square": (J.Square, P.Square, (2, 4)),
    "power": (lambda: J.Power(2.5, 0.5, 1.0), lambda: P.Power(2.5, 0.5, 1.0),
              (2, 4), POS),
    "negative": (J.Negative, P.Negative, (2, 4)),
    "add_constant": (lambda: J.AddConstant(1.5),
                     lambda: P.AddConstant(1.5), (2, 4)),
    "mul_constant": (lambda: J.MulConstant(-2.0),
                     lambda: P.MulConstant(-2.0), (2, 4)),
    "scale": (J.Scale, lambda: P.Scale(4), (3, 4)),
    "threshold": (lambda: J.Threshold(0.3, -1.0),
                  lambda: P.Threshold(0.3, -1.0), (3, 5)),
    "hard_shrink": (lambda: J.HardShrink(0.4), lambda: P.HardShrink(0.4),
                    (3, 5)),
    "soft_shrink": (lambda: J.SoftShrink(0.4), lambda: P.SoftShrink(0.4),
                    (3, 5)),
    "cadd": (lambda: J.CAdd((1, 5)), lambda: P.CAdd((1, 5)), (3, 5)),
    "cmul": (lambda: J.CMul((5,)), lambda: P.CMul((5,)), (3, 5)),
    "hard_tanh": (lambda: J.HardTanh(-0.5, 0.7),
                  lambda: P.HardTanh(-0.5, 0.7), (3, 5)),
    "resize_bilinear": (lambda: J.ResizeBilinear(7, 5),
                        lambda: P.ResizeBilinear(7, 5), (2, 4, 3, 2)),
    "resize_bilinear_align_corners": (
        lambda: J.ResizeBilinear(3, 8, align_corners=True),
        lambda: P.ResizeBilinear(3, 8, align_corners=True), (2, 5, 4, 2)),
    "merge_sum": (lambda: J.Merge("sum"), lambda: P.Merge("sum"),
                  [(2, 4), (2, 4)]),
    "merge_mul": (lambda: J.Merge("mul"), lambda: P.Merge("mul"),
                  [(2, 4), (2, 4)]),
    "merge_ave": (lambda: J.Merge("ave"), lambda: P.Merge("ave"),
                  [(2, 4), (2, 4), (2, 4)]),
    "merge_max": (lambda: J.Merge("max"), lambda: P.Merge("max"),
                  [(2, 4), (2, 4)]),
    "merge_min": (lambda: J.Merge("min"), lambda: P.Merge("min"),
                  [(2, 4), (2, 4)]),
    "merge_concat": (lambda: J.Merge("concat", concat_axis=1),
                     lambda: P.Merge("concat", concat_axis=1),
                     [(2, 3), (2, 4)]),
    "merge_dot": (lambda: J.Merge("dot", dot_axes=1),
                  lambda: P.Merge("dot", dot_axes=1), [(3, 4), (3, 4)]),
    "merge_cos": (lambda: J.Merge("cos"), lambda: P.Merge("cos"),
                  [(3, 4), (3, 4)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_forward_and_gradient_match_jax(case):
    jf, pf, shapes, *rest = CASES[case]
    domain = rest[0] if rest else (-2.0, 2.0)
    tol = rest[1] if len(rest) > 1 else 1e-5
    held(jf(), pf(), shapes, domain, tol)


def test_merge_function_on_tensors():
    a, b = np.ones((2, 3), np.float32), np.full((2, 3), 2.0, np.float32)
    for mode in ("sum", "mul", "concat", "dot"):
        want = J.merge([jnp.asarray(a), jnp.asarray(b)], mode=mode)
        got = P.merge([torch.as_tensor(a), torch.as_tensor(b)], mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown merge mode"):
        P.Merge("nope")


def test_conv_lstm_steps_each_input_once_through_unbind():
    """Each step's input is one view of an unbind (the backward of x[:, i]
    makes a zero-filled copy a step); the recurrence's last hidden state is
    the last of the sequences, and backwards the first step is the last
    frame."""
    layer = P.ConvLSTM2D(2, 3, 3, return_sequences=True)
    x = torch.randn(2, 5, 4, 4, 2)
    seq = layer(x)
    last = P.ConvLSTM2D(2, 3, 3)
    last.load_state_dict(layer.state_dict())
    torch.testing.assert_close(last(x), seq[:, -1])
    back = P.ConvLSTM2D(2, 3, 3, return_sequences=True, go_backwards=True)
    back.load_state_dict(layer.state_dict())
    torch.testing.assert_close(back(x.flip(1)), seq)
    seen = []
    orig = torch.Tensor.unbind

    def spy(self, dim=0):
        seen.append(dim)
        return orig(self, dim)

    torch.Tensor.unbind = spy
    try:
        layer(x)
    finally:
        torch.Tensor.unbind = orig
    assert seen == [1]


def test_resize_bilinear_is_the_corner_origin_grid():
    """Not F.interpolate's half-pixel grid: output pixel i samples input
    i * in / out."""
    x = torch.arange(8.0).reshape(1, 1, 8, 1)
    y = P.ResizeBilinear(1, 4)(x)
    assert y.flatten().tolist() == [0.0, 2.0, 4.0, 6.0]
    half = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(1, 4), mode="bilinear",
        align_corners=False).flatten().tolist()
    assert half != y.flatten().tolist()


def test_activity_regularization_records_the_penalty():
    x = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    jl = J.ActivityRegularization(l1=0.1, l2=0.01)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out, state = jl.apply(variables, jnp.asarray(x), training=True)
    pl = P.ActivityRegularization(l1=0.1, l2=0.01)
    pl.load_state_dict(from_jax_variables(variables), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    y = pl(xt)
    assert torch.equal(y, xt)
    np.testing.assert_allclose(pl.aux_loss.item(), float(state["aux_loss"]),
                               rtol=1e-6)
    (g,) = torch.autograd.grad(pl.penalty, xt)
    np.testing.assert_allclose(g.numpy(),
                               0.1 * np.sign(x) + 0.02 * x, rtol=1e-5)


def test_alpha_dropout_keeps_selu_moments():
    x = torch.randn(500, 400)
    layer = P.AlphaDropout(0.2)
    P.seed_dropout(layer, 0, torch.device("cpu"))
    layer.eval()
    assert layer(x) is x
    layer.train()
    y = layer(x)
    keep = 0.8
    alpha_p = P.AlphaDropout._ALPHA_P
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    dropped = torch.isclose(y, torch.full_like(y, a * alpha_p + b))
    assert abs(dropped.float().mean().item() - 0.2) < 0.01
    torch.testing.assert_close(y[~dropped], a * x[~dropped] + b)
    assert abs(y.mean().item()) < 0.02 and abs(y.std().item() - 1.0) < 0.02
    jy = np.asarray(J.AlphaDropout(0.2).apply(
        {}, jnp.asarray(x.numpy()), training=True,
        rng=jax.random.PRNGKey(0))[0])
    assert abs(jy.std() - y.std().item()) < 0.02


def test_gaussian_sampler_moments():
    mean = torch.full((400, 300), 1.5)
    log_var = torch.full((400, 300), np.log(0.25))
    layer = P.GaussianSampler()
    P.seed_dropout(layer, 0, torch.device("cpu"))
    layer.eval()
    assert layer([mean, log_var]) is mean
    layer.train()
    z = layer([mean, log_var])
    assert abs(z.mean().item() - 1.5) < 0.01
    assert abs(z.std().item() - 0.5) < 0.01
    jz = np.asarray(J.GaussianSampler().apply(
        {}, [jnp.asarray(mean.numpy()), jnp.asarray(log_var.numpy())],
        training=True, rng=jax.random.PRNGKey(0))[0])
    assert abs(jz.std() - z.std().item()) < 0.01
