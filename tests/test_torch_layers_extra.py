"""The port's ``nn/layers_extra.py`` and the classes of ``nn/layers.py``
that came with it, against the JAX package: one parametrised forward and
gradient test over every deterministic layer, and the stochastic layers'
statistics.

Each case builds the JAX layer and the port's, loads the JAX ``init`` tree
into the port's with ``load_state_dict(strict=True)``, runs both on one
seeded input in eval mode, and holds the outputs and the gradients of
``sum(out * r)`` (``r`` a seeded cotangent) over every parameter and input
at ``tol`` (1e-5 of the largest magnitude by default; convs 1e-4).  The
stochastic layers draw from other generators in the two packages, so they
are held to identity in eval mode and, in training, to their mask
structure and moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as J
from _torch_layers import held
from analytics_zoo_tpu_torch import nn as P
from analytics_zoo_tpu_torch.convert import from_jax_variables, \
    to_jax_variables


CONV = 1e-4

CASES = {
    # nn/layers.py
    "reshape": (lambda: J.Reshape((3, 4)), lambda: P.Reshape((3, 4)),
                (2, 12)),
    "activation": (lambda: J.Activation("tanh"),
                   lambda: P.Activation("tanh"), (3, 5)),
    "lambda": (lambda: J.Lambda(lambda a: a * 2.0 + 1.0),
               lambda: P.Lambda(lambda a: a * 2.0 + 1.0), (3, 5)),
    "global_avg_pool_1d": (J.GlobalAveragePooling1D,
                           P.GlobalAveragePooling1D, (2, 6, 3)),
    "global_max_pool_1d": (J.GlobalMaxPooling1D, P.GlobalMaxPooling1D,
                           (2, 6, 3)),
    "concatenate": (lambda: J.Concatenate(axis=1),
                    lambda: P.Concatenate(axis=1), [(2, 3), (2, 4)]),
    "add": (J.Add, P.Add, [(2, 5), (2, 5), (2, 5)]),
    "multiply": (J.Multiply, P.Multiply, [(2, 5), (2, 5)]),
    # convolutions
    "conv3d_same": (lambda: J.Conv3D(4, 3, strides=(1, 2, 1)),
                    lambda: P.Conv3D(3, 4, 3, strides=(1, 2, 1)),
                    (2, 5, 6, 7, 3), (-2, 2), CONV),
    "conv3d_valid": (lambda: J.Conv3D(2, (2, 3, 2), padding="valid"),
                     lambda: P.Conv3D(3, 2, (2, 3, 2), padding="valid"),
                     (2, 4, 5, 4, 3), (-2, 2), CONV),
    "conv2d_transpose_k4_s2": (
        lambda: J.Conv2DTranspose(5, 4, strides=2),
        lambda: P.Conv2DTranspose(3, 5, 4, strides=2),
        (2, 4, 5, 3), (-2, 2), CONV),
    "conv2d_transpose_k3_s2": (
        lambda: J.Conv2DTranspose(4, 3, strides=2),
        lambda: P.Conv2DTranspose(3, 4, 3, strides=2),
        (2, 4, 5, 3), (-2, 2), CONV),
    "conv2d_transpose_k2_s3": (
        lambda: J.Conv2DTranspose(4, 2, strides=3, activation="relu"),
        lambda: P.Conv2DTranspose(3, 4, 2, strides=3, activation="relu"),
        (2, 3, 4, 3), (-2, 2), CONV),
    "conv2d_transpose_valid_from_1x1": (
        lambda: J.Conv2DTranspose(6, 4, padding="valid", use_bias=False),
        lambda: P.Conv2DTranspose(5, 6, 4, padding="valid",
                                  use_bias=False),
        (2, 1, 1, 5), (-2, 2), CONV),
    "depthwise_conv2d": (
        lambda: J.DepthwiseConv2D(3, strides=2, depth_multiplier=2),
        lambda: P.DepthwiseConv2D(3, 3, strides=2, depth_multiplier=2),
        (2, 7, 6, 3), (-2, 2), CONV),
    "separable_conv2d": (
        lambda: J.SeparableConv2D(5, 3, depth_multiplier=2,
                                  activation="relu"),
        lambda: P.SeparableConv2D(3, 5, 3, depth_multiplier=2,
                                  activation="relu"),
        (2, 6, 6, 3), (-2, 2), CONV),
    "locally_connected_1d": (
        lambda: J.LocallyConnected1D(4, 3, strides=2),
        lambda: P.LocallyConnected1D(3, 9, 4, 3, strides=2),
        (2, 9, 3)),
    # pools
    "max_pool_1d": (lambda: J.MaxPooling1D(3, 2),
                    lambda: P.MaxPooling1D(3, 2), (2, 9, 3)),
    "avg_pool_1d_same": (lambda: J.AveragePooling1D(2, padding="same"),
                         lambda: P.AveragePooling1D(2, padding="same"),
                         (2, 7, 3)),
    "max_pool_3d": (lambda: J.MaxPooling3D(2), lambda: P.MaxPooling3D(2),
                    (2, 4, 6, 4, 3)),
    "max_pool_3d_same": (lambda: J.MaxPooling3D(2, padding="same"),
                         lambda: P.MaxPooling3D(2, padding="same"),
                         (2, 3, 5, 4, 2)),
    "avg_pool_3d_same": (lambda: J.AveragePooling3D(2, padding="same"),
                         lambda: P.AveragePooling3D(2, padding="same"),
                         (2, 3, 5, 4, 2)),
    "global_avg_pool_3d": (J.GlobalAveragePooling3D,
                           P.GlobalAveragePooling3D, (2, 3, 4, 2, 3)),
    "global_max_pool_3d": (J.GlobalMaxPooling3D, P.GlobalMaxPooling3D,
                           (2, 3, 4, 2, 3)),
    # resizing, padding, cropping
    "upsampling_1d": (lambda: J.UpSampling1D(3),
                      lambda: P.UpSampling1D(3), (2, 4, 3)),
    "upsampling_2d": (lambda: J.UpSampling2D((2, 3)),
                      lambda: P.UpSampling2D((2, 3)), (2, 3, 4, 2)),
    "upsampling_3d": (lambda: J.UpSampling3D(2),
                      lambda: P.UpSampling3D(2), (2, 2, 3, 2, 2)),
    "zero_padding_1d": (lambda: J.ZeroPadding1D((1, 2)),
                        lambda: P.ZeroPadding1D((1, 2)), (2, 4, 3)),
    "zero_padding_3d": (lambda: J.ZeroPadding3D((1, 0, 2)),
                        lambda: P.ZeroPadding3D((1, 0, 2)), (2, 2, 3, 2, 2)),
    "cropping_1d": (lambda: J.Cropping1D((1, 2)),
                    lambda: P.Cropping1D((1, 2)), (2, 6, 3)),
    "cropping_2d": (lambda: J.Cropping2D(((1, 0), 2)),
                    lambda: P.Cropping2D(((1, 0), 2)), (2, 5, 6, 3)),
    "cropping_3d": (lambda: J.Cropping3D(1), lambda: P.Cropping3D(1),
                    (2, 4, 4, 5, 2)),
    # shape and sequence utilities
    "repeat_vector": (lambda: J.RepeatVector(3),
                      lambda: P.RepeatVector(3), (2, 4)),
    "permute": (lambda: J.Permute((2, 1)), lambda: P.Permute((2, 1)),
                (2, 3, 4)),
    "select": (lambda: J.Select(1, -1), lambda: P.Select(1, -1),
               (2, 3, 4)),
    "narrow": (lambda: J.Narrow(2, 1, 2), lambda: P.Narrow(2, 1, 2),
               (2, 3, 5)),
    "narrow_to_end": (lambda: J.Narrow(1, 1, -1),
                      lambda: P.Narrow(1, 1, -1), (2, 4, 3)),
    "squeeze": (J.Squeeze, P.Squeeze, (2, 1, 3, 1)),
    "squeeze_dim": (lambda: J.Squeeze(1), lambda: P.Squeeze(1),
                    (2, 1, 3, 1)),
    # activations
    "leaky_relu": (lambda: J.LeakyReLU(0.2), lambda: P.LeakyReLU(0.2),
                   (3, 6)),
    "elu": (lambda: J.ELU(0.7), lambda: P.ELU(0.7), (3, 6)),
    "thresholded_relu": (lambda: J.ThresholdedReLU(0.5),
                         lambda: P.ThresholdedReLU(0.5), (3, 6)),
    "srelu": (J.SReLU, lambda: P.SReLU(6), (3, 6)),
    "prelu": (J.PReLU, lambda: P.PReLU(6), (3, 6)),
    # merges
    "average": (J.Average, P.Average, [(2, 5), (2, 5), (2, 5)]),
    "maximum": (J.Maximum, P.Maximum, [(2, 5), (2, 5)]),
    "minimum": (J.Minimum, P.Minimum, [(2, 5), (2, 5)]),
    "subtract": (J.Subtract, P.Subtract, [(2, 5), (2, 5)]),
    "dot_batch": (lambda: J.Dot(axes=(2, 1)), lambda: P.Dot(axes=(2, 1)),
                  [(2, 3, 4), (2, 4, 5)]),
    "dot_normalize": (lambda: J.Dot(axes=-1, normalize=True),
                      lambda: P.Dot(axes=-1, normalize=True),
                      [(3, 6), (3, 6)]),
    # zoo extras
    "highway": (lambda: J.Highway("tanh"), lambda: P.Highway(5, "tanh"),
                (3, 5)),
    "maxout_dense": (lambda: J.MaxoutDense(4, nb_feature=3),
                     lambda: P.MaxoutDense(5, 4, nb_feature=3), (3, 5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_forward_and_gradient_match_jax(case):
    jf, pf, shapes, *rest = CASES[case]
    domain = rest[0] if rest else (-2.0, 2.0)
    tol = rest[1] if len(rest) > 1 else 1e-5
    held(jf(), pf(), shapes, domain, tol)


def test_masking_zeroes_whole_timesteps():
    x = np.random.default_rng(1).normal(size=(2, 5, 3)).astype(np.float32)
    x[0, 1] = 0.0
    x[1, 3] = 0.5
    for mask_value in (0.0, 0.5):
        jl, pl = J.Masking(mask_value), P.Masking(mask_value)
        want, _ = jl.apply({"params": {}}, jnp.asarray(x))
        got = pl(torch.as_tensor(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_out_of_range_raises():
    with pytest.raises(ValueError, match="out of range"):
        P.Select(1, 3)(torch.zeros(2, 3))


def test_conv_kernels_carry_across_both_ways():
    """5-D (Conv3D) and transposed-conv kernels go JAX -> port -> JAX
    unchanged, and the port's layout is the one its conv consumes."""
    jl = J.Conv3D(4, (2, 3, 1))
    v = jl.init(jax.random.PRNGKey(1), jnp.ones((1, 3, 4, 5, 2)))
    sd = from_jax_variables(v)
    assert tuple(sd["kernel"].shape) == (4, 2, 2, 3, 1)
    back = to_jax_variables(sd)
    np.testing.assert_array_equal(back["params"]["kernel"],
                                  np.asarray(v["params"]["kernel"]))
    jt = J.Conv2DTranspose(6, (3, 2), strides=2)
    vt = jt.init(jax.random.PRNGKey(2), jnp.ones((1, 4, 4, 5)))
    st = from_jax_variables(vt)
    layer = P.Conv2DTranspose(5, 6, (3, 2), strides=2)
    layer.load_state_dict(st, strict=True)
    np.testing.assert_array_equal(
        to_jax_variables(layer.state_dict())["params"]["kernel"],
        np.asarray(vt["params"]["kernel"]))


# -- stochastic layers ------------------------------------------------------

def _gen_model(layer, seed=0):
    P.seed_dropout(layer, seed, torch.device("cpu"))
    return layer


@pytest.mark.parametrize("cls,shape,channel_axes", [
    (P.SpatialDropout1D, (64, 7, 32), (1,)),
    (P.SpatialDropout2D, (64, 3, 4, 32), (1, 2)),
    (P.SpatialDropout3D, (32, 2, 3, 2, 32), (1, 2, 3))])
def test_spatial_dropout_drops_whole_channels(cls, shape, channel_axes):
    x = torch.rand(shape) + 0.5
    layer = _gen_model(cls(0.25))
    layer.eval()
    assert layer(x) is x
    jx = jnp.asarray(x.numpy())
    jl = getattr(J, cls.__name__)(0.25)
    assert jl.apply({}, jx)[0] is jx
    layer.train()
    y = layer(x)
    kept = (y != 0)
    # one draw a (sample, channel): a channel is all kept or all dropped
    assert torch.equal(kept.all(dim=channel_axes),
                       kept.any(dim=channel_axes))
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    dropped = 1.0 - kept.float().mean().item()
    assert abs(dropped - 0.25) < 0.06
    jy = np.asarray(jl.apply({}, jx, training=True,
                             rng=jax.random.PRNGKey(0))[0])
    assert abs((1.0 - (jy != 0).mean()) - dropped) < 0.08


def test_gaussian_noise_and_dropout_moments():
    x = torch.full((400, 250), 2.0)
    noise = _gen_model(P.GaussianNoise(0.3))
    gdrop = _gen_model(P.GaussianDropout(0.2))
    for layer in (noise, gdrop):
        layer.eval()
        assert layer(x) is x
        layer.train()
    n = noise(x) - x
    assert abs(n.mean().item()) < 0.01 and abs(n.std().item() - 0.3) < 0.01
    m = gdrop(x) / x
    std = (0.2 / 0.8) ** 0.5
    assert abs(m.mean().item() - 1.0) < 0.01
    assert abs(m.std().item() - std) < 0.01
    jx = jnp.asarray(x.numpy())
    jn = np.asarray(J.GaussianNoise(0.3).apply(
        {}, jx, training=True, rng=jax.random.PRNGKey(0))[0]) - 2.0
    assert abs(jn.std() - n.std().item()) < 0.01
    # the draws come from the model's dropout generator: reseeding it
    # repeats them (the second draw after the seed is this one's)
    second = noise(x)
    _gen_model(noise)
    assert torch.equal(noise(x), _gen_model(P.GaussianNoise(0.3))(x))
    assert torch.equal(noise(x), second)
