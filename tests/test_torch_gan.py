"""``GANEstimator`` in the port against the JAX package (the twins of
``tests/test_gan.py``), on ``chip_smoke.dcgan``'s DCGAN at ngf = ndf = 8
and 16x16: three D/G steps held against the JAX estimator's with the JAX
noise fed in (losses at 1e-5, weights and running statistics at 1e-4 of
the largest), and checkpoints read by the other package.  The card's
case is in ``tests/test_torch_foreign_cuda.py``, which imports no JAX.
"""

import importlib
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as J
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.orca.learn import GANEstimator as JaxGAN
from analytics_zoo_tpu_torch import nn as P
from analytics_zoo_tpu_torch.convert import buffer_names, \
    from_jax_variables, to_jax_variables
from analytics_zoo_tpu_torch.orca.learn import GANEstimator, optimizers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(nz=8, ngf=8, ndf=8, nc=3, size=16)


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    yield


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def jax_dcgan(nz, ngf, ndf, nc, size):
    """``chip_smoke.dcgan`` in the JAX package's layers."""
    n_up = int(math.log2(size)) - 2
    bn = dict(momentum=0.9, epsilon=1e-5)
    ch = ngf * 2 ** (n_up - 1)
    g = [J.Reshape((1, 1, nz)),
         J.Conv2DTranspose(ch, 4, padding="valid", use_bias=False),
         J.BatchNormalization(**bn), J.Activation("relu")]
    for _ in range(n_up - 1):
        ch //= 2
        g += [J.Conv2DTranspose(ch, 4, strides=2, use_bias=False),
              J.BatchNormalization(**bn), J.Activation("relu")]
    g += [J.Conv2DTranspose(nc, 4, strides=2, use_bias=False),
          J.Activation("tanh")]
    d = [J.Conv2D(ndf, 4, strides=2, use_bias=False), J.LeakyReLU(0.2)]
    ch = ndf
    for _ in range(n_up - 1):
        ch *= 2
        d += [J.Conv2D(ch, 4, strides=2, use_bias=False),
              J.BatchNormalization(**bn), J.LeakyReLU(0.2)]
    d += [J.Conv2D(1, 4, padding="valid", use_bias=False), J.Flatten()]
    return J.Sequential(g), J.Sequential(d)


def _images(n, size=16, seed=0):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _twins(real, lr=2e-4):
    jgan = JaxGAN(*jax_dcgan(**SMALL), noise_dim=SMALL["nz"],
                  generator_lr=lr, discriminator_lr=lr)
    jgan._ensure_initialized(jnp.asarray(real))
    ts = jax.device_get(jgan._ts)
    g, d = _chip_smoke().dcgan(**SMALL)
    g.load_state_dict(from_jax_variables(
        {"params": ts["g_params"], "state": ts["g_state"]}), strict=True)
    d.load_state_dict(from_jax_variables(
        {"params": ts["d_params"], "state": ts["d_state"]}), strict=True)
    gan = GANEstimator(g, d, noise_dim=SMALL["nz"], generator_lr=lr,
                       discriminator_lr=lr, device="cpu")
    return jgan, gan


def _leaves(tree):
    return [np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for v in jax.tree_util.tree_leaves(tree)]


def _port_tree(model):
    return to_jax_variables(model.state_dict(), buffer_names(model))


def _held_trees(jtree, ptree, tol=1e-4):
    a, b = _leaves(jtree), _leaves(ptree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=tol,
                                   atol=tol * max(1.0, np.abs(x).max()))


def test_dcgan_steps_match_jax_with_its_noise():
    """Three D/G steps: D with G in eval and D trained on the real and the
    fake batch in turn (the second call on the first's statistics), G with
    D in eval; the JAX noise ``normal(fold_in(rng, step))`` fed to the
    port."""
    real = _images(16)
    jgan, gan = _twins(real)
    n_bn = sum(isinstance(m, P.BatchNormalization)
               for m in gan.discriminator.modules())
    assert n_bn == 1 and sum(isinstance(m, P.BatchNormalization)
                             for m in gan.generator.modules()) == 2
    for _ in range(3):
        for kind in ("d", "g"):
            ts = jgan._ts
            noise = jax.random.normal(
                jax.random.fold_in(ts["rng"], ts["step"]),
                (len(real), SMALL["nz"]), jnp.float32)
            step = jgan._d_step if kind == "d" else jgan._g_step
            jgan._ts, jloss = step(jgan._ts, jnp.asarray(real))
            ploss = (gan.d_step if kind == "d" else gan.g_step)(
                real, noise=np.asarray(noise))
            assert abs(float(ploss) - float(jloss)) < 1e-5, kind
    ts = jax.device_get(jgan._ts)
    assert gan.step == int(ts["step"]) == 6
    _held_trees({"params": ts["g_params"], "state": ts["g_state"]},
                _port_tree(gan.generator))
    _held_trees({"params": ts["d_params"], "state": ts["d_state"]},
                _port_tree(gan.discriminator))


def test_gan_learns_shifted_gaussian():
    rng = np.random.default_rng(0)
    real = (rng.normal(size=(512, 2)) * 0.3 + [4.0, -2.0]).astype(
        np.float32)
    gen = P.Sequential([P.Dense(8, 16, activation="relu"), P.Dense(16, 2)])
    disc = P.Sequential([P.Dense(2, 16, activation="relu"), P.Dense(16, 1)])
    gan = GANEstimator(gen, disc, noise_dim=8, generator_lr=3e-3,
                       discriminator_lr=3e-3, device="cpu")
    hist = gan.fit(real, epochs=60, batch_size=64, verbose=False)
    assert np.isfinite(hist["d_loss"][-1]) and np.isfinite(
        hist["g_loss"][-1])
    samples = gan.generate(256)
    assert samples.shape == (256, 2)
    center = samples.mean(axis=0)
    assert abs(center[0] - 4.0) < 2.0 and abs(center[1] + 2.0) < 2.0


def test_gan_d_g_step_ratio_and_history():
    real = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    gan = GANEstimator(P.Sequential([P.Dense(4, 4), P.Dense(4, 2)]),
                       P.Sequential([P.Dense(2, 4), P.Dense(4, 1)]),
                       noise_dim=4, d_steps=2, g_steps=1, device="cpu")
    hist = gan.fit(real, epochs=2, batch_size=32, verbose=False)
    assert len(hist["d_loss"]) == 2 and len(hist["g_loss"]) == 2
    assert gan.step == 12  # 2 epochs x 2 batches x (2 + 1)


def test_gan_save_load_roundtrip(tmp_path):
    real = _images(32)
    _, gan = _twins(real)
    gan.fit(real, epochs=1, batch_size=16, verbose=False)
    before = gan.generate(8, seed=9)
    d = str(tmp_path / "gan")
    gan.save(d)
    _, gan2 = _twins(real)
    gan2.load(d, real[:16])
    np.testing.assert_array_equal(gan2.generate(8, seed=9), before)
    assert gan2.step == gan.step == 4
    # the noise generator resumes where it was: the next steps agree
    a = [float(gan.d_step(real[:16])), float(gan.g_step(real[:16]))]
    b = [float(gan2.d_step(real[:16])), float(gan2.g_step(real[:16]))]
    assert a == b


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_gan_checkpoint_read_by_the_other_package(tmp_path, direction):
    real = _images(32)
    jgan, gan = _twins(real)
    d = str(tmp_path / "gan")
    if direction == "port_to_jax":
        gan.fit(real, epochs=1, batch_size=16, verbose=False)
        gan.save(d)
        jgan.load(d, real[:16])
    else:
        jgan.fit(real, epochs=1, batch_size=16, verbose=False)
        jgan.save(d)
        gan.load(d, real[:16])
    ts = jax.device_get(jgan._ts)
    assert int(ts["step"]) == gan.step == 4
    for kind, model in (("g", gan.generator), ("d", gan.discriminator)):
        _held_trees({"params": ts[f"{kind}_params"],
                     "state": ts[f"{kind}_state"]}, _port_tree(model), 0.0)
    for kind in ("g_opt", "d_opt"):
        _held_trees(ts[kind], optimizers.snapshot(gan._tree()[kind]), 0.0)
    np.testing.assert_array_equal(gan._rng, np.asarray(ts["rng"]))


def test_gan_empty_epoch_raises_clearly():
    from analytics_zoo_tpu_torch.data.interop import from_iterator
    gan = GANEstimator(P.Sequential([P.Dense(4, 2)]),
                       P.Sequential([P.Dense(2, 1)]), noise_dim=4,
                       device="cpu")
    rng = np.random.default_rng(0)
    rows = [{"x": rng.normal(size=(2,)).astype("float32")} for _ in range(3)]
    feed = from_iterator(lambda e: iter(rows), batch_size=32)
    with pytest.raises(ValueError, match="no full batches"):
        gan.fit(feed, epochs=1, batch_size=32)


def test_gan_zero_step_sides_train_without_stack_error():
    data = np.random.default_rng(0).normal(size=(64, 2)).astype("float32")
    for d_steps, g_steps in ((0, 1), (1, 0)):
        gan = GANEstimator(P.Sequential([P.Dense(4, 2)]),
                           P.Sequential([P.Dense(2, 1)]), noise_dim=4,
                           d_steps=d_steps, g_steps=g_steps, device="cpu")
        hist = gan.fit(data, epochs=1, batch_size=32, verbose=False)
        assert math.isnan(hist["d_loss"][0]) == (d_steps == 0)
        assert math.isnan(hist["g_loss"][0]) == (g_steps == 0)


def test_gan_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        GANEstimator(P.Sequential([P.Dense(4, 2)]),
                     P.Sequential([P.Dense(2, 1)]), noise_dim=4)


def test_chip_smoke_foreign_phase_runs_on_the_cpu_at_tiny_sizes():
    """``chip_smoke.py``'s foreign phase end to end through its CPU seam:
    conversion, the from_torch fit (eager here), the frozen transfer and
    the DCGAN, no kernel launched."""
    chip_smoke = _chip_smoke()
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    sizes = chip_smoke.ForeignSizes(
        device="cpu", batch=4, image=32,
        resnet=dict(layers=(1, 1, 1, 1), classes=10, width=8), steps=2,
        cmp_steps=2, transfer_steps=2, new_classes=3, gan=dict(SMALL),
        gan_batch=8, gan_steps=2, gan_cmp_steps=2, gan_fit_images=24)
    res = chip_smoke.phase_foreign(bn, sizes)
    assert res["transfer"]["backbone_bitwise_equal"]
    assert res["from_torch"]["losses_against_eager"]["bitwise_equal"]
    assert res["dcgan"]["losses_against_eager"]["bitwise_equal"]
    assert not any(res["kernel_launches"].values())
    assert res["convert"]["batch_norms"] == 17
    # the shapes the fused_bn phase holds the kernels at for this path: the
    # stem's (batch x 16 x 16, 8) first, every norm of both nets counted
    maps = chip_smoke.foreign_bn_maps(sizes)
    g, d = chip_smoke.dcgan(**sizes.gan)
    n_gan = sum(isinstance(m, P.BatchNormalization)
                for net in (g, d) for m in net.modules())
    assert sum(maps.values()) == 17 + n_gan
    assert next(iter(maps)) == (4 * 16 * 16, 8)


def test_torch_resnet50_has_torchvisions_parameter_count():
    m = _chip_smoke().TvResNet()
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
