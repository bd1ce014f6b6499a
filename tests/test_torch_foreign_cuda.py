"""On the card (``cuda`` marker, skipped without one; no JAX here): the
foreign path.  A torch ResNet converted by ``Estimator.from_torch`` and
fitted from CUDA graphs, and DCGAN's D and G steps from CUDA graphs, each
against the same steps run eagerly: equal bits under cuDNN's
deterministic algorithms (TF32 off), with the f32 batch norm launched from
every replay (once a norm each way a ResNet step; twice a D norm and once
a G norm a GAN step).
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.orca.learn import Estimator, GANEstimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the card's kernels "
                    "run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.cuda
def test_converted_graph_fit_from_cuda_graphs_equals_eager():
    _card()
    chip_smoke = _chip_smoke()
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    m = chip_smoke.tv_resnet(0, layers=(1, 1, 1, 1), classes=10, width=8)
    x = np.random.default_rng(0).normal(size=(8, 3, 32, 32)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 10, 8).astype(np.int32)
    b0 = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    losses = {}
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True):
            est = Estimator.from_torch(
                model=m, example_input=x[:2], optimizer="sgd",
                loss="sparse_categorical_crossentropy", learning_rate=0.1,
                cuda_graphs=graphs)
            first = est._multi_step(b0, 1)
            bn.reset_launches()
            losses[graphs] = [float(first[0])] + \
                est._multi_step(b0, 3).tolist()
            n_bn = sum(k.endswith(".var") for k in est.model.state_dict())
            assert n_bn == 17
            assert bn.KERNEL_LAUNCHES["fwd_f32"] == 3 * n_bn
            assert bn.KERNEL_LAUNCHES["bwd_f32"] == 3 * n_bn
    finally:
        torch.backends.cudnn.deterministic = False
    assert losses[True] == losses[False]


@pytest.mark.cuda
def test_dcgan_steps_from_cuda_graphs_equal_eager():
    _card()
    chip_smoke = _chip_smoke()
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    small = dict(nz=8, ngf=8, ndf=8, nc=3, size=16)
    g0, d0 = chip_smoke.dcgan(**small)
    real = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, (16, 16, 16, 3)).astype(np.float32)).cuda()
    losses = {}
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True):
            g, d = chip_smoke.dcgan(**small)
            g.load_state_dict(g0.state_dict())
            d.load_state_dict(d0.state_dict())
            gan = GANEstimator(g, d, noise_dim=small["nz"],
                               cuda_graphs=graphs)
            out = []
            for i in range(4):
                if i == 2:
                    bn.reset_launches()
                out += [float(gan.d_step(real)), float(gan.g_step(real))]
            losses[graphs] = out
            # D: one norm, two forwards a step; G: two norms; 2 steps each
            assert bn.KERNEL_LAUNCHES["fwd_f32"] == 2 * (2 + 2)
            assert bn.KERNEL_LAUNCHES["bwd_f32"] == 2 * (2 + 2)
            assert gan.capture_count == (2 if graphs else 0)
    finally:
        torch.backends.cudnn.deterministic = False
    assert losses[True] == losses[False]
