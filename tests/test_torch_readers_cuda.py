"""On the card (``cuda`` marker, skipped without one; no JAX here): the
readers' path.  An ImageSet stream (forked decoders, random crop and flip)
into a batch-norm ResNet fitted from CUDA graphs and eagerly; the text
models and the detector on the card against themselves on the CPU.

Tolerances: the captured fit's step losses equal the eager fit's bit for
bit under cuDNN's deterministic algorithms, with the fused batch norm
launched from every replay; outputs on the card within 1e-4 of the CPU's
largest magnitude (f32, TF32 off; the sums' order differs).
"""

import importlib

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.data import (ImageNormalize, ImageRandomCrop,
                                          ImageRandomFlip, ImageResize,
                                          ImageSet)
from analytics_zoo_tpu_torch.models import (KNRM, ObjectDetector, ResNet,
                                            TextClassifier)
from analytics_zoo_tpu_torch.nn import BatchNormalization
from analytics_zoo_tpu_torch.orca.learn import Estimator


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the card's kernels "
                    "run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _write_dataset(root, n_per_class, size):
    from PIL import Image
    rng = np.random.default_rng(0)
    for c in ("cat", "dog"):
        d = root / c
        d.mkdir(parents=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{c}_{i}.jpg")
    return str(root)


def _within(got, want, what=""):
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(np.abs(want).max(), 1.0), (what, err)


@pytest.mark.cuda
def test_imageset_fit_from_cuda_graphs_equals_eager(tmp_path):
    _card()
    pytest.importorskip("PIL")
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    root = _write_dataset(tmp_path / "imgs", 16, 40)
    iset = ImageSet.read(root).transform(
        ImageResize(36, 36), ImageRandomCrop(32, 32), ImageRandomFlip(),
        ImageNormalize())
    init = ResNet(depth=18, class_num=2, width=8).state_dict()
    n_bn = sum(isinstance(m, BatchNormalization)
               for m in ResNet(depth=18).modules())
    losses, counts = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (False, True):
            model = ResNet(depth=18, class_num=2, width=8)
            model.load_state_dict(init)
            est = Estimator.from_keras(
                model, loss="sparse_categorical_crossentropy",
                optimizer="sgd", learning_rate=0.1, cuda_graphs=graphs)
            seen, inner = [], est._train_step
            est._train_step = lambda b: seen.append(inner(b)) or seen[-1]
            bn.reset_launches()
            est.fit(iset.to_feed(batch_size=8, num_workers=1,
                                 workers="process"), epochs=1, batch_size=8,
                    verbose=False, prefetch=2)
            losses[graphs] = [float(v) for v in seen]
            counts[graphs] = dict(bn.KERNEL_LAUNCHES)
            if graphs:
                assert est.capture_count == 1
    finally:
        torch.backends.cudnn.deterministic = False
    assert len(losses[True]) == 4
    assert losses[True] == losses[False]
    for graphs in (False, True):
        assert counts[graphs]["fwd_f32"] == 4 * n_bn, counts
        assert counts[graphs]["bwd_f32"] == 4 * n_bn, counts


@pytest.mark.cuda
@pytest.mark.parametrize("make", [
    lambda: TextClassifier(3, vocab_size=200, token_length=16,
                           sequence_length=24, encoder="cnn",
                           encoder_output_dim=16),
    lambda: TextClassifier(3, vocab_size=200, token_length=16,
                           sequence_length=24, encoder="gru",
                           encoder_output_dim=16),
    lambda: KNRM(8, 16, vocab_size=200, embed_size=32, kernel_num=21)],
    ids=["cnn", "gru", "knrm"])
def test_text_models_on_the_card_equal_the_cpu(make):
    _card()
    torch.manual_seed(0)
    model = make().eval()
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 200, (8, 24)).astype(np.int32))
    ids[:2, 8:16] = ids[:2, :8]  # KNRM's exact-match kernel fires
    with torch.no_grad():
        want = model(ids).numpy()
        got = model.cuda()(ids.cuda()).cpu().numpy()
    _within(got, want)


@pytest.mark.cuda
def test_object_detector_on_the_card_equals_the_cpu():
    _card()
    torch.manual_seed(0)
    det = ObjectDetector(class_num=4, backbone_depth=18, image_size=100)
    x = np.random.default_rng(2).normal(size=(2, 100, 100, 3)).astype(
        np.float32)
    det.compile(loss="mse", device="cpu")
    want = det.predict(x)
    det.compile(loss="mse")
    got = det.predict(x)
    assert got.shape == want.shape == (2, len(det.ssd.anchors), 8)
    _within(got, want, "raw")


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["binary_crossentropy", "hinge", "huber"])
def test_clipping_losses_capture_as_eager(loss):
    """A loss built on ``jnp.clip``'s form (``losses._clip``) captures in
    the train step's CUDA graph (its bounds filled on the card; a host
    tensor copied in made the capture fail) and the captured fit's step
    losses equal the eager fit's: KNRM, WikiQA's query and document
    lengths."""
    _card()
    rng = np.random.default_rng(3)
    x = rng.integers(0, 200, (128, 50)).astype(np.int32)
    y = (rng.random((128, 1)) < 0.5).astype(np.float32)
    torch.manual_seed(0)
    init = KNRM(10, 40, vocab_size=200, embed_size=32).state_dict()
    losses = {}
    for graphs in (False, True):
        model = KNRM(10, 40, vocab_size=200, embed_size=32)
        model.load_state_dict(init)
        est = Estimator.from_keras(model, loss=loss, optimizer="adam",
                                   learning_rate=1e-2, cuda_graphs=graphs)
        seen, inner = [], est._train_step
        est._train_step = lambda b: seen.append(inner(b)) or seen[-1]
        est.fit((x, y), epochs=2, batch_size=32, verbose=False)
        losses[graphs] = [float(v) for v in seen]
        if graphs:
            assert est.capture_count == 1
    assert len(losses[True]) == 8
    assert losses[True] == losses[False]
