"""The port's SSD object detector (``models/objectdetection.py``) against
the JAX package's: twins of ``tests/test_models.py``'s
``test_ssd_object_detector``,
``test_ssd_anchor_count_matches_head_for_odd_sizes`` and
``test_visualizer_draws_boxes``, with the raw outputs and detections
held against the JAX model's at the same weights.

Weights: the JAX tree's layout from ``jax.eval_shape`` of its init, drawn
with numpy (he-normal kernels, the heads' narrower, unit gains, zero
shifts and statistics): no jitted JAX init, which costs seconds a model on
the CPU.

Tolerances: anchors, decoded boxes and NMS bit for bit (the same numpy);
raw outputs within 1e-5 of the output's largest magnitude (the trunk is
an eval-mode batch-norm ResNet whose activations grow to ~1e2); the
detections the same classes and count, scores 1e-5 and boxes within 1e-5
of their largest coordinate.
"""

import math

import numpy as np
import pytest
import torch

import jax

import analytics_zoo_tpu.models as jmodels
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.models import objectdetection as jod
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.models import (ObjectDetector, SSDLite,
                                            Visualizer)
from analytics_zoo_tpu_torch.models import objectdetection as od


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def numpy_variables(model, x, seed=0, head_gain=0.05):
    """A JAX-layout tree for ``model`` on ``x`` drawn with numpy; the
    box and class heads' kernels ``head_gain`` times he-normal, so that
    loc deltas and logits are O(1), as a trained detector's are (at
    he-normal heads on this trunk they reach 1e2, and decode's exp and the
    softmax turn 1e-6 of rounding into whole pixels and 1e-4 of score)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = math.prod(shape[:-1])
            head = any(str(getattr(p, "key", "")).startswith(
                ("loc_", "cls_")) for p in path)
            std = math.sqrt(2.0 / fan_in) * (head_gain if head else 1.0)
            return rng.normal(0.0, std, shape).astype(np.float32)
        if name in ("gamma", "var"):
            return np.ones(shape, np.float32)
        return np.zeros(shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(x, **kw):
    jm = jmodels.ObjectDetector(**kw)
    variables = numpy_variables(jm, x)
    pm = ObjectDetector(**kw)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return pm, jm, variables


def _within(got, want, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    top = max(np.abs(np.asarray(want)).max(), 1e-30)
    assert err <= 1e-5 * top, (what, err, top)


def test_anchors_boxes_and_nms_equal_jax():
    for size in (64, 100, 128, 300):
        assert SSDLite(class_num=3, image_size=size).fm_sizes == \
            jmodels.SSDLite(class_num=3, image_size=size).fm_sizes
    fm = [(38, 38), (19, 19), (10, 10), (5, 5)]
    scales = [0.1, 0.25, 0.45, 0.7]
    anchors = od._make_anchors(fm, scales)
    np.testing.assert_array_equal(anchors, jod._make_anchors(fm, scales))
    assert len(anchors) == 3 * sum(h * w for h, w in fm)
    rng = np.random.default_rng(1)
    loc = rng.normal(size=(len(anchors), 4)).astype(np.float32)
    np.testing.assert_array_equal(od.decode_boxes(loc, anchors),
                                  jod.decode_boxes(loc, anchors))
    boxes = np.array([[0, 0, 1, 1], [0, 0, 0.95, 0.95], [2, 2, 3, 3]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    assert od.nms(boxes, scores, 0.5) == jod.nms(boxes, scores, 0.5) \
        == [0, 2]
    many = od.decode_boxes(loc[:500], anchors[:500])
    sc = rng.random(500).astype(np.float32)
    assert od.nms(many, sc, 0.3, top_k=50) == jod.nms(many, sc, 0.3,
                                                      top_k=50)


@pytest.mark.parametrize("size", [64, 100])
def test_ssd_outputs_and_detections_equal_jax(size):
    """Raw outputs (anchors x (4 + classes), one per anchor, odd sizes
    too) and the post-processed detections, against the JAX model's at
    the same weights."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    kw = dict(class_num=4, backbone_depth=18, image_size=size)
    pm, jm, variables = _pair(x, **kw)
    pm.compile(loss="mse", device="cpu")
    raw = pm.predict(x)
    assert raw.shape == (2, len(pm.ssd.anchors), 4 + 4)
    want, _ = jm.apply(variables, x, training=False)
    _within(raw, want, "raw")
    jm._loaded_variables = variables
    jm.compile(loss="mse")
    for thr in (0.0, 0.5):
        got = pm.predict_image_set(x, score_threshold=thr)
        ref = jm.predict_image_set(x, score_threshold=thr)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert len(g) == len(r)
            g = sorted(g, key=lambda d: (d[0], tuple(d[2])))
            r = sorted(r, key=lambda d: (d[0], tuple(d[2])))
            assert [d[0] for d in g] == [d[0] for d in r]
            if g:
                _within([d[1] for d in g], [d[1] for d in r], "scores")
                _within(np.stack([d[2] for d in g]),
                        np.stack([d[2] for d in r]), "boxes")


def test_ssd_resnet50_trunk_widths():
    """A bottleneck backbone's stage widths feed the heads (the JAX model
    infers them; the port builds them from the depth)."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jm = jmodels.SSDLite(class_num=3, backbone_depth=50, image_size=64)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    flat = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    pm = SSDLite(class_num=3, backbone_depth=50, image_size=64)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}


def test_visualizer_draws_boxes(tmp_path):
    pytest.importorskip("PIL")
    img = np.zeros((64, 64, 3), np.float32)
    dets = [("cat", 0.9, np.asarray([8.0, 8.0, 30.0, 30.0])),
            ("dog", 0.7, np.asarray([35.0, 35.0, 60.0, 60.0]))]
    out = Visualizer().visualize(img, dets)
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8
    assert out.max() > 0  # something was drawn
    np.testing.assert_array_equal(out, jmodels.Visualizer().visualize(
        img, dets))
    path = Visualizer().save(str(tmp_path / "v.png"), img, dets)
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(path)), out)
