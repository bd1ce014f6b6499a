"""Object detection (port of ``analytics_zoo_tpu/models/objectdetection.py``;
reference: zoo.models.image.objectdetection, SSD-VGG/MobileNet pipelines:
ObjectDetector load + ImageConfigure + postprocess NMS/ScaleDetection +
Visualizer).

``SSDLite``: an SSD head over a ResNet backbone's multi-scale feature
maps, anchors generated per level.  The conv trunk and the box/class heads
run on the model's device; decode and class-wise NMS run on host numpy,
copied from the JAX package (small and latency-bound; the reference also
postprocessed on the CPU).  Module names follow the JAX tree
(``ssd.backbone``, ``ssd.extra``, ``ssd.loc_{i}``, ``ssd.cls_{i}``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.layers import Conv2D
from .common import ZooModel
from .image import ResNet


def _make_anchors(fm_sizes: Sequence[Tuple[int, int]],
                  scales: Sequence[float],
                  ratios: Sequence[float] = (1.0, 2.0, 0.5)) -> np.ndarray:
    """Center-form anchors [(cx, cy, w, h)] normalized to [0,1]."""
    out = []
    for (fh, fw), scale in zip(fm_sizes, scales):
        for i in range(fh):
            for j in range(fw):
                cx, cy = (j + 0.5) / fw, (i + 0.5) / fh
                for r in ratios:
                    w = scale * np.sqrt(r)
                    h = scale / np.sqrt(r)
                    out.append([cx, cy, w, h])
    return np.asarray(out, np.float32)


def decode_boxes(loc: np.ndarray, anchors: np.ndarray,
                 variances: Tuple[float, float] = (0.1, 0.2)) -> np.ndarray:
    """SSD box decoding: loc deltas + anchors -> corner-form [x1,y1,x2,y2]."""
    cxcy = anchors[:, :2] + loc[:, :2] * variances[0] * anchors[:, 2:]
    wh = anchors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    return np.concatenate([cxcy - wh / 2, cxcy + wh / 2], axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        top_k: int = 200) -> List[int]:
    """Greedy class-wise NMS (reference: postprocess Nms.scala)."""
    order = np.argsort(-scores)[:top_k]
    keep: List[int] = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        a_i = ((boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1]))
        a_r = ((boxes[rest, 2] - boxes[rest, 0]) *
               (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.clip(a_i + a_r - inter, 1e-9, None)
        order = rest[iou <= iou_threshold]
    return keep


def _halve(v: int, times: int) -> int:
    """``v`` after ``times`` SAME-padded stride-2 layers: each gives
    ceil(v / 2) (floor disagrees for sizes not divisible by 64 and would
    desync the anchors from the head's outputs)."""
    for _ in range(times):
        v = -(-v // 2)
    return v


class SSDLite(ZooModel):
    """SSD head over ResNet stages 1..3 (strides 8/16/32) + one extra
    stride-2 level."""

    N_RATIOS = 3

    def __init__(self, class_num: int = 21, backbone_depth: int = 18,
                 image_size: int = 128):
        super().__init__()
        self._config = dict(class_num=class_num,
                            backbone_depth=backbone_depth,
                            image_size=image_size)
        self.class_num = class_num
        self.image_size = image_size
        self.backbone = ResNet(depth=backbone_depth, include_top=False,
                               return_stages=True)
        s = image_size
        self.fm_sizes = [(_halve(s, k), _halve(s, k)) for k in (3, 4, 5, 6)]
        self.scales = [0.1, 0.25, 0.45, 0.7]
        self.anchors = _make_anchors(self.fm_sizes, self.scales)
        bottleneck = backbone_depth >= 50
        widths = [64 * 2 ** stage * (4 if bottleneck else 1)
                  for stage in (1, 2, 3)]
        self.extra = Conv2D(widths[-1], 256, 3, strides=2, activation="relu")
        k = self.N_RATIOS
        for i, c in enumerate(widths + [256]):
            self.add_module(f"loc_{i}", Conv2D(c, k * 4, 3))
            self.add_module(f"cls_{i}", Conv2D(c, k * class_num, 3))

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """ResNet trunk taps (stages 1..3) + one extra stride-2 level."""
        taps = list(self.backbone(x))
        return taps + [self.extra(taps[-1])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Returns [B, n_anchors, 4 + class_num] (loc ++ class logits)."""
        locs, clss = [], []
        k = self.N_RATIOS
        for i, f in enumerate(self._features(x)):
            loc = getattr(self, f"loc_{i}")(f)
            cls = getattr(self, f"cls_{i}")(f)
            b, fh, fw, _ = loc.shape
            locs.append(loc.reshape(b, fh * fw * k, 4))
            clss.append(cls.reshape(b, fh * fw * k, self.class_num))
        return torch.cat([torch.cat(locs, dim=1), torch.cat(clss, dim=1)],
                         dim=-1)


class ObjectDetector(ZooModel):
    """Reference-API wrapper: predict_image_set -> per-image detections
    [(class, score, [x1,y1,x2,y2]), ...] after decode + NMS."""

    def __init__(self, class_num: int = 21, backbone_depth: int = 18,
                 image_size: int = 128,
                 labels: Optional[Sequence[str]] = None):
        super().__init__()
        self._config = dict(class_num=class_num,
                            backbone_depth=backbone_depth,
                            image_size=image_size,
                            labels=list(labels) if labels else None)
        self.ssd = SSDLite(class_num, backbone_depth, image_size)
        self.class_num = class_num
        self.labels = list(labels) if labels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ssd(x)

    def postprocess(self, raw: np.ndarray, score_threshold: float = 0.5,
                    iou_threshold: float = 0.45
                    ) -> List[List[Tuple[Any, float, np.ndarray]]]:
        """The host half of ``predict_image_set``: each row of raw outputs
        ``[n_anchors, 4 + class_num]`` through the class softmax, box
        decoding and class-wise NMS, detections by falling score."""
        anchors = self.ssd.anchors
        results = []
        for row in raw:
            loc, logits = row[:, :4], row[:, 4:]
            probs = torch.softmax(torch.from_numpy(
                np.ascontiguousarray(logits, np.float32)), dim=-1).numpy()
            boxes = decode_boxes(loc, anchors)
            dets = []
            for c in range(1, self.class_num):  # 0 = background
                sc = probs[:, c]
                sel = np.where(sc >= score_threshold)[0]
                if not len(sel):
                    continue
                for i in nms(boxes[sel], sc[sel], iou_threshold):
                    label = self.labels[c] if self.labels else c
                    dets.append((label, float(sc[sel][i]), boxes[sel][i]))
            dets.sort(key=lambda d: -d[1])
            results.append(dets)
        return results

    def predict_image_set(self, images: np.ndarray,
                          score_threshold: float = 0.5,
                          iou_threshold: float = 0.45
                          ) -> List[List[Tuple[Any, float, np.ndarray]]]:
        return self.postprocess(self.predict(np.asarray(images)),
                                score_threshold, iou_threshold)


class Visualizer:
    """Draw detections onto images (reference: the objectdetection
    Visualizer utility, which rendered boxes + labels via OpenCV; here PIL
    on the host).

    ``visualize(image, detections)`` takes one HWC image (uint8 or float
    in [0,1]/[0,255]) and the per-image output of
    ``ObjectDetector.predict_image_set`` and returns a uint8 HWC array
    with boxes and ``label: score`` captions drawn."""

    # a small fixed palette cycled per class label
    _COLORS = [(230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
               (245, 130, 48), (145, 30, 180), (70, 240, 240),
               (240, 50, 230), (210, 245, 60), (250, 190, 190)]

    def __init__(self, score_format: str = "{label}: {score:.2f}"):
        self.score_format = score_format

    def visualize(self, image: np.ndarray, detections: List[Tuple[Any,
                  float, np.ndarray]]) -> np.ndarray:
        from PIL import Image, ImageDraw
        img = np.asarray(image)
        if img.dtype != np.uint8:
            scale = 255.0 if img.max() <= 1.0 + 1e-6 else 1.0
            img = np.clip(img * scale, 0, 255).astype(np.uint8)
        pil = Image.fromarray(img)
        draw = ImageDraw.Draw(pil)
        color_of: dict = {}
        for label, score, box in detections:
            if label not in color_of:
                color_of[label] = self._COLORS[len(color_of)
                                               % len(self._COLORS)]
            color = color_of[label]
            x1, y1, x2, y2 = [float(v) for v in box]
            draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
            draw.text((x1 + 2, max(0.0, y1 - 10)),
                      self.score_format.format(label=label, score=score),
                      fill=color)
        return np.asarray(pil)

    def save(self, path: str, image: np.ndarray,
             detections: List[Tuple[Any, float, np.ndarray]]) -> str:
        from PIL import Image
        Image.fromarray(self.visualize(image, detections)).save(path)
        return path


__all__ = ["SSDLite", "ObjectDetector", "Visualizer", "decode_boxes",
           "nms"]
