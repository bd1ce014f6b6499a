"""ImageSet: image collection + preprocessing chain (port of
``analytics_zoo_tpu/data/image.py``, which is numpy and PIL apart from its
process index; the port keeps its own copy, so that a decoded and
transformed image is the JAX package's bit for bit).

Reference (SURVEY.md §2.2): Scala ``feature/image/*.scala`` +
``pyzoo/zoo/feature/image/imageset.py``: ``ImageSet.read`` produced a
Local/DistributedImageSet of OpenCV Mats, transformed by a chain of
``ImageProcessing`` stages (Resize, CenterCrop, Flip, ChannelNormalize,
MatToTensor...) before feeding training.

Decode and augmentation are host work that must overlap the card's steps.
ImageSet holds *paths + labels* (cheap, shardable); decode and the
transform chain run lazily in the streaming feed's decode workers
(data/stream.py: threads, or forked processes writing into shared-memory
slots), which hand ready batches over while the card trains.  Images stay
NHWC uint8 (or float32 after ``ImageNormalize``) on the host; the port's
models are NHWC.  A forked decode worker runs only this module's numpy and
PIL code: no CUDA call reaches it.

Transforms are plain callables ``img[np.uint8 HWC] -> img``; the chain is
a list, matching the reference's ImageProcessing pipeline composition.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .shards import XShards

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif")


# -- transform chain (reference: ImageProcessing subclasses) -------------------

class ImageResize:
    """Bilinear resize to (h, w) (reference: image/Resize)."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def __call__(self, img: np.ndarray) -> np.ndarray:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize(
            (self.w, self.h), Image.BILINEAR))


def _check_crop(img: np.ndarray, h: int, w: int, kind: str) -> None:
    ih, iw = img.shape[:2]
    if ih < h or iw < w:
        raise ValueError(
            f"{kind}({h}, {w}) got a {ih}x{iw} image: resize first "
            f"(an undersized crop would break batch stacking later)")


class ImageCenterCrop:
    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def __call__(self, img: np.ndarray) -> np.ndarray:
        _check_crop(img, self.h, self.w, "ImageCenterCrop")
        ih, iw = img.shape[:2]
        top = (ih - self.h) // 2
        left = (iw - self.w) // 2
        return img[top:top + self.h, left:left + self.w]


class ImageRandomCrop:
    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        _check_crop(img, self.h, self.w, "ImageRandomCrop")
        rng = rng or np.random.default_rng()
        ih, iw = img.shape[:2]
        top = int(rng.integers(0, ih - self.h + 1))
        left = int(rng.integers(0, iw - self.w + 1))
        return img[top:top + self.h, left:left + self.w]


class ImageRandomFlip:
    """Horizontal flip with probability p (reference: image/HFlip)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return img[:, ::-1] if rng.random() < self.p else img


class ImageNormalize:
    """uint8 HWC -> float32, (x/255 - mean) / std per channel (reference:
    ChannelNormalize)."""

    def __init__(self, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return (img.astype(np.float32) / 255.0 - self.mean) / self.std


class ImageBrightness:
    """Random additive brightness jitter in [-delta, delta] (reference:
    image/Brightness).  Operates on uint8 pre-normalize."""

    def __init__(self, delta: float = 32.0):
        self.delta = float(delta)

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        shift = rng.uniform(-self.delta, self.delta)
        return np.clip(img.astype(np.float32) + shift, 0, 255).astype(
            img.dtype)


class ImageContrast:
    """Random contrast scale in [lower, upper] about the mean (reference:
    image/Contrast)."""

    def __init__(self, lower: float = 0.5, upper: float = 1.5):
        self.lower, self.upper = float(lower), float(upper)

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        scale = rng.uniform(self.lower, self.upper)
        f = img.astype(np.float32)
        mean = f.mean(axis=(0, 1), keepdims=True)
        return np.clip((f - mean) * scale + mean, 0, 255).astype(img.dtype)


class ImageSaturation:
    """Random saturation scale (blend with per-pixel luma; reference:
    image/Saturation)."""

    _LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)

    def __init__(self, lower: float = 0.5, upper: float = 1.5):
        self.lower, self.upper = float(lower), float(upper)

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        scale = rng.uniform(self.lower, self.upper)
        f = img.astype(np.float32)
        gray = (f[..., :3] @ self._LUMA)[..., None]
        out = gray + (f - gray) * scale
        return np.clip(out, 0, 255).astype(img.dtype)


class ImageColorJitter:
    """Brightness + contrast + saturation in random order per sample
    (reference: the ColorJitter chain the detection pipelines used)."""

    def __init__(self, brightness: float = 32.0,
                 contrast: Sequence[float] = (0.5, 1.5),
                 saturation: Sequence[float] = (0.5, 1.5)):
        self.stages = [ImageBrightness(brightness),
                       ImageContrast(*contrast),
                       ImageSaturation(*saturation)]

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        order = rng.permutation(len(self.stages))
        for i in order:
            img = self.stages[i](img, rng=rng)
        return img


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Raw file bytes -> uint8 HWC RGB: the decode half of the readahead
    split (readers.FileReadahead fetches the bytes)."""
    import io
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def decode_image(path: str) -> np.ndarray:
    """File -> uint8 HWC RGB (reference: OpenCV imdecode behind JNI; here
    PIL on the host: the card never sees undecoded bytes)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _takes_rng(t: Callable) -> bool:
    """Does the transform accept the feed's rng (for deterministic
    augmentation)?  Detected by signature so user transforms participate,
    cached on the object."""
    cached = getattr(t, "_zoo_takes_rng", None)
    if cached is None:
        import inspect
        try:
            cached = "rng" in inspect.signature(t).parameters
        except (TypeError, ValueError):
            cached = False
        try:
            t._zoo_takes_rng = cached
        except AttributeError:
            pass  # unsettable (e.g. builtin); re-inspect next time
    return cached


def apply_chain(img: np.ndarray, transforms: Sequence[Callable],
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    for t in transforms:
        # random transforms take the feed's per-worker rng for determinism
        img = t(img, rng=rng) if _takes_rng(t) else t(img)
    return img


# -- ImageSet ------------------------------------------------------------------

class ImageSet:
    """Paths + labels + transform chain; the decode work happens in the
    streaming feed (reference: ImageSet.read -> LocalImageSet /
    DistributedImageSet)."""

    def __init__(self, paths: Sequence[str],
                 labels: Optional[Sequence[int]] = None,
                 transforms: Optional[List[Callable]] = None,
                 class_names: Optional[List[str]] = None,
                 readahead: int = 0):
        self.paths = list(paths)
        self.labels = None if labels is None else np.asarray(labels,
                                                             np.int32)
        self.transforms = list(transforms or [])
        self.class_names = class_names
        # raw-file readahead depth (0 = off): decode workers hint each
        # batch's paths ahead of decoding it, so storage reads overlap
        # decode (readers.FileReadahead; one reader per worker process)
        self.readahead = int(readahead)
        self._ra_lock = threading.Lock()

    @staticmethod
    def read(path: str, with_label: bool = True,
             sharded: bool = False) -> "ImageSet":
        """Read an image directory.  With labels: class-per-subdirectory
        layout (the torchvision/ImageNet convention the reference's examples
        used); without: a flat directory.

        Several processes: when ``sharded`` and the process count
        (``readers.process_grid``) is above 1, each process keeps only
        its slice of the file list (the file split of data/readers.py)."""
        paths: List[str] = []
        labels: List[int] = []
        class_names: Optional[List[str]] = None
        if with_label:
            class_names = sorted(
                d for d in os.listdir(path)
                if os.path.isdir(os.path.join(path, d)))
            for ci, cname in enumerate(class_names):
                for f in sorted(os.listdir(os.path.join(path, cname))):
                    if f.lower().endswith(IMAGE_EXTS):
                        paths.append(os.path.join(path, cname, f))
                        labels.append(ci)
        else:
            for f in sorted(os.listdir(path)):
                if f.lower().endswith(IMAGE_EXTS):
                    paths.append(os.path.join(path, f))
        if sharded:
            from .readers import process_grid
            i, n = process_grid()
            paths = paths[i::n]
            labels = labels[i::n] if with_label else labels
        return ImageSet(paths, labels if with_label else None,
                        class_names=class_names)

    def transform(self, *transforms: Callable) -> "ImageSet":
        """Append transform stages (chainable, reference-style)."""
        self.transforms.extend(transforms)
        return self

    def __len__(self) -> int:
        return len(self.paths)

    # -- streaming-feed loader protocols (data/stream.py duck-types these
    # off ``load_sample.__self__``) ------------------------------------------

    def _reader(self):
        """This worker's FileReadahead, created lazily and keyed on pid
        so a forked decode worker never inherits a dead reader thread.
        Creation is locked: concurrent worker threads racing the first
        hint share one instance (every loser would otherwise leak a
        parked reader thread and duplicate its queued reads)."""
        ra = self.__dict__.get("_ra")
        if ra is not None and ra.pid == os.getpid():
            return ra
        from .readers import FileReadahead
        with self._ra_lock:
            ra = self.__dict__.get("_ra")
            if ra is None or ra.pid != os.getpid():
                ra = FileReadahead(depth=max(1, self.readahead))
                self.__dict__["_ra"] = ra
            return ra

    def hint_indices(self, indices: Sequence[int]) -> None:
        """Advisory from the streaming feed: these rows decode next."""
        if self.readahead:
            self._reader().hint([self.paths[i] for i in indices])

    def feed_stats(self) -> Dict[str, float]:
        """Cumulative blocked-on-storage ms for the calling worker
        (surfaced by the feed as ``feed.io_wait_ms``)."""
        if not self.readahead:
            return {"io_wait_ms": 0.0}
        return {"io_wait_ms": self._reader().wait_ms}

    def load_sample(self, i: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        if self.readahead:
            img = decode_image_bytes(self._reader().get(self.paths[i]))
        else:
            img = decode_image(self.paths[i])
        img = apply_chain(img, self.transforms, rng)
        out: Dict[str, np.ndarray] = {"x": np.ascontiguousarray(img)}
        if self.labels is not None:
            out["y"] = self.labels[i]
        return out

    def to_feed(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                num_workers: Optional[int] = None,
                prefetch_batches: int = 4,
                drop_remainder: bool = True,
                workers: Optional[str] = None,
                readahead: Optional[int] = None):
        """A StreamingDataFeed that decodes/augments in decode workers
        (``workers=``: "thread" | "process", see data/stream.py) and
        prefetches batches through the native queue.  ``readahead`` sets
        the per-worker raw-file readahead depth FOR THIS FEED (None
        keeps the ImageSet's setting; a different value loads through a
        shallow copy, so other feeds and direct ``load_sample`` calls on
        this ImageSet are untouched)."""
        import copy
        from .stream import StreamingDataFeed
        owner = self
        if readahead is not None and int(readahead) != self.readahead:
            owner = copy.copy(self)       # paths/labels/transforms shared
            owner.__dict__.pop("_ra", None)
            owner._ra_lock = threading.Lock()
            owner.readahead = int(readahead)
        return StreamingDataFeed(
            num_samples=len(owner.paths), load_sample=owner.load_sample,
            batch_size=batch_size, shuffle=shuffle, seed=seed,
            num_workers=num_workers, prefetch_batches=prefetch_batches,
            drop_remainder=drop_remainder, workers=workers)

    def to_shards(self, num_shards: int = 4) -> XShards:
        """Eagerly decode everything into numpy-dict XShards (small sets;
        the reference's LocalImageSet analog)."""
        items = [self.load_sample(i) for i in range(len(self.paths))]
        xs = np.stack([it["x"] for it in items])
        data: Dict[str, Any] = {"x": xs}
        if self.labels is not None:
            data["y"] = self.labels.copy()
        chunks = []
        for part in np.array_split(np.arange(len(self.paths)), num_shards):
            chunks.append({k: v[part] for k, v in data.items()})
        return XShards(chunks)
