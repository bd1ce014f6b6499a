"""Batch-level augmentation on the device (port of
``analytics_zoo_tpu/data/augment.py``).

The feed ships compact uint8 NHWC batches; normalize, random crop and flip
run on the device inside the train step (``Estimator(augment=...)``).  Each
stage is ``stage(x, generator, training)``: random stages draw from the
``torch.Generator`` on the batch's device where the JAX package takes a
PRNG key (the two give different numbers from one seed, so only the
deterministic chain compares exactly).  With ``generator=None`` or
``training=False`` the chain is deterministic (center crops, no flips,
normalize applies), which is what ``evaluate``/``predict`` use; the output
shape is the same either way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["DeviceAugment", "DeviceNormalize", "DeviceRandomCrop",
           "DeviceRandomFlip"]


class DeviceNormalize:
    """uint8 NHWC -> float32, ``(x / 255 - mean) / std`` per channel, in
    the JAX package's order of operations."""

    random = False

    def __init__(self, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225)):
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True) -> torch.Tensor:
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        return (x.float() / 255.0 - mean) / std


class DeviceRandomCrop:
    """Per-image random ``(h, w)`` crop at train time, center crop at
    eval; ``[B, h, w, C]`` either way."""

    random = True

    def __init__(self, h: int, w: int):
        self.h, self.w = int(h), int(w)

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True) -> torch.Tensor:
        ih, iw = x.shape[1], x.shape[2]
        if ih < self.h or iw < self.w:
            raise ValueError(
                f"DeviceRandomCrop({self.h}, {self.w}) got {ih}x{iw} "
                f"images; resize on the host first")
        if not training or generator is None:
            top, left = (ih - self.h) // 2, (iw - self.w) // 2
            return x[:, top:top + self.h, left:left + self.w]
        b = x.shape[0]
        tops = torch.randint(0, ih - self.h + 1, (b,), device=x.device,
                             generator=generator)
        lefts = torch.randint(0, iw - self.w + 1, (b,), device=x.device,
                              generator=generator)
        rows = tops[:, None] + torch.arange(self.h, device=x.device)
        cols = lefts[:, None] + torch.arange(self.w, device=x.device)
        batch = torch.arange(b, device=x.device)[:, None, None]
        return x[batch, rows[:, :, None], cols[:, None, :]]


class DeviceRandomFlip:
    """Per-image horizontal flip with probability ``p`` at train time (no
    op at eval)."""

    random = True

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True) -> torch.Tensor:
        if not training or generator is None:
            return x
        coin = torch.rand((x.shape[0],), device=x.device,
                          generator=generator) < self.p
        return torch.where(coin[:, None, None, None], x.flip(2), x)


class DeviceAugment:
    """A chain of device augmentation stages, applied in order; every
    stage draws from the one generator it is given."""

    def __init__(self, stages: Sequence):
        self.stages = list(stages)

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True) -> torch.Tensor:
        for stage in self.stages:
            x = stage(x, generator, training)
        return x

    def __repr__(self) -> str:
        names = ", ".join(type(s).__name__ for s in self.stages)
        return f"DeviceAugment([{names}])"
