"""Image classification (port of ``analytics_zoo_tpu/models/image.py``):
ResNet v1.5 over NHWC activations, with the classic batch-norm blocks and
the normalizer-free (NF) variant, and the ``ImageClassifier`` wrapper.

Module names follow the JAX tree (``stem``, ``stem_bn``,
``stage{s}_block{b}`` with ``conv1``..``conv3``, ``bn1``..``bn3``, ``proj``,
``proj_bn``, and ``head``), so ``convert.from_jax_variables`` output loads
with ``load_state_dict``.  PyTorch builds parameters up front, so the input
channel count is a constructor argument (``in_channels``, 3 by default),
and the NF blocks' analytic variance tracking runs at construction.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import initializers
from ..nn.layers import (BatchNormalization, Conv2D, Dense, Flatten,
                         MaxPooling2D, ScaledWSConv2D, Sequential,
                         conv2d_nhwc, scaled_ws_kernel)
from .common import ZooModel

_SPECS = {
    # depth: (blocks per stage, bottleneck?)
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}
_NF_RELU_GAIN = 1.7139588594436646  # sqrt(2 / (1 - 1/pi)): relu VP gain
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scaled(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` first rounded to x's dtype, as
    ``x * jnp.asarray(c, x.dtype)`` does."""
    return x * float(torch.tensor(c, dtype=x.dtype))


class _SpaceToDepthStem(nn.Module):
    """The 7x7/stride-2 SAME stem conv computed as a 4x4/stride-1 VALID
    conv over a 2x2 space-to-depth rearrangement of the image (the JAX
    package's ``_SpaceToDepthStem``): the kernel is kept in the plain
    stem's shape (OIHW ``[filters, C, 7, 7]``, so checkpoints interchange)
    and zero-padded to 8x8 = 4x4 blocks of 2x2; the image takes the SAME
    pads (2, 3) plus one bottom/right zero row that meets only the
    kernel's zero taps."""

    def __init__(self, in_channels: int, filters: int,
                 weight_standardized: bool = False):
        super().__init__()
        self.filters = filters
        self.kernel = nn.Parameter(torch.empty(filters, in_channels, 7, 7))
        self.ws_gain = nn.Parameter(torch.empty(filters)) \
            if weight_standardized else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.he_normal(self.kernel, generator)
        if self.ws_gain is not None:
            initializers.ones(self.ws_gain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"space-to-depth stem wants even H/W, got "
                             f"{tuple(x.shape)}")
        f = self.filters
        k = self.kernel
        if self.ws_gain is not None:
            k = scaled_ws_kernel(k, self.ws_gain)
        k8 = F.pad(k.to(x.dtype), (0, 1, 0, 1))  # [f, c, 8, 8]
        # [f, c, (i, dy), (j, dx)] -> [f, (dy, dx, c), i, j]: the input
        # channels in the order the image's 2x2 blocks are laid out below
        k2 = (k8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
              .reshape(f, 4 * c, 4, 4))
        xp = F.pad(x, (0, 0, 2, 4, 2, 4))
        hb, wb = (h + 6) // 2, (w + 6) // 2
        x2 = (xp.reshape(b, hb, 2, wb, 2, c).permute(0, 1, 3, 2, 4, 5)
              .reshape(b, hb, wb, 4 * c))
        return conv2d_nhwc(x2, k2, (1, 1), "VALID")


def _nf_transition(in_channels: int, out_channels: int, stride: int) -> bool:
    """Whether an NF block takes a projected (transition) shortcut: the
    channel count changes or the block strides.  The one rule both the
    block (to create the shortcut) and ``ResNet`` (to reset the variance
    tracker) use."""
    return in_channels != out_channels or stride != 1


class _NFResBlock(nn.Module):
    """Normalizer-free pre-activation block: ``h = shortcut + f(relu(x) *
    gain / beta)`` with Scaled WS convs inside ``f`` and the SkipInit
    scalar (times ``alpha``) folded into the last conv's gain."""

    def __init__(self, in_channels: int, filters: int, stride: int,
                 bottleneck: bool, beta: float, alpha: float):
        super().__init__()
        f = filters
        out_f = f * 4 if bottleneck else f
        self.beta = beta
        self.bottleneck = bottleneck
        self.proj = ScaledWSConv2D(in_channels, out_f, 1, strides=stride,
                                   use_bias=False) \
            if _nf_transition(in_channels, out_f, stride) else None
        if bottleneck:
            self.conv1 = ScaledWSConv2D(in_channels, f, 1, use_bias=False)
            self.conv2 = ScaledWSConv2D(f, f, 3, strides=stride,
                                        use_bias=False)
            self.conv3 = ScaledWSConv2D(f, out_f, 1, use_bias=False,
                                        skip_init=True, branch_scale=alpha)
        else:
            self.conv1 = ScaledWSConv2D(in_channels, f, 3, strides=stride,
                                        use_bias=False)
            self.conv2 = ScaledWSConv2D(f, f, 3, use_bias=False,
                                        skip_init=True, branch_scale=alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = _scaled(F.relu(x), _NF_RELU_GAIN / self.beta)
        # a transition shortcut branches from the scaled activation, an
        # identity shortcut keeps x
        shortcut = x if self.proj is None else self.proj(pre)
        h = _scaled(F.relu(self.conv1(pre)), _NF_RELU_GAIN)
        if self.bottleneck:
            h = _scaled(F.relu(self.conv2(h)), _NF_RELU_GAIN)
            h = self.conv3(h)
        else:
            h = self.conv2(h)
        return shortcut + h


class _ResBlock(nn.Module):
    """The classic v1.5 block: conv-BN-relu stack (stride on the 3x3), a
    conv-BN projection where the shape changes, relu after the sum."""

    def __init__(self, in_channels: int, filters: int, stride: int,
                 bottleneck: bool):
        super().__init__()
        f = filters
        out_f = f * 4 if bottleneck else f
        self.bottleneck = bottleneck
        self.proj = self.proj_bn = None
        if in_channels != out_f or stride != 1:
            self.proj = Conv2D(in_channels, out_f, 1, strides=stride,
                               use_bias=False)
            self.proj_bn = BatchNormalization(out_f)
        if bottleneck:
            self.conv1 = Conv2D(in_channels, f, 1, use_bias=False)
            self.bn1 = BatchNormalization(f)
            self.conv2 = Conv2D(f, f, 3, strides=stride, use_bias=False)
            self.bn2 = BatchNormalization(f)
            self.conv3 = Conv2D(f, out_f, 1, use_bias=False)
            self.bn3 = BatchNormalization(out_f)
        else:
            self.conv1 = Conv2D(in_channels, f, 3, strides=stride,
                                use_bias=False)
            self.bn1 = BatchNormalization(f)
            self.conv2 = Conv2D(f, f, 3, use_bias=False)
            self.bn2 = BatchNormalization(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.proj is None else self.proj_bn(self.proj(x))
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.bottleneck:
            h = self.bn3(self.conv3(F.relu(h)))
        return F.relu(h + shortcut)


class ResNet(ZooModel):
    """ResNet v1.5 (stride 2 on the 3x3), NHWC; ``depth`` in {18, 34, 50,
    101, 152}.  ``stem``: "conv" (7x7/s2) or "space_to_depth" (the same
    conv, computed densely); ``norm``: "batch" or "nf" (normalizer-free,
    Scaled WS convs); ``dtype``: "float32" or "bfloat16" activations over
    f32 weights, the head in f32.  ``return_stages`` returns the outputs
    of stages 1-3; ``include_top=False`` the pooled features."""

    def __init__(self, depth: int = 50, class_num: int = 1000,
                 width: int = 64, include_top: bool = True,
                 return_stages: bool = False, dtype: str = "float32",
                 stem: str = "conv", norm: str = "batch",
                 in_channels: int = 3):
        super().__init__()
        self._config = dict(depth=depth, class_num=class_num, width=width,
                            include_top=include_top,
                            return_stages=return_stages, dtype=dtype,
                            stem=stem, norm=norm, in_channels=in_channels)
        if depth not in _SPECS:
            raise ValueError(f"depth must be one of {sorted(_SPECS)}")
        if stem not in ("conv", "space_to_depth"):
            raise ValueError("stem must be 'conv' or 'space_to_depth'")
        if norm not in ("batch", "nf"):
            raise ValueError("norm must be 'batch' (classic BN ResNet) "
                             "or 'nf' (normalizer-free, Scaled WS convs)")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.dtype = _DTYPES[dtype]
        self.include_top = include_top
        self.return_stages = return_stages
        self.nf = norm == "nf"
        blocks, bottleneck = _SPECS[depth]
        if stem == "space_to_depth":
            self.stem = _SpaceToDepthStem(in_channels, width,
                                          weight_standardized=self.nf)
        elif self.nf:
            self.stem = ScaledWSConv2D(in_channels, width, 7, strides=2,
                                       use_bias=False)
        else:
            self.stem = Conv2D(in_channels, width, 7, strides=2,
                               use_bias=False)
        self.stem_bn = None if self.nf else BatchNormalization(width)
        self.stem_pool = MaxPooling2D(3, strides=2, padding="same")
        self._blocks: List[Tuple[str, int]] = []  # (name, stage)
        channels = width
        alpha, var = 0.2, 1.0  # the NF analytic variance tracking
        for stage, n_blocks in enumerate(blocks):
            f = width * (2 ** stage)
            out_f = f * 4 if bottleneck else f
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                if self.nf:
                    block = _NFResBlock(channels, f, stride, bottleneck,
                                        beta=float(np.sqrt(var)),
                                        alpha=alpha)
                    transition = _nf_transition(channels, out_f, stride)
                    var = (1.0 if transition else var) + alpha * alpha
                else:
                    block = _ResBlock(channels, f, stride, bottleneck)
                name = f"stage{stage}_block{b}"
                self.add_module(name, block)
                self._blocks.append((name, stage))
                channels = out_f
        self.head = Dense(channels, class_num) if include_top else None

    def forward(self, x: torch.Tensor) -> Any:
        """x: ``[B, H, W, C]`` images (NHWC)."""
        if self.dtype == torch.bfloat16:
            x = x.to(torch.bfloat16)
        h = self.stem(x)
        if self.stem_bn is not None:
            h = self.stem_bn(h)
        h = self.stem_pool(F.relu(h))
        taps = []
        for i, (name, stage) in enumerate(self._blocks):
            h = getattr(self, name)(h)
            last_of_stage = i + 1 == len(self._blocks) \
                or self._blocks[i + 1][1] != stage
            if stage >= 1 and last_of_stage:
                taps.append(h)
        if self.return_stages:
            return taps
        if self.nf:
            h = F.relu(h)  # NF blocks are pre-activation
        # jnp.mean of a bf16 map sums and divides in f32, then rounds once;
        # the head runs in f32 (a model cast to f64, a numerical reference,
        # stays in f64)
        acc = torch.float64 if h.dtype == torch.float64 else torch.float32
        h = h.to(acc).mean(dim=(1, 2)).to(h.dtype)
        if self.head is None:
            return h
        return self.head(h.to(acc))


class ImageClassifier(ZooModel):
    """A ResNet backbone (under ``resnet``) with labels and a top-N
    ``predict_image_set``."""

    def __init__(self, depth: int = 50, class_num: int = 1000,
                 labels: Optional[Sequence[str]] = None,
                 dtype: str = "float32"):
        super().__init__()
        self._config = dict(depth=depth, class_num=class_num,
                            labels=list(labels) if labels else None,
                            dtype=dtype)
        self.resnet = ResNet(depth=depth, class_num=class_num, dtype=dtype)
        self.labels = list(labels) if labels else None
        self.class_num = class_num

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet(x)

    @torch.no_grad()
    def predict_image_set(self, images: np.ndarray, top_n: int = 5
                          ) -> List[List[Tuple[Any, float]]]:
        """The ``top_n`` (label or class index, probability) pairs of each
        image, from eval-mode forwards of 32 images on the model's
        device."""
        self.eval()
        device = next(self.parameters()).device
        probs = []
        for i in range(0, len(images), 32):
            x = torch.as_tensor(np.asarray(images[i:i + 32]), device=device)
            probs.append(torch.softmax(self(x).float(), dim=-1).cpu().numpy())
        out = []
        for row in np.concatenate(probs):
            top = np.argsort(-row)[:top_n]
            out.append([(self.labels[i] if self.labels else int(i),
                         float(row[i])) for i in top])
        return out


def lenet() -> Sequential:
    """The LeNet of ``examples/lenet_mnist.py`` (``build_lenet``, the
    smoke config) for 28 x 28 x 1 images and 10 classes: two tanh 5x5 SAME
    convs each followed by a 2x2 max pool, then tanh dense 120 and 84 and
    a linear head, named as the JAX ``Sequential`` names them."""
    return Sequential([
        Conv2D(1, 6, 5, padding="same", activation="tanh"),
        MaxPooling2D(2),
        Conv2D(6, 16, 5, activation="tanh"),
        MaxPooling2D(2),
        Flatten(),
        Dense(7 * 7 * 16, 120, activation="tanh"),
        Dense(120, 84, activation="tanh"),
        Dense(84, 10),
    ])


__all__ = ["ResNet", "ImageClassifier", "lenet"]
