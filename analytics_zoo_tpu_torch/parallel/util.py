# Port of analytics_zoo_tpu/parallel/util.py: the batch-shard geometry and
# the quantized gradient collective (no counterpart of pvary_like: see the
# module's docstring).
"""Batch-shard geometry and the quantized gradient all-reduce.

The compression half models EQuARX-style quantized AllReduce: each batch
shard's gradient is quantized as it would travel on the wire.  In the
JAX package one process vmaps the step over the ``[S, ...]`` shards and
reduces the stack; here one shard is one rank, and
:func:`allreduce_compressed` moves the quantized payload itself: each rank
quantizes ``g + residual`` with its own per-leaf scale, the ranks
``all_gather`` the int8 codes and the f32 scales, and every rank sums the
dequantized parts in f32, in rank order, and divides by S (bf16: the parts
in bf16).  :func:`compressed_allreduce` is the stacked form over ``[S,
...]`` tensors on one process, the JAX function's twin, which the tests
hold to it.

The JAX module's ``pvary_like`` has no counterpart: it marks values as
varying over ``shard_map``'s manual axes (JAX's type bookkeeping), and a
process that holds its own shard carries no such types.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

#: Valid values for ``ZooEstimator(grad_compression=...)`` (beyond None).
GRAD_COMPRESSION = ("none", "bf16", "int8")

#: Guard against divide-by-zero on all-zero gradient leaves.
_SCALE_FLOOR = 1e-30


def batch_shard_count(mesh: Any) -> int:
    """Batch shards = the gradient contributions the data-parallel reduce
    combines (the feed's batch-axis size, ``data.feed.batch_axis_size``)."""
    from ..data.feed import batch_axis_size
    return batch_axis_size(mesh)


def batch_shard_spec(mesh: Any, rank: int) -> Tuple[Any, ...]:
    """The spec of a ``[n_shards, ...]`` stack with one slice a batch shard:
    dim 0 over the feed's batch axes the mesh has, the rest replicated."""
    from ..data.feed import BATCH_AXES
    from .sharding import P
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    if not axes:
        return P()
    return P(axes if len(axes) > 1 else axes[0], *([None] * max(0, rank - 1)))


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(shard, leaf) int8 quantization of a ``[S, ...]``
    stack: one max-abs scale a leading slice.  Returns ``(q int8, scale
    f32 broadcastable against g)``."""
    dims = tuple(range(1, g.dim()))
    if g.numel() == 0:  # an empty leaf: nothing to scale
        scale = g.new_zeros((g.shape[0],) + (1,) * len(dims))
    else:
        scale = (g.abs().amax(dim=dims, keepdim=True) if dims
                 else g.abs()) / 127.0
    scale = torch.clamp_min(scale, _SCALE_FLOOR)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_allreduce(stacked: Sequence[torch.Tensor], method: str,
                         ef: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[List[torch.Tensor],
                                    Optional[List[torch.Tensor]]]:
    """The mean over dim 0 of each ``[S, ...]`` leaf through the wire width
    ``method`` (the JAX package's ``compressed_allreduce`` on one process):
    ``"none"`` an f32 sum, ``"bf16"`` each shard's part rounded to bf16,
    ``"int8"`` each shard quantizing ``g + residual`` with its own scale,
    the dequantized parts summed in f32 and the quantization error the new
    residual.  Returns ``(means, new_ef)``; ``new_ef`` is None unless
    int8."""
    stacked = list(stacked)
    if not stacked:
        return stacked, None if ef is None else list(ef)
    s = stacked[0].shape[0]
    if method in ("none", None):
        return [g.float().sum(0) / s for g in stacked], None
    if method == "bf16":
        return [g.to(torch.bfloat16).float().sum(0) / s for g in stacked], None
    if method == "int8":
        if ef is None:
            ef = [torch.zeros_like(g, dtype=torch.float32) for g in stacked]
        out, new_ef = [], []
        for g, r in zip(stacked, ef):
            gin = g.float() + r
            q, scale = quantize_int8(gin)
            deq = q.float() * scale
            out.append(deq.sum(0) / s)
            new_ef.append(gin - deq)
        return out, new_ef
    raise ValueError(f"unknown grad compression {method!r}; "
                     f"known: {GRAD_COMPRESSION}")


def allreduce_compressed(grads: Sequence[torch.Tensor], method: str,
                         group: Any, size: int,
                         ef: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[List[torch.Tensor],
                                    Optional[List[torch.Tensor]]]:
    """This rank's gradients reduced to the mean over the ``size`` ranks
    of ``group`` (``None``: this process alone) through the wire width
    ``method`` (``"bf16"`` or ``"int8"``); ``ef`` are this rank's
    residuals (int8; zeros where None).  The payload gathered is the
    compressed one: bf16 parts, or int8 codes with one f32 scale a leaf;
    the parts are summed in f32 in rank order.  Returns ``(means,
    new_ef)``."""
    import torch.distributed as dist

    def gather(t: torch.Tensor) -> List[torch.Tensor]:
        if group is None:
            return [t]
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts

    if method == "bf16":
        out = []
        for g in grads:
            acc = None
            for part in gather(g.to(torch.bfloat16)):
                acc = part.float() if acc is None else acc + part.float()
            out.append(acc / size)
        return out, None
    if method != "int8":
        raise ValueError(f"allreduce_compressed takes 'bf16' or 'int8', "
                         f"not {method!r}")
    if ef is None:
        ef = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
    gins = [g.float() + r for g, r in zip(grads, ef)]
    # each leaf as a one-shard stack: quantize_int8's one scale a leaf
    coded = [quantize_int8(gi[None]) for gi in gins]
    all_scales = gather(torch.stack([sc.reshape(()) for _, sc in coded]))
    out, new_ef = [], []
    for i, (gi, (q, sc)) in enumerate(zip(gins, coded)):
        acc = None
        for part, scales in zip(gather(q[0]), all_scales):
            d = part.float() * scales[i]
            acc = d if acc is None else acc + d
        out.append(acc / size)
        new_ef.append(gi - q[0].float() * sc[0])
    return out, new_ef


def grad_wire_bytes(params: Sequence[Any], method: Optional[str]) -> int:
    """Gradient bytes one rank puts on the wire a step at the configured
    width (the ``train.grad_bytes`` series); int8's per-leaf scales are
    left out of both sides of the ratio, as in the JAX package."""
    n = sum(int(p.numel()) if isinstance(p, torch.Tensor)
            else int(getattr(p, "size", 0)) for p in params)
    per = {"none": 4, None: 4, "bf16": 2, "int8": 1}.get(method)
    if per is None:
        raise ValueError(f"unknown grad compression {method!r}; "
                         f"known: {GRAD_COMPRESSION}")
    return per * n


__all__ = ["GRAD_COMPRESSION", "allreduce_compressed", "batch_shard_count",
           "batch_shard_spec", "compressed_allreduce", "grad_wire_bytes",
           "quantize_int8"]
