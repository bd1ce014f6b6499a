"""GPipe-style pipeline parallelism over the mesh's ``pipe`` axis (port of
``analytics_zoo_tpu/parallel/pipeline.py``).

The JAX package stacks the stages' parameters on a leading dim sharded
over ``pipe`` and runs the GPipe schedule in a ``lax.scan`` inside
``shard_map``: ``M + S - 1`` ticks, at tick ``t`` stage ``i`` processing
microbatch ``t - i`` while the activations rotate stage -> stage + 1
(``ppermute``), each device applying its ``L = n_stages / S`` stages in
order.  Here one rank of the ``pipe`` group is one process: rank ``r``
takes microbatch ``m`` from rank ``r - 1`` (rank 0 from ``x``), applies
its ``L`` stages and posts the result to rank ``r + 1``, in microbatch
order, so rank ``r`` works on microbatch ``m`` while rank ``r + 1`` works
on ``m - 1``: the same ``M + S - 1`` steps, without the JAX scan's
computation on padding.  The receive is an autograd function whose
backward sends the activation's gradient back to rank ``r - 1``; the last
stage's outputs reach every rank (``broadcast``), as the JAX version's
``out[-1]`` does.  A rank receives before it sends only where the
schedule says so (its input before its output), and the backward's
receives are all posted before any of them is waited on, so no rank waits
on one that waits on it.

Gradients.  Every rank computes the same loss from the broadcast output
(what follows is replicated over the group); the backward takes the last
stage's rank's gradient of the output, as the JAX program, which computes
the loss once, and ignores the other ranks' copies.  A stage's parameters
get their gradient on the rank that runs the stage; the other ranks'
rows of the stacked gradient are zero, so the sum over the group is the
JAX gradient.  ``x``'s gradient is stage 0's, on rank 0.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch import nn
from torch.utils import _pytree as pytree

from . import comm


def stacked_stage_init(stage_init: Callable[[torch.Generator], Any],
                       n_stages: int, rng: Any = 0) -> Any:
    """One parameter tree a stage (``stage_init(generator)``, each stage
    its own generator drawn from ``rng``: a seed or a
    ``torch.Generator``), the leaves stacked on a leading stage dim."""
    gen = rng if isinstance(rng, torch.Generator) \
        else torch.Generator().manual_seed(int(rng))
    seeds = torch.randint(0, 2 ** 62, (n_stages,), generator=gen).tolist()
    trees = [stage_init(torch.Generator().manual_seed(int(s)))
             for s in seeds]
    flat, spec = zip(*(pytree.tree_flatten(t) for t in trees))
    return pytree.tree_unflatten(
        [torch.stack(ls) for ls in zip(*flat)], spec[0])


def _n_stages(stage_params: Any) -> int:
    return pytree.tree_leaves(stage_params)[0].shape[0]


def _stage(stage_params: Any, i: int) -> Any:
    return pytree.tree_map(lambda leaf: leaf[i], stage_params)


def _caller(apply_fn: Any) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """``apply_fn(params_i, x)``; a module runs through
    ``torch.func.functional_call`` with ``params_i`` its parameters."""
    if isinstance(apply_fn, nn.Module):
        from torch.func import functional_call
        return lambda params, x: functional_call(apply_fn, params, (x,))
    return apply_fn


class _Recv(torch.autograd.Function):
    """Microbatch ``tag``'s activation from the previous rank; the
    backward sends its gradient back there."""

    @staticmethod
    def forward(ctx, anchor, like, src, tag, group):
        ctx.link = (src, tag, group)
        return comm.recv(like, src, group, tag)

    @staticmethod
    def backward(ctx, g):
        src, tag, group = ctx.link
        comm.send(g, src, group, tag)
        return None, None, None, None, None


class _Output(torch.autograd.Function):
    """The last stage's microbatch outputs, concatenated on the last rank
    and broadcast over the group; the backward hands each of this rank's
    ``sent`` tensors its gradient: the output's on the last rank, the next
    rank's sends elsewhere (all posted, then waited on)."""

    @staticmethod
    def forward(ctx, info, *sent):
        group, size, my, shape, dtype = info
        ctx.info, ctx.shapes = info, [(t.shape, t.dtype) for t in sent]
        if my == size - 1:
            out = torch.cat([t.to(dtype) for t in sent])
        else:
            out = torch.empty(shape, dtype=dtype, device=sent[0].device)
        return comm.broadcast(out, size - 1, group)

    @staticmethod
    def backward(ctx, g):
        group, size, my, _, dtype = ctx.info
        if my == size - 1:
            parts = g.split([s[0] for s, _ in ctx.shapes])
        else:
            posted = comm.Posted(group)
            # the microbatches' backwards run last to first
            for m in reversed(range(len(ctx.shapes))):
                posted.recv(torch.empty(ctx.shapes[m][0], dtype=dtype,
                                        device=g.device), my + 1, m)
            parts = posted.wait()[::-1]
        return (None, *(p.to(dt) for p, (_, dt) in zip(parts, ctx.shapes)))


def pipeline_apply(apply_fn: Any, stage_params: Any, x: torch.Tensor,
                   n_microbatches: int, mesh: Any = None,
                   axis_name: str = "pipe") -> torch.Tensor:
    """Run ``apply_fn(stage_params_i, x)`` as a pipeline over the mesh
    (default the context's).

    ``stage_params``: a tree (dict, list) of tensors with a leading stage
    dim (``stacked_stage_init``), the whole stack on every rank: rank ``r``
    of the ``pipe`` group runs stages ``[r L, (r + 1) L)``.  ``apply_fn``:
    a function of ``(params_i, x)`` or an ``nn.Module`` (called through
    ``functional_call``).  ``x``: ``[B, ...]``, ``B`` a multiple of
    ``n_microbatches``.  The output has ``x``'s shape and dtype (stages
    preserve shape, the GPipe constraint).  Without a ``pipe`` axis (or at
    size 1) the stages run in order on the whole batch.  See the module's
    doc for the gradients."""
    call = _caller(apply_fn)
    if mesh is None:
        from ..core.context import current_mesh
        mesh = current_mesh()
    n = _n_stages(stage_params)
    if mesh is None or axis_name not in mesh.axis_names \
            or mesh.shape[axis_name] == 1:
        out = x
        for i in range(n):
            out = call(_stage(stage_params, i), out)
        return out
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible into {n_microbatches} "
                         "microbatches")
    size = mesh.shape[axis_name]
    if n % size:
        raise ValueError(
            f"{n} stages do not divide over pipe axis of size {size}; each "
            "device must own an equal number of stages")
    group = mesh.group((axis_name,))
    my = mesh.index((axis_name,))
    local = n // size
    mb = b // n_microbatches
    like = torch.empty((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    posted = comm.Posted(group)
    sent: List[torch.Tensor] = []
    for m in range(n_microbatches):
        if my == 0:
            h = x[m * mb:(m + 1) * mb]
        else:
            h = _Recv.apply(anchor, like, my - 1, m, group)
        for j in range(local):
            h = call(_stage(stage_params, my * local + j), h)
        if my < size - 1:
            posted.send(h.detach().to(x.dtype), my + 1, m)
        sent.append(h)
    posted.wait()
    return _Output.apply((group, size, my, tuple(x.shape), x.dtype), *sent)


__all__ = ["pipeline_apply", "stacked_stage_init"]
