"""Tensor-parallel compute along the mesh's ``model`` axis (Megatron's
column- and row-parallel pair), for the layers whose weights the rules
shard over ``model``.

The JAX package lets GSPMD partition the matmuls that its sharding rules
place; here the layers do it themselves when the Estimator hands them a
:class:`ModelParallel` (``orca/learn/scaleout.py``): each rank of the
model group computes its contiguous block of the column-parallel outputs
(its heads of ``wq``/``wk``/``wv``, its columns of ``ffn1``) from the
replicated input, multiplies them by its block of rows of the
row-parallel weight (``wo``, ``ffn2``), and the partial outputs are summed
over the group.  Two autograd functions carry the collectives:
:func:`copy_to` (identity forward, all-reduce of the input's gradient)
and :func:`reduce_from` (all-reduce forward, identity backward).  The
kernels (the flash attention over the local heads) see plain local
tensors.
"""

from __future__ import annotations

from typing import Any

import torch


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelParallel:
    """One rank's share of the model axis: the group, its size and this
    rank's index in it."""

    def __init__(self, group: Any, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` (``size`` equal blocks,
        the sharding rules' pieces)."""
        m = n // self.size
        return slice(self.index * m, (self.index + 1) * m)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated input of a column-parallel layer: its gradient
        is summed over the group."""
        return _CopyToModel.apply(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial output summed over the group."""
        return _ReduceFromModel.apply(x, self.group)


__all__ = ["ModelParallel"]
