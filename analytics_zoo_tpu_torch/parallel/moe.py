"""Mixture-of-Experts layer with expert parallelism (port of
``analytics_zoo_tpu/parallel/moe.py``).

GShard/Switch-style capacity-based dense dispatch, as the JAX layer: an
f32 router, top-k in order with a capacity, the token -> expert routing
as einsums against one-hot dispatch and combine tensors, static shapes
throughout.  The Switch load-balance loss is kept in the ``aux_loss``
buffer (the JAX state's leaf) and handed to the Estimator's aux-loss
channel (``nn.module.record_aux_loss``).  The einsums are
``torch.einsum``; the JAX package computes them outside any Pallas
kernel.

Expert parallelism.  The JAX package lets GSPMD shard ``wi``/``wo`` over
the ``expert`` axis (``parallel/sharding.py``'s ``moe.*wi$`` /
``moe.*wo$`` rules).  Here the Estimator hands the layer an
``ExpertParallel`` (``orca/learn/scaleout.py``) when those rules place
the expert dim over a sized ``expert`` axis: the tokens are replicated
over the expert group (the feed shards the batch over ``data``/``fsdp``
only), so each rank computes the router, the dispatch and the combine
for all tokens and runs only its ``E/n`` experts; the experts' outputs
are all-gathered over the group, whose backward keeps this rank's block
of the gradient, and the experts' input goes through ``copy_to`` (its
gradient summed over the group).  The router's gradient is then whole
on every rank, and no all-to-all is needed.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..nn import activations, initializers
from ..nn.module import record_aux_loss
from . import comm


class _GatherExperts(torch.autograd.Function):
    """Every rank's block of experts, concatenated along dim 0; the
    backward keeps this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.block = (index, x.shape[0])
        return torch.cat(comm.all_gather(x, group, size), dim=0)

    @staticmethod
    def backward(ctx, g):
        index, n = ctx.block
        return g[index * n:(index + 1) * n].contiguous(), None, None, None


class ExpertParallel:
    """This rank's share of the ``expert`` axis: the group, its size and
    this rank's index (its experts are block ``index`` of ``size``);
    ``local``: the layer's ``wi``/``wo`` hold only those experts."""

    def __init__(self, group: Any, size: int, index: int,
                 local: bool = False):
        self.group, self.size, self.index = group, int(size), int(index)
        self.local = bool(local)

    def block(self, n: int) -> slice:
        m = n // self.size
        return slice(self.index * m, (self.index + 1) * m)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        from .tensor_parallel import _CopyToModel
        return _CopyToModel.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherExperts.apply(x, self.group, self.size, self.index)


class MoE(nn.Module):
    """Token-choice MoE FFN: ``[B, T, D] -> [B, T, D]``.

    ``num_experts`` experts, each a 2-layer FFN (``D -> D * hidden_mult ->
    D``); top-k routing with capacity ``capacity_factor * B * T * top_k /
    num_experts``.  Overflowing tokens are dropped (Switch behaviour): the
    residual around the layer carries them.  Parameters in the JAX
    layout: ``gate`` ``(D, E)``, ``wi`` ``(E, D, D*h)``, ``wo`` ``(E, D*h,
    D)``; ``d_model`` is given up front (PyTorch builds parameters at
    construction)."""

    def __init__(self, d_model: int, num_experts: int, hidden_mult: int = 4,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: Any = "gelu"):
        super().__init__()
        self.num_experts = num_experts
        self.hidden_mult = hidden_mult
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.act = activations.get(activation)
        dh = d_model * hidden_mult
        self.gate = nn.Parameter(torch.empty(d_model, num_experts))
        self.wi = nn.Parameter(torch.empty(num_experts, d_model, dh))
        self.wo = nn.Parameter(torch.empty(num_experts, dh, d_model))
        self.register_buffer("aux_loss", torch.zeros(()))
        self.ep: Optional[ExpertParallel] = None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.gate, self.wi, self.wo):
            initializers.glorot_uniform(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        e, k = self.num_experts, self.top_k
        s = b * t
        cap = max(1, int(self.capacity_factor * s * k / e))
        xs = x.reshape(s, d)
        probs = torch.softmax(xs.float() @ self.gate.float(), dim=-1)

        # top-k sequential assignment: the k = 0 choices get capacity first
        assign = []
        masked = probs
        for _ in range(k):
            onehot = F.one_hot(torch.argmax(masked, dim=-1), e).float()
            assign.append(onehot)
            masked = masked * (1.0 - onehot)
        assign = torch.stack(assign)                             # [K, S, E]

        # positions: the running count in (k-major, then token) order
        flat = assign.reshape(k * s, e)
        pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, s, e)
        keep = (pos < cap).float() * assign                      # [K, S, E]

        gates = torch.einsum("se,kse->ks", probs, keep)          # [K, S]
        if k > 1:
            # renormalized among the chosen experts (GShard top-2); top-1
            # keeps the raw probability (Switch), so the router keeps its
            # gradient from the task loss
            gates = gates / torch.clamp_min(gates.sum(0, keepdim=True), 1e-9)

        # a position past the capacity is an all-zero row, as jax.nn.one_hot
        # gives it
        pos_oh = F.one_hot(pos.long().clamp(max=cap), cap + 1)[
            ..., :cap].float()                                   # [K,S,E,C]
        dispatch = torch.einsum("kse,ksec->sec", keep, pos_oh)
        combine = torch.einsum("ks,kse,ksec->sec", gates, keep, pos_oh)

        xf = xs.float()
        wi, wo, ep = self.wi, self.wo, self.ep
        if ep is not None:
            # this rank's experts: its block of the dispatch, wi and wo
            blk = ep.block(e)
            xf = ep.copy_to(xf)
            dispatch = dispatch[:, blk]
            if not ep.local:
                wi, wo = wi[blk], wo[blk]
        expert_in = torch.einsum("sec,sd->ecd", dispatch, xf)    # [E, C, D]
        h = self.act(torch.einsum("ecd,edh->ech", expert_in, wi.float()))
        expert_out = torch.einsum("ech,ehd->ecd", h, wo.float())
        if ep is not None:
            expert_out = ep.gather(expert_out)
        out = torch.einsum("sec,ecd->sd", combine, expert_out)   # [S, D]

        # Switch load-balance loss: E * sum_e(token_frac_e * prob_frac_e)
        aux = e * torch.sum(assign[0].mean(0) * probs.mean(0))
        record_aux_loss(self, aux)
        with torch.no_grad():
            self.aux_loss.copy_(aux)
        return out.reshape(b, t, d).to(x.dtype)


__all__ = ["ExpertParallel", "MoE"]
