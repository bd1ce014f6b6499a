"""Attention layers: MultiHeadAttention and the Transformer encoder block
(port of ``analytics_zoo_tpu/nn/attention.py``).

Layouts are the JAX package's: activations ``[B, T, H, D]`` inside the
attention, bias-free projections ``wq/wk/wv`` of shape ``(d_model, H*D)`` and
``wo`` of shape ``(H*D, d_model)``.  With ``use_flash`` and no mask the core
goes through ``ops.flash_attention`` (the CUDA kernel on the card);
otherwise through the dense ``dot_product_attention``.

A layer given a ``parallel.tensor_parallel.ModelParallel`` as ``tp`` (the
Estimator does, over a mesh with a ``model`` axis and the tensor-parallel
rules) computes its share of the model group: its block of heads of
``wq``/``wk``/``wv`` and of ``wo``'s rows, and in ``TransformerLayer`` its
block of ``ffn1``'s columns and ``ffn2``'s rows, the partial outputs
summed over the group.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.utils.checkpoint
from torch import nn

from . import initializers
from .layers import Dense, Dropout, LayerNormalization

# use_flash="auto" switches to the flash kernel at this kv length.  The value
# is the JAX package's (chosen there from its own hardware's timings); it has
# not been measured on the H100 yet.
FLASH_AUTO_MIN_SEQ = 2048


def causal_mask(tq: int, tk: Optional[int] = None,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``[1, 1, Tq, Tk]`` lower-triangular attend-mask by absolute position
    (so Tq != Tk works)."""
    tk = tq if tk is None else tk
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])[None, None]


class _HalfLogits(torch.autograd.Function):
    """``q @ k^T`` of bf16 (or f16) ``[BH, Tq, D]`` and ``[BH, Tk, D]``
    operands into f32 logits on the tensor cores (``aten::bmm.dtype``),
    the reference's ``preferred_element_type=jnp.float32``; the op has no
    autograd formula, so the backward is written here as JAX's autodiff
    of that einsum computes it: the f32 cotangent times the other operand
    with f32 out, rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k)
        return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k = ctx.saved_tensors
        dq = torch.bmm(g, k.float()).to(q.dtype)
        dk = torch.bmm(g.transpose(1, 2), q.float()).to(k.dtype)
        return dq, dk


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain attention: q, k, v ``[B, T, H, D]`` -> ``[B, T, H, D]``; logits
    in f32.  ``mask`` broadcasts to ``[B, H, Tq, Tk]``: 1 attends, 0 masks
    (with -1e30).  On the card, bf16 or f16 q and k go into f32 logits on
    the tensor cores (``_HalfLogits``); on the CPU they are upcast first,
    which gives the same products (a bf16 x bf16 product is exact in
    f32)."""
    d = q.shape[-1]
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) \
            and k.dtype == q.dtype:
        b, tq, h, _ = q.shape
        tk = k.shape[1]
        logits = _HalfLogits.apply(
            q.permute(0, 2, 1, 3).reshape(b * h, tq, d),
            k.permute(0, 2, 1, 3).reshape(b * h, tk, d)).view(b, h, tq, tk)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask.bool(), logits, -1e30)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class MultiHeadAttention(nn.Module):
    """``remat``: recompute the dense attention core (logits, softmax) in
    the backward instead of keeping its ``[B, H, Tq, Tk]`` maps
    (``torch.utils.checkpoint``); the flash core never keeps them, so
    ``remat`` with ``use_flash=True`` is refused, as in the JAX package
    (``"auto"`` composes: remat applies when it picks the dense path)."""

    def __init__(self, d_model: int, num_heads: int,
                 head_dim: Optional[int] = None, dropout: float = 0.0,
                 use_flash: Union[bool, str] = False, causal: bool = False,
                 remat: bool = False):
        super().__init__()
        if use_flash not in (True, False, "auto"):
            raise ValueError(f"use_flash must be True, False, or 'auto'; "
                             f"got {use_flash!r}")
        if remat and use_flash is True:
            raise ValueError(
                "remat=True applies to the dense attention path only; "
                "use_flash/use_ring kernels already rematerialize — "
                "pick one (use_flash='auto' composes with remat)")
        self.num_heads = num_heads
        self.head_dim = head_dim or d_model // num_heads
        self.use_flash = use_flash
        self.causal = causal
        self.remat = remat
        inner = num_heads * self.head_dim
        self.wq = nn.Parameter(torch.empty(d_model, inner))
        self.wk = nn.Parameter(torch.empty(d_model, inner))
        self.wv = nn.Parameter(torch.empty(d_model, inner))
        self.wo = nn.Parameter(torch.empty(inner, d_model))
        self.drop = Dropout(dropout)
        self.tp = None  # a ModelParallel: compute this rank's heads
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.wq, self.wk, self.wv, self.wo):
            initializers.glorot_uniform(w, generator)

    def _proj(self, w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        y = src @ w.to(src.dtype)
        return y.reshape(src.shape[:-1] + (-1, self.head_dim))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tp = self.tp
        wq, wk, wv, wo = self.wq, self.wk, self.wv, self.wo
        if tp is not None:
            # this rank's heads: a block of wq/wk/wv's columns, of wo's rows
            cols = tp.block(self.num_heads * self.head_dim)
            wq, wk, wv, wo = wq[:, cols], wk[:, cols], wv[:, cols], wo[cols]
            x = tp.copy_to(x)
            kv = x if kv is None else tp.copy_to(kv)
        kv = x if kv is None else kv
        q = self._proj(wq, x)
        k = self._proj(wk, kv)
        v = self._proj(wv, kv)
        use_flash = self.use_flash
        if use_flash == "auto":
            use_flash = kv.shape[1] >= FLASH_AUTO_MIN_SEQ
        if use_flash and mask is None:
            from ..ops import flash_attention
            ctx = flash_attention(q, k, v, causal=self.causal)
        else:
            # an explicit mask takes the dense path (the kernel takes no
            # mask); causal still applies there, combined with the mask
            if self.causal:
                cm = causal_mask(x.shape[1], kv.shape[1], device=x.device)
                mask = cm if mask is None else (mask.bool() & cm)
            if self.remat and torch.is_grad_enabled():
                # the core draws no random numbers, so no generator state
                # is kept for the recompute (reading the card's generator
                # state is refused inside a CUDA graph capture)
                ctx = torch.utils.checkpoint.checkpoint(
                    dot_product_attention, q, k, v, mask,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                ctx = dot_product_attention(q, k, v, mask)
        out = ctx.reshape(x.shape[:-1] + (-1,)) @ wo.to(x.dtype)
        if tp is not None:
            out = tp.reduce_from(out)
        return self.drop(out)


class TransformerLayer(nn.Module):
    """Pre- or post-LN Transformer encoder block."""

    def __init__(self, d_model: int, num_heads: int, hidden_mult: int = 4,
                 dropout: float = 0.0, pre_ln: bool = False,
                 use_flash: Union[bool, str] = False, causal: bool = False,
                 remat_attention: bool = False):
        super().__init__()
        self.pre_ln = pre_ln
        self.mha = MultiHeadAttention(d_model, num_heads, dropout=dropout,
                                      use_flash=use_flash, causal=causal,
                                      remat=remat_attention)
        self.ln1 = LayerNormalization(d_model)
        self.ln2 = LayerNormalization(d_model)
        self.ffn1 = Dense(d_model, d_model * hidden_mult, activation="gelu")
        self.ffn2 = Dense(d_model * hidden_mult, d_model)
        self.drop = Dropout(dropout)
        self.tp = None  # a ModelParallel: compute this rank's ffn block

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            return self.ffn2(self.ffn1(x))
        # this rank's block of ffn1's columns and of ffn2's rows
        c = tp.block(self.ffn1.units)
        h = tp.copy_to(x) @ self.ffn1.kernel[:, c].to(x.dtype)
        h = self.ffn1.activation(h + self.ffn1.bias[c].to(h.dtype))
        y = tp.reduce_from(h @ self.ffn2.kernel[c].to(h.dtype))
        return y + self.ffn2.bias.to(y.dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.drop(self.mha(self.ln1(x), mask=mask))
            return x + self.drop(self._ffn(self.ln2(x)))
        x = self.ln1(x + self.drop(self.mha(x, mask=mask)))
        return self.ln2(x + self.drop(self._ffn(x)))
