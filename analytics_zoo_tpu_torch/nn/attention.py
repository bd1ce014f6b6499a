"""Attention layers: MultiHeadAttention and the Transformer encoder block
(port of ``analytics_zoo_tpu/nn/attention.py``).

Layouts are the JAX package's: activations ``[B, T, H, D]`` inside the
attention, bias-free projections ``wq/wk/wv`` of shape ``(d_model, H*D)`` and
``wo`` of shape ``(H*D, d_model)``.  With ``use_flash`` and no mask the core
goes through ``ops.flash_attention`` (the CUDA kernel on the card);
otherwise through the dense ``dot_product_attention``.
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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain attention: q, k, v ``[B, T, H, D]`` -> ``[B, T, H, D]``; logits
    in f32.  ``mask`` broadcasts to ``[B, H, Tq, Tk]``: 1 attends, 0 masks
    (with -1e30)."""
    d = q.shape[-1]
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
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.wq, self.wk, self.wv, self.wo):
            initializers.glorot_uniform(w, generator)

    def _proj(self, w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        y = src @ w.to(src.dtype)
        return y.reshape(src.shape[:-1] + (self.num_heads, self.head_dim))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        q = self._proj(self.wq, x)
        k = self._proj(self.wk, kv)
        v = self._proj(self.wv, kv)
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
        out = ctx.reshape(x.shape[:-1] + (-1,)) @ self.wo.to(x.dtype)
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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.drop(self.mha(self.ln1(x), mask=mask))
            return x + self.drop(self.ffn2(self.ffn1(self.ln2(x))))
        x = self.ln1(x + self.drop(self.mha(x, mask=mask)))
        return self.ln2(x + self.drop(self.ffn2(self.ffn1(x))))
