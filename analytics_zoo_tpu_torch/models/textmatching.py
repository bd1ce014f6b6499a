"""KNRM kernel-pooling text matching (port of
``analytics_zoo_tpu/models/textmatching.py``; reference:
zoo.models.textmatching, KNRM.scala; Xiong et al., K-NRM).

Query/doc token ids -> shared embedding -> cosine translation matrix ->
RBF kernel pooling -> linear ranking score.  The exact-match kernel (mu 1,
sigma ``exact_sigma``, 0.001 by default) is very sharp: the translation
matrix must be an f32 product, so on the card TF32 must stay off for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.layers import Dense, Embedding
from .common import ZooModel


class KNRM(ZooModel):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int = 20000, embed_size: int = 300,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking"):
        super().__init__()
        self._config = dict(text1_length=text1_length,
                            text2_length=text2_length, vocab_size=vocab_size,
                            embed_size=embed_size, kernel_num=kernel_num,
                            sigma=sigma, exact_sigma=exact_sigma,
                            target_mode=target_mode)
        for k, v in self._config.items():
            setattr(self, k, v)
        self.embed = Embedding(vocab_size, embed_size)
        self.score = Dense(kernel_num, 1)
        mus = np.linspace(-1.0, 1.0, kernel_num)
        sigmas = np.full(kernel_num, sigma)
        sigmas[-1] = exact_sigma  # the exact-match kernel at mu=1
        # f32 constants as the JAX package makes them; not part of the
        # variables (persistent=False keeps them out of the state_dict)
        self.register_buffer("mus", torch.tensor(mus, dtype=torch.float32),
                             persistent=False)
        self.register_buffer(
            "sigmas", torch.tensor(sigmas, dtype=torch.float32),
            persistent=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids: int [B, text1_length + text2_length] (query ++ doc)."""
        # one shared embedding over the concatenated ids (the reference
        # ties query/doc embeddings); split after the gather
        qd = self.embed(ids)
        q = qd[:, :self.text1_length]
        d = qd[:, self.text1_length:]
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
        dn = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
        trans = torch.einsum("bqe,bde->bqd", qn, dn)  # cosine match matrix
        # RBF kernels: [B, Q, D, K] -> sum over D, log, sum over Q
        k = torch.exp(-torch.square(trans[..., None] - self.mus)
                      / (2.0 * torch.square(self.sigmas)))
        s = k.sum(dim=2)
        # jnp.clip(s, 1e-10) is a maximum: half the gradient at a tie
        pooled = torch.log(torch.maximum(s, torch.full_like(s, 1e-10))) \
            * 0.01
        feats = pooled.sum(dim=1)                    # [B, K]
        out = self.score(feats)
        if self.target_mode == "classification":
            out = torch.cat([torch.zeros_like(out), out], dim=-1)
        return out


__all__ = ["KNRM"]
