#!/usr/bin/env python3
"""How far 3xTF32 products move the f32 fused cross-entropy backward from
its plain version on a CUDA card, before and apart from any kernel.

Run from the root of a checkout:

    python3 dev/torch_tf32_probe.py

At bench.py's vocab-head shape (2,048 tokens, D 768, V 30,522) and at
(512, 96, 3,001), with h scaled 1 and 100 as ``chip_smoke.py``'s
fused_xent phase makes them, it prints one JSON line per case: the errors
of dh, dW and db, each relative to its max |ref|, against
``fused_xent_bwd_reference`` (cuBLAS f32, TF32 off), of
- ``kernel``: ``csrc/fused_xent.cu``'s f32 backward as built from this
  checkout, fed its own forward's lse;
- ``tf32x3_fwd_lse``: the backward with every product in 3xTF32
  (emulated in torch: each operand split into big = tf32(x) and small =
  tf32(x - big), three f32 matmuls of the parts), fed the plain forward's
  lse;
- ``tf32x3_own_lse``: the same, its lse from its own 3xTF32 logits;
- ``dl_exact``: dl from the plain version's own logits and lse, and only
  dh and dW in 3xTF32.
Then the card's name and power limit.  The emulation's matmuls run in
f32 with TF32 off, so their sums are f32 in cuBLAS's order: the products
are TF32's, the accumulation is not the tensor cores'.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
fx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")

TOL_XENT_F32 = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` by bit operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab = tf32(a)
    as_ = tf32(a - ab)
    bb = tf32(b)
    bs = tf32(b - bb)
    return (ab @ bs + as_ @ bb) + ab @ bb


def emulated_bwd(h, w, bias, labels, lse, g, own_lse=False, exact_dl=False):
    n = h.shape[0]
    scale = g / n
    s = (h @ w if exact_dl else mm3(h, w)) + bias
    if own_lse:
        lse = torch.logsumexp(s, dim=-1)
    dl = torch.exp(s - lse[:, None]) * scale
    dl[torch.arange(n, device=h.device), labels] -= scale
    return mm3(dl, w.T), mm3(h.T, dl), dl.sum(dim=0)


def errors(got, ref) -> list:
    return [(a.float() - b.float()).abs().max().item()
            / b.float().abs().max().item() for a, b in zip(got, ref)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tf32_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.tensor(1.0, device="cuda")
    for n, d, v, chunk, scale in ((2048, 768, 30522, 512, 1.0),
                                  (2048, 768, 30522, 512, 100.0),
                                  (512, 96, 3001, 128, 100.0)):
        h = torch.randn(n, d, device="cuda", generator=gen) * scale
        w = torch.randn(d, v, device="cuda", generator=gen) * 0.05
        bias = torch.randn(v, device="cuda", generator=gen) * 0.1
        labels = torch.randint(0, v, (n,), device="cuda", generator=gen)
        _, rlse = fx.fused_xent_reference(h, w, bias, labels, chunk)
        ref = fx.fused_xent_bwd_reference(h, w, bias, labels, rlse, g, chunk)
        _, klse = fx.fused_xent_fwd(h, w, bias, labels, chunk)
        row = {"n": n, "d": d, "v": v, "h_scale": scale,
               "design": fx.bwd_design(h.dtype),
               "lse_kernel_vs_plain": (klse - rlse).abs().max().item(),
               "kernel": errors(fx.fused_xent_bwd(h, w, bias, labels, klse,
                                                  g, chunk), ref),
               "tf32x3_fwd_lse": errors(emulated_bwd(h, w, bias, labels,
                                                     rlse, 1.0), ref),
               "tf32x3_own_lse": errors(emulated_bwd(h, w, bias, labels,
                                                     rlse, 1.0, True), ref),
               "dl_exact": errors(emulated_bwd(h, w, bias, labels, rlse,
                                               1.0, exact_dl=True), ref),
               "tol": TOL_XENT_F32}
        print(json.dumps(row), flush=True)
        del h, w, ref
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
