#!/usr/bin/env python3
"""Where the PyTorch port's flash-attention backward spends its time, on a
CUDA card, at BERT-base's training shape (BH 384 = batch 32 x 12 heads, T
512, D 64), in bf16 or (``--f32``) f32.

Run from the root of a checkout:

    python3 dev/torch_bwd_parts.py [--f32] [--parent PKG]
        [-DNAME=VALUE | path/to/source.cu ...]

Each argument adds one build variant (``dev/parts_harness.py``) beside the
default build of ``csrc/flash_attention_bwd.cu``; ``--parent PKG`` adds an
earlier commit's package (``mkdir -p build/parent && git archive <commit>
analytics_zoo_tpu_torch | tar -x -C build/parent``, then ``--parent
build/parent/analytics_zoo_tpu_torch``), its own wrapper driving its own
source.  The builds are compiled together with ``-Xptxas -v`` (each
kernel's registers and spills, and every warning, printed), then timed in
turns (default, variants and parent, the same reversed, default) in one
process.  For
each build and for ``causal`` False and True it prints one JSON line: the
largest error against ``flash_attention_bwd_reference`` relative to
max |ref|, the CUDA-event time per call, and the card's kernel time per
call from ``torch.profiler`` in all and by pass (``split`` (the f32
design's), ``bwd_delta``, ``bwd_dkdv``, ``bwd_dq``), with counted TFLOP/s
(10 BH T^2 D, the causal half when masked).  Then, as a yardstick the port never calls, the
backward of ``F.scaled_dot_product_attention`` on the same inputs, and
the card's name and power limit.
"""

from __future__ import annotations

import importlib
import json
import sys

import torch

import parts_harness as harness
from parts_harness import smoke
from torch_xent_parts import ptxas_report

fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
PASSES = ("split", "bwd_delta", "bwd_dkdv", "bwd_dq")


def by_pass(fn, iters: int = 10) -> dict:
    """Kernel time per call of ``fn`` by pass, from one whole profiler
    window."""
    out = dict.fromkeys(PASSES, 0.0)
    for name, (_, us) in smoke.device_windows(fn, iters, runs=1)[0].items():
        for p in PASSES:
            if p in name:
                out[p] += us / 1e3 / iters
    return out


def measure(label: str, mod, path, inputs: dict) -> None:
    """Time ``mod``'s backward (this checkout's wrapper on the build at
    ``path``, or a parent's wrapper on its own build: ``path`` None)."""
    if path is not None:
        harness.use(fa.BWD, path)
    for causal, (q, k, v, out, lse, g) in inputs.items():
        got = mod.flash_attention_bwd(q, k, v, out, lse, g, causal)
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
        err = max((a.float() - b.float()).abs().max().item()
                  / b.float().abs().max().item() for a, b in zip(got, ref))
        del got, ref

        def kernel():
            return mod.flash_attention_bwd(q, k, v, out, lse, g, causal)

        bh, t, d = q.shape
        pairs = t * (t + 1) / 2 if causal else t * t
        print(json.dumps({
            "build": label, "dtype": str(q.dtype).replace("torch.", ""),
            "design": mod.bwd_design(q.dtype, d), "causal": causal,
            "bh": bh, "t": t, "d": d, "max_rel_err": err,
            **harness.timing(kernel, 10.0 * bh * pairs * d, iters=10),
            "device_ms_by_pass": by_pass(kernel)}), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_parts: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parent, argv = harness.take_parent(list(argv))
    dtype = torch.bfloat16
    if argv[:1] == ["--f32"]:
        dtype, argv = torch.float32, argv[1:]
    builds = ["default"] + list(argv)
    built = harness.build_variants(fa.BWD, builds, ("-Xptxas", "-v"))
    for label, (_, log) in zip(builds, built):
        print(json.dumps({"build": label,
                          "ptxas": ptxas_report(log, "_")}), flush=True)
    sides = [(label, fa, path) for label, (path, _) in zip(builds, built)]
    if parent:
        sides.append(("parent", harness.parent_ops(
            parent, "flash_attention")[0], None))
    bh = smoke.TRAIN_SHAPE["b"] * smoke.TRAIN_SHAPE["h"]
    t, d = smoke.SEQ, smoke.TRAIN_SHAPE["d"]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    inputs = {}
    for causal in (False, True):
        q, k, v, g = (torch.randn(bh, t, d, device="cuda", generator=gen
                                  ).to(dtype) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        inputs[causal] = (q, k, v, out, lse, g)
    for i in harness.in_turns(len(sides)):
        measure(*sides[i], inputs)
    b, h = smoke.TRAIN_SHAPE["b"], smoke.TRAIN_SHAPE["h"]
    for causal, (q, k, v, out, lse, g) in inputs.items():
        q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_()
                      for x in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal)

        def library():
            return torch.autograd.grad(out4, (q4, k4, v4), g.view(b, h, t, d),
                                       retain_graph=True)

        pairs = t * (t + 1) / 2 if causal else t * t
        print(json.dumps({
            "build": "scaled_dot_product_attention backward",
            "causal": causal, "bh": bh, "t": t, "d": d,
            **harness.timing(library, 10.0 * bh * pairs * d, iters=10)}),
            flush=True)
    print(harness.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
