#!/usr/bin/env python3
"""Where the PyTorch port's bf16 flash-attention backward spends its time,
on a CUDA card, at BERT-base's training shape (BH 384 = batch 32 x 12
heads, T 512, D 64).

Run from the root of a checkout:

    python3 dev/torch_bwd_parts.py [-DNAME=VALUE | path/to/source.cu ...]

Each argument adds one build variant beside the default build of
``csrc/flash_attention_bwd.cu``: the same source with macros set (one
argument, ``-D`` flags apart by spaces), or another source with the same
C entry points (an edited copy, or an earlier commit's, unpacked with
``git archive`` into a directory ``.gitignore`` lists); the variants are
built together, then timed in turns (default, variants, variants
reversed, default) in one process.  For
each build and for ``causal`` False and True it prints one JSON line: the
largest error against ``flash_attention_bwd_reference`` relative to
max |ref|, the CUDA-event time per call, and the card's kernel time per
call from ``torch.profiler`` in all and by pass (``bwd_delta``,
``bwd_dkdv``, ``bwd_dq``), with counted TFLOP/s (10 BH T^2 D, the causal
half when masked).  Then, as a yardstick the port never calls, the
backward of ``F.scaled_dot_product_attention`` on the same inputs, and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import _build  # noqa: E402

fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
PASSES = ("bwd_delta", "bwd_dkdv", "bwd_dq")


def build_variant(arg: str) -> str:
    """The library of one variant (``arg`` one or more ``-D`` flags, or a
    source's path; empty: the default build); returns its path."""
    if not arg:
        return str(_build.build(fa.BWD))
    if arg.endswith(".cu"):
        flags, source = [], os.path.abspath(arg)
    else:
        flags, source = arg.split(), str(_build.CSRC / f"{fa.BWD}.cu")
    name = "".join(c if c.isalnum() else "_" for c in arg)
    path = _build.BUILD_DIR / f"lib{fa.BWD}-variant-{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
         source], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout.decode(errors="replace"))
    return str(path)


def by_pass(fn, iters: int = 10) -> dict:
    """Kernel time per call of ``fn`` by pass, from one profiler window."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(PASSES, 0.0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for p in PASSES:
                if p in e.key:
                    out[p] += e.self_device_time_total / 1e3 / iters
    return out


def measure(label: str, path: str, inputs: dict) -> None:
    # the wrapper loads its library through _build's cache: point it at
    # this build
    _build._loaded[fa.BWD] = ctypes.CDLL(path)
    for causal, (q, k, v, out, lse, g) in inputs.items():
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal)
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
        err = max((a.float() - b.float()).abs().max().item()
                  / b.float().abs().max().item() for a, b in zip(got, ref))
        del got, ref

        def kernel():
            return fa.flash_attention_bwd(q, k, v, out, lse, g, causal)

        bh, t, d = q.shape
        pairs = t * (t + 1) / 2 if causal else t * t
        dev = smoke.device_ms(kernel, iters=10)
        print(json.dumps({
            "build": label, "causal": causal, "bh": bh, "t": t, "d": d,
            "max_rel_err": err, "ms": smoke.cuda_ms(kernel, iters=10),
            "device_ms": dev, "device_ms_by_pass": by_pass(kernel),
            "counted_tflop_per_s": 10.0 * bh * pairs * d / dev / 1e9}),
            flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_parts: no CUDA device", file=sys.stderr)
        return 2
    builds = ["default"] + list(argv)
    with ThreadPoolExecutor() as pool:
        paths = list(pool.map(
            lambda b: build_variant("" if b == "default" else b), builds))
    bh = smoke.TRAIN_SHAPE["b"] * smoke.TRAIN_SHAPE["h"]
    t, d = smoke.SEQ, smoke.TRAIN_SHAPE["d"]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    inputs = {}
    for causal in (False, True):
        q, k, v, g = (torch.randn(bh, t, d, device="cuda", generator=gen
                                  ).to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        inputs[causal] = (q, k, v, out, lse, g)
    order = list(range(len(builds)))
    order = order + order[1:][::-1] + [0] if len(builds) > 1 else order
    for i in order:
        measure(builds[i], paths[i], inputs)
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
        dev = smoke.device_ms(library, iters=10)
        print(json.dumps({
            "build": "scaled_dot_product_attention backward",
            "causal": causal, "bh": bh, "t": t, "d": d,
            "ms": smoke.cuda_ms(library, iters=10), "device_ms": dev,
            "counted_tflop_per_s": 10.0 * bh * pairs * d / dev / 1e9}),
            flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
