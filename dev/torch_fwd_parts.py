#!/usr/bin/env python3
"""The PyTorch port's bf16 flash-attention forward on a CUDA card, at
BERT-base's shapes (T 512, D 64): BH 12, 48, 192 and 768 (12 heads x the
serving buckets 1, 4, 16, 64) and 384 (a global-batch-32 training step),
not causal, and BH 384 and 768 causal.

Run from the root of a checkout:

    python3 dev/torch_fwd_parts.py [-DNAME=VALUE | path/to/source.cu ...]

Each argument adds one build variant (``dev/parts_harness.py``) beside the
default build of ``csrc/flash_attention_fwd.cu``.  Every build is
compiled with ``-Xptxas -v`` (its kernels' registers, spills and
warnings are printed), then checked in a process of its own against
``flash_attention_fwd_reference`` at every shape (a build that faults or
disagrees is reported and left out), then the builds that passed are
timed in turns (default, variants, variants reversed, default) in one
process.  For each build and shape it prints one JSON line: the largest
error of out relative to max |ref| and of lse, the CUDA-event time per
call, the card's kernel time per call from ``torch.profiler`` and the
counted TFLOP/s (4 BH T^2 D, the causal half when masked).  Then, as a
yardstick the port never calls, ``F.scaled_dot_product_attention`` on the
same inputs, and the card's name and power limit.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

import torch

import parts_harness as harness
from parts_harness import smoke

fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
SHAPES = [(12, False), (48, False), (192, False), (384, False),
          (768, False), (384, True), (768, True)]
T, D = smoke.SEQ, smoke.TRAIN_SHAPE["d"]
H = smoke.TRAIN_SHAPE["h"]


def ptxas_report(log: str) -> list:
    """ptxas's registers and spills for the forward kernels in nvcc's
    output, and every warning."""
    report, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif "warning" in line.lower():
            report.append(line.strip())
        elif kernel and "flash_fwd" in kernel and (
                "Used" in line or "spill" in line):
            report.append(f"{kernel}: {line.strip()}")
    return report


def inputs() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    out = {}
    for bh, causal in SHAPES:
        if bh not in out:
            out[bh] = tuple(torch.randn(bh, T, D, device="cuda",
                                        generator=gen).to(torch.bfloat16)
                            for _ in range(3))
    return out


def errors(qkv, causal) -> dict:
    got, got_lse = fa.flash_attention_fwd(*qkv, causal)
    ref, ref_lse = fa.flash_attention_fwd_reference(*qkv, causal)
    top = ref.float().abs().max().item()
    return {"out_rel_err": (got.float() - ref.float()).abs().max().item()
            / top, "lse_err": (got_lse - ref_lse).abs().max().item(),
            "finite": bool(torch.isfinite(got).all())}


def check(path: str) -> int:
    """One build against the plain version at every shape, in this
    process; exits non-zero on a fault or an error above chip_smoke's
    tolerances."""
    harness.use(fa.FWD_BF16, path)
    data = inputs()
    ok = True
    for bh, causal in SHAPES:
        err = errors(data[bh], causal)
        ok &= (err["finite"] and err["out_rel_err"] <= smoke.TOL_BF16_REL
               and err["lse_err"] <= smoke.TOL_LSE)
        print(json.dumps({"check": path, "bh": bh, "causal": causal, **err}),
              flush=True)
    return 0 if ok else 1


def flops(bh: int, causal: bool) -> float:
    return 4.0 * bh * (T * (T + 1) / 2 if causal else T * T) * D


def measure(label: str, path: str, data: dict) -> None:
    harness.use(fa.FWD_BF16, path)
    for bh, causal in SHAPES:
        q, k, v = data[bh]

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal)

        print(json.dumps({
            "build": label, "bh": bh, "t": T, "d": D, "causal": causal,
            **errors((q, k, v), causal),
            **harness.timing(kernel, flops(bh, causal)),
            "bound_ms": smoke.attention_bound(bh, T, T, D, 2, causal)[0]}),
            flush=True)


def main(argv) -> int:
    if argv[:1] == ["--check"]:
        return check(argv[1])
    if not torch.cuda.is_available():
        print("torch_fwd_parts: no CUDA device", file=sys.stderr)
        return 2
    builds = ["default"] + list(argv)
    built = harness.build_variants(fa.FWD_BF16, builds, ("-Xptxas", "-v"))
    for label, (_, log) in zip(builds, built):
        print(json.dumps({"build": label, "ptxas": ptxas_report(log)}),
              flush=True)
    # each build checked in a process of its own, all at once, so that a
    # build that faults leaves the others to be timed
    checks = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                "--check", path]) for path, _ in built]
    passed = []
    for label, (path, _), proc in zip(builds, built, checks):
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        print(json.dumps({"build": label, "check_rc": rc}), flush=True)
        if rc == 0:
            passed.append((label, path))
    data = inputs()
    for i in harness.in_turns(len(passed)):
        measure(*passed[i], data)
    for bh, causal in SHAPES:
        q4, k4, v4 = (x.view(bh // H, H, T, D) for x in data[bh])

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)

        print(json.dumps({
            "build": "scaled_dot_product_attention", "bh": bh, "t": T,
            "d": D, "causal": causal,
            **harness.timing(library, flops(bh, causal))}), flush=True)
    print(harness.card(), flush=True)
    return 0 if len(passed) == len(builds) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
