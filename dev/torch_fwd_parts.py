#!/usr/bin/env python3
"""The PyTorch port's flash-attention forward on a CUDA card, at
BERT-base's shapes (T 512, D 64).  bf16: BH 12, 48, 192 and 768 (12 heads
x the serving buckets 1, 4, 16, 64) and 384 (a global-batch-32 training
step), not causal, and BH 384 and 768 causal.  f32 (``--f32``): BH 12,
96 (bert_train (a)'s batch 8), 192 and 768, not causal, and BH 192
causal.

Run from the root of a checkout:

    python3 dev/torch_fwd_parts.py [--f32] [--parent PKG]
        [-DNAME=VALUE | path/to/source.cu ...]

Each argument adds one build variant (``dev/parts_harness.py``) beside the
default build of ``csrc/flash_attention_fwd.cu`` (``--f32``:
``csrc/flash_attention_fwd_f32.cu``); ``--parent PKG`` adds
an earlier commit's package (unpacked as ``dev/torch_bwd_parts.py``
says), its own wrapper driving its own source, timed in turns with the
builds but not checked in a process of its own.  Every build is
compiled with ``-Xptxas -v`` (its kernels' registers, spills and
warnings are printed), then checked in a process of its own against
``flash_attention_fwd_reference`` at every shape (a build that faults or
disagrees is reported and left out), then the builds that passed are
timed in turns (default, variants, variants reversed, default) in one
process.  For each build and shape it prints one JSON line: the largest
error of out relative to max |ref| and of lse, the CUDA-event time per
call, the card's kernel time per call from ``torch.profiler`` and the
counted TFLOP/s (4 BH T^2 D, the causal half when masked), and, in f32,
the card's time by pass (``split``, the 3xTF32 design's split pass, and
``fwd``) beside the 3xTF32 and the FMAs' bounds.  Then, as a yardstick
the port never calls, ``F.scaled_dot_product_attention`` on the same
inputs, and the card's name and power limit.
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
SHAPES = {torch.bfloat16: [(12, False), (48, False), (192, False),
                           (384, False), (768, False), (384, True),
                           (768, True)],
          torch.float32: [(12, False), (96, False), (192, False),
                          (768, False), (192, True)]}
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
        elif kernel and ("flash_fwd" in kernel or "split" in kernel) and (
                "Used" in line or "spill" in line):
            report.append(f"{kernel}: {line.strip()}")
    return report


def source(dtype) -> str:
    return fa.FWD_BF16 if dtype == torch.bfloat16 else fa.FWD_F32


def inputs(dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    out = {}
    for bh, causal in SHAPES[dtype]:
        if bh not in out:
            out[bh] = tuple(torch.randn(bh, T, D, device="cuda",
                                        generator=gen).to(dtype)
                            for _ in range(3))
    return out


def errors(mod, qkv, causal) -> dict:
    """out's error relative to max |ref| (bf16) or absolute (f32), and
    lse's."""
    got, got_lse = mod.flash_attention_fwd(*qkv, causal)
    ref, ref_lse = fa.flash_attention_fwd_reference(*qkv, causal)
    err = (got.float() - ref.float()).abs().max().item()
    key = "out_abs_err" if got.dtype == torch.float32 else "out_rel_err"
    if key == "out_rel_err":
        err /= ref.float().abs().max().item()
    return {key: err, "lse_err": (got_lse - ref_lse).abs().max().item(),
            "finite": bool(torch.isfinite(got).all())}


def check(path: str, dtype) -> int:
    """One build against the plain version at every shape, in this
    process; exits non-zero on a fault or an error above chip_smoke's
    tolerances."""
    harness.use(source(dtype), path)
    data = inputs(dtype)
    ok = True
    for bh, causal in SHAPES[dtype]:
        err = errors(fa, data[bh], causal)
        out_ok = err["out_rel_err"] <= smoke.TOL_BF16_REL \
            if dtype == torch.bfloat16 else err["out_abs_err"] <= smoke.TOL_F32
        ok &= err["finite"] and out_ok and err["lse_err"] <= smoke.TOL_LSE
        print(json.dumps({"check": path, "bh": bh, "causal": causal, **err}),
              flush=True)
    return 0 if ok else 1


def flops(bh: int, causal: bool) -> float:
    return 4.0 * bh * (T * (T + 1) / 2 if causal else T * T) * D


def by_pass(fn, iters: int = 10) -> dict:
    """Kernel time per call of ``fn``, split pass apart, from one whole
    profiler window."""
    out = {"split": 0.0, "fwd": 0.0}
    for name, (_, us) in smoke.device_windows(fn, iters, runs=1)[0].items():
        out["split" if "split" in name else "fwd"] += us / 1e3 / iters
    return out


def measure(label: str, mod, path, data: dict, dtype) -> None:
    """Time ``mod``'s forward (this checkout's wrapper on the build at
    ``path``, or a parent's wrapper on its own build: ``path`` None)."""
    if path is not None:
        harness.use(source(dtype), path)
    size = torch.finfo(dtype).bits // 8
    for bh, causal in SHAPES[dtype]:
        q, k, v = data[bh]

        def kernel():
            return mod.flash_attention_fwd(q, k, v, causal)

        row = {"build": label, "design": mod.fwd_design(dtype, D), "bh": bh,
               "t": T, "d": D, "causal": causal,
               **errors(mod, (q, k, v), causal),
               **harness.timing(kernel, flops(bh, causal)),
               "bound_ms": smoke.attention_bound(bh, T, T, D, size,
                                                 causal)[0]}
        if dtype == torch.float32:
            row["fma_bound_ms"] = smoke.attention_bound(bh, T, T, D, 4,
                                                        causal, fma=True)[0]
            row["device_ms_by_pass"] = by_pass(kernel)
        print(json.dumps(row), flush=True)


def main(argv) -> int:
    dtype = torch.bfloat16
    if "--f32" in argv:
        dtype, argv = torch.float32, [a for a in argv if a != "--f32"]
    if argv[:1] == ["--check"]:
        return check(argv[1], dtype)
    if not torch.cuda.is_available():
        print("torch_fwd_parts: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parent, argv = harness.take_parent(list(argv))
    builds = ["default"] + list(argv)
    built = harness.build_variants(source(dtype), builds, ("-Xptxas", "-v"))
    for label, (_, log) in zip(builds, built):
        print(json.dumps({"build": label, "ptxas": ptxas_report(log)}),
              flush=True)
    # each build checked in a process of its own, all at once, so that a
    # build that faults leaves the others to be timed
    flag = ["--f32"] if dtype == torch.float32 else []
    checks = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                *flag, "--check", path])
              for path, _ in built]
    passed = []
    for label, (path, _), proc in zip(builds, built, checks):
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        print(json.dumps({"build": label, "check_rc": rc}), flush=True)
        if rc == 0:
            passed.append((label, fa, path))
    if parent:
        passed.append(("parent", harness.parent_ops(
            parent, "flash_attention")[0], None))
    data = inputs(dtype)
    for i in harness.in_turns(len(passed)):
        measure(*passed[i], data, dtype)
    for bh, causal in SHAPES[dtype]:
        q4, k4, v4 = (x.view(bh // H, H, T, D) for x in data[bh])

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)

        print(json.dumps({
            "build": "scaled_dot_product_attention", "bh": bh, "t": T,
            "d": D, "causal": causal,
            **harness.timing(library, flops(bh, causal))}), flush=True)
    print(harness.card(), flush=True)
    return 0 if len(passed) == len(builds) + bool(parent) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
