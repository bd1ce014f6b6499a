#!/usr/bin/env python3
"""Does this torch build have a CUDA kernel for ``aten::bmm.dtype``
(``torch.bmm(a, b, out_dtype=torch.float32)`` on bf16 operands), and an
autograd formula for it?

Run from the root of a checkout on a machine with a CUDA card:

    python3 dev/torch_bmm_dtype_probe.py

At the dense attention core's logits shape in bench.py's MLM recipe (4
sequences x 12 heads = 48 products of [512, 64] x [64, 512]) it prints
one JSON line each for:
- ``forward``: whether the call runs, the output dtype, and its largest
  difference from ``torch.bmm(a.float(), b.float())`` (TF32 off) relative
  to the latter's max (bf16 x bf16 products are exact in f32, so only the
  summation order differs);
- ``autograd``: whether a backward through it runs, and the error text
  if it does not;
- ``graph``: whether the call can be captured in a CUDA graph and
  replayed with the same result;
- ``timing``: CUDA-event ms per call of the bf16 -> f32 product, of the
  upcast product with its two f32 copies (the port's path before), and of
  the plain bf16 product, with the card's kernel names for each.
Then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

SHAPE = (48, 512, 64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_names(fn) -> list:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key[:120] for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"torch": torch.__version__, "cuda": torch.version.cuda})
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, t, d = SHAPE
    a = torch.randn(bh, t, d, device="cuda", generator=gen).bfloat16()
    b = torch.randn(bh, d, t, device="cuda", generator=gen).bfloat16()
    ref = torch.bmm(a.float(), b.float())
    ok = True
    try:
        out = torch.bmm(a, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max() / ref.abs().max())
        emit({"forward": "runs", "dtype": str(out.dtype),
              "max_rel_err_vs_upcast": err})
    except Exception as e:  # the probe's question: report, go on
        ok = False
        emit({"forward": "fails", "error": f"{type(e).__name__}: {e}"[:600]})
    if ok:
        a2 = a.clone().requires_grad_(True)
        try:
            o = torch.bmm(a2, b, out_dtype=torch.float32)
            o.sum().backward()
            torch.cuda.synchronize()
            emit({"autograd": "runs", "grad_dtype": str(a2.grad.dtype)})
        except Exception as e:
            emit({"autograd": "fails",
                  "error": f"{type(e).__name__}: {e}"[:600]})
        try:
            static = torch.empty_like(ref)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                torch.bmm(a, b, out_dtype=torch.float32)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                static.copy_(torch.bmm(a, b, out_dtype=torch.float32))
            g.replay()
            torch.cuda.synchronize()
            emit({"graph": "captures",
                  "replay_equal": bool(torch.equal(static, out))})
        except Exception as e:
            emit({"graph": "fails",
                  "error": f"{type(e).__name__}: {e}"[:600]})
    cases = {"upcast_f32": lambda: torch.bmm(a.float(), b.float()),
             "bf16_out": lambda: torch.bmm(a, b)}
    if ok:
        cases["bf16_to_f32"] = lambda: torch.bmm(a, b,
                                                 out_dtype=torch.float32)
    for name, fn in cases.items():
        emit({"timing": name, "shape": SHAPE, "ms": event_ms(fn),
              "kernels": kernel_names(fn)})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
