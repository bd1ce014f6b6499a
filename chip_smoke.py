#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``analytics_zoo_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, then
runs three phases, each printing one JSON line:

1. ``kernel``: ``flash_attention_fwd``'s two kernels (bf16 on the tensor
   cores, f32 scalar) against their plain PyTorch version on the card:
   f32/bf16, causal/not, ragged T, Tq != Tk, head dims from 1 to 256, BH
   70000, and every shape the BERT-base serving path gives them in both
   dtypes, out and lse each; then their times at those shapes (bf16 at BH
   12, 48, 192, 768; f32 at BH 192) beside the bound, the plain version's
   time and ``F.scaled_dot_product_attention``'s (a yardstick only: the
   port never calls it), each as CUDA-event time per call (``ms``) and as
   the card's kernel time from ``torch.profiler`` (``device_ms``).
2. ``bert_serve``: BERT-base (``BERTClassifier``, width 768, 12 layers, 12
   heads, seq 512, ``use_flash=True``) with random weights made from a seed
   in the JAX tree layout, served through ``InferenceModel`` in bf16:
   ``warm`` then ``predict``.  The bf16 kernel's launch count over that run
   must be 12 per forward (and the f32 kernel's 0), and the logits must
   match the same model served in f32 with the plain attention; the model
   served in f32 with flash must launch the f32 kernel 12 times per
   forward and match too.
3. ``devices``: the card as ``nvidia-smi`` reports it.

Then a ``kernels`` line (one entry per kernel) and, last, ``{"ok": true, "device": {...}}``.  Any
failure raises, so the script exits non-zero and prints no last line; it
also exits non-zero when there is no CUDA card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
BERT_BASE = dict(vocab_size=30522, hidden_size=768, n_layers=12, n_heads=12,
                 intermediate_mult=4, max_position=512, dropout=0.0)
SEQ = 512
BF16_KERNEL = "flash_attention_fwd"      # csrc/<name>.cu
F32_KERNEL = "flash_attention_fwd_f32"
BUCKETS = (1, 4, 16, 64)  # InferenceModel's default batch buckets
TIMED_SHAPE = dict(b=16, h=12, t=SEQ, d=64)  # the bucket-16 BERT-base call
# head dims the JAX kernel takes that are not BERT's (it pads any D)
HEAD_DIMS = (1, 5, 8, 24, 48, 80, 96, 112, 256)
LATENCY_CALLS = 50  # host-timed predict calls per bucket
# f32: same arithmetic in another summation order; bf16 out: one rounding
# of each output to bf16 on both sides, and in the kernel P rounded to bf16
# before P @ V (relative error 2^-9 per weight, averaging out over the
# keys), so a few bf16 ulps of max |out|
TOL_F32 = 2e-5
TOL_LSE = 5e-5
TOL_BF16_REL = 2e-2
# BERT logits, relative to max(1, max |ref|): f32 flash vs f32 dense differ
# only in summation order; bf16 vs f32 carries bf16 rounding through 12
# layers (about 1-2% on a 12-layer width-256 model on the CPU)
TOL_SERVE_F32 = 1e-4
TOL_SERVE_BF16 = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def device_ms(fn, iters: int = 20, runs: int = 3) -> float:
    """The card's kernel time per call of ``fn``: the device-side kernel
    events of ``iters`` calls under ``torch.profiler``, summed and divided
    by ``iters``; the median of ``runs`` such windows.  Unlike ``cuda_ms``
    it leaves out the gaps where the card waits for the host to launch,
    which decide ``cuda_ms`` for a kernel shorter than its launch."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times.append(sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters)
    return sorted(times)[len(times) // 2]


def attention_bound(bh: int, tq: int, tk: int, d: int, itemsize: int,
                    causal: bool) -> tuple:
    """(ms, "bytes"|"operations"): the least time for the forward's work:
    q, k, v read once, out and lse written once; 4*tq*tk*d FLOP per head
    (the causal half when masked), at the dtype's peak rate."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4.0 * bh * pairs * d
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d) * itemsize + bh * tq * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel(fa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"f32_out": 0.0, "lse": 0.0, "bf16_out_rel": 0.0}

    def qkv(bh, tq, tk, d, dtype):
        def r(t):
            return torch.randn(bh, t, d, device="cuda", generator=gen
                               ).to(dtype)
        return r(tq), r(tk), r(tk)

    def check(bh, tq, tk, d, dtype, causal):
        """The kernel vs its plain version on fresh inputs: out and lse
        both held to the tolerances; returns (q, k, v, out abs err)."""
        q, k, v = qkv(bh, tq, tk, d, dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != dtype:
            raise AssertionError(f"kernel gave {tuple(out.shape)} "
                                 f"{out.dtype} at bh={bh} tq={tq} d={d}")
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if dtype == torch.float32:
            worst["f32_out"] = max(worst["f32_out"], err)
            ok = err <= TOL_F32
        else:
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            worst["bf16_out_rel"] = max(worst["bf16_out_rel"], rel)
            ok = rel <= TOL_BF16_REL
        worst["lse"] = max(worst["lse"], lse_err)
        if not ok or lse_err > TOL_LSE or not torch.isfinite(out).all():
            raise AssertionError(
                f"kernel disagrees with its plain version at bh={bh} "
                f"tq={tq} tk={tk} d={d} {dtype} causal={causal}: out err "
                f"{err}, lse err {lse_err}")
        return q, k, v, err

    dtypes = (torch.float32, torch.bfloat16)
    cases = [(3, tq, tq, d, dt, c)
             for tq in (1, 100, 512, 1000) for d in (16, 64, 128)
             for dt in dtypes for c in (False, True)]
    cases += [(3, 100, 300, 64, torch.float32, c) for c in (False, True)]
    cases += [(3, 300, 100, 64, torch.bfloat16, c) for c in (False, True)]
    # every head dim the JAX kernel takes up to 256 (odd widths, ragged T,
    # Tq != Tk), and BH past the old grid-y limit of 65535
    cases += [(2, 77, 130, d, dt, c) for d in HEAD_DIMS for dt in dtypes
              for c in (False, True)]
    cases += [(2, 300, 300, 256, dt, True) for dt in dtypes]
    cases += [(70000, 8, 8, 16, dt, c) for dt in dtypes
              for c in (False, True)]
    # grids large enough for the bf16 kernel's 128-row tiles (d <= 64)
    cases += [(96, tq, tk, d, torch.bfloat16, c)
              for tq, tk in ((1000, 700), (700, 1000)) for d in (24, 40, 64)
              for c in (False, True)]
    # the shapes the main path gives it: BH = 12 heads x each batch bucket
    b, h, t, d = (TIMED_SHAPE[x] for x in "bhtd")
    cases += [(h * n, t, t, d, dt, False) for n in BUCKETS for dt in dtypes]
    for case in cases:
        check(*case)

    # times at every serving shape (bf16) and at the timed shape in f32;
    # each shape checked again on the inputs it is timed on.  ms, plain_ms
    # and library_ms are CUDA-event times per call, host launch included
    # (cuda_ms); the *device_ms keys are the card's kernel time per call
    # alone (device_ms), which differ where a call is shorter than its
    # launch
    timings = []
    for bh, dtype in [(h * n, torch.bfloat16) for n in BUCKETS] + [
            (b * h, torch.float32)]:
        q, k, v, err = check(bh, t, t, d, dtype, False)
        q4, k4, v4 = (x.view(bh // h, h, t, d) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_fwd(q, k, v, False)

        def plain():
            return fa.flash_attention_fwd_reference(q, k, v, False)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4)

        ms, plain_ms, library_ms = (cuda_ms(f)
                                    for f in (kernel, plain, library))
        dev_ms, plain_dev_ms, library_dev_ms = (
            device_ms(f) for f in (kernel, plain, library))
        bound_ms, bound_by = attention_bound(bh, t, t, d, q.element_size(),
                                             False)
        timings.append({
            "kernel": fa._KERNELS[dtype][0], "bh": bh, "t": t, "d": d,
            "dtype": str(dtype).replace("torch.", ""), "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 4.0 * bh * t * t * d / dev_ms / 1e9})
    res = {"phase": "kernel", "cases": len(cases), "worst": worst,
           "tolerances": {"f32_out_abs": TOL_F32, "lse_abs": TOL_LSE,
                          "bf16_out_rel_to_max": TOL_BF16_REL},
           "timed_shape": dict(TIMED_SHAPE, causal=False),
           "timings": timings}
    emit(res)
    return res


def random_bert_variables(model: torch.nn.Module, seed: int) -> dict:
    """Random weights made with numpy, laid out as the JAX package's
    ``{"params", "state"}`` tree, drawn from the JAX initializers'
    distributions (glorot-uniform kernels, normal(0.05) embeddings, unit
    LayerNorm gains, zero biases)."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    for key, p in model.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(p.shape)
        if leaf in ("kernel", "wq", "wk", "wv", "wo"):
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            arr = rng.uniform(-lim, lim, shape)
        elif leaf in ("embeddings", "pos_embed"):
            arr = rng.normal(0.0, 0.05, shape)
        elif leaf == "gamma":
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": params, "state": {}}


def bert_flops_per_token() -> float:
    """Forward FLOP per token of the BERT encoder at SEQ: the dense
    projections (4 h^2 attention + 8 h^2 FFN per layer, 2 FLOP per MAC) and
    the two attention products (4 * SEQ * h per layer)."""
    h, n = BERT_BASE["hidden_size"], BERT_BASE["n_layers"]
    mult = BERT_BASE["intermediate_mult"]
    return n * (2.0 * (4 + 2 * mult) * h * h + 4.0 * SEQ * h)


def profile_predict(im, x: np.ndarray) -> dict:
    """One ``predict`` under ``torch.profiler``: the host's wall time, the
    card's kernel time (busy) and idle share, the flash kernel's share of
    the kernel time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        im.predict(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's row repeats its kernels' time
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in kernels)
    flash_ms = sum(ms for k, ms in kernels if "flash_fwd_" in k)
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "flash_share_of_busy": flash_ms / busy_ms if busy_ms else None,
            "top": [[k[:90], ms] for k, ms in top]}


def reset_counts(fa) -> None:
    fa.flash_attention_fwd.launches = 0
    for name in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[name] = 0


def read_counts(fa, kernel: str, forwards: int) -> dict:
    """The launch counts since ``reset_counts``: ``kernel`` must have run
    once per encoder layer of every forward, and no other kernel."""
    counts = dict(fa.KERNEL_LAUNCHES)
    want = {name: 0 for name in counts}
    want[kernel] = BERT_BASE["n_layers"] * forwards
    if counts != want or fa.flash_attention_fwd.launches != want[kernel]:
        raise AssertionError(f"kernel launches {counts} over {forwards} "
                             f"forwards of {BERT_BASE['n_layers']} layers; "
                             f"want {want}")
    return counts


def phase_bert_serve(fa) -> dict:
    from analytics_zoo_tpu_torch.models import BERTClassifier
    from analytics_zoo_tpu_torch.serving import InferenceModel

    def served(use_flash, dtype=None):
        model = BERTClassifier(2, use_flash=use_flash, **BERT_BASE)
        return InferenceModel(device="cuda").load(model, variables,
                                                  dtype=dtype)

    t0 = time.perf_counter()
    variables = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED)
    im = served(True, torch.bfloat16)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)
    batches = {n: rng.integers(0, BERT_BASE["vocab_size"], (n, SEQ)
                               ).astype(np.int32) for n in (1, 3, 16, 64, 70)}
    top = im.batch_buckets[-1]

    # the main path: warm, then predict (padding, trimming, the largest
    # bucket and chunking beyond it); the kernels' counts read right after
    reset_counts(fa)
    t0 = time.perf_counter()
    n_warm = im.warm([(SEQ,)], dtype=np.int32)
    warm_s = time.perf_counter() - t0
    outs = {n: im.predict(x) for n, x in batches.items()}
    forwards = n_warm + sum(-(-n // top) for n in batches)
    launches = read_counts(fa, BF16_KERNEL, forwards)

    latency = {}
    for b in im.batch_buckets:
        x = batches[64][:b]
        times = []
        for _ in range(LATENCY_CALLS):
            t0 = time.perf_counter()
            im.predict(x)
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(times))
        latency[str(b)] = {"p50_ms": p50, "min_ms": min(times),
                           "calls": LATENCY_CALLS,
                           "p90_ms": float(np.percentile(times, 90)),
                           "tokens_per_s": b * SEQ / (p50 / 1e3),
                           "model_tflop_per_s":
                               b * SEQ * bert_flops_per_token() / p50 / 1e9}
    breakdown = {str(b): profile_predict(im, batches[64][:b])
                 for b in (1, 64)}
    del im

    errors = {}
    ref_im = served(False)
    refs = {n: ref_im.predict(x) for n, x in batches.items()}
    del ref_im
    # the f32 flash path, its kernel counted over this run alone
    f32_im = served(True)
    reset_counts(fa)
    f32_outs = {n: f32_im.predict(x) for n, x in batches.items()}
    f32_forwards = sum(-(-n // f32_im.batch_buckets[-1]) for n in batches)
    f32_launches = read_counts(fa, F32_KERNEL, f32_forwards)
    del f32_im
    for name, got, tol in (("bf16_flash_vs_f32_dense", outs, TOL_SERVE_BF16),
                           ("f32_flash_vs_f32_dense", f32_outs,
                            TOL_SERVE_F32)):
        worst = 0.0
        for n, ref in refs.items():
            y = got[n]
            if y.shape != (n, 2) or not np.isfinite(y).all():
                raise AssertionError(f"{name}: batch {n} gave shape "
                                     f"{y.shape} or non-finite logits")
            scale = max(1.0, float(np.abs(ref).max()))
            worst = max(worst, float(np.abs(y - ref).max()) / scale)
        if worst > tol:
            raise AssertionError(f"{name}: logits differ by {worst} of "
                                 f"max(1, |ref|) > {tol}")
        errors[name] = {"max_err_rel_to_max": worst, "tol": tol}
    res = {"phase": "bert_serve", "config": BERT_BASE, "seq": SEQ,
           "dtype": "bfloat16", "batches": sorted(batches),
           "forwards": forwards, "flash_launches": launches,
           "f32_forwards": f32_forwards, "f32_flash_launches": f32_launches,
           "setup_s": setup_s, "warm_s": warm_s, "latency": latency,
           "breakdown": breakdown, "errors": errors}
    emit(res)
    return res


def phase_devices() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "devices", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import importlib
    from analytics_zoo_tpu_torch.ops import _build
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc per source, together
        list(pool.map(_build.build, (BF16_KERNEL, F32_KERNEL)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    kern = phase_kernel(fa)
    serve = phase_bert_serve(fa)
    smi = phase_devices()
    print(smi, flush=True)
    timed = {x["kernel"]: x for x in kern["timings"]
             if x["bh"] == TIMED_SHAPE["b"] * TIMED_SHAPE["h"]}
    entries = []
    for name, design, launches, path in (
            (BF16_KERNEL, "bf16, mma.sync tensor cores, cp.async ring",
             serve["flash_launches"][BF16_KERNEL], "bert_serve bf16"),
            (F32_KERNEL, "f32, scalar FMAs (exact)",
             serve["f32_flash_launches"][F32_KERNEL], "bert_serve f32")):
        x = timed[name]
        entries.append({
            "name": name, "design": design, "route": "cuda",
            "source": f"analytics_zoo_tpu_torch/csrc/{name}.cu",
            "replaces": "analytics_zoo_tpu/ops/flash_attention.py:44",
            "path": path, "launches": launches,
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "library_ms": x["library_ms"],
            "device_ms": x["device_ms"],
            "plain_device_ms": x["plain_device_ms"],
            "library_device_ms": x["library_device_ms"],
            "shape": {k: x[k] for k in ("bh", "t", "d", "dtype")}})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
