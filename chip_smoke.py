#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``analytics_zoo_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all at once), then runs four phases, each printing one
JSON line:

1. ``kernel``: ``flash_attention_fwd``'s kernels (bf16 on the tensor
   cores, f32 scalar, and the f32 source's wide kernel for head dims
   257-1024 in both dtypes) and ``flash_attention_bwd``'s kernel (f32 and
   bf16) against their plain PyTorch versions on the card: f32/bf16,
   causal/not, ragged T, Tq != Tk, head dims from 1 to 1024, BH 70000, and
   every shape the BERT-base serving and training paths give them; then
   their times at those shapes (forward: bf16 at BH 12, 48, 192, 768, f32
   at BH 192; backward: both dtypes at the training shape, BH 384) beside
   the bound, the plain version's time and PyTorch's
   ``F.scaled_dot_product_attention`` (forward, and its backward alone: a
   yardstick only, the port never calls it), each as CUDA-event time per
   call (``ms``) and as the card's kernel time from ``torch.profiler``
   (``device_ms``).
2. ``bert_serve``: BERT-base (``BERTClassifier``, width 768, 12 layers, 12
   heads, seq 512, ``use_flash=True``) with random weights made from a seed
   in the JAX tree layout, served through ``InferenceModel`` in bf16:
   ``warm`` then ``predict``.  The bf16 kernel's launch count over that run
   must be 12 per forward (and the f32 kernel's 0), and the logits must
   match the same model served in f32 with the plain attention; the model
   served in f32 with flash must launch the f32 kernel 12 times per
   forward and match too.
3. ``bert_train``: BERT-base ``BERTSQuAD`` fine-tuned through
   ``Estimator.from_keras(loss=squad_span_loss, optimizer="adamw",
   learning_rate=1e-4)`` from the same kind of random weights.  (a) f32,
   dropout 0, batch 8: every parameter's gradient with flash attention (f32
   forward and backward kernels) against the dense attention, and the
   per-step losses of a 3-step ``fit`` (3 distinct batches) likewise.
   (b) bf16, dropout 0.1, global batch 32, 64 fixed examples, 10 epochs
   (20 steps): the loss must fall, every step must launch the bf16 forward
   and the backward 12 times each and no f32 kernel, and a second fit with
   the same seed must repeat the loss history; step time, tokens/s, model
   TFLOP/s and one profiled step's idle share; then ``evaluate`` and
   ``predict`` on the card.
4. ``devices``: the card as ``nvidia-smi`` reports it.

Then a ``kernels`` line (one entry per kernel and path) and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no last line; it also exits non-zero when there is no
CUDA card.
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
BWD_KERNEL = "flash_attention_bwd"
BUCKETS = (1, 4, 16, 64)  # InferenceModel's default batch buckets
TIMED_SHAPE = dict(b=16, h=12, t=SEQ, d=64)  # the bucket-16 BERT-base call
TRAIN_SHAPE = dict(b=32, h=12, t=SEQ, d=64)  # a global-batch-32 train step
# head dims the JAX kernel takes that are not BERT's (it pads any D)
HEAD_DIMS = (1, 5, 8, 24, 48, 80, 96, 112, 256)
WIDE_HEAD_DIMS = (320, 1024)  # above the tensor-core kernel's 256
# the bert_train recipe (bench.py's BERT-base SQuAD: seq 512, global batch
# 32, adamw at 1e-4)
TRAIN_LR = 1e-4
TRAIN_BATCH = 32
TRAIN_EXAMPLES = 64
TRAIN_EPOCHS = 10
CHECK_BATCH = 8   # the f32 flash-vs-dense check
CHECK_STEPS = 3
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
# backward, dq/dk/dv each: f32 the same math in another summation order,
# relative to max(1, max |ref|); bf16 relative to max |ref|: both sides
# round their f32 result to bf16 once, so a sound pair already differs by
# one bf16 ulp, up to 2^-7 (0.78%) of max |ref|, wherever the two f32 sums
# straddle a rounding boundary; the tensor-core path also rounds P and dS
# to bf16 before their products (2^-9 per term, averaging out over the
# sums), which can make that two ulps.  2%, the forward's limit, leaves
# room for those two; a fault (a tile missed, a wrong mask or scale) moves
# a gradient by far more
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 2e-2
# bert_train (a), f32 flash vs f32 dense on the card: each parameter's
# gradient relative to that tensor's max |grad|, and the losses of 3
# steps relative to max(1, |dense loss|) (Adam's first step moves every
# weight by the learning rate, so a loss can come near 0; the steps take
# distinct batches, since one repeated batch is learned by heart in one
# step); the few tensors whose gradient is zero in
# exact arithmetic (the span softmax is invariant to a shift shared by
# every position: span_head.bias and the last block's ffn2.bias) are held
# to GRAD_NOISE of the largest gradient instead
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_LOSS = 1e-4
GRAD_NOISE = 1e-5
# bert_train (b): the last epoch's mean loss at most this share of the
# first epoch's
LOSS_FALL = 0.9


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


def bound(flops: float, nbytes: float, itemsize: int) -> tuple:
    """(ms, "bytes"|"operations"): the larger of the operations at the
    dtype's peak rate and the bytes at the memory rate."""
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_bound(bh: int, t: int, d: int, itemsize: int) -> tuple:
    """The backward's least time (not causal): 10 * BH * T^2 * D FLOP (the
    FA2 backward's five products), q, k, v, out, dout read once and dq,
    dk, dv written once."""
    return bound(10.0 * bh * t * t * d, 8.0 * bh * t * d * itemsize,
                 itemsize)


def attention_bound(bh: int, tq: int, tk: int, d: int, itemsize: int,
                    causal: bool) -> tuple:
    """(ms, "bytes"|"operations"): the least time for the forward's work:
    q, k, v read once, out and lse written once; 4*tq*tk*d FLOP per head
    (the causal half when masked), at the dtype's peak rate."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4.0 * bh * pairs * d
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d) * itemsize + bh * tq * 4
    return bound(flops, nbytes, itemsize)


def phase_kernel(fa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"f32_out": 0.0, "lse": 0.0, "bf16_out_rel": 0.0,
             "bwd_f32_rel": 0.0, "bwd_bf16_rel": 0.0}
    # each bf16 backward check: [bh, tq, tk, d, causal, the worst of dq,
    # dk, dv relative to max |ref|]
    bwd_bf16_rel = []

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
    # head dims above 256: the f32 source's wide kernel, both dtypes
    cases += [(2, 77, 130, d, dt, c) for d in WIDE_HEAD_DIMS for dt in dtypes
              for c in (False, True)]
    cases += [(70000, 8, 8, 16, dt, c) for dt in dtypes
              for c in (False, True)]
    # grids large enough for the bf16 kernel's 128-row tiles (d <= 64)
    cases += [(96, tq, tk, d, torch.bfloat16, c)
              for tq, tk in ((1000, 700), (700, 1000)) for d in (24, 40, 64)
              for c in (False, True)]
    # the shapes the main path gives it: BH = 12 heads x each batch bucket
    b, h, t, d = (TIMED_SHAPE[x] for x in "bhtd")
    cases += [(h * n, t, t, d, dt, False) for n in BUCKETS for dt in dtypes]
    # and the shape every training step gives it (both bert_train runs'
    # dtypes; (a) runs f32 at batch CHECK_BATCH, checked end to end there)
    tb, th, tt, td = (TRAIN_SHAPE[x] for x in "bhtd")
    cases += [(tb * th, tt, tt, td, dt, False) for dt in dtypes]
    for case in cases:
        check(*case)

    def check_bwd(bh, tq, tk, d, dtype, causal):
        """The backward kernel vs its plain version on fresh inputs (the
        forward kernel's out and lse for both): dq, dk, dv each held to
        the tolerance; returns the inputs and the worst abs error."""
        q, k, v = qkv(bh, tq, tk, d, dtype)
        g = torch.randn(bh, tq, d, device="cuda", generator=gen).to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal)
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        err_abs = case_rel = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if a.shape != b.shape or a.dtype != dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"backward gave {name} "
                                     f"{tuple(a.shape)} {a.dtype} at bh={bh}"
                                     f" tq={tq} tk={tk} d={d}")
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            if dtype == torch.float32:
                rel, tol, key = err / max(1.0, top), TOL_BWD_F32, \
                    "bwd_f32_rel"
            else:
                rel, tol, key = err / max(top, 1e-30), TOL_BWD_BF16, \
                    "bwd_bf16_rel"
            worst[key] = max(worst[key], rel)
            case_rel = max(case_rel, rel)
            err_abs = max(err_abs, err)
            if rel > tol:
                raise AssertionError(
                    f"backward kernel disagrees with its plain version at "
                    f"bh={bh} tq={tq} tk={tk} d={d} {dtype} causal={causal}"
                    f": {name} err {err} of {top}")
        if dtype == torch.bfloat16:
            bwd_bf16_rel.append([bh, tq, tk, d, causal, case_rel])
        return q, k, v, out, g, err_abs

    bwd_cases = [(3, tq, tq, d, dt, c) for tq in (100, 512)
                 for d in (16, 64, 128) for dt in dtypes for c in (False, True)]
    bwd_cases += [(3, tq, tk, 64, dt, c) for tq, tk in ((100, 300), (300, 100))
                  for dt in dtypes for c in (False, True)]
    bwd_cases += [(2, 77, 130, d, dt, c) for d in HEAD_DIMS + WIDE_HEAD_DIMS
                  for dt in dtypes for c in (False, True)]
    bwd_cases += [(tb * th, tt, tt, td, dt, False) for dt in dtypes]
    for case in bwd_cases:
        check_bwd(*case)

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
            "kernel": fa.fwd_kernel(dtype, d)[0], "bh": bh, "t": t, "d": d,
            "dtype": str(dtype).replace("torch.", ""), "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 4.0 * bh * t * t * d / dev_ms / 1e9})

    # the backward at the training shape, both dtypes, checked again on the
    # inputs it is timed on; the yardstick is SDPA's backward alone
    bwd_timings = []
    for dtype in dtypes:
        bh = tb * th
        q, k, v, out, g, err = check_bwd(bh, tt, tt, td, dtype, False)
        lse = fa.flash_attention_fwd(q, k, v, False)[1]
        q4, k4, v4 = (x.view(tb, th, tt, td).detach().requires_grad_()
                      for x in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        g4 = g.view(tb, th, tt, td)

        def kernel():
            return fa.flash_attention_bwd(q, k, v, out, lse, g, False)

        def plain():
            return fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                    False)

        def library():
            return torch.autograd.grad(out4, (q4, k4, v4), g4,
                                       retain_graph=True)

        ms, plain_ms, library_ms = (cuda_ms(f, iters=10)
                                    for f in (kernel, plain, library))
        dev_ms, plain_dev_ms, library_dev_ms = (
            device_ms(f, iters=10) for f in (kernel, plain, library))
        bound_ms, bound_by = bwd_bound(bh, tt, td, q.element_size())
        bwd_timings.append({
            "kernel": BWD_KERNEL, "bh": bh, "t": tt, "d": td,
            "dtype": str(dtype).replace("torch.", ""), "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 10.0 * bh * tt * tt * td / dev_ms / 1e9})
        del q4, k4, v4, out4
    res = {"phase": "kernel", "cases": len(cases),
           "bwd_cases": len(bwd_cases), "worst": worst,
           "tolerances": {"f32_out_abs": TOL_F32, "lse_abs": TOL_LSE,
                          "bf16_out_rel_to_max": TOL_BF16_REL,
                          "bwd_f32_rel_to_max1": TOL_BWD_F32,
                          "bwd_bf16_rel_to_max": TOL_BWD_BF16},
           "timed_shape": dict(TIMED_SHAPE, causal=False),
           "bwd_bf16_rel_by_case": bwd_bf16_rel,
           "timings": timings, "bwd_timings": bwd_timings}
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


def profile_call(fn, shares: dict) -> dict:
    """One call of ``fn`` (synchronised) under ``torch.profiler``: the
    host's wall time, the card's kernel time (busy) and idle share, the
    share of the kernel time taken by the kernels whose names contain any
    of ``shares[name]`` (as ``<name>_share_of_busy``), and the kernels that
    take the most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's row repeats its kernels' time
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in kernels)
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None}
    for name, keys in shares.items():
        ms = sum(t for k, t in kernels if any(n in k for n in keys))
        res[f"{name}_share_of_busy"] = ms / busy_ms if busy_ms else None
    top = sorted(kernels, key=lambda kv: -kv[1])[:8]
    res["top"] = [[k[:90], ms] for k, ms in top]
    return res


def reset_counts(fa) -> None:
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    for name in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[name] = 0


def read_counts(fa, what: str, **runs: int) -> dict:
    """The launch counts since ``reset_counts``: each kernel named in
    ``runs`` (by source) once per encoder layer of each of its runs, no
    other kernel at all."""
    counts = dict(fa.KERNEL_LAUNCHES)
    want = {name: BERT_BASE["n_layers"] * runs.get(name, 0)
            for name in counts}
    fwd = want[BF16_KERNEL] + want[F32_KERNEL]
    if counts != want or fa.flash_attention_fwd.launches != fwd \
            or fa.flash_attention_bwd.launches != want[BWD_KERNEL]:
        raise AssertionError(f"{what}: kernel launches {counts}; want {want}"
                             f" ({BERT_BASE['n_layers']} layers)")
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
    launches = read_counts(fa, "bert_serve bf16",
                           **{BF16_KERNEL: forwards})

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
    breakdown = {str(b): profile_call(
        lambda: im.predict(batches[64][:b]), {"flash": ("flash_fwd_",)})
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
    f32_launches = read_counts(fa, "bert_serve f32",
                               **{F32_KERNEL: f32_forwards})
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


def squad_examples(rng: np.random.Generator, n: int) -> tuple:
    """n SQuAD-shaped examples at SEQ: random token ids and a random answer
    span (start < end) each, labels int [n, 2].  Nothing in the input marks
    the span, so the model can only learn the examples by heart: the loss
    falls over epochs, not in one step."""
    ids = rng.integers(0, BERT_BASE["vocab_size"], (n, SEQ)).astype(np.int32)
    start = rng.integers(0, SEQ - 64, n)
    end = start + rng.integers(1, 64, n)
    return ids, np.stack([start, end], axis=1).astype(np.int32)


def record_steps(est) -> tuple:
    """Make ``est``'s train step synchronise before and after itself and
    record its loss and its time; returns the (losses, ms) lists it
    fills."""
    losses, times = [], []
    inner = est._train_step

    def step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        return loss

    est._train_step = step
    return losses, times


def phase_bert_train(fa) -> dict:
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.models import BERTSQuAD, squad_span_loss
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    t0 = time.perf_counter()
    state = from_jax_variables(random_bert_variables(
        BERTSQuAD(use_flash=True, **BERT_BASE), SEED))
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 2)

    def model(use_flash, **kw):
        m = BERTSQuAD(use_flash=use_flash, **dict(BERT_BASE, **kw))
        m.load_state_dict(state, strict=True)
        return m.cuda()

    # (a) f32, dropout 0: flash (f32 forward + backward kernels) vs dense
    x8, y8 = squad_examples(rng, CHECK_BATCH)
    xt, yt = torch.from_numpy(x8).cuda(), torch.from_numpy(y8).cuda()
    grads = {}
    for use_flash in (True, False):
        m = model(use_flash).train()
        names = [n for n, _ in m.named_parameters()]
        loss = squad_span_loss(m(xt), yt)
        grads[use_flash] = dict(zip(names, torch.autograd.grad(
            loss, list(m.parameters()))))
        del m, loss
    g_max = max(g.abs().max().item() for g in grads[False].values())
    worst_rel, shift_invariant = 0.0, []
    for name, ref in grads[False].items():
        err = (grads[True][name] - ref).abs().max().item()
        top = ref.abs().max().item()
        if top < GRAD_NOISE * g_max:  # zero in exact arithmetic
            shift_invariant.append(name)
            if err > GRAD_NOISE * g_max:
                raise AssertionError(f"bert_train f32: {name}'s gradient "
                                     f"differs by {err} > {GRAD_NOISE} of "
                                     f"the largest, {g_max}")
            continue
        worst_rel = max(worst_rel, err / top)
        if err > TOL_TRAIN_GRAD * top:
            raise AssertionError(f"bert_train f32: {name}'s gradient differs "
                                 f"by {err} of max {top} (flash vs dense)")
    want_noise = sorted(["span_head.bias", f"bert.layer_"
                         f"{BERT_BASE['n_layers'] - 1}.ffn2.bias"])
    if sorted(shift_invariant) != want_noise:
        raise AssertionError(f"bert_train f32: gradients at noise level in "
                             f"{shift_invariant}, want {want_noise}")
    del grads
    # 3 steps, each on a batch the model has not seen (one repeated batch
    # is learned by heart in a single step)
    x3, y3 = squad_examples(rng, CHECK_BATCH * CHECK_STEPS)
    hist = {}
    for use_flash in (True, False):
        est = Estimator.from_keras(model(use_flash), loss=squad_span_loss,
                                   optimizer="adamw", learning_rate=TRAIN_LR,
                                   seed=SEED)
        hist[use_flash], _ = record_steps(est)
        reset_counts(fa)
        est.fit((x3, y3), epochs=1, batch_size=CHECK_BATCH, verbose=False)
        if use_flash:
            f32_launches = read_counts(fa, "bert_train f32", **{
                F32_KERNEL: CHECK_STEPS, BWD_KERNEL: CHECK_STEPS})
        del est
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(hist[True], hist[False]))
    if loss_err > TOL_TRAIN_LOSS or not all(map(math.isfinite, hist[True])):
        raise AssertionError(f"bert_train f32: loss history {hist[True]} "
                             f"(flash) vs {hist[False]} (dense)")
    f32_check = {"batch": CHECK_BATCH, "steps": CHECK_STEPS,
                 "grad_worst_rel_to_tensor_max":
                 worst_rel, "grad_tol": TOL_TRAIN_GRAD,
                 "shift_invariant_grads": shift_invariant,
                 "largest_grad": g_max, "loss_flash": hist[True],
                 "loss_dense": hist[False], "loss_worst_rel": loss_err,
                 "loss_tol": TOL_TRAIN_LOSS, "launches": f32_launches}

    # (b) the bf16 run: dropout 0.1, global batch 32, 20 steps
    x, y = squad_examples(rng, TRAIN_EXAMPLES)
    est = Estimator.from_keras(model(True, dropout=0.1, dtype=torch.bfloat16),
                               loss=squad_span_loss, optimizer="adamw",
                               learning_rate=TRAIN_LR, seed=SEED)
    inner = est._train_step
    step_losses, step_ms = record_steps(est)
    steps = TRAIN_EPOCHS * (TRAIN_EXAMPLES // TRAIN_BATCH)
    reset_counts(fa)
    t0 = time.perf_counter()
    losses = est.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                     verbose=False)["loss"]
    fit_s = time.perf_counter() - t0
    launches = read_counts(fa, "bert_train bf16",
                           **{BF16_KERNEL: steps, BWD_KERNEL: steps})
    if not all(map(math.isfinite, losses)) \
            or losses[-1] > LOSS_FALL * losses[0]:
        raise AssertionError(f"bert_train bf16: loss {losses} did not fall "
                             f"to {LOSS_FALL} of its first epoch")
    last = step_ms[-10:]
    p50 = float(np.median(last))
    tokens_per_s = TRAIN_BATCH * SEQ / (p50 / 1e3)
    batch = next(as_feed((x, y), TRAIN_BATCH, seed=SEED).epoch(
        est.device, 0))
    profiled = profile_call(lambda: inner(batch), {
        "flash_fwd": ("flash_fwd_",),
        "flash_bwd": ("bwd_dkdv", "bwd_dq", "bwd_delta")})

    x_eval, y_eval = squad_examples(rng, 6)
    x_eval, y_eval = np.concatenate([x, x_eval]), np.concatenate([y, y_eval])
    evaluated = est.evaluate((x_eval, y_eval), batch_size=TRAIN_BATCH)
    pred = est.predict(x_eval, batch_size=TRAIN_BATCH)
    if pred.shape != (len(x_eval), SEQ, 2) or not np.isfinite(pred).all() \
            or not math.isfinite(evaluated["loss"]):
        raise AssertionError(f"bert_train: predict gave {pred.shape}, "
                             f"evaluate {evaluated}")
    hits = float(np.mean(pred.argmax(axis=1) == y_eval))
    del est

    # one seed, one loss history: the same fit again from the same weights
    again = Estimator.from_keras(
        model(True, dropout=0.1, dtype=torch.bfloat16), loss=squad_span_loss,
        optimizer="adamw", learning_rate=TRAIN_LR, seed=SEED)
    repeat_losses, _ = record_steps(again)
    again.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
              verbose=False)
    del again
    if repeat_losses != step_losses:
        raise AssertionError(f"bert_train bf16: a second fit with seed "
                             f"{SEED} gave step losses {repeat_losses}, the "
                             f"first {step_losses}")
    res = {"phase": "bert_train", "config": dict(BERT_BASE, dropout=0.1),
           "seq": SEQ, "dtype": "bfloat16", "optimizer": "adamw",
           "learning_rate": TRAIN_LR, "global_batch": TRAIN_BATCH,
           "examples": TRAIN_EXAMPLES, "epochs": TRAIN_EPOCHS, "steps": steps,
           "setup_s": setup_s, "fit_s": fit_s, "loss": losses,
           "step_losses": step_losses,
           "loss_fall_limit": LOSS_FALL, "launches": launches,
           "step_ms_last10": last, "step_ms_p50": p50,
           "tokens_per_s": tokens_per_s,
           "model_tflop_per_s": tokens_per_s * 3 * bert_flops_per_token()
           / 1e12,
           "flop_convention": "3 x forward FLOP of bert_flops_per_token "
                              "(encoder GEMMs + attention products; "
                              "embeddings, span head, LayerNorm, softmax "
                              "and optimizer not counted)",
           "profiled_step": profiled,
           "evaluate": evaluated, "predict_rows": int(pred.shape[0]),
           "span_hit_rate": hits, "repeat_fit_identical": True,
           "f32_check": f32_check}
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
        list(pool.map(_build.build, (BF16_KERNEL, F32_KERNEL, BWD_KERNEL)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    kern = phase_kernel(fa)
    serve = phase_bert_serve(fa)
    train = phase_bert_train(fa)
    smi = phase_devices()
    print(smi, flush=True)
    timed = {x["kernel"]: x for x in kern["timings"]
             if x["bh"] == TIMED_SHAPE["b"] * TIMED_SHAPE["h"]}
    timed.update({(BWD_KERNEL, x["dtype"]): x for x in kern["bwd_timings"]})
    fwd_src = "analytics_zoo_tpu/ops/flash_attention.py:44"
    bwd_src = "analytics_zoo_tpu/ops/flash_attention.py:187"
    entries = []
    for name, key, design, launches, path, replaces in (
            (BF16_KERNEL, BF16_KERNEL,
             "bf16, mma.sync tensor cores, cp.async ring",
             serve["flash_launches"][BF16_KERNEL], "bert_serve bf16",
             fwd_src),
            (F32_KERNEL, F32_KERNEL, "f32, scalar FMAs (exact)",
             serve["f32_flash_launches"][F32_KERNEL], "bert_serve f32",
             fwd_src),
            (BWD_KERNEL, (BWD_KERNEL, "bfloat16"),
             "bf16, mma.sync tensor cores (d <= 64), cp.async ring; "
             "delta, dK/dV and dQ passes",
             train["launches"][BWD_KERNEL], "bert_train bf16", bwd_src),
            (BWD_KERNEL, (BWD_KERNEL, "float32"),
             "f32, scalar FMAs; delta, dK/dV and dQ passes",
             train["f32_check"]["launches"][BWD_KERNEL], "bert_train f32",
             bwd_src)):
        x = timed[key]
        entries.append({
            "name": name, "design": design, "route": "cuda",
            "source": f"analytics_zoo_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "library_ms": x["library_ms"],
            "device_ms": x["device_ms"],
            "plain_device_ms": x["plain_device_ms"],
            "library_device_ms": x["library_device_ms"],
            "shape": {k: x[k] for k in ("bh", "t", "d", "dtype")}})
    entries[0]["launches_bert_train_bf16"] = train["launches"][BF16_KERNEL]
    entries[1]["launches_bert_train_f32"] = \
        train["f32_check"]["launches"][F32_KERNEL]
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
