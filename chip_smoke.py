#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``analytics_zoo_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, all at once), then runs ten phases, each printing one
JSON line:

1. ``kernel``: ``flash_attention_fwd``'s kernels (bf16 on the tensor
   cores: ``wgmma`` fed by TMA for heads 33-64, ``mma.sync`` for the
   others up to 256; f32 on ``wgmma`` in 3xTF32 for heads up to 64,
   scalar up to 256, and the f32 source's wide kernel for head dims above
   256 in both dtypes) and ``flash_attention_bwd``'s kernel
   (f32 and bf16:
   ``wgmma`` fed by TMA for bf16 heads 33-64, ``mma.sync`` up to 32, and
   ``wgmma`` in 3xTF32 for f32 heads up to 64)
   against their plain PyTorch versions on the card: f32/bf16,
   causal/not, ragged T, Tq != Tk, head dims from 1 to 2048, BH 70000, and
   every shape the BERT-base serving and training paths give them; two
   backward calls on one input must give the same bits, in both dtypes;
   then
   their times at those shapes (forward: bf16 at BH 12, 48, 192, 768 and
   the training shape, BH 384, and causal at BH 768, f32 at BH 192 and
   96;
   backward: both dtypes at the training shape, BH 384; the
   wide kernels at D 320 and 1024) beside the bound, the plain version's
   time and PyTorch's ``F.scaled_dot_product_attention`` (forward, and its
   backward alone: a yardstick only, the port never calls it), each as
   CUDA-event time per call (``ms``) and as the card's kernel time from
   ``torch.profiler`` (``device_ms``).  An f32 row's bound is its FLOP in
   3xTF32 on the tensor cores (``bound_ms``) and at the f32 FMAs' rate
   (``fma_bound_ms``).
2. ``fused_bn``: the fused batch-norm kernels (``csrc/fused_bn.cu``, one
   persistent cooperative launch a direction, f32 and bf16, forward and
   backward with non-zero mean/var cotangents)
   against their plain versions at every distinct shape of ResNet-50's 53
   batch norms at batch 128, at C 3, 6, 7, 1000 and 8, with ragged rows, a
   channel whose mean is 1e3 times its std, and a misaligned view; the
   same input twice gives identical bits; then their times at the stem's
   shape, the one 11 of the 53 norms see (25,088 x 256) and the last
   stage's beside the bound, the plain version and
   ``F.batch_norm(training=True)`` on the same channels_last map.
3. ``bert_serve``: BERT-base (``BERTClassifier``, width 768, 12 layers, 12
   heads, seq 512, ``use_flash=True``) with random weights made from a seed
   in the JAX tree layout, served through ``InferenceModel`` in bf16:
   ``warm`` then ``predict``.  The bf16 kernel's launch count over that run
   must be 12 per forward, all of the ``wgmma`` design (and the f32
   kernel's 0), and the logits must
   match the same model served in f32 with the plain attention; the model
   served in f32 with flash must launch the f32 kernel 12 times per
   forward (its ``wgmma_tf32`` design) and match too; one profiled call of
   its largest bucket gives the card's busy time and the flash share.
   ``InferenceModel`` serves from one CUDA graph per batch bucket (the
   flash launches counted from the replays); the same model served
   eagerly gives the graphs' logits (equal bits expected; at worst within
   ``TOL_SERVE_BF16``) and its p50 per bucket beside theirs.
3b. ``int8_serve``: the same BERT-base served in int8 from the graphs,
   weight-only and calibrated on 16 seeded sequences (``warm``, then
   ``predict`` at batches 1, 3, 16, 64, 70): 12 bf16 flash launches a
   forward (all ``wgmma``) and, calibrated, 25 int8 products
   (``torch._int_mm``) a forward; logits against the f32 dense model; p50
   per bucket; the parameters' bytes on the card in f32, bf16 and int8;
   ``_int_mm`` at every calibrated shape bit for bit against a float64
   product, timed beside its bound and the weight-only and bf16 GEMMs;
   ResNet-50 (``norm="batch"``, 7x7 stem) calibrated at batch 16, 224 x
   224: each of its 53 int8 convs bit for bit against float64, the
   logits against its bf16 serving.
3c. ``cluster_serve``: the same bf16 BERT-base from CUDA graphs (warmed
   before the port opens) behind the port's ``ClusterServing``
   (``batch_size=64``, two inference workers): 1, 16 and 64 closed-loop
   TCP clients under the window and the continuous scheduler, at least
   256 requests a level (p50, p99, requests/s, tokens/s, mean batch,
   queue depth); every reply against direct ``predict``, the server's
   books (requests = replies + errors + pending, no error), the C++
   queue, and 12 flash launches per device batch and preparation forward;
   one profiled c = 64 window; the workers waiting on their own replay's
   event and on the whole stream, in turns; the eager model served cold
   (the kernel's first launch on a worker thread); a hot swap to another
   version under 16 clients (no failure, replies flip, the new model
   captures nothing after its warm, peak memory); and the HTTP frontend
   over two replicas under 16 clients while one is killed and restarted
   and the other drained and restarted (no failure).
4. ``bert_train``: BERT-base ``BERTSQuAD`` fine-tuned through
   ``Estimator.from_keras(loss=squad_span_loss, optimizer="adamw",
   learning_rate=1e-4)`` from the same kind of random weights.  (a) f32,
   dropout 0, batch 8: every parameter's gradient with flash attention (f32
   forward and backward kernels) against the dense attention, and the
   per-step losses of a 3-step ``fit`` (3 distinct batches) likewise.
   (b) bf16, dropout 0.1, global batch 32, 64 fixed examples, 10 epochs
   (20 steps): the loss must fall, every step must launch the bf16 forward
   and the backward 12 times each (both on their ``wgmma`` design) and no
   f32 kernel ((a)'s fit the f32 ones: the forward and the backward on
   their ``wgmma_tf32`` designs; one more (a) step is profiled), and a
   second fit with
   the same seed must repeat the loss history; step time, tokens/s, model
   TFLOP/s and one profiled step's idle share; then ``evaluate`` and
   ``predict`` on the card.  (a)-(c) run eagerly (``cuda_graphs=False``).
   (d) the (b) fit from CUDA graphs (the Estimator's default on the card:
   one captured step a batch key, replayed) through ``fit(prefetch=2)``:
   its step losses against (b)'s (equal bits expected, at worst within
   ``TOL_TRAIN_LOSS``), 12 + 12 flash launches a step counted from the
   replays, one capture; a window of 20 steps beside the eager step's,
   tokens/s, model TFLOP/s, a profiled fit's card busy and idle share,
   peak memory; and a step that reads a value back to the host must fail
   its capture and raise, in a process of its own.
5. ``resnet_train``: bench.py's ResNet-50 recipe (space-to-depth stem,
   uint8 224 x 224 images normalised on the card, sgd at 0.1) through the
   ``Estimator`` from random weights in the JAX tree layout.  (a) f32,
   batch 8: the gradients of the model with the fused kernels and of the
   one with the plain batch norm, each against a float64 model, and the
   running statistics and the losses of a 3-step ``fit`` against each
   other.  (b) ``norm="batch"``, bf16, global batch 128, 20 steps over 256
   seeded images: the loss must fall, every step must launch each of the
   two batch-norm kernels (forward, backward) 53 times and no f32 one,
   and two deterministic fits with the same seed must give identical
   step losses; images/s,
   model TFLOP/s and one profiled step's idle share and batch norm's share
   of the card's time; then ``evaluate`` and ``predict`` (the eval batch
   norm).  (c) ``norm="nf"`` (no batch norm, no launch): images/s and idle
   share.  (d) bench.py's ``bench_resnet50`` from CUDA graphs, both
   norms: ``_multi_step(b0, 5)``'s losses against the eager step's under
   cuDNN's deterministic algorithms; the eager window of 20 steps, then
   the captured ``_multi_step(b0, 20)`` after a warm call, three times,
   53 launches of each batch-norm kernel a step (``norm="batch"``) from
   the replays, one capture, a profiled window, peak memory; the streaming
   phase (worker processes forked after the CUDA context, bench.py's
   seeded pool with random flips, ``_multi_step_data`` over 4 chunks of 5
   after one, then 8 chunks on a fresh feed) beside the resident step; a
   probe that the forked workers
   are marked as such and never touch the card.
6. ``fused_xent``: the fused softmax cross-entropy kernels
   (``csrc/fused_xent.cu``: forward, and the dl, dh and dW backward passes;
   bf16 on the tensor cores, both directions on ``wgmma``; f32's forward
   and logits on scalar FMAs, its dh and dW on ``wgmma`` in 3xTF32) against
   their plain versions (loss, lse, dh, dW, db) at the
   recipe's head shape (2,048 tokens, D 768, V 30,522, chunk 512; W f32,
   and bf16 too) and ragged N, D and V, with labels at
   0 and V-1, a row of equal logits and logits scaled 1e2; the same input
   twice gives identical bits; then their times at the recipe's shape
   beside the bound, the plain version and ``F.cross_entropy`` over the
   materialised logits (and its ``autograd.grad``).
7. ``bert_mlm_train``: bench.py's BERT vocab-head recipe (``bench_bert``'s
   encoder: width 768, 12 heads, 12 post-LN layers with
   ``remat_attention=True``, a 30,522-wide head, per-token sparse
   cross-entropy, ``adamw`` at 1e-4, global batch 32 as ``grad_accum=8`` x
   4 x 512 tokens) through ``Estimator.fit`` from random weights in the JAX
   tree layout.  (a) f32, 2 layers at full width: the plain head's and
   the fused head's gradients, and the losses of a 3-step ``grad_accum=2``
   fit, against each other.  (b) bf16 with the plain head and (c) with the
   head through ``fused_softmax_xent`` (a loss callable), 20 steps a fit,
   two fits each in turns (plain, fused, fused, plain): every fit's loss
   must fall, every (c) fit must launch the forward and each backward pass
   8 times a step (both directions on ``wgmma``; (a)'s fused fit 6 times
   in all, the forward on scalar FMAs, the backward on ``wgmma_tf32``) and
   (b) none; step time, tokens/s, model
   TFLOP/s, one
   profiled step's idle share and the head's and loss's share of the card's
   time.  (a)-(c) run eagerly.  (d) the fused recipe from CUDA graphs,
   bench.py's phases: the eager window of 10 steps on the seeded batch
   (its losses) and a warm one (its time), then ``_multi_step(batch, 50)`` once (its first 10 losses against the
   eager ones) and three times timed, 8 launches of each ``fused_xent``
   pass a step from the replays, one capture, a profiled window, peak
   memory; the streaming phase (8 worker threads, ``_multi_step_data``
   over 3 chunks of 10 after one) beside the resident step.
8. ``devices``: the card as ``nvidia-smi`` reports it.

Then a ``kernels`` line (one entry per kernel and path) and, last,
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no last line; it also exits non-zero when there is no
CUDA card.  ``--only kernel,fused_bn,...`` runs the named phases alone and
prints neither of the last two lines.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense tf32 tensor-core rate
# tf32 products per f32 product at about f32's accuracy (3xTF32: big and
# small parts of each operand, the small x small term dropped)
TF32_PASSES = 3
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
BERT_BASE = dict(vocab_size=30522, hidden_size=768, n_layers=12, n_heads=12,
                 intermediate_mult=4, max_position=512, dropout=0.0)
SEQ = 512
BF16_KERNEL = "flash_attention_fwd"      # csrc/<name>.cu
F32_KERNEL = "flash_attention_fwd_f32"
BWD_KERNEL = "flash_attention_bwd"
BN_KERNEL = "fused_bn"
BUCKETS = (1, 4, 16, 64)  # InferenceModel's default batch buckets
TIMED_SHAPE = dict(b=16, h=12, t=SEQ, d=64)  # the bucket-16 BERT-base call
TRAIN_SHAPE = dict(b=32, h=12, t=SEQ, d=64)  # a global-batch-32 train step
# head dims the JAX kernel takes that are not BERT's (it pads any D)
HEAD_DIMS = (1, 5, 8, 24, 48, 80, 96, 112, 256)
# above the tensor-core kernel's 256: the wide kernels, to 2048 (they take
# any D); the timed ones are 320 and 1024
WIDE_HEAD_DIMS = (320, 1024, 1536, 2048)
WIDE_TIMED_DIMS = (320, 1024)
WIDE_TIMED_SHAPE = dict(b=2, h=12, t=SEQ)
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
# the resnet_train recipe (bench.py's ResNet-50: bf16, space-to-depth stem,
# global batch 128 of 224 x 224 uint8 images normalised on the card as
# (x - 127) / 64, sgd at lr 0.1, sparse categorical cross-entropy)
RESNET = dict(depth=50, class_num=1000, width=64, stem="space_to_depth")
IMAGE = 224
RESNET_BATCH = 128
RESNET_POOL = 256       # seeded uint8 images; 2 steps an epoch
RESNET_EPOCHS = 10      # 20 steps
RESNET_LR = 0.1
RESNET_BN = 53          # batch norms of ResNet-50
RESNET_CHECK_BATCH = 8  # resnet_train (a), f32
RESNET_CHECK_LR = 1e-5
# resnet_train (a): the fused f32 model's worst gradient error against
# float64 (of each tensor's max) at most this times the plain f32 model's,
# plus TOL_TRAIN_GRAD (two summation orders of one f32 model, emulated on
# the CPU: 0.163 vs 0.159 and 0.144 vs 0.144)
RESNET_NOISE_FACTOR = 2.0
# fused batch norm, kernel vs plain version on the same inputs.  f32: y and
# dx within 1e-4 of max(1, max |ref|): the per-channel sums differ in order,
# and a mean of 1e3 (the badly centred channel) has an f32 ulp of 6.1e-5,
# which moves x - mean by that much over a unit std; bf16: 2% of max |ref|
# (a mean that lands on the other side of a bf16 rounding step moves one
# rounding of (x - T(mean)) * T(inv), up to an ulp of a value a few times
# |y|); mean, var, dgamma, dbeta (f32 sums over up to 1.6M rows) within 1e-4
# of max(1, max |ref|)
TOL_BN_F32 = 1e-4
TOL_BN_BF16_REL = 2e-2
TOL_BN_STATS = 1e-4
BN_EDGE = [(1001, 3), (333, 6), (4097, 7), (777, 1000), (1, 8)]
XENT_KERNEL = "fused_xent"
# int8_serve: InferenceModel's int8 paths at BERT-base, weight-only and
# calibrated on INT8_CALIB seeded sequences, against the f32 dense model;
# ResNet-50 (norm="batch", its 7x7 stem conv) calibrated on
# RESNET_SERVE_BATCH seeded images, against its bf16 serving
INT8_CALIB = 16
RESNET_SERVE_BATCH = 16
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# int8 logits vs f32 dense, of max(1, max |ref|): a 12-layer width-256
# BERT on the CPU gave 1.8e-2 (weight-only) and 2.1e-2 (calibrated), its
# bf16 serving 1.2e-2 (dev/torch_int8_cpu_error.py)
TOL_INT8_SERVE = 0.1
# ResNet-50 calibrated int8 vs its bf16 serving, of max(1, max |ref|):
# width 16 at 64 x 64 on the CPU gave 3.2e-2 (random-weight logits reach
# 8e2; the same script); the share of images whose top-1 class agrees is
# reported beside
TOL_INT8_RESNET = 0.15
# bench.py's BERT vocab-head recipe (bench_bert): a BERT-base-width post-LN
# encoder (token embedding plus a learned pos, 12 TransformerLayers with
# remat_attention=True, dense attention) under a Dense(30522) vocab head,
# per-token sparse cross-entropy, adamw at 1e-4, global batch 32 as
# grad_accum=8 micro-batches of 4 x 512 tokens
MLM = dict(vocab=30522, d_model=768, heads=12, layers=12)
MLM_MICRO = 4
MLM_ACCUM = 8
MLM_BATCH = MLM_MICRO * MLM_ACCUM
MLM_STEPS = 20           # 20 epochs over one seeded global batch
MLM_CHUNK = 512          # fused_softmax_xent's chunk: one sequence
MLM_CHECK_LAYERS = 2     # bert_mlm_train (a), f32 at full width
MLM_CHECK_ACCUM = 2      # ... global batch 8 = 2 x 4
# fused_xent kernel vs plain version on the same inputs: loss and lse 1e-5
# relative (f32 sums in another order); f32 gradients 1e-5 of each tensor's
# max; bf16: dh (rounded to bf16 once on each side) 2 bf16 ulps of its max,
# dW and db (f32 sums of bf16-rounded terms over 2048 tokens) 1e-3 of their
# max, 2 ulps where dW comes back in bf16
TOL_XENT_LOSS = 1e-5
TOL_XENT_F32 = 1e-5
TOL_XENT_BF16_DH = 2.0 ** -7
TOL_XENT_BF16_SUM = 1e-3
# ragged (N, D, V, chunk) cases beside the recipe's (2048, 768, 30522, 512)
XENT_EDGE = [(300, 40, 777, 100), (129, 13, 30, 43), (256, 64, 1000, 128),
             (512, 768, 4099, 256)]
# the (d) variants: bench.py's training phases from CUDA graphs (one
# captured step a batch key, replayed K times by Estimator._multi_step and
# _multi_step_data).  bench_bert: `steps, repeats = 50, 3` after one warm
# call, streaming `chunk_steps, n_chunks = 10, 3` from 8 worker threads
# with 4 batches of prefetch; bench_resnet50: 20 x 3, streaming 5 x 4 from
# max(4, min(16, cores)) worker processes with 4 of prefetch
MLM_RESIDENT = (50, 3)
MLM_STREAM = (10, 3)
MLM_STREAM_WORKERS = 8
RESNET_RESIDENT = (20, 3)
RESNET_STREAM = (5, 4)
STREAM_PREFETCH = 4
# steps of the eager step the captured one must repeat bit for bit (an
# eager MLM step takes 0.5-0.9 s; a ResNet step under cuDNN's
# deterministic algorithms, which the comparison needs, is slower too)
MLM_CMP_STEPS = 10
RESNET_CMP_STEPS = 5
# bench.py's acceptance for a streaming phase: within 15% of resident
STREAM_WITHIN = 0.15


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


# Spin kernels, then idle time, at both ends of every profiler window;
# the spin kernels' events are left out.  Late in a long run on the H100
# the profiler lost a window's first kernels (of a window of one
# fused_xent call it kept the last of 3 kernels or none, of ten calls 28
# of 30, also with 50 ms idle at either end); the same calls in a fresh
# process lost none.  What it loses is then the padding's.
_PAD_LAUNCHES = 64
_PAD_KERNEL = "spin_kernel"
_PAD_IDLE_S = 0.05


def _pad() -> None:
    for _ in range(_PAD_LAUNCHES):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(_PAD_IDLE_S)


def _profiled(fn, calls: int) -> dict:
    """The card's events of ``calls`` calls of ``fn`` under
    ``torch.profiler``, by kernel: {name: (count, device us)}."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _pad()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        _pad()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _PAD_KERNEL not in e.key}


def device_windows(fn, iters: int = 20, runs: int = 3) -> list:
    """``runs`` profiler windows of ``iters`` calls of ``fn`` each, as
    {kernel: (count, device us)}, each window whole: it recorded, of every
    kernel, ``iters`` times what one call launches (the most that any of
    three windows of one call recorded) and nothing else.  A window that
    lost events is run again, up to ``3 * runs`` windows in all, and too
    few whole ones raise."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call: dict = {}
    for _ in range(3):
        for name, (count, _) in _profiled(fn, 1).items():
            per_call[name] = max(per_call.get(name, 0), count)
    if not per_call:
        raise RuntimeError("device_windows: the profiler recorded no event "
                           "of a call")
    want = {name: count * iters for name, count in per_call.items()}
    windows, short = [], []
    for _ in range(3 * runs):
        window = _profiled(fn, iters)
        got = {name: count for name, (count, _) in window.items()}
        if got == want:
            windows.append(window)
            if len(windows) == runs:
                return windows
        else:
            short.append({n: (got.get(n, 0), want.get(n, 0))
                          for n in set(got) | set(want)
                          if got.get(n, 0) != want.get(n, 0)})
    raise RuntimeError(f"device_windows: {len(windows)} of {3 * runs} "
                       f"windows recorded {iters} calls' events whole; "
                       f"(recorded, expected) by kernel: {short}")


def device_ms(fn, iters: int = 20, runs: int = 3) -> float:
    """The card's kernel time per call of ``fn``: the device-side events of
    ``iters`` calls under ``torch.profiler``, summed and divided by
    ``iters``; the median of ``runs`` whole windows (``device_windows``).
    Unlike ``cuda_ms`` it leaves out the gaps where the card waits for the
    host to launch, which decide ``cuda_ms`` for a kernel shorter than its
    launch."""
    times = sorted(sum(us for _, us in window.values()) / 1e3 / iters
                   for window in device_windows(fn, iters, runs))
    return times[len(times) // 2]


def bound(flops: float, nbytes: float, itemsize: int,
          fma: bool = False) -> tuple:
    """(ms, "bytes"|"operations"): the larger of the operations at the
    dtype's peak rate and the bytes at the memory rate.  f32 operations at
    f32's accuracy take the tensor cores' 3xTF32 (TF32_PASSES x FLOP at
    495 TFLOP/s); ``fma`` takes the f32 FMAs' 67 TFLOP/s instead (the
    bound before the f32 designs used the tensor cores, kept beside it)."""
    if itemsize == 2:
        peak = PEAK_BF16_FLOPS
    else:
        peak = PEAK_F32_FLOPS if fma else PEAK_TF32_FLOPS / TF32_PASSES
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_bound(bh: int, t: int, d: int, itemsize: int,
              fma: bool = False) -> tuple:
    """The backward's least time (not causal): 10 * BH * T^2 * D FLOP (the
    FA2 backward's five products), q, k, v, out, dout read once and dq,
    dk, dv written once."""
    return bound(10.0 * bh * t * t * d, 8.0 * bh * t * d * itemsize,
                 itemsize, fma)


def attention_bound(bh: int, tq: int, tk: int, d: int, itemsize: int,
                    causal: bool, fma: bool = False) -> tuple:
    """(ms, "bytes"|"operations"): the least time for the forward's work:
    q, k, v read once, out and lse written once; 4*tq*tk*d FLOP per head
    (the causal half when masked), at the dtype's peak rate."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    flops = 4.0 * bh * pairs * d
    nbytes = (2 * bh * tq * d + 2 * bh * tk * d) * itemsize + bh * tq * 4
    return bound(flops, nbytes, itemsize, fma)


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
    cases += [(70000, 8, 8, d, dt, c) for d in (16, 64) for dt in dtypes
              for c in (False, True)]
    # grids large enough for the bf16 kernel's 128-row tiles (d <= 64)
    cases += [(96, tq, tk, d, torch.bfloat16, c)
              for tq, tk in ((1000, 700), (700, 1000)) for d in (24, 40, 64)
              for c in (False, True)]
    # the shapes the main path gives it: BH = 12 heads x each batch bucket
    b, h, t, d = (TIMED_SHAPE[x] for x in "bhtd")
    cases += [(h * n, t, t, d, dt, False) for n in BUCKETS for dt in dtypes]
    # and the shape every training step gives it (both bert_train runs'
    # dtypes), and bert_train (a)'s f32 one at batch CHECK_BATCH
    tb, th, tt, td = (TRAIN_SHAPE[x] for x in "bhtd")
    cases += [(tb * th, tt, tt, td, dt, False) for dt in dtypes]
    cases += [(CHECK_BATCH * th, tt, tt, td, torch.float32, c)
              for c in (False, True)]
    # the bf16 wgmma design (heads 33-64): the largest bucket and the
    # training shape under `causal`, the widths the TMA box zero-fills (36
    # padded to 40 first) with ragged Tq != Tk, and one query row against
    # many keys
    cases += [(bh, t, t, d, torch.bfloat16, True) for bh in (h * 64, tb * th)]
    cases += [(3, tq, tk, dd, torch.bfloat16, c) for dd in (36, 40, 48, 56)
              for tq, tk in ((77, 130), (130, 77)) for c in (False, True)]
    cases += [(3, 1, 300, 64, torch.bfloat16, c) for c in (False, True)]
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
    # the wgmma design's other widths (the TMA box zero-fills columns d-63;
    # 36 is padded to 40 first), ragged Tq != Tk under `causal`, and the
    # training shape under `causal`
    bwd_cases += [(3, tq, tk, d, torch.bfloat16, c) for d in (36, 40, 56)
                  for tq, tk in ((77, 130), (130, 77)) for c in (False, True)]
    bwd_cases += [(tb * th, tt, tt, td, torch.bfloat16, True)]
    for case in bwd_cases:
        check_bwd(*case)
    # no atomics: the backward twice on one input at the training shape
    # gives the same bits, in both dtypes
    for dtype in dtypes:
        q, k, v = qkv(tb * th, tt, tt, td, dtype)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, False)
        first, second = (fa.flash_attention_bwd(q, k, v, out, lse, g, False)
                         for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{dtype} backward: two calls on one input "
                                 f"differ")
        del q, k, v, g, out, lse, first, second

    # times at every serving shape and the training shape (bf16), the
    # largest bucket under `causal`, and in f32 the timed shape (BH 192,
    # bert_serve f32's bucket 16) and bert_train (a)'s BH 96 (both on the
    # wgmma_tf32 design), with the 3xTF32 bound and the f32 FMAs' beside;
    # each shape checked again on the inputs it is timed on.  ms, plain_ms
    # and library_ms are CUDA-event times per call, host launch included
    # (cuda_ms); the *device_ms keys are the card's kernel time per call
    # alone (device_ms), which differ where a call is shorter than its
    # launch
    timings = []
    for bh, dtype, causal in [(h * n, torch.bfloat16, False)
                              for n in BUCKETS] + [
            (tb * th, torch.bfloat16, False), (h * 64, torch.bfloat16, True),
            (b * h, torch.float32, False),
            (CHECK_BATCH * h, torch.float32, False)]:
        q, k, v, err = check(bh, t, t, d, dtype, causal)
        q4, k4, v4 = (x.view(bh // h, h, t, d) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal)

        def plain():
            return fa.flash_attention_fwd_reference(q, k, v, causal)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)

        ms, plain_ms, library_ms = (cuda_ms(f)
                                    for f in (kernel, plain, library))
        dev_ms, plain_dev_ms, library_dev_ms = (
            device_ms(f) for f in (kernel, plain, library))
        bound_ms, bound_by = attention_bound(bh, t, t, d, q.element_size(),
                                             causal)
        fma_ms = attention_bound(bh, t, t, d, 4, causal, fma=True)[0] \
            if dtype == torch.float32 else None
        pairs = t * (t + 1) / 2 if causal else t * t
        timings.append({
            "kernel": fa.fwd_kernel(dtype, d)[0],
            "design": fa.fwd_design(dtype, d), "bh": bh, "t": t, "d": d,
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fma_bound_ms": fma_ms,
            "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 4.0 * bh * pairs * d / dev_ms / 1e9})

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
        fma_ms = bwd_bound(bh, tt, td, 4, fma=True)[0] \
            if dtype == torch.float32 else None
        bwd_timings.append({
            "kernel": BWD_KERNEL, "design": fa.bwd_design(dtype, td),
            "bh": bh, "t": tt, "d": td,
            "dtype": str(dtype).replace("torch.", ""), "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms,
            "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fma_bound_ms": fma_ms,
            "device_share_of_bound": bound_ms / dev_ms,
            "device_tflop_per_s": 10.0 * bh * tt * tt * td / dev_ms / 1e9})
        del q4, k4, v4, out4
    # the bf16 designs no main path takes at the training shape's BH 384 x
    # T 512: the forward's and the backward's mma.sync at D 32, the
    # forward's mma.sync and the backward's scalar kernel at D 128; each
    # checked on the inputs it is timed on, beside its bound, its plain
    # version and SDPA's (forward, or its backward alone)
    other_timings = []
    for od in (32, 128):
        bh = tb * th
        q, k, v, out, g, err = check_bwd(bh, tt, tt, od, torch.bfloat16,
                                         False)
        fwd_err = check(bh, tt, tt, od, torch.bfloat16, False)[3]
        lse = fa.flash_attention_fwd(q, k, v, False)[1]
        q4, k4, v4 = (x.view(tb, th, tt, od).detach().requires_grad_()
                      for x in (q, k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        g4 = g.view(tb, th, tt, od)
        for direction, kernel, plain, library, bnd, e in (
                ("fwd", lambda: fa.flash_attention_fwd(q, k, v, False),
                 lambda: fa.flash_attention_fwd_reference(q, k, v, False),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q4.detach(), k4.detach(), v4.detach()),
                 attention_bound(bh, tt, tt, od, 2, False), fwd_err),
                ("bwd",
                 lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, False),
                 lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                          g, False),
                 lambda: torch.autograd.grad(out4, (q4, k4, v4), g4,
                                             retain_graph=True),
                 bwd_bound(bh, tt, od, 2), err)):
            other_timings.append({
                "kernel": fa.fwd_kernel(torch.bfloat16, od)[0]
                if direction == "fwd" else BWD_KERNEL,
                "direction": direction,
                "design": fa.fwd_design(torch.bfloat16, od)
                if direction == "fwd" else fa.bwd_design(torch.bfloat16, od),
                "bh": bh, "t": tt, "d": od, "dtype": "bfloat16",
                "max_abs_err": e, "ms": cuda_ms(kernel, iters=10),
                "plain_ms": cuda_ms(plain, iters=5),
                "library_ms": cuda_ms(library, iters=10),
                "device_ms": device_ms(kernel, iters=10),
                "plain_device_ms": device_ms(plain, iters=5),
                "library_device_ms": device_ms(library, iters=10),
                "bound_ms": bnd[0], "bound_by": bnd[1]})
        del q4, k4, v4, out4
    # the f32 forward's scalar design (heads 65-256; no main path has them)
    # at BH 384 x T 512, D 128, checked on the inputs it is timed on,
    # beside its 3xTF32 and FMA bounds, its plain version and SDPA
    bh, od = tb * th, 128
    q, k, v, err = check(bh, tt, tt, od, torch.float32, False)
    q4, k4, v4 = (x.view(tb, th, tt, od) for x in (q, k, v))
    bnd = attention_bound(bh, tt, tt, od, 4, False)
    kernel, plain, library = (
        lambda: fa.flash_attention_fwd(q, k, v, False),
        lambda: fa.flash_attention_fwd_reference(q, k, v, False),
        lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4))
    other_timings.append({
        "kernel": fa.fwd_kernel(torch.float32, od)[0], "direction": "fwd",
        "design": fa.fwd_design(torch.float32, od), "bh": bh, "t": tt,
        "d": od, "dtype": "float32", "max_abs_err": err,
        "ms": cuda_ms(kernel, iters=10), "plain_ms": cuda_ms(plain, iters=5),
        "library_ms": cuda_ms(library, iters=10),
        "device_ms": device_ms(kernel, iters=10),
        "plain_device_ms": device_ms(plain, iters=5),
        "library_device_ms": device_ms(library, iters=10),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "fma_bound_ms": attention_bound(bh, tt, tt, od, 4, False,
                                        fma=True)[0]})
    del q, k, v, q4, k4, v4
    # the wide kernels (head dims above 256) at D 320 and 1024, both
    # directions and dtypes; SDPA's yardstick is whichever of its
    # memory-efficient and math backends takes the head dim
    wide_timings = []
    wb, wh, wt = (WIDE_TIMED_SHAPE[x] for x in "bht")
    for d in WIDE_TIMED_DIMS:
        for dtype in dtypes:
            bh = wb * wh
            q, k, v, out, g, err = check_bwd(bh, wt, wt, d, dtype, False)
            lse = fa.flash_attention_fwd(q, k, v, False)[1]
            q4, k4, v4 = (x.view(wb, wh, wt, d).detach().requires_grad_()
                          for x in (q, k, v))
            backend, sdpa_out = sdpa_any_head_dim(q4, k4, v4)
            g4 = g.view(wb, wh, wt, d)
            fwd_err = (fa.flash_attention_fwd(q, k, v, False)[0].float()
                       - fa.flash_attention_fwd_reference(q, k, v)[0].float()
                       ).abs().max().item()
            for direction, kernel, plain, library, bnd, fma_bnd in (
                    ("fwd",
                     lambda: fa.flash_attention_fwd(q, k, v, False),
                     lambda: fa.flash_attention_fwd_reference(q, k, v),
                     lambda: sdpa_any_head_dim(q4.detach(), k4.detach(),
                                               v4.detach(), backend),
                     attention_bound(bh, wt, wt, d, q.element_size(),
                                     False),
                     attention_bound(bh, wt, wt, d, 4, False, fma=True)),
                    ("bwd",
                     lambda: fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                    False),
                     lambda: fa.flash_attention_bwd_reference(
                         q, k, v, out, lse, g, False),
                     lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), g4,
                                                 retain_graph=True),
                     bwd_bound(bh, wt, d, q.element_size()),
                     bwd_bound(bh, wt, d, 4, fma=True))):
                ms, plain_ms, library_ms = (cuda_ms(f, iters=5)
                                            for f in (kernel, plain, library))
                dev_ms, plain_dev_ms, library_dev_ms = (
                    device_ms(f, iters=5) for f in (kernel, plain, library))
                wide_timings.append({
                    "kernel": fa.fwd_kernel(dtype, d)[0] if direction == "fwd"
                    else BWD_KERNEL, "direction": direction, "bh": bh,
                    "t": wt, "d": d, "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": fwd_err if direction == "fwd" else err,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "library": f"scaled_dot_product_attention ({backend})",
                    "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
                    "library_device_ms": library_dev_ms,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "fma_bound_ms": fma_bnd[0] if dtype == torch.float32
                    else None})
            del q4, k4, v4, sdpa_out
    res = {"phase": "kernel", "cases": len(cases),
           "bwd_cases": len(bwd_cases), "worst": worst,
           "tolerances": {"f32_out_abs": TOL_F32, "lse_abs": TOL_LSE,
                          "bf16_out_rel_to_max": TOL_BF16_REL,
                          "bwd_f32_rel_to_max1": TOL_BWD_F32,
                          "bwd_bf16_rel_to_max": TOL_BWD_BF16},
           "timed_shape": dict(TIMED_SHAPE, causal=False),
           "bwd_bf16_rel_by_case": bwd_bf16_rel,
           "timings": timings, "bwd_timings": bwd_timings,
           "other_design_timings": other_timings,
           "wide_timings": wide_timings}
    emit(res)
    return res


def sdpa_any_head_dim(q4, k4, v4, backend=None):
    """``F.scaled_dot_product_attention`` over ``[B, H, T, D]`` on its
    memory-efficient backend, or its math backend where that one refuses
    the head dim; returns (backend name, output), or the output alone when
    ``backend`` is given."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    names = {"efficient": SDPBackend.EFFICIENT_ATTENTION,
             "math": SDPBackend.MATH}
    for name in ([backend] if backend else list(names)):
        try:
            with sdpa_kernel([names[name]]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4)
        except RuntimeError:
            if backend:
                raise
            continue
        return out if backend else (name, out)
    raise RuntimeError("no SDPA backend takes this head dim")


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
        elif leaf in ("embeddings", "pos_embed", "pos"):
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
    for counts in (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_designs(counts: dict, what: str, design: str, runs: int) -> dict:
    """Launches by design since ``reset_counts`` (``counts``: the
    forward's or the backward's): all of them ``design``'s, once per
    encoder layer of each of ``runs``."""
    want = dict.fromkeys(counts, 0)
    want[design] = BERT_BASE["n_layers"] * runs
    if counts != want:
        raise AssertionError(f"{what}: launches by design {counts}; want "
                             f"{want}")
    return dict(counts)


def read_fwd_designs(fa, what: str, design: str, runs: int) -> dict:
    return read_designs(fa.FWD_LAUNCHES, f"{what} forward", design, runs)


def read_bwd_designs(fa, what: str, design: str, runs: int) -> dict:
    return read_designs(fa.BWD_LAUNCHES, f"{what} backward", design, runs)


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


def served_latency(im, x, seq: int = 0) -> dict:
    """Host-clock ``predict`` latency of ``im`` on ``x`` (LATENCY_CALLS
    calls, each ending in the device -> host copy): p50, p90, min, rows/s
    and, for BERT-base rows of ``seq`` tokens, tokens/s and model TFLOP/s
    at the p50."""
    times = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        im.predict(x)
        times.append((time.perf_counter() - t0) * 1e3)
    p50, b = float(np.median(times)), len(x)
    res = {"p50_ms": p50, "min_ms": min(times), "calls": LATENCY_CALLS,
           "p90_ms": float(np.percentile(times, 90)),
           "rows_per_s": b / (p50 / 1e3)}
    if seq:
        res["tokens_per_s"] = b * seq / (p50 / 1e3)
        res["model_tflop_per_s"] = b * seq * bert_flops_per_token() / p50 / 1e9
    return res


def phase_bert_serve(fa) -> dict:
    from analytics_zoo_tpu_torch.models import BERTClassifier
    from analytics_zoo_tpu_torch.serving import InferenceModel

    def served(use_flash, dtype=None, cuda_graphs=True):
        model = BERTClassifier(2, use_flash=use_flash, **BERT_BASE)
        return InferenceModel(device="cuda", cuda_graphs=cuda_graphs).load(
            model, variables, dtype=dtype)

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
    im.warm([(SEQ,)], dtype=np.int32)
    warm_s = time.perf_counter() - t0
    outs = {n: im.predict(x) for n, x in batches.items()}
    forwards = im.compile_count + sum(-(-n // top) for n in batches)
    launches = read_counts(fa, "bert_serve bf16",
                           **{BF16_KERNEL: forwards})
    fwd_designs = read_fwd_designs(fa, "bert_serve bf16", "wgmma", forwards)

    # the same model served eagerly (no CUDA graphs): its logits against
    # the graphs' (the same kernels on the same inputs: equal bits
    # expected) and its latency beside theirs, in turns
    eager = served(True, torch.bfloat16, cuda_graphs=False)
    eager.warm([(SEQ,)], dtype=np.int32)
    eager_outs = {n: eager.predict(x) for n, x in batches.items()}
    graph_vs_eager = max(
        float(np.abs(outs[n] - y).max()) / max(1.0, float(np.abs(y).max()))
        for n, y in eager_outs.items())
    if graph_vs_eager > TOL_SERVE_BF16:
        raise AssertionError(f"bert_serve: graph and eager logits differ by "
                             f"{graph_vs_eager} > {TOL_SERVE_BF16}")
    latency = {}
    for b in im.batch_buckets:
        latency[str(b)] = served_latency(im, batches[64][:b], SEQ)
        latency[str(b)]["eager_p50_ms"] = served_latency(
            eager, batches[64][:b], SEQ)["p50_ms"]
    breakdown = {str(b): profile_call(
        lambda: im.predict(batches[64][:b]), {"flash": ("flash_fwd_",)})
        for b in (1, 64)}
    eager_breakdown = {str(b): profile_call(
        lambda: eager.predict(batches[64][:b]), {"flash": ("flash_fwd_",)})
        for b in (1, 64)}
    del im, eager

    errors = {}
    ref_im = served(False)
    refs = {n: ref_im.predict(x) for n, x in batches.items()}
    del ref_im
    # the f32 flash path, its kernel counted over this run alone
    f32_im = served(True)
    reset_counts(fa)
    f32_outs = {n: f32_im.predict(x) for n, x in batches.items()}
    # each key's first predict runs one eager forward before its capture
    f32_forwards = sum(-(-n // f32_im.batch_buckets[-1]) for n in batches) \
        + f32_im.compile_count
    f32_launches = read_counts(fa, "bert_serve f32",
                               **{F32_KERNEL: f32_forwards})
    f32_fwd_designs = read_fwd_designs(fa, "bert_serve f32", "wgmma_tf32",
                                       f32_forwards)
    f32_breakdown = profile_call(lambda: f32_im.predict(batches[64]), {
        "flash": ("flash_fwd_", "split_tf32")})
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
           "fwd_launches_by_design": fwd_designs,
           "f32_forwards": f32_forwards, "f32_flash_launches": f32_launches,
           "f32_fwd_launches_by_design": f32_fwd_designs,
           "f32_breakdown_64": f32_breakdown, "setup_s": setup_s,
           "warm_s": warm_s, "cuda_graphs": True, "latency": latency,
           "breakdown": breakdown, "eager_breakdown": eager_breakdown,
           "graph_vs_eager_max_err_rel_to_max": graph_vs_eager,
           "errors": errors}
    emit(res)
    return res


# ClusterServing over the port (cluster_serve): BERT-base bf16 from CUDA
# graphs behind the port's server, its scheduler, registry, router and
# HTTP frontend
CS_BATCH = 64            # ClusterServing(batch_size=)
CS_WORKERS = 2           # ClusterServing(inference_workers=)
CS_LEVELS = (1, 16, 64)  # closed-loop TCP clients
CS_MIN_REQUESTS = 256    # per level (and 8 a client at least)
CS_POOL = 512            # distinct seeded rows the requests cycle through
CS_LOAD_CLIENTS = 16     # during the hot swap and the replica kill
CS_PHASE_REPLIES = 64    # replies each stage of those runs waits for


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def stream_wide_call(self, xp):
    """``_Graph.__call__`` with the wait it had before the per-replay
    event: the caller waits for the whole serving stream (every replay any
    thread queued there), not for its own replay's event.  Timed beside
    the event wait."""
    from analytics_zoo_tpu_torch.ops import _launches
    with self.lock:
        self.staging.numpy()[...] = xp
        with torch.cuda.stream(self.stream):
            self.static_in.copy_(self.staging, non_blocking=True)
            self.graph.replay()
            self.host_out.copy_(self.static_out, non_blocking=True)
        self.stream.synchronize()
        _launches.replay(self.launches)
        return self.host_out.numpy().copy()


def cluster_level(srv, pool, clients: int, requests: int) -> dict:
    """``clients`` closed-loop clients, each over its own
    ``InputQueue``/``OutputQueue`` on loopback, send one row each and wait
    for its reply, ``requests`` in all (request k sends pool row k);
    connections are made before the clock starts.  Returns the per-request
    latencies (ms), the wall time and the (row, reply) pairs."""
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
    per = -(-requests // clients)
    barrier = threading.Barrier(clients + 1)
    results, errors = [[] for _ in range(clients)], []

    def run(c):
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        try:
            barrier.wait()
            for j in range(per):
                row = (c * per + j) % len(pool)
                t0 = time.perf_counter()
                out = oq.query(iq.enqueue(f"c{c}", t=pool[row]),
                               timeout=120.0)
                ms = (time.perf_counter() - t0) * 1e3
                if out is None:
                    errors.append(f"client {c}: timeout")
                    return
                results[c].append((row, out, ms))
        except Exception as e:  # noqa: BLE001 - recorded, raised below
            errors.append(f"client {c}: {type(e).__name__}: {e}")
        finally:
            iq.close()

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster_serve: {clients} clients: "
                             f"{errors[:3] or 'a client hung'}")
    done = [r for rs in results for r in rs]
    return {"latency_ms": [r[2] for r in done], "wall_s": wall,
            "replies": [(r[0], r[1]) for r in done]}


def _level_in_a_process(host, port, pool, clients, requests, out) -> None:
    """``cluster_level`` from a process of its own (spawned): the clients
    then share no interpreter lock with the server."""
    from types import SimpleNamespace
    run = cluster_level(SimpleNamespace(host=host, port=port), pool,
                        clients, requests)
    out.put(run)


def cluster_level_in_a_process(srv, pool, clients: int,
                               requests: int) -> dict:
    """``cluster_level`` with the clients in a spawned process."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_level_in_a_process,
                       args=(srv.host, srv.port, pool, clients, requests,
                             out))
    proc.start()
    try:
        run = out.get(timeout=600)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    return run


def stage_p50s(srv) -> dict:
    """The server's own p50 of each pipeline stage (ms): queue wait,
    assembly, the model call, the reply write."""
    from analytics_zoo_tpu_torch.core.metrics import quantile_from_snapshot
    snap = srv._metrics.snapshot()
    return {stage: quantile_from_snapshot(snap[f"server.{stage}_ms"], 0.5)
            for stage in ("queue_wait", "assembly", "inference", "reply")}


def latency_summary(lat_ms, wall_s) -> dict:
    n = len(lat_ms)
    return {"requests": n, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "requests_per_s": n / wall_s,
            "tokens_per_s": n * SEQ / wall_s, "wall_s": wall_s}


def check_served(st: dict, what: str, requests: int) -> None:
    """The server's books: every request answered, none failed."""
    if st["requests"] != st["replies"] + st["errors"] + st["pending"] \
            or st["errors"] or st["pending"] or st["requests"] != requests:
        raise AssertionError(f"{what}: stats {st}; want {requests} "
                             "requests, all replied")


def check_replies(replies, refs: dict, what: str) -> dict:
    """Each reply against its row's logits from each reference (direct
    ``predict``): it must match exactly one, within TOL_SERVE_BF16 of
    max(1, |ref|) (a served row's batch differs from the reference's).
    Returns how many matched each and the worst error."""
    hits = dict.fromkeys(refs, 0)
    worst = 0.0
    for row, out in replies:
        errs = {name: float(np.abs(out - ref[row]).max())
                / max(1.0, float(np.abs(ref[row]).max()))
                for name, ref in refs.items()}
        match = [name for name, e in errs.items() if e <= TOL_SERVE_BF16]
        if out.shape != (2,) or not np.isfinite(out).all() \
                or len(match) != 1:
            raise AssertionError(f"{what}: row {row} gave {out}, errors "
                                 f"{errs} (tolerance {TOL_SERVE_BF16})")
        hits[match[0]] += 1
        worst = max(worst, errs[match[0]])
    return {"matched": hits, "max_err_rel_to_max": worst,
            "tol": TOL_SERVE_BF16}


def phase_cluster_serve(fa) -> dict:
    import urllib.request
    from analytics_zoo_tpu_torch.core.metrics import MetricsRegistry
    from analytics_zoo_tpu_torch.models import BERTClassifier
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 HTTPFrontend,
                                                 InferenceModel,
                                                 ReplicaSet, RetryPolicy)
    from analytics_zoo_tpu_torch.serving import inference_model as im_lib

    card = nvidia_smi()

    def served(variables, cuda_graphs=True):
        return InferenceModel(device="cuda", cuda_graphs=cuda_graphs).load(
            BERTClassifier(2, use_flash=True, **BERT_BASE), variables,
            dtype=torch.bfloat16)

    def server(model, scheduler="window", port=0):
        return ClusterServing(model, port=port, batch_size=CS_BATCH,
                              inference_workers=CS_WORKERS,
                              scheduler=scheduler,
                              metrics=MetricsRegistry()).start()

    def refs_of(model):
        return np.concatenate([model.predict(pool[i:i + CS_BATCH])
                               for i in range(0, CS_POOL, CS_BATCH)])

    t0 = time.perf_counter()
    variables = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED)
    pool = np.random.default_rng(SEED + 2).integers(
        0, BERT_BASE["vocab_size"], (CS_POOL, SEQ)).astype(np.int32)
    setup_s = time.perf_counter() - t0

    # the main path: the model warmed (every bucket's graph captured)
    # before the port opens, then each level under each scheduler, each
    # on a fresh server over the same model; the counts read right after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    im = served(variables)
    im.warm([(SEQ,)], dtype=np.int32)
    levels, replies, batches, native = {}, [], 0, set()
    for scheduler in ("window", "continuous"):
        for c in CS_LEVELS:
            n = max(CS_MIN_REQUESTS, 8 * c)
            srv = server(im, scheduler)
            try:
                native.add(srv._queue.is_native)
                run = cluster_level(srv, pool, c, n)
            finally:
                srv.stop()
            st = srv.stats()
            stages = stage_p50s(srv)
            check_served(st, f"cluster_serve {scheduler} c={c}", n)
            batches += st["batches"]
            replies += run["replies"]
            levels[f"{scheduler}_c{c}"] = dict(
                latency_summary(run["latency_ms"], run["wall_s"]),
                clients=c, batches=st["batches"],
                mean_batch_size=st["mean_batch_size"],
                queue_depth_max=st["queue_depth_max"],
                server_stage_p50_ms=stages)
    forwards = im.compile_count + batches
    launches = read_counts(fa, "cluster_serve", **{BF16_KERNEL: forwards})
    fwd_designs = read_fwd_designs(fa, "cluster_serve", "wgmma", forwards)
    peak_main = torch.cuda.max_memory_allocated()
    if native != {True}:
        raise AssertionError("cluster_serve: the server's queue is not the "
                             "C++ one (NativeQueue.is_native)")
    compiled = im.compile_count
    ref = refs_of(im)
    if im.compile_count != compiled:
        raise AssertionError("cluster_serve: a reference predict captured")
    agree = check_replies(replies, {"direct": ref}, "cluster_serve")

    # one profiled window of the c = 64 level: the card's busy time
    srv = server(im)
    try:
        busy = profile_call(
            lambda: cluster_level(srv, pool, CS_LEVELS[-1], CS_MIN_REQUESTS),
            {"flash": ("flash_fwd_",)})
    finally:
        srv.stop()

    # the c = 64 level with the clients in a process of their own: how
    # much of the time the clients' threads took from the server's
    c = CS_LEVELS[-1]
    srv = server(im)
    try:
        run = cluster_level_in_a_process(srv, pool, c, max(
            CS_MIN_REQUESTS, 8 * c))
    finally:
        srv.stop()
    st = srv.stats()
    check_served(st, "cluster_serve clients in a process", len(
        run["replies"]))
    check_replies(run["replies"], {"direct": ref}, "clients in a process")
    levels[f"window_c{c}_clients_in_a_process"] = dict(
        latency_summary(run["latency_ms"], run["wall_s"]), clients=c,
        batches=st["batches"], mean_batch_size=st["mean_batch_size"],
        queue_depth_max=st["queue_depth_max"],
        server_stage_p50_ms=stage_p50s(srv))

    # two workers, waiting on their own replay's event and on the whole
    # serving stream (the wait before the event), in turns at c = 64
    waits = {"event": [], "stream": []}
    event_call = im_lib._Graph.__call__
    for mode in ("event", "stream", "stream", "event"):
        im_lib._Graph.__call__ = stream_wide_call if mode == "stream" \
            else event_call
        srv = server(im)
        try:
            run = cluster_level(srv, pool, CS_LEVELS[-1], CS_MIN_REQUESTS)
        finally:
            srv.stop()
            im_lib._Graph.__call__ = event_call
        check_replies(run["replies"], {"direct": ref}, f"{mode} wait")
        waits[mode].append(float(np.percentile(run["latency_ms"], 50)))

    # the eager yardstick through the server, unwarmed: the flash kernel's
    # first launch (its TMA encoding) happens on a worker thread
    eager = served(variables, cuda_graphs=False)
    reset_counts(fa)
    srv = server(eager)
    try:
        run = cluster_level(srv, pool, CS_LOAD_CLIENTS, CS_MIN_REQUESTS)
    finally:
        srv.stop()
    st = srv.stats()
    check_served(st, "cluster_serve eager", CS_MIN_REQUESTS)
    eager_forwards = eager.compile_count + st["batches"]
    eager_launches = read_counts(fa, "cluster_serve eager",
                                 **{BF16_KERNEL: eager_forwards})
    eager_res = dict(latency_summary(run["latency_ms"], run["wall_s"]),
                     mean_batch_size=st["mean_batch_size"],
                     forwards=eager_forwards, flash_launches=eager_launches,
                     vs_graphs=check_replies(run["replies"],
                                             {"direct": ref}, "eager"))
    del eager, srv
    torch.cuda.empty_cache()

    # hot swap under load: update_model to another version (other seed)
    # while 16 clients run; the incoming model captures its graphs on this
    # thread (warm_from) while the old one's replay on the workers
    new_vars = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED + 1)
    swap_replies, failures = [], []
    stop = threading.Event()

    def load(srv_ref, c):
        from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
        iq = InputQueue(srv_ref.host, srv_ref.port)
        oq = OutputQueue(input_queue=iq)
        k = c
        try:
            while not stop.is_set():
                row = k % CS_POOL
                out = oq.query(iq.enqueue(f"c{c}", t=pool[row]), 120.0)
                if out is None:
                    failures.append("timeout")
                else:
                    swap_replies.append((row, out))
                k += CS_LOAD_CLIENTS
        except Exception as e:  # noqa: BLE001 - recorded, raised below
            failures.append(f"{type(e).__name__}: {e}")
        finally:
            iq.close()

    def wait_replies(got, n, what, timeout=120.0):
        deadline = time.monotonic() + timeout
        while len(got) < n and not failures:
            if time.monotonic() > deadline:
                raise AssertionError(f"cluster_serve: {what}: {len(got)} "
                                     f"of {n} replies")
            time.sleep(0.01)

    reset_counts(fa)
    srv = server(im)
    threads = [threading.Thread(target=load, args=(srv, c))
               for c in range(CS_LOAD_CLIENTS)]
    for t in threads:
        t.start()
    try:
        wait_replies(swap_replies, CS_PHASE_REPLIES, "before the swap")
        torch.cuda.reset_peak_memory_stats()
        new = served(new_vars)
        t0 = time.perf_counter()
        srv.update_model(new)  # warm_from, the flip, old version unloaded
        swap_s = time.perf_counter() - t0
        after_warm = new.compile_count
        n_swap = len(swap_replies)
        wait_replies(swap_replies, n_swap + 4 * CS_PHASE_REPLIES,
                     "after the swap")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        srv.stop()
    peak_swap = torch.cuda.max_memory_allocated()
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster_serve swap: {failures[:3]}")
    st = srv.stats()
    check_served(st, "cluster_serve swap", st["requests"])
    swap_forwards = new.compile_count + st["batches"]
    swap_launches = read_counts(fa, "cluster_serve swap",
                                **{BF16_KERNEL: swap_forwards})
    if new.compile_count != after_warm or after_warm != len(im._compiled):
        raise AssertionError(
            f"cluster_serve swap: the new model prepared {new.compile_count}"
            f" keys, {after_warm} by warm_from; want {len(im._compiled)}")
    ref_new = refs_of(new)
    swap_agree = check_replies(swap_replies, {"old": ref, "new": ref_new},
                               "cluster_serve swap")
    tail = check_replies(swap_replies[-CS_PHASE_REPLIES:],
                         {"old": ref, "new": ref_new}, "swap tail")
    if swap_agree["matched"]["new"] == 0 or tail["matched"]["old"]:
        raise AssertionError(f"cluster_serve swap: replies never flipped "
                             f"({swap_agree['matched']}, last "
                             f"{CS_PHASE_REPLIES}: {tail['matched']})")
    swap = {"update_model_s": swap_s, "compile_count_new": new.compile_count,
            "replies": len(swap_replies), "failures": 0,
            "batches": st["batches"], "forwards": swap_forwards,
            "flash_launches": swap_launches, "agree": swap_agree,
            "peak_memory_bytes": peak_swap}
    del new
    torch.cuda.empty_cache()

    # the router and the HTTP frontend over two in-process replicas, each
    # with its own model; 16 HTTP clients; kill replica 0, restart it on
    # its port, then drain replica 1 and restart it
    reset_counts(fa)
    models = [im, served(variables)]
    models[1].warm([(SEQ,)], dtype=np.int32)
    servers = [server(m) for m in models]
    every = list(servers)
    ports = [s.port for s in servers]
    names = [f"{s.host}:{s.port}" for s in servers]
    rs = ReplicaSet([(s.host, s.port) for s in servers],
                    retry=RetryPolicy(max_attempts=4, base_delay=0.02,
                                      max_delay=0.1, seed=SEED),
                    health_interval=0.1, health_timeout=1.0,
                    breaker_threshold=3, breaker_reset_s=0.2)
    fe = HTTPFrontend(router=rs).start()
    http_replies, http_ms, failures[:] = [], [], []
    stop.clear()

    def http_load(c):
        k = c
        while not stop.is_set():
            row = k % CS_POOL
            body = json.dumps({"instances": pool[row].tolist(),
                               "dtype": "int32"}).encode()
            req = urllib.request.Request(
                f"http://{fe.host}:{fe.port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = np.asarray(json.load(r)["predictions"],
                                     np.float32)
            except Exception as e:  # noqa: BLE001 - recorded, raised below
                failures.append(f"{type(e).__name__}: {e}")
                continue
            http_ms.append((time.perf_counter() - t0) * 1e3)
            http_replies.append((row, out))
            k += CS_LOAD_CLIENTS

    def restart(i):
        deadline = time.monotonic() + 30
        while True:
            try:
                return server(models[i], port=ports[i])
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    def wait_state(i, available, what):
        deadline = time.monotonic() + 60
        while True:
            rep = rs.healthz()["replicas"][names[i]]
            if rep["available"] == available and (
                    not available or rep["breaker"] == "closed"):
                return
            if time.monotonic() > deadline:
                raise AssertionError(f"cluster_serve router: {what}: {rep}")
            time.sleep(0.02)

    threads = [threading.Thread(target=http_load, args=(c,))
               for c in range(CS_LOAD_CLIENTS)]
    for t in threads:
        t.start()
    try:
        wait_replies(http_replies, CS_PHASE_REPLIES, "steady")
        servers[0].kill()
        wait_state(0, False, "killed replica still available")
        wait_replies(http_replies, len(http_replies) + CS_PHASE_REPLIES,
                     "one replica")
        servers[0] = restart(0)
        every.append(servers[0])
        wait_state(0, True, "replica 0 never re-admitted")
        if not servers[1].drain(timeout=60.0):
            raise AssertionError("cluster_serve router: drain never "
                                 "settled")
        servers[1].stop()
        servers[1] = restart(1)
        every.append(servers[1])
        wait_state(1, True, "replica 1 never returned")
        wait_replies(http_replies, len(http_replies) + CS_PHASE_REPLIES,
                     "after the restarts")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        fe.stop()
        for s in servers:
            s.stop()
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"cluster_serve router: {failures[:3]}")
    router_batches = sum(s.stats()["batches"] for s in every)
    router_forwards = models[1].compile_count + router_batches
    router_launches = read_counts(fa, "cluster_serve router",
                                  **{BF16_KERNEL: router_forwards})
    router = {"clients": CS_LOAD_CLIENTS, "requests": len(http_ms),
              "p50_ms": float(np.percentile(http_ms, 50)),
              "p99_ms": float(np.percentile(http_ms, 99)), "failures": 0,
              "replies_by_server": [s.stats()["replies"] for s in every],
              "forwards": router_forwards,
              "flash_launches": router_launches,
              "agree": check_replies(http_replies, {"direct": ref},
                                     "router")}

    res = {"phase": "cluster_serve", "card": card, "config": BERT_BASE,
           "seq": SEQ, "dtype": "bfloat16", "batch_size": CS_BATCH,
           "inference_workers": CS_WORKERS, "buckets": im.batch_buckets,
           "setup_s": setup_s, "levels": levels, "forwards": forwards,
           "compile_count": im.compile_count, "flash_launches": launches,
           "fwd_launches_by_design": fwd_designs, "native_queue": True,
           "agree": agree, "profiled_c64": busy,
           "p50_ms_c64_by_wait": waits, "eager_c16": eager_res,
           "swap": swap, "router": router,
           "peak_memory_bytes_main_path": peak_main}
    emit(res)
    return res


def int8_gemm_shapes() -> list:
    """(layer, M, K, N, launches per forward) of the int8 products of a
    calibrated BERT-base forward at each bucket: ffn1 and ffn2 in each of
    the 12 layers over bucket x SEQ rows, the pooler over the bucket's CLS
    rows.  The head (768 x 2: 1,536 elements, under the 4,096 of
    ``_Q_MIN_SIZE``) keeps a bf16 kernel and so runs no int8 product (0 a
    forward); its shape is timed all the same, as the N = 2 padding case.
    The attention projections stay weight-only."""
    h = BERT_BASE["hidden_size"]
    ffn, n = h * BERT_BASE["intermediate_mult"], BERT_BASE["n_layers"]
    shapes = []
    for b in BUCKETS:
        shapes += [("ffn1", b * SEQ, h, ffn, n), ("ffn2", b * SEQ, ffn, h, n),
                   ("pooler", b, h, h, 1), ("head", b, h, 2, 0)]
    return shapes


def int8_gemm_timings(quant) -> list:
    """``quant.int_mm`` (``torch._int_mm``, zero-padded where the card
    wants it) at every calibrated BERT-base shape: bit for bit against a
    float64 product on the card, its time (events; device) beside its
    bound (int8's dense peak, the bytes at 3.35e12), and beside it the
    whole int8 Dense (quantize, product, rescale), the weight-only form
    (bf16 dequantization, then a bf16 GEMM: the W8A16 yardstick) and a
    bf16 GEMM alone."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for layer, m, k, n, per_fwd in int8_gemm_shapes():
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen,
                          dtype=torch.int8)
        # K-major, as a Dense's Int8Weight keeps it
        w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen,
                          dtype=torch.int8).t()
        if not torch.equal(quant.int_mm(a, w).double(),
                           a.double() @ w.double()):
            raise AssertionError(f"int_mm {layer} {m}x{k}x{n} is not the "
                                 f"exact product")
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        scale = torch.rand(1, n, device="cuda", generator=gen) * 1e-2
        wb = (w.to(torch.bfloat16) * scale.to(torch.bfloat16))
        ctx = quant.QuantApply({"x": 4.0})
        fns = {"int_mm": lambda: quant.int_mm(a, w),
               "int8_dense": lambda: quant.dense_quantized(
                   ctx, "x", x, w, scale, torch.bfloat16),
               "weight_only": lambda: x @ (w.to(torch.bfloat16)
                                           * scale.to(torch.bfloat16)),
               "bf16_gemm": lambda: x @ wb}
        t_ops = 2.0 * m * k * n / PEAK_INT8_OPS
        t_bytes = (m * k + k * n + 4 * m * n) / PEAK_BYTES
        row = {"layer": layer, "m": m, "k": k, "n": n,
               "launches_per_forward": per_fwd, "exact": True,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        for name, fn in fns.items():
            row[f"{name}_ms"] = cuda_ms(fn)
            row[f"{name}_device_ms"] = device_ms(fn)
        rows.append(row)
        del a, w, x, wb
    return rows


def phase_int8_serve(fa) -> dict:
    """BERT-base served in int8 through ``InferenceModel`` from CUDA graphs
    (weight-only, then calibrated on INT8_CALIB seeded sequences): warm,
    predict at batches 1, 3, 16, 64 and 70; the bf16 flash forward's 12
    launches a forward (all ``wgmma``) and, calibrated, 25 int8 products a
    forward (``int8_gemm_shapes``), each counted from the graphs' replays; logits against the f32
    dense model; p50 per bucket; the parameters' bytes on the card.  Then
    ``int_mm`` at every calibrated shape, and ResNet-50 (``norm="batch"``)
    calibrated at batch 16, 224 x 224: every int8 conv bit for bit against
    float64, logits against its bf16 serving."""
    from analytics_zoo_tpu_torch.models import BERTClassifier, ResNet
    from analytics_zoo_tpu_torch.nn import quant
    from analytics_zoo_tpu_torch.nn.layers import Conv2D, conv2d_nhwc
    from analytics_zoo_tpu_torch.serving import InferenceModel

    def served(dtype=None, use_flash=True, calibrate=None):
        model = BERTClassifier(2, use_flash=use_flash, **BERT_BASE)
        return InferenceModel(device="cuda").load(model, variables,
                                                  dtype=dtype,
                                                  calibrate=calibrate)

    variables = random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT_BASE), SEED)
    rng = np.random.default_rng(SEED + 1)
    vocab = BERT_BASE["vocab_size"]
    batches = {n: rng.integers(0, vocab, (n, SEQ)).astype(np.int32)
               for n in (1, 3, 16, 64, 70)}
    calib = np.random.default_rng(SEED + 2).integers(
        0, vocab, (INT8_CALIB, SEQ)).astype(np.int32)
    ref_im = served(use_flash=False)
    refs = {n: ref_im.predict(x) for n, x in batches.items()}
    param_bytes = {"float32": ref_im.parameter_bytes()}
    del ref_im
    bf16_im = served(torch.bfloat16)
    param_bytes["bfloat16"] = bf16_im.parameter_bytes()
    del bf16_im
    bert = {}
    for mode, cal in (("weight_only", None), ("calibrated", calib)):
        t0 = time.perf_counter()
        im = served("int8", calibrate=cal)
        load_s = time.perf_counter() - t0
        top = im.batch_buckets[-1]
        # the main path: warm (an eager forward and a capture per bucket),
        # then predict from the graphs; the counts read right after
        reset_counts(fa)
        mm0 = quant.int_mm.launches
        t0 = time.perf_counter()
        im.warm([(SEQ,)], dtype=np.int32)
        warm_s = time.perf_counter() - t0
        outs = {n: im.predict(x) for n, x in batches.items()}
        forwards = im.compile_count + sum(-(-n // top) for n in batches)
        what = f"int8_serve {mode}"
        launches = read_counts(fa, what, **{BF16_KERNEL: forwards})
        designs = read_fwd_designs(fa, what, "wgmma", forwards)
        mm = quant.int_mm.launches - mm0
        per_fwd = sum(x[4] for x in int8_gemm_shapes()
                      if x[1] in (top, top * SEQ))
        want_mm = forwards * per_fwd if cal is not None else 0
        if mm != want_mm:
            raise AssertionError(f"{what}: {mm} int8 products; want "
                                 f"{want_mm} ({per_fwd} a forward)")
        worst = 0.0
        for n, ref in refs.items():
            y = outs[n]
            if y.shape != (n, 2) or not np.isfinite(y).all():
                raise AssertionError(f"{what}: batch {n} gave {y.shape} or "
                                     f"non-finite logits")
            worst = max(worst, float(np.abs(y - ref).max())
                        / max(1.0, float(np.abs(ref).max())))
        if worst > TOL_INT8_SERVE:
            raise AssertionError(f"{what}: logits differ from f32 dense by "
                                 f"{worst} of max(1, |ref|) > "
                                 f"{TOL_INT8_SERVE}")
        param_bytes[f"int8_{mode}"] = im.parameter_bytes()
        bert[mode] = {
            "load_s": load_s, "warm_s": warm_s, "forwards": forwards,
            "flash_launches": launches, "fwd_launches_by_design": designs,
            "int_mm_launches": mm, "int_mm_per_forward":
                per_fwd if cal is not None else 0,
            "calibrated_layers": len(im._quant_ctx.amax)
            if im._quant_ctx else 0,
            "max_err_rel_to_max_vs_f32_dense": worst,
            "latency": {str(b): served_latency(im, batches[64][:b], SEQ)
                        for b in im.batch_buckets},
            "breakdown_64": profile_call(
                lambda: im.predict(batches[64]), {"flash": ("flash_fwd_",),
                                                  "int8": ("s8", "imma",
                                                           "igemm")})}
        del im
        torch.cuda.empty_cache()
    gemms = int8_gemm_timings(quant)

    # ResNet-50, norm="batch", calibrated int8 against its bf16 serving
    def resnet():
        return ResNet(depth=50, class_num=1000, norm="batch")

    rvars = random_resnet_variables(resnet(), SEED)
    irng = np.random.default_rng(SEED + 3)
    shape = (RESNET_SERVE_BATCH, IMAGE, IMAGE, 3)
    images = irng.normal(size=shape).astype(np.float32)
    calib_images = irng.normal(size=shape).astype(np.float32)
    buckets = (RESNET_SERVE_BATCH,)
    ref_im = InferenceModel(batch_buckets=buckets, device="cuda").load(
        resnet(), rvars, dtype=torch.bfloat16)
    ref = ref_im.predict(images)
    resnet_res = {"bf16_latency": served_latency(ref_im, images),
                  "param_bytes": {"bfloat16": ref_im.parameter_bytes()}}
    del ref_im
    im = InferenceModel(batch_buckets=buckets, device="cuda").load(
        resnet(), rvars, dtype="int8", calibrate=calib_images)
    convs = [m for m in im._model.modules()
             if isinstance(m, Conv2D) and m._act_quant]
    mm0 = quant.int_mm.launches
    n_warm = im.warm([shape[1:]])
    out = im.predict(images)
    mm = quant.int_mm.launches - mm0
    if mm != (n_warm + 1) * (len(convs) + 1):
        raise AssertionError(f"int8_serve resnet: {mm} int8 products; want "
                             f"{(n_warm + 1) * (len(convs) + 1)}")
    err = float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max()))
    agree = float(np.mean(out.argmax(1) == ref.argmax(1)))
    if out.shape != (RESNET_SERVE_BATCH, 1000) or not np.isfinite(out).all() \
            or err > TOL_INT8_RESNET:
        raise AssertionError(f"int8_serve resnet: logits {out.shape} differ "
                             f"from bf16 by {err} of max(1, |ref|) (> "
                             f"{TOL_INT8_RESNET}?) or are not finite")
    # every int8 conv on its own input of one eager forward, against a
    # float64 conv of the same int8 values on the card
    exact = []

    def check(layer, args):
        key = im._paths[id(layer)]
        s_in, xq = quant._quantize_activation(im._quant_ctx, key, args[0])
        w = layer._modules["kernel"].q
        y = quant.conv_int8(xq, w, layer.strides, layer.padding,
                            layer.dilation, layer.groups)
        want = conv2d_nhwc(xq.double(), w.double(), layer.strides,
                           layer.padding, layer.dilation, layer.groups)
        exact.append(bool(torch.equal(y.double(), want)))

    hooks = [c.register_forward_pre_hook(check) for c in convs]
    im._forward(torch.from_numpy(images).cuda())
    for h in hooks:
        h.remove()
    if len(exact) != len(convs) or not all(exact):
        raise AssertionError(f"int8_serve resnet: {exact.count(False)} of "
                             f"{len(convs)} int8 convs differ from float64")
    resnet_res.update({
        "batch": RESNET_SERVE_BATCH, "image": IMAGE, "stem": "conv",
        "int8_convs": len(convs), "convs_exact_vs_float64": len(exact),
        "int_mm_launches": mm, "calibrated_layers": len(im._quant_ctx.amax),
        "max_err_rel_to_max_vs_bf16": err, "top1_agree_vs_bf16": agree,
        "int8_latency": served_latency(im, images)})
    resnet_res["param_bytes"]["int8_calibrated"] = im.parameter_bytes()
    del im
    res = {"phase": "int8_serve", "config": BERT_BASE, "seq": SEQ,
           "batches": sorted(batches), "calibration_rows": INT8_CALIB,
           "tol_vs_f32_dense": TOL_INT8_SERVE, "bert": bert,
           "param_bytes": param_bytes, "int_mm_timings": gemms,
           "resnet50": resnet_res,
           "tol_resnet_vs_bf16": TOL_INT8_RESNET}
    emit(res)
    return res


def window_ms(fn, steps: int) -> tuple:
    """(ms a step, losses): ``fn()`` enqueues ``steps`` train steps and
    returns their losses on the card; the window synchronises only at its
    ends (the last loss read back)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = fn()
    float(losses[-1])
    return (time.perf_counter() - t0) * 1e3 / steps, losses


def losses_against_eager(got, want, what: str) -> dict:
    """A captured run's step losses against the eager step's on the same
    inputs: equal bits expected (the same kernels, inputs and generator
    offsets); a difference is reported and held to TOL_TRAIN_LOSS of
    max(1, |loss|), bert_train (a)'s bound."""
    got, want = [float(v) for v in got], [float(v) for v in want]
    if len(got) != len(want) or not all(map(math.isfinite, got)):
        raise AssertionError(f"{what}: captured losses {got}, eager {want}")
    worst = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))
    if worst > TOL_TRAIN_LOSS:
        raise AssertionError(f"{what}: captured step losses {got} differ "
                             f"from the eager step's {want} by {worst} of "
                             f"max(1, |loss|)")
    return {"steps": len(got), "bitwise_equal": got == want,
            "worst_rel": worst, "tol": TOL_TRAIN_LOSS, "captured": got,
            "eager": want}


def captures(est, what: str) -> dict:
    """``est``'s captures: one per batch key."""
    keys = len(est._graphs)
    if est.capture_count != keys:
        raise AssertionError(f"{what}: {est.capture_count} captures for "
                             f"{keys} batch keys")
    return {"capture_count": est.capture_count, "keys": keys}


def profiled_window(fn, steps: int, shares: dict) -> dict:
    """``profile_call`` over a window of ``steps`` steps, with the card's
    busy time a step."""
    res = profile_call(fn, shares)
    res["device_busy_ms_per_step"] = (res["device_busy_ms"] / steps
                                      if res["device_busy_ms"] else None)
    return res


def idle_of(profiled: dict, step_ms: float) -> None:
    """The card's idle share of an unprofiled window's step: 1 - busy a
    step / step ms (None where the profiler saw no kernel)."""
    busy = profiled["device_busy_ms_per_step"]
    profiled["idle_share_of_window_step"] = \
        None if busy is None else 1.0 - busy / step_ms


def stream_chunks(est, feed, chunk_steps: int, n_chunks: int) -> dict:
    """bench.py's ``_stream_train`` on the port: ``chunk_steps`` host
    batches of the feed stacked into one chunk, one copy to the card a
    leaf and ``chunk_steps`` replays (``_multi_step_data``); one chunk to
    warm, then ``n_chunks`` timed with a synchronisation at the end only.
    The feed's decode workers are joined before it returns."""
    it = feed.epoch(est.device, 0, place=False)

    def next_chunk():
        host = [next(it) for _ in range(chunk_steps)]
        chunk = {k: np.stack([h[k] for h in host]) for k in host[0]}
        for h in host:  # a process backend's slots go back to its pool
            getattr(h, "release", lambda: None)()
        return chunk

    prep, dispatch = [], []  # host ms a chunk: the feed, the call
    try:
        float(est._multi_step_data(next_chunk())[-1])
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            t1 = time.perf_counter()
            chunk = next_chunk()
            t2 = time.perf_counter()
            losses = est._multi_step_data(chunk)
            prep.append((t2 - t1) * 1e3)
            dispatch.append((time.perf_counter() - t2) * 1e3)
        float(losses[-1])
        dt = time.perf_counter() - t0
    finally:
        it.close()
    steps = chunk_steps * n_chunks
    return {"chunk_steps": chunk_steps, "chunks": n_chunks, "steps": steps,
            "step_ms": dt * 1e3 / steps, "host_feed_ms_per_chunk": prep,
            "host_call_ms_per_chunk": dispatch, "backend": feed.workers,
            "workers": feed.num_workers,
            "prefetch_batches": feed.prefetch_batches,
            "last_losses": [float(v) for v in losses]}


def fork_probe() -> dict:
    """A forked decode worker of the streaming feed, after this process
    made its CUDA context: torch marks the child as forked from a CUDA
    process (a CUDA call there would raise), and the child ran the loader
    on numpy only."""
    from analytics_zoo_tpu_torch.data import StreamingDataFeed

    def load(i, rng=None):
        time.sleep(0.01)  # so that both workers take batches
        return {"bad_fork": np.int32(torch.cuda._is_in_bad_fork()),
                "pid": np.int64(os.getpid())}

    feed = StreamingDataFeed(8, load, batch_size=2, shuffle=False,
                             num_workers=2, workers="process")
    rows = []
    for b in feed.epoch(torch.device("cuda"), 0, place=False):
        rows.append({k: np.asarray(v).copy() for k, v in b.items()})
        b.release()
    pids = {int(p) for r in rows for p in r["pid"]}
    flags = {int(f) for r in rows for f in r["bad_fork"]}
    if os.getpid() in pids or flags != {1}:
        raise AssertionError(f"fork probe: worker pids {pids} (parent "
                             f"{os.getpid()}), bad-fork flags {flags}")
    return {"worker_pids": len(pids), "children_marked_bad_fork": True,
            "parent_has_cuda_context": torch.cuda.is_initialized()}


def failed_capture_check() -> dict:
    """In a process of its own (a failed capture may leave the context in
    no state to go on): a step that reads a value back to the host cannot
    be captured, and the Estimator raises, naming the call; it does not
    fall back to eager."""
    code = (
        "import numpy as np, torch\n"
        "from analytics_zoo_tpu_torch import nn as tnn\n"
        "from analytics_zoo_tpu_torch.orca.learn import Estimator\n"
        "class HostRead(torch.nn.Module):\n"
        "    def __init__(self):\n"
        "        super().__init__(); self.dense = tnn.Dense(2, 2)\n"
        "    def forward(self, x):\n"
        "        return self.dense(x) * float(x.abs().max())\n"
        "est = Estimator.from_keras(HostRead(), loss='mse', optimizer='sgd',"
        " learning_rate=0.1)\n"
        "x = np.ones((4, 2), np.float32)\n"
        "try:\n"
        "    est.fit((x, x), epochs=1, batch_size=4, verbose=False)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', str(e).splitlines()[0][:400])\n"
        "else:\n"
        "    print('RAN', est.capture_count)\n")
    import tempfile
    # from a file, so that the traceback the error names has its source
    with tempfile.NamedTemporaryFile("w", suffix=".py") as f:
        f.write(code)
        f.flush()
        out = subprocess.run([sys.executable, f.name], capture_output=True,
                             text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=os.path.dirname(
                                 os.path.abspath(__file__))))
    line = next((ln for ln in out.stdout.splitlines()
                 if ln.startswith(("RAISED", "RAN"))), "")
    if not (line.startswith("RAISED") and "capture of the train step" in line
            and "float(" in line):
        raise AssertionError(f"a capture with a host read: {line!r} "
                             f"{out.stderr[-2000:]}")
    return {"raised": True, "message": line[len("RAISED "):]}


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
                                   seed=SEED, cuda_graphs=False)
        inner = est._train_step
        hist[use_flash], _ = record_steps(est)
        reset_counts(fa)
        est.fit((x3, y3), epochs=1, batch_size=CHECK_BATCH, verbose=False)
        if use_flash:
            f32_launches = read_counts(fa, "bert_train f32", **{
                F32_KERNEL: CHECK_STEPS, BWD_KERNEL: CHECK_STEPS})
            f32_fwd_designs = read_fwd_designs(fa, "bert_train f32",
                                               "wgmma_tf32", CHECK_STEPS)
            f32_bwd_designs = read_bwd_designs(fa, "bert_train f32",
                                               "wgmma_tf32", CHECK_STEPS)
            # one more step, profiled: the card's busy time and the flash
            # kernels' share (both directions' split passes included)
            batch = next(as_feed((x3, y3), CHECK_BATCH, seed=SEED).epoch(
                est.device, 0))
            f32_profiled = profile_call(lambda: inner(batch), {
                "flash_fwd": ("flash_fwd_",),
                "flash_bwd": ("bwd_dkdv", "bwd_dq", "bwd_delta"),
                "flash_split": ("split_tf32",)})
        del est, inner
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
                 "loss_tol": TOL_TRAIN_LOSS, "launches": f32_launches,
                 "fwd_launches_by_design": f32_fwd_designs,
                 "bwd_launches_by_design": f32_bwd_designs,
                 "profiled_step": f32_profiled}

    # (b) the bf16 run: dropout 0.1, global batch 32, 20 steps
    x, y = squad_examples(rng, TRAIN_EXAMPLES)
    est = Estimator.from_keras(model(True, dropout=0.1, dtype=torch.bfloat16),
                               loss=squad_span_loss, optimizer="adamw",
                               learning_rate=TRAIN_LR, seed=SEED,
                               cuda_graphs=False)
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
    fwd_designs = read_fwd_designs(fa, "bert_train bf16", "wgmma", steps)
    bwd_designs = read_bwd_designs(fa, "bert_train bf16", "wgmma", steps)
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
        optimizer="adamw", learning_rate=TRAIN_LR, seed=SEED,
        cuda_graphs=False)
    repeat_losses, _ = record_steps(again)
    again.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
              verbose=False)
    del again
    if repeat_losses != step_losses:
        raise AssertionError(f"bert_train bf16: a second fit with seed "
                             f"{SEED} gave step losses {repeat_losses}, the "
                             f"first {step_losses}")
    captured = bert_train_captured(fa, model, x, y, step_losses, steps, rng)
    res = {"phase": "bert_train", "config": dict(BERT_BASE, dropout=0.1),
           "seq": SEQ, "dtype": "bfloat16", "optimizer": "adamw",
           "learning_rate": TRAIN_LR, "global_batch": TRAIN_BATCH,
           "examples": TRAIN_EXAMPLES, "epochs": TRAIN_EPOCHS, "steps": steps,
           "setup_s": setup_s, "fit_s": fit_s, "loss": losses,
           "step_losses": step_losses,
           "loss_fall_limit": LOSS_FALL, "launches": launches,
           "fwd_launches_by_design": fwd_designs,
           "bwd_launches_by_design": bwd_designs,
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
           "f32_check": f32_check, "captured": captured}
    emit(res)
    return res


def bert_train_captured(fa, model, x, y, eager_losses, steps, rng) -> dict:
    """bert_train (d): the (b) fine-tune from CUDA graphs through
    ``fit(prefetch=2)``: the eager (b) fit's step losses (dropout 0.1, its
    masks from the generator registered with the graph), 12 + 12 flash
    launches a step counted from the replays, one capture; then a window
    of 20 steps (one epoch of 640 fresh examples, synchronised at its
    ends) beside the eager step's same window, a profiled fit, peak
    memory, and a capture that must fail, in a process of its own."""
    from analytics_zoo_tpu_torch.models import squad_span_loss
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    def make(graphs):
        return Estimator.from_keras(
            model(True, dropout=0.1, dtype=torch.bfloat16),
            loss=squad_span_loss, optimizer="adamw", learning_rate=TRAIN_LR,
            seed=SEED, cuda_graphs=graphs)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = make(True)
    got, inner = [], est._train_step

    def keep(batch):  # each step's loss, read after the fit
        loss = inner(batch)
        got.append(loss)
        return loss

    est._train_step = keep
    reset_counts(fa)
    est.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
            verbose=False, prefetch=2)
    launches = read_counts(fa, "bert_train (d)",
                           **{BF16_KERNEL: steps, BWD_KERNEL: steps})
    fwd_designs = read_fwd_designs(fa, "bert_train (d)", "wgmma", steps)
    bwd_designs = read_bwd_designs(fa, "bert_train (d)", "wgmma", steps)
    against = losses_against_eager(got, eager_losses, "bert_train (d)")
    est._train_step = inner
    window = 20
    xw, yw = squad_examples(rng, TRAIN_BATCH * window)
    ms = {}
    for graphs in (True, False):
        run = est if graphs else make(False)
        if not graphs:  # warm: the optimizer's state, cuBLAS's workspace
            run.fit((x, y), epochs=1, batch_size=TRAIN_BATCH, verbose=False,
                    prefetch=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.fit((xw, yw), epochs=1, batch_size=TRAIN_BATCH, verbose=False,
                prefetch=2)  # the epoch's loss read back: synchronised
        ms[graphs] = (time.perf_counter() - t0) * 1e3 / window
        if not graphs:
            del run
    profiled = profiled_window(
        lambda: est.fit((x, y), epochs=1, batch_size=TRAIN_BATCH,
                        verbose=False, prefetch=2),
        TRAIN_EXAMPLES // TRAIN_BATCH,
        {"flash_fwd": ("flash_fwd_",),
         "flash_bwd": ("bwd_dkdv", "bwd_dq", "bwd_delta")})
    idle_of(profiled, ms[True])
    caps = captures(est, "bert_train (d)")
    peak = torch.cuda.max_memory_allocated()
    del est
    torch.cuda.empty_cache()
    tokens_per_s = TRAIN_BATCH * SEQ / (ms[True] / 1e3)
    return {"path": "fit(prefetch=2) from CUDA graphs", "steps": steps,
            "losses_against_eager": against, "launches": launches,
            "fwd_launches_by_design": fwd_designs,
            "bwd_launches_by_design": bwd_designs,
            "window_steps": window, "step_ms": ms[True],
            "eager_step_ms": ms[False], "tokens_per_s": tokens_per_s,
            "model_tflop_per_s": tokens_per_s * 3 * bert_flops_per_token()
            / 1e12, "profiled": profiled, "peak_memory_bytes": peak,
            "failed_capture": failed_capture_check(), **caps}


class TrainNet(torch.nn.Module):
    """bench.py's ResNet-50 training net: uint8 NHWC images, normalised on
    the card to ``(x - 127) / 64`` in the model's dtype (or in
    ``input_dtype``: float64 for the numerical reference), into
    ``resnet``."""

    def __init__(self, input_dtype=None, **kw):
        super().__init__()
        from analytics_zoo_tpu_torch.models import ResNet
        self.resnet = ResNet(**dict(RESNET, **kw))
        self.input_dtype = input_dtype or self.resnet.dtype

    def forward(self, x):
        return self.resnet((x.to(self.input_dtype) - 127.0) * (1.0 / 64.0))


def bn_textbook(x, gamma, beta, eps):
    """Training batch norm as the textbook writes it, differentiated by
    autograd, in x's dtype: the float64 reference of resnet_train (a)."""
    red = tuple(range(x.dim() - 1))
    mean, var = x.mean(red), x.var(red, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta, mean, var


def random_resnet_variables(model: torch.nn.Module, seed: int) -> dict:
    """Random weights made with numpy in the JAX tree layout, drawn from
    the JAX initializers' distributions: he-normal conv kernels (HWIO),
    glorot-uniform head, unit gains, zero biases and shifts, running mean 0
    and variance 1, SkipInit gains 0."""
    from analytics_zoo_tpu_torch.convert import buffer_names, to_jax_variables
    rng = np.random.default_rng(seed)

    def draw(leaf, shape):
        if leaf == "kernel" and len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            return rng.normal(0.0, math.sqrt(2.0 / fan_in), shape)
        if leaf == "kernel":
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            return rng.uniform(-lim, lim, shape)
        if leaf in ("gamma", "ws_gain", "var"):
            return np.ones(shape)
        return np.zeros(shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else draw(k, v.shape).astype(np.float32)
                for k, v in node.items()}

    return walk(to_jax_variables(model.state_dict(), buffer_names(model)))


def model_flops_per_image(model: torch.nn.Module, x: torch.Tensor) -> float:
    """Forward FLOP per image of the convs and dense layers, from the
    shapes one forward gives them: 2 x output elements x fan in (a conv
    kernel OIHW, the space-to-depth stem counted as the 7x7 conv it
    computes)."""
    from analytics_zoo_tpu_torch.nn import Dense
    total = [0.0]

    def hook(m, _inp, out):
        k = m.kernel
        fan_in = k.shape[0] if isinstance(m, Dense) else k[0].numel()
        total[0] += 2.0 * out.numel() * fan_in

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(getattr(m, "kernel", None), torch.nn.Parameter)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0] / x.shape[0]


def resnet_bn_maps(batch: int, device: str = "cuda") -> dict:
    """Every distinct (rows, C) the 53 batch norms of ResNet-50 see at
    ``batch`` 224 x 224 images, in the order of the forward, with how many
    norms see it (one image through the model on ``device``)."""
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    model = TrainNet().to(device)
    maps: dict = {}

    def hook(_m, inp, _out):
        *lead, c = inp[0].shape
        key = (batch * math.prod(lead[1:]), c)
        maps[key] = maps.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, BatchNormalization)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, IMAGE, IMAGE, 3, dtype=torch.uint8,
                                 device=device))
    for h in hooks:
        h.remove()
    if sum(maps.values()) != RESNET_BN:
        raise AssertionError(f"ResNet-50 ran {sum(maps.values())} batch "
                             f"norms")
    return maps


def bn_inputs(gen, rows, c, dtype, offset=0):
    """x (channel 0 centred at 1e3 times its std), gamma, beta, dy and
    non-zero dmean, dvar on the card; ``offset`` elements into a buffer
    (an unaligned view) when given."""
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = 2.0 + r(rows, c)
    x[:, 0] += 1e3 - 2.0
    if offset:
        buf = torch.empty(rows * c + offset, device="cuda", dtype=dtype)
        buf[offset:] = x.reshape(-1).to(dtype)
        x = buf[offset:].view(rows, c)
    else:
        x = x.to(dtype)
    return x, 1.0 + 0.1 * r(c), 0.1 * r(c), r(rows, c).to(dtype), r(c), r(c)


def bn_bound(rows: int, c: int, itemsize: int, direction: str) -> tuple:
    """(ms, "bytes"): forward reads x and writes y (2 maps), backward reads
    dy and x and writes dx (3 maps), the [C] vectors beside them."""
    maps = 2 if direction == "fwd" else 3
    vectors = 5 if direction == "fwd" else 8
    return (maps * rows * c * itemsize + vectors * c * 4) / PEAK_BYTES \
        * 1e3, "bytes"


def phase_fused_bn(bn) -> dict:
    """The fused batch-norm kernels against their plain versions at every
    ResNet-50 shape (batch 128) and the edge cases, forward (y, mean, var)
    and backward (dx, dgamma, dbeta, with non-zero dmean/dvar), both
    dtypes; bit-for-bit repeats; then times at the stem's shape, the one
    the most norms see and the last stage's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"f32": 0.0, "bf16_rel": 0.0, "stats": 0.0}
    eps = 1e-3

    def check(x, g, b, dy, dm, dv):
        y, m, v = bn.bn_train_fwd(x, g, b, eps)
        dx, dg, db = bn.bn_train_bwd(x, g, m, v, dy, dm, dv, eps)
        ry, rm, rv = bn.bn_train_fwd_reference(x, g, b, eps)
        rdx, rdg, rdb = bn.bn_train_bwd_reference(x, g, m, v, dy, dm, dv,
                                                  eps)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, ref in (("y", y, ry), ("dx", dx, rdx), ("mean", m, rm),
                             ("var", v, rv), ("dgamma", dg, rdg),
                             ("dbeta", db, rdb)):
            if a.shape != ref.shape or a.dtype != ref.dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"fused_bn {name}: {tuple(a.shape)} "
                                     f"{a.dtype} at {tuple(x.shape)}")
            e = (a.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            if name in ("y", "dx") and x.dtype == torch.bfloat16:
                rel, tol, key = e / max(top, 1e-30), TOL_BN_BF16_REL, \
                    "bf16_rel"
            elif name in ("y", "dx"):
                rel, tol, key = e / max(1.0, top), TOL_BN_F32, "f32"
            else:
                rel, tol, key = e / max(1.0, top), TOL_BN_STATS, "stats"
            worst[key] = max(worst[key], rel)
            if name in ("y", "dx"):
                err = max(err, e)
            if rel > tol:
                raise AssertionError(
                    f"fused_bn kernel disagrees with its plain version at "
                    f"{tuple(x.shape)} {x.dtype}: {name} err {e} of {top}")
        return (y, m, v, dx, dg, db), err

    counts = resnet_bn_maps(RESNET_BATCH)
    shapes = list(counts)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(rows, c, dt, 0) for rows, c in shapes + BN_EDGE
             for dt in dtypes]
    cases += [(3001, 64, dt, 1) for dt in dtypes]  # unaligned: scalar path
    for rows, c, dt, offset in cases:
        check(*bn_inputs(gen, rows, c, dt, offset))
    # no atomics: one input, identical bits
    for rows, c in (shapes[0], shapes[-1]):
        inputs = bn_inputs(gen, rows, c, torch.bfloat16)
        first, _ = check(*inputs)
        again, _ = check(*inputs)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"fused_bn: two runs at {(rows, c)} differ")

    timings = []
    last_stage = max((s for s in shapes if s[0] == shapes[-1][0]),
                     key=lambda s: s[1])
    most_norms = max(counts, key=counts.get)  # 25,088 x 256: 11 of 53
    for label, (rows, c) in (("stem", shapes[0]), ("most_norms", most_norms),
                             ("stage3", last_stage)):
        for dt in dtypes:
            x, g, b, dy, dm, dv = bn_inputs(gen, rows, c, dt)
            _, err = check(x, g, b, dy, dm, dv)
            y, m, v = bn.bn_train_fwd(x, g, b, eps)
            # F.batch_norm's yardstick on the same map as a channels_last
            # NCHW tensor (training mode, its own statistics)
            hw = rows // RESNET_BATCH
            side = int(math.isqrt(hw))
            x4 = x.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
            lib_in = x4.detach().requires_grad_()
            lib_w, lib_b = (t.detach().requires_grad_() for t in (g, b))
            run_m, run_v = torch.zeros(c, device="cuda"), \
                torch.ones(c, device="cuda")

            def lib_fwd():
                return torch.nn.functional.batch_norm(
                    lib_in, run_m, run_v, lib_w, lib_b, training=True,
                    momentum=0.01, eps=eps)

            lib_out = lib_fwd()
            dy4 = dy.view(RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)
            for direction, kernel, plain, library in (
                    ("fwd", lambda: bn.bn_train_fwd(x, g, b, eps),
                     lambda: bn.bn_train_fwd_reference(x, g, b, eps),
                     lambda: torch.nn.functional.batch_norm(
                         x4, run_m, run_v, g, b, training=True,
                         momentum=0.01, eps=eps)),
                    ("bwd",
                     lambda: bn.bn_train_bwd(x, g, m, v, dy, dm, dv, eps),
                     lambda: bn.bn_train_bwd_reference(x, g, m, v, dy, dm,
                                                       dv, eps),
                     lambda: torch.autograd.grad(
                         lib_out, (lib_in, lib_w, lib_b), dy4,
                         retain_graph=True))):
                ms, plain_ms, library_ms = (cuda_ms(f, iters=10)
                                            for f in (kernel, plain, library))
                dev_ms, plain_dev_ms, library_dev_ms = (
                    device_ms(f, iters=10) for f in (kernel, plain, library))
                bound_ms, bound_by = bn_bound(rows, c, x.element_size(),
                                              direction)
                timings.append({
                    "kernel": BN_KERNEL, "direction": direction,
                    "shape": label, "rows": rows, "c": c,
                    "dtype": str(dt).replace("torch.", ""),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    "library_device_ms": library_dev_ms,
                    "library": "F.batch_norm(training=True), channels_last",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "device_share_of_bound": bound_ms / dev_ms})
            del lib_in, lib_out, x, dy, x4, dy4, y
    res = {"phase": "fused_bn", "cases": len(cases),
           "resnet50_shapes_batch128": shapes,
           "resnet50_norms_by_shape": [[*k, n] for k, n in counts.items()],
           "edge_shapes": BN_EDGE,
           "worst": worst,
           "tolerances": {"f32_rel_to_max1": TOL_BN_F32,
                          "bf16_rel_to_max": TOL_BN_BF16_REL,
                          "stats_rel_to_max1": TOL_BN_STATS},
           "repeat_bitwise_identical": True, "timings": timings}
    emit(res)
    return res


def read_bn_counts(bn, what: str, **per_pass: int) -> dict:
    """The fused batch-norm launch counts since ``reset_launches``: each
    pass of the dtypes named in ``per_pass`` (``bf16=20`` means 20 steps)
    ``RESNET_BN`` times a step, no other."""
    counts = dict(bn.KERNEL_LAUNCHES)
    want = {name: RESNET_BN * per_pass.get(name.rsplit("_", 1)[1], 0)
            for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: fused_bn launches {counts}; want "
                             f"{want}")
    return counts


def phase_resnet_train(bn) -> dict:
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.nn import BatchNormalization
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    t0 = time.perf_counter()
    variables = {norm: random_resnet_variables(TrainNet(norm=norm), SEED)
                 for norm in ("batch", "nf")}
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 4)

    def model(norm="batch", plain=False, **kw):
        m = TrainNet(norm=norm, **kw)
        m.load_state_dict(from_jax_variables(variables[norm]), strict=True)
        if plain:  # the yardstick: the plain batch norm on the card
            for layer in m.modules():
                if isinstance(layer, BatchNormalization):
                    layer.train_fn = bn.bn_train_plain
        return m.cuda()

    def images(n):
        return (rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8),
                rng.integers(0, RESNET["class_num"], n).astype(np.int32))

    loss_name = "sparse_categorical_crossentropy"

    def estimator(m, graphs=False):
        return Estimator.from_keras(m, loss=loss_name, optimizer="sgd",
                                    learning_rate=RESNET_LR, seed=SEED,
                                    cuda_graphs=graphs)

    # (a) f32, batch 8: the fused kernels and the plain batch norm, each in
    # an f32 model on the card, against a float64 model (textbook batch
    # norm through autograd).  This model's f32 gradients at a random init
    # carry percents of rounding noise however they are summed (train-mode
    # batch norm's backward subtracts per-channel projections that nearly
    # cancel; f32 vs f64 on the CPU: 2% at the stem, 15% in stage 3), so
    # the fused model is held to the plain one's distance from float64,
    # not to the plain f32 model itself
    xa, ya = images(RESNET_CHECK_BATCH)
    xt, yt = torch.from_numpy(xa).cuda(), torch.from_numpy(ya).cuda()
    grads, buffers, losses0 = {}, {}, {}
    for kind in ("fused", "plain", "f64"):
        if kind == "f64":
            m = model(dtype="float32", input_dtype=torch.float64).double()
            for layer in m.modules():
                if isinstance(layer, BatchNormalization):
                    layer.train_fn = bn_textbook
        else:
            m = model(plain=kind == "plain", dtype="float32")
        bn.reset_launches()
        out = m.train()(xt).double()
        loss = (torch.logsumexp(out, dim=-1)
                - out.gather(1, yt.long()[:, None])[:, 0]).mean()
        names = [n for n, _ in m.named_parameters()]
        grads[kind] = dict(zip(names, torch.autograd.grad(
            loss, list(m.parameters()))))
        read_bn_counts(bn, f"resnet_train {kind} gradients",
                       **({"f32": 1} if kind == "fused" else {}))
        buffers[kind] = {k: b.clone() for k, b in m.named_buffers()}
        losses0[kind] = float(loss.detach())
        del m, loss, out
    noise = {}
    for kind in ("fused", "plain"):
        noise[kind] = max(
            (grads[kind][n].double() - g).abs().max().item()
            / max(g.abs().max().item(), 1e-30)
            for n, g in grads["f64"].items())
    if noise["fused"] > RESNET_NOISE_FACTOR * noise["plain"] + TOL_TRAIN_GRAD:
        raise AssertionError(
            f"resnet_train f32: the fused model's gradients lie {noise} of "
            f"each tensor's max from float64, the plain model's "
            f"{noise['plain']}")
    worst_buf = 0.0
    for name, ref in buffers["plain"].items():
        err = (buffers["fused"][name] - ref).abs().max().item()
        top = ref.abs().max().item()
        worst_buf = max(worst_buf, err / top)
        if err > TOL_TRAIN_GRAD * top:
            raise AssertionError(f"resnet_train f32: running statistic "
                                 f"{name} differs by {err} of max {top}")
    del grads, buffers
    # 3 steps over 3 distinct batches at a small learning rate: at 0.1 the
    # second step's loss is chaotic in the gradients' rounding noise, and
    # at 1e-4 that noise still moved it by 7.7e-5 on an H100
    x3, y3 = images(RESNET_CHECK_BATCH * CHECK_STEPS)
    hist = {}
    for plain in (False, True):
        est = Estimator.from_keras(model(plain=plain, dtype="float32"),
                                   loss=loss_name, optimizer="sgd",
                                   learning_rate=RESNET_CHECK_LR, seed=SEED,
                                   cuda_graphs=False)
        hist[plain], _ = record_steps(est)
        bn.reset_launches()
        est.fit((x3, y3), epochs=1, batch_size=RESNET_CHECK_BATCH,
                verbose=False)
        counts = read_bn_counts(bn, "resnet_train f32 fit",
                                **({} if plain else {"f32": CHECK_STEPS}))
        if not plain:
            f32_launches = counts
        del est
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(hist[False], hist[True]))
    if loss_err > TOL_TRAIN_LOSS or not all(map(math.isfinite, hist[False])):
        raise AssertionError(f"resnet_train f32: loss history {hist[False]}"
                             f" (fused) vs {hist[True]} (plain)")
    f32_check = {"batch": RESNET_CHECK_BATCH, "steps": CHECK_STEPS,
                 "grad_worst_rel_to_tensor_max_vs_f64": noise,
                 "grad_noise_factor": RESNET_NOISE_FACTOR,
                 "grad_tol": TOL_TRAIN_GRAD, "first_loss": losses0,
                 "running_stats_worst_rel_to_tensor_max": worst_buf,
                 "fit_learning_rate": RESNET_CHECK_LR,
                 "loss_fused": hist[False], "loss_plain": hist[True],
                 "loss_worst_rel": loss_err, "loss_tol": TOL_TRAIN_LOSS,
                 "launches": f32_launches}

    # (b) bench.py's recipe, norm="batch", bf16: 20 steps of batch 128
    x, y = images(RESNET_POOL)
    steps = RESNET_EPOCHS * (RESNET_POOL // RESNET_BATCH)
    runs = {}
    for norm in ("batch", "nf"):
        est = estimator(model(norm, dtype="bfloat16"))
        inner = est._train_step
        step_losses, step_ms = record_steps(est)
        bn.reset_launches()
        t0 = time.perf_counter()
        losses = est.fit((x, y), epochs=RESNET_EPOCHS,
                         batch_size=RESNET_BATCH, verbose=False)["loss"]
        fit_s = time.perf_counter() - t0
        launches = read_bn_counts(bn, f"resnet_train {norm}",
                                  **({"bf16": steps} if norm == "batch"
                                     else {}))
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"resnet_train {norm}: loss {losses}")
        if norm == "batch" and losses[-1] > LOSS_FALL * losses[0]:
            raise AssertionError(f"resnet_train batch: loss {losses} did "
                                 f"not fall to {LOSS_FALL} of its first "
                                 f"epoch")
        p50 = float(np.median(step_ms[-10:]))
        batch = next(as_feed((x, y), RESNET_BATCH, seed=SEED).epoch(
            est.device, 0))
        flops = model_flops_per_image(est.model, batch["x"][:1])
        profiled = profile_call(lambda: inner(batch), {
            "batch_norm": ("bn_fwd_kernel", "bn_bwd_kernel")})
        # the profiler slows the host, so beside its own idle share the
        # card's busy time is also set against the unprofiled step p50
        profiled["idle_share_of_p50_step"] = 1.0 - \
            profiled["device_busy_ms"] / p50
        runs[norm] = {
            "loss": losses, "step_losses": step_losses, "fit_s": fit_s,
            "launches": launches, "step_ms_last10": step_ms[-10:],
            "step_ms_p50": p50, "images_per_s": RESNET_BATCH / (p50 / 1e3),
            "forward_gflop_per_image": flops / 1e9,
            "model_tflop_per_s": 3 * flops * RESNET_BATCH / p50 / 1e9,
            "profiled_step": profiled}
        if norm == "batch":
            x_eval, y_eval = images(5)
            x_eval = np.concatenate([x, x_eval])
            y_eval = np.concatenate([y, y_eval])
            evaluated = est.evaluate((x_eval, y_eval),
                                     batch_size=RESNET_BATCH)
            pred = est.predict(x_eval, batch_size=RESNET_BATCH)
            if pred.shape != (len(x_eval), RESNET["class_num"]) \
                    or not np.isfinite(pred).all() \
                    or not math.isfinite(evaluated["loss"]):
                raise AssertionError(f"resnet_train: predict gave "
                                     f"{pred.shape}, evaluate {evaluated}")
            runs[norm]["evaluate"] = evaluated
            runs[norm]["predict_rows"] = int(pred.shape[0])
        del est, inner
        torch.cuda.empty_cache()
        if norm == "batch":
            # one seed, one loss history: two more fits from the same
            # weights with cuDNN's deterministic algorithms (its default
            # weight-gradient algorithms may add in another order from run
            # to run; the batch-norm kernels use no atomics) must give
            # identical step losses; the default fit's distance from them
            # is reported
            torch.backends.cudnn.deterministic = True
            repeats = []
            for _ in range(2):
                again = estimator(model(norm, dtype="bfloat16"))
                repeats.append(record_steps(again)[0])
                again.fit((x, y), epochs=RESNET_EPOCHS,
                          batch_size=RESNET_BATCH, verbose=False)
                del again
                torch.cuda.empty_cache()
            torch.backends.cudnn.deterministic = False
            if repeats[0] != repeats[1]:
                raise AssertionError(
                    f"resnet_train: two deterministic fits with seed {SEED} "
                    f"gave step losses {repeats[0]} and {repeats[1]}")
            runs[norm]["repeat_identical"] = True
            runs[norm]["default_vs_deterministic_worst_rel"] = max(
                abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(step_losses, repeats[0]))
    captured = resnet_captured(bn, model, estimator, x, y, runs)
    res = {"phase": "resnet_train", "config": RESNET, "image": IMAGE,
           "dtype": "bfloat16", "optimizer": "sgd",
           "learning_rate": RESNET_LR, "global_batch": RESNET_BATCH,
           "pool": RESNET_POOL, "epochs": RESNET_EPOCHS, "steps": steps,
           "setup_s": setup_s, "loss_fall_limit": LOSS_FALL,
           "flop_convention": "3 x forward FLOP of the convs and the dense "
                              "head from their shapes (2 x outputs x fan "
                              "in; the space-to-depth stem as its 7x7 "
                              "conv); batch norm, relu, pooling, loss and "
                              "optimizer not counted",
           "batch": runs["batch"], "nf": runs["nf"], "f32_check": f32_check,
           "captured": captured}
    emit(res)
    return res


def resnet_captured(bn, model, estimator, pool, labels, runs) -> dict:
    """resnet_train (d): bench.py's ``bench_resnet50`` from CUDA graphs,
    both norms.  The step losses of ``_multi_step(b0, 5)`` against the
    eager step's under cuDNN's deterministic algorithms (its default
    weight-gradient algorithms may sum in another order from run to run);
    then, with the default algorithms, the eager window of 20 steps and
    the captured one after a warm call, three times (bench.py's 20 x 3),
    53 launches of each batch-norm kernel a step counted from the
    replays, a profiled window, peak memory; and the streaming phase:
    worker processes (forked after this process made its CUDA context)
    decode the seeded pool with random flips into shared-memory slots,
    ``_multi_step_data`` over 4 chunks of 5, then over 8 on a fresh
    feed."""
    from analytics_zoo_tpu_torch.data import StreamingDataFeed, as_feed

    b0 = next(as_feed((pool[:RESNET_BATCH], labels[:RESNET_BATCH]),
                      RESNET_BATCH, shuffle=False).epoch(
                          torch.device("cuda"), 0))
    steps, repeats = RESNET_RESIDENT
    chunk_steps, n_chunks = RESNET_STREAM
    n_workers = max(4, min(16, os.cpu_count() or 8))

    def load_sample(i, rng=None):  # bench_resnet50's loader
        r = rng if rng is not None else np.random.default_rng(i)
        j = int(r.integers(0, len(pool)))
        img = pool[j]
        if r.integers(0, 2):
            img = img[:, ::-1]  # horizontal flip
        return {"x": np.ascontiguousarray(img), "y": np.int32(labels[j])}

    out = {"fork": fork_probe()}
    for norm in ("batch", "nf"):
        per_step = {"bf16": 1} if norm == "batch" else {}
        torch.backends.cudnn.deterministic = True
        cmp = {}
        for graphs in (False, True):
            e = estimator(model(norm, dtype="bfloat16"), graphs)
            cmp[graphs] = e._multi_step(b0, RESNET_CMP_STEPS).tolist()
            del e
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        against = losses_against_eager(cmp[True], cmp[False],
                                       f"resnet_train (d) {norm}")
        e = estimator(model(norm, dtype="bfloat16"))
        float(e._multi_step(b0, 1)[-1])  # warm: state, cuDNN's plans
        eager_ms, _ = window_ms(lambda: e._multi_step(b0, steps), steps)
        del e
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        est = estimator(model(norm, dtype="bfloat16"), True)
        warm_ms, _ = window_ms(lambda: est._multi_step(b0, steps), steps)
        bn.reset_launches()
        windows = [window_ms(lambda: est._multi_step(b0, steps), steps)[0]
                   for _ in range(repeats)]
        launches = read_bn_counts(
            bn, f"resnet_train (d) {norm}",
            **{k: v * steps * repeats for k, v in per_step.items()})
        profiled = profiled_window(
            lambda: est._multi_step(b0, 5), 5,
            {"batch_norm": ("bn_fwd_kernel", "bn_bwd_kernel")})
        peak = torch.cuda.max_memory_allocated()
        bn.reset_launches()
        feed = StreamingDataFeed(
            num_samples=(n_chunks + 2) * chunk_steps * RESNET_BATCH,
            load_sample=load_sample, batch_size=RESNET_BATCH, shuffle=False,
            num_workers=n_workers, prefetch_batches=STREAM_PREFETCH,
            workers="process")
        stream = stream_chunks(est, feed, chunk_steps, n_chunks)
        stream["launches"] = read_bn_counts(
            bn, f"resnet_train (d) {norm} streaming",
            **{k: v * chunk_steps * (n_chunks + 1)
               for k, v in per_step.items()})
        # twice the chunks on a fresh feed: do the chunks after the
        # decoders' first pass keep the card's pace?
        long = stream_chunks(est, StreamingDataFeed(
            num_samples=(2 * n_chunks + 2) * chunk_steps * RESNET_BATCH,
            load_sample=load_sample, batch_size=RESNET_BATCH, shuffle=False,
            num_workers=n_workers, prefetch_batches=STREAM_PREFETCH,
            workers="process"), chunk_steps, 2 * n_chunks)
        stream["long_window"] = {
            k: long[k] for k in ("chunks", "step_ms", "host_feed_ms_per_chunk",
                                 "host_call_ms_per_chunk")}
        caps = captures(est, f"resnet_train (d) {norm}")
        del est
        torch.cuda.empty_cache()
        ms = float(np.median(windows))
        idle_of(profiled, ms)
        flops = runs[norm]["forward_gflop_per_image"] * 1e9
        stream["vs_resident"] = stream["step_ms"] / ms
        stream["long_window"]["vs_resident"] = \
            stream["long_window"]["step_ms"] / ms
        stream["within_bench_acceptance"] = \
            stream["step_ms"] <= (1 + STREAM_WITHIN) * ms
        out[norm] = {
            "losses_against_eager": against, "warm_window_step_ms": warm_ms,
            "window_step_ms": windows, "step_ms": ms,
            "eager_step_ms": eager_ms,
            "eager_step_ms_p50_b": runs[norm]["step_ms_p50"],
            "images_per_s": RESNET_BATCH / (ms / 1e3),
            "model_tflop_per_s": 3 * flops * RESNET_BATCH / ms / 1e9,
            "launches": launches, "profiled": profiled,
            "peak_memory_bytes": peak, "streaming": stream, **caps}
    return out


def xent_inputs(gen, n, d, v, dtype, w_dtype=torch.float32, scale=1.0,
                flat_row=False):
    """h (scaled by ``scale``), w, bias and labels on the card, labels 0
    and V-1 at the first and last tokens; with ``flat_row`` token 1's
    logits are all equal (h row 0, zero bias)."""
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    h = r(n, d) * scale
    bias = r(v) * 0.1
    if flat_row:
        h[1] = 0.0
        bias.zero_()
    labels = torch.randint(0, v, (n,), device="cuda", generator=gen)
    labels[0], labels[-1] = 0, v - 1
    return h.to(dtype), (r(d, v) * 0.05).to(w_dtype), bias, labels


def xent_bound(n, d, v, h_size, w_size, direction, fma=False) -> tuple:
    """(ms, "bytes"|"operations") of the head's loss: 2NDV FLOP forward,
    6NDV backward (the logits recomputed, then dh and dW), at the
    activation dtype's peak; h, w, bias, labels read once and lse/loss
    (forward) or dh, dW, db (backward) written once."""
    flops = (2.0 if direction == "fwd" else 6.0) * n * d * v
    nbytes = n * d * h_size + d * v * w_size + 4 * v + 8 * n + 4 * n
    if direction == "bwd":
        nbytes += n * d * h_size + d * v * w_size + 4 * v
    return bound(flops, nbytes, h_size, fma)


def phase_fused_xent(fx) -> dict:
    """The fused softmax cross-entropy kernels against their plain versions
    (loss, lse, dh, dW, db) at the recipe's head shape and ragged ones,
    f32 and bf16, labels at 0 and V-1, a row of equal logits, logits of
    1e2 x the scale; identical bits on repeat; then times at the recipe's
    shape beside the bound, the plain version and the library's
    ``F.cross_entropy`` over materialised logits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst = {"loss": 0.0, "f32": 0.0, "bf16_dh": 0.0, "bf16_sums": 0.0}
    d, v = MLM["d_model"], MLM["vocab"]
    n = MLM_MICRO * SEQ

    def check(h, w, bias, labels, chunk):
        g = torch.tensor(1.0, device="cuda")
        loss, lse = fx.fused_xent_fwd(h, w, bias, labels, chunk)
        got = (loss, lse) + fx.fused_xent_bwd(h, w, bias, labels, lse, g,
                                              chunk)
        rloss, rlse = fx.fused_xent_reference(h, w, bias, labels, chunk)
        ref = (rloss, rlse) + fx.fused_xent_bwd_reference(
            h, w, bias, labels, rlse, g, chunk)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b in zip(("loss", "lse", "dh", "dw", "db"), got, ref):
            if a.shape != b.shape or a.dtype != b.dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"fused_xent {name}: {tuple(a.shape)} "
                                     f"{a.dtype} at {tuple(h.shape)} V {v}")
            e = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            if name in ("loss", "lse"):
                rel = e / max(1.0, top)
                tol, key = TOL_XENT_LOSS, "loss"
            elif h.dtype == torch.float32:
                rel, tol, key = e / max(top, 1e-30), TOL_XENT_F32, "f32"
            elif name == "dh" or a.dtype == torch.bfloat16:
                rel, tol, key = e / max(top, 1e-30), TOL_XENT_BF16_DH, \
                    "bf16_dh"
            else:
                rel, tol, key = e / max(top, 1e-30), TOL_XENT_BF16_SUM, \
                    "bf16_sums"
            worst[key] = max(worst[key], rel)
            err = max(err, e)
            if rel > tol:
                raise AssertionError(
                    f"fused_xent kernel disagrees with its plain version at "
                    f"{tuple(h.shape)} V {w.shape[1]} {h.dtype} w "
                    f"{w.dtype}: {name} err {e} of {top}")
        return got, err

    dtypes = (torch.float32, torch.bfloat16)
    cases = [(n, d, v, MLM_CHUNK, dt, torch.float32, {}) for dt in dtypes]
    cases += [(n, d, v, MLM_CHUNK, torch.bfloat16, torch.bfloat16, {})]
    cases += [(nn_, dd, vv, ch, dt, torch.float32, {})
              for nn_, dd, vv, ch in XENT_EDGE for dt in dtypes]
    cases += [(300, 40, 777, 100, torch.bfloat16, torch.bfloat16, {})]
    cases += [(512, 96, 3001, 128, dt, torch.float32, kw) for dt in dtypes
              for kw in ({"flat_row": True}, {"scale": 100.0})]
    for nn_, dd, vv, ch, dt, wdt, kw in cases:
        check(*xent_inputs(gen, nn_, dd, vv, dt, wdt, **kw), ch)
    # no atomics: one input, identical bits
    for dt in dtypes:
        inputs = xent_inputs(gen, n, d, v, dt, scale=100.0)
        first, _ = check(*inputs, MLM_CHUNK)
        again, _ = check(*inputs, MLM_CHUNK)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"fused_xent: two runs at {dt} differ")

    # times at the recipe's shape: bf16 activations with the f32 head
    # kernel (the recipe's), and f32
    timings = []
    for dt in dtypes:
        h, w, bias, labels = xent_inputs(gen, n, d, v, dt)
        _, err = check(h, w, bias, labels, MLM_CHUNK)
        loss, lse = fx.fused_xent_fwd(h, w, bias, labels, MLM_CHUNK)
        g = torch.tensor(1.0, device="cuda")
        lib_h, lib_w, lib_b = (t.detach().requires_grad_()
                               for t in (h, w, bias))

        def lib_fwd():
            return torch.nn.functional.cross_entropy(
                lib_h @ lib_w.to(dt) + lib_b, labels)

        lib_out = lib_fwd()
        for direction, kernel, plain, library in (
                ("fwd",
                 lambda: fx.fused_xent_fwd(h, w, bias, labels, MLM_CHUNK),
                 lambda: fx.fused_xent_reference(h, w, bias, labels,
                                                 MLM_CHUNK),
                 lib_fwd),
                ("bwd",
                 lambda: fx.fused_xent_bwd(h, w, bias, labels, lse, g,
                                           MLM_CHUNK),
                 lambda: fx.fused_xent_bwd_reference(h, w, bias, labels, lse,
                                                     g, MLM_CHUNK),
                 lambda: torch.autograd.grad(lib_out, (lib_h, lib_w, lib_b),
                                             retain_graph=True))):
            ms, plain_ms, library_ms = (cuda_ms(f, iters=10)
                                        for f in (kernel, plain, library))
            dev_ms, plain_dev_ms, library_dev_ms = (
                device_ms(f, iters=10) for f in (kernel, plain, library))
            bound_ms, bound_by = xent_bound(n, d, v, h.element_size(),
                                            w.element_size(), direction)
            fma_ms = xent_bound(n, d, v, 4, w.element_size(), direction,
                                fma=True)[0] if dt == torch.float32 else None
            timings.append({
                "kernel": XENT_KERNEL, "direction": direction, "n": n,
                "design": fx.bwd_design(dt) if direction == "bwd"
                else fx.fwd_design(dt),
                "d": d, "v": v, "chunk": MLM_CHUNK,
                "dtype": str(dt).replace("torch.", ""),
                "w_dtype": str(w.dtype).replace("torch.", ""),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "device_ms": dev_ms,
                "plain_device_ms": plain_dev_ms,
                "library_device_ms": library_dev_ms,
                "library": "F.cross_entropy(h @ w.to(h.dtype) + b, labels)"
                           + (" and its autograd.grad over (h, w, b)"
                              if direction == "bwd" else ""),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "fma_bound_ms": fma_ms,
                "device_share_of_bound": bound_ms / dev_ms})
        del lib_h, lib_w, lib_b, lib_out, h, w
        torch.cuda.empty_cache()
    res = {"phase": "fused_xent", "cases": len(cases) + 2 * len(dtypes),
           "edge_shapes": XENT_EDGE, "worst": worst,
           "tolerances": {"loss_lse_rel_to_max1": TOL_XENT_LOSS,
                          "f32_rel_to_max": TOL_XENT_F32,
                          "bf16_dh_rel_to_max": TOL_XENT_BF16_DH,
                          "bf16_dw_db_rel_to_max": TOL_XENT_BF16_SUM},
           "repeat_bitwise_identical": True, "timings": timings}
    emit(res)
    return res


class MlmEncoder(torch.nn.Module):
    """bench.py's ``bench_bert`` ``Encoder`` at BERT-base width, in the JAX
    tree's names (``tok/embeddings``, ``pos``, ``block{i}/...``,
    ``head/kernel``, ``head/bias``): the token embedding plus ``pos`` in
    ``dtype``, ``layers`` post-LN ``TransformerLayer``s with
    ``remat_attention=True``, then the vocab head: applied (``fused=False``,
    logits for ``sparse_categorical_crossentropy``) or handed to the loss as
    ``(h, head.kernel, head.bias)`` for ``fused_softmax_xent``."""

    def __init__(self, layers, dtype, fused):
        super().__init__()
        from analytics_zoo_tpu_torch import nn as tnn
        d, v = MLM["d_model"], MLM["vocab"]
        self.dtype, self.fused = dtype, fused
        self.tok = tnn.Embedding(v, d)
        self.pos = torch.nn.Parameter(torch.empty(1, SEQ, d))
        self.blocks = [f"block{i}" for i in range(layers)]
        for name in self.blocks:
            self.add_module(name, tnn.TransformerLayer(
                d, MLM["heads"], remat_attention=True))
        self.head = tnn.Dense(d, v)

    def forward(self, ids):
        x = (self.tok(ids) + self.pos).to(self.dtype)
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.fused:
            return x, self.head.kernel, self.head.bias
        return self.head(x)


def mlm_loss(fused):
    """The recipe's loss: per-token sparse cross-entropy on the logits, or
    the same function through ``fused_softmax_xent`` (a loss callable)."""
    if not fused:
        return "sparse_categorical_crossentropy"
    from analytics_zoo_tpu_torch.ops import fused_softmax_xent

    def loss(out, y):
        return fused_softmax_xent(out[0], out[1], y, MLM_CHUNK, bias=out[2])

    return loss


def mlm_flops_per_token(layers) -> tuple:
    """(forward FLOP per token of the encoder and the head, the recompute's
    FLOP per token): the encoder as ``bert_flops_per_token`` at ``layers``
    layers, the head's 2 D V, and remat_attention's second pass over the two
    attention products (4 SEQ D a layer)."""
    d = MLM["d_model"]
    encoder = layers * (2.0 * 12 * d * d + 4.0 * SEQ * d)
    return encoder + 2.0 * d * MLM["vocab"], layers * 4.0 * SEQ * d


def read_xent_counts(fx, what, **per_dtype) -> dict:
    """The fused_xent launch counts since ``reset_launches``: every pass of
    the dtypes in ``per_dtype`` that many times, no other."""
    counts = dict(fx.KERNEL_LAUNCHES)
    want = {name: per_dtype.get(name.rsplit("_", 1)[1], 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: fused_xent launches {counts}; want "
                             f"{want}")
    return counts


def read_xent_designs(fx, what, fwd=None, bwd=None, calls=0) -> tuple:
    """The fused_xent calls of each direction by design since
    ``reset_launches``, (forward's, backward's): ``calls`` of ``fwd`` and
    of ``bwd``, none of another design."""
    got = []
    for direction, counts, designs, design in (
            ("forward", fx.FWD_LAUNCHES, fx.FWD_DESIGNS, fwd),
            ("backward", fx.BWD_LAUNCHES, fx.BWD_DESIGNS, bwd)):
        want = dict.fromkeys(designs, 0)
        if design is not None:
            want[design] = calls
        if counts != want:
            raise AssertionError(f"{what}: fused_xent {direction} calls by "
                                 f"design {counts}; want {want}")
        got.append(dict(counts))
    return tuple(got)


def phase_bert_mlm_train(fa, fx) -> dict:
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.data import as_feed
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    t0 = time.perf_counter()
    states = {layers: from_jax_variables(random_bert_variables(
        MlmEncoder(layers, torch.float32, False), SEED))
        for layers in (MLM_CHECK_LAYERS, MLM["layers"])}
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    vocab = MLM["vocab"]

    def model(layers, dtype, fused):
        m = MlmEncoder(layers, dtype, fused)
        m.load_state_dict(states[layers], strict=True)
        return m.cuda()

    def estimator(m, fused, accum, graphs=False):
        return Estimator.from_keras(m, loss=mlm_loss(fused), optimizer="adamw",
                                    learning_rate=TRAIN_LR, seed=SEED,
                                    grad_accum=accum, cuda_graphs=graphs)

    def tokens(rows):
        return (rng.integers(0, vocab, (rows, SEQ)).astype(np.int32),
                rng.integers(0, vocab, (rows, SEQ)).astype(np.int32))

    # (a) f32, 2 layers at full width: the plain and the fused head's
    # gradients on one micro-batch, then 3 steps of global batch 8 =
    # grad_accum 2 x 4 each
    xa, ya = tokens(MLM_MICRO)
    xt, yt = torch.from_numpy(xa).cuda(), torch.from_numpy(ya).cuda()
    grads, loss0 = {}, {}
    for fused in (False, True):
        m = model(MLM_CHECK_LAYERS, torch.float32, fused).train()
        est = estimator(m, fused, 1)
        names = [k for k, _ in m.named_parameters()]
        loss = est.loss_fn(m(xt), yt)
        grads[fused] = dict(zip(names, torch.autograd.grad(
            loss, list(m.parameters()), allow_unused=True)))
        loss0[fused] = float(loss.detach())
        del m, est, loss
    worst_rel, worst_head = 0.0, 0.0
    for name, ref in grads[False].items():
        got = grads[True][name]
        if ref is None or got is None:
            raise AssertionError(f"bert_mlm_train f32: no gradient of {name}")
        top = ref.abs().max().item()
        if top == 0.0:  # embedding rows of absent tokens
            continue
        rel = (got - ref).abs().max().item() / top
        worst_rel = max(worst_rel, rel)
        if name.startswith("head."):
            worst_head = max(worst_head, rel)
        if rel > TOL_TRAIN_GRAD:
            raise AssertionError(f"bert_mlm_train f32: {name}'s gradient "
                                 f"differs by {rel} of its max (fused vs "
                                 f"plain head)")
    del grads
    x3, y3 = tokens(MLM_MICRO * MLM_CHECK_ACCUM * CHECK_STEPS)
    hist = {}
    for fused in (False, True):
        est = estimator(model(MLM_CHECK_LAYERS, torch.float32, fused), fused,
                        MLM_CHECK_ACCUM)
        hist[fused], _ = record_steps(est)
        fx.reset_launches()
        est.fit((x3, y3), epochs=1, batch_size=MLM_MICRO * MLM_CHECK_ACCUM,
                verbose=False)
        calls = MLM_CHECK_ACCUM * CHECK_STEPS
        counts = read_xent_counts(fx, "bert_mlm_train f32",
                                  **({"f32": calls} if fused else {}))
        designs = read_xent_designs(
            fx, "bert_mlm_train f32",
            **(dict(fwd="scalar", bwd="wgmma_tf32", calls=calls) if fused
               else {}))
        if fused:
            f32_launches, f32_designs = counts, designs
        del est
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(hist[True], hist[False]))
    if loss_err > TOL_TRAIN_LOSS or not all(map(math.isfinite, hist[True])):
        raise AssertionError(f"bert_mlm_train f32: loss history {hist[True]}"
                             f" (fused head) vs {hist[False]} (plain)")
    f32_check = {"layers": MLM_CHECK_LAYERS, "micro_batch": MLM_MICRO,
                 "grad_accum": MLM_CHECK_ACCUM, "steps": CHECK_STEPS,
                 "first_loss": {"plain": loss0[False], "fused": loss0[True]},
                 "grad_worst_rel_to_tensor_max": worst_rel,
                 "head_grad_worst_rel_to_tensor_max": worst_head,
                 "grad_tol": TOL_TRAIN_GRAD, "loss_plain": hist[False],
                 "loss_fused": hist[True], "loss_worst_rel": loss_err,
                 "loss_tol": TOL_TRAIN_LOSS, "launches": f32_launches,
                 "fwd_launches_by_design": f32_designs[0],
                 "bwd_launches_by_design": f32_designs[1]}
    torch.cuda.empty_cache()

    # (b) plain head and (c) fused head: bench.py's recipe, bf16, 12
    # layers, global batch 32 = grad_accum 8 x 4, 20 steps on one seeded
    # batch.  The step is host-bound and the host's time swings between
    # fits of one code, so the two heads take turns: plain, fused, fused,
    # plain; each fit must launch as it should and lower the loss
    x, y = tokens(MLM_BATCH)
    fwd_flops, recompute_flops = mlm_flops_per_token(MLM["layers"])
    d = MLM["d_model"]
    runs = {}
    for fused in (False, True, True, False):
        name = "fused" if fused else "plain"
        est = estimator(model(MLM["layers"], torch.bfloat16, fused), fused,
                        MLM_ACCUM)
        inner = est._train_step
        step_losses, step_ms = record_steps(est)
        fx.reset_launches()
        reset_counts(fa)
        t0 = time.perf_counter()
        losses = est.fit((x, y), epochs=MLM_STEPS, batch_size=MLM_BATCH,
                         verbose=False)["loss"]
        fit_s = time.perf_counter() - t0
        launches = read_xent_counts(
            fx, f"bert_mlm_train {name}",
            **({"bf16": MLM_ACCUM * MLM_STEPS} if fused else {}))
        designs = read_xent_designs(
            fx, f"bert_mlm_train {name}",
            **(dict(fwd="wgmma", bwd="wgmma", calls=MLM_ACCUM * MLM_STEPS)
               if fused else {}))
        read_counts(fa, "bert_mlm_train (dense attention)")
        if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"bert_mlm_train {name}: loss {losses} did "
                                 f"not fall")
        fit = {"loss": losses, "fit_s": fit_s,
               "step_ms_last10": step_ms[-10:],
               "step_ms_p50": float(np.median(step_ms[-10:]))}
        if name in runs:  # the variant's second turn
            run = runs[name]
            run["fits"].append(fit)
            run["step_ms_p50"] = float(np.median(
                [t for f in run["fits"] for t in f["step_ms_last10"]]))
            tokens_per_s = MLM_BATCH * SEQ / (run["step_ms_p50"] / 1e3)
            run["tokens_per_s"] = tokens_per_s
            run["model_tflop_per_s"] = 3 * fwd_flops * tokens_per_s / 1e12
            run["recompute_tflop_per_s"] = (recompute_flops + (
                2.0 * d * MLM["vocab"] if fused else 0.0)) \
                * tokens_per_s / 1e12
            run["profiled_step"]["idle_share_of_p50_step"] = 1.0 - \
                run["profiled_step"]["device_busy_ms"] / run["step_ms_p50"]
            del est, inner
            torch.cuda.empty_cache()
            continue
        batch = next(as_feed((x, y), MLM_BATCH, seed=SEED).epoch(
            est.device, 0))
        profiled = profile_call(lambda: inner(batch),
                                {"xent": ("xent_",)})
        # the head and its loss alone, forward and backward on one
        # micro-batch's activations, times the micro-batches of a step
        h = torch.randn(MLM_MICRO, SEQ, d, device="cuda").to(torch.bfloat16)
        h.requires_grad_()
        yb = batch["y"][:MLM_MICRO]
        head = est.model.head

        def head_and_loss():
            out = (h, head.kernel, head.bias) if fused else head(h)
            loss = est.loss_fn(out, yb)
            return torch.autograd.grad(loss, (h, head.kernel, head.bias))

        head_ms = device_ms(head_and_loss, iters=5)
        runs[name] = {
            "fits": [fit], "launches": launches,
            "fwd_launches_by_design": designs[0],
            "bwd_launches_by_design": designs[1], "profiled_step": profiled,
            "head_and_loss_device_ms_per_micro": head_ms,
            "head_and_loss_share_of_busy":
                MLM_ACCUM * head_ms / profiled["device_busy_ms"]}
        del est, inner, h, head
        torch.cuda.empty_cache()
    captured = mlm_captured(
        fa, fx, lambda graphs: estimator(
            model(MLM["layers"], torch.bfloat16, True), True, MLM_ACCUM,
            graphs), x, y, fwd_flops, runs["fused"])
    res = {"phase": "bert_mlm_train", "config": dict(MLM, seq=SEQ),
           "dtype": "bfloat16", "optimizer": "adamw",
           "learning_rate": TRAIN_LR, "global_batch": MLM_BATCH,
           "grad_accum": MLM_ACCUM, "micro_batch": MLM_MICRO,
           "steps": MLM_STEPS, "chunk": MLM_CHUNK, "setup_s": setup_s,
           "flop_convention": "model: 3 x forward FLOP per token (encoder "
                              "GEMMs and attention products as "
                              "bert_flops_per_token, plus the head's 2 D V); "
                              "recompute: remat_attention's second pass of "
                              "the attention products (4 SEQ D a layer) and, "
                              "for the fused head, its logits recomputed in "
                              "the backward (2 D V)",
           "plain": runs["plain"], "fused": runs["fused"],
           "fused_vs_plain_step_p50": runs["fused"]["step_ms_p50"]
           / runs["plain"]["step_ms_p50"],
           "f32_check": f32_check, "captured": captured}
    emit(res)
    return res


def mlm_captured(fa, fx, make, x, y, fwd_flops, eager_run) -> dict:
    """bert_mlm_train (d): bench.py's ``bench_bert`` (the fused head) from
    CUDA graphs.  The eager step's window of 10 steps on the seeded batch
    (its losses the yardstick) and a second, warm one (its time), then ``_multi_step(batch, 50)`` once to
    warm (its first 10 losses against the eager ones) and three times
    timed, 8 launches of each ``fused_xent`` pass a step counted from the
    replays, a profiled window, peak memory; then bench.py's streaming
    phase: 8 worker threads decode token batches, ``_multi_step_data``
    over chunks of 10."""
    from analytics_zoo_tpu_torch.data import StreamingDataFeed

    batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    steps, repeats = MLM_RESIDENT
    chunk_steps, n_chunks = MLM_STREAM
    vocab = MLM["vocab"]
    torch.cuda.empty_cache()
    eager = make(False)
    # the first window's losses are the yardstick; its time includes the
    # first step's costs (Adam's state, the allocator's growth), so the
    # eager step is timed over a second, warm window
    eager_cold_ms, eager_losses = window_ms(
        lambda: eager._multi_step(batch, MLM_CMP_STEPS), MLM_CMP_STEPS)
    eager_ms, _ = window_ms(
        lambda: eager._multi_step(batch, MLM_CMP_STEPS), MLM_CMP_STEPS)
    del eager
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = make(True)
    fx.reset_launches()
    reset_counts(fa)
    warm_ms, warm = window_ms(lambda: est._multi_step(batch, steps), steps)
    against = losses_against_eager(warm[:MLM_CMP_STEPS], eager_losses,
                                   "bert_mlm_train (d)")
    read_xent_counts(fx, "bert_mlm_train (d) warm",
                     bf16=MLM_ACCUM * steps)
    fx.reset_launches()
    windows = [window_ms(lambda: est._multi_step(batch, steps), steps)[0]
               for _ in range(repeats)]
    calls = MLM_ACCUM * steps * repeats
    launches = read_xent_counts(fx, "bert_mlm_train (d)", bf16=calls)
    designs = read_xent_designs(fx, "bert_mlm_train (d)", fwd="wgmma",
                                bwd="wgmma", calls=calls)
    read_counts(fa, "bert_mlm_train (d) (dense attention)")
    profiled = profiled_window(lambda: est._multi_step(batch, 5), 5,
                               {"xent": ("xent_",)})
    peak = torch.cuda.max_memory_allocated()

    def load_sample(i, rng=None):  # bench_bert's loader, int32 tokens
        r = np.random.default_rng(i)
        return {"x": r.integers(0, vocab, (SEQ,)).astype(np.int32),
                "y": r.integers(0, vocab, (SEQ,)).astype(np.int32)}

    feed = StreamingDataFeed(
        num_samples=(n_chunks + 2) * chunk_steps * MLM_BATCH,
        load_sample=load_sample, batch_size=MLM_BATCH, shuffle=False,
        num_workers=MLM_STREAM_WORKERS, prefetch_batches=STREAM_PREFETCH)
    fx.reset_launches()
    stream = stream_chunks(est, feed, chunk_steps, n_chunks)
    stream["launches"] = read_xent_counts(
        fx, "bert_mlm_train (d) streaming",
        bf16=MLM_ACCUM * chunk_steps * (n_chunks + 1))
    caps = captures(est, "bert_mlm_train (d)")
    del est
    torch.cuda.empty_cache()
    ms = float(np.median(windows))
    idle_of(profiled, ms)
    stream["vs_resident"] = stream["step_ms"] / ms
    stream["within_bench_acceptance"] = \
        stream["step_ms"] <= (1 + STREAM_WITHIN) * ms
    tokens_per_s = MLM_BATCH * SEQ / (ms / 1e3)
    return {"losses_against_eager": against, "warm_window_step_ms": warm_ms,
            "window_step_ms": windows, "step_ms": ms,
            "eager_step_ms": eager_ms, "eager_cold_step_ms": eager_cold_ms,
            "eager_step_ms_p50_c": eager_run["step_ms_p50"],
            "tokens_per_s": tokens_per_s,
            "model_tflop_per_s": 3 * fwd_flops * tokens_per_s / 1e12,
            "launches": launches, "fwd_launches_by_design": designs[0],
            "bwd_launches_by_design": designs[1], "profiled": profiled,
            "peak_memory_bytes": peak, "streaming": stream, **caps}


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


def kernel_entry(name, design, launches, path, replaces, x) -> dict:
    """One entry of the ``kernels`` line from a timing record ``x``."""
    return {"name": name, "design": design, "route": "cuda",
            "source": f"analytics_zoo_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "fma_bound_ms": x.get("fma_bound_ms"),
            "library_ms": x["library_ms"],
            "device_ms": x["device_ms"],
            "plain_device_ms": x["plain_device_ms"],
            "library_device_ms": x["library_device_ms"]}


def main(argv) -> int:
    only = []
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv:
        print("usage: chip_smoke.py [--only phase,phase,...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import importlib
    from analytics_zoo_tpu_torch.ops import _build
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    fx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc per source, together
        list(pool.map(_build.build, (BF16_KERNEL, F32_KERNEL, BWD_KERNEL,
                                     BN_KERNEL, XENT_KERNEL)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    if only:  # a subset of the phases, for iterating on one: no last line
        phases = {"kernel": lambda: phase_kernel(fa),
                  "fused_bn": lambda: phase_fused_bn(bn),
                  "bert_serve": lambda: phase_bert_serve(fa),
                  "int8_serve": lambda: phase_int8_serve(fa),
                  "cluster_serve": lambda: phase_cluster_serve(fa),
                  "bert_train": lambda: phase_bert_train(fa),
                  "resnet_train": lambda: phase_resnet_train(bn),
                  "fused_xent": lambda: phase_fused_xent(fx),
                  "bert_mlm_train": lambda: phase_bert_mlm_train(fa, fx)}
        for name in only:
            phases[name]()
        return 0
    kern = phase_kernel(fa)
    bn_kern = phase_fused_bn(bn)
    serve = phase_bert_serve(fa)
    int8 = phase_int8_serve(fa)
    cluster = phase_cluster_serve(fa)
    train = phase_bert_train(fa)
    resnet = phase_resnet_train(bn)
    xent_kern = phase_fused_xent(fx)
    mlm = phase_bert_mlm_train(fa, fx)
    smi = phase_devices()
    print(smi, flush=True)
    timed = {x["kernel"]: x for x in kern["timings"]
             if x["bh"] == TIMED_SHAPE["b"] * TIMED_SHAPE["h"]
             and not x["causal"]}
    timed.update({(BWD_KERNEL, x["dtype"]): x for x in kern["bwd_timings"]})
    fwd_src = "analytics_zoo_tpu/ops/flash_attention.py:44"
    bwd_src = "analytics_zoo_tpu/ops/flash_attention.py:187"
    bn_src = "analytics_zoo_tpu/ops/fused_bn.py:76"
    entries = []
    for name, key, design, launches, path, replaces in (
            (BF16_KERNEL, BF16_KERNEL,
             "bf16: wgmma fed by a 2-stage TMA ring, one warpgroup a block "
             "of 64 q rows (d 33-64); mma.sync with a cp.async ring for "
             "the other heads up to 256",
             serve["flash_launches"][BF16_KERNEL], "bert_serve bf16",
             fwd_src),
            (F32_KERNEL, F32_KERNEL,
             "f32: wgmma in 3xTF32 (big and small tf32 parts, three "
             "products per f32 product) after a split pass (q's and k's "
             "parts as they are, v's transposed), one warpgroup a block of "
             "64 q rows streaming 32-key tiles through a 2-stage TMA ring, "
             "two blocks an SM, P split in registers into the A fragments "
             "of P V (d <= 64); scalar FMAs for d 65-256, the wide kernel "
             "above", serve["f32_flash_launches"][F32_KERNEL],
             "bert_serve f32", fwd_src),
            (BWD_KERNEL, (BWD_KERNEL, "bfloat16"),
             "bf16: wgmma fed by a 2-stage TMA ring, one warpgroup a "
             "block (d 33-64); mma.sync with a cp.async ring for d <= 32, "
             "scalar f32 above 64; delta, dK/dV and dQ passes, no atomics",
             train["launches"][BWD_KERNEL], "bert_train bf16", bwd_src),
            (BWD_KERNEL, (BWD_KERNEL, "float32"),
             "f32: wgmma in 3xTF32 (big and small tf32 parts, three "
             "products per f32 product) fed by a 2-stage TMA ring of "
             "32-row tiles, one warpgroup a block of 64 keys or q rows, one "
             "block an SM (d <= 64; scalar FMAs above); a split pass "
             "writes each operand's parts, transposed where a product's "
             "depth is T; then delta, dK/dV and dQ passes, no atomics",
             train["f32_check"]["launches"][BWD_KERNEL], "bert_train f32",
             bwd_src)):
        x = timed[key]
        entry = kernel_entry(name, design, launches, path, replaces, x)
        entry["shape"] = {k: x[k] for k in ("bh", "t", "d", "dtype")}
        entries.append(entry)
    entries[0]["launches_bert_train_bf16"] = train["launches"][BF16_KERNEL]
    entries[0]["launches_bert_train_captured"] = \
        train["captured"]["launches"][BF16_KERNEL]
    entries[2]["launches_bert_train_captured"] = \
        train["captured"]["launches"][BWD_KERNEL]
    for mode, run in int8["bert"].items():
        entries[0][f"launches_int8_serve_{mode}"] = \
            run["flash_launches"][BF16_KERNEL]
    entries[0]["launches_cluster_serve"] = \
        cluster["flash_launches"][BF16_KERNEL]
    entries[0]["launches_by_design_cluster_serve"] = \
        cluster["fwd_launches_by_design"]
    entries[0]["launches_by_design"] = serve["fwd_launches_by_design"]
    entries[0]["launches_by_design_bert_train_bf16"] = \
        train["fwd_launches_by_design"]
    entries[1]["launches_by_design"] = serve["f32_fwd_launches_by_design"]
    entries[1]["launches_by_design_bert_train_f32"] = \
        train["f32_check"]["fwd_launches_by_design"]
    entries[1]["at_bert_train_f32"] = {
        k: x[k] for x in kern["timings"]
        if x["dtype"] == "float32"
        and x["bh"] == CHECK_BATCH * TRAIN_SHAPE["h"]
        for k in ("bh", "ms", "plain_ms", "library_ms", "device_ms",
                  "plain_device_ms", "library_device_ms", "bound_ms",
                  "fma_bound_ms", "max_abs_err")}
    entries[2]["launches_by_design"] = train["bwd_launches_by_design"]
    entries[3]["launches_by_design"] = \
        train["f32_check"]["bwd_launches_by_design"]
    entries[1]["launches_bert_train_f32"] = \
        train["f32_check"]["launches"][F32_KERNEL]
    # fused batch norm: one entry per direction and dtype, timed at the
    # stem's shape (the last stage's beside it), launches of the main path
    # run of that dtype (bf16: resnet_train (b); f32: (a)'s fit)
    bn_times = {(x["direction"], x["dtype"], x["shape"]): x
                for x in bn_kern["timings"]}
    for direction, passes in (("fwd", ("fwd",)), ("bwd", ("bwd",))):
        for dtype, sfx, counts, path in (
                ("bfloat16", "bf16", resnet["batch"]["launches"],
                 "resnet_train bf16"),
                ("float32", "f32", resnet["f32_check"]["launches"],
                 "resnet_train f32")):
            x = bn_times[(direction, dtype, "stem")]
            entry = kernel_entry(
                BN_KERNEL, f"{dtype}, {direction}: one persistent "
                "cooperative launch, a 512-thread block an SM over "
                "(16-byte channel vectors x row ranges): f32 partials, one "
                "grid barrier, each block's own finalize, then the output; "
                "up to 200 KB of each block's rows kept in shared memory "
                "(cp.async.bulk) between the phases, the rest re-read in "
                "reverse; no atomics", counts[f"{passes[0]}_{sfx}"], path,
                bn_src, x)
            entry["launches_by_pass"] = {p: counts[f"{p}_{sfx}"]
                                         for p in passes}
            if sfx == "bf16":  # resnet_train (d), norm="batch"
                entry["launches_resnet_train_captured"] = resnet[
                    "captured"]["batch"]["launches"][f"{passes[0]}_{sfx}"]
            entry["shape"] = {"rows": x["rows"], "c": x["c"],
                              "dtype": dtype}
            for label in ("most_norms", "stage3"):
                y = bn_times[(direction, dtype, label)]
                entry[f"at_{label}"] = {k: y[k] for k in (
                    "rows", "c", "ms", "plain_ms", "library_ms",
                    "device_ms", "plain_device_ms", "library_device_ms",
                    "bound_ms", "max_abs_err")}
            entries.append(entry)
    # fused softmax cross-entropy: one entry per direction and activation
    # dtype, timed at the recipe's head shape, launches of the main path
    # run of that dtype (bf16: bert_mlm_train (c); f32: (a)'s fused fit)
    xent_times = {(x["direction"], x["dtype"]): x
                  for x in xent_kern["timings"]}
    xent_src = "analytics_zoo_tpu/ops/fused_xent.py:50"
    bwd_designs = {
        "wgmma": "bf16, wgmma m64n128k16 fed by a TMA ring, two warpgroups "
                 "a 128 x 128 tile; over every token: dl, dh (split-K, "
                 "reduced in order) and dW (f32 sum in registers, written "
                 "once) passes, then db",
        "wgmma_tf32": "f32: the dl pass's logits on scalar FMAs in the "
                      "forward's summation order, then dh (split-K, "
                      "reduced in order) and dW (f32 sum in registers) on "
                      "wgmma m64n128k8 in 3xTF32 (A from registers, split "
                      "there; B as tf32 parts from split passes of W and "
                      "h^T) fed by a 2-stage TMA ring of 64-deep slices, "
                      "two warpgroups a 128 x 128 tile; over every token; "
                      "then db"}
    for direction, passes in (("fwd", ("fwd",)), ("bwd", ("dl", "dh", "dw"))):
        for dtype, sfx, counts, path in (
                ("bfloat16", "bf16", mlm["fused"]["launches"],
                 "bert_mlm_train bf16 (fused head)"),
                ("float32", "f32", mlm["f32_check"]["launches"],
                 "bert_mlm_train f32 (fused head)")):
            x = xent_times[(direction, dtype)]
            if direction == "fwd":
                design = x["design"] + (
                    ": bf16, the bf16 backward's dl main loop (wgmma "
                    "m64n128k16 fed by a 3-stage TMA ring, two warpgroups a "
                    "128 x 128 tile, two blocks an SM; W packed once and "
                    "handed to the backward)" if sfx == "bf16"
                    else ": f32, scalar FMAs, 128 x 256 tiles")
                design += ("; fwd: logit tiles' max / sum-exp / label "
                           "logit, per-token finalize, mean; logits never "
                           "written")
            else:
                design = f"{x['design']}: {bwd_designs[x['design']]}"
            entry = kernel_entry(
                XENT_KERNEL, design + "; no atomics",
                counts[f"{passes[0]}_{sfx}"], path, xent_src, x)
            entry["launches_by_pass"] = {p: counts[f"{p}_{sfx}"]
                                         for p in passes}
            entry["launches_by_design"] = (
                mlm["fused"] if sfx == "bf16" else mlm["f32_check"]
            )[f"{direction}_launches_by_design"]
            if sfx == "bf16":  # bert_mlm_train (d)
                entry["launches_bert_mlm_train_captured"] = {
                    p: mlm["captured"]["launches"][f"{p}_{sfx}"]
                    for p in passes}
            entry["shape"] = {k: x[k] for k in ("n", "d", "v", "chunk",
                                                "dtype", "w_dtype")}
            entries.append(entry)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
