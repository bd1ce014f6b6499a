#!/usr/bin/env python3
"""Where the host's time goes in the PyTorch port's BERT vocab-head step
(``chip_smoke.py``'s bert_mlm_train recipe), on a CUDA card.

Run from the root of a checkout:

    python3 dev/torch_head_parts.py

Prints one JSON line with, for the plain head (``Dense`` then
``sparse_categorical_crossentropy``) and the fused head
(``fused_softmax_xent``), each at one micro-batch of the recipe (4 x 512
tokens, D 768, V 30,522, bf16 activations, f32 head weights):

- the head and its loss, forward and ``autograd.grad`` over (h, W, b): the
  host's enqueue time per call (no synchronisation inside the timed calls),
  the wall time per call with one synchronisation at the end, and the
  card's kernel time (``torch.profiler``);
- one micro-batch's forward and backward through the whole 12-layer model
  (``Estimator._loss_and_grads``): the same three times;
- the host-side operations of one fused-head call that take the most CPU
  time (``torch.profiler``, CPU activity).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from analytics_zoo_tpu_torch.convert import from_jax_variables  # noqa: E402
from analytics_zoo_tpu_torch.orca.learn import Estimator  # noqa: E402

CALLS = 10


def times(fn) -> dict:
    """Host enqueue ms per call, wall ms per call (one synchronisation at
    the end) and the card's kernel ms per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_enqueue_ms": (t1 - t0) * 1e3 / CALLS,
            "wall_ms": (t2 - t0) * 1e3 / CALLS,
            "device_ms": smoke.device_ms(fn, iters=CALLS)}


def top_cpu_ops(fn, k=12) -> list:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key[:60], e.self_cpu_time_total / 1e3 / CALLS, e.count // CALLS]
            for e in rows[:k]]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_head_parts: no CUDA device", file=sys.stderr)
        return 2
    smoke.phase_devices()
    d, v = smoke.MLM["d_model"], smoke.MLM["vocab"]
    state = from_jax_variables(smoke.random_bert_variables(
        smoke.MlmEncoder(smoke.MLM["layers"], torch.float32, False),
        smoke.SEED))
    rng = np.random.default_rng(smoke.SEED)
    ids = torch.from_numpy(rng.integers(0, v, (smoke.MLM_MICRO, smoke.SEQ)
                                        ).astype(np.int32)).cuda()
    labels = torch.from_numpy(rng.integers(0, v, (smoke.MLM_MICRO, smoke.SEQ)
                                           ).astype(np.int32)).cuda()
    h = torch.randn(smoke.MLM_MICRO, smoke.SEQ, d, device="cuda").to(
        torch.bfloat16).requires_grad_()
    out = {}
    for fused in (False, True):
        model = smoke.MlmEncoder(smoke.MLM["layers"], torch.bfloat16, fused)
        model.load_state_dict(state, strict=True)
        est = Estimator.from_keras(model.cuda(), loss=smoke.mlm_loss(fused),
                                   optimizer="adamw", learning_rate=1e-4,
                                   grad_accum=smoke.MLM_ACCUM)
        head = est.model.head

        def head_and_loss():
            o = (h, head.kernel, head.bias) if fused else head(h)
            return torch.autograd.grad(est.loss_fn(o, labels),
                                       (h, head.kernel, head.bias))

        def micro_batch():
            return est._loss_and_grads(ids, labels)

        est.model.train()
        name = "fused" if fused else "plain"
        out[name] = {"head_and_loss": times(head_and_loss),
                     "micro_batch": times(micro_batch)}
        if fused:
            out[name]["head_and_loss_top_cpu_ops"] = top_cpu_ops(
                head_and_loss)
        del est, model, head
        torch.cuda.empty_cache()
    print(json.dumps({"micro_batch_tokens": smoke.MLM_MICRO * smoke.SEQ,
                      "calls": CALLS, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
