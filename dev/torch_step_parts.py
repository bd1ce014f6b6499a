#!/usr/bin/env python3
"""Dropout's and the optimizer's cost in the PyTorch port's BERT-base bf16
train step (``chip_smoke.py``'s bert_train recipe), on a CUDA card.

Run from the root of a checkout:

    python3 dev/torch_step_parts.py

Prints one JSON line:

- the port's ``Dropout(0.1)``, forward and backward, at the training
  activation [32, 512, 768] bf16, beside the four-pass form
  ``where(rand_f32 < keep, x / keep, 0)`` and ``F.dropout`` (a yardstick
  only), each as CUDA-event time per call (``*_ms``) and as the card's
  kernel time (``*_device_ms``, ``torch.profiler``);
- how many Dropout calls one training forward of BERT-base makes;
- one adamw step (``optimizers.get("adamw")``) over BERT-base's parameters,
  CUDA-event and kernel time.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from analytics_zoo_tpu_torch.models import BERTSQuAD  # noqa: E402
from analytics_zoo_tpu_torch.nn import Dropout  # noqa: E402
from analytics_zoo_tpu_torch.orca.learn import optimizers  # noqa: E402

RATE = 0.1


def both_times(fn) -> dict:
    return {"ms": smoke.cuda_ms(fn), "device_ms": smoke.device_ms(fn)}


def dropout_times() -> dict:
    shape = (smoke.TRAIN_BATCH, smoke.SEQ, smoke.BERT_BASE["hidden_size"])
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    x.requires_grad_()
    g = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    keep = 1.0 - RATE
    drop = Dropout(RATE).train()
    drop.generator = gen

    def port():
        torch.autograd.grad(drop(x), x, g)

    def four_pass():
        mask = torch.rand(shape, device="cuda", generator=gen) < keep
        y = torch.where(mask, x / keep,
                        torch.zeros((), dtype=x.dtype, device="cuda"))
        torch.autograd.grad(y, x, g)

    def library():
        torch.autograd.grad(F.dropout(x, RATE, True), x, g)

    return {"shape": list(shape), "dtype": "bfloat16", "rate": RATE,
            **{name: both_times(fn) for name, fn in (
                ("port", port), ("four_pass", four_pass),
                ("library", library))}}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_parts: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"dropout": dropout_times()}

    model = BERTSQuAD(use_flash=False, dtype=torch.bfloat16,
                      **dict(smoke.BERT_BASE, dropout=RATE)).cuda().train()
    calls = [0]
    for m in model.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(
                lambda *_: calls.__setitem__(0, calls[0] + 1))
    with torch.no_grad():
        model(torch.zeros(1, smoke.SEQ, dtype=torch.int32, device="cuda"))
    res["dropout_calls_per_step"] = calls[0]

    params = list(model.parameters())
    opt = optimizers.get("adamw", smoke.TRAIN_LR)
    state = opt.init(params)
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    res["adamw_step"] = dict(
        both_times(lambda: opt.step(params, grads, state)),
        tensors=len(params), elements=sum(p.numel() for p in params))
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
