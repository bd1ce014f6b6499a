#!/usr/bin/env python3
"""How far the port's int8 serving moves a model's logits, on the CPU at
reduced widths: the numbers ``chip_smoke.py``'s ``int8_serve`` tolerances
were set from, before the same comparisons ran at full width on the card.

Run from the root of a checkout (a minute or so on a few cores):

    python3 dev/torch_int8_cpu_error.py

Prints one JSON line per comparison, each error as max |got - ref| /
max(1, max |ref|) (``chip_smoke.py``'s measure):
- a 12-layer BERT classifier at width 256 (4 heads, seq 128; BERT-base's
  depth, FFN ratio and vocabulary) from ``chip_smoke.random_bert_variables``:
  bf16, int8 weight-only and int8 calibrated (16 seeded sequences), each
  against the f32 model with the dense attention, over batches of 3 and 16;
- ResNet-50 (``norm="batch"``, 7x7 stem) at width 16 on 64 x 64 images
  from ``chip_smoke.random_resnet_variables``: bf16, int8 weight-only and
  int8 calibrated (8 seeded images) against f32, and calibrated int8
  against bf16 (``int8_serve``'s comparison), with the share of images
  whose top-1 class agrees.
All on ``device="cpu"`` through ``InferenceModel``: the kernels' plain
versions, no card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.models import BERTClassifier, ResNet  # noqa: E402
from analytics_zoo_tpu_torch.serving import InferenceModel  # noqa: E402

BERT = dict(chip_smoke.BERT_BASE, hidden_size=256, n_heads=4,
            max_position=128)
SEQ = 128


def rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def bert() -> None:
    variables = chip_smoke.random_bert_variables(
        BERTClassifier(2, use_flash=True, **BERT), chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    vocab = BERT["vocab_size"]
    batches = [rng.integers(0, vocab, (n, SEQ)).astype(np.int32)
               for n in (3, 16)]
    calib = np.random.default_rng(chip_smoke.SEED + 2).integers(
        0, vocab, (16, SEQ)).astype(np.int32)

    def served(use_flash=True, **load):
        return InferenceModel(device="cpu").load(
            BERTClassifier(2, use_flash=use_flash, **BERT), variables, **load)

    ref = served(use_flash=False)
    refs = [ref.predict(x) for x in batches]
    for name, load in (("bf16", dict(dtype=torch.bfloat16)),
                       ("int8_weight_only", dict(dtype="int8")),
                       ("int8_calibrated", dict(dtype="int8",
                                                calibrate=calib))):
        im = served(**load)
        err = max(rel(im.predict(x), r) for x, r in zip(batches, refs))
        print(json.dumps({"model": "bert", "config": BERT, "seq": SEQ,
                          "serving": name, "vs": "f32 dense",
                          "max_err_rel_to_max": err}), flush=True)


def resnet() -> None:
    def model():
        return ResNet(depth=50, class_num=1000, width=16, norm="batch")

    variables = chip_smoke.random_resnet_variables(model(), chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    images = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    calib = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)

    def served(**load):
        return InferenceModel(device="cpu", batch_buckets=(8,)).load(
            model(), variables, **load).predict(images)

    f32 = served()
    bf16 = served(dtype=torch.bfloat16)
    outs = {"bf16": bf16, "int8_weight_only": served(dtype="int8"),
            "int8_calibrated": served(dtype="int8", calibrate=calib)}
    for name, out in outs.items():
        print(json.dumps({"model": "resnet50", "width": 16, "image": 64,
                          "serving": name, "vs": "f32",
                          "max_err_rel_to_max": rel(out, f32)}), flush=True)
    cal = outs["int8_calibrated"]
    print(json.dumps({"model": "resnet50", "width": 16, "image": 64,
                      "serving": "int8_calibrated", "vs": "bf16",
                      "max_err_rel_to_max": rel(cal, bf16),
                      "top1_agree": float(np.mean(cal.argmax(1)
                                                  == bf16.argmax(1)))}),
          flush=True)


if __name__ == "__main__":
    torch.manual_seed(chip_smoke.SEED)
    bert()
    resnet()
