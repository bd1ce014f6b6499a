#!/usr/bin/env python3
"""Seconds of ``chip_smoke.py``'s ``kernel`` phase alone, for the checkout
the script is run from, as the full run's ``{"phase_seconds": "kernel"}``
line counts them: the flash sources are built first, outside the time.

Run from the root of a checkout (an earlier commit's too, unpacked with
``git archive`` into a directory ``.gitignore`` lists), on a CUDA card:

    python3 path/to/dev/kernel_phase_seconds.py

Prints the phase's own JSON line, then ``{"kernel_phase_seconds": s}``.
Two checkouts are compared in one call, in turns (parent, change, change,
parent).
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phase_seconds: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from analytics_zoo_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in (smoke.BF16_KERNEL, smoke.F32_KERNEL, smoke.BWD_KERNEL):
        _build.build(name)
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    t = time.perf_counter()
    smoke.phase_kernel(fa)
    print(json.dumps({"checkout": os.getcwd(),
                      "kernel_phase_seconds": time.perf_counter() - t}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
