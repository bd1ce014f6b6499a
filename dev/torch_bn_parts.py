#!/usr/bin/env python3
"""The PyTorch port's fused batch norm on a CUDA card at every one of
ResNet-50's 12 distinct batch-norm maps at batch 128 (224 x 224, the
space-to-depth stem), both dtypes and directions, beside an earlier
commit's source and wrapper and ``F.batch_norm``.

Run from the root of a checkout:

    python3 dev/torch_bn_parts.py [--maps I,J,...] [--parent DIR]
                                  [-DNAME=VALUE | path.cu ...]

``--maps`` times only the maps of those indices (0 the stem, 11 the last
stage, in the order of the forward; the per-step sum then covers only
them).
``--parent DIR`` names an earlier commit's ``analytics_zoo_tpu_torch``
package, unpacked with ``git archive`` into a directory ``.gitignore``
lists (``mkdir -p build/parent && git archive <commit>
analytics_zoo_tpu_torch | tar -x -C build/parent``, then ``--parent
build/parent/analytics_zoo_tpu_torch``): it is imported under another name
and drives its own ``csrc/fused_bn.cu`` through its own wrapper, so a
source with other C entry points is timed as its callers ran it.  Each
other argument adds one build variant of this checkout's source
(``dev/parts_harness.py``).  Every build is compiled with ``-Xptxas -v``
(registers and spills printed).  At each map, dtype and direction the
builds are timed in turns (this checkout's default build, the variants,
the parent, then back), each turn the card's kernel time per call from
whole ``torch.profiler`` windows (``device_ms``, the barrier word's reset
included) and the CUDA-event time per call (``ms``: with the host's
launch, whose cost shows where it exceeds ``device_ms``); beside them
``F.batch_norm(training=True)`` on the same channels_last map and its
``autograd.grad`` (a yardstick the port never calls), the bound and each
build's worst error against the plain version.  Last, the time of the
53 norms of a step (each map's time times the norms that see it) against
the bound's sum, and the card's name and power limit.  One JSON line
each.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import math
import os
import subprocess
import sys

import torch

import parts_harness as harness
from parts_harness import smoke
from torch_xent_parts import ptxas_report

bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
EPS = 1e-3
DTYPES = (torch.bfloat16, torch.float32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def channels_last(t, rows, c):
    side = math.isqrt(rows // smoke.RESNET_BATCH)
    return t.view(smoke.RESNET_BATCH, side, side, c).permute(0, 3, 1, 2)


def worst_error(mod, x, g, b, dy, dm, dv, ref) -> float:
    """The larger of y's and dx's max error against the plain version,
    relative to max(1, max |ref|)."""
    y, m, v = mod.bn_train_fwd(x, g, b, EPS)
    dx, _, _ = mod.bn_train_bwd(x, g, m, v, dy, dm, dv, EPS)
    return max((a.float() - r.float()).abs().max().item()
               / max(1.0, r.float().abs().max().item())
               for a, r in zip((y, dx), ref))


def trace(maps: dict) -> None:
    """The forward's phases per block (a ``-DFUSED_BN_TRACE`` build: thread
    0's clock at each boundary), bf16 and f32 at ``maps``: the median and
    the largest over the blocks of each phase's cycles, and the spread of
    the blocks' start times."""
    path, _ = harness.build_variant(bn.SOURCE, "-DFUSED_BN_TRACE")
    harness.use(bn.SOURCE, path)
    lib = harness._build._loaded[bn.SOURCE]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 8)
    phases = ("stream", "resident", "partials", "barrier1", "finalize",
              "barrier2", "output")
    for rows, c in maps:
        for dt in DTYPES:
            x, g, b, *_ = smoke.bn_inputs(gen, rows, c, dt)
            for _ in range(3):
                bn.bn_train_fwd(x, g, b, EPS)
            torch.cuda.synchronize()
            bn.bn_train_fwd(x, g, b, EPS)
            torch.cuda.synchronize()
            buf = torch.zeros(1024, 10, dtype=torch.int64)
            if lib.fused_bn_trace(ctypes.c_void_p(buf.data_ptr())):
                raise RuntimeError("fused_bn_trace failed")
            p = bn.plan(rows, c, x.element_size(), True, "fwd",
                        bn._sm_count(x.device.index))
            t = buf[:p.blocks].double()
            row = {"trace": [rows, c], "dtype": str(dt),
                   "start_spread_ns": (t[:, 0].max() - t[:, 0].min()).item(),
                   "total_cycles": (t[:, 8] - t[:, 1]).median().item()}
            for k, name in enumerate(phases):
                d = t[:, k + 2] - t[:, k + 1]
                row[name] = [d.median().item(), d.max().item()]
            emit(row)
    emit({"sm_clock": subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()})


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_bn_parts: no CUDA device", file=sys.stderr)
        return 2
    parent, only = None, None
    if argv[:1] == ["--trace"]:
        maps = list(smoke.resnet_bn_maps(smoke.RESNET_BATCH))
        trace([maps[int(i)] for i in argv[1].split(",")])
        return 0
    if argv[:1] == ["--maps"]:
        only, argv = [int(i) for i in argv[1].split(",")], argv[2:]
    if argv[:1] == ["--parent"]:
        parent, argv = argv[1], argv[2:]
    builds = ["default"] + list(argv)
    sources = list(builds)
    if parent:
        sources.append(os.path.join(parent, "csrc", f"{bn.SOURCE}.cu"))
    built = harness.build_variants(bn.SOURCE, sources, ("-Xptxas", "-v"))
    sides = [(label, bn, path) for label, (path, _) in zip(builds, built)]
    if parent:
        parent_bn, parent_build = harness.parent_ops(parent, "fused_bn")
        parent_build._loaded[parent_bn.SOURCE] = ctypes.CDLL(built[-1][0])
        sides.append(("parent", parent_bn, None))
    for (label, _, _), (_, log) in zip(sides, built):
        emit({"build": label, "ptxas": ptxas_report(log, "bn_")})

    def use(i):
        label, mod, path = sides[i]
        if path:
            harness.use(bn.SOURCE, path)
        return label, mod

    maps = smoke.resnet_bn_maps(smoke.RESNET_BATCH)
    if only is not None:
        maps = {k: n for i, (k, n) in enumerate(maps.items()) if i in only}
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 7)
    per_step: dict = {}
    for (rows, c), norms in maps.items():
        for dt in DTYPES:
            x, g, b, dy, dm, dv = smoke.bn_inputs(gen, rows, c, dt)
            ry, rm, rv = bn.bn_train_fwd_reference(x, g, b, EPS)
            rdx, _, _ = bn.bn_train_bwd_reference(x, g, rm, rv, dy, dm, dv,
                                                  EPS)
            errors = {}
            for i in range(len(sides)):
                label, mod = use(i)
                errors[label] = worst_error(mod, x, g, b, dy, dm, dv,
                                            (ry, rdx))
            del ry, rdx
            use(0)
            m, v = bn.bn_train_fwd(x, g, b, EPS)[1:]
            lib_in = channels_last(x, rows, c).detach().requires_grad_()
            lib_w, lib_b = (t.detach().requires_grad_() for t in (g, b))
            run_m = torch.zeros(c, device="cuda")
            run_v = torch.ones(c, device="cuda")

            def lib_fwd():
                return torch.nn.functional.batch_norm(
                    lib_in, run_m, run_v, lib_w, lib_b, training=True,
                    momentum=0.01, eps=EPS)

            lib_out = lib_fwd()
            dy4 = channels_last(dy, rows, c)

            def lib_bwd():
                return torch.autograd.grad(lib_out, (lib_in, lib_w, lib_b),
                                           dy4, retain_graph=True)

            for direction, library in (("fwd", lib_fwd), ("bwd", lib_bwd)):
                times: dict = {}
                for i in harness.in_turns(len(sides)):
                    label, mod = use(i)
                    call = ((lambda: mod.bn_train_fwd(x, g, b, EPS))
                            if direction == "fwd" else
                            (lambda: mod.bn_train_bwd(x, g, m, v, dy, dm,
                                                      dv, EPS)))
                    times.setdefault(label, []).append({
                        "device_ms": smoke.device_ms(call, iters=10),
                        "ms": smoke.cuda_ms(call, iters=10)})
                bound_ms, _ = smoke.bn_bound(rows, c, x.element_size(),
                                             direction)
                row = {"rows": rows, "c": c, "norms": norms,
                       "dtype": str(dt).replace("torch.", ""),
                       "direction": direction, "bound_ms": bound_ms,
                       "worst_err_vs_plain": errors, "builds": times,
                       "library_device_ms": smoke.device_ms(library,
                                                            iters=10),
                       "library_ms": smoke.cuda_ms(library, iters=10)}
                emit(row)
                for label, turns in [*times.items(),
                                     ("F.batch_norm",
                                      [{"device_ms":
                                        row["library_device_ms"]}]),
                                     ("bound", [{"device_ms": bound_ms}])]:
                    best = min(t["device_ms"] for t in turns)
                    key = f"{label} {row['dtype']} {direction}"
                    per_step[key] = per_step.get(key, 0.0) + norms * best
            del x, dy, lib_in, lib_out, dy4
            torch.cuda.empty_cache()
    emit({"per_step_ms": per_step,
          "convention": "sum over ResNet-50's 53 norms at batch 128 of the "
                        "map's device ms (the faster of a build's turns) "
                        "times the norms that see it"})
    print(harness.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
