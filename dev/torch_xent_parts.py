#!/usr/bin/env python3
"""Where the PyTorch port's bf16 fused cross-entropy backward spends its
time, on a CUDA card, at bench.py's vocab-head recipe (2,048 tokens, D 768,
V 30,522, bf16 h, f32 W, chunk 512).

Run from the root of a checkout:

    python3 dev/torch_xent_parts.py [--sass DIR] [--parent PKG]
        [-DNAME=VALUE | path.cu ...]

Each argument adds one build variant (``dev/parts_harness.py``) beside the
default build of ``csrc/fused_xent.cu``: ``-D`` flags, or another source
with the same C entry points, such as an earlier commit's unpacked with
``git archive`` (driven through this checkout's wrapper, whose workspace
covers the per-chunk backward's needs at this shape with an f32 W).
Every build is compiled with ``-Xptxas -v`` (its kernels' registers,
spills and warnings, C7515 "wgmma serialized" among them, are printed),
checked in a process of its own against ``fused_xent_bwd_reference`` (a
build that faults or disagrees is reported and left out), then the builds
that passed are timed in turns (default, variants, variants reversed,
default) in one process.  For each it prints one JSON line: the errors of
dh, dW and db relative to max |ref|, the CUDA-event time per call, the
card's kernel time per call from whole ``torch.profiler`` windows in all
and by pass (pack, dl, dh, dh_reduce, dw, db) and the counted TFLOP/s
(6 N D V); beside them the card's time of the bf16 forward (in all and
by kernel) and of the f32 forward and backward (f32 h) on the same
build.  Then, as a yardstick the port never calls, ``autograd.grad``
of ``F.cross_entropy`` over the materialised logits, and the card's name
and power limit.

``--parent PKG`` (an earlier commit's package, unpacked as
``dev/torch_bwd_parts.py`` says) then times that package's forward and
backward, its own wrapper on its own source, in turns with this
checkout's (this, parent, parent, this), bf16 and f32 each, the backward
by pass too, and says whether each forward's loss and lse equal this
checkout's bit for bit.

``--sass DIR`` also compiles ``flash_attention_fwd.cu``,
``flash_attention_fwd_f32.cu``, ``flash_attention_bwd.cu``, ``fused_bn.cu``
and ``fused_xent.cu`` from ``DIR`` (an earlier commit's ``csrc``) and from
this checkout, and prints for each source the
kernels whose ``cuobjdump -sass`` is identical, differs or exists on one
side only, and each side's registers.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

import parts_harness as harness
from parts_harness import smoke

fx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")
_build = harness._build
N = smoke.MLM_MICRO * smoke.SEQ
D, V = smoke.MLM["d_model"], smoke.MLM["vocab"]
CHUNK = smoke.MLM_CHUNK
PASSES = ("pack", "dl", "dh", "dh_reduce", "dw", "db")


def _demangle(names: list) -> list:
    """``names`` through ``c++filt`` where the machine has it, with the
    anonymous namespace's per-file tag left out."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        out = names
    return [re.sub(r"\(anonymous namespace\)::", "", n) for n in out]


def ptxas_report(log: str, match: str = "xent") -> dict:
    """ptxas's registers and spills for the kernels whose name holds
    ``match`` ({kernel: "N registers, S bytes spill stores, L bytes spill
    loads"}), and every warning (under "warnings")."""
    kernels, warnings, kernel = {}, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif "warning" in line.lower():
            warnings.append(line.strip())
        elif kernel and match in kernel:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels.setdefault(kernel, []).insert(0, f"{m.group(1)} "
                                                         "registers")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                kernels.setdefault(kernel, []).append(
                    f"{m.group(1)}/{m.group(2)} bytes spilled")
    names = sorted(kernels)
    report = {short: ", ".join(kernels[name])
              for name, short in zip(names, _demangle(names))}
    report["warnings"] = warnings
    return report


def inputs(dtype=torch.bfloat16) -> tuple:
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 5)
    h, w, bias, labels = smoke.xent_inputs(gen, N, D, V, dtype)
    _, lse = fx.fused_xent_fwd(h, w, bias, labels, CHUNK)
    return h, w, bias, labels, lse, torch.tensor(1.0, device="cuda")


def errors(data) -> dict:
    got = fx.fused_xent_bwd(*data, CHUNK)
    ref = fx.fused_xent_bwd_reference(*data, CHUNK)
    out = {}
    for name, a, b in zip(("dh", "dw", "db"), got, ref):
        out[f"{name}_rel_err"] = ((a.float() - b.float()).abs().max().item()
                                  / b.float().abs().max().item())
        out[f"{name}_finite"] = bool(torch.isfinite(a).all())
    return out


def check(path: str) -> int:
    """One build against the plain version, in this process; exits
    non-zero on a fault or an error above chip_smoke's tolerances."""
    harness.use(fx.SOURCE, path)
    err = errors(inputs())
    ok = (all(err[f"{n}_finite"] for n in ("dh", "dw", "db"))
          and err["dh_rel_err"] <= smoke.TOL_XENT_BF16_DH
          and err["dw_rel_err"] <= smoke.TOL_XENT_BF16_SUM
          and err["db_rel_err"] <= smoke.TOL_XENT_BF16_SUM)
    print(json.dumps({"check": path, **err}), flush=True)
    return 0 if ok else 1


def by_pass(fn, iters: int = 10) -> dict:
    """Kernel time per call of ``fn`` by pass, from one whole profiler
    window."""
    out = dict.fromkeys(PASSES, 0.0)
    for name, (_, us) in smoke.device_windows(fn, iters, runs=1)[0].items():
        m = re.search(r"xent_(?:wg_|bwd_|tf_)?([a-z_]+)", name)
        key = m.group(1) if m else name
        out[key] = out.get(key, 0.0) + us / 1e3 / iters
    return out


def fwd_by_kernel(fn, iters: int = 10) -> dict:
    """Kernel time per call of a forward ``fn`` by kernel (pack, tiles,
    finalize, mean), from one whole profiler window."""
    out = {}
    for name, (_, us) in smoke.device_windows(fn, iters, runs=1)[0].items():
        m = re.search(r"xent_(\w+?)[<(]", name)
        key = m.group(1) if m else name
        out[key] = out.get(key, 0.0) + us / 1e3 / iters
    return out


def measure(label: str, path: str, data, data_f32) -> None:
    harness.use(fx.SOURCE, path)

    def kernel():
        return fx.fused_xent_bwd(*data, CHUNK)

    others = {}  # the forwards and the f32 backward, for a build's side
    for name, dt in (("", data), ("f32_", data_f32)):
        h, w, bias, labels, lse, g = dt
        others[f"{name}fwd_device_ms"] = smoke.device_ms(
            lambda: fx.fused_xent_fwd(h, w, bias, labels, CHUNK), iters=10)
    h, w, bias, labels = data[:4]
    others["fwd_device_ms_by_kernel"] = fwd_by_kernel(
        lambda: fx.fused_xent_fwd(h, w, bias, labels, CHUNK))
    others["f32_bwd_device_ms"] = smoke.device_ms(
        lambda: fx.fused_xent_bwd(*data_f32, CHUNK), iters=10)
    print(json.dumps({
        "build": label, "n": N, "d": D, "v": V, "chunk": CHUNK,
        **errors(data),
        **harness.timing(kernel, 6.0 * N * D * V, iters=10),
        "device_ms_by_pass": by_pass(kernel),
        "bound_ms": smoke.xent_bound(N, D, V, 2, 4, "bwd")[0], **others}),
        flush=True)


def against_parent(parent: str, data, data_f32) -> None:
    """This checkout's backward and the parent package's in turns, both
    dtypes: errors, card time in all and by pass, and the bounds (3xTF32
    and the f32 FMAs' for f32)."""
    parent_fx = harness.parent_ops(parent, "fused_xent")[0]
    for label, mod in (("this", fx), ("parent", parent_fx),
                       ("parent", parent_fx), ("this", fx)):
        for dt in (data, data_f32):
            h, w, bias, labels = dt[:4]
            fwd = mod.fused_xent_fwd(h, w, bias, labels, CHUNK)
            mine = fx.fused_xent_fwd(h, w, bias, labels, CHUNK)
            fwd_same = all(torch.equal(a, b) for a, b in zip(fwd, mine))
            fwd_ms = smoke.device_ms(
                lambda: mod.fused_xent_fwd(h, w, bias, labels, CHUNK),
                iters=10)
            fwd_kernels = fwd_by_kernel(
                lambda: mod.fused_xent_fwd(h, w, bias, labels, CHUNK))
            got = mod.fused_xent_bwd(*dt, CHUNK)
            ref = fx.fused_xent_bwd_reference(*dt, CHUNK)
            err = max((a.float() - b.float()).abs().max().item()
                      / b.float().abs().max().item()
                      for a, b in zip(got, ref))
            del got, ref

            def kernel():
                return mod.fused_xent_bwd(*dt, CHUNK)

            size = dt[0].element_size()
            print(json.dumps({
                "build": label, "dtype": str(dt[0].dtype).replace(
                    "torch.", ""), "design": mod.bwd_design(dt[0].dtype),
                "n": N, "d": D, "v": V, "max_rel_err": err,
                **harness.timing(kernel, 6.0 * N * D * V, iters=10),
                "device_ms_by_pass": by_pass(kernel),
                "fwd_device_ms": fwd_ms,
                "fwd_device_ms_by_kernel": fwd_kernels,
                "fwd_bitwise_equal_to_this": fwd_same,
                "bound_ms": smoke.xent_bound(N, D, V, size, 4, "bwd")[0],
                "fma_bound_ms": smoke.xent_bound(N, D, V, size, 4, "bwd",
                                                 fma=True)[0]
                if size == 4 else None}), flush=True)


def _functions(sass: str) -> dict:
    """``cuobjdump -sass`` output as {kernel: its lines}, the anonymous
    namespace's per-file tag left out of every line."""
    out, name = {}, None
    for line in sass.splitlines():
        line = re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}(_\w+?_cu_)[0-9a-f]{8}",
                      r"\g<1>00000000\g<2>00000000", line)
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def sass_check(parent: str) -> None:
    """The kernels' SASS and registers in the flash, batch-norm and
    cross-entropy sources as built from
    ``parent`` (an earlier commit's csrc) and from this checkout: for each
    source, the kernels whose SASS is identical, differs, or exists on one
    side only."""
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out_dir = _build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for src, match in (("flash_attention_fwd.cu", "flash"),
                       ("flash_attention_fwd_f32.cu", "_"),
                       ("flash_attention_bwd.cu", "_"),
                       ("fused_bn.cu", "bn"),
                       ("fused_xent.cu", "xent")):
        result, sides = {"source": src}, []
        for tag, root in (("parent", Path(parent)), ("this", _build.CSRC)):
            cubin = out_dir / f"{tag}-{src}.cubin"
            proc = subprocess.run(
                [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
                 str(root / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)
            log = proc.stdout.decode(errors="replace")
            if proc.returncode != 0:
                raise RuntimeError(log)
            result[f"ptxas_{tag}"] = ptxas_report(log, match)
            sides.append(_functions(subprocess.run(
                [cuobjdump, "-sass", str(cubin)], capture_output=True,
                text=True, check=True).stdout))
        parent_fns, this_fns = sides
        groups = {
            "identical": [n for n in parent_fns
                          if this_fns.get(n) == parent_fns[n]],
            "differ": [n for n in parent_fns
                       if n in this_fns and this_fns[n] != parent_fns[n]],
            "only_parent": [n for n in parent_fns if n not in this_fns],
            "only_this": [n for n in this_fns if n not in parent_fns]}
        for key, names in groups.items():
            result[key] = _demangle(names) if names else []
        print(json.dumps(result), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--check"]:
        return check(argv[1])
    if not torch.cuda.is_available():
        print("torch_xent_parts: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parent, argv = harness.take_parent(list(argv))
    if argv[:1] == ["--sass"]:
        sass_check(argv[1])
        argv = argv[2:]
    builds = ["default"] + list(argv)
    built = harness.build_variants(fx.SOURCE, builds, ("-Xptxas", "-v"))
    for label, (_, log) in zip(builds, built):
        print(json.dumps({"build": label, "ptxas": ptxas_report(log)}),
              flush=True)
    # each build checked in a process of its own, all at once, so that a
    # build that faults leaves the others to be timed
    checks = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                "--check", path]) for path, _ in built]
    passed = []
    for label, (path, _), proc in zip(builds, built, checks):
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        print(json.dumps({"build": label, "check_rc": rc}), flush=True)
        if rc == 0:
            passed.append((label, path))
    data, data_f32 = inputs(), inputs(torch.float32)
    for i in harness.in_turns(len(passed)):
        measure(*passed[i], data, data_f32)
    if parent:
        harness.use(fx.SOURCE, built[0][0])
        against_parent(parent, data, data_f32)
    h, w, bias, labels, _, _ = data
    lib_h, lib_w, lib_b = (t.detach().requires_grad_() for t in (h, w, bias))
    lib_out = torch.nn.functional.cross_entropy(
        lib_h @ lib_w.to(h.dtype) + lib_b, labels)

    def library():
        return torch.autograd.grad(lib_out, (lib_h, lib_w, lib_b),
                                   retain_graph=True)

    print(json.dumps({
        "build": "autograd.grad of F.cross_entropy(h @ w.to(h.dtype) + b)",
        "n": N, "d": D, "v": V,
        **harness.timing(library, 6.0 * N * D * V, iters=10)}), flush=True)
    print(harness.card(), flush=True)
    return 0 if len(passed) == len(builds) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
