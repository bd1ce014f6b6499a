"""What ``dev/torch_fwd_parts.py`` and ``dev/torch_bwd_parts.py`` share:
build variants of a kernel's source in parallel, point the port's wrapper
at one of them, time them in turns, time one call, and name the card.

A variant is the default build of ``csrc/<source>.cu`` (``"default"``),
the same source with macros set (one argument, ``-D`` flags apart by
spaces), or another source with the same C entry points (the path of an
edited copy, or of an earlier commit's, unpacked with ``git archive``
into a directory ``.gitignore`` lists).
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops import _build  # noqa: E402


def build_variant(source: str, arg: str, extra=()) -> tuple:
    """One variant of ``csrc/<source>.cu`` (``arg`` as the module says),
    compiled with ``extra`` flags too: its library's path and nvcc's
    output."""
    if arg.endswith(".cu"):
        flags, src = [], os.path.abspath(arg)
    else:
        flags = [] if arg == "default" else arg.split()
        src = str(_build.CSRC / f"{source}.cu")
    name = "".join(c if c.isalnum() else "_" for c in arg)
    path = _build.BUILD_DIR / f"lib{source}-variant-{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, *flags, "-o",
         str(path), src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(log)
    return str(path), log


def build_variants(source: str, builds, extra=()) -> list:
    """Every variant of ``builds`` at once, one nvcc each: (path, nvcc's
    output) in their order."""
    with ThreadPoolExecutor() as pool:
        return list(pool.map(lambda b: build_variant(source, b, extra),
                             builds))


def use(source: str, path: str) -> None:
    """Point the wrapper at the library at ``path`` for ``csrc/<source>.cu``
    (it loads its libraries through ``_build``'s cache)."""
    _build._loaded[source] = ctypes.CDLL(path)


def in_turns(n: int) -> list:
    """The order that times ``n`` builds in turns: the default (0), the
    variants, the variants reversed, the default again."""
    order = list(range(n))
    return order + order[1:][::-1] + [0] if n > 1 else order


def timing(fn, flops: float, iters: int = 20) -> dict:
    """One call of ``fn``'s CUDA-event time (``ms``), the card's kernel
    time (``device_ms``, from ``torch.profiler``) and ``flops`` over the
    latter."""
    dev = smoke.device_ms(fn, iters=iters)
    return {"ms": smoke.cuda_ms(fn, iters=iters), "device_ms": dev,
            "counted_tflop_per_s": flops / dev / 1e9}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def parent_ops(pkg: str, module: str) -> tuple:
    """The ``ops.<module>`` module of the package at ``pkg`` (an earlier
    commit's ``analytics_zoo_tpu_torch``, unpacked with ``git archive``
    into a directory ``.gitignore`` lists), imported as
    ``parent_analytics_zoo_tpu_torch`` (its relative imports stay inside
    it, and it builds its own ``csrc`` into its own build directory), and
    that package's ``_build``."""
    name = "parent_analytics_zoo_tpu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.{module}"),
            importlib.import_module(f"{name}.ops._build"))


def take_parent(argv: list) -> tuple:
    """(the package of ``--parent PKG`` or None, the other arguments)."""
    if "--parent" in argv:
        i = argv.index("--parent")
        return argv[i + 1], argv[:i] + argv[i + 2:]
    return None, argv
