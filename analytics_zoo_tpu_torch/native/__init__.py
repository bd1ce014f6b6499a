# Port of analytics_zoo_tpu/native/__init__.py: a copy that builds the
# port's own copy of zoo_native.cpp into the port's build directory.
"""Native (C++) runtime: bounded MPMC byte queue + batch assembly.

Reference parity (SURVEY.md §2.10): the reference's host data plane was
native (BlockManager/plasma/Redis/PMEM behind JNI).  Here the equivalent —
the queueing/synchronization under data prefetch and serving batching — is
C++ (zoo_native.cpp), compiled on first use with g++ and loaded via
ctypes.  A pure-Python fallback (queue.Queue) keeps every feature working if
no compiler is available; ``NativeQueue.is_native`` reports which is active.

Port: the source is the port's own copy, and the library is built into
``analytics_zoo_tpu_torch/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and the flags, as ``ops/_build.py``
names the kernels: an edited source rebuilds, and no built file lives
beside the source or is committed.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import logging
import os
import queue as pyqueue
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu")

SRC = Path(__file__).resolve().parent / "zoo_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library built from ``zoo_native.cpp`` lives: its name
    carries a hash of the source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libzoonative-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library's path, compiled first unless it exists; None (with a
    warning) when it cannot be built."""
    so = library_path()
    if so.exists():
        return so
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent builds race safely
        return so
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        logger.warning("native build failed (%s); using Python fallback "
                       "queue", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use (None if
    unavailable — callers must fall back)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        so = _build()
        try:
            lib = ctypes.CDLL(str(so)) if so is not None else None
        except OSError as e:
            logger.warning("native library %s failed to load (%s); using "
                           "Python fallback queue", so, e)
            lib = None
        if lib is None:
            _lib = False
            return None
        lib.zn_queue_create.restype = ctypes.c_void_p
        lib.zn_queue_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.zn_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.zn_queue_close.argtypes = [ctypes.c_void_p]
        lib.zn_queue_push.restype = ctypes.c_int
        lib.zn_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_size_t, ctypes.c_uint64,
                                      ctypes.c_int]
        lib.zn_queue_pop.restype = ctypes.c_longlong
        lib.zn_queue_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.c_int]
        lib.zn_queue_next_size.restype = ctypes.c_size_t
        lib.zn_queue_next_size.argtypes = [ctypes.c_void_p]
        lib.zn_queue_len.restype = ctypes.c_size_t
        lib.zn_queue_len.argtypes = [ctypes.c_void_p]
        lib.zn_queue_pushed.restype = ctypes.c_uint64
        lib.zn_queue_pushed.argtypes = [ctypes.c_void_p]
        lib.zn_queue_popped.restype = ctypes.c_uint64
        lib.zn_queue_popped.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


# Every live queue, closed from an atexit hook: worker threads blocked in
# push/pop must wake and exit while the interpreter is still fully alive —
# a daemon thread returning from the (GIL-released) native call during
# interpreter teardown is a "Fatal Python error" crash.
_live_queues: "weakref.WeakSet[NativeQueue]" = weakref.WeakSet()


@atexit.register
def _close_all_queues() -> None:
    for q in list(_live_queues):
        try:
            q.close()
        except Exception:  # noqa: BLE001 — best-effort shutdown
            pass


class NativeQueue:
    """Bounded MPMC byte queue; C++-backed when the native lib builds."""

    def __init__(self, max_items: int = 0, max_bytes: int = 0):
        lib = get_lib()
        self._lib = lib
        if lib is not None:
            self._q = lib.zn_queue_create(max_items, max_bytes)
            self.is_native = True
        else:
            self._pyq = pyqueue.Queue(maxsize=max_items or 0)
            self.is_native = False
        self._closed = False
        _live_queues.add(self)

    # -- ops ------------------------------------------------------------------

    def push(self, payload: bytes, tag: int = 0,
             timeout: Optional[float] = None) -> bool:
        """False on timeout; raises if the queue is closed."""
        if self.is_native:
            rc = self._lib.zn_queue_push(
                self._q, payload, len(payload), tag,
                -1 if timeout is None else int(timeout * 1000))
            if rc == -2:
                raise RuntimeError("queue closed")
            return rc == 0
        # poll in short slices so close() can wake a blocked producer (the
        # C++ path gets this from the condvar broadcast in zn_queue_close)
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            if self._closed:
                raise RuntimeError("queue closed")
            slice_t = 0.05
            if deadline is not None:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                slice_t = min(slice_t, left)
            try:
                self._pyq.put((payload, tag), timeout=slice_t)
                return True
            except pyqueue.Full:
                continue

    def pop(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[bytes, int]]:
        """(payload, tag) or None on timeout; raises when closed+drained."""
        if self.is_native:
            tag = ctypes.c_uint64(0)
            size = self._lib.zn_queue_next_size(self._q)
            buf = ctypes.create_string_buffer(max(size, 1 << 16))
            while True:
                rc = self._lib.zn_queue_pop(
                    self._q, buf, len(buf), ctypes.byref(tag),
                    -1 if timeout is None else int(timeout * 1000))
                if rc == -3:        # distinct from a popped empty payload
                    return None
                if rc == -2:
                    raise RuntimeError("queue closed")
                if rc < 0:          # buffer too small: retry with exact size
                    buf = ctypes.create_string_buffer(-rc)
                    continue
                return buf.raw[:rc], tag.value
        try:
            item = self._pyq.get(timeout=timeout)
        except pyqueue.Empty:
            if self._closed:
                raise RuntimeError("queue closed") from None
            return None
        if item is None:
            raise RuntimeError("queue closed")
        return item

    def close(self) -> None:
        self._closed = True
        if self.is_native:
            self._lib.zn_queue_close(self._q)
        else:
            try:
                self._pyq.put_nowait(None)
            except pyqueue.Full:
                pass

    def __len__(self) -> int:
        if self.is_native:
            return int(self._lib.zn_queue_len(self._q))
        return self._pyq.qsize()

    def stats(self) -> Tuple[int, int]:
        if self.is_native:
            return (int(self._lib.zn_queue_pushed(self._q)),
                    int(self._lib.zn_queue_popped(self._q)))
        return (-1, -1)

    def __del__(self):
        try:
            if getattr(self, "is_native", False):
                self._lib.zn_queue_destroy(self._q)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
