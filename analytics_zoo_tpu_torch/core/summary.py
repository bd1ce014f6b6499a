# Port of analytics_zoo_tpu/core/summary.py: a copy, which imports nothing of
# the JAX package.
"""Scalar training summaries (TrainSummary/ValidationSummary parity).

Reference (SURVEY.md §5.1): BigDL wrote per-iteration scalars (loss, lr,
throughput) as TensorBoard event files, enabled from zoo via
``KerasNet.set_tensorboard`` (zoo/.../pipeline/api/keras/models/Topology.scala).

Here: a small append-only JSONL writer (always available, trivially parseable)
plus an optional TensorBoard event-file writer when ``tensorboard`` or
``tensorboardX`` is importable.  The Estimator calls ``add_scalar`` per step /
epoch; ``read_scalar`` gives programmatic access the way the reference's
``TrainSummary.read_scalar`` did.
"""

from __future__ import annotations

import atexit
import json
import os
import time
import weakref
from typing import Dict, List, Optional, Tuple


# Close leaked writers while the interpreter is fully alive: the backend
# writer owns background threads whose teardown during interpreter
# shutdown is unsafe.
_live_writers: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _close_all_writers() -> None:
    for w in list(_live_writers):
        try:
            w.close()
        except Exception:  # noqa: BLE001 — best-effort shutdown
            pass


class SummaryWriter:
    def __init__(self, log_dir: str, app_name: str = "train"):
        self.log_dir = os.path.join(log_dir, app_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._path = os.path.join(self.log_dir, "scalars.jsonl")
        self._file = open(self._path, "a")
        self._tb = self._try_tensorboard()
        _live_writers.add(self)

    def _try_tensorboard(self):
        # torch's writer first: it uses a background THREAD.  tensorboardX
        # spawns a multiprocessing child — forking a process that already
        # carries JAX/TF threads aborts intermittently (absl/grpc mutexes
        # held across fork), which took out whole test-suite runs.
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
            return TBWriter(self.log_dir)
        except Exception:
            pass
        try:
            from tensorboardX import SummaryWriter as TBWriter  # type: ignore
            return TBWriter(self.log_dir)
        except Exception:
            return None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "wall": time.time()}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """Return [(step, value), ...] for a tag (TrainSummary.read_scalar)."""
        out = []
        try:
            with open(self._path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["tag"] == tag:
                        out.append((rec["step"], rec["value"]))
        except OSError:
            pass
        return out

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
