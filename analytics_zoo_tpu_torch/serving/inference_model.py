"""InferenceModel (port of ``analytics_zoo_tpu/serving/inference_model.py``,
float subset).

Same serving rules as the JAX package: a request batch is padded to the
nearest batch bucket by repeating its last row, a batch beyond the largest
bucket is served in chunks, the result is trimmed to the request, and
``concurrent_num`` bounds the host threads in flight.  PyTorch runs eagerly,
so there is no per-shape compile: ``warm`` runs one forward per (shape,
bucket) so that the kernel build and the library handles are in place
before traffic arrives, and ``compile_count`` stays 0.

The int8 paths, ``save_executables``/``load_executables`` and
``enable_aot_cache`` are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..convert import from_jax_variables


class InferenceModel:
    def __init__(self, concurrent_num: int = 4,
                 batch_buckets: Sequence[int] = (1, 4, 16, 64),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.concurrent_num = concurrent_num
        self.batch_buckets = sorted(batch_buckets)
        self._model: Optional[nn.Module] = None
        self._sema = threading.Semaphore(concurrent_num)
        # no compile in eager PyTorch: stays 0 (kept for the JAX API, where
        # it counts fresh XLA compiles)
        self.compile_count = 0

    def load(self, model: nn.Module, variables: Mapping[str, Any],
             dtype: Optional[torch.dtype] = None) -> "InferenceModel":
        """Load ``variables`` (a ``state_dict``, or a JAX ``{"params",
        "state"}`` tree of arrays) into ``model``, move it to the device and
        cast its floating parameters to ``dtype`` once (e.g.
        ``torch.bfloat16``).  Integer inputs such as token ids are never
        cast.  The model is put in eval mode and owned by this object."""
        if "params" in variables:
            variables = from_jax_variables(variables)
        model.load_state_dict(dict(variables), strict=True)
        model.to(device=self.device)
        if dtype is not None:
            model.to(dtype=dtype)  # floating parameters only
        self._model = model.eval()
        return self

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def warm(self, shapes: Sequence[Tuple[int, ...]],
             dtype: Any = np.float32,
             buckets: Optional[Sequence[int]] = None) -> int:
        """Run one forward per per-row shape x batch bucket (``buckets``
        defaults to every ``batch_buckets`` entry) on zeros of ``dtype``;
        returns the number of (shape, bucket) pairs run."""
        use = self.batch_buckets if buckets is None else sorted(
            int(b) for b in buckets)
        n = 0
        for shape in shapes:
            for b in use:
                self._run(np.zeros((int(b),) + tuple(int(s) for s in shape),
                                   dtype=dtype))
                n += 1
        return n

    def _run(self, xp: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(xp)).to(self.device)
        with self._sema, torch.inference_mode():
            out = self._model(x)
            if out.dtype == torch.bfloat16:  # numpy has no bf16
                out = out.float()
            return out.cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched forward: pads to the nearest bucket, chunks beyond the
        largest, trims the result to the request's rows."""
        if self._model is None:
            raise ValueError("no model loaded")
        x = np.asarray(x)
        n = x.shape[0]
        bucket = self._bucket(n)
        if n > bucket:  # larger than the largest bucket: chunk
            return np.concatenate([self.predict(x[i:i + bucket])
                                   for i in range(0, n, bucket)], axis=0)
        if n < bucket:
            x = np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)])
        return self._run(x)[:n]
