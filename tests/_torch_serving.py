"""What the port's serving tests share: a tiny BERT served by the port's
``InferenceModel`` on the CPU, a wrapper that slows it down or counts its
rows, and the per-test hygiene that ``conftest.py`` gives the JAX
package's telemetry, applied to the port's own (its metrics registry,
trace ring, fault registry and controller set are separate module state).

A test module imports the fixtures by name so that pytest applies them.
"""

import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.core import faults, metrics, trace
from analytics_zoo_tpu_torch.models import BERTClassifier
from analytics_zoo_tpu_torch.serving import InferenceModel
from analytics_zoo_tpu_torch.serving import controller as controller_lib

# tests/test_torch_bert_serving.py's small BERT; 3 classes
CFG = dict(vocab_size=100, hidden_size=32, n_layers=2, n_heads=4,
           max_position=40, dropout=0.0)
SEQ = 20
CLASSES = 3
# f32 through two layers: one batch size against another, or the JAX
# package against the port, sum in different orders
TOL = 1e-4

_VARIABLES = {}


def ids(n, seed=0, seq=SEQ):
    """``n`` rows of ``seq`` token ids from a seeded generator."""
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], size=(n, seq)).astype(np.int32)


def bert_variables(seed):
    """The port BERT's weights from ``init_weights`` under a seeded
    generator: one seed, one model version."""
    if seed not in _VARIABLES:
        m = BERTClassifier(CLASSES, use_flash=True, **CFG)
        m.init_weights(torch.Generator().manual_seed(seed))
        _VARIABLES[seed] = {k: v.detach().clone()
                            for k, v in m.state_dict().items()}
    return _VARIABLES[seed]


def bert(seed=0, buckets=(1, 4, 16), **kw):
    """A port ``InferenceModel`` on the CPU serving version ``seed``."""
    return InferenceModel(batch_buckets=buckets, device="cpu", **kw).load(
        BERTClassifier(CLASSES, use_flash=True, **CFG), bert_variables(seed))


def expect(model, x):
    """What ``model`` answers for the one row ``x``, predicted alone."""
    return model.predict(np.asarray(x)[None])[0]


def close(got, want):
    assert got is not None, "no reply"
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


class Served:
    """A port model behind a test's knobs: an optional sleep before each
    batch (explicit capacity) and a count of the rows it ran."""

    def __init__(self, model, delay=0.0):
        self.model = model
        self.delay = delay
        self.concurrent_num = model.concurrent_num
        self.calls = []
        self._lock = threading.Lock()

    def predict(self, x):
        if self.delay:
            time.sleep(self.delay)
        with self._lock:
            self.calls.append(np.asarray(x).shape[0])
        return self.model.predict(x)

    @property
    def rows_seen(self):
        with self._lock:
            return sum(self.calls)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; one
    intra-op thread keeps the timing-sensitive serving tests of the other
    workers from being crowded out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def port_telemetry_reset():
    """Each test reads a zeroed port metrics registry and trace ring."""
    metrics.get_registry().reset()
    metrics.get_registry().enabled = True
    trace.reset()
    trace.enabled = True
    yield


@pytest.fixture(autouse=True)
def port_faults_disarmed():
    """A test that arms a port fault point must disarm it."""
    yield
    reg = faults.get_registry()
    leaked = reg.armed_points()
    if leaked:
        reg.reset()
        pytest.fail(f"test leaked armed port fault points: {leaked}")


@pytest.fixture(autouse=True)
def no_leaked_port_controllers():
    """A test that starts a port ServingController must close it."""
    yield
    leaked = controller_lib.live_controllers()
    if leaked:
        for c in leaked:
            c.stop()
        pytest.fail(f"test leaked port ServingController(s): {leaked}")
