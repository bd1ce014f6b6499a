"""A CUDA graph capture beside dead graphs (no JAX here).

``torch.cuda.graph`` no longer collects garbage before it captures, so a
dead reference cycle that holds an earlier graph could be collected while
a capture was under way; the graph's destructor then made CUDA calls that
a capture forbids and the capture failed (the readers' clipping-loss
captures failed now and then that way).  Every capture of the port runs
inside ``collector_held``.  The holds are checked here on the CPU; the
captures beside a dead graph (the collector made to run at nearly every
allocation) on the card, under the ``cuda`` marker.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import collector_held
from analytics_zoo_tpu_torch import nn as P
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.serving import InferenceModel


def test_collector_held_nests_and_restores():
    assert gc.isenabled()
    with collector_held():
        assert not gc.isenabled()
        with collector_held():
            assert not gc.isenabled()
        assert not gc.isenabled()  # the outer hold is still on
    assert gc.isenabled()
    gc.disable()
    try:
        with collector_held():
            pass
        assert not gc.isenabled()  # left as it was found
    finally:
        gc.enable()
    with pytest.raises(ValueError):
        with collector_held():
            raise ValueError("the hold ends with the block")
    assert gc.isenabled()


def test_collector_held_counts_holds_of_other_threads():
    """A hold that ends while another thread's is still on leaves the
    collector off: it comes back with the last hold."""
    inside, release = threading.Event(), threading.Event()

    def hold():
        with collector_held():
            inside.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    assert inside.wait(10)
    with collector_held():
        pass
    assert not gc.isenabled()
    release.set()
    t.join(10)
    assert gc.isenabled()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured there")


def _drop_while_capturing(held):
    """Inside a capture, once: drop the graph ``held`` holds into a
    reference cycle that only the collector frees, and allocate with the
    collector set to run at the next allocation.  Where it may run, the
    dead graph's destructor runs inside the capture."""
    if not held or not torch.cuda.is_current_stream_capturing():
        return
    box = [held.pop()]
    box.append(box)
    del box
    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        junk = [[] for _ in range(100)]
    finally:
        gc.set_threshold(*old)
    del junk


def _xy(rng):
    return (rng.normal(size=(64, 8)).astype(np.float32),
            rng.normal(size=(64, 1)).astype(np.float32))


def _estimator(loss="mse"):
    model = P.Sequential([P.Dense(8, 16, activation="relu"), P.Dense(16, 1)])
    return Estimator.from_keras(model, loss=loss, optimizer="adam",
                                learning_rate=1e-2)


@pytest.mark.cuda
def test_train_step_captures_while_a_dead_graph_could_be_collected():
    _card()
    rng = np.random.default_rng(0)
    old = _estimator()
    old.fit(_xy(rng), epochs=1, batch_size=32, verbose=False)
    held = [old._graphs.popitem()[1]]  # the old step's graph, alone
    del old
    mse = torch.nn.functional.mse_loss

    def loss(pred, y):
        _drop_while_capturing(held)
        return mse(pred, y)

    est = _estimator(loss)
    est.fit(_xy(rng), epochs=1, batch_size=32, verbose=False)
    assert not held and est.capture_count == 1
    gc.collect()


class _Dropper(torch.nn.Module):
    def __init__(self, held):
        super().__init__()
        self.held = held

    def forward(self, x):
        _drop_while_capturing(self.held)
        return x


@pytest.mark.cuda
def test_serving_captures_while_a_dead_graph_could_be_collected():
    _card()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    dense = P.Dense(8, 4)
    old = InferenceModel(device="cuda").load(dense, dense.state_dict())
    old.predict(x)
    held = [old._compiled.popitem()[1]]
    del old
    model = torch.nn.Sequential(P.Dense(8, 4), _Dropper(held))
    im = InferenceModel(device="cuda").load(model, model.state_dict())
    assert im.predict(x).shape == (4, 4)
    assert not held and im.compile_count == 1
    gc.collect()
