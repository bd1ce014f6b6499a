"""On the card (``cuda`` marker, skipped without one; no JAX here): the
aux-loss channel inside a captured train step."""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.models.common import init_weights
from analytics_zoo_tpu_torch.orca.learn import Estimator


def _model(seed=0):
    m = tnn.Sequential([tnn.Dense(8, 16, activation="relu"),
                        tnn.ActivityRegularization(l2=0.5),
                        tnn.Dense(16, 3)])
    return init_weights(m, torch.Generator().manual_seed(seed))


@pytest.mark.cuda
def test_captured_step_adds_the_aux_sum_in_its_graph():
    """A train step on the card is a CUDA graph replay: the aux sum is
    computed in the graph from the replay's own forward, so the captured
    fit's losses equal the eager fit's bit for bit (a sum read at capture
    time would be a constant, and the losses would part after the first
    replay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs run there")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, 8)).astype(np.float32)
    y = rng.integers(0, 3, 48).astype(np.int32)
    hist = {}
    for graphs in (True, False):
        est = Estimator.from_keras(_model(),
                                   loss="sparse_categorical_crossentropy",
                                   optimizer="sgd", learning_rate=0.05,
                                   device="cuda", cuda_graphs=graphs,
                                   aux_loss_weight=1.0)
        hist[graphs] = est.fit((x, y), epochs=3, batch_size=16,
                               verbose=False)["loss"]
        assert est.capture_count == (1 if graphs else 0)
    assert hist[True] == hist[False]
