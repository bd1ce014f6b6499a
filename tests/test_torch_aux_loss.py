"""The aux-loss channel: the JAX Estimator adds ``aux_loss_weight`` times
the sum of every ``aux_loss`` its model's layers record in a forward
(``ActivityRegularization``'s penalty, MoE's load-balance loss) to the
training loss; the port's Estimator adds the same sum, recorded through
``nn.module.aux_losses``, eagerly here (inside a captured step on the
card: ``tests/test_torch_aux_cuda.py``).

Tolerances: loss histories 1e-5 relative, parameters 1e-5 of each leaf's
largest magnitude (f32 on both sides, the same update rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import one_torch_thread  # noqa: F401
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.nn.module import aux_losses, record_aux_loss
from analytics_zoo_tpu_torch.orca.learn import Estimator

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _data(n=48, d=8, classes=3, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def _pair(l1=0.0, l2=0.5, **kw):
    """The same Sequential with an ActivityRegularization in both
    packages, from the JAX Estimator's init."""
    x, y = _data()
    jm = jnn.Sequential([jnn.Dense(16, activation="relu"),
                         jnn.ActivityRegularization(l1=l1, l2=l2),
                         jnn.Dense(3)])
    jest = JaxEstimator.from_keras(jm, loss="sparse_categorical_crossentropy",
                                   optimizer="sgd", learning_rate=0.05, **kw)
    jest._ensure_initialized(jnp.asarray(x[:16]))
    init = jest.get_model()
    port = tnn.Sequential([tnn.Dense(8, 16, activation="relu"),
                           tnn.ActivityRegularization(l1=l1, l2=l2),
                           tnn.Dense(16, 3)])
    port.load_state_dict(from_jax_variables(init), strict=True)
    return jest, port, x, y


@pytest.mark.parametrize("knobs", [{}, {"aux_loss_weight": 0.2},
                                   {"aux_loss_weight": 0.0}])
def test_activity_regularization_trains_on_the_jax_loss(knobs):
    """Default knobs (``aux_loss_weight`` 0.01), a larger weight and none:
    the loss histories and the trained parameters agree."""
    jest, port, x, y = _pair(**knobs)
    test = Estimator.from_keras(port, loss="sparse_categorical_crossentropy",
                                optimizer="sgd", learning_rate=0.05,
                                device="cpu", **knobs)
    hj = jest.fit((x, y), epochs=2, batch_size=16, verbose=False)
    ht = test.fit((x, y), epochs=2, batch_size=16, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    for (kj, vj), (kt, vt) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(
                jest.get_model()["params"]), key=lambda a: str(a[0])),
            sorted(jax.tree_util.tree_leaves_with_path(
                test.get_model()["params"]), key=lambda a: str(a[0]))):
        vj, vt = np.asarray(vj), np.asarray(vt)
        assert np.abs(vj - vt).max() <= 1e-5 * max(1.0, np.abs(vj).max())
    # the buffer keeps the JAX state's value: the last step's penalty
    np.testing.assert_allclose(
        np.asarray(test.get_model()["state"]["01_layer1"]["aux_loss"]),
        np.asarray(jest.get_model()["state"]["01_layer1"]["aux_loss"]),
        rtol=1e-4)


def test_aux_loss_weight_changes_the_objective():
    """The penalty reaches the loss: with l2 > 0 the default weight's
    first loss exceeds the zero weight's by 0.01 x the penalty."""
    _, port, x, y = _pair()
    first = {}
    for w in (0.0, 0.01):
        m = tnn.Sequential([tnn.Dense(8, 16, activation="relu"),
                            tnn.ActivityRegularization(l2=0.5),
                            tnn.Dense(16, 3)])
        m.load_state_dict(port.state_dict())
        est = Estimator.from_keras(m, loss="sparse_categorical_crossentropy",
                                   optimizer="sgd", learning_rate=0.0,
                                   device="cpu", aux_loss_weight=w)
        first[w] = est.fit((x[:16], y[:16]), epochs=1, batch_size=16,
                           verbose=False)["loss"][0]
    with torch.no_grad():
        pen = 0.5 * getattr(port, "00_layer0")(
            torch.from_numpy(x[:16])).square().sum()
    np.testing.assert_allclose(first[0.01] - first[0.0], 0.01 * float(pen),
                               rtol=1e-4)


def test_the_channel_keeps_the_last_record_of_a_module():
    """A module called twice in one forward counts once, with its last
    value (the JAX state's ``put_variable`` overwrites); outside a
    collector nothing is kept."""
    a, b = torch.nn.Identity(), torch.nn.Identity()
    record_aux_loss(a, torch.tensor(5.0))  # no collector: dropped
    with aux_losses() as rec:
        record_aux_loss(a, torch.tensor(1.0))
        record_aux_loss(b, torch.tensor(2.0))
        record_aux_loss(a, torch.tensor(3.0))
    assert sorted(float(v) for v in rec.values()) == [2.0, 3.0]
    with aux_losses() as rec:
        pass
    assert rec == {}

