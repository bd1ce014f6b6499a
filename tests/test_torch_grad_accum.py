"""The port's ``Estimator(grad_accum=k)`` against its own full-batch step
and against the JAX Estimator on the CPU, and a tiny twin of bench.py's
BERT vocab-head recipe (``bench_bert``'s local ``Encoder``: token
embedding plus a learned ``pos``, post-LN ``TransformerLayer``s with
``remat_attention=True``, a ``Dense(vocab)`` head, per-token sparse
cross-entropy, ``adamw``, ``grad_accum``) trained by both packages from one
JAX init, with the plain head and with the head through each package's
``fused_softmax_xent``.

Tolerances: loss histories 1e-5 relative (f32; accumulation sums the same
micro-batch gradients in another order than one full batch); parameters
1e-5 absolute against the full-batch step (sgd moves them by lr x
gradient), 1e-5 against the JAX Estimator for the small nets and 1e-4 for
the recipe twin after three adamw steps (optax's formula in another
evaluation order; Adam rescales each gradient's rounding by its own
magnitude, as in tests/test_torch_training.py); batch norm's running
statistics 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.ops import fused_softmax_xent as jax_fused
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.ops import fused_softmax_xent
from analytics_zoo_tpu_torch.orca.learn import Estimator

# the recipe's twin: bench_bert at d 32, 2 heads, 2 layers, vocab 50,
# seq 16, global batch 8 as grad_accum=2 micro-batches of 4
VOCAB, D, HEADS, LAYERS, SEQ = 50, 32, 2, 2, 16
ACCUM, GLOBAL_BATCH, CHUNK = 2, 8, 16
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _assert_trees_close(got, want, atol):
    paths = [p for p, _ in _leaves(want)]
    assert sorted(p for p, _ in _leaves(got)) == sorted(paths)
    for path, w in _leaves(want):
        np.testing.assert_allclose(_at(got, path), w, atol=atol,
                                   err_msg="/".join(path))


# -- the Estimator's grad_accum -----------------------------------------------

def _mlp_data():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(16, 6)).astype(np.float32),
            rng.integers(0, 3, 16).astype(np.int32))


def test_grad_accum_matches_full_batch_step():
    """The twin of the JAX test: grad_accum=4 gives the full-batch update
    (the mean of equal micro-batch mean gradients is the full-batch mean
    gradient)."""
    x, y = _mlp_data()

    def make(accum):
        model = tnn.Sequential([tnn.Dense(6, 16, activation="relu"),
                                tnn.Dense(16, 3)])
        gen = torch.Generator().manual_seed(3)
        for m in model.modules():
            if isinstance(m, tnn.Dense):
                m.reset_parameters(gen)
        est = Estimator.from_keras(
            model, loss="sparse_categorical_crossentropy", optimizer="sgd",
            learning_rate=0.1, grad_accum=accum, device="cpu")
        hist = est.fit((x, y), epochs=2, batch_size=16, verbose=False)
        return hist["loss"], est.get_model()

    loss1, p1 = make(1)
    loss4, p4 = make(4)
    np.testing.assert_allclose(loss1, loss4, rtol=1e-5)
    _assert_trees_close(p4["params"], p1["params"], atol=1e-5)


def test_grad_accum_rejects_indivisible_batch():
    est = Estimator.from_keras(tnn.Sequential([tnn.Dense(4, 2)]), loss="mse",
                               optimizer="sgd", learning_rate=0.1,
                               grad_accum=3, device="cpu")
    x = np.zeros((8, 4), np.float32)
    y = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        est.fit((x, y), epochs=1, batch_size=8, verbose=False)


@pytest.mark.parametrize("accum", [0, -2])
def test_grad_accum_below_one_is_refused(accum):
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        Estimator.from_keras(tnn.Dense(4, 2), loss="mse", device="cpu",
                             grad_accum=accum)


def test_grad_accum_keeps_its_f32_sums_in_buffers_made_once():
    x, y = _mlp_data()
    model = tnn.Sequential([tnn.Dense(6, 4), tnn.Dense(4, 3)])
    est = Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                               optimizer="sgd", learning_rate=0.1,
                               grad_accum=2, device="cpu")
    est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    sums = est._grad_sum
    assert [s.dtype for s in sums] == [torch.float32] * len(sums)
    assert [s.shape for s in sums] == [p.shape for p in model.parameters()]
    ptrs = [s.data_ptr() for s in sums]
    est.fit((x, y), epochs=2, batch_size=8, verbose=False)
    assert est._grad_sum is sums
    assert [s.data_ptr() for s in est._grad_sum] == ptrs


def _jax_mlp(kind):
    if kind == "batchnorm":
        # batch norm first: after a Dense it would zero that Dense's bias
        # gradient in exact arithmetic, and Adam would amplify the noise
        return jnn.Sequential([jnn.BatchNormalization(),
                               jnn.Dense(8, activation="relu"),
                               jnn.Dense(3)])
    return jnn.Sequential([jnn.Dense(16, activation="relu"), jnn.Dense(3)])


def _port_mlp(kind):
    if kind == "batchnorm":
        return tnn.Sequential([tnn.BatchNormalization(6),
                               tnn.Dense(6, 8, activation="relu"),
                               tnn.Dense(8, 3)])
    return tnn.Sequential([tnn.Dense(6, 16, activation="relu"),
                           tnn.Dense(16, 3)])


@pytest.mark.parametrize("kind", ["mlp", "batchnorm"])
def test_grad_accum_fit_matches_the_jax_estimator(kind):
    """grad_accum=4 in both packages from one JAX init: loss history,
    parameters and (with batch norm, which normalizes each micro-batch by
    its own statistics and updates the running ones once per micro-batch)
    the running statistics."""
    x, y = _mlp_data()
    jest = JaxEstimator.from_keras(_jax_mlp(kind),
                                   loss="sparse_categorical_crossentropy",
                                   optimizer="adam", learning_rate=0.01,
                                   grad_accum=4)
    jest._ensure_initialized(jnp.asarray(x[:16]))
    port = _port_mlp(kind)
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    test = Estimator.from_keras(port, loss="sparse_categorical_crossentropy",
                                optimizer="adam", learning_rate=0.01,
                                grad_accum=4, device="cpu")
    hist_j = jest.fit((x, y), epochs=3, batch_size=16, verbose=False)
    hist_t = test.fit((x, y), epochs=3, batch_size=16, verbose=False)
    np.testing.assert_allclose(hist_t["loss"], hist_j["loss"], rtol=1e-5)
    got, want = test.get_model(), jest.get_model()
    _assert_trees_close(got["params"], want["params"], atol=1e-5)
    if kind == "batchnorm":
        _assert_trees_close(got["state"], want["state"], atol=1e-6)


# -- bench.py's BERT vocab-head recipe, tiny ----------------------------------

class _JaxHeadWeights(jnn.Module):
    """The head's ``kernel`` and ``bias`` under ``head/``, as ``Dense``
    makes them, returned unapplied (the fused head's input)."""

    def forward(self, scope, x):
        w = scope.param("kernel", jnn.initializers.get("glorot_uniform"),
                        (x.shape[-1], VOCAB))
        b = scope.param("bias", jnn.initializers.get("zeros"), (VOCAB,))
        return w, b


class JaxEncoder(jnn.Module):
    """bench.py's ``Encoder`` at the twin's widths (f32); ``fused`` returns
    ``(h, head/kernel, head/bias)`` for ``fused_softmax_xent``."""

    def __init__(self, fused):
        super().__init__()
        self.fused = fused

    def forward(self, scope, ids):
        x = scope.child(jnn.Embedding(VOCAB, D), ids, name="tok")
        pos = scope.param("pos", jnn.initializers.get("normal"),
                          (1, ids.shape[1], D))
        x = (x + pos).astype(jnp.float32)
        for i in range(LAYERS):
            x = scope.child(jnn.TransformerLayer(HEADS, remat_attention=True),
                            x, name=f"block{i}")
        if self.fused:
            w, b = scope.child(_JaxHeadWeights(), x, name="head")
            return x, w, b
        return scope.child(jnn.Dense(VOCAB), x, name="head")


class Encoder(torch.nn.Module):
    """The port's twin of bench.py's ``Encoder`` (the JAX tree's names:
    ``tok/embeddings``, ``pos``, ``block{i}/...``, ``head/kernel``,
    ``head/bias``)."""

    def __init__(self, fused):
        super().__init__()
        self.fused = fused
        self.tok = tnn.Embedding(VOCAB, D)
        self.pos = torch.nn.Parameter(torch.empty(1, SEQ, D))
        self.blocks = [f"block{i}" for i in range(LAYERS)]
        for name in self.blocks:
            self.add_module(name, tnn.TransformerLayer(
                D, HEADS, remat_attention=True))
        self.head = tnn.Dense(D, VOCAB)

    def forward(self, ids):
        x = self.tok(ids) + self.pos
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.fused:
            return x, self.head.kernel, self.head.bias
        return self.head(x)


def _recipe_data():
    rng = np.random.default_rng(0)
    return (rng.integers(0, VOCAB, (GLOBAL_BATCH, SEQ)).astype(np.int32),
            rng.integers(0, VOCAB, (GLOBAL_BATCH, SEQ)).astype(np.int32))


def _fit_both(fused):
    """The JAX Estimator's own init (seed 0) loaded into the port, then
    three steps of each; returns both loss histories, both final trees and
    the init."""
    ids, labels = _recipe_data()
    if fused:
        jloss = lambda out, y: jax_fused(out[0], out[1], y, CHUNK,  # noqa
                                         bias=out[2])
        tloss = lambda out, y: fused_softmax_xent(out[0], out[1], y,  # noqa
                                                  CHUNK, bias=out[2])
    else:
        jloss = tloss = "sparse_categorical_crossentropy"
    jest = JaxEstimator.from_keras(JaxEncoder(fused), loss=jloss,
                                   optimizer="adamw", learning_rate=LR,
                                   grad_accum=ACCUM)
    jest._ensure_initialized(jnp.asarray(ids))
    init = jest.get_model()
    port = Encoder(fused)
    port.load_state_dict(from_jax_variables(init), strict=True)
    test = Estimator.from_keras(port, loss=tloss, optimizer="adamw",
                                learning_rate=LR, grad_accum=ACCUM,
                                device="cpu")
    hist_j = jest.fit((ids, labels), epochs=3, batch_size=GLOBAL_BATCH,
                      verbose=False)["loss"]
    hist_t = test.fit((ids, labels), epochs=3, batch_size=GLOBAL_BATCH,
                      verbose=False)["loss"]
    return hist_j, hist_t, jest.get_model(), test.get_model(), init


@pytest.fixture(scope="module")
def recipe_fits():
    return {fused: _fit_both(fused) for fused in (False, True)}


def test_the_recipe_twin_loads_the_jax_tree():
    ids, _ = _recipe_data()
    init = JaxEncoder(False).init(jax.random.PRNGKey(1), jnp.asarray(ids))
    port = Encoder(False)
    port.load_state_dict(from_jax_variables(init), strict=True)
    want, _ = JaxEncoder(False).apply(init, jnp.asarray(ids))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_the_recipe_twin_trains_like_the_jax_estimator(recipe_fits, fused):
    hist_j, hist_t, want, got, _ = recipe_fits[fused]
    assert len(hist_t) == 3
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-5)
    assert hist_t[-1] < hist_t[0]
    _assert_trees_close(got["params"], want["params"], atol=1e-4)


def test_the_fused_head_trains_like_the_plain_head(recipe_fits):
    _, plain, _, plain_params, plain_init = recipe_fits[False]
    _, fused, _, fused_params, fused_init = recipe_fits[True]
    # one init: the head's kernel and bias draw the same keys either way
    _assert_trees_close(fused_init["params"], plain_init["params"], atol=0)
    np.testing.assert_allclose(fused, plain, rtol=1e-5)
    _assert_trees_close(fused_params["params"], plain_params["params"],
                        atol=1e-4)
