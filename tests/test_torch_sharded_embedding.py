"""The port's sharded embedding engine (``parallel/embedding.py``) and the
Estimator's sparse train path against the JAX package on the CPU: the
static-size unique against ``jnp.unique(size=, fill_value=0,
return_inverse=True)`` (values, inverse and order, bit for bit), the
deduped lookup with masks, the ``sum``/``mean`` combiners and
``max_unique`` (NaN rows past the cap, as ``jnp.take`` fills), the
unique rows' gradient against the dense one, a sparse ``fit`` with
``embedding_lr`` against the JAX Estimator (its losses and tables), the
guardrails, the absence of any table gradient, and ``lookup_stats``.

Tolerances: lookups 1e-6 absolute (gathers and at most a few f32 adds in
another order); row gradients 1e-6 absolute; the fit's losses 1e-5 of
max(1, |loss|) and its tables and dense weights 1e-5 absolute (the same
f32 arithmetic in another summation order, over 3 epochs of Adam).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.core import metrics as jmetrics
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.parallel import embedding as jemb
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import metrics as tmetrics
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.parallel import embedding as emb

LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ratings(n=256, users=64, items=40, seed=42):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, users, n),
                  rng.integers(0, items, n)], 1).astype(np.int32)
    y = (rng.random(n) < 0.5).astype(np.int32)
    return x, y


# -- the static-size unique and the lookup -----------------------------------

@pytest.mark.parametrize("n,hi,size", [(40, 12, None), (40, 12, 5),
                                       (64, 1000, None), (1, 3, None),
                                       (33, 2, 40)])
def test_static_unique_equals_jnp_unique(n, hi, size):
    flat = np.random.default_rng(n + hi).integers(0, hi, n)
    size = size or n
    uniq, inv = emb.static_unique(torch.from_numpy(flat), size)
    ju, ji = jnp.unique(jnp.asarray(flat), size=size, fill_value=0,
                        return_inverse=True)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji).reshape(-1))


@pytest.mark.parametrize("combiner", [None, "sum", "mean"])
@pytest.mark.parametrize("max_unique", [None, 6])
def test_dedup_lookup_matches_jax(combiner, max_unique):
    """Masked (negative) ids, multi-hot rows, a cap below the distinct
    count: values and NaN rows as the JAX lookup gives them."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(15, 4)).astype(np.float32)
    ids = rng.integers(-2, 15, (5, 3)).astype(np.int32)
    got = emb.dedup_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                           combiner=combiner, max_unique=max_unique).numpy()
    want = np.asarray(jemb.dedup_lookup(jnp.asarray(table), jnp.asarray(ids),
                                        combiner=combiner,
                                        max_unique=max_unique))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dedup_lookup_rejects_bad_combiner():
    with pytest.raises(ValueError, match="combiner"):
        emb.dedup_lookup(torch.zeros(4, 2), torch.tensor([0]),
                         combiner="max")
    with pytest.raises(ValueError, match="combiner"):
        emb.ShardedEmbedding(4, 2, combiner="max")


def test_row_gradient_equals_the_dense_gradient():
    """Under ``inject_taps`` the unique rows' gradient, added into a zero
    table at the unique ids, is ``jax.grad`` of the plain lookup's loss
    over the table; the table itself gets no gradient."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(20, 3)).astype(np.float32)
    ids = rng.integers(-1, 20, (16, 4)).astype(np.int32)
    w = rng.normal(size=(16, 3)).astype(np.float32)

    def jloss(t):
        return (jemb.dedup_lookup(t, jnp.asarray(ids), combiner="sum")
                * w).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    t = torch.nn.Parameter(torch.from_numpy(table))
    with emb.inject_taps() as taps:
        out = emb.dedup_lookup(t, torch.from_numpy(ids), combiner="sum")
    g, = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             [taps[0].rows])
    assert len(taps) == 1 and taps[0].table is t
    got = torch.zeros(20, 3).index_add_(0, taps[0].uniq, g).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert t.grad is None


def test_split_merge_and_paths_match_jax():
    tree = {"a": {"sharded_embeddings": np.ones((3, 2))},
            "b": {"kernel": np.zeros((2, 2)),
                  "c": {"sharded_embeddings": np.zeros((4, 2))}}}
    dense, tables = emb.split_sparse(tree)
    jdense, jtables = jemb.split_sparse(tree)
    assert dense.keys() == jdense.keys() and tables.keys() == jtables.keys()
    assert emb.sparse_paths(tree) == jemb.sparse_paths(tree)
    merged = emb.merge_sparse(dense, tables)
    assert merged["b"]["c"]["sharded_embeddings"] is tree["b"]["c"][
        "sharded_embeddings"]
    model = NeuralCF(10, 8, sharded_embeddings=True)
    assert sorted(emb.sparse_parameters(model)) == [
        f"{n}/sharded_embeddings" for n in ("mf_item_embed", "mf_user_embed",
                                            "mlp_item_embed",
                                            "mlp_user_embed")]


def test_row_rules_take_the_reference_form():
    rules = emb.embedding_row_rules()
    jrules = jemb.embedding_row_rules()
    assert [r.pattern for r in rules] == [r.pattern for r in jrules]
    assert [tuple(r.spec) for r in rules] == [tuple(r.spec) for r in jrules]
    assert emb.is_row_rules(rules)
    assert not emb.is_row_rules([emb.ShardingRule("kernel$", ("model",))])


# -- the sparse train path ----------------------------------------------------

def _sharded_pair(users=64, items=40, embedding_lr=None, seed=7, x=None):
    """A JAX NeuralCF with ShardedEmbedding tables and its port twin
    holding the same initial weights, each under its Estimator."""
    init_orca_context("local")
    kw = dict(user_count=users, item_count=items, class_num=2,
              user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8,
              sharded_embeddings=True)
    ekw = dict(loss=LOSS, optimizer="adam", learning_rate=1e-2, seed=seed,
               embedding_lr=embedding_lr)
    jest = JaxEstimator.from_keras(JaxNeuralCF(**kw),
                                   sharding=jemb.embedding_row_rules(), **ekw)
    jest._ensure_initialized(jnp.asarray(x[:64]))
    model = NeuralCF(**kw)
    model.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    test = Estimator.from_keras(model, device="cpu",
                                sharding=emb.embedding_row_rules(), **ekw)
    return jest, test


@pytest.mark.parametrize("embedding_lr", [None, 0.05])
def test_sparse_fit_matches_jax_estimator(embedding_lr):
    """3 epochs of a ShardedEmbedding NeuralCF (adam 1e-2 on the dense
    tower, a plain row step of ``embedding_lr`` on the tables): the loss
    history, every table and every dense weight as the JAX Estimator's."""
    x, y = _ratings()
    jest, test = _sharded_pair(embedding_lr=embedding_lr, x=x)
    hj = jest.fit((x, y), epochs=3, batch_size=64, verbose=False)
    ht = test.fit((x, y), epochs=3, batch_size=64, verbose=False)
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5, atol=1e-5)
    want, got = jest.get_model()["params"], test.get_model()["params"]
    for name in want:
        for leaf in want[name]:
            np.testing.assert_allclose(got[name][leaf],
                                       np.asarray(want[name][leaf]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name}/{leaf}")
    for p in test._sparse.values():
        assert p.grad is None
    ev_j = jest.evaluate((x, y), batch_size=64)
    ev_t = test.evaluate((x, y), batch_size=64)
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)


def test_embedding_lr_zero_freezes_the_tables():
    x, y = _ratings()
    _, test = _sharded_pair(embedding_lr=0.0, x=x)
    before = {k: v.clone() for k, v in test.model.state_dict().items()}
    test.fit((x, y), epochs=1, batch_size=64, verbose=False)
    after = test.model.state_dict()
    for k in before:
        assert torch.equal(before[k], after[k]) == k.endswith(
            "sharded_embeddings"), k


def test_sparse_guardrails_raise_as_the_reference():
    model = NeuralCF(16, 8, sharded_embeddings=True)
    with pytest.raises(ValueError, match="grad_accum"):
        Estimator.from_keras(model, loss=LOSS, device="cpu", grad_accum=2)
    with pytest.raises(ValueError, match="embedding_lr=0.0"):
        Estimator.from_keras(model, loss=LOSS, device="cpu",
                             frozen=["mlp_user_embed"])
    # the JAX package's third guardrail: no quantized wire for row grads
    with pytest.raises(ValueError, match="grad_compression"):
        Estimator.from_keras(model, loss=LOSS, device="cpu",
                             grad_compression="int8")
    # a dense model takes grad_accum, and frozen= on its dense layers
    Estimator.from_keras(NeuralCF(16, 8), loss=LOSS, device="cpu",
                         grad_accum=2)
    est = Estimator.from_keras(NeuralCF(16, 8), loss=LOSS, device="cpu",
                               frozen=["mlp_user_embed"])
    assert est._frozen_names == {"mlp_user_embed.embeddings"}


class _Shapes(TorchDispatchMode):
    """Every op's name and the shapes of its tensor outputs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.seen.extend((str(func), tuple(o.shape)) for o in outs
                         if isinstance(o, torch.Tensor))
        return out


def _table_shaped_ops(sharded):
    users, items = 97, 89  # primes: no accidental shape collisions
    x, y = _ratings(n=32, users=users, items=items)
    model = NeuralCF(users, items, class_num=2, user_embed=8, item_embed=8,
                     hidden_layers=(16, 8), mf_embed=8,
                     sharded_embeddings=sharded)
    est = Estimator.from_keras(model, loss=LOSS, optimizer="adam",
                               learning_rate=1e-2, device="cpu")
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    est._train_step(batch)  # the optimizer's state made outside the count
    with _Shapes() as mode:
        est._train_step(batch)
    ops = {}
    for name, shape in mode.seen:
        if shape in ((users, 8), (items, 8)):
            ops[name] = ops.get(name, 0) + 1
    return ops, est


def test_sparse_step_never_makes_a_table_gradient():
    """The ops of one sparse train step: at a table's shape only the
    tables' in-place row updates and the detach of the lookup, no dense
    gradient and no optimizer state; the dense model (adam over
    ``Embedding`` tables) does many.  No table ever holds ``.grad``."""
    sparse, est = _table_shaped_ops(True)
    assert sparse == {"aten.detach.default": 4,
                      "aten.index_add_.default": 4}, sparse
    assert all(p.grad is None for p in est.model.parameters())
    dense, _ = _table_shaped_ops(False)
    assert sum(v for k, v in dense.items()
               if "index_add" not in k and "detach" not in k) > 10, dense


def test_lookup_stats_match_jax():
    ids = np.array([[3, 3, -1, 7], [7, 2, 2, 2]])
    treg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    assert emb.lookup_stats(ids, 16, metrics=treg) == \
        jemb.lookup_stats(ids, 16, metrics=jreg) == (3, 7)
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    for k in ("embed.gather_rows", "embed.gather_rows_naive",
              "embed.gather_bytes", "embed.gather_bytes_naive"):
        assert tsnap[k] == jsnap[k], k
