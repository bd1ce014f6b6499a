"""The port's compiled training loop against the JAX package on the CPU,
and its CUDA graphs on the card.

On the CPU: the optimizers' schedules on a device count tensor against
optax's own schedules evaluated in JAX, for every name of ``_SCHEDULES``;
``Estimator._multi_step`` and ``_multi_step_data`` against the JAX
Estimator's (a 2-layer twin of bench.py's BERT vocab-head recipe with
``adamw`` on ``warmup_cosine``, and a small batch-norm ResNet with
``sgd``) from one JAX init; the port's ``_multi_step`` against K of its own
``_train_step``; an update count that lives on the device.

On the card (``cuda`` marker, skipped without one): a captured ``fit``
against an eager one, bit for bit, through flash attention (dropout,
``grad_accum=2``), the fused batch norm and the fused cross-entropy, and
over a streaming feed of either backend through ``fit(prefetch=2)``; one
capture per (batch shapes, dtypes) key across epochs; a capture that
fails raises.

Tolerances.  Schedules: 1 f32 ulp of the schedule's largest value against
optax evaluated op by op on an int32 count (the same f32 operations; the
``cos`` and ``pow`` of two libraries may round their last bit apart, and a
1-ulp difference in ``cos`` near the end of a cosine decay moves ``1 +
cos``, so the value, by up to that much; integer exponents, since
``jnp.power`` with a float exponent is not correctly rounded).  The
twins: losses 1e-5 relative and parameters 1e-4 absolute after adamw, 1e-5
after sgd (the f32 math of the two Estimators in another order; Adam
rescales each gradient's rounding by its own magnitude, as in
``tests/test_torch_grad_accum.py``), batch norm's running statistics 1e-5.
The port against itself, and a captured step against an eager one: bit
for bit (the same kernels on the same inputs and the same generator
offsets).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
import analytics_zoo_tpu.orca.learn.optimizers as jopt
from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.data.feed import as_feed as jas_feed
from analytics_zoo_tpu.models import ResNet as JaxResNet
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.data import StreamingDataFeed, as_feed
from analytics_zoo_tpu_torch.models import BERTSQuAD, ResNet, squad_span_loss
from analytics_zoo_tpu_torch.ops import fused_softmax_xent
from analytics_zoo_tpu_torch.orca.learn import Estimator, optimizers
from analytics_zoo_tpu_torch.orca.learn.estimator import _supports_host_epoch

tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
tbn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
txent = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")

# bench_bert's Encoder at d 32, 2 heads, 2 layers, vocab 50, seq 16,
# global batch 8 as grad_accum=2 micro-batches of 4
VOCAB, D, HEADS, LAYERS, SEQ = 50, 32, 2, 2, 16
ACCUM, GLOBAL_BATCH, CHUNK = 2, 8, 16
WARMUP_COSINE = {"schedule": "warmup_cosine", "peak": 1e-3,
                 "warmup_steps": 2, "decay_steps": 8}
K = 4


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
        np.testing.assert_allclose(_at(got, path), w, atol=atol, rtol=0,
                                   err_msg="/".join(path))


# -- schedules ------------------------------------------------------------------

SCHEDULES = [
    {"schedule": "poly", "lr": 0.1, "decay_steps": 7, "power": 2},
    {"schedule": "poly", "lr": 0.1, "decay_steps": 7, "end_lr": 0.01,
     "transition_begin": 2},
    {"schedule": "exponential", "lr": 0.1, "decay_steps": 3,
     "decay_rate": 0.5, "staircase": True},
    {"schedule": "exponential", "lr": 0.1, "decay_steps": 3,
     "decay_rate": 0.9, "end_value": 0.05, "transition_begin": 1},
    {"schedule": "exponential", "lr": 0.1, "decay_steps": 4,
     "decay_rate": 1.1, "end_value": 0.15},
    {"schedule": "warmup_cosine", "peak": 0.05, "warmup_steps": 3,
     "decay_steps": 11, "end_lr": 1e-3},
    {"schedule": "warmup_cosine", "peak": 1e-4, "warmup_steps": 10,
     "decay_steps": 100, "exponent": 2},
    {"schedule": "warmup_linear", "peak": 0.1, "warmup_steps": 4},
    {"schedule": "cosine", "peak": 0.1, "decay_steps": 9, "alpha": 0.1},
    {"schedule": "constant", "peak": 0.02},
]


def test_every_schedule_name_is_covered():
    assert {s["schedule"] for s in SCHEDULES} == set(optimizers._SCHEDULES)


@pytest.mark.parametrize("spec", SCHEDULES,
                         ids=[f"{s['schedule']}{i}"
                              for i, s in enumerate(SCHEDULES)])
def test_schedule_on_a_count_tensor_matches_optax(spec):
    """counts 0..119 as int32 tensors: an f32 tensor within 1 ulp of the
    largest value of optax's schedule at the same int32 counts."""
    ours = optimizers.resolve_learning_rate(dict(spec))
    theirs = jopt.resolve_learning_rate(dict(spec))
    counts = torch.arange(120, dtype=torch.int32)
    got = torch.stack([ours(c) for c in counts])
    assert got.dtype == torch.float32
    want = np.array([np.float32(theirs(jnp.int32(c))) for c in range(120)])
    ulp = np.spacing(np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= ulp
    # the schedule is one expression of the count: a whole vector of
    # counts gives the same values
    assert torch.equal(ours(counts), got)


@pytest.mark.parametrize("name", ["sgd", "adamw", "rmsprop", "adagrad"])
def test_update_count_and_learning_rate_live_on_the_device(name):
    """The count is an int32 tensor advanced in place and a schedule's
    learning rate an f32 tensor written in place: a replayed step reads
    and writes no host state."""
    opt = optimizers.get(name, dict(WARMUP_COSINE))
    params = [torch.ones(3), torch.ones(2, 2)]
    state = opt.init(params)
    count = state["count"] if "count" in state else state[1]["count"]
    assert count.dtype == torch.int32 and int(count) == 0
    ptr = count.data_ptr()
    for _ in range(3):
        state = opt.step(params, [torch.ones(3), torch.ones(2, 2)], state)
    count = state["count"] if "count" in state else state[1]["count"]
    assert int(count) == 3 and count.data_ptr() == ptr
    if "lr" in state:
        assert state["lr"].dtype == torch.float32
        want = optimizers.resolve_learning_rate(dict(WARMUP_COSINE))(
            torch.tensor(2, dtype=torch.int32))
        assert torch.equal(state["lr"], want)


# -- the recipe twin --------------------------------------------------------------

class _JaxHeadWeights(jnn.Module):
    def forward(self, scope, x):
        w = scope.param("kernel", jnn.initializers.get("glorot_uniform"),
                        (x.shape[-1], VOCAB))
        b = scope.param("bias", jnn.initializers.get("zeros"), (VOCAB,))
        return w, b


class JaxEncoder(jnn.Module):
    """bench.py's ``Encoder`` at the twin's widths (f32), its head handed
    to the fused cross-entropy when ``fused``."""

    def __init__(self, fused=False):
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
    """The port's twin of bench.py's ``Encoder``."""

    def __init__(self, fused=False, dtype=torch.float32):
        super().__init__()
        self.fused, self.dtype = fused, dtype
        self.tok = tnn.Embedding(VOCAB, D)
        self.pos = torch.nn.Parameter(0.02 * torch.randn(
            1, SEQ, D, generator=torch.Generator().manual_seed(0)))
        self.blocks = [f"block{i}" for i in range(LAYERS)]
        for name in self.blocks:
            self.add_module(name, tnn.TransformerLayer(
                D, HEADS, remat_attention=True))
        self.head = tnn.Dense(D, VOCAB)

    def forward(self, ids):
        x = (self.tok(ids) + self.pos).to(self.dtype)
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.fused:
            return x, self.head.kernel, self.head.bias
        return self.head(x)


def _xent(fused):
    if not fused:
        return "sparse_categorical_crossentropy"
    return lambda out, y: fused_softmax_xent(out[0], out[1], y, CHUNK,
                                             bias=out[2])


def _tokens(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (rows, SEQ)).astype(np.int32),
            rng.integers(0, VOCAB, (rows, SEQ)).astype(np.int32))


def _recipe_pair():
    """The JAX Estimator (its own init, seed 0) and the port's over the
    same weights: adamw on warmup_cosine, grad_accum=2."""
    ids, _ = _tokens(GLOBAL_BATCH, 0)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adamw",
              grad_accum=ACCUM)
    jest = JaxEstimator.from_keras(
        JaxEncoder(), learning_rate=jopt.resolve_learning_rate(
            dict(WARMUP_COSINE)), **kw)
    jest._ensure_initialized(jnp.asarray(ids))
    port = Encoder()
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    test = Estimator.from_keras(port, learning_rate=dict(WARMUP_COSINE),
                                device="cpu", **kw)
    return jest, test


def _resnet_pair():
    """A depth-18 width-8 batch-norm ResNet from one JAX init, sgd at
    0.01, in both Estimators."""
    x = np.zeros((8, 64, 64, 3), np.float32)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="sgd",
              learning_rate=0.01)
    jest = JaxEstimator.from_keras(JaxResNet(depth=18, class_num=10, width=8),
                                   **kw)
    jest._ensure_initialized(jnp.asarray(x))
    port = ResNet(depth=18, class_num=10, width=8)
    port.load_state_dict(from_jax_variables(jest.get_model()), strict=True)
    return jest, Estimator.from_keras(port, device="cpu", **kw)


def _images(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, 64, 64, 3)).astype(np.float32),
            rng.integers(0, 10, rows).astype(np.int32))


PAIRS = {"bert_mlm": (_recipe_pair, _tokens, 1e-4),
         "resnet_batch_norm": (_resnet_pair, _images, 1e-5)}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_multi_step_matches_the_jax_estimator(kind):
    """K steps on one batch (the JAX package's lax.scan): the K losses
    and the final variables."""
    make, data, atol = PAIRS[kind]
    jest, test = make()
    x, y = data(GLOBAL_BATCH, 1)
    mesh = init_orca_context("local")
    jbatch = next(jas_feed((x, y), GLOBAL_BATCH, shuffle=False).epoch(mesh))
    jest._ts, want = jest._multi_step(jest._ts, jbatch, K)
    tbatch = next(as_feed((x, y), GLOBAL_BATCH, shuffle=False).epoch(
        torch.device("cpu")))
    got = test._multi_step(tbatch, K)
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    got_v, want_v = test.get_model(), jest.get_model()
    _assert_trees_close(got_v["params"], want_v["params"], atol)
    if got_v.get("state"):
        _assert_trees_close(got_v["state"], want_v["state"], 1e-5)


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_multi_step_data_matches_the_jax_estimator(kind):
    """K steps over a leading-K chunk of K distinct batches."""
    make, data, atol = PAIRS[kind]
    jest, test = make()
    x, y = data(GLOBAL_BATCH * K, 2)
    chunk = {"x": x.reshape((K, GLOBAL_BATCH) + x.shape[1:]),
             "y": y.reshape((K, GLOBAL_BATCH) + y.shape[1:])}
    jest._ts, want = jest._multi_step_data(
        jest._ts, {k: jnp.asarray(v) for k, v in chunk.items()})
    got = test._multi_step_data(chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    got_v, want_v = test.get_model(), jest.get_model()
    _assert_trees_close(got_v["params"], want_v["params"], atol)
    if got_v.get("state"):
        _assert_trees_close(got_v["state"], want_v["state"], 1e-5)


def _squad(dropout, accum=1):
    model = BERTSQuAD(vocab_size=100, hidden_size=64, n_layers=2, n_heads=4,
                      max_position=40, dropout=dropout, use_flash=True)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _squad_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, (n, 40)).astype(np.int32),
            rng.integers(0, 40, (n, 2)).astype(np.int32))


def test_multi_step_is_k_train_steps_bit_for_bit():
    """The port's _multi_step(batch, k) against k of its own _train_step,
    with dropout (one generator drawn in the same order) and
    grad_accum=2; _multi_step_data over k copies of the batch likewise."""
    x, y = _squad_data(8)
    runs = []
    for how in ("train_step", "multi_step", "multi_step_data"):
        est = Estimator.from_keras(_squad(0.1), loss=squad_span_loss,
                                   optimizer="adamw", learning_rate=1e-3,
                                   grad_accum=2, seed=3, device="cpu")
        batch = next(as_feed((x, y), 8, shuffle=False).epoch(
            torch.device("cpu")))
        if how == "train_step":
            losses = torch.stack([est._train_step(batch) for _ in range(K)])
        elif how == "multi_step":
            losses = est._multi_step(batch, K)
        else:
            losses = est._multi_step_data({
                "x": np.stack([x] * K), "y": np.stack([y] * K)})
        assert est._py_step == K
        runs.append((losses, [p.detach().clone()
                              for p in est.model.parameters()]))
    for losses, params in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][1]))


def test_cpu_estimator_takes_the_eager_step():
    est = Estimator.from_keras(tnn.Dense(2, 2), loss="mse", device="cpu")
    assert not est.cuda_graphs
    x = np.ones((4, 2), np.float32)
    est.fit((x, x), epochs=2, batch_size=2, verbose=False)
    assert est.capture_count == 0 and est._py_step == 4


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels run "
                    "there")
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fit_losses(make_est, data, epochs, batch_size, prefetch=None):
    """Each step's loss of a fit, read after it (the step returns it)."""
    est = make_est()
    losses = []
    inner = est._train_step

    def step(batch):
        loss = inner(batch)
        losses.append(loss.clone())
        return loss

    est._train_step = step
    hist = est.fit(data, epochs=epochs, batch_size=batch_size,
                   prefetch=prefetch, verbose=False)
    return est, [float(v) for v in losses], hist


def _captured_vs_eager(make_model, data, epochs, batch_size,
                      prefetch=None, **kw):
    out = {}
    for graphs in (True, False):
        out[graphs] = _fit_losses(
            lambda: Estimator.from_keras(make_model(), cuda_graphs=graphs,
                                         **kw), data, epochs, batch_size,
            prefetch)
    (cap, cap_losses, cap_hist), (eag, eag_losses, eag_hist) = \
        out[True], out[False]
    assert cap_losses == eag_losses
    assert cap_hist == eag_hist
    for a, b in zip(cap.model.state_dict().values(),
                    eag.model.state_dict().values()):
        assert torch.equal(a, b)
    return cap, eag


@pytest.mark.cuda
def test_captured_bert_fit_equals_eager_bit_for_bit():
    """2-layer BERT, dropout 0.1, grad_accum=2, through the flash kernels:
    the same step losses and the same weights; one capture over 3
    epochs, and the flash launches counted from the replays."""
    _card()
    x, y = _squad_data(16)
    before = tfa.flash_attention_bwd.launches
    cap, eag = _captured_vs_eager(
        lambda: _squad(0.1), (x, y), 3, 8, loss=squad_span_loss,
        optimizer="adamw", learning_rate=1e-3, grad_accum=2, seed=3)
    assert cap.capture_count == 1 and eag.capture_count == 0
    # 2 steps an epoch x 3 epochs x 2 micro-batches x 2 layers, each fit
    assert tfa.flash_attention_bwd.launches - before == 2 * 6 * 2 * 2


@pytest.mark.cuda
def test_captured_resnet_fit_equals_eager_bit_for_bit():
    """A batch-norm ResNet through the fused batch norm (cuDNN's
    deterministic algorithms): the same step losses, weights and running
    statistics, and the kernels' launches counted per replay."""
    _card()
    x, y = _images(16, 3)
    state = ResNet(depth=18, class_num=10, width=8).state_dict()

    def make():
        model = ResNet(depth=18, class_num=10, width=8)
        model.load_state_dict(state)
        return model

    before = dict(tbn.KERNEL_LAUNCHES)
    cap, _ = _captured_vs_eager(
        make, (x, y), 2, 8,
        loss="sparse_categorical_crossentropy", optimizer="sgd",
        learning_rate=0.01, seed=1)
    n_bn = sum(isinstance(m, tnn.BatchNormalization)
               for m in cap.model.modules())
    got = {k: v - before[k] for k, v in tbn.KERNEL_LAUNCHES.items()}
    assert got["fwd_f32"] == got["bwd_f32"] == n_bn * 4 * 2


@pytest.mark.cuda
def test_captured_fused_head_multi_steps_equal_eager():
    """bench.py's recipe twin, bf16, the fused cross-entropy head:
    _multi_step and then _multi_step_data (a host chunk of K batches,
    copied on a side stream) from one graph equal the eager steps, and
    the kernels' launches are counted per replay."""
    _card()
    x, y = _tokens(GLOBAL_BATCH, 5)
    batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    xs, ys = _tokens(GLOBAL_BATCH * K, 6)
    chunk = {"x": xs.reshape(K, GLOBAL_BATCH, SEQ),
             "y": ys.reshape(K, GLOBAL_BATCH, SEQ)}
    state = Encoder(True).state_dict()
    losses = {}
    for graphs in (True, False):
        model = Encoder(True, torch.bfloat16)
        model.load_state_dict(state)
        est = Estimator.from_keras(model, loss=_xent(True), optimizer="adamw",
                                   learning_rate=dict(WARMUP_COSINE),
                                   grad_accum=ACCUM, cuda_graphs=graphs)
        before = txent.KERNEL_LAUNCHES["fwd_bf16"]
        losses[graphs] = (est._multi_step(batch, K).tolist()
                          + est._multi_step_data(chunk).tolist())
        assert txent.KERNEL_LAUNCHES["fwd_bf16"] - before == ACCUM * 2 * K
        assert est.capture_count == int(graphs)
    assert losses[True] == losses[False]


def _squad_row(i, rng=None):
    """A SQuAD row from its index: a decode on numpy only, so a forked
    worker of the process backend never touches the card."""
    r = np.random.default_rng(i)
    return {"x": r.integers(0, 100, (40,)).astype(np.int32),
            "y": r.integers(0, 40, (2,)).astype(np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("workers", ["thread", "process"])
def test_captured_fit_over_a_streaming_feed_equals_eager(workers):
    """fit(prefetch=2) over a StreamingDataFeed: host batches placed in the
    producer thread (pinned staging, a side-stream copy the step's stream
    waits for) while the first step is captured, then replays; the same
    step losses and weights as the eager fit, bit for bit, with dropout
    through the flash kernels."""
    _card()
    feed = StreamingDataFeed(20, _squad_row, batch_size=8, shuffle=True,
                             seed=5, num_workers=2, workers=workers)
    assert _supports_host_epoch(feed)
    cap, _ = _captured_vs_eager(
        lambda: _squad(0.1), feed, 3, 8, prefetch=2, loss=squad_span_loss,
        optimizer="adamw", learning_rate=1e-3, seed=3)
    assert cap.capture_count == 1 and cap._py_step == 2 * 3


@pytest.mark.cuda
def test_one_capture_per_batch_key():
    """Epochs replay one graph; a new batch shape is a second capture."""
    _card()
    est = Estimator.from_keras(_squad(0.0), loss=squad_span_loss,
                               optimizer="adamw", learning_rate=1e-3)
    x, y = _squad_data(16)
    est.fit((x, y), epochs=3, batch_size=8, verbose=False)
    assert est.capture_count == 1
    est.fit((x, y), epochs=1, batch_size=4, verbose=False)
    assert est.capture_count == 2
    est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    assert est.capture_count == 2


class _HostRead(torch.nn.Module):
    """A model that reads a value back to the host inside its forward,
    which a CUDA graph cannot capture."""

    def __init__(self):
        super().__init__()
        self.dense = tnn.Dense(2, 2)

    def forward(self, x):
        scale = float(x.abs().max())
        return self.dense(x) * scale


@pytest.mark.cuda
def test_a_failed_capture_raises_naming_the_op():
    _card()
    est = Estimator.from_keras(_HostRead(), loss="mse", optimizer="sgd",
                               learning_rate=0.1)
    x = np.ones((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="capture of the train step "
                       "failed at .*float"):
        est.fit((x, x), epochs=1, batch_size=4, verbose=False)
