"""The port's recurrent layers and ``Conv1D`` against the JAX package on the
CPU: ``LSTM``, ``GRU`` and ``SimpleRNN`` forward and backward, each way,
with and without the sequence, their ``return_state`` carries;
``Bidirectional`` under each merge mode; ``TimeDistributed``; ``Conv1D``
with strides, dilation and both paddings; the ``orthogonal`` initializer;
``Seq2seq`` (bridge, context step, attention) and its greedy ``infer``.

Each layer is initialised in JAX, its variables go through
``convert.from_jax_variables`` into the port's module, and the same
numpy inputs go through both.  Gradients: of ``sum(out * r)`` over every
output (and carry) with a seeded ``r``, against ``jax.grad`` of the same
sum, over the input and every parameter.  Tolerance: 1e-5 of max(1, max
|ref|), outputs and gradients alike (f32 in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
import analytics_zoo_tpu_torch.nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables, jax_tree

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * scale, err_msg=what)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _flat(out):
    """Every array of a layer's output (the carry's too), in order."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _both_with_grads(jmod, tmod, x):
    """Outputs and gradients of ``jmod`` (JAX, initialised on ``x``) and
    ``tmod`` (the port, loaded with the same variables) on ``x``: returns
    (want outputs, got outputs, want grads, got grads), the grads a dict
    of the input's (``"x"``) and each parameter's by ``state_dict`` key."""
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tmod.load_state_dict(from_jax_variables(variables), strict=True)
    want_out, _ = jmod.apply(variables, jnp.asarray(x))
    want_out = _flat(want_out)
    rs = [_x(100 + i, *np.shape(o)) for i, o in enumerate(want_out)]

    def jloss(params, xj):
        out, _ = jmod.apply({"params": params, "state": {}}, xj)
        return sum(jnp.sum(o * r) for o, r in zip(_flat(out), rs))

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(variables["params"],
                                                      jnp.asarray(x))
    want_grads = dict(from_jax_variables({"params": gp}))
    want_grads["x"] = np.asarray(gx)

    xt = torch.from_numpy(x).requires_grad_(True)
    got_out = _flat(tmod(xt))
    loss = sum((o * torch.from_numpy(r)).sum()
               for o, r in zip(got_out, rs))
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(loss, [xt] + list(tmod.parameters()))
    got_grads = {"x": grads[0].numpy()}
    got_grads.update({n: g.numpy() for n, g in zip(names, grads[1:])})
    return ([np.asarray(o) for o in want_out],
            [o.detach().numpy() for o in got_out], want_grads, got_grads)


def _check(jmod, tmod, x, what):
    want, got, want_g, got_g = _both_with_grads(jmod, tmod, x)
    assert len(want) == len(got), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        _close(g, w, f"{what} output {i}")
    assert set(got_g) == set(want_g), (what, sorted(got_g), sorted(want_g))
    for k in want_g:
        _close(got_g[k], want_g[k], f"{what} grad {k}")


CELLS = {"lstm": (jnn.LSTM, tnn.LSTM), "gru": (jnn.GRU, tnn.GRU),
         "simple": (jnn.SimpleRNN, tnn.SimpleRNN)}


@pytest.mark.parametrize("seq", [False, True], ids=["last", "seq"])
@pytest.mark.parametrize("backwards", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_matches_jax(cell, backwards, seq):
    """Outputs, the ``return_state`` carry and gradients; a go_backwards
    layer's last output is the last step of its loop."""
    jcls, tcls = CELLS[cell]
    x = _x(0, 3, 7, 5)
    kw = dict(return_sequences=seq, return_state=True,
              go_backwards=backwards)
    _check(jcls(6, **kw), tcls(5, 6, **kw), x, f"{cell} {kw}")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cell_without_state_returns_one_array(cell):
    jcls, tcls = CELLS[cell]
    x = _x(2, 2, 4, 3)
    _check(jcls(5, return_sequences=True), tcls(3, 5, return_sequences=True),
           x, cell)
    out = tcls(3, 5)(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 5)


def test_lstm_forget_gate_is_shifted_by_one():
    """All-zero weights: c = sigmoid(1) * c + sigmoid(0) * tanh(0), so the
    state stays 0 and h is 0; the forget bias matters once c is not 0,
    which a unit input through the g gate makes."""
    layer = tnn.LSTM(1, 1, return_state=True)
    with torch.no_grad():
        for p in layer.parameters():
            p.zero_()
        layer.kernel[0, 2] = 10.0  # g = tanh(10 x) ~ 1
    x = torch.tensor([[[1.0], [0.0]]])
    _, (h, c) = layer(x)
    s0, s1 = torch.sigmoid(torch.tensor(0.0)), torch.sigmoid(torch.tensor(1.0))
    c1 = s0 * torch.tanh(torch.tensor(10.0))
    torch.testing.assert_close(c[0, 0], s1 * c1)


@pytest.mark.parametrize("mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_matches_jax(mode):
    x = _x(3, 2, 6, 4)
    jmod = jnn.Bidirectional(jnn.LSTM(5, return_sequences=True), mode)
    tmod = tnn.Bidirectional(tnn.LSTM(4, 5, return_sequences=True), mode)
    assert sorted(tmod.state_dict()) == [
        f"{d}.{p}" for d in ("backward", "forward")
        for p in ("bias", "kernel", "recurrent_kernel")]
    assert tmod._modules["backward"].go_backwards
    _check(jmod, tmod, x, mode)


def test_bidirectional_rejects_an_unknown_merge_mode():
    with pytest.raises(ValueError, match="merge_mode"):
        tnn.Bidirectional(tnn.GRU(2, 3), "max")


def test_time_distributed_matches_jax():
    x = _x(4, 3, 5, 6)
    _check(jnn.TimeDistributed(jnn.Dense(4, activation="tanh")),
           tnn.TimeDistributed(tnn.Dense(6, 4, activation="tanh")), x,
           "time_distributed")


CONV1D = {
    "same": dict(kernel_size=3),
    "valid": dict(kernel_size=3, padding="valid"),
    "dilated_valid": dict(kernel_size=3, padding="valid", dilation=2),
    "dilated_same": dict(kernel_size=2, dilation=4),
    "strided_same": dict(kernel_size=3, strides=2, activation="relu"),
    "no_bias": dict(kernel_size=1, use_bias=False),
}


@pytest.mark.parametrize("case", sorted(CONV1D))
def test_conv1d_matches_jax(case):
    kw = CONV1D[case]
    x = _x(5, 2, 11, 3)
    tmod = tnn.Conv1D(3, 4, **kw)
    assert tmod.conv.kernel.shape == (4, 3, 1, kw["kernel_size"])
    _check(jnn.Conv1D(4, **kw), tmod, x, case)


def test_conv1d_kernel_round_trips_the_jax_layout():
    """The converter's HWIO <-> OIHW map holds for the 1 x k kernel."""
    jmod = jnn.Conv1D(4, 3, dilation=2)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(_x(6, 1, 9, 2)))
    tmod = tnn.Conv1D(2, 4, 3, dilation=2)
    tmod.load_state_dict(from_jax_variables(variables), strict=True)
    back = jax_tree(tmod.state_dict().items())
    np.testing.assert_array_equal(back["conv"]["kernel"].numpy(),
                                  np.asarray(variables["params"]["conv"]
                                             ["kernel"]))


@pytest.mark.parametrize("shape", [(6, 24), (8, 8), (10, 4)])
def test_orthogonal_initializer(shape):
    """Orthonormal along the shorter side, drawn from the generator."""
    t = torch.empty(shape)
    tnn.initializers.get("orthogonal")(t, torch.Generator().manual_seed(0))
    m = t @ t.T if shape[0] <= shape[1] else t.T @ t
    torch.testing.assert_close(m, torch.eye(min(shape)), atol=1e-5,
                               rtol=0)
    t2 = torch.empty(shape)
    tnn.initializers.orthogonal(t2, torch.Generator().manual_seed(0))
    assert torch.equal(t, t2)


def test_recurrent_kernels_draw_from_the_generator():
    a = tnn.GRU(3, 4)
    b = tnn.GRU(3, 4)
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert a.bias.abs().sum() == 0


# -- Seq2seq ------------------------------------------------------------------

SEQ2SEQ = {
    "lstm_attention": dict(rnn_type="lstm", use_attention=True),
    "gru_two_layers": dict(rnn_type="gru", num_layers=2),
    "no_bridge_same_width": dict(bridge="none", embed_dim=7, hidden_size=7),
    "output_dim": dict(output_dim=5, use_attention=True),
}


def _seq2seq_pair(**kw):
    from analytics_zoo_tpu.models import Seq2seq as JaxSeq2seq
    from analytics_zoo_tpu_torch.models import Seq2seq
    kw = dict(dict(vocab_size=13, embed_dim=6, hidden_size=9,
                   encoder_length=5, decoder_length=4), **kw)
    return JaxSeq2seq(**kw), Seq2seq(**kw)


@pytest.mark.parametrize("case", sorted(SEQ2SEQ))
def test_seq2seq_matches_jax(case):
    """The bridge, the context step, Luong attention: outputs, and with
    attention the gradients too."""
    jmod, tmod = _seq2seq_pair(**SEQ2SEQ[case])
    ids = np.random.default_rng(7).integers(0, 13, (3, 9))
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(ids))
    tmod.load_state_dict(from_jax_variables(variables), strict=True)
    want = jax.jit(lambda v, i: jmod.apply(v, i)[0])(variables,
                                                     jnp.asarray(ids))
    got = tmod(torch.from_numpy(ids))
    _close(got.detach().numpy(), want, case)
    if case != "lstm_attention":
        return
    r = _x(8, *want.shape)

    def jloss(params):
        out, _ = jmod.apply({"params": params, "state": {}},
                            jnp.asarray(ids))
        return jnp.sum(out * r)

    want_g = from_jax_variables(
        {"params": jax.jit(jax.grad(jloss))(variables["params"])})
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad((got * torch.from_numpy(r)).sum(),
                                list(tmod.parameters()))
    assert sorted(names) == sorted(want_g)
    for n, g in zip(names, grads):
        _close(g.numpy(), want_g[n], f"{case} grad {n}")


def test_seq2seq_infer_matches_jax():
    """Greedy decoding over the rolling window: the JAX package's ids."""
    from analytics_zoo_tpu.core import init_orca_context
    init_orca_context("local")
    jmod, tmod = _seq2seq_pair(use_attention=True)
    enc = np.random.default_rng(9).integers(1, 13, (4, 5)).astype(np.int32)
    jmod.compile(loss="sparse_categorical_crossentropy", optimizer="adam")
    jmod.estimator._ensure_initialized(
        jnp.asarray(np.concatenate([enc, enc[:, :4]], 1)))
    tmod.load_state_dict(from_jax_variables(jmod.estimator.get_model()),
                         strict=True)
    with pytest.raises(ValueError, match="compile"):
        tmod.infer(enc)
    tmod.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
                 device="cpu")
    for length in (None, 7):
        got = tmod.infer(enc, start_id=1, max_length=length)
        want = jmod.infer(enc, start_id=1, max_length=length)
        assert got.shape == (4, length or 4)
        np.testing.assert_array_equal(got, want)
    assert tmod.training  # infer leaves the mode as it found it
