"""The port's fused softmax cross-entropy against the JAX package's
``ops/fused_xent.fused_softmax_xent`` (its value, and ``jax.value_and_grad``
of the ``custom_vjp``) on the CPU, where the wrappers take the plain
versions; and, on a card, the CUDA kernels against the plain versions.

Tolerances.  float32: the loss within 1e-6 relative and every gradient
within 1e-6 absolute of JAX's (the same chunked f32 math; only the order of
the f32 sums differs), against the custom_vjp and against the naive path
that materialises the logits.  bfloat16: the bf16 loss within 3e-2 of the
f32 one (the twin of ``tests/test_ops.py``'s check); the port's bf16 loss
within 1e-6 relative of JAX's bf16 loss and its gradients within one bf16
ulp (2^-8 relative, taken of max |ref|) of JAX's: the f32 logits of bf16
products are the same sums on both sides, and each side rounds ``dl`` and
``dh`` to bf16 once.

On the card (``cuda`` tests): f32 runs scalar f32 FMAs in its forward,
so the loss and lse are held to 1e-5 relative and each gradient to 1e-5
of its max |ref|; bf16 runs the tensor cores with f32 sums, so the loss
and lse to 1e-5 relative, dh (rounded to bf16 once on each side) to 2
bf16 ulps of its max, and dW and db (f32 sums of bf16-rounded terms) to
1e-3 of their max (2 bf16 ulps where dW comes back in bf16).  The same
input twice gives identical bits, and so does the bf16 backward with the
forward's copy of W and without.
"""

import ctypes
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import fused_softmax_xent as jax_fused
from analytics_zoo_tpu_torch.ops import (fused_softmax_xent,
                                         fused_xent_bwd,
                                         fused_xent_bwd_reference,
                                         fused_xent_fwd,
                                         fused_xent_reference)

jfx = importlib.import_module("analytics_zoo_tpu.ops.fused_xent")
tfx = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_xent")
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, b, s, d, v, edge_labels=False):
    """h, w, bias (f32 numpy) and int labels; with ``edge_labels`` the
    first and last tokens take labels 0 and V-1."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, s))
    if edge_labels:
        labels[0, 0], labels[-1, -1] = 0, v - 1
    return h, w, bias, labels


def _jax_value_and_grads(h, w, bias, labels, chunk, dtype=jnp.float32):
    def loss(h, w, bias):
        return jax_fused(h.astype(dtype), w.astype(dtype), jnp.asarray(labels),
                         chunk, bias=bias)

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias))
    return float(val), [np.asarray(g, np.float32) for g in grads]


def _port_value_and_grads(h, w, bias, labels, chunk, dtype=torch.float32):
    th, tw, tb = (torch.tensor(a, requires_grad=True) for a in (h, w, bias))
    loss = fused_softmax_xent(th.to(dtype), tw.to(dtype),
                              torch.from_numpy(labels), chunk, bias=tb)
    loss.backward()
    return float(loss.detach()), [t.grad.float().numpy()
                                  for t in (th, tw, tb)]


@pytest.mark.parametrize("b,s,d,v,chunk", [
    (2, 8, 16, 50, 4),     # tests/test_ops.py's shape
    (1, 12, 13, 37, 6),    # D and V not multiples of 8
    (3, 4, 7, 9, 12),      # one chunk of every token
    (2, 16, 24, 129, 32),  # V just past a 128-wide tile
])
def test_f32_loss_and_gradients_match_the_jax_custom_vjp(b, s, d, v, chunk):
    h, w, bias, labels = _case(0, b, s, d, v, edge_labels=True)
    want, gwant = _jax_value_and_grads(h, w, bias, labels, chunk)
    got, ggot = _port_value_and_grads(h, w, bias, labels, chunk)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, ref in zip(ggot, gwant):
        np.testing.assert_allclose(a, ref, atol=1e-6)


def test_f32_matches_the_jax_naive_logits_path():
    """The twin of ``test_fused_softmax_xent_matches_naive``: the port's
    fused op against JAX's materialised logits and their loss."""
    h, w, bias, labels = _case(0, 2, 8, 16, 50)

    def naive(h, w, bias):
        logits = (h @ w).astype(jnp.float32) + bias
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        corr = jnp.take_along_axis(
            logits, jnp.asarray(labels)[..., None], axis=-1)[..., 0]
        return (lse - corr).mean()

    want, gwant = jax.value_and_grad(naive, argnums=(0, 1, 2))(h, w, bias)
    got, ggot = _port_value_and_grads(h, w, bias, labels, 4)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    for a, ref in zip(ggot, gwant):
        np.testing.assert_allclose(a, np.asarray(ref), atol=1e-6)


def test_the_plain_forward_keeps_the_jax_lse():
    """``fused_xent_reference`` returns the per-token logsumexp the JAX
    forward keeps as its residual (``_fused_fwd_impl``)."""
    h, w, bias, labels = _case(1, 2, 8, 16, 50)
    jloss, jlse = jfx._fused_fwd_impl(jnp.asarray(h), jnp.asarray(w),
                                      jnp.asarray(bias), jnp.asarray(labels),
                                      4)
    loss, lse = fused_xent_reference(torch.from_numpy(h), torch.from_numpy(w),
                                     torch.from_numpy(bias),
                                     torch.from_numpy(labels), 4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(-1),
                               rtol=1e-6)


def test_bias_none_means_f32_zeros():
    h, w, _, labels = _case(2, 2, 8, 16, 50)
    want = float(jax_fused(jnp.asarray(h), jnp.asarray(w),
                           jnp.asarray(labels), 8))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = fused_softmax_xent(th, tw, torch.from_numpy(labels), 8)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    zeros = np.zeros(w.shape[1], np.float32)
    np.testing.assert_allclose(
        float(fused_softmax_xent(th.detach(), tw.detach(),
                                 torch.from_numpy(labels), 8,
                                 bias=torch.from_numpy(zeros))),
        float(got.detach()), rtol=0)
    assert th.grad.shape == th.shape and tw.grad.shape == tw.shape


def test_bf16_is_close_to_f32():
    """The twin of ``test_fused_softmax_xent_bf16_close``."""
    rng = np.random.default_rng(1)
    h = rng.normal(size=(1, 16, 8)).astype(np.float32)
    w = (rng.normal(size=(8, 30)) * 0.2).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 30, (1, 16)))
    lf32 = fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                              labels, 8)
    lbf = fused_softmax_xent(torch.from_numpy(h).bfloat16(),
                             torch.from_numpy(w).bfloat16(), labels, 8)
    assert lbf.dtype == torch.float32
    np.testing.assert_allclose(float(lbf), float(lf32), rtol=3e-2)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_bf16_matches_jax_bf16(w_dtype):
    """bf16 activations with an f32 head kernel (the recipe's: w is cast to
    h's dtype per call) or a bf16 one: the loss as JAX's, dh (bf16) and dW,
    db within one bf16 ulp of max |ref|."""
    h, w, bias, labels = _case(3, 2, 16, 24, 77, edge_labels=True)
    hb = jnp.asarray(h, jnp.bfloat16)
    wj = jnp.asarray(w, getattr(jnp, w_dtype))

    def loss(hb, wj, bias):
        return jax_fused(hb, wj, jnp.asarray(labels), 8, bias=bias)

    want, gwant = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        hb, wj, jnp.asarray(bias))
    th = torch.from_numpy(h).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype)).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    got = fused_softmax_xent(th, tw, torch.from_numpy(labels), 8, bias=tb)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for t, ref in zip((th, tw, tb), gwant):
        assert t.grad.dtype == t.dtype
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(t.grad.float().numpy(), ref,
                                   atol=BF16_ULP * np.abs(ref).max())


@pytest.mark.parametrize("chunk", [3, 0, 32])
def test_a_chunk_that_does_not_divide_the_tokens_is_refused(chunk):
    with pytest.raises(ValueError, match="divisible"):
        fused_softmax_xent(torch.zeros(2, 5, 4), torch.zeros(4, 7),
                           torch.zeros(2, 5, dtype=torch.int32), chunk)


def test_mismatched_shapes_are_refused():
    with pytest.raises(ValueError, match="w must be"):
        fused_softmax_xent(torch.zeros(2, 4, 4), torch.zeros(5, 7),
                           torch.zeros(2, 4, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="labels"):
        fused_softmax_xent(torch.zeros(2, 4, 4), torch.zeros(4, 7),
                           torch.zeros(8, dtype=torch.int64), 4)


def test_the_cpu_runs_no_kernel():
    h, w, bias, labels = _case(4, 2, 8, 16, 50)
    before = dict(tfx.KERNEL_LAUNCHES)
    _port_value_and_grads(h, w, bias, labels, 4)
    assert dict(tfx.KERNEL_LAUNCHES) == before
    assert tfx.fused_xent_fwd.launches == tfx.fused_xent_bwd.launches == 0


def test_the_wrappers_take_the_plain_versions_on_the_cpu():
    h, w, bias, labels = (torch.from_numpy(a) for a in _case(5, 2, 8, 16, 50))
    loss, lse = fused_xent_fwd(h, w, bias, labels, 4)
    want = fused_xent_reference(h, w, bias, labels, 4)
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])
    g = torch.tensor(1.5)
    got = fused_xent_bwd(h, w, bias, labels, lse, g, 4)
    ref = fused_xent_bwd_reference(h, w, bias, labels, lse, g, 4)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_xent_fwd(h.to("meta"), w.to("meta"), bias.to("meta"),
                       labels.to("meta"), 4)


@pytest.mark.parametrize("n,d,v", [(2048, 768, 30522), (129, 13, 30),
                                   (300, 40, 777), (512, 768, 4099),
                                   (5504, 64, 1000), (1, 1, 1)])
def test_tf32_bwd_plan_covers_every_tile_and_the_vocabulary(n, d, v):
    """The f32 design's grids: dh's splits cover round8(V) in whole
    64-deep k slices, none empty, about eight waves of one block an SM."""
    plan = tfx.bwd_plan(n, d, v, "wgmma_tf32")
    assert plan.vp == -(-v // 8) * 8
    assert plan.split_len % tfx.TF_BK == 0
    assert (plan.splits - 1) * plan.split_len < plan.vp \
        <= plan.splits * plan.split_len
    blocks = plan.row_tiles * plan.d_tiles * plan.splits
    assert blocks <= tfx.TF_TARGET_BLOCKS + plan.row_tiles * plan.d_tiles
    if (n, d, v) == (2048, 768, 30522):  # the recipe's: 8 waves of 132
        assert (plan.splits, plan.split_len, blocks) == (11, 2816, 1056)


@pytest.mark.parametrize("n,d,v", [(2048, 768, 30522), (129, 13, 30),
                                   (300, 40, 777), (512, 768, 4099),
                                   (5504, 64, 1000), (1, 1, 1)])
def test_bwd_plan_covers_every_tile_and_the_vocabulary(n, d, v):
    """The wgmma backward's grids cover tokens, D and V with whole tiles,
    and dh's splits cover round8(V) in whole k slices, none empty."""
    plan = tfx.bwd_plan(n, d, v)
    for count, tiles in ((n, plan.row_tiles), (d, plan.d_tiles),
                         (v, plan.v_tiles)):
        assert (tiles - 1) * tfx.TILE < count <= tiles * tfx.TILE
    assert plan.vp == -(-v // 8) * 8
    assert plan.split_len % tfx.WG_BK == 0
    assert (plan.splits - 1) * plan.split_len < plan.vp \
        <= plan.splits * plan.split_len
    blocks = plan.row_tiles * plan.d_tiles * plan.splits
    assert blocks <= tfx.WG_TARGET_BLOCKS + plan.row_tiles * plan.d_tiles
    if (n, d, v) == (2048, 768, 30522):  # the recipe's: 4 waves of 264
        assert (plan.splits, plan.split_len, blocks) == (11, 2816, 1056)


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "wgmma_tf32")])
def test_bwd_design_names_the_backward_by_dtype(dtype, design):
    assert tfx.bwd_design(dtype) == design
    assert design in tfx.BWD_DESIGNS


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "scalar")])
def test_fwd_design_names_the_forward_by_dtype(dtype, design):
    assert tfx.fwd_design(dtype) == design
    assert design in tfx.FWD_DESIGNS


def test_the_cpu_forward_hands_on_no_packed_w():
    """On the CPU the forward packs nothing, so the autograd Function's
    backward gets no copy of W to read."""
    h, w, bias, labels = (torch.from_numpy(a) for a in _case(6, 2, 8, 16, 50))
    loss, lse, w_packed = tfx._fwd(h.to(torch.bfloat16), w, bias, labels, 4)
    assert w_packed is None
    want = fused_xent_reference(h.to(torch.bfloat16), w, bias, labels, 4)
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])


# -- on the card --------------------------------------------------------------

def _card_case(gen, n, d, v, dtype, w_dtype, scale=1.0):
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    h = (r(n, d) * scale).to(dtype)
    w = (r(d, v) * 0.05).to(w_dtype)
    bias = r(v) * 0.1
    labels = torch.randint(0, v, (n,), device="cuda", generator=gen)
    labels[0], labels[-1] = 0, v - 1
    return h, w, bias, labels


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


CARD_CASES = [(n, d, v, chunk, dt, wdt)
              for n, d, v, chunk in ((256, 64, 1000, 128), (300, 40, 777, 100),
                                     (129, 13, 30, 43), (512, 768, 4099, 256))
              for dt, wdt in (("float32", "float32"),
                              ("bfloat16", "float32"),
                              ("bfloat16", "bfloat16"))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,chunk,dtype,w_dtype", CARD_CASES)
def test_kernels_match_the_plain_version_on_card(n, d, v, chunk, dtype,
                                                  w_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(n + d + v)
    h, w, bias, labels = _card_case(gen, n, d, v, getattr(torch, dtype),
                                    getattr(torch, w_dtype))
    before = (tfx.fused_xent_fwd.launches, tfx.fused_xent_bwd.launches)
    loss, lse = fused_xent_fwd(h, w, bias, labels, chunk)
    g = torch.tensor(1.3, device="cuda")
    dh, dw, db = fused_xent_bwd(h, w, bias, labels, lse, g, chunk)
    rloss, rlse = fused_xent_reference(h, w, bias, labels, chunk)
    rdh, rdw, rdb = fused_xent_bwd_reference(h, w, bias, labels, rlse, g,
                                             chunk)
    torch.cuda.synchronize()
    assert (tfx.fused_xent_fwd.launches, tfx.fused_xent_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert abs(loss.item() - rloss.item()) <= 1e-5 * abs(rloss.item())
    assert ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max() <= 1e-5
    for a, b in ((dh, rdh), (dw, rdw), (db, rdb)):
        assert a.shape == b.shape and a.dtype == b.dtype
    tol_dh = 1e-5 if dtype == "float32" else 2 * BF16_ULP
    tol_w = 1e-5 if dtype == "float32" else 1e-3
    assert _rel(dh, rdh) <= tol_dh
    assert _rel(dw, rdw) <= tol_w if w_dtype == "float32" else \
        _rel(dw, rdw) <= 2 * BF16_ULP
    assert _rel(db, rdb) <= tol_w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_repeat_bit_for_bit_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(7)
    h, w, bias, labels = _card_case(gen, 384, 96, 3001, getattr(torch, dtype),
                                    torch.float32, scale=100.0)
    g = torch.tensor(1.0, device="cuda")
    runs = []
    for _ in range(2):
        loss, lse = fused_xent_fwd(h, w, bias, labels, 128)
        runs.append((loss, lse) + fused_xent_bwd(h, w, bias, labels, lse, g,
                                                 128))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert all(torch.isfinite(t).all() for t in runs[0])


def _bwd_errors(h, w, bias, labels, g, chunk):
    """The backward of the kernels against the plain version's from the
    same lse: (dh, dw, db) relative to max |ref|, after checking dtypes
    and shapes."""
    _, lse = fused_xent_fwd(h, w, bias, labels, chunk)
    got = fused_xent_bwd(h, w, bias, labels, lse, g, chunk)
    ref = fused_xent_bwd_reference(h, w, bias, labels, lse, g, chunk)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all()
    return got, [_rel(a, b) for a, b in zip(got, ref)]


# the wgmma design's cases: (n, d, v, chunk, w dtype, g): the recipe's
# head with f32 and bf16 W; token counts that are no multiple of 64 or 128;
# D 13 and 40 (h packed, or one 64-wide box part empty); V 30 and 4,099
WGMMA_CASES = [(2048, 768, 30522, 512, "float32", 1.0),
               (2048, 768, 30522, 512, "bfloat16", 1.0),
               (300, 40, 777, 100, "float32", 1.0),
               (129, 13, 30, 43, "bfloat16", 0.37),
               (200, 96, 4099, 8, "float32", 2.5),
               (512, 768, 4099, 256, "bfloat16", 1.0),
               (1000, 13, 30, 1000, "float32", 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,chunk,w_dtype,g", WGMMA_CASES)
def test_wgmma_backward_matches_the_plain_version_on_card(n, d, v, chunk,
                                                          w_dtype, g):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert tfx.bwd_design(torch.bfloat16) == "wgmma"
    gen = torch.Generator(device="cuda").manual_seed(n + d + v)
    h, w, bias, labels = _card_case(gen, n, d, v, torch.bfloat16,
                                    getattr(torch, w_dtype))
    before = dict(tfx.KERNEL_LAUNCHES)
    _, (e_dh, e_dw, e_db) = _bwd_errors(
        h, w, bias, labels, torch.tensor(g, device="cuda"), chunk)
    for p in ("dl", "dh", "dw"):
        assert tfx.KERNEL_LAUNCHES[f"{p}_bf16"] == before[f"{p}_bf16"] + 1
    assert e_dh <= 2 * BF16_ULP
    assert e_dw <= (1e-3 if w_dtype == "float32" else 2 * BF16_ULP)
    assert e_db <= 1e-3


@pytest.mark.cuda
def test_wgmma_backward_is_the_same_for_every_chunk_on_card():
    """``chunk`` shapes the plain version, not the kernels' schedule: 43,
    128 and every token give identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 43 * 128
    gen = torch.Generator(device="cuda").manual_seed(11)
    h, w, bias, labels = _card_case(gen, n, 64, 1000, torch.bfloat16,
                                    torch.float32)
    g = torch.tensor(1.0, device="cuda")
    _, lse = fused_xent_fwd(h, w, bias, labels, n)
    runs = [fused_xent_bwd(h, w, bias, labels, lse, g, chunk)
            for chunk in (43, 128, n)]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    _, errs = _bwd_errors(h, w, bias, labels, g, 43)
    assert errs[0] <= 2 * BF16_ULP and max(errs[1:]) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_wgmma_backward_repeats_bit_for_bit_at_the_recipe_on_card(w_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(12)
    h, w, bias, labels = _card_case(gen, 2048, 768, 30522, torch.bfloat16,
                                    getattr(torch, w_dtype), scale=10.0)
    g = torch.tensor(1.0, device="cuda")
    _, lse = fused_xent_fwd(h, w, bias, labels, 512)
    first = fused_xent_bwd(h, w, bias, labels, lse, g, 512)
    again = fused_xent_bwd(h, w, bias, labels, lse, g, 512)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_design_mirrors_the_source_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from analytics_zoo_tpu_torch.ops import _build
    fn = _build.load(tfx.SOURCE).fused_xent_bwd_design
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    dt = getattr(torch, dtype)
    assert tfx.BWD_DESIGNS[fn(int(dt == torch.bfloat16))] == \
        tfx.bwd_design(dt)


# the f32 design's cases: (n, d, v, chunk, w dtype, h scale): the recipe's
# head with f32 and bf16 W, at logits of 1e2 too (dl then needs the
# forward's own summation order, which the scalar logits keep); the
# ragged N, D and V of chip_smoke.py's XENT_EDGE (D 13 and 40: W's and h's
# parts padded, boxes zero-filled)
TF32_CASES = [(2048, 768, 30522, 512, "float32", 1.0),
              (2048, 768, 30522, 512, "bfloat16", 1.0),
              (2048, 768, 30522, 512, "float32", 100.0),
              (512, 96, 3001, 128, "float32", 100.0),
              (300, 40, 777, 100, "float32", 1.0),
              (129, 13, 30, 43, "bfloat16", 1.0),
              (256, 64, 1000, 128, "float32", 1.0),
              (512, 768, 4099, 256, "float32", 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,chunk,w_dtype,scale", TF32_CASES)
def test_tf32_backward_matches_the_plain_version_on_card(n, d, v, chunk,
                                                         w_dtype, scale):
    """The f32 backward (logits on f32 FMAs, dh and dW on wgmma in 3xTF32)
    against the plain version: each gradient within 1e-5 of its max |ref|
    (chip_smoke.py's TOL_XENT_F32), but a bf16 dW, rounded once on each
    side, within 2 bf16 ulps of its max; one launch of each pass and of
    the design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(n + d + v)
    h, w, bias, labels = _card_case(gen, n, d, v, torch.float32,
                                    getattr(torch, w_dtype), scale)
    before = dict(tfx.KERNEL_LAUNCHES)
    designs = dict(tfx.BWD_LAUNCHES)
    _, errs = _bwd_errors(h, w, bias, labels, torch.tensor(1.3, device="cuda"),
                          chunk)
    for p in ("dl", "dh", "dw"):
        assert tfx.KERNEL_LAUNCHES[f"{p}_f32"] == before[f"{p}_f32"] + 1
    assert tfx.BWD_LAUNCHES["wgmma_tf32"] == designs["wgmma_tf32"] + 1
    assert errs[0] <= 1e-5 and errs[2] <= 1e-5
    assert errs[1] <= (1e-5 if w_dtype == "float32" else 2 * BF16_ULP)


@pytest.mark.cuda
def test_tf32_backward_repeats_bit_for_bit_at_the_recipe_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(13)
    h, w, bias, labels = _card_case(gen, 2048, 768, 30522, torch.float32,
                                    torch.float32, scale=100.0)
    g = torch.tensor(1.0, device="cuda")
    _, lse = fused_xent_fwd(h, w, bias, labels, 512)
    first = fused_xent_bwd(h, w, bias, labels, lse, g, 512)
    again = fused_xent_bwd(h, w, bias, labels, lse, g, 512)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# the bf16 forward's (wgmma) cases: (n, d, v, chunk, w dtype, h scale,
# flat row): the recipe's head with f32 and bf16 W and at logits of 1e2;
# ragged N, D (h packed) and V (the last tile mostly past V); a row of
# equal logits
WGMMA_FWD_CASES = [(2048, 768, 30522, 512, "float32", 1.0, False),
                   (2048, 768, 30522, 512, "bfloat16", 1.0, False),
                   (2048, 768, 30522, 512, "float32", 100.0, False),
                   (300, 40, 777, 100, "float32", 1.0, False),
                   (129, 13, 30, 43, "bfloat16", 1.0, False),
                   (512, 768, 4099, 256, "float32", 1.0, False),
                   (512, 96, 3001, 128, "float32", 1.0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,chunk,w_dtype,scale,flat", WGMMA_FWD_CASES)
def test_wgmma_forward_matches_the_plain_version_on_card(n, d, v, chunk,
                                                         w_dtype, scale,
                                                         flat):
    """The bf16 forward on wgmma against the plain version: loss and lse
    within 1e-5 relative (chip_smoke.py's TOL_XENT_LOSS), labels at 0 and
    V-1; one launch, of the wgmma design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(n + d + v)
    h, w, bias, labels = _card_case(gen, n, d, v, torch.bfloat16,
                                    getattr(torch, w_dtype), scale)
    if flat:
        h[1] = 0.0
        bias.zero_()
    before = dict(tfx.FWD_LAUNCHES)
    loss, lse = fused_xent_fwd(h, w, bias, labels, chunk)
    rloss, rlse = fused_xent_reference(h, w, bias, labels, chunk)
    torch.cuda.synchronize()
    want = dict(before)
    want["wgmma"] += 1
    assert tfx.FWD_LAUNCHES == want
    assert loss.shape == () and lse.shape == (n,)
    assert torch.isfinite(lse).all()
    assert abs(loss.item() - rloss.item()) <= 1e-5 * max(1.0,
                                                         abs(rloss.item()))
    assert ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max() <= 1e-5


@pytest.mark.cuda
def test_wgmma_forward_repeats_bit_for_bit_at_the_recipe_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(14)
    h, w, bias, labels = _card_case(gen, 2048, 768, 30522, torch.bfloat16,
                                    torch.float32, scale=100.0)
    first = fused_xent_fwd(h, w, bias, labels, 512)
    again = fused_xent_fwd(h, w, bias, labels, 512)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_design_mirrors_the_source_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from analytics_zoo_tpu_torch.ops import _build
    fn = _build.load(tfx.SOURCE).fused_xent_fwd_design
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    dt = getattr(torch, dtype)
    assert tfx.FWD_DESIGNS[fn(int(dt == torch.bfloat16))] == \
        tfx.fwd_design(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v,w_dtype", [(2048, 768, 30522, "float32"),
                                           (2048, 768, 30522, "bfloat16"),
                                           (129, 13, 30, "float32")])
def test_the_forwards_w_pack_gives_the_backward_bit_for_bit_on_card(
        n, d, v, w_dtype):
    """The bf16 backward reading the forward's copy of W (as the autograd
    Function hands it on) gives the same bits as the backward that packs W
    itself, and so does ``fused_softmax_xent``'s gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(15)
    h, w, bias, labels = _card_case(gen, n, d, v, torch.bfloat16,
                                    getattr(torch, w_dtype))
    g = torch.tensor(1.0, device="cuda")
    loss, lse, w_packed = tfx._fwd(h, w, bias, labels, n)
    assert w_packed is not None and w_packed.dtype == torch.bfloat16
    own = fused_xent_bwd(h, w, bias, labels, lse, g, n)
    shared = fused_xent_bwd(h, w, bias, labels, lse, g, n, w_packed)
    assert all(torch.equal(a, b) for a, b in zip(own, shared))
    hh, ww, bb = (t.detach().requires_grad_() for t in (h, w, bias))
    grads = torch.autograd.grad(
        fused_softmax_xent(hh, ww, labels, n, bias=bb), (hh, ww, bb))
    assert all(torch.equal(a, b) for a, b in zip(own, grads))


@pytest.mark.cuda
def test_the_shared_w_pack_runs_from_a_fresh_thread_on_card():
    """A thread whose first CUDA call is the backward's (every allocation
    from PyTorch's cache, no pack to launch first, as autograd's backward
    thread can be) encodes its tensor maps all the same and gives the main
    thread's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(16)
    h, w, bias, labels = _card_case(gen, 1024, 768, 30522, torch.bfloat16,
                                    torch.float32)
    g = torch.tensor(1.0, device="cuda")
    _, lse, w_packed = tfx._fwd(h, w, bias, labels, 1024)
    want = fused_xent_bwd(h, w, bias, labels, lse, g, 1024)

    def in_thread(packed):
        out = []
        t = threading.Thread(target=lambda: out.append(fused_xent_bwd(
            h, w, bias, labels, lse, g, 1024, packed)))
        t.start()
        t.join()
        assert out, "the backward raised in its thread"
        return out[0]

    in_thread(None)  # its workspace stays in PyTorch's cache
    got = in_thread(w_packed)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(want, got))
