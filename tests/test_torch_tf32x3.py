"""The arithmetic of the f32 tensor-core designs, emulated on the CPU:
3xTF32 against the JAX package's f32 functions.

On the card the f32 flash-attention forward and backward (heads up to 64)
and the f32 ``fused_xent`` backward's dh and dW run their products on
``wgmma`` in
TF32, three products per f32 product: each operand x is split into big =
tf32(x) (``cvt.rna.tf32.f32``: round to nearest, ties away, to 10 mantissa
bits) and small = tf32(x - big), and a . b is big.small + small.big +
big.big, summed in f32.  Every product of two TF32 values is exact in f32,
so an f32 matmul of the parts on the CPU is that arithmetic up to the
order of the f32 sums.  The attention scores are recomputed that way while
the logsumexp comes from the exact f32 forward, as on the card.  The
cross-entropy's logits are not: at logits of 1e2, dl = exp(S - lse) moves
by more than the tolerance when S is summed in any order but the
forward's (3xTF32's or f32's), so the design keeps them on f32 FMAs in
the forward's order, and only dh and dW take 3xTF32; the tests below show
both halves of that.

Tolerances are the ones the card is held to (``chip_smoke.py``):
``TOL_XENT_F32`` 1e-5 of each gradient's max |ref|, ``TOL_BWD_F32`` 1e-4
of max(1, max |ref|), the forward's ``TOL_F32`` 2e-5 on out and
``TOL_LSE`` 5e-5 on lse (absolute).  One-pass TF32 misses the first by
far, which is why the designs take three passes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import fused_softmax_xent as jax_fused

jfx = importlib.import_module("analytics_zoo_tpu.ops.fused_xent")
jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

TOL_XENT_F32 = 1e-5
TOL_BWD_F32 = 1e-4
TOL_F32 = 2e-5
TOL_LSE = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the 13 low mantissa bits rounded off, ties
    away from zero (adding half of the last kept bit to the magnitude,
    which the sign-magnitude layout does for either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: the two small terms, then the big one, in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (ab @ bs + as_ @ bb) + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one pass of TF32 (what the designs must not do)."""
    return tf32(a) @ tf32(b)


def test_tf32_rounds_to_ten_mantissa_bits_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2 ** -20,
                      1.0 + 3 * ulp / 2, 3.0e-39, 0.0])
    got = tf32(x)
    assert got.tolist()[:4] == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp]
    assert got[5] == 0.0
    big, small = split(torch.tensor([1.0 + 2 ** -15]))
    assert big.item() == 1.0 and small.item() == 2 ** -15
    assert torch.equal(tf32(one), one)


def test_3xtf32_products_keep_f32_accuracy():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 768)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(768, 64)).astype(np.float32))
    exact = (a.double() @ b.double())
    scale = exact.abs().max().item()
    err3 = (mm3(a, b).double() - exact).abs().max().item() / scale
    err1 = (mm1(a, b).double() - exact).abs().max().item() / scale
    errf = ((a @ b).double() - exact).abs().max().item() / scale
    assert err3 < 4 * errf + 1e-7 and err1 > 50 * err3


# -- the fused cross-entropy backward ----------------------------------------

def _xent_case(seed, n, d, v, scale=1.0):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (n,))
    labels[0], labels[-1] = 0, v - 1
    return h, w, bias, labels


def _jax_xent(h, w, bias, labels, chunk, g):
    """JAX's f32 forward lse and its custom_vjp's (dh, dW, db)."""
    _, lse = jfx._fused_fwd_impl(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(bias), jnp.asarray(labels),
                                 chunk)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, jnp.asarray(labels),
                                               chunk, bias=c),
                     jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias))
    grads = vjp(jnp.float32(g))
    return (np.asarray(lse).reshape(-1),
            [np.asarray(x, np.float32) for x in grads])


def _emulated_xent_bwd(h, w, bias, labels, lse, g, mm):
    """The backward with every product in ``mm``: S = h W + b, dl from the
    given lse (None: S's own), dh = dl W^T, dW = h^T dl, db the sums of
    dl."""
    h, w, bias = (torch.from_numpy(x) for x in (h, w, bias))
    n = h.shape[0]
    scale = torch.tensor(g / n, dtype=torch.float32)
    s = mm(h, w) + bias
    if lse is None:  # the emulated forward's own
        lse = torch.logsumexp(s, dim=-1)
    else:
        lse = torch.from_numpy(lse)
    dl = torch.exp(s - lse[:, None]) * scale
    dl[torch.arange(n), torch.from_numpy(labels)] -= scale
    return [x.numpy() for x in (mm(dl, w.T), mm(h.T, dl), dl.sum(dim=0))]


def _worst_rel_to_max(got, want):
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(got, want))


XENT_SHAPES = [(64, 40, 777, 32), (43, 13, 30, 43), (128, 64, 1000, 64),
               (256, 768, 4099, 128)]  # the last: one full-width block


@pytest.mark.parametrize("lse_from", ["exact", "emulated"])
@pytest.mark.parametrize("n,d,v,chunk", XENT_SHAPES)
def test_3xtf32_xent_backward_meets_the_f32_tolerance(n, d, v, chunk,
                                                      lse_from):
    h, w, bias, labels = _xent_case(n + d + v, n, d, v)
    lse, want = _jax_xent(h, w, bias, labels, chunk, 1.3)
    got = _emulated_xent_bwd(h, w, bias, labels,
                             lse if lse_from == "exact" else None, 1.3, mm3)
    assert _worst_rel_to_max(got, want) <= TOL_XENT_F32


def _design_xent_bwd(h, w, bias, labels, g):
    """The f32 design's backward: dl from the reference's own logits and
    lse (JAX's f32 sums, as the card's FMA loop repeats cuBLAS's), dh and
    dW in 3xTF32, db the sums of dl."""
    logits = np.asarray(jnp.dot(jnp.asarray(h), jnp.asarray(w)) + bias)
    lse = np.asarray(jax.scipy.special.logsumexp(logits, axis=-1))
    n = h.shape[0]
    scale = np.float32(g / n)
    dl = torch.from_numpy(np.exp(logits - lse[:, None]) * scale)
    dl[torch.arange(n), torch.from_numpy(labels)] -= float(scale)
    w_t = torch.from_numpy(w)
    return [x.numpy() for x in (mm3(dl, w_t.T), mm3(torch.from_numpy(h).T,
                                                      dl), dl.sum(dim=0))]


@pytest.mark.parametrize("n,d,v", [(128, 96, 3001), (512, 768, 3001)])
def test_at_large_logits_only_exact_logits_hold_the_xent_tolerance(n, d, v):
    """Logits scaled 1e2 (near one-hot softmax rows): 3xTF32 logits miss
    the tolerance with the forward's lse and with their own; the design's
    arithmetic (exact logits, dh and dW in 3xTF32) meets it."""
    h, w, bias, labels = _xent_case(5, n, d, v, scale=100.0)
    lse, want = _jax_xent(h, w, bias, labels, n, 1.0)
    for own in (lse, None):
        got = _emulated_xent_bwd(h, w, bias, labels, own, 1.0, mm3)
        assert _worst_rel_to_max(got, want) > TOL_XENT_F32
    got = _design_xent_bwd(h, w, bias, labels, 1.0)
    assert _worst_rel_to_max(got, want) <= TOL_XENT_F32


def test_one_pass_tf32_misses_the_xent_tolerance():
    n, d, v, chunk = XENT_SHAPES[-1]
    h, w, bias, labels = _xent_case(n + d + v, n, d, v)
    lse, want = _jax_xent(h, w, bias, labels, chunk, 1.3)
    got = _emulated_xent_bwd(h, w, bias, labels, lse, 1.3, mm1)
    assert _worst_rel_to_max(got, want) > 10 * TOL_XENT_F32


# -- the flash-attention backward --------------------------------------------

def _emulated_flash_bwd(q, k, v, out, lse, g, causal, mm):
    """The design's backward: S = Q K^T and dP = dO V^T in ``mm``, P and
    dS in f32 from the forward's lse and delta = rowsum(out dO), then dV =
    P^T dO, dK = dS^T Q, dQ = dS K in ``mm``."""
    q, k, v, out, lse, g = (torch.from_numpy(np.asarray(x))
                            for x in (q, k, v, out, lse, g))
    tq, tk, d = q.shape[1], k.shape[1], q.shape[2]
    scale = 1.0 / np.sqrt(d)
    delta = (out * g).sum(dim=-1, keepdim=True)
    s = torch.stack([mm(qi, ki.T) for qi, ki in zip(q, k)]) * scale
    keep = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        keep = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.stack([mm(gi, vi.T) for gi, vi in zip(g, v)])
    ds = p * (dp - delta) * scale
    dq = torch.stack([mm(a, b) for a, b in zip(ds, k)])
    dk = torch.stack([mm(a.T, b) for a, b in zip(ds, q)])
    dv = torch.stack([mm(a.T, b) for a, b in zip(p, g)])
    return [x.numpy() for x in (dq, dk, dv)]


FLASH_SHAPES = [(3, 77, 130, 64, False), (3, 130, 77, 64, True),
                (2, 100, 100, 40, True), (2, 64, 64, 8, False),
                (2, 512, 512, 64, False)]  # the last: one full-width block


@pytest.mark.parametrize("bh,tq,tk,d,causal", FLASH_SHAPES)
def test_3xtf32_flash_backward_meets_the_f32_tolerance(bh, tq, tk, d,
                                                       causal):
    rng = np.random.default_rng(bh * tq + d)
    q, g = (rng.normal(size=(bh, tq, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(bh, tk, d)).astype(np.float32)
            for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    out, lse = jfa._blocked_fwd_jax(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale, causal, 128)
    want = jfa._blocked_bwd_jax(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), out, lse, jnp.asarray(g),
                                scale, causal, 128)
    got = _emulated_flash_bwd(q, k, v, out, lse, g, causal, mm3)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= TOL_BWD_F32 * max(1.0,
                                                        np.abs(b).max())


# -- the flash-attention forward ---------------------------------------------

def _emulated_flash_fwd(q, k, v, causal, mm, block_k=32):
    """The design's forward: per tile of ``block_k`` keys, S = Q K^T in
    ``mm`` times the scale, masked to -1e30 (keys >= Tk; under ``causal``
    q < k), the online softmax in f32 (running max m and sum l, the
    accumulator rescaled by exp(m_old - m_new)), then acc += P V in
    ``mm``; out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    q, k, v = (torch.from_numpy(np.asarray(x)) for x in (q, k, v))
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(d))
    qpos = torch.arange(tq)[:, None]
    m = torch.full((bh, tq, 1), -1e30)
    l = torch.zeros((bh, tq, 1))
    acc = torch.zeros((bh, tq, d))
    for k0 in range(0, tk, block_k):
        kj, vj = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = torch.stack([mm(qi, ki.T) for qi, ki in zip(q, kj)]) * scale
        if causal:
            kpos = k0 + torch.arange(kj.shape[1])[None, :]
            s = torch.where(qpos >= kpos, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.stack([mm(a, b) for a, b in zip(p, vj)])
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).numpy(), (m + torch.log(l))[..., 0].numpy()


def _flash_fwd_case(bh, tq, tk, d, causal, q_scale=1.0):
    """Inputs made from a seed with numpy, and the live JAX package's f32
    forward (``_blocked_fwd_jax``) on them."""
    rng = np.random.default_rng(bh * tq + tk + d)
    q = (rng.normal(size=(bh, tq, d)) * q_scale).astype(np.float32)
    k, v = (rng.normal(size=(bh, tk, d)).astype(np.float32)
            for _ in range(2))
    out, lse = jfa._blocked_fwd_jax(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 1.0 / np.sqrt(d),
                                    causal, 128)
    return q, k, v, np.asarray(out), np.asarray(lse)


FLASH_FWD_SHAPES = [(3, 77, 130, 64, False), (3, 130, 77, 64, True),
                    (2, 100, 100, 40, True), (2, 64, 64, 8, False),
                    (2, 33, 33, 1, True),
                    (2, 512, 512, 64, False)]  # the last: one full-width block


@pytest.mark.parametrize("bh,tq,tk,d,causal", FLASH_FWD_SHAPES)
def test_3xtf32_flash_forward_meets_the_f32_tolerance(bh, tq, tk, d,
                                                      causal):
    """S and P V in 3xTF32 with the online softmax over 32-key tiles hold
    the JAX f32 forward's out to 2e-5 and lse to 5e-5: ragged Tk, Tq !=
    Tk both ways, causal, heads of 1-64, one full-width block."""
    q, k, v, want_out, want_lse = _flash_fwd_case(bh, tq, tk, d, causal)
    out, lse = _emulated_flash_fwd(q, k, v, causal, mm3)
    assert np.abs(out - want_out).max() <= TOL_F32
    assert np.abs(lse - want_lse).max() <= TOL_LSE


def test_3xtf32_flash_forward_at_logits_of_1e2():
    """q scaled so that the logits reach about 1e2 (softmax rows near one
    key): 3xTF32 misses the tolerance there (out 3.9e-5, lse 6.1e-5 on
    this input: the dropped small x small term of each product is 2^-22
    of |q_c k_c|, which the scale carries into S), while plain f32 in
    another summation order still holds it.  BERT's logits at its
    shapes stay near 1e0-1e1, where 3xTF32 holds the tolerance with room
    (the cases above)."""
    q, k, v, want_out, want_lse = _flash_fwd_case(2, 256, 256, 64, False,
                                                  q_scale=30.0)
    top = np.abs(np.einsum("bqd,bkd->bqk", q, k)).max() / 8.0
    assert 60.0 < top < 300.0
    out, lse = _emulated_flash_fwd(q, k, v, False, mm3)
    assert np.abs(out - want_out).max() > TOL_F32
    assert np.abs(lse - want_lse).max() > TOL_LSE
    out, lse = _emulated_flash_fwd(q, k, v, False, torch.matmul)
    assert np.abs(out - want_out).max() <= TOL_F32
    assert np.abs(lse - want_lse).max() <= TOL_LSE


def test_one_pass_tf32_misses_the_flash_forward_tolerance():
    q, k, v, want_out, _ = _flash_fwd_case(2, 512, 512, 64, False)
    out, _ = _emulated_flash_fwd(q, k, v, False, mm1)
    assert np.abs(out - want_out).max() > 10 * TOL_F32
