"""The port's flash-attention gradients against the JAX package's, on the
CPU.

The JAX side differentiates ``analytics_zoo_tpu.ops.flash_attention``
through its ``custom_vjp`` (``_blocked_bwd_jax``; the forward in Pallas
interpret mode where a case says so, else its blocked fallback) and through
autodiff of ``mha_reference``.  The port's side runs ``flash_attention``
through ``_FlashAttention``, whose backward is the plain version
``flash_attention_bwd_reference`` for a CPU tensor.  Tolerance 5e-5 in f32,
as ``tests/test_ops.py::test_flash_grads_match_reference``.

The ``cuda`` cases hold the backward kernel against its plain version on
the card: f32 dq/dk/dv within 1e-4 of max(1, max |ref|) (the same f32 math
in another summation order over at most 130 keys), bf16 within 1e-2 of
max |ref| (both sides round their f32 result to bf16 once, so they differ
by about one bf16 ulp, at most 2^-7 of the value; the tensor-core path also
rounds P and dS to bf16 before their products, 2^-9 per term, which
averages out over the sums).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                         flash_attention_bwd_reference,
                                         flash_attention_fwd,
                                         flash_attention_fwd_reference,
                                         mha_reference)

# the package's __init__ re-exports the function under the module's name,
# so reach the modules themselves through importlib
jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")
tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")

TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, tq, tk, h, d):
    """q, k, v and the output's gradient g, [B, T, H, D] f32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tq, h, d)).astype(np.float32))


def _jax_grads(fn, q, k, v, g, interpret=False, **kw):
    jfa.INTERPRET = interpret
    try:
        _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw), jnp.asarray(q),
                         jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]
    finally:
        jfa.INTERPRET = False


def _port_grads(q, k, v, g, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in (qt, kt, vt)]


def _close(got, want, tol=TOL):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("d", [5, 24, 64])
@pytest.mark.parametrize("tq,tk", [(40, 40), (33, 33), (24, 56), (56, 24)])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_custom_vjp(causal, tq, tk, d):
    """Causal and not, Tq != Tk both ways, a T that is no multiple of 8 or
    of any kernel tile, and head dims 5, 24, 64."""
    q, k, v, g = _inputs(tq * tk + d, b=2, tq=tq, tk=tk, h=2, d=d)
    want = _jax_grads(jfa.flash_attention, q, k, v, g, causal=causal)
    _close(_port_grads(q, k, v, g, causal), want)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_with_the_pallas_forward(causal):
    """The JAX forward through the Pallas kernel (interpret mode) feeds its
    own out and lse to the backward; the port's gradients match those too,
    with blocks smaller than T and a ragged edge."""
    q, k, v, g = _inputs(3, b=1, tq=24, tk=24, h=2, d=8)
    want = _jax_grads(jfa.flash_attention, q, k, v, g, interpret=True,
                      causal=causal, block_q=16, block_k=16)
    _close(_port_grads(q, k, v, g, causal), want)


@pytest.mark.parametrize("d", [5, 24, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_autodiff_of_mha_reference(causal, d):
    q, k, v, g = _inputs(d, b=2, tq=21, tk=21, h=3, d=d)
    want = _jax_grads(jfa.mha_reference, q, k, v, g, causal=causal)
    _close(_port_grads(q, k, v, g, causal), want)


@pytest.mark.parametrize("tk", [32, 33])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_blocked_jax(causal, tk):
    """The plain backward repeats ``_blocked_bwd_jax``'s math block for
    block, including a ragged last key block (tk 33 at block 16)."""
    q, k, v, g = _inputs(tk, b=1, tq=30, tk=tk, h=2, d=8)
    q3, k3, v3 = (x.transpose(0, 2, 1, 3).reshape(2, -1, 8)
                  for x in (q, k, v))
    g3 = g.transpose(0, 2, 1, 3).reshape(2, -1, 8)
    scale = 1.0 / np.sqrt(8)
    out, lse = jfa._blocked_fwd_jax(jnp.asarray(q3), jnp.asarray(k3),
                                    jnp.asarray(v3), scale, causal, 16)
    want = jfa._blocked_bwd_jax(jnp.asarray(q3), jnp.asarray(k3),
                                jnp.asarray(v3), out, lse, jnp.asarray(g3),
                                scale, causal, 16)
    got = flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q3, k3, v3)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(g3), causal, block_k=16)
    _close([x.numpy() for x in got], [np.asarray(x) for x in want])


def test_bf16_bwd_reference_keeps_dtypes():
    q, k, v, g = (torch.from_numpy(x[0].transpose(1, 0, 2).copy()).bfloat16()
                  for x in _inputs(4, b=1, tq=10, tk=12, h=2, d=16))
    out, lse = flash_attention_fwd(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == (2, 10, 16) and dk.shape == dv.shape == (2, 12, 16)
    ref = flash_attention_bwd(*(x.float() for x in (q, k, v, out)), lse,
                              g.float())
    for a, b in zip((dq, dk, dv), ref):
        assert (a.float() - b).abs().max().item() <= \
            2e-2 * b.abs().max().item()


def test_flash_attention_is_differentiable_only_where_asked():
    """With a gradient wanted, the output's grad_fn is the flash backward;
    without one (inference), no graph and no saved residuals."""
    def names(fn):
        todo, seen = [fn], []
        while todo:
            node = todo.pop()
            if node is not None:
                seen.append(type(node).__name__)
                todo.extend(n for n, _ in node.next_functions)
        return seen

    x = torch.randn(1, 6, 2, 8, requires_grad=True)
    out = flash_attention(x, x, x)
    assert "_FlashAttentionBackward" in names(out.grad_fn)
    with torch.no_grad():
        assert flash_attention(x, x, x).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(x, x, x).grad_fn is None


def test_backward_hands_the_wrapper_a_contiguous_dout(monkeypatch):
    """The permute in flash_attention makes the incoming gradient a strided
    view; the backward makes it contiguous and calls the wrapper once."""
    seen = []

    def spy(q3, k3, v3, out, lse, dout, causal=False):
        seen.append(dout.is_contiguous())
        return flash_attention_bwd_reference(q3, k3, v3, out, lse, dout,
                                             causal)

    monkeypatch.setattr(tfa, "flash_attention_bwd", spy)
    x = torch.randn(2, 5, 3, 8, requires_grad=True)
    flash_attention(x, x, x).sum().backward()
    assert seen == [True]


def test_cpu_backward_never_counts_as_a_launch():
    before = dict(tfa.KERNEL_LAUNCHES), flash_attention_bwd.launches
    x = torch.randn(1, 4, 2, 16, requires_grad=True)
    flash_attention(x, x, x, causal=True).sum().backward()
    assert (dict(tfa.KERNEL_LAUNCHES), flash_attention_bwd.launches) == before


def test_bwd_wrapper_raises_on_other_devices_and_bad_shapes():
    meta = torch.empty(2, 4, 16, device="meta")
    lse_m = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(meta, meta, meta, meta, lse_m, meta)
    q = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_bwd(q, q, q, q, torch.zeros(2, 4),
                            torch.zeros(2, 5, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa._check_launch(q.half(), q.half(), q.half())


@pytest.mark.parametrize("d,dtype,width", [
    (300, torch.bfloat16, 300), (1024, torch.float32, 1024),
    (256, torch.bfloat16, 256)])
def test_wide_heads_go_to_the_f32_source_unpadded(monkeypatch, d, dtype,
                                                  width):
    """Head dims above 256 take the f32 source's wide kernel in both dtypes,
    with no padding (its loads are element-wise); 256 and below in bf16
    stay on the tensor-core kernel."""
    seen = []

    def fake_kernel(q3, k3, v3, causal, scale):
        seen.append((tfa.fwd_kernel(q3.dtype, q3.shape[-1])[0],
                     q3.shape[-1]))
        return flash_attention_fwd_reference(q3, k3, v3, causal, scale=scale)

    monkeypatch.setattr(tfa, "_run_kernel", fake_kernel)
    q = torch.randn(1, 3, d).to(dtype)
    tfa._launch(q, q, q, False)
    want = tfa.FWD_F32 if d > 256 else tfa.FWD_BF16
    assert seen == [(want, width)]


@pytest.mark.parametrize("dtype,d,width", [
    (torch.bfloat16, 5, 8), (torch.bfloat16, 21, 24),
    (torch.bfloat16, 64, 64), (torch.bfloat16, 72, 72),
    (torch.float32, 21, 21)])
def test_bwd_launch_hands_the_kernel_its_width_and_the_true_scale(
        monkeypatch, dtype, d, width):
    """The backward's launch path: bf16 heads up to 64 (its tensor-core
    path) are padded to a multiple of 8 with zero columns, q, k, v, out and
    dout alike, the scale stays 1/sqrt(d), and dq, dk, dv are cut back to
    d (the kernel call replaced by the plain version, on the CPU)."""
    seen = []

    def fake_kernel(q3, k3, v3, out, lse, dout, causal, scale):
        seen.append(({x.shape[-1] for x in (q3, k3, v3, out, dout)}, scale))
        return flash_attention_bwd_reference(q3, k3, v3, out, lse, dout,
                                             causal, scale=scale)

    monkeypatch.setattr(tfa, "_run_bwd_kernel", fake_kernel)
    q, k, v, g = (torch.from_numpy(x[0].transpose(1, 0, 2).copy()).to(dtype)
                  for x in _inputs(d, b=1, tq=9, tk=11, h=2, d=d))
    out, lse = flash_attention_fwd_reference(q, k, v, True)
    got = tfa._launch_bwd(q, k, v, out, lse, g, True)
    assert seen == [({width}, pytest.approx(1 / np.sqrt(d)))]
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, True)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype and a.is_contiguous()
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                   rtol=1e-2)


def _card_case(seed, bh, tq, tk, d, dtype, causal):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(t):
        return torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)

    q, k, v, g = r(tq), r(tk), r(tk), r(tq)
    out, lse = flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, g


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [3, 40])
@pytest.mark.parametrize("tq,tk", [(77, 77), (130, 61), (61, 130)])
@pytest.mark.parametrize("d", [5, 24, 64, 128, 256, 320])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_reference_on_card(dtype, causal, d, tq, tk, bh):
    """The backward kernel against its plain version on the same inputs
    (runs on the card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, out, lse, g = _card_case(d + tq, bh, tq, tk, d, dtype, causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        ref = b.float().abs().max().item()
        tol = 1e-4 * max(1.0, ref) if dtype == torch.float32 else 1e-2 * ref
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d", [24, 64, 320])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_on_card_matches_mha_reference(causal, d):
    """End to end on the card in f32: flash_attention's gradients (forward
    and backward kernels) against autograd through mha_reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = (torch.from_numpy(x).cuda()
                  for x in _inputs(d, b=2, tq=70, tk=70, h=3, d=d))
    grads = []
    for fn in (flash_attention, mha_reference):
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        out = fn(qs, ks, vs, causal=causal)
        assert out.grad_fn is not None
        out.backward(g)
        grads.append([x.grad for x in (qs, ks, vs)])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())
