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


@pytest.mark.parametrize("d", [1536, 2048])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dims_above_1024_match_jax(causal, d):
    """Head dims past the wide kernels' old 1024 limit: the port's forward
    and gradients against the JAX custom_vjp (on the card these take the
    wide kernels, which the launch path hands them unpadded)."""
    q, k, v, g = _inputs(d, b=1, tq=9, tk=11, h=1, d=d)
    want_out = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got_out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=TOL, rtol=TOL)
    want = _jax_grads(jfa.flash_attention, q, k, v, g, causal=causal)
    _close(_port_grads(q, k, v, g, causal), want)


def _forward_kernel_seen(monkeypatch, d, dtype):
    """(source, width) of the forward kernel that ``_launch`` hands a
    ``[1, 3, d]`` input (the kernel call replaced by the plain version)."""
    seen = []

    def fake_kernel(q3, k3, v3, causal, scale):
        seen.append((tfa.fwd_kernel(q3.dtype, q3.shape[-1])[0],
                     q3.shape[-1]))
        return flash_attention_fwd_reference(q3, k3, v3, causal, scale=scale)

    monkeypatch.setattr(tfa, "_run_kernel", fake_kernel)
    q = torch.randn(1, 3, d).to(dtype)
    out, _ = tfa._launch(q, q, q, False)
    assert out.shape == (1, 3, d)
    return seen


@pytest.mark.parametrize("d,dtype,width", [
    (1024, torch.float32, 1024), (256, torch.bfloat16, 256),
    (1536, torch.float32, 1536)])
def test_wide_heads_go_to_the_f32_source_unpadded(monkeypatch, d, dtype,
                                                  width):
    """f32 head dims above 256 take the f32 source's wide kernel with no
    padding (its loads are element-wise); bf16 256 stays on the bf16
    source's tensor-core kernels."""
    want = tfa.FWD_F32 if dtype == torch.float32 else tfa.FWD_BF16
    assert _forward_kernel_seen(monkeypatch, d, dtype) == [(want, width)]


@pytest.mark.parametrize("d,width", [(257, 264), (300, 304), (520, 520),
                                     (2048, 2048), (2049, 2056)])
def test_wide_bf16_heads_go_to_the_bf16_source_padded(monkeypatch, d,
                                                      width):
    """bf16 head dims above 256 take the bf16 source's ``wgmma_wide``
    design, padded to a multiple of 8 (TMA's 16-byte rows), the output cut
    back to d."""
    assert _forward_kernel_seen(monkeypatch, d, torch.bfloat16) == \
        [(tfa.FWD_BF16, width)]
    assert tfa.fwd_design(torch.bfloat16, d) == "wgmma_wide"


@pytest.mark.parametrize("dtype,d,width", [
    (torch.bfloat16, 5, 8), (torch.bfloat16, 21, 24),
    (torch.bfloat16, 64, 64), (torch.bfloat16, 72, 72),
    (torch.float32, 21, 21), (torch.bfloat16, 130, 136),
    (torch.bfloat16, 250, 256), (torch.bfloat16, 260, 260)])
def test_bwd_launch_hands_the_kernel_its_width_and_the_true_scale(
        monkeypatch, dtype, d, width):
    """The backward's launch path: bf16 heads up to 256 (its tensor-core
    paths) are padded to a multiple of 8 with zero columns, q, k, v, out
    and dout alike, the scale stays 1/sqrt(d), and dq, dk, dv are cut back
    to d (the kernel call replaced by the plain version, on the CPU); wider
    heads go to the wide kernels as they are."""
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


@pytest.mark.parametrize("d", [36, 40, 48, 56])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_custom_vjp_at_the_wgmma_widths(causal, d):
    """The head dims the bf16 backward's wgmma design takes (33-64), with
    Tq != Tk and ragged T, against the JAX custom_vjp (f32, on the CPU)."""
    q, k, v, g = _inputs(d + 7, b=1, tq=19, tk=27, h=2, d=d)
    want = _jax_grads(jfa.flash_attention, q, k, v, g, causal=causal)
    _close(_port_grads(q, k, v, g, causal), want)


def _bf16_rounded(*xs):
    """Each array rounded to bf16 and back: inputs a bf16 caller hands both
    packages, in f32."""
    return [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]


@pytest.mark.parametrize("d", [72, 128, 136, 192, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_custom_vjp_at_the_pair_widths(causal, d):
    """The head dims the bf16 backward's wgmma_pair design takes (65-256:
    one, two and three swizzle atoms of 64, 136 and 192 past an atom's
    edge), with Tq != Tk and ragged T, on bf16-rounded inputs, against the
    JAX custom_vjp (f32, on the CPU; 5e-5 as the other cases)."""
    q, k, v, g = _bf16_rounded(*_inputs(d + 11, b=1, tq=21, tk=29, h=2,
                                        d=d))
    want = _jax_grads(jfa.flash_attention, q, k, v, g, causal=causal)
    _close(_port_grads(q, k, v, g, causal), want)


@pytest.mark.parametrize("dtype,d,design", [
    (torch.bfloat16, 1, "mma.sync"), (torch.bfloat16, 24, "mma.sync"),
    (torch.bfloat16, 32, "mma.sync"), (torch.bfloat16, 33, "wgmma"),
    (torch.bfloat16, 40, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 65, "wgmma_pair"), (torch.bfloat16, 256, "wgmma_pair"),
    (torch.bfloat16, 257, "wide"), (torch.float32, 8, "wgmma_tf32"),
    (torch.float32, 64, "wgmma_tf32"), (torch.float32, 65, "scalar"),
    (torch.float32, 320, "wide"), (torch.bfloat16, 130, "wgmma_pair"),
    (torch.bfloat16, 249, "wgmma_pair"), (torch.float32, 256, "scalar")])
def test_bwd_design_by_dtype_and_head_dim(dtype, d, design):
    """Which design of the backward takes which (dtype, head dim): bf16
    heads padded to 40-64 go to wgmma, 65-256 to wgmma_pair, up to 32 to
    mma.sync, f32 heads up to 64 to wgmma in 3xTF32, f32 65-256 to the
    scalar kernels, above 256 to the wide ones."""
    assert tfa.bwd_design(dtype, d) == design


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _hold_bwd_to_reference(q, k, v, out, lse, g, causal):
    """The bf16 backward kernel against its plain version, each gradient
    within 1e-2 of max |ref| (the tolerance of
    test_bwd_kernel_matches_reference_on_card); returns the kernel's."""
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.isfinite(a).all()
        ref = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-2 * ref
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (384, 512, 512, 64, False), (384, 512, 512, 64, True),
    (3, 77, 130, 40, False), (3, 77, 130, 40, True),
    (3, 130, 77, 48, False), (3, 130, 77, 48, True),
    (2, 200, 77, 36, True), (5, 130, 61, 64, True), (5, 61, 130, 64, True),
    (2, 300, 3, 56, True), (2, 1, 300, 64, False), (7, 333, 333, 64, True)])
def test_wgmma_bwd_matches_reference_on_card(bh, tq, tk, d, causal):
    """The wgmma design (bf16 heads 33-64) against the plain backward: the
    training shape, head dims the TMA box zero-fills to 64, and Tq != Tk
    ragged under `causal`; each call launches that design once.  (Tk 1
    under `causal`, or Tq 1 with it, is left out: one visible key makes P 1
    and dS = P (dP - delta) 0 in exact arithmetic, so dq and dk are f32
    rounding noise on both sides and no relative tolerance holds them.)"""
    _needs_card()
    q, k, v, out, lse, g = _card_case(bh + d, bh, tq, tk, d, torch.bfloat16,
                                      causal)
    before = dict(tfa.BWD_LAUNCHES)
    _hold_bwd_to_reference(q, k, v, out, lse, g, causal)
    assert tfa.BWD_LAUNCHES["wgmma"] == before["wgmma"] + 1
    assert {n: c for n, c in tfa.BWD_LAUNCHES.items() if n != "wgmma"} == \
        {n: c for n, c in before.items() if n != "wgmma"}


@pytest.mark.cuda
def test_wgmma_bwd_takes_a_misaligned_view_on_card():
    """Views 2 bytes past a 16-byte boundary (the wrapper copies them for
    TMA) give the plain version's gradients."""
    _needs_card()
    bh, t, d = 4, 100, 64
    q, k, v, out, lse, g = _card_case(5, bh, t, t, d, torch.bfloat16, True)

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    q, k, v, out, g = (shifted(x) for x in (q, k, v, out, g))
    _hold_bwd_to_reference(q, k, v, out, lse, g, True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_bwd_repeats_bit_for_bit_on_card(causal):
    """No atomics: two calls on one input give identical dq, dk and dv."""
    _needs_card()
    case = _card_case(11, 48, 512, 512, 64, torch.bfloat16, causal)
    first = flash_attention_bwd(*case[:5], case[5], causal)
    second = flash_attention_bwd(*case[:5], case[5], causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


PAIR_WIDTHS = (72, 128, 136, 192, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (384, 512, 512, 128, False), (384, 512, 512, 128, True),
    (384, 512, 512, 256, False), (96, 512, 512, 256, True),
    *[(3, tq, tk, d, c) for d in PAIR_WIDTHS
      for tq, tk in ((77, 130), (130, 77)) for c in (False, True)],
    (2, 1, 300, 128, False), (7, 333, 333, 192, True),
    (70000, 8, 8, 72, False)])
def test_wgmma_pair_bwd_matches_reference_on_card(bh, tq, tk, d, causal):
    """The wgmma_pair design (bf16 heads 65-256, two warpgroups a block)
    against the plain backward: the training shape at D 128 and 256 (12
    and more waves of blocks), every atom count (72 and 136 padded by TMA's
    zero columns), Tq != Tk ragged under `causal`, one query row, and BH
    past 65535; each call launches that design once and no other."""
    _needs_card()
    q, k, v, out, lse, g = _card_case(bh + d + tq, bh, tq, tk, d,
                                      torch.bfloat16, causal)
    before = dict(tfa.BWD_LAUNCHES)
    _hold_bwd_to_reference(q, k, v, out, lse, g, causal)
    want = dict(before)
    want["wgmma_pair"] += 1
    assert tfa.BWD_LAUNCHES == want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
def test_wgmma_pair_bwd_takes_one_key_on_card(d):
    """Tk 1: P is 1 and dS = P (dP - delta) is 0 in exact arithmetic, so dq
    and dk are f32 rounding noise on both sides: dv is held as elsewhere,
    dq and dk to 1e-3 absolute (their noise is about 1e-5)."""
    _needs_card()
    q, k, v, out, lse, g = _card_case(d, 3, 100, 1, d, torch.bfloat16,
                                      False)
    got = flash_attention_bwd(q, k, v, out, lse, g, False)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, False)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        tol = 1e-2 * b.float().abs().max().item() if name == "dv" else 1e-3
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_wgmma_pair_bwd_takes_a_misaligned_view_on_card():
    """Views 2 bytes past a 16-byte boundary (the wrapper copies them for
    TMA) give the plain version's gradients at D 128."""
    _needs_card()
    q, k, v, out, lse, g = _card_case(8, 4, 100, 100, 128, torch.bfloat16,
                                      True)

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    q, k, v, out, g = (shifted(x) for x in (q, k, v, out, g))
    _hold_bwd_to_reference(q, k, v, out, lse, g, True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_pair_bwd_repeats_bit_for_bit_on_card(causal, d):
    """No atomics: two calls on one input give identical dq, dk and dv."""
    _needs_card()
    case = _card_case(15 + d, 48, 512, 512, d, torch.bfloat16, causal)
    first = flash_attention_bwd(*case[:5], case[5], causal)
    second = flash_attention_bwd(*case[:5], case[5], causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b_mn_major", [0, 1])
def test_wgmma_operand_form_matches_a_plain_matmul_on_card(b_mn_major):
    """Each wgmma operand form of the backward alone, 64 x 64 x 64 through
    TMA's 128-byte swizzle: A and B K-major in shared memory (S = A B^T,
    as S and dP), and A from registers with B MN-major (C = A B, as dV, dK
    and dQ); f32 sums of exact bf16 products, within 1e-5 of max |ref|."""
    _needs_card()
    import ctypes
    from analytics_zoo_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda").manual_seed(b_mn_major)
    a, b = (torch.randn(64, 64, device="cuda", generator=gen
                        ).to(torch.bfloat16) for _ in range(2))
    c = torch.empty(64, 64, device="cuda")
    fn = _build.load(tfa.BWD).flash_attention_bwd_wgmma_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), b_mn_major,
              torch.cuda.current_stream().cuda_stream) == 0
    want = a.double() @ (b.double() if b_mn_major else b.double().T)
    torch.cuda.synchronize()
    err = (c.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_bwd_design_of_the_source_matches_bwd_design_on_card():
    """The source's own choice of design, for every head dim up to 1100 in
    both dtypes, is the one bwd_design names (and counts)."""
    _needs_card()
    from analytics_zoo_tpu_torch.ops import _build
    fn = _build.load(tfa.BWD).flash_attention_bwd_design
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(1, 1101):
            width = tfa._kernel_head_dim(d, dtype, tfa.BWD_TC_MAX_HEAD_DIM)
            got = tfa.DESIGNS[fn(int(dtype == torch.bfloat16), width)]
            assert got == tfa.bwd_design(dtype, d), (dtype, d)


def _tf32(x):
    """``cvt.rna.tf32.f32`` by bit operations."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000
            ).view(torch.float32)


def _parts(x):
    """x's big and small tf32 parts, stacked: [2, *x.shape]."""
    big = _tf32(x)
    return torch.stack([big, _tf32(x - big)]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (384, 512, 512, 64, False), (384, 512, 512, 64, True),
    (3, 77, 130, 64, False), (3, 77, 130, 64, True),
    (3, 130, 77, 40, False), (3, 130, 77, 40, True),
    (2, 200, 77, 33, True), (5, 61, 130, 1, True), (5, 130, 61, 8, False),
    (2, 300, 3, 24, True), (2, 1, 300, 63, False), (7, 333, 333, 48, True),
    (4, 100, 100, 56, False), (3, 64, 64, 32, True), (3, 33, 95, 16, False),
    (70000, 8, 8, 16, False)])
def test_tf32_bwd_matches_reference_on_card(bh, tq, tk, d, causal):
    """The f32 design on wgmma in 3xTF32 (heads 1-64) against the plain
    backward: the training shape, every kind of width the split pass pads
    to a multiple of 8 and the TMA box zero-fills to 64, Tq != Tk ragged
    under `causal`, BH past 65535; each gradient within 1e-4 of max(1,
    max |ref|), and one launch of that design."""
    _needs_card()
    q, k, v, out, lse, g = _card_case(bh + d, bh, tq, tk, d, torch.float32,
                                      causal)
    before = dict(tfa.BWD_LAUNCHES)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.isfinite(a).all()
        ref = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, ref)
    assert tfa.BWD_LAUNCHES["wgmma_tf32"] == before["wgmma_tf32"] + 1
    assert {n: c for n, c in tfa.BWD_LAUNCHES.items()
            if n != "wgmma_tf32"} == \
        {n: c for n, c in before.items() if n != "wgmma_tf32"}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_tf32_bwd_repeats_bit_for_bit_on_card(causal):
    """No atomics in the f32 design either: two calls on one input give
    identical dq, dk and dv."""
    _needs_card()
    case = _card_case(12, 48, 512, 512, 64, torch.float32, causal)
    first = flash_attention_bwd(*case[:5], case[5], causal)
    second = flash_attention_bwd(*case[:5], case[5], causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tf32_bwd_takes_a_misaligned_view_on_card():
    """f32 views 4 bytes past a 16-byte boundary give the plain version's
    gradients."""
    _needs_card()
    q, k, v, out, lse, g = _card_case(6, 4, 100, 100, 64, torch.float32,
                                      True)

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    got = flash_attention_bwd(*(shifted(x) for x in (q, k, v, out)), lse,
                              shifted(g), True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, True)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
def test_tf32_operand_form_matches_a_plain_matmul_on_card(form):
    """Each 3xTF32 operand form of the f32 design alone, 64 x 64 x 64
    through TMA's 128-byte swizzle: A and B K-major parts in shared memory
    (C = A B^T, as S and dP), and A from registers in the order an
    accumulator hands it on, B K-major with its depth in that order (as
    dV, dK and dQ); within 2e-6 of max |ref| (f32: 3xTF32 keeps about its
    accuracy), and one pass of tf32 would miss that."""
    _needs_card()
    import ctypes
    from analytics_zoo_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda").manual_seed(form)
    a, b = (torch.randn(64, 64, device="cuda", generator=gen)
            for _ in range(2))
    if form:  # position p of each group of 8 holds depth 2p, or 2(p-4)+1
        j = torch.arange(64, device="cuda")
        p = j % 8
        src = (j - p) + torch.where(p < 4, 2 * p, 2 * (p - 4) + 1)
        b_stored = b[:, src]
    else:
        b_stored = b
    c = torch.empty(64, 64, device="cuda")
    fn = _build.load(tfa.BWD).flash_attention_bwd_tf32_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a_parts, b_parts = _parts(a), _parts(b_stored)
    assert fn(a.data_ptr(), a_parts.data_ptr(), b_parts.data_ptr(),
              c.data_ptr(), form, torch.cuda.current_stream().cuda_stream) == 0
    want = a.double() @ b.double().T
    torch.cuda.synchronize()
    top = want.abs().max().item()
    assert (c.double() - want).abs().max().item() <= 2e-6 * top
    one_pass = (_tf32(a).double() @ _tf32(b).double().T - want).abs().max()
    assert one_pass.item() > 2e-6 * top
