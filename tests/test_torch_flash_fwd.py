"""The port's flash-attention forward by design: which design takes which
(dtype, head dim) and, on the card, the ``wgmma`` design (bf16 heads of
33-64), the ``wgmma_wide`` design (bf16 heads above 256) and the
``wgmma_tf32`` design (f32 heads up to 64) against the plain version.

The CPU tests hold the dispatch rule and the plain forward against the
JAX package's ``_blocked_fwd_jax`` and custom_vjp at the widths the
``wgmma`` and ``wgmma_wide`` designs take (2e-5, as
tests/test_torch_ops.py); tests/test_torch_flash_shapes.py
holds the wrapper's padding and scale at those widths.
The ``cuda`` tests hold the kernels to their plain version at
chip_smoke.py's tolerances (bf16 out 2% of max |ref|: one rounding of
each output on both sides and P rounded to bf16 before P V; f32 out 2e-5;
lse 5e-5) and skip without a card.
"""

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import (_build, flash_attention,
                                         flash_attention_fwd,
                                         flash_attention_fwd_reference)

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")
tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")

TOL = 2e-5
TOL_BF16_REL = 2e-2
TOL_LSE = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv3(seed, bh, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, tq, d)).astype(np.float32),
            rng.normal(size=(bh, tk, d)).astype(np.float32),
            rng.normal(size=(bh, tk, d)).astype(np.float32))


@pytest.mark.parametrize("dtype,d,design", [
    (torch.bfloat16, 1, "mma.sync"), (torch.bfloat16, 24, "mma.sync"),
    (torch.bfloat16, 32, "mma.sync"), (torch.bfloat16, 33, "wgmma"),
    (torch.bfloat16, 36, "wgmma"), (torch.bfloat16, 57, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 65, "mma.sync"),
    (torch.bfloat16, 256, "mma.sync"), (torch.bfloat16, 257, "wgmma_wide"),
    (torch.float32, 1, "wgmma_tf32"), (torch.float32, 8, "wgmma_tf32"),
    (torch.float32, 33, "wgmma_tf32"), (torch.float32, 64, "wgmma_tf32"),
    (torch.float32, 65, "scalar"), (torch.float32, 128, "scalar"),
    (torch.float32, 256, "scalar"), (torch.float32, 320, "wide"),
    (torch.bfloat16, 320, "wgmma_wide"), (torch.bfloat16, 2048, "wgmma_wide"),
    (torch.float32, 2048, "wide")])
def test_fwd_design_by_dtype_and_head_dim(dtype, d, design):
    """Which design of the forward takes which (dtype, head dim): bf16
    heads padded to 40-64 go to wgmma, above 256 to wgmma_wide, other bf16
    heads to mma.sync, f32 heads up to 64 to wgmma in 3xTF32, 65-256 to
    the scalar kernel, above 256 to the wide one."""
    assert tfa.fwd_design(dtype, d) == design


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [36, 56])
def test_reference_matches_blocked_jax_at_the_wgmma_widths(d, causal):
    """The plain forward the kernel is held against repeats
    ``_blocked_fwd_jax``'s math at head dims the wgmma design takes, with
    Tq != Tk and a ragged last key block."""
    q, k, v = _qkv3(d + 1, 2, 19, 27, d)
    want_out, want_lse = jfa._blocked_fwd_jax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0 / np.sqrt(d),
        causal, 16)
    out, lse = flash_attention_fwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [264, 320, 520])
def test_forward_matches_jax_custom_vjp_at_the_wide_wgmma_widths(d, causal):
    """The head dims of the bf16 forward's wgmma_wide design (above 256:
    one and two column groups, 520 past a group's edge), with Tq != Tk and
    a ragged T, on bf16-rounded inputs: the port's forward (the plain
    version, on the CPU) against the JAX custom_vjp's, and its lse against
    ``_blocked_fwd_jax``'s (2e-5)."""
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in _qkv3(d + 3, 2, 19, 27, d))
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x[None].transpose(0, 2, 1, 3)) for x in (q, k, v)),
        causal=causal))[0].transpose(1, 0, 2)
    got = flash_attention(*(torch.from_numpy(x[None]).transpose(1, 2)
                            for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got[0].transpose(0, 1).numpy(), want,
                               atol=TOL, rtol=TOL)
    _, want_lse = jfa._blocked_fwd_jax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0 / np.sqrt(d),
        causal, 256)
    _, lse = flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL,
                               rtol=TOL)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _card_qkv(seed, bh, tq, tk, d, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(t):
        return torch.randn(bh, t, d, device="cuda", generator=gen).to(dtype)

    return r(tq), r(tk), r(tk)


def _hold_to_reference(q, k, v, causal):
    """The bf16 forward kernel against its plain version; returns the
    kernel's (out, lse)."""
    out, lse = flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL_BF16_REL * ref.float().abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE
    return out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (768, 512, 512, 64, False), (768, 512, 512, 64, True),
    (384, 512, 512, 64, False), (384, 512, 512, 64, True),
    *[(3, tq, tk, d, c) for d in (36, 40, 48, 56)
      for tq, tk in ((77, 130), (130, 77)) for c in (False, True)],
    (3, 1, 300, 64, False), (3, 1, 300, 64, True),
    (70000, 8, 8, 64, False), (70000, 8, 8, 64, True)])
def test_wgmma_fwd_matches_reference_on_card(bh, tq, tk, d, causal):
    """The wgmma design against the plain forward: BERT's serving and
    training shapes, head dims the TMA box zero-fills to 64 (36 padded to
    40 first), Tq != Tk ragged under `causal`, one query row against 300
    keys, and BH 70000 (blocks whose 64 rows lie mostly past Tq 8); each
    call launches that design once."""
    _needs_card()
    q, k, v = _card_qkv(bh + d + tq, bh, tq, tk, d)
    before = dict(tfa.FWD_LAUNCHES)
    _hold_to_reference(q, k, v, causal)
    assert tfa.FWD_LAUNCHES["wgmma"] == before["wgmma"] + 1
    assert {n: c for n, c in tfa.FWD_LAUNCHES.items() if n != "wgmma"} == \
        {n: c for n, c in before.items() if n != "wgmma"}


@pytest.mark.cuda
def test_wgmma_fwd_takes_a_misaligned_view_on_card():
    """Views 2 bytes past a 16-byte boundary (the wrapper copies them for
    TMA) give the plain version's out and lse."""
    _needs_card()
    q, k, v = _card_qkv(7, 4, 100, 100, 64)

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    _hold_to_reference(*(shifted(x) for x in (q, k, v)), True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_fwd_repeats_bit_for_bit_on_card(causal):
    """Two calls on one input give identical out and lse."""
    _needs_card()
    q, k, v = _card_qkv(13, 192, 512, 512, 64)
    first = flash_attention_fwd(q, k, v, causal)
    second = flash_attention_fwd(q, k, v, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fwd_design_of_the_source_matches_fwd_design_on_card():
    """The source's own choice of design, for every head dim up to 1100 in
    both dtypes, is the one fwd_design names (and counts)."""
    _needs_card()
    fn = _build.load(tfa.FWD_BF16).flash_attention_fwd_design
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(1, 1101):
            width = tfa._kernel_head_dim(d, dtype)
            got = tfa.DESIGNS[fn(int(dtype == torch.bfloat16), width)]
            assert got == tfa.fwd_design(dtype, d), (dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (24, 512, 512, 1024, False), (24, 512, 512, 1024, True),
    (24, 512, 512, 320, False), (96, 512, 512, 320, True),
    *[(3, tq, tk, d, c) for d in (264, 320, 1024, 2048)
      for tq, tk in ((77, 130), (130, 77)) for c in (False, True)],
    (3, 100, 1, 320, False), (3, 100, 1, 520, True),
    (3, 1, 300, 520, False), (70000, 8, 8, 264, True)])
def test_wgmma_wide_fwd_matches_reference_on_card(bh, tq, tk, d, causal):
    """The wgmma_wide design (bf16 heads above 256) against the plain
    forward: BH 24 and 96 at T 512 (several waves of blocks), one to eight
    column groups, 264 one atom past the last group's first, Tq != Tk
    ragged both ways under `causal`, one key, one query row and BH past
    65535; each call launches that design once and no other."""
    _needs_card()
    q, k, v = _card_qkv(bh + d + tq, bh, tq, tk, d)
    before = dict(tfa.FWD_LAUNCHES)
    _hold_to_reference(q, k, v, causal)
    want = dict(before)
    want["wgmma_wide"] += 1
    assert tfa.FWD_LAUNCHES == want


@pytest.mark.cuda
def test_wgmma_wide_fwd_takes_a_misaligned_view_and_a_ragged_width_on_card():
    """Views 2 bytes past a 16-byte boundary at D 300 (padded to 304 and
    copied by the wrapper) give the plain version's out and lse."""
    _needs_card()
    q, k, v = _card_qkv(10, 4, 100, 100, 300)

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    _hold_to_reference(*(shifted(x) for x in (q, k, v)), True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_wide_fwd_repeats_bit_for_bit_on_card(causal):
    """Two calls on one input give identical out and lse at D 1024."""
    _needs_card()
    q, k, v = _card_qkv(16, 24, 512, 512, 1024)
    first = flash_attention_fwd(q, k, v, causal)
    second = flash_attention_fwd(q, k, v, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _hold_f32_to_reference(q, k, v, causal, design):
    """The f32 forward kernel against its plain version (out within 2e-5,
    lse within 5e-5); the call launches ``design`` once and no other.
    Returns the kernel's (out, lse)."""
    before = dict(tfa.FWD_LAUNCHES)
    out, lse = flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE
    want = dict(before)
    want[design] += 1
    assert tfa.FWD_LAUNCHES == want
    return out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (192, 512, 512, 64, False), (192, 512, 512, 64, True),
    (96, 512, 512, 64, False),
    *[(3, tq, tk, d, c) for d in (1, 8, 24, 40, 64)
      for tq, tk in ((77, 130), (130, 77)) for c in (False, True)],
    (3, 1000, 1000, 64, True), (3, 1, 300, 64, False),
    (70000, 8, 8, 64, True)])
def test_wgmma_tf32_fwd_matches_reference_on_card(bh, tq, tk, d, causal):
    """The f32 wgmma_tf32 design against the plain forward: BERT's f32
    serving (BH 192) and training (BH 96) shapes, head dims 1-64 (the
    split pass pads them to a multiple of 8, TMA zero-fills the rest of
    64), Tq != Tk ragged both ways under `causal`, one query row against
    300 keys, and BH 70000 (blocks whose rows lie mostly past Tq 8)."""
    _needs_card()
    q, k, v = _card_qkv(bh + d + tq, bh, tq, tk, d, torch.float32)
    _hold_f32_to_reference(q, k, v, causal, "wgmma_tf32")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [65, 128])
def test_scalar_fwd_keeps_f32_heads_of_65_to_256_on_card(d):
    _needs_card()
    q, k, v = _card_qkv(d, 3, 77, 130, d, torch.float32)
    _hold_f32_to_reference(q, k, v, True, "scalar")


@pytest.mark.cuda
def test_wgmma_tf32_fwd_takes_a_misaligned_view_on_card():
    """f32 views 4 bytes past a 16-byte boundary give the plain version's
    out and lse."""
    _needs_card()
    q, k, v = _card_qkv(9, 4, 100, 100, 64, torch.float32)

    def shifted(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    _hold_f32_to_reference(*(shifted(x) for x in (q, k, v)), True,
                           "wgmma_tf32")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_tf32_fwd_repeats_bit_for_bit_on_card(causal):
    """Two calls on one input give identical out and lse."""
    _needs_card()
    q, k, v = _card_qkv(14, 192, 512, 512, 64, torch.float32)
    first = flash_attention_fwd(q, k, v, causal)
    second = flash_attention_fwd(q, k, v, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
