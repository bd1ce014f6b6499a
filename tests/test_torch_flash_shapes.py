"""Head dims and softmax scales of the port's flash attention, against the
JAX package's, on the CPU.

The CUDA kernels take any head dim from 1 to 256: columns past the true
``d`` are zero (in shared memory, or padded by the wrapper for bf16 dims
that are not a multiple of 8) and the softmax scale is ``1/sqrt(true d)``.
These tests hold that padding rule, the explicit ``scale=`` of the plain
version and a ``MultiHeadAttention`` with an odd ``head_dim`` against the
JAX package; the kernels themselves are checked on the card
(tests/test_torch_ops.py's ``cuda`` test and chip_smoke.py).  Tolerances
as tests/test_torch_ops.py (2e-5) and tests/test_torch_nn.py (1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
import analytics_zoo_tpu_torch.nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.ops import _build, flash_attention_fwd_reference

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")
tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")

TOL = 2e-5


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


@pytest.mark.parametrize("causal", [False, True])
def test_reference_takes_an_explicit_scale(causal):
    """``scale=`` replaces 1/sqrt(D), as ``_blocked_fwd_jax``'s argument."""
    q, k, v = _qkv3(1, 2, 30, 45, 16)
    want_out, want_lse = jfa._blocked_fwd_jax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, causal, 16)
    out, lse = flash_attention_fwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, block_k=16,
        scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,width", [(24, 32), (96, 128), (21, 24)])
def test_zero_padded_head_dim_matches_unpadded_and_pallas(d, width, causal):
    """What the kernels do for a head dim below their width: zero columns
    up to ``width``, the scale of the true d, the output cut back to d.
    Held against the unpadded plain version and against the Pallas kernel
    in interpret mode (``_padded_pallas`` pads D to 128 itself)."""
    q, k, v = _qkv3(d, 3, 20, 28, d)
    tq3 = [torch.from_numpy(x) for x in (q, k, v)]
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_attention_fwd_reference(
        *(tfa._pad_head_dim(x, width) for x in tq3), causal, scale=scale)
    assert out.shape == (3, 20, width)
    assert torch.count_nonzero(out[..., d:]) == 0
    ref, ref_lse = flash_attention_fwd_reference(*tq3, causal)
    np.testing.assert_allclose(out[..., :d].numpy(), ref.numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=TOL,
                               rtol=TOL)
    jfa.INTERPRET = True
    try:
        want_out, want_lse = jfa._padded_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
            8, 8, interpret=True)
    finally:
        jfa.INTERPRET = False
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype,d,width", [
    (torch.bfloat16, 21, 24), (torch.bfloat16, 24, 24),
    (torch.float32, 21, 21), (torch.bfloat16, 5, 8),
    # the widths of the wgmma design (bf16 heads of 33-64)
    (torch.bfloat16, 33, 40), (torch.bfloat16, 36, 40),
    (torch.bfloat16, 57, 64), (torch.bfloat16, 64, 64)])
def test_launch_hands_the_kernel_its_width_and_the_true_scale(
        monkeypatch, dtype, d, width):
    """The launch path around the kernel: bf16 head dims that are not a
    multiple of 8 are padded with zeros, the scale stays 1/sqrt(d), and
    the output is cut back to d (the kernel call itself replaced by the
    plain version, so this runs on the CPU)."""
    seen = []

    def fake_kernel(q3, k3, v3, causal, scale):
        seen.append((q3.shape[-1], k3.shape[-1], v3.shape[-1], scale))
        return flash_attention_fwd_reference(q3, k3, v3, causal,
                                             scale=scale)

    monkeypatch.setattr(tfa, "_run_kernel", fake_kernel)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv3(3, 2, 9, 11, d))
    out, lse = tfa._launch(q, k, v, True)
    assert seen == [(width, width, width, pytest.approx(1 / np.sqrt(d)))]
    assert out.shape == (2, 9, d) and out.dtype == dtype
    assert out.is_contiguous()
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, True)
    # bf16: one rounding of each output on both sides (the repo's 2% of
    # max |out|)
    tol = TOL if dtype == torch.float32 else \
        2e-2 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_with_head_dim_24_and_flash_matches_jax(causal):
    """A model the JAX package takes with ``use_flash=True``: head_dim 24
    (not a power of two, not d_model / H)."""
    x = np.random.default_rng(12).normal(size=(2, 11, 32)).astype(np.float32)
    jm = jnn.MultiHeadAttention(4, head_dim=24, use_flash=True,
                                causal=causal)
    variables = jm.init(jax.random.PRNGKey(0), x)
    tm = tnn.MultiHeadAttention(32, 4, head_dim=24, use_flash=True,
                                causal=causal)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    tm.eval()
    want, _ = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_build_hash_tracks_the_shared_headers(tmp_path, monkeypatch):
    """A kernel source may include any ``csrc/*.cuh``: editing, adding or
    removing one must not load a stale library."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "h.cuh"\n')
    (src / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (src / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (src / "other.cuh").write_text("// new\n")
    third = _build.library_path("k")
    assert third not in (first, second)
    (src / "other.cuh").unlink()
    assert _build.library_path("k") == second
