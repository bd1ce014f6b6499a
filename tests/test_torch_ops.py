"""Differential tests: the PyTorch port's flash attention against the JAX
package's, on the CPU.

The JAX side runs the real Pallas kernel in interpret mode (``INTERPRET`` of
its module set in a try/finally, as tests/test_ops.py does).  The port's
side takes its plain PyTorch version, which is what its wrapper runs for a
CPU tensor; the CUDA kernel itself is checked on the card (the ``cuda``
test below, and chip_smoke.py).  Tolerance 2e-5 in f32, as test_ops.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import (flash_attention, flash_attention_fwd,
                                         flash_attention_fwd_reference,
                                         mha_reference)

# the package's __init__ re-exports the function under the module's name,
# so reach the modules themselves through importlib
jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")
tfa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32))


def _jax_interpret(fn, *args, **kw):
    jfa.INTERPRET = True
    try:
        return np.asarray(fn(*args, **kw))
    finally:
        jfa.INTERPRET = False


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [24, 33])
def test_flash_matches_pallas_kernel(causal, t):
    """[B, T, H, D] entry point against the Pallas kernel (interpret mode),
    with T not a multiple of the block (the ragged edge)."""
    q, k, v = _qkv(t, b=2, tq=t, tk=t, h=2, d=8)
    want = _jax_interpret(jfa.flash_attention, jnp.asarray(q),
                          jnp.asarray(k), jnp.asarray(v), causal=causal,
                          block_q=16, block_k=16)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(20, 20), (12, 28)])
def test_fwd_out_and_lse_match_padded_pallas(causal, tq, tk):
    """The [BH, T, D] forward's out AND lse against ``_padded_pallas``
    (which pads D to 128 and T to the block, then runs the kernel)."""
    q, k, v = _qkv(tq + tk, b=1, tq=tq, tk=tk, h=3, d=16)
    q3, k3, v3 = (x.transpose(0, 2, 1, 3).reshape(3, -1, 16)
                  for x in (q, k, v))
    scale = 1.0 / np.sqrt(16)
    want_out, want_lse = jfa._padded_pallas(
        jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3), scale, causal,
        8, 8, interpret=True)
    out, lse = flash_attention_fwd(torch.from_numpy(q3),
                                   torch.from_numpy(k3),
                                   torch.from_numpy(v3), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_blocked_jax(causal):
    """The plain version repeats ``_blocked_fwd_jax``'s math, block size
    and all."""
    q, k, v = _qkv(5, b=1, tq=40, tk=40, h=2, d=8)
    q3, k3, v3 = (x.transpose(0, 2, 1, 3).reshape(2, 40, 8)
                  for x in (q, k, v))
    want_out, want_lse = jfa._blocked_fwd_jax(
        jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3),
        1.0 / np.sqrt(8), causal, 16)
    out, lse = flash_attention_fwd_reference(
        torch.from_numpy(q3), torch.from_numpy(k3), torch.from_numpy(v3),
        causal, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(7, b=2, tq=16, tk=16, h=2, d=8)
    want = np.asarray(jfa.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal))
    got = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_bf16_reference_keeps_dtype_and_f32_lse():
    q, k, v = (torch.from_numpy(x[0].transpose(1, 0, 2).copy()).bfloat16()
               for x in _qkv(9, b=1, tq=10, tk=10, h=2, d=16))
    out, lse = flash_attention_fwd(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 10, 16)
    assert lse.dtype == torch.float32 and lse.shape == (2, 10)
    ref, _ = flash_attention_fwd(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_hands_the_kernel_contiguous_tensors(monkeypatch, b):
    """The kernel takes contiguous [BH, T, D]; at B == 1 the transpose's
    reshape alone would hand it a strided view."""
    seen = []

    def spy(q3, k3, v3, causal=False):
        seen.extend(x.is_contiguous() for x in (q3, k3, v3))
        return flash_attention_fwd_reference(q3, k3, v3, causal)

    monkeypatch.setattr(tfa, "flash_attention_fwd", spy)
    x = torch.randn(b, 5, 3, 16)
    flash_attention(x, x, x)
    assert seen and all(seen)


def test_cpu_path_never_counts_as_a_launch():
    before = flash_attention_fwd.launches
    q = torch.zeros(1, 4, 16)
    flash_attention_fwd(q, q, q)
    assert flash_attention_fwd.launches == before


def test_wrapper_raises_on_other_devices_and_bad_shapes():
    """No silent fallback: a tensor neither on the CPU nor on the card is
    refused, as are shapes the kernel does not take."""
    meta = torch.empty(2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(meta, meta, meta)
    q = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_fwd(q, torch.zeros(2, 4, 8), torch.zeros(2, 4, 8))
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_fwd(q, q.double(), q)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=1032), "D <= 1024"),
    (dict(d=0), "1 <= D"),
])
def test_launch_validates_before_building(bad, match):
    """The kernel's own limits are checked before any build or launch."""
    d = bad.get("d", 16)
    q = torch.zeros(2, 4, d, dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        tfa._launch(q, q, q, False)


def test_build_hash_tracks_source_and_missing_nvcc_raises(tmp_path,
                                                          monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first
    assert first.parent == tmp_path / "build"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("k")


def test_csrc_sources_ship_with_the_package():
    assert (_build.CSRC / "flash_attention_fwd.cu").is_file()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [4, 300])
@pytest.mark.parametrize("tq,tk", [(77, 77), (130, 61)])
@pytest.mark.parametrize("d", [24, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_reference_on_card(dtype, causal, d, tq, tk, bh):
    """The CUDA kernels against their plain version (runs on the card
    only), at chip_smoke.py's tolerances: f32 out 2e-5, bf16 out 2% of
    max |out|, lse 5e-5; ragged T, Tq != Tk; BH 300 makes grids large
    enough for the bf16 kernel's 128-row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(d + tq)
    q = torch.randn(bh, tq, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(bh, tk, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal)
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else \
        2e-2 * ref.float().abs().max().item()
    assert out.dtype == dtype and out.shape == (bh, tq, d)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 5e-5
