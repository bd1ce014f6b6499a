"""Flash attention forward: hand-written CUDA kernels for Hopper and their
plain PyTorch version.

Port of ``analytics_zoo_tpu/ops/flash_attention.py``.  The TPU package runs
the forward as a Pallas kernel (``_fwd_kernel``); here
``flash_attention_fwd`` launches, for a tensor on the card, the bfloat16
tensor-core kernel (``csrc/flash_attention_fwd.cu``) or the exact float32
scalar kernel (``csrc/flash_attention_fwd_f32.cu``), and uses
``flash_attention_fwd_reference`` (the blocked online-softmax math of the
JAX package's ``_blocked_fwd_jax``) only for a tensor on the CPU.  Both
kernels take any BH and any head dim from 1 to 256.  There is no fallback
from the card to the plain version: a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
MAX_HEAD_DIM = 256
# dtype -> (the kernel's source, csrc/<source>.cu, and its C entry point)
_KERNELS = {
    torch.bfloat16: ("flash_attention_fwd", "flash_attention_fwd_bf16"),
    torch.float32: ("flash_attention_fwd_f32", "flash_attention_fwd_f32"),
}
# launches of each kernel, by source; flash_attention_fwd.launches counts all
KERNEL_LAUNCHES = {source: 0 for source, _ in _KERNELS.values()}
_count_lock = threading.Lock()


def flash_attention_fwd_reference(q3: torch.Tensor, k3: torch.Tensor,
                                  v3: torch.Tensor, causal: bool = False,
                                  block_k: int = 256,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax forward over key blocks of ``block_k``; ``[BH, T, D]``
    in, ``(out [BH, Tq, D] in the input dtype, lse [BH, Tq] f32)`` out.
    ``scale`` defaults to ``1/sqrt(D)``.  Runs on any device; it is what
    the kernels are held against."""
    bh, tq, d = q3.shape
    tk = k3.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bk = min(block_k, tk)
    qf = q3.float()
    qpos = torch.arange(tq, device=q3.device)[:, None]
    m = torch.full((bh, tq, 1), _NEG_INF, device=q3.device)
    l = torch.zeros((bh, tq, 1), device=q3.device)
    acc = torch.zeros((bh, tq, d), device=q3.device)
    for j0 in range(0, tk, bk):
        kj = k3[:, j0:j0 + bk].float()
        vj = v3[:, j0:j0 + bk].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kj) * scale
        if causal:
            kpos = j0 + torch.arange(kj.shape[1], device=q3.device)[None, :]
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vj)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q3.dtype), (m + torch.log(l))[..., 0]


def _check(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor) -> None:
    if q3.dim() != 3 or k3.dim() != 3 or v3.dim() != 3:
        raise ValueError("q, k, v must be [BH, T, D]")
    bh, _, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"shape mismatch: q {tuple(q3.shape)}, "
                         f"k {tuple(k3.shape)}, v {tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise ValueError("q, k, v must share one dtype")
    if q3.shape[1] < 1 or k3.shape[1] < 1:
        raise ValueError("Tq and Tk must be at least 1")


def _pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns appended to the last dim up to ``width``:
    they add 0 to every q.k and make output columns that are cut off."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim a kernel is handed for a true ``d``: the bf16 kernel
    copies rows in whole 16-byte pieces, so it takes multiples of 8 (others
    are padded); the f32 kernel takes any ``d``."""
    return -(-d // 8) * 8 if dtype == torch.bfloat16 else d


def _launch(q3, k3, v3, causal):
    if q3.dtype not in _KERNELS:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, "
                         f"not {q3.dtype}")
    d = q3.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take 1 <= D <= {MAX_HEAD_DIM}, "
                         f"not {d}")
    if not (q3.device == k3.device == v3.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q3.is_contiguous() and k3.is_contiguous()
            and v3.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous [BH, T, D] "
                         "tensors")
    width = _kernel_head_dim(d, q3.dtype)
    if width != d:
        q3, k3, v3 = (_pad_head_dim(x, width) for x in (q3, k3, v3))
    out, lse = _run_kernel(q3, k3, v3, causal, 1.0 / math.sqrt(d))
    if width != d:
        out = out[..., :d].contiguous()
    return out, lse


def _run_kernel(q3, k3, v3, causal, scale):
    """Launch the dtype's kernel on ``[BH, T, width]`` tensors with the
    softmax ``scale`` of the true head dim; counts the launch."""
    from . import _build
    source, entry = _KERNELS[q3.dtype]
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:  # ints would cut 64-bit pointers
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the bf16 kernel copies 16-byte pieces: a view at an odd offset is
    # copied to fresh (aligned) storage first
    q3, k3, v3 = (x if x.data_ptr() % 16 == 0 else x.clone()
                  for x in (q3, k3, v3))
    bh, tq, d = q3.shape
    out = torch.empty_like(q3)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), bh, tq, k3.shape[1], d, int(bool(causal)),
                 scale, stream)
    if err != 0:
        es = lib.flash_attention_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({es(err).decode()})")
    with _count_lock:
        flash_attention_fwd.launches += 1
        KERNEL_LAUNCHES[source] += 1
    return out, lse


def flash_attention_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward over ``[BH, T, D]``: ``(out, lse)``.

    A CUDA tensor goes to its dtype's kernel (f32 or bf16, any BH,
    1 <= D <= 256, contiguous), anything else raises; a CPU tensor takes
    the plain version.  ``flash_attention_fwd.launches`` counts kernel
    launches, ``KERNEL_LAUNCHES`` each kernel's."""
    _check(q3, k3, v3)
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, causal)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, "
                         f"not {q3.device.type}")
    return _launch(q3, k3, v3, causal)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention over ``[B, T, H, D]`` tensors (softmax scale
    ``1/sqrt(D)``), forward only; matches :func:`mha_reference`."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    # contiguous(): at B == 1 the reshape alone is a strided view
    q3 = q.permute(0, 2, 1, 3).reshape(b * h, tq, d).contiguous()
    k3 = k.permute(0, 2, 1, 3).reshape(b * h, tk, d).contiguous()
    v3 = v.permute(0, 2, 1, 3).reshape(b * h, tk, d).contiguous()
    out, _ = flash_attention_fwd(q3, k3, v3, causal)
    return out.reshape(b, h, tq, d).permute(0, 2, 1, 3)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> torch.Tensor:
    """Materialized-logits attention over ``[B, T, H, D]``, for tests."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        tq, tk = s.shape[-2:]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
