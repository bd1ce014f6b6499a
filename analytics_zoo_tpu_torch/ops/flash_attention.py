"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper and their plain PyTorch versions.

Port of ``analytics_zoo_tpu/ops/flash_attention.py``.  The TPU package runs
the forward as a Pallas kernel (``_fwd_kernel``) inside a ``jax.custom_vjp``
whose backward is the blocked FA2 math of ``_blocked_bwd_jax``.  Here, for a
tensor on the card:

- ``flash_attention_fwd`` launches the bfloat16 tensor-core kernel
  (``csrc/flash_attention_fwd.cu``: heads of 33-64 on ``wgmma`` fed by a
  TMA ring, other heads up to 256 on ``mma.sync``) or the float32 kernels
  (``csrc/flash_attention_fwd_f32.cu``: heads up to 64 on ``wgmma`` in
  3xTF32 after a split pass, up to 256 on scalar FMAs, wider heads, and
  bfloat16 heads wider than 256, in f32 on the wide kernel);
  ``fwd_design`` names the design;
- ``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu``: bf16
  heads of 33-64 on ``wgmma`` fed by a TMA ring, up to 32 on ``mma.sync``,
  f32 heads up to 64 on ``wgmma`` in 3xTF32 (three tf32 products per f32
  product, about f32's accuracy), wider heads in scalar f32
  (``bwd_design`` names the design);
- ``flash_attention`` ties them together in a ``torch.autograd.Function``.

Every kernel takes any BH and any head dim of at least 1, as the JAX
kernel (which pads D) does.  For a tensor on
the CPU the wrappers use ``flash_attention_fwd_reference`` and
``flash_attention_bwd_reference`` (the blocked math of the JAX package's
``_blocked_fwd_jax`` and ``_blocked_bwd_jax``).  There is no fallback from
the card to the plain versions: a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
# the bf16 tensor-core forward's widest head; wider bf16 heads take the f32
# source's wide kernel
TC_MAX_HEAD_DIM = 256
# the backward's bf16 tensor-core paths' widest head; wider heads take its
# scalar f32 paths
BWD_TC_MAX_HEAD_DIM = 64
# the designs of both directions, in the order of the `Design` of
# csrc/flash_attention_fwd.cu and csrc/flash_attention_bwd.cu
# (flash_attention_fwd_design and flash_attention_bwd_design return the
# index)
DESIGNS = ("scalar", "mma.sync", "wgmma", "wide", "wgmma_tf32")
FWD_BF16 = "flash_attention_fwd"      # csrc/<source>.cu
FWD_F32 = "flash_attention_fwd_f32"
BWD = "flash_attention_bwd"
# the f32 forward's C entry point, the one that takes a workspace
_FWD_F32_ENTRY = "flash_attention_fwd_f32"
_BWD_ENTRIES = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}
# launches of each kernel, by source; flash_attention_fwd.launches and
# flash_attention_bwd.launches count each direction's, FWD_LAUNCHES and
# BWD_LAUNCHES each direction's by design
KERNEL_LAUNCHES = {FWD_BF16: 0, FWD_F32: 0, BWD: 0}
FWD_LAUNCHES = dict.fromkeys(DESIGNS, 0)
BWD_LAUNCHES = dict.fromkeys(DESIGNS, 0)
_count_lock = threading.Lock()


def fwd_kernel(dtype: torch.dtype, d: int) -> Tuple[str, str]:
    """(source, C entry point) of the forward kernel for ``dtype`` and a
    head dim of ``d``."""
    if dtype == torch.bfloat16:
        if d <= TC_MAX_HEAD_DIM:
            return FWD_BF16, "flash_attention_fwd_bf16"
        return FWD_F32, "flash_attention_fwd_wide_bf16"
    return FWD_F32, _FWD_F32_ENTRY


def fwd_design(dtype: torch.dtype, d: int) -> str:
    """The design that takes the forward of a head dim ``d`` in ``dtype``
    (after the wrapper's padding of bf16 tensor-core heads to a multiple
    of 8): one of ``DESIGNS``.  bf16 heads of 33-64 run on ``wgmma``,
    other bf16 heads up to 256 on ``mma.sync`` (both in
    ``csrc/flash_attention_fwd.cu``); f32 heads up to 64 on ``wgmma`` in
    3xTF32 (``wgmma_tf32``), up to 256 on the scalar kernel and heads
    above 256 on the wide one (all in
    ``csrc/flash_attention_fwd_f32.cu``).  The rule depends on nothing
    but the dtype and the width: at BERT's shapes the ``wgmma`` design is
    faster than ``mma.sync`` at every BH, 12 included (``PERF.md``).
    Mirrors the source's ``design``; a ``cuda`` test holds the two
    together."""
    width = _kernel_head_dim(d, dtype, TC_MAX_HEAD_DIM)
    if width > TC_MAX_HEAD_DIM:
        return "wide"
    if dtype != torch.bfloat16:
        return "wgmma_tf32" if width <= 64 else "scalar"
    if 32 < width <= 64:
        return "wgmma"
    return "mma.sync"


def bwd_design(dtype: torch.dtype, d: int) -> str:
    """The design of ``csrc/flash_attention_bwd.cu`` that takes the
    backward of a head dim ``d`` in ``dtype`` (after the wrapper's padding
    of bf16 tensor-core heads to a multiple of 8): one of ``DESIGNS``.
    bf16 heads of 33-64 run on ``wgmma``, up to 32 on ``mma.sync``; f32
    heads up to 64 on ``wgmma`` in 3xTF32 (``wgmma_tf32``); wider heads up
    to 256 on the scalar kernels, above 256 on the wide ones.  Mirrors the
    source's ``design``; a ``cuda`` test holds the two together."""
    width = _kernel_head_dim(d, dtype, BWD_TC_MAX_HEAD_DIM)
    if width > 256:
        return "wide"
    if width <= BWD_TC_MAX_HEAD_DIM:
        if dtype != torch.bfloat16:
            return "wgmma_tf32"
        return "mma.sync" if width <= 32 else "wgmma"
    return "scalar"


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


def flash_attention_bwd_reference(q3: torch.Tensor, k3: torch.Tensor,
                                  v3: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, dout: torch.Tensor,
                                  causal: bool = False, block_k: int = 256,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """The FA2 backward over key blocks of ``block_k``: ``delta = Σ out·dO``
    (from ``out`` in f32), then per block ``P = exp(S - lse)``,
    ``dS = P (dO·Vᵀ - delta) scale``, ``dq += dS K``, ``dk = dSᵀ Q``,
    ``dv = Pᵀ dO``, all accumulated in f32 and returned in the input dtype.
    Runs on any device; it is what the kernel is held against."""
    bh, tq, d = q3.shape
    tk = k3.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bk = min(block_k, tk)
    qf, gf = q3.float(), dout.float()
    delta = (out.float() * gf).sum(dim=-1, keepdim=True)
    lse3 = lse[..., None]
    qpos = torch.arange(tq, device=q3.device)[:, None]
    dq = torch.zeros((bh, tq, d), device=q3.device)
    dks, dvs = [], []
    for j0 in range(0, tk, bk):
        kj = k3[:, j0:j0 + bk].float()
        vj = v3[:, j0:j0 + bk].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kj) * scale
        if causal:
            kpos = j0 + torch.arange(kj.shape[1], device=q3.device)[None, :]
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        p = torch.exp(s - lse3)
        dp = torch.einsum("bqd,bkd->bqk", gf, vj)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bqk,bkd->bqd", ds, kj)
        dks.append(torch.einsum("bqk,bqd->bkd", ds, qf))
        dvs.append(torch.einsum("bqk,bqd->bkd", p, gf))
    return (dq.to(q3.dtype), torch.cat(dks, dim=1).to(k3.dtype),
            torch.cat(dvs, dim=1).to(v3.dtype))


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


def _check_launch(*tensors: torch.Tensor) -> None:
    """What every kernel takes: f32 or bf16, D >= 1, one device,
    contiguous; raises before any build or launch otherwise."""
    q3 = tensors[0]
    if q3.dtype not in _BWD_ENTRIES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, "
                         f"not {q3.dtype}")
    d = q3.shape[-1]
    if d < 1:
        raise ValueError(f"the CUDA kernels take 1 <= D, not {d}")
    if any(x.device != q3.device for x in tensors):
        raise ValueError("the kernels' tensors must lie on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernels take contiguous [BH, T, D] "
                         "tensors")


def _pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns appended to the last dim up to ``width``:
    they add 0 to every q.k and make output columns that are cut off."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _kernel_head_dim(d: int, dtype: torch.dtype, tc_max: int) -> int:
    """The head dim a kernel is handed for a true ``d``: bf16 heads up to
    ``tc_max`` go to a tensor-core kernel, which copies rows in whole
    16-byte pieces, so they are padded to a multiple of 8; the scalar
    kernels load element by element and take any ``d``."""
    if dtype == torch.bfloat16 and d <= tc_max:
        return -(-d // 8) * 8
    return d


def _launch(q3, k3, v3, causal):
    _check_launch(q3, k3, v3)
    d = q3.shape[-1]
    width = _kernel_head_dim(d, q3.dtype, TC_MAX_HEAD_DIM)
    if width != d:
        q3, k3, v3 = (_pad_head_dim(x, width) for x in (q3, k3, v3))
    out, lse = _run_kernel(q3, k3, v3, causal, 1.0 / math.sqrt(d))
    if width != d:
        out = out[..., :d].contiguous()
    return out, lse


def _entry(source: str, entry: str, n_ptrs: int, n_ints: int):
    """The C entry point ``entry`` of ``csrc/<source>.cu`` (built at first
    use) and its library, with its argument types set: ``n_ptrs``
    pointers, ``n_ints`` ints, the scale (float) and the stream."""
    from . import _build
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:  # ints would cut 64-bit pointers
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _raise_on_error(lib, entry: str, err: int) -> None:
    if err != 0:
        es = lib.flash_attention_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({es(err).decode()})")


def _count(fn, source: str, by_design: dict, design: str) -> None:
    with _count_lock:
        fn.launches += 1
        KERNEL_LAUNCHES[source] += 1
        by_design[design] += 1


def _fwd_work_floats(lib, bh: int, tk: int, d: int) -> int:
    """The f32 workspace the f32 forward's design needs at these sizes
    (the 3xTF32 design's split parts of k and v: 2 x BH x (Tk +
    round8(Tk)) x round8(d) floats, 0 for the others), as the source
    counts it."""
    fn = lib.flash_attention_fwd_f32_work_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return int(fn(bh, tk, d))


def _run_kernel(q3, k3, v3, causal, scale):
    """Launch the forward kernel for the dtype and width of ``[BH, T,
    width]`` tensors with the softmax ``scale`` of the true head dim;
    counts the launch, and one of its design.  The f32 kernels take a
    workspace (the 3xTF32 design's split parts), allocated here."""
    source, entry = fwd_kernel(q3.dtype, q3.shape[-1])
    with_work = entry == _FWD_F32_ENTRY
    lib, fn = _entry(source, entry, 5 + with_work, 5)
    # the tensor-core kernels copy 16-byte pieces (cp.async, TMA): a view at
    # an odd offset is copied to fresh (aligned) storage first
    q3, k3, v3 = (x if x.data_ptr() % 16 == 0 else x.clone()
                  for x in (q3, k3, v3))
    bh, tq, d = q3.shape
    tk = k3.shape[1]
    out = torch.empty_like(q3)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q3.device)
    ptrs = [q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
            lse.data_ptr()]
    if with_work:
        floats = _fwd_work_floats(lib, bh, tk, d)
        work = torch.empty(floats, dtype=torch.float32, device=q3.device) \
            if floats else None
        ptrs.append(0 if work is None else work.data_ptr())
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, bh, tq, tk, d, int(bool(causal)), scale, stream)
    _raise_on_error(lib, entry, err)
    _count(flash_attention_fwd, source, FWD_LAUNCHES, fwd_design(q3.dtype, d))
    return out, lse


def _launch_bwd(q3, k3, v3, out, lse, dout, causal):
    _check_launch(q3, k3, v3, out, lse, dout)
    d = q3.shape[-1]
    width = _kernel_head_dim(d, q3.dtype, BWD_TC_MAX_HEAD_DIM)
    if width != d:
        q3, k3, v3, out, dout = (_pad_head_dim(x, width)
                                 for x in (q3, k3, v3, out, dout))
    grads = _run_bwd_kernel(q3, k3, v3, out, lse, dout, causal,
                            1.0 / math.sqrt(d))
    if width != d:
        grads = tuple(x[..., :d].contiguous() for x in grads)
    return grads


def _work_floats(lib, dtype: torch.dtype, bh: int, tq: int, tk: int,
                 d: int) -> int:
    """The f32 workspace the backward's design needs at these sizes (the
    3xTF32 design's split parts: 2 x BH x (2 Tq + 2 Tk + 2 round8(Tq) +
    round8(Tk)) x round8(d) floats, 0 for the others), as the source
    counts it."""
    fn = lib.flash_attention_bwd_work_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
    return int(fn(int(dtype == torch.bfloat16), bh, tq, tk, d))


def _run_bwd_kernel(q3, k3, v3, out, lse, dout, causal, scale):
    """Launch the backward kernel (delta, dK/dV, dQ; the 3xTF32 design's
    split pass first) on ``[BH, T, width]`` tensors with the softmax
    ``scale`` of the true head dim, on the current stream of the tensors'
    device; counts one launch, and one of its design."""
    entry = _BWD_ENTRIES[q3.dtype]
    lib, fn = _entry(BWD, entry, 11, 5)
    # the tensor-core paths copy 16-byte pieces (cp.async, TMA): a view at
    # an odd offset is copied to fresh (aligned) storage first
    q3, k3, v3, out, dout = (x if x.data_ptr() % 16 == 0 else x.clone()
                             for x in (q3, k3, v3, out, dout))
    bh, tq, d = q3.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q3, k3, v3))
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q3.device)
    floats = _work_floats(lib, q3.dtype, bh, tq, k3.shape[1], d)
    work = torch.empty(floats, dtype=torch.float32, device=q3.device) \
        if floats else None
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 0 if work is None else work.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, tq,
                 k3.shape[1], d, int(bool(causal)), scale, stream)
    _raise_on_error(lib, entry, err)
    _count(flash_attention_bwd, BWD, BWD_LAUNCHES, bwd_design(q3.dtype, d))
    return dq, dk, dv


def _on_cpu(q3: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one
    (the kernel); raises for any other device."""
    if q3.device.type == "cpu":
        return True
    if q3.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"not {q3.device.type}")
    return False


def flash_attention_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward over ``[BH, T, D]``: ``(out, lse)``.

    A CUDA tensor goes to its kernel (f32 or bf16, any BH, any D >= 1,
    contiguous), anything else raises; a CPU tensor takes
    the plain version.  ``flash_attention_fwd.launches`` counts kernel
    launches, ``KERNEL_LAUNCHES`` each kernel's, ``FWD_LAUNCHES`` each
    design's."""
    _check(q3, k3, v3)
    if _on_cpu(q3, "flash_attention_fwd"):
        return flash_attention_fwd_reference(q3, k3, v3, causal)
    return _launch(q3, k3, v3, causal)


flash_attention_fwd.launches = 0


def flash_attention_bwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """Flash-attention backward over ``[BH, T, D]``: ``(dq, dk, dv)`` in the
    input dtype, given the forward's ``out`` and ``lse`` and the output's
    gradient ``dout``.

    A CUDA tensor goes to ``csrc/flash_attention_bwd.cu`` (f32 or bf16,
    any BH, any D >= 1), anything else raises; a CPU tensor takes the
    plain version.  ``flash_attention_bwd.launches`` counts kernel launches
    (one per call: the kernel's three passes)."""
    _check(q3, k3, v3)
    if out.shape != q3.shape or dout.shape != q3.shape \
            or lse.shape != q3.shape[:2]:
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q3.shape)}")
    if _on_cpu(q3, "flash_attention_bwd"):
        return flash_attention_bwd_reference(q3, k3, v3, out, lse, dout,
                                             causal)
    if out.dtype != q3.dtype or dout.dtype != q3.dtype \
            or lse.dtype != torch.float32:
        raise ValueError("out and dout must have q's dtype, lse float32")
    return _launch_bwd(q3, k3, v3, out, lse, dout, causal)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attention_fwd`` with ``flash_attention_bwd`` as its
    gradient: the residuals are ``(q, k, v, out, lse)``, as in the JAX
    package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal):
        out, lse = flash_attention_fwd(q3, k3, v3, causal)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q3, k3, v3, out, lse = ctx.saved_tensors
        # the permute in flash_attention makes dout a strided view
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention over ``[B, T, H, D]`` tensors (softmax scale
    ``1/sqrt(D)``); matches :func:`mha_reference`.  Differentiable: where a
    gradient is wanted it runs through ``_FlashAttention``, whose backward
    is the flash backward (the kernel on the card)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    # contiguous(): at B == 1 the reshape alone is a strided view
    q3 = q.permute(0, 2, 1, 3).reshape(b * h, tq, d).contiguous()
    k3 = k.permute(0, 2, 1, 3).reshape(b * h, tk, d).contiguous()
    v3 = v.permute(0, 2, 1, 3).reshape(b * h, tk, d).contiguous()
    if torch.is_grad_enabled() and (q3.requires_grad or k3.requires_grad
                                    or v3.requires_grad):
        out = _FlashAttention.apply(q3, k3, v3, causal)
    else:
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
