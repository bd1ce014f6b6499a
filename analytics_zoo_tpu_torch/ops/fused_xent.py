"""Fused softmax cross-entropy over a vocabulary head: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Port of ``analytics_zoo_tpu/ops/fused_xent.py``.  The TPU package runs
``fused_softmax_xent`` as a ``jax.custom_vjp`` (``_fused``) that never
materialises the ``[tokens, vocab]`` logits: the forward scans token
chunks, computes each chunk's f32 logits ``h @ W + b``, and keeps one f32
logsumexp per token; the backward recomputes each chunk's logits, forms
``softmax - onehot`` scaled by ``g / n``, rounds it to the activation dtype
for the two gradient products (``dh = dl @ W^T``, ``dW += h^T @ dl``) and
sums db from the f32 values.  Here, for a tensor on the card:

- ``fused_xent_fwd`` launches ``csrc/fused_xent.cu``'s forward (the logit
  tiles' max, sum of exponentials and label logit, combined per token into
  the logsumexp and the mean loss; the logits are never written): bf16
  activations on ``wgmma`` (the backward's dl main loop), f32 on scalar
  FMAs; ``fwd_design`` names the design;
- ``fused_xent_bwd`` launches its backward over every token: the ``dl``
  pass into a ``[tokens, vocab]`` workspace, ``dh`` split over the
  vocabulary, ``dW`` with its f32 sum kept on chip from the first token to
  the last, then db.  bf16 activations run all three products on
  ``wgmma``; f32 activations run the ``dl`` pass's logits on scalar f32
  FMAs (in the forward's summation order: dl = exp(S - lse) needs S to its
  last bits, see ``csrc/fused_xent.cu``) and ``dh`` and ``dW`` on ``wgmma``
  in 3xTF32 (three tf32 products per f32 product);
- ``fused_softmax_xent`` ties them together in a
  ``torch.autograd.Function`` whose residuals are ``(h, w, bias, labels,
  lse)``, as the ``custom_vjp``'s are, plus the forward's bf16 copy of W
  where it made one, which the backward then reads instead of packing W
  again.

bf16 activations run on the tensor cores (both directions on ``wgmma``
fed by TMA); f32 activations' forward and logits on scalar f32 FMAs
(exact f32 products, as JAX's f32 dot), their dh and dW on ``wgmma`` in
3xTF32; ``fwd_design`` and ``bwd_design`` name the designs.  For a
tensor on the CPU the wrappers use
``fused_xent_reference`` and ``fused_xent_bwd_reference``, which repeat
the JAX op's chunked math step by step.  There is no fallback from the card to the plain versions: a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Tuple

import torch

SOURCE = "fused_xent"  # csrc/<source>.cu
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
PASSES = ("fwd", "dl", "dh", "dw")
# calls of each pass by activation dtype ("fwd_bf16", ...): one forward
# entry call counts "fwd" (its pack, tile, finalize and mean kernels); one
# backward entry call counts "dl", "dh" and "dw" once each
KERNEL_LAUNCHES = {f"{p}_{s}": 0 for s in _SUFFIX.values() for p in PASSES}
_count_lock = threading.Lock()
TILE = 128            # the kernels' output tile, rows and columns
# each direction's designs, in the order of the source's FwdDesign and
# BwdDesign; FWD_LAUNCHES and BWD_LAUNCHES count each direction's entry
# calls by design
FWD_DESIGNS = ("wgmma", "scalar")
FWD_LAUNCHES = dict.fromkeys(FWD_DESIGNS, 0)
BWD_DESIGNS = ("wgmma", "wgmma_tf32")
BWD_LAUNCHES = dict.fromkeys(BWD_DESIGNS, 0)
WG_BK = 64            # the wgmma design's k slice: its dh splits' step
# the wgmma dh's splits: four waves of two blocks on each of 132 SMs
WG_TARGET_BLOCKS = 4 * 2 * 132
TF_BK = 64            # the wgmma_tf32 design's k slice
# ... and its dh's splits: eight waves of one block on each of 132 SMs
# (at the recipe 96 tiles x 11 splits fill them exactly)
TF_TARGET_BLOCKS = 8 * 132


def _flatten(h: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return h.reshape(-1, h.shape[-1]), labels.reshape(-1)


def _check(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           labels: torch.Tensor, chunk: int) -> int:
    """The token count; raises as the JAX op does for a chunk that does
    not divide it, and for shapes that do not fit together."""
    d = h.shape[-1]
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w must be [{d}, V], not {tuple(w.shape)}")
    if bias.shape != (w.shape[1],):
        raise ValueError(f"bias must be [{w.shape[1]}], not "
                         f"{tuple(bias.shape)}")
    if tuple(labels.shape) != tuple(h.shape[:-1]):
        raise ValueError(f"labels {tuple(labels.shape)} do not match h's "
                         f"leading dims {tuple(h.shape[:-1])}")
    n = math.prod(h.shape[:-1])
    if chunk < 1 or n % chunk:
        raise ValueError(f"token count {n} not divisible by chunk={chunk}")
    return n


# -- the plain versions -------------------------------------------------------

def fused_xent_reference(h: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, labels: torch.Tensor,
                         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``: the JAX op's ``_fused_fwd_impl``.  Per chunk of
    tokens, the f32 logits ``h_c @ w.to(h.dtype) + bias`` (products of the
    activation-dtype values summed in f32), their logsumexp and the label's
    logit; the loss is the sum of ``lse - logit[label]`` over the chunks
    divided by the token count.  Runs on any device; it is what the kernels
    are held against."""
    n = _check(h, w, bias, labels, chunk)
    hf, lf = _flatten(h, labels)
    wt = w.to(hf.dtype).float()
    bf = bias.float()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    lses = []
    for c0 in range(0, n, chunk):
        logits = hf[c0:c0 + chunk].float() @ wt + bf
        lse = torch.logsumexp(logits, dim=-1)
        corr = logits.gather(1, lf[c0:c0 + chunk, None].long())[:, 0]
        total = total + (lse - corr).sum()
        lses.append(lse)
    return total / n, torch.cat(lses)


def fused_xent_bwd_reference(h: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor, labels: torch.Tensor,
                             lse: torch.Tensor, g: torch.Tensor, chunk: int
                             ) -> Tuple[torch.Tensor, ...]:
    """``(dh, dw, db)``: the JAX op's ``_fused_bwd``.  Per chunk, the
    recomputed f32 logits give ``dl = exp(logits - lse) * (g / n)`` less
    ``g / n`` at the label; ``dl`` rounded to h's dtype feeds ``dh_c = dl @
    W^T`` (in h's dtype) and ``dW += h_c^T @ dl`` (f32), and db sums the f32
    ``dl``.  dW and db come back in w's and bias's dtypes.  Runs on any
    device."""
    n = _check(h, w, bias, labels, chunk)
    hf, lf = _flatten(h, labels)
    d, v = hf.shape[1], w.shape[1]
    scale = (g.float() / n).reshape(())
    wt = w.to(hf.dtype).float()
    bf = bias.float()
    dw = torch.zeros(d, v, dtype=torch.float32, device=h.device)
    db = torch.zeros(v, dtype=torch.float32, device=h.device)
    rows = torch.arange(chunk, device=h.device)
    dh = []
    for c0 in range(0, n, chunk):
        hc = hf[c0:c0 + chunk]
        logits = hc.float() @ wt + bf
        dl = torch.exp(logits - lse[c0:c0 + chunk, None]) * scale
        dl[rows, lf[c0:c0 + chunk].long()] += -scale
        dlb = dl.to(hf.dtype).float()
        dh.append((dlb @ wt.T).to(hf.dtype))
        dw = dw + hc.float().T @ dlb
        db = db + dl.sum(dim=0)
    return (torch.cat(dh).reshape(h.shape), dw.to(w.dtype),
            db.to(bias.dtype))


# -- the kernels --------------------------------------------------------------

def _on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one
    (the kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    return False


def _check_launch(h: torch.Tensor, *others: torch.Tensor) -> None:
    if h.dtype not in _SUFFIX:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16 "
                         f"activations, not {h.dtype}")
    if any(t.device != h.device for t in others):
        raise ValueError("the kernels' tensors must lie on one device")


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _tiles(x: int) -> int:
    return -(-x // TILE)


class BwdPlan(NamedTuple):
    """The backward's grids: ``TILE``-square output tiles over
    tokens (``row_tiles``), D (``d_tiles``) and V (``v_tiles``); dh's
    vocabulary (K, padded to ``vp``) in ``splits`` ranges of ``split_len``
    columns."""
    row_tiles: int
    d_tiles: int
    v_tiles: int
    vp: int
    splits: int
    split_len: int


def bwd_plan(n: int, d: int, v: int, design: str = "wgmma") -> BwdPlan:
    """The grids of the backward's ``design`` at ``n`` tokens, width
    ``d`` and vocabulary ``v``: the dl pass ``row_tiles x v_tiles``
    blocks, dW ``d_tiles x v_tiles``, dh ``d_tiles x row_tiles x splits``,
    with enough splits of whole k slices (``WG_BK`` for ``wgmma``,
    ``TF_BK`` for ``wgmma_tf32``) to make about ``WG_TARGET_BLOCKS`` (two
    blocks an SM) or ``TF_TARGET_BLOCKS`` (one) blocks and no split empty:
    at the recipe's 2048 x 768 -> 30,522, 96 tiles x 11 splits of 2,816
    columns (both designs)."""
    step, target = ((WG_BK, WG_TARGET_BLOCKS) if design == "wgmma"
                    else (TF_BK, TF_TARGET_BLOCKS))
    vp = _round8(v)
    tiles = _tiles(n) * _tiles(d)
    steps = -(-vp // step)
    per_split = -(-steps // min(steps, -(-target // tiles)))
    return BwdPlan(_tiles(n), _tiles(d), _tiles(v), vp,
                   -(-steps // per_split), per_split * step)


def fwd_design(dtype: torch.dtype) -> str:
    """The design of ``csrc/fused_xent.cu``'s forward for activations in
    ``dtype``: one of ``FWD_DESIGNS`` (bf16 ``wgmma``, f32 ``scalar``).
    Mirrors the source's ``fwd_design``; a ``cuda`` test holds the two
    together."""
    return "wgmma" if dtype == torch.bfloat16 else "scalar"


def bwd_design(dtype: torch.dtype) -> str:
    """The design of ``csrc/fused_xent.cu``'s backward for activations in
    ``dtype``: one of ``BWD_DESIGNS`` (bf16 ``wgmma``, f32
    ``wgmma_tf32``).  Mirrors the source's ``bwd_design``; a ``cuda`` test
    holds the two together."""
    return "wgmma" if dtype == torch.bfloat16 else "wgmma_tf32"


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


class _Operands:
    """The products' operands on the card.  The bf16 tensor-core route
    copies its operands with TMA and wants each row a whole number of 16
    bytes: ``w`` in f32, or with a width V that is not a multiple of 8, is
    cast into a bf16 ``[D, round8(V)]`` copy ``wp`` by the pack kernel (one
    pass per call, unless ``w_packed``, the forward's copy of the same W,
    is given: then ``wp`` is that copy and ``packed`` says so); ``h``
    likewise when D is not a multiple of 8.  The f32 route's scalar loops
    read any width and any dtype of ``w``; its backward's split passes
    write ``wp``, W's tf32 parts ``[2, D, round8(V)]``, and ``ht``, h's
    transposed ``[2, D, round8(N)]`` (``with_parts``)."""

    def __init__(self, h2: torch.Tensor, w: torch.Tensor,
                 with_parts: bool = False,
                 w_packed: Optional[torch.Tensor] = None):
        n, d = h2.shape
        v = w.shape[1]
        self.tc = h2.dtype == torch.bfloat16
        self.h = h2.contiguous()
        self.w = w.contiguous()
        self.hp = self.wp = self.ht = None
        if with_parts and not self.tc:
            self.wp = torch.empty(2, d, _round8(v), dtype=torch.float32,
                                  device=h2.device)
            self.ht = torch.empty(2, d, _round8(n), dtype=torch.float32,
                                  device=h2.device)
        self.dp, self.vp = (_round8(d), _round8(v)) if self.tc else (d, v)
        self.packed = False
        if self.tc:
            if w_packed is not None:
                self.wp, self.packed = w_packed, True
            elif not (self.w.dtype == torch.bfloat16 and v % 8 == 0
                      and _aligned(self.w)):
                self.wp = torch.empty(d, self.vp, dtype=torch.bfloat16,
                                      device=h2.device)
            if not (d % 8 == 0 and _aligned(self.h)):
                self.hp = torch.empty(n, self.dp, dtype=torch.bfloat16,
                                      device=h2.device)

    @staticmethod
    def ptr(t: Optional[torch.Tensor]) -> int:
        return 0 if t is None else t.data_ptr()


def _entry(name: str):
    """The C entry point ``fused_xent_<name>`` (built at first use) and its
    library, with its argument types set."""
    from . import _build
    lib = _build.load(SOURCE)
    fn = getattr(lib, f"fused_xent_{name}")
    if fn.argtypes is None:  # ints would cut 64-bit pointers
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            # tc, w_bf16; h, hp, w, wp, bias, labels; n, d, v;
            # part, lse, loss_tok, loss; stream
            "fwd": [i, i] + [p] * 6 + [i] * 3 + [p] * 4 + [p],
            # tc, w_bf16; h, hp, w, wp; w_packed; bias, labels, lse, g; n,
            # d, v, splits, split_len; dl, dbp, dh_part, ht, dh, dw, db;
            # stream
            "bwd": [i, i] + [p] * 4 + [i] + [p] * 4 + [i] * 5 + [p] * 7
            + [p],
        }[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _raise_on_error(lib, entry: str, err: int) -> None:
    if err != 0:
        es = lib.fused_xent_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({es(err).decode()})")


def _count(fn, by_design: dict, design: str, *names: str) -> None:
    with _count_lock:
        fn.launches += 1
        for name in names:
            KERNEL_LAUNCHES[name] += 1
        by_design[design] += 1


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _labels(labels: torch.Tensor) -> torch.Tensor:
    return labels.reshape(-1).long().contiguous()


def _launch_fwd(h2, w, bias, labels):
    """(loss, lse, the bf16 copy of W the forward packed, or None)."""
    _check_launch(h2, w, bias, labels)
    n, d = h2.shape
    v = w.shape[1]
    ops = _Operands(h2, w)
    dev = h2.device
    part = torch.empty(3 * _tiles(v) * n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    loss_tok = torch.empty_like(lse)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    bias, labels = _f32(bias), _labels(labels)
    lib, fn = _entry("fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(ops.tc), int(ops.w.dtype == torch.bfloat16),
                 ops.h.data_ptr(), ops.ptr(ops.hp), ops.w.data_ptr(),
                 ops.ptr(ops.wp), bias.data_ptr(), labels.data_ptr(), n, d,
                 v, part.data_ptr(), lse.data_ptr(), loss_tok.data_ptr(),
                 loss.data_ptr(), stream)
    _raise_on_error(lib, "fused_xent forward", err)
    _count(fused_xent_fwd, FWD_LAUNCHES, fwd_design(h2.dtype),
           f"fwd_{_SUFFIX[h2.dtype]}")
    return loss, lse, ops.wp if ops.tc else None


def _launch_bwd(h2, w, bias, labels, lse, g, w_packed=None):
    _check_launch(h2, w, bias, labels, lse, g)
    n, d = h2.shape
    v = w.shape[1]
    ops = _Operands(h2, w, with_parts=True, w_packed=w_packed)
    dev = h2.device
    design = bwd_design(h2.dtype)
    plan = bwd_plan(n, d, v, design)
    dl = torch.empty(n, plan.vp, dtype=h2.dtype, device=dev)
    dbp = torch.empty(plan.row_tiles * v, dtype=torch.float32, device=dev)
    dh_part = torch.empty(plan.splits * n * d, dtype=torch.float32,
                          device=dev)
    dh = torch.empty(n, d, dtype=h2.dtype, device=dev)
    dw = torch.empty(d, v, dtype=w.dtype, device=dev)
    db = torch.empty(v, dtype=torch.float32, device=dev)
    bias_f, labels = _f32(bias), _labels(labels)
    lse, g = lse.contiguous(), _f32(g).reshape(1)
    lib, fn = _entry("bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(ops.tc), int(ops.w.dtype == torch.bfloat16),
                 ops.h.data_ptr(), ops.ptr(ops.hp), ops.w.data_ptr(),
                 ops.ptr(ops.wp), int(ops.packed), bias_f.data_ptr(),
                 labels.data_ptr(), lse.data_ptr(), g.data_ptr(), n, d, v,
                 plan.splits, plan.split_len, dl.data_ptr(), dbp.data_ptr(),
                 dh_part.data_ptr(), ops.ptr(ops.ht), dh.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), stream)
    _raise_on_error(lib, "fused_xent backward", err)
    sfx = _SUFFIX[h2.dtype]
    _count(fused_xent_bwd, BWD_LAUNCHES, design, f"dl_{sfx}", f"dh_{sfx}",
           f"dw_{sfx}")
    return dh, dw, db.to(bias.dtype)


def fused_xent_fwd(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   labels: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``: the mean softmax cross-entropy of ``h @ w + bias``
    against ``labels`` (f32 scalar) and the per-token f32 logsumexp
    (``[tokens]``).

    A CUDA tensor goes to ``csrc/fused_xent.cu`` (bf16 on the tensor cores,
    f32 on scalar FMAs; any token count, width and vocabulary), anything
    else raises; a CPU tensor takes the plain version.
    ``fused_xent_fwd.launches`` counts calls that launched the kernels,
    ``FWD_LAUNCHES`` calls by design."""
    return _fwd(h, w, bias, labels, chunk)[:2]


def _fwd(h, w, bias, labels, chunk):
    """``fused_xent_fwd``'s ``(loss, lse)`` and the bf16 copy of W its
    kernels packed (None on the CPU, for f32 activations and where W was
    read as given), which ``fused_xent_bwd`` takes as ``w_packed``."""
    _check(h, w, bias, labels, chunk)
    if _on_cpu(h, "fused_xent_fwd"):
        return fused_xent_reference(h, w, bias, labels, chunk) + (None,)
    hf, lf = _flatten(h, labels)
    return _launch_fwd(hf, w, bias, lf)


fused_xent_fwd.launches = 0


def fused_xent_bwd(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   chunk: int, w_packed: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """``(dh in h's dtype and shape, dw in w's dtype, db in bias's dtype)``
    from the forward's ``lse`` and the loss's cotangent ``g``; ``w_packed``,
    the bf16 copy of this W that the forward's kernels packed (``_fwd``),
    spares the backward its own pack of W (the same bits either way).

    A CUDA tensor goes to ``csrc/fused_xent.cu``, anything else raises; a
    CPU tensor takes the plain version.  ``fused_xent_bwd.launches`` counts
    calls that launched the kernels.

    Workspace on the card, from ``torch.empty`` on the current stream
    (the call does not synchronise), over every token: ``dl`` ``[tokens,
    round8(V)]`` in h's dtype (125 MB bf16 at the recipe's 2048 x 30,522,
    250 MB f32), dh's f32 partials ``[splits, tokens, D]`` (``bwd_plan``:
    69 MB bf16, 38 MB f32), db's per-tile sums; bf16 (``wgmma``): a bf16
    copy of W when W is f32 or V is not a multiple of 8 (47 MB); f32
    (``wgmma_tf32``): W's tf32 parts (188 MB) and h's transposed (13 MB).
    The bf16 copy of W is ``w_packed`` where one is given.
    ``chunk`` shapes none of it (only dW's f32 summation order differs
    from the plain version's).  ``BWD_LAUNCHES`` counts calls by design."""
    _check(h, w, bias, labels, chunk)
    if _on_cpu(h, "fused_xent_bwd"):
        return fused_xent_bwd_reference(h, w, bias, labels, lse, g, chunk)
    hf, lf = _flatten(h, labels)
    dh, dw, db = _launch_bwd(hf, w, bias, lf, lse, g, w_packed)
    return dh.reshape(h.shape), dw, db


fused_xent_bwd.launches = 0


class _FusedXent(torch.autograd.Function):
    """``fused_xent_fwd`` with ``fused_xent_bwd`` as its gradient; residuals
    ``(h, w, bias, labels, lse)``, as the JAX package's ``custom_vjp``, and
    the forward's bf16 copy of W (``w_packed``), which the backward reads
    and then drops."""

    @staticmethod
    def forward(ctx, h, w, bias, labels, chunk):
        loss, lse, ctx.w_packed = _fwd(h, w, bias, labels, chunk)
        ctx.save_for_backward(h, w, bias, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, w, bias, labels, lse = ctx.saved_tensors
        w_packed, ctx.w_packed = ctx.w_packed, None
        dh, dw, db = fused_xent_bwd(h, w, bias, labels, lse, g, ctx.chunk,
                                    w_packed)
        return dh, dw, db, None, None


def fused_softmax_xent(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, chunk: int = 512,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(h @ w + bias)`` against integer
    labels, without the ``[tokens, vocab]`` logits (the JAX package's
    signature and arithmetic).

    h: ``[..., D]`` activations (bf16/f32); w: ``[D, V]`` head kernel, cast
    to h's dtype for the products; labels: integers in ``[0, V)`` shaped as
    h's leading dims; bias: optional ``[V]`` (``None``: f32 zeros).
    ``chunk`` must divide the flattened token count.  Differentiable in h,
    w and bias; on the card both directions run in
    ``csrc/fused_xent.cu``."""
    if bias is None:
        bias = torch.zeros(w.shape[1], dtype=torch.float32, device=w.device)
    return _FusedXent.apply(h, w, bias, labels, int(chunk))


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    with _count_lock:
        fused_xent_fwd.launches = fused_xent_bwd.launches = 0
        for counts in (KERNEL_LAUNCHES, FWD_LAUNCHES, BWD_LAUNCHES):
            for name in counts:
                counts[name] = 0


__all__ = ["fused_softmax_xent", "fused_xent_fwd", "fused_xent_bwd",
           "fused_xent_reference", "fused_xent_bwd_reference",
           "KERNEL_LAUNCHES", "FWD_LAUNCHES", "BWD_LAUNCHES",
           "reset_launches", "fwd_design", "bwd_design", "bwd_plan"]
