"""On the card (``cuda`` marker, skipped without one; no JAX here): the
recommenders' train steps from CUDA graphs against the eager steps, bit
for bit (a ShardedEmbedding ``NeuralCF`` on the sparse path and the
replicated one), the static-size unique, the deduped lookup and its row
gradient on the card against the CPU,
and the dense attention core's bf16 logits on the tensor cores
(``aten::bmm.dtype``) against the upcast path it replaced.

Tolerances: the unique and the lookup exactly (integer ops and gathers);
the row gradient at 1e-5 of max |ref| against the CPU (the sums' order
differs) and bit for bit from one run on the card to the next;
attention: the logits' products are exact in f32 on both paths and only
their summation order differs, so the output and the q, k, v gradients
(each rounded to bf16 on both paths) are held to 2^-7 of each tensor's
max |ref|, two bf16 steps.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import dot_product_attention
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.parallel import embedding as emb

LOSS = "sparse_categorical_crossentropy"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the card's kernels "
                    "run there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _ratings(n, users, items, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, users, n),
                  rng.integers(0, items, n)], 1).astype(np.int32)
    return x, (rng.random(n) < 0.5).astype(np.int32)


def _fit(state, kw, graphs, x, y, **ekw):
    model = NeuralCF(**kw)
    model.load_state_dict(state)
    est = Estimator.from_keras(model, loss=LOSS, optimizer="adam",
                               learning_rate=1e-2, cuda_graphs=graphs,
                               seed=3, **ekw)
    losses, inner = [], est._train_step

    def step(batch):
        loss = inner(batch)
        losses.append(loss.clone())
        return loss

    est._train_step = step
    hist = est.fit((x, y), epochs=3, batch_size=256, verbose=False)
    return est, [float(v) for v in losses], hist


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [True, False])
def test_captured_ncf_fit_equals_eager_bit_for_bit(sharded):
    """3 epochs: the same step losses and the same weights from one
    capture as from the eager step; no table ever holds ``.grad``."""
    _card()
    kw = dict(user_count=997, item_count=313, class_num=2,
              hidden_layers=(16, 8), sharded_embeddings=sharded)
    x, y = _ratings(256 * 5, 997, 313, 1)
    state = NeuralCF(**kw).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    cap, cap_losses, cap_hist = _fit(state, kw, True, x, y,
                                     embedding_lr=0.05 if sharded else None)
    eag, eag_losses, eag_hist = _fit(state, kw, False, x, y,
                                     embedding_lr=0.05 if sharded else None)
    assert cap.capture_count == 1 and eag.capture_count == 0
    assert cap_losses == eag_losses and cap_hist == eag_hist
    assert cap_hist["loss"][-1] < cap_hist["loss"][0]
    for (k, a), b in zip(cap.model.state_dict().items(),
                         eag.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert len(cap._sparse) == (4 if sharded else 0)
    assert all(p.grad is None for p in cap.model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("n,hi,size", [(2048, 5000, None), (2048, 7, None),
                                       (300, 50, 20)])
def test_static_unique_and_lookup_on_the_card_equal_the_cpu(n, hi, size):
    _card()
    rng = np.random.default_rng(n + hi)
    ids = torch.from_numpy(rng.integers(-1, hi, (n // 4, 4)))
    table = torch.from_numpy(rng.normal(size=(hi, 16)).astype(np.float32))
    flat = ids.clamp(min=0).reshape(-1)
    cpu = emb.static_unique(flat, size or n)
    card = emb.static_unique(flat.cuda(), size or n)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    for comb in (None, "sum", "mean"):
        got = emb.dedup_lookup(table.cuda(), ids.cuda(), comb, size).cpu()
        want = emb.dedup_lookup(table, ids, comb, size)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6,
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hi", [(2048, 5000), (2048, 7), (16384, 300)])
def test_row_gradient_is_deterministic_on_the_card(n, hi):
    """Under ``inject_taps`` the unique rows' gradient runs under
    ``torch.use_deterministic_algorithms`` and repeats to the bit; it
    matches the CPU's."""
    _card()
    rng = np.random.default_rng(n + hi)
    ids = torch.from_numpy(rng.integers(-1, hi, (n // 4, 4)))
    table = torch.from_numpy(rng.normal(size=(hi, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n // 4, 16)).astype(np.float32))

    def row_grad(device):
        with emb.inject_taps() as taps:
            out = emb.dedup_lookup(table.to(device), ids.to(device), "sum")
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            (d,) = torch.autograd.grad(out, [taps[0].rows], g.to(device))
        finally:
            torch.use_deterministic_algorithms(prev)
        return d.cpu()

    card = [row_grad("cuda") for _ in range(3)]
    assert all(torch.equal(card[0], c) for c in card[1:])
    want = row_grad("cpu")
    torch.testing.assert_close(card[0], want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 12, 64), (3, 37, 2, 24)])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_attention_logits_on_the_tensor_cores(shape, masked):
    """The forward runs ``aten::bmm.dtype`` on the bf16 operands (no copy
    of q or k to f32); its output and gradients match the upcast path on
    the same inputs."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    b, t, h, d = shape
    q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                  .bfloat16() for _ in range(4))
    mask = (torch.rand((b, 1, t, t), device="cuda", generator=gen) < 0.7
            if masked else None)

    def upcast(q, k, v):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits / d ** 0.5
        if mask is not None:
            logits = torch.where(mask, logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    outs = {}
    for name, fn in (("tensor_cores", lambda a, c, e:
                      dot_product_attention(a, c, e, mask)),
                     ("upcast", upcast)):
        args = [a.clone().requires_grad_() for a in (q, k, v)]
        with _Ops() as ops:
            out = fn(*args)
        out.backward(g)
        outs[name] = [out] + [a.grad for a in args]
        if name == "tensor_cores":
            assert "aten.bmm.dtype" in ops.names, ops.names
            assert out.dtype == torch.bfloat16
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               outs["tensor_cores"], outs["upcast"]):
        want = want.detach().float()
        torch.testing.assert_close(
            got.detach().float(), want, rtol=0,
            atol=2.0 ** -7 * float(want.abs().max()), msg=name)
