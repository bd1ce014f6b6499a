"""On the card (``cuda`` marker, skipped without one; no JAX here): the
single-device knobs' card-only facts.

- A NaN reaches the same outputs through the kernels as through their
  plain versions: the flash forward's lse of a NaN row (the kernels'
  ``max(l, 1e-30)`` once dropped the NaN through ``fmaxf`` and left a
  finite lse) in both dtypes, and batch norm's variance of a channel
  with a NaN (its ``max(var, 0)`` read 0) in both dtypes.
- ``nan_policy="skip_step"`` from CUDA graphs: a poisoned step is a
  replay (no new capture), counts on the card, and leaves a LAMB BERT's
  parameters and state equal, bit for bit, to the run without it.
"""

import importlib

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.core import faults
from analytics_zoo_tpu_torch.orca.learn import Estimator


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and CUDA graphs run "
                    "there")


def _same_nonfinite(got, want):
    for g, w in zip(got, want):
        assert torch.equal(~torch.isfinite(g.float()),
                           ~torch.isfinite(w.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_keeps_a_nan_row_in_lse(dtype, d):
    _card()
    fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(8, 200, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    q[3, 17] = float("nan")
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_fwd_reference(q, k, v)
    _same_nonfinite(got, want)
    assert torch.isnan(got[1][3, 17]) and torch.isfinite(got[1][3, 16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_norm_keeps_a_nan_channel_in_var(dtype):
    _card()
    bn = importlib.import_module("analytics_zoo_tpu_torch.ops.fused_bn")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4096, 64, generator=gen, device="cuda").to(dtype)
    x[100, 5] = float("nan")
    g, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    got = bn.bn_train_fwd(x, g, b, 1e-3)
    _same_nonfinite(got, bn.bn_train_fwd_reference(x, g, b, 1e-3))
    assert torch.isnan(got[2][5]) and torch.isfinite(got[2][4])


class _Tiny(torch.nn.Module):
    """Embedding, one flash Transformer block in bf16 and a head."""

    def __init__(self):
        super().__init__()
        from analytics_zoo_tpu_torch import nn as tnn
        self.tok = tnn.Embedding(100, 64)
        self.block = tnn.TransformerLayer(64, 4, use_flash=True)
        self.head = tnn.Dense(64, 100)

    def forward(self, x):
        return self.head(self.block(self.tok(x).to(torch.bfloat16)).float())


@pytest.mark.cuda
def test_skip_step_graph_replays_a_poisoned_step_bit_for_bit():
    """The loss is made NaN for step 2 (token ids are integer leaves,
    which ``step.nan`` leaves alone): one capture, bad_steps 1 on the
    card, and the state equals a run over the other batches."""
    _card()
    torch.manual_seed(0)
    init = _Tiny().state_dict()
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (4 * 8, 32)).astype(np.int32)
    y = rng.integers(0, 100, (4 * 8, 32)).astype(np.int32)
    batches = [{"x": torch.from_numpy(x[i * 8:(i + 1) * 8]).cuda(),
                "y": torch.from_numpy(y[i * 8:(i + 1) * 8]).cuda()}
               for i in range(4)]

    def make():
        m = _Tiny()
        m.load_state_dict(init)
        return Estimator.from_keras(
            m, loss="sparse_categorical_crossentropy", optimizer="lamb",
            learning_rate=1e-3, nan_policy="skip_step")

    poisoned, clean = make(), make()
    scale = torch.ones((), device="cuda")
    loss_fn = poisoned.loss_fn
    poisoned.loss_fn = lambda out, yb: loss_fn(out, yb) * scale
    for i, b in enumerate(batches):
        scale.fill_(float("nan") if i == 2 else 1.0)
        poisoned._train_step(b)
        if i != 2:
            clean._train_step(b)
    assert poisoned.capture_count == 1
    assert int(poisoned._bad_steps) == 1 and int(clean._bad_steps) == 0
    for a, b in zip(poisoned.model.state_dict().values(),
                    clean.model.state_dict().values()):
        assert torch.equal(a, b)
    from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
    ts_a = poisoned._save_tree()["opt_state"]
    ts_b = clean._save_tree()["opt_state"]
    assert ckpt_io.leaf_paths(ts_a) == ckpt_io.leaf_paths(ts_b)
    for a, b in zip(ckpt_io.flatten(ts_a)[0], ckpt_io.flatten(ts_b)[0]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert int(ts_a["count"]) == int(ts_b["count"]) == 3
    assert faults.get_registry().armed_points() == []
