"""The port's AOT seam against the JAX package on the CPU: twins of the JAX
package's executable tests (``tests/test_serving.py`` round trip, no
per-call rebuild, stale model code; ``tests/test_scheduler.py``
``warm_from`` re-bucketing and artifacts across versions).  The same calls
go to the JAX ``InferenceModel`` and to the port's, and their
``compile_count`` and prepared key sets (``_compiled``) must be equal.  On
the CPU a key is prepared by one eager forward; on the card by a CUDA graph
capture (the ``cuda`` tests, which skip here: replay against eager, the
launch counts of replays, a capture that fails, ``_int_mm``'s padding).
Outputs: 1e-5 of max(1, max |ref|) (f32, another summation order) where
the two packages are compared, bit for bit where the port is compared
with itself.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.serving.inference_model import \
    InferenceModel as JaxInferenceModel
import analytics_zoo_tpu_torch.models as port_models
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.nn import quant
from analytics_zoo_tpu_torch.ops import _build, _launches
from analytics_zoo_tpu_torch.serving import InferenceModel, enable_aot_cache

fa = importlib.import_module("analytics_zoo_tpu_torch.ops.flash_attention")
TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(act="relu", hidden=32, d_in=8, d_out=4):
    jm = jnn.Sequential([jnn.Dense(hidden, activation=act), jnn.Dense(d_out)])
    pm = tnn.Sequential([tnn.Dense(d_in, hidden, act),
                         tnn.Dense(hidden, d_out)])
    return jm, pm


def _fc_pair():
    """``tests/test_scheduler.py``'s ``M``: one Dense(3) named ``fc``."""
    class M(jnn.Module):
        def forward(self, scope, x):
            return scope.child(jnn.Dense(3), x, name="fc")

    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Dense(4, 3)

        def forward(self, x):
            return self.fc(x)

    return M(), P


def _same_keys(port_im, jax_im):
    assert set(port_im._compiled) == set(jax_im._compiled)
    assert port_im.compile_count == jax_im.compile_count


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL * max(
        1.0, float(np.abs(want).max())), rtol=0)


def test_save_load_executables_roundtrip(tmp_path):
    """A fresh model loads the manifest and prepares its key without a
    fresh compile; a different precision ignores it (JAX's counts too)."""
    jm, pm = _pair()
    x = np.random.default_rng(9).normal(size=(4, 8)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jsrc = JaxInferenceModel().load(jm, variables)
    src = InferenceModel(device="cpu").load(pm, variables)
    want = np.asarray(jsrc.predict(x))
    _close(src.predict(x), want)
    _same_keys(src, jsrc)
    assert src.save_executables(str(tmp_path / "aot")) \
        == jsrc.save_executables(str(tmp_path / "jax_aot")) == 1
    manifest = json.loads((tmp_path / "aot" / "manifest.json").read_text())
    assert manifest["keys"] == [{"shape": [4, 8], "dtype": "float32",
                                 "hash": src._computation_hash((4, 8),
                                                               "float32")}]

    _, pm2 = _pair()
    dst = InferenceModel(device="cpu").load(pm2, variables)
    jdst = JaxInferenceModel().load(jm, variables)
    assert dst.load_executables(str(tmp_path / "aot")) \
        == jdst.load_executables(str(tmp_path / "jax_aot")) == 1
    _same_keys(dst, jdst)
    _close(dst.predict(x), want)
    _same_keys(dst, jdst)

    _, pm3 = _pair()
    other = InferenceModel(device="cpu").load(pm3, variables,
                                              dtype=torch.bfloat16)
    jother = JaxInferenceModel().load(jm, variables, dtype=jnp.bfloat16)
    assert other.load_executables(str(tmp_path / "aot")) \
        == jother.load_executables(str(tmp_path / "jax_aot")) == 0
    assert other.predict(x).shape == want.shape
    jother.predict(x)
    _same_keys(other, jother)


def test_load_executables_prepares_once_and_never_per_call(tmp_path):
    """The loaded key is prepared once, not counted, and every predict
    calls the same prepared object (JAX: a ``jax.stages.Compiled``)."""
    jm, pm = _pair()
    x = np.random.default_rng(11).normal(size=(4, 8)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    src = InferenceModel(device="cpu").load(pm, variables)
    want = src.predict(x)
    assert src.save_executables(str(tmp_path)) == 1
    _, pm2 = _pair()
    dst = InferenceModel(device="cpu").load(pm2, variables)
    assert dst.load_executables(str(tmp_path)) == 1
    assert dst.compile_count == 0
    fns = list(dst._compiled.values())
    assert len(fns) == 1
    np.testing.assert_array_equal(dst.predict(x), want)
    np.testing.assert_array_equal(dst.predict(x), want)
    assert dst._compiled[next(iter(dst._compiled))] is fns[0]
    assert dst.compile_count == 0


def test_load_executables_rejects_stale_model_code(tmp_path):
    """A model-code edit that leaves the parameters alike (relu -> gelu)
    changes the computation hash, so the manifest's key is skipped;
    ``verify=False`` trusts it.  JAX's counts agree."""
    jrelu, prelu = _pair("relu", hidden=16)
    jgelu, pgelu = _pair("gelu", hidden=16)
    x = np.random.default_rng(10).normal(size=(4, 8)).astype(np.float32)
    variables = jrelu.init(jax.random.PRNGKey(0), jnp.asarray(x))
    src = InferenceModel(device="cpu").load(prelu, variables)
    jsrc = JaxInferenceModel().load(jrelu, variables)
    src.predict(x)
    jsrc.predict(x)
    assert src.save_executables(str(tmp_path / "p")) \
        == jsrc.save_executables(str(tmp_path / "j")) == 1
    stale = InferenceModel(device="cpu").load(pgelu, variables)
    jstale = JaxInferenceModel().load(jgelu, variables)
    assert stale.load_executables(str(tmp_path / "p")) \
        == jstale.load_executables(str(tmp_path / "j")) == 0
    assert stale.load_executables(str(tmp_path / "p"), verify=False) \
        == jstale.load_executables(str(tmp_path / "j"), verify=False) == 1
    _same_keys(stale, jstale)


def test_warm_from_rebuckets_to_incoming_models_buckets():
    """``warm_from`` warms the buckets THIS model pads to; afterwards no
    predict prepares a key (JAX's counts and keys agree)."""
    jm, P = _fc_pair()
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.float32))
    pairs = []
    for cls, kw in ((JaxInferenceModel, {}), (InferenceModel,
                                              {"device": "cpu"})):
        model = jm if cls is JaxInferenceModel else P()
        im1 = cls(batch_buckets=(16,), **kw).load(model, v)
        im1.predict(np.ones((3, 4), np.float32))
        im2 = cls(batch_buckets=(4, 32), **kw).load(
            jm if cls is JaxInferenceModel else P(), v)
        assert im2.warm_from(im1) == 2
        pre = im2.compile_count
        im2.predict(np.ones((3, 4), np.float32))
        im2.predict(np.ones((20, 4), np.float32))
        assert im2.compile_count == pre == 2
        pairs.append((im1, im2))
    (j1, j2), (p1, p2) = pairs
    _same_keys(p1, j1)
    _same_keys(p2, j2)


def test_aot_executables_persist_across_versions(tmp_path):
    """Two versions of one model (same structure, other weights): v2 loads
    v1's manifest, prepares both keys without a fresh compile, and serves
    v2's weights."""
    jm, P = _fc_pair()
    vars1 = jm.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.float32))
    vars2 = jm.init(jax.random.PRNGKey(1), np.zeros((1, 4), np.float32))
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    im1 = InferenceModel(batch_buckets=(1, 4), device="cpu").load(P(), vars1)
    j1 = JaxInferenceModel(batch_buckets=(1, 4)).load(jm, vars1)
    out1 = im1.predict(x)
    im1.predict(x[:1])
    j1.predict(x)
    j1.predict(x[:1])
    _same_keys(im1, j1)
    assert im1.compile_count == 2
    assert im1.save_executables(str(tmp_path)) == 2

    im2 = InferenceModel(batch_buckets=(1, 4), device="cpu").load(P(), vars2)
    assert im2.load_executables(str(tmp_path)) == 2
    out2 = im2.predict(x)
    assert im2.compile_count == 0
    ref = JaxInferenceModel(batch_buckets=(1, 4)).load(jm, vars2).predict(x)
    _close(out2, np.asarray(ref))
    assert not np.allclose(out1, out2)


def test_int8_manifest_needs_the_same_calibration(tmp_path):
    """The fingerprint holds the precision and the calibration ranges: a
    calibrated int8 manifest loads into the same calibration only."""
    pm = tnn.Sequential([tnn.Dense(64, 128, "relu"), tnn.Dense(128, 4)])
    variables = {k: v.detach().clone() for k, v in pm.state_dict().items()}
    rng = np.random.default_rng(2)
    calib = rng.normal(size=(8, 64)).astype(np.float32)
    x = rng.normal(size=(4, 64)).astype(np.float32)

    def served(**load):
        model = tnn.Sequential([tnn.Dense(64, 128, "relu"),
                                tnn.Dense(128, 4)])
        return InferenceModel(device="cpu").load(model, variables, **load)

    src = served(dtype="int8", calibrate=calib)
    want = src.predict(x)
    assert src.save_executables(str(tmp_path)) == 1
    same = served(dtype="int8", calibrate=calib)
    assert same.load_executables(str(tmp_path)) == 1
    np.testing.assert_array_equal(same.predict(x), want)
    assert served(dtype="int8").load_executables(str(tmp_path)) == 0
    assert served(dtype="int8", calibrate=2 * calib).load_executables(
        str(tmp_path)) == 0
    assert served().load_executables(str(tmp_path)) == 0


def test_computation_hash_is_the_same_in_another_process():
    """The hash names no address, so a manifest written by one process
    verifies in another."""
    code = ("import torch\n"
            "from analytics_zoo_tpu_torch import nn\n"
            "from analytics_zoo_tpu_torch.serving import InferenceModel\n"
            "m = nn.Sequential([nn.Dense(8, 32, 'relu'), nn.Dropout(0.1), "
            "nn.Dense(32, 4)])\n"
            "v = {k: t.detach().clone() for k, t in m.state_dict().items()}\n"
            "im = InferenceModel(device='cpu').load(m, v)\n"
            "print(im._computation_hash((4, 8), 'float32'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    m = tnn.Sequential([tnn.Dense(8, 32, "relu"), tnn.Dropout(0.1),
                        tnn.Dense(32, 4)])
    v = {k: t.detach().clone() for k, t in m.state_dict().items()}
    im = InferenceModel(device="cpu").load(m, v)
    assert out.stdout.strip() == im._computation_hash((4, 8), "float32")
    assert im._computation_hash((4, 8), "float32") \
        != im._computation_hash((4, 8), "int32")


def test_enable_aot_cache_moves_the_kernel_build_dir(tmp_path):
    before = _build.BUILD_DIR
    try:
        enable_aot_cache(str(tmp_path))
        assert _build.library_path("flash_attention_fwd").parent == tmp_path
        enable_aot_cache(str(tmp_path))  # again: the same place
        assert _build.BUILD_DIR == tmp_path
    finally:
        _build.BUILD_DIR = before


def test_counts_are_deferred_at_capture_and_added_per_replay(monkeypatch):
    """Inside ``_launches.recording(stream)`` (a graph's capture) a
    wrapper's count call made on that stream is recorded, not made; each
    replay makes it again.  (The stream is a stand-in handle here: the
    rule reads only the calling thread's current stream.)"""
    before = dict(fa.KERNEL_LAUNCHES), fa.flash_attention_fwd.launches
    capture = types.SimpleNamespace(cuda_stream=7)
    monkeypatch.setattr(_launches, "_current_stream", lambda: 7)
    with _launches.recording(capture) as rec:
        fa._count(fa.flash_attention_fwd, fa.FWD_BF16, fa.FWD_LAUNCHES,
                  "wgmma")
        quant._count_int_mm()
    assert (dict(fa.KERNEL_LAUNCHES), fa.flash_attention_fwd.launches) \
        == before and len(rec) == 2
    mm = quant.int_mm.launches
    for _ in range(3):
        _launches.replay(rec)
    assert fa.KERNEL_LAUNCHES[fa.FWD_BF16] == before[0][fa.FWD_BF16] + 3
    assert fa.flash_attention_fwd.launches == before[1] + 3
    assert quant.int_mm.launches == mm + 3
    with fa._count_lock:  # leave the counts as they were
        fa.KERNEL_LAUNCHES[fa.FWD_BF16] -= 3
        fa.FWD_LAUNCHES["wgmma"] -= 3
        fa.flash_attention_fwd.launches -= 3
    quant.int_mm.launches -= 3
    # a count made on another stream meanwhile is made at once
    with _launches.recording(capture) as rec:
        monkeypatch.setattr(_launches, "_current_stream", lambda: 8)
        assert not _launches.deferred(quant._count_int_mm)
    assert rec == [] and not _launches._streams


def test_concurrent_int8_predicts_agree_with_serial():
    """More threads than cores predict on one calibrated int8 model at
    once, with the interpreter switching threads every microsecond: each
    result equals the serial one (each thread's quant context is its own,
    a key is prepared once)."""
    pm = tnn.Sequential([tnn.Dense(64, 128, "relu"), tnn.Dense(128, 4)])
    variables = {k: v.detach().clone() for k, v in pm.state_dict().items()}
    rng = np.random.default_rng(6)
    calib = rng.normal(size=(8, 64)).astype(np.float32)
    xs = [rng.normal(size=(n, 64)).astype(np.float32)
          for n in (1, 2, 3, 5, 9, 16, 17, 40)] * 2
    im = InferenceModel(device="cpu").load(pm, variables, dtype="int8",
                                           calibrate=calib)
    serial = InferenceModel(device="cpu").load(
        tnn.Sequential([tnn.Dense(64, 128, "relu"), tnn.Dense(128, 4)]),
        variables, dtype="int8", calibrate=calib)
    want = [serial.predict(x) for x in xs]
    got = [None] * len(xs)

    def run(i):
        got[i] = im.predict(xs[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert im.compile_count == len(im._compiled) == 4


# -- the card -------------------------------------------------------------------

BERT_CFG = dict(vocab_size=100, hidden_size=64, n_layers=2, n_heads=4,
                max_position=64, dropout=0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")


def _bert_variables():
    model = port_models.BERTClassifier(2, use_flash=True, **BERT_CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16, "int8", "int8cal"])
def test_graph_replay_matches_eager_on_card(dtype):
    """Each key's CUDA graph gives the eager forward's logits (the same
    kernels on the same inputs), at every bucket and a chunked batch."""
    _card()
    variables = _bert_variables()
    ids = np.random.default_rng(3).integers(0, 100, (70, 48)).astype(np.int32)
    load = dict(dtype="int8", calibrate=ids[:16]) if dtype == "int8cal" \
        else dict(dtype=dtype)
    outs = []
    for graphs in (True, False):
        im = InferenceModel(device="cuda", cuda_graphs=graphs).load(
            port_models.BERTClassifier(2, use_flash=True, **BERT_CFG),
            variables, **load)
        assert im.warm([(48,)], dtype=np.int32) == 4
        outs.append([im.predict(ids[:n]) for n in (1, 3, 16, 64, 70)])
    for g, e in zip(*outs):
        np.testing.assert_allclose(g, e, atol=1e-5 * max(
            1.0, float(np.abs(e).max())), rtol=0)


@pytest.mark.cuda
def test_replays_count_their_flash_launches_on_card():
    """A captured forward counts nothing at capture and its two flash
    launches (one a layer) at every replay; warming counts the eager
    forward that precedes each capture."""
    _card()
    im = InferenceModel(batch_buckets=(2, 8), device="cuda").load(
        port_models.BERTClassifier(2, use_flash=True, **BERT_CFG),
        _bert_variables(), dtype=torch.bfloat16)
    ids = np.zeros((8, 48), np.int32)
    before = fa.KERNEL_LAUNCHES[fa.FWD_BF16]
    im.warm([(48,)], dtype=np.int32)
    assert fa.KERNEL_LAUNCHES[fa.FWD_BF16] - before == 2 * 2
    for n in (1, 2, 5, 8):
        im.predict(ids[:n])
    assert fa.KERNEL_LAUNCHES[fa.FWD_BF16] - before == 2 * 2 + 4 * 2
    assert all(len(g.launches) == 2 for g in im._compiled.values())


@pytest.mark.cuda
def test_failed_capture_raises_on_card():
    """A forward that cannot be captured (a host read) raises, and the key
    is not prepared: there is no silent eager fallback."""
    _card()

    class HostRead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Dense(4, 3)

        def forward(self, x):
            if float(x.abs().sum()) > 1e30:  # a device -> host read
                x = x * 0
            return self.fc(x)

    m = HostRead()
    v = {k: t.detach().clone() for k, t in m.state_dict().items()}
    im = InferenceModel(device="cuda").load(m, v)
    with pytest.raises(RuntimeError):
        im.predict(np.ones((2, 4), np.float32))
    assert not im._compiled and im.compile_count == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k_major", [True, False], ids=["k_major", "n_major"])
@pytest.mark.parametrize("m,k,n", [(1, 768, 768), (3, 768, 2), (16, 768, 768),
                                   (17, 13, 5), (64, 768, 2), (512, 3072, 768),
                                   (48, 64, 256)])
def test_int_mm_pads_and_stays_exact_on_card(m, k, n, k_major):
    """``_int_mm`` wants more than 16 rows, K and N multiples of 8 and both
    operands K-major: the pooler's 1-16 rows and the head's N = 2 are
    padded with zeros, an N-major weight laid out again (48 x 64 x 256
    found cuBLASLt without a kernel for it), and the result equals a
    float64 product bit for bit."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(m * n + k)
    a = torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k) if k_major else (k, n),
                      device="cuda", generator=g, dtype=torch.int8)
    b = b.t() if k_major else b
    before = quant.int_mm.launches
    y = quant.int_mm(a, b)
    assert y.shape == (m, n) and y.dtype == torch.int32
    assert torch.equal(y.double(), a.double() @ b.double())
    assert quant.int_mm.launches == before + 1


@pytest.mark.cuda
def test_concurrent_graph_replays_agree_with_serial_on_card():
    """Threads replaying one instance's graphs at once (one serving stream,
    a lock a key) get the serial results, while a key is captured beside
    them."""
    _card()
    variables = _bert_variables()
    rng = np.random.default_rng(4)
    calib = rng.integers(0, 100, (4, 48)).astype(np.int32)

    def served():
        return InferenceModel(device="cuda").load(
            port_models.BERTClassifier(2, use_flash=True, **BERT_CFG),
            variables, dtype="int8", calibrate=calib)

    xs = [rng.integers(0, 100, (n, 48)).astype(np.int32)
          for n in (1, 3, 4, 9, 16, 20, 64, 70)] * 2
    serial = served()
    want = [serial.predict(x) for x in xs]
    im = served()
    im.warm([(48,)], dtype=np.int32, buckets=[1, 4, 16])  # 64 captured below
    got = [None] * len(xs)

    def run(i):
        got[i] = im.predict(xs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert im.compile_count == 4


@pytest.mark.cuda
def test_calibration_refuses_a_graph_capture_on_card():
    """The Calibrator reads ranges back to the host, so observing inside a
    capture raises with the reason (the JAX package's refusal under jit)."""
    _card()
    calib = quant.Calibrator()
    x = torch.ones(4, 4, device="cuda")
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="eagerly"):
        with torch.cuda.graph(g):
            calib.observe("dense", x * 2)
