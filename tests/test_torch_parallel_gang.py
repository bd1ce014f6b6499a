"""Ring attention, MoE over the ``expert`` axis, the GPipe pipeline and
ShardedEmbedding tables by rows, over a 2-rank gloo gang of the port,
against the JAX package on a CPU mesh of the same axes: the twins of
``tests/test_parallel.py``'s ring, MoE, pipeline and seq-mesh cases and of
``tests/test_sharded_embedding.py``'s multi-device cases.

One gang of 2 ranks (``tests/_torch_parallel_worker.py``) runs every
case in turn, each under its own mesh, once for the module, and one of 4
the ring over ``{seq: 4}`` and the pipeline over ``{pipe: 4}`` (a ring
whose neighbours differ, the JAX tests' axis sizes); the JAX package
runs the same inputs and the same converted weights on its devices.  Tolerances
(f32 throughout): ring attention 2e-5 forward and 5e-5 gradients, the JAX
tests' own; MoE, the pipeline and the fits 1e-5 relative (sums in another
order: gloo's gathers and the per-rank unique ids against XLA's global
program).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import one_torch_thread  # noqa: F401
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import (init_orca_context as jax_init,
                                    stop_orca_context as jax_stop)
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.parallel import (MoE as JaxMoE, pipeline_apply,
                                        ring_self_attention,
                                        stacked_stage_init)
from analytics_zoo_tpu_torch.core import launcher

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
GANG_TIMEOUT = 240
BERT_CFG = dict(vocab_size=50, hidden_size=32, n_layers=2, n_heads=4,
                max_position=16, dropout=0.0)
USERS = 1024  # 512 rows a rank

# the 4-rank gang's cases: a ring of 4, one stage a rank of 4
CASES_4 = [
    dict(name="ring", kind="ring", mesh={"seq": 4}),
    dict(name="pipe", kind="pipe", mesh={"pipe": 4}, runs=[["s4", 4]],
         errors=False),
]
CASES = [
    dict(name="ring", kind="ring", mesh={"seq": 2}),
    dict(name="ring_bert", kind="ring_bert", mesh={"seq": 2}),
    dict(name="seq_labels", kind="seq_labels", mesh={"seq": 2}),
    dict(name="moe_forward", kind="moe_forward", mesh={"expert": 2}),
    dict(name="moe_fit", kind="moe_fit", mesh={"expert": 2},
         save="@moe_ckpt"),
    dict(name="pipe", kind="pipe", mesh={"pipe": 2}),
    dict(name="ncf", kind="ncf", mesh={"data": 2}, users=USERS, epochs=2),
    dict(name="ncf_ckpt", kind="ncf", mesh={"data": 2}, users=64, epochs=1,
         save="@ckpt"),
]


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _ratings(n=256, users=64, items=40, seed=42):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, users, n),
                  rng.integers(0, items, n)], 1).astype(np.int32)
    y = (rng.random(n) < 0.5).astype(np.int32)
    return x, y


def _jax_ncf(users):
    from analytics_zoo_tpu.models import NeuralCF
    return NeuralCF(user_count=users, item_count=40, class_num=2,
                    user_embed=8, item_embed=8, hidden_layers=(16, 8),
                    mf_embed=8, sharded_embeddings=True)


class _JaxWithMoE(jnn.Module):
    def forward(self, scope, x):
        return scope.child(JaxMoE(num_experts=4, hidden_mult=2, top_k=1,
                                  capacity_factor=4.0), x, name="moe")


class _JaxMoEModel(jnn.Module):
    def forward(self, scope, x):
        h = scope.child(jnn.Dense(16), x, name="in")
        h = h[:, None, :]
        h = scope.child(JaxMoE(num_experts=2, hidden_mult=1, top_k=1,
                               capacity_factor=2.0), h, name="moe")
        return scope.child(jnn.Dense(2), h[:, 0], name="head")


def _mlp_stage():
    class Stage(jnn.Module):
        def forward(self, scope, x):
            h = scope.child(jnn.Dense(16, activation="relu"), x, name="fc1")
            return scope.child(jnn.Dense(8), h, name="fc2")
    return Stage()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _inputs():
    """Every case's inputs and initial variables (JAX layout), from
    seeds."""
    rng = np.random.default_rng(0)
    inp = {"ring": {n: _normal(rng, (2, 32, 2, 8))
                    for n in ("q", "k", "v", "w")}}
    jax_stop()
    jax_init("local", mesh_shape={"data": 1})
    from analytics_zoo_tpu.models import BERTClassifier
    ids = rng.integers(0, BERT_CFG["vocab_size"], (16, 16)).astype(np.int32)
    inp["bert_data"] = (ids, rng.integers(0, 3, 16).astype(np.int32))
    est = JaxEstimator.from_keras(
        BERTClassifier(3, use_ring=True, **BERT_CFG),
        loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=1e-3)
    est._ensure_initialized(jnp.asarray(ids[:8]))
    inp["bert"] = _np_tree(est.get_model())
    x = rng.normal(size=(8, 9)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    inp["seq_labels_data"] = (x, y)
    est = JaxEstimator.from_keras(jnn.Sequential([jnn.Dense(3)]),
                                  loss="categorical_crossentropy",
                                  learning_rate=0.1)
    est._ensure_initialized(jnp.asarray(x))
    inp["seq_labels"] = _np_tree(est.get_model())
    inp["moe_x"] = _normal(rng, (2, 4, 8))
    inp["moe"] = _np_tree(_JaxWithMoE().init(jax.random.PRNGKey(0),
                                             jnp.asarray(inp["moe_x"])))
    inp["moe_data"] = (rng.normal(size=(32, 8)).astype(np.float32),
                       rng.integers(0, 2, 32).astype(np.int32))
    est = JaxEstimator.from_keras(_JaxMoEModel(),
                                  loss="sparse_categorical_crossentropy",
                                  learning_rate=0.05, sharding="tp")
    est._ensure_initialized(jnp.asarray(inp["moe_data"][0][:16]))
    inp["moe_model"] = _np_tree(est.get_model())
    inp["pipe_x"] = _normal(rng, (8, 8))
    stage = _mlp_stage()
    for n in (4, 2, 3):
        inp[f"pipe_s{n}"] = _np_tree(stacked_stage_init(
            lambda r: stage.init(r, jnp.asarray(inp["pipe_x"][:2]))[
                "params"], n, jax.random.PRNGKey(n)))
    for users in (USERS, 64):
        x, y = _ratings(users=users)
        est = JaxEstimator.from_keras(_jax_ncf(users),
                                      loss="sparse_categorical_crossentropy",
                                      optimizer="adam", learning_rate=1e-2,
                                      seed=7)
        est._ensure_initialized(jnp.asarray(x[:32]))
        inp[f"ncf_{users}"] = _np_tree(est.get_model())
        inp[f"ncf_data_{users}"] = (x, y)
    return inp


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The gangs of 2 and of 4 ranks, run once: ``({world: [rank
    results]}, inputs, root)``."""
    root = tmp_path_factory.mktemp("parallel_gang")
    inp = _inputs()
    torch.save(inp, root / "inputs.pt")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")])
    out = {}
    for world, cases in ((2, CASES), (4, CASES_4)):
        d = root / f"w{world}"
        d.mkdir()
        spec = [{k: (str(root / v[1:]) if isinstance(v, str)
                     and v.startswith("@") else v) for k, v in case.items()}
                for case in cases]
        (d / "spec.json").write_text(json.dumps(
            {"inputs": str(root / "inputs.pt"), "cases": spec}))
        rc = launcher.launch(WORKER, [str(d / "spec.json"), str(d)], world,
                             platform="cpu", timeout=GANG_TIMEOUT)
        assert rc == 0, f"the gang of {world} exited {rc}"
        out[world] = [torch.load(d / f"r{r}.pt", weights_only=False)
                      for r in range(world)]
    return out, inp, root


@pytest.fixture(scope="module")
def gang(gangs):
    """The 2-rank gang's view: ``([rank results], inputs, root)``."""
    return gangs[0][2], gangs[1], gangs[2]


def _case(ranks, name):
    """Every rank's result of case ``name`` (none of them an error)."""
    res = [r[name] for r in ranks]
    for r in res:
        assert "error" not in r, r.get("trace", r)
    return res


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), (
        np.abs(got - want).max(), tol)


# -- ring attention -----------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_ring_and_reference(gangs, world, causal):
    """Every rank's gathered output and the whole gradients of q, k and v
    equal the JAX ring on a ``seq`` mesh of the gang's size and the dense
    reference."""
    from analytics_zoo_tpu.ops import mha_reference
    res = _case(gangs[0][world], "ring")
    x = {k: jnp.asarray(v) for k, v in gangs[1]["ring"].items()}
    jax_stop()
    jax_init("local", mesh_shape={"data": 1, "seq": world})

    def loss(q, k, v):
        return (ring_self_attention(q, k, v, causal=causal) * x["w"]).sum()

    out = jax.jit(lambda q, k, v: ring_self_attention(
        q, k, v, causal=causal))(x["q"], x["k"], x["v"])
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x["q"], x["k"],
                                                       x["v"])
    ref = mha_reference(x["q"], x["k"], x["v"], causal=causal)
    tag = "causal" if causal else "full"
    for r in res:
        _close(r[f"{tag}_out"], out, 2e-5)
        _close(r[f"{tag}_out"], ref, 2e-5)
        for n, g in zip(("dq", "dk", "dv"), grads):
            _close(r[f"{tag}_{n}"], g, 5e-5)


def test_ring_attention_no_seq_axis_fallback():
    """Without a ``seq`` axis ring_self_attention is plain attention (the
    causal mask kept)."""
    from analytics_zoo_tpu.ops import mha_reference
    from analytics_zoo_tpu_torch.core.context import (init_orca_context,
                                                      stop_orca_context)
    from analytics_zoo_tpu_torch.parallel import ring_self_attention as rsa
    q = _normal(np.random.default_rng(1), (1, 8, 2, 4))
    init_orca_context("local")
    try:
        got = rsa(torch.tensor(q), torch.tensor(q), torch.tensor(q),
                  causal=True)
    finally:
        stop_orca_context()
    ref = mha_reference(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                        causal=True)
    _close(got.numpy(), ref, 2e-5)


def test_ring_bert_fits_as_the_jax_ring_bert(gang):
    """A 2-layer BERT with ``use_ring=True`` fitted 2 epochs under ``{seq:
    2}``: the losses and the parameters equal the JAX BERT's on a ``seq``
    mesh of 2; the step communicates (on the card it runs eagerly)."""
    res = _case(gang[0], "ring_bert")
    from analytics_zoo_tpu.models import BERTClassifier
    jax_stop()
    jax_init("local", mesh_shape={"data": 1, "seq": 2})
    ids, y = gang[1]["bert_data"]
    est = JaxEstimator.from_keras(
        BERTClassifier(3, use_ring=True, **BERT_CFG),
        loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=1e-3)
    est._ensure_initialized(jnp.asarray(ids[:8]))
    for g, w in zip(jax.tree_util.tree_leaves(gang[1]["bert"]),
                    jax.tree_util.tree_leaves(_np_tree(est.get_model()))):
        np.testing.assert_array_equal(g, w)  # the same seeded init
    hist = est.fit((ids, y), epochs=2, batch_size=8, verbose=False)
    want = jax.tree_util.tree_leaves(_np_tree(est.get_model()["params"]))
    for r in res:
        np.testing.assert_allclose(r["loss"], hist["loss"], rtol=1e-5)
        got = jax.tree_util.tree_leaves(r["params"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
        assert r["communicates"]


def test_seq_mesh_does_not_crash_on_label_shapes(gang):
    """Rank-2 labels and a feature dim the ``seq`` axis does not divide
    train under ``{seq: 2}``, to the JAX loss."""
    res = _case(gang[0], "seq_labels")
    jax_stop()
    jax_init("local", mesh_shape={"data": 1, "seq": 2})
    x, y = gang[1]["seq_labels_data"]
    est = JaxEstimator.from_keras(jnn.Sequential([jnn.Dense(3)]),
                                  loss="categorical_crossentropy",
                                  learning_rate=0.1)
    hist = est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    for r in res:
        assert np.isfinite(r["loss"][0])
        np.testing.assert_allclose(r["loss"], hist["loss"], rtol=1e-5)


# -- MoE ----------------------------------------------------------------------

def test_moe_expert_split_matches_whole_and_jax(gang):
    """Each rank running 2 of 4 experts (its output all-gathered, its
    input's gradient summed) equals the whole layer: the output, the aux
    loss, the gradients of x and of the gate on every rank, and ``wi``/
    ``wo``'s gradients summed over the ranks (each its experts' rows);
    and the whole layer equals the JAX MoE with the same variables."""
    res = _case(gang[0], "moe_forward")
    v = {"params": gang[1]["moe"]["params"], "state": gang[1]["moe"]["state"]}
    x = jnp.asarray(gang[1]["moe_x"])
    model = _JaxWithMoE()

    def loss(params, x):
        out, _ = model.apply({"params": params, "state": v["state"]}, x)
        return jnp.square(out).sum()

    out, state = model.apply(v, x)
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    for r in res:
        _close(r["whole_out"], out, 1e-5)
        _close(r["whole_aux"], state["moe"]["aux_loss"], 1e-5)
        _close(r["whole_dx"], g_x, 1e-5)
        for n in ("gate", "wi", "wo"):
            _close(r[f"whole_d{n}"], g_params["moe"][n], 1e-5)
        _close(r["split_out"], r["whole_out"], 1e-5)
        _close(r["split_aux"], r["whole_aux"], 1e-6)
        _close(r["split_dx"], r["whole_dx"], 1e-5)
        _close(r["split_dgate"], r["whole_dgate"], 1e-5)
    for n in ("wi", "wo"):
        summed = res[0][f"split_d{n}"] + res[1][f"split_d{n}"]
        _close(summed, res[0][f"whole_d{n}"], 1e-5)
        for i, r in enumerate(res):  # each rank's experts only
            other = r[f"split_d{n}"][2 * (1 - i):2 * (1 - i) + 2]
            assert np.abs(other).max() == 0.0


def test_moe_trains_through_estimator_with_aux_loss(gang):
    """``sharding="tp"`` on ``{expert: 2}``: each rank holds 1 of the 2
    experts' ``wi``/``wo``; the loss history (aux loss at the default
    weight included) equals the JAX Estimator's on an ``expert`` mesh of
    2 within 1e-5, and the trained parameters within 5e-5 (Adam, the JAX
    test's optimizer, divides by the root of the second moment, so on
    entries whose gradient is near 0 a rounding difference of the
    gradient, 1e-8 here, becomes a step of up to lr: 4e-7 after one step
    in one process, 1.3e-5 after six over the gang); the aux loss is in
    the state; its checkpoint, written as each rank's expert, loads back
    into a fresh estimator and whole into the JAX package."""
    res = _case(gang[0], "moe_fit")
    jax_stop()
    jax_init("local", mesh_shape={"data": 1, "expert": 2})
    est = JaxEstimator.from_keras(_JaxMoEModel(),
                                  loss="sparse_categorical_crossentropy",
                                  learning_rate=0.05, sharding="tp")
    x, y = gang[1]["moe_data"]
    hist = est.fit((x, y), epochs=3, batch_size=16, verbose=False)
    params = _np_tree(est.get_model()["params"])
    assert "aux_loss" in est._ts["state"]["moe"]
    for i, r in enumerate(res):
        assert r["ep_layers"] == ["moe"]
        assert r["wi_shape"] == [1, 16, 16]
        np.testing.assert_allclose(r["loss"], hist["loss"], rtol=1e-5)
        _close(r["aux"], est._ts["state"]["moe"]["aux_loss"], 1e-5)
        for name in ("in", "head"):
            for leaf in ("kernel", "bias"):
                _close(r["params"][name][leaf], params[name][leaf], 5e-5)
        _close(r["params"]["moe"]["gate"], params["moe"]["gate"], 5e-5)
        for n in ("wi", "wo"):
            _close(r["params"]["moe"][n], params["moe"][n][i:i + 1], 5e-5)
        # the checkpoint loads back as each rank's expert
        assert r["loaded_step"] == 6
        for a, b in zip(jax.tree_util.tree_leaves(r["loaded_params"]),
                        jax.tree_util.tree_leaves(r["params"])):
            np.testing.assert_array_equal(a, b)
    # the JAX package restores it whole: the ranks' experts in order
    from analytics_zoo_tpu.core import checkpoint as jckpt
    tree = jckpt.restore(str(gang[2] / "moe_ckpt"))
    for n in ("wi", "wo"):
        whole = np.asarray(tree["params"]["moe"][n])
        np.testing.assert_array_equal(
            whole, np.concatenate([r["params"]["moe"][n] for r in res]))


def test_moe_respects_capacity():
    """A tiny capacity drops most tokens: most output rows are zero, as
    in the JAX layer."""
    from analytics_zoo_tpu_torch.parallel import MoE
    torch.manual_seed(0)
    moe = MoE(8, num_experts=2, hidden_mult=1, top_k=1,
              capacity_factor=0.02)
    x = torch.tensor(_normal(np.random.default_rng(2), (2, 32, 8)))
    out = moe(x)
    assert (out.abs().sum(-1) < 1e-9).float().mean() > 0.5


def test_moe_router_gets_gradient_top1():
    """top_k=1 keeps the raw softmax gate, so the router gets the task
    loss's gradient; it equals the JAX router's gradient."""
    from analytics_zoo_tpu_torch.convert import from_jax_variables
    from analytics_zoo_tpu_torch.parallel import MoE

    class One(jnn.Module):
        def forward(self, scope, x):
            return scope.child(JaxMoE(num_experts=4, hidden_mult=1, top_k=1,
                                      capacity_factor=2.0), x, name="moe")

    x = _normal(np.random.default_rng(3), (2, 8, 16))
    jm = One()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(params):
        out, _ = jm.apply({"params": params, "state": v["state"]},
                          jnp.asarray(x))
        return jnp.square(out).sum()

    want = jax.grad(loss)(v["params"])["moe"]["gate"]
    holder = torch.nn.Module()
    holder.moe = MoE(16, num_experts=4, hidden_mult=1, top_k=1,
                     capacity_factor=2.0)
    holder.load_state_dict(from_jax_variables(_np_tree(v)), strict=True)
    holder.moe(torch.tensor(x)).square().sum().backward()
    got = holder.moe.gate.grad.numpy()
    assert np.abs(got).sum() > 1e-3
    _close(got, want, 1e-5)


# -- pipeline -----------------------------------------------------------------

def _jax_stage_fn():
    stage = _mlp_stage()

    def apply_fn(params, xb):
        out, _ = stage.apply({"params": params}, xb)
        return out
    return apply_fn


@pytest.mark.parametrize("world,tag,n_micro", [(2, "s4", 4), (2, "s2", 2),
                                               (4, "s4", 4)])
def test_pipeline_matches_jax_and_sequential(gangs, world, tag, n_micro):
    """4 stages (2 a rank) in 4 microbatches and 2 stages in 2 over
    ``{pipe: 2}``, and 4 stages over ``{pipe: 4}``: the output on every
    rank equals the JAX pipeline on a ``pipe`` mesh of the gang's size and
    the stages run in order; the stacked gradients summed over the ranks
    (each holds its stages' rows) equal the JAX gradient."""
    res = _case(gangs[0][world], "pipe")
    stacked = jax.tree_util.tree_map(jnp.asarray, gangs[1][f"pipe_{tag}"])
    x = jnp.asarray(gangs[1]["pipe_x"])
    jax_stop()
    mesh = jax_init("local", mesh_shape={"data": 1, "pipe": world})
    fn = _jax_stage_fn()
    out = jax.jit(lambda sp, x: pipeline_apply(fn, sp, x, n_micro,
                                               mesh=mesh))(stacked, x)
    grads = jax.jit(jax.grad(lambda sp: pipeline_apply(
        fn, sp, x, n_micro, mesh=mesh).sum()))(stacked)
    expect = x
    n = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    for i in range(n):
        expect = fn(jax.tree_util.tree_map(lambda l: l[i], stacked), expect)
    for r in res:
        _close(r[f"{tag}_out"], out, 1e-5)
        _close(r[f"{tag}_out"], expect, 1e-5)
    local = n // world
    for layer in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            key = f"{tag}_d{layer}_{leaf}"
            want = np.asarray(grads[layer][leaf])
            _close(sum(r[key] for r in res), want, 1e-5)
            for i, r in enumerate(res):
                mine = slice(i * local, (i + 1) * local)
                _close(r[key][mine], want[mine], 1e-5)


def test_pipeline_raises_the_jax_errors(gang):
    res = _case(gang[0], "pipe")
    for r in res:
        assert "not divisible into 4 microbatches" in r["batch_error"]
        assert "3 stages do not divide over pipe axis of size 2" in \
            r["stages_error"]


def test_pipeline_no_pipe_axis_falls_back():
    """Without a ``pipe`` axis the stages run in order (the JAX
    fallback's output)."""
    from analytics_zoo_tpu_torch.parallel import pipeline_apply as tpa
    rng = np.random.default_rng(4)
    x = _normal(rng, (4, 8))
    stage = _mlp_stage()
    stacked = stacked_stage_init(
        lambda r: stage.init(r, jnp.asarray(x))["params"], 3,
        jax.random.PRNGKey(1))
    jax_stop()
    jax_init("local", mesh_shape={"data": 8})
    want = pipeline_apply(_jax_stage_fn(), stacked, jnp.asarray(x), 2)

    def torch_stage(p, xb):
        h = torch.relu(xb @ p["fc1"]["kernel"] + p["fc1"]["bias"])
        return h @ p["fc2"]["kernel"] + p["fc2"]["bias"]

    params = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                    stacked)
    got = tpa(torch_stage, params, torch.tensor(x), 2)
    _close(got.numpy(), want, 1e-5)


def test_stacked_stage_init_stacks_each_stage():
    from analytics_zoo_tpu_torch import nn as tnn
    from analytics_zoo_tpu_torch.parallel import stacked_stage_init as tsi

    def init(gen):
        d = tnn.Dense(4, 3)
        d.reset_parameters(gen)
        return {"kernel": d.kernel.detach(), "bias": d.bias.detach()}

    st = tsi(init, 3, 5)
    assert st["kernel"].shape == (3, 4, 3) and st["bias"].shape == (3, 3)
    assert not torch.equal(st["kernel"][0], st["kernel"][1])
    again = tsi(init, 3, 5)
    assert torch.equal(st["kernel"], again["kernel"])


# -- ShardedEmbedding tables by rows ------------------------------------------

def _jax_ncf_fit(users, epochs, **kw):
    from analytics_zoo_tpu.parallel import embedding_row_rules
    jax_stop()
    jax_init("local", mesh_shape={"data": 2})
    x, y = _ratings(users=users)
    est = JaxEstimator.from_keras(_jax_ncf(users),
                                  loss="sparse_categorical_crossentropy",
                                  optimizer="adam", learning_rate=1e-2,
                                  seed=7, sharding=embedding_row_rules(),
                                  **kw)
    hist = est.fit((x, y), epochs=epochs, batch_size=64, verbose=False)
    return est, hist


def _tables_close(res, params, tol=1e-5):
    """Each rank's rows of every table: half the rows, equal to that half
    of the JAX table."""
    for i, r in enumerate(res):
        for name, t in r["tables"].items():
            whole = np.asarray(params[name.split(".")[0]][
                "sharded_embeddings"])
            half = whole.shape[0] // 2
            assert t.shape == (half, 8)
            _close(t, whole[i * half:(i + 1) * half], tol)


def test_sharded_ncf_trains_with_per_device_row_shards(gang):
    """``embedding_row_rules`` over ``{data: 2}``: each rank holds half
    the rows of every table; with ``nan_policy="skip_step"`` the loss
    history, the tables' rows and the dense tower equal the JAX
    Estimator's on a ``data`` mesh of 2, the loss goes down, and
    evaluate and predict run on the row-sharded tables."""
    res = _case(gang[0], "ncf")
    est, hist = _jax_ncf_fit(USERS, 2, nan_policy="skip_step")
    params = _np_tree(est.get_model()["params"])
    for r in res:
        np.testing.assert_allclose(r["loss"], hist["loss"], rtol=1e-5)
        assert r["loss"][-1] < r["loss"][0]
        assert r["bad_steps"] == 0
        assert np.isfinite(r["eval"]["loss"])
        assert r["pred_shape"] == [16, 2]
        for name, t in r["dense"].items():
            *path, leaf = name.split(".")
            node = params
            for k in path:
                node = node[k]
            _close(t, node[leaf], 1e-5)
    _tables_close(res, params)


def test_sharded_checkpoint_roundtrip(gang):
    """A checkpoint of the row-sharded tables written by the 2 ranks
    loads back into a fresh estimator as each rank's rows; the JAX
    package restores it whole, equal to the JAX run's tables."""
    from analytics_zoo_tpu.core import checkpoint as jckpt
    res = _case(gang[0], "ncf_ckpt")
    for r in res:
        assert r["loaded_step"] == 4
        for name, t in r["tables"].items():
            np.testing.assert_array_equal(r["loaded_tables"][name], t)
    tree = jckpt.restore(str(gang[2] / "ckpt"))
    est, _ = _jax_ncf_fit(64, 1)
    params = _np_tree(est.get_model()["params"])
    for key in ("mlp_user_embed", "mf_item_embed"):
        whole = np.asarray(tree["params"][key]["sharded_embeddings"])
        _close(whole, params[key]["sharded_embeddings"], 1e-5)
    _tables_close(res, params)


def test_shard_variables_places_each_rank_piece():
    """``shard_variables`` cuts each ``params`` leaf to the piece the rank
    holds under the JAX rules (the blocks of the JAX package's placement
    on a ``{data: 2, model: 2}`` mesh), the other collections whole."""
    from analytics_zoo_tpu.parallel import shard_variables as jshard
    from analytics_zoo_tpu.parallel import ShardingRule as JRule
    from analytics_zoo_tpu_torch.core.context import Mesh
    from analytics_zoo_tpu_torch.parallel import (P, ShardingRule,
                                                  shard_variables)
    rng = np.random.default_rng(5)
    variables = {"params": {"ffn": {"kernel": _normal(rng, (4, 8)),
                                    "bias": _normal(rng, (8,))}},
                 "state": {"bn": {"mean": _normal(rng, (8,))}}}
    jax_stop()
    jmesh = jax_init("local", mesh_shape={"data": 2, "model": 2})
    placed = jshard(variables, [JRule(r"kernel$", P(None, "model"))], jmesh)
    kernel = placed["params"]["ffn"]["kernel"]
    for rank in range(4):
        mesh = Mesh(("data", "model"), (2, 2), rank=rank)
        got = shard_variables(variables,
                              [ShardingRule(r"kernel$", P(None, "model"))],
                              mesh)
        dev = jmesh.devices.reshape(-1)[rank]
        want = next(s.data for s in kernel.addressable_shards
                    if s.device == dev)
        np.testing.assert_array_equal(got["params"]["ffn"]["kernel"],
                                      np.asarray(want))
        np.testing.assert_array_equal(got["params"]["ffn"]["bias"],
                                      variables["params"]["ffn"]["bias"])
        assert got["state"] is variables["state"]
