"""The port's Estimator over several processes against the JAX package on
a mesh of the same axes: the twins of ``tests/test_scaleout.py`` (but its
LARS/LAMB cases, twinned in ``test_torch_train_knobs.py``) and of
``tests/test_parallel.py``'s item-7 cases.

The port runs one gloo process a device on the CPU: one gang a world
size (2 and 4) runs every case of that size in turn
(``tests/_torch_scaleout_worker.py``, each case under its own mesh), once
for the module; the JAX package runs the same fit on the first N of its 8
CPU devices.  Tolerances: losses and parameters 1e-4 relative (f32 sums
in another order: gloo's all-reduce against XLA's psum); ``"none"``
equals ``None`` bit for bit; bf16 and int8 stay within 0.02 of the
uncompressed run's last loss, as the JAX tests require, and within 5e-3
of the JAX package's compressed run; wire bytes exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_serving import one_torch_thread  # noqa: F401
from analytics_zoo_tpu.core import (init_orca_context as jax_init,
                                    stop_orca_context as jax_stop)
from analytics_zoo_tpu.core import checkpoint as jckpt
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
from analytics_zoo_tpu_torch.core import launcher

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_scaleout_worker.py")
TOL = 1e-4
TOL_COMPRESSED = 5e-3
GANG_TIMEOUT = 300


BERT_CFG = dict(vocab_size=50, hidden_size=32, n_layers=2, n_heads=4,
                max_position=16, dropout=0.0)


def _bert_data(n=32, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, BERT_CFG["vocab_size"], (n, seq)).astype(
        np.int32), rng.integers(0, 3, n).astype(np.int32))


def _jax_mlp(bn=False):
    if bn:
        return jnn.Sequential([jnn.Dense(32, name="ffn1"),
                               jnn.BatchNormalization(name="bn"),
                               jnn.Activation("relu"),
                               jnn.Dense(4, name="ffn2")])
    return jnn.Sequential([jnn.Dense(32, activation="relu", name="ffn1"),
                           jnn.Dense(4, name="ffn2")])


def _data(n=64, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def _jax_estimator(mesh_shape, model="mlp", lr=0.1, **kw):
    jax_stop()
    jax_init("local", mesh_shape=mesh_shape)
    kw.setdefault("optimizer", "sgd")
    if model == "bert":
        from analytics_zoo_tpu.models import BERTClassifier
        net = BERTClassifier(3, **BERT_CFG)
    else:
        net = _jax_mlp(model == "bn")
    return JaxEstimator.from_keras(net, loss="sparse_categorical_crossentropy",
                                   learning_rate=lr, seed=1, **kw)


def _jax_fit(mesh_shape, epochs=2, model="mlp", **kw):
    est = _jax_estimator(mesh_shape, model=model, **kw)
    hist = est.fit(_data(), epochs=epochs, batch_size=32, verbose=False)
    return hist["loss"], est


# the cases, by world size; "jax" is the JAX mesh of the same axes
CASES = {
    2: [
        dict(name="dp", mesh={"data": 2}),
        dict(name="dp_bn", model="bn", mesh={"data": 2}),
        dict(name="fsdp", mesh="fsdp", sharding="fsdp",
             jax={"data": 1, "fsdp": 2}),
        dict(name="tp", mesh="tp", sharding="tp",
             jax={"data": 1, "model": 2}),
        dict(name="none", mesh={"data": 2}, grad_compression="none"),
        dict(name="bf16", mesh={"data": 2}, grad_compression="bf16"),
        dict(name="int8", mesh={"data": 2}, grad_compression="int8",
             epochs=1, save="@int8"),
        dict(name="int8_resumed", mesh={"data": 2}, grad_compression="int8",
             epochs=1, load="@int8"),
        dict(name="2d_on_data_mesh", mesh={"data": 2}, sharding="2d",
             epochs=1),
        dict(name="rollback", mesh={"data": 2}, nan_policy="rollback",
             model_dir="@rollback", nan_at=2),
        dict(name="bert_tp", model="bert", mesh="tp", sharding="tp",
             jax={"data": 1, "model": 2}, lr=0.05, epochs=1),
    ],
    4: [
        dict(name="dp", mesh={"data": 4}),
        dict(name="fsdp", mesh="fsdp", sharding="fsdp",
             jax={"data": 1, "fsdp": 4}),
        dict(name="2d", mesh={"data": 2, "model": 2}, sharding="2d",
             save="@2d", more_epochs=1),
        dict(name="2d_loaded", mesh={"data": 2, "model": 2}, sharding="2d",
             load="@2d", epochs=1),
        dict(name="tp+fsdp", mesh={"fsdp": 2, "model": 2, "data": 1},
             sharding="tp+fsdp"),
        dict(name="int8", mesh={"data": 4}, grad_compression="int8"),
        dict(name="2d_int8", mesh={"data": 2, "model": 2}, sharding="2d",
             grad_compression="int8", epochs=1),
        dict(name="bert_2d", model="bert", mesh={"data": 2, "model": 2},
             sharding="2d", lr=0.05, epochs=1),
        dict(name="bert_tp+fsdp", model="bert",
             mesh={"fsdp": 2, "model": 2, "data": 1}, sharding="tp+fsdp",
             lr=0.05, epochs=1),
    ],
}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Each world size's gang, run once: ``{world: [rank results]}``."""
    root = tmp_path_factory.mktemp("scaleout")
    init = root / "init"
    for model in ("mlp", "bn", "bert"):
        est = _jax_estimator({"data": 1}, model=model)
        x0 = _bert_data()[0][:8] if model == "bert" else _data()[0][:32]
        est._ensure_initialized(jnp.asarray(x0))
        ckpt_io.save(str(init / model), est.get_model())
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")])
    out = {}
    for world, cases in CASES.items():
        spec = []
        for case in cases:
            case = {k: (str(root / f"{world}_{v[1:]}")
                        if isinstance(v, str) and v.startswith("@") else v)
                    for k, v in case.items() if k != "jax"}
            spec.append(case)
        d = root / f"w{world}"
        d.mkdir()
        (d / "cases.json").write_text(json.dumps({"init": str(init),
                                                  "cases": spec}))
        rc = launcher.launch(WORKER, [str(d / "cases.json"), str(d)], world,
                             platform="cpu", timeout=GANG_TIMEOUT)
        assert rc == 0, f"world {world} gang exited {rc}"
        out[world] = [json.loads((d / f"r{r}.json").read_text())
                      for r in range(world)]
    out["root"] = root
    return out


def _case(gangs, world, name):
    res = [r[name] for r in gangs[world]]
    for r in res:
        assert "error" not in r, r
    return res


def _jax_mesh(world, name):
    case = next(c for c in CASES[world] if c["name"] == name)
    return case.get("jax", case["mesh"])


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), (
        got, want)


def _arrays(tree):
    """A JSON tree (lists for arrays) or a tree of arrays, as arrays."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(_arrays(tree))]


@pytest.mark.parametrize("world,name,jax_kw", [
    (2, "dp", {}), (2, "dp_bn", {"model": "bn"}),
    (2, "fsdp", {"sharding": "fsdp"}), (2, "tp", {"sharding": "tp"}),
    (4, "dp", {}), (4, "fsdp", {"sharding": "fsdp"}),
    (4, "2d", {"sharding": "2d"}), (4, "tp+fsdp", {"sharding": "tp+fsdp"})])
def test_strategy_fit_matches_jax_on_the_same_mesh(gangs, world, name,
                                                   jax_kw):
    """Loss history, evaluate, the trained parameters and batch norm's
    running statistics against the JAX Estimator on a mesh of the same
    axes; every rank agrees."""
    res = _case(gangs, world, name)
    jloss, jest = _jax_fit(_jax_mesh(world, name), **jax_kw)
    _close(res[0]["loss"], jloss)
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
        assert r["eval"] == res[0]["eval"]
    _close(res[0]["eval"]["loss"], jest.evaluate(
        _data(), batch_size=32)["loss"])
    for got, want in zip(_leaves(res[0]["params"]),
                         _leaves(jest.get_model()["params"])):
        _close(got, want)
    for got, want in zip(_leaves(res[0]["state"]),
                         _leaves(jest.get_model()["state"])):
        _close(got, want)
    # predict: each rank its block of every global batch; over a mesh of
    # batch axes only, rank k's block is the k-th
    want = np.asarray(jest.predict(_data()[0], batch_size=32))
    shards = res[0]["mesh"].get("data", 1) * res[0]["mesh"].get("fsdp", 1)
    if shards == world:
        m = 32 // world
        got = np.concatenate([np.asarray(res[k]["pred"])[b * m:(b + 1) * m]
                              for b in range(2) for k in range(world)])
        _close(got, want)


@pytest.mark.parametrize("world,name", [(2, "fsdp"), (2, "tp"),
                                        (4, "2d"), (4, "tp+fsdp")])
def test_rule_placed_leaves_live_as_pieces(gangs, world, name):
    """The rules' specs are the JAX package's ``infer_param_specs`` on the
    same mesh, and each rank keeps only its piece of a sharded leaf's
    optimizer state."""
    from analytics_zoo_tpu.parallel import infer_param_specs
    from analytics_zoo_tpu.orca.learn.estimator import \
        _resolve_sharding_rules
    res = _case(gangs, world, name)
    jest = _jax_estimator(_jax_mesh(world, name), sharding=name)
    jest._ensure_initialized(jnp.asarray(_data()[0][:32]))
    from analytics_zoo_tpu.core import get_mesh
    specs = infer_param_specs(jest.get_model()["params"],
                              _resolve_sharding_rules(name), get_mesh())
    want = {"/".join(str(k.key) for k in p): list(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    names = ["ffn1/kernel", "ffn1/bias", "ffn2/kernel", "ffn2/bias"]
    got = dict(zip(names, res[0]["specs"]))
    for path, spec in got.items():
        assert [tuple(e) if isinstance(e, list) else e for e in spec] == [
            tuple(e) if isinstance(e, (list, tuple)) else e
            for e in want[path]], path
    assert any(got.values())  # the strategy shards something
    full = {"ffn1/kernel": [8, 32], "ffn1/bias": [32],
            "ffn2/kernel": [32, 4], "ffn2/bias": [4]}
    for path, shape in zip(names, res[0]["opt_piece_shapes"]):
        n = int(np.prod(shape))
        if got[path]:
            assert n < int(np.prod(full[path])), path
        else:
            assert shape == full[path], path


def test_grad_compression_none_is_bitwise_identical(gangs):
    """THE bisection guard: ``"none"`` keeps the uncompressed step, so its
    loss history is ``None``'s bit for bit."""
    assert _case(gangs, 2, "none")[0]["loss"] == \
        _case(gangs, 2, "dp")[0]["loss"]
    assert _case(gangs, 2, "none")[0]["params"] == \
        _case(gangs, 2, "dp")[0]["params"]


@pytest.mark.parametrize("world,name", [(2, "bf16"), (2, "int8"),
                                        (4, "int8")])
def test_grad_compression_quantized_tracks_uncompressed(gangs, world, name):
    """bf16 and int8 change only the wire: within 0.02 of the uncompressed
    run's last loss (the JAX tests' bound), and the JAX package's
    compressed run on the same mesh within ``TOL_COMPRESSED``."""
    comp = name
    base = _case(gangs, world, "dp")[0]["loss"]
    res = _case(gangs, world, name)
    epochs = next(c for c in CASES[world]
                  if c["name"] == name).get("epochs", 2)
    jloss, jest = _jax_fit(_jax_mesh(world, name), epochs=epochs,
                           grad_compression=comp)
    assert abs(res[0]["loss"][-1] - base[epochs - 1]) < 0.02
    _close(res[0]["loss"], jloss, TOL_COMPRESSED)
    if comp == "int8":
        # one residual slice a rank: the JAX state's [S, ...] leaves
        ef = jax.tree_util.tree_leaves(jest._ts["ef"])
        assert ef[0].shape[0] == world
        names = ["ffn1/bias", "ffn1/kernel", "ffn2/bias", "ffn2/kernel"]
        for rank, r in enumerate(res):
            assert float(np.abs(np.asarray(r["ef"][1])).sum()) > 0
            mine = dict(zip(["ffn1/kernel", "ffn1/bias", "ffn2/kernel",
                             "ffn2/bias"], r["ef"]))
            for name_, leaf in zip(names, ef):
                _close(mine[name_], np.asarray(leaf)[rank], TOL_COMPRESSED)


def test_grad_bytes_and_comm_ms_metered(gangs):
    """train.grad_bytes: the >= 4x int8 wire cut (exactly the bytes a
    parameter); train.comm_ms: the per-epoch all-reduce probe."""
    none = _case(gangs, 2, "none")[0]["snapshot"]
    int8 = _case(gangs, 2, "int8")[0]["snapshot"]
    n_params = 8 * 32 + 32 + 32 * 4 + 4
    steps_none, steps_int8 = 4, 2
    assert none["train.grad_bytes"] == 4 * n_params * steps_none
    assert int8["train.grad_bytes"] == 1 * n_params * steps_int8
    assert (none["train.grad_bytes"] / steps_none) / (
        int8["train.grad_bytes"] / steps_int8) >= 4.0
    assert none["train.comm_ms"]["count"] >= 1
    assert "train.grad_bytes" not in _case(gangs, 2, "dp")[0]["snapshot"]


def test_int8_error_feedback_checkpoints(gangs):
    """The ``ef`` leaf ``[S, ...]`` is written as a sharded leaf (one slice
    a rank), restored into each rank's residuals, and training goes on;
    the JAX package restores the same checkpoint."""
    saved = _case(gangs, 2, "int8")
    resumed = _case(gangs, 2, "int8_resumed")
    assert all(np.isfinite(r["loss"]).all() for r in resumed)
    path = str(gangs["root"] / "2_int8")
    tree = jckpt.restore(path)
    ef = tree["ef"]
    for rank, r in enumerate(saved):
        mine = dict(zip(["ffn1/kernel", "ffn1/bias", "ffn2/kernel",
                         "ffn2/bias"], r["ef"]))
        for layer in ("ffn1", "ffn2"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    np.asarray(ef[layer][leaf])[rank],
                    np.asarray(mine[f"{layer}/{leaf}"], np.float32))
    # the JAX Estimator resumes from it on its own mesh of 2
    jest = _jax_estimator({"data": 2}, grad_compression="int8")
    jest._ensure_initialized(jnp.asarray(_data()[0][:32]))
    jest.load(path)
    hist = jest.fit(_data(), epochs=1, batch_size=32, verbose=False)
    _close(resumed[0]["loss"], hist["loss"], TOL_COMPRESSED)


def test_2d_checkpoint_save_restore_roundtrip(gangs):
    """The 2d layout's checkpoint: one shards file a process, restored
    whole by both packages with the trained values, resumed by the port
    on the same mesh (the loaded run's epoch equals the saving run's next
    epoch bit for bit)."""
    saved = _case(gangs, 4, "2d")
    loaded = _case(gangs, 4, "2d_loaded")
    path = gangs["root"] / "4_2d"
    names = sorted(p.name for p in path.iterdir())
    for pid in range(4):
        assert any(n.startswith("shards_") and n.endswith(f"_p{pid}.npz")
                   for n in names), names
    meta = json.loads((path / "treedef.json").read_text())
    specs = [e.get("spec") for e in meta["sharded"] if e]
    assert [None, "model"] in specs and ["model"] in specs
    jtree = jckpt.restore(str(path))
    ttree = ckpt_io.restore(str(path))
    for a, b, want in zip(_leaves(jtree["params"]),
                          _leaves(ttree["params"]),
                          _leaves(saved[0]["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, np.asarray(want, np.float32))
    assert loaded[0]["loss"] == saved[0]["more_loss"]


def test_jax_checkpoint_restores_in_a_port_gang(gangs, tmp_path):
    """The reverse way: the port's multi-process restore reads the JAX
    package's checkpoint (one process, dense layout) into every rank."""
    jloss, jest = _jax_fit({"data": 2, "model": 2}, sharding="2d",
                           epochs=1)
    jest.save(str(tmp_path / "j"))
    tree = ckpt_io.restore(str(tmp_path / "j"))
    for a, b in zip(_leaves(tree["params"]),
                    _leaves(jest.get_model()["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_2d_on_data_only_mesh_warns_and_trains_dp(gangs):
    res = _case(gangs, 2, "2d_on_data_mesh")
    assert np.isfinite(res[0]["loss"][0])
    assert any("no sized model axis" in w for w in res[0]["warnings"])
    assert res[0]["loss"] == _case(gangs, 2, "dp")[0]["loss"][:1]


@pytest.mark.parametrize("world,name,sharding", [
    (2, "bert_tp", "tp"), (4, "bert_2d", "2d"),
    (4, "bert_tp+fsdp", "tp+fsdp")])
def test_tensor_parallel_transformer_matches_jax(gangs, world, name,
                                                 sharding):
    """A 2-layer BERT classifier whose TransformerLayers compute their
    blocks over the model axis (each rank its 2 of 4 heads, through the
    attention core on local tensors, and its half of the ffn), against
    the JAX Estimator on the same mesh: losses, evaluate and parameters
    at 1e-4."""
    res = _case(gangs, world, name)
    assert len(res[0]["tp_layers"]) == BERT_CFG["n_layers"]
    est = _jax_estimator(_jax_mesh(world, name), model="bert", lr=0.05,
                         sharding=sharding)
    hist = est.fit(_bert_data(), epochs=1, batch_size=8, verbose=False)
    _close(res[0]["loss"], hist["loss"])
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
    _close(res[0]["eval"]["loss"], est.evaluate(_bert_data(),
                                                batch_size=8)["loss"])
    for got, want in zip(_leaves(res[0]["params"]),
                         _leaves(est.get_model()["params"])):
        _close(got, want)


def test_nan_policy_rollback_across_processes(gangs):
    """A NaN at step 3 on every rank reads as NaN in the global loss of
    every rank: all roll back to the epoch-1 checkpoint together and end
    on the clean run's losses and parameters."""
    res = _case(gangs, 2, "rollback")
    clean = _case(gangs, 2, "dp")[0]
    for r in res:
        assert r["rollbacks"] == 1 and r["bad_steps"] == 1
        assert r["loss"] == clean["loss"]
        assert r["params"] == clean["params"]


def test_grad_compression_composes_with_2d(gangs):
    dp = _case(gangs, 4, "dp")[0]["loss"]
    d2 = _case(gangs, 4, "2d_int8")[0]["loss"]
    assert abs(d2[-1] - dp[0]) < 0.02


def test_backend_and_mesh_of_the_gang(gangs):
    for world in (2, 4):
        for rank, r in enumerate(_case(gangs, world, "dp")):
            assert r["backend"] == "gloo" and r["rank"] == rank
            assert r["mesh"] == {"data": world}
