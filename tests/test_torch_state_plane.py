"""The port's state plane against the JAX package on the CPU, and its
card-only facts.

- A checkpoint written by either Estimator (sync ``save``, or async
  trigger saves through the manager: full and, for the ShardedEmbedding
  NCF, delta generations) loads in the other, for sgd-momentum, adam and
  adamw on a schedule; one more epoch then gives the other package's
  resumed losses and parameters within 1e-5 of max(1, |x|) (the same f32
  math in another evaluation order, as tests/test_torch_training.py
  holds the optimizers), and the JAX Estimator finds the optimizer state
  without a "reinitialized" warning; every named optimizer's state has
  the layout of the JAX package's ``tx.init``.
- The port resumed from its own checkpoint equals its straight run bit for
  bit (dropout masks from the restored generator, Adam's moments and step
  tensors, the schedule's count, batch norm's running statistics).
- ``save_model`` -> ``load_zoo_model`` both ways between the packages (a
  2-layer BERT: 1e-4, two layers of f32 summed in different orders);
  ``zoo-serving --model-dir`` on the CPU and ``SubprocessReplicaFactory``;
  ``chip_smoke.py``'s state_plane phase at tiny sizes on the CPU.
- ``cuda`` tests (they skip without a card): a load into an estimator that
  has captured its step, the dropout masks after a resume, an async
  snapshot beside the next replays, the touched-row masks on the card.
"""

import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.models import BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.models import ZooModel as JaxZooModel
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.orca.learn.trigger import \
    SeveralIteration as JaxSeveralIteration
from analytics_zoo_tpu.serving import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
from analytics_zoo_tpu_torch.core import ckpt_manager as cm
from analytics_zoo_tpu_torch.core import faults as faults_lib
from analytics_zoo_tpu_torch.core import launcher
from analytics_zoo_tpu_torch.models import (BERTClassifier, BERTSQuAD,
                                            NeuralCF, ResNet, ZooModel,
                                            squad_span_loss)
from analytics_zoo_tpu_torch.orca.learn import Estimator, SeveralIteration
from analytics_zoo_tpu_torch.serving import (InferenceModel, InputQueue,
                                             OutputQueue)
from analytics_zoo_tpu_torch.serving.controller import \
    SubprocessReplicaFactory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, BATCH = 64, 16  # 4 steps an epoch
SCHEDULE = {"schedule": "warmup_cosine", "peak": 1e-2, "warmup_steps": 3,
            "decay_steps": 20}
OPTIMIZERS = {"momentum": 0.05, "adam": 1e-2, "adamw": SCHEDULE}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > 1e-5 * np.maximum(1.0, np.abs(want))
    assert not bad.any(), (what, np.abs(got - want).max())


def _trees_close(got, want, path=""):
    """Leaf for leaf (an empty subtree, a JAX layer's empty state, holds
    none)."""
    gl, wl = ckpt_io.leaf_paths(got), ckpt_io.leaf_paths(want)
    assert gl == wl, path
    for p, g, w in zip(gl, ckpt_io.flatten(got)[0], ckpt_io.flatten(want)[0]):
        _close(g, w, f"{path}/{p}")


# -- the models of the cross-package tests ------------------------------------

def _dense_pair():
    return (lambda: jnn.Sequential([jnn.Dense(16, activation="relu"),
                                    jnn.Dense(3)]),
            lambda: tnn.Sequential([tnn.Dense(6, 16, activation="relu"),
                                    tnn.Dense(16, 3)]))


def _dense_data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(ROWS, 6)).astype(np.float32),
            rng.integers(0, 3, ROWS).astype(np.int32))


NCF = dict(user_count=300, item_count=200, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8,
           sharded_embeddings=True)


def _sparse_pair():
    return lambda: JaxNeuralCF(**NCF), lambda: NeuralCF(**NCF)


def _sparse_data():
    rng = np.random.default_rng(1)
    x = np.stack([rng.integers(0, 300, ROWS),
                  rng.integers(0, 200, ROWS)], 1).astype(np.int32)
    return x, (rng.random(ROWS) < 0.5).astype(np.int32)


MODELS = {"dense": (_dense_pair, _dense_data),
          "sparse": (_sparse_pair, _sparse_data)}


def _train_and_save(est, data, mode, path, jax_side, sparse):
    """One epoch, saved: ``est.save`` (sync) or trigger saves every 2
    steps through the manager (async: at steps 2 and 4 and at the epoch's
    end, step 4 again; the NCF's tables as deltas after the first)."""
    trig = None
    if mode == "async":
        trig = JaxSeveralIteration(2) if jax_side else SeveralIteration(2)
    est.fit(data, epochs=1, batch_size=BATCH, verbose=False,
            checkpoint_trigger=trig)
    if mode == "sync":
        est.save(path)
    else:
        est._ckpt_mgr.flush()
        kinds = [r["kind"] for r in est._ckpt_mgr.generations()]
        assert kinds == (["full", "delta", "delta"] if sparse
                         else ["full"] * 3), kinds


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_checkpoints_cross_between_the_estimators(tmp_path, caplog, opt,
                                                  mode, model):
    make_pair, make_data = MODELS[model]
    jmodel, tmodel = make_pair()
    x, y = make_data()
    kw = dict(loss="sparse_categorical_crossentropy", optimizer=opt,
              learning_rate=OPTIMIZERS[opt], seed=5)
    async_kw = {"checkpoint_async": mode == "async"}
    if mode == "async":  # every trigger lands, whatever the writer's pace
        async_kw["checkpoint_inflight"] = "block"
    # JAX writes, the port resumes
    dj = str(tmp_path / "jax")
    jest = JaxEstimator.from_keras(jmodel(), model_dir=dj, **async_kw, **kw)
    jest._ensure_initialized(jnp.asarray(x[:BATCH]))
    init = jest.get_model()
    _train_and_save(jest, (x, y), mode, dj, True, model == "sparse")
    jres = JaxEstimator.from_keras(jmodel(), model_dir=dj, **async_kw, **kw)
    jres.load(dj)
    want = jres.fit((x, y), epochs=1, batch_size=BATCH, verbose=False)
    tres = Estimator.from_keras(tmodel(), model_dir=dj, device="cpu",
                                **async_kw, **kw)
    tres.load(dj)
    assert (tres._py_step, tres._epoch) == (4, 1)
    got = tres.fit((x, y), epochs=1, batch_size=BATCH, verbose=False)
    _close(got["loss"], want["loss"], "jax -> port loss")
    _trees_close(tres.get_model(), jres.get_model(), "jax -> port")
    # the port writes, JAX resumes, with the optimizer state kept
    dt = str(tmp_path / "port")
    port = tmodel()
    port.load_state_dict(from_jax_variables(init), strict=True)
    test = Estimator.from_keras(port, model_dir=dt, device="cpu",
                                **async_kw, **kw)
    _train_and_save(test, (x, y), mode, dt, False, model == "sparse")
    tres2 = Estimator.from_keras(tmodel(), model_dir=dt, device="cpu",
                                 **async_kw, **kw)
    tres2.load(dt)
    got2 = tres2.fit((x, y), epochs=1, batch_size=BATCH, verbose=False)
    jres2 = JaxEstimator.from_keras(jmodel(), model_dir=dt, **async_kw,
                                    **kw)
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu"):
        jres2.load(dt)
    assert not [r for r in caplog.records
                if "reinitialized" in r.getMessage()]
    assert int(np.asarray(jres2._ts["step"])) == 4 and jres2._epoch == 1
    want2 = jres2.fit((x, y), epochs=1, batch_size=BATCH, verbose=False)
    _close(got2["loss"], want2["loss"], "port -> jax loss")
    _trees_close(tres2.get_model(), jres2.get_model(), "port -> jax")


LAYOUTS = [("sgd", 0.1, {}), ("sgd", SCHEDULE, {}), ("momentum", 0.1, {}),
           ("adam", 1e-3, {}), ("adam", SCHEDULE, {"grad_clip_norm": 1.0}),
           ("adamw", 1e-3, {}), ("adamw", SCHEDULE, {}),
           ("rmsprop", 1e-3, {}), ("rmsprop", SCHEDULE, {"momentum": 0.9}),
           ("adagrad", 1e-3, {}), ("adagrad", SCHEDULE, {})]


@pytest.mark.parametrize("name,lr,kw", LAYOUTS)
def test_optimizer_state_has_optax_tx_init_layout(name, lr, kw):
    """Every named optimizer's state in optax's layout has the leaf paths,
    shapes and dtypes of the JAX package's ``tx.init`` over the same
    parameters (the JAX load keeps a state only when they fit)."""
    import analytics_zoo_tpu.orca.learn.optimizers as jopt
    from analytics_zoo_tpu_torch.convert import jax_tree
    from analytics_zoo_tpu_torch.orca.learn import optimizers as topt
    clip = kw.pop("grad_clip_norm", None)
    _, tmodel = _dense_pair()
    model = tmodel()
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    opt = topt.get(name, lr, grad_clip_norm=clip, **kw)
    live = topt.snapshot(opt.optax_state(
        params, opt.init(params), lambda ts: jax_tree(zip(names, ts))))
    tree = jax_tree(zip(names, params))
    jparams = {k: {n: jnp.asarray(t.detach().numpy()) for n, t in v.items()}
               for k, v in tree.items()}
    want = jopt.get(name, lr, grad_clip_norm=clip, **kw).init(jparams)
    assert ckpt_io.leaf_paths(live) == ckpt_io.leaf_paths(want)
    for a, b in zip(ckpt_io.flatten(live)[0], ckpt_io.flatten(want)[0]):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        np.testing.assert_array_equal(a.numpy(), b)


def test_saved_tree_has_the_jax_estimator_keys(tmp_path):
    _, tmodel = _dense_pair()
    est = Estimator.from_keras(tmodel(), loss="mse", optimizer="adam",
                               device="cpu", seed=9)
    tree = ckpt_io.restore(est.save(str(tmp_path)))
    assert set(tree) == {"params", "state", "opt_state", "step", "rng",
                         "bad_steps", "torch_generators"}
    np.testing.assert_array_equal(tree["rng"], np.asarray([0, 9],
                                                          np.uint32))
    assert int(tree["step"]) == 0 and int(tree["bad_steps"]) == 0
    # adam before any step: torch.optim's lazy state made at zero
    (count, mu, nu), empty = tree["opt_state"]
    assert int(count) == 0 and empty == ()
    assert set(mu) == {"00_layer0", "01_layer1"} and set(nu) == set(mu)


def test_a_state_that_does_not_fit_the_optimizer_raises_naming_it(tmp_path):
    x, y = _dense_data()
    _, tmodel = _dense_pair()
    est = Estimator.from_keras(tmodel(), loss="sparse_categorical_"
                               "crossentropy", optimizer="adam",
                               device="cpu")
    est.fit((x, y), epochs=1, batch_size=BATCH, verbose=False)
    est.save(str(tmp_path))
    other = Estimator.from_keras(tmodel(), loss="sparse_categorical_"
                                 "crossentropy", optimizer="momentum",
                                 learning_rate=0.1, device="cpu")
    with pytest.raises(ValueError, match="at leaf '0/0'"):
        other.load(str(tmp_path))


# -- the port resumed equals its straight run ---------------------------------

def _squad(dropout=0.1):
    return BERTSQuAD(vocab_size=100, hidden_size=32, n_layers=2, n_heads=4,
                     max_position=20, dropout=dropout, use_flash=True)


def _squad_data(n=32):
    rng = np.random.default_rng(2)
    return (rng.integers(0, 100, (n, 20)).astype(np.int32),
            rng.integers(0, 20, (n, 2)).astype(np.int32))


def _resnet():
    return ResNet(depth=18, class_num=10, width=8)


def _images(n=16):
    rng = np.random.default_rng(3)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


RESUMES = {
    "bert_adamw_dropout": (_squad, _squad_data, 16,
                           dict(loss=squad_span_loss, optimizer="adamw",
                                learning_rate=SCHEDULE)),
    "resnet_momentum_bn": (_resnet, _images, 8,
                           dict(loss="sparse_categorical_crossentropy",
                                optimizer="momentum", learning_rate=0.05)),
}


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("case", sorted(RESUMES))
def test_port_resume_equals_its_straight_run_bit_for_bit(tmp_path, case,
                                                         mode):
    make, data, batch, kw = RESUMES[case]
    state = make().state_dict()

    def est(**more):
        model = make()
        model.load_state_dict(state)
        return Estimator.from_keras(model, device="cpu", seed=11, **kw,
                                    **more)

    xy = data()
    straight = est()
    want = straight.fit(xy, epochs=4, batch_size=batch, verbose=False)
    d = str(tmp_path / "ckpt")
    first = est(model_dir=d, checkpoint_async=mode == "async")
    first.fit(xy, epochs=2, batch_size=batch, verbose=False,
              checkpoint_trigger="every_epoch")
    second = est(model_dir=d, checkpoint_async=mode == "async")
    got = second.fit(xy, epochs=4, batch_size=batch, verbose=False,
                     auto_resume=True)
    assert got["loss"] == want["loss"][2:]
    assert second._py_step == straight._py_step
    for (k, a), b in zip(second.model.state_dict().items(),
                         straight.model.state_dict().values()):
        assert torch.equal(a, b), k
    opt_a = ckpt_io.flatten(second._save_tree()["opt_state"])[0]
    opt_b = ckpt_io.flatten(straight._save_tree()["opt_state"])[0]
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(opt_a, opt_b))


def test_mid_epoch_checkpoint_resumes_its_epoch_from_the_start(tmp_path):
    """The JAX package's semantics: the interrupted epoch runs again from
    its start (its shuffle), the step count carried on."""
    x, y = _dense_data()
    _, tmodel = _dense_pair()
    d = str(tmp_path)
    kw = dict(loss="sparse_categorical_crossentropy", device="cpu",
              model_dir=d)
    first = Estimator.from_keras(tmodel(), **kw)
    first.fit((x, y), epochs=1, batch_size=BATCH, verbose=False,
              checkpoint_trigger=SeveralIteration(3))
    assert ckpt_io.latest_step(d) == 3
    assert ckpt_io.load_extra(d) == {"epoch": 0}
    second = Estimator.from_keras(tmodel(), **kw)
    hist = second.fit((x, y), epochs=2, batch_size=BATCH, verbose=False,
                      auto_resume=True)
    assert len(hist["loss"]) == 2 and second._py_step == 3 + 8


def test_touched_masks_mark_no_row_for_the_padding(tmp_path):
    """A batch of a few distinct ids, none of them 0: the static-size
    unique's padded slots (id 0) mark nothing, and the masks hold exactly
    the looked-up rows."""
    x = np.array([[5, 7], [5, 9], [11, 7], [5, 9]] * 4, np.int32)
    y = np.zeros(len(x), np.int32)
    est = Estimator.from_keras(NeuralCF(**NCF), model_dir=str(tmp_path),
                               checkpoint_async=True, device="cpu",
                               loss="sparse_categorical_crossentropy")
    est.fit((x, y), epochs=1, batch_size=16, verbose=False)
    for tp, ids in est._collect_touched().items():
        want = [5, 11] if "user" in tp else [7, 9]
        assert ids.tolist() == want, tp


def test_nan_policy_rollback_still_waits_for_item_7(tmp_path):
    """On one process ``nan_policy="rollback"`` reloads ``model_dir`` in
    place and re-runs the epoch (across processes every rank reads the
    same global loss, so all roll back together): a NaN at step 3 of 4
    ends on the clean run's losses
    and parameters, bit for bit, with the step count rewound."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    init = tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                           tnn.Dense(8, 1)]).state_dict()

    def mkest(**kw):
        model = tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                                tnn.Dense(8, 1)])
        model.load_state_dict(init)
        return Estimator.from_keras(model, loss="mse", optimizer="adam",
                                    learning_rate=1e-3, device="cpu", **kw)

    clean_est = mkest()
    clean = clean_est.fit((x, y), epochs=2, batch_size=32, verbose=False)
    est = mkest(nan_policy="rollback", model_dir=str(tmp_path / "ckpt"))
    with faults_lib.get_registry().armed("step.nan", times=1, after=2):
        hist = est.fit((x, y), epochs=2, batch_size=32,
                       checkpoint_trigger="every_epoch", verbose=False)
    assert est._rollbacks == 1 and est.bad_steps == 1
    assert est._py_step == 4
    assert hist["loss"] == clean["loss"]
    assert hist["bad_steps"] == [0, 0]
    for a, b in zip(est.model.parameters(), clean_est.model.parameters()):
        assert torch.equal(a, b)


# -- saved models and serving --------------------------------------------------

BERT_CFG = dict(vocab_size=100, hidden_size=32, n_layers=2, n_heads=4,
                max_position=20, dropout=0.0)


def _ids(n=5, seed=4):
    return np.random.default_rng(seed).integers(0, 100, (n, 20)).astype(
        np.int32)


def test_jax_saved_model_serves_in_the_port(tmp_path):
    jm = JaxBERTClassifier(3, **BERT_CFG)
    jm.compile(loss="sparse_categorical_crossentropy")
    jm.estimator._ensure_initialized(jnp.asarray(_ids()))
    jm.save_model(str(tmp_path))
    want = JaxInferenceModel().load_zoo_model(str(tmp_path)).predict(_ids())
    got = InferenceModel(device="cpu").load_zoo_model(
        str(tmp_path)).predict(_ids())
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    model = ZooModel.load_model(str(tmp_path))
    assert isinstance(model, BERTClassifier)
    # compile starts from the loaded weights
    model.compile(loss="sparse_categorical_crossentropy", device="cpu")
    got_vars = model.estimator.get_model()["params"]
    want_vars = jm.estimator.get_model()["params"]
    _trees_close(got_vars, jax_numpy(want_vars))


def jax_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_port_saved_model_serves_in_jax(tmp_path):
    m = BERTClassifier(3, **BERT_CFG, dtype=torch.bfloat16)
    m.init_weights(torch.Generator().manual_seed(0))
    m.save_model(str(tmp_path))
    back = ZooModel.load_model(str(tmp_path))
    assert back._config["dtype"] == torch.bfloat16
    m32 = BERTClassifier(3, **BERT_CFG)
    m32.load_state_dict(m.state_dict())
    m32.save_model(str(tmp_path / "f32"))
    want = InferenceModel(device="cpu").load_zoo_model(
        str(tmp_path / "f32")).predict(_ids())
    jm = JaxZooModel.load_model(str(tmp_path / "f32"))
    assert type(jm).__name__ == "BERTClassifier"
    got = JaxInferenceModel().load_zoo_model(
        str(tmp_path / "f32")).predict(_ids())
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4, rtol=1e-4)


def _saved_bert(path):
    m = BERTClassifier(3, **BERT_CFG)
    m.init_weights(torch.Generator().manual_seed(1))
    m.save_model(path)
    return InferenceModel(device="cpu").load_zoo_model(path)


def _query(port, rows):
    iq = InputQueue("127.0.0.1", port)
    oq = OutputQueue(input_queue=iq)
    try:
        return [oq.query(iq.enqueue(f"r{i}", t=r), timeout=60.0)
                for i, r in enumerate(rows)]
    finally:
        iq.close()


def test_zoo_serving_cli_answers_on_the_cpu(tmp_path):
    d = str(tmp_path / "model")
    direct = _saved_bert(d)
    port = launcher._free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.server",
         "--model-dir", d, "--port", str(port), "--device", "cpu",
         "--batch-size", "4"], env=env, cwd=REPO)
    try:
        assert launcher.wait_serving_ready("127.0.0.1", port, proc=proc,
                                           timeout=120.0)
        rows = _ids(6)
        got = _query(port, rows)
        want = direct.predict(rows)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    finally:
        launcher._terminate_gang([proc], grace=10.0)
    assert proc.returncode is not None


def test_subprocess_replica_factory_starts_and_retires_a_child(tmp_path):
    d = str(tmp_path / "model")
    direct = _saved_bert(d)
    factory = SubprocessReplicaFactory(
        ["--model-dir", d, "--device", "cpu"], startup_timeout=120.0)
    handle = factory.create()
    try:
        assert handle.obj.poll() is None
        rows = _ids(2, seed=7)
        got = _query(handle.port, rows)
        np.testing.assert_allclose(np.stack(got), direct.predict(rows),
                                   atol=1e-5, rtol=1e-5)
    finally:
        factory.retire(handle)
    assert handle.obj.poll() is not None


def test_chip_smoke_state_plane_phase_runs_on_the_cpu_at_tiny_sizes():
    """``chip_smoke.py``'s state_plane phase end to end through its CPU
    seam (``StatePlaneSizes(device="cpu")``, tiny widths): its resume,
    preemption, restore and serving checks hold here too."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    sizes = chip_smoke.StatePlaneSizes(
        device="cpu", ncf=dict(NCF), rows=256, batch=64,
        resnet=dict(depth=18, class_num=10, width=8, stem="space_to_depth",
                    norm="batch", dtype="float32"),
        image=32, images=32, resnet_batch=8,
        bert=dict(BERT_CFG, intermediate_mult=4, max_position=32),
        seq=32, examples=16, squad_batch=8)
    res = chip_smoke.phase_state_plane(None, None, sizes)
    assert res["checkpoint_bench"]["modes"]["async"]["verify"] == []
    assert res["resnet"]["in_place_load_losses_equal"]
    assert res["squad"]["zoo_serving"]["requests"] == chip_smoke.SP_SERVE


def test_gang_launcher_waits_for_item_7(tmp_path, monkeypatch):
    # the gang launcher runs now: a 2-process CPU gang whose workers join
    # the context over gloo from the launcher's environment
    script = tmp_path / "job.py"
    out = tmp_path / "out"
    script.write_text(
        "import sys\n"
        "from analytics_zoo_tpu_torch.core.context import "
        "init_orca_context\n"
        "m = init_orca_context('multihost')\n"
        "open(sys.argv[1] + str(m.rank), 'w').write(f'{m.rank}/{m.size} '"
        "f'{m.backend}')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    assert launcher.launch(str(script), [str(out)], 2, platform="cpu",
                           timeout=120) == 0
    assert [(tmp_path / f"out{r}").read_text() for r in (0, 1)] == [
        "0/2 gloo", "1/2 gloo"]
    with pytest.raises(SystemExit):
        launcher.main([])  # --nprocs and the script are required


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels run "
                    "there")
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _step_losses(est, data, epochs, batch, **fit_kw):
    losses = []
    inner = est._train_step

    def step(b):
        loss = inner(b)
        losses.append(loss.clone())
        return loss

    est._train_step = step
    est.fit(data, epochs=epochs, batch_size=batch, verbose=False, **fit_kw)
    return [float(v) for v in losses]


def _card_squad(state, **kw):
    model = _squad(0.1)
    model.load_state_dict(state)
    return Estimator.from_keras(model, loss=squad_span_loss,
                                optimizer="adamw", learning_rate=SCHEDULE,
                                seed=11, **kw)


@pytest.mark.cuda
def test_load_after_a_capture_equals_a_fresh_load(tmp_path):
    """A load into an estimator whose step is captured copies into the
    tensors the graph replays on (parameters, Adam's moments and step
    tensors, the count, the dropout generator's state): one more epoch
    gives a fresh estimator's losses after the same load, bit for bit."""
    _card()
    xy = _squad_data(32)
    state = _squad(0.1).state_dict()
    d = str(tmp_path)
    _card_squad(state, model_dir=d).fit(
        xy, epochs=1, batch_size=16, verbose=False,
        checkpoint_trigger="every_epoch")
    used = _card_squad(state)
    used.fit(xy, epochs=3, batch_size=16, verbose=False)
    assert used.capture_count == 1
    ptrs = [p.data_ptr() for p in used.model.parameters()]
    used.load(d)
    assert [p.data_ptr() for p in used.model.parameters()] == ptrs
    got = _step_losses(used, xy, 1, 16)
    fresh = _card_squad(state)
    fresh.load(d)
    want = _step_losses(fresh, xy, 1, 16)
    assert got == want and used.capture_count == 1
    for a, b in zip(used.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_resumed_dropout_masks_equal_the_straight_runs(tmp_path):
    """From CUDA graphs with the dropout generator registered: the resumed
    fit's step losses and weights equal the straight run's, and the
    generator draws the same numbers after the resume."""
    _card()
    xy = _squad_data(32)
    state = _squad(0.1).state_dict()
    straight = _card_squad(state)
    want = _step_losses(straight, xy, 4, 16)
    d = str(tmp_path)
    _card_squad(state, model_dir=d, checkpoint_async=True).fit(
        xy, epochs=2, batch_size=16, verbose=False,
        checkpoint_trigger="every_epoch")
    resumed = _card_squad(state, model_dir=d, checkpoint_async=True)
    got = _step_losses(resumed, xy, 4, 16, auto_resume=True)
    assert got == want[4:]
    for a, b in zip(resumed.model.state_dict().values(),
                    straight.model.state_dict().values()):
        assert torch.equal(a, b)
    ga, gb = resumed._generators_list()[0], straight._generators_list()[0]
    assert torch.equal(ga.get_state(), gb.get_state())
    assert torch.equal(torch.rand(64, device="cuda", generator=ga),
                       torch.rand(64, device="cuda", generator=gb))


@pytest.mark.cuda
def test_async_snapshots_are_not_torn_by_the_next_replays(tmp_path):
    """A save after every step while the writer is stalled: each
    generation that lands holds the state of its own step (cloned right
    after that step, in stream order), not a later one's."""
    _card()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 512)).astype(np.float32)
    y = rng.integers(0, 8, 256).astype(np.int32)
    model = tnn.Sequential([tnn.Dense(512, 2048, activation="relu"),
                            tnn.Dense(2048, 8)])
    est = Estimator.from_keras(model, loss="sparse_categorical_"
                               "crossentropy", optimizer="adam",
                               model_dir=str(tmp_path),
                               checkpoint_async=True,
                               checkpoint_inflight="block",
                               checkpoint_keep_last=0)
    truth = {}
    inner = est._train_step

    def step(b):
        loss = inner(b)
        truth[est._py_step] = [p.detach().clone()
                               for p in est.model.parameters()]
        return loss

    est._train_step = step
    with faults_lib.get_registry().armed("checkpoint.slow_write", times=3,
                                         delay=0.2):
        est.fit((x, y), epochs=1, batch_size=32, verbose=False,
                checkpoint_trigger=SeveralIteration(1))
    gens = est._ckpt_mgr.generations()
    # a save after each step, and the epoch end's again at step 8
    assert [r["step"] for r in gens] == list(range(1, 9)) + [8]
    names = [n for n, _ in est.model.named_parameters()]
    for rec in gens:
        tree = ckpt_io.restore(os.path.join(str(tmp_path), rec["dir"]))
        got = from_jax_variables({"params": tree["params"]})
        for name, want in zip(names, truth[rec["step"]]):
            np.testing.assert_array_equal(got[name].numpy(),
                                          want.cpu().numpy())


@pytest.mark.cuda
def test_touched_masks_on_the_card_skip_the_padding(tmp_path):
    """The mask marking is captured with the step: after a captured epoch
    the masks hold exactly the rows looked up, none for the padding."""
    _card()
    x = np.array([[5, 7], [5, 9], [11, 7], [5, 9]] * 8, np.int32)
    y = np.zeros(len(x), np.int32)
    est = Estimator.from_keras(NeuralCF(**NCF), model_dir=str(tmp_path),
                               checkpoint_async=True,
                               loss="sparse_categorical_crossentropy")
    est.fit((x, y), epochs=2, batch_size=16, verbose=False)
    assert est.capture_count == 1
    for tp, ids in est._collect_touched().items():
        want = [5, 11] if "user" in tp else [7, 9]
        assert ids.tolist() == want, tp
