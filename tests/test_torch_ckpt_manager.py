"""The port's asynchronous checkpoint manager (``core/ckpt_manager.py``) on
the CPU: twins of ``tests/test_ckpt_manager.py``'s manager, CLI, estimator
and serving tests over torch tensors, plus the port's own snapshot rule
(a snapshot is a copy: the step that follows updates the tensors in
place).  Exact: nothing here computes, so restores are held bit for bit."""

import os

import numpy as np
import pytest
import torch

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
from analytics_zoo_tpu_torch.core import ckpt_manager as cm
from analytics_zoo_tpu_torch.core import faults as faults_lib
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.orca.learn import Estimator, SeveralIteration
from analytics_zoo_tpu_torch import nn as tnn

TP = "params/emb/sharded_embeddings"


def _tree(table_val=0.0, w_val=1.0, rows=16, dim=4):
    return {"params": {"w": torch.full((3, 3), w_val),
                       "emb": {"sharded_embeddings":
                               torch.full((rows, dim), table_val)}},
            "step": np.asarray(0)}


def _set(t, row, val):
    tbl = t["params"]["emb"]["sharded_embeddings"].clone()
    tbl[row] = val
    t["params"]["emb"]["sharded_embeddings"] = tbl


def _wait_writing(m, timeout=10.0):
    """Until the writer thread has taken the pending snapshot (the port's
    snapshots are quick; the JAX twin's device copies gave it the time)."""
    import time
    deadline = time.monotonic() + timeout
    while m._writing is None:
        assert time.monotonic() < deadline, "the writer never started"
        time.sleep(0.005)


def _assert_trees_equal(a, b):
    la, sa = ckpt_io.flatten(a)
    lb, sb = ckpt_io.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- core manager semantics ---------------------------------------------------

def test_full_then_delta_roundtrip_and_verify(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d) as m:
        assert m.save_async(t, step=1)
        m.flush()
        _set(t, 3, 7.5)
        assert m.save_async(t, step=2, touched={TP: np.array([3])})
        m.flush()
        assert [r["kind"] for r in m.generations()] == ["full", "delta"]
        assert m.verify() == []
        _assert_trees_equal(m.restore(), t)


def test_delta_restore_equals_full_restore_exactly(tmp_path):
    da, db = str(tmp_path / "delta"), str(tmp_path / "full")
    t = _tree()
    with cm.CheckpointManager(da) as m:
        m.save(t, step=1)
        for i, step in enumerate(range(2, 5)):
            _set(t, i, float(step))
            t["params"]["w"] = t["params"]["w"] + 1.0
            t["step"] = np.asarray(step)
            m.save(t, step=step, touched={TP: torch.tensor([i])})
        assert [r["kind"] for r in m.generations()] == \
            ["full", "delta", "delta", "delta"]
        got = m.restore()
    with cm.CheckpointManager(db) as m2:
        m2.save(t, step=4)
        want = m2.restore()
    _assert_trees_equal(got, want)


def test_delta_rows_preserve_bf16_bit_exact(tmp_path):
    d = str(tmp_path / "c")
    t = {"params": {"emb": {"sharded_embeddings":
                            torch.zeros(8, 4, dtype=torch.bfloat16)}},
         "step": np.asarray(0)}
    with cm.CheckpointManager(d) as m:
        m.save(t, step=1)
        tbl = t["params"]["emb"]["sharded_embeddings"].clone()
        tbl[torch.tensor([1, 3])] = torch.tensor(
            [[0.1] * 4, [-2.5] * 4], dtype=torch.bfloat16)
        t["params"]["emb"]["sharded_embeddings"] = tbl
        m.save(t, step=2, touched={TP: np.array([1, 3])})
        rec = m.generations()[-1]
        assert rec["kind"] == "delta"
        assert rec["rows_dtype"] == {TP: "bfloat16"}
        assert m.verify() == []
        got = m.restore()["params"]["emb"]["sharded_embeddings"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), tbl.view(torch.int16))


def test_latest_wins_supersedes_pending_and_keeps_newest(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, inflight="latest-wins") as m:
        m.save(t, step=1)
        with faults_lib.get_registry().armed("checkpoint.slow_write",
                                             times=1, delay=0.4):
            _set(t, 2, 2.0)
            assert m.save_async(t, step=2, touched={TP: np.array([2])})
            _wait_writing(m)  # stalled on step 2
            _set(t, 5, 5.0)
            assert m.save_async(t, step=3, touched={TP: np.array([5])})
            _set(t, 5, 9.0)
            assert m.save_async(t, step=4, touched={TP: np.array([5])})
            m.flush()
        steps = [r["step"] for r in m.generations()]
        assert steps[0] == 1 and steps[-1] == 4
        assert len(steps) == 3, steps
        assert m.verify() == []
        tbl = m.restore()["params"]["emb"]["sharded_embeddings"]
        assert tbl[5, 0] == 9.0 and tbl[2, 0] == 2.0
    assert metrics_lib.get_registry().snapshot().get("ckpt.skipped", 0) >= 1


def test_skip_policy_drops_while_in_flight(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, inflight="skip") as m:
        with faults_lib.get_registry().armed("checkpoint.slow_write",
                                             times=1, delay=0.4):
            assert m.save_async(t, step=1)
            _wait_writing(m)
            assert m.save_async(t, step=2) is False
            m.flush()
        assert [r["step"] for r in m.generations()] == [1]
    assert metrics_lib.get_registry().snapshot().get("ckpt.skipped", 0) >= 1


def test_save_for_exit_reuses_inflight_snapshot(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d) as m:
        with faults_lib.get_registry().armed("checkpoint.slow_write",
                                             times=1, delay=0.3):
            assert m.save_async(t, step=7)
            assert m.save_for_exit(t, step=9, timeout=30.0) == 7
        assert [r["step"] for r in m.generations()] == [7]
        assert m.save_for_exit(t, step=9, timeout=30.0) == 9


def test_retention_gc_never_breaks_a_live_chain(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, keep_last=1, compact_every=100) as m:
        m.save(t, step=1)
        for step in range(2, 6):
            _set(t, step, float(step))
            m.save(t, step=step, touched={TP: np.array([step])})
        assert m.verify() == []
        _assert_trees_equal(m.restore(), t)
        m.save(t, step=6, force_full=True)
        m.save(t, step=7, force_full=True)
        recs, gcd = cm.read_manifest(d)
        assert gcd, "GC never fired"
        on_disk = {n for n in os.listdir(d) if n != cm.MANIFEST}
        assert not any(r["dir"] in on_disk for r in recs
                       if r.get("kind") != "gc" and r["gen"] in gcd)
        assert m.verify() == []
        _assert_trees_equal(m.restore(), t)


def test_anchor_generations_survive_retention(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, keep_last=2, anchor_every=3,
                              delta=False) as m:
        for step in range(8):
            t["step"] = np.asarray(step)
            m.save(t, step=step)
        steps = [r["step"] for r in m.generations()]
    assert steps == [0, 3, 6, 7], steps


def test_torn_manifest_tail_is_ignored(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d) as m:
        m.save(t, step=1)
    with open(os.path.join(d, cm.MANIFEST), "a") as f:
        f.write('{"kind": "full", "gen": "999999-dead", "ste')
    assert [r["step"] for r in cm.visible_generations(d)] == [1]
    tree, rec = cm.restore_path(d)
    assert rec["step"] == 1
    _assert_trees_equal(tree, t)


def _corrupt_newest(d):
    newest = cm.visible_generations(d)[-1]
    gen_dir = os.path.join(d, newest["dir"])
    victim = next(os.path.join(gen_dir, f) for f in os.listdir(gen_dir)
                  if f.endswith(".npz"))
    with open(victim, "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")


def test_corrupt_generation_falls_back_to_older(tmp_path):
    d = str(tmp_path / "c")
    t = _tree(w_val=1.0)
    with cm.CheckpointManager(d, delta=False) as m:
        m.save(t, step=1)
        m.save(_tree(w_val=2.0), step=2)
    _corrupt_newest(d)
    errors, _ = cm.verify_path(d)
    assert errors, "corruption not detected"
    tree, rec = cm.restore_path(d)
    assert rec["step"] == 1
    _assert_trees_equal(tree, t)


def test_write_failure_rewinds_chain_and_forces_full(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, retries=1, retry_delay=0.01) as m:
        m.save(t, step=1)
        _set(t, 1, 1.0)
        with faults_lib.get_registry().armed("checkpoint.write_fail",
                                             times=1):
            with pytest.raises(OSError):
                m.save(t, step=2, touched={TP: np.array([1])})
        _set(t, 2, 2.0)
        m.save(t, step=3, touched={TP: np.array([2])})
        assert m.generations()[-1]["kind"] == "full"
        assert m.verify() == []
        _assert_trees_equal(m.restore(), t)
    assert metrics_lib.get_registry().snapshot().get(
        "ckpt.write_errors", 0) >= 1


def test_compact_folds_deltas_into_fresh_full(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, compact_every=100) as m:
        m.save(t, step=1)
        for step in (2, 3):
            _set(t, step, float(step))
            m.save(t, step=step, touched={TP: np.array([step])})
        assert m.generations()[-1]["kind"] == "delta"
        gen = m.compact()
        newest = m.generations()[-1]
        assert newest["kind"] == "full" and newest["gen"] == gen
        _assert_trees_equal(m.restore(), t)


def test_delta_cadence_promotes_full_every_compact_every(tmp_path):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, compact_every=2, keep_last=100) as m:
        for step in range(6):
            t["step"] = np.asarray(step)
            m.save(t, step=step, touched={TP: np.array([0])})
        kinds = [r["kind"] for r in m.generations()]
    assert kinds == ["full", "delta", "delta", "full", "delta",
                     "delta"], kinds


def test_snapshot_is_a_copy_of_tensors_updated_in_place(tmp_path):
    """The estimator's step writes its tensors in place: what a save took
    must not move with them."""
    d = str(tmp_path / "c")
    t = _tree(w_val=1.0)
    with cm.CheckpointManager(d) as m:
        with faults_lib.get_registry().armed("checkpoint.slow_write",
                                             times=1, delay=0.2):
            assert m.save_async(t, step=1)
            t["params"]["w"].add_(5.0)  # the next step, in place
            m.flush()
        got = m.restore()
    np.testing.assert_array_equal(got["params"]["w"],
                                  np.ones((3, 3), np.float32))


def test_bad_inflight_policy_rejected(tmp_path):
    with pytest.raises(ValueError, match="inflight"):
        cm.CheckpointManager(str(tmp_path / "c"), inflight="yolo")


# -- CLI ----------------------------------------------------------------------

def test_cli_ls_verify_compact(tmp_path, capsys):
    d = str(tmp_path / "c")
    t = _tree()
    with cm.CheckpointManager(d, compact_every=100) as m:
        m.save(t, step=1)
        m.save(t, step=2, touched={TP: np.array([0])})
    assert cm.main(["ls", d]) == 0
    out = capsys.readouterr().out
    assert "full" in out and "delta" in out
    assert cm.main(["verify", d]) == 0
    assert cm.main(["compact", d]) == 0
    assert cm.main(["verify", d]) == 0
    _corrupt_newest(d)
    capsys.readouterr()
    assert cm.main(["verify", d]) == 1
    assert "ERROR" in capsys.readouterr().out


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys
    d = str(tmp_path / "c")
    with cm.CheckpointManager(d) as m:
        m.save(_tree(), step=1)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.core.ckpt_manager",
         "verify", d], capture_output=True, text=True, timeout=120,
        cwd=repo)
    assert out.returncode == 0, out.stderr
    assert "1 generation(s) verified clean" in out.stdout


# -- estimator integration ----------------------------------------------------

def _ncf():
    return NeuralCF(user_count=64, item_count=40, class_num=2,
                    user_embed=8, item_embed=8, hidden_layers=(16, 8),
                    mf_embed=8, sharded_embeddings=True).init_weights(
                        torch.Generator().manual_seed(0))


def _ratings(n=256, seed=42):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, 64, n),
                  rng.integers(0, 40, n)], 1).astype(np.int32)
    y = (rng.random(n) < 0.5).astype(np.int32)
    return x, y


KW = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
          learning_rate=1e-2, seed=7, device="cpu")


def _state(est):
    return {k: v for k, v in est._save_tree().items()
            if k in ("params", "state", "opt_state", "step")}


def test_estimator_async_equals_sync_bit_identical(tmp_path):
    x, y = _ratings()
    da, ds = str(tmp_path / "async"), str(tmp_path / "sync")
    ea = Estimator.from_keras(_ncf(), model_dir=da, checkpoint_async=True,
                              checkpoint_inflight="block", **KW)
    ea.fit((x, y), epochs=2, batch_size=64, verbose=False,
           checkpoint_trigger=SeveralIteration(2))
    es = Estimator.from_keras(_ncf(), model_dir=ds, **KW)
    es.fit((x, y), epochs=2, batch_size=64, verbose=False,
           checkpoint_trigger=SeveralIteration(2))
    ra = Estimator.from_keras(_ncf(), model_dir=da, checkpoint_async=True,
                              **KW)
    ra.load(da)
    rs = Estimator.from_keras(_ncf(), model_dir=ds, **KW)
    rs.load(ds)
    _assert_trees_equal(_state(ra), _state(rs))
    _assert_trees_equal(_state(ra), _state(ea))
    assert ra._py_step == rs._py_step == 8
    assert ra._ckpt_mgr.verify() == []
    kinds = [r["kind"] for r in ra._ckpt_mgr.generations()]
    assert kinds[0] == "full" and "delta" in kinds, kinds


def test_touched_masks_reset_only_when_a_snapshot_is_accepted(tmp_path):
    x, y = _ratings()
    est = Estimator.from_keras(_ncf(), model_dir=str(tmp_path),
                               checkpoint_async=True, **KW)
    est.fit((x[:64], y[:64]), epochs=1, batch_size=64, verbose=False)
    touched = est._collect_touched()
    users = np.unique(x[:64, 0])
    assert sorted(touched) == sorted(
        "params/" + tp for tp in est._sparse)
    for tp, ids in touched.items():
        want = users if "user" in tp else np.unique(x[:64, 1])
        np.testing.assert_array_equal(ids, want)
    est._ckpt_mgr.inflight_policy = "skip"
    with faults_lib.get_registry().armed("checkpoint.slow_write", times=1,
                                         delay=0.3):
        est._trigger_save()  # accepted: the masks reset
        assert all(not ids.size for ids in est._collect_touched().values())
        est.fit((x[64:128], y[64:128]), epochs=1, batch_size=64,
                verbose=False)
    assert all(ids.size for ids in est._collect_touched().values())


def test_checkpoint_async_resumes_legacy_sync_checkpoint(tmp_path):
    def _model():
        return tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                               tnn.Dense(8, 1)])

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    d = str(tmp_path / "m")
    kw = dict(loss="mse", learning_rate=1e-3, seed=3, device="cpu")
    legacy = Estimator.from_keras(_model(), model_dir=d, **kw)
    legacy.fit((x, y), epochs=1, batch_size=32, verbose=False)
    legacy.save(d)
    assert ckpt_io.exists(d) and not cm.has_manifest(d)
    est = Estimator.from_keras(_model(), model_dir=d,
                               checkpoint_async=True, **kw)
    est.load(d)
    _assert_trees_equal(_state(est), _state(legacy))
    est2 = Estimator.from_keras(_model(), model_dir=d,
                                checkpoint_async=True, **kw)
    est2.fit((x, y), epochs=2, batch_size=32, verbose=False,
             checkpoint_trigger="every_epoch", auto_resume=True)
    assert est2._py_step == 4
    gens = est2._ckpt_mgr.generations()
    assert gens and gens[0]["kind"] == "full"
    assert est2._ckpt_mgr.verify() == []


@pytest.mark.parametrize("knob", ["checkpoint_async",
                                  "preemption_checkpoint"])
def test_state_plane_knobs_require_model_dir(knob):
    with pytest.raises(ValueError, match="model_dir"):
        Estimator.from_keras(tnn.Dense(2, 1), loss="mse", device="cpu",
                             **{knob: True})


# -- serving integration ------------------------------------------------------

def test_swap_from_checkpoint_serves_latest_generation(tmp_path):
    from analytics_zoo_tpu_torch.serving import ModelRegistry
    d = str(tmp_path / "c")
    with cm.CheckpointManager(d, delta=False) as m:
        m.save(_tree(w_val=1.0), step=1)
        m.save(_tree(w_val=5.0), step=2)

    class _M:
        def __init__(self, w):
            self.w = w

        def predict(self, xs):
            return np.asarray(xs, np.float32) * self.w

    reg = ModelRegistry()
    reg.register("default", _M(0.0), version="v1")
    seen = {}

    def loader(tree, rec):
        seen.update(rec)
        return _M(float(np.asarray(tree["params"]["w"])[0, 0]))

    ver = reg.swap_from_checkpoint("default", loader, d)
    assert ver == f"ckpt-{seen['gen']}"
    assert seen["step"] == 2
    model, _, active = reg.resolve("default")
    assert active == ver
    np.testing.assert_allclose(model.predict(np.ones(2, np.float32)),
                               [5.0, 5.0])
    with pytest.raises(ValueError, match="already has a version"):
        reg.swap_from_checkpoint("default", loader, d)
