"""The port's checkpoint format against the JAX package's on the CPU: a
tree written by either ``core/checkpoint.py`` restores in the other leaf for
leaf (f32, int, bf16 and fp8 as bit views, scalars, empty nodes), and so
does a manager directory (a full generation and its deltas).  Bit for bit:
the format stores bytes, nothing is computed."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
from analytics_zoo_tpu.core import checkpoint as jckpt
from analytics_zoo_tpu.core import ckpt_manager as jcm
from analytics_zoo_tpu_torch.core import checkpoint as tckpt
from analytics_zoo_tpu_torch.core import ckpt_manager as tcm
from analytics_zoo_tpu_torch.core import faults as tfaults
from analytics_zoo_tpu_torch.core import metrics as tmetrics

TP = "params/emb/sharded_embeddings"


def _jax_tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": jnp.asarray(rng.normal(size=(3, 4)),
                                        jnp.float32),
                       "b16": jnp.asarray(rng.normal(size=(5,)),
                                          jnp.bfloat16),
                       "f8": jnp.asarray(rng.normal(size=(2, 3)),
                                         jnp.float8_e4m3fn)},
            "state": {},
            "opt_state": ((jnp.asarray(7, jnp.int32),
                           {"w": jnp.zeros((3, 4))}), ()),
            "step": jnp.asarray(11, jnp.int32),
            "rng": jax.random.PRNGKey(5),
            "scalars": [1, 2.5, "name", True, None]}


def _port_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "b16": torch.randn(5, generator=g).bfloat16(),
                       "f8": torch.randn(2, 3, generator=g).to(
                           torch.float8_e4m3fn)},
            "state": {},
            "opt_state": ((np.asarray(7, np.int32),
                           {"w": torch.zeros(3, 4)}), ()),
            "step": np.asarray(11, np.int32),
            "rng": np.asarray([0, 5], np.uint32),
            "scalars": [1, 2.5, "name", True, None]}


def _bits(leaf):
    """A leaf's bytes as numpy (a torch bf16/fp8 tensor or an ml_dtypes
    array through its same-width uint view), and its dtype's name."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype in (
            torch.bfloat16, torch.float8_e4m3fn):
        width = leaf.element_size()
        raw = leaf.view(torch.int16 if width == 2 else torch.uint8)
        return raw.numpy().view(f"uint{8 * width}"), str(leaf.dtype).split(
            ".")[-1]
    arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name in ("bfloat16",
                                                   "float8_e4m3fn"):
        return arr.view(f"uint{8 * arr.dtype.itemsize}"), arr.dtype.name
    return arr, arr.dtype.name


def _assert_same(got, want):
    gl, gs = tckpt.flatten(got)
    wl, ws = tckpt.flatten(want)
    assert gs == ws
    for a, b in zip(gl, wl):
        if isinstance(b, (str, bool, int, float)) or b is None:
            assert a == b and type(a) is type(b)
            continue
        (ab, an), (bb, bn) = _bits(a), _bits(b)
        assert an == bn and ab.shape == bb.shape
        np.testing.assert_array_equal(ab, bb)


def test_jax_written_tree_restores_in_the_port_leaf_for_leaf(tmp_path):
    tree = _jax_tree()
    jckpt.save(str(tmp_path), tree, step=11, extra={"epoch": 2})
    got = tckpt.restore(str(tmp_path))
    assert isinstance(got["params"]["b16"], torch.Tensor)
    assert got["params"]["b16"].dtype == torch.bfloat16
    assert got["params"]["f8"].dtype == torch.float8_e4m3fn
    _assert_same(got, jax.device_get(tree))
    assert tckpt.load_extra(str(tmp_path)) == {"epoch": 2}
    assert tckpt.latest_step(str(tmp_path)) == 11


def test_port_written_tree_restores_in_jax_leaf_for_leaf(tmp_path):
    tree = _port_tree()
    tckpt.save(str(tmp_path), tree, step=11, extra={"epoch": 2})
    got = jckpt.restore(str(tmp_path))
    assert np.asarray(got["params"]["b16"]).dtype == ml_dtypes.bfloat16
    _assert_same(tckpt.restore(str(tmp_path)), tree)
    _assert_same(jax.device_get(got), tree)
    assert jckpt.load_extra(str(tmp_path)) == {"epoch": 2}
    # the same structure JSON as the JAX package writes for the twin tree
    with open(tmp_path / "treedef.json") as f:
        ours = json.load(f)
    jckpt.save(str(tmp_path / "j"), _jax_tree())
    with open(tmp_path / "j" / "treedef.json") as f:
        theirs = json.load(f)
    assert ours["treedef"] == theirs["treedef"]
    assert ours["raw_dtypes"] == theirs["raw_dtypes"]
    assert ours["scalars"] == theirs["scalars"]


def test_flatten_follows_jax_leaf_order():
    tree = {"b": [3, {"z": 1, "a": 2}], "a": (None, 4), "c": {}}
    leaves, _ = tckpt.flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree) == [4, 3, 2, 1]
    assert tckpt.leaf_paths(tree) == ["a/1", "b/0", "b/1/a", "b/1/z"]
    assert tckpt.unflatten(tckpt.flatten(tree)[1], leaves) == tree


def test_keep2_falls_back_to_the_previous_generation(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, {"w": torch.ones(4)}, keep=2)
    tckpt.save(d, {"w": torch.full((4,), 2.0)}, keep=2)
    with open(os.path.join(d, "treedef.json")) as f:
        gen = json.load(f)["gen"]
    with open(os.path.join(d, f"arrays_{gen}.npz"), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    before = tmetrics.get_registry().snapshot().get(
        "checkpoint.corrupt_files", 0)
    got = tckpt.restore(d)  # the JAX package's keep=2 contract
    np.testing.assert_array_equal(got["w"], np.ones(4, np.float32))
    assert tmetrics.get_registry().snapshot().get(
        "checkpoint.corrupt_files", 0) > before
    np.testing.assert_array_equal(jckpt.restore(d)["w"], np.ones(4))


def test_corrupt_file_is_named_without_a_fallback(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, {"w": torch.ones(4)})
    name = next(n for n in os.listdir(d) if n.endswith(".npz"))
    with open(os.path.join(d, name), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(tckpt.CheckpointCorruptError, match=name):
        tckpt.restore(d)


def test_write_failure_is_retried(tmp_path):
    reg = tfaults.get_registry()
    before = reg.fired("checkpoint.write_fail")
    with reg.armed("checkpoint.write_fail", times=2):
        tckpt.save(str(tmp_path), {"w": torch.ones(2)}, retries=3,
                   retry_delay=0.001)
        assert reg.fired("checkpoint.write_fail") - before == 2
    np.testing.assert_array_equal(tckpt.restore(str(tmp_path))["w"],
                                  np.ones(2, np.float32))


def test_multi_process_layout_waits_for_sharding(tmp_path):
    # the JAX package's multi-process layout restores: a sharded entry's
    # pieces (here two, in two processes' files) are reassembled whole
    tckpt.save(str(tmp_path), {"w": torch.ones(4)})
    path = tmp_path / "treedef.json"
    meta = json.loads(path.read_text())
    meta["sharded"] = [{"shape": [4], "dtype": "float32",
                        "shards": {"0:2": 0, "2:4": 1}}]
    meta["scalars"] = [None]
    for proc, key, vals in ((0, "0:2", [1, 2]), (1, "2:4", [3, 4])):
        np.savez(tmp_path / f"shards_{meta['gen']}_p{proc}.npz",
                 **{f"a0__{key}": np.asarray(vals, np.float32)})
    path.write_text(json.dumps(meta))
    np.testing.assert_array_equal(tckpt.restore(str(tmp_path))["w"],
                                  np.asarray([1, 2, 3, 4], np.float32))


# -- a manager directory, both ways -------------------------------------------

def _chain(cm, d, table, w, to_dev, set_row):
    """A full generation then two deltas of one table row each."""
    with cm.CheckpointManager(d, compact_every=100) as m:
        m.save({"params": {"w": w, "emb": {"sharded_embeddings": table}},
                "step": to_dev(1)}, step=1)
        for step, row in ((2, 3), (3, 5)):
            table = set_row(table, row, float(step))
            m.save({"params": {"w": w, "emb": {"sharded_embeddings": table}},
                    "step": to_dev(step)}, step=step,
                   touched={TP: np.array([row])})
        assert [r["kind"] for r in m.generations()] == \
            ["full", "delta", "delta"]
    return table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_manager_directory_restores_in_the_port(tmp_path, dtype):
    d = str(tmp_path)
    table = _chain(jcm, d, jnp.zeros((8, 4), dtype), jnp.ones((2, 2)),
                   lambda s: jnp.asarray(s, jnp.int32),
                   lambda t, r, v: t.at[r].set(v))
    tree, rec = tcm.restore_path(d)
    assert rec["step"] == 3 and rec["kind"] == "delta"
    got = tree["params"]["emb"]["sharded_embeddings"]
    assert _bits(got)[1] == dtype
    np.testing.assert_array_equal(_bits(got)[0],
                                  _bits(np.asarray(table))[0])
    assert tcm.verify_path(d) == ([], [])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_manager_directory_restores_in_jax(tmp_path, dtype):
    d = str(tmp_path)

    def set_row(t, r, v):
        t = t.clone()
        t[r] = v
        return t

    table = _chain(tcm, d, torch.zeros(8, 4, dtype=dtype), torch.ones(2, 2),
                   lambda s: np.asarray(s, np.int32), set_row)
    tree, rec = jcm.restore_path(d)
    assert rec["step"] == 3 and rec["kind"] == "delta"
    got = np.asarray(tree["params"]["emb"]["sharded_embeddings"])
    np.testing.assert_array_equal(_bits(got)[0], _bits(table)[0])
    assert jcm.verify_path(d) == ([], [])
