"""The port's sharding rules and quantized-wire arithmetic against the JAX
package's, in one process: ``parallel/sharding.py`` (the rules, the trim
to the mesh, the ``train.sharding_fallbacks`` counter and its warning,
``infer_param_specs`` over a transformer layer's tree), ``parallel/
util.py`` (``compressed_allreduce``, ``quantize_int8``,
``grad_wire_bytes``, the batch-shard geometry), ``MeshConfig``'s
strategy layouts and the Estimator's validation of ``grad_compression``.
The port's mesh is laid out without processes here
(``make_mesh(..., n_devices=8)``), the JAX one over its 8 CPU devices.
Specs compare as tuples, one for one; the quantized means at 1e-6
(the same f32 arithmetic, summed in another order).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_serving import one_torch_thread  # noqa: F401
import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.core import metrics as jmetrics
from analytics_zoo_tpu.core.context import make_mesh as jmake_mesh
from analytics_zoo_tpu.parallel import sharding as jsharding
from analytics_zoo_tpu.parallel import util as jutil
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import to_jax_variables
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core.config import MeshConfig
from analytics_zoo_tpu_torch.core.context import make_mesh
from analytics_zoo_tpu_torch.data.feed import batch_axis_size, shard_batch
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.parallel import sharding, util
from analytics_zoo_tpu_torch.parallel.sharding import P

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LOGGER = "analytics_zoo_tpu_torch"


def _meshes(shape, n=8):
    return make_mesh(shape, n_devices=n), jmake_mesh(
        shape, devices=jax.devices()[:n])


def _same(port_spec, jax_spec):
    return tuple(port_spec) == tuple(jax_spec)


def _fresh():
    sharding._reset_fallback_warnings()
    jsharding._reset_fallback_warnings()
    metrics_lib.get_registry().reset()
    jmetrics.get_registry().reset()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def test_non_dividing_dim_falls_back_with_warning_and_counter(caplog):
    _fresh()
    mesh, _ = _meshes({"data": 4, "model": 2})
    params = {"odd": {"kernel": np.zeros((7, 3), np.float32)}}
    rules = [sharding.ShardingRule(r"kernel$", P("model", None))]
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        specs = sharding.infer_param_specs(params, rules, mesh)
        specs2 = sharding.infer_param_specs(params, rules, mesh)
    assert specs["odd"]["kernel"] == P() == specs2["odd"]["kernel"]
    warned = [r for r in caplog.records
              if "falling back to replication" in r.message]
    assert len(warned) == 1
    snap = metrics_lib.get_registry().snapshot()
    assert snap["train.sharding_fallbacks"] == 2


def test_spec_longer_than_tensor_rank_falls_back(caplog):
    _fresh()
    mesh, _ = _meshes({"data": 4, "model": 2})
    params = {"vec": {"bias": np.zeros((8,), np.float32)}}
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        specs = sharding.infer_param_specs(
            params, [sharding.ShardingRule(r"bias$", P(None, "model"))],
            mesh)
    assert specs["vec"]["bias"] == P()
    assert metrics_lib.get_registry().snapshot()[
        "train.sharding_fallbacks"] == 1
    assert any("has no such dim" in r.message for r in caplog.records)


def test_absent_axis_trims_silently(caplog):
    _fresh()
    mesh, _ = _meshes({"data": 8})
    params = {"ffn1": {"kernel": np.zeros((8, 32), np.float32)}}
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        specs = sharding.infer_param_specs(
            params, sharding.tensor_parallel_rules(), mesh)
    assert specs["ffn1"]["kernel"] == P()
    assert metrics_lib.get_registry().snapshot().get(
        "train.sharding_fallbacks", 0) == 0
    assert not [r for r in caplog.records if "falling back" in r.message]


def test_rule_inference_on_nested_param_paths():
    mesh, jmesh = _meshes({"data": 4, "model": 2})
    params = {"encoder": {"block0": {"ffn1": {"kernel": np.zeros((8, 32))}},
                          "block1": {"ffn1": {"kernel": np.zeros((8, 32))}}},
              "head": {"kernel": np.zeros((32, 4))}}
    rules = [sharding.ShardingRule(r"block1/ffn1/kernel$", P(None, "model")),
             sharding.ShardingRule(r"kernel$", P())]
    jrules = [jsharding.ShardingRule(r.pattern, JP(*r.spec)) for r in rules]
    specs = _flat(sharding.infer_param_specs(params, rules, mesh))
    jspecs = _flat(jsharding.infer_param_specs(params, jrules, jmesh))
    assert specs["encoder/block1/ffn1/kernel"] == P(None, "model")
    assert all(_same(specs[k], jspecs[k]) for k in specs)


@pytest.mark.parametrize("mesh_shape,rules", [
    ({"data": 4, "model": 2}, "tp"), ("2d", "tp"), ("2d", "fsdp"),
    ({"fsdp": 4, "model": 2, "data": 1}, "tp+fsdp"),
    ({"fsdp": 0, "data": 1}, "fsdp"), ({"data": 8}, "tp")])
def test_rules_on_a_transformer_layer_match_jax(mesh_shape, rules):
    """``infer_param_specs`` of the port's TransformerLayer tree (its
    ``state_dict`` as the JAX tree) equals the JAX package's on the JAX
    layer's tree, path for path: wq/wk/wv column-parallel, wo and ffn2
    row-parallel, layer norms replicated, axes trimmed to the mesh."""
    mesh, jmesh = _meshes(mesh_shape)

    def port_rules():
        if rules == "tp":
            return sharding.tensor_parallel_rules()
        if rules == "fsdp":
            return sharding.fsdp_rules()
        return (sharding.tensor_parallel_rules(fsdp_axis="fsdp")
                + sharding.fsdp_rules())

    def jax_rules():
        if rules == "tp":
            return jsharding.tensor_parallel_rules()
        if rules == "fsdp":
            return jsharding.fsdp_rules()
        return (jsharding.tensor_parallel_rules(fsdp_axis="fsdp")
                + jsharding.fsdp_rules())

    layer = tnn.TransformerLayer(64, 4)
    tree = to_jax_variables(layer.state_dict(), [])["params"]
    jlayer = jnn.TransformerLayer(num_heads=4)
    jtree = jlayer.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, 8, 64), jnp.float32))["params"]
    specs = _flat(sharding.infer_param_specs(tree, port_rules(), mesh))
    jspecs = _flat(jsharding.infer_param_specs(jtree, jax_rules(), jmesh))
    assert sorted(specs) == sorted(jspecs)
    for path in specs:
        assert _same(specs[path], jspecs[path]), (path, specs[path],
                                                  jspecs[path])


def test_tensor_parallel_rules_match_transformer_params():
    mesh, _ = _meshes({"data": 4, "model": 2})
    layer = tnn.TransformerLayer(64, 4)
    tree = to_jax_variables(layer.state_dict(), [])["params"]
    flat = _flat(sharding.infer_param_specs(
        tree, sharding.tensor_parallel_rules(), mesh))
    assert next(v for k, v in flat.items() if k.endswith("wq")) == \
        P(None, "model")
    assert next(v for k, v in flat.items() if k.endswith("wo")) == \
        P("model")
    assert next(v for k, v in flat.items()
                if "ffn1" in k and k.endswith("kernel")) == P(None, "model")
    assert next(v for k, v in flat.items()
                if "ln1" in k and k.endswith("gamma")) == P()


def test_mesh_for_strategy_layouts():
    assert MeshConfig.for_strategy("dp").resolved(8)["data"] == 8
    assert MeshConfig.for_strategy("fsdp").resolved(8)["fsdp"] == 8
    tp = MeshConfig.for_strategy("tp").resolved(8)
    assert tp["model"] == 8 and tp["data"] == 1
    assert MeshConfig.for_strategy("2d").resolved(8) == {
        "data": 4, "fsdp": 1, "seq": 1, "pipe": 1, "model": 2, "expert": 1}
    assert MeshConfig.for_strategy("2d", n_devices=3).resolved(3)[
        "model"] == 1
    with pytest.raises(ValueError, match="unknown mesh strategy"):
        MeshConfig.for_strategy("3d")


def test_make_mesh_accepts_strategy_string():
    mesh, jmesh = _meshes("2d")
    assert mesh.axis_names == jmesh.axis_names == ("data", "model")
    assert mesh.devices.shape == jmesh.devices.shape == (4, 2)


@pytest.mark.parametrize("shape,rank", [
    ({"data": 4, "model": 2}, 5), ({"data": 2, "fsdp": 2, "model": 2}, 3),
    ({"fsdp": 4, "data": 1}, 2), ({"data": 8}, 7)])
def test_piece_placement_follows_the_jax_device_order(shape, rank):
    """The piece a rank holds under a spec is the piece JAX's sharding
    gives device ``rank`` of the same mesh, and the owner of each piece is
    the lowest rank holding it (the checkpoint's rule)."""
    from jax.sharding import NamedSharding
    mesh, jmesh = _meshes(shape)
    mesh_r = make_mesh(shape, n_devices=8)
    mesh_r.rank = rank
    mesh_r.coords = dict(zip(mesh_r.axis_names, (int(c) for c in
                                                 np.unravel_index(
                                                     rank,
                                                     mesh_r.devices.shape))))
    full = (16, 8)
    for spec in (P("model"), P(None, "model"), P(("data", "fsdp")),
                 P("fsdp", "model"), P()):
        spec_t = sharding._trim_spec_to_mesh(spec, mesh, full)
        jspec = jsharding._trim_spec_to_mesh(JP(*spec), jmesh, full)
        assert _same(spec_t, jspec)
        dmap = NamedSharding(jmesh, jspec).devices_indices_map(full)
        dev = jax.devices()[rank]
        want = tuple(slice(sl.start or 0, sl.stop if sl.stop is not None
                           else d) for sl, d in zip(dmap[dev], full))
        got = sharding.piece_index(spec_t, full, mesh_r)
        assert got == want, (spec, got, want)
        owners = sharding.owners(spec_t, full, mesh)
        for d, idx in dmap.items():
            key = sharding.index_key(idx, full)
            assert owners[key] <= d.id


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"data": 2, "fsdp": 2, "model": 2}])
def test_placements_hold_the_pieces_of_the_spec(shape):
    """A spec's ``DTensor`` placements (one a mesh axis) shard the same
    pieces ``piece_index`` gives each rank: each Shard(d) axis splits dim d
    in the spec's axis order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh(shape, n_devices=8)
    full = (16, 8)
    for spec in (P("model"), P(None, "model"), P(("data", "fsdp"), "model"),
                 P()):
        spec = sharding._trim_spec_to_mesh(spec, mesh, full)
        pl = sharding.placements(spec, mesh)
        assert len(pl) == len(mesh.axis_names)
        for axis, p in zip(mesh.axis_names, pl):
            dims = [d for d, e in enumerate(spec)
                    if axis in sharding._entry_axes(e)]
            assert p == (Shard(dims[0]) if dims else Replicate())
        # the DTensor rule: a dim's blocks follow its Shard axes in order
        for rank in range(8):
            c = dict(zip(mesh.axis_names, (int(v) for v in np.unravel_index(
                rank, mesh.devices.shape))))
            idx = sharding.piece_index(spec, full, mesh, c)
            for d, n in enumerate(full):
                axes = [a for a, p in zip(mesh.axis_names, pl)
                        if p == Shard(d)]
                block, at = n, 0
                for a in axes:
                    block //= mesh.shape[a]
                    at = at * mesh.shape[a] + c[a]
                assert idx[d] == slice(at * block, (at + 1) * block)


def test_compressed_allreduce_unit():
    """The stacked form against the JAX function: int8 means within one
    quantization step of the exact mean, the residual the dropped part,
    both equal to JAX's; bf16 within 0.02."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(4, 16, 8)).astype(np.float32)
    exact = g.mean(0)
    red, ef = util.compressed_allreduce([torch.from_numpy(g)], "int8")
    jred, jef = jutil.compressed_allreduce({"w": jnp.asarray(g)}, "int8")
    step = np.abs(g).max(axis=(1, 2)).mean() / 127.0
    assert np.abs(red[0].numpy() - exact).max() <= step
    np.testing.assert_allclose(red[0].numpy(), np.asarray(jred["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ef[0].numpy(), np.asarray(jef["w"]),
                               rtol=1e-6, atol=1e-7)
    q_contrib = g - ef[0].numpy()
    np.testing.assert_allclose(q_contrib.mean(0), red[0].numpy(),
                               rtol=1e-6, atol=1e-7)
    red_b, ef_b = util.compressed_allreduce([torch.from_numpy(g)], "bf16")
    assert ef_b is None
    assert np.abs(red_b[0].numpy() - exact).max() < 0.02
    np.testing.assert_allclose(
        red_b[0].numpy(),
        np.asarray(jutil.compressed_allreduce({"w": jnp.asarray(g)},
                                              "bf16")[0]["w"]),
        rtol=1e-6, atol=1e-7)
    q, scale = util.quantize_int8(torch.from_numpy(g))
    jq, jscale = jutil.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)


def test_allreduce_compressed_alone_equals_the_stacked_form():
    """One process (no group): the wire form quantizes this rank's
    gradient as the stacked form does its one shard."""
    rng = np.random.default_rng(4)
    g = rng.normal(size=(12, 5)).astype(np.float32)
    r = rng.normal(size=(12, 5)).astype(np.float32) * 1e-3
    got, ef = util.allreduce_compressed([torch.from_numpy(g)], "int8", None,
                                        1, ef=[torch.from_numpy(r)])
    want, wef = util.compressed_allreduce([torch.from_numpy(g[None])],
                                          "int8",
                                          ef=[torch.from_numpy(r[None])])
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(ef[0].numpy(), wef[0][0].numpy())


def test_grad_wire_bytes_analytics():
    params = [torch.zeros(10, 10), torch.zeros(10)]
    jparams = {"k": np.zeros((10, 10), np.float32),
               "b": np.zeros((10,), np.float32)}
    for method, want in ((None, 440), ("none", 440), ("bf16", 220),
                         ("int8", 110)):
        assert util.grad_wire_bytes(params, method) == want
        assert jutil.grad_wire_bytes(jparams, method) == want
    with pytest.raises(ValueError, match="unknown grad compression"):
        util.grad_wire_bytes(params, "fp4")


@pytest.mark.parametrize("shape", [{"data": 8}, {"data": 2, "model": 4},
                                   {"data": 2, "fsdp": 2, "model": 2}])
def test_batch_shard_geometry_matches_jax(shape):
    mesh, jmesh = _meshes(shape)
    assert util.batch_shard_count(mesh) == jutil.batch_shard_count(jmesh)
    for rank in (1, 3):
        assert _same(util.batch_shard_spec(mesh, rank),
                     jutil.batch_shard_spec(jmesh, rank))
    assert batch_axis_size(mesh) == jutil.batch_shard_count(jmesh)


def test_shard_batch_takes_this_ranks_block_and_refuses_a_ragged_batch():
    mesh = make_mesh({"data": 4}, n_devices=4)
    mesh.coords = {"data": 2}
    batch = {"x": np.arange(16).reshape(8, 2), "y": np.arange(8)}
    got = shard_batch(batch, mesh)
    np.testing.assert_array_equal(got["y"], [4, 5])
    np.testing.assert_array_equal(got["x"], [[8, 9], [10, 11]])
    with pytest.raises(ValueError, match="does not divide the mesh batch"):
        shard_batch({"x": np.arange(6)}, mesh)


def test_grad_compression_validation():
    with pytest.raises(ValueError, match="grad_compression"):
        Estimator.from_keras(tnn.Dense(2, 2), loss="mse", learning_rate=0.1,
                             device="cpu", grad_compression="fp4")
    with pytest.raises(ValueError, match="grad_accum"):
        Estimator.from_keras(tnn.Dense(2, 2), loss="mse", learning_rate=0.1,
                             device="cpu", grad_compression="int8",
                             grad_accum=2)


def test_one_process_compressed_fit_quantizes_and_meters():
    """At one shard int8 still quantizes (the JAX step at S = 1): the
    residuals bank the rounding, grad_bytes counts one byte a parameter,
    and ``"none"`` repeats ``None``'s fit bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.integers(0, 4, 64).astype(np.int32)
    init = tnn.Sequential([tnn.Dense(8, 4)]).state_dict()
    hist = {}
    for comp in (None, "none", "int8"):
        m = tnn.Sequential([tnn.Dense(8, 4)])
        m.load_state_dict(init)
        metrics_lib.get_registry().reset()
        est = Estimator.from_keras(m, loss="sparse_categorical_crossentropy",
                                   optimizer="sgd", learning_rate=0.1,
                                   device="cpu", grad_compression=comp)
        hist[comp] = est.fit((x, y), epochs=1, batch_size=16,
                             verbose=False)["loss"]
        snap = metrics_lib.get_registry().snapshot()
        if comp == "int8":
            assert snap["train.grad_bytes"] == 4 * (8 * 4 + 4)
            assert any(float(e.abs().sum()) > 0 for e in est._scale.ef)
            assert snap["train.comm_ms"]["count"] == 1
    assert hist["none"] == hist[None]
    assert hist["int8"] != hist[None]
    assert abs(hist["int8"][-1] - hist[None][-1]) < 0.02
