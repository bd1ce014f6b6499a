"""The port's recsys serving path (``serving/embed_cache.py``) on the CPU:
``EmbedCache``'s LRU, its metrics, its invalidation scopes, its
invalidation on a ``ModelRegistry`` swap or unload and the fencing of a
swapped-out version; ``CachedEmbeddingModel``'s ranking against the JAX
package's adapter over the same trained tables and tail, cold and warm;
and raw string events through ``ClusterServing(pipelines=)`` to ranked
ids.

Rankings are ids, compared exactly: the port's tail (``InferenceModel``
on the CPU) and the JAX tail give the same logits to 1e-6 at these widths,
and the probe's candidates are far from ties (checked).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import (no_leaked_port_controllers,  # noqa: F401
                            one_torch_thread, port_faults_disarmed,
                            port_telemetry_reset)
from analytics_zoo_tpu.core import metrics as jmetrics
from analytics_zoo_tpu.models import NeuralCF as JaxNeuralCF
from analytics_zoo_tpu.serving import CachedEmbeddingModel as JaxAdapter
from analytics_zoo_tpu.serving import EmbedCache as JaxCache
from analytics_zoo_tpu.serving import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import metrics
from analytics_zoo_tpu_torch.friesian import FeaturePipeline, StringIndex
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.serving import (CachedEmbeddingModel,
                                             ClusterServing, EmbedCache,
                                             InferenceModel, InputQueue,
                                             ModelRegistry, OutputQueue)

USERS, ITEMS = 64, 40
NCF = dict(user_count=USERS, item_count=ITEMS, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8,
           sharded_embeddings=True)


class _Stub:
    def predict(self, x):
        return np.asarray(x)


@pytest.fixture(scope="module")
def recsys_parts():
    """A sharded NeuralCF's random JAX variables split for serving in both
    packages, with a request batch of [user | 6 candidates] rows."""
    x0 = np.zeros((2, 2), np.int32)
    jmodel = JaxNeuralCF(**NCF)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(4),
                                           jnp.asarray(x0)))
    model = NeuralCF(**NCF)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    tables, tail, tail_vars = model.serving_split(variables)
    jtables, jtail, jtail_vars = jmodel.serving_split(variables)
    rng = np.random.default_rng(1)
    req = np.concatenate([rng.integers(0, USERS, (5, 1)),
                          rng.integers(0, ITEMS, (5, 6))], 1)
    return {"model": model, "tables": tables, "columns":
            model.embedding_columns(),
            "im": InferenceModel(device="cpu").load(tail, tail_vars),
            "jtables": jtables,
            "jim": JaxInferenceModel().load(jtail, jtail_vars),
            "req": req}


# -- EmbedCache ---------------------------------------------------------------

def test_embed_cache_lru_eviction_and_metrics():
    reg = metrics.get_registry()
    c = EmbedCache(capacity=3)
    c.insert("m", "v1", "t", [1, 2, 3], np.eye(3, 4, dtype=np.float32))
    hits, missing = c.lookup("m", "v1", "t", [1, 9])
    assert list(hits) == [1] and missing == [9]
    c.insert("m", "v1", "t", [4, 5], np.zeros((2, 4), np.float32))
    assert len(c) == 3
    hits, missing = c.lookup("m", "v1", "t", [1, 2, 3, 4, 5])
    assert sorted(hits) == [1, 4, 5] and missing == [2, 3]
    snap = reg.snapshot()
    assert snap["embed.cache_hits"] == 1 + 3
    assert snap["embed.cache_misses"] == 1 + 2
    assert snap["embed.cache_evictions"] == 2
    assert snap["embed.cache_size"]["value"] == 3
    with pytest.raises(ValueError, match="capacity"):
        EmbedCache(capacity=0)


def test_embed_cache_invalidate_scopes():
    c = EmbedCache(capacity=100)
    for model, ver in [("a", "v1"), ("a", "v2"), ("b", "v1")]:
        c.insert(model, ver, "t", [0, 1], np.zeros((2, 2), np.float32))
    assert c.invalidate("a", "v1") == 2
    assert len(c) == 4
    assert c.invalidate("a") == 2
    assert c.invalidate() == 2
    assert len(c) == 0


def test_embed_cache_swap_and_unload_invalidation():
    c = EmbedCache(capacity=100)
    reg = ModelRegistry()
    c.attach(reg)
    reg.register("m", _Stub(), version="v1")
    c.insert("m", "v1", "t", [0, 1, 2], np.zeros((3, 2), np.float32))
    c.insert("other", "v1", "t", [0], np.zeros((1, 2), np.float32))
    reg.swap("m", _Stub(), version="v2", warm=False)
    assert c.invalidate("m", "v1") == 0
    assert len(c) == 1
    c.insert("m", "v2", "t", [5], np.zeros((1, 2), np.float32))
    reg.swap("m", _Stub(), version="v3", warm=False, keep_old=False)
    assert c.invalidate("m", "v2") == 0
    c.detach(reg)
    c.insert("m", "v3", "t", [7], np.zeros((1, 2), np.float32))
    reg.swap("m", _Stub(), version="v4", warm=False)
    assert c.invalidate("m", "v3") == 1


def test_embed_cache_fences_a_swapped_out_version():
    reg = metrics.get_registry()
    c = EmbedCache(capacity=100)
    mreg = ModelRegistry()
    c.attach(mreg)
    mreg.register("m", _Stub(), version="v1")
    c.insert("m", "v1", "t", [0, 1], np.zeros((2, 2), np.float32))
    mreg.swap("m", _Stub(), version="v2", warm=False)
    c.insert("m", "v1", "t", [0, 1], np.zeros((2, 2), np.float32))
    assert c.invalidate("m", "v1") == 0
    assert reg.snapshot()["embed.cache_fenced_inserts"] == 2
    c.insert("m", "v2", "t", [0], np.zeros((1, 2), np.float32))
    assert len(c) == 1
    mreg.promote("m", "v1", warm=False)
    c.insert("m", "v1", "t", [3], np.zeros((1, 2), np.float32))
    hits, _ = c.lookup("m", "v1", "t", [3])
    assert list(hits) == [3]


# -- CachedEmbeddingModel -----------------------------------------------------

def test_cached_adapter_ranks_as_the_jax_adapter(recsys_parts):
    """Cold and warm (every row from the cache), and without a cache: the
    JAX adapter's ranking, its hit, miss and gather-row counts."""
    p = recsys_parts
    jreg = jmetrics.MetricsRegistry()
    treg = metrics.MetricsRegistry()
    port = CachedEmbeddingModel(p["tables"], p["columns"], p["im"],
                                cache=EmbedCache(1000, metrics=treg),
                                metrics=treg, device="cpu")
    ref = JaxAdapter(p["jtables"], p["columns"], p["jim"],
                     cache=JaxCache(1000, metrics=jreg), metrics=jreg)
    for _ in range(2):
        np.testing.assert_array_equal(port.predict(p["req"]),
                                      ref.predict(p["req"]))
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    for k in ("embed.cache_hits", "embed.cache_misses",
              "embed.gather_rows", "embed.gather_rows_naive"):
        assert tsnap[k] == jsnap[k], k
    bare = CachedEmbeddingModel(p["tables"], p["columns"], p["im"],
                                device="cpu")
    np.testing.assert_array_equal(bare.predict(p["req"]),
                                  ref.predict(p["req"]))
    with pytest.raises(ValueError, match="user"):
        CachedEmbeddingModel(p["tables"], [("mlp_user_embed", "x")],
                             p["im"], device="cpu")
    with pytest.raises(ValueError, match="rows"):
        bare.predict(np.zeros((3,), np.int64))


def test_cached_adapter_ranks_as_the_full_model(recsys_parts):
    """The adapter's order is the full model's P(positive) order, and no
    two candidates of the probe are within 1e-4 of each other."""
    p = recsys_parts
    port = CachedEmbeddingModel(p["tables"], p["columns"], p["im"],
                                device="cpu")
    got = port.predict(p["req"])
    for row, ranked in zip(p["req"], got):
        pairs = np.stack([np.full(6, row[0]), row[1:]], 1)
        with torch.no_grad():
            logits = p["model"](torch.from_numpy(pairs)).numpy()
        pr = np.exp(logits - logits.max(1, keepdims=True))
        pos = 1.0 - pr[:, 0] / pr.sum(1)
        np.testing.assert_array_equal(
            ranked, row[1:][np.argsort(-pos, kind="stable")])
        distinct = row[1:][:, None] != row[1:][None, :]
        assert (np.abs(pos[:, None] - pos[None, :])[distinct] > 1e-4).all()


def test_server_pipeline_raw_events_to_ranked_ids(recsys_parts):
    """``ClusterServing(pipelines=)``: a client sends raw string events,
    the fitted ``FeaturePipeline`` encodes them on the server, and the
    reply is the adapter's ranking of those ids."""
    p = recsys_parts
    adapter = CachedEmbeddingModel(p["tables"], p["columns"], p["im"],
                                   cache=EmbedCache(capacity=1000),
                                   device="cpu")
    k = p["req"].shape[1] - 1
    uix = StringIndex("user", {f"u{u}": u for u in range(1, USERS)})
    iix = StringIndex("item", {f"i{i}": i for i in range(1, ITEMS)})
    tf = pickle.loads(pickle.dumps(
        FeaturePipeline().encode_string(uix).encode_string(iix)
        .as_server_transform(["user"] + ["item"] * k, dtype=np.int64)))
    events = np.array([[f"u{r[0]}"] + [f"i{i}" for i in r[1:]]
                       for r in p["req"]], dtype="<U8")
    with ClusterServing(models={"recsys": adapter},
                        pipelines={"recsys": tf}, batch_size=4,
                        batch_timeout_ms=2) as srv:
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        uids = [iq.enqueue(f"c{i}", model="recsys", t=ev)
                for i, ev in enumerate(events)]
        replies = [oq.query(u, timeout=30.0) for u in uids]
        iq.close()
    want = adapter.predict(tf(events))
    for got, w in zip(replies, want):
        np.testing.assert_array_equal(got, w)
