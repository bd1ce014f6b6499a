"""The port's ``XShards`` and Friesian (``FeatureTable``, ``StringIndex``,
``FeaturePipeline``) against the JAX package's on the same DataFrames:
every output frame, vocabulary, array and feed batch equal, bit for bit
(both sides are the same pandas and numpy operations).
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.data import XShards as JaxXShards
from analytics_zoo_tpu.friesian import FeaturePipeline as JaxPipeline
from analytics_zoo_tpu.friesian import FeatureTable as JaxTable
from analytics_zoo_tpu_torch.data import DataFeed, XShards
from analytics_zoo_tpu_torch.friesian import (FeaturePipeline, FeatureTable,
                                              StringIndex)


def _df(n=80, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "user": [f"u{int(i)}" for i in rng.integers(0, 9, n)],
        "item": [f"i{int(i)}" for i in rng.integers(0, 13, n)],
        "category": rng.choice(["sports", "news", None], n),
        "age": rng.choice([22.0, 35.0, 71.5, np.nan], n),
    })


def _tables(df, shards=4):
    return (FeatureTable.from_pandas(df, num_shards=shards),
            JaxTable.from_pandas(df, num_shards=shards))


def _same(a, b):
    pd.testing.assert_frame_equal(a.to_pandas(), b.to_pandas())


@pytest.mark.parametrize("op", ["fillna", "fillna_all", "clip", "rename",
                                "drop", "encode", "encode_given",
                                "cross", "negative", "negative_seeded"])
def test_feature_table_ops_equal_jax(op):
    t, j = _tables(_df())
    if op == "fillna":
        _same(t.fillna(0.0, ["age"]), j.fillna(0.0, ["age"]))
    elif op == "fillna_all":
        _same(t.fillna("x"), j.fillna("x"))
    elif op == "clip":
        _same(t.fillna(30.0, ["age"]).clip(["age"], min=25.0, max=50.0),
              j.fillna(30.0, ["age"]).clip(["age"], min=25.0, max=50.0))
    elif op == "rename":
        _same(t.rename({"age": "years"}), j.rename({"age": "years"}))
    elif op == "drop":
        _same(t.drop("category", "age"), j.drop("category", "age"))
    elif op == "encode":
        (te, ti), (je, ji) = t.encode_string(["user", "item"]), \
            j.encode_string(["user", "item"])
        _same(te, je)
        assert [i.to_dict() for i in ti] == [i.to_dict() for i in ji]
        assert [i.size for i in ti] == [i.size for i in ji]
    elif op == "encode_given":
        idx = j.gen_string_idx("user", freq_limit=9)
        port_idx = [StringIndex(i.col_name, i.to_dict()) for i in idx]
        other = pd.DataFrame({"user": ["u1", "uNEW", "u3"]})
        (te, _), (je, _) = (
            FeatureTable.from_pandas(other, 2).encode_string("user",
                                                             port_idx),
            JaxTable.from_pandas(other, 2).encode_string("user", idx))
        _same(te, je)
    elif op == "cross":
        crosses = [["user", "item"], ["category", "age"]]
        _same(t.fillna("none", ["category"]).fillna(0.0, ["age"])
              .cross_columns(crosses, [16, 7]),
              j.fillna("none", ["category"]).fillna(0.0, ["age"])
              .cross_columns(crosses, [16, 7]))
    else:
        seed = 3 if op == "negative_seeded" else 0
        te, _ = t.encode_string(["user", "item"])
        je, _ = j.encode_string(["user", "item"])
        _same(te.negative_sample(14, neg_num=3, seed=seed),
              je.negative_sample(14, neg_num=3, seed=seed))


def test_gen_string_idx_equals_jax():
    t, j = _tables(_df(200, 1), shards=3)
    for limit in (1, 12):
        got = t.gen_string_idx(["user", "item", "category"], limit)
        want = j.gen_string_idx(["user", "item", "category"], limit)
        assert [(i.col_name, i.to_dict()) for i in got] == \
            [(i.col_name, i.to_dict()) for i in want]


def test_random_split_len_columns_and_numpy_equal_jax():
    t, j = _tables(_df(120, 2))
    assert len(t) == len(j) and t.columns == j.columns
    for a, b in zip(t.random_split([0.7, 0.3], seed=4),
                    j.random_split([0.7, 0.3], seed=4)):
        _same(a, b)
    te, _ = t.encode_string(["user", "item"])
    je, _ = j.encode_string(["user", "item"])
    got = te.to_numpy_dict(["user", "item"], label_col="age")
    want = je.to_numpy_dict(["user", "item"], label_col="age")
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])


def test_to_feed_builds_the_ports_feed():
    t, _ = _tables(_df(70, 3))
    te, _ = t.encode_string(["user", "item"])
    feed = te.to_feed(["user", "item"], label_col="age", batch_size=16,
                      shuffle=False)
    assert isinstance(feed, DataFeed) and feed.steps_per_epoch() == 4
    first = next(iter(feed.epoch(torch.device("cpu"))))
    want = te.to_numpy_dict(["user", "item"], label_col="age")
    np.testing.assert_array_equal(first["x"].numpy(), want["x"][:16])


@pytest.mark.parametrize("where", ["file", "glob", "dir"])
def test_read_csv_equals_jax(tmp_path, where):
    """``FeatureTable.read_csv`` through the port's reader: the JAX
    package's table, shard by shard, from one file, a glob and a
    directory."""
    for i in range(3):
        _df(30, 20 + i).to_csv(tmp_path / f"part{i}.csv", index=False)
    path = {"file": tmp_path / "part1.csv", "glob": tmp_path / "part*.csv",
            "dir": tmp_path}[where]
    t, j = FeatureTable.read_csv(str(path)), JaxTable.read_csv(str(path))
    assert t.shards.num_partitions() == j.shards.num_partitions()
    for a, b in zip(t.shards.collect(), j.shards.collect()):
        pd.testing.assert_frame_equal(a, b)
    _same(t, j)
    _same(t.encode_string("user")[0], j.encode_string("user")[0])


def _pipelines(t):
    """The same fitted chain on both packages."""
    idx = t.gen_string_idx(["user", "item"])
    chains = []
    for cls in (FeaturePipeline, JaxPipeline):
        p = cls().fillna(0.0, ["age"]).clip(["age"], min=25, max=60)
        for i in idx:
            p = p.encode_string(i)
        chains.append(p.cross_columns([("user", "item")], [97]))
    return chains


def test_feature_pipeline_transform_equals_jax():
    t, _ = _tables(_df(40, 5))
    port, ref = _pipelines(t)
    events = _df(12, 6).drop(columns="category").to_dict("records")
    events.append({"user": "uNEW", "item": "i1", "age": None})
    got, want = port.transform(events), ref.transform(events)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got1 = port.transform(events[0])
    np.testing.assert_array_equal(got1["user_item"],
                                  want["user_item"][:1])


def test_feature_pipeline_matrix_and_server_transform_equal_jax():
    """The serving layout (one user and k item columns), the picklable
    server transform, and a width mismatch refused alike."""
    t, _ = _tables(_df(40, 7))
    port, ref = _pipelines(t)
    rng = np.random.default_rng(7)
    k = 4
    x = np.array([[f"u{rng.integers(0, 12)}"]
                  + [f"i{rng.integers(0, 15)}" for _ in range(k)]
                  for _ in range(6)], dtype="<U8")
    cols = ["user"] + ["item"] * k
    np.testing.assert_array_equal(port.transform_matrix(x, cols),
                                  ref.transform_matrix(x, cols))
    fn = pickle.loads(pickle.dumps(port.as_server_transform(cols,
                                                            np.int64)))
    np.testing.assert_array_equal(
        fn(x), ref.as_server_transform(cols, np.int64)(x))
    with pytest.raises(ValueError, match="column"):
        port.transform_matrix(x, cols[:-1])


def test_xshards_equal_jax():
    """partition, transform_shard, repartition, partition_by, split,
    to_numpy_dict and concatenated, shard by shard."""
    rng = np.random.default_rng(9)
    data = {"x": rng.normal(size=(23, 3)), "y": rng.integers(0, 2, 23)}
    t, j = XShards.partition(data, 4), JaxXShards.partition(data, 4)
    assert len(t) == len(j) == 23 and t.num_partitions() == 4
    for a, b in zip(t.transform_shard(lambda s: {"x": s["x"] * 2}).collect(),
                    j.transform_shard(lambda s: {"x": s["x"] * 2}).collect()):
        np.testing.assert_array_equal(a["x"], b["x"])
    for a, b in zip(t.repartition(3).collect(), j.repartition(3).collect()):
        np.testing.assert_array_equal(a["x"], b["x"])
    pair = (rng.normal(size=(10, 2)), rng.normal(size=(10,)))
    for a, b in zip(XShards.partition(pair, 3).split(),
                    JaxXShards.partition(pair, 3).split()):
        np.testing.assert_array_equal(a.concatenated(), b.concatenated())
    df = _df(50, 10)
    dt = XShards([df.iloc[:20], df.iloc[20:]])
    dj = JaxXShards([df.iloc[:20], df.iloc[20:]])
    for a, b in zip(dt.partition_by("user", 3).collect(),
                    dj.partition_by("user", 3).collect()):
        pd.testing.assert_frame_equal(a, b)
    for a, b in zip(dt.to_numpy_dict(["age"], ["user"]).collect(),
                    dj.to_numpy_dict(["age"], ["user"]).collect()):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
