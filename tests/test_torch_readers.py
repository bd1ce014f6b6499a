"""The port's file readers (``data/readers.py``) against the JAX package's
on the same files: twins of ``tests/test_data.py::TestReaders``, plus
``read_parquet`` and the row split between processes.  Every frame and
array equal, bit for bit (both sides are the same pandas and numpy calls).
"""

import time

import numpy as np
import pandas as pd
import pytest

from analytics_zoo_tpu.data import readers as jax_readers
from analytics_zoo_tpu_torch.data import (FileReadahead, XShards, pandas,
                                          read_csv, read_json, read_npz,
                                          read_parquet)
from analytics_zoo_tpu_torch.data import readers


def _df(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"a": rng.normal(size=n), "b": rng.integers(0, 5, n),
                         "y": rng.integers(0, 2, n)})


def _same_frames(got, want):
    assert isinstance(got, XShards)
    assert got.num_partitions() == want.num_partitions()
    for g, w in zip(got.collect(), want.collect()):
        pd.testing.assert_frame_equal(g, w)


def test_read_csv_glob(tmp_path):
    for i in range(3):
        _df(10, i).to_csv(tmp_path / f"part{i}.csv", index=False)
    s = read_csv(str(tmp_path / "*.csv"))
    assert s.num_partitions() == 3
    assert len(s) == 30
    _same_frames(s, jax_readers.read_csv(str(tmp_path / "*.csv")))


def test_read_csv_dir_and_repartition(tmp_path):
    """Repartitioned frames stay frames in the port; under pandas 3 the
    JAX package's ``np.array_split`` of a frame gives numpy arrays, so
    the JAX side is compared by value."""
    for i in range(4):
        _df(5, i).to_csv(tmp_path / f"p{i}.csv", index=False)
    s = read_csv(str(tmp_path), num_shards=2)
    assert s.num_partitions() == 2
    assert len(s) == 20
    want = jax_readers.read_csv(str(tmp_path), num_shards=2).collect()
    whole = pd.concat([pd.read_csv(tmp_path / f"p{i}.csv")
                       for i in range(4)], ignore_index=True)
    for g, w, rows in zip(s.collect(), want, (range(10), range(10, 20))):
        pd.testing.assert_frame_equal(g, whole.iloc[list(rows)])
        np.testing.assert_array_equal(g.to_numpy(), np.asarray(w))


def test_read_json(tmp_path):
    _df(8).to_json(tmp_path / "d.json", orient="records")
    s = read_json(str(tmp_path / "d.json"))
    assert len(s) == 8
    _same_frames(s, jax_readers.read_json(str(tmp_path / "d.json")))


def test_read_parquet(tmp_path):
    pytest.importorskip("pyarrow")
    for i in range(2):
        _df(7, i).to_parquet(tmp_path / f"p{i}.parquet")
    s = read_parquet(str(tmp_path))
    assert len(s) == 14
    _same_frames(s, jax_readers.read_parquet(str(tmp_path)))


def test_read_npz(tmp_path):
    np.savez(tmp_path / "d.npz", x=np.ones((6, 2)), y=np.zeros(6))
    s = read_npz(str(tmp_path / "d.npz"))
    assert s.collect()[0]["x"].shape == (6, 2)
    want = jax_readers.read_npz(str(tmp_path / "d.npz"), keys=["x"])
    got = read_npz(str(tmp_path / "d.npz"), keys=["x"])
    assert list(got.collect()[0]) == ["x"]
    np.testing.assert_array_equal(got.collect()[0]["x"],
                                  want.collect()[0]["x"])


def test_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_csv(str(tmp_path / "none*.csv"))


def test_extension_matching_is_case_insensitive(tmp_path):
    _df(6, 0).to_csv(tmp_path / "lower.csv", index=False)
    _df(4, 1).to_csv(tmp_path / "UPPER.CSV", index=False)
    s = read_csv(str(tmp_path))
    assert s.num_partitions() == 2
    assert len(s) == 10
    _same_frames(s, jax_readers.read_csv(str(tmp_path)))


def test_pandas_namespace_is_the_readers():
    assert pandas is readers
    assert pandas.read_csv is read_csv


def test_one_process_reads_every_file():
    """Without a process group the port's process index and count are
    what ``jax.process_index()``/``process_count()`` give in one process."""
    import jax
    assert readers.process_grid() == (jax.process_index(),
                                      jax.process_count())
    files = [f"f{i}" for i in range(5)]
    assert readers._my_files(files) == (files, None)


@pytest.mark.parametrize("pid,n,n_files", [(1, 3, 7), (2, 3, 2), (0, 2, 1)])
def test_file_split_between_processes(tmp_path, monkeypatch, pid, n,
                                      n_files):
    """Process ``pid`` of ``n``: files ``pid::n``, or (fewer files than
    processes) every file with rows ``pid::n``, as the JAX reader splits
    them under the same process index and count."""
    import jax
    for i in range(n_files):
        _df(9, i).to_csv(tmp_path / f"p{i}.csv", index=False)
    np.savez(tmp_path / "d.npz", x=np.arange(12.0))
    monkeypatch.setattr(readers, "process_grid", lambda: (pid, n))
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    _same_frames(read_csv(str(tmp_path)),
                 jax_readers.read_csv(str(tmp_path)))
    got = read_npz(str(tmp_path / "d.npz")).collect()
    want = jax_readers.read_npz(str(tmp_path / "d.npz")).collect()
    np.testing.assert_array_equal(got[0]["x"], want[0]["x"])


def test_file_readahead_overlaps_and_counts_waits(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * 64)
        paths.append(str(p))
    ra = FileReadahead(depth=2)
    ra.hint(paths)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and not ra._cache:
        time.sleep(0.005)
    for i, p in enumerate(paths):
        assert ra.get(p) == bytes([i]) * 64
    # an un-hinted miss reads inline and counts the blocked time
    miss = tmp_path / "miss.bin"
    miss.write_bytes(b"z" * 8)
    before = ra.wait_ms
    assert ra.get(str(miss)) == b"z" * 8
    assert ra.wait_ms >= before
    # a lost race retires the hint: no consumed path lingers in (or later
    # enters) the cache
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        with ra._cond:
            stale = set(ra._cache) & set(paths)
            idle = ra._reading is None and not ra._want
        if idle and not stale:
            break
        time.sleep(0.005)
    assert not stale, stale
    ra.close()


def test_file_readahead_rejects_zero_depth():
    with pytest.raises(ValueError, match="depth"):
        FileReadahead(depth=0)


def _tiny_readers_sizes(chip_smoke, missing):
    return chip_smoke.ReadersSizes(
        device="cpu", images=64, classes=4, side=40, crop=32, batch=8,
        resnet=dict(norm="batch", dtype="float32", depth=18, width=8,
                    class_num=10),
        workers=2, epochs=1, cmp_steps=2, resident=2,
        news20=dict(docs=64, words=(10, 30), vocab=300, classes=4), seq=24,
        text_batch=16, text=dict(token_length=8, encoder_output_dim=8),
        text_cmp={"cnn": 2, "lstm": 1, "gru": 1},
        text_window={"cnn": 2, "lstm": 1, "gru": 1},
        wikiqa=dict(text1_length=4, text2_length=8, embed_size=8,
                    kernel_num=5),
        knrm_rows=64, knrm_steps=(2, 2),
        ssd=dict(class_num=3, backbone_depth=18, image_size=64),
        ssd_batch=2, ip=(8, 32, 8), missing=missing)


@pytest.mark.parametrize("missing", [{}, {"PIL": "JPEG decode",
                                          "pyarrow": "read_parquet"}],
                         ids=["all", "without_pil_pyarrow"])
def test_chip_smoke_readers_phase_runs_on_the_cpu_at_tiny_sizes(
        missing, capsys):
    """``chip_smoke.py``'s readers phase end to end through its CPU seam
    (``ReadersSizes(device="cpu")``, tiny widths): captured against eager
    (both eager here) equal, the detector against itself, the frames
    against pandas, no kernel launch; without PIL and pyarrow it names
    both parts on a line of its own first and still fits the ResNet over
    raw files."""
    import importlib
    import json
    import os
    import sys
    import torch
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    ops = [importlib.import_module(f"analytics_zoo_tpu_torch.ops.{m}")
           for m in ("flash_attention", "fused_bn", "fused_xent")]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = chip_smoke.phase_readers(
            *ops, _tiny_readers_sizes(chip_smoke, missing))
    finally:
        torch.set_num_threads(n)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    fit = res["imageset_fit"]
    assert fit["losses_against_eager"]["bitwise_equal"]
    assert fit["steps_an_epoch"] == 8
    assert not any(res["kernel_launches"].values())
    assert res["input_pipeline"]["bottleneck_stage"] in ("io", "decode",
                                                         "h2d")
    for enc in ("cnn", "lstm", "gru"):
        assert res["text"][f"text_classifier_{enc}"][
            "losses_against_eager"]["bitwise_equal"]
    assert res["detector"]["raw_rel_err"] == 0.0
    assert res["interop"]["predict_rows"] == 1000
    if missing:
        assert lines[0]["missing_packages"].keys() == {"PIL", "pyarrow"}
        assert fit["source"].startswith("raw")
        assert "nnclassifier" not in res
        assert "parquet" not in res["read_rows_equal_pandas"]
    else:
        assert "missing_packages" not in lines[0] or \
            lines[0]["missing_packages"] == []
        assert res["nnclassifier"]["transform_equals_predict"]
        assert res["read_rows_equal_pandas"]["parquet"] == 1400
