"""The port's chronos (``analytics_zoo_tpu_torch/chronos``) against the JAX
package on the CPU.

- ``TSDataset``: roll (one series and by id), scale (standard, minmax, a
  fitted scaler on another split), impute, resample, dt features and
  ``unscale_numpy`` give the JAX package's arrays; ``XShardsTSDataset``
  its global scaling and rolled windows; ``to_feed`` the port's
  ``DataFeed``.
- Every forecaster family (LSTM, Seq2Seq over LSTM and GRU, TCN, MTNet):
  the JAX forecaster's initial weights through ``convert.from_jax_variables``
  into the port's, dropout 0, 3 steps of adam: step losses within 1e-4 of
  max(1, |loss|), then ``predict`` and ``evaluate`` within 1e-4 of max(1,
  max |ref|).
- Saved models across the packages: a JAX-saved forecaster and
  ``TSPipeline`` (its config and target scaler) loaded by the port, and
  the port's loaded by JAX, each predicting the other's numbers (1e-5 of
  max(1, max |ref|)); ``TCMFForecaster`` saved by JAX and predicting in
  the port.
- TCMF given the JAX initial ``F`` and ``X``: the factors and the
  factorization loss within 1e-4 of max(1, max |ref|); one device only.
- ``AutoTSEstimator`` on a 200-point series with 2 trials, the search's
  configs the JAX package's for the seed; the detectors; ARIMA and
  Prophet's numpy backends equal to the JAX package's.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import analytics_zoo_tpu.chronos as jchronos
from analytics_zoo_tpu.core import init_orca_context
import analytics_zoo_tpu_torch.chronos as chronos
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.data import DataFeed, XShards

LOSS_TOL = 1e-4
PRED_TOL = 1e-4
LOAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _series_df(n=200, freq="h", seed=0):
    rng = np.random.default_rng(seed)
    ts = pd.date_range("2021-01-01", periods=n, freq=freq)
    value = np.sin(np.arange(n) / 12) + 0.1 * rng.normal(size=n)
    return pd.DataFrame({"datetime": ts, "value": value,
                         "extra": rng.normal(size=n)})


def _both(fn):
    """``fn(package)`` for the JAX package and the port."""
    return fn(jchronos), fn(chronos)


# -- TSDataset ----------------------------------------------------------------

def _pipeline(pkg, df, scaler):
    ts = pkg.TSDataset.from_pandas(df, dt_col="datetime", target_col="value",
                                   extra_feature_col=["extra"])
    ts.impute("linear").deduplicate().gen_dt_feature(["HOUR", "DAYOFWEEK"])
    ts.scale(scaler)
    ts.roll(lookback=10, horizon=[1, 3])
    return ts


@pytest.mark.parametrize("scaler", ["standard", "minmax"])
def test_tsdataset_arrays_equal_jax(scaler):
    df = _series_df(120)
    df.loc[[5, 17, 40], "value"] = np.nan
    df = pd.concat([df, df.iloc[[30]]])  # a duplicate timestamp
    jts, tts = _both(lambda pkg: _pipeline(pkg, df, scaler))
    for a, b in zip(tts.to_numpy(), jts.to_numpy()):
        np.testing.assert_array_equal(a, b)
    pd.testing.assert_frame_equal(tts.to_pandas(), jts.to_pandas())
    arr = np.random.default_rng(1).normal(size=(4, 2, 1))
    np.testing.assert_array_equal(tts.unscale_numpy(arr),
                                  jts.unscale_numpy(arr))
    # a fitted scaler applied to another split
    jtest, ttest = _both(lambda pkg: pkg.TSDataset.from_pandas(
        _series_df(60, seed=3), dt_col="datetime", target_col="value",
        extra_feature_col=["extra"]).gen_dt_feature(["HOUR", "DAYOFWEEK"]))
    jtest.scale(jts.scaler, fit=False)
    ttest.scale(tts.scaler, fit=False)
    pd.testing.assert_frame_equal(ttest.to_pandas(), jtest.to_pandas())


@pytest.mark.parametrize("mode", ["last", "const", "linear"])
def test_tsdataset_impute_and_resample_equal_jax(mode):
    df = _series_df(96, freq="15min")
    df.loc[[2, 3, 50], "value"] = np.nan
    jts, tts = _both(lambda pkg: pkg.TSDataset.from_pandas(
        df, dt_col="datetime", target_col="value",
        extra_feature_col=["extra"]).impute(mode).resample("h"))
    pd.testing.assert_frame_equal(tts.to_pandas(), jts.to_pandas())


def test_tsdataset_multi_id_roll_and_feed():
    df = pd.concat([_series_df(40, seed=1).assign(station="a"),
                    _series_df(30, seed=2).assign(station="b")])
    jts, tts = _both(lambda pkg: pkg.TSDataset.from_pandas(
        df, dt_col="datetime", target_col="value", id_col="station"
    ).roll(lookback=8, horizon=2))
    for a, b in zip(tts.to_numpy(), jts.to_numpy()):
        np.testing.assert_array_equal(a, b)
    feed = tts.to_feed(batch_size=16, shuffle=False)
    assert isinstance(feed, DataFeed) and feed.num_rows == 31 + 21
    loader = tts.to_torch_data_loader(batch_size=8, shuffle=False)
    xb, yb = next(iter(loader))
    np.testing.assert_array_equal(xb.numpy(), tts.to_numpy()[0][:8])


def test_xshards_tsdataset_equals_jax():
    df = pd.concat([_series_df(50, seed=s).assign(sid=f"s{s}")
                    for s in range(5)])
    df.loc[df.index[::17], "value"] = np.nan

    def run(pkg):
        ds = pkg.XShardsTSDataset.from_pandas(
            df, dt_col="datetime", target_col="value", id_col="sid",
            extra_feature_col=["extra"], num_shards=3)
        ds.scale("standard").impute("last").roll(10, 2)
        return ds

    jds, tds = _both(run)
    assert isinstance(tds.shards, XShards)
    for a, b in zip(tds.to_numpy(), jds.to_numpy()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for k in ("mean", "std"):
        np.testing.assert_allclose(tds.scaler[k].to_numpy(),
                                   jds.scaler[k].to_numpy(), rtol=1e-12)
    assert isinstance(tds.to_feed(8), DataFeed)


# -- forecasters --------------------------------------------------------------

FAMILIES = {
    "lstm": ("LSTMForecaster", dict(hidden_dim=8, layer_num=2)),
    "seq2seq_lstm": ("Seq2SeqForecaster",
                     dict(lstm_hidden_dim=8, rnn_type="lstm")),
    "seq2seq_gru": ("Seq2SeqForecaster",
                    dict(lstm_hidden_dim=6, lstm_layer_num=2,
                         rnn_type="gru")),
    "tcn": ("TCNForecaster", dict(num_channels=(4, 6), kernel_size=2)),
    "mtnet": ("MTNetForecaster",
              dict(long_series_num=3, cnn_hid_size=4, rnn_hid_size=5)),
}
PAST, FUTURE, FEATS = 12, 3, 2


def _xy(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, PAST, FEATS)).astype(np.float32),
            rng.normal(size=(n, FUTURE, 1)).astype(np.float32))


def _forecasters(family, **extra):
    """A JAX forecaster initialised on the data and the port's twin
    holding its weights."""
    cls, kw = FAMILIES[family]
    kw = dict(kw, dropout=0.0, **extra)
    args = dict(past_seq_len=PAST, future_seq_len=FUTURE,
                input_feature_num=FEATS, output_feature_num=1)
    jcls = getattr(jchronos, cls)
    jfc = jcls(**args, **kw)
    jfc.est._ensure_initialized(np.asarray(_xy()[0]))
    tfc = getattr(chronos, cls)(**args, device="cpu", **kw)
    tfc.model.load_state_dict(from_jax_variables(jfc.est.get_model()),
                              strict=True)
    return jfc, tfc


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forecaster_fit_predict_evaluate_match_jax(family):
    jfc, tfc = _forecasters(family)
    x, y = _xy()
    want = jfc.fit((x, y), epochs=3, batch_size=32)["loss"]
    got = tfc.fit((x, y), epochs=3, batch_size=32)["loss"]
    assert len(got) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL * max(1.0, abs(w)), (got, want)
    xv, yv = _xy(20, seed=1)
    _close(tfc.predict(xv, batch_size=8), jfc.predict(xv, batch_size=8),
           PRED_TOL, f"{family} predict")
    jm, tm = jfc.evaluate((xv, yv), 8), tfc.evaluate((xv, yv), 8)
    for k in ("loss", "mse"):
        assert abs(tm[k] - jm[k]) <= PRED_TOL * max(1.0, abs(jm[k])), k


def test_trunk_state_dict_keys_are_the_jax_tree():
    jfc, tfc = _forecasters("tcn")
    assert sorted(tfc.model.state_dict()) == sorted(
        from_jax_variables(jfc.est.get_model()))
    assert "tcn0_proj.kernel" in tfc.model.state_dict()
    assert "tcn1_proj.kernel" in tfc.model.state_dict()


def test_forecaster_seed_gives_one_model():
    a = chronos.LSTMForecaster(PAST, FUTURE, FEATS, 1, seed=3, device="cpu")
    b = chronos.LSTMForecaster(PAST, FUTURE, FEATS, 1, seed=3, device="cpu")
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), n


def test_mtnet_rejects_bad_window():
    with pytest.raises(ValueError, match="divisible"):
        chronos.MTNetForecaster(past_seq_len=25, future_seq_len=1,
                                input_feature_num=1, output_feature_num=1,
                                long_series_num=3)


@pytest.mark.parametrize("family", ["lstm", "mtnet"])
def test_saved_forecasters_cross_between_the_packages(tmp_path, family):
    jfc, tfc = _forecasters(family)
    x, y = _xy()
    jfc.fit((x, y), epochs=1, batch_size=16)
    tfc.fit((x, y), epochs=2, batch_size=16)
    jfc.save(str(tmp_path / "jax"))
    tfc.save(str(tmp_path / "port"))
    jload, tload = _forecasters(family)
    tload.load(str(tmp_path / "jax"))
    _close(tload.predict(x), jfc.predict(x), LOAD_TOL, "jax -> port")
    jload.load(str(tmp_path / "port"))
    _close(jload.predict(x), tfc.predict(x), LOAD_TOL, "port -> jax")


def test_tspipelines_cross_between_the_packages(tmp_path):
    df = _series_df(150)
    df["value"] = df["value"] * 10.0 + 50.0

    def pipeline(pkg, **kw):
        ts = pkg.TSDataset.from_pandas(df, dt_col="datetime",
                                       target_col="value")
        ts.scale("standard").roll(PAST, FUTURE)
        x, y = ts.to_numpy()
        cfg = dict(model="tcn", past_seq_len=PAST, future_seq_len=FUTURE,
                   input_feature_num=1, output_feature_num=1,
                   model_kwargs=dict(num_channels=[4, 4], dropout=0.0))
        fc = pkg.TCNForecaster(PAST, FUTURE, 1, 1,
                               **cfg["model_kwargs"], **kw)
        fc.fit((x, y), epochs=1, batch_size=32)
        return pkg.TSPipeline(fc, cfg, scaler=pkg.autots._target_scaler(ts)
                              ), x

    (jpipe, x), (tpipe, _) = pipeline(jchronos), pipeline(chronos,
                                                          device="cpu")
    jpipe.save(str(tmp_path / "jax"))
    tpipe.save(str(tmp_path / "port"))
    tload = chronos.TSPipeline.load(str(tmp_path / "jax"), device="cpu")
    assert tload.scaler == jpipe.scaler
    assert tload.config["model_kwargs"]["num_channels"] == [4, 4]
    _close(tload.predict(x), jpipe.predict(x), LOAD_TOL, "jax -> port")
    assert np.abs(tload.predict(x)).mean() > 10  # unscaled
    jload = jchronos.TSPipeline.load(str(tmp_path / "port"))
    _close(jload.predict(x), tpipe.predict(x), LOAD_TOL, "port -> jax")
    # the port's own round trip gives equal bits
    again = chronos.TSPipeline.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.predict(x), tpipe.predict(x))


# -- AutoTS -------------------------------------------------------------------

def test_autots_two_trials_on_200_points(tmp_path):
    from analytics_zoo_tpu_torch.automl import hp
    df = _series_df(200)

    def search(pkg, hp_mod, **kw):
        ts = pkg.TSDataset.from_pandas(df, dt_col="datetime",
                                       target_col="value")
        ts.scale()
        auto = pkg.AutoTSEstimator(
            model=["lstm", "tcn"], past_seq_len=hp_mod.choice([8, 12]),
            search_space={"lr": hp_mod.choice([1e-2, 1e-3])},
            future_seq_len=2, seed=4, **kw)
        return auto, ts

    tauto, ts = search(chronos, hp, device="cpu")
    pipe = tauto.fit(ts, epochs=1, batch_size=16, n_sampling=2,
                     max_concurrent=2)
    assert [t.status for t in tauto.trials] == ["done", "done"]
    # the configs the JAX package's engine draws for the seed
    from analytics_zoo_tpu.automl import hp as jhp
    from analytics_zoo_tpu.automl.search import RandomSearchEngine
    jauto, _ = search(jchronos, jhp)
    space = dict(jauto.search_space, model=jauto.model_space,
                 past_seq_len=jauto.past_seq_len)
    want = RandomSearchEngine(seed=4).configs(space, 2)
    assert [t.config for t in tauto.trials] == want
    lookback = pipe.config["past_seq_len"]
    ts.roll(lookback, 2)
    x, y = ts.to_numpy()
    pred = pipe.predict(x[:5])
    assert pred.shape == (5, 2, 1) and np.all(np.isfinite(pred))
    pipe.save(str(tmp_path / "p"))
    loaded = chronos.TSPipeline.load(str(tmp_path / "p"), device="cpu")
    np.testing.assert_array_equal(loaded.predict(x[:5]), pred)
    assert np.isfinite(loaded.evaluate((x[:8], y[:8]))["mse"])


def test_auto_single_model_wrappers():
    auto = chronos.AutoTCN(past_seq_len=8, future_seq_len=1, device="cpu")
    assert auto.model_space.options == ["tcn"]
    with pytest.raises(ValueError, match="family only"):
        chronos.AutoLSTM(model=["tcn"])


# -- TCMF ---------------------------------------------------------------------

def _panel(n=10, t=80, seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(t)
    basis = np.stack([np.sin(tt / 6.0), np.cos(tt / 11.0)])
    return (rng.normal(size=(n, 2)) @ basis
            + 0.05 * rng.normal(size=(n, t))).astype(np.float32)


def _jax_init(seed, n, k, t):
    import jax
    rf, rx = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(rf, (n, k)) * 0.1),
            np.asarray(jax.random.normal(rx, (k, t)) * 0.1))


def test_tcmf_factorization_matches_jax_from_its_init(tmp_path):
    y = _panel()
    kw = dict(rank=3, y_iters=60, tcn_lookback=8, num_channels_X=(4, 4))
    jfc = jchronos.TCMFForecaster(**kw)
    want = jfc.fit({"y": y}, epochs=1)
    tfc = chronos.TCMFForecaster(device="cpu", **kw)
    got = tfc.fit({"y": y}, epochs=1, _init=_jax_init(0, *y.shape[:1],
                                                     3, y.shape[1]))
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)
    _close(tfc.F, jfc.F, 1e-4, "F")
    _close(tfc.X, jfc.X, 1e-4, "X")
    pred = tfc.predict(horizon=5)
    assert pred.shape == (10, 5) and np.all(np.isfinite(pred))
    assert np.isfinite(tfc.evaluate({"y": y[:, -5:]}, ("mae", "mse"))["mse"])
    # a JAX-saved TCMF predicts its numbers in the port, and back
    jfc.save(str(tmp_path / "jax"))
    tload = chronos.TCMFForecaster.load(str(tmp_path / "jax"), device="cpu")
    _close(tload.predict(horizon=5), jfc.predict(horizon=5), LOAD_TOL,
           "jax -> port")
    tfc.save(str(tmp_path / "port"))
    jload = jchronos.TCMFForecaster.load(str(tmp_path / "port"))
    _close(jload.predict(horizon=5), pred, LOAD_TOL, "port -> jax")


def test_tcmf_xshards_input_and_one_device():
    y = _panel(n=6, t=40)
    shards = XShards([{"id": np.array(["a", "b"]), "y": y[:2]},
                      {"id": np.array(["c", "d", "e", "f"]), "y": y[2:]}])
    fc = chronos.TCMFForecaster(rank=2, y_iters=20, tcn_lookback=6,
                                num_channels_X=(4,), device="cpu")
    fc.fit(shards, epochs=1)
    out = fc.predict(horizon=3)
    assert isinstance(out, XShards)
    parts = out.collect()
    assert [p["prediction"].shape for p in parts] == [(2, 3), (4, 3)]
    assert list(parts[1]["id"]) == ["c", "d", "e", "f"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        chronos.TCMFForecaster(device=["cpu", "cpu"])


# -- detectors and the classical forecasters ----------------------------------

def test_detectors():
    rng = np.random.default_rng(0)
    y = np.sin(np.arange(300) / 8) + 0.05 * rng.normal(size=300)
    y[150] += 4.0
    th = chronos.ThresholdDetector(ratio=0.01).fit(y)
    jth = jchronos.ThresholdDetector(ratio=0.01).fit(y)
    assert th.threshold == jth.threshold
    np.testing.assert_array_equal(th.anomaly_indexes(y),
                                  jth.anomaly_indexes(y))
    ae = chronos.AEDetector(roll_len=12, ratio=0.01, epochs=3, device="cpu")
    idx = ae.anomaly_indexes(y)
    assert 150 <= np.median(idx) <= 162, idx
    ae2 = chronos.AEDetector(roll_len=12, ratio=0.01, epochs=3,
                             device="cpu").fit(y)
    np.testing.assert_array_equal(ae2.score(y), ae.score(y))
    db = chronos.DBScanDetector(eps=0.3, min_samples=3)
    np.testing.assert_array_equal(
        db.anomaly_indexes(np.append(y[:100], 5.0)),
        jchronos.DBScanDetector(eps=0.3, min_samples=3).anomaly_indexes(
            np.append(y[:100], 5.0)))


def test_classical_numpy_backends_equal_jax():
    rng = np.random.default_rng(0)
    y = np.cumsum(rng.normal(size=160))
    for order, seasonal in (((2, 1, 1), (0, 0, 0, 0)),
                            ((1, 0, 0), (0, 1, 0, 12))):
        got = chronos.ARIMAForecaster(order, seasonal, backend="numpy"
                                      ).fit(y).predict(6)
        want = jchronos.ARIMAForecaster(order, seasonal, backend="numpy"
                                        ).fit(y).predict(6)
        np.testing.assert_array_equal(got, want)
    df = pd.DataFrame({"ds": pd.date_range("2023-01-01", periods=120,
                                           freq="D"),
                       "y": np.sin(np.arange(120) * 2 * np.pi / 7)
                       + 0.01 * np.arange(120)})
    got = chronos.ProphetForecaster(backend="numpy").fit(df).predict(5)
    want = jchronos.ProphetForecaster(backend="numpy").fit(df).predict(5)
    pd.testing.assert_frame_equal(got, want)


def test_packages_export_the_jax_names():
    import analytics_zoo_tpu.automl as jautoml
    import analytics_zoo_tpu_torch.automl as automl
    assert sorted(chronos.__all__) == sorted(jchronos.__all__)
    assert sorted(automl.__all__) == sorted(jautoml.__all__)


def test_chip_smoke_autots_phase_runs_on_the_cpu_at_tiny_sizes():
    """``chip_smoke.py``'s autots phase end to end through its CPU seam
    (``AutotsSizes(device="cpu")``, tiny widths): the trunk checks, the
    search's trials all ``done``, the captured-against-eager comparison
    (both eager here), the saved models, and no kernel launch."""
    import importlib
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    ops = [importlib.import_module(f"analytics_zoo_tpu_torch.ops.{m}")
           for m in ("flash_attention", "fused_bn", "fused_xent")]
    sizes = chip_smoke.AutotsSizes(
        device="cpu", points=300, trials=2, hidden=8, channels=(8, 8),
        tcmf=(6, 60), sessions=64, items=50, vocab=30,
        session_kw=dict(item_embed=8, rnn_hidden_layers=(8, 6)))
    res = chip_smoke.phase_autots(*ops, sizes)
    assert [t["status"] for t in res["search"]["trials"]] == ["done"] * 2
    assert res["captured_vs_eager"]["lstm"]["losses_against_eager"][
        "bitwise_equal"]
    assert res["saved_models"]["pipeline_reload_bitwise_equal"]
    assert not any(res["kernel_launches"].values())
    assert len(res["trunks"]["trunks"]) == 11
