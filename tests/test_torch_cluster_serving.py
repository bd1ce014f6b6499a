"""The port's ``ClusterServing`` against the JAX package's on the CPU.

The same weights (a small BERT initialised in JAX, through
``convert.from_jax_variables``; and ``tests/test_serving.py``'s linear
model) are served by both packages' servers, and the same seeded requests
go through concurrent clients of each.  Replies agree within ``TOL =
1e-4`` (f32 through two layers; the frameworks sum in different orders):
round trips with mixed shapes, both schedulers, the stats invariants,
registry routing with version pins, a hot swap under load, drain and kill,
the HTTP frontend over a replica set, the batch scorer, and each
package's client against the other's server (the frames are equal byte
for byte).  The ``cuda`` tests (skipped without a card) serve from CUDA
graphs: the server against direct ``predict``, two workers' replays on two
keys against serial replays, and a swap's capture beside live replays.
"""

import importlib
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu import native as jax_native
from analytics_zoo_tpu import serving as jax_serving
from analytics_zoo_tpu.models import BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu.serving import protocol as jax_protocol
from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.models import BERTClassifier
from analytics_zoo_tpu_torch.serving import (BatchScorer, ClusterServing,
                                             HTTPFrontend, InferenceModel,
                                             InputQueue, ModelRegistry,
                                             OutputQueue, ReplicaSet,
                                             RetryPolicy,
                                             SubprocessReplicaFactory,
                                             read_output)
from analytics_zoo_tpu_torch.serving import protocol
from analytics_zoo_tpu_torch.serving import server as server_lib

from _torch_serving import (CFG, CLASSES, SEQ, TOL, Served, close, ids,
                            no_leaked_port_controllers, one_torch_thread,
                            port_faults_disarmed, port_telemetry_reset)

BUCKETS = (1, 4, 16)
PORT_CLIENT = (InputQueue, OutputQueue)
JAX_CLIENT = (jax_serving.InputQueue, jax_serving.OutputQueue)


def _jax_bert(seed):
    m = JaxBERTClassifier(CLASSES, use_flash=True, **CFG)
    return m, m.init(jax.random.PRNGKey(seed), ids(1))


def _pair(seed):
    """Version ``seed`` of the small BERT served by each package."""
    m, v = _jax_bert(seed)
    return (jax_serving.InferenceModel(batch_buckets=BUCKETS).load(m, v),
            InferenceModel(batch_buckets=BUCKETS, device="cpu").load(
                BERTClassifier(CLASSES, use_flash=True, **CFG),
                from_jax_variables(v)))


@pytest.fixture(scope="module")
def versions():
    """{seed: (JAX InferenceModel, port InferenceModel)} for two versions."""
    return {seed: _pair(seed) for seed in (0, 1)}


def _linear_pair():
    """``tests/test_serving.py``'s linear model: one Dense(3) named fc."""
    class M(jnn.Module):
        def forward(self, scope, x):
            return scope.child(jnn.Dense(3), x, name="fc")

    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Dense(4, 3)

        def forward(self, x):
            return self.fc(x)

    m = M()
    v = m.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.float32))
    return (jax_serving.InferenceModel(batch_buckets=(1, 4, 8)).load(m, v),
            InferenceModel(batch_buckets=(1, 4, 8), device="cpu").load(
                P(), from_jax_variables(v)))


def _fast_retry(**kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("base_delay", 0.02)
    kw.setdefault("max_delay", 0.1)
    kw.setdefault("seed", 0)
    return RetryPolicy(**kw)


def _drive(srv, rows, client=PORT_CLIENT, n_clients=4, **enqueue):
    """Send ``rows`` through ``n_clients`` concurrent clients, each over
    its own queues (a client enqueues its share, then queries each);
    returns the replies in row order."""
    out = [None] * len(rows)
    errors = []

    def run(c):
        iq = client[0](srv.host, srv.port)
        oq = client[1](input_queue=iq)
        try:
            mine = range(c, len(rows), n_clients)
            uids = [iq.enqueue(f"r{i}", t=rows[i], **enqueue) for i in mine]
            for i, uid in zip(mine, uids):
                out[i] = oq.query(uid, timeout=30.0)
        except Exception as e:  # noqa: BLE001 - recorded, asserted below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            iq.close()

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a client hung"
    assert not errors, errors[:3]
    return out


def _invariant(st):
    assert st["requests"] == st["replies"] + st["errors"] + st["pending"]
    assert st["pending"] == 0


# -- round trips ---------------------------------------------------------------

def test_round_trip_and_mixed_shapes_match_jax(versions):
    """Rows of 20 and of 12 tokens, interleaved: each server groups them
    by shape into batches, and every reply agrees with the JAX server's
    and with the port model's own ``predict`` of that row."""
    jax_im, port_im = versions[0]
    rows = [r for a, b in zip(ids(12, seed=1), ids(12, seed=2, seq=12))
            for r in (a, b)]
    with jax_serving.ClusterServing(jax_im, batch_size=8,
                                    batch_timeout_ms=20) as jsrv:
        want = _drive(jsrv, rows, JAX_CLIENT)
    with ClusterServing(port_im, batch_size=8, batch_timeout_ms=20) as srv:
        got = _drive(srv, rows)
        st = srv.stats()
    for row, g, w in zip(rows, got, want):
        assert g.shape == w.shape == (CLASSES,) and g.dtype == np.float32
        close(g, w)
        close(g, port_im.predict(row[None])[0])
    _invariant(st)
    assert st["requests"] == len(rows) and st["errors"] == 0


def test_linear_model_round_trip_matches_jax():
    jax_im, port_im = _linear_pair()
    rows = [np.full((4,), float(i), np.float32) for i in range(12)]
    with jax_serving.ClusterServing(jax_im, batch_size=8,
                                    batch_timeout_ms=20) as jsrv:
        want = _drive(jsrv, rows, JAX_CLIENT)
    with ClusterServing(port_im, batch_size=8, batch_timeout_ms=20) as srv:
        got = _drive(srv, rows)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("scheduler", ["window", "continuous"])
def test_schedulers_match_jax(versions, scheduler):
    jax_im, port_im = versions[0]
    rows = list(ids(32, seed=3))
    with jax_serving.ClusterServing(jax_im, batch_size=8,
                                    scheduler=scheduler) as jsrv:
        want = _drive(jsrv, rows, JAX_CLIENT, n_clients=8)
    with ClusterServing(port_im, batch_size=8, scheduler=scheduler) as srv:
        assert srv.scheduler.name == scheduler
        got = _drive(srv, rows, n_clients=8)
        st = srv.stats()
    for g, w in zip(got, want):
        close(g, w)
    _invariant(st)
    assert st["scheduler"] == scheduler and st["batches"] >= 1
    assert 1.0 <= st["mean_batch_size"] <= 8.0


def test_stats_invariants_match_jax(versions):
    """Good rows and rows the model refuses (float ids): both servers
    count the same requests, replies and errors, and both keep
    requests == replies + errors + pending."""
    def run(srv, client):
        iq = client[0](srv.host, srv.port)
        oq = client[1](input_queue=iq)
        good = [iq.enqueue(f"g{i}", t=r) for i, r in enumerate(ids(6, 4))]
        bad = [iq.enqueue(f"b{i}", t=np.ones(SEQ, np.float32))
               for i in range(2)]
        outs = [oq.query(u, timeout=30.0) for u in good]
        for u in bad:
            with pytest.raises(RuntimeError):
                oq.query(u, timeout=30.0)
        iq.close()
        return outs, srv.stats()

    jax_im, port_im = versions[0]
    with jax_serving.ClusterServing(jax_im, batch_size=4) as jsrv:
        want, jst = run(jsrv, JAX_CLIENT)
    with ClusterServing(port_im, batch_size=4) as srv:
        got, st = run(srv, PORT_CLIENT)
    for g, w in zip(got, want):
        close(g, w)
    for key in ("requests", "replies", "errors", "pending", "rejected",
                "shed", "unknown_model"):
        assert st[key] == jst[key], (key, st, jst)
    _invariant(st)
    assert st["errors"] == 2


def test_registry_routing_with_version_pins_matches_jax(versions):
    """Two versions under one name: unpinned rows go to the active one,
    rows pinned to v1 keep reading v1, and a name the registry does not
    hold gets an explicit error, in both packages alike."""
    def run(reg_cls, srv_cls, client, ims):
        reg = reg_cls()
        assert reg.register("bert", ims[0]) == "v1"
        with srv_cls(models=reg, batch_size=4) as srv:
            assert reg.swap("bert", ims[1]) == "v2"
            rows = list(ids(6, seed=5))
            active = _drive(srv, rows, client, model="bert")
            pinned = _drive(srv, rows, client, model="bert", version="v1")
            iq = client[0](srv.host, srv.port)
            oq = client[1](input_queue=iq)
            with pytest.raises(RuntimeError, match="unknown model"):
                oq.query(iq.enqueue("x", model="ghost", t=rows[0]), 30.0)
            iq.close()
            return active, pinned, srv.stats()

    ja, jp, jst = run(jax_serving.ModelRegistry, jax_serving.ClusterServing,
                      JAX_CLIENT, [versions[0][0], versions[1][0]])
    pa, pp, st = run(ModelRegistry, ClusterServing, PORT_CLIENT,
                     [versions[0][1], versions[1][1]])
    rows = list(ids(6, seed=5))
    for i, row in enumerate(rows):
        close(pa[i], ja[i])
        close(pp[i], jp[i])
        close(pa[i], versions[1][1].predict(row[None])[0])
        close(pp[i], versions[0][1].predict(row[None])[0])
    assert st["unknown_model"] == jst["unknown_model"] == 1
    assert st["models"]["bert"]["versions"] == ["v1", "v2"]


def test_hot_swap_under_load_matches_jax(versions):
    """``update_model`` to version 1 while four clients run: no client
    sees a failure, the replies flip from version 0's logits to version
    1's (the JAX package's, within TOL), and the incoming model prepares
    nothing once traffic flows: its ``compile_count`` after ``warm_from``
    stays put."""
    want = {seed: versions[seed][0].predict(ids(4, seed=6))
            for seed in (0, 1)}
    rows = ids(4, seed=6)
    v1 = InferenceModel(batch_buckets=(1, 4), device="cpu").load(
        BERTClassifier(CLASSES, use_flash=True, **CFG),
        {k: t for k, t in versions[0][1]._model.state_dict().items()})
    assert v1.warm([(SEQ,)], dtype=np.int32) == 2
    seen = {0: 0, 1: 0}
    failures = []
    lock = threading.Lock()
    stop = threading.Event()

    def client(i):
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        try:
            while not stop.is_set():
                out = oq.query(iq.enqueue(f"c{i}", t=rows[i]), 30.0)
                if out is None:
                    failures.append("timeout")
                    continue
                match = [s for s in (0, 1) if np.allclose(
                    out, want[s][i], atol=TOL, rtol=TOL)]
                if len(match) != 1:
                    failures.append(f"row {i}: {out} matches {match}")
                    continue
                with lock:
                    seen[match[0]] += 1
        except Exception as e:  # noqa: BLE001 - recorded, asserted below
            failures.append(f"{type(e).__name__}: {e}")
        finally:
            iq.close()

    def wait_for(version, n):
        deadline = time.monotonic() + 30
        while seen[version] < n and not failures:
            assert time.monotonic() < deadline, (seen, failures)
            time.sleep(0.01)

    with ClusterServing(v1, batch_size=4, scheduler="continuous") as srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            wait_for(0, 20)
            v2 = InferenceModel(batch_buckets=(1, 4), device="cpu").load(
                BERTClassifier(CLASSES, use_flash=True, **CFG),
                {k: t for k, t in
                 versions[1][1]._model.state_dict().items()})
            srv.update_model(v2)
            after_warm = v2.compile_count
            wait_for(1, 20)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        st = srv.stats()
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    assert v2.compile_count == after_warm == len(v1._compiled) == 2
    assert st["errors"] == 0 and st["requests"] == st["replies"]


# -- drain and kill ------------------------------------------------------------

def _drain_and_kill(srv_cls, client, model):
    """test_ha's drain scenario, then a hard kill: what a client sees."""
    srv = srv_cls(model, batch_size=1, batch_timeout_ms=1).start()
    iq = client[0](srv.host, srv.port, retry=_fast_retry(max_attempts=2))
    oq = client[1](input_queue=iq)
    x = ids(1, seed=7)[0]
    uid_in = iq.enqueue("in-flight", t=x)
    time.sleep(0.05)  # the request reaches the pipeline
    assert srv.drain(wait=False) and srv.state == "draining"
    assert iq.conn.ping(timeout=5.0)["state"] == "draining"
    with pytest.raises(RuntimeError, match="draining"):
        oq.query(iq.enqueue("late", t=x), timeout=10.0)
    assert srv.drain(wait=True, timeout=10.0)
    served = oq.query(uid_in, timeout=10.0)
    st = srv.stats()
    srv.kill()
    assert srv.state == "stopped"
    assert iq.conn.ping(timeout=0.5) is None  # the socket died with it
    iq.close()
    return served, st


def test_drain_and_kill_match_jax(versions):
    jax_im, port_im = versions[0]
    want, jst = _drain_and_kill(jax_serving.ClusterServing, JAX_CLIENT,
                                Served(jax_im, delay=0.2))
    got, st = _drain_and_kill(ClusterServing, PORT_CLIENT,
                              Served(port_im, delay=0.2))
    close(got, want)
    for key in ("requests", "replies", "errors", "draining_rejected"):
        assert st[key] == jst[key], (key, st, jst)
    assert st["requests"] == st["replies"] + st["errors"]


def test_request_admitted_while_stop_closes_the_queue_is_answered():
    """A request that enters the pending table after ``stop()`` closed the
    queue (a client's replay on a connection accepted during the stop)
    gets ``server shutting down`` at once and leaves nothing pending; the
    JAX package's server leaves such a request pending."""
    _, port_im = _linear_pair()
    with ClusterServing(port_im, batch_size=4) as srv:
        def closed(*a, **kw):
            raise RuntimeError("queue closed")

        srv._queue.push = closed  # the queue as stop() leaves it
        iq = InputQueue(srv.host, srv.port, retry=_fast_retry(max_attempts=1))
        oq = OutputQueue(input_queue=iq)
        with pytest.raises(RuntimeError, match="shutting down"):
            oq.query(iq.enqueue("late", t=np.ones(4, np.float32)), 10.0)
        iq.close()
        st = srv.stats()
    assert st["pending"] == 0 and st["drained"] == 1
    assert st["requests"] == st["replies"] + st["errors"] == 1


# -- the HTTP frontend over a replica set --------------------------------------

def _post(fe, body):
    req = urllib.request.Request(
        f"http://{fe.host}:{fe.port}/predict",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return np.asarray(json.load(r)["predictions"], np.float32)


def test_http_frontend_over_replica_set_matches_jax(versions):
    """One POST a row (an instance is the one tensor of a request) through
    the port's frontend over a replica set of two port servers, and
    through the JAX package's frontend over its server."""
    jax_im, port_im = versions[0]
    bodies = [{"instances": r.tolist(), "dtype": "int32"}
              for r in ids(5, seed=8)]
    with jax_serving.ClusterServing(jax_im, batch_size=8) as jsrv, \
            jax_serving.HTTPFrontend(jsrv.host, jsrv.port) as jfe:
        want = [_post(jfe, b) for b in bodies]
    s1 = ClusterServing(port_im, batch_size=8).start()
    s2 = ClusterServing(port_im, batch_size=8).start()
    rs = ReplicaSet([(s.host, s.port) for s in (s1, s2)],
                    retry=_fast_retry(), start_health=False)
    try:
        with HTTPFrontend(router=rs) as fe:
            got = [_post(fe, b) for b in bodies]
            with urllib.request.urlopen(
                    f"http://{fe.host}:{fe.port}/healthz", timeout=10) as r:
                hz = json.load(r)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(fe, {"wrong": 1})
            assert ei.value.code == 400
    finally:
        rs.close()
        s1.stop()
        s2.stop()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (CLASSES,)
        close(g, w)
    assert hz["status"] == "ok" and len(hz["replicas"]) == 2
    assert s1.stats()["replies"] + s2.stats()["replies"] == len(bodies)


# -- the batch scorer ------------------------------------------------------------

def test_batch_scorer_matches_jax(versions, tmp_path):
    """A journaled job of 40 rows in shards of 16 through two port
    replicas gives the JAX package's job output; a resumed job re-scores
    nothing."""
    jax_im, port_im = versions[0]
    rows = ids(40, seed=9)
    with jax_serving.ClusterServing(jax_im, batch_size=8) as jsrv:
        with jax_serving.BatchScorer([f"{jsrv.host}:{jsrv.port}"],
                                     str(tmp_path / "jax"),
                                     shard_size=16) as scorer:
            jrep = scorer.score(rows)
    want = jax_serving.read_output(str(tmp_path / "jax"))
    s1 = ClusterServing(port_im, batch_size=8).start()
    s2 = ClusterServing(port_im, batch_size=8).start()
    try:
        backends = [f"{s.host}:{s.port}" for s in (s1, s2)]
        with BatchScorer(backends, str(tmp_path / "port"),
                         shard_size=16, max_inflight=2) as scorer:
            rep = scorer.score(rows)
        with BatchScorer(backends, str(tmp_path / "port"),
                         shard_size=16) as scorer:
            again = scorer.score(rows, resume=True)
    finally:
        s1.stop()
        s2.stop()
    got = read_output(str(tmp_path / "port"))
    assert got.shape == want.shape == (40, CLASSES)
    close(got, want)
    assert rep.rows == jrep.rows == 40
    assert rep.n_shards == jrep.n_shards == rep.scored_shards == 3
    assert again.resumed_shards == 3 and again.scored_shards == 0
    assert s1.stats()["replies"] + s2.stats()["replies"] == 40


# -- one package's client against the other's server ---------------------------

def test_jax_client_against_port_server(versions):
    jax_im, port_im = versions[0]
    rows = list(ids(6, seed=10)) + list(ids(2, seed=11, seq=12))
    with ClusterServing(port_im, batch_size=4) as srv:
        got = _drive(srv, rows, JAX_CLIENT, n_clients=2)
        pong = jax_serving.InputQueue(srv.host, srv.port).conn.ping(5.0)
    for row, g in zip(rows, got):
        close(g, jax_im.predict(row[None])[0])
    assert pong["pong"] is True and pong["state"] == "serving"


def test_port_client_against_jax_server(versions):
    jax_im, port_im = versions[0]
    rows = list(ids(6, seed=12))
    with jax_serving.ClusterServing(jax_im, batch_size=4) as jsrv:
        got = _drive(jsrv, rows, PORT_CLIENT, n_clients=2)
        rs = ReplicaSet([(jsrv.host, jsrv.port)], start_health=False)
        try:
            routed = rs.predict(rows[0], timeout=30.0)
        finally:
            rs.close()
    for row, g in zip(rows, got):
        close(g, port_im.predict(row[None])[0])
    close(routed, got[0])


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.int32).reshape(2, 3),
    np.linspace(-1, 1, 7, dtype=np.float32),
    np.ones((3, 1, 2), np.uint8),
    None], ids=["int32", "float32", "uint8", "header_only"])
def test_frames_are_byte_identical(arr):
    kw = dict(trace="t0", span="s1", model="bert", version="v2",
              deadline_ms=125, klass="batch")
    header = protocol.request_header("u1", **kw)
    assert header == jax_protocol.request_header("u1", **kw)
    frame = protocol.encode(header, arr)
    assert frame == jax_protocol.encode(header, arr)
    assert b"".join(protocol.encode_parts(header, arr)) == frame
    h, a = jax_protocol.decode(frame[4:])
    h2, a2 = protocol.decode(frame[4:])
    assert h == h2 and (a is None) == (a2 is None)
    if a is not None:
        np.testing.assert_array_equal(a, a2)
    assert protocol.encode_ping("p") == jax_protocol.encode_ping("p")
    assert protocol.encode_metrics_request("m") == \
        jax_protocol.encode_metrics_request("m")


# -- the native queue -----------------------------------------------------------

def test_native_queue_is_built_from_the_ports_source_into_its_build_dir():
    """The port's queue library is g++'s build of the port's own copy of
    ``zoo_native.cpp``, under ``analytics_zoo_tpu_torch/build/`` with the
    source's hash in its name (nothing beside the source); it passes the
    same payloads and tags as the JAX package's queue."""
    pkg = Path(importlib.import_module("analytics_zoo_tpu_torch").__file__)
    assert native.SRC == pkg.parent / "native" / "zoo_native.cpp"
    assert native.BUILD_DIR == pkg.parent / "build"
    port_dir = native.SRC.parent
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert native.SRC.read_bytes()[:40].startswith(b"// Port of")
    assert not list(port_dir.glob("*.so"))
    payloads = [b"", b"\x00\xff" * 300, bytes(range(256)) * 400,
                protocol.encode({"uuid": "u"}, np.arange(9.0))]
    out = {}
    for name, q in (("port", native.NativeQueue(max_items=8)),
                    ("jax", jax_native.NativeQueue(max_items=8))):
        assert q.is_native
        for i, p in enumerate(payloads):
            assert q.push(p, tag=i + 7)
        out[name] = [q.pop(timeout=1.0) for _ in payloads]
        assert q.pop(timeout=0.01) is None
        assert q.stats() == (len(payloads), len(payloads))
        q.close()
    assert out["port"] == out["jax"] == [(p, i + 7)
                                         for i, p in enumerate(payloads)]


# -- what is not ported yet, and no device fallback ----------------------------

def test_unported_entry_points_raise_naming_the_state_plane():
    """The state plane's serving entry points work now: the launcher asks
    for a model, the factory takes its child's arguments, and a registry
    refresh from a directory without generations says so."""
    with pytest.raises(SystemExit):
        server_lib.main([])  # argparse: a model directory is required
    factory = SubprocessReplicaFactory(["--model-dir", "/x"])
    assert factory.extra_args == ["--model-dir", "/x"]
    with pytest.raises(FileNotFoundError, match="no visible checkpoint"):
        ModelRegistry().swap_from_checkpoint("m", lambda *a: None, "/x")


def test_serving_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        ClusterServing(InferenceModel())


# -- the card --------------------------------------------------------------------

CARD_CFG = dict(vocab_size=100, hidden_size=64, n_layers=2, n_heads=4,
                max_position=64, dropout=0.0)
CARD_SEQ = 48


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")


def _card_model(seed, dtype=None, **kw):
    m = BERTClassifier(2, use_flash=True, **CARD_CFG)
    m.init_weights(torch.Generator().manual_seed(seed))
    v = {k: t.detach().clone() for k, t in m.state_dict().items()}
    im = InferenceModel(device="cuda", **kw).load(
        BERTClassifier(2, use_flash=True, **CARD_CFG), v, dtype=dtype)
    im.warm([(CARD_SEQ,)], dtype=np.int32)
    return im


def _card_ids(n, seed):
    return np.random.default_rng(seed).integers(
        0, 100, (n, CARD_SEQ)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_server_over_card_model_equals_direct_predict_on_card(dtype):
    """Two workers replay the graphs on their threads; each reply is the
    row's logits from direct ``predict`` (f32 1e-4, bf16 5e-2 of
    max(1, |ref|): a row's batch size differs between the two)."""
    _card()
    im = _card_model(0, dtype)
    compiled = im.compile_count
    rows = list(_card_ids(48, 1))
    with ClusterServing(im, batch_size=16, inference_workers=2) as srv:
        got = _drive(srv, rows, n_clients=8)
        st = srv.stats()
    want = im.predict(np.stack(rows))
    tol = 1e-4 if dtype is None else 5e-2
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * max(1.0, float(np.abs(w).max()))
    _invariant(st)
    assert im.compile_count == compiled


@pytest.mark.cuda
def test_two_keys_replayed_from_two_threads_give_serial_bits_on_card():
    """Replays of two keys from two threads at once (one serving stream,
    each thread waiting on its own replay's event) give the serial
    results bit for bit."""
    _card()
    im = _card_model(0, torch.bfloat16)
    xs = {1: _card_ids(1, 2), 16: _card_ids(13, 3)}
    want = {n: im.predict(x) for n, x in xs.items()}
    got = {n: [] for n in xs}

    def run(n):
        for _ in range(25):
            got[n].append(im.predict(xs[n]))

    threads = [threading.Thread(target=run, args=(n,)) for n in xs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for n, outs in got.items():
        assert len(outs) == 25
        for out in outs:
            np.testing.assert_array_equal(out, want[n])


@pytest.mark.cuda
def test_swap_captures_beside_live_replays_on_card():
    """``update_model`` captures the incoming version's graphs on the
    swapping thread while the old version's replay on the workers: no
    client sees a failure, replies flip to the new logits, and the new
    model captures nothing once traffic flows."""
    _card()
    old = _card_model(0, torch.bfloat16)
    new_weights = BERTClassifier(2, use_flash=True, **CARD_CFG)
    new_weights.init_weights(torch.Generator().manual_seed(1))
    new_state = {k: t.detach().clone()
                 for k, t in new_weights.state_dict().items()}
    rows = _card_ids(4, 4)
    want = {0: old.predict(rows),
            1: InferenceModel(device="cuda", cuda_graphs=False).load(
                BERTClassifier(2, use_flash=True, **CARD_CFG), new_state,
                dtype=torch.bfloat16).predict(rows)}
    failures, seen = [], {0: 0, 1: 0}
    stop = threading.Event()

    def client(i):
        iq = InputQueue(srv.host, srv.port)
        oq = OutputQueue(input_queue=iq)
        try:
            while not stop.is_set():
                out = oq.query(iq.enqueue(f"c{i}", t=rows[i]), 60.0)
                hit = [s for s, w in want.items() if np.abs(
                    out - w[i]).max() <= 5e-2 * max(1.0, np.abs(w[i]).max())]
                if not hit:
                    failures.append(f"row {i}: {out}")
                for s in hit:
                    seen[s] += 1
        except Exception as e:  # noqa: BLE001 - recorded, asserted below
            failures.append(f"{type(e).__name__}: {e}")
        finally:
            iq.close()

    with ClusterServing(old, batch_size=4, inference_workers=2) as srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.5)
            new = InferenceModel(device="cuda").load(
                BERTClassifier(2, use_flash=True, **CARD_CFG), new_state,
                dtype=torch.bfloat16)
            srv.update_model(new)  # warm_from captures beside the replays
            after_warm = new.compile_count
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
    assert not failures, failures[:5]
    assert seen[0] > 0 and seen[1] > 0, seen
    assert new.compile_count == after_warm == len(old._compiled)
