"""The port's serving path on the CPU: REST front, ServingService,
MicroBatcher and ModelRegistry over an int8 BERT artifact.

Concurrent predicts coalesce into power-of-two buckets and each answer
equals the direct ``predict`` of the same artifact; the status codes are
the JAX server's (404, 406, 429 + Retry-After, 400).
"""

import http.client
import json
import threading

import numpy as np
import pytest

from learningorchestra_tpu_torch.api.server import PREFIX, APIServer
from learningorchestra_tpu_torch.config import Config, ServeConfig, StoreConfig
from learningorchestra_tpu_torch.models.text import BertModel
from learningorchestra_tpu_torch.serve.batcher import MicroBatcher, QueueFull
from learningorchestra_tpu_torch.serve.bucketing import bucket_for, pad_rows
from learningorchestra_tpu_torch.serve.service import (
    ARTIFACT_TYPE,
    ServingService,
)
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.train.neural import load_artifact

SMALL = dict(vocab_size=50, hidden_dim=32, num_layers=2, num_heads=2,
             max_len=12)


def _request(port, verb, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None
        )
        conn.request(verb, PREFIX + path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _store(tmp_path):
    """The store and volume roots of a test server, under ``tmp_path``
    (its ``volumes`` directory is where the test saves artifacts)."""
    return StoreConfig(root=str(tmp_path / "store"),
                       volume_root=str(tmp_path / "volumes"))


@pytest.fixture(scope="module")
def artifact():
    est = BertModel(**SMALL, seed=4, device="cpu")
    return est.to_artifact(quantize=True)


@pytest.fixture
def server(tmp_path, artifact):
    vols = VolumeStorage(tmp_path / "volumes")
    vols.save_object(ARTIFACT_TYPE, "bert", artifact)
    cfg = Config(store=_store(tmp_path),
                 serve=ServeConfig(max_batch=8, max_queue=64, flush_ms=150))
    api = APIServer(cfg, device="cpu")
    port = api.start_background()
    yield api, port
    api.shutdown()


def _instances(seed, rows):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, SMALL["vocab_size"], (rows, SMALL["max_len"]))
    for r in range(rows):
        x[r, rng.integers(1, SMALL["max_len"] + 1):] = 0  # pad tails
    return x


def test_concurrent_predicts_coalesce_and_match_direct(server, artifact):
    api, port = server
    assert _request(port, "POST", "/serve/bert/load")[0] == 200
    requests = [_instances(s, 1 + s % 3) for s in range(10)]
    requests[3][0] = 0  # an all-pad row
    results = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def fire(i):
        barrier.wait()
        results[i] = _request(
            port, "POST", "/serve/bert/predict",
            {"instances": requests[i].tolist()},
        )

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    direct = load_artifact(artifact, device="cpu")
    for x, (status, _, body) in zip(requests, results):
        assert status == 200, body
        preds = np.asarray(body["predictions"], np.float32)
        assert preds.shape == (len(x), 2)
        np.testing.assert_allclose(preds, direct.predict(x), atol=1e-5,
                                   rtol=1e-5)
    stats = _request(port, "GET", "/serve")[2]["stats"]["models"]["bert"]
    assert stats["requests"] == len(requests)
    assert stats["rows"] == sum(len(x) for x in requests)
    assert stats["batches"] < len(requests)  # coalesced
    assert set(stats["bucketHistogram"]) <= {"1", "2", "4", "8"}


def test_status_codes(server):
    api, port = server
    x = _instances(0, 2).tolist()
    assert _request(port, "POST", "/serve/nope/predict",
                    {"instances": x})[0] == 404
    assert _request(port, "GET", "/no/such/route")[0] == 404
    assert _request(port, "GET", "/serve/bert/predict")[0] == 405
    assert _request(port, "POST", "/serve/bert/predict", {})[0] == 406
    assert _request(port, "POST", "/serve/bert/predict",
                    {"instances": [[1, 2], [3]]})[0] == 406
    assert _request(port, "POST", "/serve/bert/predict",
                    {"instances": [[1, 2, SMALL["vocab_size"]]]})[0] == 406
    assert _request(port, "POST", "/serve/bert/predict",
                    raw=b"{not json")[0] == 400
    assert _request(port, "POST", "/serve/bert/predict",
                    {"x": x})[0] == 200


def test_backpressure_is_429_with_retry_after(tmp_path, artifact):
    vols = VolumeStorage(tmp_path / "volumes")
    vols.save_object(ARTIFACT_TYPE, "bert", artifact)
    # One 3-row chunk against a 2-row queue: refused before any dispatch.
    cfg = Config(store=_store(tmp_path),
                 serve=ServeConfig(max_batch=4, max_queue=2,
                                   retry_after_s=3.0))
    api = APIServer(cfg, device="cpu")
    port = api.start_background()
    try:
        status, headers, body = _request(
            port, "POST", "/serve/bert/predict",
            {"instances": _instances(1, 3).tolist()},
        )
    finally:
        api.shutdown()
    assert status == 429
    assert headers["Retry-After"] == "3.0"
    assert body["retryAfter"] == 3.0


def test_load_list_unload_lifecycle(server):
    api, port = server
    status, _, body = _request(port, "POST", "/serve/bert/load")
    assert status == 200 and body["result"]["name"] == "bert"
    assert body["result"]["paramBytes"] > 0
    assert body["result"]["device"] == "cpu"
    listed = _request(port, "GET", "/serve")[2]
    assert [m["name"] for m in listed["models"]] == ["bert"]
    assert listed["stats"]["registry"]["residentModels"] == 1
    assert _request(port, "POST", "/serve/bert/unload")[0] == 200
    assert _request(port, "POST", "/serve/bert/unload")[0] == 404
    assert _request(port, "DELETE", "/serve/bert")[0] == 404
    assert _request(port, "POST", "/serve/bert/load")[0] == 200
    assert _request(port, "DELETE", "/serve/bert")[0] == 200
    assert _request(port, "GET", "/serve")[2]["models"] == []
    assert _request(port, "POST", "/serve/missing/load")[0] == 404
    assert _request(port, "POST", "/serve/..bad/load")[0] == 406


def test_invalidated_model_serves_the_overwritten_artifact(tmp_path):
    vols = VolumeStorage(tmp_path)
    a = BertModel(**SMALL, seed=1, device="cpu")
    b = BertModel(**SMALL, seed=2, device="cpu")
    vols.save_object(ARTIFACT_TYPE, "m", a.to_artifact())
    svc = ServingService(vols, ServeConfig(flush_ms=0), device="cpu")
    x = _instances(3, 2)
    try:
        first = np.asarray(svc.predict("m", x)["predictions"])
        np.testing.assert_allclose(first, a.predict(x), atol=1e-6)
        vols.save_object(ARTIFACT_TYPE, "m", b.to_artifact())
        assert svc.registry.invalidate("m")
        second = np.asarray(svc.predict("m", x)["predictions"])
        np.testing.assert_allclose(second, b.predict(x), atol=1e-6)
        assert svc.registry.stats()["loads"] == 2
    finally:
        svc.close()


def test_registry_lru_evicts_by_count(tmp_path):
    vols = VolumeStorage(tmp_path)
    for i in range(3):
        vols.save_object(ARTIFACT_TYPE, f"m{i}", BertModel(
            **SMALL, seed=i, device="cpu").to_artifact())
    svc = ServingService(vols, ServeConfig(max_models=2), device="cpu")
    try:
        for i in range(3):
            svc.load(f"m{i}")
        assert [m["name"] for m in svc.list_loaded()] == ["m1", "m2"]
        assert svc.registry.stats()["evictions"] == 1
    finally:
        svc.close()


def test_batcher_keeps_row_shapes_apart():
    seen = []

    def dispatch(padded):
        seen.append(padded.shape)
        return padded.sum(axis=1, keepdims=True)

    batcher = MicroBatcher(dispatch, max_batch=8, flush_ms=100)
    out = {}
    try:
        def go(key, x):
            out[key] = batcher.submit(x)

        threads = [
            threading.Thread(target=go, args=("a", np.ones((2, 3)))),
            threading.Thread(target=go, args=("b", np.ones((3, 5)))),
            threading.Thread(target=go, args=("c", np.ones((1, 3)))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        batcher.close()
    np.testing.assert_array_equal(out["a"], [[3], [3]])
    np.testing.assert_array_equal(out["b"], [[5], [5], [5]])
    np.testing.assert_array_equal(out["c"], [[3]])
    assert all(shape[0] in (1, 2, 4, 8) for shape in seen)


def test_batcher_queue_cap_and_bucketing_helpers():
    batcher = MicroBatcher(lambda p: p, max_batch=8, max_queue=4)
    try:
        with pytest.raises(QueueFull):
            batcher.submit(np.ones((5, 1)))
        assert batcher.stats()["overflows"] == 1
    finally:
        batcher.close()
    assert [bucket_for(n, 6) for n in (1, 2, 3, 5, 6, 9)] == \
        [1, 2, 4, 6, 6, 6]
    padded = pad_rows(np.arange(6).reshape(2, 3), 4)
    np.testing.assert_array_equal(padded[2:], [[0, 1, 2], [0, 1, 2]])


def test_config_reads_the_jax_env_names():
    cfg = Config.from_env({
        "LO_TPU_SERVE_MAX_BATCH": "32", "LO_TPU_SERVE_MAX_QUEUE": "99",
        "LO_TPU_SERVE_FLUSH_MS": "2.5", "LO_TPU_SERVE_MAX_MODELS": "3",
        "LO_TPU_SERVE_MAX_BYTES": "1000", "LO_TPU_SERVE_RETRY_AFTER": "7",
        "LO_TPU_VOLUME_ROOT": "/v",
    })
    assert (cfg.serve.max_batch, cfg.serve.max_queue, cfg.serve.flush_ms,
            cfg.serve.max_models, cfg.serve.max_bytes,
            cfg.serve.retry_after_s) == (32, 99, 2.5, 3, 1000, 7.0)
    assert cfg.store.volume_root == "/v"
    default = Config.from_env({})
    assert default.serve == ServeConfig()
    assert (default.serve.max_batch, default.serve.flush_ms) == (64, 5.0)
