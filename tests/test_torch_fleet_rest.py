"""The fleet's REST surface on a JAX and a port server side by side:
``GET|POST|DELETE /serve/<model>/replicas`` and ``GET /serve/fleet``
answer the same status codes and the same documents (timestamps,
latencies, device names and ``UNPORTED_KEYS`` aside), predictions routed
through replicas agree within the model-logits bar with weights carried
from the JAX params, and ``tests/test_fleet.py``'s REST drills (manual
scale, autoscale, dissolve, failed cutover, the default single path) run
on both.  Each server gets an injected 3-device pool (``tpu:k`` for the
JAX one, ``cuda:k`` for the port, neither resolving to a card here).  The
drill slows dispatch on each side through that server's own
``/faults/serve.apply`` route.
"""

import re
import threading
import time

import jax
import numpy as np
import pytest
import requests

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu.jobs.leases import DeviceLeaser as JaxLeaser
from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLP
from learningorchestra_tpu_torch import faults as port_faults
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import (
    Config,
    FleetConfig,
    ServeConfig,
    StoreConfig,
)
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.serve.batcher import BatcherClosed
from tests.torch_rest_pair import UNPORTED_KEYS

PREFIX = "/api/learningOrchestra/v1"
SIDES = ("jax", "port")
LOGIT_BAR = 1e-4
#: Keys whose values are clocks or measured latencies, not behaviour.
_TIMED = {"createdAt", "t", "latencyMs", "loadedAt"}
#: The autoscaler's counters of its own (timer-driven) ticks.
_TICKED = {"ticks", "ledger", "decisions", "streaks"}


def _norm(doc):
    """A document with timestamps, latencies and ``UNPORTED_KEYS`` left
    out and device names reduced to their index."""
    if isinstance(doc, dict):
        return {k: _norm(v) for k, v in doc.items()
                if k not in _TIMED | UNPORTED_KEYS}
    if isinstance(doc, list):
        return [_norm(v) for v in doc]
    if isinstance(doc, str):
        return re.sub(r"^(tpu|cuda):", "dev:", doc)
    return doc


def _fleet_doc(doc):
    doc = _norm(doc)
    doc["autoscaler"] = {k: v for k, v in doc["autoscaler"].items()
                         if k not in _TICKED}
    return doc


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_pair")
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp / "jax" / "store")
    jcfg.store.volume_root = str(tmp / "jax" / "volumes")
    jcfg.store.backend = "python"
    pcfg = Config(store=StoreConfig(root=str(tmp / "port" / "store"),
                                    volume_root=str(tmp / "port" / "volumes")),
                  serve=ServeConfig(), fleet=FleetConfig())
    for cfg in (jcfg, pcfg):
        cfg.serve.max_batch = 2
        cfg.serve.max_queue = 16
        cfg.serve.flush_ms = 1.0
        cfg.fleet.interval_s = 0.05
        cfg.fleet.up_queue_frac = 0.1
        cfg.fleet.up_ticks = 2
        cfg.fleet.down_ticks = 3
        cfg.fleet.lease_timeout_s = 1.0
    servers = {"jax": JaxServer(jcfg), "port": APIServer(pcfg, device="cpu")}
    # 3-device pools BEFORE any fleet op, the JAX test's seam.
    servers["jax"].ctx.leaser = JaxLeaser(["tpu:0", "tpu:1", "tpu:2"])
    servers["port"].ctx.leaser = DeviceLeaser(["cuda:0", "cuda:1", "cuda:2"])
    bases = {side: f"http://127.0.0.1:{srv.start_background()}{PREFIX}"
             for side, srv in servers.items()}
    yield servers, bases
    for srv in servers.values():
        srv.shutdown()


def _install(servers, name):
    """A finished train artifact on both servers: the JAX MLP fitted once,
    its params carried into the port's MLP."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    jest = JaxMLP(hidden_layer_sizes=[8], num_classes=2, seed=0)
    jest.compute_dtype = "float32"
    jest.fit(x, y, epochs=1, batch_size=32)
    jctx = servers["jax"].ctx
    jctx.volumes.save_object("train/tensorflow", name, jest)
    jctx.artifacts.metadata.create(name, "train/tensorflow")
    jctx.artifacts.metadata.mark_finished(name)
    pest = MLPClassifier(hidden_layer_sizes=[8], num_classes=2,
                         device="cpu")
    pest.load_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jest.params)})
    pest.compute_dtype = "float32"
    pctx = servers["port"].ctx
    pctx.volumes.save_estimator("train/pytorch", name, pest)
    pctx.artifacts.metadata.create(name, "train/pytorch")
    pctx.artifacts.metadata.mark_finished(name)
    return x


def _both(bases, verb, path, body=None):
    return {side: requests.request(verb, bases[side] + path, json=body,
                                   timeout=60) for side in SIDES}


def _free(servers):
    return {side: len(srv.ctx.leaser.snapshot()["free"])
            for side, srv in servers.items()}


def test_status_codes_without_a_set_and_on_bad_bodies(pair):
    servers, bases = pair
    _install(servers, "flt_bounds")
    cases = [("GET", "/serve/none_such/replicas", None, 404),
             ("POST", "/serve/ghost/replicas", {"count": 2}, 404),
             ("POST", "/serve/flt_bounds/replicas", {"min": 3, "max": 1},
              406),
             ("POST", "/serve/flt_bounds/replicas", {}, 406),
             ("POST", "/serve/flt_bounds/replicas", {"count": "two"}, 406),
             ("POST", "/serve/flt_bounds/replicas", {"count": 0}, 406),
             ("GET", "/serve/flt_bounds/replicas", None, 404)]
    for verb, path, body, want in cases:
        got = {side: r.status_code
               for side, r in _both(bases, verb, path, body).items()}
        assert got == {"jax": want, "port": want}, (verb, path, body, got)


def test_manual_scale_roundtrip_documents_and_predictions(pair):
    servers, bases = pair
    x = _install(servers, "flt_manual")
    # One single-path predict first: its counters carry into the fleet.
    for side, r in _both(bases, "POST", "/serve/flt_manual/predict",
                         {"instances": x[:1].tolist()}).items():
        assert r.status_code == 200 and "replica" not in r.json(), side
    # min = max = 2: the running autoscaler cannot move the set.
    made = _both(bases, "POST", "/serve/flt_manual/replicas",
                 {"min": 2, "max": 2})
    assert {s: r.status_code for s, r in made.items()} == {"jax": 200,
                                                          "port": 200}
    assert _norm(made["port"].json()) == _norm(made["jax"].json())
    assert made["port"].json()["size"] == 2
    assert _free(servers) == {"jax": 1, "port": 1}
    # Sequential predicts: the seeded router picks the same replicas, and
    # the replicas answer the JAX logits.
    answers = {side: [] for side in SIDES}
    for i in range(8):
        rows = x[3 * i:3 * i + 3].tolist()
        for side, r in _both(bases, "POST", "/serve/flt_manual/predict",
                             {"instances": rows}).items():
            assert r.status_code == 200, r.text
            answers[side].append(r.json())
    assert [a["replica"] for a in answers["port"]] == \
        [a["replica"] for a in answers["jax"]]
    assert {a["replica"] for a in answers["port"]} == {0, 1}
    assert all(a["device"].startswith("cuda:") for a in answers["port"])
    got = np.asarray([a["predictions"] for a in answers["port"]])
    ref = np.asarray([a["predictions"] for a in answers["jax"]])
    np.testing.assert_allclose(got, ref, atol=LOGIT_BAR, rtol=0)
    docs = _both(bases, "GET", "/serve/flt_manual/replicas")
    assert _norm(docs["port"].json()) == _norm(docs["jax"].json())
    # The batchers count chunks: 8 requests of 3 rows at max_batch 2.
    assert sum(r["requests"] for r in docs["port"].json()["replicas"]) == 16
    fleet = _both(bases, "GET", "/serve/fleet")
    assert _fleet_doc(fleet["port"].json()) == _fleet_doc(fleet["jax"].json())
    for side, srv in servers.items():
        stats = srv.serving.stats()["models"]["flt_manual"]
        assert stats["requests"] == 17, (side, stats)  # 1 single + 16
    listed = _both(bases, "GET", "/serve")
    for side, r in listed.items():
        entry = next(m for m in r.json()["models"]
                     if m["name"] == "flt_manual")
        assert len(entry["replicaDevices"]) == 2, side
    # While fleet-engaged the single-path batcher is not resurrected.
    with pytest.raises(BatcherClosed, match="fleet"):
        servers["port"].serving._batcher_for("flt_manual")
    down = _both(bases, "POST", "/serve/flt_manual/replicas",
                 {"min": 1, "max": 3, "count": 1})
    assert _norm(down["port"].json()) == _norm(down["jax"].json())
    assert down["port"].json()["size"] == 1
    _both(bases, "POST", "/serve/flt_manual/unload", {})
    for side, srv in servers.items():
        assert not srv.serving.fleet.engaged("flt_manual"), side
    assert _free(servers) == {"jax": 3, "port": 3}


def _drill(servers, bases, side, x):
    """min 1, max 3; a slowed dispatch and sustained REST load scale the
    model to >= 2; a fresh replica takes traffic; load stops, the fleet
    drains back to 1 and the leases return."""
    base = bases[side]
    resp = requests.post(f"{base}/serve/flt_drill/replicas",
                         json={"min": 1, "max": 3}, timeout=30)
    assert resp.status_code == 200 and resp.json()["size"] == 1, resp.text
    assert 3 - len(servers[side].ctx.leaser.snapshot()["free"]) == 1
    stop, errors = threading.Event(), []

    def load():
        while not stop.is_set():
            try:
                r = requests.post(f"{base}/serve/flt_drill/predict",
                                  json={"instances": x[:1].tolist()},
                                  timeout=30)
                if r.status_code not in (200, 429):
                    errors.append((r.status_code, r.text))
            except requests.RequestException as exc:
                errors.append(exc)

    threads = [threading.Thread(target=load, daemon=True)
               for _ in range(8)]
    try:
        for t in threads:
            t.start()
        deadline, size = time.monotonic() + 20, 1
        while size < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
            size = requests.get(f"{base}/serve/flt_drill/replicas",
                                timeout=30).json()["size"]
        assert size >= 2, f"{side}: never scaled up under load"
        deadline, fresh = time.monotonic() + 15, False
        while not fresh and time.monotonic() < deadline:
            time.sleep(0.1)
            status = requests.get(f"{base}/serve/flt_drill/replicas",
                                  timeout=30).json()
            fresh = any(r["requests"] > 0 for r in status["replicas"]
                        if r["replica"] != 0)
        assert fresh, f"{side}: no traffic reached the new replica"
    finally:
        stop.set()
        for t in threads:
            t.join(15)
    assert not errors, (side, errors[:3])


def _drained(servers, bases, side):
    base = bases[side]
    deadline, size = time.monotonic() + 25, 99
    while size > 1 and time.monotonic() < deadline:
        time.sleep(0.1)
        size = requests.get(f"{base}/serve/flt_drill/replicas",
                            timeout=30).json()["size"]
    assert size == 1, f"{side}: never scaled back down"
    assert len(servers[side].ctx.leaser.snapshot()["free"]) == 2
    fleet = requests.get(f"{base}/serve/fleet", timeout=30).json()
    directions = {(d["model"], d["to"] > d["from"])
                  for d in fleet["autoscaler"]["decisions"]}
    assert {("flt_drill", True), ("flt_drill", False)} <= directions, side
    requests.post(f"{base}/serve/flt_drill/unload", json={}, timeout=30)


def test_autoscale_drill_end_to_end(pair):
    servers, bases = pair
    x = _install(servers, "flt_drill")
    # Every coalesced dispatch sleeps 60 ms through each side's own fault
    # plane, armed over its REST surface.
    for side in SIDES:
        resp = requests.post(f"{bases[side]}/faults/serve.apply",
                             json={"mode": "delay", "delayMs": 60},
                             timeout=30)
        assert resp.status_code in (200, 201), (side, resp.text)
        try:
            _drill(servers, bases, side, x)
        finally:
            requests.delete(f"{bases[side]}/faults", timeout=30)
        _drained(servers, bases, side)
    assert port_faults.triggers("serve.apply") > 0


def test_dissolve_returns_model_to_single_path(pair):
    servers, bases = pair
    x = _install(servers, "flt_dissolve")
    before = _free(servers)
    made = _both(bases, "POST", "/serve/flt_dissolve/replicas",
                 {"min": 2, "max": 3})
    for side, r in made.items():
        assert r.status_code == 200 and r.json()["size"] == 2, side
    assert _free(servers) == {s: n - 2 for s, n in before.items()}
    gone = _both(bases, "DELETE", "/serve/flt_dissolve/replicas")
    assert {s: r.json() for s, r in gone.items()} == {
        s: {"model": "flt_dissolve", "dissolved": True} for s in SIDES}
    assert _free(servers) == before
    for side, r in _both(bases, "POST", "/serve/flt_dissolve/predict",
                         {"instances": x[:1].tolist()}).items():
        assert r.status_code == 200 and "replica" not in r.json(), side
    for side, r in _both(bases, "GET",
                         "/serve/flt_dissolve/replicas").items():
        assert r.status_code == 404, side
    again = _both(bases, "DELETE", "/serve/flt_dissolve/replicas")
    assert all(r.json()["dissolved"] is False for r in again.values())
    fleet = _both(bases, "GET", "/serve/fleet")
    assert _fleet_doc(fleet["port"].json())["bounds"] == \
        _fleet_doc(fleet["jax"].json())["bounds"]
    assert fleet["port"].json()["bounds"]["flt_dissolve"] == {
        "singlePath": True}


def test_failed_cutover_keeps_single_path_serving(pair):
    """A cutover that cannot place its first replica answers 503 with
    Retry-After and leaves the single-path batcher serving; once cards
    free up it completes and carries the counters."""
    servers, bases = pair
    x = _install(servers, "flt_degrade")
    for side, r in _both(bases, "POST", "/serve/flt_degrade/predict",
                         {"instances": x[:1].tolist()}).items():
        assert r.status_code == 200 and "replica" not in r.json(), side
    hogs = [srv.ctx.leaser.acquire(1, label=f"hog{i}", timeout=1)
            for srv in servers.values()
            for i in range(len(srv.ctx.leaser.snapshot()["free"]))]
    try:
        made = _both(bases, "POST", "/serve/flt_degrade/replicas",
                     {"min": 1, "max": 2})
        for side, r in made.items():
            assert r.status_code == 503, (side, r.text)
            assert r.headers["Retry-After"] == "1.0", side
            assert r.json()["retryAfter"] == 1.0, side
        for side, r in _both(bases, "POST", "/serve/flt_degrade/predict",
                             {"instances": x[:1].tolist()}).items():
            assert r.status_code == 200 and "replica" not in r.json(), side
    finally:
        for hog in hogs:
            hog.release()
    made = _both(bases, "POST", "/serve/flt_degrade/replicas", {"count": 1})
    for side, r in made.items():
        assert r.status_code == 200, (side, r.text)
    for side, srv in servers.items():
        stats = srv.serving.stats()["models"]["flt_degrade"]
        assert stats["requests"] == 2, (side, stats)
    _both(bases, "DELETE", "/serve/flt_degrade/replicas")


def test_single_replica_path_unchanged(pair):
    servers, bases = pair
    x = _install(servers, "flt_classic")
    answers = _both(bases, "POST", "/serve/flt_classic/predict",
                    {"instances": x[:2].tolist()})
    for side, r in answers.items():
        assert r.status_code == 200 and "replica" not in r.json(), side
    np.testing.assert_allclose(answers["port"].json()["predictions"],
                               answers["jax"].json()["predictions"],
                               atol=LOGIT_BAR, rtol=0)
    for side, r in _both(bases, "GET",
                         "/serve/flt_classic/replicas").items():
        assert r.status_code == 404, side
    assert _free(servers) == {"jax": 3, "port": 3}
