"""The port's gateway (``learningorchestra_tpu_torch/api/server.py``)
against the JAX server's on the same requests, side by side
(``tests/test_api.py`` and ``tests/test_idempotency.py``): status codes
and payload keys must be equal.

- ``GET /metrics``: the per-route JSON and the budget;
- the request budget (504), the response cache of an opted-in GET and
  its invalidation by any other verb, the long poll's exemption;
- saturation: at ``max_inflight`` the next request answers 503 at once,
  and an abandoned handler keeps its slot until it returns;
- ``GET /status``: the HTML page;
- the idempotency ledger: a keyed POST replays its answer, a keyed PATCH
  re-runs its job once, unkeyed mutations and GETs are untouched, an
  attempt with no recorded outcome answers 409, a key reused on another
  request (query included) answers 422, expired records are swept, and
  the ledger's ``_id`` and fingerprint are the JAX server's;
- a request on a kept-alive connection after shutdown answers 503, and a
  bad ``X-Tenant`` header 400.

The port side is driven with the port's own ``client.py`` where a client
call exists.
"""

import contextlib
import http.client
import json
import socket
import threading
import time
import uuid

import pytest

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.client import Context
from learningorchestra_tpu_torch.config import Config, StoreConfig

PREFIX = "/api/learningOrchestra/v1"


@contextlib.contextmanager
def pair(tmp, **api):
    """{"jax": server, "port": server} with ``api`` set on both configs."""
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp / "jax" / "store")
    jcfg.store.volume_root = str(tmp / "jax" / "volumes")
    jcfg.store.backend = "python"
    pcfg = Config(store=StoreConfig(root=str(tmp / "port" / "store"),
                                    volume_root=str(tmp / "port" / "volumes")))
    for cfg in (jcfg, pcfg):
        for key, value in api.items():
            setattr(cfg.api, key, value)
    servers = {"jax": JaxServer(jcfg), "port": APIServer(pcfg, device="cpu")}
    try:
        yield servers
    finally:
        for srv in servers.values():
            srv.shutdown()


def call(port, verb, path, body=None, headers=None, conn=None):
    """-> (status, payload (JSON, else text), response headers)."""
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(verb, PREFIX + path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = raw.decode(errors="replace")
        return resp.status, payload, dict(resp.getheaders())
    finally:
        if own:
            conn.close()


def keys(payload):
    return sorted(payload) if isinstance(payload, dict) else type(payload)


def poll(port, path, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, docs, _ = call(port, "GET", path)
        meta = docs[0] if isinstance(docs, list) and docs else {}
        if meta.get("finished"):
            return meta
        time.sleep(0.05)
    raise AssertionError(f"timeout polling {path}")


def idle(server, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not server.ctx.engine.running_jobs() and not any(
                server.ctx.engine.queue_depths().values()):
            return
        time.sleep(0.05)


# -- the budget, the cache, the caps ------------------------------------------


def test_metrics_endpoint_matches_jax(tmp_path):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            call(port, "GET", "/health")
            call(port, "POST", "/function/python",
                 {"name": "m1", "function": "response = 1"})
            status, metrics, _ = call(port, "GET", "/metrics")
            got[side] = (status, metrics)
        assert got["port"][0] == got["jax"][0] == 200
        for side in ("jax", "port"):
            metrics = got[side][1]
            assert metrics["budget"]["request_timeout_s"] > 0
            routes = metrics["routes"]
            assert routes["GET /health"]["count"] >= 1
            assert routes["GET /health"]["avg_ms"] >= 0
            assert "POST /function/python" in routes
        assert keys(got["port"][1]) == keys(got["jax"][1])
        assert keys(got["port"][1]["budget"]) == keys(got["jax"][1]["budget"])
        assert keys(got["port"][1]["routes"]["GET /health"]) == keys(
            got["jax"][1]["routes"]["GET /health"])
        # The port's client reads the same view.
        port = servers["port"]._httpd.server_address[1]
        assert "routes" in Context(f"http://127.0.0.1:{port}").request(
            "GET", "/metrics")


def test_gateway_timeout_and_response_cache_match_jax(tmp_path):
    with pair(tmp_path, request_timeout_s=0.3, cache_ttl_s=300.0) as servers:
        seen = {}
        for side, srv in servers.items():
            srv.router.add("GET", "/slowroute",
                           lambda m, b, q: (time.sleep(1.0), (200, {}))[1])
            calls = {"n": 0}

            def counted(m, b, q, calls=calls):
                calls["n"] += 1
                return 200, {"n": calls["n"]}

            srv.router.add("GET", "/cachedroute", counted, cacheable=True)
            slow = srv.handle("GET", PREFIX + "/slowroute", {}, {})
            first = srv.handle("GET", PREFIX + "/cachedroute", {}, {})
            second = srv.handle("GET", PREFIX + "/cachedroute", {}, {})
            srv.handle("DELETE", PREFIX + "/dataset/csv/nothing", {}, {})
            third = srv.handle("GET", PREFIX + "/cachedroute", {}, {})
            seen[side] = (slow, first, second, third, calls["n"])
        for side in ("jax", "port"):
            slow, first, second, third, n = seen[side]
            assert slow[0] == 504 and "budget" in slow[1]["error"]
            assert first == second == (200, {"n": 1})
            assert third == (200, {"n": 2}) and n == 2
        assert seen["port"][0][1] == seen["jax"][0][1]
        # The long poll and /generate are exempt from the budget; the
        # registry listing is the one GET the JAX server caches.
        port = servers["port"].router
        assert port.flags["GET /observe/(?P<name>[A-Za-z0-9_.\\-]+)"][
            "no_timeout"]
        assert port.flags["POST /serve/(?P<name>[A-Za-z0-9_.\\-]+)/generate"][
            "no_timeout"]
        assert [k for k, f in port.flags.items() if f["cacheable"]] == [
            "GET /registry", "GET /cachedroute"]
        # By design, unlike the JAX server: a capture's start and stop
        # (CUPTI's initialization, the trace's write) run unbudgeted.
        assert sorted(k for k, f in port.flags.items() if f["no_timeout"]
                      and "profile" in k) == [
            "POST /observability/profile/start",
            "POST /observability/profile/stop"]
        jax = servers["jax"].router
        assert [k for *_, k, f in jax.routes if f["cacheable"]] == [
            "GET /registry", "GET /cachedroute"]


def test_gateway_saturation_sheds_load_as_jax(tmp_path):
    with pair(tmp_path, request_timeout_s=0.2, max_inflight=2) as servers:
        gates = []
        try:
            for side, srv in servers.items():
                gate = threading.Event()
                gates.append(gate)
                srv.router.add("GET", "/stuckroute",
                               lambda m, b, q, g=gate: (g.wait(10),
                                                        (200, {}))[1])
                results = []

                def one(srv=srv, results=results):
                    results.append(srv.handle("GET", PREFIX + "/stuckroute",
                                              {}, {}))

                threads = [threading.Thread(target=one) for _ in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(5)
                assert [s for s, _ in results] == [504, 504], side
                # The abandoned handlers still hold both slots.
                status, payload = srv.handle("GET", PREFIX + "/stuckroute",
                                             {}, {})
                assert status == 503 and "saturated" in payload["error"]
                assert srv._metrics["saturated"]["errors"] >= 1
                gate.set()
                deadline = time.time() + 5
                while time.time() < deadline:
                    if srv.handle("GET", PREFIX + "/health", {}, {})[0] == 200:
                        break
                    time.sleep(0.05)
                else:
                    raise AssertionError(f"{side}: slots never freed")
        finally:
            for gate in gates:
                gate.set()


def test_status_page_renders_like_jax(tmp_path):
    with pair(tmp_path) as servers:
        pages = {}
        for side, srv in servers.items():
            port = srv.start_background()
            call(port, "POST", "/function/python",
                 {"name": "status_boom", "function": "raise ValueError('x')"})
            deadline = time.time() + 30
            while time.time() < deadline:
                _, docs, _ = call(port, "GET", "/function/python/status_boom")
                if docs and docs[0].get("jobState") == "failed":
                    break
                time.sleep(0.1)
            pages[side] = call(port, "GET", "/status")
        for side in ("jax", "port"):
            status, page, headers = pages[side]
            assert status == 200
            assert headers["Content-Type"].startswith("text/html")
            for fragment in ("Agents", "in-process mode", "Device leases",
                             "Jobs", "Recent events", "status_boom",
                             "failed"):
                assert fragment in page, (side, fragment)
        assert "<h1>learningorchestra_tpu_torch</h1>" in pages["port"][1]


def test_draining_connection_and_bad_tenant_match_jax(tmp_path):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            bad = call(port, "GET", "/health", headers={"X-Tenant": "a b!"})
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            first = call(port, "GET", "/health", conn=conn)
            srv._shutting_down.set()
            drained = call(port, "GET", "/health", conn=conn)
            conn.close()
            got[side] = (bad[:2], first[0], drained[:2])
        assert got["port"] == got["jax"]
        assert got["port"][0][0] == 400 and got["port"][2][0] == 503


# -- the idempotency ledger ---------------------------------------------------


def test_post_retry_replays_not_conflicts(tmp_path):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            key = uuid.uuid4().hex
            body = {"name": "once", "function": "response = 1"}
            r1 = call(port, "POST", "/function/python", body,
                      {"X-Idempotency-Key": key})
            poll(port, "/function/python/once")
            r2 = call(port, "POST", "/function/python", body,
                      {"X-Idempotency-Key": key})
            r3 = call(port, "POST", "/function/python", body,
                      {"X-Idempotency-Key": uuid.uuid4().hex})
            assert r2[1] == r1[1], side
            got[side] = (r1[0], r2[0], r3[0], keys(r1[1]))
        assert got["port"] == got["jax"] == (201, 201, 409, got["jax"][3])


def test_patch_rerun_executes_exactly_once(tmp_path):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            marker = tmp_path / f"runs_{side}.txt"
            code = f"open({str(marker)!r}, 'a').write('x')\nresponse = 1"
            call(port, "POST", "/function/python",
                 {"name": "fx", "function": code},
                 {"X-Idempotency-Key": uuid.uuid4().hex})
            poll(port, "/function/python/fx")
            key = uuid.uuid4().hex
            p1 = call(port, "PATCH", "/function/python/fx",
                      {"function": code}, {"X-Idempotency-Key": key})
            poll(port, "/function/python/fx")
            after_first = marker.read_text()
            p2 = call(port, "PATCH", "/function/python/fx",
                      {"function": code}, {"X-Idempotency-Key": key})
            idle(srv)
            assert p2[1] == p1[1], side
            got[side] = (p1[0], p2[0], after_first, marker.read_text())
        assert got["port"] == got["jax"]
        assert got["port"][2:] == ("xx", "xx")


def test_unkeyed_mutations_and_keyed_gets_are_untouched(tmp_path):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            body = {"name": "plain", "function": "response = 1"}
            statuses = [call(port, "POST", "/function/python", body)[0]
                        for _ in range(2)]
            key = uuid.uuid4().hex
            statuses += [call(port, "GET", "/health",
                              headers={"X-Idempotency-Key": key})[0]
                         for _ in range(2)]
            got[side] = (statuses, srv.ctx.documents.collection_exists(
                srv.IDEM_COLLECTION))
        assert got["port"] == got["jax"] == ([201, 409, 200, 200], False)


def test_begun_without_outcome_is_explicit_409(tmp_path):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            key = uuid.uuid4().hex
            body = {"name": "ghost", "function": "response = 1"}
            srv.ctx.documents.insert_unique(
                srv.IDEM_COLLECTION,
                {"key": key, "fp": srv._idem_fingerprint(
                    "POST", f"{PREFIX}/function/python", body),
                 "state": "begun", "at": time.time()},
                srv._idem_id(key))
            status, payload, _ = call(port, "POST", "/function/python",
                                      body, {"X-Idempotency-Key": key})
            assert "no recorded outcome" in payload["error"], side
            got[side] = (status, keys(payload),
                         call(port, "GET", "/function/python/ghost")[0])
        assert got["port"] == got["jax"]
        assert got["port"][0] == 409 and got["port"][2] == 404


@pytest.mark.parametrize("reuse", ["query", "body"])
def test_key_reuse_on_another_request_is_422(tmp_path, reuse):
    with pair(tmp_path) as servers:
        got = {}
        for side, srv in servers.items():
            port = srv.start_background()
            key = uuid.uuid4().hex
            first = {"name": "op_a", "function": "response = 1"}
            r1 = call(port, "POST", "/function/python", first,
                      {"X-Idempotency-Key": key})
            if reuse == "query":
                r2 = call(port, "POST", "/function/python?force=1", first,
                          {"X-Idempotency-Key": key})
            else:
                r2 = call(port, "POST", "/function/python",
                          {"name": "op_b", "function": "response = 2"},
                          {"X-Idempotency-Key": key})
            assert "different request" in r2[1]["error"], side
            got[side] = (r1[0], r2[0], keys(r2[1]),
                         call(port, "GET", "/function/python/op_b")[0])
        assert got["port"] == got["jax"]
        assert got["port"][:2] == (201, 422)


def test_expired_records_are_swept_and_ids_match_jax(tmp_path):
    with pair(tmp_path) as servers:
        jax, port = servers["jax"], servers["port"]
        for key in ("k", uuid.uuid4().hex, "ключ"):
            assert port._idem_id(key) == jax._idem_id(key)
        for args in (("POST", "/p", {"a": [1, 2]}, {"q": "1"}),
                     ("PATCH", "/p/x", {}, None)):
            assert port._idem_fingerprint(*args) == \
                jax._idem_fingerprint(*args)
        for srv in (jax, port):
            docs = srv.ctx.documents
            stale = docs.insert_one(srv.IDEM_COLLECTION, {
                "key": "old", "state": "done", "status": 201,
                "payload": {}, "at": time.time() - 2 * srv.IDEM_TTL_S})
            fresh = docs.insert_one(srv.IDEM_COLLECTION, {
                "key": "new", "state": "done", "status": 201,
                "payload": {}, "at": time.time()})
            srv._idem_sweep()
            assert docs.find_one(srv.IDEM_COLLECTION, stale) is None
            assert docs.find_one(srv.IDEM_COLLECTION, fresh) is not None
        assert (port.IDEM_COLLECTION, port.IDEM_TTL_S,
                port.IDEM_SWEEP_EVERY) == (jax.IDEM_COLLECTION,
                                           jax.IDEM_TTL_S,
                                           jax.IDEM_SWEEP_EVERY)


def test_an_interrupt_while_a_connection_thread_starts_stops_the_loop(
        monkeypatch):
    """SIGINT landing in the accept loop while it waits for a connection's
    thread to start must reach ``serve_forever``'s caller: the started
    thread frees its connection slot once, and the interrupt is not
    swallowed by a double release."""
    from learningorchestra_tpu_torch.api.server import (
        _BoundedThreadingHTTPServer,
    )

    done = threading.Event()

    class Handler:
        def __init__(self, *args):
            done.set()

    srv = _BoundedThreadingHTTPServer(("127.0.0.1", 0), Handler,
                                      max_connections=1)
    real_start = threading.Thread.start

    def start_then_interrupt(thread):
        # The interrupt lands after the connection's thread has run and
        # freed its slot (the order that used to lose it).
        real_start(thread)
        thread.join(10)
        raise KeyboardInterrupt

    ours, theirs = socket.socketpair()
    monkeypatch.setattr(threading.Thread, "start", start_then_interrupt)
    try:
        with pytest.raises(KeyboardInterrupt):
            srv.process_request(ours, ("127.0.0.1", 1))
    finally:
        monkeypatch.undo()
        theirs.close()
    assert done.wait(10)
    # The thread's release is the only one: the slot frees exactly once.
    deadline = time.time() + 10
    while not srv._conn_slots.acquire(blocking=False):
        assert time.time() < deadline, "the connection slot never freed"
        time.sleep(0.01)
    assert not srv._conn_slots.acquire(blocking=False)
    srv.server_close()
