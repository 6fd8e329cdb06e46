"""The port's on-demand profiler (obs/profiling.py) over REST, held against
the JAX server on the same drive (``tests/test_costs.py``'s
``TestProfileRest``): a start/stop round trip with a non-empty capture
listed and fetched through ``?file=``, path traversal rejected, a double
start and an idle stop answering 409, the capture dir bounded by
``max_captures``, the auto-stop timer, DELETE, a bad name and an unknown
capture; both servers answer the same status codes and document keys.
Then the port's own trace: a ``.pt.trace.json`` holding the operators
of a forward run on another thread, a start while another
``torch.profiler`` is active answering 409 (never a 500, never wedging
the surface), and a monitored job's trace skipped while a capture runs.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import (
    Config,
    ProfilingConfig,
    StoreConfig,
)

PREFIX = "/api/learningOrchestra/v1"


def _call(base, verb, path, body=None, raw=False):
    req = urllib.request.Request(
        base + path, method=verb,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            data = resp.read()
            return resp.status, data if raw else json.loads(data)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _jax_work():
    import jax
    import jax.numpy as jnp

    jax.jit(lambda a: (a @ a.T).sum())(jnp.ones((64, 64))).block_until_ready()


def _torch_work():
    """A forward on another thread: the capture must record it."""
    def forward():
        layer = torch.nn.Linear(64, 64)
        with torch.inference_mode():
            layer(torch.ones(8, 64)).sum()

    th = threading.Thread(target=forward)
    th.start()
    th.join()


def _keys(doc):
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


def _drive(base, work) -> list:
    """The REST drive; -> [(step, status, document keys)]."""
    log = []

    def step(name, verb, path, body=None):
        status, doc = _call(base, verb, path, body)
        log.append((name, status, _keys(doc)))
        return status, doc

    status, doc = step("start", "POST", "/observability/profile/start",
                       {"name": "drill", "maxSeconds": 30})
    log.append(("start.capture", status, _keys(doc.get("capture"))))
    status, doc = step("status", "GET", "/observability/profile")
    assert doc["active"]["name"] == "drill"
    work()
    status, doc = step("stop", "POST", "/observability/profile/stop", {})
    manifest = doc["capture"]
    log.append(("stop.capture", status, _keys(manifest)))
    assert manifest["files"] and manifest["totalBytes"] > 0
    status, doc = step("list", "GET", "/observability/profile/captures")
    drill = next(c for c in doc["captures"] if c["name"] == "drill")
    log.append(("list.capture", status, _keys(drill)))
    assert drill["totalBytes"] > 0 and not drill["active"]
    step("one", "GET", "/observability/profile/captures/drill")
    path = drill["files"][0]["path"]
    status, blob = _call(base, "GET", "/observability/profile/captures/"
                         f"drill?file={path}", raw=True)
    log.append(("file", status, len(blob) == drill["files"][0]["bytes"]))
    step("traversal", "GET", "/observability/profile/captures/drill"
         "?file=../../etc/passwd")
    step("missing file", "GET", "/observability/profile/captures/drill"
         "?file=nope.bin")
    step("unknown capture", "GET", "/observability/profile/captures/nope")
    step("bad name", "POST", "/observability/profile/start",
         {"name": "../escape"})
    step("bad seconds", "POST", "/observability/profile/start",
         {"maxSeconds": -1})
    step("first", "POST", "/observability/profile/start", {"name": "first"})
    step("double start", "POST", "/observability/profile/start",
         {"name": "second"})
    step("delete active", "DELETE", "/observability/profile/captures/first")
    step("stop first", "POST", "/observability/profile/stop", {})
    step("idle stop", "POST", "/observability/profile/stop", {})
    for i in range(5):  # max_captures = 3
        step(f"bound start {i}", "POST", "/observability/profile/start",
             {"name": f"bound-{i}"})
        step(f"bound stop {i}", "POST", "/observability/profile/stop", {})
    _, doc = _call(base, "GET", "/observability/profile/captures")
    names = [c["name"] for c in doc["captures"]]
    log.append(("bounded", len(names) <= 3 and "bound-4" in names, None))
    step("auto", "POST", "/observability/profile/start",
         {"name": "auto", "maxSeconds": 0.5})
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline:
        _, doc = _call(base, "GET", "/observability/profile")
        if doc["active"] is None and doc["autoStops"]:
            break
        time.sleep(0.05)
    log.append(("auto-stopped", doc["active"] is None,
                doc["autoStops"]))
    step("delete", "DELETE", "/observability/profile/captures/bound-4")
    step("delete again", "DELETE", "/observability/profile/captures/bound-4")
    return log


@pytest.fixture
def servers(tmp_path):
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp_path / "jax" / "store")
    jcfg.store.volume_root = str(tmp_path / "jax" / "volumes")
    jcfg.store.backend = "python"
    jcfg.profiling.max_captures = 3
    port = APIServer(Config(
        store=StoreConfig(root=str(tmp_path / "port" / "store"),
                          volume_root=str(tmp_path / "port" / "volumes")),
        profiling=ProfilingConfig(max_captures=3)), device="cpu")
    jax_server = JaxServer(jcfg)
    bases = {}
    try:
        for side, srv in (("jax", jax_server), ("port", port)):
            bases[side] = (f"http://127.0.0.1:{srv.start_background()}"
                           f"{PREFIX}")
        yield bases, port
    finally:
        for srv in (jax_server, port):
            srv.shutdown()


def test_profile_routes_answer_as_the_jax_server(servers):
    bases, _ = servers
    ref = _drive(bases["jax"], _jax_work)
    got = _drive(bases["port"], _torch_work)
    assert got == ref
    steps = dict((name, status) for name, status, _ in got)
    assert (steps["start"], steps["stop"], steps["file"],
            steps["traversal"], steps["missing file"],
            steps["unknown capture"], steps["bad name"],
            steps["double start"], steps["idle stop"], steps["delete"],
            steps["delete again"]) == (201, 200, 200, 406, 404, 404, 406,
                                       409, 409, 200, 404)
    assert steps["bounded"] is True and steps["auto-stopped"] is True


def test_capture_holds_a_chrome_trace_of_another_thread(servers):
    bases, port = servers
    base = bases["port"]
    assert _call(base, "POST", "/observability/profile/start",
                 {"name": "threads"})[0] == 201
    _torch_work()
    status, doc = _call(base, "POST", "/observability/profile/stop", {})
    assert status == 200
    (trace,) = [f["path"] for f in doc["capture"]["files"]]
    assert trace.endswith(".pt.trace.json")
    assert trace.startswith("plugins/profile/")
    status, blob = _call(base, "GET", "/observability/profile/captures/"
                         f"threads?file={trace}", raw=True)
    events = json.loads(blob)["traceEvents"]
    ops = [e for e in events if e.get("name") in ("aten::linear",
                                                   "aten::addmm")]
    assert ops, "no operator of the other thread's forward"
    main = threading.get_native_id()
    assert all(e.get("tid") != main for e in ops)


def test_another_active_profiler_answers_409_and_never_wedges(
        servers, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from learningorchestra_tpu_torch.services.monitoring import profiled

    bases, port = servers
    base = bases["port"]
    with profile(activities=[ProfilerActivity.CPU]):
        status, doc = _call(base, "POST", "/observability/profile/start",
                            {"name": "clash"})
        assert status == 409 and "another torch.profiler" in doc["error"]
        assert _call(base, "GET", "/observability/profile")[1][
            "active"] is None
    # The surface works once the other profiler ends; a monitored job's
    # trace is skipped (not started over the capture) meanwhile.
    assert _call(base, "POST", "/observability/profile/start",
                 {"name": "after"})[0] == 201
    with profiled(str(tmp_path / "monitored")):
        np.ones(4).sum()
    assert not (tmp_path / "monitored").exists()
    status, doc = _call(base, "POST", "/observability/profile/stop", {})
    assert status == 200 and doc["capture"]["totalBytes"] > 0
    with profiled(str(tmp_path / "monitored")):
        torch.ones(4).sum()
    assert list((tmp_path / "monitored").rglob("*.pt.trace.json"))


def test_every_start_warms_the_tracer_before_its_window(
        tmp_path, monkeypatch):
    """A capture enables the tracer, runs the warm-up, then opens its
    window; a warm-up that raises leaves no profiler running and the
    surface free for the next start."""
    from learningorchestra_tpu_torch.obs import profiling

    order = []
    real_prepare = torch.profiler.profile.prepare_trace
    real_start = torch.profiler.profile.start_trace
    monkeypatch.setattr(
        torch.profiler.profile, "prepare_trace",
        lambda self: (order.append("prepare"), real_prepare(self))[1])
    monkeypatch.setattr(
        torch.profiler.profile, "start_trace",
        lambda self: (order.append("start"), real_start(self))[1])
    monkeypatch.setattr(profiling, "_warm_devices",
                        lambda: order.append("warm"))
    service = profiling.ProfilerService(str(tmp_path), max_seconds=30)
    service.start("warmed")
    assert order == ["prepare", "warm", "start"]
    assert profiling.profiler_active()
    _torch_work()
    manifest = service.stop()
    assert manifest["totalBytes"] > 0 and not profiling.profiler_active()

    def broken():
        raise RuntimeError("warm-up failed")

    monkeypatch.setattr(profiling, "_warm_devices", broken)
    with pytest.raises(profiling.ProfilerConflict):
        service.start("broken")
    assert not profiling.profiler_active()
    assert service.status()["active"] is None
    monkeypatch.setattr(profiling, "_warm_devices", lambda: None)
    service.start("after")
    service.stop()
    assert not profiling.profiler_active()
