"""The port's metrics registry (obs/metrics.py) and job tracing
(obs/tracing.py) held against the JAX package's: the same sequence of
counter, gauge, histogram and collector operations renders the same
Prometheus text, snapshot and ``collect_all`` in both registries, the
series bound and the disabled render included; the same spans give the
same span tree and sampling decisions.  Over REST, a JAX and a port
server given the same train job under an ``X-Request-Id`` serve span
trees with the same span names and nesting, and every route of the
port's table is metered."""

import re

import numpy as np
import pytest
import requests

from learningorchestra_tpu.obs import metrics as jmetrics
from learningorchestra_tpu.obs import tracing as jtracing
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.api import server as api_server
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.obs import metrics, tracing
from tests.torch_rest_pair import server_pair

PREFIX = "/api/learningOrchestra/v1"


@pytest.fixture(autouse=True)
def _fresh_registries():
    metrics.reset_registry()
    jmetrics.reset_registry()
    yield
    faults.disarm_all()
    metrics.reset_registry()
    jmetrics.reset_registry()


def _drive(reg, mod):
    """One fixed sequence of push and pull operations."""
    c = reg.counter("demo_requests_total", "Requests.", labels=("route",
                                                                 "status"))
    g = reg.gauge("demo_depth", "Depth.", labels=("q",))
    h = reg.histogram("demo_latency_seconds", "Latency.", labels=("m",),
                      buckets=(0.01, 0.1, 1.0))
    plain = reg.histogram("demo_default_buckets", "Default edges.")
    for i in range(7):
        c.inc(route=f"GET /r{i % 3}", status="2xx")
    c.inc(2.5, route='we"ird\\path\n', status="5xx")
    g.set(3, q="a")
    g.set(-1.5, q="b")
    g.set_max(2, q="a")
    g.set_max(9, q="a")
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v, m="x")
    bound = h.bind(m="y")
    for v in (0.02, 2.0):
        bound.observe(v)
    for v in (0.0001, 0.003, 12.0, 1e6):
        plain.observe(v)
    reg.add_collector(lambda: [
        mod.Family("gauge", "demo_pulled", "Pulled.").sample(4, k="v")
        .sample(1e16).sample(float("inf"), k="inf"),
        mod.Family("counter", "demo_pulled_total").sample(12),
    ])

    def broken():
        raise RuntimeError("a bad collector drops its families only")

    reg.add_collector(broken)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_series=3),
    dict(enabled=False),
], ids=["default", "series_bound", "disabled"])
def test_same_operations_render_the_same_text(kw):
    ours = metrics.reset_registry(**kw)
    theirs = jmetrics.reset_registry(**kw)
    _drive(ours, metrics)
    _drive(theirs, jmetrics)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.snapshot() == theirs.snapshot()
    assert ours.collect_all() == theirs.collect_all()
    assert ours.collect_all(names={"demo_depth", "demo_pulled"}) == \
        theirs.collect_all(names={"demo_depth", "demo_pulled"})
    assert ours.series_overflows == theirs.series_overflows
    if kw.get("max_series"):
        assert ours.series_overflows > 0
        assert metrics.OVERFLOW_LABEL in ours.render_prometheus()


def test_registry_from_config_matches_jax_defaults():
    from learningorchestra_tpu.config import ObsConfig as JaxObs
    from learningorchestra_tpu_torch.config import ObsConfig

    assert vars(ObsConfig()) == vars(JaxObs())
    ours, theirs = metrics.reset_registry(), jmetrics.reset_registry()
    for attr in ("enabled", "trace_enabled", "max_series", "max_spans",
                 "trace_sample"):
        assert getattr(ours, attr) == getattr(theirs, attr)


def _spans(mod):
    trace = mod.JobTrace("job", "rid", max_spans=5)
    with mod.activate(trace):
        with mod.span("outer", a=1):
            with mod.span("inner"):
                mod.record_span("epoch", 0.01, epoch=0)
            mod.record_span("epoch", 0.02, epoch=1)
        with mod.span("second"):
            pass
        with mod.span("dropped"):  # past the 5-span cap
            pass
    return trace.to_doc()


def test_trace_docs_and_span_trees_match_jax():
    ours, theirs = _spans(tracing), _spans(jtracing)

    def shape(doc):
        return [(s["id"], s["parent"], s["name"], s["attrs"],
                 s["end"] is not None) for s in doc["spans"]]

    assert shape(ours) == shape(theirs)
    assert ours["droppedSpans"] == theirs["droppedSpans"] == 1
    assert set(ours) == set(theirs)

    def names(tree):
        return [(n["name"], names(n["children"])) for n in tree]

    assert names(tracing.span_tree(ours["spans"])) == \
        names(jtracing.span_tree(theirs["spans"]))
    # The same flat list gives the same tree in both packages.
    assert tracing.span_tree(theirs["spans"]) == \
        jtracing.span_tree(theirs["spans"])


def test_sampling_decisions_match_jax():
    ids = [f"req-{i}" for i in range(500)]
    for fraction in (0.0, 0.1, 0.5, 1.0):
        assert [tracing.sampled(i, fraction) for i in ids] == \
            [jtracing.sampled(i, fraction) for i in ids]
    assert tracing.get_request_id() is None
    token = tracing.set_request_id("abc")
    assert tracing.get_request_id() == "abc"
    tracing.reset_request_id(token)
    assert len(tracing.new_request_id()) == 16


def _tree_shape(tree):
    return [(n["name"], sorted(k for k in n["attrs"]
                               if k in ("attempt", "epoch")),
             _tree_shape(n["children"])) for n in tree]


def test_rest_train_job_span_tree_matches_jax(tmp_path):
    from learningorchestra_tpu.train import compile_cache as jcc
    from learningorchestra_tpu_torch.train import compile_cache as cc

    # Both program caches cold, as in a fresh process: a program an
    # earlier test built would be a hit, with no compile span.
    jcc.reset_cache()
    cc.reset_cache()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    trees = {}
    with server_pair(tmp_path) as (servers, clients):
        for side, srv in servers.items():
            base = (f"http://127.0.0.1:{srv._httpd.server_address[1]}"
                    f"{PREFIX}")
            rid = {"X-Request-Id": f"trace-{side}"}
            resp = requests.post(f"{base}/model/tensorflow", json={
                "modelName": "m",
                "modulePath": "learningorchestra_tpu.models.mlp",
                "class": "MLPClassifier",
                "classParameters": {"hidden_layer_sizes": [4],
                                    "num_classes": 2}}, headers=rid,
                timeout=60)
            assert resp.status_code == 201, resp.text
            assert resp.headers["X-Request-Id"] == f"trace-{side}"
            clients[side].observe.wait("m", 60)
            resp = requests.post(f"{base}/train/tensorflow", json={
                "name": "t", "modelName": "m", "method": "fit",
                "methodParameters": {"x": x.tolist(), "y": y.tolist(),
                                     "epochs": 2, "batch_size": 8}},
                headers=rid, timeout=60)
            assert resp.status_code == 201, resp.text
            clients[side].observe.wait("t", 120)
            doc = requests.get(f"{base}/observability/jobs/t/trace",
                               timeout=30).json()
            assert doc["requestId"] == f"trace-{side}"
            assert srv.ctx.artifacts.metadata.read("t")["requestId"] == \
                f"trace-{side}"
            trees[side] = _tree_shape(doc["tree"])
            # A minted id when the client sends none (or a bad one).
            resp = requests.get(f"{base}/health", timeout=30,
                                headers={"X-Request-Id": "bad id!"})
            assert re.fullmatch(r"[0-9a-f]{16}",
                                resp.headers["X-Request-Id"])
            assert requests.get(f"{base}/observability/jobs/m/trace",
                                timeout=30).status_code in (200, 404)
    assert trees["port"] == trees["jax"]
    names = [n[0] for n in trees["port"]]
    assert names == ["queue_wait", "job"]
    assert [n[0] for n in trees["port"][1][2]].count("epoch") == 2


def _synth(pattern: str, value: str) -> str:
    """A concrete path for a route pattern: named groups take ``value``
    (hook ids a number), alternations their first branch."""
    path = re.sub(r"\(\?P<hook>\[0-9\]\+\)", "1", pattern)
    path = re.sub(r"\(\?P<\w+>[^)]*\)", value, path)
    path = re.sub(r"\(\?:([^|)]*)[^)]*\)", r"\1", path)
    return path.replace("\\.", ".").replace("\\-", "-")


def test_every_route_in_the_table_is_metered(tmp_path):
    """With ``http.handler`` armed to fail, no handler runs: each route
    answers 500 and is counted under its own route label."""
    srv = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "store"),
        volume_root=str(tmp_path / "volumes"))), device="cpu")
    try:
        faults.arm("http.handler", "error")
        keys = []
        for verb, _rx, _handler, key in srv.router.routes:
            pattern = key.split(" ", 1)[1]
            for value in ("a1", "events", "webhook"):
                path = srv.router.prefix + _synth(pattern, value)
                if srv.router.resolve(verb, path)[2] == key:
                    break
            else:
                pytest.fail(f"no path reaches {key}")
            status, _ = srv.handle(verb, path, {}, {}, request_id="r1")
            assert status == 500, key
            keys.append(key)
        faults.disarm_all()
        assert srv.handle("GET", f"{PREFIX}/nowhere", {}, {})[0] == 404
        series = {
            (s["labels"]["route"], s["labels"]["status"]): s["value"]
            for s in srv.obs.snapshot()[api_server.HTTP_TOTAL]["series"]}
        for key in keys:
            assert series.get((key, "5xx"), 0) >= 1, key
        assert series[("404", "4xx")] == 1
        text = srv.obs.render_prometheus()
        assert api_server.HTTP_DURATION + "_bucket" in text
    finally:
        faults.disarm_all()
        srv.shutdown()


def test_metrics_prom_exposes_the_subsystem_families(tmp_path):
    srv = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "store"),
        volume_root=str(tmp_path / "volumes"))), device="cpu")
    try:
        status, (ctype, body) = srv.handle(
            "GET", f"{PREFIX}/metrics.prom", {}, {})
        assert status == 200 and ctype.startswith("text/plain")
        text = body.decode()
        types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
        # Every collector family the JAX server emits without a cluster,
        # replication or served model.
        from learningorchestra_tpu.api import server as jserver
        import inspect

        src = inspect.getsource(jserver.APIServer._collect_families)
        theirs = set(re.findall(r'"(lo_[a-z_]+)"', src))
        ha_only = {n for n in theirs if "replication" in n or "fenced" in n}
        model_only = {n for n in theirs if "replica" in n or "decode" in n
                      or "model_queue" in n or "scale_events" in n}
        assert theirs - ha_only - model_only <= set(types)
    finally:
        srv.shutdown()


def test_operations_plane_config_reads_the_jax_environment(monkeypatch):
    from learningorchestra_tpu.config import Config as JaxConfig

    env = {"LO_TPU_OBS_BUCKETS_MS": "1, 5,10", "LO_TPU_OBS_TRACE": "0",
           "LO_TPU_OBS_TRACE_SAMPLE": "0.5", "LO_TPU_ROLLUP_TICK_S": "0.5",
           "LO_TPU_ROLLUP_FAMILIES": "a, b", "LO_TPU_SLO_AVAILABILITY": "0.9",
           "LO_TPU_SLO_FAST_S": "3", "LO_TPU_SLO_WEBHOOK": " http://x ",
           "LO_TPU_FLIGHT_EVENTS": "64", "LO_TPU_BUNDLE_PROFILE": "1",
           "LO_TPU_BUNDLE_DEBOUNCE_S": "5", "LO_TPU_JOB_RETRIES": "5",
           "LO_TPU_JOB_BACKOFF_S": "0.2", "LO_TPU_JOB_BACKOFF_MAX_S": "2",
           "LO_TPU_FAULT_SERVE_APPLY": "delay:ms=5"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ours, theirs = Config.from_env(), JaxConfig.from_env()
    for section in ("obs", "rollup", "slo", "flight", "bundle", "faults"):
        assert vars(getattr(ours, section)) == \
            vars(getattr(theirs, section)), section
    for attr in ("max_preemption_retries", "retry_backoff_s",
                 "retry_backoff_max_s"):
        assert getattr(ours.jobs, attr) == getattr(theirs.jobs, attr)
    for key, value in (("LO_TPU_OBS_BUCKETS_MS", "5,1"),
                       ("LO_TPU_SLO_JOB_SUCCESS", "1"),
                       ("LO_TPU_OBS_TRACE_SAMPLE", "2")):
        monkeypatch.setenv(key, value)
        with pytest.raises(ValueError):
            Config.from_env()
        monkeypatch.delenv(key)
