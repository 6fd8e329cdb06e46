"""The port's windowed rollups (obs/rollup.py) and SLO alerting
(obs/slo.py) held against the JAX package's: the same registry
operations snapshotted at the same injected clock give the same counter
rates, gauge min/avg/max, histogram quantiles (1e-12), ``fraction_below``
counts and least-squares slope, the same timeseries documents, and the
SLO service takes the same alert transitions with the same burn rates.
The fleet autoscaler, with ``FleetConfig.up_slope > 0`` (refused at boot
until the rollup was ported), makes the same decisions as the JAX one on
the same queue series."""

import time

import pytest

from learningorchestra_tpu.config import FleetConfig as JaxFleetConfig
from learningorchestra_tpu.config import RollupConfig as JaxRollupConfig
from learningorchestra_tpu.config import SLOConfig as JaxSLOConfig
from learningorchestra_tpu.obs import metrics as jmetrics
from learningorchestra_tpu.obs import rollup as jrollup
from learningorchestra_tpu.obs import slo as jslo
from learningorchestra_tpu.serve.fleet.autoscaler import (
    Autoscaler as JaxAutoscaler,
)
from learningorchestra_tpu_torch.api.server import HTTP_TOTAL
from learningorchestra_tpu_torch.config import (
    FleetConfig,
    RollupConfig,
    SLOConfig,
)
from learningorchestra_tpu_torch.jobs.engine import JOBS_TOTAL
from learningorchestra_tpu_torch.obs import metrics, rollup, slo
from learningorchestra_tpu_torch.serve.fleet.autoscaler import Autoscaler
from learningorchestra_tpu_torch.serve.service import PREDICT_DURATION

SIDES = {
    "port": (metrics, rollup, slo, RollupConfig, SLOConfig, FleetConfig,
             Autoscaler),
    "jax": (jmetrics, jrollup, jslo, JaxRollupConfig, JaxSLOConfig,
            JaxFleetConfig, JaxAutoscaler),
}
QUEUE_DEPTH = next(f for f in rollup.CORE_FAMILIES
                   if f.endswith("_model_queue_depth"))
#: Keys stamped from the wall clock (not compared).
WALL = {"t", "evaluatedAt", "pendingSinceWall", "firingSinceWall",
        "resolvedAtWall"}


@pytest.fixture(autouse=True)
def _fresh_planes():
    for mod_metrics, mod_rollup, mod_slo, *_ in SIDES.values():
        mod_metrics.reset_registry()
    yield
    for mod_metrics, mod_rollup, mod_slo, *_ in SIDES.values():
        mod_rollup.reset_engine()
        mod_slo.reset_service()
        mod_metrics.reset_registry()


def test_configs_match_jax_defaults():
    assert vars(RollupConfig()) == vars(JaxRollupConfig())
    assert vars(SLOConfig()) == vars(JaxSLOConfig())
    assert rollup.CORE_FAMILIES == jrollup.CORE_FAMILIES


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _scenario(side):
    """One scripted 24-tick schedule: HTTP traffic with a 5xx burst,
    predict latencies that breach the latency objective, a ramping queue
    gauge, job outcomes; every view read after every tick."""
    mod_metrics, mod_rollup, mod_slo, rcfg, scfg, *_ = SIDES[side]
    engine = mod_rollup.reset_engine(rcfg(tick_s=0.0, points=8,
                                          max_series=64))
    service = mod_slo.reset_service(scfg(
        for_s=2.0, resolve_s=3.0, fast_window_s=4.0, slow_window_s=8.0,
        burn_threshold=5.0, predict_p99_ms=100.0))
    events = []
    service.add_sink(events.append)
    reg = mod_metrics.get_registry()
    http = reg.counter(HTTP_TOTAL, "t", labels=("route", "status"))
    pred = reg.histogram(PREDICT_DURATION, "t", labels=("model",))
    depth = reg.gauge(QUEUE_DEPTH, "t", labels=("model",))
    jobs = reg.counter(JOBS_TOTAL, "t", labels=("job_class", "state"))
    views = []
    for i in range(24):
        now = 100.0 + i
        http.inc(20 + i, route="GET /x", status="2xx")
        if 3 <= i <= 6:
            http.inc(15, route="POST /y", status="5xx")
        for k in range(10):
            slow = 4 <= i <= 7 and k < 6
            pred.observe((0.4 if slow else 0.004) * (1 + k / 10), model="m")
        depth.set(i * 1.5 + (i % 3), model="m")
        depth.set(7.0, model="n")
        jobs.inc(1, job_class="executor",
                 state="failed" if i in (5, 6) else "finished")
        engine.tick(now=now)
        views.append({
            "rate": engine.rate(HTTP_TOTAL, None, 4.0, now=now),
            "bad": engine.counter_delta(HTTP_TOTAL, {"status": "5xx"}, 4.0,
                                        now=now),
            "gauge": engine.gauge_window(QUEUE_DEPTH, {"model": "m"}, 5.0,
                                         now=now),
            "hist": engine.hist_window(PREDICT_DURATION, {"model": "m"},
                                       3.0, qs=(0.5, 0.9, 0.99, 0.999),
                                       now=now),
            "below": engine.fraction_below(PREDICT_DURATION, None, 0.1,
                                           6.0, now=now),
            "slope": engine.slope(QUEUE_DEPTH, {"model": "m"}, 6.0,
                                  now=now),
            "slope_all": engine.slope(QUEUE_DEPTH, None, 6.0, now=now),
            "labels": engine.label_values(PREDICT_DURATION, "model"),
            "alerts": _strip(service.alerts()["alerts"]),
        })
    status = engine.status()
    return {
        "views": views,
        "events": _strip(events),
        "history": _strip(service.alerts()["history"]),
        "slo": service.status(),
        "status": {k: v for k, v in status.items() if k != "running"},
        "prom": [(f.kind, f.name, f.samples)
                 for f in engine.prom_families() + service.prom_families()],
    }


def _close(a, b, path=""):
    """Equal structure; floats within 1e-12 (quantiles, slopes, rates)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _close(u, v, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12), path
    else:
        assert a == b, path


def test_windowed_views_and_alert_transitions_match_jax():
    ours, theirs = _scenario("port"), _scenario("jax")
    _close(ours, theirs)
    states = [e["state"] for e in ours["events"]]
    # The scenario fired and resolved both the availability and the
    # latency objective.
    assert states.count("firing") >= 2 and "resolved" in states
    assert {e["slo"] for e in ours["events"]} >= {
        "route-availability", "predict-latency"}
    assert any(v["hist"] and v["hist"]["quantiles"]["p50"] > 0.1
               for v in ours["views"])


def _timeseries(side):
    mod_metrics, mod_rollup, _slo, rcfg, *_ = SIDES[side]
    engine = mod_rollup.reset_engine(rcfg(tick_s=0.0, max_series=3))
    reg = mod_metrics.get_registry()
    http = reg.counter(HTTP_TOTAL, "t", labels=("route", "status"))
    depth = reg.gauge(QUEUE_DEPTH, "t", labels=("model",))
    base = time.monotonic() - 10.0
    for i in range(6):
        http.inc(3, route="GET /a", status="2xx")
        http.inc(1, route=f"GET /b{i % 2}", status="2xx")
        depth.set(float(i), model="m")
        engine.tick(now=base + i)
    docs = [engine.timeseries(name, None, window_s=30.0, max_points=4)
            for name in (HTTP_TOTAL, QUEUE_DEPTH)]
    for doc in docs:
        for series in doc["series"]:
            series["points"] = [p[1:] for p in series["points"]]
    directory = engine.timeseries()
    directory.pop("running")
    return docs, directory, engine.status()["droppedSeries"]


def test_timeseries_documents_and_series_cap_match_jax():
    ours, theirs = _timeseries("port"), _timeseries("jax")
    _close(ours, theirs)
    assert ours[2] > 0  # the series cap dropped new series


class _Ramp:
    """One model's replica set: traffic every tick, a queue that stays
    under the fraction trigger while it ramps."""

    name = "m"
    min_replicas, max_replicas = 1, 3

    def __init__(self):
        self.size = 1
        self.calls = 0

    def signals(self):
        self.calls += 1
        return {"replicas": self.size, "queue_depth": 6,
                "queue_frac": 6 / 64.0, "p99_ms": 1.0, "sheds": 0,
                "requests": 10 * self.calls}


class _Manager:
    def __init__(self, rs):
        self.rs = rs

    def sets_snapshot(self):
        return [(self.rs.name, self.rs)]

    def scale(self, name, n, *, reason):
        self.rs.size = n
        return n


def _slope_drive(side, ramp):
    mod_metrics, mod_rollup, _slo, rcfg, _scfg, fcfg, scaler_cls = \
        SIDES[side]
    engine = mod_rollup.reset_engine(rcfg(tick_s=0.0))
    depth = mod_metrics.get_registry().gauge(QUEUE_DEPTH, "t",
                                             labels=("model",))
    # Anchored to the live clock: the autoscaler reads the slope at now.
    base = time.monotonic() - len(ramp)
    for t, rows in enumerate(ramp):
        depth.set(rows, model="m")
        engine.tick(now=base + t)
    rs = _Ramp()
    scaler = scaler_cls(_Manager(rs), fcfg(
        interval_s=0.0, up_queue_frac=0.5, up_ticks=2, down_ticks=5,
        up_slope=1.0, slope_window_s=30.0))
    made = [scaler.tick() for _ in range(4)]
    status = scaler.status()
    for key in ("decisions", "ledger"):
        for record in status[key]:
            record.pop("t")
    for batch in made:
        for record in batch:
            record.pop("t", None)
    return made, status, rs.size


@pytest.mark.parametrize("ramp", [
    (0.0, 2.0, 4.0, 6.0),      # 2 rows/s: scales on the slope
    (6.0, 6.0, 6.0, 6.0),      # flat: holds
    (0.0, 0.5, 1.0, 1.5),      # 0.5 rows/s, under up_slope: holds
], ids=["ramp", "flat", "slow"])
def test_autoscaler_slope_decisions_match_jax(ramp):
    ours, theirs = _slope_drive("port", ramp), _slope_drive("jax", ramp)
    _close(ours, theirs)
    scaled = ours[2] > 1
    assert scaled == (ramp[-1] - ramp[0] >= len(ramp) - 1)
    if scaled:
        assert ours[1]["ledger"][-1]["queueSlope"] == pytest.approx(2.0)
        assert any(d["signal"] == "slope" for batch in ours[0]
                   for d in batch)
