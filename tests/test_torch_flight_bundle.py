"""The port's flight recorder (obs/flight.py) and debug bundles
(obs/bundle.py) held against the JAX package's: the same flight events
give the same rings, the same merged timeline and the same status; a
bundle built over REST by a JAX and a port server has the same file set
and manifest keys, and both answer its routes alike.  Then the port's
drills: an ``http.handler`` fault burst fires the availability SLO and
lands exactly one bundle holding the faulted requests and the triggers;
a job whose preemption retries run out, and one past its deadline, each
ask for a bundle."""

import gc
import json
import time

import pytest

from learningorchestra_tpu import concurrency_rt as jrt
from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu import faults as jfaults
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu.config import FlightConfig as JaxFlightConfig
from learningorchestra_tpu.obs import bundle as jbundle
from learningorchestra_tpu.obs import flight as jflight
from learningorchestra_tpu.obs import metrics as jmetrics
from learningorchestra_tpu.obs import rollup as jrollup
from learningorchestra_tpu.obs import slo as jslo
from learningorchestra_tpu.obs import tracing as jtracing
from learningorchestra_tpu_torch import concurrency_rt as rt
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import (
    BundleConfig,
    Config,
    FlightConfig,
    RollupConfig,
    SLOConfig,
    StoreConfig,
)
from learningorchestra_tpu_torch.jobs.engine import JobEngine, Preempted
from learningorchestra_tpu_torch.obs import bundle, flight, rollup, slo
from learningorchestra_tpu_torch.obs import tracing
from learningorchestra_tpu_torch.store.artifacts import ArtifactStore
from learningorchestra_tpu_torch.store.document_store import DocumentStore

PREFIX = "/api/learningOrchestra/v1"


@pytest.fixture(autouse=True)
def _fresh():
    """The recorders, bundle services, fault planes and lock witnesses are
    process-wide: each test starts from empty ones (the planes'
    cumulative counters land in a bundle's faults.json, the witnesses'
    edges and live witnessed locks in its locks.json).  A witnessed lock
    lives as long as its owner: the singletons an earlier test's server
    left behind are rebuilt, and dropped before the test starts."""
    for mod in (rt, jrt):
        mod.set_witness(False)
        mod.reset()
    jrollup.reset_engine()
    jslo.reset_service()
    jmetrics.reset_registry()
    gc.collect()
    for mod in (flight, jflight):
        mod.reset()
    for mod in (faults, jfaults):
        mod.reset()
    bundle.reset_service()
    jbundle.reset_service()
    yield
    faults.disarm_all()
    for mod in (flight, jflight):
        mod.reset(FlightConfig())
    bundle.reset_service()
    jbundle.reset_service()
    rollup.reset_engine()
    slo.reset_service()


def _record(mod, trace_mod, events):
    for domain, kind, rid, fields in events:
        token = trace_mod.set_request_id(rid) if rid else None
        try:
            mod.record(domain, kind, **fields)
        finally:
            if token is not None:
                trace_mod.reset_request_id(token)


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if k not in ("t", "wall")}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def test_flight_rings_and_timeline_match_jax():
    assert vars(FlightConfig()) == vars(JaxFlightConfig())
    assert flight.DOMAINS == jflight.DOMAINS
    # Disabled: every record is dropped, the views say so.
    _record(flight, tracing, [("http", "request", None, {"status": 200})])
    assert flight.snapshot() == jflight.snapshot()
    assert flight.status() == jflight.status()
    flight.configure(FlightConfig(events=4))
    jflight.configure(JaxFlightConfig(events=4))
    events = []
    for i in range(9):
        events += [
            ("http", "request", f"r{i}", {"route": "GET /x", "status": 200,
                                          "ms": 1.5 * i}),
            ("jobs", "dispatch", None, {"job": f"j{i}", "attempt": 1}),
            ("decode", "ttft", f"r{i}", {"model": "lm", "ttftS": 0.1}),
            ("faults", "trigger", None, {"point": "serve.apply",
                                         "mode": "error", "n": i}),
            ("compile", "build", None, {"label": "p", "builtS": 0.2}),
            ("no_such_domain", "x", None, {}),
        ]
    # Interleaved, so each event's monotonic stamp orders the same way
    # in both recorders.
    for event in events:
        _record(flight, tracing, [event])
        _record(jflight, jtracing, [event])
    assert _untimed(flight.snapshot()) == _untimed(jflight.snapshot())
    assert flight.status() == jflight.status()
    for kw in (dict(), dict(limit=5), dict(domains=("http", "faults"))):
        ours = _untimed(flight.timeline(**kw))
        assert ours == _untimed(jflight.timeline(**kw))
    merged = flight.timeline()
    assert [e["t"] for e in merged] == sorted(e["t"] for e in merged)
    assert len(flight.snapshot()["events"]["http"]) == 4
    assert flight.snapshot(limit=2)["events"]["jobs"][-1]["job"] == "j8"


def _pair(tmp_path):
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp_path / "jax" / "store")
    jcfg.store.volume_root = str(tmp_path / "jax" / "volumes")
    jcfg.store.backend = "python"
    return {
        "jax": JaxServer(jcfg),
        "port": APIServer(Config(store=StoreConfig(
            root=str(tmp_path / "port" / "store"),
            volume_root=str(tmp_path / "port" / "volumes"))),
            device="cpu"),
    }


def test_bundle_files_and_manifest_keys_match_jax(tmp_path):
    servers = _pair(tmp_path)
    try:
        made, docs = {}, {}
        for side, srv in servers.items():
            srv.handle("GET", f"{PREFIX}/health", {}, {})
            status, doc = srv.handle("POST", f"{PREFIX}/observability/bundle",
                                     {"reason": "drill"}, {})
            assert status == 201, (side, doc)
            made[side] = doc["bundle"]
            name = made[side]["name"]
            docs[side] = {
                "list": srv.handle("GET", f"{PREFIX}/observability/bundles",
                                   {}, {}),
                "manifest": srv.handle(
                    "GET", f"{PREFIX}/observability/bundles/{name}", {}, {}),
                "file": srv.handle(
                    "GET", f"{PREFIX}/observability/bundles/{name}", {},
                    {"file": "faults.json"}),
                "escape": srv.handle(
                    "GET", f"{PREFIX}/observability/bundles/{name}", {},
                    {"file": "../../x"})[0],
                "missing": srv.handle(
                    "GET", f"{PREFIX}/observability/bundles/nope", {},
                    {})[0],
                "flight": srv.handle("GET", f"{PREFIX}/observability/flight",
                                     {}, {"domain": "http", "limit": "3"}),
            }
        assert set(made["port"]) == set(made["jax"])
        assert {f["name"] for f in made["port"]["files"]} == \
            {f["name"] for f in made["jax"]["files"]}
        assert made["port"]["errors"] == {} and made["port"]["reason"] == \
            made["jax"]["reason"] == "drill"
        ours, theirs = docs["port"], docs["jax"]
        assert ours["list"][0] == theirs["list"][0] == 200
        assert set(ours["list"][1]) == set(theirs["list"][1])
        assert ours["manifest"][0] == 200
        assert set(ours["manifest"][1]) == set(theirs["manifest"][1])
        assert ours["file"][0] == 200
        assert json.loads(ours["file"][1][1]) == json.loads(
            theirs["file"][1][1])
        # With both lock witnesses off, both snapshots are the empty one;
        # with one engine each, cluster.json is the claim table's status
        # as GET /cluster/status answers it (enabled false on both).
        for stem in ("locks", "cluster"):
            assert json.loads(servers["port"].bundles.read_file(
                made["port"]["name"], f"{stem}.json")) == json.loads(
                servers["jax"].bundles.read_file(
                    made["jax"]["name"], f"{stem}.json")), stem
        assert json.loads(servers["port"].bundles.read_file(
            made["port"]["name"], "cluster.json")) == servers["port"].handle(
                "GET", f"{PREFIX}/cluster/status", {}, {})[1]
        assert ours["escape"] == theirs["escape"]
        assert ours["missing"] == theirs["missing"] == 404
        assert set(ours["flight"][1]) == set(theirs["flight"][1])
        assert [e["route"] for e in ours["flight"][1]["timeline"]] == \
            [e["route"] for e in theirs["flight"][1]["timeline"]]
        for side, srv in servers.items():
            name = made[side]["name"]
            assert srv.handle(
                "DELETE", f"{PREFIX}/observability/bundles/{name}", {},
                {})[0] == 200
            assert srv.handle("DELETE", f"{PREFIX}/observability/bundles",
                              {}, {})[1] == {"deleted": 0}
    finally:
        for srv in servers.values():
            srv.shutdown()


def _wait_for(fn, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    return fn()


def test_fault_burst_fires_the_slo_and_lands_one_bundle(tmp_path):
    cfg = Config(store=StoreConfig(root=str(tmp_path / "store"),
                                   volume_root=str(tmp_path / "volumes")))
    cfg.rollup = RollupConfig(tick_s=0.1, points=256)
    cfg.slo = SLOConfig(fast_window_s=2.0, slow_window_s=4.0,
                        burn_threshold=5.0, for_s=0.2, resolve_s=0.5,
                        predict_p99_ms=0.0, job_success_target=0.0)
    cfg.bundle = BundleConfig(dir=str(tmp_path / "bundles"),
                              debounce_s=300.0)
    rollup.reset_engine(cfg.rollup)
    slo.reset_service(cfg.slo)
    server = APIServer(cfg, device="cpu")
    try:
        status, _ = server.handle("POST", f"{PREFIX}/faults/http.handler",
                                  {"mode": "error", "maxTriggers": 30}, {})
        assert status == 201
        for i in range(30):
            assert server.handle("GET", f"{PREFIX}/health", {}, {},
                                 request_id=f"burst{i}")[0] == 500

        def names():
            return [b["name"] for b in server.bundles.status()["bundles"]]

        found = _wait_for(names)
        assert len(found) == 1, found
        manifest = server.bundles.manifest(found[0])
        assert manifest["reason"] == "slo_firing"
        assert manifest["detail"]["slo"] == "route-availability"
        doc = json.loads(server.bundles.read_file(found[0], "flight.json"))
        faulted = [e for e in doc["snapshot"]["events"]["http"]
                   if e.get("route") == "GET /health"
                   and e.get("status") == 500]
        assert len(faulted) == 30
        assert {e["requestId"] for e in faulted} == {
            f"burst{i}" for i in range(30)}
        assert sum(1 for e in doc["snapshot"]["events"]["faults"]
                   if e.get("point") == "http.handler") == 30
        assert {"http", "faults"} <= {e["domain"] for e in doc["timeline"]}
        alerts = server.handle("GET", f"{PREFIX}/observability/alerts", {},
                               {})[1]
        assert any(a["slo"] == "route-availability"
                   for a in alerts["firing"])
        # The storm's later triggers are debounced into the one bundle.
        assert server.bundles.trigger("slo_firing") is None
        assert names() == found
    finally:
        server.shutdown()


def test_exhausted_retries_and_a_deadline_each_land_a_bundle(tmp_path):
    bundle.reset_service(BundleConfig(dir=str(tmp_path / "bundles"),
                                      debounce_s=0.0), providers={})
    flight.configure(FlightConfig())
    store = DocumentStore(tmp_path / "store")
    artifacts = ArtifactStore(store)
    engine = JobEngine(artifacts, max_preemption_retries=1,
                       retry_backoff_s=0.0)
    try:
        for name in ("preempted", "late"):
            artifacts.metadata.create(name, "function/python")

        def always_preempted():
            raise Preempted("spot reclaim")

        engine.submit("preempted", always_preempted)
        engine.wait("preempted", timeout=30)
        svc = bundle.get_service()
        reasons = _wait_for(lambda: [
            b["reason"] for b in svc.list_bundles()])
        assert reasons == ["job_retries_exhausted"]
        engine.submit("late", lambda: time.sleep(1.0), deadline_s=0.1)
        reasons = _wait_for(lambda: [
            b["reason"] for b in svc.list_bundles()
            if b["reason"] != "job_retries_exhausted"])
        assert reasons == ["job_deadline"]
        timeline = flight.timeline(domains=("jobs",))
        kinds = [e["kind"] for e in timeline]
        assert kinds.count("preempt_retry") == 2 and "deadline" in kinds
    finally:
        engine.shutdown(wait=False)
        store.close()


def test_the_cluster_ring_is_fed_by_the_claim_table_like_jax(tmp_path):
    """Claims, renewals, releases, steals, a dead engine and a quota
    rejection land in the ``cluster`` ring, event for event as the JAX
    control plane records them."""
    from learningorchestra_tpu.jobs.cluster import (
        ClusterCoordinator as JaxCoordinator,
    )
    from learningorchestra_tpu.jobs.cluster import (
        QuotaExceeded as JaxQuota,
    )
    from learningorchestra_tpu.jobs.cluster import (
        TenantAdmission as JaxAdmission,
    )
    from learningorchestra_tpu.store import DocumentStore as JaxStore
    from learningorchestra_tpu_torch.jobs.cluster import (
        ClusterCoordinator,
        QuotaExceeded,
        TenantAdmission,
    )

    rings = {}
    for name, mod, coord, store, adm, quota in (
            ("port", flight, ClusterCoordinator, DocumentStore,
             TenantAdmission, QuotaExceeded),
            ("jax", jflight, JaxCoordinator, JaxStore, JaxAdmission,
             JaxQuota)):
        mod.configure(FlightConfig(events=64) if name == "port"
                      else JaxFlightConfig(events=64))
        root = tmp_path / name
        stores = [store(root), store(root)]
        dead, thief = (coord(s, root, engine_id=e, heartbeat_s=30,
                             ttl_s=t, sweep_s=30)
                       for s, e, t in zip(stores, ("A", "B"),
                                          (60.0, 0.05)))
        try:
            dead.heartbeat()
            assert dead.claim("j1") and dead.claim("j2")
            dead.release("j2")
            time.sleep(0.12)
            assert [j for j, _ in thief.sweep()] == ["j1"]
            admission = adm(max_queued=1, cluster=thief)
            admission.note_queued("t")
            with pytest.raises(quota):
                admission.check("t")
        finally:
            for c in (dead, thief):
                c.close()
            for s in stores:
                s.close()
        rings[name] = [
            {k: v for k, v in e.items() if k not in ("t", "wall")}
            for e in mod.snapshot()["events"]["cluster"]]
        mod.reset()
    assert rings["port"] == rings["jax"]
    assert [e["kind"] for e in rings["port"]] == [
        "renew", "claim", "claim", "release", "steal", "engine_dead",
        "quota_reject"]
