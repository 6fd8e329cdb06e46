"""The port's multi-engine control plane (jobs/cluster.py with the
journal's claim fence, the engine's claims and tenant fairness, the
context's steal, the gateway's 429) held against the JAX package's:

- the claim-table goldens of the JAX ``tests/test_control_plane.py``,
  run on both packages over the same sequence of operations (each
  engine with its own ``DocumentStore`` over one root, so views meet
  only through the WAL refresh under the ``fcntl`` lock): CAS with one
  owner, renewal on one's own reclaim, the released-claim supersede
  rule, a dispatch-time takeover, the boot-adoption gate, a steal in
  claim order, the engine-death callback, and a stolen or released claim
  refusing the stale commit;
- tenant admission: a quota answers alike on two engines of either
  package, counters clamp at zero, a flood cannot starve a peer tenant,
  and the gateway answers 429 with ``Retry-After`` before any metadata
  exists, as the JAX server does;
- the cross-process coherence primitive: ``refresh`` folds a peer's
  appends and a peer's compaction in;
- a two-process partition drill on the CPU with a small MLP: engine A is
  SIGKILLed mid-fit after its second checkpoint, engine B steals the
  claim and resumes from the newest checkpoint: one ``finished`` journal
  event under B's epoch, only the tail epochs run on B, and B's
  ``/cluster/status`` and flight ring show the steal.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from learningorchestra_tpu import faults as jax_faults
from learningorchestra_tpu.jobs import JobEngine as JaxEngine
from learningorchestra_tpu.jobs import JobJournal as JaxJournal
from learningorchestra_tpu.jobs import QuotaExceeded as JaxQuota
from learningorchestra_tpu.jobs import StaleEpochError as JaxStale
from learningorchestra_tpu.jobs import TenantAdmission as JaxAdmission
from learningorchestra_tpu.jobs import bind_tenant as jax_bind_tenant
from learningorchestra_tpu.jobs import journal as jax_journal_mod
from learningorchestra_tpu.jobs.cluster import (
    ClusterCoordinator as JaxCoordinator,
)
from learningorchestra_tpu.jobs.cluster import bind_claim as jax_bind_claim
from learningorchestra_tpu.store import ArtifactStore as JaxArtifacts
from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.jobs import (
    JobEngine,
    JobJournal,
    QuotaExceeded,
    StaleEpochError,
    TenantAdmission,
    bind_tenant,
)
from learningorchestra_tpu_torch.jobs import journal as journal_mod
from learningorchestra_tpu_torch.jobs.cluster import (
    ClusterCoordinator,
    bind_claim,
)
from learningorchestra_tpu_torch.store import ArtifactStore, DocumentStore

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "/api/learningOrchestra/v1"

PKGS = {
    "port": dict(Coord=ClusterCoordinator, Store=DocumentStore,
                 Journal=JobJournal, journal=journal_mod,
                 bind_claim=bind_claim, Stale=StaleEpochError,
                 Admission=TenantAdmission, Quota=QuotaExceeded,
                 Engine=JobEngine, Artifacts=ArtifactStore,
                 bind_tenant=bind_tenant),
    "jax": dict(Coord=JaxCoordinator, Store=JaxStore, Journal=JaxJournal,
                journal=jax_journal_mod, bind_claim=jax_bind_claim,
                Stale=JaxStale, Admission=JaxAdmission, Quota=JaxQuota,
                Engine=JaxEngine, Artifacts=JaxArtifacts,
                bind_tenant=jax_bind_tenant),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


class Pair:
    """Coordinators of one package, each over its own store instance of
    one root (the shape of separate engine processes)."""

    def __init__(self, pkg: dict, root: Path):
        self.pkg, self.root = pkg, root
        self.stores, self.coords = [], []

    def coord(self, engine_id, **kw):
        store = self.pkg["Store"](self.root)
        kw.setdefault("heartbeat_s", 30.0)
        kw.setdefault("ttl_s", 60.0)
        kw.setdefault("sweep_s", 30.0)
        c = self.pkg["Coord"](store, store.root, engine_id=engine_id, **kw)
        self.stores.append(store)
        self.coords.append(c)
        return c

    def close(self):
        for c in self.coords:
            c.close()
        for s in self.stores:
            s.close()


def _both(tmp_path, fn):
    """Run ``fn(pair)`` on both packages; returns {pkg: result}."""
    out = {}
    for name, pkg in PKGS.items():
        pair = Pair(pkg, tmp_path / name / "store")
        try:
            out[name] = fn(pair)
        finally:
            pair.close()
    return out


def _cas(p):
    a, b = p.coord("A"), p.coord("B")
    return [a.claim("j"), b.claim("j"), a.verify("j"), b.verify("j")]


def _reclaim(p):
    a = p.coord("A")
    return [a.claim("j"), a.claim("j"), a.verify("j")]


def _supersede(p):
    a, b = p.coord("A"), p.coord("B")
    out = [a.claim("j")]
    a.release("j")
    out += [b.claim("j", enqueued_at=time.time() - 100),
            b.claim("j", enqueued_at=time.time() + 100), b.verify("j"),
            a.verify("j")]
    return out


def _takeover(p):
    a, b = p.coord("A"), p.coord("B", ttl_s=0.05)
    out = [a.claim("j")]
    time.sleep(0.12)  # the lease idles past B's TTL
    return out + [b.claim("j"), a.verify("j"), b.verify("j")]


def _claimable(p):
    a, b = p.coord("A"), p.coord("B")
    out = [a.claim("j"), b.claimable("j"), a.claimable("j")]
    a.release("j")
    return out + [b.claimable("j")]


def _steal_order(p):
    dead, thief = p.coord("dead"), p.coord("thief", ttl_s=0.05)
    for job in ("j1", "j2", "j3"):
        assert dead.claim(job)
    time.sleep(0.12)
    stolen = thief.sweep()
    return [stolen, [thief.verify(j) for j in ("j1", "j2", "j3")],
            [dead.verify(j) for j in ("j1", "j2", "j3")]]


def _engine_dead(p):
    dead, thief = p.coord("dead"), p.coord("thief", ttl_s=0.05)
    dead.epoch = 7
    seen = []
    thief.on_engine_dead = lambda eng, epoch: seen.append((eng, epoch))
    dead.heartbeat()
    time.sleep(0.12)
    thief.sweep()
    return [seen, [e["engine"] for e in thief.status()["engines"]]]


@pytest.mark.parametrize("case", [_cas, _reclaim, _supersede, _takeover,
                                  _claimable, _steal_order, _engine_dead],
                         ids=lambda f: f.__name__.strip("_"))
def test_claim_goldens_match_jax(tmp_path, case):
    out = _both(tmp_path, case)
    assert out["port"] == out["jax"], out


def _fence(p, release: bool):
    pkg = p.pkg
    store = pkg["Store"](p.root)
    p.stores.append(store)
    journal = pkg["Journal"](store, p.root)
    a = pkg["Coord"](store, store.root, engine_id="A", heartbeat_s=30,
                     ttl_s=60, sweep_s=30)
    p.coords.append(a)
    a.epoch = journal.epoch
    journal.cluster = a
    thief = p.coord("thief", ttl_s=0.05)
    out = []
    try:
        assert a.claim("fit1")
        with pkg["bind_claim"]("fit1"), pkg["journal"].stamp(a.epoch):
            journal.fence_check()  # owned: the commit is allowed
            if release:
                a.release("fit1")
            else:
                time.sleep(0.12)
                out.append([j for j, _ in thief.sweep()])
            with pytest.raises(pkg["Stale"]):
                journal.fence_check()
        # Without a bound claim a clustered store is not fenced.
        with pkg["journal"].stamp(a.epoch):
            journal.fence_check()
        out.append("refused")
    finally:
        journal.close()
    return out


@pytest.mark.parametrize("release", [False, True],
                         ids=["stolen", "released"])
def test_stale_commit_is_refused_like_jax(tmp_path, release):
    out = _both(tmp_path, lambda p: _fence(p, release))
    assert out["port"] == out["jax"] == (
        ["refused"] if release else [["fit1"], "refused"])


def _quota(p):
    a, b = p.coord("A"), p.coord("B")
    Adm, Quota = p.pkg["Admission"], p.pkg["Quota"]
    adm_a, adm_b = Adm(max_queued=1, cluster=a), Adm(max_queued=1, cluster=b)
    out = []
    adm_a.check("t1")
    adm_a.note_queued("t1")
    with pytest.raises(Quota) as exc:
        adm_b.check("t1")  # queued through A, refused by B
    out.append((str(exc.value), exc.value.retry_after_s))
    adm_b.check("t2")
    adm_a.note_dispatch("t1", "executor")
    adm_b.check("t1")
    adm_run = Adm(max_running=1, cluster=b)
    with pytest.raises(Quota) as exc:
        adm_run.check("t1")
    out.append(str(exc.value))
    adm_a.note_done("t1", "executor")
    adm_run.check("t1")
    adm_a.note_dequeued("t9")  # a cancel race must not go negative
    adm_a.note_queued("t9")
    out.append(adm_b.snapshot())
    return out


def test_tenant_quota_answers_alike_on_two_engines(tmp_path):
    out = _both(tmp_path, _quota)
    assert out["port"] == out["jax"], out
    assert out["port"][2]["t9"] == {"queued": 1, "running": 0}


def _flood(pkg, root):
    store = pkg["Store"](root)
    arts = pkg["Artifacts"](store)
    eng = pkg["Engine"](arts, max_workers=1)
    done, gate, started = [], threading.Event(), threading.Event()

    def blocker():
        started.set()
        gate.wait(30)
        return "b"

    try:
        arts.metadata.create("blk", "function/python")
        eng.submit("blk", blocker, job_class="f")
        assert started.wait(10)

        def body(tag):
            return lambda: done.append(tag) or tag

        with pkg["bind_tenant"]("noisy"):
            for i in range(6):
                arts.metadata.create(f"n{i}", "function/x")
                eng.submit(f"n{i}", body(f"n{i}"), job_class="f")
        with pkg["bind_tenant"]("quiet"):
            for i in range(2):
                arts.metadata.create(f"q{i}", "function/x")
                eng.submit(f"q{i}", body(f"q{i}"), job_class="f")
        depths = eng.queue_depths_by_tenant()
        gate.set()
        for name in [f"n{i}" for i in range(6)] + ["q0", "q1"]:
            eng.wait(name, timeout=30)
        tenant = arts.metadata.read("q0").get("tenant")
    finally:
        gate.set()
        eng.shutdown()
        store.close()
    return done, depths, tenant


def test_a_flood_cannot_starve_a_peer_tenant(tmp_path):
    """One worker, six jobs of one tenant, two of another: the class's
    turn serves the tenants round-robin, in the JAX engine's order."""
    port = _flood(PKGS["port"], tmp_path / "p")
    jax = _flood(PKGS["jax"], tmp_path / "j")
    assert port == jax
    done, depths, tenant = port
    assert {"q0", "q1"} <= set(done[:4]), done
    assert depths == {("f", "noisy"): 6, ("f", "quiet"): 2}
    assert tenant == "quiet"


def test_refresh_folds_a_peers_appends_and_compaction(tmp_path):
    a = DocumentStore(tmp_path / "s")
    b = DocumentStore(tmp_path / "s")
    try:
        a.insert_one("c", {"v": 1})
        assert not b.collection_exists("x")
        assert b.find("c") == [{"v": 1, "_id": 0}]  # replayed at first use
        a.insert_one("c", {"v": 2})
        assert len(b.find("c")) == 1  # stale until refreshed
        b.refresh("c")
        assert [d["v"] for d in b.find("c")] == [1, 2]
        a.delete_one("c", 0)
        a.compact("c")  # a new file under the same name
        b.refresh("c")
        assert [d["v"] for d in b.find("c")] == [2]
        b.insert_one("c", {"v": 3})  # lands in the live file
        a.refresh("c")
        assert [d["v"] for d in a.find("c")] == [2, 3]
        assert b.find("c")[-1]["_id"] == 2  # ids stay monotonic
    finally:
        a.close()
        b.close()


def _quota_server(pkg_name, tmp_path):
    """A server of ``pkg_name`` with one worker and a queued quota of one,
    over a fresh metrics registry: the registry is process-wide, so a
    rejection an earlier test counted would show in this test's
    counter."""
    if pkg_name == "port":
        from learningorchestra_tpu_torch.api.server import APIServer
        from learningorchestra_tpu_torch.config import Config
        from learningorchestra_tpu_torch.obs import metrics

        cfg = Config()
        kw = {"device": "cpu"}
    else:
        from learningorchestra_tpu.api import APIServer
        from learningorchestra_tpu.config import Config
        from learningorchestra_tpu.obs import metrics

        cfg = Config()
        kw = {}
    metrics.reset_registry()
    cfg.store.root = str(tmp_path / pkg_name / "store")
    cfg.store.volume_root = str(tmp_path / pkg_name / "volumes")
    cfg.jobs.max_workers = 1
    cfg.tenant.max_queued = 1
    cfg.tenant.retry_after_s = 0.2
    return APIServer(cfg, **kw)


def _blocking_fn(name, start, gate):
    return {"name": name, "functionParameters": {}, "function": (
        "import os, time\n"
        f"open({str(start)!r}, 'w').close()\n"
        f"while not os.path.exists({str(gate)!r}):\n"
        "    time.sleep(0.01)\n"
        "response = 1\n")}


def _drive_quota(server, tmp):
    out = []
    gate = tmp / "drain"
    start = tmp / "b0_started"
    post = lambda name, tenant, flag: server.handle(  # noqa: E731
        "POST", f"{PREFIX}/function/python",
        _blocking_fn(name, flag, gate), {}, tenant=tenant)
    out.append(post("b0", "acme", start)[0])
    deadline = time.time() + 30
    while not start.exists():  # the worker is busy, the queue empty
        assert time.time() < deadline
        time.sleep(0.01)
    out.append(post("q1", "acme", tmp / "q1s")[0])
    st, body = post("q2", "acme", tmp / "q2s")
    out.append((st, body["retryAfter"], body["error"]))
    out.append(server.handle("GET", f"{PREFIX}/function/python/q2",
                             {}, {})[0])  # no orphan artifact
    out.append(post("o1", "tenant-b", tmp / "o1s")[0])
    text = server.handle("GET", f"{PREFIX}/metrics.prom", {}, {})[1][1]
    out.append(any(
        line.startswith("lo_admission_rejections_total{")
        and 'tenant="acme"' in line and 'reason="queued_quota"' in line
        and line.endswith(" 1") for line in text.decode().splitlines()))
    status = server.handle("GET", f"{PREFIX}/cluster/status", {}, {})[1]
    out.append(status)
    gate.write_text("go")
    for name in ("b0", "q1", "o1"):
        server.ctx.engine.wait(name, timeout=30)
    return out


def test_gateway_answers_429_with_retry_after_like_jax(tmp_path):
    outs = {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        server = _quota_server(name, tmp_path)
        try:
            outs[name] = _drive_quota(server, tmp_path / name)
        finally:
            server.shutdown()
    assert outs["port"] == outs["jax"], outs
    assert outs["port"][:2] == [201, 201]
    assert outs["port"][2][:2] == (429, 0.2)
    assert outs["port"][3:6] == [404, 201, True]


def test_clustering_refuses_the_native_store(tmp_path):
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.services.context import ServiceContext

    cfg = Config()
    cfg.store.root = str(tmp_path / "store")
    cfg.store.volume_root = str(tmp_path / "volumes")
    cfg.store.backend = "native"
    cfg.cluster.enabled = True
    with pytest.raises(ValueError, match="python store backend"):
        ServiceContext(cfg, device="cpu")


# -- the two-process partition drill ------------------------------------------

_CHILD_A = r"""
import sys, time
import numpy as np
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.executor import ExecutorService
from learningorchestra_tpu_torch.services.model import ModelService

ctx = ServiceContext(Config.from_env(), device="cpu")
ModelService(ctx).create(
    "m", module_path="learningorchestra_tpu.models.mlp",
    class_name="MLPClassifier",
    class_parameters={"hidden_layer_sizes": [4], "num_classes": 2})
ctx.engine.wait("m", timeout=120)
rng = np.random.default_rng(0)
x = rng.standard_normal((32, 4)).astype("float32")
y = (x.sum(1) > 0).astype("int32")
# Epochs 0-1 run free and checkpoint; the third epoch's top holds the
# fit, so the parent's SIGKILL lands while it runs, however long engine
# B takes to boot.
faults.arm("train.epoch", "delay", delay_ms=120000, after=2)
ExecutorService(ctx).create(
    "fit1", parent_name="m", method="fit",
    method_parameters={"x": x.tolist(), "y": y.tolist(), "epochs": 6,
                       "batch_size": 8, "shuffle": False,
                       "checkpoint_every": 1,
                       "checkpoint_min_interval_s": 0,
                       "checkpoint_async": False},
    artifact_type="train/tensorflow")
print("SUBMITTED", flush=True)
time.sleep(600)
"""

_CHILD_B = r"""
import json, os, time
from pathlib import Path
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.jobs.journal import JOURNAL_COLLECTION
from learningorchestra_tpu_torch.obs import flight
from learningorchestra_tpu_torch.services.context import ServiceContext

flight.ensure(Config().flight)
faults.arm("cluster.claim", "delay", delay_ms=20)
ctx = ServiceContext(Config.from_env(), device="cpu")
adopted_early = "fit1" in ctx.engine.running_jobs()
Path(os.environ["DRILL_B_BOOTED"]).write_text("1")
deadline = time.time() + 120
meta = {}
while time.time() < deadline:
    ctx.documents.refresh("fit1")
    meta = ctx.artifacts.metadata.read("fit1") or {}
    if meta.get("jobState") in ("finished", "failed"):
        break
    time.sleep(0.05)
ctx.engine.wait("fit1", timeout=60)
ctx.journal.flush()  # group-committed: drain before reading back
with ctx.cluster.journal_guard():
    finished = sum(
        1 for d in ctx.documents.find(JOURNAL_COLLECTION)
        if d.get("job") == "fit1" and d.get("event") == "finished")
hist = ctx.artifacts.ledger.history("fit1")
trace = next((r["trace"] for r in reversed(hist) if r.get("trace")), None)
epochs = sorted(s["attrs"]["epoch"] for s in (trace or {}).get("spans", [])
                if s.get("name") == "epoch")
status = ctx.cluster.status()
ring = [e["kind"] for e in flight.snapshot()["events"]["cluster"]]
print("RESULT " + json.dumps({
    "jobState": meta.get("jobState"), "engineEpoch": meta.get(
        "engineEpoch"), "myEpoch": ctx.journal.epoch,
    "adoptedEarly": adopted_early, "finishedEvents": finished,
    "claimTriggers": faults.triggers("cluster.claim"), "epochs": epochs,
    "engines": sorted(e["engine"] for e in status["engines"]),
    "claims": [(c["job"], c["engine"], c["state"])
               for c in status["claims"]],
    "ring": ring}), flush=True)
ctx.close()
"""


def _drill_env(tmp_path, engine_id):
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "LO_TPU_STORE_ROOT": str(tmp_path / "store"),
           "LO_TPU_VOLUME_ROOT": str(tmp_path / "vol"),
           "LO_TPU_STORE_BACKEND": "python",
           "LO_TPU_CLUSTER_ENABLED": "1",
           "LO_TPU_CLUSTER_ENGINE_ID": engine_id,
           "LO_TPU_CLUSTER_HEARTBEAT_S": "0.2",
           "LO_TPU_CLUSTER_TTL_S": "1.2",
           "LO_TPU_CLUSTER_SWEEP_S": "0.3"}
    env.pop("LO_TPU_WITNESS", None)
    return env


def _spawn_b(env_b, tmp_path, booted):
    b = subprocess.Popen([sys.executable, "-c", _CHILD_B], env=env_b,
                         cwd=tmp_path, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 90
    while not booted.exists():
        assert b.poll() is None, b.communicate()[1][-3000:]
        assert time.time() < deadline, "engine B never booted"
        time.sleep(0.05)
    return b


@pytest.mark.parametrize("order", ["a_first", "b_first"])
def test_partition_drill_peer_steals_and_resumes(tmp_path, order):
    """Engine A SIGKILLed mid-fit; engine B steals its claim after the
    TTL and resumes from the newest complete checkpoint: one terminal
    publication, under B's epoch.  ``a_first``: B boots while A holds
    the claim (its recovery must not adopt the job), and mints the
    larger epoch; ``b_first``: A boots last and mints the larger epoch,
    so the dead engine's epoch is the larger one when B adopts its work
    (the steal and the dead engine's queued work name the same job; it
    must run once)."""
    booted = tmp_path / "b_booted"
    env_b = _drill_env(tmp_path, "B")
    env_b["DRILL_B_BOOTED"] = str(booted)
    a = b = None
    try:
        if order == "b_first":
            b = _spawn_b(env_b, tmp_path, booted)
        a = subprocess.Popen([sys.executable, "-c", _CHILD_A],
                             env=_drill_env(tmp_path, "A"), cwd=tmp_path,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        marker = tmp_path / "vol" / "_checkpoints" / "fit1" / "latest.json"
        deadline = time.time() + 90
        while True:
            assert a.poll() is None, a.communicate()[1][-3000:]
            try:
                if json.loads(marker.read_text()).get("step", 0) >= 2:
                    break
            except (OSError, ValueError):
                pass
            assert time.time() < deadline, "fit1 never reached checkpoint 2"
            time.sleep(0.02)
        if b is None:
            b = _spawn_b(env_b, tmp_path, booted)
        a.send_signal(signal.SIGKILL)  # the partition: A's heartbeats stop
        a.wait(timeout=30)
        out, err = b.communicate(timeout=180)
    finally:
        for proc in (a, b):
            if proc is not None and proc.poll() is None:
                proc.kill()
            if proc is not None:
                proc.communicate()
    assert b.returncode == 0, (out[-3000:], err[-3000:])
    result = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
    assert result["jobState"] == "finished", result
    assert result["adoptedEarly"] is False, result
    assert result["finishedEvents"] == 1, result
    # The terminal commit is B's epoch (A minted the other one).
    mine = 2 if order == "a_first" else 1
    assert result["engineEpoch"] == result["myEpoch"] == mine, result
    # Resumed from the newest checkpoint: only the tail epochs ran on B.
    assert result["epochs"] and min(result["epochs"]) >= 2, result
    assert max(result["epochs"]) == 5 and len(result["epochs"]) < 6, result
    assert result["claimTriggers"] >= 1, result
    assert result["engines"] == ["B"], result  # A's membership expired
    assert ("fit1", "B", "released") in [tuple(c) for c in
                                         result["claims"]], result
    assert "steal" in result["ring"] and "engine_dead" in result["ring"]
