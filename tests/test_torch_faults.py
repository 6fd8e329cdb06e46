"""The port's fault-injection plane (faults/plane.py) held against the JAX
package's: the same schedule spec and seed give the same trigger pattern
over 1,000 hits, ``parse_spec`` gives the same results and errors, the
same environment arms the same status, and the trigger counter renders
the same Prometheus text.  Every fault point the port wires fires at its
call site.  Then the drill of the JAX ``tests/test_faults.py``
(``TestTrainChaos``): a 6-epoch fit preempted entering epoch 3 resumes on
attempt 2 from its checkpoint, with the JAX weights carried in; its
history and final parameters match the JAX drill's (f32 5e-5) and an
unfaulted port fit's, and its trace has one ``job`` span per attempt."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from learningorchestra_tpu import faults as jfaults
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu.obs import metrics as jmetrics
from learningorchestra_tpu.services.context import (
    ServiceContext as JaxContext,
)
from learningorchestra_tpu.services.executor import (
    ExecutorService as JaxExecutor,
)
from learningorchestra_tpu.services.model import ModelService as JaxModels
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, ServeConfig, StoreConfig
from learningorchestra_tpu_torch.jobs.engine import JobEngine, Preempted
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.models.text import DecoderLM
from learningorchestra_tpu_torch.obs import metrics
from learningorchestra_tpu_torch.serve.fleet.router import P2CRouter
from learningorchestra_tpu_torch.serve.service import ServingService
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.executor import ExecutorService
from learningorchestra_tpu_torch.services.model import ModelService
from learningorchestra_tpu_torch.store.artifacts import ArtifactStore
from learningorchestra_tpu_torch.store.document_store import DocumentStore
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.train import aot_store
from learningorchestra_tpu_torch.train import compile_cache as cc

TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def _clean_planes():
    """Both planes and registries are process-wide: each test starts and
    ends with nothing armed and fresh counters."""
    for mod in (faults, jfaults):
        mod.reset()
    metrics.reset_registry()
    jmetrics.reset_registry()
    try:
        yield
    finally:
        for mod in (faults, jfaults):
            mod.disarm_all()
            mod.reset()
        metrics.reset_registry()
        jmetrics.reset_registry()


# -- schedules, specs, status ------------------------------------------------

SCHEDULES = [
    ("serve.apply", dict(mode="error")),
    ("train.epoch", dict(mode="preempt", rate=0.3, seed=7)),
    ("store.wal_write", dict(mode="delay", rate=0.01, seed=1, after=100)),
    ("engine.dispatch", dict(mode="error", rate=0.5, seed=7,
                             max_triggers=2)),
    ("http.handler", dict(mode="error", rate=0.9, seed=123, after=3,
                          max_triggers=40)),
]


@pytest.mark.parametrize("point,kw", SCHEDULES,
                         ids=[p for p, _ in SCHEDULES])
def test_trigger_pattern_matches_jax_over_1000_hits(point, kw):
    kw = dict(kw)
    mode = kw.pop("mode")
    ours = faults.FaultSchedule(point, mode, **kw)
    theirs = jfaults.FaultSchedule(point, mode, **kw)
    a = [ours.should_fire() for _ in range(1000)]
    b = [theirs.should_fire() for _ in range(1000)]
    assert a == b
    assert ours.to_doc() == theirs.to_doc()


SPECS = [
    "preempt:rate=0.5,seed=7,max=2",
    "delay:ms=50",
    "error:rate=0.01,seed=1,after=100",
    " ERROR : rate=1 ",
    "preempt",
    "bogus",
    "delay:ms",
    "delay:nope=3",
    "error:rate=x",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    def outcome(mod):
        try:
            return ("ok", mod.parse_spec(spec))
        except Exception as exc:  # noqa: BLE001 — compared by type
            return ("error", type(exc).__name__)

    assert outcome(faults) == outcome(jfaults)


def test_env_arming_and_status_match_jax():
    env = {"LO_TPU_FAULT_ENGINE_DISPATCH": "preempt:rate=0.5,seed=7,max=2",
           "LO_TPU_FAULT_STORE_WAL_WRITE": "error:rate=0.01,seed=1,after=9",
           "LO_TPU_FAULT_SERVE_APPLY": "delay:ms=5",
           "UNRELATED": "x"}
    assert sorted(faults.load_env(env)) == sorted(jfaults.load_env(env))
    assert faults.status() == jfaults.status()
    assert faults.points() == jfaults.points()
    with pytest.raises(ValueError):
        faults.load_env({faults.ENV_PREFIX + "NO_SUCH_POINT": "error"})
    faults.disarm_all()
    jfaults.disarm_all()
    assert faults.status() == jfaults.status()


def test_trigger_counter_renders_like_jax():
    for mod in (faults, jfaults):
        mod.arm("serve.route", "error", max_triggers=2)
        mod.arm("store.wal_write", "delay", delay_ms=0.0, after=1)
        for point in ("serve.route",) * 3 + ("store.wal_write",) * 3:
            try:
                mod.hit(point)
            except mod.FaultInjected:
                pass
    assert faults.triggers("serve.route") == 2
    assert faults.triggers("store.wal_write") == 2
    assert metrics.get_registry().render_prometheus() == \
        jmetrics.get_registry().render_prometheus()
    assert faults.status() == jfaults.status()


def test_disabled_hit_changes_nothing():
    for point in faults.points():
        faults.hit(point)
    assert not faults.status()["enabled"]
    assert all(p["hits"] == 0 for p in faults.status()["points"].values())


# -- every port fault point at its call site --------------------------------


def _mlp(**kw):
    est = MLPClassifier(hidden_layer_sizes=[4], num_classes=2, seed=0,
                        device="cpu", **kw)
    est.compute_dtype = "float32"
    return est


def _xy(n=32):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


def _engine_dispatch(tmp_path):
    store = DocumentStore(tmp_path / "store")
    artifacts = ArtifactStore(store)
    engine = JobEngine(artifacts, retry_backoff_s=0.0)
    try:
        artifacts.metadata.create("job", "function/python")
        faults.arm("engine.dispatch", "preempt", max_triggers=1)
        engine.submit("job", lambda: 7)
        assert engine.wait("job", timeout=30) == 7
        meta = artifacts.metadata.read("job")
        assert meta["jobState"] == "finished" and meta["preemptions"] == 1
    finally:
        engine.shutdown()
        store.close()


def _lease_acquire(tmp_path):
    leaser = DeviceLeaser(["cuda:7"], device="cpu")
    faults.arm("lease.acquire", "error", max_triggers=1)
    with pytest.raises(faults.FaultInjected):
        with leaser.lease(1, label="j"):
            pass
    with leaser.lease(1, label="j") as devs:
        assert devs == ["cuda:7"]


def _compile_build(tmp_path):
    cache = cc.reset_cache()
    try:
        faults.arm("compile.build", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            cache.get_or_build("k", lambda: 1, label="p")
        assert cache.get_or_build("k", lambda: 2, label="p") == 2
        assert cache.get_or_build("k", lambda: 3, label="p") == 2  # a hit
        assert cache.stats()["misses"] == 1
    finally:
        cc.reset_cache()


def _store_wal_write(tmp_path):
    store = DocumentStore(tmp_path / "store")
    try:
        store.insert_one("c", {"a": 1})
        faults.arm("store.wal_write", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            store.insert_one("c", {"a": 2})
        store.insert_many("c", [{"a": 3}, {"a": 4}])
    finally:
        store.close()


def _serve_apply(tmp_path):
    vols = VolumeStorage(tmp_path / "volumes")
    est = _mlp()
    x, y = _xy()
    est.fit(x, y, epochs=1, batch_size=8)
    vols.save_estimator("train/tensorflow", "m", est)
    svc = ServingService(vols, ServeConfig(flush_ms=0), device="cpu")
    try:
        faults.arm("serve.apply", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            svc.predict("m", x[:2].tolist())
        out = svc.predict("m", x[:2].tolist())
        np.testing.assert_allclose(out["predictions"], est.predict(x[:2]),
                                   atol=1e-6)
    finally:
        svc.close()


def _serve_route(tmp_path):
    router = P2CRouter(seed=0)
    faults.arm("serve.route", "error", max_triggers=1)
    with pytest.raises(faults.FaultInjected):
        router.choose([0, 1, 2])
    assert sorted(router.choose([0, 1, 2])) == [0, 1, 2]


def _serve_decode_step(tmp_path):
    vols = VolumeStorage(tmp_path / "volumes")
    lm = DecoderLM(vocab_size=16, hidden_dim=16, num_layers=1, num_heads=2,
                   max_len=16, seed=0, device="cpu")
    lm.compute_dtype = "float32"
    rng = np.random.default_rng(1)
    x = rng.integers(1, 16, (4, 8)).astype(np.int32)
    lm.fit(x, np.roll(x, -1, 1), epochs=1, batch_size=4)
    vols.save_estimator("train/pytorch", "lm", lm)
    svc = ServingService(vols, ServeConfig(flush_ms=0), device="cpu")
    try:
        faults.arm("serve.decode_step", "error", max_triggers=1)
        with pytest.raises(Exception, match="decode step failed"):
            svc.generate("lm", [[2, 3, 4]], max_new_tokens=3)
        out = svc.generate("lm", [[2, 3, 4]], max_new_tokens=3)
        assert out["tokens"] == lm.generate(
            np.asarray([[2, 3, 4]], np.int32), max_new_tokens=3).tolist()
    finally:
        svc.close()


def _http_handler(tmp_path):
    srv = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "store"),
        volume_root=str(tmp_path / "volumes"))), device="cpu")
    try:
        faults.arm("http.handler", "error", max_triggers=1)
        status, payload = srv.handle("GET", srv.router.prefix + "/health",
                                     {}, {})
        assert status == 500 and "injected fault" in payload["error"]
        assert srv.handle("GET", srv.router.prefix + "/health",
                          {}, {})[0] == 200
    finally:
        srv.shutdown()


def _train_epoch(tmp_path):
    est = _mlp()
    x, y = _xy()
    faults.arm("train.epoch", "preempt", after=1, max_triggers=1)
    with pytest.raises(Preempted):
        est.fit(x, y, epochs=3, batch_size=8)
    assert len(est.history["loss"]) == 1


def _cache_aot_load(tmp_path):
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    try:
        store.offer("k", {"fn": "x"}, label="p")
        faults.arm("cache.aot_load", "error", max_triggers=1)
        assert store.load("k") is None
        assert store.stats()["loadErrors"] == 1
    finally:
        aot_store.reset_store()


def _cache_aot_store(tmp_path):
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    try:
        faults.arm("cache.aot_store", "error", max_triggers=1)
        assert store.offer("k", {"fn": "x"}, label="p") is False
        assert store.stats()["storeErrors"] == 1
        assert store.offer("k", {"fn": "x"}, label="p") is True
    finally:
        aot_store.reset_store()


def _replica_wal_ship(tmp_path):
    from learningorchestra_tpu_torch.store.replica import WalReplica

    store = DocumentStore(tmp_path / "primary")
    store.insert_one("c", {"a": 1})
    try:
        replica = WalReplica(str(tmp_path / "primary"), tmp_path / "replica")
        faults.arm("replica.wal_ship", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            replica.sync()
        assert replica.sync() == {
            "c": (tmp_path / "primary" / "c.wal").stat().st_size}
        assert replica.lag_bytes() == 0
        assert replica.find("c")[0]["a"] == 1
    finally:
        store.close()


def _store_ha_failover(tmp_path):
    from learningorchestra_tpu_torch.store import ha

    DocumentStore(tmp_path / "primary").close()
    monitor = ha.StandbyMonitor("127.0.0.1:9", str(tmp_path / "primary"),
                                tmp_path / "replica")
    faults.arm("store.ha.failover", "error", max_triggers=1)
    with pytest.raises(faults.FaultInjected):
        monitor.promote()
    # Promotion is idempotent: nothing landed, the retry promotes.
    assert ha.promotion_record(tmp_path / "replica") is None
    monitor.promote()
    assert ha.read_epoch(tmp_path / "replica") == 1


def _cluster_coordinator(tmp_path):
    from learningorchestra_tpu_torch.jobs.cluster import ClusterCoordinator

    store = DocumentStore(tmp_path / "store")
    return store, ClusterCoordinator(store, store.root, engine_id="A",
                                     heartbeat_s=30, ttl_s=60, sweep_s=30)


def _cluster_claim(tmp_path):
    store, coord = _cluster_coordinator(tmp_path)
    try:
        faults.arm("cluster.claim", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            coord.claim("j")
        assert coord.claim("j") is True
    finally:
        coord.close()
        store.close()


def _cluster_heartbeat(tmp_path):
    store, coord = _cluster_coordinator(tmp_path)
    try:
        faults.arm("cluster.heartbeat", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            coord.heartbeat()
        assert coord.claim("j") is True and coord.heartbeat() == 1
    finally:
        coord.close()
        store.close()


def _cluster_steal(tmp_path):
    from learningorchestra_tpu_torch.jobs.cluster import ClusterCoordinator

    store, dead = _cluster_coordinator(tmp_path)
    other = DocumentStore(tmp_path / "store")
    thief = ClusterCoordinator(other, other.root, engine_id="B",
                               heartbeat_s=30, ttl_s=0.05, sweep_s=30)
    try:
        assert dead.claim("j") is True
        time.sleep(0.12)
        faults.arm("cluster.steal", "error", max_triggers=1)
        with pytest.raises(faults.FaultInjected):
            thief.sweep()
        # The claim stays with the dead owner; the next sweep takes it.
        assert thief.sweep() == [("j", "A")]
    finally:
        for c in (dead, thief):
            c.close()
        store.close()
        other.close()


CALL_SITES = {
    "engine.dispatch": _engine_dispatch,
    "lease.acquire": _lease_acquire,
    "compile.build": _compile_build,
    "store.wal_write": _store_wal_write,
    "serve.apply": _serve_apply,
    "serve.route": _serve_route,
    "serve.decode_step": _serve_decode_step,
    "http.handler": _http_handler,
    "train.epoch": _train_epoch,
    "cache.aot_load": _cache_aot_load,
    "cache.aot_store": _cache_aot_store,
    "replica.wal_ship": _replica_wal_ship,
    "store.ha.failover": _store_ha_failover,
    "cluster.claim": _cluster_claim,
    "cluster.heartbeat": _cluster_heartbeat,
    "cluster.steal": _cluster_steal,
}


@pytest.mark.parametrize("point", sorted(CALL_SITES))
def test_each_port_point_fires_at_its_call_site(point, tmp_path):
    CALL_SITES[point](tmp_path)
    assert faults.triggers(point) == 1
    assert faults.status()["points"][point]["triggers"] == 1


def test_unported_points_are_the_jax_control_plane_ones():
    """Every registered point has a call site in the port (the control
    plane's five since store/ha.py, store/replica.py and jobs/cluster.py
    were ported), each driven above, and the registry is the JAX one."""
    from learningorchestra_tpu.faults import plane as jax_plane

    assert set(faults.POINTS) == set(CALL_SITES)
    assert set(faults.POINTS) == set(jax_plane.POINTS)


# -- the preemption drill ----------------------------------------------------


def _drill_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


FIT = {"epochs": 6, "checkpoint_every": 1, "checkpoint_min_interval_s": 0,
       "checkpoint_async": False, "batch_size": 8, "shuffle": False}
MLP = {"hidden_layer_sizes": [4], "num_classes": 2}


def _jax_drill(tmp_path, x, y):
    cfg = JaxConfig()
    cfg.store.backend = "python"
    cfg.store.root = str(tmp_path / "jax" / "store")
    cfg.store.volume_root = str(tmp_path / "jax" / "volumes")
    cfg.jobs.retry_backoff_s = 0.01
    cfg.jobs.retry_backoff_max_s = 0.05
    ctx = JaxContext(cfg)
    try:
        JaxModels(ctx).create(
            "chaos_mlp", module_path="learningorchestra_tpu.models.mlp",
            class_name="MLPClassifier", class_parameters=MLP)
        ctx.engine.wait("chaos_mlp", timeout=60)
        jest = ctx.volumes.read_object("model/tensorflow", "chaos_mlp")
        jest.compute_dtype = "float32"
        jest._init_params(jnp.asarray(x[:1]))
        ctx.volumes.save_object("model/tensorflow", "chaos_mlp", jest)
        init = jax.tree_util.tree_map(np.asarray, jest.params)
        jfaults.arm("train.epoch", "preempt", after=3, max_triggers=1)
        JaxExecutor(ctx).create(
            "chaos_fit", parent_name="chaos_mlp", method="fit",
            method_parameters={"x": x.tolist(), "y": y.tolist(), **FIT},
            artifact_type="train/tensorflow")
        ctx.engine.wait("chaos_fit", timeout=300)
        meta = ctx.artifacts.metadata.read("chaos_fit")
        assert meta["jobState"] == "finished", meta.get("exception")
        assert meta["preemptions"] == 1 and jfaults.triggers(
            "train.epoch") == 1
        fitted = ctx.volumes.read_object("train/tensorflow", "chaos_fit")
        return init, dict(fitted.history), jax.tree_util.tree_map(
            np.asarray, fitted.params)
    finally:
        ctx.close()


def _port_fit(tmp_path, x, y, init, *, preempt: bool):
    side = "port_chaos" if preempt else "port_clean"
    cfg = Config(store=StoreConfig(root=str(tmp_path / side / "store"),
                                   volume_root=str(tmp_path / side /
                                                   "volumes")))
    cfg.jobs.retry_backoff_s = 0.01
    cfg.jobs.retry_backoff_max_s = 0.05
    ctx = ServiceContext(cfg, device="cpu")
    try:
        ModelService(ctx).create(
            "chaos_mlp", module_path="learningorchestra_tpu.models.mlp",
            class_name="MLPClassifier", class_parameters=MLP)
        ctx.engine.wait("chaos_mlp", timeout=60)
        pest = ctx.volumes.load_estimator("model/tensorflow", "chaos_mlp",
                                          device="cpu")
        pest.load_state_dict({"params": init})
        pest.compute_dtype = "float32"
        ctx.volumes.save_estimator("model/tensorflow", "chaos_mlp", pest)
        if preempt:
            faults.arm("train.epoch", "preempt", after=3, max_triggers=1)
        ExecutorService(ctx).create(
            "chaos_fit", parent_name="chaos_mlp", method="fit",
            method_parameters={"x": x.tolist(), "y": y.tolist(), **FIT},
            artifact_type="train/tensorflow")
        ctx.engine.wait("chaos_fit", timeout=300)
        meta = ctx.artifacts.metadata.read("chaos_fit")
        assert meta["jobState"] == "finished", meta.get("exception")
        hist = ctx.artifacts.ledger.history("chaos_fit")
        fitted = ctx.volumes.load_estimator("train/tensorflow", "chaos_fit",
                                            device="cpu")
        return meta, hist, fitted
    finally:
        ctx.close()


def test_preempted_fit_resumes_from_checkpoint_and_matches_jax(tmp_path):
    from learningorchestra_tpu_torch import convert

    x, y = _drill_data()
    init, jhist, jparams = _jax_drill(tmp_path, x, y)
    meta, hist, fitted = _port_fit(tmp_path, x, y, init, preempt=True)
    assert meta["preemptions"] == 1 and faults.triggers("train.epoch") == 1
    states = [h["state"] for h in hist]
    assert states.count("preempted") == 1 and states[-1] == "finished"
    spans = next(r["trace"] for r in reversed(hist) if r.get("trace"))[
        "spans"]
    by_id = {s["id"]: s for s in spans}

    def attempt_of(span):
        while span is not None:
            if span["name"] == "job":
                return span["attrs"]["attempt"]
            span = by_id.get(span.get("parent"))
        return None

    assert [s["attrs"]["attempt"] for s in spans if s["name"] == "job"] \
        == [1, 2]
    assert len([s for s in spans if s["name"] == "retry_backoff"]) == 1
    epochs: dict = {}
    for s in spans:
        if s["name"] == "epoch":
            epochs.setdefault(attempt_of(s), []).append(s["attrs"]["epoch"])
    # Attempt 2 resumed at epoch 3: a restart would log epoch 0 again.
    assert epochs == {1: [0, 1, 2], 2: [3, 4, 5]}
    # History and parameters: the JAX drill's, and an unfaulted fit's.
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(fitted.history[key], jhist[key], **TOL)
    ours = convert.params_to_jax(fitted.module)
    for u, v in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(ours)):
        np.testing.assert_allclose(np.asarray(v), u, **TOL)
    _, _, clean = _port_fit(tmp_path, x, y, init, preempt=False)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(fitted.history[key], clean.history[key],
                                   **TOL)
    for u, v in zip(jax.tree_util.tree_leaves(
            convert.params_to_jax(clean.module)),
            jax.tree_util.tree_leaves(ours)):
        np.testing.assert_allclose(np.asarray(v), np.asarray(u), **TOL)


def test_exhausted_retries_fail_the_job_and_ask_for_a_bundle(tmp_path):
    store = DocumentStore(tmp_path / "store")
    artifacts = ArtifactStore(store)
    engine = JobEngine(artifacts, max_preemption_retries=2,
                       retry_backoff_s=0.0)
    try:
        artifacts.metadata.create("job", "function/python")

        def body():
            raise Preempted("always")

        engine.submit("job", body)
        engine.wait("job", timeout=30)
        meta = artifacts.metadata.read("job")
        assert meta["jobState"] == "failed"
        assert "retries exhausted" in meta["exception"]
        states = [h["state"] for h in artifacts.ledger.history("job")]
        assert states == ["preempted"] * 3
        assert artifacts.ledger.history("job")[-1]["trace"]["spans"]
    finally:
        engine.shutdown()
        store.close()


def _tune(tmp_path, side, x, y, *, preempt):
    cfg = Config(store=StoreConfig(root=str(tmp_path / side / "store"),
                                   volume_root=str(tmp_path / side /
                                                   "volumes")))
    cfg.jobs.retry_backoff_s = 0.01
    ctx = ServiceContext(cfg, device="cpu")
    try:
        ModelService(ctx).create(
            "mlp", module_path="learningorchestra_tpu.models.mlp",
            class_name="MLPClassifier", class_parameters=MLP)
        ctx.engine.wait("mlp", timeout=60)
        if preempt:
            faults.arm("train.epoch", "preempt", after=2, max_triggers=1)
        ExecutorService(ctx).create_tune(
            "grid", parent_name="mlp",
            param_grid={"seed": [1, 2], "hidden_layer_sizes": [[4]]},
            method_parameters={"x": x.tolist(), "y": y.tolist(),
                               "epochs": 3, "batch_size": 8,
                               "shuffle": False, "checkpoint_every": 1,
                               "checkpoint_min_interval_s": 0,
                               "checkpoint_async": False})
        ctx.engine.wait("grid", timeout=300)
        meta = ctx.artifacts.metadata.read("grid")
        assert meta["jobState"] == "finished", meta.get("exception")
        rows = ctx.documents.find("grid", query={})
        scores = sorted((r["params"]["seed"], r["score"]) for r in rows
                        if "score" in r)
        return meta, scores, faults.status()["points"]["train.epoch"]
    finally:
        ctx.close()


def test_preempted_tune_resumes_every_trial_checkpoint(tmp_path):
    """The engine retries a tune whose trial was preempted: attempt 2
    resumes each trial's checkpoint, so every epoch of the 2 x 3 starts
    once (6 hits, plus the one that preempted), and the trials score as
    an unfaulted tune's do."""
    x, y = _drill_data()
    meta, scores, hits = _tune(tmp_path, "chaos", x, y, preempt=True)
    assert meta["preemptions"] == 1 and hits["triggers"] == 1
    assert hits["hits"] == 2 * 3 + 1
    faults.reset()
    _, clean, _ = _tune(tmp_path, "clean", x, y, preempt=False)
    assert [s for s, _ in scores] == [s for s, _ in clean] == [1, 2]
    np.testing.assert_allclose([v for _, v in scores],
                               [v for _, v in clean], **TOL)
