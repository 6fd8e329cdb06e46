"""The port's store, job engine, leases, CSV inference and DSL against
the JAX package's (``store/``, ``jobs/``, ``services/dataset.py``,
``dsl.py``).

- stores: a WAL written by either package reopens in the other with equal
  documents, a torn final line included, and both refuse mid-file damage;
  the store, metadata and engine cases of the JAX package's own tests run
  on both packages as parametrised cases;
- metadata and ledger documents have the JAX field set; lineage walks
  agree;
- the engine's lifecycle, failure, stdout capture, cancel (queued and
  running), deadline expiry, weighted-fair order and bounded shutdown;
  the model and executor jobs lease a device, and an executor job's
  prints land in its execution document;
- leases serialize on an injected device list and are a no-op on a CPU
  context;
- ``_infer`` / ``_clean_header`` equal the JAX functions cell by cell;
- the ``#`` spec gate rejects the escape probes;
- ``fit`` honours a cancelled token at its next epoch boundary, as the
  JAX ``fit`` does.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from learningorchestra_tpu import dsl as jax_dsl
from learningorchestra_tpu.jobs import cancel as jax_cancel
from learningorchestra_tpu.jobs import engine as jax_engine
from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLP
from learningorchestra_tpu.services import dataset as jax_dataset
from learningorchestra_tpu.store import artifacts as jax_artifacts
from learningorchestra_tpu.store import document_store as jax_store
from learningorchestra_tpu.train import compile_cache as jax_compile_cache
from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs import cancel, engine
from learningorchestra_tpu_torch.jobs.leases import (
    DeviceLeaser,
    LeaseTimeout,
    placed,
)
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.services import dataset
from learningorchestra_tpu_torch.store import (
    artifacts,
    document_store,
    open_document_store,
)

PKGS = {
    "jax": (jax_store, jax_artifacts, jax_engine),
    "port": (document_store, artifacts, engine),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def store(pkg, tmp_path):
    s = pkg[0].DocumentStore(tmp_path / "db")
    yield s
    s.close()


@pytest.fixture
def arts(pkg, store):
    return pkg[1].ArtifactStore(store)


# -- stores -----------------------------------------------------------------


def _write_history(s):
    """One of each WAL op, over three collections."""
    s.insert_many("rows", ({"v": i, "s": f"r{i}"} for i in range(5)))
    s.insert_one("rows", {"v": None, "nested": {"a": [1, 2.5]}})
    s.update_one("rows", 2, {"v": 20, "extra": True})
    s.delete_one("rows", 3)
    assert s.compare_and_update("rows", 1, {"v": 1}, {"v": 10})
    assert not s.compare_and_update("rows", 1, {"v": 1}, {"v": 99})
    s.insert_unique("meta", {"name": "meta"}, _id=0)
    s.insert_one("gone", {"x": 1})
    s.drop("gone")
    s.insert_many("compacted", ({"v": i} for i in range(4)))
    s.delete_one("compacted", 3)
    s.compact("compacted")


def _snapshot(s):
    return {c: s.find(c) for c in s.list_collections()}


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_store_reopens_in_the_other_package(tmp_path, writer, reader):
    w = PKGS[writer][0].DocumentStore(tmp_path / "db")
    _write_history(w)
    want = _snapshot(w)
    w.close()
    # A torn final line: the record a crash cut mid-append.
    with open(tmp_path / "db" / "rows.wal", "a") as fh:
        fh.write('{"op": "i", "d": {"_id": 9, "v": ')
    r = PKGS[reader][0].DocumentStore(tmp_path / "db")
    assert _snapshot(r) == want
    # Both continue the id sequence past the compacted delete, on a clean
    # line after the truncated tail.
    assert r.insert_one("rows", {"v": 6}) == 6
    assert r.insert_one("compacted", {"v": 4}) == 4
    r.close()
    back = PKGS[writer][0].DocumentStore(tmp_path / "db")
    assert back.find_one("rows", 6) == {"v": 6, "_id": 6}
    assert back.count("compacted") == 4
    back.close()


def test_store_refuses_mid_file_damage(pkg, tmp_path):
    s = pkg[0].DocumentStore(tmp_path / "db")
    s.insert_many("c", ({"v": i} for i in range(3)))
    s.close()
    lines = (tmp_path / "db" / "c.wal").read_text().splitlines(True)
    lines.insert(1, "garbage\n")
    (tmp_path / "db" / "c.wal").write_text("".join(lines))
    with pytest.raises(pkg[0].CorruptWal):
        pkg[0].DocumentStore(tmp_path / "db")


def test_store_queries_and_counts(store):
    store.insert_one("c", {"meta": True}, _id=0)
    for i, f in enumerate(["a", "b", "a", "a"]):
        store.insert_one("c", {"f": f, "v": i})
    store.insert_one("c", {"docType": "execution", "f": "a"})
    assert store.aggregate_counts("c", "f") == {"a": 3, "b": 1}
    assert [d["v"] for d in store.find("c", {"v": {"$gte": 2}})] == [2, 3]
    assert [d["v"] for d in store.find("c", {"f": {"$in": ["b"]}})] == [1]
    assert store.count("c", {"docType": {"$ne": "execution"}}) == 5
    assert [d["_id"] for d in store.find("c", skip=1, limit=2)] == [1, 2]
    with pytest.raises(ValueError):
        store.insert_one("../evil", {})


def test_store_ids_are_atomic_and_unique(store, pkg):
    def worker():
        for _ in range(50):
            store.insert_one("c", {"x": 1})

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    ids = [d["_id"] for d in store.find("c")]
    assert sorted(ids) == list(range(400))
    with pytest.raises(pkg[0].DuplicateKey):
        store.insert_unique("c", {}, _id=7)


def test_open_document_store_backends(tmp_path, monkeypatch):
    from learningorchestra_tpu_torch import native

    s = open_document_store(tmp_path / "a", backend="python")
    s.insert_one("c", {"v": 1})
    s.close()
    # "auto" opens the python store's WAL with the native engine.
    auto = open_document_store(tmp_path / "a")
    assert isinstance(auto, native.NativeDocumentStore)
    assert auto.find("c")[0]["v"] == 1
    auto.close()
    with pytest.raises(ValueError, match="unknown store backend"):
        open_document_store(tmp_path / "b", backend="mongo")
    # A native library that cannot be built: "native" raises with the
    # compiler's output, "auto" opens the python store.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nb")
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-DLO_BREAK", "-include",
                                            str(tmp_path / "missing.h")))
    with pytest.raises(native.NativeBuildError, match="missing.h"):
        open_document_store(tmp_path / "b", backend="native")
    fallback = open_document_store(tmp_path / "b")
    assert type(fallback).__name__ == "DocumentStore"
    fallback.close()


# -- metadata and lineage ------------------------------------------------------


def _docs(pkg_name, tmp_path):
    store_mod, arts_mod, _ = PKGS[pkg_name]
    a = arts_mod.ArtifactStore(store_mod.DocumentStore(tmp_path / pkg_name))
    a.metadata.create("m", "model/tensorflow", module_path="zoo.x",
                      class_name="C")
    a.metadata.create("t", "train/tensorflow", parent_name="m",
                      method="fit", extra={"fields": ["a"]})
    a.metadata.create("p", "predict/tensorflow", parent_name="t")
    a.metadata.mark_running("t")
    a.metadata.mark_failed("t", "ValueError('x')")
    a.metadata.restart("t")
    a.metadata.mark_finished("t", {"fitTime": 1.0})
    a.ledger.record("t", description="d", method="fit",
                    parameters={"epochs": 1}, stdout="hi")
    a.ledger.record("t", state="failed", exception="E")
    out = {
        "meta": {n: a.metadata.read(n) for n in ("m", "t", "p")},
        "ledger": a.ledger.history("t"),
        "chain": [d["name"] for d in a.metadata.parent_chain("p")],
        "model": a.metadata.find_model_ancestor("p")["name"],
        "page": [d["_id"] for d in a.read_page("t", limit=2)],
        "types": sorted(d["name"] for d in a.list_by_type("train")),
    }
    a.documents.close()
    return out


def test_metadata_and_ledger_documents_match_jax(tmp_path):
    want, got = _docs("jax", tmp_path), _docs("port", tmp_path)
    for name in want["meta"]:
        assert set(got["meta"][name]) == set(want["meta"][name]), name
        for key, val in want["meta"][name].items():
            if key != "timeCreated":
                assert got["meta"][name][key] == val, (name, key)
    assert [set(d) for d in got["ledger"]] == \
        [set(d) for d in want["ledger"]]
    for key in ("chain", "model", "page", "types"):
        assert got[key] == want[key], key
    # Same timestamp format.
    assert len(got["meta"]["m"]["timeCreated"]) == \
        len(want["meta"]["m"]["timeCreated"])


@pytest.mark.parametrize("case", ["missing", "cycle"])
def test_lineage_errors(arts, pkg, case):
    if case == "missing":
        arts.metadata.create("t", "train/x", parent_name="ghost")
    else:
        arts.metadata.create("t", "train/x", parent_name="u")
        arts.metadata.create("u", "train/x", parent_name="t")
    with pytest.raises(pkg[1].LineageError):
        arts.metadata.parent_chain("t")
    with pytest.raises(pkg[1].DuplicateArtifact):
        arts.metadata.create("t", "train/x")


# -- the engine ----------------------------------------------------------------


@pytest.fixture
def eng(pkg, arts):
    e = pkg[2].JobEngine(arts, max_workers=4)
    yield e
    e.shutdown(wait=True, drain_timeout_s=2.0, grace_s=0.5)


def _wait_state(arts, name, states, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        meta = arts.metadata.read(name)
        if meta.get("jobState") in states:
            return meta
        time.sleep(0.01)
    raise AssertionError(f"{name}: {arts.metadata.read(name)}")


def test_engine_lifecycle_and_failure(arts, eng):
    release = threading.Event()
    arts.metadata.create("slow", "train/x")
    eng.submit("slow", lambda: release.wait(10) and 42, method="fit",
               parameters={"epochs": 1},
               on_success=lambda r: {"answer": r})
    assert arts.metadata.read("slow")["finished"] is False
    assert arts.metadata.read("slow")["requestParameters"] == {"epochs": 1}
    release.set()
    assert eng.wait("slow", timeout=10) == 42
    meta = arts.metadata.read("slow")
    assert (meta["jobState"], meta["finished"], meta["answer"]) == \
        ("finished", True, 42)

    def boom():
        raise ValueError("bad hyperparameter")

    arts.metadata.create("bad", "train/x")
    eng.submit("bad", boom)
    eng.wait("bad", timeout=10)
    meta = arts.metadata.read("bad")
    assert (meta["jobState"], meta["finished"]) == ("failed", False)
    assert "bad hyperparameter" in meta["exception"]
    assert "ValueError" in arts.ledger.history("bad")[-1]["exception"]
    # The engine still runs the next job.
    arts.metadata.create("next", "train/x")
    eng.submit("next", lambda: 1)
    assert eng.wait("next", timeout=10) == 1
    assert eng.state("next") == "finished"


def test_engine_captures_the_jobs_stdout_only(arts, eng):
    arts.metadata.create("chatty", "function/python")

    def chatty():
        print("hello from user code")
        return 1

    eng.submit("chatty", chatty, capture_stdout=True)
    eng.wait("chatty", timeout=10)
    assert "hello from user code" in \
        arts.ledger.history("chatty")[-1]["functionMessage"]


def test_engine_cancel_queued_and_running(arts, pkg):
    eng = pkg[2].JobEngine(arts, max_workers=1)
    token_seen = threading.Event()
    mod_cancel = jax_cancel if pkg[2] is jax_engine else cancel

    def cooperative():
        token_seen.set()
        while not mod_cancel.cancel_requested():
            time.sleep(0.01)
        return "partial"

    arts.metadata.create("run", "train/x")
    eng.submit("run", cooperative)
    arts.metadata.create("queued", "train/x")
    eng.submit("queued", lambda: 1)
    assert token_seen.wait(10)
    assert eng.cancel("queued") is True
    assert eng.cancel("run") == "running"
    eng.wait("run", timeout=10)
    assert _wait_state(arts, "run", {"cancelled"})["finished"] is False
    assert arts.metadata.read("queued")["jobState"] == "cancelled"
    assert eng.cancel("run") is False
    eng.shutdown()


def test_engine_deadline_flips_the_token(arts, pkg):
    eng = pkg[2].JobEngine(arts, max_workers=1)
    mod_cancel = jax_cancel if pkg[2] is jax_engine else cancel
    exited = threading.Event()

    def hangs():
        while not mod_cancel.cancel_requested():
            time.sleep(0.01)
        exited.set()

    arts.metadata.create("hung", "train/x")
    fut = eng.submit("hung", hangs, deadline_s=0.2)
    with pytest.raises(pkg[2].JobDeadlineExceeded):
        fut.result(timeout=10)
    assert exited.wait(10)  # the zombie saw its token and left
    meta = arts.metadata.read("hung")
    assert meta["jobState"] == "failed" and "deadline" in meta["exception"]
    # The reclaimed worker runs the next job.
    arts.metadata.create("after", "train/x")
    eng.submit("after", lambda: 2)
    assert eng.wait("after", timeout=10) == 2
    eng.shutdown()


def _contention(arts, pkg, weights):
    """One worker, a blocker, then 10 'function' and 10 'train' jobs: with
    a single worker the dispatch order IS the fairness policy."""
    eng = pkg[2].JobEngine(arts, max_workers=1, class_weights=weights)
    order: list[str] = []
    gate = threading.Event()
    arts.metadata.create("blocker", "function/python")
    eng.submit("blocker", gate.wait, job_class="function")
    time.sleep(0.05)
    for cls in ("function", "train"):
        for i in range(10):
            arts.metadata.create(f"{cls}{i}", f"{cls}/x")
            eng.submit(f"{cls}{i}", lambda c=cls: order.append(c),
                       job_class=cls)
    gate.set()
    eng.shutdown(wait=True)
    return order


@pytest.mark.parametrize("weights", [{}, {"function": 3, "train": 1}])
def test_engine_weighted_fair_order(arts, pkg, weights):
    order = _contention(arts, pkg, weights)
    if not weights:
        for n in range(2, 20, 2):
            assert abs(order[:n].count("train")
                       - order[:n].count("function")) <= 1, order
    else:
        assert order[:12].count("function") == 9, order


def test_engine_bounded_shutdown_abandons_a_stuck_body(arts, pkg):
    eng = pkg[2].JobEngine(arts, max_workers=1)
    stuck = threading.Event()
    arts.metadata.create("stuck", "train/x")
    eng.submit("stuck", lambda: stuck.wait(30))
    arts.metadata.create("never", "train/x")
    eng.submit("never", lambda: 1)
    time.sleep(0.05)
    t0 = time.monotonic()
    eng.shutdown(wait=True, drain_timeout_s=0.2, grace_s=0.1)
    assert time.monotonic() - t0 < 5
    assert arts.metadata.read("never")["jobState"] == "cancelled"
    with pytest.raises(RuntimeError):
        eng.submit("late", lambda: 1)
    stuck.set()


# -- leases ------------------------------------------------------------------


def test_leases_serialize_on_one_device():
    leaser = DeviceLeaser(device_ids=["cuda:0"])
    active, peak = [], []

    def job(i):
        with leaser.lease(1, label=f"job{i}") as devs:
            assert devs == ["cuda:0"]
            active.append(i)
            peak.append(len(active))
            time.sleep(0.02)
            active.remove(i)

    threads = [threading.Thread(target=job, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert max(peak) == 1
    spans = sorted((t0, t1) for _, _, t0, t1 in leaser.history)
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0 + 1e-6


def test_leases_two_devices_timeout_and_revoke():
    leaser = DeviceLeaser(device_ids=["cuda:0", "cuda:1"])
    with leaser.lease(1, label="a") as a, leaser.lease(1, label="b") as b:
        assert sorted(a + b) == ["cuda:0", "cuda:1"]
        with pytest.raises(LeaseTimeout):
            with leaser.lease(1, label="c", timeout=0.05):
                pass
        assert leaser.revoke("a") == a
        with leaser.lease(1, label="c", timeout=1) as c:
            assert c == a
    assert sorted(leaser._free) == ["cuda:0", "cuda:1"]


def test_leases_are_a_noop_on_a_cpu_context():
    leaser = DeviceLeaser(device="cpu")
    assert leaser.device_count == 0
    with leaser.lease(1, label="x") as devs, placed(devs):
        assert devs == []
        assert torch.zeros(1).device.type == "cpu"


# -- CSV inference -------------------------------------------------------------

CELLS = ["1", "-7", "+3", " 42 ", "9223372036854775807",
         "9223372036854775808", "-9223372036854775809", "1_000", "0x10",
         "1e3", "2.5", ".5", "-0.0", "nan", "NaN", "inf", "-Infinity", "",
         "   ", "abc", "1,5", "1.2.3", "True", "0X1F", "12a"]


def test_infer_and_clean_header_match_jax():
    for cell in CELLS:
        got, want = dataset._infer(cell), jax_dataset._infer(cell)
        assert type(got) is type(want) and (
            got == want or got != got and want != want), cell
    header = ["a b", " c-d ", "", "__", "x.y", "ok_1", "é"]
    assert dataset._clean_header(header) == \
        jax_dataset._clean_header(header)


# -- DSL ---------------------------------------------------------------------

PROBES = [
    'np.load("/etc/passwd")', 'np.fromfile("/x")', 'torch.load("/x")',
    'torch.from_file("/x")', 'torch.hub.list("x")', 'open("/etc/passwd")',
    'getattr(np, "lo" + "ad")', "np.ctypeslib", "().__class__",
    '__import__("os")', "[x for x in (1, 2)]", "lambda: 1", "unknownname",
    "jax.numpy.ones(2)", "jnp.ones(2)", "optax.adam(1e-3)", "nn.relu",
    # torch's code-loading and process-wide surface, and module globals.
    'torch.ops.load_library("/x.so")', 'torch.classes.load_library("/x")',
    'torch.cuda.memory._dump_snapshot("/x")', "torch._C",
    'torch.set_default_device("cpu")', "torch.set_default_dtype(torch.int)",
    "torch.jit", "torch.package", "torch.nn", "torch.ones(2)._cdata",
    'torch.ones(2).untyped_storage().from_file("/x")',
    "torch.ones(2).numpy().dumps()", "zoo.text.torch", "zoo.mlp.np",
    "MLPClassifier.load_state_dict", "np._core",
]


@pytest.mark.parametrize("expr", PROBES)
def test_dsl_escape_probes_rejected(expr):
    with pytest.raises(dsl.DSLResolutionError):
        dsl.evaluate_spec(expr)


class _Loader:
    def __init__(self, objs):
        self.objs = objs

    def load(self, name):
        if name not in self.objs:
            raise KeyError(name)
        return self.objs[name]


@pytest.mark.parametrize("mod", [jax_dsl, dsl], ids=["jax", "port"])
def test_dsl_dollar_and_spec_values(mod):
    loader = _Loader({"ds": {"col": [1, 2]}, "a.csv": "whole", "t": (5, 6)})
    assert mod.resolve_value("$ds.col", loader) == [1, 2]
    assert mod.resolve_value("$a.csv", loader) == "whole"
    assert mod.resolve_value("$t.1", loader) == 6
    assert mod.resolve_params(
        {"x": ["$t.0", {"k": "$ds"}], "n": 3}, loader
    ) == {"x": [5, {"k": {"col": [1, 2]}}], "n": 3}
    with pytest.raises(KeyError):
        mod.resolve_value("$missing", loader)
    with pytest.raises(mod.DSLResolutionError):
        mod.resolve_value("$ds.nope", loader)
    assert mod.evaluate_spec("np.float32") is np.float32
    assert mod.split_special_params({"a": 1, "b": 2}, ("a",)) == \
        ({"a": 1}, {"b": 2})


def test_dsl_spec_namespace_is_the_ports():
    assert float(dsl.evaluate_spec("torch.ones((2, 2)).sum()")) == 4.0
    assert dsl.evaluate_spec(
        "torch.tensor([1, 2], dtype=torch.int32)").dtype == torch.int32
    assert dsl.evaluate_spec("MLPClassifier") is MLPClassifier
    assert dsl.evaluate_spec("zoo.mlp.MLPClassifier") is MLPClassifier


# -- fit honours cancellation ---------------------------------------------


@pytest.mark.parametrize("side", ["jax", "port"])
def test_fit_stops_after_the_epoch_a_cancel_lands_in(side, request):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    if side == "jax":
        # The JAX fit compiles into the process-wide program cache: a later
        # file on this worker that fits the same program and counts its
        # compile span (tests/test_obs.py) would find it there.
        request.addfinalizer(jax_compile_cache.reset_cache)
        est, mod = JaxMLP(hidden_layer_sizes=(8,), num_classes=2), jax_cancel
    else:
        est = MLPClassifier(hidden_layer_sizes=(8,), num_classes=2,
                            device="cpu")
        mod = cancel
    token = mod.CancelToken()
    seen = {}

    def cancel_after_second(epoch, metrics, model):
        if epoch == 1:
            seen["params"] = json.dumps(_params_of(model, side))
            token.cancel("test")

    with mod.bind(token):
        est.fit(x, y, epochs=6, batch_size=16, callbacks=[
            cancel_after_second])
    assert len(est.history["loss"]) == 2
    assert json.dumps(_params_of(est, side)) == seen["params"]
    assert est.stop_training


def _params_of(est, side):
    if side == "jax":
        import jax

        return [np.asarray(v).tolist()
                for v in jax.tree_util.tree_leaves(est.params)]
    return [p.detach().tolist() for p in est.module.parameters()]


# -- registry and config --------------------------------------------------


@pytest.mark.parametrize("module_path,cls", [
    ("learningorchestra_tpu.models.text", "BertModel"),
    ("learningorchestra_tpu.models.mlp", "MLPClassifier"),
    ("learningorchestra_tpu.models.vision", "MnistCNN"),
    ("tensorflow.keras.applications", "ResNet50"),
    ("tensorflow.keras.models", "BertModel"),
    ("torch.nn", "LSTMClassifier"),
    ("learningorchestra_tpu_torch.models.text", "BertModel"),
])
def test_registry_aliases_resolve_to_the_port_zoo(module_path, cls):
    from learningorchestra_tpu_torch.toolkit import registry

    factory = registry.resolve(module_path, cls)
    assert factory.__name__ == cls
    assert factory.__module__.startswith("learningorchestra_tpu_torch.")


def test_registry_refuses_classical_estimators_and_device_params():
    from learningorchestra_tpu_torch.toolkit import registry

    # The classical estimators are ported: sklearn paths resolve to them.
    factory = registry.resolve("sklearn.linear_model", "LogisticRegression")
    assert factory.__module__ == \
        "learningorchestra_tpu_torch.toolkit.estimators.linear"
    with pytest.raises(registry.RegistryError):
        registry.resolve("learningorchestra_tpu.models.text", "Nope")
    assert registry.validate_init_params(
        "torch.nn", "BertModel", {"max_len": 8, "device": "cpu"}
    ) == ["device"]
    assert registry.validate_method(MLPClassifier, "fit")
    assert not registry.validate_method(MLPClassifier, "nope")


def test_config_reads_the_jax_store_and_job_env_names():
    from learningorchestra_tpu_torch.config import Config

    cfg = Config.from_env({
        "LO_TPU_STORE_ROOT": "/s", "LO_TPU_STORE_BACKEND": "python",
        "LO_TPU_MAX_WORKERS": "3", "LO_TPU_JOB_WEIGHTS": '{"train": 2}',
        "LO_TPU_JOB_DEADLINE_S": "9", "LO_TPU_JOB_DRAIN_S": "4",
    })
    assert (cfg.store.root, cfg.store.backend, cfg.jobs.max_workers,
            cfg.jobs.class_weights, cfg.jobs.deadline_s,
            cfg.jobs.shutdown_drain_s) == (
        "/s", "python", 3, {"train": 2}, 9.0, 4.0)
    default = Config.from_env({})
    assert default.device == "cuda"
    assert default.store.root.startswith("~/.learningorchestra_tpu_torch")


def test_entry_points_default_to_the_card(tmp_path):
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import Config, StoreConfig
    from learningorchestra_tpu_torch.services import ServiceContext

    cfg = Config(store=StoreConfig(root=str(tmp_path / "s"),
                                   volume_root=str(tmp_path / "v")))
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs")
    for entry in (ServiceContext, APIServer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(cfg)


def test_model_and_executor_jobs_lease_and_record_prints(tmp_path,
                                                          monkeypatch):
    from learningorchestra_tpu_torch.config import Config, StoreConfig
    from learningorchestra_tpu_torch.services import ServiceContext
    from learningorchestra_tpu_torch.services.executor import (
        ExecutorService,
    )
    from learningorchestra_tpu_torch.services.model import ModelService

    real_fit = MLPClassifier.fit

    def chatty_fit(self, *args, **kwargs):
        print("epoch report from the estimator")
        return real_fit(self, *args, **kwargs)

    monkeypatch.setattr(MLPClassifier, "fit", chatty_fit)
    ctx = ServiceContext(Config(store=StoreConfig(
        root=str(tmp_path / "s"), volume_root=str(tmp_path / "v"))),
        device="cpu")
    # An injected device list: leases are taken and audited, and the
    # bodies run in place (only ``cuda:k`` ids switch the device).
    ctx.leaser = DeviceLeaser(["dev:0"])
    try:
        ModelService(ctx).create(
            "mlp", module_path="learningorchestra_tpu.models.mlp",
            class_name="MLPClassifier",
            class_parameters={"hidden_layer_sizes": [4]})
        ctx.engine.wait("mlp", timeout=30)
        ExecutorService(ctx).create(
            "fitted", parent_name="mlp", method="fit",
            method_parameters={"x": "#np.ones((8, 3))",
                               "y": "#np.zeros(8, dtype=np.int32)",
                               "epochs": 1, "batch_size": 4})
        ctx.engine.wait("fitted", timeout=60)
        assert ctx.artifacts.metadata.read("fitted")["jobState"] == \
            "finished"
        assert [h[0] for h in ctx.leaser.history] == ["mlp", "fitted"]
        assert ctx.artifacts.ledger.history("fitted")[-1][
            "functionMessage"] == "epoch report from the estimator\n"
        # The model job ran no user code that printed: no stdout field.
        assert "functionMessage" not in \
            ctx.artifacts.ledger.history("mlp")[-1]
    finally:
        ctx.engine.shutdown()
