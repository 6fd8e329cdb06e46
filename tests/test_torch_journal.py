"""The port's job journal (``jobs/journal.py``) and the engine's use of it,
against the JAX package's, on the CPU.

One drive runs on a JAX ``JobEngine`` and on a port ``JobEngine``, each
with a ``JobJournal`` over a fresh store and one worker, so the order of
every record is fixed: a job that finishes, one that fails, one past its
deadline, one cancelled while queued (behind a blocker) and one cancelled
while running.  Held to: the same journal records (job, event, spec,
attempt, reason; timestamps aside, and the deadline's reason names "chip
leases" on the JAX side where the port's says "device leases"),
the same ``replay()``, and each package replaying the other's journal
into the same dict.  Also: ``prune`` keeps live jobs and bounds terminal
ones on both, epochs mint monotonically across both packages over one
store root, and a stale stamp's terminal commit and artifact publication
are refused with ``StaleEpochError``, as in
``tests/test_journal_recovery.py::TestEpochFencing``.
"""

import json
import threading
import time
from concurrent import futures

import pytest

from learningorchestra_tpu.jobs import JobEngine as JaxEngine
from learningorchestra_tpu.jobs import JobJournal as JaxJournal
from learningorchestra_tpu.jobs import cancel as jax_cancel
from learningorchestra_tpu.store import ArtifactStore as JaxArtifacts
from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.jobs import cancel as port_cancel
from learningorchestra_tpu_torch.jobs import journal as port_journal
from learningorchestra_tpu_torch.jobs.engine import JobEngine
from learningorchestra_tpu_torch.jobs.journal import (
    JOURNAL_COLLECTION,
    JobJournal,
    StaleEpochError,
    read_engine_epoch,
    write_engine_epoch,
)
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.store import ArtifactStore, DocumentStore

PACKAGES = {
    "jax": (JaxStore, JaxArtifacts, JaxJournal, JaxEngine, jax_cancel),
    "port": (DocumentStore, ArtifactStore, JobJournal, JobEngine,
             port_cancel),
}


def _same_words(tree):
    """The JAX deadline reason's "chip leases" read as the port's."""
    return json.loads(json.dumps(tree).replace("chip leases",
                                               "device leases"))


def _wait_state(arts, name, state, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if arts.metadata.read(name)["jobState"] == state:
            return
        time.sleep(0.01)
    raise AssertionError(f"{name} never reached {state}: "
                         f"{arts.metadata.read(name)}")


def _drive(root, package):
    """The five lives, one after another on one worker; returns the
    journal's records (timestamps dropped) and its replay."""
    store_cls, arts_cls, journal_cls, engine_cls, jc = PACKAGES[package]
    store = store_cls(root)
    arts = arts_cls(store)
    journal = journal_cls(store, root)
    eng = engine_cls(arts, max_workers=1)
    eng.journal = journal
    try:
        arts.metadata.create("ok", "function/python")
        eng.submit("ok", lambda: 1, job_class="f",
                   method="run").result(timeout=10)
        arts.metadata.create("bad", "function/python")
        assert eng.submit("bad", lambda: 1 / 0,
                          job_class="f").result(timeout=10) is None
        arts.metadata.create("late", "function/python")
        late = eng.submit("late",
                          lambda: jc.current_cancel_token().wait(30),
                          job_class="f", deadline_s=0.2)
        # The body exits once the expiry flips its token, racing the
        # watchdog's JobDeadlineExceeded: the journal is the contract.
        futures.wait([late], timeout=10)
        _wait_state(arts, "late", "failed")
        # Cancelled while queued, behind a blocker on the one worker.
        gate = threading.Event()
        arts.metadata.create("blk", "function/python")
        blk = eng.submit("blk", gate.wait, job_class="f")
        arts.metadata.create("victim", "function/python")
        eng.submit("victim", lambda: 1, job_class="f")
        assert eng.cancel("victim") is True
        gate.set()
        blk.result(timeout=10)
        # Cancelled while running: the body winds down at the token.
        started = threading.Event()

        def body():
            started.set()
            while not jc.cancel_requested():
                time.sleep(0.005)
            return "partial"

        arts.metadata.create("run", "function/python")
        frun = eng.submit("run", body, job_class="f")
        assert started.wait(10)
        assert eng.cancel("run") == "running"
        assert frun.result(timeout=10) is None
        _wait_state(arts, "run", "cancelled")
        eng.shutdown(wait=True)
        journal.flush()
        records = [
            {k: v for k, v in d.items() if k != "at"}
            for d in store.find(JOURNAL_COLLECTION)
        ]
        meta = {n: arts.metadata.read(n) for n in
                ("ok", "bad", "late", "blk", "victim", "run")}
        return _same_words(records), _same_words(journal.replay()), meta
    finally:
        eng.shutdown(wait=False)
        journal.close()
        store.close()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {pkg: tmp_path_factory.mktemp(pkg) for pkg in PACKAGES}


@pytest.fixture(scope="module")
def driven(roots):
    return {pkg: _drive(root, pkg) for pkg, root in roots.items()}


def test_drive_journals_the_same_records(driven):
    port, jax = driven["port"][0], driven["jax"][0]
    assert port == jax
    by_job = {}
    for rec in port:
        by_job.setdefault(rec["job"], []).append(rec["event"])
    assert by_job == {
        "ok": ["submitted", "queued", "running", "finished"],
        "bad": ["submitted", "queued", "running", "failed"],
        "late": ["submitted", "queued", "running", "deadline"],
        "blk": ["submitted", "queued", "running", "finished"],
        "victim": ["submitted", "queued", "cancelled"],
        "run": ["submitted", "queued", "running", "cancel_requested",
                "cancelled"],
    }
    spec = next(r["spec"] for r in port if r["job"] == "late"
                and r["event"] == "submitted")
    assert spec == {"jobClass": "f", "deadlineS": 0.2}


def test_drive_replays_the_same(driven):
    assert driven["port"][1] == driven["jax"][1]
    rep = driven["port"][1]
    assert rep["ok"]["state"] == "finished" and rep["ok"]["terminal"]
    assert rep["late"]["state"] == "failed"
    assert rep["run"]["reason"] == "cancel requested"
    assert [j for j, _ in sorted(rep.items(), key=lambda kv: kv[1]["seq"])
            ] == ["ok", "bad", "late", "blk", "victim", "run"]


def test_drive_metadata_states_and_epoch_stamp(driven):
    port, jax = driven["port"][2], driven["jax"][2]
    for name in port:
        assert port[name]["jobState"] == jax[name]["jobState"], name
    # The finished commit names the engine life that made it.
    assert port["ok"]["engineEpoch"] == jax["ok"]["engineEpoch"] == 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_replays_the_others_journal(driven, roots, writer,
                                                 reader):
    root = roots[writer]
    store_cls, _, journal_cls, _, _ = PACKAGES[reader]
    store = store_cls(root)
    journal = journal_cls(store, root)
    try:
        assert _same_words(journal.replay()) == driven[writer][1]
    finally:
        journal.close()
        store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_prune_keeps_live_jobs_and_bounds_terminal(tmp_path, package):
    store_cls, _, journal_cls, _, _ = PACKAGES[package]
    store = store_cls(tmp_path)
    journal = journal_cls(store, tmp_path, max_records=5)
    try:
        for i in range(6):
            journal.record_submit(f"t{i}", job_class="f")
            journal.append("running", f"t{i}", attempt=1)
            journal.append("finished", f"t{i}")
        journal.record_submit("live", job_class="f")
        journal.append("running", "live", attempt=1)
        journal.flush()
        assert journal.prune() == 6 * 3
        rep = journal.replay()
        assert all(rep[f"t{i}"]["terminal"] for i in range(6))
        assert rep["live"]["state"] == "running"
        assert store.count(JOURNAL_COLLECTION) == 6 + 3
    finally:
        journal.close()
        store.close()


def test_epochs_mint_monotonically_across_packages(tmp_path):
    port_store = DocumentStore(tmp_path / "a")
    jax_store = JaxStore(tmp_path / "b")
    try:
        epochs = [cls(store, tmp_path).epoch for cls, store in (
            (JobJournal, port_store), (JaxJournal, jax_store),
            (JobJournal, port_store))]
        assert epochs == [1, 2, 3]
        assert read_engine_epoch(tmp_path) == 3
        disabled = JobJournal(port_store, tmp_path, enabled=False)
        assert disabled.epoch == 0 and read_engine_epoch(tmp_path) == 3
    finally:
        port_store.close()
        jax_store.close()


def test_fence_check_refuses_stale_stamp(tmp_path):
    store = DocumentStore(tmp_path)
    journal = JobJournal(store, tmp_path)
    try:
        journal.fence_check()  # unstamped: passes
        with port_journal.stamp(journal.epoch):
            journal.fence_check()
            write_engine_epoch(tmp_path, journal.epoch + 1)
            with pytest.raises(StaleEpochError):
                journal.fence_check()
    finally:
        journal.close()
        store.close()


def test_stale_worker_terminal_commit_refused(tmp_path):
    """A body of an older epoch finishes after a newer boot: metadata,
    ledger and journal are left for the newer epoch."""
    store = DocumentStore(tmp_path)
    arts = ArtifactStore(store)
    journal = JobJournal(store, tmp_path)
    eng = JobEngine(arts, max_workers=1)
    eng.journal = journal
    try:
        release, started = threading.Event(), threading.Event()

        def body():
            started.set()
            release.wait(30)
            return "stale result"

        arts.metadata.create("stale", "function/python")
        fut = eng.submit("stale", body, job_class="f")
        assert started.wait(10)
        write_engine_epoch(tmp_path, journal.epoch + 1)
        release.set()
        assert fut.result(timeout=10) is None
        assert arts.metadata.read("stale")["jobState"] == "running"
        assert not arts.ledger.history("stale")
        journal.flush()
        assert [d["event"] for d in store.find(JOURNAL_COLLECTION)
                if d["job"] == "stale"] == ["submitted", "queued",
                                            "running"]
    finally:
        eng.shutdown(wait=False)
        journal.close()
        store.close()


def test_stale_worker_artifact_publication_refused(tmp_path):
    ctx = ServiceContext(Config(store=StoreConfig(
        root=str(tmp_path / "store"), volume_root=str(tmp_path / "vol"))),
        device="cpu")
    try:
        release, published = threading.Event(), []

        def body():
            release.wait(30)
            ctx.require_current_epoch()  # raises: stale
            published.append(True)

        ctx.artifacts.metadata.create("pub", "function/python")
        fut = ctx.engine.submit("pub", body, job_class="f")
        write_engine_epoch(ctx.config.store.store_path(),
                           ctx.journal.epoch + 1)
        release.set()
        assert fut.result(timeout=10) is None
        assert not published
    finally:
        ctx.close()
