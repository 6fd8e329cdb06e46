"""The port's runtime lock witness (``learningorchestra_tpu_torch/
concurrency_rt.py``) and its cross-check (``analysis/witness.py``) against
the JAX package's (``tests/test_witness_cancel.py``):

- each scripted lock sequence of the JAX witness cases (plain primitives
  with the witness off, order edges, no edge on a reentrant re-acquire,
  holders, waiters and contention events, reset) runs on both packages'
  ``concurrency_rt``, and the snapshots are equal apart from times,
  thread ids and stacks;
- ``cross_check`` gives the same findings as the JAX one on one dump over
  one static graph, an unmatched edge is a finding and a self-edge is not;
- a short port job with the witness on (store writes through the armed
  fault plane) witnesses edges, every one in the port's static graph; so
  does a fresh process's exit dump, through ``run_checks(witness_dump=)``;
- every lock the port builds goes through the factories, under the name
  the whole-program pass gives it;
- ``GET /observability/locks`` serves the snapshot through the port's
  client.
"""

import functools
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from learningorchestra_tpu import concurrency_rt as jax_rt
from learningorchestra_tpu.analysis import wholeprogram as jax_wholeprogram
from learningorchestra_tpu.analysis.witness import cross_check as jax_cross_check
from learningorchestra_tpu_torch import concurrency_rt as rt
# Imported here, outside any witnessed window: their module-level locks
# must be plain ones whichever test first imports them.
from learningorchestra_tpu_torch import config as _config  # noqa: F401
from learningorchestra_tpu_torch.api import server as _server  # noqa: F401
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.analysis import run_checks
from learningorchestra_tpu_torch.analysis.wholeprogram import global_graph
from learningorchestra_tpu_torch.analysis.witness import cross_check
from learningorchestra_tpu_torch.jobs.engine import JobEngine
from learningorchestra_tpu_torch.obs import bundle as obs_bundle
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.obs import metrics as obs_metrics
from learningorchestra_tpu_torch.obs import rollup as obs_rollup
from learningorchestra_tpu_torch.obs import slo as obs_slo
from learningorchestra_tpu_torch.store import ArtifactStore, open_document_store
from learningorchestra_tpu_torch.train import aot_store, compile_cache

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "learningorchestra_tpu_torch"


@functools.lru_cache(maxsize=1)
def _graph():
    return global_graph(PKG)


@pytest.fixture
def witness():
    """Both witnesses on for locks built inside the test, with clean edge
    and event state before and after; the port's metrics registry is
    rebuilt on both sides (a registry from an earlier test would carry a
    plain lock into the test's chains).  After the test, the process-wide
    singletons a server ensures are rebuilt plain: a witnessed one left
    behind would go on recording, and count in every later snapshot."""
    for mod in (rt, jax_rt):
        mod.set_witness(True)
        mod.reset()
    obs_metrics.reset_registry()
    yield
    for mod in (rt, jax_rt):
        mod.set_witness(False)
        mod.reset()
    obs_metrics.reset_registry()
    obs_rollup.reset_engine()
    obs_slo.reset_service()
    obs_bundle.reset_service()
    costs.reset()
    compile_cache.reset_cache()
    aot_store.reset_store()
    gc.collect()
    assert not list(rt._LOCKS), sorted(lock.name for lock in rt._LOCKS)


# -- the JAX witness cases on both packages ----------------------------------


def _order(mod):
    a, b = mod.make_lock("Wa.x"), mod.make_lock("Wb.y")
    with a:
        with b:
            pass


def _reentrant(mod):
    r = mod.make_rlock("Wr.r")
    with r:
        with r:
            pass


def _reset(mod):
    a, b = mod.make_lock("Wd.a"), mod.make_lock("Wd.b")
    with a, b:
        pass
    assert mod.snapshot()["edges"]
    mod.reset()


def _contention(mod):
    """A holds Wc.a while a contender holding Wc.c blocks on it; the
    snapshot is taken while the contender waits."""
    a, c = mod.make_lock("Wc.a"), mod.make_lock("Wc.c")
    entered = threading.Event()

    def contender():
        with c:
            entered.set()
            with a:
                pass

    with a:
        thread = threading.Thread(target=contender, name="contender")
        thread.start()
        entered.wait(5)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            snap = mod.snapshot(include_stacks=True)
            held = {e["name"]: e for e in snap["locks"]}
            if held.get("Wc.a", {}).get("waiters"):
                break
            time.sleep(0.01)
    thread.join(5)
    assert not thread.is_alive()
    return snap


SCRIPTS = {"order": _order, "reentrant": _reentrant, "reset": _reset,
           "contention": _contention}


def _normal(snap: dict) -> dict:
    """A snapshot without times, thread ids, stacks and the live-lock
    count (each process's other locks differ)."""
    out = {k: v for k, v in snap.items()
           if k not in ("stacks", "registeredLocks")}
    out["events"] = [{k: v for k, v in e.items() if k != "at"}
                     for e in snap["events"]]
    out["locks"] = [{**e, "waiters": [w["thread"] for w in e["waiters"]]}
                    for e in snap["locks"]]
    return out


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_scripted_sequence_snapshots_match_jax(witness, case):
    snaps = {}
    for name, mod in (("jax", jax_rt), ("port", rt)):
        got = SCRIPTS[case](mod)
        snaps[name] = got if got is not None else mod.snapshot()
    assert _normal(snaps["port"]) == _normal(snaps["jax"])
    snap = snaps["port"]
    edges = {(e["from"], e["to"]) for e in snap["edges"]}
    if case == "order":
        assert edges == {("Wa.x", "Wb.y")}
    elif case in ("reentrant", "reset"):
        assert edges == set()
    else:
        held = {e["name"]: e for e in snap["locks"]}
        assert held["Wc.a"]["owner"] == threading.current_thread().name
        assert held["Wc.a"]["waiters"][0]["thread"] == "contender"
        assert any(e["wanted"] == "Wc.a" and "Wc.c" in e["held"]
                   for e in snap["events"])
        assert snap.get("stacks")


def test_disabled_factories_return_plain_primitives():
    rt.set_witness(False)
    assert type(rt.make_lock("X.y")) is type(threading.Lock())
    assert type(rt.make_rlock("X.z")) is type(threading.RLock())
    assert type(rt.make_condition("X.c")) is threading.Condition
    assert rt.snapshot()["enabled"] is False


def test_contention_lands_in_the_flight_ring(witness):
    from learningorchestra_tpu_torch.config import FlightConfig
    from learningorchestra_tpu_torch.obs import flight

    flight.reset(FlightConfig())
    try:
        _contention(rt)
        events = flight.snapshot(["locks"])["events"]["locks"]
    finally:
        flight.reset()
    assert any(e["kind"] == "contention" and e["wanted"] == "Wc.a"
               for e in events), events


# -- the cross-check ----------------------------------------------------------


def test_cross_check_matches_jax_on_one_dump():
    """One dump (a matched edge, an unmatched one between modeled locks,
    one naming an unknown lock, a self-edge) over the port's package: the
    port's and the JAX cross-check give the same findings."""
    graph = _graph()
    jax_graph = jax_wholeprogram.global_graph(PKG)
    matched = sorted(graph.edge_pairs)[0]
    assert ("JobEngine._lock", "_Collection.lock") not in graph.edge_pairs
    dump = {"edges": [
        {"from": matched[0], "to": matched[1], "count": 1, "site": "x.py:1"},
        {"from": "JobEngine._lock", "to": "_Collection.lock", "count": 3,
         "site": "somefile.py:12"},
        {"from": "Nowhere.lock", "to": "JobEngine._lock", "count": 1,
         "site": "y.py:7"},
        {"from": "MicroBatcher._cond", "to": "MicroBatcher._cond",
         "count": 2, "site": "x.py:2"},
    ]}
    port = cross_check(dump, graph)
    jax = jax_cross_check(dump, jax_graph)
    key = lambda f: (f.file, f.line, f.rule, f.message)  # noqa: E731
    assert sorted(map(key, port)) == sorted(map(key, jax))
    assert [(f.file, f.line, f.rule) for f in port] == [
        ("somefile.py", 12, "witness-unmatched-edge"),
        ("y.py", 7, "witness-unmatched-edge")]
    assert "not in the static model" in port[1].message


def test_short_job_has_zero_unmatched_edges(witness, tmp_path):
    """A witnessed engine job whose store writes cross the armed fault
    plane (collection lock -> plane lock -> metrics lock): every witnessed
    edge is in the port's static graph."""
    # The python store: its collection lock is the chain's first link
    # (the default "auto" store is the native one, which has none).
    arts = ArtifactStore(open_document_store(tmp_path / "store",
                                             backend="python"))
    arts.metadata.create("wit_job", {"name": "wit_job"})
    faults.arm("store.wal_write", "delay", delay_ms=0.0)
    try:
        engine = JobEngine(arts, max_workers=2)
        assert engine.submit("wit_job", lambda: 7).result(30) == 7
        engine.shutdown(wait=True)
    finally:
        faults.disarm_all()
    snap = rt.snapshot()
    assert snap["enabled"] and snap["edges"]
    findings = cross_check(snap, _graph())
    assert findings == [], "\n".join(f.render() for f in findings)


def test_fresh_process_dump_cross_checks_clean(tmp_path):
    """LO_TPU_WITNESS=1 and LO_TPU_WITNESS_DUMP in a fresh process (so
    module-level locks are witnessed too), a store and faults workload,
    the exit dump, then run_checks(witness_dump=) finds nothing."""
    dump = tmp_path / "witness.json"
    script = (
        "import tempfile\n"
        "from learningorchestra_tpu_torch.store import (\n"
        "    ArtifactStore, open_document_store)\n"
        "from learningorchestra_tpu_torch.jobs.engine import JobEngine\n"
        "from learningorchestra_tpu_torch import faults\n"
        "tmp = tempfile.mkdtemp()\n"
        "arts = ArtifactStore(open_document_store(tmp + '/s',\n"
        "                                         backend='python'))\n"
        "arts.metadata.create('j', {'name': 'j'})\n"
        "faults.arm('store.wal_write', 'delay', delay_ms=0.0)\n"
        "eng = JobEngine(arts, max_workers=1)\n"
        "assert eng.submit('j', lambda: 1).result(30) == 1\n"
        "eng.shutdown(wait=True)\n"
    )
    env = {**os.environ, "LO_TPU_WITNESS": "1",
           "LO_TPU_WITNESS_DUMP": str(dump), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(dump.read_text())
    assert doc["enabled"] and doc["edges"]
    report = run_checks(PKG, whole_program=True, witness_dump=dump)
    assert report.errors == [], "\n".join(f.render() for f in report.errors)


def test_every_port_lock_is_built_by_a_named_factory():
    """No ``threading.Lock/RLock/Condition()`` outside concurrency_rt and
    the analyzers, and every factory's name is its static identity."""
    import ast

    for path in sorted(PKG.rglob("*.py")):
        if path.name == "concurrency_rt.py" or "analysis" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "threading"
                    and node.func.attr in ("Lock", "RLock", "Condition")):
                raise AssertionError(f"{path}:{node.lineno} builds a "
                                     "threading lock directly")
    report = run_checks(PKG, whole_program=True, drift=False)
    assert not [f for f in report.findings
                if f.rule == "lock-name-mismatch"]
    names = _graph().names
    for name in ("JobEngine._lock", "_Collection.lock", "APIServer._cache_lock",
                 "attention._count_lock", "plane._LOCK", "_Slot._lock"):
        assert name in names, name


def test_locks_endpoint_and_client_binding(witness, tmp_path):
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.client import Context
    from learningorchestra_tpu_torch.config import Config, StoreConfig

    server = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "store"), volume_root=str(tmp_path / "vol"))),
        device="cpu")
    port = server.start_background()
    try:
        doc = Context(f"http://127.0.0.1:{port}").observability.locks()
        assert doc["enabled"] is True
        assert "edges" in doc and "locks" in doc and "stalls" in doc
        assert doc["registeredLocks"] > 0
    finally:
        server.shutdown()
