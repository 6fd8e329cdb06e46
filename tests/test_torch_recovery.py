"""Boot recovery, webhooks, the event feed and REST cancel of the port,
against the JAX package, on the CPU.

Recovery: one crafted store (written with the JAX package's store and
journal classes, the WAL format both share) is copied, and each package
boots its ``ServiceContext`` over its copy, as
``tests/test_journal_recovery.py::TestRecovery`` does: journaled queued
jobs re-enqueue in their pre-crash order; an unresumable job fails with
the exact ``orphaned-by-restart`` reason and a journaled terminal; a
journal-less job, and any job when the journal is off, gets the legacy
interrupted message (the port left such jobs ``running`` before);
``journal_recover`` off orphans instead of re-dispatching.  Each case's
metadata is held equal on both.  A store the JAX package wrote, with a
dill model binary, boots the port in a child process that cannot import
dill, JAX or the JAX package (as on the card's machine): the train job is
re-dispatched and fails on the load with the error in its execution
document, a job whose parent is gone is failed ``orphaned-by-restart``
with the exception's text, the rest recover, nothing stays running.

REST: ``DELETE /jobs/<name>`` (200 queued, 202 running then 409, 404
unknown; ``cancel_requested`` and ``cancelled`` journaled), webhook
registration, listing, deletion, the wildcard, delivery to a local
receiver on ``finished`` and ``failed`` (the recovery orphan path
included) and ``/observe/events`` paging give equal bodies on a JAX and
a port server.

Last, the port's kill-9 drill in two child processes on
``device="cpu"``, after ``test_kill9_drill_resumes_from_newest_checkpoint``:
SIGKILLed mid-fit, the next boot resumes the job from its newest
checkpoint (not epoch 0) to ``finished`` with ``engineEpoch`` 2.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu.jobs import JobJournal as JaxJournal
from learningorchestra_tpu.jobs import cancel as jax_cancel
from learningorchestra_tpu.services import context as jax_context
from learningorchestra_tpu.services import executor as jax_executor
from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu.store import Metadata as JaxMetadata
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.jobs import cancel as port_cancel
from learningorchestra_tpu_torch.jobs.journal import JOURNAL_COLLECTION
from learningorchestra_tpu_torch.services import context as port_context
from learningorchestra_tpu_torch.services import executor as port_executor

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "/api/learningOrchestra/v1"
ORPHANED = (
    "orphaned-by-restart: the orchestrator died while this job was queued "
    "or running and its body is not automatically re-dispatchable; re-run "
    "it with a PATCH (bare PATCH re-uses the last recorded parameters)")
LEGACY = (
    "job interrupted by a server restart or store failover before "
    "completing; re-run it with a PATCH (bare PATCH re-uses the last "
    "recorded parameters)")


def _configs(root: Path, *, journal=True, recover=True):
    jcfg = JaxConfig()
    jcfg.store.root = str(root / "jax" / "store")
    jcfg.store.volume_root = str(root / "jax" / "vol")
    jcfg.store.backend = "python"
    pcfg = Config(store=StoreConfig(root=str(root / "port" / "store"),
                                    volume_root=str(root / "port" / "vol")))
    for jobs in (jcfg.jobs, pcfg.jobs):
        jobs.journal, jobs.journal_recover = journal, recover
    return jcfg, pcfg


def _craft(root: Path, jobs: dict, journaled=()):
    """A store (and volumes) under ``root/jax`` holding ``jobs``
    ({name: (type, parentName, method, jobState)}), the ``journaled``
    ones submitted (and running, if so) in that order; copied to
    ``root/port``."""
    store = JaxStore(root / "jax" / "store")
    meta = JaxMetadata(store)
    for name, (kind, parent, method, state) in jobs.items():
        meta.create(name, kind, parent_name=parent, method=method)
        if state == "running":
            meta.mark_running(name)
    journal = JaxJournal(store, root / "jax" / "store")
    for name in journaled:
        journal.record_submit(name, job_class="executor",
                              method=jobs[name][2])
        if jobs[name][3] == "running":
            journal.append("running", name, attempt=1)
    journal.close()
    store.close()
    (root / "jax" / "vol").mkdir(exist_ok=True)
    shutil.copytree(root / "jax", root / "port")


def _boot_both(root, names, **cfg_kw):
    """Boot each package's context over its copy; -> {side: {name:
    metadata}} and the contexts' replays."""
    jcfg, pcfg = _configs(root, **cfg_kw)
    out, replays = {}, {}
    for side, make in (("jax", lambda: jax_context.ServiceContext(jcfg)),
                       ("port", lambda: port_context.ServiceContext(
                           pcfg, device="cpu"))):
        ctx = make()
        try:
            out[side] = {n: ctx.artifacts.metadata.read(n) for n in names}
            replays[side] = ctx.journal.replay()
        finally:
            ctx.close()
    return out, replays


# -- recovery on crafted stores -------------------------------------------------

def test_reenqueue_preserves_queue_order(tmp_path, monkeypatch):
    order = {"jax": [], "port": []}
    for side, mod in (("jax", jax_executor), ("port", port_executor)):
        monkeypatch.setattr(
            mod.ExecutorService, "update",
            lambda self, name, _o=order[side], **kw: _o.append(name))
    names = ("j_b", "j_a", "j_c")  # admission order
    _craft(tmp_path, {n: ("predict/tensorflow", "fit0", "predict",
                          "pending") for n in names}, journaled=names)
    _boot_both(tmp_path, names)
    assert order["port"] == order["jax"] == ["j_b", "j_a", "j_c"]


def test_unresumable_job_orphan_fails_with_reason(tmp_path):
    _craft(tmp_path, {"fn1": ("function/python", None, None, "running")},
           journaled=["fn1"])
    metas, replays = _boot_both(tmp_path, ["fn1"])
    for side in ("jax", "port"):
        assert metas[side]["fn1"]["jobState"] == "failed"
        assert metas[side]["fn1"]["exception"] == ORPHANED
        assert replays[side]["fn1"]["terminal"]
        assert replays[side]["fn1"]["reason"] == "orphaned-by-restart"


@pytest.mark.parametrize("journal", [True, False],
                         ids=["journal_less_job", "journal_off"])
def test_interrupted_job_gets_the_legacy_reflag(tmp_path, journal):
    """The repair: before, a port boot left ``old`` running forever and
    every PATCH re-run answered 409."""
    _craft(tmp_path, {"old": ("function/python", None, None, "running"),
                      "queued": ("train/tensorflow", "m", "fit",
                                 "pending")})
    metas, _ = _boot_both(tmp_path, ["old", "queued"], journal=journal)
    for side in ("jax", "port"):
        for name in ("old", "queued"):
            assert metas[side][name]["jobState"] == "failed", (side, name)
            assert metas[side][name]["exception"] == LEGACY


def test_recover_off_orphans_instead_of_redispatch(tmp_path, monkeypatch):
    called = []
    for mod in (jax_executor, port_executor):
        monkeypatch.setattr(mod.ExecutorService, "update",
                            lambda self, name, **kw: called.append(name))
    _craft(tmp_path, {"fitx": ("train/tensorflow", "m", "fit", "running")},
           journaled=["fitx"])
    metas, _ = _boot_both(tmp_path, ["fitx"], recover=False)
    assert not called
    assert metas["port"]["fitx"] == metas["jax"]["fitx"]
    assert metas["port"]["fitx"]["exception"] == ORPHANED


_PORT_CHILD = r"""
import json, sys, time
# The card's machine has none of these: a dill binary cannot load there.
for mod in ("dill", "jax", "jaxlib", "flax", "optax", "orbax",
            "learningorchestra_tpu"):
    sys.modules[mod] = None
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.services.context import ServiceContext

root = sys.argv[1]
ctx = ServiceContext(Config(store=StoreConfig(
    root=root + "/store", volume_root=root + "/vol")), device="cpu")
names = ("fit1", "fn1", "ghostfit")
deadline = time.time() + 60
while time.time() < deadline:
    metas = {n: ctx.artifacts.metadata.read(n) for n in names}
    if all(m["jobState"] in ("finished", "failed") for m in metas.values()):
        break
    time.sleep(0.05)
execs = [d.get("exception") for d in ctx.artifacts.ledger.history("fit1")]
print("RESULT " + json.dumps({"metas": metas, "executions": execs,
                              "replay": ctx.journal.replay()}))
ctx.close()
"""


def test_jax_written_store_boots_the_port(tmp_path):
    jcfg, _ = _configs(tmp_path)
    ctx = jax_context.ServiceContext(jcfg)
    try:
        from learningorchestra_tpu.services.model import ModelService

        ModelService(ctx).create(
            "m", module_path="learningorchestra_tpu.models.mlp",
            class_name="MLPClassifier",
            class_parameters={"hidden_layer_sizes": [4], "num_classes": 2})
        ctx.engine.wait("m", timeout=60)
        assert ctx.artifacts.metadata.read("m")["finished"]
    finally:
        ctx.close()
    store = JaxStore(tmp_path / "jax" / "store")
    meta = JaxMetadata(store)
    journal = JaxJournal(store, tmp_path / "jax" / "store")
    jobs = {"fit1": ("train/tensorflow", "m", "fit"),
            "fn1": ("function/python", None, None),
            "ghostfit": ("train/tensorflow", "ghost", "fit")}
    for name, (kind, parent, method) in jobs.items():
        meta.create(name, kind, parent_name=parent, method=method)
        meta.update(name, {"requestParameters": {
            "x": [[0.0, 1.0], [1.0, 0.0]], "y": [0, 1], "epochs": 1}})
        meta.mark_running(name)
        journal.record_submit(name, job_class="executor", method=method)
        journal.append("running", name, attempt=1)
    journal.close()
    store.close()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_CHILD, str(tmp_path / "port")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.split("RESULT ", 1)[1])
    metas = got["metas"]
    assert {m["jobState"] for m in metas.values()} == {"failed"}
    # fit1 was re-dispatched, and its body failed loading the dill
    # binary, which names the JAX package's class.
    assert "learningorchestra_tpu" in metas["fit1"]["exception"]
    assert got["executions"][-1] == metas["fit1"]["exception"]
    assert got["replay"]["fit1"]["state"] == "failed"
    assert metas["fn1"]["exception"] == ORPHANED
    # The re-dispatch raised before the body ran: orphaned, with why.
    ghost = metas["ghostfit"]["exception"]
    assert ghost.startswith("orphaned-by-restart") and ghost == ORPHANED \
        .replace("re-dispatchable;", "re-dispatchable (NotFoundError("
                 "\"no such artifact: 'ghost'\"));")
    # The JAX package, booted over the same store, fails the same two
    # with the same reasons (and runs fit1, which it can load).
    jctx = jax_context.ServiceContext(jcfg)
    try:
        for name in ("fn1", "ghostfit"):
            assert jctx.artifacts.metadata.read(name)["exception"] == \
                metas[name]["exception"]
    finally:
        jctx.close()


# -- REST: cancel, webhooks and the feed on both servers ------------------------

class _Receiver:
    """A local webhook endpoint recording every POST body by path."""

    def __init__(self):
        got = self.got = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                got.append((self.path, json.loads(body)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def wait(self, path, n, timeout=20):
        deadline = time.time() + timeout
        while time.time() < deadline:
            hits = [b for p, b in self.got if p == path]
            if len(hits) >= n:
                return hits
            time.sleep(0.02)
        raise AssertionError(f"{path}: {self.got}")

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def receiver():
    recv = _Receiver()
    yield recv
    recv.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jcfg, pcfg = _configs(tmp_path_factory.mktemp("rest"))
    jcfg.jobs.max_workers = pcfg.jobs.max_workers = 1
    out = {"jax": JaxServer(jcfg), "port": APIServer(pcfg, device="cpu")}
    yield out
    for srv in out.values():
        srv.shutdown()


CANCEL = {"jax": jax_cancel, "port": port_cancel}


def _call(server, verb, path, body=None):
    return server.handle(verb, PREFIX + path, body or {}, {})


def _until(cond, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("condition never held")


def _cancel_drive(side, server):
    ctx, jc, out = server.ctx, CANCEL[side], []
    gate, started = threading.Event(), threading.Event()

    def body():
        started.set()
        while not jc.cancel_requested():
            time.sleep(0.005)
        return "partial"

    for name in ("blk", "victim", "runjob"):
        ctx.artifacts.metadata.create(name, "function/python")
    ctx.engine.submit("blk", gate.wait, job_class="f")
    ctx.engine.submit("victim", lambda: 1, job_class="f")
    out.append(_call(server, "DELETE", "/jobs/victim"))  # queued: 200
    gate.set()
    fut = ctx.engine.submit("runjob", body, job_class="f")
    assert started.wait(10)
    out.append(_call(server, "DELETE", "/jobs/runjob"))  # running: 202
    fut.result(timeout=10)
    _until(lambda: ctx.artifacts.metadata.read("runjob")["jobState"]
           == "cancelled")
    out.append(_call(server, "DELETE", "/jobs/runjob"))  # terminal: 409
    out.append(_call(server, "DELETE", "/jobs/nope"))  # unknown: 404
    ctx.journal.flush()
    events = [d["event"] for d in ctx.documents.find(JOURNAL_COLLECTION)
              if d["job"] in ("victim", "runjob")]
    return out, events


def test_delete_jobs_cancels_on_both(servers):
    outs = {side: _cancel_drive(side, srv) for side, srv in servers.items()}
    assert outs["port"] == outs["jax"]
    statuses, events = outs["port"]
    assert [s for s, _ in statuses] == [200, 202, 409, 404]
    assert statuses[1][1] == {"job": "runjob", "result": "cancelling"}
    assert events == ["submitted", "queued", "cancelled",
                      "submitted", "queued", "running", "cancel_requested",
                      "cancelled"]


def _norm(tree, url):
    """Bodies without time stamps and without ``deliveries``, the
    receiver's URL named.  Each package counts a delivery as the
    notify-time snapshot's count plus one, so two deliveries in flight
    at once may count 1 or 2 on either side."""
    text = json.dumps(tree, default=str).replace(url, "URL")
    tree = json.loads(text)

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()
                    if k not in ("ts", "timeCreated", "deliveries")}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    return strip(tree)


def _feed(server, since, limit=100):
    return server.handle("GET", PREFIX + "/observe/events", {},
                         {"sinceId": str(since), "limit": str(limit)})


def _webhook_drive(side, server, receiver):
    ctx, out = server.ctx, {}
    url = f"{receiver.url}/{side}"
    since = max([e["_id"] for e in ctx.webhooks.events(limit=1000)],
                default=-1)
    hook_all = _call(server, "POST", "/observe/webhook", {"url": url})
    out["register_all"] = hook_all
    out["bad_url"] = _call(server, "POST", "/observe/webhook",
                           {"url": "ftp://x"})[0]
    out["bad_event"] = _call(server, "POST", "/observe/webhook",
                             {"url": url, "events": ["running"]})[0]
    for name, fn in (("hok", lambda: 1), ("hbad", lambda: 1 / 0)):
        ctx.artifacts.metadata.create(name, "function/python")
        ctx.engine.submit(name, fn, job_class="f")
        ctx.engine.wait(name, timeout=10)
    pushed = receiver.wait(f"/{side}", 2)
    # A hook on an artifact already finished fires at once.
    out["register_late"] = _call(server, "POST", "/observe/hok/webhook",
                                 {"url": url + "/late",
                                  "events": ["finished"]})
    late = receiver.wait(f"/{side}/late", 1)
    _until(lambda: all(h["lastStatus"] == 200 for h in
                       ctx.webhooks.list("*") + ctx.webhooks.list("hok")))
    out["list_all"] = _call(server, "GET", "/observe/webhook")
    out["list_one"] = _call(server, "GET", "/observe/hok/webhook")
    out["list_missing"] = _call(server, "GET", "/observe/ghost/webhook")[0]
    hook_id = out["register_late"][1]["result"]["_id"]
    out["delete_one"] = _call(server, "DELETE",
                              f"/observe/hok/webhook/{hook_id}")
    out["delete_again"] = _call(server, "DELETE",
                                f"/observe/hok/webhook/{hook_id}")[0]
    out["delete_all"] = _call(
        server, "DELETE",
        f"/observe/webhook/{hook_all[1]['result']['_id']}")
    out["feed"] = [_feed(server, since), _feed(server, since + 1, 2)]
    out["feed_bad"] = server.handle("GET", PREFIX + "/observe/events", {},
                                    {"sinceId": "x"})[0]
    out["pushed"] = sorted(
        (b["name"], b["event"], b["metadata"]["jobState"]) for b in pushed
        + late)
    return _norm(out, url)


def test_webhooks_and_feed_equal_on_both(servers, receiver):
    outs = {side: _webhook_drive(side, srv, receiver)
            for side, srv in servers.items()}
    assert outs["port"] == outs["jax"]
    out = outs["port"]
    assert out["register_all"][0] == 201 and out["bad_url"] == 406
    assert out["bad_event"] == 406 and out["list_missing"] == 404
    assert out["register_late"][1]["result"]["firedImmediately"] == \
        "finished"
    assert out["delete_one"] == [200, {"result": "deleted"}]
    assert out["delete_again"] == 404 and out["feed_bad"] == 400
    assert out["pushed"] == [["hbad", "failed", "failed"],
                             ["hok", "finished", "finished"],
                             ["hok", "finished", "finished"]]
    assert [e["event"] for e in out["feed"][1][1]["result"]] == [
        "finished", "running"]


def test_recovery_orphan_fires_the_webhook_on_both(tmp_path, receiver):
    _craft(tmp_path, {"fn1": ("function/python", None, None, "running")},
           journaled=["fn1"])
    for side in ("jax", "port"):
        store = JaxStore(tmp_path / side / "store")
        store.insert_one("observe_webhooks", {
            "artifact": "*", "url": f"{receiver.url}/orphan/{side}",
            "events": ["finished", "failed"], "deliveries": 0,
            "lastStatus": None, "lastError": None})
        store.close()
    _boot_both(tmp_path, ["fn1"])
    bodies = {side: receiver.wait(f"/orphan/{side}", 1)[0]
              for side in ("jax", "port")}
    for body in bodies.values():
        assert (body["name"], body["event"]) == ("fn1", "failed")
        assert body["metadata"]["exception"] == ORPHANED


# -- the kill-9 drill -------------------------------------------------------------

_CHILD_ORCHESTRATOR = r"""
import json, os, signal, sys, time
import numpy as np
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.executor import ExecutorService
from learningorchestra_tpu_torch.services.model import ModelService
from learningorchestra_tpu_torch.train.neural import NeuralEstimator

# A certain mid-fit window: epochs 0-1 run free (and checkpoint), every
# later epoch waits 300 ms first, so the SIGKILL lands while the fit runs.
epoch_raw = NeuralEstimator._device_epoch


def slowed(self, *args):
    if args[-1] >= 2:
        time.sleep(0.3)
    return epoch_raw(self, *args)


NeuralEstimator._device_epoch = slowed
ctx = ServiceContext(Config.from_env(), device="cpu")
rng = np.random.default_rng(0)
x = rng.standard_normal((32, 4)).astype("float32")
y = (x.sum(1) > 0).astype("int32")
ModelService(ctx).create(
    "m", module_path="learningorchestra_tpu.models.mlp",
    class_name="MLPClassifier",
    class_parameters={"hidden_layer_sizes": [4], "num_classes": 2})
ctx.engine.wait("m", timeout=60)
ExecutorService(ctx).create(
    "fit1", parent_name="m", method="fit",
    method_parameters={
        "x": x.tolist(), "y": y.tolist(), "epochs": 6,
        "checkpoint_every": 1, "checkpoint_min_interval_s": 0,
        "checkpoint_async": False,
    },
    artifact_type="train/tensorflow")
marker = ctx.checkpoint_dir("fit1") / "latest.json"
deadline = time.time() + 60
while time.time() < deadline:
    try:
        if json.loads(marker.read_text()).get("step", 0) >= 2:
            break
    except (OSError, ValueError):
        pass
    time.sleep(0.02)
else:
    print("NO_CHECKPOINT", flush=True)
    sys.exit(3)
print("KILLING", flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""

_CHILD_RECOVERY = r"""
import json, time
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.train.neural import NeuralEstimator

ran = []
epoch_raw = NeuralEstimator._device_epoch


def counted(self, *args):
    ran.append(args[-1])
    return epoch_raw(self, *args)


NeuralEstimator._device_epoch = counted
ctx = ServiceContext(Config.from_env(), device="cpu")  # recovers fit1
deadline = time.time() + 60
meta = {}
while time.time() < deadline:
    meta = ctx.artifacts.metadata.read("fit1") or {}
    if meta.get("finished") or meta.get("jobState") == "failed":
        break
    time.sleep(0.05)
history = ctx.documents.find("fit1", query={"docType": "history"})
print("RESULT " + json.dumps({
    "jobState": meta.get("jobState"), "engineEpoch": meta.get(
        "engineEpoch"), "epochs": ran, "history": len(history)}),
    flush=True)
ctx.close()
"""


def test_kill9_drill_resumes_from_newest_checkpoint(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "LO_TPU_STORE_ROOT": str(tmp_path / "store"),
           "LO_TPU_VOLUME_ROOT": str(tmp_path / "vol")}
    first = subprocess.run([sys.executable, "-c", _CHILD_ORCHESTRATOR],
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert first.returncode == -signal.SIGKILL, (
        first.returncode, first.stdout[-2000:], first.stderr[-2000:])
    assert "KILLING" in first.stdout
    marker = json.loads((tmp_path / "vol" / "_checkpoints" / "fit1" /
                         "latest.json").read_text())
    assert marker["step"] >= 2
    second = subprocess.run([sys.executable, "-c", _CHILD_RECOVERY],
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert second.returncode == 0, second.stderr[-3000:]
    result = json.loads(second.stdout.split("RESULT ", 1)[1])
    assert result["jobState"] == "finished", result
    assert result["engineEpoch"] == 2, result
    # Resumed, not restarted: only the epochs after the checkpoint ran.
    assert result["epochs"] == list(range(marker["step"], 6)), (marker,
                                                               result)
    assert result["history"] == 6
