"""``tests/test_distributed_exec.py``'s ten contracts on a JAX and a port
server side by side, plus recovery's ``distributed`` kind.

The port's server runs two gloo ranks on the CPU (``dist.cpu_ranks``);
the JAX server's mesh folds its 8 host devices into ``dp``, so
``meshDevices`` is each side's world size (8 and 2, ROADMAP C).  The
first train job carries the JAX model's initial parameters into the
port's (f32, ``shuffle: false``) and holds the two fits' histories and
predictions against each other; the rest hold both servers to the same
statuses, states, rows and metadata keys (``UNPORTED_KEYS`` aside).
JAX marks its train-route test slow (its mesh program compiles); the
port's side of it is one fit of two ranks.
"""

import concurrent.futures
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import requests
import torch

from learningorchestra_tpu.jobs import JobJournal as JaxJournal
from learningorchestra_tpu.services import distributed_exec as jax_dist
from learningorchestra_tpu.services import executor as jax_executor
from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu.store import Metadata as JaxMeta
from learningorchestra_tpu_torch.parallel.distributed import STAGE_PREFIX
from learningorchestra_tpu_torch.services import (
    distributed_exec as port_dist,
)
from learningorchestra_tpu_torch.services import executor as port_executor
from learningorchestra_tpu_torch.services.monitoring import (
    MonitoringService,
    write_scalar_logs,
)
from tests.test_torch_recovery import ROOT, _boot_both
from tests.torch_rest_pair import UNPORTED_KEYS, carry_weights, server_pair

SIDES = ("jax", "port")
WORLD = {"jax": 8, "port": 2}
#: The two servers' API base URLs while the module's ``api`` fixture runs.
BASES: dict = {}
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distrest")
    with server_pair(tmp) as (servers, clients):
        servers["port"].config.dist.cpu_ranks = WORLD["port"]
        BASES.update({side: clients[side].base for side in SIDES})
        yield servers, tmp
        BASES.clear()


def poll(base, path, timeout=180):
    deadline = time.time() + timeout
    while time.time() < deadline:
        docs = requests.get(f"{base}{path}", timeout=10).json()
        meta = docs[0] if isinstance(docs, list) and docs else {}
        if meta.get("finished"):
            return meta
        if meta.get("jobState") == "failed":
            raise AssertionError(f"job failed: {meta.get('exception')}")
        time.sleep(0.05)
    raise AssertionError(f"timeout polling {path}")


def both(fn):
    """Run ``fn(side, base)`` on both servers at once -> {side: result}."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {side: pool.submit(fn, side, base)
                   for side, base in BASES.items()}
        return {side: fut.result() for side, fut in futures.items()}


@pytest.fixture(scope="module")
def dataset(api):
    _, tmp = api
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 4))
    y = (x[:, 0] - x[:, 1] > 0).astype(int)
    path = tmp / "dd.csv"
    with open(path, "w") as fh:
        fh.write("a,b,c,d,label\n")
        for row, label in zip(x, y):
            fh.write(",".join(f"{v:.5f}" for v in row) + f",{label}\n")

    def ingest(side, base):
        resp = requests.post(f"{base}/dataset/csv", json={
            "datasetName": "dd", "url": f"file://{path}"})
        assert resp.status_code == 201, resp.text
        poll(base, "/dataset/csv/dd")
        resp = requests.post(f"{base}/transform/projection", json={
            "datasetName": "dd", "projectionName": "dd_X",
            "fields": ["a", "b", "c", "d"]})
        assert resp.status_code == 201, resp.text
        poll(base, "/dataset/csv/dd_X")

    both(ingest)
    return x.astype(np.float32)


def _model(base, name, hidden):
    resp = requests.post(f"{base}/model/tensorflow", json={
        "name": name, "modulePath": "learningorchestra_tpu.models.mlp",
        "class": "MLPClassifier",
        "classParameters": {"hidden_layer_sizes": hidden, "num_classes": 2}})
    assert resp.status_code == 201, resp.text
    poll(base, f"/model/tensorflow/{name}")


def _epochs(base, name):
    docs = requests.get(f"{base}/train/horovod/{name}",
                        params={"limit": 50}).json()
    return [d for d in docs if d.get("docType") == "history"]


def test_distributed_train_route(api, dataset):
    servers, _ = api
    both(lambda side, base: _model(base, "dmlp", [8]))
    carry_weights(servers, "dmlp", dataset[:1])

    def drive(side, base):
        resp = requests.post(f"{base}/train/horovod", json={
            "name": "dtrain", "parentName": "dmlp",
            "trainingParameters": {"x": "$dd_X", "y": "$dd.label",
                                   "epochs": 2, "batch_size": 16,
                                   "shuffle": False},
            "mesh": {"dp": 2}, "monitoringPath": "dtrain_logs"})
        assert resp.status_code == 201, resp.text
        body = resp.json()
        assert "extra_results" in body  # the monitoring session, inline
        meta = poll(base, "/train/horovod/dtrain")
        mon = requests.get(f"{base}/monitoring/tensorflow/dtrain_logs")
        nope = requests.get(f"{base}/monitoring/tensorflow/nope")
        resp = requests.post(f"{base}/predict/tensorflow", json={
            "name": "dpreds", "parentName": "dtrain",
            "method": "predict_classes", "methodParameters": {"x": "$dd_X"}})
        assert resp.status_code == 201, resp.text
        poll(base, "/predict/tensorflow/dpreds")
        docs = requests.get(f"{base}/predict/tensorflow/dpreds",
                            params={"limit": 100}).json()
        return {"meta": meta, "history": _epochs(base, "dtrain"),
                "monitoring": (mon.status_code, mon.json()),
                "nope": nope.status_code,
                "preds": [d["result"] for d in docs if "result" in d],
                "extra": body["extra_results"]}

    out = both(drive)
    for side, got in out.items():
        meta = got["meta"]
        assert meta["distributed"] is True and meta["mesh"] == {"dp": 2}
        # spec dp=2 folds spare devices into dp: the world size.
        assert meta["meshDevices"] == WORLD[side]
        assert len(got["history"]) == 2
        assert all("samples_per_sec" in d for d in got["history"])
        status, session = got["monitoring"]
        assert status == 200 and session["logdir"]
        assert session["url"] is None  # no TensorBoard on either machine
        assert got["nope"] == 404
        assert got["preds"] and set(got["preds"]) <= {0, 1}
        assert got["extra"]["monitoring"]["nickname"] == "dtrain_logs"
    assert set(out["port"]["meta"]) - UNPORTED_KEYS == \
        set(out["jax"]["meta"]) - UNPORTED_KEYS
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(
            [d[key] for d in out["port"]["history"]],
            [d[key] for d in out["jax"]["history"]], **TOL, err_msg=key)
    assert out["port"]["preds"] == out["jax"]["preds"]
    # The session's logdir: the scalars twice over and rank 0's trace.
    files = [f for _, _, fs in os.walk(
        out["port"]["monitoring"][1]["logdir"]) for f in fs]
    assert "dtrain.csv" in files
    assert any(f.startswith("events.out.tfevents.") for f in files)
    assert any(f.endswith(".pt.trace.json") for f in files)


def test_distributed_builder_route(api, dataset):
    code = (
        "def builder(rank, world_size, xs):\n"
        "    total = sum(xs)\n"
        "    return {'rank': rank, 'world': world_size,"
        " 'share': total / world_size}\n"
    )

    def drive(side, base):
        resp = requests.post(f"{base}/builder/tensorflow", json={
            "name": "dbuild", "function": code,
            "functionParameters": {"xs": [1, 2, 3]}, "nWorkers": 3})
        assert resp.status_code == 201, resp.text
        meta = poll(base, "/builder/tensorflow/dbuild")
        docs = requests.get(f"{base}/builder/tensorflow/dbuild",
                            params={"limit": 10}).json()
        return meta, sorted((d["rank"], d["result"]) for d in docs
                            if "result" in d)

    out = both(drive)
    assert out["port"][1] == out["jax"][1]
    assert [rank for rank, _ in out["port"][1]] == [0, 1, 2]
    for meta, _ in out.values():
        assert meta["worldSize"] == 3
    assert set(out["port"][0]) - UNPORTED_KEYS == \
        set(out["jax"][0]) - UNPORTED_KEYS


def test_distributed_builder_rejects_non_function(api):
    assert both(lambda side, base: requests.post(
        f"{base}/builder/pytorch",
        json={"name": "dbad", "function": "x = 1\ny = 2\n"},
    ).status_code) == {"jax": 406, "port": 406}


def test_monitoring_service_atomic_and_trace(tmp_path):
    import torch

    svc = MonitoringService(str(tmp_path / "mon"))
    try:
        # Concurrent starts for one nickname converge on one session.
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            infos = list(pool.map(
                lambda _: svc.start("nick", spawn_tensorboard=False),
                range(8)))
        assert len({i["logdir"] for i in infos}) == 1
        assert len(svc.list_sessions()) == 1
        with svc.trace("nick") as info:
            torch.ones(8, 8) @ torch.ones(8, 8)
        # The trace wrote into the logdir (plugins/profile/...).
        assert any(os.scandir(info["logdir"]))
        n = write_scalar_logs(
            info["logdir"], {"loss": [1.0, 0.5], "acc": [0.4, 0.9]},
            prefix="job")
        assert n == 2
        with open(os.path.join(info["logdir"], "job.csv")) as fh:
            assert fh.readline().strip() == "step,acc,loss"
        assert svc.stop("nick") and not svc.stop("nick")
    finally:
        svc.close()


def test_builder_worker_count_validation(api):
    fn = "def f(rank, world_size):\n    return rank\n"

    def drive(side, base):
        return [requests.post(f"{base}/builder/tensorflow", json={
            "name": name, "function": fn, "nWorkers": n}).status_code
            for name, n in (("w0", 0), ("wbig", 10_000_000))]

    assert both(drive) == {"jax": [406, 406], "port": [406, 406]}


def test_builder_rejects_toplevel_side_effects(api):
    code = ("def f(rank, world_size):\n    return rank\n"
            "print('side effect at exec time')\n")
    code_ok = '"""doc"""\ndef f(rank, world_size):\n    return rank\n'

    def drive(side, base):
        return [requests.post(f"{base}/builder/tensorflow", json={
            "name": name, "function": fn, "nWorkers": 1}).status_code
            for name, fn in (("wside", code), ("wdoc", code_ok))]

    assert both(drive) == {"jax": [406, 201], "port": [406, 201]}


def test_distributed_train_patch_rerun(api, dataset):
    """PATCH re-runs a finished job fresh with new parameters (history
    rows replaced, not appended); a bare PATCH re-applies the recorded
    request."""

    def drive(side, base):
        _model(base, "dp_mlp", [8])
        resp = requests.post(f"{base}/train/horovod", json={
            "name": "dp_fit", "parentName": "dp_mlp",
            "trainingParameters": {"x": "$dd_X", "y": "$dd.label",
                                   "epochs": 2, "batch_size": 16}})
        assert resp.status_code == 201, resp.text
        poll(base, "/train/horovod/dp_fit")
        seen = []
        for body in ({"trainingParameters": {
                "x": "$dd_X", "y": "$dd.label", "epochs": 3,
                "batch_size": 16}}, {}):
            resp = requests.patch(f"{base}/train/horovod/dp_fit", json=body)
            assert resp.status_code == 200, resp.text
            assert poll(base, "/train/horovod/dp_fit")["finished"]
            seen.append(sorted(d["epoch"] for d in _epochs(base, "dp_fit")))
        return seen

    assert both(drive) == {side: [[0, 1, 2], [0, 1, 2]] for side in SIDES}


def test_distributed_train_rejects_raw_checkpoint_dir(api, dataset):
    assert both(lambda side, base: requests.post(
        f"{base}/train/horovod", json={
            "name": "dp_evil", "parentName": "dp_mlp",
            "trainingParameters": {"checkpoint_dir": "/srv/data"}},
    ).status_code) == {"jax": 406, "port": 406}


def test_collection_get_lists_distributed_artifacts(api, dataset):
    """GET /train/horovod lists what its POST stored (type
    train/tensorflow), as GET /train/tensorflow does."""

    def drive(side, base):
        _model(base, "lmodel", [4])
        resp = requests.post(f"{base}/train/horovod", json={
            "name": "ltrain", "parentName": "lmodel",
            "trainingParameters": {"x": "$dd_X", "y": "$dd.label",
                                   "epochs": 1, "batch_size": 16}})
        assert resp.status_code == 201, resp.text
        poll(base, "/train/horovod/ltrain")
        out = {}
        for family in ("train/horovod", "train/tensorflow",
                       "builder/pytorch"):
            docs = requests.get(f"{base}/{family}").json()
            assert not any(d.get("hidden") for d in docs)
            out[family] = sorted(d.get("name") for d in docs)
        return out

    out = both(drive)
    assert out["port"] == out["jax"]
    assert "ltrain" in out["port"]["train/horovod"]
    assert out["port"]["train/horovod"] == out["port"]["train/tensorflow"]
    assert "dbuild" in out["port"]["builder/pytorch"]


def test_monitoring_external_host_advertised(tmp_path):
    svc = MonitoringService(str(tmp_path / "mon"),
                            external_host="node.example.com")
    try:
        assert svc.host == "0.0.0.0"
        assert svc.advertised_url(6006) == "http://node.example.com:6006/"
        info = svc.start("ext", spawn_tensorboard=False)
        assert info["url"] is None  # no process -> logdir-only
        local = MonitoringService(str(tmp_path / "mon2"))
        assert local.host == "127.0.0.1"
        assert local.advertised_url(6006) == "http://127.0.0.1:6006/"
    finally:
        svc.close()


def test_recovery_redispatches_distributed_train(tmp_path, monkeypatch):
    """A journaled running distributed train re-runs through the
    distributed PATCH on both packages (the executor's is not called);
    a distributed builder is orphaned on both."""
    called = {side: [] for side in SIDES}
    for side, dist_mod, exec_mod in (("jax", jax_dist, jax_executor),
                                     ("port", port_dist, port_executor)):
        monkeypatch.setattr(
            dist_mod.DistributedExecutorService, "update_train",
            lambda self, name, _c=called[side], **kw: _c.append(
                ("distributed", name, kw)))
        monkeypatch.setattr(
            exec_mod.ExecutorService, "update",
            lambda self, name, _c=called[side], **kw: _c.append(
                ("executor", name, kw)))
    store = JaxStore(tmp_path / "jax" / "store")
    meta = JaxMeta(store)
    meta.create("dfit", "train/tensorflow", parent_name="m", method="fit",
                extra={"distributed": True, "mesh": {}})
    meta.create("dbuild", "builder/horovod", method="f",
                extra={"worldSize": 2})
    journal = JaxJournal(store, tmp_path / "jax" / "store")
    for name, method in (("dfit", "fit"), ("dbuild", "f")):
        meta.mark_running(name)
        journal.record_submit(name, job_class="distributed", method=method,
                              description=f"{name} run")
        journal.append("running", name, attempt=1)
    journal.close()
    store.close()
    (tmp_path / "jax" / "vol").mkdir()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    metas, _ = _boot_both(tmp_path, ["dfit", "dbuild"])
    for side in SIDES:
        assert called[side] == [
            ("distributed", "dfit", {"description": "dfit run"})], side
        assert metas[side]["dbuild"]["jobState"] == "failed"
    assert metas["port"]["dbuild"]["exception"] == \
        metas["jax"]["dbuild"]["exception"]


def test_rank_devices_follow_the_context_device():
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert port_dist.rank_devices(cpu, [], 2) == ["cpu", "cpu"]
    assert port_dist.rank_devices(card, ["cuda:1", "cuda:0"], 2) == [
        "cuda:1", "cuda:0"]
    with pytest.raises(RuntimeError, match="leased no card"):
        port_dist.rank_devices(card, [], 2)


# -- the kill-9 drill of a distributed fit ------------------------------------

DRILL_EPOCHS = 6

_DRILL_SERVER = r"""
import json, os, signal, sys, time
import numpy as np
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.distributed_exec import (
    DistributedExecutorService)
from learningorchestra_tpu_torch.services.model import ModelService

ctx = ServiceContext(Config.from_env(), device="cpu")
rng = np.random.default_rng(0)
x = rng.standard_normal((2048, 16)).astype("float32")
y = (x.sum(1) > 0).astype("int32")
ModelService(ctx).create(
    "m", module_path="learningorchestra_tpu.models.mlp",
    class_name="MLPClassifier",
    class_parameters={"hidden_layer_sizes": [32], "num_classes": 2})
ctx.engine.wait("m", timeout=60)
DistributedExecutorService(ctx).create_train(
    "dfit", parent_name="m", training_parameters={
        "x": x.tolist(), "y": y.tolist(), "epochs": int(sys.argv[1]),
        "batch_size": 8, "checkpoint_every": 1,
        "checkpoint_min_interval_s": 0, "checkpoint_async": False})
marker = ctx.checkpoint_dir("dfit") / "latest.json"
deadline = time.time() + 90
while time.time() < deadline:
    try:
        if json.loads(marker.read_text()).get("step", 0) >= 1:
            break
    except (OSError, ValueError):
        pass
    time.sleep(0.02)
else:
    print("NO_CHECKPOINT", flush=True)
    sys.exit(3)
me, ranks = str(os.getpid()), []
for pid in filter(str.isdigit, os.listdir("/proc")):
    try:
        stat = open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()
        cmd = open(f"/proc/{pid}/cmdline", "rb").read()
    except OSError:
        continue
    if stat[1] == me and b"parallel.rank" in cmd:
        ranks.append(int(pid))
print("RANKS " + json.dumps(sorted(ranks)), flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""

_DRILL_RECOVERY = r"""
import json, time
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext

ctx = ServiceContext(Config.from_env(), device="cpu")  # recovers dfit
deadline = time.time() + 120
meta = {}
while time.time() < deadline:
    meta = ctx.artifacts.metadata.read("dfit") or {}
    if meta.get("finished") or meta.get("jobState") == "failed":
        break
    time.sleep(0.05)
history = ctx.documents.find("dfit", query={"docType": "history"})
print("RESULT " + json.dumps({
    "jobState": meta.get("jobState"), "exception": meta.get("exception"),
    "meshDevices": meta.get("meshDevices"), "history": len(history)}),
    flush=True)
ctx.close()
"""


def _alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_kill9_of_a_distributed_fit_leaves_no_rank_and_recovers(tmp_path):
    """The server dies by SIGKILL mid-fit: both of its ranks die with it
    (no orphan goes on writing the checkpoints), and the next boot
    resumes the job through the distributed PATCH to its end."""
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "LO_TPU_STORE_ROOT": str(tmp_path / "store"),
           "LO_TPU_VOLUME_ROOT": str(tmp_path / "vol"),
           "LO_TPU_CPU_RANKS": "2"}
    ranks: list = []
    try:
        first = subprocess.run(
            [sys.executable, "-c", _DRILL_SERVER, str(DRILL_EPOCHS)],
            env=env, capture_output=True, text=True, timeout=180)
        assert first.returncode == -signal.SIGKILL, (
            first.returncode, first.stdout[-2000:], first.stderr[-2000:])
        ranks = json.loads(first.stdout.split("RANKS ", 1)[1])
        assert len(ranks) == 2, first.stdout
        deadline = time.monotonic() + 3  # SIGKILLed with it: at once
        while any(map(_alive, ranks)) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(map(_alive, ranks)), "a rank outlived its server"
        marker = tmp_path / "vol" / "_checkpoints" / "dfit" / "latest.json"
        step = json.loads(marker.read_text())["step"]
        assert 1 <= step < DRILL_EPOCHS  # killed mid-fit
        # The dead fit's staging directory (its staged inputs) is left
        # under the server's stage root, never in the bare TMPDIR.
        stage_root = tmp_path / "vol" / "_dist_stage"
        left = [p.name for p in stage_root.iterdir()]
        assert len(left) == 1 and left[0].startswith(STAGE_PREFIX), left
        second = subprocess.run([sys.executable, "-c", _DRILL_RECOVERY],
                                env=env, capture_output=True, text=True,
                                timeout=180)
        assert second.returncode == 0, second.stderr[-3000:]
        result = json.loads(second.stdout.split("RESULT ", 1)[1])
        assert result["jobState"] == "finished", result
        assert result["meshDevices"] == 2
        assert result["history"] == DRILL_EPOCHS
        # The boot removed the dead fit's stage; the recovered fit's own
        # went when it finished.
        assert list(stage_root.iterdir()) == []
    finally:
        for pid in ranks:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
