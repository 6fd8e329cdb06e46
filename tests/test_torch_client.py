"""The port's client (``learningorchestra_tpu_torch/client.py``) against the
JAX package's (``learningorchestra_tpu/client.py``):

- every public method of every service binding, and the ``Context``
  conveniences, send the same requests from both clients, byte for byte
  (verb, path, query, body, ``X-Idempotency-Key``, ``X-Tenant``), as a
  local ``http.server`` records them;
- the addresses a ``Context`` accepts resolve alike;
- the JAX client suite's pipeline (``tests/test_client.py``) runs through
  the port's client against a port server: ingest, projection,
  histogram, model, fit, predict, the 409 and 404 surfaces, functions and
  their failures, delete, a PATCH re-run's fresh history, the metrics
  view, and the cluster and locks views.
"""

import contextlib
import inspect
import itertools
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from learningorchestra_tpu import client as jax_client
from learningorchestra_tpu_torch import client as port_client
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.client import ClientError, Context
from learningorchestra_tpu_torch.config import Config, StoreConfig

#: A value for each required argument name of a client method.
ARGS = {
    "name": "n1", "dataset_name": "ds", "projection_name": "pj",
    "histogram_name": "h1", "model_name": "mm", "url": "file:///d.csv",
    "labels_url": "file:///l.npy", "fields": ["a", "b"],
    "types": {"a": "number"}, "train_name": "t1", "module_path": "m.p",
    "class_name": "C", "text_field": "text", "parent_name": "p1",
    "training_parameters": {"epochs": 1}, "function": "response = 1",
    "train_dataset": "tr", "test_dataset": "te", "classifiers": ["LR"],
    "nickname": "nick", "hook_id": 3, "instances": [[1, 2]],
    "prompts": [[1, 2]], "model": "m1", "stream_id": "s1",
    "path": "a.json", "capture": "c1", "kind": "latency", "target": 0.99,
    "point": "serve.apply", "mode": "error", "service_path": "dataset/csv",
}
#: Requests recorded per call at most: a polling method gets 500s past it.
MAX_REQUESTS = 4


class _Recorder:
    """A local server that records every request and answers a JSON
    document most bindings accept (a finished artifact)."""

    def __init__(self):
        self.log: list = []
        rec = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _any(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                rec.log.append((
                    self.command, self.path, body,
                    self.headers.get("Content-Type"),
                    self.headers.get("X-Idempotency-Key"),
                    self.headers.get("X-Tenant")))
                if len(rec.log) > MAX_REQUESTS:
                    status, doc = 500, {"error": "enough"}
                else:
                    status, doc = 200, {
                        "result": "r", "name": "n1", "finished": True,
                        "metadata": {"finished": True, "name": "n1",
                                     "jobState": "finished"}}
                data = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PATCH = do_DELETE = _any

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def recorder():
    rec = _Recorder()
    yield rec
    rec.close()


def _methods():
    ctx = Context("http://127.0.0.1:1")
    out = [("Context", name) for name in
           ("metadata", "metrics", "search")]
    for attr, svc in vars(ctx).items():
        if hasattr(svc, "ctx"):
            out += [(attr, name) for name, _ in
                    inspect.getmembers(svc, inspect.ismethod)
                    if not name.startswith("_")]
    return out


def _call(module, recorder, attr: str, name: str):
    """The requests one client method sends (with deterministic keys)."""
    counter = itertools.count()
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    recorder.log.clear()
    try:
        ctx = module.Context(recorder.base, failover="127.0.0.1:9",
                             tenant="tenant-a", request_timeout=5)
        target = ctx if attr == "Context" else getattr(ctx, attr)
        fn = getattr(target, name)
        params = inspect.signature(fn).parameters.values()
        args = [ARGS[p.name] for p in params
                if p.default is inspect.Parameter.empty
                and p.kind is p.POSITIONAL_OR_KEYWORD]
        kwargs = {p.name: ARGS[p.name] for p in params
                  if p.default is inspect.Parameter.empty
                  and p.kind is p.KEYWORD_ONLY}
        with contextlib.suppress(Exception):
            result = fn(*args, **kwargs)
            if inspect.isgenerator(result):
                list(itertools.islice(result, 2))
    finally:
        uuid.uuid4 = real
    return list(recorder.log)


@pytest.mark.parametrize("attr,name", _methods(),
                         ids=lambda v: str(v))
def test_every_method_sends_the_jax_request(recorder, attr, name):
    port = _call(port_client, recorder, attr, name)
    jax = _call(jax_client, recorder, attr, name)
    assert port, f"{attr}.{name} sent nothing"
    assert port == jax


@pytest.mark.parametrize("cluster", [
    "10.0.0.5", "10.0.0.5:8080", "http://h:1/", "gw:8080/tenant-a", "::1",
    "[::1]:8000", "2001:db8::1", "localhost"])
def test_addresses_resolve_as_in_the_jax_client(cluster):
    assert port_client.Context(cluster).base == jax_client.Context(
        cluster).base


# -- the JAX client suite's pipeline on the port -----------------------------


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("client")
    server = APIServer(Config(store=StoreConfig(
        root=str(tmp / "store"), volume_root=str(tmp / "volumes"))),
        device="cpu")
    port = server.start_background()
    rng = np.random.default_rng(0)
    csv = tmp / "data.csv"
    with open(csv, "w") as fh:
        fh.write("f1,f2,label\n")
        for _ in range(300):
            a, b = rng.random(), rng.random()
            fh.write(f"{a:.4f},{b:.4f},{int(a + b > 1)}\n")
    yield Context(f"http://127.0.0.1:{port}"), str(csv)
    server.shutdown()


def test_full_pipeline(ctx):
    client, csv = ctx
    assert client.dataset_csv.insert("cds", f"file://{csv}")
    meta = client.observe.wait("cds", timeout=60)
    assert meta["finished"] and meta["rows"] == 300
    client.projection.create("cds_x", "cds", ["f1", "f2"])
    client.observe.wait("cds_x", timeout=60)
    client.histogram.create("cds_hist", "cds", ["label"])
    client.histogram.wait("cds_hist", timeout=60)
    rows = client.histogram.search("cds_hist", limit=10)
    counts = [d for d in rows if d.get("field") == "label"]
    assert counts and sum(counts[0]["counts"].values()) == 300
    client.model.create(
        "cmlp", module_path="learningorchestra_tpu.models.mlp",
        class_name="MLPClassifier",
        class_parameters={"hidden_layer_sizes": [8], "num_classes": 2})
    client.model.wait("cmlp", timeout=60)
    client.train.create("cfit", model_name="cmlp", method="fit",
                        method_parameters={"x": "$cds_x", "y": "$cds.label",
                                           "epochs": 2, "batch_size": 64})
    assert client.train.wait("cfit", timeout=180)["finished"]
    client.predict.create("cpred", parent_name="cfit", method="predict",
                          method_parameters={"x": "$cds_x"})
    assert client.predict.wait("cpred", timeout=120)["finished"]
    assert len(client.predict.search("cpred", limit=5)) >= 2


def test_duplicate_and_missing_are_client_errors(ctx):
    client, csv = ctx
    client.dataset_csv.insert("dup", f"file://{csv}")
    client.observe.wait("dup", timeout=60)
    with pytest.raises(ClientError) as exc:
        client.dataset_csv.insert("dup", f"file://{csv}")
    assert exc.value.status == 409
    with pytest.raises(ClientError) as exc:
        client.train.search("never-existed")
    assert exc.value.status == 404


def test_function_failure_and_delete(ctx):
    client, _ = ctx
    client.function.create("cfn", function="response = sum(range(10))")
    assert client.observe.wait("cfn", timeout=60)["finished"]
    client.function.create("cboom", function="raise RuntimeError('x')")
    assert client.observe.wait("cboom", timeout=60)["jobState"] == "failed"
    client.function.create("ctmp", function="response = 1")
    client.observe.wait("ctmp", timeout=60)
    client.function.delete("ctmp")
    with pytest.raises(ClientError) as exc:
        client.function.search("ctmp")
    assert exc.value.status == 404


def test_train_patch_rerun_is_fresh_and_undup(ctx):
    client, csv = ctx
    client.dataset_csv.insert("pds", f"file://{csv}")
    client.observe.wait("pds", timeout=60)
    client.projection.create("pds_x", "pds", ["f1", "f2"])
    client.observe.wait("pds_x", timeout=60)
    client.model.create(
        "ckmlp", module_path="learningorchestra_tpu.models.mlp",
        class_name="MLPClassifier",
        class_parameters={"hidden_layer_sizes": [8], "num_classes": 2})
    client.model.wait("ckmlp", timeout=60)
    params = {"x": "$pds_x", "y": "$pds.label", "batch_size": 64}
    client.train.create("ckfit", model_name="ckmlp", method="fit",
                        method_parameters={**params, "epochs": 2})
    client.train.wait("ckfit", timeout=120)
    rows = client.train.search("ckfit", limit=50)
    assert len([d for d in rows if "epoch" in d]) == 2
    client.train.update("ckfit", method_parameters={**params, "epochs": 4})
    assert client.train.wait("ckfit", timeout=120)["finished"]
    hist = [d for d in client.train.search("ckfit", limit=50)
            if "epoch" in d]
    assert sorted(d["epoch"] for d in hist) == [0, 1, 2, 3]


def test_metrics_cluster_and_locks_views(ctx):
    client, _ = ctx
    metrics = client.metrics()
    assert "routes" in metrics and "budget" in metrics
    assert client.cluster.status() == {"enabled": False, "engines": [],
                                       "claims": []}
    assert set(client.observability.locks()) >= {
        "enabled", "edges", "events", "locks", "stalls"}
