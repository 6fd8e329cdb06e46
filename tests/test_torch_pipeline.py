"""The port's REST pipeline against the JAX package's, on the CPU.

One JAX ``APIServer`` and one port ``APIServer(device="cpu")`` receive the
same drive through the JAX package's ``client.py`` (so the client also
proves it works unchanged against the port): ingest a seeded token CSV
(40 rows, T=16, vocab 64), project its token columns, create a small BERT
(2 layers, hidden 32, 2 heads), carry the JAX model's initial weights into
the port's model binary (both in f32 compute), then fit with
``shuffle: false``, evaluate and predict.  Then the failure path, the
``checkpoint_dir`` 406, the duplicate-name 409, an unknown-route 404 and a
PATCH re-run, on both.

Held to: equal HTTP status sequences; history losses, evaluate metrics
and predict rows within 1e-4; equal metadata key sets except the keys of
layers the port does not carry (``UNPORTED_KEYS``); equal lineage.  Also
here: a train job continues its parent train job's trajectory, an
unbuilt ``MLPClassifier`` model artifact round-trips and trains, a
REST-trained job serves over ``/serve`` and reloads after a PATCH
re-run, and the port's ``Frame``
matches ``pandas.DataFrame(docs).to_numpy()`` on mixed columns.
"""

import contextlib
import urllib.error
import urllib.request

import jax.numpy as jnp
import jax.tree_util
import numpy as np
import pandas as pd
import pytest

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.client import ClientError, Context
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.services.frame import Frame

T, VOCAB, ROWS = 16, 64, 40
BERT = dict(vocab_size=VOCAB, hidden_dim=32, num_layers=2, num_heads=2,
            max_len=T, num_classes=2)
TOL = dict(atol=1e-4, rtol=1e-4)
#: Metadata / execution-document keys left out of the comparisons: the
#: request id and span records (minted per run on each side), the compile
#: cache's counters and device-time accounting (per-process values).
UNPORTED_KEYS = {"requestId", "compileCache", "deviceTime", "trace"}
FIELDS = [f"t{i}" for i in range(T)]


def _write_csv(path):
    rng = np.random.default_rng(11)
    x = rng.integers(1, VOCAB, (ROWS, T))
    for r, n in enumerate(rng.integers(4, T + 1, ROWS)):
        x[r, n:] = 0
    x[3] = 0  # an all-pad row
    with open(path, "w") as fh:
        fh.write(",".join(FIELDS + ["label"]) + "\n")
        for row in x:
            fh.write(",".join(map(str, row)) + f",{row[0] % 2}\n")
    return x


@contextlib.contextmanager
def _recording(log):
    """Record (verb, path, status) of every request the client sends,
    leaving the long polls out (their count depends on timing)."""
    real = urllib.request.urlopen

    def urlopen(req, *args, **kwargs):
        path = req.full_url.split("/v1", 1)[1].split("?")[0]
        entry = [req.get_method(), path, None]
        if not path.startswith("/observe/"):
            log.append(entry)
        try:
            resp = real(req, *args, **kwargs)
        except urllib.error.HTTPError as exc:
            entry[2] = exc.code
            raise
        entry[2] = resp.status
        return resp

    urllib.request.urlopen = urlopen
    try:
        yield
    finally:
        urllib.request.urlopen = real


def _status(call):
    try:
        call()
    except ClientError as exc:
        return exc.status
    return 200


def _carry_weights(jax_srv, port_srv, x):
    """The JAX model binary gets initial params (flax has none before the
    first fit); the port's binary gets the same, both in f32 compute."""
    jest = jax_srv.ctx.volumes.read_object("model/tensorflow", "bert")
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1].astype(np.int32)))
    jax_srv.ctx.volumes.save_object("model/tensorflow", "bert", jest)
    pest = port_srv.ctx.volumes.load_estimator(
        "model/tensorflow", "bert", device="cpu")
    pest.load_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jest.params)})
    pest.compute_dtype = "float32"
    port_srv.ctx.volumes.save_estimator("model/tensorflow", "bert", pest)


def _setup(c, csv, out):
    """Ingest, project and create the model."""
    c.dataset_csv.insert("tok", f"file://{csv}")
    out["csv"] = c.observe.wait("tok", 60)
    out["dup"] = _status(lambda: c.dataset_csv.insert("tok", f"file://{csv}"))
    c.projection.create("tokx", "tok", FIELDS)
    out["proj"] = c.observe.wait("tokx", 60)
    c.model.create("bert", module_path="learningorchestra_tpu.models.text",
                   class_name="BertModel", class_parameters=BERT)
    out["model"] = c.observe.wait("bert", 60)
    # An MLP is sized by its first input: its model binary is unbuilt.
    c.model.create("mlp", module_path="learningorchestra_tpu.models.mlp",
                   class_name="MLPClassifier",
                   class_parameters={"hidden_layer_sizes": [8],
                                     "num_classes": 2})
    out["mlp"] = c.observe.wait("mlp", 60)


def _run(c, out):
    """Train, evaluate, predict, the failure paths and a PATCH re-run."""
    fit = {"x": "$tokx", "y": "$tok.label", "epochs": 2, "batch_size": 8,
           "shuffle": False}
    c.train.create("fit", model_name="bert", method="fit",
                   method_parameters=fit)
    out["fit"] = c.observe.wait("fit", 120)
    out["history"] = c.train.search("fit", limit=20)[1:]
    c.evaluate.create("ev", parent_name="fit", method="evaluate",
                      method_parameters={"x": "$tokx", "y": "$tok.label"})
    out["ev"] = c.observe.wait("ev", 60)
    out["ev_rows"] = c.evaluate.search("ev")[1:]
    c.predict.create("pr", parent_name="fit", method="predict",
                     method_parameters={"x": "$tokx"})
    out["pr"] = c.observe.wait("pr", 60)
    out["pr_rows"] = c.predict.search("pr", limit=100)[1:]
    # A train job whose parent is a finished train job continues its
    # trajectory: optimizer state and history ride in the f32 artifact.
    c.train.create("cont", parent_name="fit", method="fit",
                   method_parameters={**fit, "epochs": 1})
    out["cont"] = c.observe.wait("cont", 120)
    out["cont_history"] = c.train.search("cont", limit=20)[1:]
    c.train.create("mlpfit", model_name="mlp", method="fit",
                   method_parameters={**fit, "epochs": 1})
    out["mlpfit"] = c.observe.wait("mlpfit", 60)
    # Failure path: a column the dataset does not have.
    c.train.create("bad", model_name="bert", method="fit",
                   method_parameters={**fit, "x": "$tok.nosuch"})
    out["bad"] = c.observe.wait("bad", 60)
    out["bad_rows"] = c.train.search("bad")[1:]
    out["ckpt"] = _status(lambda: c.train.create(
        "ck", model_name="bert", method="fit",
        method_parameters={**fit, "checkpoint_dir": "/tmp/x"}))
    out["route"] = _status(lambda: c.request("GET", "/no/such/route"))
    out["missing"] = _status(lambda: c.train.update("ghost"))
    out["listed"] = sorted(d["name"] for d in c.request(
        "GET", "/train/tensorflow"))
    # Bare PATCH re-run: the ledger's last parameters, a fresh fit from
    # the model.
    c.train.update("fit")
    out["rerun"] = c.observe.wait("fit", 120)
    out["rerun_history"] = c.train.search("fit", limit=20)[1:]
    out["meta"] = {
        name: c.metadata(path, name) for path, name in (
            ("dataset/csv", "tok"), ("transform/projection", "tokx"),
            ("model/tensorflow", "bert"), ("model/tensorflow", "mlp"),
            ("train/tensorflow", "fit"), ("train/tensorflow", "mlpfit"),
            ("train/tensorflow", "cont"),
            ("evaluate/tensorflow", "ev"), ("predict/tensorflow", "pr"),
            ("train/tensorflow", "bad"))
    }


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    csv = tmp / "tokens.csv"
    x = _write_csv(csv)
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp / "jax" / "store")
    jcfg.store.volume_root = str(tmp / "jax" / "volumes")
    jcfg.store.backend = "python"
    servers = {
        "jax": JaxServer(jcfg),
        "port": APIServer(Config(store=StoreConfig(
            root=str(tmp / "port" / "store"),
            volume_root=str(tmp / "port" / "volumes"))), device="cpu"),
    }
    try:
        clients = {side: Context(f"http://127.0.0.1:{srv.start_background()}")
                   for side, srv in servers.items()}
        outs = {side: {"log": []} for side in servers}
        for side, c in clients.items():
            with _recording(outs[side]["log"]):
                _setup(c, csv, outs[side])
        _carry_weights(servers["jax"], servers["port"], x)
        for side, c in clients.items():
            with _recording(outs[side]["log"]):
                _run(c, outs[side])
        yield outs, servers["port"], clients["port"]
    finally:
        for srv in servers.values():
            srv.shutdown()


def test_http_statuses_are_equal(drives):
    outs, _, _ = drives
    assert outs["port"]["log"] == outs["jax"]["log"]
    assert [outs["port"][k] for k in ("dup", "ckpt", "route", "missing")] \
        == [409, 406, 404, 404]


def test_losses_metrics_and_predictions_agree(drives):
    outs, _, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    for out in (jax_out, port_out):
        assert out["fit"]["jobState"] == out["rerun"]["jobState"] == \
            "finished"
    for key in ("history", "rerun_history", "cont_history"):
        rows = {s: [r for r in o[key] if r.get("docType") == "history"]
                for s, o in outs.items()}
        assert [r["epoch"] for r in rows["port"]] == \
            ([0, 1, 2] if key == "cont_history" else [0, 1])
        for metric in ("loss", "accuracy"):
            np.testing.assert_allclose(
                [r[metric] for r in rows["port"]],
                [r[metric] for r in rows["jax"]], **TOL)
    # The re-run starts again from the model: the same trajectory.
    np.testing.assert_allclose(
        [r["loss"] for r in port_out["rerun_history"] if "loss" in r],
        [r["loss"] for r in port_out["history"] if "loss" in r], **TOL)
    ev = {s: o["ev_rows"][0] for s, o in outs.items()}
    assert set(ev["port"]) == set(ev["jax"])
    for metric in ("loss", "accuracy"):
        np.testing.assert_allclose(ev["port"][metric], ev["jax"][metric],
                                   **TOL)
    preds = {s: np.asarray([r["result"] for r in o["pr_rows"]
                            if "result" in r]) for s, o in outs.items()}
    assert preds["port"].shape == (ROWS, 2)
    np.testing.assert_allclose(preds["port"], preds["jax"], **TOL)


def test_metadata_keys_and_lineage_agree(drives):
    outs, _, _ = drives
    for name, want in outs["jax"]["meta"].items():
        got = outs["port"]["meta"][name]
        assert set(got) - UNPORTED_KEYS == set(want) - UNPORTED_KEYS, name
        assert got.get("parentName") == want.get("parentName"), name
        assert (got["type"], got["jobState"], got["finished"]) == \
            (want["type"], want["jobState"], want["finished"]), name
    for key in ("csv", "proj"):
        for field in ("fields", "rows"):
            assert outs["port"][key][field] == outs["jax"][key][field]
    for key in ("history", "bad_rows"):
        assert [set(d) - UNPORTED_KEYS for d in outs["port"][key]] == \
            [set(d) - UNPORTED_KEYS for d in outs["jax"][key]], key
    assert outs["port"]["listed"] == outs["jax"]["listed"]


def test_failure_path_records_the_exception(drives):
    outs, _, _ = drives
    for out in outs.values():
        assert out["bad"]["jobState"] == "failed"
        execution = [d for d in out["bad_rows"]
                     if d.get("docType") == "execution"]
        assert execution[-1]["state"] == "failed"
        assert "nosuch" in execution[-1]["exception"]
    assert outs["port"]["mlpfit"]["jobState"] == "finished"


def test_unbuilt_model_artifact_round_trips(drives):
    _, port_srv, _ = drives
    vols = port_srv.ctx.volumes
    doc = vols.read_object("model/tensorflow", "mlp")
    assert doc["state"] is None
    est = vols.load_estimator("model/tensorflow", "mlp", device="cpu")
    assert not est._built()
    assert est.to_artifact()["state"] is None
    # The train job built it at its first fit, from the projection.
    trained = vols.load_estimator("train/tensorflow", "mlpfit", device="cpu")
    assert trained._built() and len(trained.history["loss"]) == 1


def test_rest_trained_job_serves_and_reloads_after_a_rerun(drives):
    outs, port_srv, c = drives
    rows = np.asarray([r["result"] for r in outs["port"]["pr_rows"]
                       if "result" in r])
    x = port_srv.ctx.loader.load_frame("tokx").to_numpy()[:5].tolist()
    # Served under the train job's name (type train/tensorflow); the PATCH
    # re-run republished the same trajectory's weights.
    np.testing.assert_allclose(c.serve.predict("fit", x)["predictions"],
                               rows[:5], **TOL)
    # A re-run with other parameters replaces the binary: the resident
    # model reloads before the next predict.
    c.train.update("fit", method_parameters={
        "x": "$tokx", "y": "$tok.label", "epochs": 1, "batch_size": 8,
        "shuffle": False})
    assert c.observe.wait("fit", 120)["jobState"] == "finished"
    fresh = port_srv.ctx.volumes.load_estimator(
        "train/tensorflow", "fit", device="cpu").predict(np.asarray(x))
    got = np.asarray(c.serve.predict("fit", x)["predictions"])
    np.testing.assert_allclose(got, fresh, **TOL)
    assert np.abs(got - rows[:5]).max() > 1e-4


@pytest.mark.parametrize("docs", [
    [{"i": 1, "f": 1.5, "s": "x", "b": True, "n": None},
     {"i": 2, "f": 2, "s": None, "b": False, "n": None},
     {"i": 3, "f": 3.25, "s": "z", "b": True, "extra": "y"}],
    [{"a": 1, "b": 2}, {"a": 3, "b": 2 ** 63 - 1}],
    [{"a": 1, "b": 2.5}, {"a": None, "b": 1}],
    [{"a": True, "b": 1}, {"b": None}],
], ids=["mixed", "ints", "floats-with-missing", "bools-and-absent"])
def test_frame_matches_pandas(docs):
    want, got = pd.DataFrame(docs), Frame(docs)
    assert got.columns == list(want.columns) and len(got) == len(want)
    pairs = [(got.to_numpy(), want.to_numpy()),
             (np.asarray(got), np.asarray(want))] + [
        (got[c].to_numpy(), want[c].to_numpy()) for c in want.columns] + [
        (np.asarray(got[c]), np.asarray(want[c])) for c in want.columns]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        for u, v in zip(a.ravel(), b.ravel()):
            assert (u is None) == (v is None)
            assert u == v or (u != u and v != v), (u, v)
