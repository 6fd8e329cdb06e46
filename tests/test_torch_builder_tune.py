"""The port's Titanic pipeline against the JAX package's, over REST on the
CPU: the dataType cast, the generic transform, the builder and the grid
search tune.

One JAX ``APIServer`` and one port ``APIServer(device="cpu")`` receive the
same drive through the JAX package's ``client.py``: ingest a seeded
Titanic-shaped CSV (Kaggle ``train.csv``'s 12 columns, 96 rows, blank
``Age`` cells, mixed numeric/text ``Ticket``s) and a 32-row test CSV;
``PATCH /transform/dataType`` (Age and Fare to numbers, Ticket to
strings: the blank Age cells read ``None`` after it); a projection;
``POST /transform/scikitlearn`` ``StandardScaler.fit_transform`` and two
PATCH re-runs (bare, then with new class parameters); BASELINE config
1's RandomForest model / train / evaluate / predict; the builder over all
five classifiers with numpy modeling code, and again with modeling code
that fails; an RF tune over a 2x2 grid, a tune whose second combination
fails, and the ``checkpoint_dir`` 406; then a 2-trial tiny-BERT tune over
a token CSV.

Held to: equal HTTP status sequences; equal prediction rows, evaluate
scores, builder ``accuracy`` / ``F1`` and rows, RF trial scores and
``bestParams``; transform outputs within 1e-5 of their largest value.
For the neural tune: the same trial count, ``bestParams`` inside the grid
and equal metadata keys except ``UNPORTED_KEYS``; each package builds
fresh candidates from its own seeded init, so the two sides' scores are
not comparable.  Each side runs with one injected device lease, so its
two neural trials serialize on it (and must not deadlock), as on one
card.  (Unleased, the JAX package runs a CPU context's trials at once,
and their managed orbax checkpoints then fail now and then with
``FileExistsError`` or OCDBT ``NOT_FOUND``: ROADMAP C.)  Also
here: the port cancels a tune between trials, and refuses a
``builder/tensorflow`` payload that is not one function as the JAX
server does.
"""

import contextlib
import csv
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.client import ClientError, Context
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu.jobs.leases import DeviceLeaser as JaxLeaser
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
from learningorchestra_tpu_torch.toolkit.estimators import trees

#: Metadata keys left out of the comparisons: the request id and span
#: records (minted per run on each side), the compile cache's counters and
#: device-time accounting (per-process values).
UNPORTED_KEYS = {"requestId", "compileCache", "deviceTime", "trace"}
CLASSIFIERS = ["LogisticRegression", "DecisionTree", "RandomForest",
               "GradientBoosting", "NaiveBayes"]
FEATURES = ["Pclass", "SibSp", "Parch", "Fare"]
RF = {"modulePath": "sklearn.ensemble", "class": "RandomForestClassifier",
      "classParameters": {"n_estimators": 8, "max_depth": 4}}
FIT = {"x": "$titanic_scaled", "y": "$titanic.Survived"}
# The reference's modeling-code contract over what pandas DataFrames and
# the port's Frames share: column selection, to_numpy() and numpy.
MODELING_CODE = """
def prep(df):
    age = df["Age"].to_numpy().astype(float)
    age = np.where(np.isnan(age), np.nanmedian(age), age)
    sex = (df["Sex"].to_numpy() == "female").astype(float)
    emb = df["Embarked"].to_numpy()
    port = np.select([emb == "C", emb == "Q"], [1.0, 2.0], 0.0)
    cols = [df[c].to_numpy().astype(float)
            for c in ("Pclass", "SibSp", "Parch", "Fare")]
    return np.stack(cols + [age, sex, port], axis=1)

features_training = prep(training_df)
features_testing = prep(testing_df)
"""
TOKENS_T, TOKENS_VOCAB, TOKENS_ROWS = 8, 32, 24
BERT = dict(vocab_size=TOKENS_VOCAB, hidden_dim=16, num_layers=1,
            num_heads=2, max_len=TOKENS_T, num_classes=2)


def write_titanic(path, n, seed):
    """A seeded CSV at Kaggle ``train.csv``'s schema: 12 columns, about a
    fifth of ``Age`` blank, text and numeric ``Ticket``s, two blank
    ``Embarked``; survival follows sex, class and age."""
    rng = np.random.default_rng(seed)
    pclass = rng.choice([1, 2, 3], n, p=[0.24, 0.21, 0.55])
    female = rng.random(n) < 0.35
    age = np.clip(rng.normal(29.7, 14.5, n), 0.42, 80.0)
    age_blank = rng.random(n) < 177 / 891
    fare = np.round(rng.lognormal(np.log([80.0, 20.0, 9.0])[pclass - 1],
                                  0.5), 4)
    logit = 2.5 * female - 0.9 * (pclass - 2) - 0.02 * (age - 30)
    survived = rng.random(n) < 1 / (1 + np.exp(-logit))
    embarked = rng.choice(["S", "C", "Q"], n, p=[0.72, 0.19, 0.09])
    embarked[rng.choice(n, 2, replace=False)] = ""
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["PassengerId", "Survived", "Pclass", "Name", "Sex",
                      "Age", "SibSp", "Parch", "Ticket", "Fare", "Cabin",
                      "Embarked"])
        for i in range(n):
            ticket = (f"A/5 {rng.integers(1000, 99999)}" if i % 3 == 0
                      else str(rng.integers(10000, 400000)))
            out.writerow([
                i + 1, int(survived[i]), pclass[i],
                f"Passenger{i}, Mr. X{i}", "female" if female[i] else "male",
                "" if age_blank[i] else (int(age[i]) if i % 2 else
                                         round(float(age[i]), 1)),
                rng.choice([0, 0, 0, 1, 2]), rng.choice([0, 0, 1, 2]),
                ticket, fare[i], f"C{i}" if i % 5 == 0 else "",
                embarked[i]])


def write_tokens(path):
    rng = np.random.default_rng(5)
    x = rng.integers(1, TOKENS_VOCAB, (TOKENS_ROWS, TOKENS_T))
    with open(path, "w") as fh:
        fh.write(",".join(f"t{i}" for i in range(TOKENS_T)) + ",label\n")
        for row in x:
            fh.write(",".join(map(str, row)) + f",{row[0] % 2}\n")


@contextlib.contextmanager
def _recording(log):
    """(verb, path, status) of every request but the long polls."""
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


def _rows(c, path, name, limit=100):
    return [d for d in c.request("GET", f"/{path}/{name}",
                                 query={"limit": limit})
            if d.get("_id", 0) >= 1 and d.get("docType") != "execution"]


def _drive(c, tmp, out):
    c.dataset_csv.insert("titanic", f"file://{tmp}/titanic.csv")
    c.dataset_csv.insert("titanic_test", f"file://{tmp}/titanic_test.csv")
    c.dataset_csv.insert("tok", f"file://{tmp}/tokens.csv")
    for name in ("titanic", "titanic_test", "tok"):
        out[f"csv_{name}"] = c.observe.wait(name, 60)
    out["raw_rows"] = _rows(c, "dataset/csv", "titanic")
    # dataType: Age/Fare to numbers, Ticket to strings, on both datasets.
    for name in ("titanic", "titanic_test"):
        c.data_type.update(name, {"Age": "number", "Fare": "number",
                                  "Ticket": "string"})
        out[f"cast_{name}"] = c.observe.wait(name, 60)
    out["cast_rows"] = _rows(c, "dataset/csv", "titanic")
    out["bad_type"] = _status(lambda: c.data_type.update(
        "titanic", {"Age": "float"}))
    c.projection.create("titanic_x", "titanic", FEATURES)
    out["proj"] = c.observe.wait("titanic_x", 60)
    c.transform_sklearn.create(
        "titanic_scaled", module_path="sklearn.preprocessing",
        class_name="StandardScaler", method="fit_transform",
        method_parameters={"x": "$titanic_x"})
    out["scaled"] = c.observe.wait("titanic_scaled", 60)
    c.transform_sklearn.update("titanic_scaled")  # bare PATCH re-run
    out["scaled_rerun"] = c.observe.wait("titanic_scaled", 60)
    # Config 1: RandomForest through the model / train / evaluate /
    # predict routes.
    c.request("POST", "/model/scikitlearn", {"name": "rf", **RF})
    out["rf"] = c.observe.wait("rf", 60)
    c.request("POST", "/train/scikitlearn", {
        "name": "rf_fit", "parentName": "rf", "method": "fit",
        "methodParameters": FIT})
    out["rf_fit"] = c.observe.wait("rf_fit", 60)
    c.request("POST", "/evaluate/scikitlearn", {
        "name": "rf_eval", "parentName": "rf_fit", "method": "score",
        "methodParameters": FIT})
    out["rf_eval"] = c.observe.wait("rf_eval", 60)
    out["rf_eval_rows"] = _rows(c, "evaluate/scikitlearn", "rf_eval")
    c.request("POST", "/predict/scikitlearn", {
        "name": "rf_pred", "parentName": "rf_fit", "method": "predict",
        "methodParameters": {"x": "$titanic_scaled"}})
    out["rf_pred"] = c.observe.wait("rf_pred", 60)
    out["rf_pred_rows"] = _rows(c, "predict/scikitlearn", "rf_pred")
    # The builder: five classifiers at once, then failing modeling code.
    out["builder_uris"] = c.builder.create(
        train_dataset="titanic", test_dataset="titanic_test",
        classifiers=CLASSIFIERS, label_field="Survived",
        modeling_code=MODELING_CODE)["result"]
    out["builder"] = {clf: c.observe.wait(f"titanic_test{clf}", 120)
                      for clf in CLASSIFIERS}
    out["builder_rows"] = {clf: _rows(c, "builder/sparkml",
                                      f"titanic_test{clf}")
                           for clf in CLASSIFIERS}
    c.builder.create(train_dataset="titanic", test_dataset="titanic",
                     classifiers=CLASSIFIERS, label_field="Survived",
                     modeling_code='features_training = '
                                   'training_df["nosuch"].to_numpy()')
    out["builder_bad"] = {clf: c.observe.wait(f"titanic{clf}", 60)
                          for clf in CLASSIFIERS}
    out["builder_list"] = sorted(
        d["name"] for d in c.request("GET", "/builder/sparkml"))
    # Grid-search tunes: RF 2x2, a failing combination, checkpoint_dir.
    c.request("POST", "/tune/scikitlearn", {
        "name": "rf_tune", "parentName": "rf", "method": "fit",
        "paramGrid": {"n_estimators": [4, 8], "max_depth": [2, 4]},
        "methodParameters": FIT})
    out["rf_tune"] = c.observe.wait("rf_tune", 120)
    out["rf_tune_rows"] = _rows(c, "tune/scikitlearn", "rf_tune")
    c.request("POST", "/tune/scikitlearn", {
        "name": "rf_tune_bad", "parentName": "rf", "method": "fit",
        "paramGrid": {"max_depth": [2, "deep"]}, "methodParameters": FIT})
    out["rf_tune_bad"] = c.observe.wait("rf_tune_bad", 60)
    out["tune_ckpt"] = _status(lambda: c.request(
        "POST", "/tune/scikitlearn", {
            "name": "rf_tune_ck", "parentName": "rf", "method": "fit",
            "paramGrid": {"max_depth": [2]},
            "methodParameters": {**FIT, "checkpoint_dir": "/tmp/x"}}))
    # The neural tune: two learning rates of a tiny BERT.
    c.projection.create("tokx", "tok", [f"t{i}" for i in range(TOKENS_T)])
    c.observe.wait("tokx", 60)
    c.model.create("bert", module_path="learningorchestra_tpu.models.text",
                   class_name="BertModel", class_parameters=BERT)
    c.observe.wait("bert", 60)
    c.tune.create("bert_tune", parent_name="bert", method="fit",
                  param_grid={"learning_rate": [1e-3, 1e-4],
                              **{k: [v] for k, v in BERT.items()}},
                  method_parameters={"x": "$tokx", "y": "$tok.label",
                                     "epochs": 2, "batch_size": 8})
    out["bert_tune"] = c.observe.wait("bert_tune", 180)
    out["bert_tune_rows"] = _rows(c, "tune/tensorflow", "bert_tune")


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("titanic")
    write_titanic(tmp / "titanic.csv", 96, seed=1)
    write_titanic(tmp / "titanic_test.csv", 32, seed=2)
    write_tokens(tmp / "tokens.csv")
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp / "jax" / "store")
    jcfg.store.volume_root = str(tmp / "jax" / "volumes")
    jcfg.store.backend = "python"
    port = APIServer(Config(store=StoreConfig(
        root=str(tmp / "port" / "store"),
        volume_root=str(tmp / "port" / "volumes"))), device="cpu")
    jax_srv = JaxServer(jcfg)
    # One lease unit each: neural trials serialize on it, as on one card.
    port.ctx.leaser = port.ctx.engine.leaser = DeviceLeaser(["dev:0"])
    jax_srv.ctx.leaser = jax_srv.ctx.engine.leaser = JaxLeaser(["cpu:0"])
    servers = {"jax": jax_srv, "port": port}
    try:
        clients = {side: Context(f"http://127.0.0.1:{srv.start_background()}")
                   for side, srv in servers.items()}
        outs = {side: {"log": []} for side in servers}
        for side, c in clients.items():
            with _recording(outs[side]["log"]):
                _drive(c, tmp, outs[side])
        yield outs, servers, clients
    finally:
        for srv in servers.values():
            srv.shutdown()


def test_http_statuses_are_equal(drives):
    outs, _, _ = drives
    assert outs["port"]["log"] == outs["jax"]["log"]
    for out in outs.values():
        assert (out["bad_type"], out["tune_ckpt"]) == (406, 406)


def test_datatype_cast_rows(drives):
    outs, _, _ = drives
    for out in outs.values():
        assert out["cast_titanic"]["jobState"] == "finished"
        raw, cast = out["raw_rows"], out["cast_rows"]
        assert len(raw) == len(cast) == 96
        assert any(r["Age"] is None for r in raw)
        assert any(isinstance(r["Age"], int) for r in raw)
        for before, after in zip(raw, cast):
            want = None if before["Age"] is None else float(before["Age"])
            assert after["Age"] == want and (
                want is None or isinstance(after["Age"], float))
            assert isinstance(after["Fare"], float)
            assert after["Ticket"] == str(before["Ticket"])
    assert outs["port"]["cast_rows"] == outs["jax"]["cast_rows"]


def test_generic_transform_and_its_reruns(drives):
    outs, servers, clients = drives

    def scaled():
        return {
            "jax": np.asarray(servers["jax"].ctx.volumes.read_object(
                "transform/scikitlearn", "titanic_scaled")),
            "port": servers["port"].ctx.volumes.load_estimator(
                "transform/scikitlearn", "titanic_scaled",
                device="cpu").numpy()}

    for out in outs.values():
        assert out["scaled"]["jobState"] == "finished"
        assert out["scaled_rerun"]["jobState"] == "finished"
    got = scaled()
    assert got["port"].shape == (96, len(FEATURES))
    np.testing.assert_allclose(got["port"].mean(0), 0.0, atol=1e-5)
    assert np.abs(got["port"] - got["jax"]).max() <= \
        1e-5 * np.abs(got["jax"]).max()
    # A PATCH with new class parameters re-runs with them.
    for side, c in clients.items():
        c.transform_sklearn.update("titanic_scaled",
                                   class_parameters={"with_mean": False})
        assert c.observe.wait("titanic_scaled", 60)["jobState"] == \
            "finished"
    got = scaled()
    assert got["port"].min() >= 0.0  # the features are non-negative
    assert np.abs(got["port"] - got["jax"]).max() <= \
        1e-5 * np.abs(got["jax"]).max()


def test_config1_random_forest_flow(drives):
    outs, _, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    for key in ("rf", "rf_fit", "rf_eval", "rf_pred"):
        assert port_out[key]["jobState"] == jax_out[key]["jobState"] == \
            "finished", key
    assert port_out["rf_eval_rows"] == jax_out["rf_eval_rows"]
    assert port_out["rf_pred_rows"] == jax_out["rf_pred_rows"]
    assert len(port_out["rf_pred_rows"]) == 96


def test_builder_results(drives):
    outs, _, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    assert port_out["builder_uris"] == jax_out["builder_uris"]
    for clf in CLASSIFIERS:
        got, want = port_out["builder"][clf], jax_out["builder"][clf]
        assert got["jobState"] == want["jobState"] == "finished", clf
        assert (got["accuracy"], got["F1"]) == \
            (want["accuracy"], want["F1"]), clf
        assert got["fitTime"] > 0
        assert port_out["builder_rows"][clf] == jax_out["builder_rows"][clf]
        assert len(port_out["builder_rows"][clf]) == 32
        bad = port_out["builder_bad"][clf]
        assert bad["jobState"] == "failed" and "nosuch" in bad["exception"]
    # The coordinators are hidden from the family listing.
    assert port_out["builder_list"] == jax_out["builder_list"]
    assert not any("__builder_run" in n for n in port_out["builder_list"])


def test_random_forest_tune(drives):
    outs, _, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    for out in (jax_out, port_out):
        assert out["rf_tune"]["jobState"] == "finished"
        assert out["rf_tune_bad"]["jobState"] == "failed"

    def trials(out):
        return sorted((tuple(sorted(r["params"].items())), r["score"])
                      for r in out["rf_tune_rows"])

    assert len(trials(port_out)) == 4
    assert trials(port_out) == trials(jax_out)
    for key in ("bestParams", "bestScore"):
        assert port_out["rf_tune"][key] == jax_out["rf_tune"][key]
    assert set(port_out["rf_tune"]) - UNPORTED_KEYS == \
        set(jax_out["rf_tune"]) - UNPORTED_KEYS


def test_best_instance_is_published(drives):
    outs, servers, _ = drives
    best = servers["port"].ctx.volumes.load_estimator(
        "tune/scikitlearn", "rf_tune", device="cpu")
    assert isinstance(best, trees.RandomForestClassifier)
    params = outs["port"]["rf_tune"]["bestParams"]
    assert (best.n_estimators, best.max_depth) == (
        params["n_estimators"], params["max_depth"])


def test_neural_tune_serializes_on_one_lease(drives):
    outs, servers, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    for out in (jax_out, port_out):
        assert out["bert_tune"]["jobState"] == "finished"
        assert len(out["bert_tune_rows"]) == 2
        assert out["bert_tune"]["bestParams"]["learning_rate"] in \
            (1e-3, 1e-4)
    assert set(port_out["bert_tune"]) - UNPORTED_KEYS == \
        set(jax_out["bert_tune"]) - UNPORTED_KEYS
    spans = sorted((t0, t1) for label, _, t0, t1 in
                   servers["port"].ctx.leaser.history
                   if label == "bert_tune:trial")
    assert len(spans) == 2 and spans[0][1] <= spans[1][0]


def test_builder_tensorflow_is_refused_on_the_port(drives):
    # builder/tensorflow is the distributed builder on both packages now
    # (tests/test_torch_distributed_rest.py): a payload that is not one
    # function is refused alike.
    _, servers, _ = drives
    answers = {side: servers[side].handle(
        "POST", "/api/learningOrchestra/v1/builder/tensorflow",
        {"name": "dist", "function": "pass"}, {})
        for side in ("jax", "port")}
    assert answers["port"][0] == answers["jax"][0] == 406
    assert answers["port"][1]["error"] == answers["jax"][1]["error"]
    assert "single top-level function" in answers["port"][1]["error"]


def test_tune_cancel_stops_between_trials(drives, monkeypatch):
    _, servers, clients = drives
    port, c = servers["port"], clients["port"]
    started = threading.Event()
    release = threading.Event()
    fits = []
    real_fit = trees.RandomForestClassifier.fit

    def slow_fit(self, x, y):
        fits.append(self.max_depth)
        started.set()
        release.wait(30)
        return real_fit(self, x, y)

    monkeypatch.setattr(trees.RandomForestClassifier, "fit", slow_fit)
    c.request("POST", "/tune/scikitlearn", {
        "name": "rf_tune_cancel", "parentName": "rf", "method": "fit",
        "paramGrid": {"max_depth": list(range(2, 10))},
        "methodParameters": FIT})
    assert started.wait(30)
    assert port.ctx.engine.cancel("rf_tune_cancel") == "running"
    release.set()
    for _ in range(300):
        meta = c.metadata("tune/scikitlearn", "rf_tune_cancel")
        if meta["jobState"] not in ("pending", "running"):
            break
        threading.Event().wait(0.1)
    assert meta["jobState"] == "cancelled"
    # At most the pool's four workers were fitting; the queued trials
    # found the token flipped and never ran.
    assert 1 <= len(fits) <= 4
