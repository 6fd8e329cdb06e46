"""The port's explore and function services against the JAX server's,
over REST on the CPU, and the port's PNGs by what they show.

One JAX ``APIServer`` and one port ``APIServer(device="cpu")`` get the
same drive through the JAX package's ``client.py``:

- a numeric CSV, its histogram (equal documents), ``function/python``
  building (features, labels) from it (equal result rows and
  ``functionMessage``), a function without ``response`` (failed with the
  same message on both) and, on the port, a function given by URL (406);
- BASELINE config 3's flow at its tiny shape
  (``tests/test_baseline_configs.py``): a function makes token data,
  ``$fn.0`` and ``$fn.1`` feed an LSTM's train (weights carried from the
  JAX model, ``shuffle: false``) and evaluate, and a t-SNE
  ``/explore/scikitlearn`` plot coloured by ``$fn.1``;
- a PCA plot of the CSV's features and a t-SNE plot at
  ``tests/test_torch_estimators.py``'s shape (240 points); curves of the
  train job, a PATCH with ``fields``, a PATCH naming a metric the
  history lacks and curves over an artifact with no history (failed
  alike).

Held to: equal HTTP status sequences and job states; the arrays each
server hands its renderer (captured from ``_render_scatter``): PCA within
1e-5, t-SNE by the KL divergence of each embedding under the same
affinities (learning rate 20) within 2e-2; the curves jobs' ``epochs``
and ``metrics``.  The port's PNGs are decoded here (signature, every
chunk's CRC, zlib rows with filter byte 0): every scatter point's pixel
holds its colour on the ramp (or a neighbour's disc covering it), both
label colours are drawn, and every series' vertices hold its colour.
Last, a boot over a store with a running text, explore or function job
orphans it with the JAX package's reason.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from learningorchestra_tpu_torch.services import png
from learningorchestra_tpu_torch.toolkit.estimators.decomposition import (
    TSNE,
    kl_divergence,
)
from tests.test_torch_recovery import ORPHANED, _boot_both, _craft
from tests.torch_rest_pair import (
    UNPORTED_KEYS,
    carry_weights,
    data_rows,
    recording,
    serve_dir,
    server_pair,
    status,
)

TOL = dict(atol=1e-4, rtol=1e-4)
KL_RTOL = 2e-2
FEATURES = ["f1", "f2", "f3", "f4"]
MAKE_DATA = """
import numpy as np
x = np.stack([data[c].to_numpy() for c in cols], 1).astype("float32")
y = data["label"].to_numpy().astype("int32")
print("rows", len(y))
response = (x, y)
"""
MAKE_IMDB = """
import numpy as np
rng = np.random.default_rng(0)
n, seq = 48, 12
y = rng.integers(0, 2, n)
x = np.where(
    (y[:, None] == 1),
    rng.integers(1, 25, (n, seq)),
    rng.integers(25, 49, (n, seq)),
).astype(np.int32)
response = (x, y.astype(np.int32))
"""
# tests/test_torch_estimators.py's t-SNE shape: at a few dozen points
# the optimisation is chaotic on both sides (ROADMAP C, PR 8).
MAKE_BLOBS = """
import numpy as np
rng = np.random.default_rng(42)
centers = rng.normal(0.0, 3.0, (3, 5))
y = rng.integers(0, 3, 240)
x = (centers[y] + rng.normal(0.0, 1.0, (240, 5))).astype(np.float32)
response = (x, y)
"""
LSTM = {"vocab_size": 50, "embed_dim": 8, "hidden_dim": 8,
        "num_classes": 2, "learning_rate": 5e-3}
TSNE_PARAMS = {"n_components": 2, "perplexity": 5.0, "learning_rate": 20.0,
               "random_state": 0}


def _csv(path):
    rng = np.random.default_rng(9)
    with open(path, "w") as fh:
        fh.write(",".join(FEATURES + ["label"]) + "\n")
        for i in range(40):
            label = i % 3
            vals = rng.standard_normal(4) + 2.0 * label
            fh.write(",".join(f"{v:.5f}" for v in vals) + f",{label}\n")


def _capture(servers):
    """Wrap each server's ``_render_scatter``: -> {side: {name: (points,
    colors)}}."""
    got = {}
    for side, srv in servers.items():
        got[side] = {}
        real = srv.explore._render_scatter

        def render(name, kind, points, colors=None, _real=real,
                   _got=got[side]):
            _got[name] = (np.asarray(points), None if colors is None
                          else np.asarray(colors))
            return _real(name, kind, points, colors)

        srv.explore._render_scatter = render
    return got


def _drive(c, tmp, out):
    c.dataset_csv.insert("ds", f"file://{tmp}/ds.csv")
    out["ds"] = c.observe.wait("ds", 30)
    c.histogram.create("hist", "ds", ["label", "f1"])
    out["hist"] = c.observe.wait("hist", 30)
    out["hist_rows"] = data_rows(c.histogram.search("hist", limit=10))
    c.function.create("fn", function=MAKE_DATA, function_parameters={
        "data": "$ds", "cols": FEATURES})
    out["fn"] = c.observe.wait("fn", 30)
    out["fn_rows"] = data_rows(c.function.search("fn"))
    c.function.create("noresp", function="x = 1\nprint('no response')")
    out["noresp"] = c.observe.wait("noresp", 30)
    out["noresp_rows"] = c.function.search("noresp")[1:]
    c.explore_sklearn.create(
        "pca", module_path="sklearn.decomposition", class_name="PCA",
        class_parameters={"n_components": 2}, method="fit_transform",
        method_parameters={"x": "$fn.0"}, color_by="$fn.1")
    out["pca"] = c.explore_sklearn.wait("pca", 60)
    # BASELINE config 3: function data -> LSTM train/evaluate -> t-SNE.
    c.function.create("imdb_mini", function=MAKE_IMDB)
    out["imdb_mini"] = c.observe.wait("imdb_mini", 30)
    c.model.create("imdb_lstm", module_path="learningorchestra_tpu.models."
                   "text", class_name="LSTMClassifier",
                   class_parameters=LSTM)
    out["imdb_lstm"] = c.observe.wait("imdb_lstm", 30)


def _drive_trained(c, out):
    c.train.create("imdb_fit", model_name="imdb_lstm", method="fit",
                   method_parameters={"x": "$imdb_mini.0",
                                      "y": "$imdb_mini.1", "epochs": 3,
                                      "batch_size": 16, "shuffle": False})
    out["imdb_fit"] = c.observe.wait("imdb_fit", 60)
    out["history"] = [r for r in c.train.search("imdb_fit", limit=20)
                      if r.get("docType") == "history"]
    c.evaluate.create("imdb_eval", parent_name="imdb_fit", method="evaluate",
                      method_parameters={"x": "$imdb_mini.0",
                                         "y": "$imdb_mini.1"})
    out["imdb_eval"] = c.observe.wait("imdb_eval", 30)
    out["eval_rows"] = data_rows(c.evaluate.search("imdb_eval"))
    c.explore_sklearn.create(
        "imdb_tsne", module_path="learningorchestra_tpu.toolkit.estimators."
        "decomposition", class_name="TSNE", class_parameters=TSNE_PARAMS,
        method="fit_transform", method_parameters={"x": "$imdb_mini.0"},
        color_by="$imdb_mini.1")
    out["imdb_tsne"] = c.explore_sklearn.wait("imdb_tsne", 120)
    c.function.create("blobs", function=MAKE_BLOBS)
    out["blobs"] = c.observe.wait("blobs", 30)
    c.explore_sklearn.create(
        "blobs_tsne", module_path="sklearn.manifold", class_name="TSNE",
        class_parameters={"learning_rate": 20.0}, method="fit_transform",
        method_parameters={"x": "$blobs.0"}, color_by="$blobs.1")
    out["blobs_tsne"] = c.explore_sklearn.wait("blobs_tsne", 120)
    for plot in ("imdb_tsne", "pca", "blobs_tsne"):
        out[f"{plot}_png"] = c.explore_sklearn.image(plot)
    c.explore_curves.create("curves", "imdb_fit")
    out["curves"] = c.explore_curves.wait("curves", 30)
    out["curves_png"] = c.explore_curves.image("curves")
    c.request("PATCH", "/explore/curves/curves", {"fields": ["loss"]})
    out["curves_loss"] = c.explore_curves.wait("curves", 30)
    c.request("PATCH", "/explore/curves/curves", {"fields": ["nosuch"]})
    out["curves_bad"] = c.explore_curves.wait("curves", 30)
    c.explore_curves.create("nohist", "ds")
    out["nohist"] = c.explore_curves.wait("nohist", 30)


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("explore_function")
    _csv(tmp / "ds.csv")
    with server_pair(tmp) as (servers, clients):
        scatter = _capture(servers)
        outs = {side: {"log": []} for side in servers}
        for side, c in clients.items():
            with recording(outs[side]["log"]):
                _drive(c, tmp, outs[side])
        # A function by URL is fetched when its job runs: a localhost
        # 404 fails the job (tests/test_torch_url_sources.py holds the
        # fetch against the JAX server's).
        with serve_dir(tmp) as base:
            outs["port"]["url"] = status(
                lambda: clients["port"].function.create(
                    "byurl", function=f"{base}/nosuch.py"))
            outs["port"]["url_job"] = clients["port"].function.wait(
                "byurl", 30)["jobState"]
        x0 = np.asarray(servers["port"].ctx.volumes.read_object(
            "function/python", "imdb_mini")[0][:1])
        carry_weights(servers, "imdb_lstm", x0)
        for side, c in clients.items():
            with recording(outs[side]["log"]):
                _drive_trained(c, outs[side])
        yield outs, scatter, servers["port"]


def test_http_statuses_and_job_states_are_equal(drives):
    outs, _, _ = drives
    assert outs["port"]["url"] == 200
    assert outs["port"]["url_job"] == "failed"
    assert outs["port"]["log"] == outs["jax"]["log"]
    for key, out in outs["port"].items():
        if isinstance(out, dict) and "jobState" in out:
            assert out["jobState"] == outs["jax"][key]["jobState"], key
            assert set(out) - UNPORTED_KEYS == \
                set(outs["jax"][key]) - UNPORTED_KEYS, key
    assert outs["port"]["imdb_tsne"]["jobState"] == "finished"


def test_histogram_and_function_rows_are_equal(drives):
    outs, _, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    assert port_out["hist_rows"] == jax_out["hist_rows"]
    assert [r["field"] for r in port_out["hist_rows"]] == ["label", "f1"]
    assert port_out["hist_rows"][0]["counts"] == {"0": 14, "1": 13,
                                                  "2": 13}
    got, want = port_out["fn_rows"][0], jax_out["fn_rows"][0]
    assert got["functionMessage"] == want["functionMessage"] == "rows 40\n"
    np.testing.assert_allclose(np.asarray(got["result"][0]),
                               np.asarray(want["result"][0]), rtol=1e-6)
    assert got["result"][1] == want["result"][1]
    for out in (jax_out, port_out):
        assert out["noresp"]["jobState"] == "failed"
    assert port_out["noresp"]["exception"] == jax_out["noresp"]["exception"]
    assert "must set a 'response' variable" in \
        port_out["noresp"]["exception"]


def test_function_outputs_feed_train_evaluate_and_tsne(drives):
    outs, scatter, _ = drives
    for metric in ("loss", "accuracy"):
        np.testing.assert_allclose(
            [r[metric] for r in outs["port"]["history"]],
            [r[metric] for r in outs["jax"]["history"]], **TOL)
        np.testing.assert_allclose(outs["port"]["eval_rows"][0][metric],
                                   outs["jax"]["eval_rows"][0][metric],
                                   **TOL)
    (jpts, jcol), (ppts, pcol) = (scatter[s]["imdb_tsne"]
                                  for s in ("jax", "port"))
    assert ppts.shape == jpts.shape == (48, 2)
    assert np.isfinite(ppts).all()
    np.testing.assert_array_equal(pcol, jcol)


def test_tsne_plot_agrees_by_kl(drives):
    _, scatter, port = drives
    (jpts, jcol), (ppts, pcol) = (scatter[s]["blobs_tsne"]
                                  for s in ("jax", "port"))
    np.testing.assert_array_equal(pcol, jcol)
    x = port.ctx.volumes.read_object("function/python", "blobs")[0]
    p = TSNE(device="cpu").affinities(x)
    kl = {side: kl_divergence(p, torch.tensor(pts, dtype=torch.float64))
          for side, pts in (("jax", jpts), ("port", ppts))}
    assert kl["port"] == pytest.approx(kl["jax"], rel=KL_RTOL)


def test_pca_plot_points_agree(drives):
    _, scatter, _ = drives
    (jpts, jcol), (ppts, pcol) = (scatter[s]["pca"] for s in ("jax", "port"))
    assert ppts.shape == (40, 2)
    np.testing.assert_allclose(ppts, jpts, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(pcol, jcol)


def test_curves_results_agree(drives):
    outs, _, _ = drives
    for key, metrics in (("curves", ["accuracy", "loss"]),
                         ("curves_loss", ["loss"])):
        got, want = outs["port"][key], outs["jax"][key]
        assert (got["epochs"], got["metrics"]) == \
            (want["epochs"], want["metrics"]) == (3, metrics)
    for key in ("curves_bad", "nohist"):
        got, want = outs["port"][key], outs["jax"][key]
        assert got["jobState"] == want["jobState"] == "failed"
        assert got["exception"] == want["exception"]


def decode_png(data: bytes) -> np.ndarray:
    """(height, width, 3) uint8 of an 8-bit RGB PNG, checking the
    signature, each chunk's CRC and each row's filter byte (0)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body), kind
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("plot", ["imdb_tsne", "pca", "blobs_tsne"])
def test_scatter_png_shows_every_point_in_its_colour(drives, plot):
    outs, scatter, _ = drives
    rgb = decode_png(outs["port"][f"{plot}_png"])
    assert rgb.shape == (png.HEIGHT, png.WIDTH, 3)
    points, colors = scatter["port"][plot]
    _, centres, fill = png.scatter_png(points, colors)
    np.testing.assert_array_equal(fill, png.ramp(colors))
    r2 = png.DISC_RADIUS ** 2
    for (x, y), want in zip(centres, fill):
        covering = fill[((centres - (x, y)) ** 2).sum(1) <= r2]
        assert any((rgb[y, x] == c).all() for c in covering), (x, y)
    for end in (png.ramp(np.asarray([0.0, 1.0]))):
        assert (rgb == end).all(-1).any()  # both ends of the labels


def test_curves_png_draws_every_series(drives):
    outs, _, port = drives
    rgb = decode_png(outs["port"]["curves_png"])
    history = outs["port"]["history"]
    series = {k: [r[k] for r in history] for k in ("loss", "accuracy")}
    _, drawn = png.curves_png({"loss": series["loss"]},
                              {"accuracy": series["accuracy"]})
    colours = [c for _, c in drawn.values()]
    for name, (vertices, colour) in drawn.items():
        assert len(vertices) == 3
        on = [any((rgb[y, x] == c).all() for c in colours)
              for x, y in vertices]
        assert all(on), name
        assert (rgb == colour).all(-1).sum() > 20, name  # its polyline


@pytest.mark.parametrize("kind", ["transform/text", "explore/histogram",
                                  "explore/scikitlearn", "function/python"])
def test_boot_orphans_running_text_explore_function_jobs(tmp_path, kind):
    _craft(tmp_path, {"job1": (kind, None, None, "running")},
           journaled=("job1",))
    metas, _ = _boot_both(tmp_path, ["job1"])
    assert metas["port"]["job1"]["jobState"] == "failed"
    assert metas["port"]["job1"]["exception"] == \
        metas["jax"]["job1"]["exception"] == ORPHANED
