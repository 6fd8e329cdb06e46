"""The port's sharded datasets and streaming fit against the JAX
package's, on the CPU.

- shard directories written by either package's writers (scalar CSV
  rows, with a column promoted int -> float across shards and an int64
  beyond int32; N-D tensor chunks) are equal file for file in content and
  read alike by both readers, the dtypes narrowed alike;
- views (one column, a feature matrix, a collapsed tensor column),
  ``feature_view``, ``resolve_xy_views`` and their errors; ``same_dataset``;
  ``WeightedMetrics`` (perplexity in the log domain);
- the streaming fit of a 2-layer width-32 ``TransformerClassifier`` and a
  small ``LSTMClassifier`` over 3 shards (the last a ragged tail that is
  not a multiple of the batch) with ``shuffle=False``, from parameters
  carried from the JAX model: per-epoch losses within 5e-5 and final
  parameters within 1e-4 (f32, SGD); the streaming evaluate and the
  predict on the bare dataset (the fit's feature columns) within 1e-4,
  also after an int8 artifact round trip;
- the shard order under ``shuffle=True``, epoch by epoch, equal to the
  JAX package's;
- a streaming fit resumed from a managed checkpoint bit-equal to an
  uninterrupted one, each asynchronously published marker holding its
  own step's history, and the JAX package's refusals (``validation_split``,
  sharded ``validation_data``, two datasets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLP
from learningorchestra_tpu.models.text import LSTMClassifier as JaxLSTM
from learningorchestra_tpu.models.text import (
    TransformerClassifier as JaxTransformer,
)
from learningorchestra_tpu.store import sharded as jsh
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.models.text import (
    LSTMClassifier,
    TransformerClassifier,
)
from learningorchestra_tpu_torch.store import sharded as psh
from learningorchestra_tpu_torch.train import checkpoint as ckpt
from learningorchestra_tpu_torch.train.neural import load_artifact

PKGS = {"jax": jsh, "port": psh}
T, VOCAB = 12, 40
TC = dict(vocab_size=VOCAB, hidden_dim=32, num_layers=2, num_heads=2,
          max_len=T, num_classes=2)
LSTM = dict(vocab_size=VOCAB, embed_dim=8, hidden_dim=8, num_classes=2)
LOSS_TOL = dict(atol=5e-5, rtol=5e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _csv_rows(n=70, seed=0):
    """Rows of [int, float-from-shard-2, huge int, label]: column b is
    integral in the first shard and fractional later (promotion), c holds
    an int64 beyond int32 in the last shard."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        b = int(rng.integers(0, 9)) if i < 32 \
            else float(rng.standard_normal())
        c = 2 ** 40 if i == n - 1 else int(rng.integers(-9, 9))
        rows.append([int(rng.integers(-5, 5)), b, c, int(i % 3)])
    return rows


def _write_csv(pkg, root, rows, rows_per_shard=32):
    w = pkg.ShardedDatasetWriter(root, ["a", "b", "c", "label"],
                                 rows_per_shard=rows_per_shard)
    for r in rows:
        w.append(list(r))
    return w.close()


def _tokens(n=50, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, VOCAB, (n, T)).astype(np.int32)
    x[2, 5:] = 0  # a pad tail
    x[7] = 0  # an all-pad row
    return x, (x[:, 0] % 2).astype(np.int64)


def _write_tokens(pkg, root, x, y, rows_per_shard=20):
    w = pkg.ShardedTensorWriter(root, {"tokens": (T,), "label": ()},
                                rows_per_shard=rows_per_shard)
    for i in range(0, len(x), 7):  # chunks that straddle shard edges
        w.append_rows({"tokens": x[i:i + 7], "label": y[i:i + 7]})
    return w.close()


@pytest.mark.parametrize("kind", ["csv", "tensor"])
def test_both_writers_agree_and_each_reader_reads_both(tmp_path, kind):
    x, y = _tokens()
    manifests = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        manifests[name] = _write_csv(pkg, root, _csv_rows()) \
            if kind == "csv" else _write_tokens(pkg, root, x, y)
    assert manifests["port"] == manifests["jax"]
    if kind == "csv":
        assert manifests["port"]["dtypes"] == {
            "a": "int32", "b": "float32", "c": "float32", "label": "int32"}
        assert manifests["port"]["shard_rows"] == [32, 32, 6]
    else:
        assert manifests["port"]["shard_rows"] == [20, 20, 10]
    for reader in PKGS.values():
        ds = {name: reader.ShardedDataset(tmp_path / name) for name in PKGS}
        for k in range(ds["jax"].n_shards):
            want, got = ds["jax"].load_shard(k), ds["port"].load_shard(k)
            for col in want:
                assert got[col].dtype == want[col].dtype
                np.testing.assert_array_equal(got[col], want[col])
    # Narrowed like the JAX package: no 64-bit column on disk.
    with np.load(tmp_path / "port" / "shard_00000.npz") as z:
        assert all(z[f].dtype.itemsize <= 4 for f in z.files)


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("case", [
    "non_numeric", "row_width", "no_manifest", "bad_rows", "no_fields",
    "tensor_shape", "tensor_counts", "closed"])
def test_writer_and_reader_errors_match(tmp_path, case):
    def run(pkg, root):
        if case == "non_numeric":
            w = pkg.ShardedDatasetWriter(root, ["a"], rows_per_shard=2)
            w.append(["x"])
            w.append(["y"])
        elif case == "row_width":
            pkg.ShardedDatasetWriter(root, ["a", "b"]).append([1])
        elif case == "no_manifest":
            root.mkdir()
            pkg.ShardedDataset(root)
        elif case == "bad_rows":
            pkg.ShardedDatasetWriter(root, ["a"], rows_per_shard=0)
        elif case == "no_fields":
            pkg.ShardedDatasetWriter(root, [])
        elif case == "tensor_shape":
            pkg.ShardedTensorWriter(root, {"x": (2,)}).append_rows(
                {"x": np.zeros((3, 4))})
        elif case == "tensor_counts":
            pkg.ShardedTensorWriter(root, {"x": (), "y": ()}).append_rows(
                {"x": np.zeros(3), "y": np.zeros(4)})
        else:
            w = pkg.ShardedDatasetWriter(root, ["a"])
            w.close()
            w.close()

    got = {name: _raised(lambda: run(pkg, tmp_path / name))
           for name, pkg in PKGS.items()}
    assert got["port"] is not None
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1].replace(str(tmp_path / "port"), "") == \
        got["jax"][1].replace(str(tmp_path / "jax"), "")


def test_views_feature_view_and_xy_resolution(tmp_path):
    x, y = _tokens()
    for name, pkg in PKGS.items():
        _write_csv(pkg, tmp_path / f"csv_{name}", _csv_rows())
        _write_tokens(pkg, tmp_path / f"tok_{name}", x, y)
    ds = {n: {k: p.ShardedDataset(tmp_path / f"{k}_{n}")
              for k in ("csv", "tok")} for n, p in PKGS.items()}

    def views(d, pkg):
        return {
            "col": d["csv"]["b"], "matrix": d["csv"].view(["a", "b"]),
            "one": d["csv"].view(["a"]), "features":
                d["csv"].feature_view("label"),
            "tensor": d["tok"].feature_view("label"),
            "tok": d["tok"]["tokens"],
            "xy": pkg.resolve_xy_views(d["csv"], d["csv"]["label"])[0],
        }

    got, want = views(ds["port"], psh), views(ds["jax"], jsh)
    for key in want:
        assert (got[key].shape, got[key].dtype, got[key].single,
                got[key].cols) == (want[key].shape, want[key].dtype,
                                   want[key].single, want[key].cols), key
        for k in range(3):
            np.testing.assert_array_equal(got[key].load_shard(k),
                                          want[key].load_shard(k))
        np.testing.assert_array_equal(got[key].head(3), want[key].head(3))
    assert psh.same_dataset(got["col"], ds["port"]["csv"])
    assert not psh.same_dataset(got["col"], got["tok"])

    def errors(d, pkg):
        csv, tok = d["csv"], d["tok"]
        return [_raised(f) for f in (
            lambda: csv["nosuch"], lambda: tok.view(["tokens", "label"]),
            lambda: csv.feature_view(["a", "b", "c", "label"]),
            lambda: pkg.resolve_xy_views(csv, csv),
            lambda: pkg.resolve_xy_views(csv, csv.view(["a", "b"])),
            lambda: pkg.resolve_xy_views(np.zeros(3), csv["label"]),
            lambda: pkg.resolve_xy_views(tok, csv["label"]))]

    port_errors, jax_errors = errors(ds["port"], psh), errors(ds["jax"], jsh)
    assert all(port_errors)
    assert [(t, m.replace("_port", "")) for t, m in port_errors] == \
        [(t, m.replace("_jax", "")) for t, m in jax_errors]


def test_weighted_metrics_match():
    shards = [({"loss": 0.7, "accuracy": 0.5, "perplexity": 3.0}, 32),
              ({"loss": 0.2, "accuracy": 0.9, "perplexity": 1.5}, 6)]
    results = []
    for pkg in PKGS.values():
        acc = pkg.WeightedMetrics()
        for metrics, rows in shards:
            acc.add(metrics, rows)
        results.append(acc.result())
    assert results[0] == results[1]
    assert results[1]["perplexity"] == pytest.approx(
        np.exp((32 * np.log(3.0) + 6 * np.log(1.5)) / 38))


# -- the streaming fit against the JAX package's ------------------------------

def _pair(kind, x0):
    jcls, pcls, kw = {"tc": (JaxTransformer, TransformerClassifier, TC),
                      "lstm": (JaxLSTM, LSTMClassifier, LSTM)}[kind]
    jest = jcls(**kw, seed=3)
    pest = pcls(**kw, device="cpu")
    for est in (jest, pest):
        est.compute_dtype = "float32"
        # SGD: Adam turns the rounding noise of the zero exact gradient
        # of the qkv bias's key part into lr-sized steps on both sides.
        est.compile(optimizer="sgd", learning_rate=0.05)
    jest._init_params(jnp.asarray(x0))
    pest.load_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                           jest.params)})
    return jest, pest


@pytest.fixture(scope="module", params=["tc", "lstm"])
def streamed(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"stream_{request.param}")
    x, y = _tokens()
    _write_tokens(psh, tmp / "train", x, y)
    xt, yt = _tokens(23, seed=5)
    _write_tokens(psh, tmp / "test", xt, yt, rows_per_shard=10)
    data = {name: {split: pkg.ShardedDataset(tmp / split)
                   for split in ("train", "test")}
            for name, pkg in PKGS.items()}
    jest, pest = _pair(request.param, x[:1])
    for name, est in (("jax", jest), ("port", pest)):
        train = data[name]["train"]
        est.fit(train, train["label"], epochs=2, batch_size=8,
                shuffle=False)
    return jest, pest, data, tmp


def test_streaming_fit_matches_jax(streamed):
    jest, pest, _, _ = streamed
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(pest.history["accuracy"],
                               jest.history["accuracy"], **LOSS_TOL)
    a = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        np.asarray, jest.params))
    b = jax.tree_util.tree_leaves(convert.params_to_jax(pest.module))
    assert len(a) == len(b)
    for (path, u), v in zip(a, b):
        np.testing.assert_allclose(np.asarray(v), u,
                                   err_msg=jax.tree_util.keystr(path), **TOL)
    assert pest._sharded_fit_cols == jest._sharded_fit_cols == ["tokens"]
    assert len(pest.stream_stats["shard_wait_s"]) == 2


def test_streaming_evaluate_and_bare_predict_match_jax(streamed):
    jest, pest, data, _ = streamed
    jtest, ptest = data["jax"]["test"], data["port"]["test"]
    for batch in (4, 128):
        got = pest.evaluate(ptest, ptest["label"], batch_size=batch)
        want = jest.evaluate(jtest, jtest["label"], batch_size=batch)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL)
    want = np.asarray(jest.predict(jtest, batch_size=8))
    assert want.shape == (23, 2)
    np.testing.assert_allclose(pest.predict(ptest, batch_size=8), want,
                               **TOL)
    np.testing.assert_allclose(pest.predict(ptest["tokens"], batch_size=8),
                               want, **TOL)
    # The feature columns survive an int8 artifact.
    loaded = load_artifact(pest.to_artifact(quantize=True), device="cpu")
    assert loaded._sharded_fit_cols == ["tokens"]
    assert loaded.predict(ptest).shape == (23, 2)


def _record_shard_order(monkeypatch, pkg, order):
    real = pkg.ShardedView.load_shard

    def load_shard(view, k):
        if view.cols == ["label"]:
            order.append(int(k))
        return real(view, k)

    monkeypatch.setattr(pkg.ShardedView, "load_shard", load_shard)


def test_shuffled_shard_order_matches_jax(monkeypatch, tmp_path):
    rows = _csv_rows(150)
    orders = {}
    for name, pkg in PKGS.items():
        _write_csv(pkg, tmp_path / name, [r[:2] + [0, r[3]] for r in rows],
                   rows_per_shard=16)
        ds = pkg.ShardedDataset(tmp_path / name)
        orders[name] = []
        _record_shard_order(monkeypatch, pkg, orders[name])
        est = (JaxMLP if name == "jax" else MLPClassifier)(
            hidden_layer_sizes=[4], num_classes=3, seed=7,
            **({} if name == "jax" else {"device": "cpu"}))
        est.fit(ds, ds["label"], epochs=3, batch_size=16, shuffle=True)
    # The first read is the loss resolution's look at shard 0's labels.
    assert len(orders["port"]) == 1 + 3 * 10
    assert orders["port"] == orders["jax"]
    assert orders["port"][1:11] != list(range(10))


def _mlp_data(tmp_path):
    rows = _csv_rows(60, seed=2)
    _write_csv(psh, tmp_path / "ds", [r[:2] + [0, r[3]] for r in rows],
               rows_per_shard=16)
    return psh.ShardedDataset(tmp_path / "ds")


def test_resumed_streaming_fit_equals_uninterrupted(tmp_path):
    ds = _mlp_data(tmp_path)

    def est():
        return MLPClassifier(hidden_layer_sizes=[8], num_classes=3, seed=1,
                             device="cpu")

    full = est().fit(ds, ds["label"], epochs=4, batch_size=8)
    ck = str(tmp_path / "ck")
    est().fit(ds, ds["label"], epochs=2, batch_size=8, checkpoint_dir=ck,
              checkpoint_min_interval_s=0.0)
    resumed = est().fit(ds, ds["label"], epochs=4, batch_size=8,
                        checkpoint_dir=ck, checkpoint_min_interval_s=0.0)
    assert resumed.history["loss"] == full.history["loss"]
    for a, b in zip(resumed.module.parameters(), full.module.parameters()):
        assert torch.equal(a, b)


def test_async_markers_hold_their_own_steps_history(tmp_path, monkeypatch):
    ds = _mlp_data(tmp_path)
    published = []
    real = ckpt._publish

    def publish(directory, step, history):
        published.append((step, len((history or {}).get("loss", []))))
        return real(directory, step, history)

    monkeypatch.setattr(ckpt, "_publish", publish)
    MLPClassifier(hidden_layer_sizes=[8], num_classes=3, device="cpu").fit(
        ds, ds["label"], epochs=4, batch_size=8, checkpoint_dir=str(
            tmp_path / "ck"), checkpoint_min_interval_s=0.0,
        checkpoint_async=True)
    assert published == [(1, 1), (2, 2), (3, 3), (4, 4)]


@pytest.mark.parametrize("case", ["split", "val_sharded", "two_datasets"])
def test_streaming_refusals_match_jax(tmp_path, case):
    rows = [r[:2] + [0, r[3]] for r in _csv_rows(40)]
    got = {}
    for name, pkg in PKGS.items():
        for sub in ("a", "b"):
            _write_csv(pkg, tmp_path / name / sub, rows)
        a = pkg.ShardedDataset(tmp_path / name / "a")
        b = pkg.ShardedDataset(tmp_path / name / "b")
        est = (JaxMLP if name == "jax" else MLPClassifier)(
            hidden_layer_sizes=[4], num_classes=3,
            **({} if name == "jax" else {"device": "cpu"}))
        kw = {"split": {"x": a, "y": a["label"], "validation_split": 0.2},
              "val_sharded": {"x": a, "y": a["label"],
                              "validation_data": (b, b["label"])},
              "two_datasets": {"x": a.feature_view("label"),
                               "y": b["label"]}}[case]
        got[name] = _raised(lambda: est.fit(**kw))
    assert got["port"] is not None and got["port"] == got["jax"]
