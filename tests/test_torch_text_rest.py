"""The port's text pipeline and sharded ingests against the JAX server's,
over REST on the CPU.

One JAX ``APIServer`` and one port ``APIServer(device="cpu")`` get the
same drive through the JAX package's ``client.py``: plain CSV ingest of a
seeded review corpus (train and held-out), a sharded CSV (``shardRows``,
a ragged tail, int, float and float-formatted columns), a tensor ingest
of ``.npy`` images and a generic ingest; ``/transform/text`` on the train
split (BPE, 3 shards with a ragged tail) and on the held-out split with
``tokenizerFrom``; the 406s (bad ``vocabSize``, ``maxLen``,
``shardRows``, a dangling ``tokenizerFrom``, a text transform over a
sharded parent, a tensor ingest without labels); a small transformer and
an MLP (initial weights carried from the JAX models) trained streaming
on the token and CSV shards with ``shuffle: false``; a streaming
evaluate on the held-out tokens and a predict on the bare held-out
dataset; a PATCH re-run of the text transform; and DELETEs.

Held to: equal HTTP status sequences; shard directories equal array for
array and dtype for dtype, read by each package's reader; equal
previews, ``labelClasses`` and manifests; history losses, evaluate
metrics and predictions within 1e-4; the DELETE removing the shards and
the tokenizer on both.
"""

import json

import numpy as np
import pytest

from learningorchestra_tpu.store import sharded as jsh
from learningorchestra_tpu_torch.store import sharded as psh
from tests.torch_rest_pair import (
    UNPORTED_KEYS,
    carry_weights,
    data_rows,
    recording,
    server_pair,
    status,
)

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, VOCAB = 16, 64
POS = ["great", "loved", "fun", "moving", "superb"]
NEG = ["boring", "hated", "dull", "terrible", "awful"]
FILLER = ["the", "film", "a", "plot", "and", "it", "was", "acting", "movie"]
TC = dict(vocab_size=VOCAB, hidden_dim=16, num_layers=1, num_heads=2,
          max_len=MAX_LEN, num_classes=2)
SHARDED = ("num", "img", "tok", "tok_test")


def _reviews(path, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        fh.write("review,sentiment\n")
        for i in range(n):
            label = ("pos", "neg")[i % 2]
            words = list(rng.choice(FILLER, rng.integers(3, 14)))
            words += list(rng.choice(POS if label == "pos" else NEG, 2))
            rng.shuffle(words)
            text = " ".join(words) + ("!" if i % 3 else ", ok.")
            fh.write(f'"{text.capitalize()}",{label}\n')


def _numeric(path):
    rng = np.random.default_rng(7)
    with open(path, "w") as fh:
        fh.write("a,b,c,label\n")
        for i in range(30):
            a, b = rng.integers(-5, 5), rng.standard_normal()
            label = int(a > 0) + int(b > 0)
            fh.write(f"{a},{b:.6f},{float(i % 4):.1f},{label}\n")


def _files(tmp):
    _reviews(tmp / "rev.csv", 40, 0)
    _reviews(tmp / "rev_test.csv", 20, 1)
    _numeric(tmp / "num.csv")
    rng = np.random.default_rng(3)
    np.save(tmp / "img.npy", rng.standard_normal((20, 4, 4, 1)))
    np.save(tmp / "img_y.npy", rng.integers(0, 3, 20))
    (tmp / "blob.bin").write_bytes(bytes(range(256)) * 5)


def _ingest(c, tmp, out):
    c.dataset_csv.insert("rev", f"file://{tmp}/rev.csv")
    c.dataset_csv.insert("rev_test", f"file://{tmp}/rev_test.csv")
    c.dataset_csv.insert("num", f"file://{tmp}/num.csv", shard_rows=8)
    c.dataset_tensor.insert("img", f"file://{tmp}/img.npy",
                            f"file://{tmp}/img_y.npy", shard_rows=8)
    c.dataset_generic.insert("blob", f"file://{tmp}/blob.bin")
    for name in ("rev", "rev_test", "num", "img", "blob"):
        out[name] = c.observe.wait(name, 60)
    c.text.create("tok", "rev", text_field="review",
                  label_field="sentiment", vocab_size=VOCAB,
                  max_len=MAX_LEN, shard_rows=16)
    out["tok"] = c.observe.wait("tok", 60)
    c.text.create("tok_test", "rev_test", text_field="review",
                  label_field="sentiment", max_len=MAX_LEN,
                  tokenizer_from="tok", shard_rows=16)
    out["tok_test"] = c.observe.wait("tok_test", 60)
    text = dict(text_field="review", label_field="sentiment")
    out["refused"] = [
        status(lambda: c.text.create("t1", "rev", vocab_size=4, **text)),
        status(lambda: c.text.create("t2", "rev", vocab_size="abc",
                                     **text)),
        status(lambda: c.text.create("t3", "rev", max_len=2, **text)),
        status(lambda: c.text.create("t4", "rev", shard_rows=0, **text)),
        status(lambda: c.text.create("t5", "rev", tokenizer_from="ghost",
                                     **text)),
        status(lambda: c.text.create("t6", "num", text_field="a")),
        status(lambda: c.dataset_csv.insert("n2", f"file://{tmp}/num.csv",
                                            shard_rows=0)),
        status(lambda: c.request("POST", "/dataset/tensor", {
            "datasetName": "i2", "url": f"file://{tmp}/img.npy"})),
    ]
    c.model.create("tc", module_path="learningorchestra_tpu.models.text",
                   class_name="TransformerClassifier", class_parameters=TC)
    c.model.create("mlp", module_path="learningorchestra_tpu.models.mlp",
                   class_name="MLPClassifier",
                   class_parameters={"hidden_layer_sizes": [8],
                                     "num_classes": 3})
    for name in ("tc", "mlp"):
        out[name] = c.observe.wait(name, 60)


def _train(c, out):
    # One fit at a time: the JAX package's concurrent managed orbax
    # checkpoints fail now and then (ROADMAP C, PR 8).
    for name, model, data, batch in (("fit", "tc", "tok", 8),
                                     ("mfit", "mlp", "num", 4)):
        c.train.create(name, model_name=model, method="fit",
                       method_parameters={
                           "x": f"${data}", "y": f"${data}.label",
                           "epochs": 2, "batch_size": batch,
                           "shuffle": False})
        out[name] = c.observe.wait(name, 120)
        out[f"{name}_history"] = c.train.search(name, limit=20)
    c.evaluate.create("ev", parent_name="fit", method="evaluate",
                      method_parameters={"x": "$tok_test",
                                         "y": "$tok_test.label"})
    c.predict.create("pr", parent_name="fit", method="predict",
                     method_parameters={"x": "$tok_test"})
    c.predict.create("mpr", parent_name="mfit", method="predict",
                     method_parameters={"x": "$num"})
    for name, svc in (("ev", c.evaluate), ("pr", c.predict),
                      ("mpr", c.predict)):
        out[name] = c.observe.wait(name, 60)
        out[f"{name}_rows"] = data_rows(svc.search(name, limit=100))
    for name in SHARDED:
        out[f"{name}_page"] = c.dataset_csv.search(name, limit=100)
    c.text.update("tok")
    out["rerun"] = c.observe.wait("tok", 60)
    out["rerun_page"] = c.text.search("tok", limit=100)


def _delete(c, servers_side, out):
    vols = servers_side.ctx.volumes
    out["before_delete"] = [vols.path_for("transform/text", n).exists()
                            for n in ("tok", "tok.tokenizer", "tok_test")]
    c.text.delete("tok_test")
    c.text.delete("tok")
    c.dataset_csv.delete("num")
    out["after_delete"] = [vols.path_for(t, n).exists() for t, n in (
        ("transform/text", "tok"), ("transform/text", "tok.tokenizer"),
        ("transform/text", "tok_test"), ("dataset/csv", "num"))]
    out["recreate"] = status(lambda: c.text.create(
        "t7", "rev", text_field="review", tokenizer_from="tok"))


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("text_rest")
    _files(tmp)
    with server_pair(tmp) as (servers, clients):
        outs = {side: {"log": []} for side in servers}
        for side, c in clients.items():
            with recording(outs[side]["log"]):
                _ingest(c, tmp, outs[side])
        tokens = np.load(servers["jax"].ctx.volumes.path_for(
            "transform/text", "tok") / "shard_00000.npz")["tokens"][:1]
        carry_weights(servers, "tc", tokens)
        carry_weights(servers, "mlp", np.zeros((1, 3), np.float32))
        shards = {}
        for side, c in clients.items():
            with recording(outs[side]["log"]):
                _train(c, outs[side])
            vols = servers[side].ctx.volumes
            shards[side] = {
                name: vols.path_for(outs[side][name]["type"], name)
                for name in SHARDED}
        # Snapshots of the shard directories before the deletes.
        snap = tmp / "snap"
        for side in servers:
            for name, root in shards[side].items():
                dst = snap / side / name
                dst.mkdir(parents=True)
                for f in root.iterdir():
                    (dst / f.name).write_bytes(f.read_bytes())
        for side, c in clients.items():
            with recording(outs[side]["log"]):
                _delete(c, servers[side], outs[side])
        yield outs, snap


def test_http_statuses_are_equal(drives):
    outs, _ = drives
    assert outs["port"]["log"] == outs["jax"]["log"]
    assert outs["port"]["refused"] == [406] * 8
    for name in ("rev", "rev_test", "num", "img", "blob", "tok", "tok_test",
                 "fit", "mfit", "ev", "pr", "mpr", "rerun"):
        assert outs["port"][name]["jobState"] == "finished", name


@pytest.mark.parametrize("name", SHARDED)
def test_shard_directories_are_equal_and_cross_readable(drives, name):
    outs, snap = drives
    roots = {side: snap / side / name for side in ("jax", "port")}
    manifests = {s: json.loads((r / "manifest.json").read_text())
                 for s, r in roots.items()}
    assert manifests["port"] == manifests["jax"]
    for reader in (jsh.ShardedDataset, psh.ShardedDataset):
        ds = {s: reader(r) for s, r in roots.items()}
        assert ds["port"].n_shards == ds["jax"].n_shards > 1
        for k in range(ds["jax"].n_shards):
            want, got = ds["jax"].load_shard(k), ds["port"].load_shard(k)
            assert list(got) == list(want)
            for col in want:
                assert got[col].dtype == want[col].dtype, (name, col)
                np.testing.assert_array_equal(got[col], want[col])


def test_sharded_metadata_and_previews_agree(drives):
    outs, _ = drives
    jax_out, port_out = outs["jax"], outs["port"]
    for name in ("rev", "num", "img", "blob", "tok", "tok_test", "rerun"):
        want, got = jax_out[name], port_out[name]
        assert set(got) - UNPORTED_KEYS == set(want) - UNPORTED_KEYS, name
        for key in ("fields", "rows", "shards", "shardRows", "previewRows",
                    "featureShape", "vocabSize", "labelClasses",
                    "tokenizer", "sizeBytes", "sharded"):
            assert got.get(key) == want.get(key), (name, key)
    assert port_out["tok"]["labelClasses"] == ["neg", "pos"]
    assert port_out["tok"]["shards"] == 3
    for key in ("tok_page", "tok_test_page", "num_page", "img_page",
                "rerun_page"):
        assert data_rows(port_out[key]) == data_rows(jax_out[key]), key
    assert len(data_rows(port_out["tok_page"])) == 40


def test_streaming_fit_evaluate_and_predict_agree(drives):
    outs, _ = drives
    for key in ("fit_history", "mfit_history"):
        rows = {s: [r for r in o[key] if r.get("docType") == "history"]
                for s, o in outs.items()}
        assert [r["epoch"] for r in rows["port"]] == [0, 1]
        for metric in ("loss", "accuracy"):
            np.testing.assert_allclose(
                [r[metric] for r in rows["port"]],
                [r[metric] for r in rows["jax"]], err_msg=key, **TOL)
    ev = {s: o["ev_rows"][0] for s, o in outs.items()}
    assert set(ev["port"]) == set(ev["jax"]) == {"_id", "loss", "accuracy"}
    for metric in ("loss", "accuracy"):
        np.testing.assert_allclose(ev["port"][metric], ev["jax"][metric],
                                   **TOL)
    for key, shape in (("pr_rows", (20, 2)), ("mpr_rows", (30, 3))):
        preds = {s: np.asarray([r["result"] for r in o[key]])
                 for s, o in outs.items()}
        # The bare dataset fed the fit's feature columns, not the label.
        assert preds["port"].shape == shape
        np.testing.assert_allclose(preds["port"], preds["jax"], **TOL)


def test_delete_removes_the_shards_and_the_tokenizer(drives):
    outs, _ = drives
    for out in outs.values():
        assert out["before_delete"] == [True, True, True]
        assert out["after_delete"] == [False] * 4
        assert out["recreate"] == 406  # the tokenizer went with it
