"""URL sources on a JAX and a port server side by side: both fetch the
same ``http://`` URLs from one ``http.server`` on localhost (the JAX
package with ``requests``, the port with ``urllib.request``).

- a CSV: equal rows on both, and equal to the port's ingest of the same
  bytes from a ``file://`` URL;
- a sharded CSV (``shardRows``): equal metadata, preview rows and shards;
- a ``.npy`` tensor pair (``POST /dataset/tensor``): equal metadata and
  shards, equal to the source arrays;
- a generic file: equal sizes, the same bytes on both volumes;
- ``/function/python`` given by URL: equal result rows and message;
- a URL answering 404, as a CSV and as a function: the job fails on both,
  with the status in its exception.
"""

import numpy as np
import pytest
import requests

from learningorchestra_tpu_torch.store.sharded import ShardedDataset
from tests.torch_rest_pair import (
    UNPORTED_KEYS,
    data_rows,
    serve_dir,
    server_pair,
)

SIDES = ("jax", "port")
FUNCTION = """
import numpy as np
print("fetched")
response = {"sum": float(np.arange(int(n)).sum()), "n": int(n)}
"""


def _wait(base, name, timeout=60):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        meta = requests.get(f"{base}/observe/{name}",
                            params={"timeout": 10}).json()["metadata"]
        if meta.get("finished") or meta.get("jobState") == "failed":
            return meta
    raise AssertionError(f"timeout waiting for {name}")


def _all_rows(base, path):
    docs = []
    while True:
        page = requests.get(f"{base}/{path}",
                            params={"skip": len(docs), "limit": 100}).json()
        docs += page
        if len(page) < 100:
            return docs


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("urls")
    www = tmp / "www"
    www.mkdir()
    rng = np.random.default_rng(7)
    with open(www / "d.csv", "w") as fh:
        fh.write("Name,x 1,x2,label\n")
        for i in range(150):
            fh.write(f"r{i},{rng.normal():.5f},{int(rng.integers(0, 9))},"
                     f"{i % 2}\n")
    with open(www / "n.csv", "w") as fh:
        fh.write("a,b,label\n")
        for i in range(70):
            fh.write(f"{rng.normal():.4f},{i},{i % 3}\n")
    feats = rng.normal(size=(40, 4, 4, 1)).astype(np.float32)
    labels = rng.integers(0, 5, 40).astype(np.int32)
    np.save(www / "x.npy", feats)
    np.save(www / "y.npy", labels)
    (www / "blob.bin").write_bytes(rng.bytes(5000))
    (www / "f.py").write_text(FUNCTION)
    requests_by_name = {
        "csv": ("dataset/csv", {"datasetName": "csv",
                                "url": "{base}/d.csv"}),
        "sharded": ("dataset/csv", {"datasetName": "sharded",
                                    "url": "{base}/n.csv",
                                    "shardRows": 16}),
        "tensor": ("dataset/tensor", {"datasetName": "tensor",
                                      "url": "{base}/x.npy",
                                      "labelsUrl": "{base}/y.npy",
                                      "shardRows": 16}),
        "generic": ("dataset/generic", {"datasetName": "generic",
                                        "url": "{base}/blob.bin"}),
        "fn": ("function/python", {"name": "fn",
                                   "function": "{base}/f.py",
                                   "functionParameters": {"n": 5}}),
        "missing": ("dataset/csv", {"datasetName": "missing",
                                    "url": "{base}/nosuch.csv"}),
        "fn_missing": ("function/python", {"name": "fn_missing",
                                           "function": "{base}/nosuch.py"}),
    }
    out = {side: {} for side in SIDES}
    with server_pair(tmp) as (servers, clients), serve_dir(www) as url:
        for side in SIDES:
            base = clients[side].base
            for name, (route, body) in requests_by_name.items():
                body = {k: v.format(base=url) if isinstance(v, str) else v
                        for k, v in body.items()}
                resp = requests.post(f"{base}/{route}", json=body)
                assert resp.status_code == 201, (side, name, resp.text)
                out[side][name] = {"meta": _wait(base, name)}
            for name, (route, _) in requests_by_name.items():
                out[side][name]["rows"] = data_rows(
                    _all_rows(base, f"{route}/{name}"))
            vols = servers[side].ctx.volumes
            for name, kind in (("sharded", "dataset/csv"),
                               ("tensor", "dataset/tensor")):
                ds = ShardedDataset(vols.path_for(kind, name))
                out[side][name]["shards"] = [
                    ds.load_shard(k) for k in range(ds.n_shards)]
            out[side]["generic"]["bytes"] = vols.path_for(
                "dataset/generic", "generic").read_bytes()
        # The same CSV bytes from a file:// URL, on the port.
        base = clients["port"].base
        resp = requests.post(f"{base}/dataset/csv", json={
            "datasetName": "csv_file", "url": f"file://{www / 'd.csv'}"})
        assert resp.status_code == 201, resp.text
        _wait(base, "csv_file")
        out["file_rows"] = data_rows(_all_rows(base, "dataset/csv/csv_file"))
    out["source"] = {"x": feats, "label": labels,
                     "blob": (www / "blob.bin").read_bytes()}
    yield out


@pytest.mark.parametrize("name", ["csv", "sharded", "tensor", "generic",
                                  "fn"])
def test_url_source_ingests_equal_on_both(drive, name):
    jax_out, port_out = drive["jax"][name], drive["port"][name]
    assert port_out["meta"]["jobState"] == jax_out["meta"]["jobState"] \
        == "finished"
    assert set(port_out["meta"]) - UNPORTED_KEYS == \
        set(jax_out["meta"]) - UNPORTED_KEYS
    for key in ("fields", "rows", "shards", "shardRows", "featureShape",
                "sizeBytes", "sharded", "url"):
        assert port_out["meta"].get(key) == jax_out["meta"].get(key), key
    strip = [{k: v for k, v in r.items() if k != "_id"}
             for r in port_out["rows"]]
    assert strip == [{k: v for k, v in r.items() if k != "_id"}
                     for r in jax_out["rows"]]
    for got, want in zip(port_out.get("shards", []),
                         jax_out.get("shards", [])):
        assert set(got) == set(want)
        for col in want:
            np.testing.assert_array_equal(got[col], want[col])


def test_csv_url_equals_file_ingest(drive):
    rows = drive["port"]["csv"]["rows"]
    assert len(rows) == 150
    assert [{k: v for k, v in r.items() if k != "_id"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "_id"}
         for r in drive["file_rows"]]
    assert rows[0]["x_1"] is not None and rows[0]["Name"] == "r0"


def test_tensor_and_generic_bytes_reach_the_volume(drive):
    shards = drive["port"]["tensor"]["shards"]
    np.testing.assert_array_equal(
        np.concatenate([s["x"] for s in shards]), drive["source"]["x"])
    np.testing.assert_array_equal(
        np.concatenate([s["label"] for s in shards]),
        drive["source"]["label"])
    assert drive["port"]["generic"]["bytes"] == \
        drive["jax"]["generic"]["bytes"] == drive["source"]["blob"]


def test_function_by_url_runs_the_fetched_code(drive):
    rows = drive["port"]["fn"]["rows"]
    assert rows[0]["result"] == {"sum": 10.0, "n": 5}
    assert rows[0]["functionMessage"] == "fetched\n"


@pytest.mark.parametrize("name", ["missing", "fn_missing"])
def test_http_404_fails_the_job_on_both(drive, name):
    for side in SIDES:
        meta = drive[side][name]["meta"]
        assert meta["jobState"] == "failed", side
        assert "404 Client Error" in meta["exception"], (side, meta)
    assert drive["port"][name]["meta"]["exception"] == \
        drive["jax"][name]["meta"]["exception"]
