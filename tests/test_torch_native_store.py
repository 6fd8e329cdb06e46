"""The port's native document store and CSV engine (native/__init__.py,
built with g++ from ``csrc/docstore.cpp``) held against the JAX
package's native and Python stores and its CSV engine on the same input:

- one sequence of store operations gives the same answers op for op on
  the port's native store, the JAX native store and both Python stores;
- the WAL format interchanges across all of them: what one writes, the
  others reopen (and continue with the same ids);
- ``csv_parse`` and ``csv_numeric_chunk`` give the JAX engine's output
  byte for byte: quotes, CRLF and a BOM, short rows and blanks, the
  numeric contract, and a chunk boundary inside a quoted field;
- sharded native ingest through each package's dataset service gives the
  same shards, dtypes and preview as the JAX package's (and as the
  port's Python row path), and an in-memory ingest the same documents;
- two processes building the library at once both load a whole one.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.store import DocumentStore
from learningorchestra_tpu_torch.store.document_store import DuplicateKey

ROOT = Path(__file__).resolve().parent.parent

STORES = {
    "port_native": native.NativeDocumentStore,
    "jax_native": jax_native.NativeDocumentStore,
    "port_python": DocumentStore,
    "jax_python": JaxStore,
}


def _ops(store):
    out = []
    out.append(store.insert_one("c", {"a": 1, "s": "x"}))
    out.append(store.insert_many("c", [{"a": i, "t": "é,\"q\"\n"}
                                       for i in range(2, 7)]))
    out.append(store.insert_unique("c", {"meta": True}, 100))
    try:
        store.insert_unique("c", {"meta": False}, 100)
        out.append("inserted")
    except Exception as exc:  # noqa: BLE001 — each package's DuplicateKey
        out.append(type(exc).__name__)
    out.append(store.update_one("c", 2, {"a": 20, "new": [1, {"b": 2}]}))
    out.append(store.update_one("c", 999, {"a": 0}))
    out.append(store.delete_one("c", 3))
    out.append(store.delete_one("c", 3))
    out.append(store.find("c"))
    out.append(store.find("c", {"a": {"$gte": 4}}))
    out.append(store.find("c", sort_key="a", skip=1, limit=2))
    out.append(store.find_one("c", 2))
    out.append(store.find_one("c", 3))
    out.append(store.count("c"))
    out.append(store.count("c", {"a": {"$in": [1, 5]}}))
    out.append(sorted(store.aggregate_counts("c", "a").items(),
                      key=repr))
    out.append(store.collection_exists("c"))
    out.append(store.collection_exists("nope"))
    store.insert_one("d", {"x": 1})
    out.append(store.list_collections())
    out.append(store.drop("d"))
    out.append(store.list_collections())
    store.compact("c")
    out.append(store.insert_one("c", {"after": "compact"}))
    out.append(store.find("c"))
    try:
        store.find("nope")
        out.append("found")
    except Exception as exc:  # noqa: BLE001
        out.append(type(exc).__name__)
    with pytest.raises(ValueError):
        store.insert_one("../bad", {})
    return out


def test_every_store_answers_the_same_sequence(tmp_path):
    outs = {}
    for name, cls in STORES.items():
        store = cls(tmp_path / name)
        try:
            outs[name] = _ops(store)
        finally:
            store.close()
    for name, out in outs.items():
        assert out == outs["jax_python"], name
    assert outs["port_native"][3] == DuplicateKey.__name__


@pytest.mark.parametrize("writer", sorted(STORES))
def test_the_wal_interchanges_across_every_store(tmp_path, writer):
    w = STORES[writer](tmp_path / "s")
    w.insert_unique("c", {"name": "ds", "finished": False}, 0)
    w.insert_many("c", [{"i": i, "x": i * 0.5} for i in range(20)])
    w.update_one("c", 0, {"finished": True, "rows": 20})
    w.delete_one("c", 5)
    w.close()
    for reader, cls in STORES.items():
        r = cls(tmp_path / "s")
        try:
            assert r.count("c") == 20, reader
            assert r.find_one("c", 0)["rows"] == 20, reader
            assert r.find_one("c", 5) is None, reader
            assert r.find_one("c", 2)["x"] == 0.5, reader
        finally:
            r.close()
    # The id floor survives: the next insert continues past 20.
    last = STORES["port_native"](tmp_path / "s")
    try:
        assert last.insert_one("c", {}) == 21
    finally:
        last.close()


CSV_CASES = {
    "typed": b"Name,Age!,Score\nalice,30,1.5\nbob,,x\n",
    "quoted": b'a,b\n"x, y","line1\nline2"\n"say ""hi""",2\n',
    "crlf_bom": b"\xef\xbb\xbfa,b\r\n1,2\r\n3,4\r\n",
    "short_rows": b"a,b,c\n1\n2,3\n4,5,6,7\n",
    "numbers": b"a,b,c,d,e\n1e3,-0,+7,0x10,1_0\n9223372036854775808,1.0,"
               b"nan,inf, 5 \n",
    "no_trailing_newline": b"h1,h2\n1,2",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("infer", [True, False])
def test_csv_parse_matches_jax(case, infer):
    data = CSV_CASES[case]
    assert native.csv_parse(data, infer) == jax_native.csv_parse(data, infer)


NUMERIC_CASES = {
    "nan_contract": (b"1,2.5,3\n4,,x\n7,8,9", 3),
    "quoted_newline": (b'1,2\n3,"4\n', 2),
    "quotes_blanks": (b'"5","6.5",7,8\n\n1,2\n', 4),
    "spellings": (b"inf,nan,0x10,1_0,1e-310\n", 5),
    "crlf_floats": (b"1.0,2\r\n3,4.5\r\n", 2),
}


@pytest.mark.parametrize("case", sorted(NUMERIC_CASES))
@pytest.mark.parametrize("final", [False, True])
def test_csv_numeric_chunk_matches_jax(case, final):
    data, ncols = NUMERIC_CASES[case]
    got = {}
    for name, mod in (("port", native), ("jax", jax_native)):
        bad = np.zeros(ncols, np.int64)
        ffmt = np.zeros(ncols, np.int64)
        block, consumed = mod.csv_numeric_chunk(
            data, ncols, is_final=final, bad_counts=bad, float_counts=ffmt)
        got[name] = (block.tobytes(), block.shape, consumed, bad.tolist(),
                     ffmt.tolist())
    assert got["port"] == got["jax"]


def test_a_chunk_boundary_inside_a_quoted_field_rolls_back():
    bad = np.zeros(2, np.int64)
    full = b'1,2\n3,"4\n'
    block, consumed = native.csv_numeric_chunk(full, 2, is_final=False,
                                               bad_counts=bad)
    assert block.tolist() == [[1, 2]] and consumed == len(b"1,2\n")
    block, _ = native.csv_numeric_chunk(full[consumed:] + b'5"\n', 2,
                                        is_final=True, bad_counts=bad)
    assert block[0][0] == 3 and bad.tolist() == [0, 1]


def _covtype_like(path, rows=3000, seed=0):
    rng = np.random.default_rng(seed)
    cols = ["Elevation", "Slope", "Hillshade 9am", "ratio", "Cover_Type"]
    lines = [",".join(cols)]
    for i in range(rows):
        lines.append(",".join([
            str(int(rng.integers(1800, 3900))),
            str(int(rng.integers(0, 66))),
            "" if i % 97 == 0 else str(int(rng.integers(0, 255))),
            f"{rng.random():.6f}" if i % 5 else "2.0",
            str(int(rng.integers(1, 8)))]))
    path.write_text("\r\n".join(lines) + "\r\n")


def _ingest(pkg, tmp, url, shard_rows, backend="auto", native_csv=True,
            monkeypatch=None):
    if pkg == "port":
        from learningorchestra_tpu_torch.config import Config
        from learningorchestra_tpu_torch.services import dataset
        from learningorchestra_tpu_torch.services.context import (
            ServiceContext,
        )
        from learningorchestra_tpu_torch.store.sharded import (
            ShardedDataset,
        )

        kw = {"device": "cpu"}
    else:
        from learningorchestra_tpu.config import Config
        from learningorchestra_tpu.services import dataset
        from learningorchestra_tpu.services.context import ServiceContext
        from learningorchestra_tpu.store.sharded import ShardedDataset

        kw = {}
    if not native_csv:
        monkeypatch.setattr(dataset, "_native", lambda: None)
    cfg = Config()
    cfg.store.root = str(tmp / "store")
    cfg.store.volume_root = str(tmp / "volumes")
    cfg.store.backend = backend
    ctx = ServiceContext(cfg, **kw)
    try:
        svc = dataset.DatasetService(ctx)
        svc.create_csv("ds", url, shard_rows=shard_rows)
        ctx.engine.wait("ds", timeout=120)
        meta = ctx.artifacts.metadata.read("ds")
        assert meta["jobState"] == "finished", meta
        docs = ctx.documents.find("ds", query={
            "_id": {"$gte": 1}, "docType": {"$ne": "execution"}})
        shards = None
        if shard_rows:
            ds = ShardedDataset(ctx.volumes.path_for("dataset/csv", "ds"))
            shards = [{k: (v.dtype.str, v.tobytes())
                       for k, v in ds.load_shard(i).items()}
                      for i in range(ds.n_shards)]
        keep = ("fields", "rows", "sharded", "shards", "shardRows",
                "previewRows", "engine")
        return {k: meta.get(k) for k in keep}, docs, shards
    finally:
        ctx.close()


def test_sharded_native_ingest_matches_jax(tmp_path, monkeypatch):
    src = tmp_path / "cov.csv"
    _covtype_like(src)
    url = f"file://{src}"
    port = _ingest("port", tmp_path / "port", url, 1000)
    jax = _ingest("jax", tmp_path / "jax", url, 1000)
    assert port == jax
    assert port[0]["engine"] == "native" and port[0]["rows"] == 3000
    # The port's Python row path gives the same shards and preview.
    rows = _ingest("port", tmp_path / "rows", url, 1000, native_csv=False,
                   monkeypatch=monkeypatch)
    assert rows[1:] == port[1:]
    assert rows[0]["engine"] is None


@pytest.mark.parametrize("backend", ["native", "python"])
def test_in_memory_native_ingest_matches_jax(tmp_path, backend):
    src = tmp_path / "t.csv"
    src.write_bytes(b'\xef\xbb\xbfName,Age,"Note, here"\r\nalice,30,"a,b"\r\n'
                    b'bob,,"multi\nline"\r\ncarol,4.5,x\r\n')
    url = f"file://{src}"
    port = _ingest("port", tmp_path / "port", url, None, backend=backend)
    jax = _ingest("jax", tmp_path / "jax", url, None, backend=backend)
    assert port == jax
    assert [d["Name"] for d in port[1]] == ["alice", "bob", "carol"]


_BUILDER = textwrap.dedent("""
    import sys
    from pathlib import Path
    from learningorchestra_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    lib = native.load_library()
    fields, _ = native.csv_parse(b"a,b\\n1,2\\n")
    print(native.library_path().name, fields, flush=True)
""")


def test_two_processes_building_at_once_load_one_whole_library(tmp_path):
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
    assert outs[0][0] == outs[1][0]
    assert "['a', 'b']" in outs[0][0]
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == [outs[0][0].split()[0]]  # one library, no temp left
