"""The port's WAL-shipping replica (store/replica.py) held against the JAX
package's on the same primary store directories, over both transports
(the filesystem and the primary's ``/replication`` routes, served here
by a port ``APIServer`` on the CPU):

- every sync ships the same bytes per collection and leaves the same
  documents and ``lag_bytes`` on both replicas, through appends, a torn
  tail on the primary (withheld until its record completes), a
  compaction (resynced from byte 0) and a dropped collection;
- a drop propagates only on a successful non-empty listing: an emptied
  primary root wipes nothing;
- an unreachable primary raises ``ReplicationUnavailable`` (an
  ``OSError``) and deletes nothing;
- a port replica follows a store the JAX package wrote and the JAX
  replica one the port wrote, and each promoted replica opens in the
  other package.
"""

import os
import socket

import pytest

from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu.store import replica as jax_replica
from learningorchestra_tpu_torch.store import DocumentStore
from learningorchestra_tpu_torch.store import replica

PKGS = {"port": replica, "jax": jax_replica}


def _dead_addr() -> str:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


@pytest.fixture(params=["fs", "http"])
def primary(request, tmp_path):
    """(store root, the address each transport is made from)."""
    root = tmp_path / "primary"
    root.mkdir()
    if request.param == "fs":
        yield root, str(root)
        return
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import Config

    cfg = Config()
    cfg.store.root = str(root)
    cfg.store.volume_root = str(tmp_path / "volumes")
    server = APIServer(cfg, device="cpu")
    port = server.start_background()
    try:
        yield root, f"127.0.0.1:{port}"
    finally:
        server.shutdown()


def _state(rep):
    return {name: rep.find(name) for name in rep.list_collections()}


def _step(reps):
    """One sync of each package's replica: the shipped bytes, state and
    lag must agree."""
    out = {}
    for name, rep in reps.items():
        out[name] = (rep.sync(), _state(rep), rep.lag_bytes())
    assert out["port"] == out["jax"], out
    return out["port"]


def test_replicas_ship_alike_through_tail_compaction_and_drop(primary,
                                                              tmp_path):
    root, addr = primary
    reps = {name: mod.WalReplica(addr, tmp_path / f"replica_{name}")
            for name, mod in PKGS.items()}
    assert type(reps["port"].transport).__name__ == type(
        reps["jax"].transport).__name__
    store = DocumentStore(root, durable_writes=True)
    try:
        for i in range(5):
            store.insert_one("a", {"i": i, "s": "x" * i})
        store.insert_one("b", {"k": "v"})
        shipped, state, lag = _step(reps)
        assert shipped["a"] == (root / "a.wal").stat().st_size and lag == 0
        assert [d["i"] for d in state["a"]] == list(range(5))
        # A torn tail (a crash mid-append) is withheld ...
        with open(root / "a.wal", "ab") as fh:
            fh.write(b'{"op": "i", "d": {"i": 99, "_id": 5')
        shipped, state, lag = _step(reps)
        assert shipped["a"] == 0 and len(state["a"]) == 5 and lag > 0
        # ... until the record completes.
        with open(root / "a.wal", "ab") as fh:
            fh.write(b'}}\n')
        shipped, state, _ = _step(reps)
        assert state["a"][-1]["i"] == 99
        store.close()
        store = DocumentStore(root, durable_writes=True)
        # A compaction rewrites the WAL below the shipped offset: resync.
        store.delete_one("a", 0)
        store.update_one("a", 1, {"s": "changed"})
        store.compact("a")
        shipped, state, _ = _step(reps)
        assert shipped["a"] == (root / "a.wal").stat().st_size
        assert [d["i"] for d in state["a"]] == [1, 2, 3, 4, 99]
        assert state["a"][0]["s"] == "changed"
        # A drop on a non-empty listing propagates.
        store.drop("b")
        _, state, _ = _step(reps)
        assert "b" not in state
        for rep in reps.values():
            assert not (rep.replica_root / "b.wal").exists()
    finally:
        store.close()


def test_drops_need_a_non_empty_listing(tmp_path):
    root = tmp_path / "primary"
    store = DocumentStore(root)
    store.insert_one("a", {"v": 1})
    store.close()
    reps = {name: mod.WalReplica(str(root), tmp_path / f"r_{name}")
            for name, mod in PKGS.items()}
    _step(reps)
    # An empty primary root (an unpopulated mount) is no evidence of a
    # drop: nothing is deleted.
    os.unlink(root / "a.wal")
    for name, rep in reps.items():
        assert rep.sync() == {}
        assert rep.find("a") == [{"v": 1, "_id": 0}], name
    # promote() never deletes either, whatever the primary shows.
    for name, rep in reps.items():
        promoted = rep.promote()
        try:
            assert promoted.find("a")[0]["v"] == 1, name
        finally:
            promoted.close()


@pytest.mark.parametrize("kind", ["fs", "http"])
def test_unreachable_primary_raises_and_wipes_nothing(tmp_path, kind):
    addr = str(tmp_path / "gone") if kind == "fs" else _dead_addr()
    for name, mod in PKGS.items():
        rep = mod.WalReplica(addr, tmp_path / f"r_{name}")
        (rep.replica_root / "a.wal").write_text(
            '{"op": "i", "d": {"v": 1, "_id": 0}}\n')
        rep = mod.WalReplica(addr, tmp_path / f"r_{name}")
        with pytest.raises(mod.ReplicationUnavailable) as exc:
            rep.sync()
        assert isinstance(exc.value, OSError)
        with pytest.raises(mod.ReplicationUnavailable):
            rep.lag_bytes()
        assert rep.find("a") == [{"v": 1, "_id": 0}], name


@pytest.mark.parametrize("writer,follower", [("jax", "port"),
                                             ("port", "jax")])
def test_a_replica_follows_the_other_packages_store(tmp_path, writer,
                                                    follower):
    stores = {"port": DocumentStore, "jax": JaxStore}
    src = stores[writer](tmp_path / "primary")
    for i in range(4):
        src.insert_one("c", {"i": i})
    src.update_one("c", 2, {"i": 20})
    src.delete_one("c", 3)
    src.close()
    rep = PKGS[follower].WalReplica(str(tmp_path / "primary"),
                                    tmp_path / "replica")
    rep.sync()
    assert [d["i"] for d in rep.find("c")] == [0, 1, 20]
    assert rep.lag_bytes() == 0
    rep.promote().close()
    # The promoted directory opens in the writer's package too.
    back = stores[writer](tmp_path / "replica")
    try:
        assert [d["i"] for d in back.find("c")] == [0, 1, 20]
    finally:
        back.close()


def test_transports_resolve_like_jax():
    for addr in ("http://h:1", "h:8080", "[::1]:80", "/data/store",
                 "relative/dir", "::1:8080", "host"):
        assert type(replica.make_transport(addr)).__name__ == type(
            jax_replica.make_transport(addr)).__name__, addr
    assert replica.read_epoch("/nonexistent/dir") == 0
