"""Store failover (store/ha.py, the replication routes of api/server.py,
the client's failover retry) of the port, held against the JAX package's:

- the standby monitor of each package over its own copy of one primary
  store: the same probe decisions, takeover after ``max_misses``, a fence
  record and an election epoch bump of the same shape, a ``.promoted``
  record, and no takeover over a primary it never reached;
- a standby restarted after its promotion resumes as primary without
  re-syncing (post-failover writes survive); a foreign fence refuses;
- ``serve()`` refuses (status ``SERVE_REFUSED``) a fenced store, and a
  store whose HA peer serves a higher epoch, where it writes the fence;
  a running primary self-demotes on a fence marker and on a peer's
  higher epoch;
- the ``/replication/*`` answers of a port and a JAX server over
  equivalent stores match key for key (``tests/torch_rest_pair.py``),
  the fence POST's epoch rule included;
- the port's client retries once against the standby and stays
  repointed;
- kill -9 of a port ``serve --device cpu`` child under a write storm,
  with a port ``standby --device cpu`` child shipping its WALs: every
  acknowledged write is on the promoted standby, the client lands there
  without an operator, and the revived primary refuses with status 3.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from learningorchestra_tpu.client import ClientError as JaxClientError
from learningorchestra_tpu.store import DocumentStore as JaxStore
from learningorchestra_tpu.store import ha as jax_ha
from learningorchestra_tpu_torch.api.server import (
    SERVE_REFUSED,
    APIServer,
    serve,
)
from learningorchestra_tpu_torch.client import ClientError, Context
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.store import DocumentStore
from learningorchestra_tpu_torch.store import ha
from learningorchestra_tpu_torch.store.replica import (
    FENCE_FILE,
    read_epoch,
    write_epoch,
)
from tests.torch_rest_pair import server_pair

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "/api/learningOrchestra/v1"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _config(tmp_path, name="store") -> Config:
    cfg = Config()
    cfg.store.root = str(tmp_path / name)
    cfg.store.volume_root = str(tmp_path / "vol")
    return cfg


def _monitor_run(mod, store_cls, tmp_path):
    primary = store_cls(tmp_path / "p")
    primary.insert_one("jobs", {"name": "seed"}, _id=0)
    primary.close()
    write_epoch(tmp_path / "p", 4)
    mon = mod.StandbyMonitor("127.0.0.1:1", tmp_path / "p", tmp_path / "r",
                             check_interval=0.01, max_misses=3,
                             probe_timeout=0.2,
                             new_primary_addr="127.0.0.1:9")
    # Never reached: no takeover however many probes miss.
    cold = [mon.step() for _ in range(5)]
    mon.saw_primary, mon.misses = True, 0  # a healthy contact once
    decisions = [mon.step() for _ in range(3)]
    root = mon.promote()
    fence = mod.is_fenced(tmp_path / "p")
    record = mod.promotion_record(root)
    replica = store_cls(root)
    seed = replica.find_one("jobs", 0)["name"]
    replica.close()
    return (cold, decisions, read_epoch(root), sorted(fence),
            fence["epoch"], fence["promoted_to"], sorted(record), seed)


def test_monitor_promotes_fences_and_bumps_the_epoch_like_jax(tmp_path):
    port = _monitor_run(ha, DocumentStore, tmp_path / "port")
    jax = _monitor_run(jax_ha, JaxStore, tmp_path / "jax")
    assert port == jax
    cold, decisions, epoch, _, fence_epoch, promoted_to, _, seed = port
    assert cold == [False] * 5 and decisions == [False, False, True]
    assert epoch == fence_epoch == 5 and promoted_to == "127.0.0.1:9"
    assert seed == "seed"


def test_probe_counts_any_answer_as_alive(tmp_path):
    import http.server

    class Always503(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_error(503, "gateway saturated")

        def log_message(self, *args):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Always503)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        for mod in (ha, jax_ha):
            assert mod.StandbyMonitor(addr, tmp_path / "p", tmp_path / "r",
                                      probe_timeout=2).probe() is True
            assert mod.StandbyMonitor("127.0.0.1:1", tmp_path / "p",
                                      tmp_path / "r",
                                      probe_timeout=0.2).probe() is False
    finally:
        srv.shutdown()
        srv.server_close()


def _spawn(args, env, log: Path):
    """A child whose merged output goes to ``log`` (read on failure)."""
    with open(log, "w") as fh:
        return subprocess.Popen(args, env=env, stdout=fh,
                                stderr=subprocess.STDOUT, text=True)


def _tail(log: Path) -> str:
    return log.read_text(errors="replace")[-3000:] if log.exists() else ""


def _env(tmp_path, **extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "LO_TPU_VOLUME_ROOT": str(tmp_path / "vol"), **extra}
    env.pop("LO_TPU_WITNESS", None)
    return env


def _wait_health(port, proc, log, timeout=90):
    deadline = time.time() + timeout
    url = f"http://127.0.0.1:{port}{PREFIX}/health"
    while time.time() < deadline:
        assert proc.poll() is None, _tail(log)
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"no health on :{port}")


def test_restarted_standby_resumes_as_primary_without_rollback(tmp_path):
    primary, replica = tmp_path / "p", tmp_path / "r"
    DocumentStore(primary).insert_one("jobs", {"name": "old"}, _id=0)
    (primary / FENCE_FILE).write_text(json.dumps({
        "promoted_to": "127.0.0.1:9", "replica_root": str(replica)}))
    post = DocumentStore(replica)
    post.insert_one("post_failover", {"name": "survives"}, _id=0)
    post.close()
    (replica / ha.PROMOTED_FILE).write_text(json.dumps({"epoch": 1}))
    port = _free_port()
    proc = _spawn([sys.executable, "-m", "learningorchestra_tpu_torch",
                   "standby", "--primary", "127.0.0.1:1", "--primary-store",
                   str(primary), "--replica", str(replica), "--port",
                   str(port), "--host", "127.0.0.1", "--device", "cpu"],
                  _env(tmp_path), tmp_path / "standby.log")
    try:
        _wait_health(port, proc, tmp_path / "standby.log")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{PREFIX}/function/python/"
                "post_failover", timeout=5) as resp:
            assert json.loads(resp.read())[0]["name"] == "survives"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def test_a_foreign_fence_refuses_to_stand_by(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "p" / FENCE_FILE).write_text(json.dumps({
        "promoted_to": "10.0.0.9:8081",
        "replica_root": str(tmp_path / "someone_else")}))
    for mod in (ha, jax_ha):
        with pytest.raises(SystemExit, match="fenced in favor"):
            mod.run_standby("127.0.0.1:1", tmp_path / "p", tmp_path / "r",
                            _free_port(), **({"device": "cpu"}
                                             if mod is ha else {}))


def test_serve_refuses_a_fenced_store_and_a_higher_peer_epoch(tmp_path,
                                                              capsys):
    cfg = _config(tmp_path)
    cfg.store.store_path().mkdir(parents=True)
    (cfg.store.store_path() / FENCE_FILE).write_text(
        json.dumps({"promoted_to": "127.0.0.1:9999"}))
    assert serve(cfg, device="cpu") == SERVE_REFUSED
    assert "127.0.0.1:9999" in capsys.readouterr().out
    # No shared disk: the peer's /replication/status holds epoch 3.
    peer_cfg = _config(tmp_path, "peer")
    write_epoch(peer_cfg.store.store_path(), 3)
    peer = APIServer(peer_cfg, device="cpu")
    peer_port = peer.start_background()
    try:
        cfg = _config(tmp_path, "stale")
        write_epoch(cfg.store.store_path(), 2)
        cfg.ha.peer = f"127.0.0.1:{peer_port}"
        assert serve(cfg, device="cpu") == SERVE_REFUSED
        fence = ha.is_fenced(cfg.store.store_path())
        assert fence["epoch"] == 3 and fence["promoted_to"] == cfg.ha.peer
    finally:
        peer.shutdown()


def _demoted(url, deadline_s=15.0) -> bool:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2):
                time.sleep(0.1)
        except urllib.error.HTTPError as exc:
            if exc.code == 503:  # the kept-alive drain: demoted
                return True
            time.sleep(0.1)
        except OSError:
            return True  # the listener is closed
    return False


@pytest.mark.parametrize("how", ["fence_file", "peer_epoch"])
def test_a_running_primary_self_demotes(tmp_path, how):
    peer = None
    cfg = _config(tmp_path)
    if how == "peer_epoch":
        peer_cfg = _config(tmp_path, "peer")
        write_epoch(peer_cfg.store.store_path(), 1)
        peer = APIServer(peer_cfg, device="cpu")
        cfg.ha.peer = f"127.0.0.1:{peer.start_background()}"
    cfg.ha.fence_interval_s = 0.1
    server = APIServer(cfg, device="cpu")
    assert server.FENCE_CHECK_INTERVAL_S == 0.1
    try:
        port = server.start_background()
        url = f"http://127.0.0.1:{port}{PREFIX}/health"
        if how == "peer_epoch":
            # Equal epochs: the peer does not supersede this store.
            write_epoch(cfg.store.store_path(), 1)
            time.sleep(0.5)
            with urllib.request.urlopen(url, timeout=5) as resp:
                assert resp.status == 200
            write_epoch(peer.config.store.store_path(), 2)
        else:
            with urllib.request.urlopen(url, timeout=5) as resp:
                assert resp.status == 200
            (cfg.store.store_path() / FENCE_FILE).write_text(
                json.dumps({"promoted_to": "10.0.0.2:8081"}))
        assert _demoted(url), "the fenced primary kept serving"
        with pytest.raises(OSError):
            urllib.request.urlopen(url, timeout=2)
        assert ha.is_fenced(cfg.store.store_path()) is not None
    finally:
        server.shutdown()
        if peer is not None:
            peer.shutdown()


def _replication_answers(client, base_url, store_root):
    out = {}
    out["wals"] = client.request("GET", "/replication/wals")
    out["status"] = client.request("GET", "/replication/status")
    with urllib.request.urlopen(
            f"{base_url}/replication/wal/c?from=0&len=20",
            timeout=5) as resp:
        out["range"] = (resp.headers["Content-Type"], resp.read())
    try:
        client.request("GET", "/replication/wal/missing")
    except JaxClientError as exc:
        out["missing"] = exc.status
    try:
        client.request("POST", "/replication/fence",
                       {"epoch": 0, "promoted_to": "x"})
    except JaxClientError as exc:
        out["stale_fence"] = (exc.status, sorted(exc.payload))
    out["fence"] = client.request("POST", "/replication/fence",
                                  {"epoch": 7, "promoted_to": "peer:1"})
    out["fenced_file"] = json.loads((store_root / FENCE_FILE).read_text())
    return out


def test_replication_routes_answer_like_jax(tmp_path):
    out = {}
    with server_pair(tmp_path) as (servers, clients):
        for side, srv in servers.items():
            root = srv.config.store.store_path()
            # The same collection on both sides, written by the python
            # store of the side's own package.
            store = (DocumentStore if side == "port" else JaxStore)(root)
            store.insert_one("c", {"v": 1})
            store.insert_one("c", {"v": 2})
            store.close()
            base = clients[side].base
            out[side] = _replication_answers(clients[side], base, root)
    port, jax = out["port"], out["jax"]
    assert sorted(port["wals"]) == sorted(jax["wals"]) == [
        "epoch", "fenced", "wals"]
    sizes = {side: {w["name"]: w["size"] for w in o["wals"]["wals"]}
             for side, o in out.items()}
    assert sizes["port"]["c"] == sizes["jax"]["c"]
    for key in ("status", "range", "missing", "stale_fence", "fence",
                "fenced_file"):
        assert port[key] == jax[key], key
    assert port["status"] == {"role": "primary", "epoch": 0, "fence": None}
    assert port["fence"] == {"fenced": True}


def test_client_retries_once_then_stays_repointed(tmp_path):
    server = APIServer(_config(tmp_path), device="cpu")
    port = server.start_background()
    dead = _free_port()
    try:
        ctx = Context("127.0.0.1", port=dead, failover=f"127.0.0.1:{port}")
        assert ctx.request("GET", "/health") == {"status": "ok"}
        assert str(port) in ctx.base and str(dead) in ctx._failover_base
        survey = ctx.replication_status()
        assert survey["base"]["role"] == "primary"
        assert "unreachable" in survey["failover"]["error"]
        with pytest.raises(OSError):
            Context("127.0.0.1", port=dead).request("GET", "/health")
    finally:
        server.shutdown()


def test_kill9_under_a_write_storm_loses_no_acknowledged_write(tmp_path):
    """kill -9 of the primary mid-storm: the standby promotes within its
    probe window, every acknowledged write is on it, the client lands
    there, and the revived primary refuses with status 3."""
    pa, pb = _free_port(), _free_port()
    env = _env(tmp_path, LO_TPU_API_PORT=str(pa),
               LO_TPU_STORE_ROOT=str(tmp_path / "store"))
    logs = {"primary": tmp_path / "primary.log",
            "standby": tmp_path / "standby.log"}
    primary = _spawn([sys.executable, "-m", "learningorchestra_tpu_torch",
                      "serve", "--device", "cpu"], env, logs["primary"])
    standby = None
    storm_stop = threading.Event()
    acked: list[str] = []
    try:
        _wait_health(pa, primary, logs["primary"])
        standby = _spawn(
            [sys.executable, "-m", "learningorchestra_tpu_torch", "standby",
             "--primary", f"127.0.0.1:{pa}", "--primary-store",
             str(tmp_path / "store"), "--replica", str(tmp_path / "replica"),
             "--port", str(pb), "--host", "127.0.0.1", "--interval", "0.1",
             "--misses", "3", "--device", "cpu"], env, logs["standby"])
        status_url = f"http://127.0.0.1:{pb}{PREFIX}/replication/status"
        deadline = time.time() + 90
        while True:  # takeover arms once the standby reached the primary
            assert standby.poll() is None, _tail(logs["standby"])
            try:
                with urllib.request.urlopen(status_url, timeout=2) as resp:
                    if json.loads(resp.read()).get("saw_primary"):
                        break
            except OSError:
                pass
            assert time.time() < deadline, "the standby never armed"
            time.sleep(0.05)
        ctx = Context("127.0.0.1", port=pa, failover=f"127.0.0.1:{pb}")

        def storm():
            # A write that got an error was not acknowledged (it may or
            # may not have landed): the next write takes a fresh name.
            i = 0
            while not storm_stop.is_set():
                name = f"storm{i}"
                i += 1
                try:
                    ctx.request("POST", "/function/python",
                                {"name": name, "function": "response = 1"})
                    acked.append(name)  # acknowledged: must survive
                except (OSError, ClientError):
                    time.sleep(0.05)

        writer = threading.Thread(target=storm, daemon=True)
        writer.start()
        deadline = time.time() + 60
        while len(acked) < 15:
            assert time.time() < deadline, "the storm never got going"
            time.sleep(0.01)
        primary.send_signal(signal.SIGKILL)  # mid-storm
        primary.wait(timeout=30)
        killed_at = len(acked)
        deadline = time.time() + 90
        while len(acked) < killed_at + 3:  # writes resume on the standby
            assert standby.poll() is None, _tail(logs["standby"])
            assert time.time() < deadline, ("writes never recovered",
                                            _tail(logs["standby"]))
            time.sleep(0.05)
        storm_stop.set()
        writer.join(timeout=30)
        assert str(pb) in ctx.base
        for name in acked:
            docs = ctx.request("GET", f"/function/python/{name}")
            assert docs and docs[0].get("name") == name, name
        assert ha.is_fenced(tmp_path / "store") is not None
        assert read_epoch(tmp_path / "replica") == 1
        revived = subprocess.run(
            [sys.executable, "-m", "learningorchestra_tpu_torch", "serve",
             "--device", "cpu"], env=env, capture_output=True, text=True,
            timeout=120)
        assert revived.returncode == SERVE_REFUSED == 3
        assert "fenced" in revived.stdout
    finally:
        storm_stop.set()
        for proc in (primary, standby):
            if proc is not None and proc.poll() is None:
                proc.kill()
            if proc is not None:
                proc.wait()
