"""Automatic store failover — port of ``learningorchestra_tpu/store/ha.py``,
the reference's replica-set election.

The reference deploys MongoDB as a 3-node replica set whose secondaries
take over automatically when the primary dies (reference:
docker-compose.yml:42-90 — ``replSetInitiate`` + client re-discovery).
Here the store is embedded in the API server process, so HA is a
process-pair story instead of a database protocol:

- The PRIMARY is an ordinary ``serve`` process over its store directory.
- A STANDBY process (``python -m learningorchestra_tpu_torch standby``)
  runs a
  :class:`StandbyMonitor`: it ships the primary's WALs continuously
  (:class:`~learningorchestra_tpu_torch.store.replica.WalReplica`) — through
  the filesystem when it shares a mount with the primary, or over the
  primary's ``/replication`` HTTP routes when it runs on its own host
  with its own disk (the mongo-secondary topology; pass the primary's
  ADDRESS instead of a store path).  It probes the primary's
  ``/health`` route every ``check_interval`` seconds, and after
  ``max_misses`` consecutive failed probes performs the election a
  Mongo secondary would win:

  1. **final sync** — ship every complete WAL record still readable
     from the primary.  On a shared filesystem a kill -9'd primary
     loses NO acknowledged writes: they are all in its WALs, and only
     the torn tail — which the primary's own restart recovery would
     also discard — is withheld.  Over the network the loss window is
     the replication lag, exactly Mongo's w:1 rollback window.
  2. **fence** — mark the old primary dead: write a ``.fenced`` marker
     into its store directory (filesystem transport) or POST it to the
     primary's ``/replication/fence`` route (network transport, lands
     only if the "dead" primary is actually alive behind a partition —
     which is precisely when the fence matters).  A fenced primary
     refuses to serve; a RUNNING one self-demotes (api/server.py).
  3. **epoch bump** — the promoted replica's ``.epoch`` becomes the
     primary's last-known epoch + 1 (mongo's election term).  A
     restarted old primary configured with ``LO_HA_PEER`` asks its
     peer's ``/replication/status`` and refuses to serve when the peer
     holds a HIGHER epoch — split-brain protection that needs no
     shared disk.
  4. **promote** — the replica directory is a valid store directory, so
     the standby opens it writable and starts the FULL API server on
     its own port: the new primary.  A ``.promoted`` record in the
     replica root makes standby restarts resume as primary instead of
     re-syncing from (and being rolled back by) the dead primary.

Clients pass ``failover=`` to :class:`~learningorchestra_tpu_torch.client.Context`
and retry once against the standby address on connection failure — the
client-side half of Mongo's automatic server re-discovery.
"""

from __future__ import annotations

import json
import socket
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.store.replica import (
    FENCE_FILE,
    WalReplica,
    make_transport,
    read_epoch,
    write_epoch,
)

__all__ = [
    "FENCE_FILE",
    "PROMOTED_FILE",
    "StandbyMonitor",
    "is_fenced",
    "peer_status",
    "read_epoch",
    "run_standby",
    "write_epoch",
]

log = get_logger("ha")  # get_logger prepends the "lo." namespace

#: Record a promotion writes into its OWN replica root — the standby's
#: durable memory that it became primary (the fence marker lives on the
#: OLD primary's disk, which a network standby cannot read).
PROMOTED_FILE = ".promoted"


def is_fenced(store_root: str | Path) -> dict | None:
    """Return the fence record if ``store_root`` was fenced by a
    promotion, else None.  ``serve`` checks this at startup so a
    supervisor-restarted old primary exits instead of split-braining."""
    path = Path(store_root) / FENCE_FILE
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        # Unreadable ≠ absent: a marker we cannot parse (torn write,
        # permission change) still means SOMEONE fenced this store —
        # fail safe and refuse to serve rather than split-brain.
        return {"reason": "unreadable fence marker"}


def promotion_record(replica_root: str | Path) -> dict | None:
    """The ``.promoted`` record if this replica already became primary."""
    path = Path(replica_root) / PROMOTED_FILE
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return {"reason": "unreadable promotion record"}


def peer_status(peer_addr: str, *, timeout: float = 2.0,
                prefix: str = "/api/learningOrchestra/v1") -> dict | None:
    """One ``/replication/status`` round-trip to the HA peer.

    Returns the peer's ``{"role", "epoch", ...}`` record, or None when
    the peer is unreachable.  A MONITORING standby answers this route
    too (``role="standby"``, _start_standby_status) — a non-None
    record is NOT proof the peer promoted; check ``role``."""
    url = f"http://{peer_addr}{prefix}/replication/status"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError):
        return None


class StandbyMonitor:
    """Ship WALs from a primary and decide when to take over.

    ``primary_store`` may be a path (filesystem shipping over a shared
    mount) or ``None`` — in which case WALs ship over HTTP from
    ``primary_addr`` and the node pair needs no shared storage at all.
    """

    def __init__(
        self,
        primary_addr: str,
        primary_store: str | Path | None,
        replica_root: str | Path,
        *,
        check_interval: float = 0.5,
        max_misses: int = 4,
        probe_timeout: float = 1.0,
        new_primary_addr: str = "",
        require_first_contact: bool = True,
    ):
        self.primary_addr = primary_addr
        self.primary_store = (
            Path(primary_store) if primary_store is not None else None
        )
        transport = make_transport(
            str(primary_store) if primary_store is not None
            else primary_addr
        )
        self.replica = WalReplica(transport, replica_root)
        self.check_interval = check_interval
        self.max_misses = max_misses
        self.probe_timeout = probe_timeout
        self.new_primary_addr = new_primary_addr
        # Never elect over a primary we have never reached: a standby
        # that boots alongside a slow-starting primary (cold `compose
        # up`: jax imports alone exceed interval*misses) must wait, not
        # fence a healthy node out of existence.  An unreachable-from-
        # birth primary is indistinguishable from a standby pointed at
        # the wrong address — takeover there is never safe.
        self.require_first_contact = require_first_contact
        self.saw_primary = False
        self.misses = 0
        # The primary's election term, refreshed on every successful
        # sync — promotion bumps from the LAST KNOWN value because the
        # primary is usually unreachable by then.
        self.primary_epoch = 0
        # Last successful sync, for the pre-promotion status endpoint
        # (mongo's printSecondaryReplicationInfo role): read cross-
        # thread by _StandbyStatusServer — plain floats/ints only.
        self.last_sync_at = 0.0
        self.last_sync_bytes = 0

    def probe(self) -> bool:
        """One /health round-trip: is the primary PROCESS alive?

        ANY HTTP response — including the gateway's 503 backpressure
        when ``max_inflight`` is saturated — proves a live process
        still serving its store; only connection-level failure
        (refused/reset/timeout) counts as a miss.  Promoting over a
        merely-saturated primary would split-brain the cluster.
        """
        url = (
            f"http://{self.primary_addr}/api/learningOrchestra/v1/health"
        )
        try:
            with urllib.request.urlopen(
                url, timeout=self.probe_timeout
            ):
                return True
        except urllib.error.HTTPError:
            return True  # it answered: alive
        except (urllib.error.URLError, OSError, TimeoutError):
            return False

    def step(self) -> bool:
        """One monitor iteration: sync, probe, count misses.

        Returns True when the takeover threshold is reached.  Sync
        happens BEFORE the probe so the replication lag at the moment
        of a detected death is one interval, not two.
        """
        try:
            shipped = self.replica.sync()
            self.last_sync_at = time.time()
            self.last_sync_bytes = sum(shipped.values())
            # Never let the cached epoch REGRESS: a degraded primary
            # whose store dir unmounted can answer a listing with
            # epoch 0 (read_epoch swallows the OSError); promoting
            # from a regressed value would mint an epoch BELOW the
            # real history and the split-brain protection would wave
            # the stale primary back in.
            self.primary_epoch = max(
                self.primary_epoch, self.replica.transport.epoch()
            )
        except OSError as exc:
            # A vanishing primary directory is itself a failure signal;
            # keep probing — the health check decides.  Nothing is
            # deleted on this path: sync() raised before touching the
            # replica's WALs.
            log.warning(f"standby sync error: {exc}")
        if self.probe():
            if not self.saw_primary:
                log.info(f"primary {self.primary_addr} reached — "
                         "takeover arming enabled")
            self.saw_primary = True
            self.misses = 0
            return False
        if self.require_first_contact and not self.saw_primary:
            # Startup grace: the primary may still be booting.
            self.misses += 1
            if self.misses % 30 == 0:
                log.warning(
                    f"primary {self.primary_addr} still unreached "
                    f"after {self.misses} probes; standing by "
                    "(takeover requires first contact)"
                )
            return False
        self.misses += 1
        log.warning(
            f"primary {self.primary_addr} missed health check "
            f"({self.misses}/{self.max_misses})"
        )
        return self.misses >= self.max_misses

    def run_until_takeover(self) -> Path:
        """Block until the primary is declared dead, then promote.

        Returns the replica root, now fenced-off from the old primary
        and ready to open as the new system-of-record.
        """
        while not self.step():
            time.sleep(self.check_interval)
        return self.promote()

    def promote(self) -> Path:
        """Final-sync, bump the epoch, fence the old primary, hand
        over the directory.  The final sync never deletes replicated
        data (``allow_drops=False``) — a dying primary that presents
        an empty or missing store must not take the replica with it."""
        # Chaos probe: an injected `error` models the standby dying at
        # the election moment — promotion is idempotent (the epoch
        # bump and fence land only on success), so a supervisor
        # restart re-promotes cleanly; the kill-9 recovery drills arm
        # seeded schedules here.
        faults.hit("store.ha.failover")
        try:
            shipped = self.replica.sync(allow_drops=False)
            self.primary_epoch = max(
                self.primary_epoch, self.replica.transport.epoch()
            )
        except OSError:
            shipped = {}
        new_epoch = self.primary_epoch + 1
        write_epoch(self.replica.replica_root, new_epoch)
        record = {
            "promoted_to": self.new_primary_addr,
            "replica_root": str(self.replica.replica_root),
            "old_primary": self.primary_addr,
            "epoch": new_epoch,
            "at": datetime.now(timezone.utc).isoformat(),
        }
        # Durable local memory FIRST: if we crash between here and
        # serving, the supervisor restart must resume as primary, not
        # re-sync from (and get rolled back by) the dead primary.
        (self.replica.replica_root / PROMOTED_FILE).write_text(
            json.dumps(record)
        )
        self._write_fence(record)
        total = sum(shipped.values())
        log.info(
            f"promoted replica {self.replica.replica_root} "
            f"(epoch {new_epoch}, final sync shipped {total} bytes)"
        )
        return self.replica.replica_root

    def _write_fence(self, record: dict) -> None:
        try:
            self.replica.transport.fence(record)
        except OSError as exc:
            # The primary may be gone entirely — promotion must still
            # proceed.  Over the filesystem this is best-effort
            # protection; over the network the epoch comparison
            # (serve()'s peer check) covers the restarted primary.
            log.warning(f"could not fence old primary: {exc}")


def _start_standby_status(host: str, port: int,
                          monitor: StandbyMonitor):
    """Observability for a MONITORING standby (mongo's
    ``rs.printSecondaryReplicationInfo()`` role): before promotion the
    standby binds its future API port and serves exactly one route —
    ``GET …/replication/status`` → ``role=standby`` + sync freshness —
    answering every other request 503 ("not promoted").  The 503 is
    part of the failover protocol: the client treats it as "pair
    alive, election hasn't happened" and does NOT repoint
    (client.py request()), unlike any other HTTP answer.  Binding
    early also reserves the port, so a colliding service fails at
    bring-up instead of at election time.

    Returns the server (shut it down before the promoted APIServer
    binds), or None when the port cannot be bound — status is an
    extra, never a reason to refuse to stand by.
    """
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/").endswith("/replication/status"):
                body = json.dumps({
                    "role": "standby",
                    "primary": monitor.primary_addr,
                    "epoch": monitor.primary_epoch,
                    "saw_primary": monitor.saw_primary,
                    "misses": monitor.misses,
                    "last_sync_at": monitor.last_sync_at,
                    "last_sync_bytes": monitor.last_sync_bytes,
                }).encode()
                self._send(200, body)
            else:
                self._not_promoted()

        def _not_promoted(self):
            self._send(503, json.dumps(
                {"error": "standby: monitoring, not promoted"}
            ).encode())

        do_POST = do_PATCH = do_DELETE = do_PUT = _not_promoted

        def _send(self, code: int, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # noqa: D102 — quiet
            pass

    try:
        srv = http.server.ThreadingHTTPServer((host, port), Handler)
    except OSError as exc:
        log.warning(
            f"standby status endpoint could not bind {host}:{port} "
            f"({exc}) — monitoring without it"
        )
        return None
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _prepay_device(device) -> None:
    """Pay what the promoted server's first answer would otherwise wait
    for while the primary is still healthy: the torch import, the CUDA
    context and the kernel libraries (built from ``csrc/`` when missing,
    then loaded), so takeover stays bound by the probe.  On the CPU only
    the import is paid."""
    import torch

    from learningorchestra_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return
    from learningorchestra_tpu_torch.kernels import build

    torch.cuda.init()
    torch.empty(1, device=dev)
    for name in build.SOURCES:
        build.load(name)


def run_standby(
    primary_addr: str,
    primary_store: str | Path | None,
    replica_root: str | Path,
    port: int,
    *,
    check_interval: float = 0.5,
    max_misses: int = 4,
    host: str = "0.0.0.0",
    device=None,
) -> None:
    """The ``standby`` CLI role: monitor, then become the API server.

    Blocks: first in the monitor loop, then — after promotion — serving
    the full REST API over the promoted directory on ``port`` until
    SIGINT.  ``device`` is where the promoted server's estimators run
    (the config's, ``"cuda"`` by default; ``"cpu"`` for a test); a
    standby that cannot reach that device fails at start, not at
    takeover.
    """
    # Pay the heavy server import (and the card's context and kernels)
    # while the primary is still healthy — takeover latency must be
    # probe-bound, not import-bound.
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import Config, set_config

    base = Config.from_env()
    device = device or base.device
    _prepay_device(device)

    # The advertised address lands in the fence record and the fenced
    # primary's operator guidance — a bind-all wildcard is useless
    # there, so substitute the host's name.
    advertised_host = (
        socket.gethostname() if host in ("0.0.0.0", "::") else host
    )

    def become_primary(promoted: Path) -> None:
        from learningorchestra_tpu_torch.api.server import _peer_supersedes

        config = Config.from_env()
        config.store.root = str(promoted)
        config.api.port = port
        # The dead primary is now OUR peer: if it resurrects with a
        # higher epoch (it re-promoted over us during a partition), we
        # must stand down — the fence watch polls it.
        config.ha.peer = primary_addr
        set_config(config)  # services resolving get_config() must agree
        # Startup epoch check, same as serve(): a RESUMING promoted
        # replica may itself have been superseded while down — serving
        # would split-brain until the fence watch's first peer poll.
        fence = _peer_supersedes(promoted, primary_addr)
        if fence is not None:
            print(
                "promoted replica is superseded by "
                f"{fence.get('promoted_to')!r} (higher election "
                "epoch) — refusing to resume as primary.",
                flush=True,
            )
            return
        server = APIServer(config, device=device)
        try:
            server.serve_forever(host=host, port=port)
        finally:
            server.shutdown()

    # Standby RESTART after promotion: the replica dir's own record is
    # authoritative (a network standby cannot read the old primary's
    # fence marker).  The replica dir is the current system of record —
    # syncing from the dead primary again would classify our own
    # post-failover WAL growth as a rewrite and roll it back.  A FENCE
    # in the replica root overrides the promotion record: someone
    # re-promoted over this store since.
    if promotion_record(replica_root) is not None:
        fence = is_fenced(replica_root)
        if fence is not None:
            # Clean exit (code 0): a supervisor's restart-on-failure
            # loop must END here, not crash-loop — same contract as
            # serve()'s fenced refusal.
            print(
                f"promoted replica {replica_root} was later fenced in "
                f"favor of {fence.get('promoted_to')!r} — superseded; "
                "refusing to resume as primary.",
                flush=True,
            )
            return
        log.info(
            "store already promoted to this replica — resuming as "
            "primary without re-sync"
        )
        become_primary(Path(replica_root))
        return

    if primary_store is not None:
        fence = is_fenced(primary_store)
        if fence is not None:
            # If WE fenced it (same replica root), this is a pre-
            # ``.promoted``-era restart after promotion: resume as
            # primary.  Otherwise someone ELSE is primary now.
            if Path(fence.get("replica_root", "")).resolve() == (
                Path(replica_root).resolve()
            ):
                log.info(
                    "store already promoted to this replica — resuming "
                    "as primary without re-sync"
                )
                become_primary(Path(replica_root))
                return
            raise SystemExit(
                f"{primary_store} is fenced in favor of "
                f"{fence.get('replica_root')!r} (promoted_to="
                f"{fence.get('promoted_to')!r}) — refusing to stand by "
                "for a dead primary; re-point --primary/--primary-store "
                "at the current one."
            )

    monitor = StandbyMonitor(
        primary_addr,
        primary_store,
        replica_root,
        check_interval=check_interval,
        max_misses=max_misses,
        new_primary_addr=f"{advertised_host}:{port}",
    )
    log.info(
        f"standby shipping {primary_store or primary_addr} -> "
        f"{replica_root} via {monitor.replica.transport!r}, "
        f"watching http://{primary_addr}/health"
    )
    status_srv = _start_standby_status(host, port, monitor)
    try:
        promoted = monitor.run_until_takeover()
    finally:
        # Free the port for the promoted APIServer (and on an
        # exception, for whatever supervises this role).
        if status_srv is not None:
            status_srv.shutdown()
            status_srv.server_close()
    become_primary(promoted)
