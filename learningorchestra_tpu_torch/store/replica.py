"""WAL-shipping read replica for the document store — port of
``learningorchestra_tpu/store/replica.py`` (the same WAL format, so a
port replica follows a store either package writes).

The reference deploys a 3-node MongoDB replica set for persistence HA
(reference: docker-compose.yml:42-90 — mongo + two mongo-secondary
replicas behind a replSetInitiate).  The store here is a per-collection
JSONL write-ahead log (document_store.py), which makes replication a
byte-shipping problem instead of a protocol: a follower tails each
``<name>.wal``, appends the complete records to its OWN copy (fsync'd —
the replica must survive its own crash), and applies them to a live
read view.  Failover is :meth:`WalReplica.promote`: the replica
directory IS a valid store directory, so promotion is just opening it
for writes.

Transports
----------

The mongo secondaries replicate **over the wire** — independent nodes,
independent disks.  Shipping is therefore abstracted behind a transport
with two implementations:

- :class:`FsWalTransport` — reads the primary's store directory through
  the filesystem (shared mount / same host), the original deployment.
- :class:`HttpWalTransport` — pulls WAL byte-ranges from the primary's
  ``/replication`` routes (api/server.py), so a standby on a different
  host with its own disk replicates exactly like a mongo secondary.

Both raise :class:`ReplicationUnavailable` (an ``OSError``) when the
primary cannot be reached, and both are **fail-safe about absence**: a
primary whose store directory is missing, unmounted, or unreadable is a
sync FAILURE, never an instruction to delete replicated data.

Semantics:

- **Record-aligned shipping.**  Only byte ranges ending in a complete
  ``\\n``-terminated record ship; a torn tail on the primary (crash
  mid-append) is never copied, mirroring the primary's own recovery.
- **Compaction/rewrite detection.**  ``compact()`` rewrites a WAL in
  place; the follower detects the file shrinking below its shipped
  offset and resyncs that collection from byte 0 (same for a dropped
  and recreated collection).
- **Drop propagation is positive-evidence-only.**  A collection
  disappears from the replica only when a *successful, non-empty*
  listing of the primary omits it.  An unreachable or empty primary
  root (unmounted network mount, empty mountpoint at boot) must not be
  read as "everything was dropped" — that failure mode would otherwise
  wipe the replica and promote an empty store.
- **Pull model.**  ``sync()`` is explicit — call it on a timer, or
  from a cron/sidecar.  The primary needs no cooperation beyond its
  ordinary appends over the filesystem transport, and only the
  stateless ``/replication`` read routes over HTTP.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.store.document_store import (
    DocumentStore,
    _match,
)

#: Marker a promotion writes into the OLD primary's store dir.
FENCE_FILE = ".fenced"

#: Election-term file inside a store directory (mongo's replica-set
#: term).  Promotions bump it; a node whose peer serves a HIGHER epoch
#: knows it is the stale side of a healed partition.
EPOCH_FILE = ".epoch"


def read_epoch(store_root: str | Path) -> int:
    """The store's election epoch; 0 for a never-promoted store."""
    try:
        return int((Path(store_root) / EPOCH_FILE).read_text())
    except (OSError, ValueError):
        return 0


def write_epoch(store_root: str | Path, epoch: int) -> None:
    root = Path(store_root)
    root.mkdir(parents=True, exist_ok=True)
    (root / EPOCH_FILE).write_text(str(int(epoch)))


class ReplicationUnavailable(OSError):
    """The primary's WALs cannot be reached right now.

    Subclasses OSError so callers' existing transient-failure handling
    (StandbyMonitor.step keeps probing; promote ships best-effort)
    applies unchanged.
    """


class FsWalTransport:
    """Read the primary's WALs through the filesystem (shared mount)."""

    def __init__(self, primary_root: str | Path):
        self.primary_root = Path(primary_root)

    def list_wals(self) -> list[tuple[str, int]]:
        if not self.primary_root.is_dir():
            raise ReplicationUnavailable(
                f"primary store directory {self.primary_root} is "
                "missing or not a directory"
            )
        out = []
        for wal in sorted(self.primary_root.glob("*.wal")):
            try:
                out.append((wal.stem, wal.stat().st_size))
            except OSError:
                continue  # dropped between glob and stat
        return out

    def read(self, name: str, offset: int,
             length: int | None = None) -> bytes:
        try:
            with open(self.primary_root / f"{name}.wal", "rb") as fh:
                fh.seek(offset)
                return fh.read() if length is None else fh.read(length)
        except FileNotFoundError:
            return b""  # dropped between listing and read

    def epoch(self) -> int:
        return read_epoch(self.primary_root)

    def fence(self, record: dict) -> None:
        self.primary_root.mkdir(parents=True, exist_ok=True)
        (self.primary_root / FENCE_FILE).write_text(json.dumps(record))

    def __repr__(self) -> str:
        return f"FsWalTransport({self.primary_root})"


class HttpWalTransport:
    """Pull WAL byte-ranges from the primary's ``/replication`` routes.

    The network half of the mongo-secondary story (reference:
    docker-compose.yml:42-90 — replication rides the overlay network,
    no shared volume).  The primary serves:

    - ``GET  /replication/wals``                  — listing + epoch
    - ``GET  /replication/wal/<name>?from=&len=`` — raw byte range
    - ``POST /replication/fence``                 — fence + self-demote

    The epoch piggybacks on every listing so the standby still knows
    the primary's last term after the primary dies — promotion bumps
    from the cached value.
    """

    #: Bytes per range request when draining an unbounded read.
    CHUNK = 8 << 20

    def __init__(self, primary_addr: str,
                 prefix: str = "/api/learningOrchestra/v1",
                 timeout: float = 5.0):
        addr = primary_addr
        if not addr.startswith(("http://", "https://")):
            addr = f"http://{addr}"
        self.base = addr.rstrip("/") + prefix + "/replication"
        self.timeout = timeout
        self._epoch = 0

    def list_wals(self) -> list[tuple[str, int]]:
        try:
            with urllib.request.urlopen(
                self.base + "/wals", timeout=self.timeout
            ) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError) as exc:
            raise ReplicationUnavailable(
                f"primary replication endpoint unreachable: {exc}"
            ) from exc
        self._epoch = int(payload.get("epoch", 0))
        return [
            (w["name"], int(w["size"]))
            for w in payload.get("wals", [])
        ]

    def read(self, name: str, offset: int,
             length: int | None = None) -> bytes:
        if length is not None:
            return self._read_range(name, offset, length)
        out = bytearray()
        while True:
            chunk = self._read_range(
                name, offset + len(out), self.CHUNK
            )
            out += chunk
            if len(chunk) < self.CHUNK:
                return bytes(out)

    def _read_range(self, name: str, offset: int, length: int) -> bytes:
        url = (
            f"{self.base}/wal/{urllib.parse.quote(name)}"
            f"?from={int(offset)}&len={int(length)}"
        )
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return b""  # dropped between listing and read
            raise ReplicationUnavailable(
                f"replication read failed: HTTP {exc.code}"
            ) from exc
        except (urllib.error.URLError, OSError) as exc:
            raise ReplicationUnavailable(
                f"primary replication endpoint unreachable: {exc}"
            ) from exc

    def epoch(self) -> int:
        """Last epoch observed on a listing — survives primary death."""
        return self._epoch

    def fence(self, record: dict) -> None:
        req = urllib.request.Request(
            self.base + "/fence",
            method="POST",
            data=json.dumps(record).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except (urllib.error.URLError, OSError) as exc:
            raise ReplicationUnavailable(
                f"could not deliver fence to primary: {exc}"
            ) from exc

    def __repr__(self) -> str:
        return f"HttpWalTransport({self.base})"


def make_transport(primary) -> FsWalTransport | HttpWalTransport:
    """Path-like → filesystem shipping; address/URL → network shipping.

    A string counts as an address when it is an ``http(s)://`` URL or a
    ``host:port`` pair whose suffix is numeric — anything else (including
    plain relative paths) is a directory.
    """
    if hasattr(primary, "list_wals"):
        return primary
    if isinstance(primary, str):
        if primary.startswith(("http://", "https://")):
            return HttpWalTransport(primary)
        # host:port only when the host part is unambiguous — a plain
        # name/IPv4 or a bracketed IPv6 literal.  A bare IPv6 address
        # whose last group is decimal must not be misread as
        # host:port (use "[::1]:8080" to address an IPv6 primary).
        # (Kept in sync by hand with client.Context._make_base — the
        # client stays import-free so it can be vendored standalone.)
        host, _, port = primary.rpartition(":")
        unambiguous = ":" not in host or (
            host.startswith("[") and host.endswith("]")
        )
        if host and port.isdigit() and unambiguous and (
            "/" not in primary
        ):
            return HttpWalTransport(primary)
    return FsWalTransport(primary)


class WalReplica:
    """Read-only follower of a primary store, over either transport."""

    def __init__(self, primary, replica_root: str | Path):
        self.transport = make_transport(primary)
        self.replica_root = Path(replica_root)
        self.replica_root.mkdir(parents=True, exist_ok=True)
        self._offsets: dict[str, int] = {}
        self._docs: dict[str, dict[int, dict]] = {}
        # Bootstrap from whatever the replica dir already holds (a
        # follower restarting must not re-apply from zero into
        # duplicated state — offsets persist next to the shipped WALs).
        for wal in sorted(self.replica_root.glob("*.wal")):
            name = wal.stem
            self._offsets[name] = wal.stat().st_size
            self._docs[name] = {}
            self._apply_bytes(name, wal.read_bytes())

    # -- shipping -------------------------------------------------------------

    def sync(self, *, allow_drops: bool = True) -> dict:
        """Ship new complete records for every primary collection;
        returns {collection: bytes_shipped}.

        Raises :class:`ReplicationUnavailable` when the primary cannot
        be listed — distinguishing "primary gone" (keep everything,
        retry later) from "collection dropped" (mirror the drop).
        ``allow_drops=False`` additionally suppresses drop propagation
        for the final pre-promotion sync: a promote must never delete
        replicated data, whatever the dying primary looks like.
        """
        # Chaos probe: an injected `error` here models the standby
        # crashing mid-ship (its supervisor restarts it; shipped
        # offsets are durable, so the next sync resumes); `delay`
        # models replication lag — the kill-9 recovery drills run
        # their WAL shipping under seeded schedules.
        faults.hit("replica.wal_ship")
        listing = self.transport.list_wals()
        shipped: dict[str, int] = {}
        seen = set()
        for name, size in listing:
            seen.add(name)
            shipped[name] = self._sync_one(name, size)
        # Collections dropped on the primary disappear here too —
        # otherwise a promote would resurrect deleted data.  Only a
        # successful NON-EMPTY listing is evidence of a drop: an empty
        # one is indistinguishable from an unpopulated mountpoint, and
        # acting on it would wipe the replica in exactly the
        # primary-disk-gone failure mode HA exists to survive.
        if allow_drops and listing:
            for name in list(self._offsets):
                if name not in seen:
                    self._offsets.pop(name, None)
                    self._docs.pop(name, None)
                    dst = self.replica_root / f"{name}.wal"
                    if dst.exists():
                        dst.unlink()
        return shipped

    # Shipped-tail window compared against the primary on every sync:
    # detects a COMPACTED-then-REGROWN WAL whose size passed our offset
    # again (size alone can't) — mid-record shipping would silently
    # diverge the replica.
    TAIL_CHECK = 64

    def _sync_one(self, name: str, size: int) -> int:
        offset = self._offsets.get(name, 0)
        rewritten = size < offset
        if not rewritten and offset > 0:
            # Same-or-larger size: confirm the primary still holds the
            # bytes we shipped by comparing the tail window.
            dst = self.replica_root / f"{name}.wal"
            check = min(self.TAIL_CHECK, offset)
            primary_tail = self.transport.read(
                name, offset - check, check
            )
            if len(primary_tail) < check:
                # The file shrank or vanished between the listing and
                # this read (unmounting mid-sync, rmtree, drop race).
                # That is an INCONSISTENT SNAPSHOT, not a compaction:
                # misreading it as a rewrite would clear the replica's
                # copy — the data-loss path the listing guard exists
                # to block.  Fail the sync; the next listing tells the
                # truth.
                raise ReplicationUnavailable(
                    f"{name}.wal shrank below its listed size "
                    "mid-sync — primary snapshot inconsistent"
                )
            with open(dst, "rb") as fh:
                fh.seek(offset - check)
                replica_tail = fh.read(check)
            rewritten = primary_tail != replica_tail
        if rewritten:
            # Compaction (or drop+recreate) rewrote the file: restart
            # this collection from byte 0.
            offset = 0
            self._docs[name] = {}
            dst = self.replica_root / f"{name}.wal"
            if dst.exists():
                dst.unlink()
        data = self.transport.read(name, offset)
        # Ship complete records only: hold back everything past the
        # last newline (a mid-append torn tail must not replicate).
        cut = data.rfind(b"\n")
        if cut < 0:
            return 0
        chunk = data[: cut + 1]
        dst = self.replica_root / f"{name}.wal"
        with open(dst, "ab") as fh:
            fh.write(chunk)
            fh.flush()
            os.fsync(fh.fileno())
        self._offsets[name] = offset + len(chunk)
        self._apply_bytes(name, chunk)
        return len(chunk)

    def _apply_bytes(self, name: str, data: bytes) -> None:
        docs = self._docs.setdefault(name, {})
        for raw in data.splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                op = json.loads(raw)
            except ValueError:
                continue  # primary torn tail shipped pre-fix; skip
            kind = op.get("op")
            if kind == "i":
                docs[op["d"]["_id"]] = op["d"]
            elif kind == "u":
                if op["id"] in docs:
                    docs[op["id"]].update(op["d"])
            elif kind == "d":
                docs.pop(op["id"], None)

    # -- read surface ---------------------------------------------------------

    def list_collections(self) -> list[str]:
        return sorted(self._docs)

    def count(self, name: str, query: dict | None = None) -> int:
        return len(self.find(name, query))

    def find(self, name: str, query: dict | None = None) -> list[dict]:
        docs = self._docs.get(name, {})
        return [
            dict(d) for _id, d in sorted(docs.items())
            if _match(d, query)
        ]

    def find_one(self, name: str, _id: int) -> dict | None:
        doc = self._docs.get(name, {}).get(_id)
        return dict(doc) if doc is not None else None

    def lag_bytes(self) -> int:
        """Total unshipped primary bytes — the replication-lag gauge."""
        lag = 0
        for name, size in self.transport.list_wals():
            lag += max(0, size - self._offsets.get(name, 0))
        return lag

    # -- failover -------------------------------------------------------------

    def promote(self, durable_writes: bool = True) -> DocumentStore:
        """Open the replica directory as a WRITABLE store — the
        failover step.  The caller must stop syncing from the old
        primary first (a promoted replica is a new primary).  The
        final sync is best-effort (the primary is usually dead) and
        never deletes replicated data."""
        try:
            self.sync(allow_drops=False)
        except OSError:
            pass
        return DocumentStore(
            self.replica_root, durable_writes=durable_writes
        )
