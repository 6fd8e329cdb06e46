"""Embedded, thread-safe, WAL-backed document store — port of
``learningorchestra_tpu/store/document_store.py``.

The system of record for every artifact: the Mongo subset the pipeline
uses (``insert_one`` / ``insert_unique`` / ``insert_many`` with atomic
integer ``_id`` allocation, ``update_one``, ``compare_and_update``,
``delete_one``, ``find`` with equality and ``$gt``-style operators,
``count``, ``aggregate_counts``, ``compact``, ``drop``).

Durability: one JSONL write-ahead log per collection (``<name>.wal``),
one op record per line — ``{"op": "i", "d": doc}`` insert, ``{"op": "u",
"id": _id, "d": fields}`` update, ``{"op": "d", "id": _id}`` delete,
``{"op": "n", "v": next_id}`` id floor — the JAX package's format, so
either package reopens the other's store.  Full state is replayed on
open; a torn final record (a crash mid-append) is truncated away, while
damage followed by valid records refuses to open.  Every append (one op
or a batch) passes the ``store.wal_write`` fault point first
(faults/plane.py); the API server's collector reports the WALs' bytes and
file count.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Iterable

from learningorchestra_tpu_torch import faults

# Collection names become file names; keep them safe.
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$")


class DuplicateKey(Exception):
    """insert_unique target _id already present."""


class CorruptWal(Exception):
    """WAL damaged beyond the torn-tail case a crash can produce."""


class NoSuchCollection(Exception):
    pass


def _match(doc: dict, query: dict | None) -> bool:
    """Mongo-style match: equality and $gt/$gte/$lt/$lte/$ne/$in."""
    if not query:
        return True
    for key, cond in query.items():
        val = doc.get(key)
        if isinstance(cond, dict):
            for op, operand in cond.items():
                try:
                    if op == "$gt" and not (val is not None and val > operand):
                        return False
                    elif op == "$gte" and not (
                        val is not None and val >= operand
                    ):
                        return False
                    elif op == "$lt" and not (val is not None and val < operand):
                        return False
                    elif op == "$lte" and not (
                        val is not None and val <= operand
                    ):
                        return False
                    elif op == "$ne" and not (val != operand):
                        return False
                    elif op == "$in" and val not in operand:
                        return False
                except TypeError:
                    return False
        elif val != cond:
            return False
    return True


def _parse(raw: bytes):
    """One WAL line -> its op record, or None when it is not a complete
    valid record (a missing newline means the append was cut)."""
    if not raw.endswith(b"\n"):
        return None
    try:
        op = json.loads(raw.strip())
    except ValueError:
        return None
    return op if isinstance(op, dict) and "op" in op else None


class _Collection:
    def __init__(self, path: Path, durable: bool):
        self.path = path
        self.durable = durable
        self.lock = threading.RLock()
        self.docs: dict[int, dict] = {}
        self.next_id = 0
        self._fh = None
        if path.exists():
            self._replay()
        self._open_log()

    def _apply(self, op: dict) -> None:
        # next_id stays monotonic across deletes: it tracks the largest
        # _id ever inserted, not the largest surviving one.
        kind = op["op"]
        if kind == "i":
            doc = op["d"]
            self.docs[doc["_id"]] = doc
            self.next_id = max(self.next_id, doc["_id"] + 1)
        elif kind == "u":
            if op["id"] in self.docs:
                self.docs[op["id"]].update(op["d"])
        elif kind == "d":
            self.docs.pop(op["id"], None)
        elif kind == "n":
            self.next_id = max(self.next_id, op["v"])

    def _replay(self) -> None:
        data = self.path.read_bytes()
        off = good_end = 0  # good_end: after the last valid record
        torn_at = None
        for raw in data.splitlines(keepends=True):
            end = off + len(raw)
            if not raw.strip():
                if raw.endswith(b"\n"):
                    good_end = end
                off = end
                continue
            op = _parse(raw)
            if op is None:
                torn_at = off
                break
            self._apply(op)
            good_end = off = end
        if torn_at is None:
            return
        # A crash mid-append leaves one torn record at the TAIL; valid
        # records after the bad one mean mid-file damage, and silently
        # dropping acknowledged writes is refused.
        for raw in data[torn_at:].splitlines(keepends=True)[1:]:
            if _parse(raw) is not None:
                raise CorruptWal(
                    f"{self.path}: invalid record at byte {torn_at} "
                    "followed by valid records — WAL is damaged mid-file, "
                    "refusing to open"
                )
        # Torn tail only: truncate to the last good record so the next
        # append starts a clean line.
        with open(self.path, "r+b") as fh:
            fh.truncate(good_end)

    def _open_log(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def append_lines(self, lines: list[str]) -> None:
        # Chaos probe BEFORE the write: an injected failure models a
        # failing disk at the WAL boundary (the in-memory map may run
        # ahead of the log; recovery is replay-on-reopen).
        faults.hit("store.wal_write")
        self._fh.write("\n".join(lines) + "\n")
        self._fh.flush()
        if self.durable:
            os.fsync(self._fh.fileno())

    def append(self, op: dict) -> None:
        self.append_lines([json.dumps(op, default=str)])

    def insert(self, doc: dict, _id: int) -> int:
        """Insert ``doc`` at ``_id`` (caller holds the lock)."""
        doc = dict(doc)
        doc["_id"] = _id
        self.next_id = max(self.next_id, _id + 1)
        self.docs[_id] = doc
        self.append({"op": "i", "d": doc})
        return _id

    def update(self, _id: int, fields: dict) -> None:
        """Merge ``fields`` into an existing doc (caller holds the lock)."""
        fields = dict(fields)
        fields.pop("_id", None)
        self.docs[_id].update(fields)
        self.append({"op": "u", "id": _id, "d": fields})

    def close(self) -> None:
        with self.lock:
            if self._fh:
                self._fh.close()
                self._fh = None


class DocumentStore:
    """A directory of collections, each a WAL-backed dict of documents."""

    def __init__(self, root: str | Path, durable_writes: bool = False):
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self.durable = durable_writes
        self._collections: dict[str, _Collection] = {}
        self._lock = threading.Lock()
        for wal in sorted(self.root.glob("*.wal")):
            self._collections[wal.stem] = _Collection(wal, durable_writes)

    # -- collection lifecycle -------------------------------------------------

    @staticmethod
    def _validate_name(name: str) -> None:
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"invalid collection name: {name!r}")

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._collections)

    def collection_exists(self, name: str) -> bool:
        with self._lock:
            return name in self._collections

    def _get(self, name: str, create: bool = False) -> _Collection:
        with self._lock:
            coll = self._collections.get(name)
            if coll is None:
                if not create:
                    raise NoSuchCollection(name)
                self._validate_name(name)
                coll = _Collection(self.root / f"{name}.wal", self.durable)
                self._collections[name] = coll
            return coll

    def drop(self, name: str) -> bool:
        with self._lock:
            coll = self._collections.pop(name, None)
        if coll is None:
            return False
        coll.close()
        try:
            coll.path.unlink()
        except FileNotFoundError:
            pass
        return True

    # -- writes ---------------------------------------------------------------

    def insert_one(self, name: str, doc: dict, _id: int | None = None) -> int:
        """Insert, atomically allocating ``_id`` unless one is given."""
        coll = self._get(name, create=True)
        with coll.lock:
            return coll.insert(doc, coll.next_id if _id is None else _id)

    def insert_unique(self, name: str, doc: dict, _id: int) -> int:
        """Insert at an explicit ``_id``, failing atomically if present:
        the duplicate-name gate is check-and-insert under one lock, so two
        concurrent POSTs of one name cannot both succeed."""
        coll = self._get(name, create=True)
        with coll.lock:
            if _id in coll.docs:
                raise DuplicateKey(f"{name}[{_id}]")
            return coll.insert(doc, _id)

    def insert_many(self, name: str, docs: Iterable[dict]) -> int:
        """Batched insert: one WAL append for the whole batch."""
        coll = self._get(name, create=True)
        with coll.lock:
            lines = []
            for doc in docs:
                doc = dict(doc)
                doc["_id"] = coll.next_id
                coll.next_id += 1
                coll.docs[doc["_id"]] = doc
                lines.append(json.dumps({"op": "i", "d": doc}, default=str))
            if lines:
                coll.append_lines(lines)
        return len(lines)

    def update_one(self, name: str, _id: int, fields: dict) -> bool:
        coll = self._get(name)
        with coll.lock:
            if _id not in coll.docs:
                return False
            coll.update(_id, fields)
            return True

    def compare_and_update(self, name: str, _id: int, expect: dict,
                           fields: dict) -> bool:
        """Atomic compare-and-swap on one document: apply ``fields`` only
        if every ``expect`` item currently matches."""
        try:
            coll = self._get(name)
        except NoSuchCollection:
            return False
        with coll.lock:
            doc = coll.docs.get(_id)
            if doc is None or any(
                doc.get(k) != v for k, v in expect.items()
            ):
                return False
            coll.update(_id, fields)
            return True

    def delete_one(self, name: str, _id: int) -> bool:
        coll = self._get(name)
        with coll.lock:
            if _id not in coll.docs:
                return False
            del coll.docs[_id]
            coll.append({"op": "d", "id": _id})
            return True

    # -- reads ----------------------------------------------------------------

    def find(
        self,
        name: str,
        query: dict | None = None,
        sort_key: str = "_id",
        skip: int = 0,
        limit: int | None = None,
    ) -> list[dict]:
        """Query -> sorted (by ``sort_key``) -> skip -> limit."""
        coll = self._get(name)
        with coll.lock:
            docs = [dict(d) for d in coll.docs.values() if _match(d, query)]
        docs.sort(key=lambda d: (d.get(sort_key) is None, d.get(sort_key)))
        if skip:
            docs = docs[skip:]
        if limit is not None:
            docs = docs[:limit]
        return docs

    def find_one(self, name: str, _id: int) -> dict | None:
        try:
            coll = self._get(name)
        except NoSuchCollection:
            return None
        with coll.lock:
            doc = coll.docs.get(_id)
            return dict(doc) if doc is not None else None

    def count(self, name: str, query: dict | None = None) -> int:
        coll = self._get(name)
        with coll.lock:
            if query is None:
                return len(coll.docs)
            return sum(1 for d in coll.docs.values() if _match(d, query))

    def aggregate_counts(
        self, name: str, field: str, exclude_ids: tuple = (0,)
    ) -> dict[Any, int]:
        """Value counts of ``field`` over the data rows (metadata and
        execution documents excluded)."""
        coll = self._get(name)
        counts: dict[Any, int] = {}
        with coll.lock:
            for _id, doc in coll.docs.items():
                if _id in exclude_ids or doc.get("docType") == "execution":
                    continue
                val = doc.get(field)
                if isinstance(val, (list, dict)):
                    val = json.dumps(val, default=str)
                counts[val] = counts.get(val, 0) + 1
        return counts

    # -- maintenance ----------------------------------------------------------

    def compact(self, name: str) -> None:
        """Rewrite a collection's WAL to its current state; the new file
        is fsync'd before it replaces the live log (and the directory
        after), so a crash mid-compaction never surfaces a partial
        collection."""
        coll = self._get(name)
        with coll.lock:
            tmp = coll.path.with_suffix(".wal.tmp")
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(json.dumps({"op": "n", "v": coll.next_id}) + "\n")
                for doc in coll.docs.values():
                    fh.write(json.dumps({"op": "i", "d": doc}, default=str)
                             + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            coll._fh.close()
            os.replace(tmp, coll.path)
            dir_fd = os.open(coll.path.parent, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
            coll._open_log()

    def close(self) -> None:
        with self._lock:
            for coll in self._collections.values():
                coll.close()
            self._collections.clear()
