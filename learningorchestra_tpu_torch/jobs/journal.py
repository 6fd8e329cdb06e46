"""Crash-durable job journal and engine-epoch fencing — port of
``learningorchestra_tpu/jobs/journal.py``.

The engine's queue and running set live in memory: without a journal, a
``kill -9`` of the orchestrator loses every queued job and strands
running ones as forever-"running" metadata.  Two pieces close that gap.

**Journal.**  Every job state transition (``submitted -> queued ->
running(attempt N) -> finished | failed | cancelled``, plus
``deadline`` and ``cancel_requested``) is appended to the
``_job_journal`` store collection, which rides the document store's WAL
(same torn-tail recovery and compaction as every artifact).  Records are
keyed by job name and carry the submit spec (method, class, deadline),
so :meth:`JobJournal.replay` folds them into one terminal-or-latest
state per job in queue admission order.  Both packages write the same
collection with the same fields, so a journal either one wrote replays
in the other.

**Epoch fencing.**  Each boot mints an **engine epoch**, a monotonic
counter in ``.engine_epoch`` inside the store root.  The engine stamps
the boot epoch on every dispatched job body (a contextvar); terminal
metadata commits and artifact publications re-read the durable file and
refuse to commit when a newer epoch exists (:meth:`JobJournal.
fence_check` raises :class:`StaleEpochError`), so a straggler from a
previous life cannot double-publish.

Every record is group-committed: the hot path enqueues a record (one
deque append) and a flusher thread drains FIFO batches into the WAL.  A
crash inside that sub-millisecond window can lose a record, which is
harmless by construction: recovery is metadata-authoritative (the
artifact's own metadata holds the same transitions, written inline, and
the request parameters stamped at submit), so at worst a job is demoted
from re-dispatch to the explicit ``orphaned-by-restart`` path, never
lost or run twice.  Fence checks read a one-line file, only at terminal
commits and publications.

Under the multi-engine control plane (jobs/cluster.py) the context sets
two hooks, as in the JAX journal: ``cluster``, to which the fence
delegates (a commit needs this engine to still own the job's live claim
under its stamped epoch), and ``exclusive``, the coordinator's
cross-process guard, around every append and replay so two engines never
allocate the same ``_id``.  Epoch minting runs under ``epoch_lock`` (the
same guard), so engines booting at once mint distinct epochs.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import TYPE_CHECKING

from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.log import get_logger, kv

if TYPE_CHECKING:  # at run time a cycle: store/ imports train/neural.py
    from learningorchestra_tpu_torch.store.document_store import (
        DocumentStore,
    )

logger = get_logger("journal")

#: Store collection holding journal records (underscore prefix: outside
#: the artifact namespace).
JOURNAL_COLLECTION = "_job_journal"

#: Engine-epoch counter file inside the store root.
ENGINE_EPOCH_FILE = ".engine_epoch"

#: Events that end a job's life; after anything else a restart must
#: recover the job.
TERMINAL_EVENTS = frozenset({"finished", "failed", "cancelled", "deadline"})

#: Every event the JAX engine journals (the port's engine never
#: preempts, so it writes all of them but ``preempted``).
EVENTS = (
    "submitted",
    "queued",
    "running",
    "preempted",
    "cancel_requested",
    "finished",
    "failed",
    "cancelled",
    "deadline",
)


class StaleEpochError(RuntimeError):
    """A worker from an older engine epoch tried to commit: a newer
    recovery owns this store now, and the write is refused."""


def read_engine_epoch(store_root: str | Path) -> int:
    """The store's engine epoch; 0 for a store no engine booted on."""
    try:
        return int((Path(store_root) / ENGINE_EPOCH_FILE).read_text())
    except (OSError, ValueError):
        return 0


def write_engine_epoch(store_root: str | Path, epoch: int) -> None:
    """Durably publish ``epoch`` (write, fsync, atomic replace): fencing
    is only as strong as this file's crash durability."""
    root = Path(store_root)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / (ENGINE_EPOCH_FILE + ".tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(str(int(epoch)))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, root / ENGINE_EPOCH_FILE)


#: The dispatched job body's engine epoch (None outside a dispatch:
#: direct library use runs unfenced).
_STAMP: contextvars.ContextVar = contextvars.ContextVar(
    "lo_engine_epoch", default=None
)


def current_stamp() -> int | None:
    """The engine epoch stamped on the calling job body's dispatch."""
    return _STAMP.get()


@contextlib.contextmanager
def stamp(epoch: int | None):
    """Bind ``epoch`` as the current body's engine epoch (the engine
    wraps each dispatch; tests bind stale values to drive the fence)."""
    handle = _STAMP.set(epoch)
    try:
        yield
    finally:
        _STAMP.reset(handle)


class JobJournal:
    """Append/replay surface over the ``_job_journal`` collection.

    Writes go through the document store, whose per-collection lock
    serializes WAL appends and allocates monotonic ``_id`` sequence
    numbers; drains are serialized by ``_flush_lock``, so batch order is
    enqueue order.
    """

    def __init__(self, documents: DocumentStore,
                 store_root: str | Path, *,
                 enabled: bool = True, max_records: int = 4096,
                 epoch_lock=None):
        self.documents = documents
        self.store_root = Path(store_root)
        self.enabled = bool(enabled)
        self.max_records = int(max_records)
        #: Zero-arg callable returning a context manager that holds the
        #: cluster's cross-process lock (None: one engine, no lock).
        self._epoch_lock = epoch_lock
        #: Set by the context under clustering: ``cluster`` takes over
        #: the fence (claim ownership), ``exclusive`` (a zero-arg guard
        #: factory refreshing this collection) wraps appends and replays.
        self.cluster = None
        self.exclusive = None
        #: Appends that failed (store fault, disk full): a lossy journal
        #: stays countable.
        self.dropped = 0
        self._pending: deque = deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._flush_lock = make_lock("JobJournal._flush_lock")
        self._flusher: threading.Thread | None = None
        # Each construction is an engine boot: the next epoch fences
        # stragglers of every previous life.  A disabled journal keeps
        # epoch 0 and never fences.
        self.epoch = self._mint_epoch() if self.enabled else 0

    # -- epoch fencing --------------------------------------------------------

    def _mint_epoch(self) -> int:
        lock = (self._epoch_lock() if self._epoch_lock is not None
                else contextlib.nullcontext())
        with lock:
            epoch = read_engine_epoch(self.store_root) + 1
            write_engine_epoch(self.store_root, epoch)
        logger.info(kv(event="engine_epoch_minted", epoch=epoch))
        return epoch

    def durable_epoch(self) -> int:
        """The store's current epoch, re-read from disk."""
        return read_engine_epoch(self.store_root)

    def fence_check(self, stamped: int | None = None) -> None:
        """Refuse a commit from a stale engine epoch.

        ``stamped`` defaults to the calling body's dispatch stamp; an
        unstamped caller (direct library use) passes."""
        if not self.enabled:
            return
        if stamped is None:
            stamped = current_stamp()
        if stamped is None:
            return
        if self.cluster is not None:
            # Several live engines hold different durable epochs, so the
            # fence is claim ownership: a dispatch commits only while its
            # engine still owns the live claim under the stamped epoch,
            # and a straggler whose claim was stolen is refused.
            from learningorchestra_tpu_torch.jobs.cluster import (
                current_claim,
            )

            claim = current_claim()
            if claim is None:
                return  # direct library use on a clustered store
            if not self.cluster.verify(claim, stamped):
                from learningorchestra_tpu_torch.obs import flight

                flight.record("cluster", "fence_refused", job=claim,
                              engine=self.cluster.engine_id, epoch=stamped)
                raise StaleEpochError(
                    f"claim for job {claim!r} is no longer owned by engine "
                    f"{self.cluster.engine_id!r} under epoch {stamped} — "
                    "the claim was stolen or released by a peer; refusing "
                    "to commit"
                )
            return
        durable = self.durable_epoch()
        if durable > stamped:
            raise StaleEpochError(
                f"engine epoch {stamped} is stale: the store's current "
                f"epoch is {durable} — a newer recovery owns this store; "
                "refusing to commit"
            )

    # -- append ---------------------------------------------------------------

    def record_submit(self, job: str, *, job_class: str, method=None,
                      description=None, deadline_s=None,
                      request_id=None) -> None:
        """The ``submitted`` + ``queued`` pair, adjacent in the FIFO.

        The request parameters are not journaled: the engine stamps them
        into the artifact's metadata (``requestParameters``) first, and
        recovery re-dispatches through those."""
        if not self.enabled:
            return
        spec = {"jobClass": job_class}
        if method is not None:
            spec["method"] = method
        if description is not None:
            spec["description"] = description
        if deadline_s is not None:
            spec["deadlineS"] = deadline_s
        if request_id is not None:
            spec["requestId"] = request_id
        base = {"docType": "journal", "job": job, "epoch": self.epoch,
                "at": time.time()}
        self._pending.append({**base, "event": "submitted", "spec": spec})
        self._enqueue({**base, "event": "queued"})

    def append(self, event: str, job: str, *, attempt=None,
               reason=None) -> None:
        """One transition record, group-committed."""
        if not self.enabled:
            return
        doc = {"docType": "journal", "job": job, "event": event,
               "epoch": self.epoch, "at": time.time()}
        if attempt is not None:
            doc["attempt"] = attempt
        if reason is not None:
            doc["reason"] = reason
        self._enqueue(doc)

    # -- group-commit flusher -------------------------------------------------

    def _enqueue(self, doc: dict) -> None:
        self._pending.append(doc)
        if self._stop.is_set():
            # A late append after close(): the flusher is gone, so write
            # through inline (a closed store counts the loss in dropped).
            self._drain()
            return
        self._wake.set()
        if self._flusher is None:
            self._ensure_flusher()

    def _ensure_flusher(self) -> None:
        with self._flush_lock:
            if self._flusher is None or not self._flusher.is_alive():
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="lo-job-journal",
                    daemon=True)
                self._flusher.start()

    def _flush_loop(self) -> None:
        while True:
            self._wake.wait(0.2)
            self._wake.clear()
            self._drain()
            if self._stop.is_set() and not self._pending:
                return

    def _drain(self) -> int:
        """Write every enqueued record, in order; returns the count."""
        with self._flush_lock:
            batch = []
            while self._pending:
                batch.append(self._pending.popleft())
            if not batch:
                return 0
            # Clustered: the append runs inside the cross-process guard,
            # which folds the peers' appends in first.
            guard = (self.exclusive() if self.exclusive is not None
                     else contextlib.nullcontext())
            try:
                with guard:
                    self.documents.insert_many(JOURNAL_COLLECTION, batch)
            except Exception:  # noqa: BLE001 — the journal must not take
                # down the engine; the loss is counted and logged.
                self.dropped += len(batch)
                logger.exception(kv(event="journal_append_failed",
                                    batch=len(batch)))
            return len(batch)

    def flush(self) -> None:
        """Drain synchronously (shutdown, and readers in this process)."""
        if self.enabled:
            self._drain()

    def close(self) -> None:
        """Stop the flusher after a final drain; call before closing the
        document store."""
        self._stop.set()
        self._wake.set()
        flusher = self._flusher
        if flusher is not None and flusher.is_alive():
            flusher.join(timeout=2.0)
        self.flush()

    # -- replay ---------------------------------------------------------------

    def replay(self) -> dict:
        """Fold the journal into one record per job, in queue admission
        order (the insertion ``_id`` is the sequence number).

        Returns ``{job: {"state", "terminal", "spec", "attempts",
        "epoch", "seq"}}`` (plus ``"reason"`` after a terminal event that
        gave one); ``seq`` is the job's latest ``queued`` sequence number,
        so re-enqueueing in ``seq`` order keeps the pre-crash order."""
        if not self.enabled:
            return {}
        self.flush()
        # Clustered: fold the peers' appends in before reading.
        guard = (self.exclusive() if self.exclusive is not None
                 else contextlib.nullcontext())
        with guard:
            docs = (self.documents.find(JOURNAL_COLLECTION)
                    if self.documents.collection_exists(JOURNAL_COLLECTION)
                    else [])
        out: dict = {}
        for doc in docs:
            if doc.get("docType") != "journal" or not doc.get("job"):
                continue
            event = doc.get("event")
            rec = out.setdefault(doc["job"], {
                "state": "submitted", "terminal": False, "spec": None,
                "attempts": 0, "epoch": 0, "seq": -1,
            })
            rec["epoch"] = max(rec["epoch"], doc.get("epoch", 0))
            if event == "submitted":
                rec["spec"] = doc.get("spec") or rec["spec"]
                if rec["terminal"]:
                    # A re-submission of a completed job (PATCH re-run):
                    # a fresh life starts.
                    rec.update(terminal=False, attempts=0)
                rec["state"] = "submitted"
            elif event == "queued":
                rec.update(state="queued", terminal=False, seq=doc["_id"])
            elif event == "running":
                rec["state"] = "running"
                rec["attempts"] = max(rec["attempts"], doc.get("attempt", 1))
            elif event == "preempted":
                rec["state"] = "running"
            elif event == "cancel_requested":
                rec["state"] = "cancelling"
            elif event in TERMINAL_EVENTS:
                rec["state"] = "failed" if event == "deadline" else event
                rec["terminal"] = True
                if doc.get("reason"):
                    rec["reason"] = doc["reason"]
        return out

    # -- maintenance ----------------------------------------------------------

    def prune(self) -> int:
        """Boot-time compaction: past ``max_records``, drop all but the
        last record of each terminal job (live jobs keep their history:
        recovery needs it) and compact the WAL.  Returns the number of
        records dropped."""
        if not self.enabled or self.max_records <= 0:
            return 0
        if not self.documents.collection_exists(JOURNAL_COLLECTION):
            return 0
        if self.documents.count(JOURNAL_COLLECTION) <= self.max_records:
            return 0
        terminal = {job for job, rec in self.replay().items()
                    if rec["terminal"]}
        docs = self.documents.find(JOURNAL_COLLECTION)
        last_seen = {d["job"]: d["_id"] for d in docs
                     if d.get("job") in terminal}
        dropped = 0
        for doc in docs:
            job = doc.get("job")
            if job in terminal and doc["_id"] != last_seen[job]:
                self.documents.delete_one(JOURNAL_COLLECTION, doc["_id"])
                dropped += 1
        if dropped:
            try:
                self.documents.compact(JOURNAL_COLLECTION)
            except OSError:
                # Compaction only shrinks the WAL; the deletes landed.
                logger.exception(kv(event="journal_compact_failed"))
            logger.info(kv(event="journal_pruned", dropped=dropped))
        return dropped
