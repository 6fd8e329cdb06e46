"""Scale-out control plane: multi-engine dispatch over the shared store —
port of ``learningorchestra_tpu/jobs/cluster.py``.

The reference scales its orchestration tier by replicating one-container
-per-service workers behind the gateway (PAPER.md §L2-L4); here the
whole control plane was ONE process — the queue, lease table and fleet
state all lived in ``JobEngine``'s memory, so a second API process could
neither share work nor survive the first's death.  This module moves
dispatch ownership into the replicated document store so N engine
processes over one store root accept, schedule and execute concurrently
and safely:

- **Claim table.**  ``_job_claims`` is an ordinary store collection
  (it rides the WAL, so it ships to the standby with everything else).
  Before executing a queued job, an engine must CLAIM it: insert a
  claim document carrying the engine id and its durable epoch, or CAS
  an expired one over via :meth:`DocumentStore.compare_and_update`.
  Two engines can race a claim; exactly one wins.
- **Leases + work stealing.**  Claims are heartbeat-renewed; a claim
  whose heartbeat is older than ``ttl_s`` belongs to a dead (or
  partitioned) engine and the sweep loop steals it in claim-id order —
  the pre-crash queue admission order — handing each stolen job to the
  context's checkpoint-resume redispatch path.
- **Epoch fencing.**  Every claim records the claimant's engine epoch.
  The epoch fence (jobs/journal.py) delegates here during a cluster
  dispatch: a terminal commit is allowed only while the committing
  engine still OWNS the claim under its stamped epoch, so a stale
  engine revived after its claim was stolen is refused at publication
  — no double-run becomes no lost-update.
- **Per-tenant fair-share admission.**  :class:`TenantAdmission`
  enforces queued/running quotas per ``X-Tenant`` with counters kept in
  the same store collection, so every engine rejects identically (429
  + Retry-After); the engine's dispatch loop adds a nested tenant
  round-robin inside each job-class pool so one tenant's flood cannot
  starve another's jobs.

Cross-process coherence: the store's in-memory maps are per-process, so
every claim-table access runs under an exclusive ``fcntl`` file lock on
``<store_root>/_cluster.lock`` and re-reads the collection from its WAL
first (:meth:`DocumentStore.refresh`).  That is also why clustering
requires the **python** store backend — the native backend has no
refresh primitive (services/context.py disables clustering loudly when
it is missing).  Claim/heartbeat wall-time comparisons assume the
engines' clocks agree to within ``ttl_s`` (same-host processes or
NTP-disciplined hosts).

Fault points: ``cluster.claim`` (claim CAS), ``cluster.heartbeat``
(renew) and ``cluster.steal`` (expired-claim takeover); the partition
drill is tests/test_torch_cluster.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from pathlib import Path

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.concurrency_rt import make_lock, make_rlock
from learningorchestra_tpu_torch.log import get_logger, kv

logger = get_logger("cluster")

__all__ = [
    "CLAIM_COLLECTION",
    "ClusterCoordinator",
    "FIT_CLASSES",
    "QuotaExceeded",
    "TenantAdmission",
    "bind_claim",
    "bind_tenant",
    "current_claim",
    "current_tenant",
]

#: The claim table.  Underscore prefix keeps it out of the artifact
#: namespace (boot recovery skips it); riding the store means it ships
#: to the standby through the ordinary ``*.wal`` glob.
CLAIM_COLLECTION = "_job_claims"

#: Cross-process mutual exclusion for the claim table (file next to
#: the WALs so every engine over one store root sees the same lock).
LOCK_FILE = "_cluster.lock"

#: Job classes that count against the per-tenant RUNNING quota — the
#: accelerator-holding fits; cheap metadata jobs only count as queued.
FIT_CLASSES = frozenset({"executor", "distributed"})

#: Released claims are kept this many TTLs as supersede markers (a
#: dead engine's stale queue entry must still see that its job already
#: finished elsewhere), then swept.
_RELEASED_KEEP_TTLS = 10.0

#: Claim-table mutations between compactions — bounds WAL growth from
#: the heartbeat loop.  Safe under the cluster file lock: every
#: cross-process accessor refreshes before reading or writing.
_COMPACT_EVERY = 256


# -- contextvars: the dispatching claim + the requesting tenant -------------

_claim_var: contextvars.ContextVar = contextvars.ContextVar(
    "lo_cluster_claim", default=None
)
_tenant_var: contextvars.ContextVar = contextvars.ContextVar(
    "lo_tenant", default=None
)


def current_claim() -> str | None:
    """Job name of the claim held by the current engine dispatch, or
    None outside one — the journal fence keys its delegation on this."""
    return _claim_var.get()


def current_tenant() -> str | None:
    """Tenant bound to the current request/job, or None."""
    return _tenant_var.get()


@contextlib.contextmanager
def bind_claim(job: str):
    token = _claim_var.set(job)
    try:
        yield
    finally:
        _claim_var.reset(token)


@contextlib.contextmanager
def bind_tenant(tenant: str | None):
    token = _tenant_var.set(tenant or None)
    try:
        yield
    finally:
        _tenant_var.reset(token)


# -- metrics ---------------------------------------------------------------


#: (registry, counter) pair — re-resolved only when reset_registry()
#: swapped the registry (tests); a dispatch-path dict-get otherwise.
_claims_cache: tuple = (None, None)


def _claims_counter():
    """Registry counter, cached per registry identity: claim() rides
    every clustered dispatch, so the per-use name lookup matters."""
    global _claims_cache
    from learningorchestra_tpu_torch.obs.metrics import get_registry

    reg = get_registry()
    cached_reg, counter = _claims_cache
    if cached_reg is not reg:
        counter = reg.counter(
            "lo_cluster_claims_total",
            "Claim-table operations by outcome.",
            labels=("outcome",),
        )
        _claims_cache = (reg, counter)
    return counter


def _rejections_counter():
    from learningorchestra_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        "lo_admission_rejections_total",
        "Per-tenant admission rejections by reason.",
        labels=("tenant", "reason"),
    )


def _flight(event: str, **fields) -> None:
    from learningorchestra_tpu_torch.obs import flight as obs_flight

    obs_flight.record("cluster", event, **fields)


class ClusterCoordinator:
    """One engine's membership in the store-backed dispatch plane.

    Lifecycle: construct → (context wires ``epoch`` + callbacks) →
    :meth:`join` → claims flow through :meth:`claim`/:meth:`release`
    around every dispatch → :meth:`close`.  All claim-table access is
    serialized by a re-entrant in-process lock plus the cross-process
    file lock, with a WAL refresh folding peer appends on entry.
    """

    def __init__(self, documents, store_root, *, engine_id: str,
                 heartbeat_s: float = 1.0, ttl_s: float = 5.0,
                 sweep_s: float = 2.0):
        import os

        self.documents = documents
        self.root = Path(store_root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.engine_id = engine_id or f"engine-{os.getpid()}"
        self.heartbeat_s = float(heartbeat_s)
        self.ttl_s = float(ttl_s)
        self.sweep_s = float(sweep_s)
        #: The durable engine epoch (journal-minted); the context sets
        #: this after the journal boots, before join().
        self.epoch = 0
        #: ``on_steal(job, prev_engine)`` — fired (outside the lock)
        #: for each claim stolen by the sweep.
        self.on_steal = None
        #: ``on_engine_dead(engine_id, epoch)`` — fired when an engine
        #: document expires, so queued-but-unclaimed work of the dead
        #: engine can be re-dispatched.
        self.on_engine_dead = None
        #: job → claim-doc ``_id`` fast path: _ids are stable for a
        #: doc's lifetime and never reused, so a hit turns the claim
        #: lookup into one find_one instead of a collection scan (a
        #: miss — peer GC'd the doc — falls back to the scan).
        self._claim_ids: dict[str, int] = {}
        self._lock = make_rlock("ClusterCoordinator._lock")
        self._depth = 0
        self._refreshed: set = set()
        self._lock_fh = None
        self._mutations = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._closed = False

    # -- the guard ---------------------------------------------------------

    @contextlib.contextmanager
    def _guard(self, refresh: tuple = (CLAIM_COLLECTION,)):
        """Exclusive claim-table session: in-process re-entrant lock +
        cross-process flock, refreshing each named collection from its
        WAL once per flock hold (peer appends fold in before any read
        or write; our own mutations then land at the true tail)."""
        import fcntl

        with self._lock:
            if self._depth == 0:
                if self._lock_fh is None:
                    self._lock_fh = open(self.root / LOCK_FILE, "a+")
                fcntl.flock(self._lock_fh, fcntl.LOCK_EX)
                self._refreshed = set()
            for name in refresh:
                if name not in self._refreshed:
                    self.documents.refresh(name)
                    self._refreshed.add(name)
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                if self._depth == 0 and self._lock_fh is not None:
                    fcntl.flock(self._lock_fh, fcntl.LOCK_UN)

    def journal_guard(self):
        """The same exclusive session, refreshing the JOURNAL instead:
        installed as ``journal.exclusive`` so cross-process journal
        appends/replays cannot allocate conflicting ``_id``s."""
        from learningorchestra_tpu_torch.jobs.journal import JOURNAL_COLLECTION

        return self._guard(refresh=(JOURNAL_COLLECTION,))

    @staticmethod
    def _now() -> float:
        return time.time()

    def _docs_locked(self) -> list:
        """All claim-table documents; [] before the first write ever
        creates the collection."""
        if not self.documents.collection_exists(CLAIM_COLLECTION):
            return []
        return self.documents.find(CLAIM_COLLECTION)

    def _find_locked(self, kind: str, key: str, value: str):
        for doc in self._docs_locked():
            if doc.get("kind") == kind and doc.get(key) == value:
                return doc
        return None

    def _find_claim_locked(self, job: str):
        _id = self._claim_ids.get(job)
        if _id is not None:
            doc = self.documents.find_one(CLAIM_COLLECTION, _id)
            if (
                doc is not None
                and doc.get("kind") == "claim"
                and doc.get("job") == job
            ):
                return doc
            self._claim_ids.pop(job, None)
        doc = self._find_locked("claim", "job", job)
        if doc is not None:
            self._claim_ids[job] = doc["_id"]
        return doc

    def _note_mutation_locked(self) -> None:
        self._mutations += 1
        if self._mutations >= _COMPACT_EVERY:
            self._mutations = 0
            try:
                self.documents.compact(CLAIM_COLLECTION)
            except Exception:  # noqa: BLE001 — compaction is an
                pass           # optimization, never a claim failure

    # -- claims ------------------------------------------------------------

    def claim(self, job: str, enqueued_at: float | None = None) -> bool:
        """Claim ``job`` for this engine; True means we own it and may
        execute.  ``enqueued_at`` (submit wall-time) guards the
        released-slot supersede rule: a queue entry older than the
        claim's completion was already finished by a peer that adopted
        it — executing it again would be the double-run.
        """
        # Chaos probe: an injected error models a claim-table wobble
        # mid-CAS — the engine treats any claim failure as "lost"
        # (the peer owns it), never as a crash.
        faults.hit("cluster.claim")
        now = self._now()
        with self._guard():
            doc = self._find_claim_locked(job)
            if doc is None:
                self._claim_ids[job] = self.documents.insert_one(
                    CLAIM_COLLECTION, {
                        "kind": "claim", "job": job,
                        "engine": self.engine_id, "epoch": self.epoch,
                        "hbAt": now, "state": "live", "doneAt": None,
                    }
                )
                self._note_mutation_locked()
                outcome = "acquired"
            elif doc.get("state") == "released":
                if (
                    enqueued_at is not None
                    and (doc.get("doneAt") or 0) > enqueued_at
                ):
                    # Finished by a peer AFTER this entry was queued:
                    # the work this entry describes already ran to a
                    # terminal publication elsewhere.
                    outcome = "superseded"
                else:
                    ok = self.documents.compare_and_update(
                        CLAIM_COLLECTION, doc["_id"],
                        {"engine": doc.get("engine"),
                         "state": "released"},
                        {"engine": self.engine_id, "epoch": self.epoch,
                         "hbAt": now, "state": "live", "doneAt": None},
                    )
                    self._note_mutation_locked()
                    outcome = "acquired" if ok else "lost"
            elif doc.get("engine") == self.engine_id:
                # Re-dispatch of a job we already own (preemption
                # retry, recovered boot): renew and proceed.  Skip the
                # WAL append when the lease is already fresh — the
                # heartbeat daemon owns renewals, so the steady-state
                # dispatch path pays no write here.
                if (
                    doc.get("epoch") != self.epoch
                    or now - (doc.get("hbAt") or 0) > self.heartbeat_s
                ):
                    self.documents.update_one(
                        CLAIM_COLLECTION, doc["_id"],
                        {"epoch": self.epoch, "hbAt": now},
                    )
                    self._note_mutation_locked()
                outcome = "acquired"
            elif now - (doc.get("hbAt") or 0) > self.ttl_s:
                # Expired peer claim: dispatch-time takeover by CAS —
                # two engines racing here both saw the same stale
                # owner, only one lands.
                ok = self.documents.compare_and_update(
                    CLAIM_COLLECTION, doc["_id"],
                    {"engine": doc.get("engine"),
                     "hbAt": doc.get("hbAt")},
                    {"engine": self.engine_id, "epoch": self.epoch,
                     "hbAt": now, "state": "live", "doneAt": None},
                )
                self._note_mutation_locked()
                outcome = "acquired" if ok else "lost"
            else:
                outcome = "lost"
        acquired = outcome == "acquired"
        _claims_counter().inc(
            outcome="acquired" if acquired else "lost"
        )
        _flight(
            "claim", job=job, outcome=outcome,
            engine=self.engine_id, epoch=self.epoch,
        )
        if not acquired:
            logger.info(kv(
                event="claim_" + outcome, job=job,
                engine=self.engine_id,
            ))
        return acquired

    def release(self, job: str) -> None:
        """Mark our claim released (with completion time) — kept as a
        supersede marker instead of deleted, so a straggler engine's
        stale queue entry for the same submission refuses to re-run."""
        with self._guard():
            doc = self._find_claim_locked(job)
            if doc is None or doc.get("engine") != self.engine_id:
                return
            self.documents.update_one(CLAIM_COLLECTION, doc["_id"], {
                "state": "released", "doneAt": self._now(),
            })
            self._note_mutation_locked()
        _claims_counter().inc(outcome="released")
        _flight(
            "release", job=job, engine=self.engine_id,
            epoch=self.epoch,
        )

    def verify(self, job: str, epoch: int | None = None) -> bool:
        """Fence delegate: does this engine still OWN the live claim
        for ``job`` (under ``epoch``, when stamped)?  False after a
        steal — the stolen-from engine's terminal commit must be
        refused even though its process never died."""
        with self._guard():
            doc = self._find_claim_locked(job)
            return (
                doc is not None
                and doc.get("state") == "live"
                and doc.get("engine") == self.engine_id
                and (epoch is None or doc.get("epoch") == epoch)
            )

    def claimable(self, job: str) -> bool:
        """Boot-recovery gate: may this engine adopt ``job``?  False
        while a LIVE peer holds its claim (the job is not orphaned —
        it is running over there)."""
        with self._guard():
            doc = self._find_claim_locked(job)
            if doc is None or doc.get("engine") == self.engine_id:
                return True
            if doc.get("state") == "released":
                return True
            return self._now() - (doc.get("hbAt") or 0) > self.ttl_s

    # -- heartbeat + sweep -------------------------------------------------

    def heartbeat(self) -> int:
        """Renew this engine's membership document and every live
        claim it holds; returns the renewed-claim count."""
        faults.hit("cluster.heartbeat")
        now = self._now()
        renewed = 0
        with self._guard():
            mine = self._find_locked("engine", "engine", self.engine_id)
            if mine is None:
                self.documents.insert_one(CLAIM_COLLECTION, {
                    "kind": "engine", "engine": self.engine_id,
                    "epoch": self.epoch, "hbAt": now,
                })
            else:
                self.documents.update_one(
                    CLAIM_COLLECTION, mine["_id"],
                    {"epoch": self.epoch, "hbAt": now},
                )
            for doc in self._docs_locked():
                if (
                    doc.get("kind") == "claim"
                    and doc.get("engine") == self.engine_id
                    and doc.get("state") == "live"
                ):
                    self.documents.update_one(
                        CLAIM_COLLECTION, doc["_id"], {"hbAt": now}
                    )
                    renewed += 1
            self._note_mutation_locked()
        _claims_counter().inc(outcome="renewed")
        _flight(
            "renew", engine=self.engine_id, epoch=self.epoch,
            claims=renewed,
        )
        return renewed

    def sweep(self) -> list[tuple]:
        """Steal expired peer claims (claim-id order = pre-crash queue
        admission order) and expire dead engine documents; fires the
        ``on_steal``/``on_engine_dead`` callbacks outside the lock.
        Returns the stolen ``(job, prev_engine)`` pairs."""
        now = self._now()
        stolen: list[tuple] = []
        dead: list[tuple] = []
        with self._guard():
            docs = self._docs_locked()
            for doc in docs:
                if (
                    doc.get("kind") == "engine"
                    and doc.get("engine") != self.engine_id
                    and now - (doc.get("hbAt") or 0) > self.ttl_s
                ):
                    dead.append(
                        (doc.get("engine"), doc.get("epoch") or 0)
                    )
                    self.documents.delete_one(
                        CLAIM_COLLECTION, doc["_id"]
                    )
                    self._note_mutation_locked()
            for doc in sorted(docs, key=lambda d: d["_id"]):
                if doc.get("kind") != "claim":
                    continue
                if (
                    doc.get("state") == "released"
                    and now - (doc.get("doneAt") or now)
                    > _RELEASED_KEEP_TTLS * self.ttl_s
                ):
                    self.documents.delete_one(
                        CLAIM_COLLECTION, doc["_id"]
                    )
                    self._note_mutation_locked()
                    continue
                if (
                    doc.get("state") == "live"
                    and doc.get("engine") != self.engine_id
                    and now - (doc.get("hbAt") or 0) > self.ttl_s
                ):
                    # Chaos probe: an injected error here models the
                    # sweeper crashing mid-steal — the claim stays
                    # with the (dead) owner and the NEXT sweep
                    # finishes the takeover.
                    faults.hit("cluster.steal")
                    ok = self.documents.compare_and_update(
                        CLAIM_COLLECTION, doc["_id"],
                        {"engine": doc.get("engine"),
                         "hbAt": doc.get("hbAt")},
                        {"engine": self.engine_id,
                         "epoch": self.epoch, "hbAt": now},
                    )
                    self._note_mutation_locked()
                    if ok:
                        stolen.append(
                            (doc.get("job"), doc.get("engine"))
                        )
        for job, prev in stolen:
            _claims_counter().inc(outcome="stolen")
            _flight(
                "steal", job=job, prev=prev,
                engine=self.engine_id, epoch=self.epoch,
            )
            logger.warning(kv(
                event="claim_stolen", job=job, prev=prev,
                engine=self.engine_id,
            ))
            if self.on_steal is not None:
                try:
                    self.on_steal(job, prev)
                except Exception:  # noqa: BLE001 — one bad redispatch
                    logger.exception(   # must not kill the sweeper
                        "steal callback failed for job %r", job
                    )
        # Bounded walk over this sweep's dead-engine list; "epoch" is
        # the fencing epoch, not a training loop.
        # lo-check: disable=loop-no-cancel-check
        for dead_engine, dead_epoch in dead:
            _flight(
                "engine_dead", dead=dead_engine, deadEpoch=dead_epoch,
                engine=self.engine_id,
            )
            logger.warning(kv(
                event="engine_dead", dead=dead_engine,
                deadEpoch=dead_epoch,
            ))
            if self.on_engine_dead is not None:
                try:
                    self.on_engine_dead(dead_engine, dead_epoch)
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "engine-dead callback failed for %r", dead_engine
                    )
        return stolen

    # -- membership --------------------------------------------------------

    def join(self) -> None:
        """Publish this engine's membership and start the heartbeat +
        sweep daemons."""
        self.heartbeat()
        if self.heartbeat_s > 0:
            t = threading.Thread(
                target=self._loop,
                args=(self.heartbeat_s, self.heartbeat),
                name=f"cluster-heartbeat-{self.engine_id}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        if self.sweep_s > 0:
            t = threading.Thread(
                target=self._loop, args=(self.sweep_s, self.sweep),
                name=f"cluster-sweep-{self.engine_id}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        logger.info(kv(
            event="cluster_join", engine=self.engine_id,
            epoch=self.epoch, heartbeat_s=self.heartbeat_s,
            ttl_s=self.ttl_s,
        ))

    def _loop(self, interval: float, fn) -> None:
        while not self._stop.wait(interval):
            try:
                fn()
            except Exception:  # noqa: BLE001 — a failed tick (chaos,
                # transient IO) must not kill the loop; the next tick
                # retries against fresh state.
                logger.exception("cluster loop tick failed")

    def status(self) -> dict:
        """The /cluster/status body: engines + claims as the store
        sees them right now."""
        now = self._now()
        with self._guard():
            docs = self._docs_locked()
        engines = []
        claims = []
        for doc in docs:
            if doc.get("kind") == "engine":
                engines.append({
                    "engine": doc.get("engine"),
                    "epoch": doc.get("epoch"),
                    "ageS": round(now - (doc.get("hbAt") or now), 3),
                    "live": now - (doc.get("hbAt") or 0) <= self.ttl_s,
                })
            elif doc.get("kind") == "claim":
                claims.append({
                    "job": doc.get("job"),
                    "engine": doc.get("engine"),
                    "epoch": doc.get("epoch"),
                    "state": doc.get("state"),
                    "ageS": round(now - (doc.get("hbAt") or now), 3),
                })
        return {
            "engine": self.engine_id,
            "epoch": self.epoch,
            "ttlS": self.ttl_s,
            "heartbeatS": self.heartbeat_s,
            "engines": engines,
            "claims": claims,
        }

    def close(self) -> None:
        """Leave the cluster: stop the loops and retract this engine's
        membership document (peers need not wait out the TTL)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        try:
            with self._guard():
                mine = self._find_locked(
                    "engine", "engine", self.engine_id
                )
                if mine is not None:
                    self.documents.delete_one(
                        CLAIM_COLLECTION, mine["_id"]
                    )
        except Exception:  # noqa: BLE001 — closing must not raise
            pass
        with self._lock:
            if self._lock_fh is not None:
                self._lock_fh.close()
                self._lock_fh = None


# -- per-tenant fair-share admission ----------------------------------------


class QuotaExceeded(Exception):
    """Tenant over quota → HTTP 429 + Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class TenantAdmission:
    """Per-tenant queued/running quotas, enforced identically on every
    engine.

    Under clustering the counters live as ``tenant`` documents in the
    claim collection (read/written under the coordinator's guard), so
    engine B sees the jobs tenant X queued through engine A.  Without a
    cluster they are a local dict under a lock.  The API tier calls
    :meth:`check` on job-creating routes BEFORE any metadata exists
    (a quota rejection must not leave an orphan artifact); the engine
    maintains the counters at submit/dispatch/terminal.  The check and
    the increment are not one atomic step — a burst racing the window
    can overshoot a quota by the in-flight request count, which load
    shedding tolerates by design.
    """

    def __init__(self, max_queued: int = 0, max_running: int = 0,
                 retry_after_s: float = 1.0, cluster=None):
        self.max_queued = int(max_queued)
        self.max_running = int(max_running)
        self.retry_after_s = float(retry_after_s)
        self.cluster = cluster
        self._lock = make_lock("TenantAdmission._lock")
        self._local: dict[str, dict] = {}

    def _counts(self, tenant: str) -> tuple[int, int]:
        if self.cluster is not None:
            with self.cluster._guard():
                doc = self.cluster._find_locked(
                    "tenant", "tenant", tenant
                )
            if doc is None:
                return 0, 0
            return int(doc.get("queued") or 0), int(
                doc.get("running") or 0
            )
        with self._lock:
            rec = self._local.get(tenant)
            if rec is None:
                return 0, 0
            return rec["queued"], rec["running"]

    def _bump(self, tenant: str, field: str, delta: int) -> None:
        if self.cluster is not None:
            docs = self.cluster.documents
            with self.cluster._guard():
                doc = self.cluster._find_locked(
                    "tenant", "tenant", tenant
                )
                if doc is None:
                    doc = {"kind": "tenant", "tenant": tenant,
                           "queued": 0, "running": 0}
                    doc["_id"] = docs.insert_one(
                        CLAIM_COLLECTION, doc
                    )
                value = max(0, int(doc.get(field) or 0) + delta)
                docs.update_one(
                    CLAIM_COLLECTION, doc["_id"], {field: value}
                )
                self.cluster._note_mutation_locked()
            return
        with self._lock:
            rec = self._local.setdefault(
                tenant, {"queued": 0, "running": 0}
            )
            rec[field] = max(0, rec[field] + delta)

    def check(self, tenant: str | None) -> None:
        """Admission gate: raise :class:`QuotaExceeded` when ``tenant``
        is over its queued or running quota."""
        t = tenant or ""
        queued, running = self._counts(t)
        reason = None
        if self.max_queued > 0 and queued >= self.max_queued:
            reason, n, cap = "queued_quota", queued, self.max_queued
        elif self.max_running > 0 and running >= self.max_running:
            reason, n, cap = "running_quota", running, self.max_running
        if reason is None:
            return
        _rejections_counter().inc(tenant=t or "-", reason=reason)
        _flight(
            "quota_reject", tenant=t or "-", reason=reason,
            n=n, cap=cap,
        )
        raise QuotaExceeded(
            f"tenant {t or '<default>'!r} over its {reason.split('_')[0]}"
            f" quota ({n}/{cap}); retry after backoff",
            retry_after_s=self.retry_after_s,
        )

    def note_queued(self, tenant: str | None) -> None:
        self._bump(tenant or "", "queued", +1)

    def note_dequeued(self, tenant: str | None) -> None:
        """A queued entry left the queue WITHOUT dispatching (cancel,
        shutdown drop) — the queued count must not leak."""
        self._bump(tenant or "", "queued", -1)

    def note_dispatch(self, tenant: str | None, job_class: str) -> None:
        self._bump(tenant or "", "queued", -1)
        if job_class in FIT_CLASSES:
            self._bump(tenant or "", "running", +1)

    def note_done(self, tenant: str | None, job_class: str) -> None:
        if job_class in FIT_CLASSES:
            self._bump(tenant or "", "running", -1)

    def snapshot(self) -> dict:
        """Per-tenant counter view (the /cluster/status body)."""
        out: dict[str, dict] = {}
        if self.cluster is not None:
            with self.cluster._guard():
                docs = self.cluster._docs_locked()
            for doc in docs:
                if doc.get("kind") == "tenant":
                    out[doc.get("tenant") or ""] = {
                        "queued": int(doc.get("queued") or 0),
                        "running": int(doc.get("running") or 0),
                    }
            return out
        with self._lock:
            return {t: dict(rec) for t, rec in self._local.items()}
