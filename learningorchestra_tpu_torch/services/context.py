"""Shared service context — port of the core of
``learningorchestra_tpu/services/context.py``: the store, volumes, job
engine, device leases, the job journal, the webhooks and the DSL's
artifact loader, plus the request exceptions the API maps to the
reference's status codes (409 duplicate, 404 missing, 406 semantic
errors).

The context owns the ``device``: every estimator the services build or
load goes there.  Each construction is a boot: it mints an engine epoch
(jobs/journal.py), prunes the journal and recovers every job a dead
process left pending or running (:meth:`ServiceContext._recover_jobs`).
When the process-wide program cache (train/compile_cache.py) clears on a
device-set change, the engine's warm-start hints go with it (a listener
held through a weak reference, deregistered by :meth:`close`).  With the
durable program store on (``AotConfig.enabled`` and ``prewarm``), each
boot starts the pre-warm (:meth:`ServiceContext._start_aot_prewarm`): a
daemon thread that installs the store's hot set into the program cache
while the API already serves.  The cluster plane's claim stealing is not
ported (ROADMAP A.11).
"""

from __future__ import annotations

import re
import shutil
import threading
import time
import weakref
from typing import Any

from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.jobs.engine import JobEngine
from learningorchestra_tpu_torch.jobs.journal import JobJournal
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.obs import tracing
from learningorchestra_tpu_torch.services.frame import Frame
from learningorchestra_tpu_torch.services.webhooks import WebhookNotifier
from learningorchestra_tpu_torch.store import (
    ArtifactStore,
    VolumeStorage,
    open_document_store,
)
from learningorchestra_tpu_torch.store.sharded import ShardedDataset
from learningorchestra_tpu_torch.train import aot_store, compile_cache

logger = get_logger("context")

# The document store's own name shape: first char word-like, no
# separators, so '..' and '/x' never match.
_ARTIFACT_NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*")

#: Data rows of a collection: not the metadata, not execution records.
DATA_ROWS = {"_id": {"$gte": 1}, "docType": {"$ne": "execution"}}


#: How long ``close`` waits for a running boot pre-warm.
_PREWARM_JOIN_S = 30.0


class ValidationError(Exception):
    """Semantic request error -> HTTP 406."""


class NotFoundError(Exception):
    """Missing artifact -> HTTP 404."""


class ConflictError(Exception):
    """Duplicate artifact name or a job still running -> HTTP 409."""


class ServiceContext:
    def __init__(self, config: Config | None = None, *, device=None):
        self.config = config or Config.from_env()
        self.device = resolve_device(device or self.config.device)
        self.documents = open_document_store(
            self.config.store.store_path(),
            durable_writes=self.config.store.durable_writes,
            backend=self.config.store.backend,
        )
        self.artifacts = ArtifactStore(self.documents)
        self.volumes = VolumeStorage(self.config.store.volume_path())
        jobs = self.config.jobs
        self.engine = JobEngine(
            self.artifacts,
            max_workers=jobs.max_workers,
            class_weights=jobs.class_weights,
            deadline_s=jobs.deadline_s,
            shutdown_drain_s=jobs.shutdown_drain_s,
            max_preemption_retries=jobs.max_preemption_retries,
            retry_backoff_s=jobs.retry_backoff_s,
            retry_backoff_max_s=jobs.retry_backoff_max_s,
        )
        # Device placement: jobs on the card serialize per card; the
        # watchdog revokes an expired job's leases through the same pool.
        self.leaser = DeviceLeaser(device=self.device)
        self.engine.leaser = self.leaser
        # A device-set change clears the program cache, so the engine's
        # warm-start hints are stale then.  Weakly bound: short-lived
        # contexts (tests) must not pin dead engines through the
        # process-wide cache.
        engine_ref = weakref.ref(self.engine)

        def _drop_warm_hints():
            engine = engine_ref()
            if engine is not None:
                engine.clear_warm_keys()

        self._warm_hint_listener = _drop_warm_hints
        compile_cache.get_cache().add_invalidation_listener(
            _drop_warm_hints)
        self.loader = StoreLoader(self)
        # Subscribers to artifact changes (the serving registry drops a
        # resident model whose binary was replaced or deleted).
        self._artifact_change_listeners: list = []
        # Observe push: terminal transitions fire registered webhooks
        # and every transition lands in the event feed.
        self.webhooks = WebhookNotifier(self.documents)
        self.engine.notifier = self.webhooks
        # Constructing the journal mints this boot's engine epoch, so a
        # straggler of any previous life is refused at its commit.
        self.journal = JobJournal(
            self.documents, self.config.store.store_path(),
            enabled=jobs.journal, max_records=jobs.journal_max_records)
        self.engine.journal = self.journal if self.journal.enabled else None
        self.journal.prune()
        self._recover_jobs()
        # The boot pre-warm of the durable program store's hot set: in the
        # background, so readiness never waits for it.
        self._aot_prewarm_thread: threading.Thread | None = None
        self.aot_prewarm_stats: dict | None = None
        self._start_aot_prewarm()

    def add_artifact_change_listener(self, listener) -> None:
        """Register ``listener(name)``, fired when an artifact's binary
        or metadata is replaced or deleted."""
        self._artifact_change_listeners.append(listener)

    def notify_artifact_changed(self, name: str) -> None:
        for listener in self._artifact_change_listeners:
            try:
                listener(name)
            except Exception:  # noqa: BLE001 — a broken subscriber must
                # not fail the delete or publication that notified it.
                logger.exception(kv(event="artifact_listener_failed",
                                    artifact=name))

    def close(self) -> None:
        compile_cache.get_cache().remove_invalidation_listener(
            self._warm_hint_listener)
        thread = self._aot_prewarm_thread
        if thread is not None:
            thread.join(timeout=_PREWARM_JOIN_S)
        # With a drain budget the close waits, bounded; without one it
        # never hangs on an unbounded drain.
        self.engine.shutdown(wait=self.config.jobs.shutdown_drain_s > 0)
        self.journal.close()  # its final drain needs the open store
        self.documents.close()

    # -- boot pre-warm --------------------------------------------------------

    def _start_aot_prewarm(self) -> None:
        """Start the boot pre-warm when the durable program store is on
        (``AotConfig.enabled`` and ``prewarm``; a context whose config
        enables the store serves it from that config) and has a manifest
        to walk.  Background by design: the API comes up at once, and a
        program not yet restored simply builds live."""
        try:
            if self.config.aot.enabled:
                aot_store.configure(self.config.aot)
            if not (aot_store.enabled() and self.config.aot.prewarm
                    and compile_cache.enabled()):
                return
            store = aot_store.get_store()
            work = store.manifest_entries() if store is not None else []
        except Exception:  # noqa: BLE001 — warm start is best effort
            return
        if not work:
            return
        self._aot_prewarm_thread = threading.Thread(
            target=self._aot_prewarm, args=(store, work),
            name="aot-prewarm", daemon=True)
        self._aot_prewarm_thread.start()

    def _aot_prewarm(self, store, work: list[dict]) -> None:
        """Walk the manifest hottest first, restoring each blob and
        installing the program into the program cache; a key already
        resident is skipped, and a bad blob costs its key (a live build
        later), never the boot.  Every restore is a ``prewarm`` span on a
        dedicated ``boot.prewarm`` trace."""
        cache = compile_cache.get_cache()
        warmed = skipped = failed = 0
        t0 = time.perf_counter()
        trace = tracing.new_trace("boot.prewarm")
        with tracing.activate(trace):
            for rec in work:
                key = rec.get("key")
                if not key or cache.contains(key):
                    skipped += 1
                    continue
                label = rec.get("label")
                try:
                    with tracing.span("prewarm", key=key[:12],
                                      label=label or ""):
                        stored = store.load(key)
                        if stored is None:
                            failed += 1
                            continue
                        ok = cache.install(
                            key, compile_cache.restore(key, stored,
                                                       label=label),
                            label=label)
                    warmed += 1 if ok else 0
                except Exception:  # noqa: BLE001 — a bad blob costs one
                    failed += 1  # key, not the boot
        self.aot_prewarm_stats = {
            "warmed": warmed, "skipped": skipped, "failed": failed,
            "total": len(work),
            "seconds": round(time.perf_counter() - t0, 6)}
        logger.info(kv(event="aot_prewarm_done", **self.aot_prewarm_stats))

    # -- boot-time recovery ---------------------------------------------------

    def _recover_jobs(self) -> None:
        """Resolve every job a dead process left pending or running.

        Left alone, such a job wedges its artifact: it never finishes,
        and ``require_not_running`` answers 409 to every PATCH re-run.
        With the journal on and ``jobs.journal_recover``, journaled jobs
        whose bodies can be re-derived from metadata (executor jobs) are
        re-submitted through the PATCH path in their pre-crash queue
        order, and a train fit resumes from its newest managed
        checkpoint.  Every other journaled job, and every one when
        recovery is off, fails ``orphaned-by-restart``; a job with no
        journal record (a store older than the journal, or the journal
        off) gets the legacy interrupted message."""
        # A dead server's distributed fits left their staging directories
        # (staged inputs) behind: remove every one no live fit owns, before
        # a recovered fit stages anew.
        from learningorchestra_tpu_torch.parallel.distributed import (
            sweep_stages,
        )

        for stage in sweep_stages(self.stage_root()):
            logger.warning(f"removed the staging directory {stage!r} of a "
                           "distributed fit no live process owns")
        journaled = self.journal.replay() if self.journal.enabled else {}
        recover = self.journal.enabled and self.config.jobs.journal_recover
        interrupted: list[tuple] = []
        for name in self.documents.list_collections():
            if name.startswith("_"):
                continue  # internal ledgers and the journal hold no jobs
            meta = self.artifacts.metadata.read(name)
            if not meta or meta.get("jobState") not in ("pending",
                                                         "running"):
                continue
            rec = journaled.get(name)
            # Pre-crash queue admission order (the latest ``queued``
            # sequence number); journal-less jobs last, by name.
            seq = rec["seq"] if rec and rec["seq"] >= 0 else float("inf")
            interrupted.append((seq, name, meta, rec))
        interrupted.sort(key=lambda t: (t[0], t[1]))
        for _seq, name, meta, rec in interrupted:
            # A journal-terminal record under live metadata: the job's
            # life ended (a refused submission, or a crash between the
            # append and the metadata commit); orphan, never resurrect.
            kind = (self._recoverable_kind(meta)
                    if recover and rec is not None
                    and not rec.get("terminal") else None)
            if kind is None:
                self._orphan_job(name, journaled=rec is not None)
                continue
            try:
                self._redispatch(name, kind, rec.get("spec") or {})
                logger.warning(
                    f"recovered job {name!r} from the journal (epoch "
                    f"{self.journal.epoch}): re-dispatched through the "
                    "checkpoint-resume path")
            except Exception as exc:  # noqa: BLE001 — one unrecoverable
                # job (a deleted parent, a bad spec) must not stop the boot.
                logger.error(
                    f"could not re-dispatch recovered job {name!r}: "
                    f"{exc!r} — failing it orphaned-by-restart")
                self._orphan_job(name, journaled=True, detail=repr(exc))

    @staticmethod
    def _recoverable_kind(meta: dict) -> str | None:
        """How a journaled job can be re-dispatched, or None: distributed
        trains re-run through the distributed PATCH, executor artifacts
        (train, evaluate, predict with a parent and a method) through the
        executor's, both with their last recorded parameters; tune grids,
        models, ingests, text transforms, explores, functions and
        distributed builders are orphaned, as the JAX package orphans
        them."""
        if meta.get("distributed"):
            return "distributed"
        kind = str(meta.get("type", ""))
        if (kind.startswith(("train/", "evaluate/", "predict/"))
                and meta.get("parentName") and meta.get("method")):
            return "executor"
        return None

    def _redispatch(self, name: str, kind: str, spec: dict) -> None:
        """Re-submit a recovered job through PATCH, under its journaled
        deadline.  Marking it failed first is what routes a train fit
        into the checkpoint-resume path (``update`` resumes a failed
        job from its newest managed checkpoint)."""
        from learningorchestra_tpu_torch.services.distributed_exec import (
            DistributedExecutorService,
        )
        from learningorchestra_tpu_torch.services.executor import (
            ExecutorService,
        )

        self.artifacts.metadata.mark_failed(
            name, "orphaned-by-restart: re-dispatching from the job journal")
        if kind == "distributed":
            DistributedExecutorService(self).update_train(
                name, description=spec.get("description") or "")
            return
        ExecutorService(self).update(
            name, description=spec.get("description") or "",
            deadline_s=spec.get("deadlineS"))

    def _orphan_job(self, name: str, *, journaled: bool,
                    detail: str | None = None) -> None:
        """Fail an interrupted job that cannot (or must not) be
        re-dispatched, and tell its subscribers."""
        if journaled:
            reason = (
                "orphaned-by-restart: the orchestrator died while "
                "this job was queued or running and its body is not "
                "automatically re-dispatchable"
                + (f" ({detail})" if detail else "")
                + "; re-run it with a PATCH (bare PATCH re-uses the "
                "last recorded parameters)"
            )
        else:
            reason = (
                "job interrupted by a server restart or store "
                "failover before completing; re-run it with a "
                "PATCH (bare PATCH re-uses the last recorded "
                "parameters)"
            )
        self.artifacts.metadata.mark_failed(name, reason)
        if journaled:
            self.journal.append("failed", name,
                                reason="orphaned-by-restart")
        logger.warning(f"re-flagged interrupted job {name!r} (was mid-run "
                       "when the previous process died)")
        # A watcher of the dead job sees its terminal transition, as
        # from the engine's own failure path.
        self.webhooks.notify(name, "failed",
                             self.artifacts.metadata.read(name) or {})

    def require_current_epoch(self) -> None:
        """The epoch fence at artifact publication: a job body from a
        stale engine epoch raises ``StaleEpochError`` here instead of
        publishing.  A no-op outside an engine dispatch."""
        self.journal.fence_check()

    # -- validation helpers shared by services --------------------------------

    def require_new_name(self, name: str) -> None:
        if not name or not isinstance(name, str):
            raise ValidationError("missing or invalid 'name'")
        # Names become collection files and volume paths: reject
        # path-shaped ones here (406).
        if not _ARTIFACT_NAME_RE.fullmatch(name) or ".." in name:
            raise ValidationError(f"invalid artifact name: {name!r}")
        # Reserved by the JAX package (tokenizer binaries, observe
        # sub-routes), so a name valid here is valid there.
        if name.endswith(".tokenizer"):
            raise ValidationError(
                f"artifact name {name!r} uses the reserved "
                "'.tokenizer' suffix"
            )
        if name in ("events", "webhook"):
            raise ValidationError(
                f"artifact name {name!r} is reserved (observe route)"
            )
        if self.artifacts.metadata.exists(name):
            raise ConflictError(f"duplicate artifact name: {name!r}")

    def require_existing(self, name: str) -> dict:
        meta = self.artifacts.metadata.read(name)
        if meta is None:
            raise NotFoundError(f"no such artifact: {name!r}")
        return meta

    def require_not_running(self, name: str) -> dict:
        """PATCH re-run gate: two jobs of one artifact must not run at
        once (409 while the previous one is pending or running)."""
        meta = self.require_existing(name)
        if meta.get("jobState") in ("pending", "running"):
            raise ConflictError(
                f"artifact {name!r} has a job in state "
                f"{meta.get('jobState')!r}; wait for it to finish"
            )
        return meta

    def require_finished_parent(self, name: str) -> dict:
        """Downstream steps refuse unfinished parents."""
        meta = self.require_existing(name)
        if not meta.get("finished"):
            raise ValidationError(
                f"parent artifact {name!r} is not finished "
                f"(jobState={meta.get('jobState')})"
            )
        return meta

    def last_recorded_parameters(self, name: str):
        """The newest request parameters recorded for ``name``: what a
        bare PATCH re-run submits.  Ledger rows win (what actually ran);
        the submit-time metadata copy covers a first run that died
        before writing one."""
        rows = [
            d for d in self.documents.find(
                name, query={"docType": "execution"})
            if d.get("parameters") is not None
        ]
        if rows:
            return rows[-1]["parameters"]
        return (self.artifacts.metadata.read(name) or {}).get(
            "requestParameters")

    def stage_root(self):
        """Where this context's distributed fits stage their inputs."""
        return self.config.dist.stage_path(self.volumes.root)

    def checkpoint_dir(self, name: str):
        """An artifact's managed train-checkpoint tree: the one place its
        path is built (the executor and delete share it)."""
        return self.volumes.root / "_checkpoints" / name

    def delete_artifact(self, name: str) -> dict:
        """Collection, volume binary (a sharded dataset's shard
        directory), a text transform's tokenizer and managed checkpoints;
        subscribers drop derived state now, so a recreated name never
        serves deleted weights, resumes a deleted job's state or hands a
        deleted vocabulary to ``tokenizerFrom``."""
        meta = self.require_existing(name)
        kind = meta.get("type", "")
        self.artifacts.delete(name)
        self.volumes.delete(kind, name)
        self.notify_artifact_changed(name)
        if kind == "transform/text":
            self.volumes.delete(kind, name + ".tokenizer")
        shutil.rmtree(self.checkpoint_dir(name), ignore_errors=True)
        return meta


class StoreLoader:
    """The DSL's ``$name``: a sharded dataset resolves to a lazy
    :class:`ShardedDataset` (``$name.col`` to one column's view); a
    dataset collection loads as a :class:`Frame`; a function's response
    or an explore's binary loads as the object it is; anything else
    loads its volume binary (an estimator artifact rebuilt on the
    context's device)."""

    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def load(self, name: str) -> Any:
        meta = self.ctx.artifacts.metadata.read(name)
        if meta is None:
            raise KeyError(name)
        kind = str(meta.get("type", ""))
        if meta.get("sharded"):
            # Materialising the rows here would be the O(dataset) host
            # step the sharded format exists to avoid.
            return ShardedDataset(self.ctx.volumes.path_for(kind, name))
        if kind.startswith("dataset/csv") or not self.ctx.volumes.exists(
            kind, name
        ):
            return self.load_frame(name)
        if kind.startswith(("function/", "explore/")):
            return self.ctx.volumes.read_object(kind, name)
        return self.ctx.volumes.load_estimator(kind, name,
                                               device=self.ctx.device)

    def load_frame(self, name: str) -> Frame:
        docs = self.ctx.documents.find(name, query=DATA_ROWS)
        if not docs:
            raise KeyError(f"artifact {name!r} has no rows")
        return Frame([{k: v for k, v in d.items() if k != "_id"}
                      for d in docs])
