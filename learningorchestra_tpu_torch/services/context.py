"""Shared service context — port of the core of
``learningorchestra_tpu/services/context.py``: the store, volumes, job
engine, device leases and the DSL's artifact loader, plus the request
exceptions the API maps to the reference's status codes (409 duplicate,
404 missing, 406 semantic errors).

The context owns the ``device``: every estimator the services build or
load goes there.  Job recovery over the journal, the compile-cache
pre-warm and the cluster plane are not ported.
"""

from __future__ import annotations

import re
from typing import Any

from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.jobs.engine import JobEngine
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.services.frame import Frame
from learningorchestra_tpu_torch.store import (
    ArtifactStore,
    VolumeStorage,
    open_document_store,
)

logger = get_logger("context")

# The document store's own name shape: first char word-like, no
# separators, so '..' and '/x' never match.
_ARTIFACT_NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*")

#: Data rows of a collection: not the metadata, not execution records.
DATA_ROWS = {"_id": {"$gte": 1}, "docType": {"$ne": "execution"}}


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
        )
        # Device placement: jobs on the card serialize per card; the
        # watchdog revokes an expired job's leases through the same pool.
        self.leaser = DeviceLeaser(device=self.device)
        self.engine.leaser = self.leaser
        self.loader = StoreLoader(self)
        # Subscribers to artifact changes (the serving registry drops a
        # resident model whose binary was replaced or deleted).
        self._artifact_change_listeners: list = []

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
        # With a drain budget the close waits, bounded; without one it
        # never hangs on an unbounded drain.
        self.engine.shutdown(wait=self.config.jobs.shutdown_drain_s > 0)
        self.documents.close()

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

    def delete_artifact(self, name: str) -> dict:
        """Collection + volume binary; subscribers drop derived state
        now, so a recreated name never serves deleted weights."""
        meta = self.require_existing(name)
        self.artifacts.delete(name)
        self.volumes.delete(meta.get("type", ""), name)
        self.notify_artifact_changed(name)
        return meta


class StoreLoader:
    """The DSL's ``$name``: a dataset collection loads as a
    :class:`Frame`; anything else loads its volume binary (an estimator
    artifact rebuilt on the context's device)."""

    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def load(self, name: str) -> Any:
        meta = self.ctx.artifacts.metadata.read(name)
        if meta is None:
            raise KeyError(name)
        kind = str(meta.get("type", ""))
        if kind.startswith("dataset/csv") or not self.ctx.volumes.exists(
            kind, name
        ):
            return self.load_frame(name)
        return self.ctx.volumes.load_estimator(kind, name,
                                               device=self.ctx.device)

    def load_frame(self, name: str) -> Frame:
        docs = self.ctx.documents.find(name, query=DATA_ROWS)
        if not docs:
            raise KeyError(f"artifact {name!r} has no rows")
        return Frame([{k: v for k, v in d.items() if k != "_id"}
                      for d in docs])
