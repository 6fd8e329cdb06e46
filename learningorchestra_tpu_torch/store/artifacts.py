"""Artifact metadata, lineage and the execution ledger — port of
``learningorchestra_tpu/store/artifacts.py``.

Every pipeline artifact is a named collection whose document ``_id=0`` is
its metadata ``{name, type, finished, jobState, timeCreated, parentName?,
modulePath?, class?, method?, ...}``: ``finished`` is the completion flag
clients poll, ``jobState`` (pending/running/finished/failed) tells a
running job from a dead one, and ``parentName`` links give lineage and the
walk to the model behind any step.  Execution records (``docType:
"execution"``) share the collection at ``_id >= 1``.  The fields and the
timestamp format are the JAX package's.
"""

from __future__ import annotations

import datetime
from typing import Any

from learningorchestra_tpu_torch.store.document_store import (
    DocumentStore,
    DuplicateKey,
)

METADATA_ID = 0


class LineageError(Exception):
    pass


class DuplicateArtifact(Exception):
    """An artifact with this name already exists (API: 409)."""


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ"
    )


class Metadata:
    """Create/read/update the ``_id=0`` metadata document of an artifact."""

    def __init__(self, store: DocumentStore):
        self.store = store

    def create(
        self,
        name: str,
        artifact_type: str,
        *,
        parent_name: str | None = None,
        module_path: str | None = None,
        class_name: str | None = None,
        method: str | None = None,
        extra: dict | None = None,
        overwrite: bool = False,
    ) -> dict:
        doc = {
            "name": name,
            "type": artifact_type,
            "finished": False,
            "jobState": "pending",
            "timeCreated": _now(),
        }
        optional = {"parentName": parent_name, "modulePath": module_path,
                    "class": class_name, "method": method}
        doc.update({k: v for k, v in optional.items() if v is not None})
        if extra:
            doc.update(extra)
        if overwrite:
            self.store.insert_one(name, doc, _id=METADATA_ID)
        else:
            # Atomic check-and-insert: of two concurrent creates with one
            # name, the loser gets DuplicateArtifact.
            try:
                self.store.insert_unique(name, doc, _id=METADATA_ID)
            except DuplicateKey as exc:
                raise DuplicateArtifact(name) from exc
        return doc

    def read(self, name: str) -> dict | None:
        return self.store.find_one(name, METADATA_ID)

    def exists(self, name: str) -> bool:
        return self.read(name) is not None

    def update(self, name: str, fields: dict) -> bool:
        return self.store.update_one(name, METADATA_ID, fields)

    def mark_running(self, name: str) -> None:
        self.update(name, {"jobState": "running", "finished": False})

    def mark_finished(self, name: str, extra: dict | None = None) -> None:
        self.update(name, {"jobState": "finished", "finished": True,
                           **(extra or {})})

    def mark_failed(self, name: str, exception: str) -> None:
        self.update(
            name,
            {"jobState": "failed", "finished": False, "exception": exception},
        )

    def restart(self, name: str) -> None:
        """PATCH re-run: back to unfinished/pending."""
        self.update(
            name,
            {"jobState": "pending", "finished": False, "exception": None},
        )

    # -- lineage --------------------------------------------------------------

    def parent_chain(self, name: str) -> list[dict]:
        """Metadata docs from ``name`` up the ``parentName`` links to the
        root; a cycle or a missing link raises LineageError."""
        chain: list[dict] = []
        seen: set[str] = set()
        cur: str | None = name
        while cur is not None:
            if cur in seen:
                raise LineageError(f"lineage cycle at {cur!r}")
            seen.add(cur)
            doc = self.read(cur)
            if doc is None:
                raise LineageError(f"missing artifact in lineage: {cur!r}")
            chain.append(doc)
            cur = doc.get("parentName")
        return chain

    def find_model_ancestor(self, name: str) -> dict:
        """The first ``model/*`` artifact up the chain: the model spec
        behind a train, evaluate or predict step."""
        for doc in self.parent_chain(name):
            if str(doc.get("type", "")).startswith("model"):
                return doc
        raise LineageError(f"no model ancestor for {name!r}")


class ExecutionLedger:
    """Append-only per-artifact execution records at ``_id >= 1``: what
    ran and how it ended (parameters, exception, captured stdout)."""

    def __init__(self, store: DocumentStore):
        self.store = store

    def record(
        self,
        name: str,
        *,
        description: str | None = None,
        method: str | None = None,
        parameters: Any = None,
        state: str = "finished",
        exception: str | None = None,
        stdout: str | None = None,
        metrics: dict | None = None,
    ) -> int:
        doc: dict = {
            "executionTime": _now(),
            "state": state,
            # Tagged so data reads (frames, projections) skip it.
            "docType": "execution",
        }
        optional = {"description": description, "method": method,
                    "parameters": parameters, "exception": exception,
                    "functionMessage": stdout}
        doc.update({k: v for k, v in optional.items() if v is not None})
        if metrics:
            doc["metrics"] = metrics
        return self.store.insert_one(name, doc)

    def history(self, name: str) -> list[dict]:
        return self.store.find(name, query={"docType": "execution"})


class ArtifactStore:
    """The document store, metadata and ledger together; services take
    this rather than the raw store."""

    def __init__(self, store: DocumentStore):
        self.documents = store
        self.metadata = Metadata(store)
        self.ledger = ExecutionLedger(store)

    def read_page(
        self,
        name: str,
        query: dict | None = None,
        skip: int = 0,
        limit: int = 20,
    ) -> list[dict]:
        """The universal GET/poll read: metadata (``_id=0``) first."""
        return self.documents.find(
            name, query=query, sort_key="_id", skip=skip, limit=limit
        )

    def list_by_type(self, artifact_type_prefix: str = "") -> list[dict]:
        """Metadata of every artifact whose type starts with a prefix."""
        out = []
        for coll in self.documents.list_collections():
            meta = self.metadata.read(coll)
            if meta and str(meta.get("type", "")).startswith(
                artifact_type_prefix
            ):
                out.append(meta)
        return out

    def delete(self, name: str) -> bool:
        return self.documents.drop(name)
