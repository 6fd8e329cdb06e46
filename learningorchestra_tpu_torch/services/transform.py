"""Transform service: column projection — port of the projection part of
``learningorchestra_tpu/services/transform.py``.

A projection copies the chosen columns of a finished dataset into a new
collection on a job thread; ``PATCH`` re-runs it, replacing the rows.
The dataType cast, text (BPE) and generic transforms are not ported yet
(ROADMAP A.3 part 2).
"""

from __future__ import annotations

from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.services.context import (
    DATA_ROWS,
    ServiceContext,
    ValidationError,
)

PROJECTION_TYPE = "transform/projection"


class TransformService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def _check_fields(self, parent: dict, fields: list[str]) -> None:
        parent_fields = parent.get("fields") or []
        missing = [f for f in fields if f not in parent_fields]
        if parent_fields and missing:
            raise ValidationError(f"fields not in parent dataset: {missing}")

    def create_projection(self, name: str, parent_name: str,
                          fields: list[str]) -> dict:
        parent = self.ctx.require_finished_parent(parent_name)
        self.ctx.require_new_name(name)
        self._check_fields(parent, fields)
        meta = self.ctx.artifacts.metadata.create(
            name, PROJECTION_TYPE, parent_name=parent_name,
            extra={"fields": fields},
        )
        self._submit_projection(name, parent_name, fields, replace=False)
        return meta

    def update_projection(self, name: str,
                          fields: list[str] | None = None) -> dict:
        """PATCH re-run: replace the projected rows, with new ``fields``
        when given, else the original request's."""
        meta = self.ctx.require_not_running(name)
        if meta.get("type") != PROJECTION_TYPE:
            raise ValidationError(f"{name!r} is not a projection")
        parent_name = meta.get("parentName")
        parent = self.ctx.require_finished_parent(parent_name)
        fields = fields or meta.get("fields") or []
        self._check_fields(parent, fields)
        self.ctx.artifacts.metadata.restart(name)
        self._submit_projection(name, parent_name, fields, replace=True)
        return self.ctx.artifacts.metadata.read(name)

    def _submit_projection(self, name: str, parent_name: str,
                           fields: list[str], *, replace: bool) -> None:
        documents = self.ctx.documents

        def project():
            if replace:
                for doc in documents.find(name, query=DATA_ROWS):
                    documents.delete_one(name, doc["_id"])
            rows = documents.find(parent_name, query=DATA_ROWS)
            n = documents.insert_many(
                name, ({f: d.get(f) for f in fields} for d in rows))
            if replace:
                # A replace wrote a delete and an insert per row: fold
                # the log back to the current state.  Maintenance, never
                # the job's outcome.
                try:
                    documents.compact(name)
                except OSError as exc:
                    get_logger("store").warning(
                        "compact(%s) failed (ignored): %r", name, exc)
            return {"rows": n, "fields": fields}

        self.ctx.engine.submit(
            name, project, description=f"projection of {parent_name}",
            parameters={"fields": fields},
            on_success=lambda r: r,
            job_class="transform",
        )
