"""Transform service: projection, dtype casting and the generic
transform — port of ``learningorchestra_tpu/services/transform.py``.

- **projection** copies the chosen columns of a finished dataset into a
  new collection on a job thread; ``PATCH`` re-runs it, replacing the
  rows;
- **dataType** casts dataset fields to number or string in place (a
  failed number cast stores ``None``), re-flagging the dataset
  unfinished while the cast runs;
- **generic** instantiates a registry class on the context's device,
  calls a method with DSL-resolved parameters and persists the result
  (tensors on the CPU); ``PATCH`` re-runs it.

The text transform (BPE tokenization) is not ported yet (ROADMAP A.3
part 2).
"""

from __future__ import annotations

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.services.context import (
    DATA_ROWS,
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.toolkit import registry

PROJECTION_TYPE = "transform/projection"


def _compact_best_effort(documents, name: str) -> None:
    """Fold a collection's log back to its current state.  Maintenance,
    never the job's outcome: a failed rewrite is logged and ignored."""
    try:
        documents.compact(name)
    except OSError as exc:
        get_logger("store").warning(
            "compact(%s) failed (ignored): %r", name, exc)


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
                # A replace wrote a delete and an insert per row.
                _compact_best_effort(documents, name)
            return {"rows": n, "fields": fields}

        self.ctx.engine.submit(
            name, project, description=f"projection of {parent_name}",
            parameters={"fields": fields},
            on_success=lambda r: r,
            job_class="transform",
        )

    # -- dtype casting --------------------------------------------------------

    def update_field_types(self, parent_name: str, fields: dict) -> dict:
        """Cast fields in place; each value is "number" or "string"."""
        meta = self.ctx.require_existing(parent_name)
        known = meta.get("fields") or []
        for field, kind in fields.items():
            if kind not in ("number", "string"):
                raise ValidationError(
                    f"field {field!r}: type must be 'number' or 'string'"
                )
            if known and field not in known:
                raise ValidationError(f"no such field: {field!r}")
        # Unfinished while the cast runs, finished again after it.
        self.ctx.artifacts.metadata.restart(parent_name)
        documents = self.ctx.documents

        def cast():
            n_updates = 0
            for doc in documents.find(parent_name, query=DATA_ROWS):
                updates = {}
                for field, kind in fields.items():
                    val = doc.get(field)
                    if val is None:
                        continue
                    if kind == "number":
                        try:
                            updates[field] = float(val)
                        except (TypeError, ValueError):
                            updates[field] = None
                    else:
                        updates[field] = str(val)
                if updates:
                    documents.update_one(parent_name, doc["_id"], updates)
                    n_updates += 1
            if n_updates:
                # The cast appended one update entry per document.
                _compact_best_effort(documents, parent_name)
            return {"cast": list(fields)}

        self.ctx.engine.submit(
            parent_name, cast, description=f"dtype cast {fields}",
            on_success=lambda r: r,
            job_class="transform",
        )
        return self.ctx.artifacts.metadata.read(parent_name)

    # -- generic transform (registry class + method) --------------------------

    def create_generic(
        self,
        name: str,
        *,
        module_path: str,
        class_name: str,
        class_parameters: dict | None = None,
        method: str | None = None,
        method_parameters: dict | None = None,
        artifact_type: str = "transform/tensorflow",
        description: str = "",
    ) -> dict:
        self.ctx.require_new_name(name)
        factory = registry.resolve(module_path, class_name)  # 406 if unknown
        bad = registry.validate_init_params(
            module_path, class_name, class_parameters or {}
        )
        if bad:
            raise ValidationError(f"invalid classParameters: {bad}")
        if method is not None:
            if not registry.validate_method(factory, method):
                raise ValidationError(f"no such method: {method!r}")
            bad = registry.validate_method_params(
                factory, method, method_parameters or {}
            )
            if bad:
                raise ValidationError(f"invalid methodParameters: {bad}")
        meta = self.ctx.artifacts.metadata.create(
            name,
            artifact_type,
            module_path=module_path,
            class_name=class_name,
            method=method,
            # Persisted so a PATCH re-run rebuilds the instance without
            # the original request body.
            extra={"classParameters": class_parameters or {}},
        )
        self._submit_generic(
            name, factory, class_parameters, method, method_parameters,
            artifact_type, description, class_name,
        )
        return meta

    def update_generic(
        self,
        name: str,
        *,
        class_parameters: dict | None = None,
        method_parameters: dict | None = None,
        description: str = "",
    ) -> dict:
        """PATCH re-run with new parameters when given, else the original
        request's (class parameters from the metadata, method parameters
        from the execution ledger)."""
        meta = self.ctx.require_not_running(name)
        module_path = meta.get("modulePath")
        class_name = meta.get("class")
        if not module_path or not class_name:
            raise ValidationError(
                f"{name!r} is not a re-runnable transform execution"
            )
        factory = registry.resolve(module_path, class_name)
        if class_parameters is None:
            class_parameters = meta.get("classParameters") or {}
        if method_parameters is None:
            method_parameters = self.ctx.last_recorded_parameters(name)
        self.ctx.artifacts.metadata.restart(name)
        self._submit_generic(
            name, factory, class_parameters, meta.get("method"),
            method_parameters, meta.get("type"), description, class_name,
        )
        return self.ctx.artifacts.metadata.read(name)

    def _submit_generic(
        self, name, factory, class_parameters, method, method_parameters,
        artifact_type, description, class_name,
    ) -> None:
        ctx = self.ctx

        def run():
            # The instance and its method's work land on the leased card.
            with ctx.leaser.lease(1, label=name) as devs, placed(devs):
                instance = factory(
                    **dsl.resolve_params(class_parameters, ctx.loader),
                    device=ctx.device)
                result = instance
                if method is not None:
                    result = getattr(instance, method)(
                        **dsl.resolve_params(method_parameters, ctx.loader))
                # A neural instance persists as its artifact.
                ctx.volumes.save_estimator(artifact_type, name, result)

        ctx.engine.submit(
            name, run, description=description or f"{class_name}.{method}",
            method=method, parameters=method_parameters,
            job_class="transform",
        )
