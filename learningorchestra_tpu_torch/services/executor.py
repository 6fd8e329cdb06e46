"""Executor service: train / evaluate / predict — port of
``learningorchestra_tpu/services/executor.py`` (grid-search tuning comes
with ROADMAP A.3 part 2).

A job loads its parent's binary on the context's device, calls
``getattr(instance, method)(**treated_params)`` and persists the outcome:
a train-family job (or any method returning the instance) publishes the
mutated estimator as an artifact (int8 when the fit asked for
``quantize_checkpoint``) and its history as one row per epoch; other
methods' results are stored as result rows and a pickled binary.  The
lineage walk finds the model spec behind any chain of steps.  Each job
holds a device lease for its device work, so jobs on one card
serialize, and what it prints is recorded in its execution document.

Managed checkpoints are not ported (ROADMAP A.5): a request carrying
``checkpoint_dir`` is refused (406) as the JAX package refuses it.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.toolkit import registry


def store_history_rows(documents, name: str, history: dict) -> int:
    """Persist a TrainHistory-shaped dict ({metric: [per-epoch...]}) as
    one pollable row per epoch (``docType: "history"``)."""
    keys = list(history)
    n = max((len(history[k]) for k in keys), default=0)
    for i in range(n):
        documents.insert_one(name, {
            "docType": "history",
            "epoch": i,
            **{k: history[k][i] for k in keys if len(history[k]) > i},
        })
    return n


class ExecutorService:
    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    @staticmethod
    def _reject_raw_checkpoint_dir(method_parameters) -> None:
        """Checkpoint placement is the service's to manage; a raw path
        from the network would be written verbatim."""
        if method_parameters and "checkpoint_dir" in method_parameters:
            raise ValidationError(
                "checkpoint_dir is managed by the service; use "
                "checkpoint_every/resume to control checkpointing"
            )

    def _validate_request(self, name, parent_name, method, method_parameters):
        self.ctx.require_new_name(name)
        self._reject_raw_checkpoint_dir(method_parameters)
        parent_meta = self.ctx.require_finished_parent(parent_name)
        model_meta = self.ctx.artifacts.metadata.find_model_ancestor(
            parent_name
        )
        factory = registry.resolve(
            model_meta.get("modulePath"), model_meta.get("class")
        )
        if not registry.validate_method(factory, method):
            raise ValidationError(f"no such method: {method!r}")
        bad = registry.validate_method_params(
            factory, method, method_parameters or {}
        )
        if bad:
            raise ValidationError(f"invalid methodParameters: {bad}")
        return parent_meta, model_meta

    def create(
        self,
        name: str,
        *,
        parent_name: str,
        method: str,
        method_parameters: dict | None = None,
        artifact_type: str = "train/tensorflow",
        description: str = "",
        deadline_s: float | None = None,
    ) -> dict:
        parent_meta, model_meta = self._validate_request(
            name, parent_name, method, method_parameters
        )
        meta = self.ctx.artifacts.metadata.create(
            name,
            artifact_type,
            parent_name=parent_name,
            module_path=model_meta.get("modulePath"),
            class_name=model_meta.get("class"),
            method=method,
        )
        self._submit(name, parent_meta, method, method_parameters,
                     artifact_type, description, deadline_s=deadline_s)
        return meta

    def update(
        self,
        name: str,
        *,
        method_parameters: dict | None = None,
        description: str = "",
        deadline_s: float | None = None,
    ) -> dict:
        """PATCH re-run with new parameters; a bare PATCH re-uses the
        last recorded ones."""
        meta = self.ctx.require_existing(name)
        self._reject_raw_checkpoint_dir(method_parameters)
        parent = meta.get("parentName")
        if not parent:
            raise ValidationError(
                f"artifact {name!r} has no parent — not an executor result"
            )
        parent_meta = self.ctx.require_finished_parent(parent)
        if not method_parameters:
            method_parameters = self.ctx.last_recorded_parameters(name)
        self.ctx.artifacts.metadata.restart(name)
        self._submit(name, parent_meta, meta.get("method"),
                     method_parameters, meta.get("type"), description,
                     deadline_s=deadline_s)
        return self.ctx.artifacts.metadata.read(name)

    def _submit(self, name, parent_meta, method, method_parameters,
                artifact_type, description, *, deadline_s=None):
        parent_name = parent_meta["name"]
        parent_type = parent_meta.get("type", "")
        kind = artifact_type.split("/", 1)[0]
        ctx = self.ctx

        def run():
            # The lease covers all of the job's device work: the parent's
            # load (dequantize), the method and the publication (quantize).
            with ctx.leaser.lease(1, label=name) as devs, placed(devs):
                if devs:
                    ctx.artifacts.metadata.update(
                        name, {"leasedDevices": devs})
                instance = ctx.volumes.load_estimator(
                    parent_type, parent_name, device=ctx.device)
                params = dsl.resolve_params(method_parameters, ctx.loader)
                t0 = time.perf_counter()
                result = getattr(instance, method)(**params)
                fit_time = time.perf_counter() - t0
                if kind == "train" or result is instance:
                    ctx.volumes.save_estimator(artifact_type, name, instance)
                    # A PATCH re-train replaced this binary: a model
                    # resident in serving reloads before its next predict.
                    ctx.notify_artifact_changed(name)
                    hist = getattr(instance, "history", None)
                    if hist:
                        # Re-runs re-store the whole history.
                        for doc in ctx.documents.find(
                            name, query={"docType": "history"}
                        ):
                            ctx.documents.delete_one(name, doc["_id"])
                        store_history_rows(ctx.documents, name, hist)
                    return {"fitTime": fit_time}
                ctx.volumes.save_object(artifact_type, name, result)
            self._store_result_rows(name, result)
            return {"fitTime": fit_time}

        ctx.engine.submit(
            name,
            run,
            description=description or f"{method} on {parent_name}",
            method=method,
            parameters=_json_safe(method_parameters),
            capture_stdout=True,
            on_success=lambda extra: extra,
            job_class="executor",
            deadline_s=deadline_s,
        )

    def _store_result_rows(self, name: str, result: Any) -> None:
        """Method results as pollable rows."""
        if isinstance(result, dict):
            self.ctx.documents.insert_one(name, _json_safe(result))
            return
        arr = np.asarray(result)
        if arr.ndim == 0:
            self.ctx.documents.insert_one(name, {"result": arr.item()})
        elif arr.ndim == 1:
            self.ctx.documents.insert_many(
                name, ({"result": _json_safe(v)} for v in arr.tolist()))
        else:
            self.ctx.documents.insert_many(
                name, ({"result": row} for row in arr.tolist()))

    def delete(self, name: str) -> None:
        self.ctx.delete_artifact(name)


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)
