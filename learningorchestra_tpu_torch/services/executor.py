"""Executor service: train / evaluate / predict and grid-search tune —
port of ``learningorchestra_tpu/services/executor.py``.

A job loads its parent's binary on the context's device, calls
``getattr(instance, method)(**treated_params)`` and persists the outcome:
a train-family job (or any method returning the instance) publishes the
mutated estimator as an artifact (int8 when the fit asked for
``quantize_checkpoint``) and its history as one row per epoch; other
methods' results are stored as result rows and a pickled binary.  The
lineage walk finds the model spec behind any chain of steps.  Each job
holds a device lease for its device work, so jobs on one card
serialize, and what it prints is recorded in its execution document.

A tune job (:meth:`ExecutorService.create_tune`) fits one candidate
per combination of a parameter grid on a thread pool, each neural
candidate under a device lease of its own (on one card the trials
serialize there), scores it, stores a result row per trial as it
finishes and publishes the best candidate.

Managed checkpoints: a neural ``fit`` gets the artifact's checkpoint
directory (``ServiceContext.checkpoint_dir``), wiped on a fresh run and
resumed when a failed job is PATCHed back (how boot recovery resumes a
killed fit); a neural tune trial gets ``trial_<idx>`` under the tune's
directory, removed once the best candidate is published.  A request
carrying a raw ``checkpoint_dir`` is refused (406).  Each publication is
fenced against the store's engine epoch (``require_current_epoch``).
The tune's compile-cache and device-time accounting (``compileCache``,
``deviceTime``) come with A.6.
"""

from __future__ import annotations

import contextlib
import itertools
import shutil
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any

import numpy as np

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs import cancel as jobs_cancel
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.base import map_tensors
from learningorchestra_tpu_torch.train.neural import NeuralEstimator


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
        last recorded ones.  A re-run of a FAILED train job resumes from
        its newest managed checkpoint; a re-run of a finished one is a
        fresh fit (its stale checkpoints are wiped)."""
        meta = self.ctx.require_existing(name)
        self._reject_raw_checkpoint_dir(method_parameters)
        parent = meta.get("parentName")
        if not parent:
            raise ValidationError(
                f"artifact {name!r} has no parent — not an executor result"
            )
        parent_meta = self.ctx.require_finished_parent(parent)
        resume = meta.get("jobState") == "failed"
        if not method_parameters:
            method_parameters = self.ctx.last_recorded_parameters(name)
        self.ctx.artifacts.metadata.restart(name)
        self._submit(name, parent_meta, meta.get("method"),
                     method_parameters, meta.get("type"), description,
                     resume_checkpoint=resume, deadline_s=deadline_s)
        return self.ctx.artifacts.metadata.read(name)

    def _submit(self, name, parent_meta, method, method_parameters,
                artifact_type, description, *, resume_checkpoint=False,
                deadline_s=None):
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
                if (kind in ("train", "tune") and method == "fit"
                        and getattr(instance, "supports_managed_checkpoints",
                                    False)):
                    # A fresh run must not resurrect old state: its tree
                    # is wiped; a failed job PATCHed back resumes.
                    ckdir = ctx.checkpoint_dir(name)
                    if not resume_checkpoint:
                        shutil.rmtree(ckdir, ignore_errors=True)
                    params["checkpoint_dir"] = str(ckdir)
                    params.setdefault("resume", resume_checkpoint)
                t0 = time.perf_counter()
                result = getattr(instance, method)(**params)
                fit_time = time.perf_counter() - t0
                # A stale-epoch straggler must not overwrite the artifact
                # a newer recovery owns.
                ctx.require_current_epoch()
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
        result = map_tensors(result, lambda t: t.detach().cpu().numpy())
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

    # -- tune: managed grid search -------------------------------------------

    def create_tune(
        self,
        name: str,
        *,
        parent_name: str,
        method: str = "fit",
        param_grid: dict | None = None,
        method_parameters: dict | None = None,
        scoring_parameters: dict | None = None,
        artifact_type: str = "tune/tensorflow",
        description: str = "",
        deadline_s: float | None = None,
    ) -> dict:
        """Grid search over ``param_grid`` (dict of lists).  Each
        candidate instantiates the model ancestor's class with one
        combination on the context's device, runs ``method`` with
        ``method_parameters``, scores with ``score`` on
        ``scoring_parameters`` (default: the fit's ``x``/``y``); the best
        candidate is persisted as this artifact's binary."""
        if not param_grid:
            raise ValidationError("param_grid is required for tune")
        for key, values in param_grid.items():
            if not isinstance(values, (list, tuple)) or not values:
                raise ValidationError(
                    f"param_grid[{key!r}] must be a non-empty list"
                )
        self.ctx.require_new_name(name)
        self._reject_raw_checkpoint_dir(method_parameters)
        self.ctx.require_finished_parent(parent_name)
        model_meta = self.ctx.artifacts.metadata.find_model_ancestor(
            parent_name
        )
        module_path, class_name = (model_meta.get("modulePath"),
                                   model_meta.get("class"))
        factory = registry.resolve(module_path, class_name)
        bad = registry.validate_init_params(
            module_path, class_name, {k: None for k in param_grid})
        if bad:
            raise ValidationError(f"param_grid keys not in __init__: {bad}")
        meta = self.ctx.artifacts.metadata.create(
            name,
            artifact_type,
            parent_name=parent_name,
            module_path=module_path,
            class_name=class_name,
            method=method,
        )
        ctx = self.ctx
        neural = isinstance(factory, type) and issubclass(
            factory, NeuralEstimator)

        def run():
            # The engine does not retry a tune (no preemption in the
            # port), so every run is a fresh grid: old trial state goes.
            trial_ck_root = ctx.checkpoint_dir(name)
            shutil.rmtree(trial_ck_root, ignore_errors=True)
            fit_params = dsl.resolve_params(method_parameters, ctx.loader)
            score_params = dsl.resolve_params(
                scoring_parameters, ctx.loader
            ) if scoring_parameters else {
                k: v for k, v in fit_params.items() if k in ("x", "y")
            }
            keys = sorted(param_grid)
            combos = [dict(zip(keys, combo)) for combo in itertools.product(
                *(param_grid[k] for k in keys))]
            # Trials run on pool threads, which do not inherit the job's
            # context: each binds the job's cancel token itself.
            token = jobs_cancel.current_cancel_token()

            def eval_candidate(idx: int, kwargs: dict):
                if token is not None and token.cancelled():
                    raise RuntimeError(
                        f"tune cancelled: {token.reason or 'requested'}")
                trial_params = fit_params
                if neural and method == "fit":
                    # Managed per-trial checkpoints: combos are built in a
                    # fixed order, so idx names the same trial every run.
                    trial_params = {
                        "checkpoint_dir": str(trial_ck_root
                                              / f"trial_{idx:04d}"),
                        "resume": False, **fit_params}
                # A neural trial leases a card for its device work and
                # runs there; on one card the trials serialize.
                lease = ctx.leaser.lease(1, label=f"{name}:trial") \
                    if neural else contextlib.nullcontext([])
                with jobs_cancel.bind(token), lease as devs, placed(devs):
                    candidate = factory(**kwargs, device=ctx.device)
                    t0 = time.perf_counter()
                    getattr(candidate, method)(**trial_params)
                    fit_time = time.perf_counter() - t0
                    score = float(candidate.score(**score_params))
                return candidate, score, fit_time

            # Trials stream: each result row lands as its trial finishes,
            # and only the best candidate so far stays referenced.
            best_score, best_instance, best_combo = -np.inf, None, None
            workers = min(len(combos),
                          max(4, ctx.leaser.device_count if neural else 0))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = {pool.submit(eval_candidate, i, kw): kw
                           for i, kw in enumerate(combos)}
                try:
                    for fut in as_completed(list(futures)):
                        # pop: a consumed non-best candidate is collectable
                        # now, not when the pool exits.
                        kwargs = futures.pop(fut)
                        candidate, score, fit_time = fut.result()
                        ctx.documents.insert_one(name, {
                            "params": _json_safe(kwargs),
                            "score": score,
                            "fitTime": fit_time,
                        })
                        if score > best_score:
                            best_score, best_instance, best_combo = (
                                score, candidate, kwargs)
                except BaseException:
                    # The first failure ends the search: the queued
                    # trials never start.
                    for pending in futures:
                        pending.cancel()
                    raise
            ctx.require_current_epoch()
            lease = ctx.leaser.lease(1, label=name) if neural \
                else contextlib.nullcontext([])
            with lease as devs, placed(devs):
                ctx.volumes.save_estimator(artifact_type, name,
                                           best_instance)
            ctx.notify_artifact_changed(name)
            # Trial checkpoints are this run's scratch: a later grid of
            # the same name must not find them.
            shutil.rmtree(trial_ck_root, ignore_errors=True)
            return {"bestScore": best_score,
                    "bestParams": _json_safe(best_combo)}

        ctx.engine.submit(
            name, run,
            description=description or f"grid search {parent_name}",
            method=method, parameters=_json_safe(param_grid),
            on_success=lambda extra: extra,
            job_class="executor",
            deadline_s=deadline_s,
        )
        return meta

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
