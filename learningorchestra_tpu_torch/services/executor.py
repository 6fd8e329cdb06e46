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
killed fit) or when the engine re-runs a preempted attempt
(``jobs.engine.current_attempt() > 0``); a neural tune trial gets
``trial_<idx>`` under the tune's directory, resumed by a preemption
retry and removed once the best candidate is published.  A request
carrying a raw ``checkpoint_dir`` is refused (406).  Each publication is
fenced against the store's engine epoch (``require_current_epoch``).

Programs and costs: a train or tune job publishes ``compileCache``, its
delta of the program cache's counters (train/compile_cache.py), and, when
any epoch was attributed to it, ``deviceTime`` (device seconds, FLOPs,
MFU when the card's peak is configured; obs/costs.py): the body (and
each tune trial, on its pool thread) runs in ``costs.job_scope``.  Each
submission carries its spec's ``warm_fingerprint`` as the engine's warm
key, and a finished neural job reports it warm.
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
from learningorchestra_tpu_torch.jobs import engine as engine_mod
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.obs import costs, tracing
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.store.artifacts import LineageError
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.base import map_tensors
from learningorchestra_tpu_torch.train import compile_cache
from learningorchestra_tpu_torch.train.neural import NeuralEstimator


def _model_class(ctx: ServiceContext, name: str):
    """The registry class of the model behind artifact ``name`` (None when
    its lineage names none)."""
    try:
        meta = ctx.artifacts.metadata.find_model_ancestor(name)
        return registry.resolve(meta.get("modulePath"), meta.get("class"))
    except (LineageError, registry.RegistryError):
        return None


@contextlib.contextmanager
def lease_and_place(ctx: ServiceContext, label: str, model_class):
    """A model job's lease, placed: one card, or every card for a class
    that spans a mesh (``spans_mesh``: a pipelined transformer), as a
    distributed fit takes them.  Yields the leased devices and, for a
    mesh model, the devices its mesh is laid over: the leased cards, or
    ``dist.cpu_ranks`` CPU ranks on a context on the CPU (else None)."""
    # Imported here: distributed_exec imports this module.
    from learningorchestra_tpu_torch.services.distributed_exec import (
        rank_devices,
    )

    spans = bool(getattr(model_class, "spans_mesh", False))
    with ctx.leaser.lease(0 if spans else 1, label=label) as devs, \
            placed(devs):
        yield devs, (rank_devices(ctx.device, devs,
                                  ctx.config.dist.cpu_ranks)
                     if spans else None)


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
                     artifact_type, description,
                     warm_key=_warm_key(model_meta, method,
                                        method_parameters),
                     deadline_s=deadline_s)
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
                     resume_checkpoint=resume,
                     warm_key=_warm_key(meta, meta.get("method"),
                                        method_parameters),
                     deadline_s=deadline_s)
        return self.ctx.artifacts.metadata.read(name)

    def _submit(self, name, parent_meta, method, method_parameters,
                artifact_type, description, *, resume_checkpoint=False,
                warm_key=None, deadline_s=None):
        parent_name = parent_meta["name"]
        parent_type = parent_meta.get("type", "")
        kind = artifact_type.split("/", 1)[0]
        ctx = self.ctx

        def run():
            cache_before = compile_cache.counters_snapshot()
            # The lease covers all of the job's device work: the parent's
            # load (dequantize), the method and the publication (quantize).
            with lease_and_place(ctx, name, _model_class(
                    ctx, parent_name)) as (devs, mesh):
                if devs:
                    ctx.artifacts.metadata.update(
                        name, {"leasedDevices": devs})
                with tracing.span("load_artifact", parent=parent_name):
                    instance = ctx.volumes.load_estimator(
                        parent_type, parent_name, device=ctx.device)
                if mesh is not None:  # its rank processes stage here
                    instance.bind_devices(mesh)
                    instance.stage_root = ctx.stage_root()
                params = dsl.resolve_params(method_parameters, ctx.loader)
                # A preemption retry (attempt > 0) resumes the checkpoints
                # this run already wrote instead of restarting at epoch 0.
                attempt = engine_mod.current_attempt()
                resume = resume_checkpoint or attempt > 0
                if (kind in ("train", "tune") and method == "fit"
                        and getattr(instance, "supports_managed_checkpoints",
                                    False)):
                    # A fresh run must not resurrect old state: its tree
                    # is wiped (on attempt 0 only: a retry's checkpoints
                    # are its own run's); a failed job PATCHed back
                    # resumes.
                    ckdir = ctx.checkpoint_dir(name)
                    if not resume:
                        shutil.rmtree(ckdir, ignore_errors=True)
                    params["checkpoint_dir"] = str(ckdir)
                    params.setdefault("resume", resume)
                    if attempt > 0:
                        # The same logical run, continued, even when the
                        # request asked for a fresh fit.
                        params["resume"] = True
                t0 = time.perf_counter()
                # The body's dispatches (the fit's epochs) book against
                # this job's device-time entry.
                with costs.job_scope(name):
                    result = getattr(instance, method)(**params)
                fit_time = time.perf_counter() - t0
                if isinstance(instance, NeuralEstimator) and \
                        compile_cache.enabled():
                    # Its programs are cached now: queued jobs of the same
                    # spec may start ahead of cold ones.
                    ctx.engine.note_warm(warm_key)
                cache_delta = compile_cache.delta_since(cache_before)
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
                    extra = {"fitTime": fit_time,
                             "compileCache": cache_delta}
                    device_time = costs.job_summary(name)
                    if device_time is not None:
                        extra["deviceTime"] = device_time
                    return extra
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
            warm_key=warm_key,
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
        warm_key = _warm_key(model_meta, method, param_grid)

        def run():
            cache_before = compile_cache.counters_snapshot()
            # A preemption retry resumes every trial from its newest
            # checkpoint; attempt 0 is a fresh grid, so old trial state
            # goes.
            attempt = engine_mod.current_attempt()
            trial_ck_root = ctx.checkpoint_dir(name)
            if attempt == 0:
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
                        **fit_params}
                    trial_params.setdefault("resume", attempt > 0)
                # A neural trial leases a card for its device work and
                # runs there; on one card the trials serialize.
                lease = ctx.leaser.lease(1, label=f"{name}:trial") \
                    if neural else contextlib.nullcontext([])
                # Re-bind the job scope too: every trial's epochs book
                # against this tune job.
                with jobs_cancel.bind(token), lease as devs, placed(devs), \
                        costs.job_scope(name):
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
            if neural and compile_cache.enabled():
                ctx.engine.note_warm(warm_key)
            # Same-architecture candidates coalesce onto one build per
            # program kind; the rest hit.
            out = {"bestScore": best_score,
                   "bestParams": _json_safe(best_combo),
                   "compileCache": compile_cache.delta_since(cache_before)}
            device_time = costs.job_summary(name)
            if device_time is not None:
                out["deviceTime"] = device_time
            return out

        ctx.engine.submit(
            name, run,
            description=description or f"grid search {parent_name}",
            method=method, parameters=_json_safe(param_grid),
            on_success=lambda extra: extra,
            job_class="executor",
            warm_key=warm_key,
            deadline_s=deadline_s,
        )
        return meta

    def delete(self, name: str) -> None:
        self.ctx.delete_artifact(name)


def _warm_key(meta: dict, method, parameters: dict | None = None):
    """The engine's warm-start hint for a submission: its spec's
    trace-shaping parameters through ``compile_cache.warm_fingerprint``
    (None without a model class to name)."""
    module_path = meta.get("modulePath")
    class_name = meta.get("class")
    if not module_path or not class_name:
        return None
    return compile_cache.warm_fingerprint(module_path, class_name, method,
                                          parameters)


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
