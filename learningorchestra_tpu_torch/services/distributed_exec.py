"""Distributed execution service — port of the local paths of
``learningorchestra_tpu/services/distributed_exec.py``.

- ``POST /train/horovod|distributed``: the train request's parameters
  drive :class:`DistributedTrainer` over every leased card (one rank
  each; on a CPU context ``dist.cpu_ranks`` gloo ranks on the CPU; a
  ``mesh`` body's ``sp`` splits each token row over a ring of ranks,
  ``"shardSequence"`` forcing that on or off, and its ``ep`` splits an MoE
  model's experts over the ranks of each replica), with
  managed checkpoints (a fresh POST wipes stale state, a PATCH of a
  failed job or the engine's preemption retry resumes it), the published artifact (int8 with
  ``quantize_checkpoint``), one history row per epoch and, with a
  ``monitoringPath``, a monitoring session whose logdir gets the scalars
  (with rank 0's ``compile_cache_*`` counter deltas, also published as
  the job's ``compileCache``) and rank 0's profiler trace;
- ``POST /builder/tensorflow|pytorch|horovod``: one validated user
  function run once per rank with ``rank``/``world_size`` keyword
  arguments, the ranks as host threads (the function is user code; no
  process group is needed), one result row per rank.

The JAX package's cluster mode (``_submit_train_cluster``, a fit fanned
out to host agents by a task coordinator) is ROADMAP A.9 part 3 / A.11:
with ``dist.task_coordinator`` set a distributed train answers 406.
"""

from __future__ import annotations

import ast
import concurrent.futures
import shutil
import time

from learningorchestra_tpu_torch import dsl
from learningorchestra_tpu_torch.jobs import engine as engine_mod
from learningorchestra_tpu_torch.jobs.leases import placed
from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.services.executor import (
    ExecutorService,
    _json_safe,
    store_history_rows,
)
from learningorchestra_tpu_torch.services.monitoring import (
    MonitoringService,
    write_scalar_logs,
)

DISTRIBUTED_TRAIN_TYPE = "train/tensorflow"
DISTRIBUTED_BUILDER_TYPE = "builder/horovod"
# One request must not be able to exhaust the server's threads: builder
# ranks are host threads.
MAX_BUILDER_WORKERS = 256


def rank_devices(device, leased: list, cpu_ranks: int) -> list:
    """One rank per leased card on a context on the card; ``cpu_ranks``
    ranks on a context on the CPU.  A card context that leased no card
    raises rather than train on the CPU."""
    if device.type == "cpu":
        return ["cpu"] * cpu_ranks
    if not leased:
        raise RuntimeError(
            f"a distributed fit on {device} leased no card")
    return list(leased)


def _validate_single_function(code: str) -> str:
    """The builder contract: the payload is EXACTLY one top-level function
    definition (imports and a docstring allowed).  Returns its name."""
    try:
        tree = ast.parse(code)
    except SyntaxError as exc:
        raise ValidationError(f"function does not parse: {exc}") from exc
    if any(isinstance(n, ast.AsyncFunctionDef) for n in tree.body):
        # Each rank calls the function synchronously; an async def would
        # return an un-awaited coroutine instead of results.
        raise ValidationError("builder function must not be async")
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]

    def allowed(node: ast.stmt) -> bool:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return True
        # A bare expression is allowed only as a docstring: a call would
        # run at exec time, outside the per-rank function.
        return isinstance(node, ast.Expr) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str)

    others = [n for n in tree.body if n not in defs and not allowed(n)]
    if len(defs) != 1 or others:
        raise ValidationError(
            "builder function must be a single top-level function "
            "definition (imports and a docstring are allowed)"
        )
    return defs[0].name


class DistributedExecutorService:
    def __init__(self, ctx: ServiceContext,
                 monitoring: MonitoringService | None = None):
        self.ctx = ctx
        self.monitoring = monitoring

    # -- distributed training -------------------------------------------------

    def create_train(
        self,
        name: str,
        *,
        parent_name: str,
        training_parameters: dict | None = None,
        compile_spec: dict | None = None,
        mesh: dict | None = None,
        monitoring_path: str | None = None,
        artifact_type: str = DISTRIBUTED_TRAIN_TYPE,
        description: str = "",
    ) -> tuple[dict, dict]:
        """Returns (metadata, extra_results); the extra results carry the
        monitoring session."""
        self.ctx.require_new_name(name)
        ExecutorService._reject_raw_checkpoint_dir(training_parameters)
        parent_meta = self.ctx.require_finished_parent(parent_name)
        self._refuse_cluster_mode()
        # The nickname is checked before the artifact exists: a bad
        # monitoringPath answers 406 without burning the name.
        session_name = None
        if monitoring_path is not None and self.monitoring is not None:
            session_name = str(monitoring_path).strip("/").replace(
                "/", "_") or name
            if not self.monitoring.valid_nickname(session_name):
                raise ValidationError(
                    f"invalid monitoringPath {monitoring_path!r}")
        model_meta = self.ctx.artifacts.metadata.find_model_ancestor(
            parent_name)
        meta = self.ctx.artifacts.metadata.create(
            name,
            artifact_type,
            parent_name=parent_name,
            module_path=model_meta.get("modulePath"),
            class_name=model_meta.get("class"),
            method="fit",
            extra={"distributed": True, "mesh": _json_safe(mesh or {})},
        )
        extra_results: dict = {}
        session_logdir = None
        if session_name is not None:
            session_info = self.monitoring.start(session_name)
            # The logdir is captured now: a mid-train DELETE of the session
            # must not fail the training job.
            session_logdir = session_info["logdir"]
            extra_results["monitoring"] = session_info
        self._submit_train(
            name, parent_meta, training_parameters, compile_spec, mesh,
            artifact_type, description, session_logdir=session_logdir,
            resume_default=False,
        )
        return meta, extra_results

    def update_train(
        self,
        name: str,
        *,
        training_parameters: dict | None = None,
        compile_spec: dict | None = None,
        mesh: dict | None = None,
        description: str = "",
    ) -> dict:
        """PATCH re-run: a FAILED job resumes from its managed checkpoint,
        a finished one re-runs fresh; a bare PATCH re-uses the recorded
        parameters."""
        meta = self.ctx.require_existing(name)
        ExecutorService._reject_raw_checkpoint_dir(training_parameters)
        parent = meta.get("parentName")
        if not parent:
            raise ValidationError(
                f"artifact {name!r} has no parent — not a train result")
        parent_meta = self.ctx.require_finished_parent(parent)
        self._refuse_cluster_mode()
        resume = meta.get("jobState") == "failed"
        if not training_parameters:
            training_parameters = self.ctx.last_recorded_parameters(name)
        self.ctx.artifacts.metadata.restart(name)
        self._submit_train(
            name, parent_meta, training_parameters, compile_spec,
            mesh or meta.get("mesh"), meta.get("type"), description,
            session_logdir=None, resume_default=resume,
        )
        return self.ctx.artifacts.metadata.read(name)

    def _refuse_cluster_mode(self) -> None:
        if self.ctx.config.dist.task_coordinator:
            raise ValidationError(
                "cluster-mode distributed training (a task coordinator) is "
                "not ported to the PyTorch package (ROADMAP A.9 part 3, "
                "A.11); unset dist.task_coordinator to train on this host")

    def _submit_train(self, name, parent_meta, training_parameters,
                      compile_spec, mesh, artifact_type, description, *,
                      session_logdir, resume_default):
        parent_name = parent_meta["name"]
        parent_type = parent_meta.get("type", "")
        ctx = self.ctx

        def run():
            from learningorchestra_tpu_torch.parallel.distributed import (
                DistributedTrainer,
            )
            from learningorchestra_tpu_torch.parallel.mesh import MeshSpec
            from learningorchestra_tpu_torch.train.neural import (
                NeuralEstimator,
            )

            params = dsl.resolve_params(training_parameters, ctx.loader)
            spec = MeshSpec.from_dict(mesh) if mesh else None
            # None: the trainer's default (on iff sp > 1); the mesh body
            # forces it with "shardSequence".
            shard_seq = (mesh or {}).get("shardSequence")
            ckdir = ctx.checkpoint_dir(name)
            params.setdefault("resume", resume_default)
            if engine_mod.current_attempt() > 0:
                # A preemption retry's checkpoints are this run's own
                # state: resume even when the request said fresh-fit.
                params["resume"] = True
            if not params["resume"]:
                shutil.rmtree(ckdir, ignore_errors=True)
            params["checkpoint_dir"] = str(ckdir)
            # Written by rank 0: the session's logdir, never a path from
            # the request.
            params["trace_dir"] = session_logdir
            # A distributed fit spans the host's cards: it leases all of
            # them, so it never interleaves with single-card jobs.
            with ctx.leaser.lease(0, label=name) as devs, placed(devs):
                if devs:
                    ctx.artifacts.metadata.update(
                        name, {"leasedDevices": devs})
                instance = ctx.volumes.load_estimator(
                    parent_type, parent_name, device=ctx.device)
                if not isinstance(instance, NeuralEstimator):
                    raise ValidationError(
                        f"parent {parent_name!r} is not a neural estimator "
                        "— distributed training requires one")
                if compile_spec:
                    instance.compile(
                        **dsl.resolve_params(compile_spec, ctx.loader))
                trainer = DistributedTrainer(
                    instance, spec=spec, devices=rank_devices(
                        ctx.device, devs, ctx.config.dist.cpu_ranks),
                    stage_root=ctx.stage_root(),
                    shard_sequence=None if shard_seq is None
                    else bool(shard_seq))
                t0 = time.perf_counter()
                trainer.fit(**params)
                fit_time = time.perf_counter() - t0
                # A stale-epoch straggler must not overwrite the artifact
                # a newer recovery owns.
                ctx.require_current_epoch()
                ctx.volumes.save_estimator(artifact_type, name, instance)
            # A serving registry holding the old params reloads them.
            ctx.notify_artifact_changed(name)
            # Re-runs replace the history rows.
            for doc in ctx.documents.find(name,
                                          query={"docType": "history"}):
                ctx.documents.delete_one(name, doc["_id"])
            store_history_rows(ctx.documents, name, dict(trainer.history))
            # Rank 0's program-cache counters: the job's compileCache, and
            # single-step scalars beside the training curves.
            cache_delta = trainer.compile_cache
            if session_logdir is not None:
                logged = dict(trainer.history)
                logged.update({f"compile_cache_{key}": [float(val)]
                               for key, val in (cache_delta or {}).items()})
                write_scalar_logs(session_logdir, logged, prefix=name)
            return {"fitTime": fit_time, "meshDevices": trainer.mesh.size,
                    "compileCache": cache_delta}

        ctx.engine.submit(
            name,
            run,
            description=description or f"distributed fit on {parent_name}",
            method="fit",
            parameters=_json_safe(training_parameters),
            on_success=lambda extra: extra,
            job_class="distributed",
        )

    # -- distributed builder --------------------------------------------------

    def create_builder(
        self,
        name: str,
        *,
        function: str,
        function_parameters: dict | None = None,
        n_workers: int | None = None,
        artifact_type: str = DISTRIBUTED_BUILDER_TYPE,
        description: str = "",
    ) -> dict:
        self.ctx.require_new_name(name)
        if not function or not isinstance(function, str):
            raise ValidationError("missing 'function' code")
        fn_name = _validate_single_function(function)
        if n_workers is None:
            world = int(self.ctx.config.dist.num_processes or 1)
        else:
            try:
                world = int(n_workers)
            except (TypeError, ValueError):
                raise ValidationError("n_workers must be an integer")
        if not 1 <= world <= MAX_BUILDER_WORKERS:
            raise ValidationError(
                f"n_workers must be in [1, {MAX_BUILDER_WORKERS}]")
        meta = self.ctx.artifacts.metadata.create(
            name, artifact_type, method=fn_name, extra={"worldSize": world})
        ctx = self.ctx

        def run():
            params = dsl.resolve_params(function_parameters, ctx.loader)
            globs: dict = {"__name__": f"builder_{name}"}
            exec(compile(function, f"<builder {name}>", "exec"),  # noqa: S102
                 globs)
            fn = globs[fn_name]

            def one_rank(rank: int):
                return fn(rank=rank, world_size=world, **params)

            with concurrent.futures.ThreadPoolExecutor(world) as pool:
                results = list(pool.map(one_rank, range(world)))
            ctx.volumes.save_object(artifact_type, name, results)
            for rank, result in enumerate(results):
                ctx.documents.insert_one(
                    name, {"rank": rank, "result": _json_safe(result)})
            return {"worldSize": world}

        ctx.engine.submit(
            name,
            run,
            description=description or f"distributed builder ({world} ranks)",
            method=fn_name,
            parameters=_json_safe(function_parameters),
            on_success=lambda extra: extra,
            job_class="distributed",
        )
        return meta
