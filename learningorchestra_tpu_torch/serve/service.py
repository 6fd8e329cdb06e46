"""ServingService — port of ``learningorchestra_tpu/serve/service.py``.

Ties a :class:`~learningorchestra_tpu_torch.serve.registry.ModelRegistry`
(artifact → device-resident module) to one
:class:`~learningorchestra_tpu_torch.serve.batcher.MicroBatcher` per
served model, and exposes the synchronous predict served at
``POST /serve/<model>/predict``.  Each dispatch is one padded bucket
through the module under ``torch.inference_mode()``: on the card every
transformer layer runs the flash kernel.

Artifacts are read from the port's ``VolumeStorage`` by volume key: every
train job's binary is on the ``binaries`` volume whatever the tool in its
type (``train/tensorflow``, ``train/pytorch``...), so a REST train job is
servable under its name.  Each ``GET /monitoring/<tool>/serving`` poll
appends one step of ``serving_*`` scalars (:meth:`snapshot_scalars`) to
a tfevents file under the monitoring root.  ``generate`` (``POST
/serve/<model>/generate``) belongs to the decode engine
(``serve/decode``), dormant until the first request.

Fleet serving (``serve/fleet``): a model with replica bounds serves from
a replica set, each replica a card lease + a batcher + its placed module;
``predict`` routes through the set and answers which replica served.
Replica sets read the context's leaser through the ``leaser`` callable
when they are created.

Programs and costs: each bucket's ``apply`` resolves once through the
process-wide program cache (``compile_cache.apply_program_key``, shared
with predict jobs; misses count buckets, never requests), and each
dispatch records its device interval and the bucket's FLOPs in the
device-time ledger per model and bucket (obs/costs.py, sampled).  The
apply stays eager: the fleet's launch-count checks read the kernel
wrappers' counters, which a graph replay would bypass.

Operations plane: every dispatch passes the ``serve.apply`` fault point
on the host before its bucket runs (an injected error fails exactly the
requests coalesced into that dispatch), and every answered predict
observes the per-model predict-latency histogram the rollup's quantiles
and the predict-latency SLO read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.config import (
    AotConfig,
    DecodeConfig,
    FleetConfig,
    ServeConfig,
)
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.jobs.leases import (
    DeviceLeaser,
    LeaseTimeout,
    placed,
)
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.obs.metrics import get_registry
from learningorchestra_tpu_torch.serve.batcher import (
    BatcherClosed,
    MicroBatcher,
)
from learningorchestra_tpu_torch.serve.decode import DecodeEngine
from learningorchestra_tpu_torch.serve.fleet import FleetManager
from learningorchestra_tpu_torch.serve.registry import ModelRegistry, ServeError
from learningorchestra_tpu_torch.services.tfevents import write_scalars
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.toolkit.registry import RegistryError
from learningorchestra_tpu_torch.train.neural import (
    apply_program,
    is_artifact,
    load_artifact,
)

#: An artifact type of the ``binaries`` volume, where every train (and
#: tune) job's estimator artifact lives, whatever its tool.
ARTIFACT_TYPE = "train/pytorch"
#: Steps of serving scalars kept (and rewritten) per snapshot.
_SCALAR_WINDOW = 512


class NotFoundError(Exception):
    """No artifact of that name → 404."""


#: The predict-latency family (the JAX service's).
PREDICT_DURATION = "lo_serving_predict_duration_seconds"


class _PredictHist:
    """The predict-latency histogram with one bound series per model,
    re-resolved when the registry is replaced.  Cardinality is bounded
    by the registry's ``max_models`` cap."""

    __slots__ = ("_reg", "_hist", "_bound")

    def __init__(self):
        self._reg = None
        self._hist = None
        self._bound: dict = {}

    def observe(self, dt_s: float, model: str) -> None:
        reg = get_registry()
        if reg is not self._reg:
            self._hist = reg.histogram(
                PREDICT_DURATION,
                "End-to-end predict latency per served model "
                "(queue wait + coalesce + jitted apply + handoff).",
                labels=("model",))
            self._bound = {}
            self._reg = reg
        bound = self._bound.get(model)
        if bound is None:
            if len(self._bound) >= 256:
                # max_models bounds concurrent models, not every name
                # ever served.
                self._bound.clear()
            bound = self._bound[model] = self._hist.bind(model=model)
        bound.observe(dt_s)


_predict_hist = _PredictHist()


class ServingService:
    def __init__(self, volumes: VolumeStorage, config: ServeConfig | None = None,
                 *, device="cuda", monitoring_root: str | None = None,
                 decode_config: DecodeConfig | None = None,
                 fleet_config: FleetConfig | None = None,
                 aot_config: AotConfig | None = None,
                 leaser: Callable[[], DeviceLeaser] | None = None):
        self.volumes = volumes
        self.monitoring_root = monitoring_root
        self.cfg = config or ServeConfig()
        self.fleet_cfg = fleet_config or FleetConfig()
        self.fleet_cfg.validate()
        self.aot_cfg = aot_config or AotConfig()
        self.device = resolve_device(device)
        if leaser is None:
            own = DeviceLeaser(device=self.device)
            leaser = lambda: own  # noqa: E731
        # The lease pool replicas are placed from, read at each ensure.
        self.leaser = leaser
        self.registry = ModelRegistry(
            self._load_estimator,
            device=self.device,
            max_models=self.cfg.max_models,
            max_bytes=self.cfg.max_bytes,
            on_evict=self._teardown_model,
        )
        self._batchers: dict[str, MicroBatcher] = {}
        # Fleet serving: per-model replica sets over leased cards and the
        # shared autoscaler; dormant (one dict read per predict, no
        # thread) until a model's bounds allow a set.
        self.fleet = FleetManager(self)
        # Streaming decode: resident KV page pools and continuous batching
        # for GreedyDecodeMixin models; no thread and no pool until the
        # first /generate.
        self.decode = DecodeEngine(self, decode_config or DecodeConfig())
        self._lock = make_lock("ServingService._lock")
        self._closed = False
        self._scalar_history: dict[str, list] = {}
        self._scalar_lock = make_lock("ServingService._scalar_lock")
        self._t0 = time.time()

    # -- model residency -----------------------------------------------------

    def _load_estimator(self, name: str):
        try:
            doc = self.volumes.read_object(ARTIFACT_TYPE, name)
        except ValueError as exc:  # invalid artifact name
            raise ServeError(str(exc)) from None
        except FileNotFoundError:
            raise NotFoundError(f"no model artifact named {name!r}") from None
        if not is_artifact(doc) or doc["state"] is None:
            raise ServeError(
                f"artifact {name!r} is not a built neural model binary; "
                "only NeuralEstimator artifacts with parameters are "
                "servable"
            )
        try:
            return load_artifact(doc, device=self.device)
        except RegistryError as exc:
            raise ServeError(str(exc)) from None

    def load(self, name: str) -> dict:
        """Pin ``name`` resident (idempotent).  A generative LM whose
        architecture's decode steps this process restored from the durable
        program store captures their graphs here, before its first
        stream."""
        doc = self.registry.get(name).to_dict()
        self.decode.prewarm(name)
        return doc

    def unload(self, name: str) -> bool:
        self._teardown_model(name, keep_bounds=False)
        return self.registry.unload(name)

    def invalidate(self, name: str, *, gone: bool = False) -> bool:
        """A PATCHed or deleted train job's artifact changed: drop its
        resident params, its decoder and its replica set, so the next
        request reloads.  A DELETED artifact (``gone``) also forgets its
        fleet bounds, so a new model of that name does not inherit them;
        an overwrite keeps them."""
        self._teardown_model(name, keep_bounds=not gone)
        return self.registry.invalidate(name)

    def _teardown_model(self, name: str, *, keep_bounds: bool = True
                        ) -> None:
        """Release what serves ``name``: its batcher, its decoder (the
        pools hold the old architecture's KV shapes and steps over its
        module; in-flight streams fail fast) and its replica set (drained,
        cards released).  ``keep_bounds`` survives invalidation and
        eviction; an explicit unload forgets the model's fleet bounds."""
        self._drop_batcher(name)
        self.decode.drop_model(name)
        self.fleet.drop(name, keep_bounds=keep_bounds)

    def list_loaded(self) -> list[dict]:
        return self.registry.list()

    def _drop_batcher(self, name: str) -> None:
        with self._lock:
            batcher = self._batchers.pop(name, None)
        if batcher is not None:
            batcher.close()

    # -- predict -------------------------------------------------------------

    def _batcher_for(self, name: str) -> MicroBatcher:
        with self._lock:
            batcher = self._batchers.get(name)
            if batcher is None:
                if self._closed:
                    raise RuntimeError("serving is shut down")
                if self.fleet.engaged(name):
                    # Raced a fleet cutover: refuse retriably (429 +
                    # Retry-After) instead of resurrecting the batcher
                    # the fleet just retired; the retry routes onto the
                    # replicas.
                    raise BatcherClosed(
                        f"model {name!r} is moving to fleet serving; "
                        "retry"
                    )
                batcher = self._batchers[name] = MicroBatcher(
                    lambda padded, _n=name: self._dispatch(_n, padded),
                    max_batch=self.cfg.max_batch,
                    max_queue=self.cfg.max_queue,
                    flush_ms=self.cfg.flush_ms,
                    name=name,
                )
            return batcher

    def _dispatch(self, name: str, padded: np.ndarray, replica=None
                  ) -> np.ndarray:
        """Run one padded bucket; returns the host array.  Resolving the
        entry HERE means an invalidation between requests serves the
        reloaded artifact, never a stale module.  ``replica`` (a fleet
        Replica) runs it through the replica's placed module, with its
        card current so the kernels launch there.  The bucket's program
        comes from the program cache once per entry; a sampled dispatch
        books its device interval and FLOPs against the model and
        bucket."""
        # Chaos probe at the batch boundary, on the host before any
        # device work: an injected failure fails every request coalesced
        # into THIS dispatch and leaves the batcher healthy.
        faults.hit("serve.apply")
        entry = self.registry.get(name)
        rows = padded.shape[0]
        apply = entry.apply_fns.get(rows)
        if apply is None:
            apply = entry.apply_fns[rows] = apply_program(
                entry.estimator.module, rows,
                label=f"serve:{type(entry.estimator.module).__name__}"
                      f":b{rows}")
        # The bucket's shape and dtype: what a fresh replica's pre-warm
        # replays (dies with the entry, like decode_warm).
        entry.warm_shapes[rows] = (padded.shape, str(padded.dtype))
        if replica is None:
            module, where = entry.estimator.module, contextlib.nullcontext()
        else:
            module = replica.place(entry)
            where = (placed(replica.devices) if replica.cards is not None
                     else contextlib.nullcontext())
        with where:
            if not costs.enabled():
                return apply(module, padded)
            led = costs.devtime()
            weight = led.will_record(name)
            if not weight:
                return apply(module, padded)
            interval = costs.Interval(next(module.parameters()).device)
            out = apply(module, padded)
            cost = self._apply_cost(entry, rows, apply)
            led.record_model(
                weight, interval.stop().seconds(),
                cost.flops if cost is not None else None,
                cost.bytes_accessed if cost is not None else None,
                name, rows)
            return out

    @staticmethod
    def _apply_cost(entry, rows: int, apply):
        """The bucket's ProgramCost, memoized on the entry next to the
        program; a missing record memoizes too (False) once the program
        has been analyzed."""
        cost = entry.apply_costs.get(rows)
        if cost is None:
            cost = apply.cost()
            if cost is not None and cost.analyzed:
                entry.apply_costs[rows] = cost
            elif apply.analyzed:
                entry.apply_costs[rows] = cost = False
        return cost or None

    def replica_dispatch_factory(self, name: str):
        """Per-replica dispatch binder for the fleet manager: the
        single-path dispatch plus the replica's placement.  The
        single-path batcher is retired (``pop_single_path``) only after
        the first replica places, so a failed scale-up leaves the model
        serving as before."""
        def factory(replica):
            return lambda padded: self._dispatch(
                name, padded, replica=replica)

        return factory

    def replica_warmup_factory(self, name: str):
        """Pre-warm binder for the fleet manager, or None when
        ``AotConfig.replica_prewarm`` is off: dummy dispatches of every
        bucket the model served (``warm_shapes``) through the new
        replica, then the decode leg (every recorded (S, Tk) step), all
        before the router may pick it."""
        if not self.aot_cfg.replica_prewarm:
            return None

        def warm(replica):
            entry = self.registry.peek(name)
            if entry is None:
                return  # not resident: nothing recorded to replay
            # A copy: batcher threads record buckets concurrently.
            for _rows, (shape, dtype) in sorted(
                    entry.warm_shapes.copy().items()):
                self._dispatch(name, np.zeros(shape, dtype=dtype),
                               replica=replica)
            self.decode.warm_replica(name, replica)

        return warm

    def pop_single_path(self, name: str) -> MicroBatcher | None:
        """Detach (NOT close) the model's single-path batcher: the fleet
        cutover absorbs its counters, registers the set, and only then
        drains it, so predicts route onto replicas at once."""
        with self._lock:
            return self._batchers.pop(name, None)

    @staticmethod
    def _as_batch(instances) -> np.ndarray:
        """Request JSON → input batch: float features land f32, integer
        features (token ids) int32."""
        try:
            x = np.asarray(instances)
        except (ValueError, TypeError) as exc:
            raise ServeError(
                f"'instances' is not a rectangular array: {exc}"
            ) from None
        if x.ndim == 0:
            raise ServeError("'instances' must be a non-empty array")
        if x.ndim == 1:
            # A single instance's feature vector: serve it as one row.
            x = x[None, :] if x.shape[0] else x
        if x.shape[0] == 0:
            raise ServeError("'instances' must be a non-empty array")
        if np.issubdtype(x.dtype, np.floating):
            return x.astype(np.float32)
        if np.issubdtype(x.dtype, np.integer):
            return x.astype(np.int32)
        raise ServeError(f"instances dtype {x.dtype} is not numeric")

    def predict(self, name: str, instances) -> dict:
        """Synchronous predict: coalesced, bucketed, split.

        Raises ``QueueFull`` under backpressure (API → 429), NotFoundError
        (404) and ServeError (406)."""
        x = self._as_batch(instances)
        entry = self.registry.get(name)  # load-before-queue: 404 fast
        try:
            entry.estimator.check_input(x)
        except ValueError as exc:
            raise ServeError(str(exc)) from None
        t0 = time.perf_counter()
        try:
            rs = self.fleet.routing_set(name)
        except LeaseTimeout:
            # A PARTIAL cutover registers a routable set before
            # re-raising: serve on it; otherwise the single-path batcher
            # is only retired after the first replica places, so degrade
            # to it.  With neither, the 503 + Retry-After surfaces.
            rs = self.fleet.registered_set(name)
            if rs is None and self._batchers.get(name) is None:
                raise
        if rs is not None:
            out, replica = rs.submit(x)
            entry.requests += 1
            dt = time.perf_counter() - t0
            _predict_hist.observe(dt, model=name)
            return {
                "model": name,
                "predictions": out.tolist(),
                "latencyMs": round(dt * 1e3, 3),
                "replica": replica.idx,
                "device": replica.device_id or "host",
            }
        out = self._batcher_for(name).submit(x)
        entry.requests += 1
        dt = time.perf_counter() - t0
        _predict_hist.observe(dt, model=name)
        return {
            "model": name,
            "predictions": out.tolist(),
            "latencyMs": round(dt * 1e3, 3),
        }

    def generate(self, name: str, prompts, **kwargs):
        """LM generation, the decode engine's facade: a dict for a
        non-stream request, the :class:`~learningorchestra_tpu_torch.serve.
        decode.DecodeStream` (the SSE payload) for ``stream=True``."""
        return self.decode.generate(name, prompts, **kwargs)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            per_model = {
                name: b.stats() for name, b in self._batchers.items()
            }
        # Fleet models in the same per-model shape (replica batchers
        # merged); per-replica detail rides the "fleet" key.
        for name, rs in self.fleet.sets_snapshot():
            per_model[name] = rs.merged_stats()
        return {
            "registry": self.registry.stats(),
            "models": per_model,
            "fleet": self.fleet.snapshot(),
            "decode": self.decode.stats(),
            "config": {
                "maxBatch": self.cfg.max_batch,
                "maxQueue": self.cfg.max_queue,
                "flushMs": self.cfg.flush_ms,
                "maxModels": self.cfg.max_models,
                "maxBytes": self.cfg.max_bytes,
                "retryAfterS": self.cfg.retry_after_s,
            },
        }

    def aggregate(self, stats: dict | None = None) -> dict:
        """Roll-up over the served models of :meth:`stats`: summed counts,
        mean batch occupancy, the worst model's latency quantiles."""
        if stats is None:
            stats = self.stats()
        agg = {"requests": 0, "rows": 0, "batches": 0, "overflows": 0,
               "padded_rows": 0, "queue_depth": 0}
        occ: list[float] = []
        quantiles = {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        for mstats in stats["models"].values():
            agg["requests"] += mstats["requests"]
            agg["rows"] += mstats["rows"]
            agg["batches"] += mstats["batches"]
            agg["overflows"] += mstats["overflows"]
            agg["padded_rows"] += mstats["paddedRows"]
            agg["queue_depth"] += mstats["queueDepth"]
            occ.append(mstats["batchOccupancy"])
            for q in quantiles:
                quantiles[q] = max(quantiles[q], mstats["latencyMs"][q])
        agg["occupancy"] = round(sum(occ) / len(occ), 4) if occ else 0.0
        agg["quantiles"] = quantiles
        agg["resident_models"] = stats["registry"]["residentModels"]
        agg["resident_bytes"] = stats["registry"]["residentBytes"]
        return agg

    def snapshot_scalars(self, stats: dict | None = None) -> dict:
        """Append the current aggregate as one step of ``serving_*``
        scalars and rewrite them (the last ``_SCALAR_WINDOW`` steps) as one
        tfevents file under ``<monitoring root>/serving``."""
        a = self.aggregate(stats)
        agg = {
            "serving_requests": a["requests"],
            "serving_rows": a["rows"],
            "serving_batches": a["batches"],
            "serving_overflows": a["overflows"],
            "serving_queue_depth": a["queue_depth"],
            "serving_batch_occupancy": a["occupancy"],
            "serving_p50_ms": a["quantiles"]["p50"],
            "serving_p95_ms": a["quantiles"]["p95"],
            "serving_p99_ms": a["quantiles"]["p99"],
            "serving_resident_models": a["resident_models"],
            "serving_resident_bytes": a["resident_bytes"],
        }
        # Attributed device seconds across served models, and MFU when
        # the card's peak is configured (obs/costs.py).
        totals = costs.serving_totals()
        agg["serving_device_time_s"] = totals["deviceTimeS"]
        if "mfu" in totals:
            agg["serving_mfu"] = totals["mfu"]
        with self._scalar_lock:
            for key, val in agg.items():
                steps = self._scalar_history.setdefault(key, [])
                steps.append(float(val))
                if len(steps) > _SCALAR_WINDOW:
                    del steps[:-_SCALAR_WINDOW]
            if self.monitoring_root:
                try:
                    # A fixed wall time names one file, rewritten each time.
                    write_scalars(
                        os.path.join(str(self.monitoring_root), "serving"),
                        self._scalar_history, wall_time=self._t0)
                except OSError:
                    pass  # observability must never fail the poll
        return agg

    def close(self) -> None:
        with self._lock:
            self._closed = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
        # Decode first: in-flight streams get a terminal event before
        # their replicas go away; then the fleet (autoscaler stopped,
        # replica batchers drained, cards released).
        self.decode.close()
        self.fleet.close()
        for batcher in batchers:
            batcher.close()
        self.registry.clear()
