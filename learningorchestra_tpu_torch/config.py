"""Configuration — port of the parts of ``learningorchestra_tpu/config.py``
the port runs: ``StoreConfig``, ``APIConfig``, ``JobConfig`` (with the job
journal's switches), ``CompileCacheConfig``, ``AotConfig``,
``ServeConfig``, ``DecodeConfig``, ``FleetConfig``, ``CostsConfig``,
``ProfilingConfig``, ``DistributedConfig`` and the operations plane's
``ObsConfig``, ``RollupConfig``, ``SLOConfig``, ``FlightConfig``,
``BundleConfig`` and ``FaultsConfig``, with the same fields,
defaults and ``LO_TPU_*`` environment names, plus the ``device`` every
entry point runs on and ``DistributedConfig.cpu_ranks``, the rank devices
a CPU context gives a distributed fit.  :func:`get_config` is the process-wide config the
compile cache and the cost ledgers size themselves from, as in the JAX
package.

The default roots are the port's own (``~/.learningorchestra_tpu_torch``),
so the two packages never share a store by accident; pointing both at
one root works, since the WAL format is the same.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

from learningorchestra_tpu_torch.concurrency_rt import make_lock


@dataclasses.dataclass
class StoreConfig:
    """Where artifacts live."""

    # Root directory for the document store (collections + WAL files).
    # Env: LO_TPU_STORE_ROOT.
    root: str = "~/.learningorchestra_tpu_torch/store"
    # Root for volume-backed binaries.  Env: LO_TPU_VOLUME_ROOT.
    volume_root: str = "~/.learningorchestra_tpu_torch/volumes"
    # fsync appends on every write (durable) vs. rely on OS flush (fast).
    durable_writes: bool = False
    # Document-store engine: "native" (the C++ store, native/__init__.py),
    # "python" (the embedded WAL store) or "auto" (native when its library
    # builds with g++, else python).  Clustering needs "python".
    # Env: LO_TPU_STORE_BACKEND.
    backend: str = "auto"

    def store_path(self) -> Path:
        return Path(os.path.expanduser(self.root))

    def volume_path(self) -> Path:
        return Path(os.path.expanduser(self.volume_root))


@dataclasses.dataclass
class APIConfig:
    """REST front server and its gateway (the JAX package's fields and
    defaults): the address ``serve`` binds, the request budget (504 past
    it), the response cache's TTL on the GETs that opt in, and the two
    concurrency caps: every admitted handler holds one of
    ``max_inflight`` slots (503 at saturation, no queueing), and
    ``max_connections`` bounds the connection threads underneath, so a
    client trickling bodies never reaches the handler cap.  <= 0
    disables either cap, the budget or the cache."""

    host: str = "0.0.0.0"
    # Env: LO_TPU_API_PORT.
    port: int = 80
    request_timeout_s: float = 10.0
    cache_ttl_s: float = 300.0
    max_inflight: int = 64
    max_connections: int = 256
    # GET pagination cap.
    page_limit_max: int = 100
    page_limit_default: int = 20
    api_prefix: str = "/api/learningOrchestra/v1"
    # Host advertised in monitoring (TensorBoard) URLs; unset binds and
    # advertises 127.0.0.1.  Env: LO_TPU_MONITORING_EXTERNAL_HOST.
    monitoring_external_host: str | None = None


@dataclasses.dataclass
class JobConfig:
    """Async job engine sizing."""

    # Env: LO_TPU_MAX_WORKERS.
    max_workers: int = 8
    # Weighted-fair dispatch weights per job class (service type);
    # unlisted classes weigh 1.  Env: LO_TPU_JOB_WEIGHTS='{"train": 2}'.
    class_weights: dict = dataclasses.field(default_factory=dict)
    # Preemption-retry budget per job: a body raising ``Preempted``
    # re-executes up to this many times.  Env: LO_TPU_JOB_RETRIES.
    max_preemption_retries: int = 3
    # Retry backoff: attempt N sleeps min(max, base * 2**(N-1)) with
    # U[0.5, 1.5) jitter before re-executing.
    # Env: LO_TPU_JOB_BACKOFF_S / LO_TPU_JOB_BACKOFF_MAX_S.
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 5.0
    # Default wall-clock deadline per dispatched job (preemption retries
    # included); <= 0 disables.
    # Env: LO_TPU_JOB_DEADLINE_S.
    deadline_s: float = 0.0
    # Graceful-shutdown drain budget; <= 0 keeps the unbounded drain.
    # Env: LO_TPU_JOB_DRAIN_S.
    shutdown_drain_s: float = 0.0
    # Crash-durable job journal (jobs/journal.py): every transition is
    # group-committed to the _job_journal collection, each boot mints an
    # engine epoch and stale-epoch commits are refused.  Off: interrupted
    # jobs are re-flagged failed at boot, nothing is re-dispatched.
    # Env: LO_TPU_JOB_JOURNAL.
    journal: bool = True
    # Boot-time recovery: re-dispatch journaled executor jobs in their
    # pre-crash queue order (train fits resume from their newest managed
    # checkpoint).  Off: they fail ``orphaned-by-restart`` instead.
    # Env: LO_TPU_JOB_JOURNAL_RECOVER.
    journal_recover: bool = True
    # Past this many records, boot-time pruning keeps only the last
    # record of each terminal job; <= 0 disables pruning.
    # Env: LO_TPU_JOB_JOURNAL_MAX.
    journal_max_records: int = 4096


@dataclasses.dataclass
class CompileCacheConfig:
    """Process-wide program cache (train/compile_cache.py): the programs
    of a train, tune, predict, serve or decode job survive across jobs,
    so a repeated spec or a same-architecture tune sweep builds once."""

    # Entry cap; <= 0 disables the cache (every lookup builds).
    # Env: LO_TPU_COMPILE_CACHE_ENTRIES.
    max_entries: int = 64
    # Estimated-resident-bytes cap (each entry charges ``entry_bytes``
    # unless the cost ledger measured a size).
    # Env: LO_TPU_COMPILE_CACHE_BYTES.
    max_bytes: int = 2 << 30
    # Per-entry byte estimate. Env: LO_TPU_COMPILE_CACHE_ENTRY_BYTES.
    entry_bytes: int = 32 << 20


@dataclasses.dataclass
class ServeConfig:
    """Resident model serving (serve/): request-coalescing batched
    inference over device-pinned params (POST /serve/<model>/predict)."""

    # Largest coalesced dispatch (rows); also the largest shape bucket.
    # Env: LO_TPU_SERVE_MAX_BATCH.
    max_batch: int = 64
    # Bounded request queue (rows) per served model; beyond it submit
    # sheds load (HTTP 429 + Retry-After).  Env: LO_TPU_SERVE_MAX_QUEUE.
    max_queue: int = 256
    # Flush deadline: a dispatch fires at most this many ms after the
    # OLDEST waiting request arrived.  Env: LO_TPU_SERVE_FLUSH_MS.
    flush_ms: float = 5.0
    # Registry caps: resident model count and total parameter bytes.
    # Env: LO_TPU_SERVE_MAX_MODELS / LO_TPU_SERVE_MAX_BYTES.
    max_models: int = 4
    max_bytes: int = 1 << 30
    # Retry-After seconds advertised with a 429.
    # Env: LO_TPU_SERVE_RETRY_AFTER.
    retry_after_s: float = 1.0


@dataclasses.dataclass
class DecodeConfig:
    """Streaming LM decode engine (serve/decode/): resident KV page pools
    + continuous batching + SSE token streaming behind
    ``POST /serve/<model>/generate``.  Env knobs: LO_TPU_DECODE_*."""

    # Master switch: off, /generate still answers non-stream requests
    # through the solo decode loop; stream=true is refused (406).
    # Env: LO_TPU_DECODE_ENABLED.
    enabled: bool = True
    # Largest slot bucket per KV page pool (power-of-two growth up to
    # this): bounds concurrent in-flight sequences per (model, kv bucket).
    # Env: LO_TPU_DECODE_MAX_SLOTS.
    max_slots: int = 8
    # Largest KV-length bucket (positions per slot); also caps prompt +
    # generation length served by the engine.  The effective cap is
    # min(model max_len, this).  Env: LO_TPU_DECODE_MAX_KV.
    max_kv: int = 2048
    # Active + pending stream cap per model; beyond it, submission sheds
    # load (HTTP 429 + Retry-After).  Env: LO_TPU_DECODE_MAX_STREAMS.
    max_streams: int = 64
    # Server-side ceiling on a request's maxNewTokens.
    # Env: LO_TPU_DECODE_MAX_NEW.
    max_new_tokens: int = 128
    # Idle decode workers park and free their resident KV pools after
    # this long with no streams.  Env: LO_TPU_DECODE_IDLE_S.
    idle_timeout_s: float = 60.0


@dataclasses.dataclass
class FleetConfig:
    """Fleet serving (serve/fleet/): replica sets over leased cards with
    a metrics-driven autoscaler.  Env knobs: LO_TPU_FLEET_*.  The
    defaults keep the fleet off (max 1 replica: single-batcher serving)
    until a deployment raises the bounds globally or per model
    (``POST /serve/<model>/replicas``)."""

    # Autoscaler loop switch (replica sets and manual scaling still work
    # when off).  Env: LO_TPU_FLEET_ENABLED.
    enabled: bool = True
    # Deployment-wide default replica bounds per served model; max > 1
    # puts every served model on the fleet path.
    # Env: LO_TPU_FLEET_MIN / LO_TPU_FLEET_MAX.
    min_replicas: int = 1
    max_replicas: int = 1
    # Autoscaler tick; <= 0 disables the loop thread.
    # Env: LO_TPU_FLEET_INTERVAL_S.
    interval_s: float = 2.0
    # Scale up when the fleet's queued rows over its queue capacity stay
    # at or above up_queue_frac for up_ticks ticks, on any shed (429)
    # request, or when p99 crosses up_p99_ms (0 = off).
    # Env: LO_TPU_FLEET_UP_QUEUE_FRAC / _UP_TICKS / _UP_P99_MS.
    up_queue_frac: float = 0.25
    up_ticks: int = 2
    up_p99_ms: float = 0.0
    # Scale down after this many consecutive ticks with no traffic.
    # Env: LO_TPU_FLEET_DOWN_TICKS.
    down_ticks: int = 5
    # Scale up when a model's queued rows grow faster than this many
    # rows/s, fitted by least squares over slope_window_s of the rollup
    # series (obs/rollup.py); 0 = off.  Needs the rollup engine on and
    # ticking.  Env: LO_TPU_FLEET_UP_SLOPE / LO_TPU_FLEET_SLOPE_WINDOW_S.
    up_slope: float = 0.0
    slope_window_s: float = 30.0
    # Scale up when the model's attributed device seconds per wall
    # second (obs/costs.py) reach this fraction (0 = off).
    # Env: LO_TPU_FLEET_UP_DEVICE_FRAC.
    up_device_frac: float = 0.0
    # Lease budget for placing a new replica; on timeout a scale-up is
    # skipped (autoscaler) or answered 503 (REST).
    # Env: LO_TPU_FLEET_LEASE_TIMEOUT_S.
    lease_timeout_s: float = 5.0
    # Router RNG seed (P2C is seeded-deterministic).
    router_seed: int = 0
    # Cards leased per replica (per model: POST devicesPerReplica).
    # Env: LO_TPU_FLEET_DEVICES_PER_REPLICA.
    devices_per_replica: int = 1

    def validate(self) -> None:
        """Refuse at boot what would otherwise first fail inside a
        predict's lazy replica set."""
        if self.devices_per_replica < 1:
            raise ValueError(
                "LO_TPU_FLEET_DEVICES_PER_REPLICA must be >= 1, got "
                f"{self.devices_per_replica}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "fleet replica bounds need 1 <= LO_TPU_FLEET_MIN "
                f"({self.min_replicas}) <= LO_TPU_FLEET_MAX "
                f"({self.max_replicas})")


@dataclasses.dataclass
class AotConfig:
    """The durable program store (train/aot_store.py) and the boot
    pre-warm, field for field the JAX package's ``AOTConfig``.  A blob
    holds a program's identity and cost record, not an executable: off by
    default all the same, as in the JAX package."""

    # Master switch (off by default, as in the JAX package).
    # Env: LO_TPU_AOT_ENABLED.
    enabled: bool = False
    # On-disk store (blobs + hot-set manifest).  Env: LO_TPU_AOT_DIR.
    dir: str = "~/.learningorchestra_tpu_torch/aot_cache"
    # Persisted-entry cap; <= 0 disables the store.
    # Env: LO_TPU_AOT_MAX_ENTRIES.
    max_entries: int = 64
    # Persisted-bytes cap.  Env: LO_TPU_AOT_MAX_BYTES.
    max_bytes: int = 1 << 30
    # Boot pre-warm: install the manifest's hot set into the program cache
    # on a background thread at ServiceContext boot.
    # Env: LO_TPU_AOT_PREWARM.
    prewarm: bool = True
    # Warm a fresh replica against its model's recorded buckets (and
    # decode steps) BEFORE the router may pick it.
    # Env: LO_TPU_AOT_REPLICA_PREWARM.
    replica_prewarm: bool = False


@dataclasses.dataclass
class CostsConfig:
    """Cost accounting (obs/costs.py): per-program FLOPs and memory
    ledgers, and sampled device-time attribution per job, served model
    and serving bucket.  Env knobs: LO_TPU_COSTS_*."""

    # Master switch: off, builders skip analysis and the per-dispatch
    # hook is one config check.  Env: LO_TPU_COSTS_ENABLED.
    enabled: bool = True
    # Deep analysis: the peak device memory of the analyzed call (on a
    # card).  Env: LO_TPU_COSTS_DEEP.
    deep: bool = True
    # Per-dispatch attribution sampling (0.0-1.0), quantized to
    # 1/round(1/sample): every k-th dispatch records, scaled by k.
    # Env: LO_TPU_COSTS_SAMPLE.
    sample: float = 1.0
    # Ledger bounds: distinct program fingerprints / freshest jobs.
    # Env: LO_TPU_COSTS_MAX_PROGRAMS / LO_TPU_COSTS_MAX_JOBS.
    max_programs: int = 256
    max_jobs: int = 64
    # Per-card peak FLOP/s for model-FLOPs-utilization (e.g. 9.894e14
    # for an H100 SXM's dense bf16).  0 = unknown: MFU is omitted, not
    # made up.  Env: LO_TPU_COSTS_PEAK_FLOPS.
    peak_flops: float = 0.0


@dataclasses.dataclass
class ProfilingConfig:
    """On-demand profiler capture (obs/profiling.py): ``torch.profiler``
    behind POST /observability/profile/start|stop.  Env knobs:
    LO_TPU_PROF_*."""

    # Capture root; "" derives <volume_root>/_profiles at server
    # construction.  Env: LO_TPU_PROF_DIR.
    dir: str = ""
    # Auto-stop deadline per capture (also the cap on a request's
    # maxSeconds): a forgotten capture must not trace forever.
    # Env: LO_TPU_PROF_MAX_S.
    max_seconds: float = 60.0
    # Retained captures; older ones are deleted on the next start.
    # Env: LO_TPU_PROF_MAX_CAPTURES.
    max_captures: int = 8


@dataclasses.dataclass
class DistributedConfig:
    """Data-parallel training (parallel/distributed.py) and the
    distributed builder."""

    # The distributed builder's default nWorkers.  Env: LO_TPU_WORLD_SIZE.
    num_processes: int = 1
    # The rank devices of a context on the CPU: a distributed fit there
    # runs this many gloo ranks on the CPU (a context on the card gives
    # one rank per leased card).  Env: LO_TPU_CPU_RANKS.
    cpu_ranks: int = 1
    # The JAX package's cluster-mode job budget, kept for parity and read
    # by nothing until cluster mode is ported (ROADMAP A.11): a local fit
    # ends with its ranks, bounded by the engine's deadline and cancel.
    job_timeout_s: float = 86400.0
    # The JAX package's cluster mode (a task coordinator's "host:port"):
    # set, a distributed train answers 406 (ROADMAP A.9 part 2, A.11).
    # Env: LO_TPU_TASK_COORDINATOR.
    task_coordinator: str | None = None
    # Where a distributed fit stages its inputs and task (one directory
    # per fit); unset: ``_dist_stage`` under the volume root.  Boot
    # recovery removes the stages no live fit owns.
    # Env: LO_TPU_DIST_STAGE_ROOT.
    stage_root: str | None = None

    def stage_path(self, volume_root: Path) -> Path:
        if self.stage_root:
            return Path(os.path.expanduser(self.stage_root))
        return Path(volume_root) / "_dist_stage"


@dataclasses.dataclass
class ObsConfig:
    """Metrics registry + Prometheus exposition at GET /metrics.prom +
    job trace spans (obs/metrics.py, obs/tracing.py).  Env knobs:
    LO_TPU_OBS_*."""

    # Master switch: off makes every metric/span primitive a no-op.
    # Env: LO_TPU_OBS_ENABLED.
    enabled: bool = True
    # Job tracing (request-id propagation + spans persisted into the
    # execution ledger); metrics stay on when only this is off.
    # Env: LO_TPU_OBS_TRACE.
    trace: bool = True
    # Label-cardinality cap per metric: past it, new label combinations
    # collapse into one ``_overflow`` series.  Env: LO_TPU_OBS_MAX_SERIES.
    max_series: int = 1024
    # Span cap per job trace.  Env: LO_TPU_OBS_MAX_SPANS.
    max_spans: int = 512
    # Span-ledger sampling (0.0-1.0), decided per requestId.
    # Env: LO_TPU_OBS_TRACE_SAMPLE.
    trace_sample: float = 1.0
    # HTTP latency histogram bucket edges, milliseconds, ascending.
    # Env: LO_TPU_OBS_BUCKETS_MS (comma-separated).
    latency_buckets_ms: tuple = (
        1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
        250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
    )


@dataclasses.dataclass
class RollupConfig:
    """Windowed time-series rollups (obs/rollup.py) served at
    ``GET /observability/timeseries``.  Env knobs: LO_TPU_ROLLUP_*."""

    # Master switch: off, no snapshots are taken and SLO evaluation
    # (which reads rollup windows) is off too.  Env: LO_TPU_ROLLUP_ENABLED.
    enabled: bool = True
    # Snapshot cadence; <= 0 disables the daemon thread (tick() stays
    # callable).  Env: LO_TPU_ROLLUP_TICK_S.
    tick_s: float = 10.0
    # Ring length per series.  Env: LO_TPU_ROLLUP_POINTS.
    points: int = 360
    # Total tracked series; past it NEW series are dropped (counted).
    # Env: LO_TPU_ROLLUP_MAX_SERIES.
    max_series: int = 2048
    # Extra families to track on top of the core set.
    # Env: LO_TPU_ROLLUP_FAMILIES (comma-separated).
    families: tuple = ()


@dataclasses.dataclass
class SLOConfig:
    """SLO objectives + multi-window burn-rate alerting (obs/slo.py).
    Env knobs: LO_TPU_SLO_*."""

    # Evaluation switch.  Env: LO_TPU_SLO_ENABLED.
    enabled: bool = True
    # Route availability target.  Env: LO_TPU_SLO_AVAILABILITY.
    availability_target: float = 0.999
    # Per-model predict latency: predict_target of predicts under
    # predict_p99_ms (0 ms disables).
    # Env: LO_TPU_SLO_PREDICT_P99_MS / LO_TPU_SLO_PREDICT_TARGET.
    predict_p99_ms: float = 250.0
    predict_target: float = 0.99
    # Streamed-decode time to first token (0 ms disables).
    # Env: LO_TPU_SLO_DECODE_TTFT_MS / LO_TPU_SLO_DECODE_TTFT_TARGET.
    decode_ttft_ms: float = 0.0
    decode_ttft_target: float = 0.99
    # Job success target.  Env: LO_TPU_SLO_JOB_SUCCESS.
    job_success_target: float = 0.99
    # Burn windows and threshold.
    # Env: LO_TPU_SLO_FAST_S / LO_TPU_SLO_SLOW_S / LO_TPU_SLO_BURN.
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    burn_threshold: float = 14.4
    # Alert dwell times.  Env: LO_TPU_SLO_FOR_S / LO_TPU_SLO_RESOLVE_S.
    for_s: float = 60.0
    resolve_s: float = 300.0
    # Webhook sink URL; empty = off.  Env: LO_TPU_SLO_WEBHOOK.
    webhook: str = ""


@dataclasses.dataclass
class FlightConfig:
    """Always-on flight recorder (obs/flight.py).  Env knobs:
    LO_TPU_FLIGHT_*."""

    # Master switch.  Env: LO_TPU_FLIGHT_ENABLED.
    enabled: bool = True
    # Ring capacity per domain.  Env: LO_TPU_FLIGHT_EVENTS.
    events: int = 512


@dataclasses.dataclass
class BundleConfig:
    """Debug-bundle assembler (obs/bundle.py).  Env knobs:
    LO_TPU_BUNDLE_*."""

    # Switch for trigger-driven capture.  Env: LO_TPU_BUNDLE_ENABLED.
    enabled: bool = True
    # Bundle root; "" derives <volume_root>/_bundles at server
    # construction.  Env: LO_TPU_BUNDLE_DIR.
    dir: str = ""
    # Retained bundles.  Env: LO_TPU_BUNDLE_MAX.
    max_bundles: int = 8
    # Minimum seconds between auto-triggered bundles.
    # Env: LO_TPU_BUNDLE_DEBOUNCE_S.
    debounce_s: float = 300.0
    # Start a short torch.profiler capture with each bundle.
    # Env: LO_TPU_BUNDLE_PROFILE / LO_TPU_BUNDLE_PROFILE_S.
    profile: bool = False
    profile_s: float = 2.0
    # Journal records in the bundle's tail.
    # Env: LO_TPU_BUNDLE_JOURNAL_TAIL.
    journal_tail: int = 200


@dataclasses.dataclass
class FaultsConfig:
    """Fault-injection plane (faults/plane.py): schedules armed at boot
    from ``LO_TPU_FAULT_<POINT>=<mode>[:k=v,...]``; the API server passes
    ``specs`` to ``faults.load_env`` at construction."""

    # point-name suffix (env spelling) -> raw spec string.
    specs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class HAConfig:
    """Store failover pairing (store/ha.py — the reference's mongo
    replica set): the JAX package's fields and defaults."""

    # "host:port" of the HA partner node: the standby before promotion,
    # the old primary after.  When set, serve() refuses to start — and a
    # running primary self-demotes — if the peer answers
    # /replication/status as a primary with a HIGHER election epoch.
    # Env: LO_HA_PEER.
    peer: str = ""
    # Seconds between fence / peer-epoch checks while serving; <= 0 keeps
    # the server default (APIServer.FENCE_CHECK_INTERVAL_S).
    # Env: LO_HA_FENCE_INTERVAL.
    fence_interval_s: float = 0.0
    # A fenced primary rejoins as the new primary's standby (network WAL
    # shipping into <store>.rejoined) instead of exiting.
    # Env: LO_HA_AUTO_REJOIN.
    auto_rejoin: bool = False
    # Takeover window of the auto-rejoined standby (2 s x 15 = 30 s).
    # Env: LO_HA_REJOIN_INTERVAL, LO_HA_REJOIN_MISSES.
    rejoin_interval_s: float = 2.0
    rejoin_misses: int = 15


@dataclasses.dataclass
class ClusterConfig:
    """Scale-out control plane (jobs/cluster.py): N engine processes over
    ONE store root share dispatch through a store-backed claim table with
    heartbeat-renewed leases.  Needs the python store backend (the claim
    table's WAL-refresh coherence primitive)."""

    # Join the cluster at boot.  Env: LO_TPU_CLUSTER_ENABLED.
    enabled: bool = False
    # Engine identity in the claim table ("" derives engine-<pid>); two
    # engines must not share one.  Env: LO_TPU_CLUSTER_ENGINE_ID.
    engine_id: str = ""
    # Lease renewal cadence.  Env: LO_TPU_CLUSTER_HEARTBEAT_S.
    heartbeat_s: float = 1.0
    # A claim (or engine) whose heartbeat is older than this is dead and
    # stealable; the engines' clocks must agree to within it.
    # Env: LO_TPU_CLUSTER_TTL_S.
    ttl_s: float = 5.0
    # Expired-claim sweep cadence.  Env: LO_TPU_CLUSTER_SWEEP_S.
    sweep_s: float = 2.0


@dataclasses.dataclass
class TenantConfig:
    """Per-tenant fair-share admission (jobs/cluster.py TenantAdmission):
    quotas on the X-Tenant header, 429 + Retry-After at the API tier;
    under clustering the counters live in the claim collection, so every
    engine rejects alike.  0 disables a quota."""

    # Env: LO_TPU_TENANT_MAX_QUEUED.
    max_queued: int = 0
    # Concurrently running fits (executor / distributed classes).
    # Env: LO_TPU_TENANT_MAX_RUNNING.
    max_running: int = 0
    # Env: LO_TPU_TENANT_RETRY_AFTER_S.
    retry_after_s: float = 1.0


@dataclasses.dataclass
class Config:
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    api: APIConfig = dataclasses.field(default_factory=APIConfig)
    jobs: JobConfig = dataclasses.field(default_factory=JobConfig)
    compile_cache: CompileCacheConfig = dataclasses.field(
        default_factory=CompileCacheConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    aot: AotConfig = dataclasses.field(default_factory=AotConfig)
    costs: CostsConfig = dataclasses.field(default_factory=CostsConfig)
    profiling: ProfilingConfig = dataclasses.field(
        default_factory=ProfilingConfig)
    dist: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    rollup: RollupConfig = dataclasses.field(default_factory=RollupConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    flight: FlightConfig = dataclasses.field(default_factory=FlightConfig)
    bundle: BundleConfig = dataclasses.field(default_factory=BundleConfig)
    faults: FaultsConfig = dataclasses.field(default_factory=FaultsConfig)
    ha: HAConfig = dataclasses.field(default_factory=HAConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    tenant: TenantConfig = dataclasses.field(default_factory=TenantConfig)
    # Where every estimator the services build or load lives.
    device: str = "cuda"

    @staticmethod
    def from_env(env=None) -> "Config":
        """Build a config from the LO_TPU_* environment variables."""
        env = os.environ if env is None else env
        cfg = Config()
        fields = (
            ("LO_TPU_STORE_ROOT", cfg.store, "root", str),
            ("LO_TPU_VOLUME_ROOT", cfg.store, "volume_root", str),
            ("LO_TPU_STORE_BACKEND", cfg.store, "backend", str),
            ("LO_TPU_API_PORT", cfg.api, "port", int),
            ("LO_TPU_MAX_WORKERS", cfg.jobs, "max_workers", int),
            ("LO_TPU_JOB_RETRIES", cfg.jobs, "max_preemption_retries", int),
            ("LO_TPU_JOB_BACKOFF_S", cfg.jobs, "retry_backoff_s", float),
            ("LO_TPU_JOB_BACKOFF_MAX_S", cfg.jobs, "retry_backoff_max_s",
             float),
            ("LO_TPU_JOB_DEADLINE_S", cfg.jobs, "deadline_s", float),
            ("LO_TPU_JOB_DRAIN_S", cfg.jobs, "shutdown_drain_s", float),
            ("LO_TPU_SERVE_MAX_BATCH", cfg.serve, "max_batch", int),
            ("LO_TPU_SERVE_MAX_QUEUE", cfg.serve, "max_queue", int),
            ("LO_TPU_SERVE_FLUSH_MS", cfg.serve, "flush_ms", float),
            ("LO_TPU_SERVE_MAX_MODELS", cfg.serve, "max_models", int),
            ("LO_TPU_SERVE_MAX_BYTES", cfg.serve, "max_bytes", int),
            ("LO_TPU_SERVE_RETRY_AFTER", cfg.serve, "retry_after_s", float),
            ("LO_TPU_DECODE_MAX_SLOTS", cfg.decode, "max_slots", int),
            ("LO_TPU_DECODE_MAX_KV", cfg.decode, "max_kv", int),
            ("LO_TPU_DECODE_MAX_STREAMS", cfg.decode, "max_streams", int),
            ("LO_TPU_DECODE_MAX_NEW", cfg.decode, "max_new_tokens", int),
            ("LO_TPU_DECODE_IDLE_S", cfg.decode, "idle_timeout_s", float),
            ("LO_TPU_WORLD_SIZE", cfg.dist, "num_processes", int),
            ("LO_TPU_CPU_RANKS", cfg.dist, "cpu_ranks", int),
            ("LO_TPU_FLEET_MIN", cfg.fleet, "min_replicas", int),
            ("LO_TPU_FLEET_MAX", cfg.fleet, "max_replicas", int),
            ("LO_TPU_FLEET_INTERVAL_S", cfg.fleet, "interval_s", float),
            ("LO_TPU_FLEET_UP_QUEUE_FRAC", cfg.fleet, "up_queue_frac",
             float),
            ("LO_TPU_FLEET_UP_TICKS", cfg.fleet, "up_ticks", int),
            ("LO_TPU_FLEET_DOWN_TICKS", cfg.fleet, "down_ticks", int),
            ("LO_TPU_FLEET_UP_P99_MS", cfg.fleet, "up_p99_ms", float),
            ("LO_TPU_FLEET_UP_SLOPE", cfg.fleet, "up_slope", float),
            ("LO_TPU_FLEET_SLOPE_WINDOW_S", cfg.fleet, "slope_window_s",
             float),
            ("LO_TPU_FLEET_UP_DEVICE_FRAC", cfg.fleet, "up_device_frac",
             float),
            ("LO_TPU_FLEET_LEASE_TIMEOUT_S", cfg.fleet, "lease_timeout_s",
             float),
            ("LO_TPU_FLEET_DEVICES_PER_REPLICA", cfg.fleet,
             "devices_per_replica", int),
            ("LO_TPU_COMPILE_CACHE_ENTRIES", cfg.compile_cache,
             "max_entries", int),
            ("LO_TPU_COMPILE_CACHE_BYTES", cfg.compile_cache, "max_bytes",
             int),
            ("LO_TPU_COMPILE_CACHE_ENTRY_BYTES", cfg.compile_cache,
             "entry_bytes", int),
            ("LO_TPU_AOT_DIR", cfg.aot, "dir", str),
            ("LO_TPU_AOT_MAX_ENTRIES", cfg.aot, "max_entries", int),
            ("LO_TPU_AOT_MAX_BYTES", cfg.aot, "max_bytes", int),
            ("LO_TPU_COSTS_MAX_PROGRAMS", cfg.costs, "max_programs", int),
            ("LO_TPU_COSTS_MAX_JOBS", cfg.costs, "max_jobs", int),
            ("LO_TPU_COSTS_PEAK_FLOPS", cfg.costs, "peak_flops", float),
            ("LO_TPU_PROF_DIR", cfg.profiling, "dir", str),
            ("LO_TPU_PROF_MAX_S", cfg.profiling, "max_seconds", float),
            ("LO_TPU_PROF_MAX_CAPTURES", cfg.profiling, "max_captures",
             int),
            ("LO_TPU_OBS_MAX_SERIES", cfg.obs, "max_series", int),
            ("LO_TPU_OBS_MAX_SPANS", cfg.obs, "max_spans", int),
            ("LO_TPU_ROLLUP_TICK_S", cfg.rollup, "tick_s", float),
            ("LO_TPU_ROLLUP_POINTS", cfg.rollup, "points", int),
            ("LO_TPU_ROLLUP_MAX_SERIES", cfg.rollup, "max_series", int),
            ("LO_TPU_SLO_PREDICT_P99_MS", cfg.slo, "predict_p99_ms", float),
            ("LO_TPU_SLO_DECODE_TTFT_MS", cfg.slo, "decode_ttft_ms", float),
            ("LO_TPU_SLO_FAST_S", cfg.slo, "fast_window_s", float),
            ("LO_TPU_SLO_SLOW_S", cfg.slo, "slow_window_s", float),
            ("LO_TPU_SLO_BURN", cfg.slo, "burn_threshold", float),
            ("LO_TPU_SLO_FOR_S", cfg.slo, "for_s", float),
            ("LO_TPU_SLO_RESOLVE_S", cfg.slo, "resolve_s", float),
            ("LO_TPU_FLIGHT_EVENTS", cfg.flight, "events", int),
            ("LO_TPU_BUNDLE_DIR", cfg.bundle, "dir", str),
            ("LO_TPU_BUNDLE_MAX", cfg.bundle, "max_bundles", int),
            ("LO_TPU_BUNDLE_DEBOUNCE_S", cfg.bundle, "debounce_s", float),
            ("LO_TPU_BUNDLE_PROFILE_S", cfg.bundle, "profile_s", float),
            ("LO_TPU_BUNDLE_JOURNAL_TAIL", cfg.bundle, "journal_tail", int),
            ("LO_TPU_CLUSTER_ENGINE_ID", cfg.cluster, "engine_id", str),
            ("LO_TPU_CLUSTER_HEARTBEAT_S", cfg.cluster, "heartbeat_s",
             float),
            ("LO_TPU_CLUSTER_TTL_S", cfg.cluster, "ttl_s", float),
            ("LO_TPU_CLUSTER_SWEEP_S", cfg.cluster, "sweep_s", float),
            ("LO_TPU_TENANT_MAX_QUEUED", cfg.tenant, "max_queued", int),
            ("LO_TPU_TENANT_MAX_RUNNING", cfg.tenant, "max_running", int),
            ("LO_TPU_TENANT_RETRY_AFTER_S", cfg.tenant, "retry_after_s",
             float),
            ("LO_HA_PEER", cfg.ha, "peer", str),
            ("LO_HA_FENCE_INTERVAL", cfg.ha, "fence_interval_s", float),
            ("LO_HA_REJOIN_INTERVAL", cfg.ha, "rejoin_interval_s", float),
            ("LO_HA_REJOIN_MISSES", cfg.ha, "rejoin_misses", int),
        )
        for key, section, attr, cast in fields:
            if key in env:
                setattr(section, attr, cast(env[key]))
        for key, section, attr in (
                ("LO_TPU_JOB_JOURNAL", cfg.jobs, "journal"),
                ("LO_TPU_JOB_JOURNAL_RECOVER", cfg.jobs, "journal_recover"),
                ("LO_TPU_DECODE_ENABLED", cfg.decode, "enabled"),
                ("LO_TPU_FLEET_ENABLED", cfg.fleet, "enabled"),
                ("LO_TPU_AOT_REPLICA_PREWARM", cfg.aot, "replica_prewarm"),
                ("LO_TPU_AOT_ENABLED", cfg.aot, "enabled"),
                ("LO_TPU_AOT_PREWARM", cfg.aot, "prewarm"),
                ("LO_TPU_COSTS_ENABLED", cfg.costs, "enabled"),
                ("LO_TPU_COSTS_DEEP", cfg.costs, "deep"),
                ("LO_TPU_OBS_ENABLED", cfg.obs, "enabled"),
                ("LO_TPU_OBS_TRACE", cfg.obs, "trace"),
                ("LO_TPU_ROLLUP_ENABLED", cfg.rollup, "enabled"),
                ("LO_TPU_SLO_ENABLED", cfg.slo, "enabled"),
                ("LO_TPU_FLIGHT_ENABLED", cfg.flight, "enabled"),
                ("LO_TPU_BUNDLE_ENABLED", cfg.bundle, "enabled"),
                ("LO_TPU_BUNDLE_PROFILE", cfg.bundle, "profile"),
                ("LO_TPU_CLUSTER_ENABLED", cfg.cluster, "enabled"),
                ("LO_HA_AUTO_REJOIN", cfg.ha, "auto_rejoin")):
            if key in env:
                setattr(section, attr, _bool_env(key, env[key]))
        if "LO_TPU_JOB_JOURNAL_MAX" in env:
            cfg.jobs.journal_max_records = int(env["LO_TPU_JOB_JOURNAL_MAX"])
        for key, section, attr in (
                ("LO_TPU_TASK_COORDINATOR", cfg.dist, "task_coordinator"),
                ("LO_TPU_DIST_STAGE_ROOT", cfg.dist, "stage_root"),
                ("LO_TPU_MONITORING_EXTERNAL_HOST", cfg.api,
                 "monitoring_external_host")):
            if key in env:
                setattr(section, attr, env[key] or None)
        if "LO_TPU_JOB_WEIGHTS" in env:
            cfg.jobs.class_weights = {
                str(k): int(v)
                for k, v in json.loads(env["LO_TPU_JOB_WEIGHTS"]).items()
            }
        def fraction(key: str) -> float:
            # A typo'd rate or target must not silently clamp.
            value = float(env[key])
            if not 0.0 <= value <= 1.0:
                raise ValueError(
                    f"{key}={env[key]!r} must be a fraction in [0.0, 1.0]")
            return value

        for key, section, attr in (
                ("LO_TPU_COSTS_SAMPLE", cfg.costs, "sample"),
                ("LO_TPU_OBS_TRACE_SAMPLE", cfg.obs, "trace_sample"),
                ("LO_TPU_SLO_AVAILABILITY", cfg.slo, "availability_target"),
                ("LO_TPU_SLO_PREDICT_TARGET", cfg.slo, "predict_target"),
                ("LO_TPU_SLO_JOB_SUCCESS", cfg.slo, "job_success_target"),
                ("LO_TPU_SLO_DECODE_TTFT_TARGET", cfg.slo,
                 "decode_ttft_target")):
            if key in env:
                setattr(section, attr, fraction(key))
        # A target of 1.0 leaves no error budget to burn.
        for key, value in (
                ("LO_TPU_SLO_AVAILABILITY", cfg.slo.availability_target),
                ("LO_TPU_SLO_PREDICT_TARGET", cfg.slo.predict_target),
                ("LO_TPU_SLO_JOB_SUCCESS", cfg.slo.job_success_target),
                ("LO_TPU_SLO_DECODE_TTFT_TARGET",
                 cfg.slo.decode_ttft_target)):
            if value >= 1.0:
                raise ValueError(
                    f"{key}={value!r} leaves no error budget — SLO "
                    "targets must be < 1.0")
        if "LO_TPU_SLO_WEBHOOK" in env:
            cfg.slo.webhook = env["LO_TPU_SLO_WEBHOOK"].strip()
        if "LO_TPU_ROLLUP_FAMILIES" in env:
            cfg.rollup.families = tuple(
                t.strip() for t in env["LO_TPU_ROLLUP_FAMILIES"].split(",")
                if t.strip())
        if "LO_TPU_OBS_BUCKETS_MS" in env:
            edges = tuple(float(t) for t in env["LO_TPU_OBS_BUCKETS_MS"]
                          .split(",") if t.strip())
            if not edges or list(edges) != sorted(edges):
                raise ValueError(
                    "LO_TPU_OBS_BUCKETS_MS must be a non-empty ascending "
                    "comma-separated list of milliseconds")
            cfg.obs.latency_buckets_ms = edges
        # Fault-injection schedules: every LO_TPU_FAULT_<POINT> var is
        # carried verbatim; the API server arms them (bad specs are
        # refused there, loudly).
        for key, raw in env.items():
            if key.startswith("LO_TPU_FAULT_") and raw.strip():
                cfg.faults.specs[key[len("LO_TPU_FAULT_"):]] = raw
        cfg.fleet.validate()
        return cfg


#: Knobs read straight from the environment at their use site instead
#: of through :meth:`Config.from_env`: the log level applies before any
#: config is built, and the lock witness's switches are read while the
#: modules that construct locks import (this one among them).  They are
#: registered here because config.py is the port's knob index: the
#: drift gate (analysis/drift.py) fails any ``LO_TPU_*`` reference this
#: file does not name.
DIRECT_ENV_KNOBS = (
    "LO_TPU_LOG_LEVEL",        # log.py: root level, default INFO
    "LO_TPU_WITNESS",          # concurrency_rt.py: "1" instruments the
                               # make_lock/make_rlock locks
    "LO_TPU_WITNESS_STALL_S",  # stall-watchdog threshold (default 30)
    "LO_TPU_WITNESS_DUMP",     # path: the witnessed-order graph as JSON
                               # at exit, for run_checks(witness_dump=)
)

_config: Config | None = None
_config_lock = make_lock("config._config_lock")


def get_config() -> Config:
    """The process-wide config (from the environment on first use): the
    compile cache and the cost ledgers size themselves from it."""
    global _config
    with _config_lock:
        if _config is None:
            _config = Config.from_env()
        return _config


def set_config(cfg: Config) -> None:
    """Replace the process-wide config (a promoted standby serves its
    replica root through it)."""
    global _config
    with _config_lock:
        _config = cfg


def _bool_env(key: str, value: str) -> bool:
    raw = value.strip().lower()
    if raw in ("1", "true", "yes", "on"):
        return True
    if raw in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(
        f"{key}={value!r} is not a recognized boolean "
        "(use 1/0, true/false, yes/no, on/off)"
    )
