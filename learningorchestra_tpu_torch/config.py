"""Configuration — port of the parts of ``learningorchestra_tpu/config.py``
the port runs: ``StoreConfig``, ``APIConfig``, ``JobConfig`` (with the job journal's
switches), ``ServeConfig``, ``DecodeConfig`` and ``DistributedConfig``, with the same
fields, defaults and ``LO_TPU_*`` environment names, plus the ``device``
every entry point runs on and ``DistributedConfig.cpu_ranks``, the rank
devices a CPU context gives a distributed fit.

The default roots are the port's own (``~/.learningorchestra_tpu_torch``),
so the two packages never share a store by accident; pointing both at
one root works, since the WAL format is the same.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


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
    # Document-store engine: "auto" | "python" (the same WAL store);
    # "native" names the JAX package's C++ store, which is not ported.
    # Env: LO_TPU_STORE_BACKEND.
    backend: str = "auto"

    def store_path(self) -> Path:
        return Path(os.path.expanduser(self.root))

    def volume_path(self) -> Path:
        return Path(os.path.expanduser(self.volume_root))


@dataclasses.dataclass
class APIConfig:
    """REST front server (the address is ``start_background``'s)."""

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
    # Default wall-clock deadline per dispatched job; <= 0 disables.
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
class Config:
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    api: APIConfig = dataclasses.field(default_factory=APIConfig)
    jobs: JobConfig = dataclasses.field(default_factory=JobConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    dist: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
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
            ("LO_TPU_MAX_WORKERS", cfg.jobs, "max_workers", int),
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
        )
        for key, section, attr, cast in fields:
            if key in env:
                setattr(section, attr, cast(env[key]))
        for key, section, attr in (
                ("LO_TPU_JOB_JOURNAL", cfg.jobs, "journal"),
                ("LO_TPU_JOB_JOURNAL_RECOVER", cfg.jobs, "journal_recover"),
                ("LO_TPU_DECODE_ENABLED", cfg.decode, "enabled")):
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
        return cfg


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
