"""Configuration — port of the serving part of
``learningorchestra_tpu/config.py``: ``ServeConfig`` with the same
defaults and the same ``LO_TPU_SERVE_*`` environment names, plus the
volume root the port's API server reads artifacts from."""

from __future__ import annotations

import dataclasses
import os


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
class Config:
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    # Artifact volumes (store/volumes.py).  Env: LO_TPU_VOLUME_ROOT.
    volume_root: str = "~/.learningorchestra_tpu_torch/volumes"

    @staticmethod
    def from_env(env=None) -> "Config":
        env = os.environ if env is None else env
        cfg = Config()
        if "LO_TPU_VOLUME_ROOT" in env:
            cfg.volume_root = env["LO_TPU_VOLUME_ROOT"]
        if "LO_TPU_SERVE_MAX_BATCH" in env:
            cfg.serve.max_batch = int(env["LO_TPU_SERVE_MAX_BATCH"])
        if "LO_TPU_SERVE_MAX_QUEUE" in env:
            cfg.serve.max_queue = int(env["LO_TPU_SERVE_MAX_QUEUE"])
        if "LO_TPU_SERVE_FLUSH_MS" in env:
            cfg.serve.flush_ms = float(env["LO_TPU_SERVE_FLUSH_MS"])
        if "LO_TPU_SERVE_MAX_MODELS" in env:
            cfg.serve.max_models = int(env["LO_TPU_SERVE_MAX_MODELS"])
        if "LO_TPU_SERVE_MAX_BYTES" in env:
            cfg.serve.max_bytes = int(env["LO_TPU_SERVE_MAX_BYTES"])
        if "LO_TPU_SERVE_RETRY_AFTER" in env:
            cfg.serve.retry_after_s = float(
                env["LO_TPU_SERVE_RETRY_AFTER"]
            )
        return cfg
