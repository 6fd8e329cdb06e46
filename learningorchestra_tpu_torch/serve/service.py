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
servable under its name.  The JAX service's compile cache, cost probes,
faults, fleet and decode engine come with later slices.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from learningorchestra_tpu_torch.config import ServeConfig
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.serve.batcher import MicroBatcher
from learningorchestra_tpu_torch.serve.registry import ModelRegistry, ServeError
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.toolkit.registry import RegistryError
from learningorchestra_tpu_torch.train.neural import is_artifact, load_artifact

#: An artifact type of the ``binaries`` volume, where every train (and
#: tune) job's estimator artifact lives, whatever its tool.
ARTIFACT_TYPE = "train/pytorch"


class NotFoundError(Exception):
    """No artifact of that name → 404."""


class ServingService:
    def __init__(self, volumes: VolumeStorage, config: ServeConfig | None = None,
                 *, device="cuda"):
        self.volumes = volumes
        self.cfg = config or ServeConfig()
        self.device = resolve_device(device)
        self.registry = ModelRegistry(
            self._load_estimator,
            device=self.device,
            max_models=self.cfg.max_models,
            max_bytes=self.cfg.max_bytes,
            on_evict=self._drop_batcher,
        )
        self._batchers: dict[str, MicroBatcher] = {}
        self._lock = threading.Lock()
        self._closed = False

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
        """Pin ``name`` resident (idempotent)."""
        return self.registry.get(name).to_dict()

    def unload(self, name: str) -> bool:
        self._drop_batcher(name)
        return self.registry.unload(name)

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
                batcher = self._batchers[name] = MicroBatcher(
                    lambda padded, _n=name: self._dispatch(_n, padded),
                    max_batch=self.cfg.max_batch,
                    max_queue=self.cfg.max_queue,
                    flush_ms=self.cfg.flush_ms,
                    name=name,
                )
            return batcher

    def _dispatch(self, name: str, padded: np.ndarray) -> np.ndarray:
        """Run one padded bucket; returns the host array.  Resolving the
        entry HERE means an invalidation between requests serves the
        reloaded artifact, never a stale module."""
        entry = self.registry.get(name)
        return entry.estimator.apply(padded)

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
        out = self._batcher_for(name).submit(x)
        entry.requests += 1
        dt = time.perf_counter() - t0
        return {
            "model": name,
            "predictions": out.tolist(),
            "latencyMs": round(dt * 1e3, 3),
        }

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            per_model = {
                name: b.stats() for name, b in self._batchers.items()
            }
        return {
            "registry": self.registry.stats(),
            "models": per_model,
            "config": {
                "maxBatch": self.cfg.max_batch,
                "maxQueue": self.cfg.max_queue,
                "flushMs": self.cfg.flush_ms,
                "maxModels": self.cfg.max_models,
                "maxBytes": self.cfg.max_bytes,
                "retryAfterS": self.cfg.retry_after_s,
            },
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for batcher in batchers:
            batcher.close()
        self.registry.clear()
