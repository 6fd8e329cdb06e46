"""ModelRegistry — port of ``learningorchestra_tpu/serve/registry.py``.

Loads a trained artifact once, places its parameters on the device and
keeps them resident across requests:

- LRU with BOTH an entry cap and a byte cap (real bytes: the sum of the
  module's parameter and buffer ``nbytes``);
- per-name load coalescing: concurrent first requests for one model pay
  a single artifact read + device upload;
- invalidation: a load in flight for an invalidated/unloaded name serves
  its caller but is never cached.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable


class ServeError(Exception):
    """Model cannot be served (bad artifact, bad input) → 406."""


class _Resident:
    __slots__ = ("name", "estimator", "nbytes", "loaded_at", "requests",
                 "replica_devices", "warm_shapes", "decode_warm",
                 "apply_fns", "apply_costs")

    def __init__(self, name, estimator, nbytes):
        self.name = name
        self.estimator = estimator
        self.nbytes = nbytes
        self.loaded_at = time.time()
        self.requests = 0
        # replica index -> device id ("host" when unplaced), mirrored in
        # by the fleet manager after every scale event; empty for a
        # single-path model.
        self.replica_devices: dict = {}
        # bucket rows -> (padded shape, dtype str) of every bucket this
        # model dispatched: the set a fresh replica is pre-warmed on.
        self.warm_shapes: dict = {}
        # (slot bucket, KV bucket) -> True for every decode step this
        # model ran (serve/decode/engine.py); dies with the entry, so an
        # invalidation never replays a stale architecture's shapes.
        self.decode_warm: dict = {}
        # bucket rows -> the cached ``apply`` program (train/
        # compile_cache.py) and its ProgramCost (False: none recorded),
        # resolved once per bucket, never per request.
        self.apply_fns: dict = {}
        self.apply_costs: dict = {}

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "module": type(self.estimator.module).__name__,
            "paramBytes": self.nbytes,
            "loadedAt": self.loaded_at,
            "requests": self.requests,
            "device": str(self.estimator.device),
            "replicaDevices": {
                str(k): v for k, v in self.replica_devices.items()
            },
        }


class ModelRegistry:
    """name → resident model, LRU over entry count and parameter bytes.

    ``loader`` maps an artifact name to an estimator; the registry only
    owns residency.
    """

    def __init__(
        self,
        loader: Callable[[str], Any],
        *,
        device,
        max_models: int = 4,
        max_bytes: int = 1 << 30,
        on_evict: Callable[[str], None] | None = None,
    ):
        self._loader = loader
        self.device = device
        # Fired (outside the registry lock) with each LRU-evicted model's
        # name, so per-model state (the MicroBatcher thread) dies with it.
        self._on_evict = on_evict
        self.max_models = int(max_models)
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[str, _Resident] = OrderedDict()
        self._lock = threading.Lock()
        self._loading: dict[str, threading.Event] = {}
        self._doomed: set[str] = set()
        self.loads = 0
        self.evictions = 0
        self.invalidations = 0

    # -- internals -----------------------------------------------------------

    def _place(self, estimator) -> int:
        """Move the module to the device once; returns its bytes."""
        module = getattr(estimator, "module", None)
        if module is None:
            raise ServeError("artifact holds no model module")
        module.to(self.device)
        estimator.device = self.device
        return sum(
            t.numel() * t.element_size()
            for t in (*module.parameters(), *module.buffers())
        )

    def _evict_locked(self) -> list[str]:
        def total():
            return sum(e.nbytes for e in self._entries.values())

        evicted: list[str] = []
        while self._entries and (
            len(self._entries) > self.max_models
            or total() > self.max_bytes
        ):
            if len(self._entries) == 1:
                break  # never evict the entry just loaded
            name, _ = self._entries.popitem(last=False)
            evicted.append(name)
            self.evictions += 1
        return evicted

    # -- public surface ------------------------------------------------------

    def get(self, name: str) -> _Resident:
        """Resident entry for ``name``, loading (once, under concurrent
        callers) on a miss."""
        while True:
            with self._lock:
                entry = self._entries.get(name)
                if entry is not None:
                    self._entries.move_to_end(name)
                    return entry
                pending = self._loading.get(name)
                if pending is None:
                    pending = self._loading[name] = threading.Event()
                    break
            pending.wait()
        try:
            estimator = self._loader(name)
            nbytes = self._place(estimator)
            entry = _Resident(name, estimator, nbytes)
        except BaseException:
            with self._lock:
                ev = self._loading.pop(name, None)
                self._doomed.discard(name)
            if ev is not None:
                ev.set()
            raise
        with self._lock:
            ev = self._loading.pop(name, None)
            self.loads += 1
            if name in self._doomed:
                # Invalidated mid-load: serve THIS caller from what was
                # read, never cache it.
                self._doomed.discard(name)
                evicted = []
            else:
                self._entries[name] = entry
                self._entries.move_to_end(name)
                evicted = self._evict_locked()
        if ev is not None:
            ev.set()
        for victim in evicted:
            if self._on_evict is not None:
                try:
                    self._on_evict(victim)
                except Exception:  # noqa: BLE001 — never fail a load
                    pass
        return entry

    def peek(self, name: str) -> _Resident | None:
        """Resident entry or None; never loads."""
        with self._lock:
            return self._entries.get(name)

    def unload(self, name: str) -> bool:
        with self._lock:
            if name in self._loading:
                self._doomed.add(name)
                return True
            return self._entries.pop(name, None) is not None

    def invalidate(self, name: str) -> bool:
        """Drop a resident model whose artifact changed; a load in flight
        for the name is doomed."""
        with self._lock:
            hit = self._entries.pop(name, None) is not None
            if name in self._loading:
                self._doomed.add(name)
                hit = True
            if hit:
                self.invalidations += 1
            return hit

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._doomed.update(self._loading)

    def list(self) -> list[dict]:
        with self._lock:
            return [e.to_dict() for e in self._entries.values()]

    def stats(self) -> dict:
        with self._lock:
            return {
                "residentModels": len(self._entries),
                "maxModels": self.max_models,
                "residentBytes": sum(
                    e.nbytes for e in self._entries.values()
                ),
                "maxBytes": self.max_bytes,
                "loads": self.loads,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
