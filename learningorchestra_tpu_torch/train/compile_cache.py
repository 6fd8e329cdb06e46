"""Process-wide program cache — build once, run many — port of
``learningorchestra_tpu/train/compile_cache.py``.

Every train, tune, predict, serve and decode job resolves the programs it
runs through one cache, keyed by a canonical fingerprint of the program:

  (program kind, model architecture, optimizer spec, loss kind, compute
   dtype, batch/dataset shape, donation flag, mesh layout)

A program here is a callable that takes the module (or the estimator that
holds it) and its inputs as ARGUMENTS: it never closes over one model's
weights, so two estimators of one architecture share it and each still
computes with its own parameters.  Most programs are eager PyTorch; the
decode step's program captures a CUDA graph per page pool on the card
(``serve/decode/pages.py``).  On a hit the caller gets the program a
previous job built; on a miss the builder runs once and concurrent callers
for the same key (tune candidates) coalesce onto that one build.

Fingerprinting a ``torch.nn.Module`` (:func:`module_fingerprint`) covers
every submodule's path, qualified class name and ``extra_repr()``, every
parameter's and buffer's name, shape and dtype, and each submodule's
non-tensor configuration attributes (heads, ``causal``, ``window``,
``rope``, GQA groups, ``max_len``, activations by qualified name), so two
modules with equal parameter shapes but different head counts never
share a key.  An optimizer given as an object, or a lambda, keys on a
serial number of its own that is never reused: never a false hit, merely
uncached across jobs.

The cache clears itself when the visible set of CUDA devices changes
(index, name, capability; ``()`` on a host without a card), and a build
still in flight across that change is handed to its caller but never
inserted.  Durable warm start (train/aot_store.py): a miss consults the
on-disk store before building, and the boot pre-warm installs the store's
hot set through :meth:`CompiledProgramCache.install`, so lookups resolve
restored programs as hits.  A key is offered to the store only when it
survives the process (:func:`persistable`): one holding an opaque serial
or an object address names this process's objects.  Every live build
passes the ``compile.build`` fault point first (faults/plane.py), is a
``compile`` span of the calling job's trace (obs/tracing.py; a restore
from the durable store records none) and an entry of the ``compile``
flight ring, ``build`` or ``aot_restore``.  Counters surface at ``GET /monitoring/<tool>/compileCache``,
as per-job deltas in train and tune metadata (services/executor.py) and
as tfevents scalars of monitored distributed jobs.  Sizing knobs:
``config.CompileCacheConfig`` (``LO_TPU_COMPILE_CACHE_*``).
"""

from __future__ import annotations

import hashlib
import itertools
import re
import sys
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.obs import flight as obs_flight
from learningorchestra_tpu_torch.obs import tracing

__all__ = [
    "CompiledProgramCache",
    "Program",
    "apply_program_key",
    "canonical",
    "counters_snapshot",
    "delta_since",
    "enabled",
    "fingerprint",
    "get_cache",
    "mesh_fingerprint",
    "module_fingerprint",
    "optimizer_fingerprint",
    "persistable",
    "program_key",
    "reset_cache",
    "warm_fingerprint",
]


def _costs():
    """Lazy cost-ledger handle (obs/costs.py): every build notes a
    ProgramCost entry, and inserts charge a measured size against the
    byte cap when an analysis produced one."""
    from learningorchestra_tpu_torch.obs import costs

    return costs


def _aot():
    """Lazy durable-store handle (train/aot_store.py): a miss consults the
    on-disk store before building."""
    from learningorchestra_tpu_torch.train import aot_store

    return aot_store


# -- canonical fingerprinting -------------------------------------------------

_serials = itertools.count(1)
_opaque_tokens: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_opaque_lock = threading.Lock()


def _opaque(obj: Any) -> tuple:
    """A serial number for ``obj`` that no other object ever gets: the key
    of an object whose behaviour cannot be fingerprinted.  An object that
    cannot be weakly referenced gets a fresh serial at every call (its id
    could be reused once it dies): never a hit, merely uncached."""
    with _opaque_lock:
        try:
            serial = _opaque_tokens.get(obj)
            if serial is None:
                serial = _opaque_tokens[obj] = next(_serials)
        except TypeError:  # not weakly referenceable
            serial = next(_serials)
    return ("opaque", serial)


def canonical(obj: Any) -> Any:
    """Reduce ``obj`` to a deterministic, repr-stable structure.

    Handles what a program spec is made of: modules (recursively),
    meshes, dicts and sequences, numpy and torch dtypes, numpy scalars and
    named functions.  Anything else degrades to an opaque serial (never a
    false hit, merely uncacheable across distinct objects)."""
    import numpy as np
    import torch

    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, dict):
        return ("dict", tuple(sorted((str(k), canonical(v))
                                     for k, v in obj.items())))
    if isinstance(obj, (list, tuple)):
        return ("seq", tuple(canonical(v) for v in obj))
    if isinstance(obj, (set, frozenset)):
        return ("set", tuple(sorted(repr(canonical(v)) for v in obj)))
    if isinstance(obj, torch.dtype):
        return ("dtype", str(obj).replace("torch.", ""))
    if isinstance(obj, np.dtype) or (
            isinstance(obj, type) and issubclass(obj, np.generic)):
        return ("dtype", np.dtype(obj).name)
    if isinstance(obj, torch.nn.Module):
        return module_fingerprint(obj)
    # A Mesh exists only once its module is loaded (no import cycle
    # through parallel/ here).
    mesh_mod = sys.modules.get("learningorchestra_tpu_torch.parallel.mesh")
    if mesh_mod is not None and isinstance(obj, mesh_mod.Mesh):
        return mesh_fingerprint(obj)
    if callable(obj):
        # Named functions (an activation kept as a module attribute) key
        # on their qualified name; lambdas and closures cannot be proven
        # equal.
        name = getattr(obj, "__qualname__", "")
        mod = getattr(obj, "__module__", "")
        if name and "<lambda>" not in name and "<locals>" not in name:
            return ("fn", mod, name)
    return _opaque(obj)


_PRIMITIVE = (bool, int, float, str, type(None))


def _config_attrs(mod) -> tuple:
    """A submodule's non-tensor configuration: its public instance
    attributes (heads, ``causal``, ``window``, ``rope``, ``positional``,
    sizes, activations) and the public primitive attributes of its class
    (``remat`` on a rematerialized block)."""
    import torch

    out = []
    for name, val in vars(mod).items():
        if name.startswith("_") or name == "training" or isinstance(
                val, (torch.Tensor, torch.nn.Module, torch.device)):
            continue
        out.append((name, canonical(val)))
    for name, val in vars(type(mod)).items():
        if not name.startswith("_") and isinstance(val, _PRIMITIVE):
            out.append((f"class.{name}", val))
    return tuple(sorted(out, key=lambda kv: kv[0]))


def module_fingerprint(module: Any) -> Any:
    """Canonical spec of a ``torch.nn.Module``: every submodule's path,
    qualified class name, ``extra_repr()`` and configuration attributes,
    and every parameter's and buffer's name, shape and dtype."""
    subs = tuple(
        (path, type(mod).__module__, type(mod).__qualname__,
         mod.extra_repr(), _config_attrs(mod))
        for path, mod in module.named_modules())
    tensors = tuple(
        (kind, name, tuple(t.shape), str(t.dtype))
        for kind, items in (("param", module.named_parameters()),
                            ("buffer", module.named_buffers()))
        for name, t in items)
    return ("module", subs, tensors)


def mesh_fingerprint(mesh: Any) -> Any:
    """Axis names + per-axis sizes + the device list in rank order: two
    jobs share a distributed program only on the SAME devices in the SAME
    order."""
    return (
        "mesh",
        tuple(str(a) for a in mesh.shape),
        tuple(sorted((str(k), int(v)) for k, v in mesh.shape.items())),
        tuple(str(d) for d in mesh.devices),
    )


def optimizer_fingerprint(estimator: Any) -> Any:
    """Optimizer identity as the REST surface expresses it: the
    declarative spec (a name or dict; None is adam) + the learning rate
    (a float or a schedule spec) + accumulation.  An ``OptimizerSpec``
    passed as an object has no spec: it keys on a serial of its own,
    which never matches another object."""
    spec = getattr(estimator, "_optimizer_spec", None)
    if spec is None and getattr(estimator, "optimizer", None) is not None:
        return _opaque(estimator.optimizer)
    return (
        "opt",
        canonical(spec),
        canonical(getattr(estimator, "learning_rate", None)),
        int(getattr(estimator, "_accumulate_steps", 1)),
    )


class ProgramKey(str):
    """A cache key (a sha256 hexdigest) that knows whether it survives the
    process: ``persistable`` is False when its spec held an opaque serial
    (serials restart at 1 in every process, so another process's serial
    can name another object) or an object address."""

    __slots__ = ("persistable",)


#: An address in a ``str()``/``repr()`` (``<function f at 0x7f...>``).
_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


def fingerprint(*parts: Any) -> ProgramKey:
    """Stable digest of canonicalized parts — the cache key."""
    payload = repr(tuple(canonical(p) for p in parts))
    key = ProgramKey(hashlib.sha256(payload.encode()).hexdigest())
    key.persistable = "('opaque', " not in payload and \
        _ADDRESS.search(payload) is None
    return key


def persistable(key) -> bool:
    """Whether ``key`` may be written to the durable store: only keys
    :func:`fingerprint` made from process-independent parts."""
    return bool(getattr(key, "persistable", False))


def program_key(
    kind: str,
    *,
    module: Any,
    optimizer: Any,
    loss: Any,
    dtype: Any,
    shapes: Any = None,
    mesh: Any = None,
    donate: Any = None,
) -> str:
    """Fingerprint one program.  ``optimizer`` should already be a
    canonical token (:func:`optimizer_fingerprint`); ``shapes`` carries
    what the program is specialised to (dataset length, batch size,
    shuffle); ``mesh`` the distributed layout."""
    return fingerprint(
        kind, module, optimizer, str(loss), str(dtype), shapes, mesh,
        donate,
    )


def apply_program_key(module: Any, *, rows: int | None = None) -> str:
    """Key of a pure-inference ``apply`` program: optimizer and loss play
    no part, so every consumer of an architecture shares one program
    family, and ``rows`` is the shape bucket (a serving bucket or
    predict's batch) — the cache's miss counter counts buckets, never
    requests.  Predict and serving both resolve through it."""
    return program_key(
        "apply",
        module=module_fingerprint(module),
        optimizer=None,
        loss="-",
        dtype="-",
        shapes=None if rows is None else ("rows", int(rows)),
    )


def _record_compile_span(built_s: float, label, key: str) -> None:
    """One program build as a ``compile`` span of the calling job's trace
    (nested where it happened, inside the lease); a no-op outside an
    active trace."""
    tracing.record_span("compile", built_s, label=label or "",
                        key=key[:12])


def _device_signature() -> tuple:
    """The visible CUDA devices (index, name, capability); programs that
    hold device state (a captured graph) are invalid once it changes.
    ``()`` on a host without a card."""
    import torch

    try:
        if not torch.cuda.is_available():
            return ()
        return tuple(
            (i, torch.cuda.get_device_name(i),
             tuple(torch.cuda.get_device_capability(i)))
            for i in range(torch.cuda.device_count()))
    except Exception:  # noqa: BLE001 — CUDA not initialized, or lost
        return ()


# -- warm-start hints ---------------------------------------------------------

#: Request knobs that do not shape a program: two submissions differing
#: only here share every program, so the warm hint treats them alike.
_WARM_HINT_EXCLUDE = frozenset((
    "verbose", "description", "monitoring_path", "monitoringPath",
    "checkpoint_dir", "checkpointDir", "resume",
))


def warm_fingerprint(module_path, class_name, method,
                     parameters: dict | None = None) -> str:
    """Program-level warm-start hint for the engine's dispatcher: the
    submitted spec through the cache keys' canonicalizer, minus the knobs
    that never reach a program.  A HINT: exact matching happens inside
    the cache; a collision merely reorders one class's queue."""
    params = {
        k: v for k, v in (parameters or {}).items()
        if k not in _WARM_HINT_EXCLUDE
    }
    return fingerprint(
        "warm", str(module_path), str(class_name), str(method), params
    )


# -- the cache ---------------------------------------------------------------


class _Entry:
    __slots__ = ("value", "nbytes", "label", "built_s", "measured")

    def __init__(self, value, nbytes, label, built_s, measured=False):
        self.value = value
        self.nbytes = nbytes
        self.label = label
        self.built_s = built_s
        # True when nbytes is a MEASURED size (obs/costs) rather than the
        # flat per-entry estimate.
        self.measured = measured


class CompiledProgramCache:
    """LRU cache of programs with build coalescing.

    ``max_entries <= 0`` disables caching (every lookup builds).
    ``max_bytes`` bounds the *estimated* resident size: each entry
    charges ``entry_bytes`` unless the caller or the cost ledger gives a
    better number — a safety valve against unbounded program diversity,
    not an exact accountant.  The newest entry is never evicted."""

    def __init__(
        self,
        max_entries: int = 64,
        max_bytes: int = 2 << 30,
        entry_bytes: int = 32 << 20,
    ):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.entry_bytes = int(entry_bytes)
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._building: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._devices: tuple | None = None
        # Bumped on every device-set clear: a build that STARTED before
        # an invalidation is never inserted after it.
        self._generation = 0
        # Fired (under the cache lock: fast, never calling back into the
        # cache) when the device-set check clears the cache, so dependent
        # state (the engine's warm-start hints) stops claiming programs
        # are built.
        self._invalidation_listeners: list[Callable[[], None]] = []
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.coalesced = 0
        self.invalidations = 0
        self.trace_time_s = 0.0

    # -- internals ----------------------------------------------------------

    def _bytes_locked(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _check_devices_locked(self) -> None:
        sig = _device_signature()
        if self._devices is None:
            self._devices = sig
            return
        if sig != self._devices:
            if self._entries:
                self.invalidations += 1
            self._entries.clear()
            self._devices = sig
            self._generation += 1
            for listener in self._invalidation_listeners:
                try:
                    listener()
                except Exception:  # noqa: BLE001 — never break a lookup
                    pass

    def _evict_locked(self) -> None:
        while self._entries and (
            len(self._entries) > self.max_entries
            or self._bytes_locked() > self.max_bytes
        ):
            if len(self._entries) == 1:
                break  # never evict the entry just inserted
            self._entries.popitem(last=False)
            self.evictions += 1

    # -- public surface -----------------------------------------------------

    def get_or_build(
        self,
        key: str,
        builder: Callable[[], Any],
        *,
        label: str | None = None,
        nbytes: int | None = None,
    ) -> Any:
        """The cached program for ``key``, built (once, even under
        concurrent callers) on a miss."""
        if self.max_entries <= 0:
            with self._lock:
                self.misses += 1
            t0 = time.perf_counter()
            faults.hit("compile.build")
            value = builder()
            built_s = time.perf_counter() - t0
            _record_compile_span(built_s, label, key)
            obs_flight.record("compile", "build", key=key,
                              label=label or "", builtS=round(built_s, 4))
            self._note_cost(key, label, built_s)
            return value
        while True:
            with self._lock:
                self._check_devices_locked()
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return entry.value
                pending = self._building.get(key)
                if pending is None:
                    pending = self._building[key] = threading.Event()
                    build_generation = self._generation
                    break
            # Another thread is building this exact program (tune
            # candidates submit together): wait, then re-check — a hit if
            # it succeeded, our turn to build if it raised.
            pending.wait()
            with self._lock:
                if key in self._entries:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self.coalesced += 1
                    return self._entries[key].value
        t0 = time.perf_counter()
        try:
            # Durable warm start: a stored program satisfies the miss
            # without a build (and, with its cost record, without its
            # first call's FLOP analysis); any bad blob returns None and
            # the live build proceeds as if no store existed.
            value = self._aot_restore(key, label)
            restored = value is not None
            if not restored:
                # Chaos probe on the build path only: hits stay untouched.
                faults.hit("compile.build")
                value = builder()
        except BaseException:
            with self._lock:
                ev = self._building.pop(key, None)
            if ev is not None:
                ev.set()
            raise
        built_s = time.perf_counter() - t0
        if not restored:
            # A restored program records no compile span: the restart
            # drill holds pre-warmed keys to zero builds.
            _record_compile_span(built_s, label, key)
        obs_flight.record("compile", "aot_restore" if restored else "build",
                          key=key, label=label or "",
                          builtS=round(built_s, 4))
        self._note_cost(key, label, built_s)
        measured = False
        if nbytes is None:
            nbytes = self._measured_bytes(key)
            measured = nbytes is not None
        with self._lock:
            ev = self._building.pop(key, None)
            self.misses += 1
            if not restored:
                self.trace_time_s += built_s
            if build_generation == self._generation:
                self._entries[key] = _Entry(
                    value,
                    self.entry_bytes if nbytes is None else int(nbytes),
                    label, built_s, measured=measured)
                self._entries.move_to_end(key)
                self._evict_locked()
            # else: the device set changed while this build was in
            # flight: hand it to THIS caller only, never cache it.
        if ev is not None:
            ev.set()
        return value

    @staticmethod
    def _aot_restore(key: str, label):
        """The program ``key``'s stored blob restores to, or None (build
        live).  Never raises: a broken store must not break the build path
        it shortcuts."""
        try:
            store = _aot().get_store()
            if store is None:
                return None
            stored = store.load(key)
            if stored is None:
                return None
            return restore(key, stored, label=label)
        except Exception:  # noqa: BLE001
            return None

    def install(self, key: str, value, *, label: str | None = None,
                nbytes: int | None = None) -> bool:
        """Install an externally built program (the boot pre-warm's
        restored ones, services/context.py) WITHOUT counting a hit or
        a miss.  Respects the device-set check and eviction; a resident
        key wins.  True when the key is resident afterwards."""
        if self.max_entries <= 0:
            return False
        with self._lock:
            self._check_devices_locked()
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            self._entries[key] = _Entry(
                value,
                self.entry_bytes if nbytes is None else int(nbytes),
                label, 0.0, measured=nbytes is not None)
            self._entries.move_to_end(key)
            self._evict_locked()
            return key in self._entries

    @staticmethod
    def _note_cost(key: str, label, built_s: float) -> None:
        """Every build lands a ProgramCost ledger entry; never fails a
        build."""
        try:
            _costs().note_build(key, label, built_s)
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _measured_bytes(key: str):
        try:
            return _costs().serialized_bytes(key)
        except Exception:  # noqa: BLE001
            return None

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def add_invalidation_listener(self, listener: Callable[[], None]):
        """Register a callback fired when a device-set change clears the
        cache (under the cache lock: fast, never calling back into the
        cache).  Pair with :meth:`remove_invalidation_listener`."""
        with self._lock:
            self._invalidation_listeners.append(listener)

    def remove_invalidation_listener(self, listener) -> None:
        with self._lock:
            try:
                self._invalidation_listeners.remove(listener)
            except ValueError:
                pass

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        """Counter snapshot for the monitoring endpoint and tfevents."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "maxEntries": self.max_entries,
                "bytesEstimate": self._bytes_locked(),
                "maxBytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "coalesced": self.coalesced,
                "deviceInvalidations": self.invalidations,
                "traceTimeS": round(self.trace_time_s, 4),
                "measuredEntries": sum(
                    1 for e in self._entries.values() if e.measured),
                "programs": [
                    e.label for e in self._entries.values() if e.label],
                "entries_detail": [
                    {
                        "key": key[:12],
                        "label": e.label,
                        "bytes": e.nbytes,
                        "measured": e.measured,
                        "builtS": round(e.built_s, 4),
                    }
                    for key, e in self._entries.items()
                ],
            }


# -- process-wide singleton ---------------------------------------------------

_cache: CompiledProgramCache | None = None
_cache_lock = threading.Lock()


def get_cache() -> CompiledProgramCache:
    """The process-wide cache, sized from the config
    (``LO_TPU_COMPILE_CACHE_*``)."""
    global _cache
    with _cache_lock:
        if _cache is None:
            from learningorchestra_tpu_torch.config import get_config

            cc = get_config().compile_cache
            _cache = CompiledProgramCache(
                max_entries=cc.max_entries,
                max_bytes=cc.max_bytes,
                entry_bytes=cc.entry_bytes,
            )
        return _cache


def reset_cache(**overrides) -> CompiledProgramCache:
    """Replace the singleton (tests; or re-size after a config change)."""
    global _cache
    with _cache_lock:
        if overrides:
            _cache = CompiledProgramCache(**overrides)
            return _cache
        _cache = None
    return get_cache()


# -- per-job accounting -------------------------------------------------------

_COUNTER_KEYS = ("hits", "misses", "evictions", "coalesced", "traceTimeS")


def enabled() -> bool:
    """False when the operator disabled caching
    (``LO_TPU_COMPILE_CACHE_ENTRIES=0``): nothing is ever warm then."""
    return get_cache().max_entries > 0


def counters_snapshot() -> dict:
    stats = get_cache().stats()
    return {k: stats[k] for k in _COUNTER_KEYS}


def delta_since(before: dict) -> dict:
    """Counter delta for one job.  Counters are process-wide, so under
    concurrent jobs a delta attributes overlapping activity — exact for
    serial submissions, an upper bound otherwise."""
    now = counters_snapshot()
    out = {k: now[k] - before.get(k, 0) for k in _COUNTER_KEYS}
    out["traceTimeS"] = round(out["traceTimeS"], 4)
    return out


class Program:
    """A cached program: ``fn``, a callable over the module (or the
    estimator holding it) and its inputs — never closing over one model's
    weights — and the ``key`` its costs are recorded under.  Its first
    call runs under the cost plane's FLOP counter
    (``obs.costs.analyze_program``, which offers the program and its cost
    record to the durable store) unless ``analyze`` is off; a program that
    is never analyzed is offered when it is made."""

    __slots__ = ("fn", "key", "label", "analyze", "analyzed")

    def __init__(self, fn, key: str, label: str, *, analyze: bool = True):
        self.fn = fn
        self.key = key
        self.label = label
        self.analyze = analyze
        self.analyzed = not analyze
        if not analyze:
            _aot().offer_program(key, label, fn=fn, analyze=False)

    def __call__(self, *args):
        if self.analyzed:
            return self.fn(*args)
        self.analyzed = True
        return _costs().analyze_program(self.key, self.label, self.fn, args)

    def cost(self):
        """This program's ProgramCost, or None (costs off, not built)."""
        costs = _costs()
        return costs.get_ledger().get(self.key) if costs.enabled() else None


class _Restored(Program):
    """A program restored from the durable store.  Its cost record was
    seeded from the blob, so it runs no FLOP analysis and offers nothing.

    Unlike the JAX package's ``_AOTRestored``, a call that raises is NOT
    rebuilt and retried: the restored function is the very table entry a
    live build would use, so a rebuild re-runs the same code, and a
    program that mutates its arguments (an epoch program's weights and
    optimizer state) would apply its first steps twice.  The failure
    counts ``callFallbacks`` and raises as a live program's would; a
    renamed or missing function is refused at load (``aot_store``)."""

    __slots__ = ()

    def __init__(self, fn, key: str, label: str, *, analyze: bool):
        self.fn = fn
        self.key = key
        self.label = label
        self.analyze = analyze
        self.analyzed = True

    def __call__(self, *args):
        try:
            return self.fn(*args)
        except Exception:
            try:
                store = _aot().get_store()
                if store is not None:
                    store.note_call_fallback()
            except Exception:  # noqa: BLE001 — accounting only
                pass
            raise


def restore(key: str, stored, *, label: str | None = None):
    """The program a validated blob (``aot_store.StoredProgram``) stands
    for: a :class:`_Restored` program whose cost record seeds the ledger
    (marked analyzed), or a decode step's ``DecodeStepProgram`` (its cell
    noted for the decoders of its architecture)."""
    label = label or stored.label or ""
    if stored.kind == "decode_step":
        from learningorchestra_tpu_torch.serve.decode.pages import (
            DecodeStepProgram,
        )

        _aot().note_restored_cell(stored.arch, stored.cell)
        return DecodeStepProgram(*stored.cell)
    if stored.cost is not None:
        _costs().seed(key, label, stored.cost)
    return _Restored(stored.fn, key, label, analyze=stored.analyze)
