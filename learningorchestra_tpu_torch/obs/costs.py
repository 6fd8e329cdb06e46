"""Cost accounting: per-program FLOPs ledgers and device-time attribution
— port of ``learningorchestra_tpu/obs/costs.py``.

Two ledgers, both process-wide singletons sized from
``config.CostsConfig`` (``LO_TPU_COSTS_*``):

- :class:`CostLedger` — one :class:`ProgramCost` per program fingerprint
  (train/compile_cache.py).  :func:`analyze_program` runs ONE real call of
  a program under a FLOP-counting dispatch mode (:func:`_flop_counter`:
  ``torch.utils.flop_counter``'s formulas, per thread) and records its
  FLOPs; with ``deep`` on it also records the bytes of the call's tensor
  arguments and, on a card, the call's peak allocation above what was
  resident before it when the call raised the process's peak
  (``max_memory_allocated``, never reset).  A program made of equal
  units (an epoch's steps) calls :func:`repeats` after its first unit:
  the count stops there and is scaled, so the counter's per-operator cost
  is paid once.  What a PyTorch program cannot report — the bytes it
  moves (``bytesAccessed``), a serialized executable's size
  (``serializedBytes``) — stays None, never a made-up number.
  The counter sees aten operators only, so the hand-written kernels
  K1–K3 add their FLOPs by formula (:func:`note_kernel_flops`: 4, 6 and
  8 · B·H·D · the (query, key) pairs the causal and window masks leave
  live) and their plain versions run uncounted (:func:`uncounted`): a
  program's FLOPs are the same on the CPU and on the card.  The compile
  cache calls :func:`note_build` on EVERY build, so every program has an
  entry even when nothing analyzed it.  With the durable program store on
  (train/aot_store.py), each analysis offers its record there, and a
  program restored from the store seeds its entry (:func:`seed`, marked
  analyzed), so its first call skips the FLOP counter.

- :class:`DeviceTimeLedger` — sampled per-dispatch attribution.  Dispatch
  sites (the fit's epoch loop, the serving dispatch, the decode engine's
  host syncs) call :func:`attribute` / :meth:`DeviceTimeLedger.record_model`
  with the device interval (CUDA events on a card, the host clock on the
  CPU) and the program's cost; the ledger accumulates device seconds,
  FLOPs and bytes per job (a bounded ring), per served model and per
  (model, bucket), and model-FLOPs-utilization is ``flops / (device_s *
  peak_flops)`` when the operator configured the card's peak
  (``LO_TPU_COSTS_PEAK_FLOPS``; an unknown peak reports no MFU).
  ``LO_TPU_COSTS_SAMPLE`` thins the hook deterministically per key.

Everything here is off with ``LO_TPU_COSTS_ENABLED=0``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
import threading
import time
import types
from collections import Counter, OrderedDict

from learningorchestra_tpu_torch.concurrency_rt import make_lock

__all__ = [
    "CostLedger",
    "DeviceTimeLedger",
    "Interval",
    "ProgramCost",
    "analyze_program",
    "attribute",
    "attention_pairs",
    "counting",
    "devtime",
    "enabled",
    "get_ledger",
    "job_scope",
    "job_summary",
    "mfu",
    "note_build",
    "note_kernel_flops",
    "repeats",
    "reset",
    "seed",
    "serialized_bytes",
    "serving_totals",
    "snapshot",
    "uncounted",
]


@dataclasses.dataclass
class ProgramCost:
    """What ONE execution of a program costs.  ``None`` fields mean
    "not measured" — never made up."""

    key: str
    label: str = ""
    flops: float | None = None
    bytes_accessed: float | None = None
    argument_bytes: int | None = None
    output_bytes: int | None = None
    temp_bytes: int | None = None
    generated_code_bytes: int | None = None
    serialized_bytes: int | None = None
    built_s: float = 0.0
    builds: int = 0
    analyzed: bool = False
    # True when the analyzed call is collective-free by construction, so
    # MFU derived from its FLOPs counts compute only.
    collectives_excluded: bool = False
    created_at: float = dataclasses.field(default_factory=time.time)

    @property
    def peak_bytes(self) -> int | None:
        """Approximate peak device memory while this program runs: the
        known parts of arguments + outputs + temporaries + code."""
        parts = [self.argument_bytes, self.output_bytes,
                 self.temp_bytes, self.generated_code_bytes]
        known = [p for p in parts if p is not None]
        return sum(known) if known else None

    def to_doc(self) -> dict:
        return {
            "key": self.key[:12],
            "label": self.label,
            "flops": self.flops,
            "bytesAccessed": self.bytes_accessed,
            "argumentBytes": self.argument_bytes,
            "outputBytes": self.output_bytes,
            "tempBytes": self.temp_bytes,
            "generatedCodeBytes": self.generated_code_bytes,
            "peakBytes": self.peak_bytes,
            "serializedBytes": self.serialized_bytes,
            "builtS": round(self.built_s, 4),
            "builds": self.builds,
            "analyzed": self.analyzed,
            "collectivesExcluded": self.collectives_excluded,
        }


class CostLedger:
    """Bounded per-fingerprint ProgramCost map (LRU on insertion)."""

    def __init__(self, max_programs: int = 256):
        self.max_programs = max(1, int(max_programs))
        self._lock = make_lock("CostLedger._lock")
        self._programs: OrderedDict[str, ProgramCost] = OrderedDict()
        self.analyses = 0
        self.analysis_failures = 0
        self.analysis_time_s = 0.0

    def _entry_locked(self, key: str, label: str) -> ProgramCost:
        cost = self._programs.get(key)
        if cost is None:
            cost = self._programs[key] = ProgramCost(key=key)
            while len(self._programs) > self.max_programs:
                self._programs.popitem(last=False)
        if label and not cost.label:
            cost.label = label
        return cost

    def note_build(self, key: str, label: str | None,
                   built_s: float) -> ProgramCost:
        """Called by the compile cache on EVERY build."""
        with self._lock:
            cost = self._entry_locked(key, label or "")
            cost.builds += 1
            cost.built_s = float(built_s)
            return cost

    def record_analysis(self, key: str, label: str | None, *,
                        flops=None, bytes_accessed=None, memory=None,
                        serialized=None, analysis_s: float = 0.0,
                        collectives_excluded: bool = False
                        ) -> ProgramCost:
        with self._lock:
            cost = self._entry_locked(key, label or "")
            if collectives_excluded:
                cost.collectives_excluded = True
            if flops is not None:
                cost.flops = float(flops)
            if bytes_accessed is not None:
                cost.bytes_accessed = float(bytes_accessed)
            if memory is not None:
                # Field by field: an unmeasured field stays None.
                def _mem(attr):
                    value = getattr(memory, attr, None)
                    return int(value) if value is not None else None

                cost.argument_bytes = _mem("argument_size_in_bytes")
                cost.output_bytes = _mem("output_size_in_bytes")
                cost.temp_bytes = _mem("temp_size_in_bytes")
                cost.generated_code_bytes = _mem(
                    "generated_code_size_in_bytes")
            if serialized is not None:
                cost.serialized_bytes = int(serialized)
            cost.analyzed = True
            self.analyses += 1
            self.analysis_time_s += float(analysis_s)
            return cost

    def seed(self, key: str, label: str | None, record: dict
             ) -> ProgramCost:
        """Install a stored record (train/aot_store.py) as ``key``'s
        analyzed cost without counting an analysis: the restored
        program's first call skips the FLOP counter."""
        fields = {f.name for f in dataclasses.fields(ProgramCost)} - {
            "key", "label", "builds", "built_s", "analyzed", "created_at"}
        with self._lock:
            cost = self._entry_locked(key, label or "")
            for name, value in record.items():
                if name in fields:
                    setattr(cost, name, value)
            cost.analyzed = True
            return cost

    def note_failure(self) -> None:
        with self._lock:
            self.analysis_failures += 1

    def get(self, key: str) -> ProgramCost | None:
        with self._lock:
            return self._programs.get(key)

    def serialized_bytes(self, key: str) -> int | None:
        with self._lock:
            cost = self._programs.get(key)
        if cost is None:
            return None
        return cost.serialized_bytes

    def snapshot(self) -> dict:
        with self._lock:
            programs = [c.to_doc() for c in self._programs.values()]
            return {
                "programs": programs,
                "maxPrograms": self.max_programs,
                "analyses": self.analyses,
                "analysisFailures": self.analysis_failures,
                "analysisTimeS": round(self.analysis_time_s, 4),
            }


class DeviceTimeLedger:
    """Sampled device-time attribution: who consumed the device.

    ``attribute`` accumulates (device seconds, flops, bytes, dispatches)
    per job (a bounded insertion-ordered ring), per served model and per
    (model, bucket).  Counters are scaled by the sampling weight, so
    thinned recording stays an unbiased estimate."""

    def __init__(self, max_jobs: int = 64, sample: float = 1.0,
                 max_models: int = 64):
        self.max_jobs = max(1, int(max_jobs))
        self.max_models = max(1, int(max_models))
        self.sample = min(1.0, max(0.0, float(sample)))
        # Every k-th dispatch records, scaled by k; the rate quantizes to
        # 1/round(1/sample).
        self._stride = (
            max(1, round(1.0 / self.sample)) if self.sample > 0 else 0
        )
        self._lock = make_lock("DeviceTimeLedger._lock")
        # PER-KEY stride counters (bounded): one global counter would
        # alias strictly alternating streams.
        self._counters: OrderedDict[str, int] = OrderedDict()
        # Entries are [device_s, flops, bytes, dispatches] lists (the
        # serving hot path); jobs and models ride bounded freshest-N
        # rings, a model's buckets die with it.
        self._jobs: OrderedDict[str, list] = OrderedDict()
        self._models: OrderedDict[str, list] = OrderedDict()
        self._buckets: dict[tuple, list] = {}
        self._totals = [0.0, 0.0, 0.0, 0]

    def will_record(self, key: str = "") -> int:
        """Advance ``key``'s sampling stride: the weight to record this
        dispatch with, or 0 (sampled out: the caller skips the sync)."""
        stride = self._stride
        if stride == 1:
            return 1
        if stride == 0:
            return 0
        with self._lock:
            n = self._counters.get(key)
            if n is None:
                n = 0
                while len(self._counters) >= 4 * self.max_models:
                    self._counters.popitem(last=False)
            n += 1
            self._counters[key] = n
            self._counters.move_to_end(key)
            return stride if n % stride == 0 else 0

    def _model_entry_locked(self, model: str) -> list:
        """The model's accumulator, evicting the OLDEST model (and its
        buckets) past the cap.  Caller holds the lock."""
        entry = self._models.get(model)
        if entry is None:
            entry = self._models[model] = [0.0, 0.0, 0.0, 0]
            while len(self._models) > self.max_models:
                evicted, _ = self._models.popitem(last=False)
                for bkey in [k for k in self._buckets if k[0] == evicted]:
                    del self._buckets[bkey]
        return entry

    def record_model(self, weight, duration_s, flops, nbytes, model,
                     bucket) -> None:
        """Positional fast path for the serving dispatch hook."""
        d = duration_s * weight
        f = (flops or 0.0) * weight
        b = (nbytes or 0.0) * weight
        with self._lock:
            t = self._totals
            t[0] += d
            t[1] += f
            t[2] += b
            t[3] += weight
            entry = self._model_entry_locked(model)
            entry[0] += d
            entry[1] += f
            entry[2] += b
            entry[3] += weight
            if bucket is not None:
                bkey = (model, bucket)
                entry = self._buckets.get(bkey)
                if entry is None:
                    entry = self._buckets[bkey] = [0.0, 0.0, 0.0, 0]
                entry[0] += d
                entry[1] += f
                entry[2] += b
                entry[3] += weight

    def record(self, weight: int, duration_s: float, *, flops=None,
               nbytes=None, job: str | None = None,
               model: str | None = None,
               bucket: int | None = None) -> None:
        """General form: totals + any of job/model/bucket."""
        if model:
            self.record_model(
                weight, duration_s, flops, nbytes, model, bucket)
            if not job:
                return
            totals = None  # record_model already added them
        else:
            totals = self._totals
        d = duration_s * weight
        f = (flops or 0.0) * weight
        b = (nbytes or 0.0) * weight
        with self._lock:
            if totals is not None:
                totals[0] += d
                totals[1] += f
                totals[2] += b
                totals[3] += weight
            if job:
                entry = self._jobs.get(job)
                if entry is None:
                    entry = self._jobs[job] = [0.0, 0.0, 0.0, 0]
                    while len(self._jobs) > self.max_jobs:
                        self._jobs.popitem(last=False)
                entry[0] += d
                entry[1] += f
                entry[2] += b
                entry[3] += weight

    def attribute(self, duration_s: float, *, flops=None, nbytes=None,
                  job: str | None = None, model: str | None = None,
                  bucket: int | None = None) -> bool:
        """Sampling decision + record in one call; whether it recorded."""
        weight = self.will_record(model or job or "")
        if not weight:
            return False
        self.record(weight, duration_s, flops=flops, nbytes=nbytes,
                    job=job, model=model, bucket=bucket)
        return True

    @staticmethod
    def _doc(entry: list, peak_flops: float) -> dict:
        doc = {
            "deviceTimeS": round(entry[0], 6),
            "flops": entry[1],
            "bytes": entry[2],
            "dispatches": entry[3],
        }
        util = mfu(entry[1], entry[0], peak_flops=peak_flops)
        if util is not None:
            doc["mfu"] = util
        return doc

    def model_device_s(self, model: str) -> float:
        """Accumulated device seconds attributed to ``model`` (0.0 when
        unseen): the fleet autoscaler's device-time signal."""
        with self._lock:
            entry = self._models.get(model)
            return float(entry[0]) if entry else 0.0

    def job_summary(self, job: str,
                    peak_flops: float = 0.0) -> dict | None:
        with self._lock:
            entry = self._jobs.get(job)
            entry = list(entry) if entry else None
        return self._doc(entry, peak_flops) if entry else None

    def snapshot(self, peak_flops: float = 0.0) -> dict:
        with self._lock:
            jobs = {k: list(v) for k, v in self._jobs.items()}
            models = {k: list(v) for k, v in self._models.items()}
            buckets = {k: list(v) for k, v in self._buckets.items()}
            totals = list(self._totals)
        return {
            "sample": self.sample,
            "totals": self._doc(totals, peak_flops),
            "jobs": {k: self._doc(v, peak_flops) for k, v in jobs.items()},
            "models": {k: self._doc(v, peak_flops)
                       for k, v in models.items()},
            "buckets": {
                f"{m}:{b}": self._doc(v, peak_flops)
                for (m, b), v in sorted(buckets.items(),
                                        key=lambda kv: str(kv[0]))
            },
        }


def mfu(flops: float, device_s: float, *,
        peak_flops: float) -> float | None:
    """Model-FLOPs-utilization: achieved over peak.  None when the peak
    is unconfigured or nothing ran."""
    if peak_flops <= 0 or device_s <= 0 or flops <= 0:
        return None
    value = flops / (device_s * peak_flops)
    if not math.isfinite(value):
        return None
    # Significant digits, not decimal places: a tiny model on a big card
    # legitimately runs at 1e-8 MFU.
    return float(f"{value:.4g}")


# -- process-wide singletons --------------------------------------------------

_lock = make_lock("costs._lock")
_ledger: CostLedger | None = None
_devtime: DeviceTimeLedger | None = None
_cfg_cache = None


def _cfg():
    global _cfg_cache
    if _cfg_cache is None:
        from learningorchestra_tpu_torch.config import get_config

        _cfg_cache = get_config().costs
    return _cfg_cache


def enabled() -> bool:
    return _cfg().enabled


def deep_enabled() -> bool:
    return _cfg().enabled and _cfg().deep


def peak_flops() -> float:
    return float(_cfg().peak_flops)


def get_ledger() -> CostLedger:
    global _ledger
    with _lock:
        if _ledger is None:
            _ledger = CostLedger(max_programs=_cfg().max_programs)
        return _ledger


def devtime() -> DeviceTimeLedger:
    global _devtime
    with _lock:
        if _devtime is None:
            cfg = _cfg()
            _devtime = DeviceTimeLedger(
                max_jobs=cfg.max_jobs, sample=cfg.sample)
        return _devtime


def reset(config=None) -> None:
    """Drop both ledgers (tests; config swap).  ``config`` overrides the
    CostsConfig the rebuilt singletons size from."""
    global _ledger, _devtime, _cfg_cache
    with _lock:
        _ledger = None
        _devtime = None
        _cfg_cache = config


# -- the compile-cache hooks --------------------------------------------------


def note_build(key: str, label: str | None, built_s: float) -> None:
    """Every compile-cache build lands here."""
    if not enabled():
        return
    get_ledger().note_build(key, label, built_s)


def seed(key: str, label: str | None, record: dict) -> None:
    """A restored program's stored cost record lands here."""
    if enabled():
        get_ledger().seed(key, label, record)


def serialized_bytes(key: str) -> int | None:
    """Measured program size for the cache's byte cap, or None (the
    cache charges its flat estimate; a PyTorch program has no serialized
    form to measure)."""
    if not enabled():
        return None
    return get_ledger().serialized_bytes(key)


# -- FLOPs of one real call ---------------------------------------------------


@functools.lru_cache(maxsize=1)
def _flop_counter():
    """The class of the FLOP-counting dispatch mode, made on first use.

    ``torch.utils.flop_counter.FlopCounterMode`` is not used: it also
    starts a ``ModuleTracker``, whose module hooks are process-wide, so
    every forward on every other thread (another replica's batcher,
    another job) would run them while one thread analyzes, and their
    gradient hooks would attach to that thread's autograd graph.  A
    dispatch mode alone is per thread."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            # The FlopCounterMode layout, so note_kernel_flops and a
            # caller's own FlopCounterMode are fed alike.
            self.flop_counts = {"Global": Counter()}

        def get_total_flops(self) -> int:
            return sum(self.flop_counts["Global"].values())

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            formula = flop_registry.get(func._overloadpacket)
            if formula is None and func is not torch.ops.prim.device.default:
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if formula is not None:
                self.flop_counts["Global"][func._overloadpacket] += \
                    formula(*args, **kwargs, out_val=out)
            return out

    return FlopCount


def _active_counters() -> list:
    """The FLOP counters counting on this thread, ours or a caller's
    FlopCounterMode (the dispatch-mode stack follows the autograd
    engine's threads)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    stack = _get_current_dispatch_mode_stack()
    if not stack:
        return []
    out = []
    for mode in stack:
        counter = getattr(mode, "counter", mode)
        if hasattr(counter, "flop_counts") and hasattr(
                counter, "get_total_flops"):
            out.append(counter)
    return out


def counting() -> bool:
    """Whether a FLOP counter counts on this thread."""
    return bool(_active_counters())


def note_kernel_flops(name: str, flops: float) -> None:
    """Add a hand-written kernel's FLOPs to every active FLOP counter
    (it sees aten operators only, never a ctypes launch).  No-op when
    nothing counts."""
    for counter in _active_counters():
        counter.flop_counts["Global"][name] += int(flops)


def uncounted():
    """Context in which a kernel's plain version runs without adding its
    inner products to an active counter (the kernel's formula already
    did); a null context when nothing counts."""
    if not _active_counters():
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


@functools.lru_cache(maxsize=1024)
def attention_pairs(tq: int, tk: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks leave live, as the flash kernels
    lay them out (query row i sees key j <= i, and j > i - window with a
    window): Tq*Tk without a causal mask.  The key padding mask is data
    and is not subtracted."""
    if not causal:
        return tq * tk
    total = 0
    for i in range(tq):
        hi = min(i, tk - 1)
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _tensor_bytes(args) -> int:
    """Bytes of the distinct tensors in ``args`` (tensors, modules'
    parameters and buffers, an estimator's module, containers)."""
    import torch

    seen: dict = {}

    def walk(obj, depth=0):
        if depth > 4:
            return
        if isinstance(obj, torch.Tensor):
            seen[(obj.device, obj.data_ptr())] = max(
                seen.get((obj.device, obj.data_ptr()), 0),
                obj.numel() * obj.element_size())
        elif isinstance(obj, torch.nn.Module):
            for t in list(obj.parameters()) + list(obj.buffers()):
                walk(t, depth + 1)
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v, depth + 1)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v, depth + 1)
        elif isinstance(getattr(obj, "module", None), torch.nn.Module):
            walk(obj.module, depth + 1)

    walk(args)
    return sum(seen.values())


def _cuda_device(args):
    import torch

    for obj in args:
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            return obj.device
        module = obj if isinstance(obj, torch.nn.Module) else getattr(
            obj, "module", None)
        if isinstance(module, torch.nn.Module):
            p = next(module.parameters(), None)
            if p is not None and p.is_cuda:
                return p.device
    return None


def analyze_program(key: str, label: str | None, fn, example_args: tuple):
    """Run ``fn(*example_args)`` — ONE real call of the program, whose
    result is returned — under the FLOP counter and record its FLOPs
    under ``key``; with ``deep`` on, also the bytes of the call's tensor
    arguments and, on a card, its peak allocation above what was resident
    before it.  That peak is read from the process's peak, which is
    never reset: when the call did not raise it, the call's peak is
    unknown and stays None; what other threads allocate on the card
    meanwhile counts in it.  A key already analyzed, or costs off, just
    calls ``fn``.  The record is offered to the durable program store
    (train/aot_store.py) when it is on and the key survives the process.
    A failure to count or to offer never fails the call; a failure of the
    call itself propagates, unrecorded."""
    if not enabled():
        return fn(*example_args)
    ledger = get_ledger()
    existing = ledger.get(key)
    if existing is not None and existing.analyzed:
        return fn(*example_args)
    import torch

    try:
        counter = _flop_counter()()
    except Exception:  # noqa: BLE001 — analysis must never fail a call
        ledger.note_failure()
        return fn(*example_args)
    deep = deep_enabled()
    dev = _cuda_device(example_args) if deep else None
    if dev is not None:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    state = _analysis.state = {"counter": counter, "open": True,
                               "scale": 1}
    t0 = time.perf_counter()
    counter.__enter__()
    try:
        result = fn(*example_args)
    finally:
        _analysis.state = None
        if state["open"]:
            counter.__exit__(None, None, None)
    analysis_s = time.perf_counter() - t0
    memory = None
    try:
        if deep:
            temp = None
            if dev is not None:
                torch.cuda.synchronize(dev)
                after = torch.cuda.max_memory_allocated(dev)
                temp = after - base if after > peak else None
            memory = types.SimpleNamespace(
                argument_size_in_bytes=_tensor_bytes(example_args),
                temp_size_in_bytes=temp)
        record = ledger.record_analysis(
            key, label, flops=counter.get_total_flops() * state["scale"],
            memory=memory, analysis_s=analysis_s)
    except Exception:  # noqa: BLE001
        ledger.note_failure()
        return result
    from learningorchestra_tpu_torch.train import aot_store

    aot_store.offer_program(key, label, fn=fn, cost=record)
    return result


_analysis = threading.local()


def repeats(n: int) -> None:
    """Called by a program right after the first of ``n`` units of work
    with equal shapes (an epoch's steps): the analysis of its call stops
    counting there and takes ``n`` times that unit's FLOPs, so the
    counter's cost per operator is paid for one unit, not for the whole
    call.  A no-op outside an analysis, and after its first call."""
    state = getattr(_analysis, "state", None)
    if state is None or not state["open"]:
        return
    state["counter"].__exit__(None, None, None)
    state["open"] = False
    state["scale"] = int(n)


# -- device-time attribution --------------------------------------------------

_JOB: contextvars.ContextVar = contextvars.ContextVar(
    "lo_costs_job", default=None)


@contextlib.contextmanager
def job_scope(name: str):
    """Bind the calling thread's dispatches to job ``name`` (the executor
    wraps job bodies, and each tune trial: pool threads do not inherit
    the context)."""
    token = _JOB.set(name)
    try:
        yield
    finally:
        _JOB.reset(token)


class Interval:
    """One device interval: CUDA events on ``device``'s current stream
    (the card's clock, queued with the work), ``perf_counter`` on the
    CPU.  ``seconds()`` waits for the end event."""

    __slots__ = ("_start", "_end", "_t0", "_t1")

    def __init__(self, device):
        import torch

        if getattr(device, "type", device) == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = self._end = None
            self._t0 = time.perf_counter()

    def stop(self) -> "Interval":
        if self._end is not None:
            self._end.record()
        else:
            self._t1 = time.perf_counter()
        return self

    def seconds(self) -> float:
        if self._end is not None:
            self._end.synchronize()
            return self._start.elapsed_time(self._end) / 1e3
        return self._t1 - self._t0


def attribute(duration_s: float, *, cost: ProgramCost | None = None,
              key: str | None = None, model: str | None = None,
              bucket: int | None = None,
              job: str | None = None) -> bool:
    """The per-dispatch accounting hook.  ``cost`` (or ``key`` to look it
    up) supplies the program's flops/bytes; ``job`` defaults to the
    ambient :func:`job_scope`."""
    if not enabled():
        return False
    if cost is None and key is not None:
        cost = get_ledger().get(key)
    return devtime().attribute(
        duration_s,
        flops=cost.flops if cost is not None else None,
        nbytes=cost.bytes_accessed if cost is not None else None,
        job=job if job is not None else _JOB.get(),
        model=model,
        bucket=bucket,
    )


def job_summary(name: str) -> dict | None:
    """The job's accumulated device-time doc (None when nothing was
    attributed): the executor stamps it into finished-job metadata."""
    if not enabled():
        return None
    return devtime().job_summary(name, peak_flops=peak_flops())


def serving_totals() -> dict:
    """Aggregate over served models: device seconds, flops, dispatches,
    and MFU when a peak is configured."""
    if not enabled():
        return {"deviceTimeS": 0.0, "flops": 0.0, "dispatches": 0}
    snap = devtime().snapshot(peak_flops=peak_flops())
    device_s = sum(m["deviceTimeS"] for m in snap["models"].values())
    flops = sum(m["flops"] for m in snap["models"].values())
    out = {
        "deviceTimeS": round(device_s, 6),
        "flops": flops,
        "dispatches": sum(
            m["dispatches"] for m in snap["models"].values()),
    }
    util = mfu(flops, device_s, peak_flops=peak_flops())
    if util is not None:
        out["mfu"] = util
    return out


def snapshot() -> dict:
    """Everything, JSON-shaped — ``GET /observability/costs``."""
    return {
        "enabled": enabled(),
        "peakFlopsPerChip": peak_flops(),
        "ledger": get_ledger().snapshot() if enabled() else {},
        "deviceTime": (
            devtime().snapshot(peak_flops=peak_flops())
            if enabled() else {}
        ),
    }
