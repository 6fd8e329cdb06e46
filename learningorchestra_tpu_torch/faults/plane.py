"""Process-wide, seeded fault-injection plane — port of
``learningorchestra_tpu/faults/plane.py``.

Any pipeline step can fail and be re-executed; this switchboard makes
the recovery machinery (preemption retries, checkpoint resume, lease
timeouts, deadlines) exercisable on demand.  Subsystems declare named
fault points and call :func:`hit` on their hot paths:

=====================  ====================================================
point                  call site in the port
=====================  ====================================================
``engine.dispatch``    jobs/engine.py — start of every job-body attempt
``lease.acquire``      jobs/leases.py — entry of every device-lease request
``compile.build``      train/compile_cache.py — before a miss builds
``store.wal_write``    store/document_store.py — before every WAL append
``serve.apply``        serve/service.py — before a coalesced dispatch
``serve.route``        serve/fleet/router.py — every routing decision
``serve.decode_step``  serve/decode/engine.py — on the host, before a
                       pool's step (never inside a graph capture)
``http.handler``       api/server.py — before every route handler
``train.epoch``        train/neural.py — top of every fit epoch
``cache.aot_load``     train/aot_store.py — before a blob is read
``cache.aot_store``    train/aot_store.py — before a blob is written
=====================  ====================================================

``replica.wal_ship``, ``store.ha.failover`` and the ``cluster.*`` points
are registered as in the JAX package; their call sites (store/ha.py,
store/replica.py, jobs/cluster.py) are not ported yet.

A **schedule** arms a point with one of three behaviours:

- ``preempt`` — raise :class:`jobs.engine.Preempted` (the signal the
  engine's retry loop consumes);
- ``error``   — raise :class:`FaultInjected` (an ordinary crash);
- ``delay``   — sleep ``delay_ms`` (latency injection).

Schedules are deterministic and seeded: ``rate < 1`` draws from a
``random.Random`` seeded with ``seed`` mixed with a CRC of the point
name (never the process-salted ``hash()``), so one (seed, rate) arms
one trigger pattern on every run and in both packages.  ``after`` skips
the first N hits and ``max_triggers`` bounds total firings.

Configuration: ``LO_TPU_FAULT_<POINT>`` (see :func:`load_env`) and the
REST surface (``GET|DELETE /faults``, ``POST|DELETE /faults/<point>``).
Every trigger increments the registry's fault-trigger counter by
(point, mode), the plane's own per-point counters (:func:`status`) and
the ``faults`` flight ring.

Disabled path: :func:`hit` is a truthiness check on an empty
module-level dict and a return — no lock, no lookup, no allocation.
"""

from __future__ import annotations

import threading
import time
import zlib

from learningorchestra_tpu_torch.log import get_logger, kv

logger = get_logger("faults")

__all__ = [
    "ENV_PREFIX",
    "FaultInjected",
    "FaultSchedule",
    "MODES",
    "POINTS",
    "arm",
    "disarm",
    "disarm_all",
    "hit",
    "load_env",
    "points",
    "register_point",
    "status",
]

#: Modes a schedule can arm a point with.
MODES = ("preempt", "error", "delay")

#: The built-in fault points.  Subsystems adding a new point register it
#: with :func:`register_point`; the test gate in tests/test_faults.py
#: fails any registered point without a chaos driver.
POINTS = (
    "engine.dispatch",
    "lease.acquire",
    "compile.build",
    "store.wal_write",
    "serve.apply",
    "serve.route",
    "serve.decode_step",
    "http.handler",
    "train.epoch",
    "replica.wal_ship",
    "store.ha.failover",
    "cache.aot_load",
    "cache.aot_store",
    "cluster.claim",
    "cluster.heartbeat",
    "cluster.steal",
)


class FaultInjected(Exception):
    """The injected failure for ``error`` mode — deliberately an
    ordinary exception: recovery paths must treat it like any crash."""


class FaultSchedule:
    """One point's armed behavior: deterministic, seeded, bounded."""

    def __init__(self, point: str, mode: str, *, rate: float = 1.0,
                 seed: int = 0, after: int = 0, max_triggers: int = 0,
                 delay_ms: float = 0.0):
        if mode not in MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (one of {MODES})"
            )
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"rate must be in (0, 1], got {rate!r}")
        if delay_ms < 0:
            raise ValueError(f"delay_ms must be >= 0, got {delay_ms!r}")
        self.point = point
        self.mode = mode
        self.rate = float(rate)
        self.seed = int(seed)
        self.after = max(0, int(after))
        self.max_triggers = max(0, int(max_triggers))  # 0 = unbounded
        self.delay_ms = float(delay_ms)
        self.hits = 0
        self.triggers = 0
        # Stable per-(seed, point) stream: zlib.crc32, NOT hash() —
        # Python salts str hashes per process, which would make "the
        # same seed" mean different trigger patterns across runs.
        self._rng = _random().Random(
            (self.seed << 32) ^ zlib.crc32(point.encode())
        )

    def should_fire(self) -> bool:
        """One hit's verdict.  Caller holds the plane lock — the
        hit/trigger counters and the RNG stream must be serialized for
        the schedule to stay deterministic under concurrency."""
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.max_triggers and self.triggers >= self.max_triggers:
            return False
        if self.rate < 1.0 and self._rng.random() >= self.rate:
            return False
        self.triggers += 1
        return True

    def to_doc(self) -> dict:
        return {
            "mode": self.mode,
            "rate": self.rate,
            "seed": self.seed,
            "after": self.after,
            "maxTriggers": self.max_triggers,
            "delayMs": self.delay_ms,
            "hits": self.hits,
            "triggers": self.triggers,
        }


def _random():
    import random

    return random


_LOCK = threading.Lock()
#: point -> FaultSchedule.  THE fast-path gate: empty means the whole
#: plane is disabled and :func:`hit` returns after one truthiness check.
_ARMED: dict[str, FaultSchedule] = {}
#: Registered point names (built-ins + register_point additions).
_POINTS: set[str] = set(POINTS)
#: Cumulative per-point counters, surviving disarm — the test gate and
#: post-chaos assertions read these.
_TOTALS: dict[str, dict] = {}


def register_point(name: str) -> str:
    """Declare a fault point (idempotent); returns ``name`` so call
    sites can do ``POINT = register_point("x.y")``."""
    with _LOCK:
        _POINTS.add(name)
    return name


def points() -> tuple:
    with _LOCK:
        return tuple(sorted(_POINTS))


def _canonical(name: str) -> str:
    """Resolve a point name case/separator-insensitively (the env-var
    spelling ``ENGINE_DISPATCH`` must find ``engine.dispatch`` even
    though ``store.wal_write`` itself contains an underscore)."""
    with _LOCK:
        if name in _POINTS:
            return name
        folded = name.casefold().replace(".", "_")
        for point in _POINTS:
            if point.casefold().replace(".", "_") == folded:
                return point
    raise ValueError(
        f"unknown fault point {name!r} (known: {sorted(_POINTS)})"
    )


def arm(point: str, mode: str, *, rate: float = 1.0, seed: int = 0,
        after: int = 0, max_triggers: int = 0,
        delay_ms: float = 0.0) -> dict:
    """Arm ``point`` with a fresh schedule (replacing any existing one);
    returns the schedule's JSON doc."""
    point = _canonical(point)
    sched = FaultSchedule(
        point, mode, rate=rate, seed=seed, after=after,
        max_triggers=max_triggers, delay_ms=delay_ms,
    )
    with _LOCK:
        _ARMED[point] = sched
    logger.warning(kv(event="fault_armed", point=point, mode=mode,
                      rate=rate, seed=seed, after=after,
                      max=max_triggers))
    return sched.to_doc()


def disarm(point: str) -> bool:
    point = _canonical(point)
    with _LOCK:
        sched = _ARMED.pop(point, None)
        if sched is not None:
            _accumulate_locked(sched)
    return sched is not None


def disarm_all() -> None:
    with _LOCK:
        for sched in _ARMED.values():
            _accumulate_locked(sched)
        _ARMED.clear()


def _accumulate_locked(sched: FaultSchedule) -> None:
    tot = _TOTALS.setdefault(
        sched.point, {"hits": 0, "triggers": 0}
    )
    tot["hits"] += sched.hits
    tot["triggers"] += sched.triggers
    sched.hits = sched.triggers = 0


def reset() -> None:
    """Disarm everything and zero the cumulative counters (tests)."""
    with _LOCK:
        _ARMED.clear()
        _TOTALS.clear()


def status() -> dict:
    """The REST surface's GET body: every registered point with its
    armed schedule (if any) and cumulative hit/trigger counts."""
    with _LOCK:
        out = {}
        for point in sorted(_POINTS):
            tot = _TOTALS.get(point, {"hits": 0, "triggers": 0})
            sched = _ARMED.get(point)
            out[point] = {
                "armed": sched.to_doc() if sched is not None else None,
                "hits": tot["hits"] + (sched.hits if sched else 0),
                "triggers": tot["triggers"]
                + (sched.triggers if sched else 0),
            }
        return {"enabled": bool(_ARMED), "points": out}


def triggers(point: str) -> int:
    """Cumulative trigger count for one point (armed + disarmed)."""
    point = _canonical(point)
    with _LOCK:
        n = _TOTALS.get(point, {}).get("triggers", 0)
        sched = _ARMED.get(point)
        return n + (sched.triggers if sched is not None else 0)


def hit(point: str) -> None:
    """The per-site probe.  DISABLED PATH MUST STAY FREE: one
    truthiness check on a module global, then return — this line runs
    on every WAL append and every HTTP dispatch."""
    if not _ARMED:
        return
    _fire(point)


def _fire(point: str) -> None:
    with _LOCK:
        sched = _ARMED.get(point)
        if sched is None or not sched.should_fire():
            return
        mode = sched.mode
        delay_ms = sched.delay_ms
        trigger_n = sched.triggers
    _trigger_counter().inc(point=point, mode=mode)
    from learningorchestra_tpu_torch.obs import flight as obs_flight

    obs_flight.record(
        "faults", "trigger", point=point, mode=mode, n=trigger_n,
    )
    logger.warning(kv(event="fault_triggered", point=point, mode=mode,
                      trigger=trigger_n))
    if mode == "delay":
        time.sleep(delay_ms / 1e3)
        return
    if mode == "preempt":
        from learningorchestra_tpu_torch.jobs.engine import Preempted

        raise Preempted(f"injected preemption at {point!r}")
    raise FaultInjected(f"injected fault at {point!r}")


def _trigger_counter():
    """Obs-registry counter, resolved per trigger so a registry reset
    (tests, the on/off probe) takes effect immediately —
    triggers are rare, the lookup cost is irrelevant."""
    from learningorchestra_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        "lo_fault_triggers_total",
        "Injected faults fired, by point and mode.",
        labels=("point", "mode"),
    )


def parse_spec(spec: str) -> dict:
    """``"mode[:k=v,...]"`` → arm() kwargs.  The env-var grammar::

        LO_TPU_FAULT_ENGINE_DISPATCH="preempt:rate=0.5,seed=7,max=2"
        LO_TPU_FAULT_SERVE_APPLY="delay:ms=50"
        LO_TPU_FAULT_STORE_WAL_WRITE="error:rate=0.01,seed=1,after=100"

    Keys: ``rate``, ``seed``, ``after``, ``max`` (max_triggers),
    ``ms`` (delay_ms).  Unknown keys are rejected loudly — a typo'd
    chaos knob silently doing nothing would fake a green drill.
    """
    mode, _, rest = spec.strip().partition(":")
    mode = mode.strip().lower()
    if mode not in MODES:
        raise ValueError(
            f"bad fault spec {spec!r}: mode must be one of {MODES}"
        )
    kw: dict = {"mode": mode}
    keymap = {"rate": ("rate", float), "seed": ("seed", int),
              "after": ("after", int), "max": ("max_triggers", int),
              "ms": ("delay_ms", float)}
    for tok in filter(None, (t.strip() for t in rest.split(","))):
        key, eq, val = tok.partition("=")
        if not eq or key.strip() not in keymap:
            raise ValueError(
                f"bad fault spec {spec!r}: token {tok!r} (keys: "
                f"{sorted(keymap)})"
            )
        name, cast = keymap[key.strip()]
        kw[name] = cast(val.strip())
    return kw


ENV_PREFIX = "LO_TPU_FAULT_"


def load_env(env=None) -> list[str]:
    """Arm every ``LO_TPU_FAULT_<POINT>=<spec>`` found in ``env``
    (default ``os.environ``); returns the armed point names.  Called at
    API-server construction so a deployment can boot straight into a
    chaos drill.  Bad specs raise — same loud-rejection contract as
    the config tree's boolean env knobs."""
    import os

    env = os.environ if env is None else env
    armed = []
    for key, raw in env.items():
        if not key.startswith(ENV_PREFIX) or not raw.strip():
            continue
        kw = parse_spec(raw)
        doc_point = _canonical(key[len(ENV_PREFIX):])
        arm(doc_point, kw.pop("mode"), **kw)
        armed.append(doc_point)
    return armed
