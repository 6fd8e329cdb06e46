"""Always-on flight recorder: the last N events of runtime truth — port
of ``learningorchestra_tpu/obs/flight.py``.

Bounded per-domain event rings:

- ``http``    — one event per completed request (route, status, latency,
  request id);
- ``decode``  — per-stream lifecycle on the decode engine (admit, pool
  grow, first token, abort, step errors);
- ``jobs``    — engine dispatch / preempt-retry / terminal decisions;
- ``compile`` — program builds and durable-store restores;
- ``faults``  — every fault-point trigger;
- ``locks`` and ``cluster`` — kept for the JAX package's lock witness
  and control plane, which the port does not have yet: they stay empty.

Every event carries ``t`` (monotonic), ``wall`` and, when one is bound
on the calling thread, the ``requestId`` (obs/tracing.py), so
:func:`timeline` merges the rings into one ordered incident narrative.

``record()`` takes no lock: rings are ``collections.deque(maxlen=N)``,
whose appends are atomic under the GIL, and the disabled path is one
module-global check.

Knobs: config.py ``FlightConfig`` (env ``LO_TPU_FLIGHT_*``).
"""

from __future__ import annotations

import collections
import threading
import time

from learningorchestra_tpu_torch.obs import tracing as obs_tracing

__all__ = [
    "DOMAINS",
    "configure",
    "enabled",
    "ensure",
    "record",
    "reset",
    "snapshot",
    "status",
    "timeline",
]

#: The fixed domain set — one bounded ring each.  Adding a domain is a
#: code change on purpose: rings are capacity planning, not a dict that
#: grows per caller typo.
DOMAINS = (
    "http", "decode", "jobs", "compile", "faults", "locks", "cluster",
)

_lock = threading.Lock()
#: None while disabled (the record() fast path is this one check);
#: {domain: deque} while enabled.
_rings: dict | None = None
_events_per_ring = 0


def record(domain: str, kind: str, **fields) -> None:
    """Append one event to ``domain``'s ring.  Lock-free: a module
    read, a dict lookup and a GIL-atomic deque append.  Unknown
    domains are dropped (never raise on the hot path)."""
    rings = _rings
    if rings is None:
        return
    ring = rings.get(domain)
    if ring is None:
        return
    event = {
        "t": time.monotonic(),
        "wall": time.time(),
        "kind": kind,
    }
    rid = obs_tracing.get_request_id()
    if rid:
        event["requestId"] = rid
    if fields:
        event.update(fields)
    ring.append(event)


def enabled() -> bool:
    return _rings is not None


def configure(cfg) -> None:
    """Arm (or disarm) the recorder from a FlightConfig.  Existing
    ring contents are dropped — configuration marks a new epoch."""
    global _rings, _events_per_ring
    with _lock:
        if not cfg.enabled or cfg.events <= 0:
            _rings = None
            _events_per_ring = 0
            return
        _events_per_ring = int(cfg.events)
        _rings = {
            domain: collections.deque(maxlen=_events_per_ring)
            for domain in DOMAINS
        }


def ensure(cfg) -> None:
    """Arm from ``cfg`` only if never configured (API-server boot:
    a test that armed a custom recorder first wins, matching the
    ensure_* singleton idiom of the sibling obs modules)."""
    with _lock:
        already = _rings is not None or _events_per_ring != 0
    if not already:
        configure(cfg)


def reset(cfg=None) -> None:
    """Tests: drop all state; re-arm when ``cfg`` is given."""
    global _rings, _events_per_ring
    with _lock:
        _rings = None
        _events_per_ring = 0
    if cfg is not None:
        configure(cfg)


def snapshot(domains=None, limit: int = 0) -> dict:
    """Point-in-time copy of the rings: ``{"enabled", "events":
    {domain: [event, ...]}}`` oldest-first, optionally filtered to
    ``domains`` and truncated to the newest ``limit`` per ring."""
    rings = _rings
    doc: dict = {
        "enabled": rings is not None,
        "eventsPerRing": _events_per_ring,
        "events": {},
    }
    if rings is None:
        return doc
    for domain, ring in rings.items():
        if domains and domain not in domains:
            continue
        events = list(ring)  # GIL-atomic copy of the whole ring
        if limit > 0:
            events = events[-limit:]
        doc["events"][domain] = events
    return doc


def timeline(domains=None, limit: int = 0) -> list:
    """The merged incident timeline: every ring's events in one list
    ordered by monotonic ``t`` (newest last), each tagged with its
    ``domain``.  ``limit`` keeps the newest N after the merge."""
    snap = snapshot(domains=domains)
    merged = [
        {**event, "domain": domain}
        for domain, events in snap["events"].items()
        for event in events
    ]
    merged.sort(key=lambda event: event["t"])
    if limit > 0:
        merged = merged[-limit:]
    return merged


def status() -> dict:
    """Ring occupancy without copying event payloads."""
    rings = _rings
    return {
        "enabled": rings is not None,
        "eventsPerRing": _events_per_ring,
        "rings": {
            domain: len(ring) for domain, ring in rings.items()
        } if rings is not None else {},
    }
