"""Runtime lock witness — port of ``learningorchestra_tpu/concurrency_rt.py``,
the dynamic half of the lochecks concurrency model.

Every lock the port constructs (``threading.Lock``/``RLock``/``Condition``)
goes through :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition` with a NAME that matches the static analyzer's
lock identity (``Class.attr`` for instance locks, ``module.var`` for
module-level locks — the whole-program pass's ``lock-name-mismatch``
rule enforces the congruence).  With the witness OFF (the default) the
factories return plain ``threading`` primitives: no wrapper, no
hot-path cost.  With it ON (``LO_TPU_WITNESS=1`` at import, or
:func:`set_witness` before the objects under test are constructed)
locks come back instrumented and the witness records, per thread:

- **acquisition-order edges**: acquiring B while holding A is an A→B
  edge with the first observed call site — the OBSERVED lock-order
  graph that ``analysis/witness.py`` cross-checks against the static
  whole-program graph (a witnessed edge the static model lacks is a
  false negative in the model);
- **held-while-blocking events**: a thread that already holds locks
  stalling on another lock's acquire, kept in a bounded ring (and in
  the flight recorder's ``locks`` ring);
- **holders and waiters** per lock, so the stall watchdog — and
  ``GET /observability/locks`` — can dump who owns what and who has
  been waiting how long, with live thread stacks.

The witness's own bookkeeping is guarded by ONE plain (un-witnessed)
module lock; an instrumented ``acquire`` never blocks while holding it.
Conditions are never instrumented, so a CUDA-graph capture thread or a
batcher waiting on its condition runs exactly as with the witness off.

Env knobs (read directly, not through config.py, which constructs a
lock itself; they are registered in ``config.DIRECT_ENV_KNOBS``):

- ``LO_TPU_WITNESS=1``       enable at import
- ``LO_TPU_WITNESS_STALL_S`` stall-watchdog threshold (default 30 s):
  a waiter blocked longer is logged with a full holder/waiter dump
- ``LO_TPU_WITNESS_DUMP``    path; when set (and the witness is on) a
  JSON snapshot is written at interpreter exit, which
  ``analysis.run_checks(..., witness_dump=path)`` cross-checks
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import sys
import threading
import time
import traceback
import weakref
from collections import deque

__all__ = [
    "make_lock",
    "make_rlock",
    "make_condition",
    "witness_enabled",
    "set_witness",
    "snapshot",
    "reset",
]

_logger = logging.getLogger("learningorchestra_tpu_torch.locks")

_THIS_FILE = __file__


def _stall_threshold_s() -> float:
    try:
        return float(os.environ.get("LO_TPU_WITNESS_STALL_S", "30"))
    except ValueError:
        return 30.0


# -- witness state (guarded by _STATE_LOCK; never witnessed) -----------------

_STATE_LOCK = threading.Lock()
_ENABLED = os.environ.get("LO_TPU_WITNESS", "").strip() == "1"
#: (held_name, acquired_name) -> {"count": int, "site": "file:line"}
_EDGES: dict = {}
_MAX_EDGES = 4096
#: bounded ring of held-while-blocking contention events
_EVENTS: deque = deque(maxlen=256)
#: live instrumented locks (weak — a dropped ReplicaSet's locks go too)
_LOCKS: "weakref.WeakSet" = weakref.WeakSet()
_TLS = threading.local()
_WATCHDOG: threading.Thread | None = None
#: The CURRENT watchdog's stop event — one per thread generation, so
#: a disable→enable flip can never revive a stopping thread (it owns
#: its own event; the replacement gets a fresh one).
_WATCHDOG_STOP: threading.Event | None = None
#: (lock_name, tid) pairs already stall-logged (log once per episode)
_STALLED_LOGGED: set = set()


def witness_enabled() -> bool:
    return _ENABLED


def set_witness(enabled: bool) -> None:
    """Flip the witness for locks constructed FROM NOW ON (existing
    plain locks stay plain — enable before building the objects under
    test; tests construct fresh engines/services per fixture).
    Disabling also stops the stall watchdog; the next witnessed lock
    construction restarts it."""
    global _ENABLED, _WATCHDOG
    _ENABLED = bool(enabled)
    if not _ENABLED:
        with _STATE_LOCK:
            if _WATCHDOG_STOP is not None:
                _WATCHDOG_STOP.set()
            _WATCHDOG = None


def make_lock(name: str):
    """A ``threading.Lock`` (plain when the witness is off, witnessed
    when on).  ``name`` must equal the static identity —
    ``Class.attr`` / ``module.var`` — so observed edges line up with
    the whole-program graph."""
    if not _ENABLED:
        return threading.Lock()
    return _WitnessLock(name, reentrant=False)


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    if not _ENABLED:
        return threading.RLock()
    return _WitnessLock(name, reentrant=True)


def make_condition(name: str) -> threading.Condition:
    """A plain ``threading.Condition`` — named for the static model's
    benefit only.  Conditions are NOT witnessed: ``wait()`` releases
    and re-acquires the underlying lock out of band, which would
    corrupt the per-thread held stack; the static analyzer still
    models ``with self._cv:`` nesting."""
    del name
    return threading.Condition()


def _call_site() -> str:
    """First caller frame outside this module, as ``file:line``."""
    frame = sys._getframe(1)
    while frame is not None and frame.f_code.co_filename == _THIS_FILE:
        frame = frame.f_back
    if frame is None:
        return "<unknown>:0"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


def _held_stack() -> list:
    """The calling thread's held WITNESSED LOCK OBJECTS, in
    acquisition order.  Objects, not names: two instances of one class
    share a NAME (type-level identity), and release bookkeeping must
    not confuse sibling instances.

    Entries invalidated by a CROSS-THREAD release (legal for
    ``threading.Lock`` handoff patterns — release() on another thread
    cannot reach this thread's TLS) are pruned lazily: a lock this
    thread still held would still name it as owner."""
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    elif held:
        me = threading.get_ident()
        if any(lock._owner_tid != me for lock in held):
            held[:] = [
                lock for lock in held if lock._owner_tid == me
            ]
    return held


class _WitnessLock:
    """Witnessed Lock/RLock stand-in: same acquire/release/context-
    manager surface, with order/holder/waiter bookkeeping around the
    real primitive."""

    def __init__(self, name: str, *, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = (
            threading.RLock() if reentrant else threading.Lock()
        )
        self._owner: str | None = None
        self._owner_tid: int | None = None
        #: tid -> (since_monotonic, thread_name); guarded by _STATE_LOCK
        self._waiters: dict = {}
        with _STATE_LOCK:
            _LOCKS.add(self)
            _ensure_watchdog_locked()

    # -- lock protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        thread = threading.current_thread()
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            self._note_waiting(thread)
            try:
                if timeout is not None and timeout >= 0:
                    got = self._inner.acquire(True, timeout)
                else:
                    got = self._inner.acquire()
            finally:
                self._clear_waiting(thread)
        if got:
            self._note_acquired(thread)
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self.reentrant:
            return self._owner_tid is not None
        return self._inner.locked()

    # -- bookkeeping -----------------------------------------------------

    def _note_waiting(self, thread) -> None:
        held_names = [lock.name for lock in _held_stack()]
        with _STATE_LOCK:
            self._waiters[thread.ident] = (
                time.monotonic(), thread.name
            )
            if held_names:
                _EVENTS.append({
                    "held": list(dict.fromkeys(held_names)),
                    "wanted": self.name,
                    "thread": thread.name,
                    "site": _call_site(),
                    "at": time.time(),
                })
        if held_names:
            # Function-local import: obs.flight imports make_lock from
            # this module.  record() is lock-free, so this is safe even
            # though the caller is about to block on a witnessed lock.
            from learningorchestra_tpu_torch.obs import flight as _flight
            _flight.record(
                "locks", "contention",
                wanted=self.name, thread=thread.name,
                held=list(dict.fromkeys(held_names)),
            )

    def _clear_waiting(self, thread) -> None:
        with _STATE_LOCK:
            self._waiters.pop(thread.ident, None)
            _STALLED_LOGGED.discard((self.name, thread.ident))

    def _note_acquired(self, thread) -> None:
        held = _held_stack()
        # Identity, not name: a reentrant re-acquire of THIS lock adds
        # no edges, but a sibling instance with the same type-level
        # name still records (the edge loop below skips the resulting
        # name self-edge).
        first = all(lock is not self for lock in held)
        if first:
            site = _call_site()
            with _STATE_LOCK:
                for h in dict.fromkeys(
                    lock.name for lock in held
                ):
                    if h == self.name:
                        continue
                    rec = _EDGES.get((h, self.name))
                    if rec is None:
                        if len(_EDGES) >= _MAX_EDGES:
                            continue
                        rec = _EDGES[(h, self.name)] = {
                            "count": 0, "site": site,
                        }
                    rec["count"] += 1
        held.append(self)
        self._owner = thread.name
        self._owner_tid = thread.ident

    def _note_released(self) -> None:
        held = getattr(_TLS, "held", [])
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        if all(lock is not self for lock in held):
            self._owner = None
            self._owner_tid = None


# -- stall watchdog ----------------------------------------------------------


def _ensure_watchdog_locked() -> None:
    """Start the stall watchdog lazily with the first witnessed lock
    (caller holds _STATE_LOCK)."""
    global _WATCHDOG, _WATCHDOG_STOP
    if _WATCHDOG is not None and _WATCHDOG.is_alive():
        return
    stop = threading.Event()
    _WATCHDOG_STOP = stop
    _WATCHDOG = threading.Thread(
        target=_watchdog_loop, args=(stop,),
        name="lo-lock-witness", daemon=True,
    )
    _WATCHDOG.start()


def _watchdog_loop(stop: threading.Event) -> None:
    while not stop.wait(1.0):
        stall_s = _stall_threshold_s()
        now = time.monotonic()
        dumps = []
        with _STATE_LOCK:
            for lock in list(_LOCKS):
                for tid, (since, tname) in lock._waiters.items():
                    key = (lock.name, tid)
                    if now - since > stall_s and key not in _STALLED_LOGGED:
                        _STALLED_LOGGED.add(key)
                        dumps.append((lock.name, tname, now - since,
                                      lock._owner))
        for name, waiter, for_s, owner in dumps:
            # Outside the state lock: formatting stacks is slow.
            _logger.error(
                "lock witness: %s has waited %.1fs for %s "
                "(holder: %s) — possible deadlock; "
                "GET /observability/locks for the full dump\n%s",
                waiter, for_s, name, owner or "<unheld>",
                _format_stacks(),
            )
            # A stall is exactly the moment the flight rings are worth
            # freezing: record the episode and ask for a debug bundle
            # (no-op unless a server has wired the bundle service).
            from learningorchestra_tpu_torch.obs import bundle as _bundle
            from learningorchestra_tpu_torch.obs import flight as _flight
            _flight.record(
                "locks", "stall",
                lock=name, thread=waiter,
                forS=round(for_s, 3), holder=owner or "",
            )
            _bundle.trigger(
                "lock_stall",
                lock=name, thread=waiter, forS=round(for_s, 3),
            )


def _format_stacks() -> str:
    frames = sys._current_frames()
    out = []
    for thread in threading.enumerate():
        frame = frames.get(thread.ident)
        if frame is None:
            continue
        out.append(f"--- {thread.name} ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


# -- snapshot / reset --------------------------------------------------------


def snapshot(include_stacks: bool = False) -> dict:
    """The witness's observed state: edges, contention events, and the
    currently held/contended locks with holders and waiters (plus
    their live stacks when ``include_stacks`` — the
    ``GET /observability/locks`` dump)."""
    now = time.monotonic()
    stall_s = _stall_threshold_s()
    with _STATE_LOCK:
        edges = [
            {"from": a, "to": b,
             "count": rec["count"], "site": rec["site"]}
            for (a, b), rec in sorted(_EDGES.items())
        ]
        events = list(_EVENTS)
        locks = []
        involved: set = set()
        registered = 0
        for lock in list(_LOCKS):
            registered += 1
            waiters = [
                {"thread": tname, "tid": tid,
                 "forS": round(now - since, 3)}
                for tid, (since, tname) in lock._waiters.items()
            ]
            if lock._owner is None and not waiters:
                continue
            if lock._owner_tid is not None:
                involved.add(lock._owner_tid)
            involved.update(w["tid"] for w in waiters)
            locks.append({
                "name": lock.name,
                "reentrant": lock.reentrant,
                "owner": lock._owner,
                "waiters": waiters,
            })
    stalls = [
        {"name": entry["name"], "waiter": w["thread"],
         "forS": w["forS"]}
        for entry in locks for w in entry["waiters"]
        if w["forS"] > stall_s
    ]
    doc = {
        "enabled": _ENABLED,
        "registeredLocks": registered,
        "stallThresholdS": stall_s,
        "edges": edges,
        "events": events,
        "locks": sorted(locks, key=lambda e: e["name"]),
        "stalls": stalls,
    }
    if include_stacks and involved:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        doc["stacks"] = {
            names.get(tid, str(tid)): traceback.format_stack(
                frames[tid]
            )
            for tid in sorted(involved) if tid in frames
        }
    return doc


def reset() -> None:
    """Drop every recorded edge/event (tests isolate scenarios with
    this; live locks and their holder state are untouched)."""
    with _STATE_LOCK:
        _EDGES.clear()
        _EVENTS.clear()
        _STALLED_LOGGED.clear()


def _dump_at_exit() -> None:
    path = os.environ.get("LO_TPU_WITNESS_DUMP", "").strip()
    if not path or not _ENABLED:
        return
    try:
        with open(path, "w") as fh:
            json.dump(snapshot(), fh, indent=2, default=str)
    except OSError:  # noqa: PERF203 — best-effort at exit
        pass


atexit.register(_dump_at_exit)
