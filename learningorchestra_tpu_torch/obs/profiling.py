"""On-demand profiler capture: ``torch.profiler`` behind a REST surface —
port of ``learningorchestra_tpu/obs/profiling.py``.

Nothing else can capture a profile from a LIVE process: the "serving p99
regressed in production, what is the card doing right now?" workflow.
This module owns that:

- ``start(...)`` opens ONE capture at a time into a bounded capture
  directory, with an auto-stop deadline so a forgotten capture cannot
  trace forever and fill the disk;
- ``stop()`` ends it, writes the trace and records the capture's file
  manifest;
- ``list_captures()`` / ``read_file(...)`` serve listing and retrieval,
  so an operator pulls the trace over HTTP.

The trace is a Chrome trace, ``<capture>/plugins/profile/<time>/
<host>.pt.trace.json`` (the TensorBoard profile plugin's layout), where
the JAX package writes ``.xplane.pb``; both open offline in TensorBoard's
profile plugins or in Perfetto.  Activities are the CPU, plus CUDA where
a card is visible (CUPTI records every kernel on the card, whichever
thread launched it), and the CPU side records every thread
(``profile_all_threads``): a capture started from a REST thread sees the
serving batchers' and the job threads' operators.

Every profiler the port starts goes through :func:`start_warm`.  Measured
on an H100 late in a long-lived process (never in a fresh one): after
the tracer is enabled, the device records of the first ~50 kernels and
copies the process launches are dropped, whichever thread launches them,
while their runtime launches are traced; a wait does not help, launches
do.  So a start enables the tracer (``prepare_trace``), launches
:data:`WARMUP_LAUNCHES` probe kernels on each card the process holds a
context on and waits for them, and only then opens the recording window
(``start_trace``): the drop falls on the probe, whose records lie before
the window and are left out of the trace.

``torch.profiler`` is process-global and has no guard of its own: a
second profiler started while one runs stops the first one's session,
and stopping the first then crashes the process.  So every profiler the
port starts claims the process first (:func:`claim`: under one lock,
refused while any ``torch.profiler`` is active, the port's or a
caller's), and a start that cannot claim it answers 409.

Knobs (``LO_TPU_PROF_*``, ``config.ProfilingConfig``): capture dir,
auto-stop seconds, retained-capture cap (the oldest captures beyond it
are deleted at the next start: bounded disk, newest evidence wins).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import socket
import threading
import time

from learningorchestra_tpu_torch.concurrency_rt import make_lock

__all__ = [
    "ProfilerConflict",
    "ProfilerError",
    "ProfilerNotFound",
    "ProfilerService",
    "WARMUP_LAUNCHES",
    "activities",
    "claim",
    "profiler_active",
    "start_warm",
    "trace_path",
]

_NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*")
_META_FILE = "capture.json"
#: Probe kernels launched on each card between the tracer's enable and
#: the recording window (:func:`start_warm`); the drop they absorb was
#: 33–62 records on an H100.
WARMUP_LAUNCHES = 512

# Serializes every start of a torch.profiler the port makes.
_claim_lock = make_lock("profiling._claim_lock")


class ProfilerError(Exception):
    """Invalid profiler request (→ 406)."""


class ProfilerNotFound(Exception):
    """No such capture / capture file (→ 404)."""


class ProfilerConflict(Exception):
    """Capture state conflict: start while active, stop while idle
    (→ 409)."""


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` runs anywhere in the process (its
    Python flag is process-wide; the C++ one covers this thread)."""
    import torch
    import torch.autograd.profiler as autograd_profiler

    return bool(getattr(autograd_profiler, "_is_profiler_enabled", False)
                or torch._C._autograd._profiler_enabled())


def activities():
    """The CPU, and CUDA where a card is visible."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _all_threads_config():
    """The experimental config that records every thread's operators, or
    None on a torch without it (kernels are recorded all the same)."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def new_profile():
    """A ``torch.profiler.profile`` over every thread of the process."""
    from torch.profiler import profile

    config = _all_threads_config()
    if config is None:
        return profile(activities=activities())
    return profile(activities=activities(), experimental_config=config)


def _warm_devices() -> None:
    """Launch :data:`WARMUP_LAUNCHES` one-element kernels on each card the
    process holds a context on (never creating one), and wait for them."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    has_context = getattr(torch._C, "_cuda_hasPrimaryContext", None)
    if has_context is None:
        devices = [torch.cuda.current_device()]
    else:
        devices = [d for d in range(torch.cuda.device_count())
                   if has_context(d)]
    for device in devices:
        x = torch.zeros(1, device=f"cuda:{device}")
        for _ in range(WARMUP_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize(device)
    # A short settle, kept from the start sequence measured to keep every
    # record (PERF.md §6); the launches, not the wait, absorb the drop.
    time.sleep(0.03)


def start_warm(prof) -> None:
    """Start ``prof`` (a ``torch.profiler.profile``; stop it with
    ``prof.stop()``) with the device tracer warmed before its recording
    window opens, so the window's first device records are kept."""
    prof.prepare_trace()
    try:
        _warm_devices()
    except BaseException:
        prof.start_trace()
        prof.stop()
        raise
    prof.start_trace()


@contextlib.contextmanager
def claim():
    """Hold the process's profiler claim while starting one: yields True
    when no ``torch.profiler`` is active (start it inside the block),
    False when one is (do not start another)."""
    with _claim_lock:
        yield not profiler_active()


def trace_path(logdir: str) -> str:
    """Where a capture's Chrome trace goes (TensorBoard's layout)."""
    run = os.path.join(logdir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run, exist_ok=True)
    return os.path.join(run, f"{socket.gethostname() or 'host'}"
                             ".pt.trace.json")


class ProfilerService:
    """Single-flight ``torch.profiler`` capture manager."""

    def __init__(self, root: str, *, max_seconds: float = 60.0,
                 max_captures: int = 8):
        self.root = str(root)
        self.max_seconds = float(max_seconds)
        self.max_captures = max(1, int(max_captures))
        self._lock = make_lock("ProfilerService._lock")
        self._active: dict | None = None
        self._profile = None
        # True while a stop's trace export runs OUTSIDE the lock: a start
        # arriving in that window conflicts instead of racing it.
        self._stopping = False
        self._deadline_timer: threading.Timer | None = None
        self.captures_total = 0
        self.auto_stops = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self, name: str | None = None,
              max_seconds: float | None = None) -> dict:
        """Begin a capture.  ``name`` defaults to a timestamp;
        ``max_seconds`` overrides the auto-stop deadline (clamped to the
        configured cap: a REST caller must not disable the bound that
        keeps a forgotten capture from tracing forever)."""
        if name is None:
            name = time.strftime("capture-%Y%m%d-%H%M%S")
            # Same-second restarts (drills) must not collide.
            with self._lock:
                name = f"{name}-{self.captures_total}"
        if not isinstance(name, str) or not _NAME_RE.fullmatch(name):
            raise ProfilerError(
                f"invalid capture name {name!r} (names become "
                "directories under the capture root)")
        budget = self.max_seconds
        if max_seconds is not None:
            try:
                budget = float(max_seconds)
            except (TypeError, ValueError):
                raise ProfilerError(
                    f"maxSeconds must be a number, got {max_seconds!r}"
                ) from None
            if budget <= 0:
                raise ProfilerError("maxSeconds must be > 0")
            budget = min(budget, self.max_seconds)
        logdir = os.path.join(self.root, name)
        # Claim + start are atomic under the lock (and the process's
        # profiler claim): two racing starts, or a start racing a stale
        # deadline timer, serialize here.  Prune victims are chosen only
        # after this start is admitted (a refused start has no side
        # effects); their removal runs after the lock releases.
        with self._lock:
            if self._active is not None or self._stopping:
                raise ProfilerConflict(
                    "a profiler capture is already active or stopping"
                    + (f" ({self._active['name']!r})"
                       if self._active else "")
                    + "; stop it / retry shortly")
            if os.path.isdir(logdir):
                raise ProfilerConflict(
                    f"capture {name!r} already exists; pick another name")
            with claim() as free:
                if not free:
                    raise ProfilerConflict(
                        "another torch.profiler is active in this process "
                        "(a monitored job's trace or a caller's); retry "
                        "once it ends")
                victims = self._prune_victims(keep=name)
                os.makedirs(logdir, exist_ok=True)
                prof = new_profile()
                try:
                    start_warm(prof)
                except BaseException as exc:
                    # A failed start must never wedge the surface.
                    shutil.rmtree(logdir, ignore_errors=True)
                    raise ProfilerConflict(
                        f"torch.profiler could not start ({exc!r})"
                    ) from None
            self._profile = prof
            self._active = active = {
                "name": name, "logdir": logdir,
                "startedAt": time.time(), "deadlineS": budget,
            }
            timer = threading.Timer(budget, self._auto_stop, args=(name,))
            timer.daemon = True
            self._deadline_timer = timer
            self.captures_total += 1
            active = dict(active)
        timer.start()
        for victim in victims:
            shutil.rmtree(victim, ignore_errors=True)
        return active

    def stop(self) -> dict:
        """End the active capture; returns its manifest (name, files,
        total bytes).  No active capture → 409."""
        return self._stop_expected(None)

    def _stop_expected(self, expected: str | None, *,
                       auto: bool = False) -> dict:
        """Stop the active capture only if it is still ``expected`` (None:
        whatever is active).  The check and the state clear are atomic,
        so a stale deadline timer never stops a FRESH capture; the trace
        export runs outside the lock behind the ``_stopping`` sentinel, so
        status and listing requests never stack behind it.  ``auto``: the
        deadline timer's stop, counted as the sentinel clears, so a status
        that shows the capture stopped shows it counted."""
        with self._lock:
            active = self._active
            if active is None or (
                    expected is not None and active["name"] != expected):
                raise ProfilerConflict("no profiler capture is active")
            self._active = None
            self._stopping = True
            prof, self._profile = self._profile, None
            timer, self._deadline_timer = self._deadline_timer, None
        try:
            prof.stop()
            prof.export_chrome_trace(trace_path(active["logdir"]))
        except BaseException:  # noqa: BLE001 — what was written before
            pass  # the failure is still the evidence
        finally:
            with self._lock:
                self._stopping = False
                if auto:
                    self.auto_stops += 1
        if timer is not None:
            timer.cancel()
        manifest = {
            "name": active["name"],
            "startedAt": active["startedAt"],
            "stoppedAt": time.time(),
            "durationS": round(time.time() - active["startedAt"], 3),
            "files": _file_manifest(active["logdir"]),
        }
        manifest["totalBytes"] = sum(f["bytes"] for f in manifest["files"])
        try:
            with open(os.path.join(active["logdir"], _META_FILE),
                      "w") as fh:
                json.dump(manifest, fh)
        except OSError:
            pass  # listing degrades to the bare directory walk
        return manifest

    def _auto_stop(self, name: str) -> None:
        """Deadline expiry: stop the capture IFF it is still the one this
        timer was armed for (atomic inside _stop_expected)."""
        try:
            self._stop_expected(name, auto=True)
        except ProfilerConflict:
            pass  # lost the race to an operator stop

    # -- listing + retrieval -------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            active = dict(self._active) if self._active else None
            stopping = self._stopping
        return {
            "active": active,
            "stopping": stopping,
            "capturesTotal": self.captures_total,
            "autoStops": self.auto_stops,
            "root": self.root,
            "maxSeconds": self.max_seconds,
            "maxCaptures": self.max_captures,
        }

    def list_captures(self) -> list[dict]:
        """Every retained capture, oldest first, with file manifests."""
        if not os.path.isdir(self.root):
            return []
        with self._lock:
            active_name = self._active["name"] if self._active else None
        out = []
        for entry in sorted(os.listdir(self.root)):
            logdir = os.path.join(self.root, entry)
            if not os.path.isdir(logdir):
                continue
            doc = None
            meta = os.path.join(logdir, _META_FILE)
            if os.path.isfile(meta):
                try:
                    with open(meta) as fh:
                        doc = json.load(fh)
                except (OSError, ValueError):
                    doc = None
            if doc is None:
                doc = {"name": entry, "files": _file_manifest(logdir)}
                doc["totalBytes"] = sum(f["bytes"] for f in doc["files"])
            doc["active"] = entry == active_name
            out.append(doc)
        return out

    def capture(self, name: str) -> dict | None:
        for doc in self.list_captures():
            if doc["name"] == name:
                return doc
        return None

    def read_file(self, name: str, rel_path: str) -> bytes:
        """One capture artifact's bytes.  The resolved path must stay
        inside the capture's directory: ``rel_path`` comes off the
        wire."""
        if not _NAME_RE.fullmatch(name):
            raise ProfilerError(f"invalid capture name {name!r}")
        logdir = os.path.realpath(os.path.join(self.root, name))
        target = os.path.realpath(os.path.join(logdir, rel_path))
        if not target.startswith(logdir + os.sep):
            raise ProfilerError(
                f"file path {rel_path!r} escapes the capture")
        try:
            with open(target, "rb") as fh:
                return fh.read()
        except OSError:
            # Plain not-found (404), distinct from the traversal
            # rejection above (406).
            raise ProfilerNotFound(
                f"no file {rel_path!r} in capture {name!r}") from None

    def delete(self, name: str) -> bool:
        """Drop a retained capture (idempotent).  The active capture
        refuses: stop it first."""
        if not _NAME_RE.fullmatch(name):
            raise ProfilerError(f"invalid capture name {name!r}")
        with self._lock:
            if self._active is not None and self._active["name"] == name:
                raise ProfilerConflict(
                    f"capture {name!r} is active; stop it before deleting")
            if self._stopping:
                # A stop's trace export is in flight: deleting now would
                # race it re-creating the dir with partial files.
                raise ProfilerConflict(
                    "a capture is stopping; retry shortly")
        logdir = os.path.join(self.root, name)
        if not os.path.isdir(logdir):
            return False
        shutil.rmtree(logdir, ignore_errors=True)
        return True

    def _prune_victims(self, keep: str) -> list[str]:
        """Beyond ``max_captures`` (counting the ADMITTED capture about to
        start), the OLDEST capture dirs: newest evidence wins.  Selection
        only (the caller deletes outside the lock); the new capture and
        any active one are never victims."""
        if not os.path.isdir(self.root):
            return []
        active_name = self._active["name"] if self._active else None
        entries = []
        for entry in os.listdir(self.root):
            logdir = os.path.join(self.root, entry)
            if entry in (keep, active_name) or not os.path.isdir(logdir):
                continue
            try:
                entries.append((os.path.getmtime(logdir), logdir))
            except OSError:
                continue
        entries.sort()
        excess = len(entries) - (self.max_captures - 1)
        return [logdir for _mtime, logdir in entries[:max(0, excess)]]

    def close(self) -> None:
        """Server shutdown: end any active capture so the profiler does
        not outlive the process's surface."""
        with self._lock:
            active = self._active is not None
        if active:
            try:
                self.stop()
            except ProfilerConflict:
                pass


def _file_manifest(logdir: str) -> list[dict]:
    files = []
    for dirpath, _dirs, names in os.walk(logdir):
        for fname in names:
            if fname == _META_FILE:
                continue
            path = os.path.join(dirpath, fname)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            files.append({"path": os.path.relpath(path, logdir),
                          "bytes": size})
    files.sort(key=lambda f: f["path"])
    return files
