"""Monitoring service — managed TensorBoard sessions and their URL
registry — port of ``learningorchestra_tpu/services/monitoring.py``.

A train request carrying ``monitoringPath`` opens a session: a logdir
under the volume root, registered by nickname (atomic: concurrent starts
of one nickname share one session), with TensorBoard spawned on it when
``shutil.which("tensorboard")`` finds the binary and ``url`` None
otherwise; ``GET /monitoring/<tool>/<nickname>`` looks it up.  The job
writes its scalars there (``write_scalar_logs``: a tfevents file and a
CSV) and a profiler trace: ``torch.profiler`` here where the JAX package
records a ``jax.profiler`` trace (``profiled``; skipped, not failed,
when another profile is active).
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import socket
import subprocess
import threading
import time

from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.services.tfevents import write_scalars

# First char alphanumeric/underscore: forbids '.', '..' and path escapes.
_NICK_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*")
# Fixed API sub-routes under /monitoring/<tool>/ (compiled-program
# cache counters, serving stats): a session so named could be created
# but never read back — its GET is shadowed.
_RESERVED_NICKNAMES = frozenset(
    {"compileCache", "compile_cache", "serving"}
)


class MonitoringError(Exception):
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class MonitoringSession:
    def __init__(self, nickname: str, logdir: str):
        self.nickname = nickname
        self.logdir = logdir
        self.url: str | None = None
        self.port: int | None = None
        self.process: subprocess.Popen | None = None
        self.stopped = False  # set by stop(); guards the spawn race
        self.created = time.time()

    def to_dict(self) -> dict:
        return {
            "nickname": self.nickname,
            "logdir": self.logdir,
            "url": self.url,
            "port": self.port,
            "running": self.process is not None
            and self.process.poll() is None,
        }


class MonitoringService:
    """Supervised registry of monitoring sessions, nickname → session."""

    def __init__(self, root: str, *, host: str = "127.0.0.1",
                 external_host: str | None = None):
        """``host`` is where TensorBoard binds; ``external_host``, when
        set, is the address advertised in session URLs (and forces a
        0.0.0.0 bind, so the URL resolves to a listening interface)."""
        self.root = root
        self.host = "0.0.0.0" if external_host else host
        self.external_host = external_host
        self._sessions: dict[str, MonitoringSession] = {}
        self._lock = make_lock("MonitoringService._lock")

    # -- session lifecycle ---------------------------------------------------

    @staticmethod
    def valid_nickname(nickname: str) -> bool:
        return bool(_NICK_RE.fullmatch(nickname or "")) \
            and nickname not in _RESERVED_NICKNAMES

    def start(self, nickname: str, *, spawn_tensorboard: bool = True) -> dict:
        """Create (or return) the session for ``nickname``; concurrent
        starts of one nickname return the same session."""
        if not self.valid_nickname(nickname):
            # Nicknames become directory names under root, and the
            # reserved names are fixed API sub-routes.
            raise MonitoringError(f"invalid monitoring nickname {nickname!r}")
        with self._lock:
            existing = self._sessions.get(nickname)
            if existing is not None:
                return existing.to_dict()
            logdir = os.path.join(self.root, nickname)
            os.makedirs(logdir, exist_ok=True)
            session = MonitoringSession(nickname, logdir)
            self._sessions[nickname] = session
        if spawn_tensorboard:
            self._spawn_tensorboard(session)
        return session.to_dict()

    def _spawn_tensorboard(self, session: MonitoringSession) -> None:
        binary = shutil.which("tensorboard")
        if binary is None:
            return  # logdir-only session; scalars and traces still collect
        port = _free_port()
        try:
            # DEVNULL: nothing reads the child's output.
            cmd = [binary, "--logdir", session.logdir, "--port", str(port)]
            cmd += ["--host", self.host] if self.host != "0.0.0.0" \
                else ["--bind_all"]
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.STDOUT)
        except OSError:
            return
        doomed = None
        with self._lock:
            if session.stopped:
                doomed = proc  # stop() won the race
            else:
                session.process = proc
                session.port = port
        if doomed is not None:
            _reap(doomed)
            return

        # Readiness is probed off-thread: the caller is an HTTP handler;
        # ``url`` stays None until TensorBoard answers.
        def probe_ready():
            probe_host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
            deadline = time.time() + 30
            while time.time() < deadline:
                if proc.poll() is not None:
                    return  # died; stay logdir-only
                with socket.socket() as probe:
                    probe.settimeout(0.2)
                    if probe.connect_ex((probe_host, port)) == 0:
                        with self._lock:
                            if not session.stopped:
                                session.url = self.advertised_url(port)
                        return
                time.sleep(0.2)

        threading.Thread(target=probe_ready, daemon=True).start()

    def advertised_url(self, port: int) -> str:
        """The URL written into a ready session: the external host when
        configured, the bind host otherwise."""
        return f"http://{self.external_host or self.host}:{port}/"

    def lookup(self, nickname: str) -> dict:
        with self._lock:
            session = self._sessions.get(nickname)
        if session is None:
            raise MonitoringError(f"no monitoring session {nickname!r}")
        return session.to_dict()

    def list_sessions(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._sessions.values()]

    @staticmethod
    def compile_cache_stats() -> dict:
        """The process-wide program cache's counters
        (train/compile_cache.py), served at ``GET
        /monitoring/<tool>/compileCache``, with the per-program FLOPs and
        memory records under ``programCosts`` (obs/costs.py) and the
        durable program store's live counters under ``aot``
        (train/aot_store.py; the JAX disabled shape when it is off)."""
        from learningorchestra_tpu_torch.obs import costs
        from learningorchestra_tpu_torch.train import aot_store, compile_cache

        stats = compile_cache.get_cache().stats()
        if costs.enabled():
            stats["programCosts"] = costs.get_ledger().snapshot()
        stats["aot"] = aot_store.stats_snapshot()
        return stats

    def stop(self, nickname: str) -> bool:
        with self._lock:
            session = self._sessions.pop(nickname, None)
            if session is not None:
                session.stopped = True
        if session is None:
            return False
        if session.process is not None and session.process.poll() is None:
            _reap(session.process)
        return True

    def close(self) -> None:
        for nickname in list(self._sessions):
            self.stop(nickname)

    @contextlib.contextmanager
    def trace(self, nickname: str):
        """Record a ``torch.profiler`` trace of the with-block into the
        session's logdir; yields the session."""
        info = self.start(nickname, spawn_tensorboard=False)
        with profiled(info["logdir"]):
            yield info


def _reap(proc: subprocess.Popen) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@contextlib.contextmanager
def profiled(logdir: str):
    """A ``torch.profiler`` trace (CPU, and CUDA where a card is visible)
    of the with-block, written as a Chrome trace to
    ``<logdir>/plugins/profile/<time>/<host>.pt.trace.json`` (the
    TensorBoard profile plugin's layout).  Skipped, not failed, when
    another profile is active (``obs.profiling.claim``: a second
    ``torch.profiler`` would break the first)."""
    from torch.profiler import profile

    from learningorchestra_tpu_torch.obs.profiling import (
        activities,
        claim,
        start_warm,
        trace_path,
    )

    prof = profile(activities=activities())
    with claim() as free:
        started = free
        if free:
            try:
                start_warm(prof)
            except Exception:  # noqa: BLE001 — the trace is optional
                started = False
    try:
        yield
    finally:
        if started:
            prof.stop()
            with contextlib.suppress(Exception):
                prof.export_chrome_trace(trace_path(logdir))


def write_scalar_logs(logdir: str, history: dict, *, prefix: str = "") -> int:
    """Write a TrainHistory into the monitored logdir twice over: a
    tfevents file (services/tfevents.py) TensorBoard renders, and a CSV.
    Returns the epoch-row count."""
    os.makedirs(logdir, exist_ok=True)
    write_scalars(logdir, history, prefix=prefix)
    path = os.path.join(logdir, f"{prefix or 'metrics'}.csv")
    keys = sorted(history)
    n = max((len(v) for v in history.values()), default=0)
    with open(path, "w") as fh:
        fh.write(",".join(["step"] + keys) + "\n")
        for i in range(n):
            row = [str(i)] + [
                str(history[k][i]) if i < len(history[k]) else ""
                for k in keys
            ]
            fh.write(",".join(row) + "\n")
    return n
