"""Structured, leveled logging — port of ``learningorchestra_tpu/log.py``.

One leveled logger per component with a single-line structured format::

    2026-07-29T12:00:00 INFO lo.jobs job=mnist_fit state=finished dt=3.2s

and :func:`capture_thread_stdout`, which records a job's prints in its
execution document while every other thread keeps printing.
``LO_TPU_LOG_LEVEL`` sets the level (default INFO).
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import sys
import threading

from learningorchestra_tpu_torch.concurrency_rt import make_lock

_ROOT = "lo"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S",
        ))
        root.addHandler(handler)
    level = os.environ.get("LO_TPU_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(component: str) -> logging.Logger:
    """Logger for a component under the framework root
    (``get_logger("jobs")`` -> ``lo.jobs``)."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{component}")


def kv(**fields) -> str:
    """Format key=value pairs consistently for log lines."""
    return " ".join(f"{k}={v}" for k, v in fields.items())


class _StdoutRouter(io.TextIOBase):
    """Per-thread stdout demultiplexer: one real stream, each write sent
    to the calling thread's registered buffer if it has one
    (``contextlib.redirect_stdout`` would swap ``sys.stdout`` for every
    thread of the job engine at once)."""

    def __init__(self, real):
        self.real = real
        self.buffers: dict[int, io.StringIO] = {}

    def write(self, s):
        return self.buffers.get(threading.get_ident(), self.real).write(s)

    def flush(self):
        self.buffers.get(threading.get_ident(), self.real).flush()

    def writable(self):
        return True


_router_lock = make_lock("log._router_lock")


@contextlib.contextmanager
def capture_thread_stdout():
    """Capture THIS thread's stdout into a StringIO (yielded); other
    threads keep printing to the real stream.  The router is installed
    on first use and removed when the last capture exits.  Prints from
    threads the job itself starts pass through uncaptured."""
    buf = io.StringIO()
    tid = threading.get_ident()
    with _router_lock:
        router = sys.stdout
        if not isinstance(router, _StdoutRouter):
            router = _StdoutRouter(sys.stdout)
            sys.stdout = router
        prev = router.buffers.get(tid)  # nesting: restore on exit
        router.buffers[tid] = buf
    try:
        yield buf
    finally:
        with _router_lock:
            if prev is not None:
                router.buffers[tid] = prev
            else:
                router.buffers.pop(tid, None)
            if not router.buffers and sys.stdout is router:
                sys.stdout = router.real
