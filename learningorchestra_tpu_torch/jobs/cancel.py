"""Cooperative cancellation tokens for job bodies — port of
``learningorchestra_tpu/jobs/cancel.py``.

Python threads cannot be killed: the engine's deadline watchdog can fail
an overdue job and reclaim its worker slot and device leases, but the
body runs on as a zombie.  The token closes that gap cooperatively: the
engine binds one per dispatched job (a contextvar, readable anywhere down
the body's call stack), flips it when the watchdog expires the job, a
bounded shutdown drain runs out of budget or a client cancels, and
long-running bodies poll it between units of work (``fit`` checks it at
every epoch boundary and winds down like an early stop).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading


class CancelToken:
    """One job's cancellation flag: set-once, thread-safe, cheap to poll.
    ``cancel()`` is idempotent and keeps the FIRST reason."""

    __slots__ = ("_event", "_reason")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._reason = ""

    def cancel(self, reason: str = "") -> None:
        if reason and not self._reason:
            self._reason = reason
        self._event.set()

    def cancelled(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> str:
        return self._reason

    def wait(self, timeout: float | None = None) -> bool:
        """Block until cancelled (or ``timeout``); returns the state, so
        a body can sleep interruptibly."""
        return self._event.wait(timeout)


#: The calling job body's token (None outside a dispatched job).
_TOKEN: contextvars.ContextVar = contextvars.ContextVar(
    "lo_cancel_token", default=None
)


def current_cancel_token() -> CancelToken | None:
    """The token bound around the current job dispatch, or None outside
    the engine (direct library use, tests)."""
    return _TOKEN.get()


def cancel_requested() -> bool:
    """True when the engine asked the current job body to wind down."""
    token = _TOKEN.get()
    return token is not None and token.cancelled()


@contextlib.contextmanager
def bind(token: CancelToken | None):
    """Bind ``token`` as the current job body's cancel token."""
    handle = _TOKEN.set(token)
    try:
        yield token
    finally:
        _TOKEN.reset(handle)
