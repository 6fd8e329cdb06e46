"""DecodeStream — one generation request's lifecycle in the engine —
port of ``learningorchestra_tpu/serve/decode/streams.py``.

A stream is the unit the continuous-batching scheduler admits: one
prompt, one KV slot (while live), one bounded event queue the transport
drains.  The SSE writer in ``api/server.py`` duck-types the payload on
``sse_events()`` and calls :meth:`abort` when the client disconnects
mid-body; the :class:`~learningorchestra_tpu_torch.jobs.cancel.CancelToken`
carries that into the decode worker, which frees the stream's slot at
the next step boundary.

Non-stream requests ride the same object (``eager=False``): the engine
reads their tokens off the card only when the row is done, and the HTTP
thread blocks on :meth:`wait_done`.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid

from learningorchestra_tpu_torch.jobs.cancel import CancelToken

#: Event-queue bound: ``total`` tokens plus lifecycle events always fit,
#: but a reader that stopped draining must not grow memory.
_QUEUE_CAP = 4096


class DecodeStream:
    """One prompt's decode: identity, cancel token, event queue."""

    __slots__ = (
        "stream_id", "model", "prompt", "t0", "total", "eager",
        "token", "events", "arrived", "first_at", "last_at",
        "tokens", "error", "_done",
    )

    def __init__(self, model: str, prompt, t0: int, total: int,
                 *, eager: bool):
        self.stream_id = uuid.uuid4().hex[:12]
        self.model = model
        self.prompt = prompt  # int32 (t0,) host array
        self.t0 = int(t0)
        self.total = int(total)
        # eager: the transport wants every token as it lands (SSE), so
        # the worker copies the step's token column to the host each step.
        self.eager = bool(eager)
        self.token = CancelToken()
        self.events: queue.Queue = queue.Queue(maxsize=_QUEUE_CAP)
        self.arrived = time.perf_counter()
        self.first_at: float | None = None
        self.last_at: float | None = None
        self.tokens: list[int] = []  # emitted continuation tokens
        self.error: str | None = None
        self._done = threading.Event()

    # -- engine side ---------------------------------------------------------

    def _push(self, name: str, doc: dict) -> None:
        try:
            self.events.put_nowait((name, doc))
        except queue.Full:
            pass  # reader stopped draining; the terminal state still
            # lands through _done / token, which the transports consult.

    def push_token(self, tok: int, pos: int) -> None:
        self.tokens.append(tok)
        self._push("token", {"t": tok, "i": pos})

    def finish(self) -> None:
        self._push("done", self.summary())
        self._done.set()

    def fail(self, message: str) -> None:
        self.error = message
        self.token.cancel(message)
        self._push("error", {"stream": self.stream_id, "error": message})
        self._done.set()

    def mark_aborted(self) -> None:
        """Worker-side acknowledgement that the slot was freed after
        :meth:`abort`: terminal for both transports."""
        self._push("aborted", {
            "stream": self.stream_id,
            "reason": self.token.reason or "aborted",
        })
        self._done.set()

    # -- transport side ------------------------------------------------------

    def abort(self, reason: str = "aborted") -> None:
        """Request teardown (client disconnect or DELETE).  The decode
        worker sees the token at its next step boundary and frees the
        slot; idempotent like the token itself."""
        self.token.cancel(reason)

    def done(self) -> bool:
        return self._done.is_set()

    def wait_done(self, timeout: float) -> bool:
        return self._done.wait(timeout)

    def summary(self) -> dict:
        doc = {
            "stream": self.stream_id,
            "model": self.model,
            "promptTokens": self.t0,
            "newTokens": len(self.tokens),
            "tokens": list(self.tokens),
        }
        if self.first_at is not None:
            doc["ttftMs"] = round((self.first_at - self.arrived) * 1e3, 3)
        if self.error is not None:
            doc["error"] = self.error
        return doc

    def sse_events(self):
        """The transport's event iterator: ``(event-name, doc)`` pairs,
        ending with a terminal ``done``/``error``/``aborted``.  Polls the
        cancel token between queue waits, so an engine that died without
        a terminal event still ends the response."""
        yield "open", {
            "stream": self.stream_id,
            "model": self.model,
            "promptTokens": self.t0,
            "maxTotal": self.total,
        }
        while True:
            try:
                name, doc = self.events.get(timeout=0.25)
            except queue.Empty:
                if self.token.cancelled():
                    yield "aborted", {
                        "stream": self.stream_id,
                        "reason": self.token.reason or "aborted",
                    }
                    return
                if self._done.is_set() and self.events.empty():
                    return  # terminal event already drained
                continue
            yield name, doc
            if name in ("done", "error", "aborted"):
                return
