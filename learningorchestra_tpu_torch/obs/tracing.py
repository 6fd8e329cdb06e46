"""End-to-end job tracing: request IDs and named spans — port of
``learningorchestra_tpu/obs/tracing.py``.

A request id is minted at the API layer (or taken from the client's
``X-Request-Id`` header and echoed on every response), carried by the
job engine into the worker thread that runs the job, and every interval
on the way — queue wait, device lease, program build, each attempt and
each epoch — is recorded as a named span.  On a job's terminal record
the span list persists into the artifact's execution ledger
(store/artifacts.py), where ``GET /observability/jobs/<name>/trace``
serves it back as a span tree.

Context variables carry (request id, active trace, current span id) per
thread; the engine re-activates the submitting request's trace inside
its worker thread, so spans recorded anywhere down the stack attach to
the right job with the right parent.  Spans read only host clocks: no
span synchronises the device.

Span timestamps anchor to ONE (wall, monotonic) pair captured at trace
creation: durations are monotonic-accurate, wall times are readable.
Everything here is a no-op when the registry is disabled or tracing is
off (``ObsConfig.enabled`` / ``ObsConfig.trace``).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid

from learningorchestra_tpu_torch.concurrency_rt import make_lock


__all__ = [
    "JobTrace",
    "current_trace",
    "get_request_id",
    "new_request_id",
    "new_trace",
    "record_span",
    "set_request_id",
    "reset_request_id",
    "sampled",
    "span",
    "span_tree",
    "activate",
]

_REQUEST_ID: contextvars.ContextVar = contextvars.ContextVar(
    "lo_request_id", default=None
)
_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "lo_trace", default=None
)
_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "lo_span", default=None
)


# -- request ids --------------------------------------------------------------


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def set_request_id(request_id: str | None):
    """Bind the calling thread's current request id; returns the token
    for :func:`reset_request_id`."""
    return _REQUEST_ID.set(request_id)


def reset_request_id(token) -> None:
    _REQUEST_ID.reset(token)


def get_request_id() -> str | None:
    return _REQUEST_ID.get()


# -- traces and spans ---------------------------------------------------------


class JobTrace:
    """Span accumulator for one job.  Thread-safe: the engine worker,
    the train loop and (via the compile cache) coalesced builders may
    all record into it."""

    def __init__(self, job: str, request_id: str | None = None,
                 max_spans: int = 512):
        self.job = job
        self.request_id = request_id
        self.max_spans = int(max_spans)
        self._lock = make_lock("JobTrace._lock")
        self._spans: dict[int, dict] = {}
        self._next_id = 1
        self.dropped = 0
        # One (wall, monotonic) anchor: every span's monotonic stamps
        # convert to wall time through it, so durations stay immune to
        # wall-clock jumps while start/end remain human-readable.
        self._wall0 = time.time()
        self._mono0 = time.monotonic()

    def _wall(self, mono: float) -> float:
        return self._wall0 + (mono - self._mono0)

    def begin(self, name: str, parent: int | None = None,
              attrs: dict | None = None) -> int:
        """Open a span; returns its id, or -1 past the span cap (the
        caller then skips the matching :meth:`end`)."""
        t0 = time.monotonic()
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return -1
            sid = self._next_id
            self._next_id += 1
            self._spans[sid] = {
                "id": sid,
                "parent": parent,
                "name": name,
                "start": round(self._wall(t0), 6),
                "end": None,
                "durationS": None,
                "attrs": dict(attrs or {}),
                "_t0": t0,
            }
            return sid

    def end(self, sid: int) -> None:
        if sid < 0:
            return
        t1 = time.monotonic()
        with self._lock:
            rec = self._spans.get(sid)
            if rec is None or rec["end"] is not None:
                return
            rec["end"] = round(self._wall(t1), 6)
            rec["durationS"] = round(t1 - rec["_t0"], 6)

    def add_span(self, name: str, t0: float, t1: float,
                 parent: int | None = None,
                 attrs: dict | None = None) -> int:
        """Record an already-elapsed interval (monotonic stamps)."""
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return -1
            sid = self._next_id
            self._next_id += 1
            self._spans[sid] = {
                "id": sid,
                "parent": parent,
                "name": name,
                "start": round(self._wall(t0), 6),
                "end": round(self._wall(t1), 6),
                "durationS": round(t1 - t0, 6),
                "attrs": dict(attrs or {}),
                "_t0": t0,
            }
            return sid

    def to_doc(self) -> dict:
        """JSON-safe record for the execution ledger.  Unfinished
        spans (a crash mid-interval) keep ``end: None`` — visibly
        open, never fabricated."""
        with self._lock:
            spans = [
                {k: v for k, v in rec.items() if not k.startswith("_")}
                for _sid, rec in sorted(self._spans.items())
            ]
        return {
            "requestId": self.request_id,
            "job": self.job,
            "spans": spans,
            "droppedSpans": self.dropped,
        }


def sampled(basis: str, fraction: float) -> bool:
    """Deterministic sampling decision for ``basis`` (a request id, or
    the job name when the submission carried none): a retried request
    samples the SAME way, so a drill re-running one request id either
    always has its span tree or never does — no flaky traces."""
    if fraction >= 1.0:
        return True
    if fraction <= 0.0:
        return False
    import zlib

    return (zlib.crc32(basis.encode()) % 10_000) < fraction * 10_000


def new_trace(job: str, request_id: str | None = None) -> JobTrace | None:
    """A JobTrace sized from config, or None when tracing is off or
    the LO_TPU_OBS_TRACE_SAMPLE decision excluded this job — callers
    guard every later touch on that None (a sampled-out job keeps all
    its metrics; only the persisted span tree is skipped)."""
    from learningorchestra_tpu_torch.obs.metrics import get_registry

    registry = get_registry()
    if not registry.trace_enabled:
        return None
    if not sampled(request_id or job,
                   getattr(registry, "trace_sample", 1.0)):
        return None
    return JobTrace(job, request_id, max_spans=registry.max_spans)


def current_trace() -> JobTrace | None:
    return _TRACE.get()


@contextlib.contextmanager
def activate(trace: JobTrace | None, root_span: int | None = None):
    """Bind ``trace`` (and optionally a current span) to the calling
    thread for the with-block — the engine's worker-thread handoff."""
    t_token = _TRACE.set(trace)
    s_token = _SPAN.set(root_span)
    r_token = (
        _REQUEST_ID.set(trace.request_id)
        if trace is not None and trace.request_id else None
    )
    try:
        yield trace
    finally:
        _TRACE.reset(t_token)
        _SPAN.reset(s_token)
        if r_token is not None:
            _REQUEST_ID.reset(r_token)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record the with-block as a named span on the current trace (a
    no-op when none is active).  Spans opened inside nest under it."""
    trace = _TRACE.get()
    if trace is None:
        yield None
        return
    sid = trace.begin(name, parent=_SPAN.get(), attrs=attrs)
    token = _SPAN.set(sid) if sid >= 0 else None
    try:
        yield sid
    finally:
        if token is not None:
            _SPAN.reset(token)
        trace.end(sid)


def record_span(name: str, duration_s: float, **attrs) -> None:
    """Record an interval that just ended (duration known, end = now)
    on the current trace — the cheap form for per-epoch loops that
    already time themselves."""
    trace = _TRACE.get()
    if trace is None:
        return
    t1 = time.monotonic()
    trace.add_span(
        name, t1 - max(0.0, float(duration_s)), t1,
        parent=_SPAN.get(), attrs=attrs,
    )


def span_tree(spans: list[dict]) -> list[dict]:
    """Flat parent-linked span list → nested tree (children sorted by
    start time), the shape the trace endpoint serves."""
    nodes = {
        rec["id"]: {**rec, "children": []}
        for rec in spans
        if isinstance(rec.get("id"), int)
    }
    roots: list[dict] = []
    for rec in spans:
        node = nodes.get(rec.get("id"))
        if node is None:
            continue
        parent = nodes.get(rec.get("parent"))
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)

    def sort_rec(items: list[dict]) -> None:
        items.sort(key=lambda n: (n.get("start") or 0, n["id"]))
        for item in items:
            sort_rec(item["children"])

    sort_rec(roots)
    return roots
