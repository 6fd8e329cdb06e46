"""The async job engine — port of ``learningorchestra_tpu/jobs/engine.py``.

Every pipeline step runs as a job on a worker thread and signals
completion through its artifact's metadata document, the durable contract
clients poll:

- explicit states (pending -> running -> finished | failed | cancelled)
  persisted as ``jobState`` beside the ``finished`` flag, and an
  execution document per run (parameters, exception, captured stdout,
  the job's span tree);
- a process-local registry of live jobs, so ``wait`` / ``cancel`` /
  ``state`` work without polling the store;
- structured retry for preemptible hardware: a body raising
  :class:`Preempted` (or a ``preempt`` fault schedule, faults/plane.py)
  re-executes up to ``max_preemption_retries`` times after a jittered
  backoff; each attempt is journaled, traced as its own span, and a
  body reads :func:`current_attempt` to resume (the executor resumes a
  retried fit from its newest managed checkpoint);
- weighted-fair dispatch across job classes (service types): submissions
  queue per class and freed workers go to classes by weighted
  round-robin, so one service's burst cannot starve another's job;
- a deadline watchdog that fails an overdue job, reclaims its worker and
  device leases and flips its cancel token, and a bounded shutdown;
- warm-start preference: a submission may carry a ``warm_key`` (its
  programs' fingerprint, train/compile_cache.py); once a job reports it
  warm (:meth:`JobEngine.note_warm`), queued jobs with that key dispatch
  first within their class's round-robin turn, at most four times in a
  row past the class's FIFO head;
- the operations plane: the submitting request's id and trace
  (obs/tracing.py) ride into the worker, with ``queue_wait``, one
  ``job`` span per attempt and ``retry_backoff`` spans; queue waits and
  state transitions feed the registry (obs/metrics.py); dispatch, retry
  and terminal decisions land in the ``jobs`` flight ring; a
  retries-exhausted or deadline terminal asks for a debug bundle;
- four ``None``-able hooks the service context sets: ``journal``
  (:class:`~learningorchestra_tpu_torch.jobs.journal.JobJournal`), which
  records every transition and fences each terminal commit against the
  store's engine epoch (each dispatched body runs under its boot's epoch
  stamp); ``notifier`` (the webhooks and event feed), told of every
  transition; ``cluster`` (jobs/cluster.py), whose claim every dispatch
  must win before its body runs (a lost claim means a peer engine owns
  the job) and releases after; and ``admission``, the per-tenant
  queued / running counters;
- per-tenant fairness: a submission carries the requesting tenant
  (``X-Tenant``, bound by the API tier); once any tenanted submission
  arrived, each class's turn serves its tenants round-robin, so one
  tenant's flood delays, never starves, another's jobs.
"""

from __future__ import annotations

import contextlib
import contextvars
import io
import random
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.jobs import cancel as jobs_cancel
from learningorchestra_tpu_torch.jobs import journal as jobs_journal
from learningorchestra_tpu_torch.jobs.cancel import CancelToken
from learningorchestra_tpu_torch.log import (
    capture_thread_stdout,
    get_logger,
    kv,
)
from learningorchestra_tpu_torch.obs import bundle as obs_bundle
from learningorchestra_tpu_torch.obs import flight as obs_flight
from learningorchestra_tpu_torch.obs import tracing
from learningorchestra_tpu_torch.obs.metrics import get_registry
from learningorchestra_tpu_torch.store.artifacts import ArtifactStore

logger = get_logger("jobs")

#: Which retry attempt the calling job body is running as: 0 on the first
#: execution, N after N preemptions (bound by the engine per attempt).
_ATTEMPT: contextvars.ContextVar = contextvars.ContextVar(
    "lo_job_attempt", default=0)

#: Metric family names (the JAX engine's).
JOBS_QUEUE_WAIT = "lo_jobs_queue_wait_seconds"
JOBS_TOTAL = "lo_jobs_total"


def current_attempt() -> int:
    """0 on a job's first execution, N inside its Nth preemption retry;
    valid anywhere down the job body's call stack."""
    return _ATTEMPT.get()


def _current_tenant():
    """The requesting tenant bound by the API tier, or None (imported at
    use: the raw engine's import path stays without jobs.cluster)."""
    from learningorchestra_tpu_torch.jobs.cluster import current_tenant

    return current_tenant()


def _job_metrics():
    """The engine's families, resolved per use so a registry reset takes
    effect at once."""
    reg = get_registry()
    return (
        reg.histogram(
            JOBS_QUEUE_WAIT,
            "Queue wait from submit to dispatch, per fairness class.",
            labels=("job_class",),
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                     60.0, 300.0, 1800.0),
        ),
        reg.counter(
            JOBS_TOTAL,
            "Job state transitions by class (finished/failed are "
            "terminal; preempted counts each retry attempt).",
            labels=("job_class", "state"),
        ),
    )


class JobState:
    PENDING = "pending"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


class Preempted(Exception):
    """Raised by a job body to request re-execution after preemption."""


class JobDeadlineExceeded(Exception):
    """A job body ran past its deadline: the watchdog failed the job and
    reclaimed its worker and leases; the body finishes as an abandoned
    zombie whose result is discarded."""


class JobEngine:
    #: Watchdog poll cadence (deadlines are a coarse hang bound).
    WATCHDOG_INTERVAL_S = 0.1
    #: Post-cancel join grace inside a bounded shutdown drain.
    SHUTDOWN_GRACE_S = 2.0
    #: Completed futures kept for ``wait`` after their job ended.
    _MAX_DONE_RETAINED = 128

    def __init__(
        self,
        artifacts: ArtifactStore,
        max_workers: int = 8,
        class_weights: dict[str, int] | None = None,
        deadline_s: float = 0.0,
        shutdown_drain_s: float = 0.0,
        max_preemption_retries: int = 3,
        retry_backoff_s: float = 0.05,
        retry_backoff_max_s: float = 5.0,
    ):
        self.artifacts = artifacts
        self.max_workers = max_workers
        self.max_preemption_retries = int(max_preemption_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        # One thread per DISPATCHED job, gated by _inflight: a fixed pool
        # would have no thread for the job a deadline reclaim freed a
        # slot for while the zombie still pins its own.
        self._threads: set[threading.Thread] = set()
        self.default_deadline_s = float(deadline_s)
        self.shutdown_drain_s = float(shutdown_drain_s)
        # Device-lease pool (set by the service context): the watchdog
        # revokes an expired job's leases through it.
        self.leaser = None
        # name -> dispatch record of RUNNING jobs; the watchdog scans it.
        self._running_recs: dict[str, dict] = {}
        self._watchdog: threading.Thread | None = None
        self._watchdog_wake = threading.Event()
        self._futures: dict[str, Future] = {}
        self._lock = make_lock("JobEngine._lock")
        # Weighted round-robin over per-class FIFO queues: a class's
        # weight is its consecutive dispatches per turn (default 1).
        self.class_weights = dict(class_weights or {})
        self._queues: dict[str, deque] = {}
        self._rr_order: list[str] = []
        self._rr_idx = 0
        self._credits: dict[str, int] = {}
        self._inflight = 0
        self._shutdown = False
        # Warm-start hints (train/compile_cache.py): within a class's
        # turn the dispatcher prefers queued jobs whose programs are
        # already built.  A bounded FIFO registry of hints, not a ledger.
        self._warm_keys: "OrderedDict[str, None]" = OrderedDict()
        self._max_warm_keys = 512
        # Starvation bound: after this many CONSECUTIVE warm bypasses of
        # a class's FIFO head, the head dispatches regardless.
        self._warm_bypass: dict[str, int] = {}
        self._max_warm_bypass = 4
        # Webhooks and the event feed (services/webhooks.py), set by the
        # service context; None: nobody is told.
        self.notifier = None
        # The crash-durable job journal (jobs/journal.py), set by the
        # service context; None disables journaling and fencing.
        self.journal = None
        # The cluster coordinator (jobs/cluster.py), set by the service
        # context when multi-engine dispatch is on: every dispatch claims
        # its job first.  None: one engine, one attribute check.
        self.cluster = None
        # Per-tenant admission counters (jobs/cluster.py TenantAdmission),
        # set by the context when a quota is configured; None disables.
        self.admission = None
        # Nested tenant fairness: per-class last-served tenant.  The scan
        # runs only once a tenanted submission arrived, so untenanted
        # deployments keep the plain FIFO pop.
        self._tenant_rr: dict[str, str] = {}
        self._tenant_seen = False

    def _journal(self, name: str, event: str, **fields) -> None:
        """Append one transition record (never raises: the journal counts
        and logs its own failures)."""
        if self.journal is not None:
            self.journal.append(event, name, **fields)

    def _fence_refused(self, name: str, req: dict | None = None) -> bool:
        """True when the calling body's engine epoch is stale: a newer
        recovery owns the store, so every terminal write must be
        skipped."""
        if self.journal is None:
            return False
        try:
            self.journal.fence_check()
        except jobs_journal.StaleEpochError as exc:
            logger.error(kv(job=name, state="fenced", error=str(exc),
                            **(req or {})))
            obs_flight.record("jobs", "fence_refused", job=name)
            return True
        return False

    def _notify(self, name: str, event: str) -> None:
        """Tell the notifier of a transition; never raises, never blocks
        (delivery runs on the notifier's own thread)."""
        if self.notifier is None:
            return
        try:
            meta = self.artifacts.metadata.read(name) or {}
            self.notifier.notify(name, event, meta)
        except Exception:  # noqa: BLE001 — jobs must finish regardless
            logger.exception(kv(job=name, event="notify_failed"))

    # -- submission -----------------------------------------------------------

    def submit(
        self,
        name: str,
        fn: Callable[[], Any],
        *,
        description: str | None = None,
        method: str | None = None,
        parameters: Any = None,
        capture_stdout: bool = False,
        on_success: Callable[[Any], dict | None] | None = None,
        job_class: str = "default",
        warm_key: str | None = None,
        deadline_s: float | None = None,
    ) -> Future:
        """Run ``fn`` asynchronously as the job of artifact ``name``, whose
        metadata document must already exist (the HTTP response returns
        before the work runs).

        ``on_success(result)`` may return fields to merge into the
        finished metadata.  ``job_class`` is the fairness pool.
        ``warm_key`` is the job's program tag: once any job reports it
        warm (:meth:`note_warm`), queued jobs with the same tag go first
        within their class's turn.
        ``deadline_s`` bounds the body's wall clock per dispatch (None
        inherits the engine default, ``<= 0`` disables)."""
        # The submitting request's id (minted or echoed at the API layer)
        # rides into the metadata, log lines and the job's trace.
        request_id = tracing.get_request_id()
        trace = tracing.new_trace(name, request_id)
        t_submit = time.monotonic()
        # The requesting tenant rides into the queue entry (nested fair
        # share) and into the metadata (attribution).
        tenant = _current_tenant()
        # Persist the request parameters now, not only in the terminal
        # record: a bare PATCH re-run of a job whose first run died
        # re-uses them.
        stamp = {}
        if parameters is not None:
            stamp["requestParameters"] = parameters
        if request_id:
            stamp["requestId"] = request_id
        if tenant:
            stamp["tenant"] = tenant
        if stamp:
            self.artifacts.metadata.update(name, stamp)
        # Shared with the watchdog: once ``expired`` flips, the body is a
        # zombie and every terminal write below is discarded.
        ctl = {"expired": False}
        token = CancelToken()

        def run() -> Any:
            # The body carries its boot's engine epoch: terminal commits
            # and publications compare it with the store's (fencing).
            epoch = self.journal.epoch if self.journal is not None else None
            # Clustered: the body runs only after this engine wins the
            # job's claim; a lost claim (or any claim-path error) means a
            # peer owns it, and this future resolves None.
            claim_ctx = contextlib.nullcontext()
            if self.cluster is not None:
                try:
                    owned = self.cluster.claim(name, info["enqueued_at"])
                except Exception:  # noqa: BLE001 — lost, never a crash
                    logger.exception(kv(job=name, event="claim_failed"))
                    owned = False
                if not owned:
                    if self.admission is not None:
                        self.admission.note_dequeued(tenant)
                    obs_flight.record("jobs", "claim_lost", job=name,
                                      jobClass=job_class)
                    logger.info(kv(job=name, state="claim_lost"))
                    return None
                from learningorchestra_tpu_torch.jobs.cluster import (
                    bind_claim,
                )

                claim_ctx = bind_claim(name)
            if self.admission is not None:
                self.admission.note_dispatch(tenant, job_class)
            try:
                with jobs_cancel.bind(token), jobs_journal.stamp(epoch), \
                        claim_ctx:
                    return self._run(
                        name, fn, ctl, token, description=description,
                        method=method, parameters=parameters,
                        capture_stdout=capture_stdout,
                        on_success=on_success, job_class=job_class,
                        trace=trace, t_submit=t_submit,
                        request_id=request_id)
            finally:
                if self.admission is not None:
                    self.admission.note_done(tenant, job_class)
                if self.cluster is not None:
                    try:
                        self.cluster.release(name)
                    except Exception:  # noqa: BLE001 — best effort: the
                        # lease's TTL reclaims it.
                        logger.exception(kv(job=name,
                                            event="claim_release_failed"))

        future: Future = Future()
        deadline = (
            self.default_deadline_s if deadline_s is None
            else float(deadline_s)
        )
        info = {"name": name, "job_class": job_class, "deadline": deadline,
                "ctl": ctl, "token": token, "warm_key": warm_key,
                "tenant": tenant,
                # Submit wall time: the claim table's supersede rule
                # compares it with a released claim's completion time.
                "enqueued_at": time.time()}
        # Queued-quota accounting before the enqueue (the dispatcher may
        # pop the entry as soon as the lock drops).
        if self.admission is not None:
            self.admission.note_queued(tenant)
        # Journaled ahead of the in-memory enqueue, outside the engine
        # lock (a late append drains inline through the store).
        if self.journal is not None:
            self.journal.record_submit(
                name, job_class=job_class, method=method,
                description=description,
                deadline_s=deadline if deadline else None,
                request_id=request_id)
        with self._lock:
            refused = self._shutdown
            if not refused:
                if tenant:
                    self._tenant_seen = True
                queue = self._queues.get(job_class)
                if queue is None:
                    queue = self._queues[job_class] = deque()
                    self._rr_order.append(job_class)
                    self._credits[job_class] = self._weight(job_class)
                queue.append((run, future, info))
                self._futures[name] = future
                self._prune_locked()
                self._dispatch_locked()
        if refused:
            if self.admission is not None:
                self.admission.note_dequeued(tenant)
            # The journal already holds the submitted/queued pair: end
            # that life, or recovery would resurrect a refused job.
            self._journal(name, "cancelled",
                          reason="engine shut down before enqueue")
            raise RuntimeError("cannot submit jobs after engine shutdown")
        return future

    def _run(self, name, fn, ctl, token, *, description, method,
             parameters, capture_stdout, on_success, job_class, trace,
             t_submit, request_id) -> Any:
        meta = self.artifacts.metadata
        t_start = time.monotonic()
        queue_wait_hist, jobs_total = _job_metrics()
        queue_wait_hist.observe(t_start - t_submit, job_class=job_class)
        if trace is not None:
            trace.add_span("queue_wait", t_submit, t_start,
                           attrs={"class": job_class})
        # req=<id> on every engine log line of this job: the key tying
        # logs, metadata and the span tree together.
        req = {"req": request_id} if request_id else {}
        attempts = 0
        job_sid = None  # the current attempt's span

        def trace_doc():
            """End the attempt span and snapshot the trace for a TERMINAL
            ledger record (None when tracing is off)."""
            if trace is None:
                return None
            if job_sid is not None:
                trace.end(job_sid)
            return trace.to_doc()

        def record(state, exception=None, stdout=None, terminal=True):
            # A job that printed nothing records no stdout.
            self.artifacts.ledger.record(
                name, description=description, method=method,
                parameters=parameters, state=state, exception=exception,
                stdout=stdout or None,
                trace=trace_doc() if terminal else None)

        def commit_cancelled(detail: str | None = None):
            """A RUNNING job cancelled through :meth:`cancel`: the body
            wound down (or died doing so) -> CANCELLED, not finished or
            failed.  Fenced like every terminal commit."""
            if self._fence_refused(name, req):
                return None
            reason = token.reason or "cancel requested"
            logger.warning(kv(job=name, state="cancelled", reason=reason,
                              **req))
            self._journal(name, "cancelled", reason=reason)
            meta.update(name, {
                "jobState": JobState.CANCELLED,
                "finished": False,
                "exception": f"cancelled: {reason}"
                + (f" ({detail})" if detail else ""),
            })
            jobs_total.inc(job_class=job_class, state="cancelled")
            record(JobState.CANCELLED, exception=detail)
            self._notify(name, "cancelled")
            return None

        while True:
            if ctl["expired"]:
                # Expired before this attempt started (or in its retry
                # backoff): the failure is recorded, the worker handed on.
                logger.warning(kv(job=name, state="abandoned", **req))
                return None
            if token.cancelled():
                if ctl.get("cancelled"):
                    return commit_cancelled()
                # The bounded shutdown drain, before an attempt started.
                logger.warning(kv(job=name, state="cancelled", **req))
                self._journal(name, "cancelled",
                              reason=token.reason or None)
                meta.mark_failed(
                    name, f"cancelled: {token.reason or 'engine shutdown'}")
                return None
            # One span per attempt: retries are separate intervals in the
            # persisted trace.
            if trace is not None:
                job_sid = trace.begin("job", attrs={"attempt": attempts + 1})
            with tracing.activate(trace, job_sid):
                self._journal(name, "running", attempt=attempts + 1)
                meta.mark_running(name)
                logger.info(kv(job=name, state="running", method=method,
                               attempt=attempts + 1, **req))
                # Feed only: webhooks register for finished/failed.
                self._notify(name, "running")
                buf = io.StringIO()
                attempt_token = _ATTEMPT.set(attempts)
                try:
                    faults.hit("engine.dispatch")
                    obs_flight.record("jobs", "dispatch", job=name,
                                      method=method, jobClass=job_class,
                                      attempt=attempts + 1)
                    if capture_stdout:
                        # Thread-scoped: only this job's prints.
                        with capture_thread_stdout() as buf:
                            result = fn()
                    else:
                        result = fn()
                except Preempted:
                    if ctl["expired"]:
                        logger.warning(kv(job=name, state="abandoned",
                                          **req))
                        return None
                    attempts += 1
                    exhausted = attempts > self.max_preemption_retries
                    logger.warning(kv(job=name, state="preempted",
                                      attempt=attempts, **req))
                    self._journal(name, "preempted", attempt=attempts)
                    obs_flight.record("jobs", "preempt_retry", job=name,
                                      attempt=attempts, exhausted=exhausted)
                    jobs_total.inc(job_class=job_class, state="preempted")
                    # The exhausting attempt IS the terminal record.
                    record("preempted", stdout=buf.getvalue(),
                           terminal=exhausted)
                    if not exhausted:
                        meta.update(name, {"preemptions": attempts})
                        if trace is not None:
                            trace.end(job_sid)
                        self._backoff(name, attempts, trace, req)
                        continue
                    if self._fence_refused(name, req):
                        return None
                    self._journal(name, "failed",
                                  reason="preemption retries exhausted")
                    meta.mark_failed(name, "Preempted (retries exhausted)")
                    jobs_total.inc(job_class=job_class, state="failed")
                    obs_bundle.trigger("job_retries_exhausted", job=name,
                                       attempts=attempts)
                    self._notify(name, "failed")
                    return None
                except BaseException as exc:  # noqa: BLE001 — a job
                    # body's failure is recorded, never kills the worker.
                    err = repr(exc)
                    if ctl["expired"]:
                        logger.warning(kv(job=name, state="abandoned",
                                          error=err, **req))
                        return None
                    if self._fence_refused(name, req):
                        # A stale-epoch straggler: the newer recovery
                        # owns this job's metadata.
                        return None
                    if ctl.get("cancelled"):
                        return commit_cancelled(err)
                    logger.error(kv(job=name, state="failed", error=err,
                                    dt=f"{time.monotonic() - t_start:.2f}s",
                                    **req), exc_info=True)
                    self._journal(name, "failed", reason=err)
                    obs_flight.record("jobs", "failed", job=name,
                                      error=err[:200])
                    meta.mark_failed(name, err)
                    jobs_total.inc(job_class=job_class, state="failed")
                    record(JobState.FAILED, exception=err,
                           stdout=buf.getvalue())
                    self._notify(name, "failed")
                    return None
                finally:
                    _ATTEMPT.reset(attempt_token)
                if ctl["expired"]:
                    # Finished after its deadline: already failed and its
                    # worker handed on; a late finish would resurrect it.
                    logger.warning(kv(job=name, state="abandoned", **req))
                    return None
                if ctl.get("cancelled"):
                    # Cancelled mid-run: its partial result must not
                    # publish as finished.
                    return commit_cancelled()
                if self._fence_refused(name, req):
                    return None
                extra = on_success(result) if on_success else None
                logger.info(kv(job=name, state="finished",
                               dt=f"{time.monotonic() - t_start:.2f}s",
                               **req))
                if self.journal is not None:
                    # Which engine life committed this artifact.
                    extra = {**(extra or {}),
                             "engineEpoch": jobs_journal.current_stamp()}
                self._journal(name, "finished")
                meta.mark_finished(name, extra or None)
                jobs_total.inc(job_class=job_class, state="finished")
                record(JobState.FINISHED, stdout=buf.getvalue())
                self._notify(name, "finished")
                return result

    def _backoff(self, name: str, attempt: int, trace, req: dict) -> None:
        """Sleep the jittered exponential backoff before retry ``attempt``
        (woken by a cancel token flip) and record a ``retry_backoff``
        span."""
        base = self.retry_backoff_s
        if base <= 0:
            return
        delay = min(self.retry_backoff_max_s,
                    base * (2 ** max(0, attempt - 1))) * (
                        0.5 + random.random())
        logger.info(kv(job=name, state="backoff", delay=f"{delay:.3f}s",
                       attempt=attempt, **req))
        t0 = time.monotonic()
        token = jobs_cancel.current_cancel_token()
        if token is not None:
            token.wait(delay)
        else:
            time.sleep(delay)
        if trace is not None:
            trace.add_span("retry_backoff", t0, time.monotonic(),
                           attrs={"attempt": attempt,
                                  "delayS": round(delay, 4)})

    # -- weighted-fair dispatch ----------------------------------------------

    def _weight(self, job_class: str) -> int:
        return max(1, int(self.class_weights.get(job_class, 1)))

    def note_warm(self, warm_key: str | None) -> None:
        """Record that the programs of ``warm_key`` are built and cached:
        queued jobs with this tag dispatch first within their class.
        Bounded FIFO; never raises."""
        if not warm_key:
            return
        with self._lock:
            self._warm_keys.pop(warm_key, None)
            self._warm_keys[warm_key] = None
            while len(self._warm_keys) > self._max_warm_keys:
                self._warm_keys.popitem(last=False)

    def clear_warm_keys(self) -> None:
        """Drop every warm hint: wired to the program cache's device-set
        invalidation (services/context.py), after which nothing is
        warm."""
        with self._lock:
            self._warm_keys.clear()

    def _pop_queued_locked(self, queue: deque, job_class: str):
        """Pop the next job of one class's queue: the first queued job
        whose ``warm_key`` is known warm if any, else strict FIFO.
        Cancelled entries are skipped.  At most ``_max_warm_bypass``
        consecutive dispatches may jump the FIFO head; then the head
        runs (cold jobs are delayed, never starved)."""
        if (self._warm_keys and self._warm_bypass.get(job_class, 0)
                < self._max_warm_bypass):
            for i, item in enumerate(queue):
                if item[1].cancelled():
                    continue
                wk = item[2].get("warm_key")
                if wk is not None and wk in self._warm_keys:
                    self._warm_bypass[job_class] = (
                        self._warm_bypass.get(job_class, 0) + 1
                        if i > 0 else 0)
                    del queue[i]
                    return item
        self._warm_bypass[job_class] = 0
        if self._tenant_seen:
            picked = self._tenant_pick_locked(queue, job_class)
            if picked is not None:
                return picked
        return queue.popleft()

    def _tenant_pick_locked(self, queue: deque, job_class: str):
        """Nested tenant round-robin inside one class's turn: with more
        than one tenant queued, serve tenants in sorted cyclic order (a
        per-class last-served pointer), popping the chosen tenant's
        oldest entry.  None with one tenant or none (plain FIFO)."""
        tenants: list[str] = []
        for _r, f, info in queue:
            if f.cancelled():
                continue
            t = info.get("tenant") or ""
            if t not in tenants:
                tenants.append(t)
        if len(tenants) <= 1:
            return None
        order = sorted(tenants)
        last = self._tenant_rr.get(job_class, "")
        pick = next((t for t in order if t > last), order[0])
        self._tenant_rr[job_class] = pick
        for i, item in enumerate(queue):
            if item[1].cancelled():
                continue
            if (item[2].get("tenant") or "") == pick:
                del queue[i]
                return item
        return None

    def _dispatch_locked(self) -> None:
        """Hand freed workers to queued jobs, class by class."""
        while self._inflight < self.max_workers:
            item = self._pick_locked()
            if item is None:
                return
            runner, future, info = item
            if not future.set_running_or_notify_cancel():
                continue  # cancelled while queued
            self._inflight += 1
            rec = {**info, "future": future, "t0": time.monotonic(),
                   "released": False}
            self._running_recs[info["name"]] = rec
            if rec["deadline"] > 0:
                self._ensure_watchdog_locked()
            thread = threading.Thread(
                target=self._run_dispatched, args=(runner, future, rec),
                name=f"lo-job-{info['name']}", daemon=True,
            )
            self._threads.add(thread)
            thread.start()

    def _pick_locked(self):
        """Next queued job under weighted round-robin: the pointer stays
        on a class while it has work and credits (its weight's worth of
        consecutive dispatches), then refills them and advances.  Jobs
        cancelled while queued are dropped without charging credits."""
        for queue in self._queues.values():
            while queue and queue[0][1].cancelled():
                queue.popleft()
        if not any(self._queues.values()):
            return None
        # Two passes bound the scan: the first may only refill credits.
        for _ in range(2 * len(self._rr_order)):
            cls = self._rr_order[self._rr_idx % len(self._rr_order)]
            queue = self._queues[cls]
            if queue and self._credits.get(cls, 0) > 0:
                self._credits[cls] -= 1
                return self._pop_queued_locked(queue, cls)
            self._credits[cls] = self._weight(cls)
            self._rr_idx += 1
        return None

    def _run_dispatched(self, runner, future: Future, rec: dict) -> None:
        try:
            result = runner()
        except BaseException as exc:  # noqa: BLE001 — run() records its
            # own failures; never leak a worker slot.
            try:
                future.set_exception(exc)
            except InvalidStateError:
                pass  # the watchdog resolved the future first
        else:
            try:
                future.set_result(result)
            except InvalidStateError:
                pass
        finally:
            with self._lock:
                if self._running_recs.get(rec["name"]) is rec:
                    del self._running_recs[rec["name"]]
                if not rec["released"]:
                    # An expired job's slot was released by the watchdog.
                    rec["released"] = True
                    self._inflight -= 1
                    self._dispatch_locked()
                self._threads.discard(threading.current_thread())

    # -- deadline watchdog ----------------------------------------------------

    def _ensure_watchdog_locked(self) -> None:
        """Start the watchdog lazily, at the first deadline'd dispatch."""
        if self._shutdown:
            return
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog_wake.clear()
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="lo-job-watchdog",
                daemon=True,
            )
            self._watchdog.start()

    def _watchdog_loop(self) -> None:
        while True:
            self._watchdog_wake.wait(self.WATCHDOG_INTERVAL_S)
            expired: list[tuple[str, dict]] = []
            with self._lock:
                if self._shutdown:
                    return
                now = time.monotonic()
                armed = 0
                for name, rec in list(self._running_recs.items()):
                    if rec["deadline"] <= 0 or rec["released"]:
                        continue
                    if now - rec["t0"] > rec["deadline"]:
                        # Reclaim the worker now (the body keeps its
                        # thread) and ask the zombie to exit early.
                        rec["released"] = True
                        rec["ctl"]["expired"] = True
                        rec["token"].cancel(
                            f"deadline {rec['deadline']:g}s exceeded")
                        del self._running_recs[name]
                        self._inflight -= 1
                        expired.append((name, rec))
                    else:
                        armed += 1
                if expired:
                    self._dispatch_locked()
                if not armed and not expired:
                    # Nothing left to watch; the next deadline'd dispatch
                    # starts a fresh thread.
                    self._watchdog = None
                    return
            for name, rec in expired:
                self._expire_job(name, rec)

    def _expire_job(self, name: str, rec: dict) -> None:
        """Terminal bookkeeping for a timed-out job, outside the lock."""
        err = (
            f"job exceeded its {rec['deadline']:g}s deadline; the watchdog "
            "failed it and reclaimed its worker and device leases (the "
            "body finishes as an abandoned zombie)"
        )
        logger.error(kv(job=name, state="deadline",
                        deadlineS=rec["deadline"]))
        obs_flight.record("jobs", "deadline", job=name,
                          deadlineS=rec["deadline"])
        obs_bundle.trigger("job_deadline", job=name,
                           deadlineS=rec["deadline"])
        _, jobs_total = _job_metrics()
        jobs_total.inc(job_class=rec["job_class"], state="deadline")
        self._journal(name, "deadline", reason=err)
        try:
            self.artifacts.metadata.mark_failed(name, err)
            self.artifacts.ledger.record(name, state="deadline",
                                         exception=err)
        except Exception:  # noqa: BLE001 — the watchdog must survive an
            # artifact deleted under its job; the log line above stays.
            logger.exception(kv(job=name, event="deadline_record_failed"))
        if self.leaser is not None:
            freed = self.leaser.revoke(name)
            if freed:
                logger.warning(kv(job=name, event="lease_revoked",
                                  devices=freed))
        try:
            rec["future"].set_exception(JobDeadlineExceeded(err))
        except InvalidStateError:
            pass
        self._notify(name, "failed")

    def _prune_locked(self) -> None:
        done = [n for n, f in self._futures.items() if f.done()]
        for name in done[:max(len(done) - self._MAX_DONE_RETAINED, 0)]:
            del self._futures[name]

    # -- status / control -----------------------------------------------------

    def state(self, name: str) -> str:
        meta = self.artifacts.metadata.read(name)
        if meta is None:
            raise KeyError(name)
        return meta.get(
            "jobState",
            JobState.FINISHED if meta.get("finished") else JobState.PENDING,
        )

    def running_jobs(self) -> list[str]:
        """The jobs submitted and not done yet (queued or running)."""
        with self._lock:
            return [n for n, f in self._futures.items() if not f.done()]

    def queue_depths(self, include_empty: bool = False) -> dict[str, int]:
        """Queued-but-undispatched jobs per class; ``include_empty`` keeps
        drained classes at 0 (the collector's series must report zero,
        not vanish)."""
        with self._lock:
            return {cls: len(q) for cls, q in self._queues.items()
                    if q or include_empty}

    def queue_depths_by_tenant(self) -> dict[tuple, int]:
        """Queued jobs per ``(class, tenant)``: the tenant samples of the
        queue-depth family once any tenanted submission arrived (empty
        before, so untenanted scrapes keep their shape)."""
        with self._lock:
            if not self._tenant_seen:
                return {}
            out: dict[tuple, int] = {}
            for cls, queue in self._queues.items():
                for _runner, fut, info in queue:
                    if fut.cancelled():
                        continue
                    key = (cls, info.get("tenant") or "")
                    out[key] = out.get(key, 0) + 1
            return out

    def wait(self, name: str, timeout: float | None = None) -> Any:
        """Block until the job of ``name`` completes; returns its result
        (clients poll GET instead)."""
        with self._lock:
            future = self._futures.get(name)
        if future is None:
            return None
        return future.result(timeout=timeout)

    def cancel(self, name: str):
        """Cancel a queued job (-> ``True``, it never runs) or flip a
        RUNNING job's token (-> ``"running"``: the body winds down at its
        next check and the job ends ``cancelled``); ``False`` when the
        job is neither."""
        running = False
        with self._lock:
            # Under the engine lock, so a cancellation never lands
            # between a queue pop and its dispatch.
            future = self._futures.get(name)
            queued = future is not None and future.cancel()
            qinfo = next((
                info for queue in self._queues.values()
                for _runner, fut, info in queue if fut is future),
                {}) if queued else {}
            job_class = qinfo.get("job_class", "default")
            if not queued:
                rec = self._running_recs.get(name)
                if rec is not None and not rec["released"]:
                    # Flag first: a body that sees the token always finds
                    # the flag set.
                    rec["ctl"]["cancelled"] = True
                    rec["token"].cancel("cancel requested")
                    running = True
        if queued:
            if self.admission is not None:
                # It left the queue without dispatching: the tenant's
                # queued count must not leak.
                self.admission.note_dequeued(qinfo.get("tenant"))
            _, jobs_total = _job_metrics()
            jobs_total.inc(job_class=job_class, state="cancelled")
            self._journal(name, "cancelled",
                          reason="cancelled while queued")
            self.artifacts.metadata.update(
                name, {"jobState": JobState.CANCELLED, "finished": False})
            self.artifacts.ledger.record(
                name, state=JobState.CANCELLED,
                exception="cancelled while queued")
            self._notify(name, "cancelled")
            return True
        if running:
            self._journal(name, "cancel_requested")
            return "running"
        return False

    def shutdown(self, wait: bool = True,
                 drain_timeout_s: float | None = None,
                 grace_s: float | None = None) -> None:
        """Stop accepting work; with ``wait``, drain what was accepted.

        With a positive ``drain_timeout_s`` (default: the engine's
        ``shutdown_drain_s``) the drain is bounded: past the budget every
        running body's token is flipped, still-queued jobs are cancelled,
        and after ``grace_s`` a thread still running is abandoned (it is
        a daemon) rather than joined forever."""
        with self._lock:
            self._shutdown = True
            self._watchdog_wake.set()
            # Queued jobs keep dispatching as workers free: shutdown
            # (wait=True) runs every accepted job.
            self._dispatch_locked()
        if not wait:
            return
        budget = (self.shutdown_drain_s if drain_timeout_s is None
                  else float(drain_timeout_s))
        deadline = time.monotonic() + budget if budget > 0 else None
        while True:
            with self._lock:
                thread = next(iter(self._threads), None)
                if (thread is None and not any(self._queues.values())
                        and self._inflight == 0):
                    return
            if deadline is not None and time.monotonic() >= deadline:
                break
            if thread is None:
                time.sleep(0.005)  # a worker freed, the next not started
            elif deadline is None:
                thread.join()
            else:
                thread.join(min(0.2, max(0.0, deadline - time.monotonic())))
        with self._lock:
            stragglers = list(self._threads)
            for rec in self._running_recs.values():
                rec["token"].cancel("engine shutdown drain deadline")
            dropped = []
            for queue in self._queues.values():
                for _runner, queued, info in queue:
                    if queued.cancel():
                        dropped.append((info["name"], info.get("tenant")))
                queue.clear()
        for name, drop_tenant in dropped:
            if self.admission is not None:
                self.admission.note_dequeued(drop_tenant)
            self._journal(name, "cancelled",
                          reason="shutdown drain deadline")
            self.artifacts.metadata.update(
                name, {"jobState": JobState.CANCELLED, "finished": False})
        grace = self.SHUTDOWN_GRACE_S if grace_s is None else float(grace_s)
        grace_deadline = time.monotonic() + max(0.0, grace)
        for thread in stragglers:
            thread.join(max(0.0, grace_deadline - time.monotonic()))
        leftover = [t.name for t in stragglers if t.is_alive()]
        if dropped or leftover:
            logger.error(kv(event="shutdown_drain_bounded", budgetS=budget,
                            droppedQueued=len(dropped),
                            abandoned=len(leftover),
                            threads=",".join(leftover[:8])))
