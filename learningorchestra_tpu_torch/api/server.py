"""REST API — port of the pipeline and serving routes of
``learningorchestra_tpu/api/server.py``.

``{verb} /api/learningOrchestra/v1/{service}/{tool}[/{name}]`` over a
stdlib ``ThreadingHTTPServer`` and a regex route table, with the JAX
server's request bodies:

- ``POST /dataset/csv`` (``shardRows``: sharded), ``POST
  /dataset/tensor`` (``.npy`` features and ``labelsUrl``), ``POST
  /dataset/generic``, ``POST /transform/projection``, ``POST
  /transform/text`` (BPE tokenization into a sharded dataset), ``POST
  /transform/<tool>`` (a generic transform: registry class + method),
  ``POST /explore/histogram``, ``POST /explore/curves``, ``POST
  /explore/<tool>`` (a plot), ``POST /model/<tool>``, ``POST
  /{train,evaluate,predict,tune}/<tool>`` (a tune with ``paramGrid`` is
  a grid search), ``POST /function/python``: each creates a named
  artifact whose job runs asynchronously (201 with the artifact's GET
  URI); ``GET .../<name>`` polls it (metadata first, then rows),
  ``PATCH`` re-runs it, ``DELETE`` removes it, ``GET .../<tool>`` lists
  a family; ``GET /explore/<tool>/<name>`` is the PNG and
  ``.../<name>/metadata`` its documents;
- ``PATCH /transform/dataType``: cast a dataset's fields in place;
- ``POST /builder/sparkml``: fit the builder's classifiers at once, one
  result artifact each; ``POST /builder/tensorflow|pytorch|horovod``: the
  distributed builder, one function on every rank;
- ``POST /train/horovod|distributed`` and ``PATCH .../<name>``:
  data-parallel training (services/distributed_exec.py); ``GET
  /train/horovod`` lists the ``train/tensorflow`` artifacts it stores, as
  ``GET /builder/tensorflow|pytorch`` lists ``builder/horovod``;
- ``GET /monitoring/<tool>`` and ``GET``/``DELETE
  /monitoring/<tool>/<name>``: monitoring sessions by nickname;
  ``serving`` answers the serving stats and appends ``serving_*``
  scalars, ``compileCache`` the program cache's counters with the
  per-program costs (``programCosts``) and the durable program store's
  live ``aot`` block (train/aot_store.py);
- ``GET /observability/costs``: the cost plane (obs/costs.py): the
  per-program FLOPs ledger and the device-time ledgers per job, model
  and bucket;
- ``POST /observability/profile/start`` (201; ``name``, ``maxSeconds``)
  and ``.../stop``, ``GET /observability/profile`` (status), ``GET
  /observability/profile/captures`` and ``GET|DELETE
  .../captures/<name>`` (``?file=`` answers the file's bytes): on-demand
  ``torch.profiler`` captures of the live process (obs/profiling.py; 409
  while one runs or another ``torch.profiler`` is active);
- the operations plane: ``GET /metrics.prom`` (Prometheus text 0.0.4
  over the metrics registry and the subsystems' collectors), ``GET
  /observability/jobs/<name>/trace`` (a job's span tree),
  ``GET /observability/timeseries`` (rollup windows), ``GET
  /observability/alerts``, ``GET|POST /observability/slo`` and ``DELETE
  /observability/slo/<name>`` (SLO objectives and alerts), ``GET
  /observability/flight`` (the flight rings and their merged timeline),
  ``POST /observability/bundle``, ``GET|DELETE /observability/bundles``
  and ``GET|DELETE /observability/bundles/<name>`` (debug bundles), and
  ``GET|DELETE /faults`` and ``POST|DELETE /faults/<point>`` (the
  fault-injection plane; ``FaultsConfig.specs`` arms schedules at boot).
  Every request echoes or mints ``X-Request-Id``, passes the
  ``http.handler`` fault point and is metered by route and status class;
- ``GET /observe/<name>``: long poll until the job finishes or fails;
- ``GET /observe/events?sinceId=&limit=``: the event feed, paged by
  ``_id``; ``POST``/``GET /observe/webhook`` and ``DELETE
  /observe/webhook/<id>``: wildcard webhooks (every artifact);
  ``POST``/``GET /observe/<name>/webhook`` and ``DELETE
  /observe/<name>/webhook/<id>``: one artifact's (a registration on an
  artifact already terminal fires at once, ``firedImmediately``);
- ``DELETE /jobs/<name>``: cancel a job: 200 ``cancelled`` while queued,
  202 ``cancelling`` while running (the body winds down at its next
  epoch and the job ends ``cancelled``), 409 once terminal, 404 unknown;
- ``POST /serve/<model>/predict|load|unload``, ``DELETE
  /serve/<model>``, ``GET /serve``: resident serving of a train job's
  artifact;
- ``POST /serve/<model>/generate``: LM generation through the decode
  engine, a JSON body or, with ``stream: true``, a ``text/event-stream``
  of ``open``/``token``/``done`` events; ``DELETE
  /serve/<model>/generate/<streamId>`` aborts a stream (404 once it is
  gone).  A client that hangs up mid-stream aborts it too;
- ``GET /serve/fleet``: every replica set, the bounds and the
  autoscaler's status with its decisions and ledger; ``GET|POST|DELETE
  /serve/<model>/replicas``: one model's replica set (404 without one),
  created or resized by ``min``, ``max``, ``count``,
  ``devicesPerReplica``, dissolved back to single-path serving;
- ``GET /metrics`` (the legacy per-route JSON: count, errors, average
  and max ms by route key, and the gateway budget), ``GET /status`` (an
  HTML page: device leases, jobs and queues, recent events),
  ``GET /observability/locks`` (the lock witness's snapshot with live
  stacks, concurrency_rt.py), ``GET /cluster/status`` (the claim
  table's engines and claims when clustered, ``enabled: false`` with
  one engine, and the tenant counters under a quota), ``GET
  /registry`` (cacheable) and ``GET /health``;
- ``GET /replication/wals``, ``GET /replication/wal/<name>?from=&len=``,
  ``GET /replication/status`` and ``POST /replication/fence``: what a
  network standby (store/ha.py) ships and reads, and the fence a promoted
  standby posts (only a strictly higher election epoch fences; the
  server then demotes itself).

The gateway in front of every route is the JAX server's
(``APIConfig``): a handler past ``request_timeout_s`` answers 504 (the
long poll, ``/generate`` and a capture's start and stop are exempt; the
abandoned handler finishes on its own thread and keeps its slot until it
does); at
``max_inflight`` admitted requests the next answers 503 at once;
``max_connections`` bounds the connection threads; an opted-in GET is
served from a ``cache_ttl_s`` response cache that any other verb
clears; and a POST, PATCH or DELETE carrying ``X-Idempotency-Key`` is
recorded in the ``_idempotency`` collection of the document store, so a
retry with the same key replays the recorded answer (a key reused for
another request answers 422, an attempt begun with no recorded outcome
409).  Once :meth:`APIServer.shutdown` starts, requests on kept-alive
connections answer 503 and close.  :func:`serve` runs the server in the
foreground on ``api.host:api.port`` (``python -m
learningorchestra_tpu_torch serve``).

Status codes are the JAX server's: 201/200; 409 duplicate name or a job
still running; 404 unknown artifact, model or route; 406 semantic errors
(bad body, unknown class, ``checkpoint_dir``); 429 + ``Retry-After``
under serving backpressure or a tenant over its ``TenantConfig`` quota
(``X-Tenant``, checked on job-creating routes before any metadata
exists); 503 + ``Retry-After`` when no card lease frees up within
``FleetConfig.lease_timeout_s``; 400 for a body that is not JSON, a bad
query parameter or a bad ``X-Tenant`` header.

Store HA: a running server watches its store's fence marker, and with
``HAConfig.peer`` its peer's election epoch, every
``FENCE_CHECK_INTERVAL_S`` and shuts itself down once fenced
(:meth:`APIServer._start_fence_watch`).  :func:`serve` refuses to start
on a fenced store or under a peer with a higher epoch (exit status
``SERVE_REFUSED``), or rejoins as the new primary's standby with
``HAConfig.auto_rejoin``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import html
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch import concurrency_rt, faults
from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.jobs.cluster import QuotaExceeded, bind_tenant
from learningorchestra_tpu_torch.jobs.leases import LeaseTimeout
from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.obs import bundle as obs_bundle
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.obs import flight as obs_flight
from learningorchestra_tpu_torch.obs import metrics as obs_metrics
from learningorchestra_tpu_torch.obs import rollup as obs_rollup
from learningorchestra_tpu_torch.obs import slo as obs_slo
from learningorchestra_tpu_torch.obs import tracing as obs_tracing
from learningorchestra_tpu_torch.obs.bundle import (
    BundleBusy,
    BundleError,
    BundleNotFound,
)
from learningorchestra_tpu_torch.obs.metrics import Family
from learningorchestra_tpu_torch.obs.profiling import (
    ProfilerConflict,
    ProfilerError,
    ProfilerNotFound,
    ProfilerService,
)
from learningorchestra_tpu_torch.serve.batcher import QueueFull
from learningorchestra_tpu_torch.serve.registry import ServeError
from learningorchestra_tpu_torch.serve.service import (
    NotFoundError as ServeNotFound,
)
from learningorchestra_tpu_torch.serve.service import ServingService
from learningorchestra_tpu_torch.services import (
    BuilderService,
    DatasetService,
    DistributedExecutorService,
    ExecutorService,
    ExploreService,
    FunctionService,
    ModelService,
    MonitoringService,
    ServiceContext,
    TransformService,
)
from learningorchestra_tpu_torch.services.context import (
    ConflictError,
    NotFoundError,
    ValidationError,
)
from learningorchestra_tpu_torch.services.monitoring import MonitoringError
from learningorchestra_tpu_torch.store.artifacts import DuplicateArtifact
from learningorchestra_tpu_torch.store.document_store import DuplicateKey
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.registry import RegistryError

PREFIX = Config().api.api_prefix
TOOL = r"(?P<tool>[A-Za-z0-9_\-]+)"
NAME = r"(?P<name>[A-Za-z0-9_.\-]+)"
#: Client-supplied request ids must be header-safe and bounded; anything
#: else gets a freshly minted id.
_RID_RE = re.compile(r"[A-Za-z0-9_.\-]{1,64}")

#: Guards the swap of a server's HTTP metric handles to a new registry.
_OBS_REBIND_LOCK = make_lock("server._OBS_REBIND_LOCK")

#: The HTTP families (the JAX server's).
HTTP_DURATION = "lo_http_request_duration_seconds"
HTTP_TOTAL = "lo_http_requests_total"
HTTP_MAX_MS = "lo_http_request_max_ms"

logger = get_logger("api")


class BadRequest(Exception):
    """Malformed client input -> 400."""


class Router:
    """Regex route table: (verb, pattern) -> handler(match, body, query).
    First match wins, so specific routes are registered before generic
    ones where their patterns overlap.  Each route's metric label is
    ``"<VERB> <pattern>"``, as in the JAX server.

    Per-route gateway flags, by route key (:attr:`flags`): ``cacheable``
    opts a GET into the response cache (poll GETs must not: a job's
    completion is written through the store, not HTTP, so a cached poll
    would serve a stale ``finished``); ``no_timeout`` exempts a
    deliberate long poll or stream from the request budget."""

    def __init__(self, prefix: str):
        self.prefix = prefix.rstrip("/")
        self.routes: list[tuple[str, re.Pattern, Callable, str]] = []
        self.flags: dict[str, dict] = {}

    def add(self, verb: str, pattern: str, handler: Callable, *,
            cacheable: bool = False, no_timeout: bool = False) -> None:
        verb = verb.upper()
        key = f"{verb} {pattern}"
        self.routes.append((verb, re.compile(
            "^" + self.prefix + pattern + "/?$"), handler, key))
        self.flags[key] = {"cacheable": cacheable, "no_timeout": no_timeout}

    def resolve(self, verb: str, path: str):
        """-> (handler, match, route key), or (None, "404"|"405", that
        code as the key)."""
        matched_path = False
        for route_verb, pattern, handler, key in self.routes:
            m = pattern.match(path)
            if m:
                matched_path = True
                if route_verb == verb:
                    return handler, m, key
        code = "405" if matched_path else "404"
        return None, code, code


def _int_param(query: dict, key: str, default: int) -> int:
    try:
        return int(query.get(key, default))
    except (TypeError, ValueError):
        raise BadRequest(f"{key} must be an integer") from None


class _BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a hard cap on connection threads.

    The ``max_inflight`` semaphore bounds ADMITTED handlers, but the
    stdlib starts one thread per accepted connection before a byte of the
    request is parsed: a client trickling bodies would grow threads
    without bound underneath the handler cap.  Beyond
    ``max_connections`` the socket is closed at accept."""

    daemon_threads = True

    def __init__(self, addr, handler, *, max_connections: int = 256):
        self._conn_slots = (threading.BoundedSemaphore(max_connections)
                            if max_connections > 0 else None)
        super().__init__(addr, handler)

    def process_request(self, request, client_address):
        if self._conn_slots is not None and \
                not self._conn_slots.acquire(blocking=False):
            self.shutdown_request(request)
            return
        try:
            super().process_request(request, client_address)
        except RuntimeError:
            # The thread could not start, so its release never runs.  (An
            # interrupt while a started thread is being waited for leaves
            # the release to that thread: releasing here too would raise,
            # and the accept loop would swallow the interrupt.)
            if self._conn_slots is not None:
                self._conn_slots.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            if self._conn_slots is not None:
                self._conn_slots.release()


class _Slot:
    """One ``max_inflight`` slot with shared ownership: the dispatcher and,
    for a request past its budget, the abandoned handler's thread each
    own it, and the semaphore frees only at the LAST release, so a 504'd
    handler still counts against the cap until it really returns."""

    def __init__(self, sem):
        self._sem = sem
        self._lock = make_lock("_Slot._lock")
        self._owners = 1

    def share(self) -> None:
        with self._lock:
            self._owners += 1

    def release(self) -> None:
        if self._sem is None:
            return
        with self._lock:
            self._owners -= 1
            if self._owners > 0:
                return
        self._sem.release()


class APIServer:
    """Service wiring + route table + HTTP plumbing.  ``device``
    overrides ``config.device`` (the tests pass ``"cpu"``)."""

    def __init__(self, config: Config | None = None,
                 ctx: ServiceContext | None = None, *, device=None):
        self.config = config or Config.from_env()
        self.ctx = ctx or ServiceContext(self.config, device=device)
        self.dataset = DatasetService(self.ctx)
        self.transform = TransformService(self.ctx)
        self.model = ModelService(self.ctx)
        self.executor = ExecutorService(self.ctx)
        self.builder = BuilderService(self.ctx)
        self.explore = ExploreService(self.ctx)
        self.function = FunctionService(self.ctx)
        monitoring_root = str(self.config.store.volume_path() / "_monitoring")
        self.monitoring = MonitoringService(
            monitoring_root,
            external_host=self.config.api.monitoring_external_host)
        self.distributed = DistributedExecutorService(self.ctx,
                                                      self.monitoring)
        self.serving = ServingService(
            self.ctx.volumes, self.config.serve, device=self.ctx.device,
            monitoring_root=monitoring_root,
            decode_config=self.config.decode,
            fleet_config=self.config.fleet, aot_config=self.config.aot,
            # By reference: fleet replicas lease from whatever leaser the
            # context holds when they are placed.
            leaser=lambda: self.ctx.leaser,
        )
        # A PATCHed or deleted train job's resident params (decoder,
        # replicas) reload before the next request; a deleted one also
        # forgets its fleet bounds.
        self.ctx.add_artifact_change_listener(
            lambda name: self.serving.invalidate(
                name, gone=not self.ctx.artifacts.metadata.exists(name)))
        # On-demand profiler capture (obs/profiling.py): one capture at a
        # time into a bounded dir, with an auto-stop deadline.
        prof = self.config.profiling
        self.profiler = ProfilerService(
            prof.dir or str(self.config.store.volume_path() / "_profiles"),
            max_seconds=prof.max_seconds,
            max_captures=prof.max_captures,
        )
        # Windowed rollups + SLO burn-rate alerting: process-wide
        # singletons sized from the first server's config; the engine's
        # daemon snapshots the registry each tick and the SLO service
        # evaluates on the same clock.
        self.rollup = obs_rollup.ensure_engine(self.config.rollup)
        self.slo = obs_slo.ensure_service(self.config.slo)
        self.rollup.start()
        # The flight recorder arms at boot; the bundle assembler
        # snapshots the rings and every subsystem's state when an SLO
        # fires, a job exhausts its retries or its deadline, or an
        # operator POSTs /observability/bundle.
        obs_flight.ensure(self.config.flight)
        self.bundles = obs_bundle.ensure_service(
            self.config.bundle if self.config.bundle.dir else
            dataclasses.replace(self.config.bundle, dir=str(
                self.config.store.volume_path() / "_bundles")),
            providers=self._bundle_providers(), profiler=self.profiler)
        self.slo.add_sink(self._slo_bundle_sink)
        # HTTP metric handles bind against the CURRENT registry, checked
        # per use, so a reset_registry() re-homes them and the collector.
        self._obs_registry = None
        self._obs_handles()
        self._t_start = time.time()
        self.router = Router(self.config.api.api_prefix)
        self._httpd: ThreadingHTTPServer | None = None
        self._register_routes()
        # The gateway (JAX server's): the response cache of opted-in GETs,
        # the legacy per-route metrics behind GET /metrics, the admission
        # semaphore, and the shutdown gate that answers kept-alive
        # connections 503 once shutdown() starts.
        self._cache: dict[tuple, tuple] = {}
        self._cache_lock = make_lock("APIServer._cache_lock")
        self._metrics: dict[str, dict] = {}
        self._metrics_lock = make_lock("APIServer._metrics_lock")
        n_inflight = self.config.api.max_inflight
        self._inflight = (threading.BoundedSemaphore(n_inflight)
                          if n_inflight > 0 else None)
        self._shutting_down = threading.Event()
        self._shutdown_lock = make_lock("APIServer._shutdown_lock")
        self._shut_down = False
        # The idempotency ledger's sweep counter (the records live in the
        # document store's IDEM_COLLECTION).
        self._idem_lock = make_lock("APIServer._idem_lock")
        self._idem_writes = 0
        # Arm the schedules the config carried, so a deployment boots
        # straight into its chaos drill; bad specs raise here.
        faults.load_env({faults.ENV_PREFIX + suffix: spec
                         for suffix, spec in self.config.faults.specs.items()})
        # The fence watch's cadence bounds the window in which a primary
        # revived during its standby's promotion still serves; floored so
        # a tiny value cannot hot-spin peer polls.
        if self.config.ha.fence_interval_s > 0:
            self.FENCE_CHECK_INTERVAL_S = max(
                0.05, self.config.ha.fence_interval_s)

    # -- operations plane -----------------------------------------------------

    def _bundle_providers(self) -> dict:
        """Content sources of obs/bundle.py, stem -> zero-arg callable; a
        failing one becomes a manifest error, not a lost bundle."""

        def rollup():
            eng = self.rollup
            series = {}
            for fam in eng.families:
                try:
                    series[fam] = eng.timeseries(fam, max_points=60)
                except Exception as exc:  # noqa: BLE001 — one family
                    series[fam] = {"error": repr(exc)}
            return {"status": eng.status(), "series": series}

        def journal():
            from learningorchestra_tpu_torch.jobs.journal import (
                JOURNAL_COLLECTION,
            )

            tail = max(0, int(self.config.bundle.journal_tail))
            self.ctx.journal.flush()
            docs = self.ctx.documents
            if not docs.collection_exists(JOURNAL_COLLECTION):
                return {"records": []}
            records = list(docs.find(JOURNAL_COLLECTION))
            return {"records": records[-tail:] if tail else []}

        return {
            "metrics": lambda: obs_metrics.get_registry().snapshot(),
            "rollup": rollup,
            "slo": lambda: {"alerts": self.slo.alerts(),
                            "status": self.slo.status()},
            "fleet": lambda: self.serving.fleet.snapshot(),
            "journal": journal,
            "faults": faults.status,
            "locks": concurrency_rt.snapshot,
            "cluster": self._cluster_doc,
        }

    def _cluster_doc(self) -> dict:
        """The ``/cluster/status`` body and a bundle's ``cluster.json``:
        the claim table as the store sees it (``enabled: false`` with one
        engine) and, under a quota, the tenant counters."""
        if self.ctx.cluster is None:
            doc = {"enabled": False, "engines": [], "claims": []}
        else:
            doc = {"enabled": True, **self.ctx.cluster.status()}
        if self.ctx.admission is not None:
            doc["tenants"] = self.ctx.admission.snapshot()
        return doc

    def _slo_bundle_sink(self, event: dict) -> None:
        """A ``firing`` transition is the incident signal: ask for a
        bundle (debounced, single-flight, assembled on its own thread)."""
        if event.get("state") != "firing":
            return
        self.bundles.trigger("slo_firing", {
            "slo": event.get("slo"), "instance": event.get("instance"),
            "burnFast": event.get("burnFast"),
            "burnSlow": event.get("burnSlow")})

    @property
    def obs(self):
        """The registry this server exposes (its collector registered)."""
        self._obs_handles()
        return self._obs_registry

    def _obs_handles(self):
        """HTTP metric handles on the current registry, rebinding (and
        re-registering the collector, once) when reset_registry()
        replaced it.  Registration is idempotent by name, so only the
        swap runs under the lock."""
        reg = obs_metrics.get_registry()
        if reg is not self._obs_registry:
            handles = (
                reg.histogram(
                    HTTP_DURATION, "HTTP request latency by route.",
                    labels=("route",),
                    buckets=tuple(ms / 1e3 for ms in
                                  self.config.obs.latency_buckets_ms)),
                reg.counter(HTTP_TOTAL,
                            "HTTP requests by route and status class.",
                            labels=("route", "status")),
                reg.gauge(HTTP_MAX_MS,
                          "Max observed request latency by route.",
                          labels=("route",)),
            )
            with _OBS_REBIND_LOCK:
                fresh = reg is not self._obs_registry
                if fresh:
                    (self._http_hist, self._http_total,
                     self._http_max) = handles
                    self._obs_registry = reg
            if fresh:
                reg.add_collector(self._collect_families)
        return self._http_hist, self._http_total, self._http_max

    def _record_metric(self, key: str, status: int, dt_ms: float,
                       request_id: str | None = None) -> None:
        if request_id is not None:
            obs_flight.record("http", "request", route=key, status=status,
                              ms=round(dt_ms, 3), requestId=request_id)
        else:
            obs_flight.record("http", "request", route=key, status=status,
                              ms=round(dt_ms, 3))
        with self._metrics_lock:
            rec = self._metrics.setdefault(key, {
                "count": 0, "errors": 0, "total_ms": 0.0, "max_ms": 0.0})
            rec["count"] += 1
            if status >= 400:
                rec["errors"] += 1
            rec["total_ms"] += dt_ms
            rec["max_ms"] = max(rec["max_ms"], dt_ms)
        http_hist, http_total, http_max = self._obs_handles()
        http_hist.observe(dt_ms / 1e3, route=key)
        http_total.inc(route=key,
                       status=f"{min(max(status // 100, 1), 5)}xx")
        http_max.set_max(dt_ms, route=key)

    def _collect_families(self) -> list:
        """Pull-side exposition: snapshot the subsystems that keep exact
        counters under their own locks (job queues, the lease pool, the
        program cache and durable store, the cost ledgers, serving,
        decode, the fleet, the store's WALs, rollup and SLO) into the JAX
        server's families.  Runs at scrape time; a failing collector
        drops its families, never the exposition."""
        from learningorchestra_tpu_torch.train import aot_store, compile_cache

        fams: list[Family] = [Family(
            "gauge", "lo_uptime_seconds",
            "Seconds since this API process started.",
        ).sample(time.time() - self._t_start)]
        depth = Family("gauge", "lo_jobs_queue_depth",
                       "Queued-but-undispatched jobs per fairness class.")
        for cls, n in self.ctx.engine.queue_depths(
                include_empty=True).items():
            depth.sample(n, job_class=cls)
        # Tenant samples of the same family, once a tenant was seen.
        for (cls, tenant), n in (
                self.ctx.engine.queue_depths_by_tenant().items()):
            depth.sample(n, job_class=cls, tenant=tenant or "-")
        fams.append(depth)
        engines_live = 0
        if self.ctx.cluster is not None:
            try:
                engines_live = sum(
                    1 for e in self.ctx.cluster.status().get("engines", ())
                    if e.get("live"))
            except Exception:  # noqa: BLE001 — a scrape must not fail
                engines_live = 0
        fams.append(Family(
            "gauge", "lo_cluster_engines",
            "Live job engines sharing this store (0 = clustering off).",
        ).sample(engines_live))
        snap = self.ctx.leaser.snapshot()
        n_all, n_free = len(snap["all"]), len(snap["free"])
        fams.append(Family(
            "gauge", "lo_lease_devices",
            "Chip-lease pool state (all/free/in_use).",
        ).sample(n_all, state="all").sample(n_free, state="free")
            .sample(n_all - n_free, state="in_use"))
        stats = compile_cache.get_cache().stats()
        events = Family("counter", "lo_compile_cache_events_total",
                        "Compiled-program cache lifetime counters.")
        for kind in ("hits", "misses", "evictions", "coalesced"):
            events.sample(stats[kind], kind=kind)
        events.sample(stats["deviceInvalidations"],
                      kind="device_invalidations")
        fams.append(events)
        for kind, name, help_text, value in (
                ("counter", "lo_compile_cache_trace_seconds_total",
                 "Cumulative seconds spent tracing/compiling programs.",
                 stats["traceTimeS"]),
                ("gauge", "lo_compile_cache_entries",
                 "Resident compiled-program cache entries.",
                 stats["entries"]),
                ("gauge", "lo_compile_cache_bytes_estimate",
                 "Estimated resident bytes of cached programs.",
                 stats["bytesEstimate"]),
                ("gauge", "lo_compile_cache_measured_entries",
                 "Cache entries charged at their MEASURED serialized "
                 "size (vs the flat fallback estimate).",
                 stats.get("measuredEntries", 0))):
            fams.append(Family(kind, name, help_text).sample(value))
        aot = aot_store.stats_snapshot()
        for kind, name, help_text, key in (
                ("counter", "lo_compile_cache_aot_hits",
                 "AOT executables restored from the durable store "
                 "(dispatches that skipped trace AND compile).", "hits"),
                ("counter", "lo_compile_cache_aot_misses",
                 "Durable-store lookups with no usable blob.", "misses"),
                ("counter", "lo_compile_cache_aot_load_errors",
                 "Stale/corrupt AOT blobs that degraded to a live "
                 "re-trace.", "loadErrors"),
                ("gauge", "lo_compile_cache_aot_persisted_entries",
                 "Executables currently persisted in the AOT store.",
                 "persistedEntries"),
                ("gauge", "lo_compile_cache_aot_persisted_bytes",
                 "On-disk bytes of persisted AOT executables.",
                 "persistedBytes")):
            fams.append(Family(kind, name, help_text).sample(aot[key]))
        try:
            fams += self._collect_cost_families()
        except Exception:  # noqa: BLE001 — never the whole exposition
            pass
        sstats = self.serving.stats()
        agg = self.serving.aggregate(sstats)
        fams.append(Family(
            "gauge", "lo_serving_resident_models",
            "Models pinned resident on device.",
        ).sample(agg["resident_models"]))
        fams.append(Family(
            "gauge", "lo_serving_resident_bytes",
            "Parameter bytes pinned resident on device.",
        ).sample(agg["resident_bytes"]))
        sevents = Family(
            "counter", "lo_serving_events_total",
            "Serving lifetime counters, summed over served models.")
        for kind in ("requests", "rows", "batches", "overflows",
                     "padded_rows"):
            sevents.sample(agg[kind], kind=kind)
        fams.append(sevents)
        fams.append(Family(
            "gauge", "lo_serving_queue_depth",
            "Rows queued across serving batchers.",
        ).sample(agg["queue_depth"]))
        fams.append(Family(
            "gauge", "lo_serving_batch_occupancy",
            "Mean dispatch occupancy (rows/bucket) over models.",
        ).sample(agg["occupancy"]))
        slat = Family("gauge", "lo_serving_latency_ms",
                      "Rolling request-latency quantiles (max over models).")
        for q, val in agg["quantiles"].items():
            slat.sample(val, quantile=q)
        fams.append(slat)
        if sstats["models"]:
            # The series the rollup tracks and the autoscaler's slope
            # trigger fits against.
            mdepth = Family(
                "gauge", "lo_serving_model_queue_depth",
                "Rows queued per served model (replicas summed).")
            for model, mstats in sstats["models"].items():
                mdepth.sample(mstats["queueDepth"], model=model)
            fams.append(mdepth)
        dstats = sstats["decode"]
        if dstats["models"]:
            dactive = Family(
                "gauge", "lo_serving_decode_active_streams",
                "Streams active (queued+resident) per decode model.")
            dfree = Family(
                "gauge", "lo_serving_decode_free_slots",
                "Unoccupied page-pool slots per decode model.")
            for model, ds in dstats["models"].items():
                dactive.sample(ds["activeStreams"], model=model)
                dfree.sample(sum(p["slots"] - p["live"]
                                 for p in ds["pools"]), model=model)
            fams += [dactive, dfree]
        fleet = sstats["fleet"]
        if fleet["models"]:
            nrepl = Family("gauge", "lo_serving_replicas",
                           "Active replicas per fleet-served model.")
            rdepth = Family("gauge", "lo_serving_replica_queue_depth",
                            "Rows queued per replica batcher.")
            rreq = Family("counter", "lo_serving_replica_requests_total",
                          "Requests routed per replica.")
            for model, st in fleet["models"].items():
                nrepl.sample(st["size"], model=model)
                for r in st["replicas"]:
                    labels = {"model": model, "replica": str(r["replica"]),
                              "device": r["device"]}
                    rdepth.sample(r["queueDepth"], **labels)
                    rreq.sample(r["requests"], **labels)
            fams += [nrepl, rdepth, rreq]
        if fleet["scaleTotals"]:
            scale = Family("counter", "lo_serving_fleet_scale_events_total",
                           "Replica scale events per model and direction.")
            for model, t in fleet["scaleTotals"].items():
                scale.sample(t["up"], model=model, direction="up")
                scale.sample(t["down"], model=model, direction="down")
            fams.append(scale)
        fams.append(Family(
            "counter", "lo_serving_fleet_autoscaler_ticks_total",
            "Autoscaler control-loop passes.",
        ).sample(fleet["autoscaler"]["ticks"]))
        root = self.config.store.store_path()
        wal_bytes = wal_files = 0
        if root.is_dir():
            for wal in root.glob("*.wal"):
                try:
                    wal_bytes += wal.stat().st_size
                    wal_files += 1
                except OSError:
                    continue  # dropped between glob and stat
        fams.append(Family("gauge", "lo_store_wal_bytes",
                           "Total bytes across store WAL files.",
                           ).sample(wal_bytes))
        fams.append(Family("gauge", "lo_store_wal_files",
                           "Store WAL file count.").sample(wal_files))
        from learningorchestra_tpu_torch.store.ha import is_fenced
        from learningorchestra_tpu_torch.store.replica import read_epoch

        fams.append(Family("gauge", "lo_replication_epoch",
                           "This store's election epoch.",
                           ).sample(read_epoch(root)))
        fams.append(Family("gauge", "lo_store_fenced",
                           "1 when a standby fenced this store, else 0.",
                           ).sample(1 if is_fenced(root) is not None else 0))
        try:
            fams += self.rollup.prom_families()
            fams += self.slo.prom_families()
        except Exception:  # noqa: BLE001 — never the whole exposition
            pass
        return fams

    def _collect_cost_families(self) -> list:
        """The cost plane's families (obs/costs.py): what each program
        costs per execution, and who consumed the device."""
        if not costs.enabled():
            return []
        fams: list = []
        ledger = costs.get_ledger().snapshot()
        programs = [p for p in ledger["programs"] if p["label"]]
        if programs:
            flops = Family("gauge", "lo_program_flops",
                           "FLOPs per execution of each program.")
            accessed = Family("gauge", "lo_program_bytes_accessed",
                              "Bytes accessed per execution.")
            hbm = Family("gauge", "lo_program_hbm_bytes",
                         "Per-program device memory by kind "
                         "(argument/output/temp/code).")
            size = Family("gauge", "lo_program_serialized_bytes",
                          "Serialized program size (what the compile "
                          "cache's byte cap charges).")
            for prog in programs:
                # program + key: labels alone are not unique.
                labels = {"program": prog["label"], "key": prog["key"]}
                if prog["flops"] is not None:
                    flops.sample(prog["flops"], **labels)
                if prog["bytesAccessed"] is not None:
                    accessed.sample(prog["bytesAccessed"], **labels)
                for kind, field in (("argument", "argumentBytes"),
                                    ("output", "outputBytes"),
                                    ("temp", "tempBytes"),
                                    ("code", "generatedCodeBytes")):
                    if prog[field] is not None:
                        hbm.sample(prog[field], kind=kind, **labels)
                if prog["serializedBytes"] is not None:
                    size.sample(prog["serializedBytes"], **labels)
            fams += [f for f in (flops, accessed, hbm, size) if f.samples]
        fams.append(Family(
            "counter", "lo_program_analyses_total",
            "Cost/memory analyses run at program build time.",
        ).sample(ledger["analyses"], outcome="ok")
            .sample(ledger["analysisFailures"], outcome="failed"))
        dt = costs.devtime().snapshot(peak_flops=costs.peak_flops())
        totals = dt["totals"]
        fams.append(Family(
            "counter", "lo_device_time_seconds_total",
            "Attributed device seconds (sampled; scaled to be unbiased).",
        ).sample(totals["deviceTimeS"]))
        fams.append(Family(
            "counter", "lo_device_flops_total",
            "Attributed FLOPs across dispatches.",
        ).sample(totals["flops"]))
        if dt["jobs"]:
            jt = Family("gauge", "lo_job_device_seconds",
                        "Attributed device seconds per job (freshest-N "
                        "ring).")
            jmfu = Family("gauge", "lo_job_mfu",
                          "Model-FLOPs-utilization per job (needs "
                          "LO_TPU_COSTS_PEAK_FLOPS).")
            for job, doc in dt["jobs"].items():
                jt.sample(doc["deviceTimeS"], job=job)
                if "mfu" in doc:
                    jmfu.sample(doc["mfu"], job=job)
            fams.append(jt)
            if jmfu.samples:
                fams.append(jmfu)
        if dt["models"]:
            mt = Family("gauge", "lo_model_device_seconds",
                        "Attributed device seconds per served model.")
            for model, doc in dt["models"].items():
                mt.sample(doc["deviceTimeS"], model=model)
            fams.append(mt)
        if dt["buckets"]:
            bmfu = Family("gauge", "lo_serving_bucket_mfu",
                          "Model-FLOPs-utilization per (model, bucket) "
                          "(needs LO_TPU_COSTS_PEAK_FLOPS).")
            bt = Family("gauge", "lo_serving_bucket_device_seconds",
                        "Attributed device seconds per (model, bucket).")
            for key, doc in dt["buckets"].items():
                model, _, bucket = key.rpartition(":")
                bt.sample(doc["deviceTimeS"], model=model, bucket=bucket)
                if "mfu" in doc:
                    bmfu.sample(doc["mfu"], model=model, bucket=bucket)
            fams.append(bt)
            if bmfu.samples:
                fams.append(bmfu)
        return fams

    # -- idempotency ----------------------------------------------------------

    #: Store collection of the idempotency records (the JAX server's: the
    #: underscore keeps it out of the artifact namespace).
    IDEM_COLLECTION = "_idempotency"
    #: Records older than this are swept: a retry a day later is a new
    #: request.
    IDEM_TTL_S = 86400.0
    #: Sweep cadence, counted in new records.
    IDEM_SWEEP_EVERY = 512

    @staticmethod
    def _idem_id(key: str) -> int:
        """The record's ``_id``, from the key (the JAX server's: 63 bits of
        its SHA-256), so the store's ``insert_unique`` claims a key
        atomically; the stored key is checked on every hit."""
        digest = hashlib.sha256(key.encode()).digest()
        return int.from_bytes(digest[:8], "big") >> 1

    @staticmethod
    def _idem_fingerprint(verb: str, path: str, body: dict,
                          query: dict | None = None) -> str:
        """The request's identity, recorded with its key (the JAX
        server's): a key reused for a different mutation, query included,
        is refused rather than answered with another request's result."""
        canon = json.dumps([body or {}, sorted((query or {}).items())],
                           sort_keys=True, default=str)
        return hashlib.sha256(
            f"{verb} {path} {canon}".encode()).hexdigest()[:32]

    def _idem_begin(self, key: str, fingerprint: str):
        """Claim ``key`` or report its earlier outcome:
        ``("replay", status, payload)`` once it completed,
        ``("mismatch", record)`` when it named another request,
        ``("ambiguous", record)`` when an attempt began and recorded no
        outcome (in flight, or the process died mid-handler), and
        ``("fresh", _id)`` after a ``begun`` record is written."""
        docs = self.ctx.documents
        _id = self._idem_id(key)
        try:
            docs.insert_unique(
                self.IDEM_COLLECTION,
                {"key": key, "fp": fingerprint, "state": "begun",
                 "at": time.time()},
                _id,
            )
        except DuplicateKey:
            rec = docs.find_one(self.IDEM_COLLECTION, _id) or {}
            if rec.get("key") != key or rec.get("fp") != fingerprint:
                return ("mismatch", rec)
            if rec.get("state") == "done":
                payload = rec.get("payload")
                return ("replay", rec.get("status", 200),
                        payload if payload is not None else {})
            return ("ambiguous", rec)
        with self._idem_lock:
            self._idem_writes += 1
            # The first keyed write after boot sweeps too: the counter is
            # in memory, so a server restarting before SWEEP_EVERY writes
            # would otherwise never honour the TTL.
            sweep = (self._idem_writes == 1
                     or self._idem_writes % self.IDEM_SWEEP_EVERY == 0)
        if sweep:
            threading.Thread(target=self._idem_sweep, daemon=True,
                             name="lo-idem-sweep").start()
        return ("fresh", _id)

    def _idem_finish(self, _id: int, status: int, payload) -> None:
        """Record the terminal answer for replay; runs in the handler's
        thread even after a 504, so a retry sees the real outcome."""
        if not isinstance(payload, (dict, list)):
            payload = None
        try:
            self.ctx.documents.update_one(
                self.IDEM_COLLECTION, _id,
                {"state": "done", "status": status, "payload": payload})
        except Exception:  # noqa: BLE001 — a lost record degrades to
            pass  # at-least-once, never to a 500

    def _idem_sweep(self) -> None:
        docs = self.ctx.documents
        cutoff = time.time() - self.IDEM_TTL_S
        if not docs.collection_exists(self.IDEM_COLLECTION):
            return
        try:
            for rec in docs.find(self.IDEM_COLLECTION):
                if rec.get("at", 0) < cutoff:
                    docs.delete_one(self.IDEM_COLLECTION, rec["_id"])
        except Exception:  # noqa: BLE001 — a sweep retries at the next
            pass  # cadence

    # -- status page ----------------------------------------------------------

    def _render_status(self) -> str:
        """The ops page (the JAX server's sections): agents, device
        leases, jobs with their queues and recent events, from state the
        process holds; a meta refresh keeps it live in a browser."""
        esc = html.escape

        def table(headers, rows):
            head = "".join(f"<th>{esc(str(h))}</th>" for h in headers)
            body = "".join(
                "<tr>" + "".join(f"<td>{esc(str(c))}</td>" for c in row)
                + "</tr>" for row in rows)
            return (f"<table><thead><tr>{head}</tr></thead>"
                    f"<tbody>{body}</tbody></table>")

        sections = [
            "<h2>Agents</h2><p>in-process mode (no task coordinator: the "
            "multi-host coordinator is not ported, ROADMAP A.9 part 3)</p>"]
        snap = self.ctx.leaser.snapshot()
        if snap["initialized"]:
            sections.append(
                f"<h2>Device leases</h2><p>{len(snap['free'])}/"
                f"{len(snap['all'])} free — "
                f"{esc(', '.join(snap['all']) or 'cpu (no-op)')}</p>"
                + table(("job", "device", "held"),
                        [(label, dev, f"{t1 - t0:.2f}s")
                         for label, dev, t0, t1 in snap["recent"]]))
        else:
            sections.append("<h2>Device leases</h2><p>no lease taken yet "
                            "(device discovery is lazy)</p>")
        sections.append(self._render_ha_status(esc))
        running = self.ctx.engine.running_jobs()
        rows = []
        for name in running[:50]:
            meta = self.ctx.artifacts.metadata.read(name) or {}
            rows.append((name, meta.get("type", ""),
                         meta.get("jobState", "")))
        depths = self.ctx.engine.queue_depths()
        sections.append(
            f"<h2>Jobs ({len(running)} live)</h2>"
            + table(("artifact", "type", "state"), rows)
            + ("<p>queued per class: " + esc(json.dumps(depths)) + "</p>"
               if depths else ""))
        ev_rows = "".join(
            "<tr class={cls}><td>{ts}</td><td>{name}</td><td>{event}</td>"
            "<td>{typ}</td></tr>".format(
                cls="err" if e.get("event") == "failed" else "ok",
                ts=time.strftime("%H:%M:%S",
                                 time.localtime(e.get("ts", 0))),
                name=esc(str(e.get("artifact", ""))),
                event=esc(str(e.get("event", ""))),
                typ=esc(str(e.get("artifactType") or "")))
            for e in reversed(self.ctx.webhooks.latest_events(20)))
        sections.append(
            "<h2>Recent events</h2><table><thead><tr><th>time</th>"
            "<th>artifact</th><th>event</th><th>type</th></tr></thead>"
            f"<tbody>{ev_rows}</tbody></table>")
        uptime = time.time() - self._t_start
        return (
            "<!doctype html><html><head>"
            "<title>learningorchestra_tpu_torch status</title>"
            '<meta http-equiv="refresh" content="5">'
            "<style>"
            "body{font-family:system-ui,sans-serif;margin:2em;color:#222}"
            "table{border-collapse:collapse;margin:0.5em 0}"
            "td,th{border:1px solid #ccc;padding:4px 10px;"
            "text-align:left;font-size:14px}"
            "th{background:#f0f0f0}"
            "tr.err td{background:#fde8e8}"
            ".err{color:#b00}"
            "h2{margin-top:1.2em;font-size:16px}"
            "</style></head><body>"
            "<h1>learningorchestra_tpu_torch</h1>"
            f"<p>uptime {uptime:.0f}s — store backend "
            f"{type(self.ctx.documents).__name__} — device "
            f"{esc(str(self.ctx.device))} — {len(running)} live jobs</p>"
            + "".join(sections) + "</body></html>")

    def _render_ha_status(self, esc) -> str:
        """The store HA section: role, election epoch, peer.  A bad peer
        or an unreadable store degrades this section only."""
        try:
            from learningorchestra_tpu_torch.store.ha import (
                is_fenced,
                peer_status,
            )
            from learningorchestra_tpu_torch.store.replica import read_epoch

            root = self.config.store.store_path()
            fence = is_fenced(root)
            role = "fenced" if fence is not None else "primary"
            bits = [f"role: <b>{role}</b> — election epoch "
                    f"{read_epoch(root)}"]
            if fence is not None:
                bits.append("<span class=err>FENCED by "
                            f"{esc(str(fence.get('promoted_to') or '?'))}"
                            "</span>")
            peer = self.config.ha.peer
            if peer:
                st = peer_status(peer)
                if not isinstance(st, dict):
                    bits.append(f"<span class=err>peer {esc(peer)}: "
                                "unreachable</span>")
                else:
                    bits.append(f"peer {esc(peer)}: "
                                f"role={esc(str(st.get('role')))} "
                                f"epoch={esc(str(st.get('epoch')))}")
            else:
                bits.append("no HA peer configured")
            return "<h2>Store HA</h2><p>" + " · ".join(bits) + "</p>"
        except Exception as exc:  # noqa: BLE001 — the page must render
            return f"<h2>Store HA</h2><p class=err>{esc(repr(exc))}</p>"

    # -- helpers --------------------------------------------------------------

    def _created(self, service_path: str, meta: dict):
        """201 + the artifact's GET URI."""
        return 201, {
            "result": f"{self.config.api.api_prefix}/{service_path}/"
                      f"{meta['name']}",
            "name": meta["name"],
            "metadata": meta,
        }

    def _page(self, m, body, query):
        q = query.get("query")
        try:
            parsed = json.loads(q) if q else None
        except json.JSONDecodeError as exc:
            raise BadRequest(f"bad JSON in 'query': {exc}") from None
        return 200, self.dataset.read_page(
            m.group("name"),
            query=parsed,
            skip=_int_param(query, "skip", 0),
            limit=_int_param(query, "limit",
                             self.config.api.page_limit_default),
        )

    # URL tool -> the artifact type its POST stores, where they differ (the
    # reference's gateway maps /train/horovod onto train/tensorflow and
    # /builder/tensorflow|pytorch onto builder/horovod).
    _TYPE_ALIASES = {
        ("train", "horovod"): "train/tensorflow",
        ("train", "distributed"): "train/tensorflow",
        ("builder", "tensorflow"): "builder/horovod",
        ("builder", "pytorch"): "builder/horovod",
    }

    def _list_handler(self, service: str, tool: str | None = None):
        """Collection GET: a family's metadata docs (``tool=None`` reads
        the tool from the URL)."""

        def handler(m, body, query):
            t = tool if tool is not None else m.group("tool")
            docs = self.dataset.list_metadata(
                self._TYPE_ALIASES.get((service, t), f"{service}/{t}"))
            # Coordinator artifacts (builder runs) are not the client's.
            return 200, [d for d in docs if not d.get("hidden")]

        return handler

    def _deleter(self, delete: Callable[[str], None]):
        def handler(m, body, query):
            delete(m.group("name"))
            return 200, {"result": "deleted"}

        return handler

    # -- route table ----------------------------------------------------------

    def _register_replication_routes(self) -> None:
        """Replication and HA peering (store/ha.py): a network standby
        pulls WAL listings and byte ranges here; a promoted standby posts
        its fence; ``/replication/status`` carries the election epoch a
        restarted node compares with its own before serving."""
        from learningorchestra_tpu_torch.store.ha import is_fenced
        from learningorchestra_tpu_torch.store.replica import (
            FENCE_FILE,
            read_epoch,
        )

        add = self.router.add

        def replication_wals(m, body, query):
            root = self.config.store.store_path()
            wals = []
            if root.is_dir():
                for wal in sorted(root.glob("*.wal")):
                    try:
                        wals.append({"name": wal.stem,
                                     "size": wal.stat().st_size})
                    except OSError:
                        continue  # dropped between glob and stat
            return 200, {"wals": wals, "epoch": read_epoch(root),
                         "fenced": is_fenced(root) is not None}

        def replication_wal_read(m, body, query):
            # NAME excludes "/" and "%": the stem cannot leave the root.
            root = self.config.store.store_path()
            offset = max(0, _int_param(query, "from", 0))
            length = _int_param(query, "len", 0)
            try:
                with open(root / f"{m.group('name')}.wal", "rb") as fh:
                    fh.seek(offset)
                    data = fh.read(length) if length > 0 else fh.read()
            except FileNotFoundError:
                return 404, {"error": f"no WAL {m.group('name')!r}"}
            return 200, ("application/octet-stream", data)

        def replication_status(m, body, query):
            root = self.config.store.store_path()
            fence = is_fenced(root)
            return 200, {
                "role": "fenced" if fence is not None else "primary",
                "epoch": read_epoch(root),
                "fence": fence,
            }

        def replication_fence(m, body, query):
            root = self.config.store.store_path()
            # Only a STRICTLY higher election epoch may fence this store:
            # a stale standby or a replayed POST must not take down a
            # healthy primary.
            ours = read_epoch(root)
            theirs = int((body or {}).get("epoch", 0) or 0)
            if theirs <= ours:
                return 409, {
                    "error": f"fence epoch {theirs} is not newer than "
                             f"this store's epoch {ours}",
                    "epoch": ours,
                }
            root.mkdir(parents=True, exist_ok=True)
            (root / FENCE_FILE).write_text(json.dumps(dict(body or {})))

            # Demote after this answer flushes: the promoted standby
            # needs the acknowledgement.
            def demote():
                time.sleep(0.2)
                logger.warning("store fenced by peer over "
                               "/replication/fence — demoting: shutting "
                               "down to prevent split-brain")
                self.shutdown()

            threading.Thread(target=demote, daemon=True,
                             name="lo-fence-demote").start()
            return 200, {"fenced": True}

        add("GET", r"/replication/wals", replication_wals)
        add("GET", rf"/replication/wal/{NAME}", replication_wal_read)
        add("GET", r"/replication/status", replication_status)
        add("POST", r"/replication/fence", replication_fence)

    def _register_routes(self) -> None:
        add = self.router.add

        add("GET", r"/health", lambda m, b, q: (200, {"status": "ok"}))
        add("GET", r"/registry",
            lambda m, b, q: (200, registry.list_registered()),
            cacheable=True)

        # ---- The gateway's own views ----
        def metrics_view(m, body, query):
            """The legacy per-route JSON, beside the registry's
            histograms at /metrics.prom."""
            with self._metrics_lock:
                routes = {
                    k: {**v, "avg_ms": round(v["total_ms"] / v["count"], 3)
                        if v["count"] else 0.0}
                    for k, v in self._metrics.items()}
            return 200, {"routes": routes, "budget": {
                "request_timeout_s": self.config.api.request_timeout_s,
                "cache_ttl_s": self.config.api.cache_ttl_s}}

        add("GET", r"/metrics", metrics_view)
        add("GET", r"/status", lambda m, b, q: (200, (
            "text/html; charset=utf-8", self._render_status().encode())))
        # The witness's snapshot: edges, contention events, every held or
        # contended lock with its holder and waiters, and their stacks
        # (enabled false and empty with the witness off).
        add("GET", r"/observability/locks", lambda m, b, q: (
            200, concurrency_rt.snapshot(include_stacks=True)))
        # Always 200: a single engine answers enabled false.
        add("GET", r"/cluster/status",
            lambda m, b, q: (200, self._cluster_doc()))
        self._register_replication_routes()

        # ---- Dataset ----
        def shard_rows_of(body, default):
            raw = body.get("shardRows", default)
            if raw is None:
                return None
            try:
                rows = int(raw)
            except (TypeError, ValueError):
                rows = 0
            if rows <= 0:
                # An explicit bad value errors, never takes the default.
                raise ValidationError("'shardRows' must be a positive integer")
            return rows

        def dataset_create(m, body, query):
            kind = m.group("tool")
            name = body.get("datasetName") or body.get("name")
            url = body.get("url")
            if not url:
                raise ValidationError("missing 'url'")
            if kind == "csv":
                meta = self.dataset.create_csv(
                    name, url, shard_rows=shard_rows_of(body, None))
            elif kind == "tensor":
                labels_url = body.get("labelsUrl")
                if not labels_url:
                    raise ValidationError(
                        "tensor ingest needs 'labelsUrl' (.npy labels)")
                meta = self.dataset.create_tensor(
                    name, url, labels_url=labels_url,
                    shard_rows=shard_rows_of(body, 4096))
            else:
                meta = self.dataset.create_generic(name, url)
            return self._created(f"dataset/{kind}", meta)

        add("POST", rf"/dataset/{TOOL}", dataset_create)
        add("GET", rf"/dataset/{TOOL}", self._list_handler("dataset"))
        add("GET", rf"/dataset/{TOOL}/{NAME}", self._page)
        add("DELETE", rf"/dataset/{TOOL}/{NAME}",
            self._deleter(self.dataset.delete))

        # ---- Transform: projection ----
        def projection_create(m, body, query):
            meta = self.transform.create_projection(
                body.get("projectionName") or body.get("name"),
                body.get("datasetName") or body.get("parentName"),
                body.get("fields") or [],
            )
            return self._created("transform/projection", meta)

        def projection_update(m, body, query):
            name = m.groupdict().get("name") or \
                body.get("projectionName") or body.get("name")
            return 200, {"metadata": self.transform.update_projection(
                name, fields=body.get("fields"))}

        add("POST", r"/transform/projection", projection_create)
        # The name rides in the body (the reference's form) or the path.
        add("PATCH", r"/transform/projection", projection_update)
        add("PATCH", rf"/transform/projection/{NAME}", projection_update)
        add("GET", r"/transform/projection",
            self._list_handler("transform", "projection"))
        add("GET", rf"/transform/projection/{NAME}", self._page)
        add("DELETE", rf"/transform/projection/{NAME}",
            self._deleter(self.dataset.delete))

        # ---- Transform: dataType ----
        def datatype_patch(m, body, query):
            return 200, {"metadata": self.transform.update_field_types(
                body.get("datasetName") or body.get("name"),
                body.get("types") or body.get("fields") or {},
            )}

        add("PATCH", r"/transform/dataType", datatype_patch)
        # The collection GET lists the dataset family; per-name GET and
        # DELETE go through the generic routes below.
        add("GET", r"/transform/dataType", self._list_handler("dataset", ""))

        # ---- Transform: text (BPE tokenization) ----
        def text_create(m, body, query):
            meta = self.transform.create_text(
                body.get("name"),
                body.get("datasetName") or body.get("parentName"),
                text_field=body.get("textField"),
                label_field=body.get("labelField"),
                vocab_size=body.get("vocabSize", 8000),
                max_len=body.get("maxLen", 128),
                lowercase=body.get("lowercase", True),
                tokenizer_from=body.get("tokenizerFrom"),
                shard_rows=body.get("shardRows", 4096),
            )
            return self._created("transform/text", meta)

        def text_update(m, body, query):
            name = m.groupdict().get("name") or body.get("name")
            return 200, {"metadata": self.transform.update_text(name)}

        add("POST", r"/transform/text", text_create)
        add("PATCH", r"/transform/text", text_update)
        add("PATCH", rf"/transform/text/{NAME}", text_update)
        add("GET", rf"/transform/text/{NAME}", self._page)
        add("DELETE", rf"/transform/text/{NAME}",
            self._deleter(self.dataset.delete))

        # ---- Transform: generic (scikitlearn | tensorflow) ----
        def transform_create(m, body, query):
            tool = m.group("tool")
            meta = self.transform.create_generic(
                body.get("name"),
                module_path=body.get("modulePath"),
                class_name=body.get("class"),
                class_parameters=body.get("classParameters"),
                method=body.get("method"),
                method_parameters=body.get("methodParameters"),
                artifact_type=f"transform/{tool}",
                description=body.get("description", ""),
            )
            return self._created(f"transform/{tool}", meta)

        def transform_update(m, body, query):
            return 200, {"metadata": self.transform.update_generic(
                m.group("name"),
                class_parameters=body.get("classParameters"),
                method_parameters=body.get("methodParameters"),
                description=body.get("description", ""),
            )}

        add("POST", rf"/transform/{TOOL}", transform_create)
        add("GET", rf"/transform/{TOOL}", self._list_handler("transform"))
        add("PATCH", rf"/transform/{TOOL}/{NAME}", transform_update)
        add("GET", rf"/transform/{TOOL}/{NAME}", self._page)
        add("DELETE", rf"/transform/{TOOL}/{NAME}",
            self._deleter(self.executor.delete))

        # ---- Explore ----
        def histogram_create(m, body, query):
            meta = self.explore.create_histogram(
                body.get("histogramName") or body.get("name"),
                body.get("datasetName") or body.get("parentName"),
                body.get("fields") or [],
            )
            return self._created("explore/histogram", meta)

        def curves_create(m, body, query):
            meta = self.explore.create_curves(
                body.get("name"), body.get("parentName"),
                fields=body.get("fields"))
            return self._created("explore/curves", meta)

        def curves_update(m, body, query):
            return 200, {"metadata": self.explore.update_curves(
                m.group("name"), fields=body.get("fields"))}

        def explore_create(m, body, query):
            tool = m.group("tool")
            meta = self.explore.create_plot(
                body.get("name"),
                module_path=body.get("modulePath"),
                class_name=body.get("class"),
                class_parameters=body.get("classParameters"),
                method=body.get("method", "fit_transform"),
                method_parameters=body.get("methodParameters"),
                artifact_type=f"explore/{tool}",
                color_by=body.get("colorBy"),
                description=body.get("description", ""),
            )
            return self._created(f"explore/{tool}", meta)

        def explore_update(m, body, query):
            return 200, {"metadata": self.explore.update_plot(
                m.group("name"),
                class_parameters=body.get("classParameters"),
                method_parameters=body.get("methodParameters"),
                color_by=body.get("colorBy"),
                description=body.get("description", ""),
            )}

        def explore_image(m, body, query):
            return 200, ("image/png", self.explore.read_image(
                m.group("name")))

        # The histogram and curves routes come before the generic
        # /explore/{TOOL} ones (first match wins); their GETs of an image
        # or metadata go through the generic routes.
        add("POST", r"/explore/histogram", histogram_create)
        add("GET", rf"/explore/histogram/{NAME}", self._page)
        add("POST", r"/explore/curves", curves_create)
        add("PATCH", rf"/explore/curves/{NAME}", curves_update)
        add("POST", rf"/explore/{TOOL}", explore_create)
        add("GET", rf"/explore/{TOOL}", self._list_handler("explore"))
        add("PATCH", rf"/explore/{TOOL}/{NAME}", explore_update)
        add("GET", rf"/explore/{TOOL}/{NAME}/metadata", self._page)
        add("GET", rf"/explore/{TOOL}/{NAME}", explore_image)
        add("DELETE", rf"/explore/{TOOL}/{NAME}",
            self._deleter(self.executor.delete))

        # ---- Model ----
        def model_create(m, body, query):
            tool = m.group("tool")
            meta = self.model.create(
                body.get("modelName") or body.get("name"),
                module_path=body.get("modulePath"),
                class_name=body.get("class"),
                class_parameters=body.get("classParameters"),
                artifact_type=f"model/{tool}",
                description=body.get("description", ""),
            )
            return self._created(f"model/{tool}", meta)

        def model_update(m, body, query):
            return 200, {"metadata": self.model.update(
                m.group("name"),
                class_parameters=body.get("classParameters"),
                description=body.get("description", ""),
            )}

        add("POST", rf"/model/{TOOL}", model_create)
        add("GET", rf"/model/{TOOL}", self._list_handler("model"))
        add("PATCH", rf"/model/{TOOL}/{NAME}", model_update)
        add("GET", rf"/model/{TOOL}/{NAME}", self._page)
        add("DELETE", rf"/model/{TOOL}/{NAME}",
            self._deleter(self.model.delete))

        # ---- Train / Evaluate / Predict ----
        def deadline_s(body):
            """Per-submit job deadline (``deadlineS``): None inherits the
            engine default, 0 disables."""
            raw = body.get("deadlineS")
            if raw is None:
                return None
            try:
                return float(raw)
            except (TypeError, ValueError):
                raise ValidationError(
                    f"deadlineS must be a number, got {raw!r}") from None

        def exec_create(service):
            def handler(m, body, query):
                tool = m.group("tool")
                parent = body.get("parentName") or body.get("modelName")
                if service == "tune" and body.get("paramGrid"):
                    meta = self.executor.create_tune(
                        body.get("name"),
                        parent_name=parent,
                        method=body.get("method", "fit"),
                        param_grid=body.get("paramGrid"),
                        method_parameters=body.get("methodParameters"),
                        scoring_parameters=body.get("scoringParameters"),
                        artifact_type=f"tune/{tool}",
                        description=body.get("description", ""),
                        deadline_s=deadline_s(body),
                    )
                else:
                    meta = self.executor.create(
                        body.get("name"),
                        parent_name=parent,
                        method=body.get("method"),
                        method_parameters=body.get("methodParameters"),
                        artifact_type=f"{service}/{tool}",
                        description=body.get("description", ""),
                        deadline_s=deadline_s(body),
                    )
                return self._created(f"{service}/{tool}", meta)

            return handler

        def exec_update(m, body, query):
            return 200, {"metadata": self.executor.update(
                m.group("name"),
                method_parameters=body.get("methodParameters"),
                description=body.get("description", ""),
                deadline_s=deadline_s(body),
            )}

        # ---- Distributed training (before the generic train routes: the
        # first match wins) ----
        def distributed_train_create(m, body, query):
            meta, extra = self.distributed.create_train(
                body.get("name"),
                parent_name=body.get("parentName") or body.get("modelName"),
                training_parameters=body.get("trainingParameters")
                or body.get("methodParameters"),
                compile_spec=body.get("compile"),
                mesh=body.get("mesh"),
                monitoring_path=body.get("monitoringPath"),
                description=body.get("description", ""),
            )
            status, payload = self._created("train/horovod", meta)
            if extra:
                payload["extra_results"] = extra
            return status, payload

        def distributed_train_update(m, body, query):
            return 200, {"metadata": self.distributed.update_train(
                m.group("name"),
                training_parameters=body.get("trainingParameters")
                or body.get("methodParameters"),
                compile_spec=body.get("compile"),
                mesh=body.get("mesh"),
                description=body.get("description", ""),
            )}

        add("POST", r"/train/(?:horovod|distributed)",
            distributed_train_create)
        add("PATCH", rf"/train/(?:horovod|distributed)/{NAME}",
            distributed_train_update)

        # ---- Monitoring sessions ----
        def monitoring_lookup(m, body, query):
            name = m.group("name")
            if name in ("compileCache", "compile_cache"):
                return 200, self.monitoring.compile_cache_stats()
            if name == "serving":
                stats = self.serving.stats()
                return 200, {**stats,
                             "scalars": self.serving.snapshot_scalars(stats)}
            try:
                return 200, self.monitoring.lookup(name)
            except MonitoringError as exc:
                return 404, {"error": str(exc)}

        add("GET", rf"/monitoring/{TOOL}/{NAME}", monitoring_lookup)
        # The cost plane's JSON view (obs/costs.py).
        add("GET", r"/observability/costs",
            lambda m, b, q: (200, costs.snapshot()))
        add("GET", rf"/monitoring/{TOOL}",
            lambda m, b, q: (200, self.monitoring.list_sessions()))

        # ---- The operations plane (obs/, faults/), in the JAX server's
        # order.
        def metrics_prom(m, body, query):
            return 200, ("text/plain; version=0.0.4; charset=utf-8",
                         self.obs.render_prometheus().encode())

        add("GET", r"/metrics\.prom", metrics_prom)

        def job_trace(m, body, query):
            """Span tree of a job's life, from the newest execution record
            carrying a trace."""
            name = m.group("name")
            self.ctx.require_existing(name)
            doc = next((rec["trace"] for rec in reversed(
                self.ctx.artifacts.ledger.history(name)) if rec.get("trace")),
                None)
            if doc is None:
                return 404, {
                    "error": f"no trace recorded for {name!r} (job still "
                             "running, predates tracing, or "
                             "LO_TPU_OBS_TRACE=0)"}
            spans = doc.get("spans", [])
            return 200, {
                "name": name,
                "requestId": doc.get("requestId"),
                "droppedSpans": doc.get("droppedSpans", 0),
                "spans": spans,
                "tree": obs_tracing.span_tree(spans),
            }

        add("GET", rf"/observability/jobs/{NAME}/trace", job_trace)

        def timeseries_view(m, body, query):
            try:
                window_s = float(query.get("windowS", 300.0))
                max_points = int(query.get("points", 0))
            except (TypeError, ValueError):
                raise BadRequest("windowS/points must be numeric") from None
            labels = {k: v for k, v in query.items()
                      if k not in ("name", "windowS", "points")}
            return 200, self.rollup.timeseries(
                query.get("name"), labels or None, window_s=window_s,
                max_points=max_points)

        add("GET", r"/observability/timeseries", timeseries_view)
        add("GET", r"/observability/alerts",
            lambda m, b, q: (200, self.slo.alerts()))
        add("GET", r"/observability/slo",
            lambda m, b, q: (200, self.slo.status()))

        def slo_create(m, body, query):
            threshold_ms = body.get("thresholdMs")
            try:
                doc = self.slo.add_objective(
                    body.get("name"), body.get("kind"),
                    body.get("target", 0),
                    threshold_s=(float(threshold_ms) / 1000.0
                                 if threshold_ms is not None else None),
                    metric=body.get("metric"), route=body.get("route"))
            except (TypeError, ValueError) as exc:
                raise ValidationError(str(exc)) from None
            return 201, {"objective": doc}

        def slo_delete(m, body, query):
            if not self.slo.remove_objective(m.group("name")):
                return 404, {
                    "error": f"no runtime objective {m.group('name')!r}"}
            return 200, {"result": "deleted"}

        add("POST", r"/observability/slo", slo_create)
        add("DELETE", rf"/observability/slo/{NAME}", slo_delete)

        def flight_view(m, body, query):
            domains = tuple(d for d in str(query.get("domain") or "")
                            .split(",") if d) or None
            limit = _int_param(query, "limit", 0)
            doc = obs_flight.snapshot(domains=domains, limit=limit)
            doc["timeline"] = obs_flight.timeline(domains=domains,
                                                  limit=limit)
            return 200, doc

        def bundle_create(m, body, query):
            reason = str(body.get("reason") or "manual")
            return 201, {"bundle": self.bundles.build(reason,
                                                      {"via": "rest"})}

        def bundle_get(m, body, query):
            name = m.group("name")
            rel = query.get("file")
            if rel:
                # One bundle file's bytes (traversal refused in read_file).
                return 200, ("application/octet-stream",
                             self.bundles.read_file(name, rel))
            doc = self.bundles.manifest(name)
            if doc is None:
                return 404, {"error": f"no bundle {name!r}"}
            return 200, doc

        def bundle_delete(m, body, query):
            if not self.bundles.delete(m.group("name")):
                return 404, {"error": f"no bundle {m.group('name')!r}"}
            return 200, {"result": "deleted"}

        add("GET", r"/observability/flight", flight_view)
        add("POST", r"/observability/bundle", bundle_create)
        add("GET", r"/observability/bundles",
            lambda m, b, q: (200, self.bundles.status()))
        add("DELETE", r"/observability/bundles",
            lambda m, b, q: (200, {"deleted": self.bundles.delete_all()}))
        add("GET", rf"/observability/bundles/{NAME}", bundle_get)
        add("DELETE", rf"/observability/bundles/{NAME}", bundle_delete)

        def faults_arm(m, body, query):
            mode = body.get("mode")
            if not mode:
                raise ValidationError(
                    f"missing 'mode' (one of {list(faults.MODES)})")
            try:
                doc = faults.arm(
                    m.group("name"), str(mode),
                    rate=float(body.get("rate", 1.0)),
                    seed=int(body.get("seed", 0)),
                    after=int(body.get("after", 0)),
                    max_triggers=int(body.get("maxTriggers", 0)),
                    delay_ms=float(body.get("delayMs", 0.0)))
            except (TypeError, ValueError) as exc:
                raise ValidationError(str(exc)) from None
            return 201, {"point": m.group("name"), "armed": doc}

        def faults_disarm(m, body, query):
            try:
                disarmed = faults.disarm(m.group("name"))
            except ValueError as exc:  # unknown point
                raise ValidationError(str(exc)) from None
            if not disarmed:
                return 404, {"error": f"fault point {m.group('name')!r} "
                                      "is not armed"}
            return 200, {"result": "disarmed"}

        def faults_disarm_all(m, body, query):
            faults.disarm_all()
            return 200, {"result": "disarmed"}

        add("GET", r"/faults", lambda m, b, q: (200, faults.status()))
        add("DELETE", r"/faults", faults_disarm_all)
        add("POST", rf"/faults/{NAME}", faults_arm)
        add("DELETE", rf"/faults/{NAME}", faults_disarm)

        # ---- On-demand profiler capture (obs/profiling.py), in the JAX
        # server's order: /start before /stop.
        def profile_start(m, body, query):
            return 201, {"capture": self.profiler.start(
                name=body.get("name"), max_seconds=body.get("maxSeconds"))}

        def profile_capture(m, body, query):
            name = m.group("name")
            rel = query.get("file")
            if rel:
                # One capture file's bytes (path traversal is rejected in
                # read_file).
                return 200, ("application/octet-stream",
                             self.profiler.read_file(name, rel))
            doc = self.profiler.capture(name)
            if doc is None:
                return 404, {"error": f"no capture {name!r}"}
            return 200, doc

        # Exempt from the request budget, unlike the JAX server's: in a
        # fresh process a start initializes CUPTI and warms the tracer
        # (profiling.start_warm), past 10 s on an H100, and a stop writes
        # the trace; a 504 would report a capture failed that then runs.
        add("POST", r"/observability/profile/start", profile_start,
            no_timeout=True)
        add("POST", r"/observability/profile/stop",
            lambda m, b, q: (200, {"capture": self.profiler.stop()}),
            no_timeout=True)
        add("GET", r"/observability/profile",
            lambda m, b, q: (200, self.profiler.status()))
        add("GET", r"/observability/profile/captures",
            lambda m, b, q: (200, {
                "captures": self.profiler.list_captures()}))
        add("GET", rf"/observability/profile/captures/{NAME}",
            profile_capture)
        add("DELETE", rf"/observability/profile/captures/{NAME}",
            lambda m, b, q: (
                (200, {"result": "deleted"})
                if self.profiler.delete(m.group("name"))
                else (404, {"error": f"no capture {m.group('name')!r}"})))
        add("DELETE", rf"/monitoring/{TOOL}/{NAME}", lambda m, b, q: (
            200, {"stopped": self.monitoring.stop(m.group("name"))}))

        for service in ("tune", "train", "evaluate", "predict"):
            add("POST", rf"/{service}/{TOOL}", exec_create(service))
            add("GET", rf"/{service}/{TOOL}", self._list_handler(service))
            add("PATCH", rf"/{service}/{TOOL}/{NAME}", exec_update)
            add("GET", rf"/{service}/{TOOL}/{NAME}", self._page)
            add("DELETE", rf"/{service}/{TOOL}/{NAME}",
                self._deleter(self.executor.delete))

        # ---- Function ----
        def function_create(m, body, query):
            meta = self.function.create(
                body.get("name"),
                function=body.get("function"),
                function_parameters=body.get("functionParameters"),
                description=body.get("description", ""),
                deadline_s=deadline_s(body),
            )
            return self._created("function/python", meta)

        def function_update(m, body, query):
            return 200, {"metadata": self.function.update(
                m.group("name"),
                function=body.get("function"),
                function_parameters=body.get("functionParameters"),
                description=body.get("description", ""),
                deadline_s=deadline_s(body),
            )}

        add("POST", r"/function/python", function_create)
        add("GET", r"/function/python",
            self._list_handler("function", "python"))
        add("PATCH", rf"/function/python/{NAME}", function_update)
        add("GET", rf"/function/python/{NAME}", self._page)
        add("DELETE", rf"/function/python/{NAME}",
            self._deleter(self.function.delete))

        # ---- Builder ----
        def builder_create(m, body, query):
            tool = m.group("tool")
            if tool in ("tensorflow", "pytorch", "horovod"):
                # The distributed builder: one user function on every rank.
                n_workers = body.get("nWorkers")
                if n_workers is None:  # explicit: 0 must reach validation
                    n_workers = body.get("n_workers")
                meta = self.distributed.create_builder(
                    body.get("name"),
                    function=body.get("function")
                    or body.get("modelingCode"),
                    function_parameters=body.get("functionParameters"),
                    n_workers=n_workers,
                    description=body.get("description", ""),
                )
                return self._created(f"builder/{tool}", meta)
            metas = self.builder.create(
                training_dataset=body.get("trainDatasetName"),
                test_dataset=body.get("testDatasetName"),
                classifiers=body.get("classifiersList")
                or body.get("classifiers") or [],
                label_field=body.get("labelField", "label"),
                feature_fields=body.get("featureFields"),
                modeling_code=body.get("modelingCode"),
                classifier_parameters=body.get("classifierParameters"),
                description=body.get("description", ""),
            )
            return 201, {"result": [
                f"{self.config.api.api_prefix}/builder/sparkml/{mm['name']}"
                for mm in metas]}

        add("POST", rf"/builder/{TOOL}", builder_create)
        add("GET", rf"/builder/{TOOL}", self._list_handler("builder"))
        add("GET", rf"/builder/{TOOL}/{NAME}", self._page)
        add("DELETE", rf"/builder/{TOOL}/{NAME}",
            self._deleter(self.executor.delete))

        # ---- Observe: the long poll the client's wait() loops on ----
        def observe_wait(m, body, query):
            name = m.group("name")
            try:
                timeout = float(query.get("timeout", 30))
            except (TypeError, ValueError):
                raise BadRequest("timeout must be a number") from None
            self.ctx.require_existing(name)
            deadline = time.time() + min(timeout, 300)
            while True:
                meta = self.ctx.artifacts.metadata.read(name)
                if (meta.get("finished") or meta.get("jobState") == "failed"
                        or time.time() >= deadline):
                    return 200, {"metadata": meta}
                # A request thread holding no lock: the analyzer takes the
                # nested handlers for _register_routes' __init__ context.
                # The handler polls the store between its reads.
                # lo-check: disable=blocking-call-under-lock
                time.sleep(0.1)

        # The feed and the wildcard webhooks come before the NAME route:
        # "events" and "webhook" would match it (first match wins).
        def observe_events(m, body, query):
            try:
                since = int(query.get("sinceId", -1))
                limit = int(query.get("limit", 100))
            except (TypeError, ValueError):
                raise BadRequest("sinceId/limit must be integers") from None
            return 200, {"result": self.ctx.webhooks.events(since, limit)}

        def webhook_register_all(m, body, query):
            try:
                hook = self.ctx.webhooks.register(
                    "*", body.get("url"), body.get("events"))
            except ValueError as exc:
                raise ValidationError(str(exc)) from None
            return 201, {"result": hook}

        def webhook_delete(m, body, query):
            """One artifact's hook, or a wildcard one (no name)."""
            if not self.ctx.webhooks.unregister(
                    m.groupdict().get("name") or "*", int(m.group("hook"))):
                return 404, {"error": "no such webhook"}
            return 200, {"result": "deleted"}

        add("GET", r"/observe/events", observe_events)
        add("POST", r"/observe/webhook", webhook_register_all)
        add("GET", r"/observe/webhook",
            lambda m, b, q: (200, {"result": self.ctx.webhooks.list("*")}))
        add("DELETE", r"/observe/webhook/(?P<hook>[0-9]+)", webhook_delete)
        add("GET", rf"/observe/{NAME}", observe_wait, no_timeout=True)

        # ---- Observe push: one artifact's webhooks ----
        def webhook_register(m, body, query):
            name = m.group("name")
            self.ctx.require_existing(name)
            try:
                hook = self.ctx.webhooks.register(
                    name, body.get("url"), body.get("events"))
            except ValueError as exc:
                raise ValidationError(str(exc)) from None
            # Registered after the job ended: the engine's terminal path
            # will never fire again, so deliver now.  The metadata is
            # read after the insert, so a job finishing in between is
            # seen by the engine or here (at worst both: delivery is at
            # least once).
            meta = self.ctx.artifacts.metadata.read(name) or {}
            event = None
            if meta.get("jobState") == "failed":
                event = "failed"
            elif meta.get("finished"):
                event = "finished"
            if event is not None and event in hook["events"]:
                # Only this late hook: the feed and the wildcard hooks
                # saw the transition when it happened.
                self.ctx.webhooks.deliver_to(hook, name, event, meta)
                hook = {**hook, "firedImmediately": event}
            return 201, {"result": hook}

        def webhook_list(m, body, query):
            name = m.group("name")
            self.ctx.require_existing(name)
            return 200, {"result": self.ctx.webhooks.list(name)}

        add("POST", rf"/observe/{NAME}/webhook", webhook_register)
        add("GET", rf"/observe/{NAME}/webhook", webhook_list)
        add("DELETE", rf"/observe/{NAME}/webhook/(?P<hook>[0-9]+)",
            webhook_delete)

        # ---- Job control: cancel ----
        def job_cancel(m, body, query):
            name = m.group("name")
            self.ctx.require_existing(name)
            result = self.ctx.engine.cancel(name)
            if result is True:
                return 200, {"job": name, "result": "cancelled"}
            if result:
                return 202, {"job": name, "result": "cancelling"}
            return 409, {"error": f"job {name!r} is not queued or running "
                                  "(already terminal)"}

        add("DELETE", rf"/jobs/{NAME}", job_cancel)

        # ---- Serving ----
        def serve_predict(m, body, query):
            instances = body.get("instances")
            if instances is None:
                instances = body.get("x")
            if instances is None:
                raise ValidationError("missing 'instances'")
            return 200, self.serving.predict(m.group("name"), instances)

        def serve_unload(m, body, query):
            if not self.serving.unload(m.group("name")):
                return 404, {
                    "error": f"model {m.group('name')!r} is not loaded"
                }
            return 200, {"result": "unloaded"}

        def serve_generate(m, body, query):
            """Autoregressive decode against a resident LM.  With
            ``stream: true`` the payload is the DecodeStream itself, which
            the HTTP layer writes as an SSE body (its ``sse_events``)."""
            prompts = body.get("prompts")
            if prompts is None:
                prompts = body.get("instances")
            if prompts is None:
                raise ValidationError("missing 'prompts'")
            try:
                kwargs = {
                    "max_new_tokens": int(body.get("maxNewTokens", 32)),
                    "stream": bool(body.get("stream")),
                    "seed": int(body.get("seed", 0)),
                }
                for key, arg, cast in (("temperature", "temperature", float),
                                       ("topK", "top_k", int),
                                       ("topP", "top_p", float)):
                    if body.get(key) is not None:
                        kwargs[arg] = cast(body[key])
            except (TypeError, ValueError) as exc:
                raise ValidationError(f"bad generate parameter: {exc}") \
                    from None
            return 200, self.serving.generate(m.group("name"), prompts,
                                              **kwargs)

        def serve_generate_abort(m, body, query):
            """Abort an in-flight stream: its slot frees at the next step
            boundary, even while its socket is nominally open."""
            if not self.serving.decode.abort(
                    m.group("name"), m.group("stream"),
                    reason="aborted by DELETE"):
                return 404, {
                    "error": f"no active stream {m.group('stream')!r} for "
                             f"model {m.group('name')!r}"
                }
            return 200, {"aborted": m.group("stream")}

        # Fleet: registered BEFORE the per-model routes, so the literal
        # "fleet" never parses as a model name.
        add("GET", r"/serve/fleet",
            lambda m, b, q: (200, self.serving.fleet.snapshot()))

        def serve_replicas_get(m, body, query):
            status = self.serving.fleet.status_for(m.group("name"))
            if not status:
                return 404, {
                    "error": f"model {m.group('name')!r} has no replica "
                             "set (POST bounds/count to create one)"
                }
            return 200, status

        def serve_replicas_post(m, body, query):
            """Create or resize a model's replica set: any of ``min``,
            ``max`` (autoscaler bounds), ``count`` (manual scale, clamped
            to the bounds) and ``devicesPerReplica``.  Each replica
            leases a card; an exhausted pool is the LeaseTimeout 503."""
            def _int(key):
                val = body.get(key)
                if val is None:
                    return None
                try:
                    return int(val)
                except (TypeError, ValueError):
                    raise ValidationError(
                        f"{key!r} must be an integer, got {val!r}"
                    ) from None

            mn, mx, count = _int("min"), _int("max"), _int("count")
            dpr = _int("devicesPerReplica")
            if mn is None and mx is None and count is None and dpr is None:
                raise ValidationError(
                    "body needs at least one of 'min', 'max', 'count', "
                    "'devicesPerReplica'"
                )
            return 200, self.serving.fleet.configure(
                m.group("name"), min_replicas=mn, max_replicas=mx,
                count=count, devices_per_replica=dpr,
            )

        def serve_replicas_delete(m, body, query):
            """Dissolve the model's fleet: drain replicas, release cards,
            back to single-path serving (the model stays loaded).
            Idempotent."""
            name = m.group("name")
            return 200, {"model": name,
                         "dissolved": self.serving.fleet.dissolve(name)}

        add("GET", rf"/serve/{NAME}/replicas", serve_replicas_get)
        add("POST", rf"/serve/{NAME}/replicas", serve_replicas_post)
        add("DELETE", rf"/serve/{NAME}/replicas", serve_replicas_delete)
        add("POST", rf"/serve/{NAME}/predict", serve_predict)
        add("POST", rf"/serve/{NAME}/generate", serve_generate,
            no_timeout=True)
        add("DELETE", rf"/serve/{NAME}/generate/(?P<stream>[A-Za-z0-9]+)",
            serve_generate_abort)
        add("POST", rf"/serve/{NAME}/load", lambda m, b, q: (
            200, {"result": self.serving.load(m.group("name"))},
        ))
        add("POST", rf"/serve/{NAME}/unload", serve_unload)
        add("DELETE", rf"/serve/{NAME}", serve_unload)
        add("GET", r"/serve", lambda m, b, q: (200, {
            "models": self.serving.list_loaded(),
            "stats": self.serving.stats(),
        }))

    # -- dispatch -------------------------------------------------------------

    def handle(self, verb: str, path: str, body, query: dict | None = None,
               request_id: str | None = None, idem_key: str | None = None,
               tenant: str | None = None) -> tuple[int, object]:
        """Route one request through the gateway; returns (status, JSON
        payload, or a (content type, bytes) pair).  Admission first (503
        when ``max_inflight`` handlers hold their slots), then the cache
        of opted-in GETs (any other verb clears it), the idempotency
        ledger for a keyed POST, PATCH or DELETE, and the handler under
        the request budget (504 past it).  Every request is metered by
        its route and status class and recorded in the ``http`` flight
        ring; ``request_id`` is bound for the handler, so a job it
        submits carries it into its trace, as is ``tenant`` (the
        ``X-Tenant`` header), checked against its quota first on a
        job-creating POST or PATCH (429 + ``Retry-After`` over it)."""
        t0 = time.perf_counter()
        query = query or {}
        if self._inflight is None:
            slot = _Slot(None)
        elif self._inflight.acquire(blocking=False):
            slot = _Slot(self._inflight)
        else:
            # Saturated: shed now rather than queue behind stuck handlers.
            self._record_metric("saturated", 503, 0.0,
                                request_id=request_id)
            return 503, {
                "error": "gateway saturated "
                         f"({self.config.api.max_inflight} requests in "
                         "flight); retry with backoff"}
        try:
            status, payload, key = self._handle_slotted(
                verb, path, body, query, slot, request_id, idem_key,
                tenant)
        finally:
            # For a request past its budget the handler's thread co-owns
            # the slot: it frees when that thread really returns.
            slot.release()
        self._record_metric(key, status, (time.perf_counter() - t0) * 1e3,
                            request_id=request_id)
        return status, payload

    #: Route prefixes whose POST / PATCH enqueue engine jobs: the set the
    #: tenant admission gates (serving has its own backpressure).
    _JOB_ROUTE_PREFIXES = (
        "/dataset/", "/transform/", "/explore/", "/model/", "/train/",
        "/tune/", "/evaluate/", "/predict/", "/function/", "/builder/",
    )

    def _is_job_route(self, path: str) -> bool:
        prefix = self.config.api.api_prefix.rstrip("/")
        if prefix and path.startswith(prefix):
            path = path[len(prefix):]
        return path.startswith(self._JOB_ROUTE_PREFIXES)

    def _handle_slotted(self, verb, path, body, query, slot, request_id,
                        idem_key, tenant=None):
        """-> (status, payload, route key) of an admitted request."""
        handler, m, key = self.router.resolve(verb, path)
        if handler is None:
            return ((405, {"error": f"method {verb} not allowed on {path}"},
                     key) if m == "405" else
                    (404, {"error": f"no such route: {path}"}, key))
        if not isinstance(body, dict):
            return 406, {"error": "request body must be a JSON object"}, key
        # Tenant admission before the handler runs: a rejected request
        # leaves no orphan metadata behind.
        if (self.ctx.admission is not None and verb in ("POST", "PATCH")
                and self._is_job_route(path)):
            try:
                self.ctx.admission.check(tenant)
            except QuotaExceeded as exc:
                return 429, {"error": str(exc),
                             "retryAfter": exc.retry_after_s}, key
        flags = self.router.flags[key]
        ttl = self.config.api.cache_ttl_s
        cache_key = None
        if verb == "GET" and flags["cacheable"] and ttl > 0:
            cache_key = (path, tuple(sorted(query.items())))
            with self._cache_lock:
                hit = self._cache.get(cache_key)
            if hit is not None and hit[0] > time.monotonic():
                return hit[1], hit[2], key
        elif verb != "GET":
            # Any mutation clears the whole cache: cheap, and mutations
            # are rare beside polls.
            with self._cache_lock:
                self._cache.clear()

        idem_id = None
        if idem_key and verb in ("POST", "PATCH", "DELETE"):
            kind, *rest = self._idem_begin(
                idem_key, self._idem_fingerprint(verb, path, body, query))
            if kind == "replay":
                return rest[0], rest[1], key
            if kind == "mismatch":
                return 422, {
                    "error": "this idempotency key was already used for a "
                             "different request — keys identify ONE "
                             "logical mutation; mint a fresh key per "
                             "operation",
                    "idempotency_key": idem_key}, key
            if kind == "ambiguous":
                return 409, {
                    "error": "a previous attempt with this idempotency key "
                             "began but has no recorded outcome (still in "
                             "flight, or the server died mid-request) — "
                             "inspect the artifact's state before retrying "
                             "with a fresh key",
                    "idempotency_key": idem_key}, key
            idem_id = rest[0]

        def invoke():
            # Bound here: past the budget the handler runs on its own
            # thread, which does not inherit the HTTP thread's context.
            token = (obs_tracing.set_request_id(request_id)
                     if request_id else None)
            try:
                # The tenant rides a contextvar like the request id: the
                # engine's submit stamps it on the job.
                with bind_tenant(tenant):
                    result = self._handle_raw(handler, m, body, query)
            finally:
                if token is not None:
                    obs_tracing.reset_request_id(token)
            if idem_id is not None:
                self._idem_finish(idem_id, *result)
            return result

        timeout = self.config.api.request_timeout_s
        if flags["no_timeout"] or timeout <= 0:
            status, payload = invoke()
        else:
            # A thread per request, not a pool: stuck handlers must not
            # leave a fixed pool answering only 504s.  Python cannot
            # cancel the abandoned thread; a timed-out mutation may still
            # commit later, as behind any gateway.
            box: dict = {}

            def run():
                try:
                    box["result"] = invoke()
                finally:
                    slot.release()

            slot.share()
            worker = threading.Thread(target=run, name="lo-gateway-req",
                                      daemon=True)
            worker.start()
            worker.join(timeout)
            if "result" in box:
                status, payload = box["result"]
            else:
                status, payload = 504, {
                    "error": f"request exceeded {timeout}s gateway budget"}
        if cache_key is not None and status < 400:
            with self._cache_lock:
                self._cache[cache_key] = (time.monotonic() + ttl, status,
                                          payload)
        return status, payload, key

    def _handle_raw(self, handler, m, body, query):
        try:
            # Chaos probe inside the try: an injected error exercises the
            # real 500 path, an injected delay the real latency path.
            faults.hit("http.handler")
            return handler(m, body, query)
        except (DuplicateArtifact, ConflictError, ProfilerConflict,
                BundleBusy) as exc:
            return 409, {"error": str(exc)}
        except (NotFoundError, ServeNotFound, ProfilerNotFound,
                BundleNotFound) as exc:
            return 404, {"error": str(exc)}
        except (ValidationError, RegistryError, ServeError,
                ProfilerError, BundleError) as exc:
            return 406, {"error": str(exc)}
        except LeaseTimeout as exc:
            # No card lease within the placement budget: the pool is
            # saturated, not broken; retriable like a 429.
            return 503, {
                "error": str(exc),
                "retryAfter": self.config.serve.retry_after_s,
            }
        except QueueFull as exc:
            # Backpressure: shed load with an explicit retry budget.
            return 429, {
                "error": str(exc),
                "retryAfter": self.config.serve.retry_after_s,
            }
        except QuotaExceeded as exc:
            # A handler that submits more jobs inside can still trip a
            # tenant quota after the gateway's check.
            return 429, {"error": str(exc),
                         "retryAfter": exc.retry_after_s}
        except BadRequest as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001 — the server must keep
            # serving: log the traceback, report the failure.
            logger.exception("unhandled handler error: %r", exc)
            return 500, {"error": repr(exc)}

    # -- HTTP plumbing --------------------------------------------------------

    def _handler_class(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _run(self, verb: str):
                # Echo the client's X-Request-Id or mint one; every
                # response carries it.
                rid = (self.headers.get("X-Request-Id") or "").strip()
                if not _RID_RE.fullmatch(rid):
                    rid = obs_tracing.new_request_id()
                self._request_id = rid
                if api._drain_if_shutting_down(self):
                    return
                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                # The tenant for fair-share admission: a bad value is a
                # 400, never silently reassigned.
                tenant = (self.headers.get("X-Tenant") or "").strip()
                if tenant and not _RID_RE.fullmatch(tenant):
                    self._send(400, {
                        "error": "invalid X-Tenant header: expected 1-64 "
                                 "chars of [A-Za-z0-9_.-]"})
                    return
                body = {}
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw) if raw.strip() else {}
                    except json.JSONDecodeError:
                        self._send(400, {"error": "request body is not JSON"})
                        return
                self._send(*api.handle(
                    verb, parsed.path, body, query, request_id=rid,
                    idem_key=self.headers.get("X-Idempotency-Key"),
                    tenant=tenant or None))

            def _send(self, status: int, payload):
                events = getattr(payload, "sse_events", None)
                if callable(events):
                    self._send_sse(status, payload, events)
                    return
                if isinstance(payload, tuple):  # (content type, bytes)
                    ctype, data = payload
                else:
                    ctype = "application/json"
                    data = json.dumps(payload, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Request-Id", self._request_id)
                if status in (429, 503) and isinstance(payload, dict) \
                        and payload.get("retryAfter") is not None:
                    self.send_header(
                        "Retry-After", str(payload["retryAfter"])
                    )
                self.end_headers()
                self.wfile.write(data)

            def _send_sse(self, status: int, stream, events):
                """A server-sent-events body for a DecodeStream.  Its length
                is not known up front, so the body ends at EOF
                (``Connection: close``).  A broken pipe mid-stream is the
                client's disconnect: it aborts the stream, whose slot frees
                at the next step boundary."""
                self.close_connection = True
                self.send_response(status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-store")
                self.send_header("Connection", "close")
                self.send_header("X-Request-Id", self._request_id)
                self.end_headers()
                try:
                    for name, doc in events():
                        self.wfile.write((
                            f"event: {name}\n"
                            f"data: {json.dumps(doc, default=str)}\n\n"
                        ).encode())
                        self.wfile.flush()
                except OSError:  # BrokenPipeError, ConnectionResetError
                    stream.abort("client disconnected")

            def do_GET(self):
                self._run("GET")

            def do_POST(self):
                self._run("POST")

            def do_PATCH(self):
                self._run("PATCH")

            def do_DELETE(self):
                self._run("DELETE")

        return Handler

    def serve_forever(self, host: str | None = None,
                      port: int | None = None) -> None:
        """Serve in the calling thread on ``host:port`` (the config's
        ``api.host`` / ``api.port`` by default) until :meth:`shutdown`."""
        host = self.config.api.host if host is None else host
        port = self.config.api.port if port is None else port
        httpd = _BoundedThreadingHTTPServer(
            (host, port), self._handler_class(),
            max_connections=self.config.api.max_connections)
        # Published under the shutdown lock: a shutdown() racing this
        # either sees the listener (and stops it) or has already flipped
        # _shut_down (and nothing serves).
        with self._shutdown_lock:
            if self._shut_down:
                httpd.server_close()
                return
            self._httpd = httpd
        self._start_fence_watch()
        try:
            httpd.serve_forever()
        except Exception:
            # shutdown() closed the socket before the poll loop began:
            # a clean stop, not an error.
            with self._shutdown_lock:
                if self._shut_down:
                    return
            raise

    def start_background(self, host: str = "127.0.0.1",
                         port: int | None = None) -> int:
        """Bind, serve on a daemon thread, return the bound port (None/0
        picks an ephemeral one)."""
        httpd = _BoundedThreadingHTTPServer(
            (host, port or 0), self._handler_class(),
            max_connections=self.config.api.max_connections)
        with self._shutdown_lock:
            self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="lo-http-accept").start()
        self._start_fence_watch()
        return httpd.server_address[1]

    #: Seconds between fence checks (``HAConfig.fence_interval_s``
    #: overrides it per server).
    FENCE_CHECK_INTERVAL_S = 5.0

    def _start_fence_watch(self) -> None:
        """Self-demote when a standby fences this store while it serves.

        :func:`serve` refuses to START on a fenced store, but a running
        primary can be fenced underneath itself (a partition makes the
        standby promote; when it heals, old clients would go on writing
        here).  On a shared filesystem the fence marker shows within one
        interval; without one the watch polls ``HAConfig.peer``'s
        ``/replication/status``, and a primary peer with a higher
        election epoch fences this store.  Either way the server shuts
        itself down."""
        from learningorchestra_tpu_torch.store.ha import is_fenced

        store_root = self.config.store.store_path()
        peer = self.config.ha.peer

        def watch():
            # wait() is the sleep and the exit signal: a normal shutdown
            # ends the thread at once.
            while not self._shutting_down.wait(self.FENCE_CHECK_INTERVAL_S):
                fence = is_fenced(store_root)
                if fence is None and peer:
                    fence = _peer_supersedes(store_root, peer)
                if fence is not None:
                    logger.warning(
                        "store fenced while serving (promoted_to=%r) — "
                        "demoting: shutting down to prevent split-brain",
                        fence.get("promoted_to"))
                    self.shutdown()
                    return

        threading.Thread(target=watch, daemon=True,
                         name="lo-fence-watch").start()

    def _drain_if_shutting_down(self, handler) -> bool:
        """503 + ``Connection: close`` for a request that arrives on a
        kept-alive connection after shutdown started: the accept loop is
        gone, but HTTP/1.1 connections would go on being served."""
        if not self._shutting_down.is_set():
            return False
        handler.close_connection = True
        handler._send(503, {"error": "server is shutting down"})
        return True

    def shutdown(self) -> None:
        """Idempotent stop: the accept loop halted and its socket closed,
        kept-alive connections answered 503, then the models released,
        the engine stopped and the store closed, once."""
        with self._shutdown_lock:
            if self._shut_down:
                return
            self._shut_down = True
            httpd, self._httpd = self._httpd, None
        self._shutting_down.set()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        # The registry outlives this server: drop the collector so scrapes
        # never touch a closed context.
        if self._obs_registry is not None:
            self._obs_registry.remove_collector(self._collect_families)
        # Stop the rollup/SLO clock: a stopped server must not evaluate
        # frozen windows (a later server's construction restarts it).
        self.rollup.stop()
        self.profiler.close()
        self.serving.close()
        self.monitoring.close()
        self.ctx.close()


def _peer_supersedes(store_root, peer: str) -> dict | None:
    """Did the HA peer promote over this store?  The fence record (also
    written locally, best effort) when the peer is a primary serving a
    STRICTLY HIGHER election epoch, else None: the no-shared-disk half of
    fencing.  An unreachable peer, or one answering ``role="standby"``
    (a monitoring standby serves its status route), does not supersede."""
    from learningorchestra_tpu_torch.store.ha import peer_status
    from learningorchestra_tpu_torch.store.replica import (
        FENCE_FILE,
        read_epoch,
    )

    status = peer_status(peer)
    if (status is None or status.get("role") != "primary"
            or int(status.get("epoch", 0)) <= read_epoch(store_root)):
        return None
    fence = {"promoted_to": peer, "epoch": status.get("epoch"),
             "reason": "peer holds higher election epoch"}
    try:
        # Durable self-fence: the next restart refuses without asking.
        store_root.mkdir(parents=True, exist_ok=True)
        (store_root / FENCE_FILE).write_text(json.dumps(fence))
    except OSError:
        pass
    return fence


#: Exit status of ``serve`` when it refuses to start: the store is fenced
#: or the HA peer holds a higher election epoch.
SERVE_REFUSED = 3


def serve(config: Config | None = None, *, device=None) -> int:
    """Run the API server in the foreground on ``api.host:api.port`` until
    KeyboardInterrupt (SIGINT), then shut it down: the accept loop, the
    rollup clock, serving with its decode pools, and the job engine stop,
    so the process exits and the lock witness's exit dump is written.
    ``device`` overrides ``config.device`` (``"cpu"`` for a test).
    Returns the process's exit status.

    Store HA first, as in the JAX ``serve()``: a fenced store, or an
    ``HAConfig.peer`` that promoted over this one (a higher election
    epoch), refuses to serve — status :data:`SERVE_REFUSED`, where the
    JAX package exits 0 — unless ``HAConfig.auto_rejoin`` makes this node
    the new primary's standby (WALs shipped over the network into
    ``<store>.rejoined``); a node whose rejoin replica was promoted
    resumes serving from it."""
    from pathlib import Path

    from learningorchestra_tpu_torch.store.ha import (
        is_fenced,
        promotion_record,
        run_standby,
    )
    from learningorchestra_tpu_torch.store.replica import read_epoch

    config = config or Config.from_env()
    store_root = config.store.store_path()
    rejoin_root = Path(str(store_root) + ".rejoined")

    def standby_of(target: str) -> int:
        # Every rejoin path's parameters: with a promotion record in
        # rejoin_root this resumes as primary, else it monitors target
        # with the conservative rejoin window.
        run_standby(target, None, rejoin_root, config.api.port,
                    host=config.api.host,
                    check_interval=config.ha.rejoin_interval_s,
                    max_misses=config.ha.rejoin_misses, device=device)
        return 0

    def archive_stale_rejoin(reason: str) -> bool:
        # Move a stale .rejoined aside (never delete): its .promoted
        # record would otherwise resume stale history later.
        dst = rejoin_root.with_name(rejoin_root.name + ".stale")
        n = 0
        while dst.exists():
            n += 1
            dst = rejoin_root.with_name(f"{rejoin_root.name}.stale{n}")
        try:
            rejoin_root.rename(dst)
        except OSError as exc:
            logger.error("stale rejoin replica %s (%s) could not be "
                         "archived (%s) — refusing to serve; move it away "
                         "and restart", rejoin_root, reason, exc)
            return False
        logger.warning("archived stale rejoin replica to %s (%s)", dst,
                       reason)
        return True

    rejoin_rec = (promotion_record(rejoin_root) if config.ha.auto_rejoin
                  else None)
    fence = is_fenced(store_root)
    if rejoin_rec:
        rejoin_epoch = read_epoch(rejoin_root)
        try:
            fence_epoch = int((fence or {}).get("epoch"))
        except (TypeError, ValueError):
            fence_epoch = None  # unreadable fence: unknown, not old
        # The rejoin replica shadows the store only while it holds the
        # highest election epoch this node knows.
        if fence is None and read_epoch(store_root) >= rejoin_epoch:
            if not archive_stale_rejoin(
                    "original store restored as system of record at an "
                    "equal-or-higher epoch"):
                return SERVE_REFUSED
        elif fence is not None and (fence_epoch is None
                                    or fence_epoch >= rejoin_epoch):
            if not archive_stale_rejoin(
                    f"a later promotion fenced the original store at epoch "
                    f"{fence_epoch}, past the rejoin epoch {rejoin_epoch}"):
                return SERVE_REFUSED
        else:
            logger.warning("resuming as primary from the promoted rejoin "
                           "replica %s", rejoin_root)
            return standby_of(config.ha.peer
                              or rejoin_rec.get("old_primary")
                              or "127.0.0.1:0")

    if fence is None and config.ha.peer:
        fence = _peer_supersedes(store_root, config.ha.peer)
    if fence is not None:
        new_primary = fence.get("promoted_to") or config.ha.peer
        if config.ha.auto_rejoin and new_primary:
            logger.warning("store is fenced — auto-rejoining as a standby "
                           "of %s (replica: %s)", new_primary, rejoin_root)
            return standby_of(new_primary)
        print("store is fenced — a standby promoted itself to "
              f"{fence.get('promoted_to') or 'a new primary'}; refusing to "
              "serve.  Re-join by running this node as a standby of the "
              "new primary, or set LO_HA_AUTO_REJOIN=1.", flush=True)
        return SERVE_REFUSED
    server = APIServer(config, device=device)
    cfg = server.config
    logger.info("serving on %s:%d (device %s)", cfg.api.host, cfg.api.port,
                server.ctx.device)
    try:
        server.serve_forever()
    finally:
        server.shutdown()
    return 0
