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
- ``GET /health``.

Status codes are the JAX server's: 201/200; 409 duplicate name or a job
still running; 404 unknown artifact, model or route; 406 semantic errors
(bad body, unknown class, ``checkpoint_dir``); 429 + ``Retry-After``
under serving backpressure; 503 + ``Retry-After`` when no card lease
frees up within ``FleetConfig.lease_timeout_s``; 400 for a body that is
not JSON or a bad query parameter.  The client's ``X-Idempotency-Key``
header is accepted and ignored (the idempotency ledger is not ported).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.jobs.leases import LeaseTimeout
from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.obs import costs
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
from learningorchestra_tpu_torch.toolkit.registry import RegistryError

PREFIX = Config().api.api_prefix
TOOL = r"(?P<tool>[A-Za-z0-9_\-]+)"
NAME = r"(?P<name>[A-Za-z0-9_.\-]+)"

logger = get_logger("api")


class BadRequest(Exception):
    """Malformed client input -> 400."""


class Router:
    """Regex route table: (verb, pattern) -> handler(match, body, query).
    First match wins, so specific routes are registered before generic
    ones where their patterns overlap."""

    def __init__(self, prefix: str):
        self.prefix = prefix.rstrip("/")
        self.routes: list[tuple[str, re.Pattern, Callable]] = []

    def add(self, verb: str, pattern: str, handler: Callable) -> None:
        self.routes.append((verb.upper(), re.compile(
            "^" + self.prefix + pattern + "/?$"), handler))

    def resolve(self, verb: str, path: str):
        """-> (handler, match), or (None, "404"|"405")."""
        matched_path = False
        for route_verb, pattern, handler in self.routes:
            m = pattern.match(path)
            if m:
                matched_path = True
                if route_verb == verb:
                    return handler, m
        return None, "405" if matched_path else "404"


def _int_param(query: dict, key: str, default: int) -> int:
    try:
        return int(query.get(key, default))
    except (TypeError, ValueError):
        raise BadRequest(f"{key} must be an integer") from None


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
        self.router = Router(self.config.api.api_prefix)
        self._httpd: ThreadingHTTPServer | None = None
        self._register_routes()

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

    def _register_routes(self) -> None:
        add = self.router.add

        add("GET", r"/health", lambda m, b, q: (200, {"status": "ok"}))

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

        add("POST", r"/observability/profile/start", profile_start)
        add("POST", r"/observability/profile/stop",
            lambda m, b, q: (200, {"capture": self.profiler.stop()}))
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
        add("GET", rf"/observe/{NAME}", observe_wait)

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
        add("POST", rf"/serve/{NAME}/generate", serve_generate)
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

    def handle(self, verb: str, path: str, body, query: dict | None = None
               ) -> tuple[int, object]:
        """Route one request; returns (status, JSON payload)."""
        handler, m = self.router.resolve(verb, path)
        if handler is None:
            if m == "405":
                return 405, {"error": f"method {verb} not allowed on {path}"}
            return 404, {"error": f"no such route: {path}"}
        if not isinstance(body, dict):
            return 406, {"error": "request body must be a JSON object"}
        try:
            return handler(m, body, query or {})
        except (DuplicateArtifact, ConflictError, ProfilerConflict) as exc:
            return 409, {"error": str(exc)}
        except (NotFoundError, ServeNotFound, ProfilerNotFound) as exc:
            return 404, {"error": str(exc)}
        except (ValidationError, RegistryError, ServeError,
                ProfilerError) as exc:
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
                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                body = {}
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw) if raw.strip() else {}
                    except json.JSONDecodeError:
                        self._send(400, {"error": "request body is not JSON"})
                        return
                self._send(*api.handle(verb, parsed.path, body, query))

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

    def start_background(self, host: str = "127.0.0.1",
                         port: int | None = None) -> int:
        """Bind, serve on a daemon thread, return the bound port (None/0
        picks an ephemeral one)."""
        httpd = ThreadingHTTPServer((host, port or 0), self._handler_class())
        httpd.daemon_threads = True
        self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd.server_address[1]

    def shutdown(self) -> None:
        """Stop the accept loop, close the socket, release the models,
        stop the engine and close the store."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        self.profiler.close()
        self.serving.close()
        self.monitoring.close()
        self.ctx.close()
