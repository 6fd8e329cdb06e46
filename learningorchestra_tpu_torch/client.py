"""Python client — port of ``learningorchestra_tpu/client.py``, the
framework's equivalent of the reference's ``learning-orchestra-client``
package: ``Context(cluster_ip)`` + one class per service.

Usage::

    from learningorchestra_tpu_torch.client import Context

    ctx = Context("10.0.0.5")           # or full "http://host:port"
    ctx.dataset_csv.insert("iris", "https://.../iris.csv")
    ctx.observe.wait("iris")            # server-side block until finished
    ctx.projection.create("iris_x", "iris", ["sepal_len", "petal_len"])
    ctx.model.create("mlp", module_path="learningorchestra_tpu.models.mlp",
                     class_name="MLPClassifier",
                     class_parameters={"num_classes": 3})
    ctx.train.create("fit1", model_name="mlp",
                     method_parameters={"x": "$iris_x", "y": "$iris.label",
                                        "epochs": 5})
    ctx.observe.wait("fit1", timeout=600)
    ctx.predict.create("pred1", parent_name="fit1",
                       method_parameters={"x": "$iris_x"})

Every request a method sends is the JAX client's, byte for byte (verb,
path, query, body, ``X-Idempotency-Key``, ``X-Tenant``), so one script
drives either package's server.  (``modulePath`` strings name the JAX
package's model modules; the port's server maps them to its own zoo.)
The port serves every route the client binds, ``/replication/*`` and
``/cluster/status`` included, so ``Context(..., failover=...)``,
``replication_status()`` and ``cluster.status()`` behave against a port
primary and its ``standby`` as against the JAX package's.

Only the standard library is used (urllib), so the module is trivially
vendorable as a standalone client package.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any


class ClientError(Exception):
    """HTTP-level failure; carries the server's status and error payload."""

    def __init__(self, status: int, payload: Any):
        self.status = status
        self.payload = payload
        super().__init__(f"HTTP {status}: {payload}")


class Context:
    """Connection to a learningorchestra_tpu cluster."""

    def __init__(self, cluster: str, port: int = 80,
                 prefix: str = "/api/learningOrchestra/v1",
                 failover: str | None = None,
                 request_timeout: float = 330.0,
                 tenant: str | None = None):
        self.base = self._make_base(cluster, port) + prefix
        # Tenant identity for per-tenant fair-share admission
        # (jobs/cluster.py TenantAdmission): sent as X-Tenant on every
        # request; the gateway may answer 429 + Retry-After when this
        # tenant's queued/running quota is exhausted.
        self.tenant = tenant
        # Standby address for automatic store failover (store/ha.py):
        # on a connection-level failure the client retries ONCE against
        # the standby and — mirroring mongo driver re-discovery — keeps
        # talking to it for the rest of the session.  On every repoint
        # the OLD base becomes the new failover target (mongo's
        # retained seed list, ADVICE r5): after a failover ping-pong
        # the session still has a re-discovery path when the node it
        # repointed to later steps down.
        #
        # Retry semantics are EXACTLY-ONCE for completed mutations
        # (mongo retryable writes): every POST/PATCH/DELETE carries an
        # X-Idempotency-Key, the server records the response in the
        # store (which WAL-ships to the standby), and the failover
        # retry replays the recorded response instead of executing
        # twice.  The one ambiguous window is a primary dying MID-
        # handler: the retry then gets an explicit 409 naming the key
        # ("no recorded outcome") — inspect the artifact's state
        # before retrying with a fresh key.
        self._failover_base = (
            self._make_base(failover, port) + prefix if failover else None
        )
        # Per-request socket timeout.  A hung-but-accepting primary
        # (SIGSTOP, black-holed path) must eventually raise so the
        # failover retry can fire; the default sits above the server's
        # 300 s observe long-poll cap (api/server.py observe_wait) so
        # legitimate long polls never trip it.
        self.request_timeout = request_timeout

        self.dataset_csv = _Dataset(self, "csv")
        self.dataset_generic = _Dataset(self, "generic")
        self.dataset_tensor = _TensorDataset(self)
        self.projection = _Projection(self)
        self.text = _TextTransform(self)
        self.data_type = _DataType(self)
        self.transform = _Transform(self, "tensorflow")
        self.transform_sklearn = _Transform(self, "scikitlearn")
        self.histogram = _Histogram(self)
        self.explore = _Explore(self, "tensorflow")
        self.explore_sklearn = _Explore(self, "scikitlearn")
        self.explore_curves = _Curves(self)
        self.model = _Model(self, "tensorflow")
        self.tune = _Executor(self, "tune", "tensorflow")
        self.train = _Executor(self, "train", "tensorflow")
        self.evaluate = _Executor(self, "evaluate", "tensorflow")
        self.predict = _Executor(self, "predict", "tensorflow")
        self.train_distributed = _DistributedTrain(self)
        self.function = _Function(self)
        self.builder = _Builder(self)
        self.monitoring = _Monitoring(self)
        self.observe = _Observe(self)
        self.serve = _Serve(self)
        self.observability = _Observability(self)
        self.faults = _Faults(self)
        self.jobs = _Jobs(self)
        self.cluster = _Cluster(self)

    # -- transport ----------------------------------------------------------

    @staticmethod
    def _make_base(cluster: str, port: int) -> str:
        if cluster.startswith(("http://", "https://")):
            return cluster.rstrip("/")
        if "/" in cluster:
            # Path-bearing cluster string ("gateway:8080/tenant-a"):
            # pass through — any port is embedded, and bracketing
            # would corrupt it.
            return f"http://{cluster}"
        # host:port only when the suffix is numeric AND the host part
        # is unambiguous: a plain name/IPv4 (no colon) or a bracketed
        # IPv6 literal.  Anything else with colons is a bare IPv6
        # address ("::1", "2001:db8:0:0:0:0:0:1") — its last group may
        # be decimal, so it must never be split on the final colon;
        # bracket it and append the default port.  (Kept in sync by
        # hand with store/replica.py make_transport — the client stays
        # import-free so it can be vendored standalone.)
        host, _, maybe_port = cluster.rpartition(":")
        unambiguous = ":" not in host or (
            host.startswith("[") and host.endswith("]")
        )
        if host and maybe_port.isdigit() and unambiguous:
            return f"http://{host}:{maybe_port}"
        if ":" in cluster and not cluster.startswith("["):
            return f"http://[{cluster}]:{port}"
        return f"http://{cluster}:{port}"

    def request(self, verb: str, path: str, body: dict | None = None,
                query: dict | None = None, raw: bool = False):
        """One logical request with ONE bounded backpressure retry: a
        429 (tenant quota, serving queue overflow) carries Retry-After
        — honor it once (capped at 2 s so a misconfigured server can't
        stall the client), then surface the second 429 to the caller.
        A single retry is deliberate: quotas clear when the tenant's
        own jobs finish, so retrying in a loop would just spin against
        our own backlog."""
        try:
            return self._request_routed(verb, path, body, query, raw)
        except ClientError as exc:
            if exc.status != 429:
                raise
            delay = 0.5
            if isinstance(exc.payload, dict):
                try:
                    delay = float(exc.payload.get("retryAfter") or delay)
                except (TypeError, ValueError):
                    pass
            time.sleep(min(max(delay, 0.0), 2.0))
            return self._request_routed(verb, path, body, query, raw)

    def _request_routed(self, verb: str, path: str,
                        body: dict | None = None,
                        query: dict | None = None, raw: bool = False):
        qs = ""
        if query:
            qs = "?" + urllib.parse.urlencode(
                {k: v if isinstance(v, str) else json.dumps(v)
                 for k, v in query.items()}
            )
        # One key per LOGICAL mutation, minted before the first
        # attempt: the failover retry below reuses it, which is what
        # lets the server replay instead of re-execute (mongo's
        # txnNumber in retryable writes).  Only minted when a failover
        # target exists — without one there is no retry path, and the
        # key would cost the server two durable ledger writes per
        # mutation for nothing.
        idem_key = (
            uuid.uuid4().hex
            if verb in ("POST", "PATCH", "DELETE")
            and self._failover_base is not None
            else None
        )
        try:
            return self._one_request(
                self.base, verb, path, qs, body, raw, idem_key
            )
        except urllib.error.HTTPError as exc:
            if exc.code != 503 or self._failover_base is None:
                raise self._client_error(exc) from None
            # 503 from the base with a failover target armed: either a
            # load-shedding gateway, or — after a failover ping-pong —
            # a node that stepped down to MONITORING STANDBY and now
            # answers everything 503 (store/ha.py).  This is mongo's
            # NotWritablePrimary re-discovery moment: probe the other
            # side; only a real answer repoints (sticky), a 503 or
            # connection failure there surfaces the ORIGINAL error.
            original = self._client_error(exc)
            try:
                result = self._one_request(
                    self._failover_base, verb, path, qs, body, raw,
                    idem_key,
                )
            except urllib.error.HTTPError as fexc:
                if fexc.code == 503:
                    fexc.close()
                    raise original from None
                self.base, self._failover_base = self._failover_base, self.base
                raise self._client_error(fexc) from None
            except (urllib.error.URLError, ConnectionError, OSError):
                raise original from None
            if not self._is_standby_answer(result):
                self.base, self._failover_base = (
                    self._failover_base, self.base
                )
            return result
        except (urllib.error.URLError, ConnectionError, OSError) as conn_exc:
            # Connection-level failure (refused/reset/timeout) — NOT an
            # HTTP status.  If a standby was configured, the primary may
            # have died and the standby promoted itself: retry once
            # there, and on success stay repointed.
            if self._failover_base is None:
                raise
            try:
                result = self._one_request(
                    self._failover_base, verb, path, qs, body, raw,
                    idem_key,
                )
            except urllib.error.HTTPError as exc:
                if exc.code == 503:
                    # A MONITORING standby answers everything but its
                    # status route 503 ("not promoted", store/ha.py):
                    # the pair is alive but no election has happened —
                    # surface the PRIMARY's failure and keep the
                    # failover target armed for the next attempt.
                    # (A promoted-but-load-shedding standby also
                    # 503s; not repointing is safe either way — the
                    # next attempt retries through this same path.)
                    exc.close()
                    raise conn_exc from None
                # The standby answered any other HTTP error: it IS
                # alive and promoted — repoint, surface the error
                # as-is.
                self.base, self._failover_base = self._failover_base, self.base
                raise self._client_error(exc) from None
            if not self._is_standby_answer(result):
                self.base, self._failover_base = self._failover_base, self.base
            return result

    @staticmethod
    def _is_standby_answer(result) -> bool:
        """True when a failover-target response proves the node is a
        MONITORING standby, not a promoted primary.

        The one route an unpromoted standby answers 200 is
        ``/replication/status`` (role=standby, store/ha.py); every API
        response is an artifact list or a role-less dict.  Repointing
        the session to a node that serves nothing else would strand it
        until election — return the data, keep the bases as they are.
        """
        return (
            isinstance(result, dict)
            and result.get("role") == "standby"
        )

    def _one_request(self, base, verb, path, qs, body, raw,
                     idem_key=None, timeout=None):
        headers = {"Content-Type": "application/json"}
        if idem_key:
            headers["X-Idempotency-Key"] = idem_key
        if self.tenant:
            headers["X-Tenant"] = self.tenant
        req = urllib.request.Request(
            base + path + qs,
            method=verb,
            data=json.dumps(body).encode() if body is not None else None,
            headers=headers,
        )
        with urllib.request.urlopen(
            req, timeout=timeout or self.request_timeout
        ) as resp:
            data = resp.read()
            if raw:
                return data
            return json.loads(data) if data else {}

    @staticmethod
    def _client_error(exc: urllib.error.HTTPError) -> "ClientError":
        data = exc.read()
        try:
            payload = json.loads(data)
        except Exception:
            payload = data.decode(errors="replace")
        return ClientError(exc.code, payload)

    # -- conveniences over the universal GET/poll path ----------------------

    def replication_status(self, timeout: float = 5.0) -> dict:
        """Both sides of the HA pair in one call — mongo's
        ``rs.status()`` role.  Each entry is the node's
        ``/replication/status`` record (primaries AND monitoring
        standbys answer it, store/ha.py) or ``{"error": ...}``;
        neither query repoints the session.  ``timeout`` is per probe
        and deliberately SHORT — this is the call an operator makes
        while a node is sick, and the session's 330 s long-poll
        budget would turn diagnosis into an 11-minute hang.
        """
        out: dict = {}
        for key, base in (("base", self.base),
                          ("failover", self._failover_base)):
            if base is None:
                continue
            try:
                out[key] = self._one_request(
                    base, "GET", "/replication/status", "", None,
                    False, timeout=timeout,
                )
            except urllib.error.HTTPError as exc:
                exc.close()
                out[key] = {"error": f"HTTP {exc.code}"}
            except (urllib.error.URLError, ConnectionError,
                    OSError) as exc:
                out[key] = {"error": f"unreachable: {exc}"}
        return out

    def metrics(self) -> dict:
        """Gateway metrics: per-route request counts/latencies + the
        timeout/cache budget (the krakend :8090 exporter's role)."""
        return self.request("GET", "/metrics")

    def search(self, service_path: str, name: str, *, query: dict | None = None,
               limit: int = 20, skip: int = 0) -> list[dict]:
        q: dict = {"limit": limit, "skip": skip}
        if query:
            q["query"] = query
        return self.request("GET", f"/{service_path}/{name}", query=q)

    def metadata(self, service_path: str, name: str) -> dict:
        docs = self.search(service_path, name, limit=1)
        return docs[0] if docs else {}


class _Service:
    service_path = ""  # e.g. "dataset/csv"

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def search(self, name: str, **kw) -> list[dict]:
        return self.ctx.search(self.service_path, name, **kw)

    def metadata(self, name: str) -> dict:
        return self.ctx.metadata(self.service_path, name)

    def delete(self, name: str) -> dict:
        return self.ctx.request(
            "DELETE", f"/{self.service_path}/{name}"
        )

    def wait(self, name: str, timeout: float = 120.0) -> dict:
        return _wait(self.ctx, name, timeout)


def _wait(ctx: Context, name: str, timeout: float) -> dict:
    """Block until ``finished`` or ``jobState=failed`` (server-side long
    poll via /observe, looped client-side for arbitrary timeouts)."""
    deadline = time.time() + timeout
    while True:
        remaining = max(1.0, min(30.0, deadline - time.time()))
        meta = ctx.request(
            "GET", f"/observe/{name}", query={"timeout": remaining}
        )["metadata"]
        if meta.get("finished") or meta.get("jobState") == "failed":
            return meta
        if time.time() >= deadline:
            raise TimeoutError(f"artifact {name!r} not finished "
                               f"after {timeout}s: {meta}")


class _Dataset(_Service):
    def __init__(self, ctx: Context, kind: str):
        super().__init__(ctx)
        self.service_path = f"dataset/{kind}"

    def insert(self, dataset_name: str, url: str,
               shard_rows: int | None = None) -> dict:
        """``shard_rows`` switches to sharded (beyond-host-RAM) ingest:
        rows land in columnar volume shards the training paths stream
        (store/sharded.py)."""
        body = {"datasetName": dataset_name, "url": url}
        if shard_rows is not None:
            body["shardRows"] = int(shard_rows)
        return self.ctx.request("POST", f"/{self.service_path}", body)

    def list(self) -> list[dict]:
        return self.ctx.request("GET", f"/{self.service_path}")


class _TensorDataset(_Service):
    """N-D (image-shaped) sharded ingest: features + labels as .npy
    files, memory-mapped and copied shard by shard — the beyond-RAM
    path for BASELINE config 5-style image datasets."""

    service_path = "dataset/tensor"

    def insert(self, dataset_name: str, url: str, labels_url: str,
               shard_rows: int = 4096) -> dict:
        return self.ctx.request("POST", f"/{self.service_path}", {
            "datasetName": dataset_name, "url": url,
            "labelsUrl": labels_url, "shardRows": int(shard_rows),
        })

    def list(self) -> list[dict]:
        return self.ctx.request("GET", f"/{self.service_path}")


class _Projection(_Service):
    service_path = "transform/projection"

    def create(self, projection_name: str, dataset_name: str,
               fields: list[str]) -> dict:
        return self.ctx.request(
            "POST", "/transform/projection",
            {"projectionName": projection_name, "datasetName": dataset_name,
             "fields": fields},
        )

    def update(self, projection_name: str,
               fields: list[str] | None = None) -> dict:
        """PATCH re-run — replaces the projected rows (new ``fields``
        when given, else the original request's)."""
        return self.ctx.request(
            "PATCH", "/transform/projection",
            {"projectionName": projection_name, "fields": fields},
        )


class _TextTransform(_Service):
    """BPE tokenization of a text column into a tensor-sharded dataset
    of fixed-length int32 rows (beyond the reference's surface — its
    text configs assume user preprocessing in compile_code)."""

    service_path = "transform/text"

    def create(self, name: str, dataset_name: str, *, text_field: str,
               label_field: str | None = None, vocab_size: int = 8000,
               max_len: int = 128, lowercase: bool = True,
               tokenizer_from: str | None = None,
               shard_rows: int = 4096) -> dict:
        return self.ctx.request(
            "POST", "/transform/text",
            {"name": name, "datasetName": dataset_name,
             "textField": text_field, "labelField": label_field,
             "vocabSize": vocab_size, "maxLen": max_len,
             "lowercase": lowercase, "tokenizerFrom": tokenizer_from,
             "shardRows": shard_rows},
        )

    def update(self, name: str) -> dict:
        """PATCH re-run — re-tokenizes from the parent's current rows."""
        return self.ctx.request("PATCH", f"/transform/text/{name}", {})


class _Transform(_Service):
    """Generic transform executions (reference: POST/PATCH/DELETE
    /transform/{t} → databaseExecutor, SURVEY §2.2)."""

    def __init__(self, ctx: Context, tool: str):
        super().__init__(ctx)
        self.tool = tool
        self.service_path = f"transform/{tool}"

    def create(self, name: str, *, module_path: str, class_name: str,
               class_parameters: dict | None = None,
               method: str | None = None,
               method_parameters: dict | None = None,
               description: str = "") -> dict:
        return self.ctx.request(
            "POST", f"/transform/{self.tool}",
            {"name": name, "modulePath": module_path, "class": class_name,
             "classParameters": class_parameters or {}, "method": method,
             "methodParameters": method_parameters or {},
             "description": description},
        )

    def update(self, name: str, *,
               class_parameters: dict | None = None,
               method_parameters: dict | None = None,
               description: str = "") -> dict:
        return self.ctx.request(
            "PATCH", f"/transform/{self.tool}/{name}",
            {"classParameters": class_parameters,
             "methodParameters": method_parameters,
             "description": description},
        )


class _DataType(_Service):
    service_path = "transform/dataType"

    def update(self, dataset_name: str, types: dict) -> dict:
        return self.ctx.request(
            "PATCH", "/transform/dataType",
            {"datasetName": dataset_name, "types": types},
        )


class _Histogram(_Service):
    service_path = "explore/histogram"

    def create(self, histogram_name: str, dataset_name: str,
               fields: list[str]) -> dict:
        return self.ctx.request(
            "POST", "/explore/histogram",
            {"histogramName": histogram_name, "datasetName": dataset_name,
             "fields": fields},
        )


class _Curves(_Service):
    """Training-curves PNG from a train artifact's history rows."""

    service_path = "explore/curves"

    def create(self, name: str, train_name: str,
               fields: list[str] | None = None) -> dict:
        return self.ctx.request(
            "POST", "/explore/curves",
            {"name": name, "parentName": train_name, "fields": fields},
        )

    def update(self, name: str) -> dict:
        """PATCH re-run — re-reads the parent's current history."""
        return self.ctx.request("PATCH", f"/explore/curves/{name}", {})

    def image(self, name: str) -> bytes:
        return self.ctx.request("GET", f"/explore/curves/{name}", raw=True)


class _Explore(_Service):
    def __init__(self, ctx: Context, tool: str):
        super().__init__(ctx)
        self.tool = tool
        self.service_path = f"explore/{tool}"

    def create(self, name: str, *, module_path: str, class_name: str,
               class_parameters: dict | None = None,
               method: str = "fit_transform",
               method_parameters: dict | None = None,
               color_by: str | None = None, description: str = "") -> dict:
        return self.ctx.request(
            "POST", f"/explore/{self.tool}",
            {"name": name, "modulePath": module_path, "class": class_name,
             "classParameters": class_parameters or {}, "method": method,
             "methodParameters": method_parameters or {},
             "colorBy": color_by, "description": description},
        )

    def update(self, name: str, *,
               class_parameters: dict | None = None,
               method_parameters: dict | None = None,
               color_by: str | None = None,
               description: str = "") -> dict:
        """PATCH re-run — re-renders the plot."""
        return self.ctx.request(
            "PATCH", f"/explore/{self.tool}/{name}",
            {"classParameters": class_parameters,
             "methodParameters": method_parameters,
             "colorBy": color_by, "description": description},
        )

    def image(self, name: str) -> bytes:
        return self.ctx.request(
            "GET", f"/explore/{self.tool}/{name}", raw=True
        )

    def search(self, name: str, *, query: dict | None = None,
               limit: int = 20, skip: int = 0) -> list[dict]:
        # GET /explore/{tool}/{name} serves the PNG; rows live under the
        # /metadata suffix (reference: krakend.json explore block).
        q: dict = {"limit": limit, "skip": skip}
        if query:
            q["query"] = query
        return self.ctx.request(
            "GET", f"/explore/{self.tool}/{name}/metadata", query=q
        )

    def metadata(self, name: str) -> dict:
        docs = self.search(name, limit=1)
        return docs[0] if docs else {}

    def wait(self, name: str, timeout: float = 120.0) -> dict:
        return _wait(self.ctx, name, timeout)


class _Model(_Service):
    def __init__(self, ctx: Context, tool: str):
        super().__init__(ctx)
        self.tool = tool
        self.service_path = f"model/{tool}"

    def create(self, model_name: str, *, module_path: str, class_name: str,
               class_parameters: dict | None = None,
               description: str = "") -> dict:
        return self.ctx.request(
            "POST", f"/model/{self.tool}",
            {"modelName": model_name, "modulePath": module_path,
             "class": class_name,
             "classParameters": class_parameters or {},
             "description": description},
        )

    def update(self, model_name: str,
               class_parameters: dict | None = None,
               description: str = "") -> dict:
        return self.ctx.request(
            "PATCH", f"/model/{self.tool}/{model_name}",
            {"classParameters": class_parameters, "description": description},
        )


class _Executor(_Service):
    """tune / train / evaluate / predict over a parent artifact."""

    def __init__(self, ctx: Context, service: str, tool: str):
        super().__init__(ctx)
        self.service = service
        self.tool = tool
        self.service_path = f"{service}/{tool}"

    def create(self, name: str, *, parent_name: str | None = None,
               model_name: str | None = None, method: str | None = None,
               method_parameters: dict | None = None,
               param_grid: dict | None = None,
               scoring_parameters: dict | None = None,
               description: str = "",
               deadline_s: float | None = None) -> dict:
        body: dict = {
            "name": name,
            "parentName": parent_name or model_name,
            "modelName": model_name,
            "method": method or ("fit" if self.service in ("train", "tune")
                                 else self.service),
            "methodParameters": method_parameters or {},
            "description": description,
        }
        if param_grid:
            body["paramGrid"] = param_grid
            if scoring_parameters:
                body["scoringParameters"] = scoring_parameters
        if deadline_s is not None:
            # Per-job wall-clock bound: past it the engine watchdog
            # fails the job and reclaims its worker and chip leases
            # (0 disables for this job, None inherits the server's
            # LO_TPU_JOB_DEADLINE_S default).
            body["deadlineS"] = deadline_s
        return self.ctx.request("POST", f"/{self.service_path}", body)

    def update(self, name: str, *, method_parameters: dict | None = None,
               description: str = "",
               deadline_s: float | None = None) -> dict:
        body: dict = {"methodParameters": method_parameters,
                      "description": description}
        if deadline_s is not None:
            body["deadlineS"] = deadline_s
        return self.ctx.request(
            "PATCH", f"/{self.service_path}/{name}", body
        )


class _DistributedTrain(_Service):
    service_path = "train/horovod"

    def create(self, name: str, *, parent_name: str,
               training_parameters: dict,
               compile_spec: dict | None = None,
               mesh: dict | None = None,
               monitoring_path: str | None = None,
               description: str = "") -> dict:
        return self.ctx.request(
            "POST", "/train/horovod",
            {"name": name, "parentName": parent_name,
             "trainingParameters": training_parameters,
             "compile": compile_spec, "mesh": mesh,
             "monitoringPath": monitoring_path,
             "description": description},
        )

    def update(self, name: str, *,
               training_parameters: dict | None = None,
               compile_spec: dict | None = None,
               mesh: dict | None = None,
               description: str = "") -> dict:
        """PATCH re-run; a bare call resumes a failed job with its
        original parameters."""
        return self.ctx.request(
            "PATCH", f"/train/horovod/{name}",
            {"trainingParameters": training_parameters,
             "compile": compile_spec, "mesh": mesh,
             "description": description},
        )


class _Function(_Service):
    service_path = "function/python"

    def create(self, name: str, *, function: str,
               function_parameters: dict | None = None,
               description: str = "",
               deadline_s: float | None = None) -> dict:
        body: dict = {"name": name, "function": function,
                      "functionParameters": function_parameters or {},
                      "description": description}
        if deadline_s is not None:
            body["deadlineS"] = deadline_s
        return self.ctx.request("POST", "/function/python", body)

    def update(self, name: str, *, function: str | None = None,
               function_parameters: dict | None = None,
               description: str = "",
               deadline_s: float | None = None) -> dict:
        body: dict = {"function": function,
                      "functionParameters": function_parameters,
                      "description": description}
        if deadline_s is not None:
            body["deadlineS"] = deadline_s
        return self.ctx.request(
            "PATCH", f"/function/python/{name}", body
        )


class _Builder(_Service):
    service_path = "builder/sparkml"

    def create(self, *, train_dataset: str, test_dataset: str,
               classifiers: list[str], label_field: str = "label",
               feature_fields: list[str] | None = None,
               modeling_code: str | None = None,
               classifier_parameters: dict | None = None,
               description: str = "") -> dict:
        """Whole-pipeline builder (reference: POST /builder/sparkml)."""
        return self.ctx.request(
            "POST", "/builder/sparkml",
            {"trainDatasetName": train_dataset,
             "testDatasetName": test_dataset,
             "classifiersList": classifiers, "labelField": label_field,
             "featureFields": feature_fields,
             "modelingCode": modeling_code,
             "classifierParameters": classifier_parameters,
             "description": description},
        )

    def create_distributed(self, name: str, *, function: str,
                           function_parameters: dict | None = None,
                           n_workers: int | None = None,
                           description: str = "") -> dict:
        """One user function on every rank (reference: POST
        /builder/tensorflow|pytorch → builder/horovod)."""
        return self.ctx.request(
            "POST", "/builder/tensorflow",
            {"name": name, "function": function,
             "functionParameters": function_parameters or {},
             "nWorkers": n_workers, "description": description},
        )


class _Monitoring:
    """Session registry lookups — NOT an artifact service (its GET
    returns a session dict, not document rows)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def lookup(self, nickname: str) -> dict:
        return self.ctx.request(
            "GET", f"/monitoring/tensorflow/{nickname}"
        )

    def list(self) -> list[dict]:
        return self.ctx.request("GET", "/monitoring/tensorflow")

    def stop(self, nickname: str) -> dict:
        return self.ctx.request(
            "DELETE", f"/monitoring/tensorflow/{nickname}"
        )


class _Serve:
    """Resident model serving — the synchronous low-latency surface
    (POST /serve/<model>/predict + load/unload/list).  Rides the
    Context transport, so failover retry/repoint applies unchanged;
    a 429 (queue overflow) surfaces as ``ClientError(429, ...)`` whose
    payload carries ``retryAfter`` seconds."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def predict(self, model: str, instances) -> dict:
        """Synchronous predict: ``instances`` is one feature vector or
        a list of them; returns ``{"predictions": [...], ...}`` in the
        response — no job, no polling."""
        return self.ctx.request(
            "POST", f"/serve/{model}/predict", {"instances": instances}
        )

    def generate(self, model: str, prompts, *,
                 max_new_tokens: int = 32, stream: bool = False,
                 temperature: float | None = None,
                 top_k: int | None = None, top_p: float | None = None,
                 seed: int = 0, timeout: float | None = None):
        """Autoregressive decode against a resident LM.

        Non-stream (default): POST /serve/<model>/generate, returns
        the full ``{"tokens": [[...]], "newTokens": [[...]], ...}``
        response.  With ``stream=True`` (single prompt only) the call
        returns a GENERATOR of ``(event, doc)`` pairs parsed from the
        server's ``text/event-stream`` body — ``("open", ...)``, then
        one ``("token", {"t": id, "i": pos})`` per generated token,
        terminated by ``("done", summary)`` / ``("error", ...)`` /
        ``("aborted", ...)``.  Closing the generator drops the socket,
        which the server treats as a client abort (KV pages freed at
        the next decode step)."""
        body: dict = {
            "prompts": prompts,
            "maxNewTokens": int(max_new_tokens),
            "seed": int(seed),
        }
        if temperature is not None:
            body["temperature"] = temperature
        if top_k is not None:
            body["topK"] = top_k
        if top_p is not None:
            body["topP"] = top_p
        if not stream:
            return self.ctx.request(
                "POST", f"/serve/{model}/generate", body
            )
        body["stream"] = True
        return self._sse_events(
            f"/serve/{model}/generate", body, timeout
        )

    def _sse_events(self, path: str, body: dict,
                    timeout: float | None):
        """Minimal SSE line parser over the streaming decode body:
        accumulates ``event:``/``data:`` fields, yields on each blank
        line.  urllib only — same zero-dependency discipline as the
        rest of the client."""
        req = urllib.request.Request(
            self.ctx.base + path, method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            resp = urllib.request.urlopen(
                req,
                timeout=timeout or max(
                    self.ctx.request_timeout, 300.0
                ),
            )
        except urllib.error.HTTPError as exc:
            raise Context._client_error(exc) from None
        try:
            event: str | None = None
            data_lines: list[str] = []
            for raw in resp:
                line = raw.decode(
                    "utf-8", errors="replace"
                ).rstrip("\r\n")
                if line:
                    if line.startswith("event:"):
                        event = line[len("event:"):].strip()
                    elif line.startswith("data:"):
                        data_lines.append(
                            line[len("data:"):].strip()
                        )
                    continue
                if event is None and not data_lines:
                    continue  # keep-alive blank
                joined = "\n".join(data_lines)
                try:
                    doc = json.loads(joined) if joined else {}
                except json.JSONDecodeError:
                    doc = {"raw": joined}
                yield (event or "message", doc)
                event, data_lines = None, []
        finally:
            resp.close()

    def abort_stream(self, model: str, stream_id: str) -> dict:
        """DELETE /serve/<model>/generate/<stream> — server-side abort
        of an in-flight decode stream (frees its KV slot at the next
        step boundary); 404 when the stream already finished."""
        return self.ctx.request(
            "DELETE", f"/serve/{model}/generate/{stream_id}"
        )

    def load(self, model: str) -> dict:
        """Pin a trained artifact's params resident on device."""
        return self.ctx.request("POST", f"/serve/{model}/load", {})

    def unload(self, model: str) -> dict:
        return self.ctx.request("POST", f"/serve/{model}/unload", {})

    def list_loaded(self) -> dict:
        return self.ctx.request("GET", "/serve")

    def stats(self) -> dict:
        """Serving observability: p50/p95/p99 latency, queue depth,
        batch occupancy, bucket histogram (also appended as
        ``serving_*`` tfevents scalars server-side)."""
        return self.ctx.request(
            "GET", "/monitoring/tensorflow/serving"
        )

    # -- fleet (multi-replica data plane + autoscaler) ------------------

    def replicas(self, model: str) -> dict:
        """GET /serve/<model>/replicas — the model's replica set:
        per-replica device LIST (multi-chip replicas lease a slice)
        and shard spec, queue depth, request counts, plus the min/max
        autoscaler bounds and chips-per-replica; 404 until a set
        exists."""
        return self.ctx.request("GET", f"/serve/{model}/replicas")

    def scale(self, model: str, *, count: int | None = None,
              min_replicas: int | None = None,
              max_replicas: int | None = None,
              devices_per_replica: int | None = None) -> dict:
        """POST /serve/<model>/replicas — create/resize the model's
        replica set: ``min``/``max`` set the autoscaler bounds,
        ``count`` scales manually (clamped to the bounds),
        ``devices_per_replica`` sets the chips each replica leases
        (> 1 shards the params across the slice for models bigger
        than one chip; fixed while the set is live).  Each replica
        pins its chips through the lease pool; an exhausted pool
        surfaces as 503 + Retry-After."""
        body: dict = {}
        if count is not None:
            body["count"] = count
        if min_replicas is not None:
            body["min"] = min_replicas
        if max_replicas is not None:
            body["max"] = max_replicas
        if devices_per_replica is not None:
            body["devicesPerReplica"] = devices_per_replica
        return self.ctx.request(
            "POST", f"/serve/{model}/replicas", body
        )

    def dissolve(self, model: str) -> dict:
        """DELETE /serve/<model>/replicas — drain the model's fleet
        and return it to classic single-path serving (chips released,
        model stays loaded; deployment-wide fleet defaults won't
        re-fleet it)."""
        return self.ctx.request(
            "DELETE", f"/serve/{model}/replicas"
        )

    def fleet_status(self) -> dict:
        """GET /serve/fleet — every replica set plus autoscaler state
        (tick counts, per-model streaks, recent scale decisions)."""
        return self.ctx.request("GET", "/serve/fleet")


class _Observability:
    """The unified observability layer (server obs/): Prometheus text
    exposition and per-job trace span trees.  The JSON endpoints the
    other bindings use remain; these are the scrape/trace surfaces."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def metrics_prom(self) -> str:
        """GET /metrics.prom — the whole registry (HTTP latency
        histograms, job queue waits, lease utilization, compile-cache
        counters, serving occupancy, store/replication state) in
        Prometheus text exposition format."""
        return self.ctx.request(
            "GET", "/metrics.prom", raw=True
        ).decode()

    def trace(self, name: str) -> dict:
        """GET /observability/jobs/<name>/trace — the job's span tree
        (queue wait → lease → compile → per-epoch steps) with the
        request id the submission carried; 404 until a completed run
        has recorded one."""
        return self.ctx.request(
            "GET", f"/observability/jobs/{name}/trace"
        )

    def costs(self) -> dict:
        """GET /observability/costs — the cost-accounting plane: per-
        program FLOPs/HBM records and the device-time ledgers (per
        job / per served model / per serving bucket, with MFU when
        the server configured its chips' peak FLOP/s)."""
        return self.ctx.request("GET", "/observability/costs")

    def locks(self) -> dict:
        """GET /observability/locks — the runtime lock witness's
        deadlock-diagnosis dump (LO_TPU_WITNESS=1): witnessed
        acquisition-order edges, held-while-blocking events, and
        every held/contended lock with holder, waiters and live
        thread stacks."""
        return self.ctx.request("GET", "/observability/locks")

    # -- windowed rollups + SLO alerting --------------------------------

    def timeseries(self, name: str | None = None,
                   window_s: float | None = None,
                   points: int | None = None,
                   **labels) -> dict:
        """GET /observability/timeseries — the rollup engine's
        windowed view of one registry family: raw ring points plus
        the derived rate (counters), min/avg/max + slope (gauges) or
        bucket-delta quantiles (histograms).  Label kwargs filter
        series (``timeseries("lo_serving_model_queue_depth",
        model="mnist")``); no ``name`` lists the tracked families."""
        query: dict = dict(labels)
        if name is not None:
            query["name"] = name
        if window_s is not None:
            query["windowS"] = window_s
        if points is not None:
            query["points"] = points
        return self.ctx.request(
            "GET", "/observability/timeseries", query=query
        )

    def alerts(self) -> dict:
        """GET /observability/alerts — live SLO alert states
        (pending/firing/resolved) with the burn rates that produced
        them, plus the bounded transition history and the evaluation
        config."""
        return self.ctx.request("GET", "/observability/alerts")

    def slo(self) -> dict:
        """GET /observability/slo — the declarative objectives with
        their targets, error budgets, live fast/slow burn rates and
        budget remaining per instance."""
        return self.ctx.request("GET", "/observability/slo")

    def slo_create(self, name: str, kind: str, target: float,
                   threshold_ms: float | None = None,
                   metric: str | None = None,
                   route: str | None = None) -> dict:
        """POST /observability/slo — register an ad-hoc runtime
        objective (the drill surface): ``availability`` with an
        optional ``route`` filter (e.g. ``"GET /health"``), or
        ``latency`` with ``threshold_ms`` against a histogram
        ``metric``.  Runtime objectives evaluate on the same rollup
        clock as config-built ones and are removable."""
        body: dict = {"name": name, "kind": kind, "target": target}
        if threshold_ms is not None:
            body["thresholdMs"] = threshold_ms
        if metric is not None:
            body["metric"] = metric
        if route is not None:
            body["route"] = route
        return self.ctx.request("POST", "/observability/slo", body)

    def slo_delete(self, name: str) -> dict:
        """DELETE /observability/slo/<name> — drop a runtime
        objective and its live alert rows (config-built objectives
        are the deployment's contract and answer 404)."""
        return self.ctx.request(
            "DELETE", f"/observability/slo/{name}"
        )

    # -- flight recorder + debug bundles --------------------------------

    def flight(self, domains: list | None = None,
               limit: int | None = None) -> dict:
        """GET /observability/flight — the always-on flight
        recorder's per-domain event rings (http, decode, jobs,
        compile, faults, locks) plus the merged incident
        ``timeline`` ordered by monotonic time."""
        query: dict = {}
        if domains:
            query["domain"] = ",".join(domains)
        if limit is not None:
            query["limit"] = limit
        return self.ctx.request(
            "GET", "/observability/flight", query=query
        )

    def bundle_create(self, reason: str | None = None) -> dict:
        """POST /observability/bundle — assemble a debug bundle NOW
        (synchronous; a concurrent assembly raises ClientError 409).
        Returns the manifest: flight rings, metrics/rollup/SLO/fleet
        snapshots, journal tail, fault + lock state."""
        body = {"reason": reason} if reason else {}
        return self.ctx.request(
            "POST", "/observability/bundle", body
        )

    def bundles(self) -> dict:
        """GET /observability/bundles — the on-disk bundle store:
        retained bundles plus assembler status (built/debounced
        counters, retention knobs)."""
        return self.ctx.request("GET", "/observability/bundles")

    def bundle_get(self, name: str) -> dict:
        """GET /observability/bundles/<name> — one bundle's
        manifest (file list, sizes, trigger reason/detail,
        per-provider errors)."""
        return self.ctx.request(
            "GET", f"/observability/bundles/{name}"
        )

    def bundle_fetch(self, name: str, path: str) -> bytes:
        """One bundle artifact's bytes (e.g. ``flight.json``)."""
        return self.ctx.request(
            "GET", f"/observability/bundles/{name}",
            query={"file": path}, raw=True,
        )

    def bundle_delete(self, name: str) -> dict:
        """DELETE /observability/bundles/<name>."""
        return self.ctx.request(
            "DELETE", f"/observability/bundles/{name}"
        )

    def bundles_clear(self) -> dict:
        """DELETE /observability/bundles — drop every retained
        bundle; returns the count removed."""
        return self.ctx.request("DELETE", "/observability/bundles")

    # -- on-demand profiler capture -------------------------------------

    def profile_start(self, name: str | None = None,
                      max_seconds: float | None = None) -> dict:
        """POST /observability/profile/start — begin a jax.profiler
        capture on the LIVE server (one at a time; a second start
        raises ClientError 409).  Auto-stops after ``max_seconds``
        (clamped to the server's LO_TPU_PROF_MAX_S)."""
        body: dict = {}
        if name is not None:
            body["name"] = name
        if max_seconds is not None:
            body["maxSeconds"] = max_seconds
        return self.ctx.request(
            "POST", "/observability/profile/start", body
        )

    def profile_stop(self) -> dict:
        """POST /observability/profile/stop — end the active capture;
        returns its file manifest."""
        return self.ctx.request(
            "POST", "/observability/profile/stop", {}
        )

    def profile_status(self) -> dict:
        return self.ctx.request("GET", "/observability/profile")

    def profile_captures(self) -> dict:
        """GET /observability/profile/captures — every retained
        capture with its file manifest."""
        return self.ctx.request(
            "GET", "/observability/profile/captures"
        )

    def profile_fetch(self, capture: str, path: str) -> bytes:
        """One capture artifact's bytes (e.g. the ``.xplane.pb`` for
        TensorBoard's profile plugin)."""
        return self.ctx.request(
            "GET", f"/observability/profile/captures/{capture}",
            query={"file": path}, raw=True,
        )


class _Faults:
    """Fault-injection plane (server faults/): arm deterministic,
    seeded chaos schedules against named fault points
    (``engine.dispatch``, ``train.epoch``, ``store.wal_write``, ...)
    and read per-point hit/trigger counters.  The drill surface behind
    the self-healing claims — see README "Fault tolerance"."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def status(self) -> dict:
        """GET /faults — every registered point with its armed
        schedule (if any) and cumulative hit/trigger counts."""
        return self.ctx.request("GET", "/faults")

    def arm(self, point: str, mode: str, *, rate: float = 1.0,
            seed: int = 0, after: int = 0, max_triggers: int = 0,
            delay_ms: float = 0.0) -> dict:
        """Arm ``point`` with a seeded schedule: ``mode`` is
        ``preempt`` (raise the engine's retryable preemption),
        ``error`` (ordinary crash) or ``delay`` (sleep ``delay_ms``);
        ``after`` skips the first N hits, ``max_triggers`` bounds
        total firings, ``rate < 1`` fires a seeded-deterministic
        subset."""
        return self.ctx.request(
            "POST", f"/faults/{point}",
            {"mode": mode, "rate": rate, "seed": seed, "after": after,
             "maxTriggers": max_triggers, "delayMs": delay_ms},
        )

    def disarm(self, point: str) -> dict:
        return self.ctx.request("DELETE", f"/faults/{point}")

    def disarm_all(self) -> dict:
        return self.ctx.request("DELETE", "/faults")


class _Jobs:
    """Job control plane: cooperative cancellation over the journaled
    engine (server jobs/engine.py + jobs/journal.py)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def cancel(self, name: str) -> dict:
        """DELETE /jobs/<name> — cancel a queued job outright
        (``result: cancelled``) or flip a RUNNING job's CancelToken
        (``result: cancelling``, HTTP 202): the body observes it at
        its next epoch/batch boundary, winds down like an early stop,
        and the artifact lands in jobState ``cancelled`` with a
        journaled terminal transition.  409 when the job is already
        terminal."""
        return self.ctx.request("DELETE", f"/jobs/{name}")


class _Cluster:
    """Scale-out control plane (server jobs/cluster.py): engine
    membership, dispatch claims and per-tenant admission counters."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def status(self) -> dict:
        """GET /cluster/status — ``{"enabled", "engines", "claims"[,
        "tenants"]}``.  Single-engine deployments answer 200 with
        ``enabled: false`` rather than 404, so callers never need a
        topology-aware special case."""
        return self.ctx.request("GET", "/cluster/status")


class _Observe:
    """The reference's separate Observe service (collection watch,
    README.md:71) — a server-side long poll (``wait``) plus push
    webhooks on state transitions (``webhook``/``webhooks``/
    ``unwatch``)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def wait(self, name: str, timeout: float = 120.0) -> dict:
        return _wait(self.ctx, name, timeout)

    def webhook(self, name: str, url: str,
                events: list | None = None) -> dict:
        """Register ``url`` to be POSTed ``{"name", "event",
        "metadata"}`` when ``name`` finishes or fails."""
        body = {"url": url}
        if events is not None:
            body["events"] = list(events)
        return self.ctx.request(
            "POST", f"/observe/{name}/webhook", body
        )["result"]

    def webhooks(self, name: str) -> list:
        return self.ctx.request(
            "GET", f"/observe/{name}/webhook"
        )["result"]

    def unwatch(self, name: str, hook_id: int) -> None:
        self.ctx.request(
            "DELETE", f"/observe/{name}/webhook/{hook_id}"
        )

    def webhook_all(self, url: str, events: list | None = None) -> dict:
        """Wildcard registration: ``url`` fires for EVERY artifact's
        finish/fail — the reference Observe's watch-anything shape."""
        body: dict = {"url": url}
        if events is not None:
            body["events"] = list(events)
        return self.ctx.request("POST", "/observe/webhook", body)["result"]

    def events(self, since_id: int = -1, limit: int = 100) -> list:
        """The global event feed, oldest-first; cursor on the last
        row's ``_id``: ``events(since_id=rows[-1]["_id"])``."""
        return self.ctx.request(
            "GET", "/observe/events",
            query={"sinceId": int(since_id), "limit": int(limit)},
        )["result"]
