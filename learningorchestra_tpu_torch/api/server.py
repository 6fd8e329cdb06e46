"""REST API — port of the serve routes of
``learningorchestra_tpu/api/server.py``.

A stdlib ``ThreadingHTTPServer`` under the same
``/api/learningOrchestra/v1`` prefix, carrying the resident-serving
routes:

- ``POST /serve/<model>/predict``  ``{"instances": [...]}`` → predictions
- ``POST /serve/<model>/load``     pin the artifact resident
- ``POST /serve/<model>/unload`` and ``DELETE /serve/<model>``
- ``GET  /serve``                  resident models + batcher stats

Status codes are the JAX server's: 200; 404 for an unknown model or
route; 406 for a malformed body or an unservable artifact; 429 with a
``Retry-After`` header under backpressure; 400 for a body that is not
JSON.  Models are read from the port's ``VolumeStorage`` (``binaries``
volume) and run on ``device``.
"""

from __future__ import annotations

import json
import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.serve.batcher import QueueFull
from learningorchestra_tpu_torch.serve.registry import ServeError
from learningorchestra_tpu_torch.serve.service import (
    NotFoundError,
    ServingService,
)
from learningorchestra_tpu_torch.store.volumes import VolumeStorage

PREFIX = "/api/learningOrchestra/v1"
_NAME = r"(?P<name>[A-Za-z0-9_.\-]+)"


class ValidationError(Exception):
    """Malformed request body → 406."""


class APIServer:
    def __init__(self, config: Config | None = None, *,
                 volumes: VolumeStorage | None = None, device="cuda"):
        self.config = config or Config.from_env()
        self.volumes = volumes or VolumeStorage(self.config.volume_root)
        self.serving = ServingService(
            self.volumes, self.config.serve, device=device
        )
        self._httpd: ThreadingHTTPServer | None = None
        self._routes: list[tuple[str, re.Pattern, object]] = []
        self._register_routes()

    # -- routes ---------------------------------------------------------------

    def _add(self, verb: str, pattern: str, handler) -> None:
        self._routes.append(
            (verb, re.compile("^" + PREFIX + pattern + "/?$"), handler)
        )

    def _register_routes(self) -> None:
        add = self._add

        def serve_predict(m, body):
            instances = body.get("instances")
            if instances is None:
                instances = body.get("x")
            if instances is None:
                raise ValidationError("missing 'instances'")
            return 200, self.serving.predict(m.group("name"), instances)

        def serve_unload(m, body):
            if not self.serving.unload(m.group("name")):
                return 404, {
                    "error": f"model {m.group('name')!r} is not loaded"
                }
            return 200, {"result": "unloaded"}

        add("POST", rf"/serve/{_NAME}/predict", serve_predict)
        add("POST", rf"/serve/{_NAME}/load", lambda m, b: (
            200, {"result": self.serving.load(m.group("name"))},
        ))
        add("POST", rf"/serve/{_NAME}/unload", serve_unload)
        add("DELETE", rf"/serve/{_NAME}", serve_unload)
        add("GET", r"/serve", lambda m, b: (200, {
            "models": self.serving.list_loaded(),
            "stats": self.serving.stats(),
        }))

    def handle(self, verb: str, path: str, body) -> tuple[int, dict]:
        """Route one request; returns (status, JSON payload)."""
        matched_path = False
        for route_verb, pattern, handler in self._routes:
            m = pattern.match(path)
            if not m:
                continue
            matched_path = True
            if route_verb == verb:
                return self._run_handler(handler, m, body)
        if matched_path:
            return 405, {"error": f"method {verb} not allowed on {path}"}
        return 404, {"error": f"no such route: {path}"}

    def _run_handler(self, handler, m, body):
        if not isinstance(body, dict):
            return 406, {"error": "request body must be a JSON object"}
        try:
            return handler(m, body)
        except NotFoundError as exc:
            return 404, {"error": str(exc)}
        except (ValidationError, ServeError) as exc:
            return 406, {"error": str(exc)}
        except QueueFull as exc:
            # Backpressure: shed load with an explicit retry budget (the
            # Retry-After header is attached from 'retryAfter').
            return 429, {
                "error": str(exc),
                "retryAfter": self.config.serve.retry_after_s,
            }
        except Exception as exc:  # noqa: BLE001 — a boundary that must
            # keep serving: report the failure, keep the server up.
            traceback.print_exc()
            return 500, {"error": repr(exc)}

    # -- HTTP plumbing --------------------------------------------------------

    def _handler_class(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _run(self, verb: str):
                body = {}
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw) if raw.strip() else {}
                    except json.JSONDecodeError:
                        self._send(400, {"error": "request body is not JSON"})
                        return
                status, payload = api.handle(
                    verb, urlparse(self.path).path, body
                )
                self._send(status, payload)

            def _send(self, status: int, payload):
                data = json.dumps(payload, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if status == 429 and payload.get("retryAfter") is not None:
                    self.send_header(
                        "Retry-After", str(payload["retryAfter"])
                    )
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._run("GET")

            def do_POST(self):
                self._run("POST")

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
        """Stop the accept loop, close the socket, release the models."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        self.serving.close()
