"""Debug-bundle assembler: capture-at-incident for the flight recorder —
port of ``learningorchestra_tpu/obs/bundle.py``.

When something pages — an SLO objective entering ``firing``, a job
failing with its preemption retries exhausted, a deadline expiry, or an
operator's ``POST /observability/bundle`` — this module snapshots into
one versioned on-disk directory:

- ``flight.json``   — every flight ring plus the merged timeline;
- ``metrics.json``  — the metrics-registry snapshot;
- ``rollup.json``   — rollup status + ring tails per core family;
- ``slo.json``      — alert states, transition history, objectives;
- ``fleet.json``    — the fleet snapshot with the autoscaler's ledger;
- ``journal.json``  — the newest job-journal records;
- ``faults.json``   — armed schedules + trigger counters;
- ``locks.json`` and ``cluster.json`` — what the JAX package writes
  with its lock witness off and no cluster (the port has neither yet);
- ``manifest.json`` — name, reason, detail, file sizes, errors, and the
  name of a ``torch.profiler`` capture started with it when
  ``BundleConfig.profile`` is on (obs/profiling.py, whose every start
  goes through ``start_warm``).

Assembly goes into a hidden temp directory, then one atomic rename.
Retention is bounded; auto triggers are debounced and single-flight, so
an alert storm lands one bundle.  Content providers are injected by the
API server (obs/ imports neither serve/ nor jobs/); a failing provider
becomes an entry in ``manifest.errors``, never a lost bundle.

Knobs: config.py ``BundleConfig`` (env ``LO_TPU_BUNDLE_*``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.obs import flight as obs_flight

logger = get_logger("bundle")

__all__ = [
    "BundleBusy",
    "BundleError",
    "BundleNotFound",
    "BundleService",
    "ensure_service",
    "get_service",
    "reset_service",
    "trigger",
]

#: Bundle layout version, stamped into every manifest.
BUNDLE_VERSION = 1

_NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*")
_SLUG_RE = re.compile(r"[^A-Za-z0-9_.\-]+")


class BundleError(Exception):
    """Bundle plane failure (maps to HTTP 406)."""


class BundleBusy(BundleError):
    """A bundle is already being assembled (maps to HTTP 409)."""


class BundleNotFound(BundleError):
    """No bundle by that name (maps to HTTP 404)."""


class BundleService:
    """Trigger-driven snapshot assembly + the on-disk bundle store.

    ``providers`` maps content-file stems to zero-arg callables
    returning JSON-serializable documents; the server injects the
    subsystems' views at construction.  ``profiler`` is the server's
    ProfilerService for the knob-gated auto capture.
    """

    def __init__(self, cfg, providers: dict | None = None,
                 profiler=None):
        self.cfg = cfg
        self.dir = cfg.dir or os.path.join(".", "_bundles")
        self.providers = dict(providers or {})
        self.profiler = profiler
        self._lock = threading.Lock()
        self._building = False
        self._last_auto: float | None = None
        self._seq = 0
        self.built = 0
        self.debounced = 0

    # -- triggers ------------------------------------------------------------

    def trigger(self, reason: str, detail: dict | None = None) -> str | None:
        """Auto-trigger path (SLO sink, job engine, watchdogs):
        debounced and single-flight, assembled on a daemon thread so a
        rollup tick or an engine worker never blocks on file IO.
        Returns the bundle name it started, or None (disabled,
        debounced, or already building)."""
        if not self.cfg.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            if self._building:
                self.debounced += 1
                return None
            if (
                self._last_auto is not None
                and now - self._last_auto < self.cfg.debounce_s
            ):
                self.debounced += 1
                return None
            self._last_auto = now
            self._building = True
            name = self._next_name_locked(reason)
        threading.Thread(
            target=self._assemble_and_release,
            args=(name, reason, detail),
            name="bundle-assemble", daemon=True,
        ).start()
        return name

    def build(self, reason: str, detail: dict | None = None) -> dict:
        """Manual path (POST /observability/bundle): synchronous, no
        debounce — an operator asking for evidence gets it — but still
        single-flight (a concurrent build raises BundleBusy)."""
        with self._lock:
            if self._building:
                raise BundleBusy(
                    "a bundle is already being assembled"
                )
            self._building = True
            name = self._next_name_locked(reason)
        try:
            return self._assemble(name, reason, detail)
        finally:
            with self._lock:
                self._building = False

    def _assemble_and_release(self, name, reason, detail) -> None:
        try:
            self._assemble(name, reason, detail)
        except Exception:  # noqa: BLE001 — a failed capture must
            logger.exception("bundle assembly failed")  # never crash
        finally:  # the triggering thread's caller
            with self._lock:
                self._building = False

    def _next_name_locked(self, reason: str) -> str:
        self._seq += 1
        slug = _SLUG_RE.sub("-", reason).strip("-.") or "manual"
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        return f"{stamp}-{self._seq:03d}-{slug}"[:80]

    # -- assembly ------------------------------------------------------------

    def _assemble(self, name: str, reason: str,
                  detail: dict | None) -> dict:
        """Snapshot every source into ``<dir>/.tmp-<name>``, write the
        manifest, rename atomically, prune retention.  Returns the
        manifest."""
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f".tmp-{name}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        errors: dict = {}
        files: list = []

        def write(stem: str, doc) -> None:
            data = json.dumps(doc, default=str, indent=1).encode()
            path = os.path.join(tmp, f"{stem}.json")
            with open(path, "wb") as fh:
                fh.write(data)
            files.append({"name": f"{stem}.json", "bytes": len(data)})

        # The flight rings are the bundle's reason to exist — captured
        # first, before slower providers age them.
        try:
            write("flight", {
                "snapshot": obs_flight.snapshot(),
                "timeline": obs_flight.timeline(),
            })
        except Exception as exc:  # noqa: BLE001
            errors["flight"] = repr(exc)
        for stem, provider in self.providers.items():
            try:
                write(stem, provider())
            except Exception as exc:  # noqa: BLE001 — one broken
                errors[stem] = repr(exc)  # source, not a lost bundle
        capture = self._maybe_profile(name)
        manifest = {
            "name": name,
            "version": BUNDLE_VERSION,
            "reason": reason,
            "detail": detail or {},
            "createdAt": time.time(),
            "files": files,
            "errors": errors,
            "profileCapture": capture,
        }
        data = json.dumps(manifest, default=str, indent=1).encode()
        with open(os.path.join(tmp, "manifest.json"), "wb") as fh:
            fh.write(data)
        try:
            os.rename(tmp, final)
        except OSError as exc:
            shutil.rmtree(tmp, ignore_errors=True)
            raise BundleError(
                f"could not publish bundle {name!r}: {exc}"
            ) from None
        with self._lock:
            self.built += 1
        logger.info(kv(
            event="bundle_built", name=name, reason=reason,
            files=len(files), errors=len(errors),
        ))
        self._prune()
        return manifest

    def _maybe_profile(self, name: str) -> str | None:
        """Knob-gated short ``torch.profiler`` capture riding the bundle:
        the server's ProfilerService starts it (warmed, through
        obs/profiling.py ``start_warm``) with an auto-stop deadline and
        the capture name is recorded — the profiler's own store retains
        the artifacts.  A busy
        profiler (ProfilerConflict) or any failure degrades to None."""
        if not self.cfg.profile or self.profiler is None:
            return None
        try:
            doc = self.profiler.start(
                name=f"bundle-{name}"[:60],
                max_seconds=self.cfg.profile_s,
            )
            return doc.get("name")
        except Exception as exc:  # noqa: BLE001 — includes
            logger.warning(kv(  # ProfilerConflict: capture in flight
                event="bundle_profile_skipped", error=repr(exc),
            ))
            return None

    def _prune(self) -> None:
        keep = max(1, int(self.cfg.max_bundles))
        names = self._names()
        for victim in names[: max(0, len(names) - keep)]:
            try:
                shutil.rmtree(os.path.join(self.dir, victim))
            except OSError:
                pass

    # -- store views ---------------------------------------------------------

    def _names(self) -> list:
        """Completed bundle names, oldest first (names sort by their
        UTC stamp + sequence prefix)."""
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(
            e for e in entries
            if not e.startswith(".")
            and os.path.isfile(
                os.path.join(self.dir, e, "manifest.json")
            )
        )

    def manifest(self, name: str) -> dict | None:
        if not _NAME_RE.fullmatch(name):
            return None
        try:
            with open(
                os.path.join(self.dir, name, "manifest.json"), "rb"
            ) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def list_bundles(self) -> list:
        out = []
        for name in self._names():
            doc = self.manifest(name)
            if doc is not None:
                out.append({
                    "name": doc.get("name", name),
                    "reason": doc.get("reason"),
                    "createdAt": doc.get("createdAt"),
                    "files": len(doc.get("files", [])),
                    "profileCapture": doc.get("profileCapture"),
                })
        return out

    def read_file(self, name: str, rel: str) -> bytes:
        """One bundle artifact's bytes; rejects names/paths that
        escape the bundle directory (same guard as the profiler's
        read_file)."""
        if not _NAME_RE.fullmatch(name):
            raise BundleNotFound(f"no bundle {name!r}")
        root = os.path.realpath(os.path.join(self.dir, name))
        path = os.path.realpath(os.path.join(root, rel))
        if path != root and not path.startswith(root + os.sep):
            raise BundleError(
                f"path {rel!r} escapes the bundle directory"
            )
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            raise BundleNotFound(
                f"no file {rel!r} in bundle {name!r}"
            ) from None

    def delete(self, name: str) -> bool:
        if not _NAME_RE.fullmatch(name):
            return False
        path = os.path.join(self.dir, name)
        if not os.path.isdir(path):
            return False
        shutil.rmtree(path, ignore_errors=True)
        return True

    def delete_all(self) -> int:
        n = 0
        for name in self._names():
            if self.delete(name):
                n += 1
        return n

    def status(self) -> dict:
        with self._lock:
            building = self._building
            built = self.built
            debounced = self.debounced
        return {
            "enabled": self.cfg.enabled,
            "dir": self.dir,
            "building": building,
            "built": built,
            "debounced": debounced,
            "maxBundles": self.cfg.max_bundles,
            "debounceS": self.cfg.debounce_s,
            "bundles": self.list_bundles(),
        }


# -- process-wide singleton ---------------------------------------------------

_service: BundleService | None = None
_service_lock = threading.Lock()


def get_service() -> BundleService | None:
    """The configured singleton, or None — unlike the sibling obs
    planes, a bundle service never self-constructs: its content
    providers only exist once an API server wires them."""
    with _service_lock:
        return _service


def ensure_service(cfg, providers: dict | None = None,
                   profiler=None) -> BundleService:
    """Build the singleton if none exists yet (API-server
    construction), then return it."""
    global _service
    with _service_lock:
        if _service is None:
            _service = BundleService(
                cfg, providers=providers, profiler=profiler
            )
        return _service


def reset_service(cfg=None, providers: dict | None = None,
                  profiler=None) -> BundleService | None:
    """Replace the singleton (tests)."""
    global _service
    with _service_lock:
        _service = None if cfg is None else BundleService(
            cfg, providers=providers, profiler=profiler
        )
        return _service


def trigger(reason: str, **detail) -> str | None:
    """Module-level auto-trigger for subsystems that must not hold a
    server reference (jobs/engine.py, concurrency_rt.py): forwards to
    the singleton when one is configured, else a no-op."""
    with _service_lock:
        service = _service
    if service is None:
        return None
    try:
        return service.trigger(reason, detail or None)
    except Exception:  # noqa: BLE001 — a broken assembler must never
        logger.exception("bundle trigger failed")  # break its caller
        return None
