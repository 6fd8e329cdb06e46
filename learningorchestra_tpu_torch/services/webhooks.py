"""Observe push notifications and the event feed — port of
``learningorchestra_tpu/services/webhooks.py``.

A webhook registered against an artifact (or ``*``, every artifact) gets
an HTTP POST ``{"name", "event", "metadata"}`` when the job engine's
terminal path (or the boot recovery's orphan path) records ``finished``
or ``failed``.  Registrations are documents of ``observe_webhooks``, so
they survive restarts; delivery runs on a daemon thread with bounded
retries over ``urllib.request`` and records its last outcome in the
registration (``deliveries``, ``lastStatus``, ``lastError``).

Every transition the engine reports, ``running`` and ``cancelled``
included, also lands in ``observe_events``: one ordered feed, paged by
``_id`` (``GET /observe/events?sinceId=``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.store.document_store import NoSuchCollection

COLLECTION = "observe_webhooks"
EVENTS_COLLECTION = "observe_events"
EVENTS = ("finished", "failed")
WILDCARD = "*"  # registers against every artifact
EVENT_RETAIN = 10_000  # feed rows kept (pruned every 256 inserts)


class WebhookNotifier:
    def __init__(self, documents, *, attempts: int = 3,
                 timeout_s: float = 10.0):
        self.documents = documents
        self.attempts = attempts
        self.timeout_s = timeout_s
        self.log = get_logger("observe")

    # -- registry -------------------------------------------------------------

    def register(self, artifact: str, url: str,
                 events: list[str] | None = None) -> dict:
        """``artifact="*"`` registers a wildcard hook, fired for every
        artifact."""
        if not url or not url.startswith(("http://", "https://")):
            raise ValueError(f"webhook url must be http(s), got {url!r}")
        events = list(events or EVENTS)
        bad = [e for e in events if e not in EVENTS]
        if bad:
            raise ValueError(
                f"unknown webhook events {bad}; valid: {list(EVENTS)}"
            )
        doc = {
            "artifact": artifact,
            "url": url,
            "events": events,
            "deliveries": 0,
            "lastStatus": None,
            "lastError": None,
        }
        _id = self.documents.insert_one(COLLECTION, doc)
        return {**doc, "_id": _id}

    def unregister(self, artifact: str, hook_id: int) -> bool:
        doc = self.documents.find_one(COLLECTION, hook_id)
        if doc is None or doc.get("artifact") != artifact:
            return False
        return self.documents.delete_one(COLLECTION, hook_id)

    def list(self, artifact: str) -> list[dict]:
        try:
            return self.documents.find(COLLECTION,
                                       query={"artifact": artifact})
        except NoSuchCollection:
            return []  # nothing ever registered on this store

    # -- firing ---------------------------------------------------------------

    def deliver_to(self, hook: dict, artifact: str, event: str,
                   metadata: dict) -> None:
        """POST to one registration only, without touching the feed or
        other hooks: the catch-up for a hook registered on an artifact
        that is already terminal."""
        self._start_delivery([hook], artifact, event, metadata)

    def notify(self, artifact: str, event: str, metadata: dict) -> None:
        """Record the event and fire the hooks registered for (artifact,
        event); returns at once, delivery runs on a daemon thread so a
        slow endpoint never stalls the engine."""
        self.record_event(artifact, event, metadata)
        try:
            hooks = [h for h in self.list(artifact) + self.list(WILDCARD)
                     if event in h.get("events", EVENTS)]
        except Exception:  # noqa: BLE001 — notify must never raise
            self.log.exception(kv(event="webhook_lookup_failed",
                                  artifact=artifact))
            return
        if hooks:
            self._start_delivery(hooks, artifact, event, metadata)

    def _start_delivery(self, hooks, artifact, event, metadata) -> None:
        payload = json.dumps({"name": artifact, "event": event,
                              "metadata": metadata}, default=str).encode()
        threading.Thread(target=self._deliver_all, args=(hooks, payload),
                         name="webhook-notify", daemon=True).start()

    def _deliver_all(self, hooks: list[dict], payload: bytes) -> None:
        for hook in hooks:
            status, error = self._deliver(hook["url"], payload)
            try:
                self.documents.update_one(COLLECTION, hook["_id"], {
                    "deliveries": hook.get("deliveries", 0) + 1,
                    "lastStatus": status,
                    "lastError": error,
                })
            except Exception:  # noqa: BLE001 — bookkeeping only (the
                # hook may have been deleted, or the store closed).
                self.log.warning(kv(webhook=hook["url"],
                                    event="delivery_record_failed"))

    def _deliver(self, url: str, payload: bytes):
        last_err = None
        for attempt in range(self.attempts):
            try:
                req = urllib.request.Request(
                    url, data=payload,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req,
                                            timeout=self.timeout_s) as resp:
                    return resp.status, None
            except Exception as exc:  # noqa: BLE001 — any failure is a
                # failed attempt, recorded in the registration.
                last_err = repr(exc)
                self.log.warning(kv(webhook=url, attempt=attempt + 1,
                                    error=last_err))
                if attempt + 1 < self.attempts:
                    time.sleep(min(2 ** attempt, 5))
        return None, last_err

    # -- event feed -----------------------------------------------------------

    def record_event(self, artifact: str, event: str,
                     metadata: dict) -> None:
        """Append to the feed (``observe_events``, cursorable by
        ``_id``).  Never raises: jobs must finish."""
        try:
            _id = self.documents.insert_one(EVENTS_COLLECTION, {
                "artifact": artifact,
                "event": event,
                "artifactType": metadata.get("type"),
                "ts": time.time(),
            })
            if _id % 256 == 0:
                for old in self.documents.find(
                    EVENTS_COLLECTION,
                    query={"_id": {"$lt": _id - EVENT_RETAIN}},
                ):
                    self.documents.delete_one(EVENTS_COLLECTION, old["_id"])
        except Exception:  # noqa: BLE001 — the feed is bookkeeping
            self.log.exception(kv(event="event_record_failed",
                                  artifact=artifact))

    def latest_events(self, n: int = 20) -> list[dict]:
        """The newest ``n`` events, oldest first."""
        try:
            total = self.documents.count(EVENTS_COLLECTION)
            if not total:
                return []
            return self.documents.find(EVENTS_COLLECTION,
                                       skip=max(0, total - n), limit=n)
        except NoSuchCollection:
            return []

    def events(self, since_id: int = -1, limit: int = 100) -> list[dict]:
        """Events with ``_id > since_id``, oldest first, at most
        ``limit`` (1..1000); the default -1 starts at the beginning."""
        try:
            return self.documents.find(
                EVENTS_COLLECTION,
                query={"_id": {"$gt": int(since_id)}},
                limit=max(1, min(int(limit), 1000)),
            )
        except NoSuchCollection:
            return []  # no event ever recorded
