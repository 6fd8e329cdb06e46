"""Declarative SLO objectives + multi-window burn-rate alerting — port of
``learningorchestra_tpu/obs/slo.py``.

Objectives (built from config, evaluated on every rollup tick):

- ``route-availability`` — the non-5xx fraction of HTTP requests;
- ``predict-latency`` — per served model, the fraction of predicts under
  ``SLOConfig.predict_p99_ms`` (one alert instance per model);
- ``decode-ttft`` — per decode model, time to first token (off unless
  ``SLOConfig.decode_ttft_ms`` > 0);
- ``job-success`` — finished / (finished + failed + deadline) over the
  job counter (preempted-and-retried attempts are not failures).

Burn rate is the bad fraction over the error budget (``1 - target``).
An alert needs the burn above ``burn_threshold`` over BOTH the fast and
the slow window.  States::

    inactive → pending (breach) → firing (held ``for_s``)
            → resolved (breach-free ``resolve_s``) → inactive

Transitions go to every registered sink: a structured log line always,
a webhook POST when ``SLOConfig.webhook`` is set, and the API server's
bundle trigger on ``firing``.  ``GET /observability/alerts`` and ``GET
/observability/slo`` serve the state; the burn, alert and budget
gauges mirror it on ``/metrics.prom``.

Knobs: config.py ``SLOConfig`` (env ``LO_TPU_SLO_*``).
"""

from __future__ import annotations

import collections
import json
import threading
import time

from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.log import get_logger, kv

logger = get_logger("slo")

__all__ = [
    "SLOService",
    "burn_rate",
    "ensure_service",
    "get_service",
    "on_tick",
    "reset_service",
]


def burn_rate(bad: float, total: float, target: float) -> float | None:
    """Bad-fraction over the window divided by the error budget
    (``1 - target``).  ``None`` with no traffic — no data is not the
    same as a healthy 0 (an idle service must neither page nor mark
    its budget spent)."""
    if total <= 0:
        return None
    budget = 1.0 - target
    if budget <= 0:
        return None
    return (bad / total) / budget


class _Objective:
    """One declarative objective: knows how to read its good/bad
    counts for a window from the rollup engine."""

    def __init__(self, name: str, kind: str, target: float, **spec):
        self.name = name
        self.kind = kind
        self.target = target
        self.source = spec.pop("source", "config")
        self.spec = spec

    def instances(self, engine) -> list[str]:
        if self.kind == "latency":
            return engine.label_values(
                self.spec.get(
                    "metric", "lo_serving_predict_duration_seconds"
                ),
                "model",
            )
        return ["all"]

    def counts(self, engine, instance: str, window_s: float,
               now: float):
        """``(bad, total)`` over the window, or ``None`` (no data)."""
        if self.kind == "availability":
            # Optional per-route filter (ad-hoc runtime objectives):
            # a drill can hold ONE route to its own availability
            # target instead of the fleet-wide aggregate.
            route = self.spec.get("route")
            total = engine.counter_delta(
                "lo_http_requests_total",
                {"route": route} if route else None,
                window_s, now=now,
            )
            if total is None or total <= 0:
                return None
            bad_labels = {"status": "5xx"}
            if route:
                bad_labels["route"] = route
            bad = engine.counter_delta(
                "lo_http_requests_total", bad_labels,
                window_s, now=now,
            ) or 0.0
            return bad, total
        if self.kind == "latency":
            frac = engine.fraction_below(
                self.spec.get(
                    "metric", "lo_serving_predict_duration_seconds"
                ),
                {"model": instance},
                self.spec["threshold_s"], window_s, now=now,
            )
            if frac is None:
                return None
            good, total = frac
            return max(0.0, total - good), total
        # job_success
        good = engine.counter_delta(
            "lo_jobs_total", {"state": "finished"}, window_s, now=now
        )
        bad = 0.0
        for state in ("failed", "deadline"):
            bad += engine.counter_delta(
                "lo_jobs_total", {"state": state}, window_s, now=now
            ) or 0.0
        if good is None and bad <= 0:
            return None
        total = (good or 0.0) + bad
        return (bad, total) if total > 0 else None

    def to_doc(self) -> dict:
        doc = {"name": self.name, "kind": self.kind,
               "target": self.target,
               "errorBudget": round(1.0 - self.target, 6),
               "source": self.source}
        if "threshold_s" in self.spec:
            doc["thresholdMs"] = self.spec["threshold_s"] * 1e3
        if "metric" in self.spec:
            doc["metric"] = self.spec["metric"]
        if "route" in self.spec:
            doc["route"] = self.spec["route"]
        return doc


class SLOService:
    """Objective evaluation + alert state machine + delivery."""

    #: Resolved/fired transitions retained for the REST history view.
    HISTORY = 64

    def __init__(self, cfg):
        self.cfg = cfg
        self._lock = make_lock("SLOService._lock")
        self.objectives: list[_Objective] = []
        if cfg.availability_target > 0:
            self.objectives.append(_Objective(
                "route-availability", "availability",
                cfg.availability_target,
            ))
        if cfg.predict_p99_ms > 0:
            self.objectives.append(_Objective(
                "predict-latency", "latency", cfg.predict_target,
                threshold_s=cfg.predict_p99_ms / 1e3,
            ))
        if getattr(cfg, "decode_ttft_ms", 0) > 0:
            # Streaming decode: time-to-first-token per model — the
            # latency SLO for the SSE surface, over the decode
            # engine's own TTFT histogram instead of predict's.
            self.objectives.append(_Objective(
                "decode-ttft", "latency", cfg.decode_ttft_target,
                threshold_s=cfg.decode_ttft_ms / 1e3,
                metric="lo_serving_decode_ttft_seconds",
            ))
        if cfg.job_success_target > 0:
            self.objectives.append(_Objective(
                "job-success", "job_success", cfg.job_success_target,
            ))
        # (objective, instance) -> alert state dict.
        self._alerts: dict[tuple, dict] = {}
        self.history: collections.deque = collections.deque(
            maxlen=self.HISTORY
        )
        self.evaluations = 0
        self._sinks = [self._log_sink]
        if cfg.webhook:
            self._sinks.append(self._webhook_sink)

    # -- runtime objectives --------------------------------------------------

    #: Valid kinds for ad-hoc objectives (POST /observability/slo).
    KINDS = ("availability", "latency", "job_success")
    #: Runtime-registered objectives are bounded: every objective
    #: costs two window reads per instance per tick.
    MAX_OBJECTIVES = 32

    def add_objective(self, name: str, kind: str, target: float,
                      **spec) -> dict:
        """Register an ad-hoc objective at runtime (the drill
        surface): ``availability`` takes an optional ``route`` filter,
        ``latency`` takes ``threshold_s`` and an optional histogram
        ``metric``.  Raises ValueError on a bad spec, an existing
        name, or the objective cap."""
        name = str(name or "").strip()
        if not name:
            raise ValueError("objective needs a non-empty 'name'")
        if kind not in self.KINDS:
            raise ValueError(
                f"unknown objective kind {kind!r} "
                f"(one of {list(self.KINDS)})"
            )
        target = float(target)
        if not 0.0 < target < 1.0:
            # Same zero-budget convention the boot knobs enforce: a
            # target of 1.0 cannot burn.
            raise ValueError(
                f"target {target!r} must be a fraction in (0, 1)"
            )
        if kind == "latency":
            if float(spec.get("threshold_s") or 0) <= 0:
                raise ValueError(
                    "latency objectives need a positive thresholdMs"
                )
            spec["threshold_s"] = float(spec["threshold_s"])
        spec = {k: v for k, v in spec.items() if v is not None}
        obj = _Objective(name, kind, target, source="runtime", **spec)
        with self._lock:
            if any(o.name == name for o in self.objectives):
                raise ValueError(
                    f"objective {name!r} already exists"
                )
            if len(self.objectives) >= self.MAX_OBJECTIVES:
                raise ValueError(
                    f"objective cap reached ({self.MAX_OBJECTIVES})"
                )
            self.objectives.append(obj)
        return obj.to_doc()

    def remove_objective(self, name: str) -> bool:
        """Drop a runtime objective and its live alert rows (the
        transition history keeps the record).  Config-built
        objectives are deliberately not removable — they are the
        deployment's contract, not a drill's."""
        with self._lock:
            for obj in self.objectives:
                if obj.name == name and obj.source == "runtime":
                    self.objectives.remove(obj)
                    for key in list(self._alerts):
                        if key[0] == name:
                            del self._alerts[key]
                    return True
        return False

    def _objectives_snapshot(self) -> list:
        with self._lock:
            return list(self.objectives)

    # -- sinks ---------------------------------------------------------------

    def add_sink(self, fn) -> None:
        """Register an alert-transition consumer: ``fn(event_dict)``,
        called for firing and resolved transitions.  Exceptions are
        swallowed per sink — a broken pager must not break the rest."""
        with self._lock:
            self._sinks.append(fn)

    @staticmethod
    def _log_sink(event: dict) -> None:
        logger.warning(kv(
            event=f"slo_alert_{event['state']}", slo=event["slo"],
            instance=event["instance"],
            burnFast=event.get("burnFast"),
            burnSlow=event.get("burnSlow"),
        ))

    def _webhook_sink(self, event: dict) -> None:
        """Fire-and-forget POST so a slow receiver never stalls the
        rollup tick the evaluation rides."""
        url = self.cfg.webhook

        def _post():
            import urllib.request

            req = urllib.request.Request(
                url, data=json.dumps(event).encode(),
                headers={"Content-Type": "application/json"},
            )
            try:
                urllib.request.urlopen(req, timeout=5).close()
            except Exception as exc:  # noqa: BLE001 — best-effort
                logger.warning(kv(
                    event="slo_webhook_failed", url=url,
                    error=repr(exc),
                ))

        threading.Thread(
            target=_post, name="slo-webhook", daemon=True
        ).start()

    def _deliver(self, event: dict) -> None:
        with self._lock:
            sinks = list(self._sinks)
            self.history.append(event)
        for sink in sinks:
            try:
                sink(event)
            except Exception:  # noqa: BLE001
                logger.exception("alert sink failed")

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, engine, now: float | None = None) -> list[dict]:
        """One pass over every (objective, instance) against the
        rollup windows; returns the delivered transition events.
        Called from the rollup tick; public for tests."""
        if not self.cfg.enabled:
            return []
        now = time.monotonic() if now is None else float(now)
        events: list[dict] = []
        evaluated: set[tuple] = set()
        with self._lock:
            self.evaluations += 1
        for obj in self._objectives_snapshot():
            for instance in obj.instances(engine):
                evaluated.add((obj.name, instance))
                fast = obj.counts(
                    engine, instance, self.cfg.fast_window_s, now
                )
                slow = obj.counts(
                    engine, instance, self.cfg.slow_window_s, now
                )
                burn_fast = burn_rate(*fast, obj.target) \
                    if fast else None
                burn_slow = burn_rate(*slow, obj.target) \
                    if slow else None
                breach = (
                    burn_fast is not None and burn_slow is not None
                    and burn_fast >= self.cfg.burn_threshold
                    and burn_slow >= self.cfg.burn_threshold
                )
                event = self._transition(
                    obj, instance, breach, burn_fast, burn_slow, now
                )
                if event is not None:
                    events.append(event)
        # Garbage collection, so the live view and the Prometheus
        # mirror cannot grow stale rows forever: a ``resolved`` alert
        # decays to ``inactive`` after one more resolve window (the
        # transition history keeps the record), and an inactive entry
        # whose instance no longer exists (a per-model objective's
        # model dropped off the rollup series) is removed entirely.
        with self._lock:
            for key in list(self._alerts):
                st = self._alerts[key]
                if (
                    st["state"] == "resolved"
                    and now - st.get("resolvedAt", now)
                    >= self.cfg.resolve_s
                ):
                    st["state"] = "inactive"
                if st["state"] == "inactive" and key not in evaluated:
                    del self._alerts[key]
        for event in events:
            self._deliver(event)
        return events

    def _transition(self, obj, instance, breach, burn_fast,
                    burn_slow, now) -> dict | None:
        """Advance one alert's state machine; returns the event to
        deliver (firing/resolved) or None."""
        key = (obj.name, instance)
        with self._lock:
            st = self._alerts.get(key)
            if st is None:
                st = self._alerts[key] = {
                    "slo": obj.name, "instance": instance,
                    "state": "inactive",
                    "pendingSince": None, "firingSince": None,
                    "okSince": None,
                }
            st["burnFast"] = burn_fast
            st["burnSlow"] = burn_slow
            st["target"] = obj.target
            st["evaluatedAt"] = time.time()
            state = st["state"]
            if breach:
                st["okSince"] = None
                if state in ("inactive", "resolved"):
                    st["state"] = "pending"
                    st["pendingSince"] = now
                    st["pendingSinceWall"] = time.time()
                    state = "pending"
                if (
                    state == "pending"
                    and now - st["pendingSince"] >= self.cfg.for_s
                ):
                    st["state"] = "firing"
                    st["firingSince"] = now
                    st["firingSinceWall"] = time.time()
                    return self._event(st, "firing")
                return None
            # No breach: pending collapses immediately (it never
            # paged); firing needs resolve_s of clean air first.
            if state == "pending":
                st["state"] = "inactive"
                st["pendingSince"] = None
            elif state == "firing":
                if st["okSince"] is None:
                    st["okSince"] = now
                if now - st["okSince"] >= self.cfg.resolve_s:
                    st["state"] = "resolved"
                    st["resolvedAt"] = now
                    st["resolvedAtWall"] = time.time()
                    event = self._event(st, "resolved")
                    event["firedForS"] = round(
                        now - st["firingSince"], 3
                    )
                    st["firingSince"] = None
                    st["pendingSince"] = None
                    st["okSince"] = None
                    return event
            return None

    @staticmethod
    def _event(st: dict, state: str) -> dict:
        return {
            "state": state,
            "slo": st["slo"],
            "instance": st["instance"],
            "burnFast": st["burnFast"],
            "burnSlow": st["burnSlow"],
            "target": st["target"],
            "t": time.time(),
        }

    # -- views ---------------------------------------------------------------

    def alerts(self) -> dict:
        """The ``GET /observability/alerts`` body: live alert states
        (pending/firing first), the bounded transition history, and
        the evaluation config that produced them."""
        with self._lock:
            live = [dict(st) for st in self._alerts.values()]
            # Copied under the SAME lock _deliver appends under — an
            # alert transitioning while the drill polls must not
            # mutate the deque mid-iteration.
            history = list(self.history)
        order = {"firing": 0, "pending": 1, "resolved": 2,
                 "inactive": 3}
        live.sort(key=lambda st: (order.get(st["state"], 3),
                                  st["slo"], st["instance"]))
        return {
            "alerts": live,
            "firing": [
                st for st in live if st["state"] == "firing"
            ],
            "history": history,
            "config": {
                "enabled": self.cfg.enabled,
                "fastWindowS": self.cfg.fast_window_s,
                "slowWindowS": self.cfg.slow_window_s,
                "burnThreshold": self.cfg.burn_threshold,
                "forS": self.cfg.for_s,
                "resolveS": self.cfg.resolve_s,
                "webhook": bool(self.cfg.webhook),
            },
        }

    def status(self) -> dict:
        """The ``GET /observability/slo`` body: every objective with
        its target, budget, live burn rates and budget remaining
        (slow window = the budget period)."""
        docs = []
        with self._lock:
            states = {
                k: dict(v) for k, v in self._alerts.items()
            }
        for obj in self._objectives_snapshot():
            doc = obj.to_doc()
            doc["instances"] = []
            for (slo_name, instance), st in sorted(states.items()):
                if slo_name != obj.name:
                    continue
                burn_slow = st.get("burnSlow")
                doc["instances"].append({
                    "instance": instance,
                    "state": st["state"],
                    "burnFast": st.get("burnFast"),
                    "burnSlow": burn_slow,
                    "budgetRemaining": (
                        round(1.0 - burn_slow, 6)
                        if burn_slow is not None else None
                    ),
                })
            docs.append(doc)
        return {
            "enabled": self.cfg.enabled,
            "objectives": docs,
            "evaluations": self.evaluations,
        }

    def prom_families(self) -> list:
        """The Prometheus mirror: lo_slo_burn_rate (both windows),
        lo_alert_active (1 = firing), lo_slo_error_budget_remaining
        (slow window as the budget period; negative = overdrawn)."""
        from learningorchestra_tpu_torch.obs.metrics import Family

        burn = Family(
            "gauge", "lo_slo_burn_rate",
            "Error-budget burn rate per SLO instance and window "
            "(1.0 spends the budget exactly over the window).",
        )
        active = Family(
            "gauge", "lo_alert_active",
            "1 while the SLO alert is firing, else 0.",
        )
        budget = Family(
            "gauge", "lo_slo_error_budget_remaining",
            "Error budget left over the slow window (1 = untouched, "
            "negative = overdrawn).",
        )
        with self._lock:
            states = [dict(st) for st in self._alerts.values()]
        for st in states:
            labels = {"slo": st["slo"], "instance": st["instance"]}
            if st.get("burnFast") is not None:
                burn.sample(st["burnFast"], window="fast", **labels)
            if st.get("burnSlow") is not None:
                burn.sample(st["burnSlow"], window="slow", **labels)
                budget.sample(1.0 - st["burnSlow"], **labels)
            active.sample(
                1 if st["state"] == "firing" else 0, **labels
            )
        return [burn, active, budget]


# -- process-wide singleton ---------------------------------------------------

_service: SLOService | None = None
_service_lock = make_lock("slo._service_lock")


def get_service() -> SLOService:
    """The process-wide service, built from config on first use."""
    global _service
    with _service_lock:
        if _service is None:
            from learningorchestra_tpu_torch.config import get_config

            _service = SLOService(get_config().slo)
        return _service


def ensure_service(cfg) -> SLOService:
    """Build the singleton from ``cfg`` if none exists yet (API-server
    construction), then return it."""
    global _service
    with _service_lock:
        if _service is None:
            _service = SLOService(cfg)
        return _service


def reset_service(cfg=None) -> SLOService:
    """Replace the singleton (tests)."""
    global _service
    with _service_lock:
        _service = None if cfg is None else SLOService(cfg)
    return get_service() if cfg is None else _service


def on_tick(engine, now: float | None = None) -> None:
    """Rollup-tick hook: evaluate the singleton IF one has been
    configured (API server boot, a test).  A bare rollup
    engine with no SLO service evaluates nothing — objective state
    must not mint itself as a side effect of unrelated ticks."""
    with _service_lock:
        service = _service
    if service is not None:
        service.evaluate(engine, now=now)
