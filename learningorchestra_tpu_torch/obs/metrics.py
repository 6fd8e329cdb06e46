"""Process-wide metrics registry + Prometheus text exposition — port of
``learningorchestra_tpu/obs/metrics.py``: the same primitives, the same
series bound and the same text, so one sequence of operations renders
byte-equal in both registries.

The registry is the one sink: labelled Counter/Gauge/Histogram
primitives for push-style instrumentation on hot paths (HTTP dispatch,
job queue waits, device leases, predict latency), plus pull-style
*collectors* that snapshot subsystems already keeping exact counters
under their own locks (program cache, durable program store, cost
ledgers, serving batchers, decode engine, fleet, store WALs, job
queues) at exposition time.

``GET /metrics.prom`` renders the whole registry as Prometheus text
exposition format 0.0.4.

Knobs (config.py ``ObsConfig``, env ``LO_TPU_OBS_*``):

- ``enabled`` off: every primitive becomes a no-op and tracing stops
  minting spans.
- ``max_series`` bounds label cardinality per metric: past the cap, new
  label combinations collapse into one ``_overflow`` series (counted by
  ``series_overflows``).
- ``latency_buckets_ms`` sets the HTTP latency histogram's edges.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Iterable, Sequence

from learningorchestra_tpu_torch.concurrency_rt import make_lock


__all__ = [
    "Counter",
    "Family",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
]

#: Reserved label value new series collapse into past the cardinality cap.
OVERFLOW_LABEL = "_overflow"

#: Default latency bucket edges in SECONDS (Prometheus convention).
DEFAULT_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Metric:
    """Base: one named metric family with a fixed label-name tuple and
    a bounded number of label-value series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help_text: str, labelnames: Sequence[str]):
        self.registry = registry
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._series: dict = {}

    def _key(self, labels: dict):
        """Label dict → series key, collapsing into the overflow
        series past the registry's cardinality cap.  Caller holds the
        registry lock.  Hand-rolled loop, no genexpr, type-checked
        str() skip: this runs on every observation of every hot-path
        metric (HTTP dispatch, predict latency)."""
        vals = []
        for n in self.labelnames:
            v = labels.get(n, "")
            vals.append(v if type(v) is str else str(v))
        key = tuple(vals)
        if key in self._series:
            return key
        if len(self._series) >= self.registry.max_series:
            self.registry.series_overflows += 1
            return (OVERFLOW_LABEL,) * len(self.labelnames)
        return key

    def _labels_of(self, key) -> dict:
        return dict(zip(self.labelnames, key))


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        reg = self.registry
        if not reg.enabled:
            return
        with reg.lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        reg = self.registry
        if not reg.enabled:
            return
        with reg.lock:
            self._series[self._key(labels)] = float(value)

    def set_max(self, value: float, **labels) -> None:
        """Retain the maximum observed value (the legacy /metrics
        view's per-route ``max_ms``)."""
        reg = self.registry
        if not reg.enabled:
            return
        with reg.lock:
            key = self._key(labels)
            prev = self._series.get(key)
            if prev is None or value > prev:
                self._series[key] = float(value)


class _BoundHistogram:
    """One pre-resolved histogram series: label → key resolution paid
    ONCE at bind time, so a hot path (one predict = one observe) pays
    lock + dict-get + bisect and nothing else."""

    __slots__ = ("metric", "key")

    def __init__(self, metric: "Histogram", key):
        self.metric = metric
        self.key = key

    def observe(self, value: float) -> None:
        metric = self.metric
        reg = metric.registry
        if not reg.enabled:
            return
        with reg.lock:
            metric._observe_key(self.key, value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): per series
    stores per-bucket counts plus sum/count; render emits cumulative
    ``_bucket`` lines, ``_sum`` and ``_count``."""

    kind = "histogram"

    def __init__(self, registry, name, help_text, labelnames,
                 buckets: Sequence[float] | None = None):
        super().__init__(registry, name, help_text, labelnames)
        edges = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS_S))
        if not edges:
            edges = DEFAULT_LATENCY_BUCKETS_S
        self.buckets = edges

    def observe(self, value: float, **labels) -> None:
        reg = self.registry
        if not reg.enabled:
            return
        with reg.lock:
            self._observe_key(self._key(labels), value)

    def _observe_key(self, key, value: float) -> None:
        """The ONE series-update body (observe() and every bound
        handle share it).  Caller holds the registry lock."""
        state = self._series.get(key)
        if state is None:
            state = self._series[key] = {
                "counts": [0] * len(self.buckets),
                "sum": 0.0,
                "count": 0,
            }
        # First edge >= value, binary-searched: this sits on the
        # predict hot path (one call per request).
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.buckets):
            state["counts"][i] += 1
        state["sum"] += value
        state["count"] += 1

    def bind(self, **labels) -> _BoundHistogram:
        """Resolve one series' key now and return a
        :class:`_BoundHistogram` that observes without per-call label
        resolution.  The cardinality cap applies at bind time (a
        bound overflow series stays collapsed)."""
        with self.registry.lock:
            return _BoundHistogram(self, self._key(labels))


class Family:
    """One metric family a pull collector emits at exposition time.

    Collectors snapshot subsystems that already keep their own exact
    counters (compile cache, serving, store) — ``Family`` is just the
    render-side container: ``fam.sample(value, **labels)``.
    """

    def __init__(self, kind: str, name: str, help_text: str = ""):
        self.kind = kind
        self.name = name
        self.help = help_text
        self.samples: list[tuple[dict, float]] = []

    def sample(self, value: float, **labels) -> "Family":
        self.samples.append((labels, float(value)))
        return self


class MetricsRegistry:
    """Lock-protected registry of push metrics + pull collectors."""

    def __init__(self, enabled: bool = True, trace_enabled: bool = True,
                 max_series: int = 1024, max_spans: int = 512,
                 trace_sample: float = 1.0):
        self.enabled = bool(enabled)
        self.trace_enabled = bool(enabled) and bool(trace_enabled)
        self.max_series = max(1, int(max_series))
        self.max_spans = max(1, int(max_spans))
        # Span-ledger sampling: the fraction of jobs whose span trees
        # persist, decided deterministically per request id
        # (obs/tracing.py new_trace).  Metrics are never sampled.
        self.trace_sample = min(1.0, max(0.0, float(trace_sample)))
        self.lock = make_lock("MetricsRegistry.lock")
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], Iterable[Family]]] = []
        #: SAMPLES routed to an overflow series (one per observation
        #: past the cap, not one per distinct combination — tracking
        #: dropped combinations would itself be unbounded state).
        self.series_overflows = 0

    # -- registration (idempotent by name) ------------------------------------

    def _get_or_make(self, cls, name, help_text, labels, **kw):
        with self.lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(
                    self, name, help_text, labels, **kw
                )
            return metric

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] | None = None) -> Histogram:
        return self._get_or_make(
            Histogram, name, help_text, labels, buckets=buckets
        )

    def add_collector(self, fn: Callable[[], Iterable[Family]]) -> None:
        """Register a pull collector: called at exposition time, must
        return Family objects and must be fast; exceptions degrade that
        collector's families only, never the exposition."""
        with self.lock:
            self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        with self.lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-shaped view of the push metrics (the legacy endpoints
        render from this): {name: {kind, series: [{labels, ...}]}}."""
        out: dict = {}
        with self.lock:
            for name, metric in self._metrics.items():
                series = []
                for key, state in metric._series.items():
                    entry: dict = {"labels": metric._labels_of(key)}
                    if metric.kind == "histogram":
                        entry.update(
                            count=state["count"],
                            sum=state["sum"],
                            buckets=dict(
                                zip(
                                    map(str, metric.buckets),
                                    state["counts"],
                                )
                            ),
                        )
                    else:
                        entry["value"] = state
                    series.append(entry)
                out[name] = {"kind": metric.kind, "series": series}
        return out

    def collect_all(self, names=None) -> list:
        """Unified sample view over push metrics AND pull collectors —
        the surface the rollup engine (obs/rollup.py) snapshots each
        tick.  Returns one dict per series::

            {"name", "kind", "labels": {...}, "value": float}        # scalar
            {"name", "kind": "histogram", "labels": {...},
             "edges": (...), "cum": (...), "sum": s, "count": n}     # cum
                                                                     # incl +Inf

        ``names`` (a set/sequence) filters to those families —
        collectors still all run (they emit whole family groups), but
        only matching samples return.  Histogram bucket counts come
        back CUMULATIVE (Prometheus ``le`` semantics) so windowed
        quantiles derive from plain point-to-point deltas."""
        if not self.enabled:
            return []
        wanted = set(names) if names is not None else None
        out: list = []
        with self.lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
            for metric in metrics:
                if wanted is not None and metric.name not in wanted:
                    continue
                for key, state in metric._series.items():
                    labels = metric._labels_of(key)
                    if metric.kind == "histogram":
                        cum, total = [], 0
                        for n in state["counts"]:
                            total += n
                            cum.append(total)
                        cum.append(state["count"])  # +Inf bucket
                        out.append({
                            "name": metric.name, "kind": "histogram",
                            "labels": labels,
                            "edges": metric.buckets,
                            "cum": tuple(cum),
                            "sum": state["sum"],
                            "count": state["count"],
                        })
                    else:
                        out.append({
                            "name": metric.name, "kind": metric.kind,
                            "labels": labels, "value": float(state),
                        })
        # Collectors run OUTSIDE the lock (same contract as
        # render_prometheus: exposition cost must never stall a
        # hot-path observe, and a collector may itself take locks).
        for collector in collectors:
            try:
                families = list(collector())
            except Exception:  # noqa: BLE001 — one bad collector must
                continue  # not take down the snapshot
            for fam in families:
                if wanted is not None and fam.name not in wanted:
                    continue
                for labels, value in fam.samples:
                    out.append({
                        "name": fam.name, "kind": fam.kind,
                        "labels": dict(labels), "value": float(value),
                    })
        return out

    # -- exposition -----------------------------------------------------------

    def _render_family(self, lines, kind, name, help_text, samples):
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lines.append(
                f"{name}{_labels_str(labels)} {_format_value(value)}"
            )

    def render_prometheus(self) -> str:
        """The full registry in Prometheus text exposition 0.0.4."""
        lines: list[str] = []
        if not self.enabled:
            lines.append(
                "# observability disabled (LO_TPU_OBS_ENABLED=0)"
            )
            return "\n".join(lines) + "\n"
        with self.lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
            overflows = self.series_overflows
            rendered: list[tuple] = []
            for metric in metrics:
                if metric.kind == "histogram":
                    for key, state in metric._series.items():
                        base = metric._labels_of(key)
                        cum = 0
                        bucket_samples = []
                        for edge, n in zip(
                            metric.buckets, state["counts"]
                        ):
                            cum += n
                            bucket_samples.append(
                                ({**base, "le": _format_value(edge)},
                                 cum)
                            )
                        bucket_samples.append(
                            ({**base, "le": "+Inf"}, state["count"])
                        )
                        rendered.append((
                            "histogram", metric.name, metric.help,
                            bucket_samples, base,
                            state["sum"], state["count"],
                        ))
                else:
                    samples = [
                        (metric._labels_of(key), value)
                        for key, value in metric._series.items()
                    ]
                    rendered.append((
                        metric.kind, metric.name, metric.help,
                        samples, None, None, None,
                    ))
        # Render OUTSIDE the lock: exposition cost must never stall a
        # hot-path observe().
        emitted_type: set[str] = set()
        for kind, name, help_text, samples, base, hsum, hcount in rendered:
            if kind == "histogram":
                if name not in emitted_type:
                    emitted_type.add(name)
                    if help_text:
                        lines.append(f"# HELP {name} {help_text}")
                    lines.append(f"# TYPE {name} histogram")
                for labels, value in samples:
                    lines.append(
                        f"{name}_bucket{_labels_str(labels)} "
                        f"{_format_value(value)}"
                    )
                lines.append(
                    f"{name}_sum{_labels_str(base)} "
                    f"{_format_value(hsum)}"
                )
                lines.append(
                    f"{name}_count{_labels_str(base)} "
                    f"{_format_value(hcount)}"
                )
            else:
                self._render_family(lines, kind, name, help_text, samples)
        for collector in collectors:
            try:
                families = list(collector())
            except Exception:  # noqa: BLE001 — one bad collector must
                continue  # not take down the exposition
            for fam in families:
                self._render_family(
                    lines, fam.kind, fam.name, fam.help, fam.samples
                )
        self._render_family(
            lines, "counter", "lo_obs_series_overflow_total",
            "Samples routed to an _overflow series because the metric "
            "was at LO_TPU_OBS_MAX_SERIES label combinations.",
            [({}, overflows)],
        )
        return "\n".join(lines) + "\n"


# -- process-wide singleton ---------------------------------------------------

_registry: MetricsRegistry | None = None
_registry_lock = make_lock("metrics._registry_lock")


def get_registry() -> MetricsRegistry:
    """The process-wide registry, sized from config (LO_TPU_OBS_*).

    Lock-free fast path: the singleton read is a single atomic load
    (hot-path instrumentation — HTTP dispatch, predict latency —
    resolves the registry per call), with the lock taken only to
    build it."""
    global _registry
    reg = _registry
    if reg is not None:
        return reg
    with _registry_lock:
        if _registry is None:
            from learningorchestra_tpu_torch.config import get_config

            obs = get_config().obs
            _registry = MetricsRegistry(
                enabled=obs.enabled,
                trace_enabled=obs.trace,
                max_series=obs.max_series,
                max_spans=obs.max_spans,
                trace_sample=getattr(obs, "trace_sample", 1.0),
            )
        return _registry


def reset_registry(**overrides) -> MetricsRegistry:
    """Replace the singleton (tests; the smoke's on/off
    overhead probe).  With overrides, builds directly from them; bare call
    rebuilds from config."""
    global _registry
    with _registry_lock:
        if overrides:
            _registry = MetricsRegistry(**overrides)
            return _registry
        _registry = None
    return get_registry()
