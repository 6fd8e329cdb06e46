"""Observability — port of ``learningorchestra_tpu/obs/``: the metrics
registry and its Prometheus exposition (``metrics.py``), job tracing with
request ids and span trees (``tracing.py``), windowed rollups
(``rollup.py``), SLO burn-rate alerting (``slo.py``), the flight recorder
(``flight.py``), debug bundles (``bundle.py``), the cost plane
(``costs.py``: per-program FLOPs ledgers and device-time attribution) and
on-demand ``torch.profiler`` captures (``profiling.py``).

``GET /metrics.prom`` exposes every subsystem's counters and histograms,
and ``GET /observability/jobs/<name>/trace`` serves the span tree of a
job's life, keyed by the ``X-Request-Id`` the API mints or echoes.
Knobs: config.py ``ObsConfig`` and its siblings.
"""

from learningorchestra_tpu_torch.obs.metrics import (  # noqa: F401
    Family,
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from learningorchestra_tpu_torch.obs.tracing import (  # noqa: F401
    JobTrace,
    current_trace,
    get_request_id,
    new_request_id,
    new_trace,
    record_span,
    span,
    span_tree,
)

__all__ = [
    "Family",
    "JobTrace",
    "MetricsRegistry",
    "current_trace",
    "get_registry",
    "get_request_id",
    "new_request_id",
    "new_trace",
    "record_span",
    "reset_registry",
    "span",
    "span_tree",
]
