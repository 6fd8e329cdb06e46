"""Observability — port of the cost plane of ``learningorchestra_tpu/obs/``
(``costs.py``: per-program FLOPs ledgers and device-time attribution).
Metrics, tracing, rollups, SLOs, the flight recorder and bundles are
ROADMAP A.11; profiling is A.10."""
