"""Observability — port of the cost plane and the profiler of
``learningorchestra_tpu/obs/`` (``costs.py``: per-program FLOPs ledgers
and device-time attribution; ``profiling.py``: on-demand
``torch.profiler`` captures over REST).  Metrics, tracing, rollups, SLOs,
the flight recorder and bundles are ROADMAP A.11."""
