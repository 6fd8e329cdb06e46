"""First-party static-analysis suite (``lochecks``) — port of
``learningorchestra_tpu/analysis/`` for the PyTorch package.  The modules
keep the JAX package's names, so each has its counterpart there.

- **Concurrency** (:mod:`.concurrency`): lock-acquisition order
  cycles, self-deadlocks, and inconsistently-locked shared state,
  modeled on the repo's idioms (``with self._lock:``, daemon threads,
  module-level registry locks, ``*_locked`` caller-holds-lock
  helpers).
- **Program hazards** (:mod:`.jaxlint`): host-sync constructs,
  mutable-global capture, and shape-branching inside the port's program
  functions (``train/aot_store.py::program_function``) and the methods
  they run (the fit step, MoE routing, the decode step captured as a
  CUDA graph), as well as inside any jit-compiled body; plus the
  cooperative-cancellation worklist rule (:mod:`.cancellation`).
- **Whole-program** (:mod:`.wholeprogram`): the per-module lock
  models composed into one global lock-order graph across modules —
  cross-module inversion cycles, blocking-call-under-lock, and
  ``make_lock`` name congruence.

- **Drift** (:mod:`.drift`): the port's ``LO_TPU_*`` knobs, fault
  points, routes and metric families against ``config.py``, the
  README's port section, ``deploy/torch/``, ``client.py`` and the port's
  tests.
- **Witness** (:mod:`.witness`): a runtime lock-witness dump
  (``concurrency_rt``, ``LO_TPU_WITNESS_DUMP``) against the static
  whole-program graph; an edge the graph lacks is a finding.

Run via :func:`run_checks`; the tier-1 gate is
``tests/test_torch_lochecks.py``.
"""

from .findings import ERROR, WARN, Finding
from .runner import RULES, Report, run_checks
from .wholeprogram import GlobalLockGraph, global_graph

__all__ = [
    "ERROR",
    "Finding",
    "GlobalLockGraph",
    "RULES",
    "Report",
    "WARN",
    "global_graph",
    "run_checks",
]
