"""Asynchronous job execution of the port — port of
``learningorchestra_tpu/jobs/``: the engine (``engine.py``: weighted-fair
dispatch with nested tenant fairness, deadlines, bounded shutdown),
cooperative cancellation tokens (``cancel.py``), device leases
(``leases.py``), the crash-durable job journal with engine-epoch fencing
(``journal.py``) and the multi-engine control plane (``cluster.py``: the
claim table, stealing, the claim fence and tenant admission).

The engine's names resolve at first use (``__getattr__``): the engine
imports the store, which imports ``train/neural.py``, which imports
``jobs.cancel`` through this package."""

from learningorchestra_tpu_torch.jobs.cancel import (
    CancelToken,
    cancel_requested,
    current_cancel_token,
)
from learningorchestra_tpu_torch.jobs.cluster import (
    ClusterCoordinator,
    QuotaExceeded,
    TenantAdmission,
    bind_tenant,
    current_tenant,
)
from learningorchestra_tpu_torch.jobs.journal import (
    JOURNAL_COLLECTION,
    JobJournal,
    StaleEpochError,
    read_engine_epoch,
    write_engine_epoch,
)

_ENGINE_NAMES = ("JobDeadlineExceeded", "JobEngine", "JobState",
                 "Preempted", "current_attempt")


def __getattr__(name: str):
    if name in _ENGINE_NAMES:
        from learningorchestra_tpu_torch.jobs import engine

        return getattr(engine, name)
    raise AttributeError(name)


__all__ = [
    "CancelToken",
    "ClusterCoordinator",
    "JOURNAL_COLLECTION",
    "JobDeadlineExceeded",
    "JobEngine",
    "JobJournal",
    "JobState",
    "Preempted",
    "QuotaExceeded",
    "StaleEpochError",
    "TenantAdmission",
    "bind_tenant",
    "cancel_requested",
    "current_attempt",
    "current_cancel_token",
    "current_tenant",
    "read_engine_epoch",
    "write_engine_epoch",
]
