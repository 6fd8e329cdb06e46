"""Asynchronous job execution of the port — port of
``learningorchestra_tpu/jobs/``: the engine (``engine.py``: weighted-fair
dispatch, deadlines, bounded shutdown), cooperative cancellation tokens
(``cancel.py``), device leases (``leases.py``) and the crash-durable job
journal with engine-epoch fencing (``journal.py``).

Only the journal's names are exported here: ``train/neural.py`` imports
``jobs.cancel``, and the engine imports the store, which imports
``train/neural.py``."""

from learningorchestra_tpu_torch.jobs.journal import (
    JOURNAL_COLLECTION,
    JobJournal,
    StaleEpochError,
    read_engine_epoch,
    write_engine_epoch,
)

__all__ = [
    "JOURNAL_COLLECTION",
    "JobJournal",
    "StaleEpochError",
    "read_engine_epoch",
    "write_engine_epoch",
]
