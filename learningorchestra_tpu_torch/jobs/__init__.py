"""Asynchronous job execution of the port — port of
``learningorchestra_tpu/jobs/``: the engine (``engine.py``: weighted-fair
dispatch, deadlines, bounded shutdown), cooperative
cancellation tokens (``cancel.py``) and device leases (``leases.py``).

Nothing is imported here: ``train/neural.py`` imports ``jobs.cancel``,
and the engine imports the store, which imports ``train/neural.py``."""
