"""Per-job device placement: device leases — port of
``learningorchestra_tpu/jobs/leases.py``.

Cards are lease units (``cuda:k`` for ``k < torch.cuda.device_count()``):
a job that runs device work takes a lease for its duration, so jobs on
the card SERIALIZE per card (or take disjoint cards on a host with
several), and the lease is recorded in the job's metadata.  A leased body
runs under ``torch.cuda.device(k)`` (:func:`placed`).

On a CPU context leasing is a no-op (there is nothing to contend for)
unless a device list is injected, which is how the tests exercise the
serialization.  Single-path serving is not leased: its batcher threads
may run forwards while a train job holds the card.  A fleet replica
(``serve/fleet``) is: it holds its card through :meth:`DeviceLeaser.
acquire` for its whole life, so a train job queues behind it.

Every request passes the ``lease.acquire`` fault point (faults/plane.py);
waits, holds and grants feed the registry (obs/metrics.py), and a
with-block lease on a card is the ``lease`` span of the job's trace, so
the spans recorded inside it nest under it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Sequence

import torch

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.concurrency_rt import (
    make_condition,
    make_lock,
)
from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.obs import tracing
from learningorchestra_tpu_torch.obs.metrics import get_registry

logger = get_logger("leases")

#: Metric family names (the JAX package's).
LEASE_WAIT = "lo_lease_wait_seconds"
LEASE_HOLD = "lo_lease_hold_seconds"
LEASES_TOTAL = "lo_leases_total"


def _lease_metrics():
    """Lease instrumentation handles, resolved per lease so registry
    resets take effect at once."""
    reg = get_registry()
    return (
        reg.histogram(
            LEASE_WAIT, "Time a job waited for its chip lease.",
            buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0,
                     300.0, 1800.0),
        ),
        reg.histogram(
            LEASE_HOLD, "Time a job held its chip lease.",
            buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0,
                     7200.0, 43200.0),
        ),
        reg.counter(LEASES_TOTAL, "Chip leases granted."),
    )


class LeaseTimeout(Exception):
    pass


class DeviceLeaser:
    """Blocking lease manager over a fixed set of devices: the injected
    ``device_ids``, else every card when ``device`` is CUDA, else none."""

    def __init__(self, device_ids: Sequence[str] | None = None, *,
                 device="cuda"):
        self._cv = make_condition("DeviceLeaser._cv")
        if device_ids is not None:
            self._all = list(device_ids)
        elif torch.device(device).type == "cuda":
            self._all = [f"cuda:{k}"
                         for k in range(torch.cuda.device_count())]
        else:
            self._all = []
        self._free = list(self._all)
        # (label, device, t_start, t_end): placement audit trail, bounded.
        self.history: collections.deque = collections.deque(maxlen=1024)
        # Live leases for the watchdog's revoke: {label, devices,
        # revoked}; revoked devices are back in the pool already.
        self._active: list[dict] = []

    @property
    def device_count(self) -> int:
        return len(self._all)

    def snapshot(self) -> dict:
        """Lock-consistent view for dashboards and tests: the free and
        all device ids and the last ten history records."""
        with self._cv:
            return {
                "initialized": True,
                "free": list(self._free),
                "all": list(self._all),
                "recent": list(self.history)[-10:],
            }

    @contextlib.contextmanager
    def lease(self, n_devices: int = 1, *, label: str = "",
              timeout: float | None = None):
        """Hold ``n_devices`` devices (``<= 0``: all) for the with-block;
        yields the leased ids (empty when there is nothing to lease).
        ``timeout=None`` waits: a job queued behind a long fit must
        queue, not fail; a finite one raises :class:`LeaseTimeout`."""
        t_req = time.monotonic()
        faults.hit("lease.acquire")
        with self._cv:
            taken: list[str] = []
            if self._all:
                want = len(self._all) if n_devices <= 0 else min(
                    n_devices, len(self._all))
                if not self._cv.wait_for(lambda: len(self._free) >= want,
                                         timeout):
                    raise LeaseTimeout(
                        f"no {want}-device lease within {timeout}s "
                        f"(job {label!r})")
                taken = [self._free.pop() for _ in range(want)]
            rec = {"label": label, "devices": list(taken), "revoked": set()}
            if taken:
                self._active.append(rec)
        t0 = time.monotonic()
        wait_hist, hold_hist, leases_total = _lease_metrics()
        if taken:
            wait_hist.observe(t0 - t_req)
            leases_total.inc()
            logger.info(kv(event="lease", job=label, devices=taken))
        try:
            if taken:
                # The span covers the with-block, so program and epoch
                # spans recorded inside nest under it.
                with tracing.span("lease", devices=",".join(taken),
                                  waitS=round(t0 - t_req, 6)):
                    yield taken
            else:
                yield taken
        finally:
            t1 = time.monotonic()
            with self._cv:
                for dev in taken:
                    if dev in rec["revoked"]:
                        continue  # the watchdog already returned it
                    self._free.append(dev)
                    self.history.append((label, dev, t0, t1))
                if taken:
                    self._active.remove(rec)
                self._cv.notify_all()
            if taken:
                hold_hist.observe(t1 - t0)
                logger.info(kv(event="release", job=label, devices=taken,
                               held=f"{t1 - t0:.2f}s"))

    def acquire(self, n_devices: int = 1, *, label: str = "",
                timeout: float | None = None) -> "LeaseHandle":
        """A lease for a LONG-LIVED holder, detached from a with-block: a
        fleet replica keeps its card for its lifetime, and the thread
        that acquires it (a REST handler, the autoscaler) is not the one
        that releases it (a scale-down, shutdown).  Same blocking and
        timeout semantics as :meth:`lease`; call ``release()`` on the
        returned :class:`LeaseHandle` (idempotent, any thread).  The
        with-block's span is suppressed: a span opened in the acquiring
        thread could not close in the releasing one."""
        cm = self.lease(n_devices, label=label, timeout=timeout)
        with tracing.activate(None):
            devices = cm.__enter__()
        return LeaseHandle(cm, list(devices))

    def revoke(self, label: str) -> list[str]:
        """Force-release every device leased as ``label`` or ``label:*``
        (the deadline watchdog's reclaim).  The holder may still be
        running device work: the guarantee is that the scheduler stops
        waiting, not that the computation stops."""
        freed: list[str] = []
        t1 = time.monotonic()
        with self._cv:
            for rec in self._active:
                if rec["label"] != label and not \
                        rec["label"].startswith(label + ":"):
                    continue
                for dev in rec["devices"]:
                    if dev not in rec["revoked"]:
                        rec["revoked"].add(dev)
                        self._free.append(dev)
                        self.history.append((rec["label"], dev, t1, t1))
                        freed.append(dev)
            if freed:
                self._cv.notify_all()
        return freed


class LeaseHandle:
    """A held lease detached from its with-block (see
    :meth:`DeviceLeaser.acquire`).  ``devices`` is the granted id list
    (empty on a CPU context).  ``release()`` is idempotent and may run
    on any thread."""

    __slots__ = ("devices", "_cm", "_lock", "_released")

    def __init__(self, cm, devices: list[str]):
        self._cm = cm
        self.devices = devices
        self._lock = make_lock("LeaseHandle._lock")
        self._released = False

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
        # Resumed with no active trace, as it was entered.
        with tracing.activate(None):
            self._cm.__exit__(None, None, None)


def device_for(device_id: str) -> torch.device | None:
    """A lease's device id back to the ``torch.device`` it names:
    ``cuda:k`` for ``k < torch.cuda.device_count()``, else None (an
    injected id with no card behind it leaves its holder unplaced)."""
    platform, _, idx = device_id.partition(":")
    if platform != "cuda" or not idx.isdigit():
        return None
    k = int(idx)
    if k >= torch.cuda.device_count():
        return None
    return torch.device("cuda", k)


@contextlib.contextmanager
def placed(devices: list[str]):
    """Run the with-block on the first leased card (its current device,
    so ``"cuda"`` tensors and kernel launches land there); a no-op
    without a CUDA lease."""
    cards = [d for d in devices if d.startswith("cuda:")]
    if not cards:
        yield
        return
    with torch.cuda.device(int(cards[0].split(":", 1)[1])):
        yield
