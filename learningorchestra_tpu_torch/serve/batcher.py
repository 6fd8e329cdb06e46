"""MicroBatcher — copy of ``learningorchestra_tpu/serve/batcher.py``.

Coalesces concurrent requests into padded bucket dispatches: N
concurrent small predicts cost one bucket-sized forward instead of N.

- **max batch**: a dispatch fires as soon as ``max_batch`` rows are
  waiting (never exceeded: oversized requests are chunked at submit);
- **flush deadline**: otherwise it fires ``flush_ms`` after the OLDEST
  waiting request arrived, the latency bound a lone request pays.

Backpressure is a bounded row queue: ``submit`` raises :class:`QueueFull`
instead of queueing unboundedly (the API maps it to 429 + Retry-After).
Stats: rolling p50/p95/p99 request latency, queue depth, mean batch
occupancy and a bucket histogram.

One difference from the JAX copy: a dispatch only coalesces requests
whose rows have the same trailing shape (e.g. one sequence length), so
two clients sending different lengths are served in separate dispatches
instead of failing each other's concatenation.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable

import numpy as np

from learningorchestra_tpu_torch.concurrency_rt import make_condition
from learningorchestra_tpu_torch.serve.bucketing import bucket_for, pad_rows


class QueueFull(Exception):
    """Bounded request queue is at capacity — shed load (429)."""


class BatcherClosed(QueueFull):
    """Batcher torn down (unload/invalidation/shutdown) while the request
    was arriving.  A QueueFull subtype on purpose: the API answers 429 +
    Retry-After and the retry lands on a fresh batcher (or a clean 404)."""


class _Pending:
    __slots__ = ("x", "event", "result", "error", "t_enqueue")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enqueue = time.monotonic()


#: Rolling latency window for the percentile stats.
_LATENCY_WINDOW = 2048


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into bucket dispatches.

    ``dispatch`` receives one host array already padded to a bucket
    (``shape[0]`` IS the bucket) and returns the model outputs for it;
    the batcher slices off pad rows and splits results per request.
    """

    def __init__(
        self,
        dispatch: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 64,
        max_queue: int = 256,
        flush_ms: float = 5.0,
        name: str = "",
    ):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.flush_s = max(0.0, float(flush_ms)) / 1e3
        self.name = name
        self._queue: collections.deque[_Pending] = collections.deque()
        self._rows_queued = 0
        self._cond = make_condition("MicroBatcher._cond")
        self._closed = False
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.padded_rows = 0
        self.overflows = 0
        self.bucket_counts: dict[int, int] = {}
        self._occupancy_sum = 0.0
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=_LATENCY_WINDOW
        )
        self._worker = threading.Thread(
            target=self._run, name=f"microbatch-{name or 'serve'}",
            daemon=True,
        )
        self._worker.start()

    # -- submit side ---------------------------------------------------------

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Enqueue ``x`` (rows on axis 0), block until its outputs are
        ready.  Raises :class:`QueueFull` under backpressure (chunks
        already queued still dispatch, their results abandoned: the
        caller retries the whole request; ``partial`` is set on the
        exception then); re-raises the dispatch's
        exception on model failure.  Oversized requests chunk to
        ``max_batch`` and enqueue all chunks before waiting."""
        x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] == 0:
            raise ValueError("submit needs at least one row")
        pendings: list[_Pending] = []
        try:
            for i in range(0, x.shape[0], self.max_batch):
                pendings.append(self._enqueue(x[i:i + self.max_batch]))
        except QueueFull as exc:
            if pendings:
                # Earlier chunks are queued and WILL dispatch: the flag
                # tells a routing layer not to replay the whole request
                # on another replica (duplicate device work under the
                # very saturation that overflowed this one).
                exc.partial = True
            raise
        outs = []
        for p in pendings:
            p.event.wait()
            if p.error is not None:
                raise p.error
            outs.append(p.result)
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _enqueue(self, x: np.ndarray) -> _Pending:
        pending = _Pending(x)
        with self._cond:
            if self._closed:
                raise BatcherClosed(
                    f"batcher {self.name!r} is closed; retry"
                )
            if self._rows_queued + x.shape[0] > self.max_queue:
                self.overflows += 1
                raise QueueFull(
                    f"serving queue full ({self._rows_queued} rows "
                    f"queued, cap {self.max_queue})"
                )
            self._queue.append(pending)
            self._rows_queued += x.shape[0]
            self.requests += 1
            self._cond.notify_all()
        return pending

    # -- worker side ---------------------------------------------------------

    def _take_batch_locked(self) -> list[_Pending]:
        batch, rows = [], 0
        row_shape = self._queue[0].x.shape[1:]
        while self._queue and (
            rows + self._queue[0].x.shape[0] <= self.max_batch
            and self._queue[0].x.shape[1:] == row_shape
        ):
            p = self._queue.popleft()
            rows += p.x.shape[0]
            batch.append(p)
        self._rows_queued -= rows
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                # Coalesce until max_batch rows OR the oldest request's
                # flush deadline, whichever comes first.  close() flushes
                # immediately so shutdown never strands waiters.
                deadline = self._queue[0].t_enqueue + self.flush_s
                while (
                    self._rows_queued < self.max_batch
                    and not self._closed
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = self._take_batch_locked()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: list[_Pending]) -> None:
        xs = (
            batch[0].x if len(batch) == 1
            else np.concatenate([p.x for p in batch], axis=0)
        )
        n = xs.shape[0]
        bucket = bucket_for(n, self.max_batch)
        try:
            out = np.asarray(self._dispatch(pad_rows(xs, bucket)))[:n]
        except Exception as exc:  # noqa: BLE001 — fail the REQUESTS,
            # never the worker (one bad model call must not kill the
            # batcher for every later request).
            for p in batch:
                p.error = exc
                p.event.set()
            return
        done = time.monotonic()
        with self._cond:
            self.batches += 1
            self.rows += n
            self.padded_rows += bucket - n
            self.bucket_counts[bucket] = (
                self.bucket_counts.get(bucket, 0) + 1
            )
            self._occupancy_sum += n / bucket
            for p in batch:
                self._latencies.append(done - p.t_enqueue)
        offset = 0
        for p in batch:
            k = p.x.shape[0]
            p.result = out[offset:offset + k]
            offset += k
            p.event.set()

    # -- observability / lifecycle -------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Racy snapshot of the queued rows: the fleet router's load
        signal, read per routing decision without the condition lock
        (balancing needs freshness, not exactness)."""
        return self._rows_queued

    def stats(self) -> dict:
        with self._cond:
            lat = sorted(self._latencies)
            occupancy = (
                self._occupancy_sum / self.batches if self.batches else 0.0
            )

            def pct(q: float) -> float:
                if not lat:
                    return 0.0
                idx = min(len(lat) - 1, int(q * (len(lat) - 1)))
                return round(lat[idx] * 1e3, 3)

            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "paddedRows": self.padded_rows,
                "overflows": self.overflows,
                "queueDepth": self._rows_queued,
                "maxBatch": self.max_batch,
                "maxQueue": self.max_queue,
                "flushMs": round(self.flush_s * 1e3, 3),
                "batchOccupancy": round(occupancy, 4),
                "bucketHistogram": {
                    str(k): v
                    for k, v in sorted(self.bucket_counts.items())
                },
                "latencyMs": {
                    "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
                },
            }

    def close(self, join: bool = True) -> None:
        """Stop accepting work, flush what's queued, join the worker.
        ``join=False`` only signals: a fleet closing many batchers
        signals them all first so the drains overlap, then waits in
        :meth:`wait_drained`."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if join:
            self._worker.join(timeout=30)

    def wait_drained(self, timeout: float | None = None) -> bool:
        """True once the worker thread has exited: the fleet returns a
        replica's card to the lease pool only after this, never while
        the batcher could still be dispatching on it."""
        self._worker.join(timeout)
        return not self._worker.is_alive()
