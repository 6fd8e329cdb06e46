"""ReplicaSet — N replicas of one served model over leased cards — port
of ``learningorchestra_tpu/serve/fleet/replicaset.py``.

Each replica holds a card acquired through
:meth:`jobs.leases.DeviceLeaser.acquire` for its lifetime, its own
MicroBatcher, and the module it dispatches through (:meth:`Replica.
place`); each request is routed by power-of-two-choices on live batcher
queue depth, and answered 429 only when EVERY replica's bounded queue
refuses it.

Placement: a replica whose lease resolves to no card (a CPU context, or
an injected id with no card behind it) and a replica on the registry's
own card share the registry's resident module: zero extra bytes, zero
extra loads.  A replica on another card gets a copy of the resident
module there, cached by the registry entry's identity so an invalidated
artifact is placed again, never served stale.  A replica of more than
one resolved card would need the JAX package's GSPMD parameter sharding,
which the port does not have yet (ROADMAP A.9 part 2): it is refused.

Drain before unload: scale-down takes the victim off the routable list
FIRST, closes its batcher (``MicroBatcher.close`` flushes what is
queued), waits for its worker to exit, and only then returns the lease.
A request that raced into the victim rides the final flush or gets
``BatcherClosed`` and is re-routed by :meth:`ReplicaSet.submit`.
"""

from __future__ import annotations

import copy
import time
import zlib
from typing import Callable

import numpy as np

from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.jobs.leases import device_for
from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.obs import tracing
from learningorchestra_tpu_torch.serve.batcher import (
    BatcherClosed,
    MicroBatcher,
    QueueFull,
)
from learningorchestra_tpu_torch.serve.fleet.router import P2CRouter
from learningorchestra_tpu_torch.serve.registry import ServeError

logger = get_logger("fleet")

#: Batcher lifetime-counter keys a set's retired pool accumulates.
_COUNTER_KEYS = ("requests", "rows", "batches", "paddedRows",
                 "overflows")


def _stats_delta(final: dict, pre: dict) -> dict:
    """What a batcher did AFTER the ``pre`` snapshot — stats-shaped, so
    ``absorb_stats`` takes it unchanged."""
    delta = {key: final[key] - pre[key] for key in _COUNTER_KEYS}
    pre_w = pre["batchOccupancy"] * pre["batches"]
    final_w = final["batchOccupancy"] * final["batches"]
    delta["batchOccupancy"] = (
        (final_w - pre_w) / delta["batches"] if delta["batches"] else 0.0
    )
    pre_buckets = pre["bucketHistogram"]
    delta["bucketHistogram"] = {
        bucket: count - pre_buckets.get(bucket, 0)
        for bucket, count in final["bucketHistogram"].items()
        if count - pre_buckets.get(bucket, 0)
    }
    return delta


def _module_device(module):
    param = next(module.parameters(), None)
    return None if param is None else param.device


class Replica:
    """One routable copy of a served model: card lease + batcher + the
    module it dispatches through."""

    __slots__ = (
        "model", "idx", "device_id", "devices", "batcher", "created_at",
        "warmed", "cards", "_handle", "_placed",
    )

    def __init__(self, model: str, idx: int, handle):
        self.model = model
        self.idx = idx
        self._handle = handle
        self.devices: list[str] = (
            list(handle.devices) if handle is not None else []
        )
        self.device_id: str | None = (
            self.devices[0] if self.devices else None
        )
        # The cards the lease names, or None when any id resolves to no
        # card here (the replica then runs unplaced, on the resident
        # module).
        resolved = [device_for(d) for d in self.devices]
        self.cards = (
            resolved if resolved and all(d is not None for d in resolved)
            else None
        )
        self.created_at = time.time()
        # True once the pre-warm dispatches completed before the replica
        # became routable; False means it serves cold.
        self.warmed = False
        self.batcher: MicroBatcher | None = None
        # (registry entry, module placed on this replica's card), keyed
        # by entry IDENTITY: an invalidated artifact is placed again.
        self._placed: tuple | None = None

    def place(self, entry):
        """The module this replica runs ``entry`` with: the resident one
        when the replica is unplaced or on the resident module's card,
        else (once per entry) a copy on the replica's card.  The caller
        hands the module HOST inputs: one host-to-card transfer."""
        module = entry.estimator.module
        cards = self.cards
        if cards is None or cards[0] == _module_device(module):
            return module
        cached = self._placed
        if cached is None or cached[0] is not entry:
            self._placed = cached = (
                entry, copy.deepcopy(module).to(cards[0]).eval()
            )
        return cached[1]

    def release(self) -> None:
        self._placed = None
        if self._handle is not None:
            self._handle.release()

    def status(self) -> dict:
        stats = self.batcher.stats() if self.batcher is not None else {}
        return {
            "replica": self.idx,
            "device": self.device_id or "host",
            "devices": self.devices or ["host"],
            "shardSpec": None,
            "createdAt": self.created_at,
            "requests": stats.get("requests", 0),
            "queueDepth": stats.get("queueDepth", 0),
            "batches": stats.get("batches", 0),
            "overflows": stats.get("overflows", 0),
            "latencyMs": stats.get("latencyMs", {}),
            "warmed": self.warmed,
        }


class ReplicaSet:
    """The per-model fleet: replica lifecycle + P2C request routing.

    ``dispatch_factory(replica)`` returns the padded-bucket dispatch for
    one replica: the serving service binds the registry dispatch with
    the replica's placement; tests inject stubs to exercise routing and
    scaling without a model."""

    def __init__(
        self,
        name: str,
        serve_cfg,
        leaser,
        dispatch_factory: Callable[[Replica], Callable],
        *,
        min_replicas: int = 1,
        max_replicas: int = 1,
        lease_timeout_s: float = 5.0,
        router_seed: int = 0,
        warmup: Callable[[Replica], None] | None = None,
        devices_per_replica: int = 1,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min ({min_replicas}) <= max "
                f"({max_replicas})"
            )
        if int(devices_per_replica) < 1:
            raise ValueError(
                "devices_per_replica must be >= 1, got "
                f"{devices_per_replica}"
            )
        self.name = name
        self._cfg = serve_cfg
        self._leaser = leaser
        self._factory = dispatch_factory
        # Optional pre-router warm-up (the serving service binds it when
        # AotConfig.replica_prewarm is on): runs against a fresh replica
        # BEFORE it joins the routable list.
        self._warmup = warmup
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.devices_per_replica = int(devices_per_replica)
        self.lease_timeout_s = float(lease_timeout_s)
        # Seed mixed with a stable CRC of the model name: distinct models
        # route through distinct but reproducible RNG streams.
        self.router = P2CRouter(
            (int(router_seed) << 32) ^ zlib.crc32(name.encode())
        )
        self._replicas: list[Replica] = []
        self._lock = make_lock("ReplicaSet._lock")
        # Scaling is serialized apart from routing: a lease may block
        # for seconds, and concurrent scalers (autoscaler tick, manual
        # POST, lazy ensure) must converge on one target.
        self._scale_lock = make_lock("ReplicaSet._scale_lock")
        self._closed = False
        self.scale_ups = 0
        self.scale_downs = 0
        # CLIENT-VISIBLE sheds: submit exhausted every candidate (a real
        # 429); per-replica overflows that re-routed and served are not.
        self.sheds = 0
        # Lifetime counters folded in from drained replicas (and the
        # retired single-path batcher), so the set's cumulative counters
        # stay monotonic across scale cycles.
        self._retired = {
            "requests": 0, "rows": 0, "batches": 0, "paddedRows": 0,
            "overflows": 0, "occ_weighted": 0.0, "buckets": {},
        }

    # -- scaling -------------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self._replicas)

    def replicas(self) -> list[Replica]:
        """A snapshot of the routable replicas."""
        with self._lock:
            return list(self._replicas)

    def set_bounds(self, min_replicas: int, max_replicas: int) -> None:
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min ({min_replicas}) <= max "
                f"({max_replicas})"
            )
        with self._lock:
            self.min_replicas = int(min_replicas)
            self.max_replicas = int(max_replicas)

    def scale_to(self, n: int, *, reason: str = "manual") -> int:
        """Grow or shrink to ``n`` replicas (clamped to [min, max]);
        returns the resulting count.  Scale-up may raise ``LeaseTimeout``
        when the pool cannot place a new replica in time; replicas
        already added stay.  The clamp re-reads the bounds every
        iteration, so a concurrent ``set_bounds`` re-targets."""
        with self._scale_lock:
            while True:
                with self._lock:
                    if self._closed:
                        return 0
                    cur = len(self._replicas)
                    target = max(
                        self.min_replicas,
                        min(self.max_replicas, int(n)),
                    )
                if cur < target:
                    if not self._add_replica(reason):
                        with self._lock:
                            return len(self._replicas)
                elif cur > target:
                    self._remove_replica(reason)
                else:
                    return cur

    def _add_replica(self, reason: str) -> bool:
        with self._lock:
            # Lowest free index: a fleet oscillating for days cycles
            # through at most max_replicas distinct indices.
            live = {r.idx for r in self._replicas}
            idx = next(
                i for i in range(len(live) + 1) if i not in live
            )
        # "@" keeps the label out of the deadline watchdog's revoke
        # namespace ("<job>" or "<job>:*"): job names never hold "@".
        handle = self._leaser.acquire(
            self.devices_per_replica,
            label=f"serve@{self.name}:r{idx}",
            timeout=self.lease_timeout_s,
        )
        replica = Replica(self.name, idx, handle)
        if replica.cards is not None and len(replica.cards) > 1:
            replica.release()
            raise ServeError(
                f"devicesPerReplica={self.devices_per_replica} leased "
                f"{replica.devices}: a replica across several cards needs "
                "parameter sharding, not ported yet (ROADMAP A.9 part 2)"
            )
        replica.batcher = MicroBatcher(
            self._factory(replica),
            max_batch=self._cfg.max_batch,
            max_queue=self._cfg.max_queue,
            flush_ms=self._cfg.flush_ms,
            name=f"{self.name}:r{idx}",
        )
        if self._warmup is not None:
            # Warm BEFORE the replica is routable.  A failed warm-up is
            # logged and the replica serves cold: availability first.
            try:
                with tracing.span("replica.warmup", model=self.name,
                                  replica=idx,
                                  device=replica.device_id or "host"):
                    self._warmup(replica)
                replica.warmed = True
            except Exception as exc:  # noqa: BLE001
                logger.warning(kv(
                    event="replica_warmup_failed", model=self.name,
                    replica=idx, device=replica.device_id or "host",
                    error=repr(exc),
                ))
        with self._lock:
            # Closed (or raced past max by a concurrent scaler) while the
            # lease was being placed: hand everything straight back.
            discard = (
                self._closed
                or len(self._replicas) >= self.max_replicas
            )
            if not discard:
                self._replicas.append(replica)
                self.scale_ups += 1
        if discard:
            replica.batcher.close()
            replica.release()
            return False
        logger.info(kv(
            event="replica_up", model=self.name, replica=idx,
            device=replica.device_id or "host", reason=reason,
        ))
        return True

    def _remove_replica(self, reason: str) -> None:
        with self._lock:
            if len(self._replicas) <= 1:
                return  # never drain the last routable replica
            # Newest first: replica 0 (the longest warm) stays.
            victim = self._replicas.pop()
            self.scale_downs += 1
        # Counters move to _retired BEFORE the drain, so a status read
        # during the drain never sees the victim's totals missing.
        pre = victim.batcher.stats()
        self.absorb_stats(pre)
        victim.batcher.close(join=False)
        self._retire(victim, reason, pre)

    def _retire(self, victim: Replica, reason: str,
                pre: dict | None = None) -> None:
        """Post-close teardown: fold in the drain's counters and return
        the card, but ONLY once the batcher's worker has exited.  A join
        that timed out behind a wedged dispatch keeps the lease (and
        logs it): releasing it would double-book the card."""
        drained = victim.batcher.wait_drained(timeout=30)
        final = victim.batcher.stats()
        self.absorb_stats(_stats_delta(final, pre) if pre else final)
        if drained:
            victim.release()
            logger.info(kv(
                event="replica_down", model=self.name,
                replica=victim.idx,
                device=victim.device_id or "host", reason=reason,
            ))
        else:
            logger.warning(kv(
                event="replica_down_undrained", model=self.name,
                replica=victim.idx,
                device=victim.device_id or "host", reason=reason,
                note="worker still dispatching; lease retained",
            ))

    def absorb_stats(self, stats: dict, *,
                     overflows_were_sheds: bool = False) -> None:
        """Fold another batcher's lifetime counters into this set's
        retired totals: drained replicas at scale-down, and the
        single-path batcher a model retires when it moves onto the
        fleet.  ``overflows_were_sheds``: every overflow of the single
        path was a client 429, so the cutover counts them as sheds."""
        with self._lock:
            retired = self._retired
            for key in _COUNTER_KEYS:
                retired[key] += stats[key]
            if overflows_were_sheds:
                self.sheds += stats["overflows"]
            retired["occ_weighted"] += (
                stats["batchOccupancy"] * stats["batches"]
            )
            for bucket, count in stats["bucketHistogram"].items():
                retired["buckets"][bucket] = (
                    retired["buckets"].get(bucket, 0) + count
                )

    # -- routing -------------------------------------------------------------

    def submit(self, x: np.ndarray) -> tuple:
        """Route one request: P2C on live queue depth, falling through
        the candidate order on per-replica overflow; raises ``QueueFull``
        (429 + Retry-After) only when EVERY replica refused.  Returns
        ``(outputs, replica)``."""
        replicas = self.replicas()
        if not replicas:
            raise BatcherClosed(
                f"no routable replicas for {self.name!r}; retry"
            )
        order = self.router.choose(
            [r.batcher.queue_depth for r in replicas]
        )
        last: QueueFull | None = None
        for i in order:
            replica = replicas[i]
            try:
                # Replica attribution on the serve span (one context
                # variable read when no trace is active).
                with tracing.span("serve.predict", model=self.name,
                                  replica=replica.idx,
                                  device=replica.device_id or "host"):
                    return replica.batcher.submit(x), replica
            except QueueFull as exc:
                # BatcherClosed included: drained under us mid-route, the
                # next candidate absorbs the request.
                last = exc
            if getattr(last, "partial", False):
                # Part of the request is queued (and will dispatch) on
                # that replica: replaying it elsewhere would duplicate
                # device work under saturation.  Shed.
                break
        with self._lock:
            self.sheds += 1
        raise last  # every replica saturated: shed (429)

    # -- signals / observability ---------------------------------------------

    def signals(self) -> dict:
        """The autoscaler's per-tick inputs, read from the batchers' own
        counters: queued rows, p99, cumulative requests and sheds.  Batch
        occupancy is not one: power-of-two padding keeps it near 1.0 at
        trickle load."""
        with self._lock:
            replicas = list(self._replicas)
            requests = self._retired["requests"]
            sheds = self.sheds
        depth = 0
        p99 = 0.0
        for r in replicas:
            stats = r.batcher.stats()
            depth += stats["queueDepth"]
            requests += stats["requests"]
            p99 = max(p99, stats["latencyMs"]["p99"])
        n = len(replicas)
        cap = max(1, n * self._cfg.max_queue)
        return {
            "replicas": n,
            "queue_depth": depth,
            "queue_frac": depth / cap,
            "p99_ms": p99,
            "sheds": sheds,
            "requests": requests,
        }

    def merged_stats(self) -> dict:
        """Replica batcher stats merged into the single-batcher shape
        ``ServingService.aggregate`` consumes, so a fleet model lands on
        the same surfaces as a single-path one."""
        with self._lock:
            replicas = list(self._replicas)
            retired = {
                key: (dict(val) if isinstance(val, dict) else val)
                for key, val in self._retired.items()
            }
            sheds = self.sheds
        merged = {
            "requests": retired["requests"], "rows": retired["rows"],
            "batches": retired["batches"],
            "paddedRows": retired["paddedRows"],
            # Client-visible 429s only.
            "overflows": sheds, "queueDepth": 0,
            "maxBatch": self._cfg.max_batch,
            "maxQueue": self._cfg.max_queue,
            "flushMs": self._cfg.flush_ms,
            "replicas": len(replicas),
        }
        occ_weighted = retired["occ_weighted"]
        buckets: dict[str, int] = retired["buckets"]
        lat = {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        for r in replicas:
            stats = r.batcher.stats()
            for key in ("requests", "rows", "batches", "paddedRows",
                        "queueDepth"):
                merged[key] += stats[key]
            occ_weighted += stats["batchOccupancy"] * stats["batches"]
            for b, count in stats["bucketHistogram"].items():
                buckets[b] = buckets.get(b, 0) + count
            for q in lat:
                lat[q] = max(lat[q], stats["latencyMs"][q])
        merged["batchOccupancy"] = round(
            occ_weighted / merged["batches"], 4
        ) if merged["batches"] else 0.0
        merged["bucketHistogram"] = dict(sorted(buckets.items()))
        merged["latencyMs"] = lat
        return merged

    def placements(self) -> dict:
        with self._lock:
            return {
                r.idx: (r.device_id or "host") for r in self._replicas
            }

    def status(self) -> dict:
        replicas = self.replicas()
        return {
            "model": self.name,
            "replicas": [r.status() for r in replicas],
            "size": len(replicas),
            "min": self.min_replicas,
            "max": self.max_replicas,
            "devicesPerReplica": self.devices_per_replica,
            "scaleUps": self.scale_ups,
            "scaleDowns": self.scale_downs,
        }

    def close(self) -> None:
        """Tear the whole set down (unload, invalidation, shutdown):
        drain every batcher, release every card."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            replicas = self._replicas
            self._replicas = []
        # Signal every batcher first so the drains overlap.
        pres = []
        for r in replicas:
            pres.append(r.batcher.stats())
            self.absorb_stats(pres[-1])
            r.batcher.close(join=False)
        for r, pre in zip(replicas, pres):
            self._retire(r, "close", pre)
