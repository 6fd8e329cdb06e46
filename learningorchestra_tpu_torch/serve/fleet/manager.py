"""FleetManager — per-model ReplicaSets + the shared autoscaler — port
of ``learningorchestra_tpu/serve/fleet/manager.py``.

The glue between the serving service and the fleet: one
:class:`~learningorchestra_tpu_torch.serve.fleet.replicaset.ReplicaSet`
per fleet-served model, the per-model min/max bounds (set over REST,
surviving artifact invalidation so a re-trained model comes back at its
configured scale), and the one
:class:`~learningorchestra_tpu_torch.serve.fleet.autoscaler.Autoscaler`
thread, started the first time any model can scale (max > 1): a default
single-replica deployment runs no extra thread and ``predict`` pays one
dict lookup.

Fleet routing engages per model: the deployment-wide default
(``LO_TPU_FLEET_MAX > 1`` fleets every served model) or a per-model
``POST /serve/<model>/replicas``.  Invalidation, eviction and unload
flow through ``drop()``: the set drains and releases its cards; the
bounds survive unless the unload was explicit.  The leaser is read from
the serving service at each ``ensure``, so replacing the context's
leaser after boot takes effect for the next replica set.
"""

from __future__ import annotations

import threading
import time

from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.serve.batcher import BatcherClosed
from learningorchestra_tpu_torch.serve.fleet.autoscaler import Autoscaler
from learningorchestra_tpu_torch.serve.fleet.replicaset import (
    ReplicaSet,
    _stats_delta,
)


class FleetManager:
    def __init__(self, service):
        self.service = service
        self.cfg = service.fleet_cfg
        self._sets: dict[str, ReplicaSet] = {}
        # Per-model replica bounds.  Value semantics: a (min, max)
        # tuple is an explicit fleet opt-in; None is an explicit
        # OPT-OUT (a dissolved model stays single-path even when the
        # deployment default LO_TPU_FLEET_MAX would fleet it); an
        # absent key falls back to the deployment default.
        self._bounds: dict[str, tuple[int, int] | None] = {}
        # Per-model cards-per-replica overrides (POST body
        # ``devicesPerReplica``); absent falls back to the deployment
        # default LO_TPU_FLEET_DEVICES_PER_REPLICA.  Fixed while a set
        # is live — changing the shard width means re-placing every
        # replica, so configure() rejects it until a dissolve.
        self._shards: dict[str, int] = {}
        self._lock = make_lock("FleetManager._lock")
        # Per-model creation coalescing (the ModelRegistry idiom): a
        # set is only REGISTERED once its first replica is placed, so
        # concurrent predicts during the (possibly seconds-long) lease
        # wait park on the creator's event instead of finding an
        # empty set and shedding 429.
        self._creating: dict[str, threading.Event] = {}
        # Names whose in-flight creation a concurrent dissolve/drop
        # cancelled: the creator must NOT register its set (it would
        # resurrect a fleet the operator just tore down, card lease
        # and all).  Entries live only while a creation is in flight.
        self._cancel_create: set[str] = set()
        # model -> monotonic deadline of a placement-failure cooldown:
        # while it runs, routing_set sends traffic straight to the
        # single-path batcher instead of serializing every predict
        # through a doomed lease_timeout_s wait against an exhausted
        # card pool.  Explicit POSTs bypass it (configure -> ensure).
        self._cooldown: dict[str, float] = {}
        # model -> [scale_ups, scale_downs] accumulated from CLOSED
        # sets, so the counter-typed scale-events exposition survives
        # dissolve/invalidation instead of resetting mid-series.
        # Pruned with the bounds lifecycle (explicit unload/deletion
        # forgets the model entirely) — bounded by configured models.
        self._scale_totals: dict[str, list] = {}
        self._closed = False
        self.autoscaler = Autoscaler(self, self.cfg)

    # -- the predict hot path ------------------------------------------------

    def routing_set(self, name: str) -> ReplicaSet | None:
        """The set to route ``name`` through, or None for the classic
        single-batcher path.  One GIL-atomic dict read when fleet
        serving is not in play — the disabled path's whole cost."""
        rs = self._sets.get(name)
        if rs is not None:
            return rs
        if self._mode(name) is None:
            return None
        if time.monotonic() < self._cooldown.get(name, 0.0):
            return None  # recent placement failure: stay single-path
        return self.ensure(name)

    def registered_set(self, name: str) -> ReplicaSet | None:
        """An already-live set only — never creates.  The predict
        path's LeaseTimeout fallback uses this: a PARTIAL cutover
        registers a routable set before re-raising, and that set must
        serve the triggering request rather than a spurious 503."""
        return self._sets.get(name)

    def _mode(self, name: str) -> tuple[int, int] | None:
        """The bounds ``name`` serves under: a tuple means fleet,
        None means single-path (explicit opt-out, or deployment
        defaults that don't fleet)."""
        if name in self._bounds:
            return self._bounds[name]
        if self.cfg.max_replicas > 1:
            return (self.cfg.min_replicas, self.cfg.max_replicas)
        return None

    def engaged(self, name: str) -> bool:
        """True once ``name`` is (or is becoming) fleet-served — the
        single-path batcher must not be (re)created past this point:
        a predict racing fleet creation would otherwise resurrect the
        just-dropped batcher, leak its worker thread, and serve that
        one request off-fleet.

        Exception: during a placement-failure COOLDOWN a fleet-bound
        model with no set is allowed its single-path batcher — a
        model that never served before must not go dark just because
        the card pool is exhausted; when a replica finally places,
        the cutover retires that batcher and carries its counters."""
        if name in self._sets or name in self._creating:
            return True
        if self._mode(name) is None:
            return False
        return time.monotonic() >= self._cooldown.get(name, 0.0)

    def ensure(self, name: str, *,
               bypass_cooldown: bool = False) -> ReplicaSet | None:
        """The model's ReplicaSet, created at its min scale on first
        need (first routed predict, or a bounds POST).

        One creator per model at a time; the others wait and re-check.
        The set enters ``_sets`` only AFTER its first replica is
        placed, so no predict can ever observe a zero-replica set —
        and a failed placement (LeaseTimeout) registers nothing AND
        leaves the single-path batcher un-retired, so the model keeps
        serving on it (predict catches the LeaseTimeout and degrades)
        while later requests re-attempt the lease."""
        while True:
            rs = self._sets.get(name)
            if rs is not None:
                return rs
            if not bypass_cooldown and time.monotonic() < (
                self._cooldown.get(name, 0.0)
            ):
                # The creator we waited on just failed its lease: the
                # whole burst degrades to the single-path batcher at
                # once — waiters must not each become the next creator
                # and serially re-pay a doomed lease_timeout_s wait.
                # (Explicit POSTs bypass: the operator asked.)
                return None
            with self._lock:
                if self._closed:
                    return None
                rs = self._sets.get(name)
                if rs is not None:
                    return rs
                pending = self._creating.get(name)
                if pending is None:
                    pending = self._creating[name] = threading.Event()
                    break
            pending.wait(self.cfg.lease_timeout_s + 1.0)
        try:
            with self._lock:
                mode = self._mode(name)
            if mode is None:
                # Dissolved between the routing check and here: the
                # model stays on the classic path.
                return None
            mn, mx = mode
            rs = ReplicaSet(
                name,
                self.service.cfg,
                # Read NOW, not at construction: a test or an operator
                # may swap the context's leaser after the server is up.
                self.service.leaser(),
                self.service.replica_dispatch_factory(name),
                min_replicas=mn,
                max_replicas=mx,
                lease_timeout_s=self.cfg.lease_timeout_s,
                router_seed=self.cfg.router_seed,
                devices_per_replica=self.devices_per_replica(name),
                # getattr: test stubs provide only the dispatch seam.
                warmup=(
                    self.service.replica_warmup_factory(name)
                    if hasattr(self.service, "replica_warmup_factory")
                    else None
                ),
            )
            try:
                rs.scale_to(rs.min_replicas, reason="ensure")
            except BaseException:
                if rs.size == 0:
                    # Nothing placed: the single-path batcher was
                    # never touched, so the model keeps serving
                    # exactly as before this failed cutover.  Arm the
                    # cooldown so routed predicts stop paying a
                    # doomed lease wait each until the pool recovers.
                    with self._lock:
                        self._cooldown[name] = (
                            time.monotonic()
                            + self.cfg.lease_timeout_s
                        )
                    rs.close()
                    raise
                # Partially placed (min > 1, later leases timed out):
                # it can serve — cut over and let the autoscaler heal
                # it up to min; the CALLER still sees the error.
                self._finish_cutover(name, rs)
                raise
            if self._finish_cutover(name, rs) is None:
                return None
        finally:
            with self._lock:
                ev = self._creating.pop(name, None)
                self._cancel_create.discard(name)
            if ev is not None:
                ev.set()
        return rs

    def _finish_cutover(self, name: str,
                        rs: ReplicaSet) -> ReplicaSet | None:
        """The replica set is live: register it, THEN retire the
        single-path batcher (folding its lifetime counters into the
        set so per-model serving counters never reset mid-series),
        mirror placements, and start the autoscaler if this set can
        scale (routing_set's fast path never re-enters ensure for a
        registered set, so skipping the start here would freeze the
        set at its current size forever).  Returns None — set closed,
        cards released — when the manager shut down or a concurrent
        dissolve/drop cancelled this creation."""
        # Detach the single-path batcher and absorb its counters
        # BEFORE the set becomes visible: an autoscaler tick landing
        # between registration and absorb would baseline the model's
        # sheds at zero and later read the carried historical 429s as
        # fresh saturation.
        old = self.service.pop_single_path(name)
        pre = None
        if old is not None:
            pre = old.stats()
            rs.absorb_stats(pre, overflows_were_sheds=True)
        with self._lock:
            cancelled = (
                self._closed or name in self._cancel_create
            )
            self._cancel_create.discard(name)
            if not cancelled:
                self._sets[name] = rs
                self._cooldown.pop(name, None)
        if cancelled:
            rs.close()
            if old is not None:
                old.close()
            return None
        if old is not None:
            # Drain AFTER registration — predicts already route onto
            # the replicas — then fold in whatever the drain flushed.
            old.close()
            rs.absorb_stats(
                _stats_delta(old.stats(), pre),
                overflows_were_sheds=True,
            )
        self._record_placements(name, rs)
        if rs.max_replicas > 1:
            self._maybe_start_autoscaler()
        return rs

    # -- control surface -----------------------------------------------------

    def devices_per_replica(self, name: str) -> int:
        """Chips each of ``name``'s replicas leases: the per-model
        override, else the deployment default."""
        with self._lock:
            override = self._shards.get(name)
        if override is not None:
            return override
        return max(1, int(getattr(
            self.cfg, "devices_per_replica", 1
        )))

    def configure(self, name: str, *, min_replicas=None,
                  max_replicas=None, count=None,
                  devices_per_replica=None) -> dict:
        """The POST /serve/<model>/replicas body: set bounds and/or a
        manual replica count (clamped to the bounds).  Pins the model
        resident — a bad name 404s here, before any card is leased."""
        from learningorchestra_tpu_torch.services.context import (
            ValidationError,
        )

        with self._lock:
            cur = self._bounds.get(name) or (
                self.cfg.min_replicas, self.cfg.max_replicas
            )
        mn = cur[0] if min_replicas is None else int(min_replicas)
        mx = cur[1] if max_replicas is None else int(max_replicas)
        if not 1 <= mn <= mx:
            raise ValidationError(
                f"replica bounds need 1 <= min <= max, got "
                f"min={mn} max={mx}"
            )
        if count is not None and int(count) < 1:
            raise ValidationError(
                f"replica count must be >= 1, got {count}"
            )
        if devices_per_replica is not None:
            dpr = int(devices_per_replica)
            if dpr < 1:
                raise ValidationError(
                    "devicesPerReplica must be >= 1, got "
                    f"{devices_per_replica}"
                )
            with self._lock:
                live = self._sets.get(name)
                if (live is not None
                        and live.devices_per_replica != dpr):
                    raise ValidationError(
                        "devicesPerReplica is fixed while a replica "
                        f"set is live ({live.devices_per_replica}); "
                        "dissolve the fleet first"
                    )
                self._shards[name] = dpr
        self.service.registry.get(name)  # 404 before leasing anything
        with self._lock:
            self._bounds[name] = (mn, mx)
            rs = self._sets.get(name)
        if rs is None:
            rs = self.ensure(name, bypass_cooldown=True)
        if rs is not None:
            # Unconditionally: ensure() may hand back a set a racing
            # creator built from STALE bounds (read before ours were
            # stored) — its live bounds must match what this request
            # just configured.
            rs.set_bounds(mn, mx)
        if rs is None:
            # Raced service shutdown: retriable (429 + Retry-After),
            # the client's failover repoint lands somewhere alive.
            raise BatcherClosed("fleet manager is shut down; retry")
        target = int(count) if count is not None else rs.size
        rs.scale_to(target, reason="manual")
        self._record_placements(name, rs)
        if mx > 1:
            self._maybe_start_autoscaler()
        return self.status_for(name)

    def scale(self, name: str, n: int, *, reason: str) -> int:
        """The autoscaler's entry: scale an existing set (a dropped
        model is simply skipped — its streaks die with it)."""
        rs = self._sets.get(name)
        if rs is None:
            return 0
        result = rs.scale_to(n, reason=reason)
        self._record_placements(name, rs)
        return result

    def dissolve(self, name: str) -> bool:
        """Return a model to classic single-path serving WITHOUT
        unloading it: drain its replica set, release the cards, and
        pin an explicit opt-out so deployment-wide fleet defaults
        don't re-fleet it on the next predict — the remediation for
        'tried fleet serving, want the cards back'."""
        with self._lock:
            rs = self._sets.pop(name, None)
            if name in self._creating:
                # An in-flight creator must not register its set
                # after this teardown (it would resurrect the fleet,
                # card lease and all).
                self._cancel_create.add(name)
            # The opt-out entry is stored only when there is a fleet
            # involvement to opt out OF — unconditionally recording
            # every name ever DELETEd would grow _bounds (and the
            # /serve/fleet bounds map) without bound.
            if rs is not None or name in self._bounds or (
                name in self._creating
                or (self.cfg.max_replicas > 1
                    and self.service.registry.peek(name) is not None)
            ):
                self._bounds[name] = None
        self.autoscaler.forget(name)
        if rs is not None:
            self._accumulate_scale_totals(name, rs)
            rs.close()
            entry = self.service.registry.peek(name)
            if entry is not None:
                # The cards just went back to the pool; a residency
                # listing must not keep advertising them.
                entry.replica_devices = {}
        return rs is not None

    def drop(self, name: str, *, keep_bounds: bool) -> bool:
        """Dissolve a model's fleet: drain batchers, release cards.
        ``keep_bounds=True`` (artifact invalidation / LRU eviction)
        lets the next predict rebuild at the configured scale;
        ``False`` (explicit unload) forgets the model entirely."""
        with self._lock:
            rs = self._sets.pop(name, None)
            if name in self._creating:
                # An in-flight creator's set must not outlive this
                # teardown (an unloaded model would come back
                # fleet-served, holding a card).
                self._cancel_create.add(name)
            if not keep_bounds:
                self._bounds.pop(name, None)
                self._shards.pop(name, None)
                self._scale_totals.pop(name, None)
        self.autoscaler.forget(name)
        if rs is not None:
            if keep_bounds:
                self._accumulate_scale_totals(name, rs)
            rs.close()
        return rs is not None

    def _accumulate_scale_totals(self, name: str,
                                 rs: ReplicaSet) -> None:
        """Carry a closing set's scale-event counts so the exported
        counter series survives the set (a counter that vanishes or
        resets mid-series breaks rate() alerts)."""
        with self._lock:
            totals = self._scale_totals.setdefault(name, [0, 0])
            totals[0] += rs.scale_ups
            totals[1] += rs.scale_downs

    def sets_snapshot(self) -> list:
        with self._lock:
            return list(self._sets.items())

    def _maybe_start_autoscaler(self) -> None:
        if self.cfg.enabled and not self._closed:
            self.autoscaler.start()

    def _record_placements(self, name: str, rs: ReplicaSet) -> None:
        """Mirror the set's replica→device map onto the registry
        entry, so residency listings show WHERE each model serves."""
        entry = self.service.registry.peek(name)
        if entry is not None:
            entry.replica_devices = rs.placements()

    # -- observability -------------------------------------------------------

    def status_for(self, name: str) -> dict:
        with self._lock:
            rs = self._sets.get(name)
            bounds = self._bounds.get(name)
        if rs is not None:
            return rs.status()
        if bounds is None:
            return {}
        return {
            "model": name, "replicas": [], "size": 0,
            "min": bounds[0], "max": bounds[1],
            "devicesPerReplica": self.devices_per_replica(name),
            "scaleUps": 0, "scaleDowns": 0,
        }

    def snapshot(self) -> dict:
        with self._lock:
            sets = list(self._sets.values())
            bounds = dict(self._bounds)
            scale_totals = {
                name: list(t) for name, t in self._scale_totals.items()
            }
        for rs in sets:
            totals = scale_totals.setdefault(rs.name, [0, 0])
            totals[0] += rs.scale_ups
            totals[1] += rs.scale_downs
        return {
            "models": {rs.name: rs.status() for rs in sets},
            "scaleTotals": {
                name: {"up": t[0], "down": t[1]}
                for name, t in scale_totals.items()
            },
            "bounds": {
                name: (
                    {"min": b[0], "max": b[1]} if b is not None
                    else {"singlePath": True}
                )
                for name, b in bounds.items()
            },
            "defaults": {
                "min": self.cfg.min_replicas,
                "max": self.cfg.max_replicas,
            },
            "autoscaler": self.autoscaler.status(),
        }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sets = list(self._sets.values())
            self._sets.clear()
        self.autoscaler.stop()
        for rs in sets:
            rs.close()
