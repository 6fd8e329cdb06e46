"""The port's fleet tier (serve/fleet/) on the CPU, held against the JAX
package's: the P2C router's candidate orders for the same seeds and
depths, the autoscaler's decisions and ledger on one scripted signal
schedule, and ``tests/test_fleet.py``'s lifecycle cases on injected
device pools (``cuda:k`` ids resolve to no card here, so replicas run
unplaced, as the JAX tests' ``tpu:k`` ids do on the CPU).  The drills
slow dispatch with an armed ``serve.apply`` delay, as the JAX ones do.
Also: the kernels' launch counters count exactly from many threads, and
``Replica.place``'s three placements.
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from learningorchestra_tpu.config import FleetConfig as JaxFleetConfig
from learningorchestra_tpu.jobs.leases import LeaseTimeout as JaxLeaseTimeout
from learningorchestra_tpu.serve.fleet import Autoscaler as JaxAutoscaler
from learningorchestra_tpu.serve.fleet import P2CRouter as JaxRouter
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.config import Config, FleetConfig, ServeConfig
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser, LeaseTimeout
from learningorchestra_tpu_torch.ops import attention, quant
from learningorchestra_tpu_torch.serve.batcher import QueueFull
from learningorchestra_tpu_torch.serve.fleet import (
    Autoscaler,
    FleetManager,
    P2CRouter,
    Replica,
    ReplicaSet,
)
from learningorchestra_tpu_torch.serve.service import ServingService
from learningorchestra_tpu_torch.store.volumes import VolumeStorage


def _stub_set(n_devices=3, dispatch=None, *, min_replicas=1,
              max_replicas=3, max_batch=8, max_queue=64, flush_ms=1.0,
              devices_per_replica=1):
    """ReplicaSet over an injected pool with a stub dispatch: real
    routing, scaling and leasing, no model."""
    leaser = DeviceLeaser([f"cuda:{i}" for i in range(n_devices)])
    cfg = ServeConfig(max_batch=max_batch, max_queue=max_queue,
                      flush_ms=flush_ms)
    fn = dispatch or (lambda padded: padded)
    rs = ReplicaSet("m", cfg, leaser, lambda replica: fn,
                    min_replicas=min_replicas, max_replicas=max_replicas,
                    devices_per_replica=devices_per_replica)
    rs.scale_to(min_replicas, reason="ensure")  # what ensure() does
    return rs, leaser


class _StubManager:
    """The slice of FleetManager the Autoscaler consumes."""

    def __init__(self, rs):
        self.rs = rs

    def sets_snapshot(self):
        return [(self.rs.name, self.rs)]

    def scale(self, name, n, *, reason):
        return self.rs.scale_to(n, reason=reason)


def _fleet_cfg(**kw):
    kw.setdefault("interval_s", 0.0)  # manual tick()
    kw.setdefault("up_queue_frac", 0.1)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 2)
    return FleetConfig(**kw)


# -- router ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_router_candidate_orders_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jax_router, port_router = JaxRouter(seed), P2CRouter(seed)
    for _ in range(300):
        depths = rng.integers(0, 4, int(rng.integers(0, 7))).tolist()
        assert port_router.choose(depths) == jax_router.choose(depths), \
            depths


class TestP2CRouter:
    def test_single_replica_shortcut(self):
        assert P2CRouter(seed=0).choose([7]) == [0]
        assert P2CRouter(seed=0).choose([]) == []

    def test_pair_picks_shallower_queue(self):
        router = P2CRouter(seed=0)
        assert router.choose([5, 0]) == [1, 0]
        assert router.choose([0, 5]) == [0, 1]

    def test_candidate_order_covers_every_replica(self):
        router = P2CRouter(seed=1)
        for depths in ([3, 1, 4, 1, 5], [0, 0, 0]):
            assert sorted(router.choose(depths)) == list(range(len(depths)))

    def test_skew_bound_under_uniform_load(self):
        """Seeded P2C over idle replicas spreads near-uniformly: each of
        3 replicas takes at least 20 % of 600 sequential requests."""
        rs, _ = _stub_set(flush_ms=0.0)
        try:
            rs.scale_to(3)
            row = np.ones((1, 2), np.float32)
            for _ in range(600):
                rs.submit(row)
            counts = [r["requests"] for r in rs.status()["replicas"]]
            assert sum(counts) == 600
            assert min(counts) >= 120, counts
        finally:
            rs.close()


# -- autoscaler parity -------------------------------------------------------

#: (queue_depth, sheds, requests, p99_ms) per tick for two models; "a"
#: rises on queue depth, sheds, p99 and idles back down; "b" sits below
#: its min (healed), then hits a lease timeout on scale-up (blocked).
_SCHEDULE = {
    "a": [(80, 0, 10, 5.0), (90, 0, 20, 5.0), (10, 0, 30, 5.0),
          (0, 2, 40, 5.0), (0, 4, 40, 5.0), (0, 4, 45, 80.0),
          (0, 4, 50, 80.0), (0, 4, 50, 80.0), (0, 4, 50, 80.0),
          (0, 4, 50, 80.0), (0, 4, 50, 80.0), (0, 4, 50, 80.0),
          (0, 4, 50, 80.0), (30, 4, 60, 5.0)],
    "b": [(0, 0, 0, 0.0), (200, 0, 5, 1.0), (200, 1, 6, 1.0),
          (200, 3, 9, 1.0), (200, 3, 9, 1.0), (0, 3, 9, 1.0),
          (0, 3, 9, 1.0), (0, 3, 9, 1.0), (0, 3, 9, 1.0), (0, 3, 9, 1.0),
          (0, 3, 9, 1.0), (0, 3, 9, 1.0), (0, 3, 9, 1.0), (0, 3, 9, 1.0)],
}


class _ScriptedSet:
    """A replica set whose signals follow ``_SCHEDULE``; scaling moves
    its count, and model "b"'s second scale-up times out."""

    max_queue = 64

    def __init__(self, name, n, mn, mx, timeout_cls):
        self.name, self.n = name, n
        self.min_replicas, self.max_replicas = mn, mx
        self.tick = 0
        self.timeout_cls = timeout_cls
        self.ups = 0

    def signals(self):
        depth, sheds, requests, p99 = _SCHEDULE[self.name][self.tick]
        return {"replicas": self.n, "queue_depth": depth,
                "queue_frac": depth / (self.n * self.max_queue),
                "p99_ms": p99, "sheds": sheds, "requests": requests}

    def scale_to(self, n):
        if n > self.n:
            self.ups += 1
            if self.name == "b" and self.ups == 2:
                raise self.timeout_cls("no 1-device lease within 1000s")
        self.n = max(self.min_replicas, min(self.max_replicas, n))
        return self.n


class _ScriptedManager:
    def __init__(self, timeout_cls):
        self.sets = [_ScriptedSet("a", 1, 1, 4, timeout_cls),
                     _ScriptedSet("b", 1, 2, 4, timeout_cls)]

    def sets_snapshot(self):
        return [(rs.name, rs) for rs in self.sets]

    def scale(self, name, n, *, reason):
        return next(rs for rs in self.sets if rs.name == name).scale_to(n)

    def advance(self):
        for rs in self.sets:
            rs.tick += 1


def _drive(autoscaler_cls, cfg, timeout_cls):
    mgr = _ScriptedManager(timeout_cls)
    scaler = autoscaler_cls(mgr, cfg)
    for _ in range(len(_SCHEDULE["a"])):
        scaler.tick()
        mgr.advance()
    status = scaler.status()
    for key in ("decisions", "ledger"):
        for record in status[key]:
            record.pop("t")
    return status


def test_autoscaler_decisions_and_ledger_equal_jax():
    knobs = dict(interval_s=0.0, up_queue_frac=0.25, up_ticks=2,
                 down_ticks=3, up_p99_ms=50.0, lease_timeout_s=1000.0)
    port = _drive(Autoscaler, FleetConfig(**knobs), LeaseTimeout)
    ref = _drive(JaxAutoscaler, JaxFleetConfig(**knobs), JaxLeaseTimeout)
    assert port == ref
    # The schedule exercised every branch of the tick body.
    reasons = {(r["model"], r["action"], r["reason"])
               for r in port["ledger"]}
    assert {("a", "up", "queue"), ("a", "up", "shed"), ("a", "up", "p99"),
            ("a", "down", "idle"), ("b", "up", "min"),
            ("b", "blocked", "lease_timeout")} <= reasons, reasons
    assert any(r["blocked"] for r in port["ledger"])


class TestAutoscaler:
    def test_scale_up_on_sustained_queue_depth_under_slow_dispatch(self):
        """A fault-plane delay holds the replica's dispatch busy,
        sustained load builds queue depth, the controller scales 1 -> 2;
        when the load stops and the delay disarms, idle ticks drain back
        to 1 and the lease returns."""
        def dispatch(padded):
            faults.hit("serve.apply")  # the real dispatch's probe
            return padded

        rs, leaser = _stub_set(dispatch=dispatch, max_batch=2,
                               max_queue=32, flush_ms=0.5)
        scaler = Autoscaler(_StubManager(rs), _fleet_cfg())
        stop = threading.Event()
        row = np.zeros((1, 1), np.float32)
        faults.arm("serve.apply", "delay", delay_ms=40)

        def load():
            while not stop.is_set():
                try:
                    rs.submit(row)
                except QueueFull:
                    time.sleep(0.01)

        threads = [threading.Thread(target=load, daemon=True)
                   for _ in range(8)]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 15
            while rs.size < 2 and time.monotonic() < deadline:
                scaler.tick()
                time.sleep(0.05)
            assert rs.size >= 2
            decisions = scaler.status()["decisions"]
            assert decisions and decisions[0]["signal"] in ("queue", "shed")
            assert len(leaser.snapshot()["free"]) <= 1
            assert faults.triggers("serve.apply") > 0
            stop.set()
            for t in threads:
                t.join(10)
            faults.disarm("serve.apply")
            deadline = time.monotonic() + 15
            while rs.size > 1 and time.monotonic() < deadline:
                scaler.tick()
                time.sleep(0.02)
            assert rs.size == 1
            assert len(leaser.snapshot()["free"]) == 2
        finally:
            faults.disarm_all()
            stop.set()
            for t in threads:
                t.join(10)
            rs.close()

    def test_shed_requests_count_as_up_signal(self):
        release = threading.Event()

        def dispatch(padded):
            release.wait(10)
            return padded

        rs, _ = _stub_set(dispatch=dispatch, max_batch=1, max_queue=1,
                          flush_ms=0.0)
        scaler = Autoscaler(_StubManager(rs), _fleet_cfg())
        threads = []
        try:
            row = np.zeros((1, 1), np.float32)
            for _ in range(2):
                t = threading.Thread(target=lambda: rs.submit(row),
                                     daemon=True)
                t.start()
                threads.append(t)
                time.sleep(0.2)
            scaler.tick()  # baseline
            with pytest.raises(QueueFull):
                rs.submit(row)  # the shed 429
            for _ in range(2):
                scaler.tick()
            assert rs.size == 2
            assert scaler.status()["decisions"][0]["signal"] == "shed"
        finally:
            release.set()
            for t in threads:
                t.join(10)
            rs.close()

    def test_steady_load_does_not_scale_down(self):
        """'Idle' is no traffic since the last tick, not an empty queue
        at sample time."""
        rs, leaser = _stub_set(flush_ms=0.0)
        scaler = Autoscaler(_StubManager(rs), _fleet_cfg())
        try:
            rs.scale_to(2)
            row = np.zeros((1, 1), np.float32)
            for _ in range(3 * scaler.cfg.down_ticks):
                rs.submit(row)
                assert rs.signals()["queue_depth"] == 0
                scaler.tick()
            assert rs.size == 2
            for _ in range(scaler.cfg.down_ticks):
                scaler.tick()
            assert rs.size == 1
            assert len(leaser.snapshot()["free"]) == 2
        finally:
            rs.close()

    def test_lease_timeout_skips_scale_up_and_survives(self):
        release = threading.Event()

        def dispatch(padded):
            release.wait(10)
            return padded

        rs, _ = _stub_set(n_devices=1, dispatch=dispatch, max_batch=1,
                          max_queue=1, flush_ms=0.0)
        rs.lease_timeout_s = 0.05
        scaler = Autoscaler(_StubManager(rs), _fleet_cfg())
        threads = []
        try:
            row = np.zeros((1, 1), np.float32)
            for _ in range(2):
                t = threading.Thread(target=lambda: rs.submit(row),
                                     daemon=True)
                t.start()
                threads.append(t)
                time.sleep(0.2)
            for _ in range(4):
                scaler.tick()
            assert rs.size == 1  # no second card to scale onto
            assert scaler.status()["decisions"] == []
            assert scaler.status()["streaks"]["m"]["up"] >= 2
        finally:
            release.set()
            for t in threads:
                t.join(10)
            rs.close()

    def test_autoscaler_heals_below_min_without_sustain_window(self):
        rs, _ = _stub_set(min_replicas=1, max_replicas=3)
        rs.min_replicas = 2  # a partially placed ensure
        scaler = Autoscaler(_StubManager(rs), _fleet_cfg())
        try:
            decisions = scaler.tick()
            assert rs.size == 2
            assert decisions and decisions[0]["signal"] == "min"
            scaler.tick()
            assert scaler.status()["ticks"] == 2
        finally:
            rs.close()


# -- replica lifecycle and lease accounting ----------------------------------


class TestReplicaLifecycle:
    def test_scale_up_down_moves_card_leases(self):
        rs, leaser = _stub_set()
        try:
            assert rs.scale_to(1) == 1
            assert len(leaser.snapshot()["free"]) == 2
            assert rs.scale_to(3) == 3
            assert leaser.snapshot()["free"] == []
            # Newest first; the cards return.
            assert rs.scale_to(1, reason="test") == 1
            assert len(leaser.snapshot()["free"]) == 2
            assert rs.status()["replicas"][0]["replica"] == 0
        finally:
            rs.close()
        assert len(leaser.snapshot()["free"]) == 3

    def test_scale_clamps_to_bounds(self):
        rs, _ = _stub_set(min_replicas=1, max_replicas=2)
        try:
            assert rs.scale_to(5) == 2
            assert rs.scale_to(0) == 1
        finally:
            rs.close()

    def test_replica_devices_recorded_in_status(self):
        rs, _ = _stub_set()
        try:
            rs.scale_to(2)
            devices = {r["device"] for r in rs.status()["replicas"]}
            assert len(devices) == 2
            assert all(d.startswith("cuda:") for d in devices)
            assert set(rs.placements()) == {0, 1}
            # No card behind the ids here: the replicas run unplaced.
            assert all(r.cards is None for r in rs.replicas())
        finally:
            rs.close()

    def test_drain_before_unload_drops_no_inflight_predicts(self):
        def dispatch(padded):
            time.sleep(0.002 * padded.shape[0])
            return padded * 3.0

        rs, leaser = _stub_set(dispatch=dispatch, max_batch=4)
        errors, oks = [], []
        try:
            rs.scale_to(2)

            def client(i):
                row = np.full((1, 2), float(i), np.float32)
                try:
                    out, _replica = rs.submit(row)
                    np.testing.assert_array_equal(out, row * 3.0)
                    oks.append(i)
                except Exception as exc:  # noqa: BLE001 — the assert
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(24)]
            for t in threads:
                t.start()
            rs.scale_to(1, reason="drain-test")
            for t in threads:
                t.join(20)
            assert not errors
            assert len(oks) == 24
            assert len(leaser.snapshot()["free"]) == 2
        finally:
            rs.close()

    def test_429_only_when_every_replica_saturated(self):
        release = threading.Event()

        def dispatch(padded):
            release.wait(15)
            return padded

        rs, _ = _stub_set(dispatch=dispatch, max_batch=1, max_queue=1,
                          flush_ms=0.0)
        threads, errors = [], []
        try:
            rs.scale_to(2)
            row = np.zeros((1, 1), np.float32)

            def submit():
                try:
                    rs.submit(row)
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)

            # Wave 1 lands in the blocked workers, wave 2 fills both
            # 1-row queues.
            for _ in range(2):
                pair = [threading.Thread(target=submit, daemon=True)
                        for _ in range(2)]
                threads += pair
                for t in pair:
                    t.start()
                time.sleep(0.3)
            with pytest.raises(QueueFull):
                rs.submit(row)
            assert rs.signals()["sheds"] == 1
        finally:
            release.set()
            for t in threads:
                t.join(10)
            rs.close()
        assert not errors

    def test_partial_overflow_is_not_replayed_elsewhere(self):
        """A request whose first chunks queued on one replica and whose
        later chunk overflowed sheds at once: replaying it on the other
        replica would duplicate the queued work."""
        release = threading.Event()

        def dispatch(padded):
            release.wait(15)
            return padded

        rs, _ = _stub_set(dispatch=dispatch, max_batch=1, max_queue=1,
                          flush_ms=0.0)
        try:
            rs.scale_to(2)
            with pytest.raises(QueueFull) as exc:
                rs.submit(np.zeros((3, 1), np.float32))  # 3 chunks of 1
            assert getattr(exc.value, "partial", False)
            counts = sorted(r["requests"] for r in rs.status()["replicas"])
            assert counts[0] == 0 and counts[1] >= 1  # one replica only
            assert rs.signals()["sheds"] == 1
        finally:
            release.set()
            rs.close()

    def test_multi_device_replica_on_unresolved_slice_is_accepted(self):
        rs, leaser = _stub_set(n_devices=4, devices_per_replica=2)
        try:
            assert rs.scale_to(2) == 2
            assert leaser.snapshot()["free"] == []
            assert all(len(r["devices"]) == 2
                       for r in rs.status()["replicas"])
            out, _ = rs.submit(np.ones((1, 2), np.float32))
            assert out.shape == (1, 2)
        finally:
            rs.close()
        assert len(leaser.snapshot()["free"]) == 4

    def test_cumulative_counters_survive_scale_down(self):
        rs, _ = _stub_set(flush_ms=0.0)
        try:
            rs.scale_to(3)
            row = np.ones((1, 2), np.float32)
            for _ in range(60):
                rs.submit(row)
            assert rs.signals()["requests"] == 60
            rs.scale_to(1)
            assert rs.signals()["requests"] == 60
            merged = rs.merged_stats()
            assert merged["requests"] == 60 and merged["rows"] == 60
        finally:
            rs.close()

    def test_scale_re_clamps_against_live_bounds(self):
        rs, leaser = _stub_set(min_replicas=1, max_replicas=3)
        try:
            assert rs.scale_to(3) == 3
            rs.set_bounds(1, 2)
            assert rs.scale_to(3) == 2
            assert len(leaser.snapshot()["free"]) == 1
        finally:
            rs.close()


class TestReplicaPlacement:
    """``Replica.place`` on a resident entry: unplaced and same-card
    replicas share the resident module; another card gets one copy per
    registry entry."""

    @staticmethod
    def _entry():
        module = torch.nn.Linear(2, 2)
        return types.SimpleNamespace(
            estimator=types.SimpleNamespace(module=module))

    def test_unresolved_lease_shares_the_resident_module(self):
        entry = self._entry()
        replica = Replica("m", 0, types.SimpleNamespace(
            devices=["cuda:7"], release=lambda: None))
        assert replica.cards is None
        assert replica.place(entry) is entry.estimator.module

    def test_same_card_shares_and_other_card_copies_per_entry(self):
        entry = self._entry()
        replica = Replica("m", 0, None)
        replica.cards = [torch.device("cpu")]  # the resident module's
        assert replica.place(entry) is entry.estimator.module
        replica.cards = [torch.device("meta")]  # another device
        placed = replica.place(entry)
        assert placed is not entry.estimator.module
        assert placed.weight.device.type == "meta"
        assert replica.place(entry) is placed  # cached
        fresh = self._entry()  # an invalidated artifact's new entry
        assert replica.place(fresh) is not placed


# -- the manager over a stub service -----------------------------------------


def _manager(leaser, fleet_cfg):
    """FleetManager over a stub service: real manager and replica code,
    no model registry."""
    service = types.SimpleNamespace(
        fleet_cfg=fleet_cfg,
        leaser=lambda: leaser,
        cfg=ServeConfig(max_batch=4, max_queue=16, flush_ms=0.5),
        registry=types.SimpleNamespace(peek=lambda name: None),
        replica_dispatch_factory=lambda name: (
            lambda replica: (lambda padded: padded)),
        pop_single_path=lambda name: None,
    )
    return FleetManager(service)


def test_failed_ensure_does_not_register_a_dead_set():
    """A LeaseTimeout in ensure()'s first scale registers nothing, arms
    a cooldown (routed predicts go single-path), and the next request
    after it places the set."""
    leaser = DeviceLeaser(["cuda:0"])
    mgr = _manager(leaser, _fleet_cfg(max_replicas=3, lease_timeout_s=1.0))
    mgr._bounds["m"] = (1, 3)
    hog = leaser.acquire(1, label="training-hog")
    try:
        with pytest.raises(LeaseTimeout):
            mgr.routing_set("m")
        assert mgr.sets_snapshot() == []
    finally:
        hog.release()
    assert mgr.routing_set("m") is None  # cooldown: single path
    time.sleep(1.1)
    rs = mgr.routing_set("m")
    assert rs is not None and rs.size == 1
    out, _replica = rs.submit(np.ones((1, 2), np.float32))
    assert out.shape == (1, 2)
    mgr.close()
    assert leaser.snapshot()["free"] == ["cuda:0"]


def test_manager_reads_the_leaser_at_ensure():
    """The pool is read when a set is created, so swapping the service's
    leaser after boot places the next set on the new pool."""
    pools = {"now": DeviceLeaser(["cuda:0"])}
    mgr = _manager(None, _fleet_cfg(max_replicas=2))
    mgr.service.leaser = lambda: pools["now"]
    pools["now"] = DeviceLeaser(["cuda:5", "cuda:6"])
    mgr._bounds["m"] = (2, 2)
    try:
        rs = mgr.routing_set("m")
        assert sorted(rs.placements().values()) == ["cuda:5", "cuda:6"]
    finally:
        mgr.close()


class TestFleetConfigAtBoot:
    def test_bad_fleet_bounds_fail_at_boot(self, monkeypatch):
        monkeypatch.setenv("LO_TPU_FLEET_MIN", "0")
        monkeypatch.setenv("LO_TPU_FLEET_MAX", "2")
        with pytest.raises(ValueError, match="LO_TPU_FLEET_MIN"):
            Config.from_env()
        monkeypatch.setenv("LO_TPU_FLEET_MIN", "3")
        with pytest.raises(ValueError, match="LO_TPU_FLEET_MIN"):
            Config.from_env()
        monkeypatch.setenv("LO_TPU_FLEET_MIN", "1")
        cfg = Config.from_env()
        assert cfg.fleet.max_replicas == 2 and cfg.fleet.min_replicas == 1

    @pytest.mark.parametrize("key,value,names", [
        ("LO_TPU_FLEET_UP_SLOPE", "0.5", "A.11"),
    ])
    def test_unported_triggers_are_refused_at_boot(self, monkeypatch,
                                                    tmp_path, key, value,
                                                    names):
        """The queue-slope trigger was refused while its source, the
        rollup series, waited for ``names`` (ROADMAP A.11); now it boots
        from the environment and from a config built in code, and the
        autoscaler reports it."""
        monkeypatch.setenv(key, value)
        assert Config.from_env().fleet.up_slope == float(value), names
        fleet = FleetConfig()
        setattr(fleet, key.removeprefix("LO_TPU_FLEET_").lower(),
                float(value))
        svc = ServingService(VolumeStorage(tmp_path), fleet_config=fleet,
                             device="cpu")
        try:
            status = svc.fleet.snapshot()["autoscaler"]
            assert status["upSlope"] == float(value)
        finally:
            svc.close()

    def test_fleet_env_names_are_the_jax_ones(self, monkeypatch):
        env = {"LO_TPU_FLEET_ENABLED": "0", "LO_TPU_FLEET_MIN": "2",
               "LO_TPU_FLEET_MAX": "4", "LO_TPU_FLEET_INTERVAL_S": "0.5",
               "LO_TPU_FLEET_UP_QUEUE_FRAC": "0.3",
               "LO_TPU_FLEET_UP_TICKS": "3", "LO_TPU_FLEET_DOWN_TICKS": "7",
               "LO_TPU_FLEET_UP_P99_MS": "40",
               "LO_TPU_FLEET_LEASE_TIMEOUT_S": "9",
               "LO_TPU_FLEET_DEVICES_PER_REPLICA": "2",
               "LO_TPU_AOT_REPLICA_PREWARM": "1"}
        cfg = Config.from_env(env)
        f = cfg.fleet
        assert (f.enabled, f.min_replicas, f.max_replicas, f.interval_s,
                f.up_queue_frac, f.up_ticks, f.down_ticks, f.up_p99_ms,
                f.lease_timeout_s, f.devices_per_replica) == (
            False, 2, 4, 0.5, 0.3, 3, 7, 40.0, 9.0, 2)
        assert cfg.aot.replica_prewarm is True
        jax_defaults = JaxFleetConfig()
        assert {k: getattr(FleetConfig(), k) for k in vars(jax_defaults)} \
            == vars(jax_defaults)


# -- launch counters ---------------------------------------------------------


def test_launch_counters_count_exactly_from_many_threads(monkeypatch):
    """Replica batchers launch from several threads at once: the
    counters' locked increments lose nothing."""
    monkeypatch.setattr(attention, "launches", 0)
    monkeypatch.setattr(quant, "dequantize_launches", 0)
    monkeypatch.setattr(quant, "dequantize_leaves", 0)
    n_threads, per_thread = 8, 5000
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(per_thread):
            attention.count_launch("launches")
            quant.count_launch(dequantize_launches=1, dequantize_leaves=3)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * per_thread
    assert attention.launches == total
    assert quant.dequantize_launches == total
    assert quant.dequantize_leaves == 3 * total


# -- the serving service's fleet lifecycle -----------------------------------


def test_service_fleet_bounds_survive_invalidation_not_deletion(tmp_path):
    """Replica predicts answer the artifact's logits; an overwritten
    artifact comes back at its bounds, a deleted one forgets them, and an
    unload forgets them too."""
    from learningorchestra_tpu_torch.models.text import BertModel
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE

    vols = VolumeStorage(tmp_path)
    est = BertModel(vocab_size=20, hidden_dim=16, num_layers=1,
                    num_heads=2, max_len=8, seed=3, device="cpu")
    vols.save_object(ARTIFACT_TYPE, "m", est.to_artifact())
    leaser = DeviceLeaser(["cuda:0", "cuda:1"])
    svc = ServingService(vols, ServeConfig(flush_ms=0), device="cpu",
                         fleet_config=_fleet_cfg(), leaser=lambda: leaser)
    x = np.random.default_rng(0).integers(1, 20, (3, 8)).astype(np.int32)
    try:
        assert svc.fleet.configure("m", min_replicas=2,
                                   max_replicas=2)["size"] == 2
        out = svc.predict("m", x)
        assert out["replica"] in (0, 1) and out["device"].startswith("cuda:")
        np.testing.assert_allclose(out["predictions"], est.predict(x),
                                   atol=1e-6)
        assert svc.registry.peek("m").warm_shapes
        svc.invalidate("m")  # overwritten: the bounds stay
        assert leaser.snapshot()["free"] != []
        assert svc.predict("m", x)["replica"] in (0, 1)  # rebuilt at 2
        assert svc.fleet.status_for("m")["size"] == 2
        svc.invalidate("m", gone=True)  # deleted: forgotten
        assert svc.fleet.status_for("m") == {}
        assert "replica" not in svc.predict("m", x)
        svc.fleet.configure("m", min_replicas=1, max_replicas=2)
        assert svc.unload("m")
        assert not svc.fleet.engaged("m")
        assert len(leaser.snapshot()["free"]) == 2
    finally:
        svc.close()
    assert len(leaser.snapshot()["free"]) == 2
