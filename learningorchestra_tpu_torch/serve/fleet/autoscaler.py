"""Metrics-driven replica autoscaling — port of
``learningorchestra_tpu/serve/fleet/autoscaler.py``.

The control loop reads the fleet's saturation signals straight from the
batchers' own counters (queued rows, p99 latency, request and shed
counts) and turns sustained pressure into replicas instead of 429s:

- **scale up** when the fleet-wide queue fraction holds at or above
  ``FleetConfig.up_queue_frac`` for ``up_ticks`` consecutive ticks, when
  requests were SHED (a new 429 is saturation by definition), or when
  p99 crosses ``up_p99_ms`` (optional, gated on traffic this tick);
- **scale up** when a model's queued rows grow faster than
  ``up_slope`` rows/second, least-squares-fitted over the rollup series
  (obs/rollup.py) so a ramp scales before the queue fills;
- **scale down** after ``down_ticks`` consecutive ticks with no traffic,
  draining the victim's batcher before its card lease returns (a train
  job queued on the leaser gets the card back);
- **heal** a set below its minimum at once (a partial placement).

Sustain counts are the hysteresis, and a tick moves a model by at most
one replica.  The tick body, its ``decisions`` and its ``ledger`` (every
evaluation, holds included, with the signals and streaks it read) are
the JAX package's, key for key.  The device-time fraction
(``up_device_frac``) reads the model's attributed device seconds from the
cost plane (obs/costs.py) as the JAX loop does.

The loop is a daemon thread owned by the FleetManager, started only when
some model can scale (max > 1).  ``tick()`` is public and thread-safe so
tests drive the schedule without the thread.
"""

from __future__ import annotations

import collections
import threading
import time

from learningorchestra_tpu_torch.jobs.leases import LeaseTimeout
from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.obs import rollup as obs_rollup

logger = get_logger("fleet")


class Autoscaler:
    """Per-tick scale decisions over a FleetManager's replica sets."""

    def __init__(self, manager, cfg):
        self._manager = manager
        self.cfg = cfg
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # model -> {"up": streak, "down": streak, "overflows": last}
        self._state: dict[str, dict] = {}
        self.ticks = 0
        self.decisions: collections.deque = collections.deque(maxlen=64)
        # Decision LEDGER: every per-model evaluation — scale, hold,
        # blocked — with the signal values and sustain counters it
        # read (queue-frac, shed, p99).  ``decisions`` above keeps
        # only the scale events; drills could see THAT the fleet
        # moved but never WHY it held, so the ledger records the
        # holds too.  Bounded ring; served under GET /serve/fleet.
        self.ledger: collections.deque = collections.deque(maxlen=256)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None or self.cfg.interval_s <= 0:
                return
            self._thread = threading.Thread(
                target=self._run, name="fleet-autoscaler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                # any one tick's failure; a dead autoscaler is a fleet
                # silently frozen at its current size.
                logger.exception("autoscaler tick failed")

    # -- the control loop body -----------------------------------------------

    def tick(self) -> list[dict]:
        """One pass over every replica set; returns the decisions made
        (also appended to the rolling ``decisions`` history)."""
        made: list[dict] = []
        with self._lock:
            self.ticks += 1
        for name, rs in self._manager.sets_snapshot():
            sig = rs.signals()
            slope = self._queue_slope(name)
            dev_s = self._device_seconds(name)
            now_mono = time.monotonic()
            with self._lock:
                st = self._state.setdefault(
                    name, {"up": 0, "down": 0,
                           "sheds": sig["sheds"],
                           "requests": sig["requests"],
                           "dev_s": dev_s, "dev_t": now_mono}
                )
                shed = sig["sheds"] - st["sheds"]
                st["sheds"] = sig["sheds"]
                served = sig["requests"] - st.get(
                    "requests", sig["requests"]
                )
                st["requests"] = sig["requests"]
                # Cost-aware trigger: fraction of wall time this
                # model spent ON DEVICE since the last tick (decode
                # steps + serving dispatches, the obs/costs devtime
                # ledger).  Near 1.0 means the replica's card is
                # compute-bound even if its queue drains between
                # ticks — the saturation queue depth cannot see.
                dt = now_mono - st.get("dev_t", now_mono)
                device_frac = (
                    (dev_s - st.get("dev_s", dev_s)) / dt
                    if dt > 0 else 0.0
                )
                st["dev_s"] = dev_s
                st["dev_t"] = now_mono
                dev_sig = (
                    self.cfg.up_device_frac > 0
                    and device_frac >= self.cfg.up_device_frac
                )
                # Growth-slope trigger: the queue is RAMPING even if
                # its level is still under the frac threshold — the
                # rate-of-change controller the decision ledger's
                # signal history was recorded to justify.  Gated on
                # traffic this tick like p99 (a stale rollup window
                # must not scale an idle fleet).
                slope_sig = (
                    self.cfg.up_slope > 0 and slope is not None
                    and served > 0
                    and slope >= self.cfg.up_slope
                )
                up_sig = (
                    sig["queue_frac"] >= self.cfg.up_queue_frac
                    or shed > 0
                    # p99 comes from the batchers' rolling latency
                    # window, which FREEZES when traffic stops — gate
                    # it on traffic this tick, or a stale high p99
                    # would hold an idle fleet at max forever.
                    or (self.cfg.up_p99_ms > 0 and served > 0
                        and sig["p99_ms"] >= self.cfg.up_p99_ms)
                    or slope_sig
                    or dev_sig
                )
                # "Idle" means NO traffic since the last tick, not an
                # instantaneously empty queue: under steady load the
                # batchers flush between ticks and queue_depth samples
                # 0, and scaling down on that would drop a loaded
                # fleet to min, shed 429s for an up-sustain window,
                # scale back up, and oscillate.
                down_sig = (
                    sig["queue_depth"] == 0 and shed == 0
                    and served == 0
                )
                n = sig["replicas"]
                target, reason = n, ""
                # A recent LeaseTimeout means the card pool is
                # saturated: skip further scale-UP attempts for this
                # model until the block expires — each attempt costs
                # a full lease_timeout_s inside the tick, and a tick
                # wedged in doomed waits delays every OTHER model's
                # decisions (including the scale-downs that would
                # free the very cards being waited on).
                blocked = time.monotonic() < st.get(
                    "blocked_until", 0.0
                )
                if n < rs.min_replicas:
                    # Below min (a partially-placed ensure whose later
                    # leases timed out): heal toward min immediately —
                    # no sustain window, this is repair, not reaction.
                    if not blocked:
                        target, reason = n + 1, "min"
                elif up_sig and n < rs.max_replicas:
                    st["down"] = 0
                    st["up"] += 1
                    if st["up"] >= self.cfg.up_ticks and not blocked:
                        # The ledger must show the streak that
                        # TRIGGERED the move, not the post-reset 0.
                        triggered = st["up"]
                        st["up"] = 0
                        target = n + 1
                        reason = (
                            "shed" if shed > 0 else
                            "queue" if sig["queue_frac"]
                            >= self.cfg.up_queue_frac else
                            "p99" if (
                                self.cfg.up_p99_ms > 0
                                and sig["p99_ms"]
                                >= self.cfg.up_p99_ms
                            ) else
                            "slope" if slope_sig else "devtime"
                        )
                elif down_sig and n > rs.min_replicas:
                    st["up"] = 0
                    st["down"] += 1
                    if st["down"] >= self.cfg.down_ticks:
                        triggered = st["down"]
                        st["down"] = 0
                        target = n - 1
                        reason = "idle"
                else:
                    st["up"] = st["up"] if up_sig else 0
                    st["down"] = st["down"] if down_sig else 0
                up_streak, down_streak = st["up"], st["down"]
                if target > n and reason != "min":
                    up_streak = triggered
                elif target < n:
                    down_streak = triggered
            # Ledger entry for EVERY evaluation — the holds included:
            # a drill reading GET /serve/fleet can see exactly which
            # signal values and sustain counters produced (or
            # withheld) each move.
            record = {
                "t": time.time(),
                "tick": self.ticks,
                "model": name,
                "replicas": n,
                "queueFrac": round(sig["queue_frac"], 4),
                "shed": shed,
                "served": served,
                "p99Ms": sig["p99_ms"],
                # Queue-depth growth rate (rows/s) from the shared
                # rollup series; None while the rollup engine has too
                # few points (or is disabled) to fit one.
                "queueSlope": (
                    round(slope, 4) if slope is not None else None
                ),
                # Device-time fraction since the last tick (decode +
                # predict attribution) — the cost-aware signal; 0.0
                # on a model's first evaluation.
                "deviceFrac": round(device_frac, 4),
                "upStreak": up_streak,
                "downStreak": down_streak,
                "blocked": blocked,
                "action": "hold" if target == n
                else ("up" if target > n else "down"),
                "reason": reason or "hold",
            }
            if target == n:
                with self._lock:
                    self.ledger.append(record)
                continue
            try:
                result = self._manager.scale(
                    name, target, reason=f"auto:{reason}"
                )
            except LeaseTimeout:
                # Chip pool saturated: note it and re-arm the streak so
                # the next tick retries immediately instead of waiting
                # out a fresh sustain window.  (.get: the model may
                # have been dropped — forget() — while the lease
                # attempt blocked.)
                with self._lock:
                    st = self._state.get(name)
                    if st is not None:
                        st["up"] = self.cfg.up_ticks
                        st["blocked_until"] = (
                            time.monotonic()
                            + self.cfg.lease_timeout_s
                        )
                logger.warning(kv(
                    event="scale_up_blocked", model=name,
                    wanted=target, reason="lease_timeout",
                ))
                record["action"] = "blocked"
                record["reason"] = "lease_timeout"
                record["wanted"] = target
                with self._lock:
                    self.ledger.append(record)
                continue
            decision = {
                "t": time.time(),
                "model": name,
                "from": n,
                "to": result,
                "signal": reason,
                "queueFrac": round(sig["queue_frac"], 4),
                "shed": shed,
                "p99Ms": sig["p99_ms"],
            }
            record["to"] = result
            with self._lock:
                self.decisions.append(decision)
                self.ledger.append(record)
            made.append(decision)
        return made

    def _queue_slope(self, name: str) -> float | None:
        """This model's queue-depth growth rate (rows/second) from the
        shared rollup series, the windowed view the timeseries endpoint
        serves.  None when the rollup engine is disabled, has not two
        points yet, or the query fails (the autoscaler must never die on
        an observability hiccup)."""
        try:
            return obs_rollup.get_engine().slope(
                "lo_serving_model_queue_depth", {"model": name},
                self.cfg.slope_window_s)
        except Exception:  # noqa: BLE001
            return None

    def _device_seconds(self, name: str) -> float:
        """This model's accumulated device seconds from the cost plane's
        attribution ledger (serving dispatches + decode syncs); 0.0 when
        cost tracking is off or errs — the autoscaler must never die on
        an observability hiccup."""
        try:
            from learningorchestra_tpu_torch.obs import costs

            return costs.devtime().model_device_s(name)
        except Exception:  # noqa: BLE001
            return 0.0

    def forget(self, name: str) -> None:
        """Drop a dissolved model's streak state (manager drop path)."""
        with self._lock:
            self._state.pop(name, None)

    def status(self) -> dict:
        with self._lock:
            return {
                "running": self._thread is not None
                and self._thread.is_alive(),
                "intervalS": self.cfg.interval_s,
                "upQueueFrac": self.cfg.up_queue_frac,
                "upTicks": self.cfg.up_ticks,
                "downTicks": self.cfg.down_ticks,
                "upP99Ms": self.cfg.up_p99_ms,
                "upSlope": self.cfg.up_slope,
                "slopeWindowS": self.cfg.slope_window_s,
                "upDeviceFrac": self.cfg.up_device_frac,
                "ticks": self.ticks,
                "streaks": {
                    name: {"up": st["up"], "down": st["down"]}
                    for name, st in self._state.items()
                },
                "decisions": list(self.decisions),
                # The full per-evaluation ledger (holds included) —
                # why the fleet moved, or didn't, each tick.
                "ledger": list(self.ledger),
            }
