"""Windowed time-series rollups over the metrics registry — port of
``learningorchestra_tpu/obs/rollup.py``.

Every ``tick_s`` seconds the :class:`RollupEngine` snapshots a selected
set of registry families (``MetricsRegistry.collect_all``: push metrics
and pull collectors through one surface) into per-series bounded rings
(``points`` entries each, ``max_series`` series in all; a label
explosion drops new series, counted).  Windowed views derive on demand:
counter rates (with reset detection), gauge min/avg/max/last, histogram
quantiles from cumulative-bucket deltas (Prometheus'
``histogram_quantile`` interpolation) and the least-squares slope the
fleet autoscaler's queue-growth trigger reads
(``FleetConfig.up_slope``).  ``obs/slo.py`` evaluates its objectives on
the same tick.  ``tick()`` takes an explicit ``now`` so tests replay
schedules deterministically without the thread.

Knobs: config.py ``RollupConfig`` (env ``LO_TPU_ROLLUP_*``).
"""

from __future__ import annotations

import collections
import threading
import time

from learningorchestra_tpu_torch.log import get_logger

logger = get_logger("rollup")

__all__ = [
    "CORE_FAMILIES",
    "RollupEngine",
    "ensure_engine",
    "get_engine",
    "quantile_from_deltas",
    "reset_engine",
]

#: Families every deployment tracks (LO_TPU_ROLLUP_FAMILIES adds more).
#: Each is bounded-cardinality by construction: routes come from the
#: fixed route table, job classes from the service types, models from
#: the serving registry's max_models cap.
CORE_FAMILIES = (
    "lo_http_requests_total",
    "lo_http_request_duration_seconds",
    "lo_jobs_total",
    "lo_jobs_queue_depth",
    "lo_lease_devices",
    "lo_serving_events_total",
    "lo_serving_queue_depth",
    "lo_serving_model_queue_depth",
    "lo_serving_predict_duration_seconds",
    "lo_serving_replicas",
    "lo_serving_decode_ttft_seconds",
    "lo_serving_decode_itl_seconds",
    "lo_serving_decode_tokens_total",
    "lo_serving_decode_active_streams",
    "lo_serving_decode_free_slots",
    "lo_cluster_claims_total",
    "lo_cluster_engines",
    "lo_admission_rejections_total",
)


def quantile_from_deltas(edges, deltas, q: float):
    """Prometheus-style ``histogram_quantile`` over one window's
    per-bucket count increments.

    ``edges`` are the finite bucket upper bounds (ascending);
    ``deltas`` has ``len(edges) + 1`` entries — the last is the +Inf
    bucket.  Linear interpolation inside the bucket the rank lands in
    (lower bound 0 for the first); a rank in the +Inf bucket returns
    the highest finite edge, never an invented value.  ``None`` when
    the window saw no observations."""
    total = sum(deltas)
    if total <= 0:
        return None
    rank = min(max(q, 0.0), 1.0) * total
    cum = 0.0
    lo = 0.0
    for edge, d in zip(edges, deltas):
        if d > 0 and cum + d >= rank:
            return lo + (edge - lo) * ((rank - cum) / d)
        cum += d
        lo = edge
    return float(edges[-1])


def _hist_deltas(pts) -> tuple:
    """``(per_bucket_deltas, count, sum)`` between a histogram
    window's first and last points, with counter-reset detection —
    the ONE delta body hist_window / fraction_below / the REST view
    all share."""
    first, last = pts[0], pts[-1]
    if last[4] < first[4]:  # counter reset: window = newest alone
        cum_d, n, s = list(last[2]), last[4], last[3]
    else:
        cum_d = [b - a for a, b in zip(first[2], last[2])]
        n, s = last[4] - first[4], last[3] - first[3]
    per_bucket = [cum_d[0]] + [
        max(0.0, b - a) for a, b in zip(cum_d, cum_d[1:])
    ]
    return per_bucket, n, s


def _pts_slope(pts) -> float | None:
    """Least-squares value-per-second slope over one series' points."""
    if len(pts) < 2:
        return None
    t0 = pts[0][0]
    xs = [pt[0] - t0 for pt in pts]
    ys = [pt[2] for pt in pts]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    var = sum((x - mx) ** 2 for x in xs)
    if var <= 0:
        return None
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    return cov / var


class _Series:
    """One tracked (family, label-set): a bounded ring of snapshots.

    Scalar points: ``(mono, wall, value)``.  Histogram points:
    ``(mono, wall, cum, sum, count)`` with ``cum`` the cumulative
    bucket counts INCLUDING the +Inf bucket."""

    __slots__ = ("name", "kind", "labels", "edges", "ring")

    def __init__(self, name, kind, labels, edges, maxlen):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.edges = edges
        self.ring = collections.deque(maxlen=maxlen)

    def window_points(self, now: float, window_s: float) -> list:
        """Points inside the window PLUS the baseline point just
        before it (deltas need the value at the window's left edge;
        without it a window shorter than one tick would always read
        empty)."""
        cut = now - window_s
        pts = list(self.ring)
        start = 0
        for i, pt in enumerate(pts):
            if pt[0] <= cut:
                start = i
            else:
                break
        return pts[start:]


class RollupEngine:
    """Tick-driven snapshots + windowed derivation (module docstring)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.families = tuple(dict.fromkeys(
            CORE_FAMILIES + tuple(cfg.families)
        ))
        self.points = max(2, int(cfg.points))
        self.max_series = max(1, int(cfg.max_series))
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}
        self.ticks = 0
        #: Snapshots dropped because the engine was at max_series —
        #: one per observation, mirroring the registry's overflow
        #: counter semantics.
        self.dropped_series = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the daemon (idempotent; no-op when disabled or
        tick_s <= 0 — tests drive tick() directly).  Re-armable after
        :meth:`stop`: the singleton outlives any one API server, so a
        new server's construction revives the clock a previous
        server's shutdown stopped."""
        with self._lock:
            if (
                (self._thread is not None and self._thread.is_alive())
                or not self.cfg.enabled
                or self.cfg.tick_s <= 0
            ):
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-rollup", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        """Stop the daemon (API-server shutdown: a demoted/stopped
        node must not keep evaluating SLOs over frozen windows or
        paging a webhook).  tick() stays callable; start() re-arms."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a dead rollup loop is
                # every SLO silently frozen; survive any one tick.
                logger.exception("rollup tick failed")

    # -- ingest --------------------------------------------------------------

    def tick(self, now: float | None = None) -> int:
        """One snapshot pass; returns the number of samples ingested.
        ``now`` is a monotonic timestamp — tests pass synthetic values
        to replay schedules deterministically.

        Cost note: ``collect_all`` runs every registered pull
        collector (they emit whole family groups; per-family skipping
        is not knowable up front), so one tick costs about one
        ``/metrics.prom`` exposition pass — the same class of work a
        Prometheus scrape at the same cadence would do.  Deployments
        sensitive to that trade raise ``LO_TPU_ROLLUP_TICK_S``."""
        if not self.cfg.enabled:
            return 0
        from learningorchestra_tpu_torch.obs.metrics import get_registry

        mono = time.monotonic() if now is None else float(now)
        wall = time.time()
        samples = get_registry().collect_all(names=self.families)
        ingested = 0
        with self._lock:
            self.ticks += 1
            for s in samples:
                key = (
                    s["name"],
                    tuple(sorted(s["labels"].items())),
                )
                series = self._series.get(key)
                if series is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    series = self._series[key] = _Series(
                        s["name"], s["kind"], dict(s["labels"]),
                        tuple(s.get("edges") or ()), self.points,
                    )
                    # Synthetic zero birth point: registry counters
                    # and histograms are created at 0 in-process, so
                    # a series first sighted mid-stream (the first
                    # 5xx, a new model's first predict) gets its full
                    # increment into the window instead of a flat
                    # line at its birth value — without it the
                    # availability drill's error burst would be
                    # invisible to every delta.  Gauges get none: a
                    # fabricated 0 would distort min/avg.
                    if s["kind"] == "histogram":
                        series.ring.append((
                            mono - 1e-6, wall,
                            (0,) * len(s["cum"]), 0.0, 0,
                        ))
                    elif s["kind"] == "counter":
                        series.ring.append((mono - 1e-6, wall, 0.0))
                if s["kind"] == "histogram":
                    series.ring.append(
                        (mono, wall, s["cum"], s["sum"], s["count"])
                    )
                else:
                    series.ring.append((mono, wall, s["value"]))
                ingested += 1
        # SLO evaluation rides the same clock: one tick = one snapshot
        # + one objective pass, so alert timing is a function of
        # tick_s alone (the drill's determinism).
        try:
            from learningorchestra_tpu_torch.obs import slo as obs_slo

            obs_slo.on_tick(self, now=mono)
        except Exception:  # noqa: BLE001 — a broken objective must
            logger.exception("slo evaluation failed")  # not stop ingest
        return ingested

    # -- series access -------------------------------------------------------

    def _match(self, name: str, labels: dict | None) -> list:
        with self._lock:
            return [
                s for (n, _k), s in self._series.items()
                if n == name and (
                    not labels
                    or all(
                        s.labels.get(k) == str(v)
                        for k, v in labels.items()
                    )
                )
            ]

    def label_values(self, name: str, label: str) -> list[str]:
        """Distinct values of one label across a family's tracked
        series (SLO instance discovery: one predict-latency objective
        instance per served model)."""
        with self._lock:
            return sorted({
                s.labels[label]
                for (n, _k), s in self._series.items()
                if n == name and label in s.labels
            })

    # -- derived views -------------------------------------------------------

    @staticmethod
    def _delta(first, last) -> float:
        """Counter increment with reset detection: a restart that
        zeroed the counter reports the post-reset value instead of a
        negative delta (the Prometheus ``increase()`` convention)."""
        d = last - first
        return float(last) if d < 0 else float(d)

    def counter_delta(self, name: str, labels: dict | None,
                      window_s: float,
                      now: float | None = None) -> float | None:
        """Summed increment over the window across matching series;
        ``None`` when nothing is tracked yet."""
        now = time.monotonic() if now is None else now
        total, any_pts = 0.0, False
        for series in self._match(name, labels):
            pts = series.window_points(now, window_s)
            if len(pts) >= 2:
                any_pts = True
                total += self._delta(pts[0][2], pts[-1][2])
        return total if any_pts else None

    def rate(self, name: str, labels: dict | None, window_s: float,
             now: float | None = None) -> float | None:
        """Counter increments per second, averaged over the WHOLE
        window (a series younger than the window was semantically at
        0 before its birth, so the short observed span must not
        inflate the rate)."""
        if window_s <= 0:
            return None
        delta = self.counter_delta(name, labels, window_s, now=now)
        return None if delta is None else delta / window_s

    def gauge_window(self, name: str, labels: dict | None,
                     window_s: float,
                     now: float | None = None) -> dict | None:
        """min/avg/max/last over matching gauge points in the window
        (multi-series matches pool their points).  Strictly in-window
        points only: the pre-window baseline window_points keeps for
        counter/histogram DELTAS would report a stale series' ancient
        value as live data here — a dissolved model's frozen queue
        depth must read as no data, not as its hour-old level."""
        now = time.monotonic() if now is None else now
        cut = now - window_s
        values = []
        for series in self._match(name, labels):
            values += [
                pt[2] for pt in series.window_points(now, window_s)
                if pt[0] > cut
            ]
        if not values:
            return None
        return {
            "min": min(values),
            "avg": sum(values) / len(values),
            "max": max(values),
            "last": values[-1],
        }

    def hist_window(self, name: str, labels: dict | None,
                    window_s: float, qs=(0.5, 0.9, 0.95, 0.99),
                    now: float | None = None) -> dict | None:
        """Windowed histogram view from cumulative-bucket deltas:
        per-quantile estimates, observation count and mean over the
        window.  Multi-series matches sum their bucket deltas (the
        aggregate distribution)."""
        now = time.monotonic() if now is None else now
        deltas, edges = None, None
        count, hsum = 0.0, 0.0
        for series in self._match(name, labels):
            pts = series.window_points(now, window_s)
            if len(pts) < 2 or not series.edges:
                continue
            per_bucket, n, s = _hist_deltas(pts)
            count += n
            hsum += s
            if deltas is None:
                deltas, edges = per_bucket, series.edges
            elif series.edges == edges:
                deltas = [a + b for a, b in zip(deltas, per_bucket)]
        if deltas is None or count <= 0:
            return None
        return {
            "count": count,
            "sum": hsum,
            "avg": hsum / count,
            "quantiles": {
                f"p{round(q * 100) if q < 0.995 else '99.9'}":
                    quantile_from_deltas(edges, deltas, q)
                for q in qs
            },
        }

    def fraction_below(self, name: str, labels: dict | None,
                       threshold: float, window_s: float,
                       now: float | None = None):
        """``(good, total)`` observation counts over the window, where
        good = observations <= the smallest bucket edge >= threshold
        (bucket resolution rounds UP — an SLO threshold between edges
        credits the conservative bucket).  The latency-SLO primitive."""
        now = time.monotonic() if now is None else now
        good, total = 0.0, 0.0
        seen = False
        for series in self._match(name, labels):
            pts = series.window_points(now, window_s)
            if len(pts) < 2 or not series.edges:
                continue
            per_bucket, n, _s = _hist_deltas(pts)
            if n <= 0:
                continue
            seen = True
            total += n
            idx = None
            for i, edge in enumerate(series.edges):
                if edge >= threshold:
                    idx = i
                    break
            if idx is None:
                # Threshold above every finite edge: observations in
                # the +Inf bucket are of UNKNOWN magnitude — credit
                # only those under the largest finite edge (counting
                # them good would make the latency SLO unfireable).
                idx = len(series.edges) - 1
            good += sum(per_bucket[:idx + 1])
        return (good, total) if seen else None

    def slope(self, name: str, labels: dict | None, window_s: float,
              now: float | None = None) -> float | None:
        """Least-squares growth rate (value units per second) over the
        window's points, summed across matching series per timestamp —
        the fleet autoscaler's queue-ramp signal.  ``None`` below two
        distinct-time points."""
        now = time.monotonic() if now is None else now
        cut = now - window_s
        by_t: dict[float, float] = {}
        for series in self._match(name, labels):
            for pt in series.window_points(now, window_s):
                if pt[0] > cut:  # gauge semantics: no stale baseline
                    by_t[pt[0]] = by_t.get(pt[0], 0.0) + pt[2]
        # Pool per timestamp, then the ONE least-squares body
        # (_pts_slope) the REST view's per-series slopePerS uses too.
        return _pts_slope([
            (t, None, by_t[t]) for t in sorted(by_t)
        ])

    # -- REST views ----------------------------------------------------------

    def timeseries(self, name: str | None = None,
                   labels: dict | None = None,
                   window_s: float = 300.0,
                   max_points: int = 0) -> dict:
        """The ``GET /observability/timeseries`` body.  Without
        ``name``: the tracked-family directory.  With one: every
        matching series' raw ``[wall_t, ...]`` points plus the derived
        windowed view for its kind."""
        if name is None:
            with self._lock:
                per_family: dict[str, int] = {}
                for (n, _k) in self._series:
                    per_family[n] = per_family.get(n, 0) + 1
            return {
                "families": [
                    {"name": n, "series": per_family.get(n, 0)}
                    for n in self.families
                ],
                **self.status(),
            }
        now = time.monotonic()
        out = []
        # Derived views come from EACH series' already-extracted
        # points — re-running the multi-series window methods per
        # series would rescan the whole table O(series^2).
        for series in self._match(name, labels):
            pts = series.window_points(now, window_s)
            doc: dict = {"labels": series.labels, "kind": series.kind}
            if series.kind == "histogram":
                raw = [
                    [round(pt[1], 3), pt[4]] for pt in pts
                ]  # wall time + cumulative observation count
                if max_points > 0:
                    raw = raw[-max_points:]
                doc["points"] = raw
                doc["window"] = None
                if len(pts) >= 2 and series.edges:
                    deltas, n, s = _hist_deltas(pts)
                    if n > 0:
                        doc["window"] = {
                            "count": n,
                            "sum": s,
                            "avg": s / n,
                            "quantiles": {
                                f"p{round(q * 100)}":
                                    quantile_from_deltas(
                                        series.edges, deltas, q
                                    )
                                for q in (0.5, 0.9, 0.95, 0.99)
                            },
                        }
            else:
                raw = [[round(pt[1], 3), pt[2]] for pt in pts]
                if max_points > 0:
                    raw = raw[-max_points:]
                doc["points"] = raw
                if series.kind == "counter":
                    doc["ratePerS"] = (
                        self._delta(pts[0][2], pts[-1][2]) / window_s
                        if len(pts) >= 2 and window_s > 0 else None
                    )
                else:
                    cut = now - window_s
                    live = [pt for pt in pts if pt[0] > cut]
                    vals = [pt[2] for pt in live]
                    doc["window"] = {
                        "min": min(vals),
                        "avg": sum(vals) / len(vals),
                        "max": max(vals),
                        "last": vals[-1],
                    } if vals else None
                    doc["slopePerS"] = _pts_slope(live)
            out.append(doc)
        return {
            "name": name,
            "windowS": window_s,
            "series": out,
            "ticks": self.ticks,
        }

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": self.cfg.enabled,
                "tickS": self.cfg.tick_s,
                "points": self.points,
                "maxSeries": self.max_series,
                "series": len(self._series),
                "droppedSeries": self.dropped_series,
                "ticks": self.ticks,
                "running": self._thread is not None
                and self._thread.is_alive(),
            }

    def prom_families(self) -> list:
        """lo_rollup_* families for the server's pull collector — the
        engine's own health on the surface it rolls up."""
        from learningorchestra_tpu_torch.obs.metrics import Family

        st = self.status()
        return [
            Family(
                "gauge", "lo_rollup_series",
                "Time series tracked in rollup ring buffers.",
            ).sample(st["series"]),
            Family(
                "counter", "lo_rollup_ticks_total",
                "Rollup snapshot passes.",
            ).sample(st["ticks"]),
            Family(
                "counter", "lo_rollup_dropped_series_total",
                "Snapshots dropped at the LO_TPU_ROLLUP_MAX_SERIES "
                "cap.",
            ).sample(st["droppedSeries"]),
        ]


# -- process-wide singleton ---------------------------------------------------

_engine: RollupEngine | None = None
_engine_lock = threading.Lock()


def get_engine() -> RollupEngine:
    """The process-wide engine, built from config on first use."""
    global _engine
    with _engine_lock:
        if _engine is None:
            from learningorchestra_tpu_torch.config import get_config

            _engine = RollupEngine(get_config().rollup)
        return _engine


def ensure_engine(cfg) -> RollupEngine:
    """Build the singleton from ``cfg`` if none exists yet (API-server
    construction: the FIRST server's config wins, mirroring how the
    registry sizes itself), then return it."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = RollupEngine(cfg)
        return _engine


def reset_engine(cfg=None) -> RollupEngine:
    """Replace the singleton (tests); stops any
    running daemon thread first.  ``cfg=None`` rebuilds lazily from
    the global config on next use."""
    global _engine
    with _engine_lock:
        old, _engine = _engine, None
    if old is not None:
        old.stop()
    if cfg is not None:
        with _engine_lock:
            _engine = RollupEngine(cfg)
            return _engine
    return get_engine()
