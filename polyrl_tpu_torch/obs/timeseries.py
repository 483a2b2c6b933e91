"""Fleet time-series rail: bounded per-key rings of step snapshots with
windowed aggregates (a copy of ``polyrl_tpu/obs/timeseries.py``).

The live planes so far expose LAST-step scalars (/statusz gauges, the
step record) — enough to answer "what is it doing now", useless for
"which way is it trending". The balance-driven autoscaling the ROADMAP
targets (Adaptive Placement in PAPERS.md) needs trend signals: is fleet
occupancy climbing toward saturation, is the trainer bubble shrinking
after an engine join, is decode throughput sagging. This module is that
rail: a :class:`TimeSeriesStore` keeps a bounded ``deque`` of
``(step, value)`` points per metric key (filtered by namespace prefix so
an unbounded key set can't grow the store) and renders windowed
aggregates — mean/p95/min/max plus a least-squares **slope** per step —
into the ``timeseries`` section of the ``polyrl/statusz/v4`` schema on
both planes, ``BalanceEstimator.trends()``, and tools/fleet_report.py.

Import-light (stdlib only) and cheap per observe: one deque append per
tracked key; aggregates are computed lazily at snapshot time.
"""

from __future__ import annotations

import threading
from collections import deque

# step-record namespaces the rail tracks by default: the goodput phase
# walls, the critical-path attribution, perf/pool/engine/training gauges
# — everything the autoscaling loop or a trend dashboard would window
DEFAULT_PREFIXES = ("goodput/", "perf/", "pool/", "engine/", "training/",
                    "manager/", "critpath/", "autoscale/")


def least_squares_slope(xs, ys) -> float:
    """Ordinary least-squares slope of ``ys`` over ``xs`` (0.0 for fewer
    than two points or a degenerate x-range)."""
    xs = [float(x) for x in xs]
    ys = [float(y) for y in ys]
    n = len(xs)
    if n < 2 or len(ys) != n:
        return 0.0
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0.0:
        return 0.0
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom


def _p95(sorted_vals: list[float]) -> float:
    """p95 by the nearest-rank method over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      int(round(0.95 * (len(sorted_vals) - 1)))))
    return sorted_vals[rank]


def aggregate(points: list[tuple[float, float]]) -> dict[str, float]:
    """Windowed summary of ``(step, value)`` points: last/mean/p95/min/
    max/count plus the least-squares slope PER STEP (so a counter that
    climbs by 1 each step reads slope=1.0 regardless of window size)."""
    if not points:
        return {"count": 0}
    vals = [v for _, v in points]
    srt = sorted(vals)
    return {
        "last": vals[-1],
        "mean": sum(vals) / len(vals),
        "p95": _p95(srt),
        "min": srt[0],
        "max": srt[-1],
        "slope": least_squares_slope([s for s, _ in points], vals),
        "count": len(vals),
    }


class TimeSeriesStore:
    """Bounded per-key ring of step snapshots.

    ``observe(step, record)`` folds one step's metric record in, keeping
    only numeric values under the tracked ``prefixes``; each key holds at
    most ``capacity`` points and the store at most ``max_keys`` keys
    (first-seen wins — a runaway per-instance key family can't evict the
    core series). Thread-safe: the statusz exporter snapshots from its
    HTTP thread while the fit loop observes.
    """

    def __init__(self, capacity: int = 256, max_keys: int = 512,
                 prefixes: tuple[str, ...] = DEFAULT_PREFIXES):
        self.capacity = max(2, int(capacity))
        self.max_keys = max(1, int(max_keys))
        self.prefixes = tuple(prefixes)
        self.dropped_keys = 0
        self._series: dict[str, deque] = {}
        self._lock = threading.Lock()

    def tracks(self, key: str) -> bool:
        return key.startswith(self.prefixes)

    def observe(self, step: float, record: dict) -> None:
        """Fold one step's record in (keys not under a tracked prefix, and
        non-numeric/bool values, are skipped)."""
        step = float(step)
        with self._lock:
            for key, value in record.items():
                if not isinstance(key, str) or not self.tracks(key):
                    continue
                if isinstance(value, bool) or \
                        not isinstance(value, (int, float)):
                    continue
                ring = self._series.get(key)
                if ring is None:
                    if len(self._series) >= self.max_keys:
                        self.dropped_keys += 1
                        continue
                    ring = self._series[key] = deque(maxlen=self.capacity)
                ring.append((step, float(value)))

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, key: str, window: int = 0) -> list[tuple[float, float]]:
        """The ``(step, value)`` points of ``key`` (last ``window`` when
        > 0); [] for an untracked key."""
        with self._lock:
            pts = list(self._series.get(key, ()))
        return pts[-window:] if window > 0 else pts

    def aggregates(self, key: str, window: int = 0) -> dict[str, float]:
        return aggregate(self.series(key, window))

    def section(self, window: int = 32) -> dict:
        """The /statusz ``timeseries`` section: per-key windowed aggregates
        plus the store's own shape, so a fleet sweep can window-compare
        slopes without shipping raw points."""
        with self._lock:
            items = [(k, list(r)) for k, r in self._series.items()]
        return {
            "window": int(window),
            "capacity": self.capacity,
            "tracked_keys": len(items),
            "dropped_keys": self.dropped_keys,
            "keys": {
                k: {name: (round(v, 6) if isinstance(v, float) else v)
                    for name, v in
                    aggregate(pts[-window:] if window > 0 else pts).items()}
                for k, pts in sorted(items)},
        }
