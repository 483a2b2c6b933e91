"""Metrics tracking and phase timers.

Counterpart of ``polyrl_tpu/utils/metrics.py``'s ``MetricsTracker`` and
``marked_timer``: repeated keys average (losses), timing keys sum (a phase
can run many times per step), gauges take the last value, counters sum
raw, histograms summarise to percentiles. Metric names are ``area/name``.
The tracer spans and profiler annotations of the JAX ``marked_timer``
belong to the observability planes, which are not ported yet; the
``Tracking`` logger waits with them.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import defaultdict
from typing import Any

from polyrl_tpu_torch.obs.histogram import Histogram

_collision_warned: set[str] = set()


def _strict_metrics() -> bool:
    # collisions raise under pytest, warn once at runtime
    return "PYTEST_CURRENT_TEST" in os.environ


class MetricsTracker:
    """Accumulates the metrics of one step."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)
        self._timings = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._counters = defaultdict(float)
        self._hists: dict[str, Histogram] = {}

    def update(self, metrics: dict[str, Any]) -> None:
        for k, v in metrics.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def update_gauge(self, metrics: dict[str, Any]) -> None:
        """Last-value-wins metrics (cumulative counters)."""
        for k, v in metrics.items():
            self._gauges[k] = float(v)

    def incr(self, name: str, amount: float = 1.0) -> None:
        """Within-step counter emitted raw (not averaged)."""
        self._counters[name] += amount

    def add_timing(self, name: str, seconds: float) -> None:
        self._timings[name] += seconds

    def observe(self, name: str, value: float) -> None:
        """Distribution sample; ``as_dict`` emits ``<name>/{p50,p95,p99,max,
        mean,count}``."""
        hist = self._hists.get(name)
        if hist is None:
            hist = self._hists[name] = Histogram()
        hist.observe(value)

    def timings(self) -> dict[str, float]:
        return dict(self._timings)

    def get(self, key: str, default: float = 0.0) -> float:
        """Current value of one metric by key (averaged, gauge, counter)."""
        if key in self._sums:
            return self._sums[key] / self._counts[key]
        if key in self._gauges:
            return self._gauges[key]
        if key in self._counters:
            return self._counters[key]
        return default

    def merge(self, other: "MetricsTracker") -> None:
        for k, v in other._sums.items():
            self._sums[k] += v
            self._counts[k] += other._counts[k]
        for k, v in other._timings.items():
            self._timings[k] += v
        self._gauges.update(other._gauges)
        for k, v in other._counters.items():
            self._counters[k] += v
        self.merge_histograms(other._hists)

    def merge_histograms(self, hists: dict[str, Histogram]) -> None:
        for name, h in hists.items():
            mine = self._hists.get(name)
            if mine is None:
                self._hists[name] = h
            else:
                mine.merge(h)

    def as_dict(self) -> dict[str, float]:
        out = {k: self._sums[k] / self._counts[k] for k in self._sums}
        groups = {
            "timing": {f"timing_s/{k}": v for k, v in self._timings.items()},
            "counter": dict(self._counters),
            "histogram": {k: v for h_name, h in self._hists.items()
                          for k, v in h.summary(h_name).items()},
            "gauge": self._gauges,
        }
        for kind, metrics in groups.items():
            for k, v in metrics.items():
                if k in out:
                    self._collide(kind, k)
                out[k] = v
        return out

    @staticmethod
    def _collide(kind: str, key: str) -> None:
        msg = (f"metric key collision: {kind} metric {key!r} overwrites an "
               f"earlier metric in the same step record")
        if _strict_metrics():
            raise ValueError(msg)
        if key not in _collision_warned:
            _collision_warned.add(key)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)


@contextlib.contextmanager
def marked_timer(name: str, tracker: MetricsTracker):
    """Phase timer: always emits ``timing_s/<name>``, even when the phase
    raises (a failure also counts ``<name>/failed``)."""
    t0 = time.monotonic()
    try:
        yield
    except BaseException:
        tracker.incr(f"{name}/failed")
        raise
    finally:
        tracker.add_timing(name, time.monotonic() - t0)
