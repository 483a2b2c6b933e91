"""Fixed-bucket log2 histograms and their process-global registry (a copy
of ``polyrl_tpu/obs/histogram.py``).

``Histogram`` trades precision for O(1) memory and merges:
buckets are geometric with ``SUBDIV`` sub-buckets per octave (width
``2**(1/SUBDIV)`` ≈ 9%), so p50/p95/p99 come back within one bucket width
of the exact quantile; ``max`` is tracked exactly.
"""

from __future__ import annotations

import collections
import math
import threading

# sub-buckets per power of two: relative resolution 2**(1/8)-1 ≈ 9.05%
SUBDIV = 8
# fixed index range: values clamp into [2^-40, 2^40] (~1e-12 .. ~1e12) —
# anything outside is a unit bug, not a latency
_IDX_MIN = -40 * SUBDIV
_IDX_MAX = 40 * SUBDIV


class Histogram:
    """Log2-bucketed distribution: counts per fixed geometric bucket plus
    exact count/sum/min/max. Non-positive observations are counted but only
    contribute to count/sum/min (there is no log bucket for them)."""

    __slots__ = ("buckets", "count", "total", "vmin", "vmax", "zeros")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zeros = 0  # observations <= 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= 0.0:
            self.zeros += 1
            return
        idx = min(max(math.floor(math.log2(v) * SUBDIV), _IDX_MIN), _IDX_MAX)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def observe_many(self, values) -> None:
        """Bulk observe: one numpy pass instead of a python loop — the
        training health ledger (obs/rlhealth.py) feeds thousands of
        per-token samples per step. Bucket math identical to
        :meth:`observe` (pinned by test). numpy imported lazily so the
        module stays import-light for the no-numpy consumers."""
        import numpy as np

        vals = np.asarray(values, np.float64).ravel()
        if vals.size == 0:
            return
        self.count += int(vals.size)
        self.total += float(vals.sum())
        self.vmin = min(self.vmin, float(vals.min()))
        self.vmax = max(self.vmax, float(vals.max()))
        pos = vals[vals > 0.0]
        self.zeros += int(vals.size - pos.size)
        if pos.size:
            idx = np.clip(np.floor(np.log2(pos) * SUBDIV),
                          _IDX_MIN, _IDX_MAX).astype(np.int64)
            uniq, counts = np.unique(idx, return_counts=True)
            for i, n in zip(uniq.tolist(), counts.tolist()):
                self.buckets[i] = self.buckets.get(i, 0) + n

    def merge(self, other: "Histogram") -> None:
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self.zeros += other.zeros

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Returns the geometric midpoint of the bucket the
        rank falls in, clamped to the exact observed [min, max]."""
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        seen = self.zeros
        if rank <= seen:  # the quantile sits in the non-positive mass
            return max(min(0.0, self.vmax), self.vmin)
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                mid = 2.0 ** ((idx + 0.5) / SUBDIV)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self, prefix: str) -> dict[str, float]:
        """Flat step-record keys: ``<prefix>/{p50,p95,p99,max,mean,count}``."""
        if self.count == 0:
            return {}
        return {
            f"{prefix}/p50": self.percentile(50.0),
            f"{prefix}/p95": self.percentile(95.0),
            f"{prefix}/p99": self.percentile(99.0),
            f"{prefix}/max": self.vmax,
            f"{prefix}/mean": self.mean,
            f"{prefix}/count": float(self.count),
        }


# -- process-global registry -------------------------------------------------
# Producers that have no handle on the trainer's per-step MetricsTracker
# (transfer agents, the manager client, the remote rollout) observe here;
# the trainer drains the registry into each step record (one consumer).

_REG: dict[str, Histogram] = {}
# name -> the (t0, t1) intervals, on the monotonic clock, of the
# observations given a start: the trainer learns from them which seconds of
# its wall a series covers (concurrent round trips overlap; a sum does not
# say so). Bounded: what falls off the end is only left unattributed.
_SPANS: dict[str, collections.deque] = {}
SPANS_KEPT = 4096
_REG_LOCK = threading.Lock()


def observe(name: str, value: float, t0: float | None = None) -> None:
    """``t0`` (``time.monotonic()`` at the start of what ``value`` times)
    also keeps the interval ``(t0, t0 + value)``."""
    with _REG_LOCK:
        hist = _REG.get(name)
        if hist is None:
            hist = _REG[name] = Histogram()
        hist.observe(value)
        if t0 is not None:
            spans = _SPANS.get(name)
            if spans is None:
                spans = _SPANS[name] = collections.deque(maxlen=SPANS_KEPT)
            spans.append((t0, t0 + value))


def drain_histograms() -> dict[str, Histogram]:
    """Snapshot-and-reset the registry (each step record owns its window)."""
    return drain_registry()[0]


def drain_registry() -> tuple[dict[str, Histogram], dict[str, list]]:
    """``drain_histograms`` and, from the same window, the intervals kept
    per name."""
    with _REG_LOCK:
        out = dict(_REG)
        spans = {k: list(v) for k, v in _SPANS.items()}
        _REG.clear()
        _SPANS.clear()
    return out, spans
