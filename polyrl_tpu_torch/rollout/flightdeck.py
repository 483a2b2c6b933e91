"""Serving telemetry helpers.

Of ``polyrl_tpu/rollout/flightdeck.py`` the port so far needs only the
throughput smoother behind ``last_gen_throughput``; the per-request
lifecycle ledger (the flight deck proper) is not ported yet.
"""

from __future__ import annotations

import math
import time


class ThroughputEWMA:
    """Time-aware EWMA over throughput samples: the weight adapts to the
    gap between samples (``alpha = 1 - exp(-dt/tau)``), so irregular
    emission bursts are smoothed over ``tau`` seconds of wall time rather
    than a fixed sample count."""

    def __init__(self, tau_s: float = 5.0):
        self.tau_s = float(tau_s)
        self.value = 0.0
        self._t_last: float | None = None

    def update(self, rate: float, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if self._t_last is None:
            self.value = float(rate)
        else:
            dt = max(0.0, now - self._t_last)
            alpha = 1.0 - math.exp(-dt / self.tau_s) if self.tau_s > 0 else 1.0
            self.value += alpha * (float(rate) - self.value)
        self._t_last = now
        return self.value

    def reset(self) -> None:
        self.value = 0.0
        self._t_last = None
