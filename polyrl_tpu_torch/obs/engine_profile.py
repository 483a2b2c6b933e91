"""Engine-loop profiler: exhaustive per-iteration phase attribution of the
CB engine's loop thread.

The port's own copy of ``polyrl_tpu/obs/engine_profile.py``. Every loop
iteration's wall is decomposed into an exhaustive, non-overlapping phase
taxonomy whose sum equals the iteration wall by construction (the residual
lands in ``other``), so ``attributed_frac`` reads like the goodput
ledger's: the named phases over the wall, > 1.0 meaning double-counted
attribution.

Phase taxonomy (seconds, exclusive self-time):

- ``collect_wave``  -- admission wave assembly (slot and page reservation,
  prefix-cache match, group fork bookkeeping)
- ``restore``       -- spill readmit: host-to-device restore of spilled
  prefix pages (``rollout/kvspill.py``, restore-then-attach)
- ``prefill_dispatch`` -- prefill, attach and chunk dispatch calls (host
  wall spent queueing them, and any device wait inside)
- ``decode_dispatch_device`` -- device-state upload and the k-step decode
  dispatch (on the card: the CUDA-graph replay and the output copy)
- ``sample_fetch``  -- the loop thread blocked on a dispatch output's copy
  to the host (the fetcher's hand-off, or the synchronous fallback)
- ``emit``          -- streaming fetched tokens to the request queues, host
  mirror updates, finalize folds
- ``accounting``    -- deck, KV-ledger and dispatch bookkeeping
- ``spill_sweep``   -- the watermark sweep's page-out (host spill tier)
- ``idle``          -- no work: queue waits and backoff sleeps
- ``other``         -- the unattributed residual (clamped at 0)

Attribution is stack-based with exclusive (self-time) semantics: the
engine nests phases freely (the emission drain runs inside admission, the
spill inside allocation pressure) and a nested phase's wall is charged to
the nested phase, never counted again against its parent. Stacks are
thread-local, so another thread (or a test driving engine internals) can
enter phases without corrupting the loop thread's iteration; cumulative
totals fold under one lock.

The windowed device-vs-host split is computed over a two-bucket flip
window (about ``window_s`` of recent loop wall), so a long-lived engine
reports current behaviour, not a run-lifetime average:

- ``device_frac``        = (prefill_dispatch + decode_dispatch_device +
  sample_fetch) / wall: host wall spent dispatching to or waiting on the
  device. With CUDA-graph replay a dispatch returns at once, so on the card
  this reads below the device's own busy share (a profiler's number).
- ``accounting_frac``    = (accounting + spill_sweep) / wall;
- ``host_overhead_frac`` = 1 - device_frac - idle_frac: all host-side work
  including the residual, so the three fracs and idle partition 1.

The dispatch phases and the restore are also emitted as spans into the
process tracer (``obs/trace.py``) when tracing is on.
"""

from __future__ import annotations

import contextlib
import threading
import time

from polyrl_tpu_torch.obs.histogram import Histogram
from polyrl_tpu_torch.obs.trace import get_tracer

PHASES = ("collect_wave", "restore", "prefill_dispatch",
          "decode_dispatch_device", "sample_fetch", "emit", "accounting",
          "spill_sweep", "idle", "other")
# host wall spent dispatching to / waiting on the device
DEVICE_PHASES = frozenset(
    ("prefill_dispatch", "decode_dispatch_device", "sample_fetch"))
# the bookkeeping overhead the regression budget pins
ACCOUNTING_PHASES = frozenset(("accounting", "spill_sweep"))
# phases worth a tracer span each occurrence (dispatch-scale, not µs-scale)
SPAN_PHASES = frozenset(
    ("prefill_dispatch", "decode_dispatch_device", "sample_fetch",
     "restore"))


class EngineLoopProfiler:
    """Exhaustive engine-loop phase attribution (module docstring).

    ``clock`` is injectable for fake-clock tests (the partition tests drive
    it by hand, so ``attributed_frac`` is exactly 1.0)."""

    def __init__(self, window_s: float = 20.0, clock=time.monotonic,
                 tracer=None):
        self._clock = clock
        self._tracer = tracer  # None: the process tracer, resolved lazily
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.window_s = float(window_s)
        self.iters = 0
        self.wall_s = 0.0
        self.totals = {p: 0.0 for p in PHASES}
        self.counts = {p: 0 for p in PHASES}
        self.hists = {p: Histogram() for p in PHASES if p != "other"}
        # two-bucket flip window: [wall, device, accounting, idle] each;
        # readers sum both buckets -> window_s/2 .. window_s of loop wall
        self._win_cur = [0.0, 0.0, 0.0, 0.0]
        self._win_prev = [0.0, 0.0, 0.0, 0.0]

    # -- thread-local attribution state --------------------------------------

    def _state(self):
        st = getattr(self._tls, "state", None)
        if st is None:
            # stack of [phase_name, self_seconds]; mark = last event time;
            # iter_phases = per-iteration fold (loop thread only)
            st = self._tls.state = {"stack": [], "mark": None,
                                    "iter_phases": None}
        return st

    @staticmethod
    def _attr(st, now: float) -> None:
        """Charge the wall since the last event to the innermost open
        phase (self-time). Time with an empty stack inside an iteration
        becomes the ``other`` residual at iteration close."""
        mark = st["mark"]
        if mark is not None and st["stack"]:
            st["stack"][-1][1] += now - mark
        st["mark"] = now

    # -- phases ---------------------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name: str):
        st = self._state()
        self._attr(st, self._clock())
        st["stack"].append([name, 0.0])
        span_cm = None
        if name in SPAN_PHASES:
            tracer = self._tracer if self._tracer is not None \
                else get_tracer()
            if tracer.enabled:
                span_cm = tracer.span("engine/" + name)
                span_cm.__enter__()
        try:
            yield
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)
            self._attr(st, self._clock())
            _name, self_s = st["stack"].pop()
            if st["iter_phases"] is not None:
                st["iter_phases"][name] = (
                    st["iter_phases"].get(name, 0.0) + self_s)
            with self._lock:
                self.totals[name] += self_s
                self.counts[name] += 1
                self.hists[name].observe(self_s)

    @contextlib.contextmanager
    def iteration(self):
        """One loop iteration: phases inside fold into the iteration's
        partition; the leftover wall (empty-stack time between phases)
        lands in ``other``, so the sum equals the iteration wall by
        construction."""
        st = self._state()
        t0 = self._clock()
        st["iter_phases"] = {}
        st["mark"] = t0
        try:
            yield
        finally:
            now = self._clock()
            self._attr(st, now)
            phases, st["iter_phases"] = st["iter_phases"], None
            wall = now - t0
            other = max(0.0, wall - sum(phases.values()))
            device = sum(phases.get(p, 0.0) for p in DEVICE_PHASES)
            acct = sum(phases.get(p, 0.0) for p in ACCOUNTING_PHASES)
            idle = phases.get("idle", 0.0)
            with self._lock:
                self.iters += 1
                self.wall_s += wall
                self.totals["other"] += other
                cur = self._win_cur
                cur[0] += wall
                cur[1] += device
                cur[2] += acct
                cur[3] += idle
                if cur[0] >= self.window_s / 2.0:
                    self._win_prev = cur
                    self._win_cur = [0.0, 0.0, 0.0, 0.0]

    # -- export ---------------------------------------------------------------

    def attributed_frac(self) -> float:
        """Named-phase seconds over the iteration wall: 1.0 when every
        iteration's wall is inside a phase, > 1.0 means double-counted
        attribution. 1.0 before any iteration."""
        with self._lock:
            if self.wall_s <= 0.0:
                return 1.0
            return (self.wall_s - self.totals["other"]) / self.wall_s

    def window_fracs(self) -> dict:
        """The windowed device-vs-host split over about ``window_s`` of
        recent loop wall; zeros before the first iteration closes."""
        with self._lock:
            wall, device, acct, idle = (a + b for a, b in
                                        zip(self._win_cur, self._win_prev))
        if wall <= 0.0:
            return {"wall_s": 0.0, "device_frac": 0.0,
                    "host_overhead_frac": 0.0, "accounting_frac": 0.0,
                    "idle_frac": 0.0}
        device_f = device / wall
        idle_f = idle / wall
        return {
            "wall_s": wall,
            "device_frac": device_f,
            # everything host-side that is neither device wait nor idle,
            # the residual included, so the three partition 1
            "host_overhead_frac": max(0.0, 1.0 - device_f - idle_f),
            "accounting_frac": acct / wall,
            "idle_frac": idle_f,
        }

    def server_info_fields(self) -> dict:
        """Flat keys merged into ``server_info`` (no ``/``: the C++
        manager's stats poller indexes them directly)."""
        w = self.window_fracs()
        return {
            "device_frac": round(w["device_frac"], 6),
            "host_overhead_frac": round(w["host_overhead_frac"], 6),
            "accounting_frac": round(w["accounting_frac"], 6),
            "loop_attributed_frac": round(self.attributed_frac(), 6),
        }

    def snapshot(self) -> dict:
        """The nested ``engine.loop`` view (phase seconds, fractions,
        counts, latency percentiles and the window)."""
        with self._lock:
            totals = dict(self.totals)
            counts = dict(self.counts)
            iters = self.iters
            wall = self.wall_s
            hists = {p: {
                "p50": h.percentile(50.0), "p95": h.percentile(95.0),
                "p99": h.percentile(99.0),
                "max": h.vmax if h.count else 0.0,
                "mean": h.mean, "count": float(h.count),
            } for p, h in self.hists.items() if h.count}
        out = {
            "enabled": True,
            "iters": iters,
            "wall_s": round(wall, 3),
            "attributed_frac": round(
                (wall - totals["other"]) / wall if wall > 0 else 1.0, 6),
            "phase_s": {p: round(v, 4) for p, v in totals.items()},
            "phase_frac": {p: round(v / wall, 4) if wall > 0 else 0.0
                           for p, v in totals.items()},
            "phase_n": {p: counts[p] for p in PHASES if counts[p]},
            "window": {k: round(v, 4)
                       for k, v in self.window_fracs().items()},
        }
        if hists:
            out["latency"] = hists
        return out
