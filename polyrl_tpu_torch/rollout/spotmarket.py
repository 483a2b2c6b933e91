"""Trace-driven spot-market chaos harness (a copy of
``polyrl_tpu/rollout/spotmarket.py``).

The paper's capacity story assumes rollout engines live on HARVESTED
spot capacity: instances arrive when the market has surplus, leave with
a short preemption notice, and sometimes just die. This module replays a
scripted ``(t, event)`` schedule against the elastic pool so the whole
closed loop — AutoscaleController adds from offers, PoolManager drains
on notices, heartbeat eviction + token-level continuation on kills — is
drillable deterministically in tests and in the chip smoke's
``autoscale`` phase:

- ``offer``  — capacity appears. The market starts an engine via its
  ``engine_factory`` (or takes the event's pre-existing ``endpoint``)
  and queues it for :meth:`acquire` — the controller's next add decision
  picks it up. ``auto_add: true`` joins the pool directly instead (the
  market forcing capacity ON — how a drill pushes the fleet ABOVE the
  envelope to provoke a proactive drain).
- ``notice`` — preemption WITH a grace window (the ~2-min spot warning,
  compressed): ``PoolManager.preempt`` drains the engine so in-flight
  tokens ride the salvage path (abort partials → suffix resumes on
  survivors) instead of dying with the instance.
- ``kill``   — preemption WITHOUT notice (SIGKILL semantics): streams
  break mid-line, recovery is heartbeat eviction + manager continuation.

Trace format (JSONL, one event per line; ``#`` comments and blank lines
skipped)::

    {"t": 1.0, "event": "offer",  "name": "C"}
    {"t": 1.0, "event": "notice", "target": "A"}
    {"t": 3.0, "event": "kill",   "target": "B"}
    {"t": 7.0, "event": "offer",  "name": "F", "auto_add": true}

``t`` is seconds from :meth:`start` (scaled by ``time_scale``) with the
default ``time_base="wall"``; with ``time_base="step"`` events fire
synchronously from the controller's tick when the trainer step reaches
``t`` — the deterministic pacing the chaos e2e uses. ``target`` names an
engine the market knows: a prior offer's ``name``, or one registered
via :meth:`adopt`. Counters ride the step record through the
fault-injection plane: attach via ``FaultInjector``'s ``spot`` hook and
``fault/spot_{offers,notices,kills}`` land next to the ``fault/*``
recovery counters they cause.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time

from polyrl_tpu_torch.rollout.autoscale import CapacityProvider

log = logging.getLogger(__name__)

_EVENTS = ("offer", "notice", "kill")


@dataclasses.dataclass
class SpotMarketConfig:
    """``rollout.spot_market.*`` knobs (config.py RolloutSection),
    mirroring the ``transfer.fault_injection`` config idiom: a dataclass
    the run config owns, default OFF."""
    enabled: bool = False
    # JSONL schedule (see module docstring); "" with no inline events =
    # an empty market (acquire always returns None)
    trace_path: str = ""
    # notice grace window: how long preempt waits for abort partials to
    # flush before deregistering (compressed from spot's ~2 minutes)
    grace_s: float = 0.5
    # wall-mode time compression: event fires at t * time_scale
    time_scale: float = 1.0
    # "wall" replays on a background thread against the clock; "step"
    # fires events from AutoscaleController.tick when the trainer step
    # reaches t (deterministic — the chaos e2e's pacing)
    time_base: str = "wall"


def load_trace(path: str) -> list[dict]:
    """Parse a JSONL trace file; validates event kinds and sorts by t
    (stable, so same-t events keep file order)."""
    events: list[dict] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ev = json.loads(line)
            kind = ev.get("event")
            if kind not in _EVENTS:
                raise ValueError(
                    f"{path}:{lineno}: unknown spot event {kind!r} "
                    f"(expected one of {_EVENTS})")
            ev["t"] = float(ev.get("t", 0.0))
            events.append(ev)
    events.sort(key=lambda e: e["t"])
    return events


class SpotMarket(CapacityProvider):
    """Replays a spot trace against a :class:`PoolManager`; doubles as
    the controller's :class:`CapacityProvider` (offers queue for
    :meth:`acquire`). ``engine_factory`` is a zero-arg callable
    returning a started engine handle (``.endpoint``, ``.kill()``,
    ``.stop()``) — tests pass a FakeEngine factory, a drill a
    real CBEngine server factory; offers carrying an explicit ``endpoint``
    need no factory. Attaching ``injector`` (a rollout FaultInjector)
    merges ``fault/spot_*`` counters into every step record."""

    def __init__(self, pool, cfg: SpotMarketConfig | None = None,
                 engine_factory=None, injector=None,
                 events: list[dict] | None = None):
        self.pool = pool
        self.cfg = cfg or SpotMarketConfig(enabled=True)
        self.engine_factory = engine_factory
        if events is None:
            events = (load_trace(self.cfg.trace_path)
                      if self.cfg.trace_path else [])
        self._events = sorted(list(events), key=lambda e: float(e.get("t", 0.0)))
        self._idx = 0                      # step-mode replay cursor
        self._handles: dict[str, object] = {}   # name -> engine handle
        self._owned: list[object] = []     # handles the market must stop
        self._ready: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # all events fired (a drill waits on this before measuring recovery)
        self.done = threading.Event()
        if not self._events:
            self.done.set()
        # cumulative counters (public, like every injector in faults.py)
        self.offers = 0
        self.notices = 0
        self.kills = 0
        # wall timestamp of the first disruptive event (notice/kill) —
        # a drill's recovery clock starts here
        self.first_disruption_t: float | None = None
        if injector is not None:
            injector.spot = self

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SpotMarket":
        """Arm the market. Wall mode spawns the replay thread; step mode
        is passive — events fire from :meth:`on_step`."""
        if self.cfg.time_base == "wall" and self._events:
            self._thread = threading.Thread(target=self._replay,
                                            name="spot-market", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for handle in self._owned:
            try:
                handle.stop()
            except Exception:  # noqa: BLE001 — killed engines are down
                pass

    def _replay(self) -> None:
        t0 = time.monotonic()
        for ev in self._events:
            delay = (ev["t"] * self.cfg.time_scale
                     - (time.monotonic() - t0))
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            self._fire(ev, sync=False)
        self.done.set()

    def on_step(self, step: int) -> int:
        """Step-paced replay (``time_base="step"``): fire every event
        with ``t <= step``, synchronously — by the time the controller
        decides, the pool reflects the market. Returns events fired."""
        if self.cfg.time_base != "step":
            return 0
        fired = 0
        while (self._idx < len(self._events)
               and self._events[self._idx]["t"] <= step):
            self._fire(self._events[self._idx], sync=True)
            self._idx += 1
            fired += 1
        if self._idx >= len(self._events):
            self.done.set()
        return fired

    # -- CapacityProvider --------------------------------------------------

    def acquire(self) -> str | None:
        try:
            return self._ready.get_nowait()
        except queue.Empty:
            return None

    # -- event dispatch ----------------------------------------------------

    def adopt(self, name: str, handle) -> None:
        """Register a pre-existing engine under a trace name so notices/
        kills can target it (the market does NOT own it: :meth:`stop`
        leaves it running)."""
        with self._lock:
            self._handles[str(name)] = handle

    def _fire(self, ev: dict, sync: bool) -> None:
        try:
            kind = ev.get("event")
            log.info("spot market: %s %s", kind,
                     ev.get("name") or ev.get("target") or "")
            if kind == "offer":
                self._offer(ev)
            elif kind == "notice":
                self._notice(ev, sync)
            elif kind == "kill":
                self._kill(ev)
        except Exception:  # noqa: BLE001 — a failed event is a log
            # line, not a dead market (the drill must keep replaying)
            log.exception("spot event failed: %r", ev)

    def _offer(self, ev: dict) -> None:
        endpoint = str(ev.get("endpoint", ""))
        handle = None
        if not endpoint:
            if self.engine_factory is None:
                log.warning("spot offer without endpoint and no "
                            "engine_factory; dropped: %r", ev)
                return
            handle = self.engine_factory()
            endpoint = handle.endpoint
        name = str(ev.get("name") or endpoint)
        with self._lock:
            self.offers += 1
            if handle is not None:
                self._handles[name] = handle
                self._owned.append(handle)
        if ev.get("auto_add"):
            # market forces capacity on (no controller decision): the
            # over-the-envelope drill provoking a proactive drain
            self.pool.add_engine(endpoint=endpoint, wait=False)
        else:
            self._ready.put(endpoint)

    def _resolve(self, ev: dict):
        name = str(ev.get("target") or ev.get("name") or "")
        with self._lock:
            handle = self._handles.get(name)
        endpoint = str(ev.get("endpoint", "")) or (
            handle.endpoint if handle is not None else "")
        return handle, endpoint

    def _notice(self, ev: dict, sync: bool) -> None:
        handle, endpoint = self._resolve(ev)
        if not endpoint:
            log.warning("spot notice with no resolvable target: %r", ev)
            return
        with self._lock:
            self.notices += 1
            self._mark_disruption()

        def run() -> None:
            # the grace-window warning: drain so in-flight tokens ride
            # the salvage path, then the instance actually goes away
            self.pool.preempt(endpoint, grace_s=self.cfg.grace_s)
            if handle is not None and ev.get("terminate", True):
                handle.kill()

        if sync:
            run()
        else:
            # wall mode: preempt sleeps out the grace window — off the
            # replay thread so later events stay on schedule
            threading.Thread(target=run, name="spot-notice",
                             daemon=True).start()

    def _kill(self, ev: dict) -> None:
        handle, endpoint = self._resolve(ev)
        if handle is None or not hasattr(handle, "kill"):
            log.warning("spot kill needs an owned/adopted handle: %r", ev)
            return
        with self._lock:
            self.kills += 1
            self._mark_disruption()
        handle.kill()

    def _mark_disruption(self) -> None:
        if self.first_disruption_t is None:
            self.first_disruption_t = time.monotonic()

    # -- telemetry ---------------------------------------------------------

    def counters(self) -> dict[str, float]:
        return {
            "fault/spot_offers": float(self.offers),
            "fault/spot_notices": float(self.notices),
            "fault/spot_kills": float(self.kills),
        }
