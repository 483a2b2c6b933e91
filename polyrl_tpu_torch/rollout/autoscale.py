"""Closed-loop autoscaling: act on the trend rail (a copy of
``polyrl_tpu/rollout/autoscale.py``).

The paper's adaptivity story (progressive workload balance offloading
rollout onto harvested spot capacity) had every INPUT built — the
elastic pool lifecycle (rollout/pool.py), the progressive balance
estimator's trend slopes (``BalanceEstimator.trends()``), the per-step
critical-path bottleneck attribution (``critpath/bottleneck``) and the
fleet ``engine/*`` gauges — but nothing ever ACTED on them. This module
closes the loop:

- :class:`AutoscaleController` — a deterministic policy ticked once per
  finished step from the trainer's fit loop. It consumes the trend rail
  (occupancy/bubble slopes, gated on ``balance_trends_valid``), the
  critical-path bottleneck segment and the fleet pool counters, and
  issues PoolManager actions: **request-add** (an endpoint acquired from
  a pluggable :class:`CapacityProvider` — e.g. the spot-market harness,
  rollout/spotmarket.py) and **proactive drain** of the least-loaded
  engine. Decisions run under hysteresis (``hold_steps`` consecutive
  ticks before a trend acts), per-action cooldowns, a min/max fleet
  envelope (envelope repair bypasses the trend gate — a pool below
  ``min_engines`` adds immediately) and a sliding-window rate limiter.
  Actions execute on a background worker thread (a drain sleeps out its
  grace window; the trainer loop must never stall on it) with at most
  one action in flight.
- **Degradation tiers** — when the fleet collapses the trainer degrades
  explicitly instead of stalling: tier 0 ``remote`` (>=1 remote engine
  in the fleet), tier 1 ``colocated`` (only the local time-sliced engine
  left), tier 2 ``local`` (no engine, or a ``finish_locally``
  degraded completion just happened). The tier is the
  ``autoscale/degrade_tier`` step gauge (FlightRecorder watches it
  "high") and :meth:`hold_admission` is the pipeline's admission
  backpressure: new streams hold while the fleet is empty, releasing at
  ``admission_max_wait_s`` so the ``finish_locally`` path can
  degrade-complete rather than deadlock.

Every decision — acted, intended (dry run) or suppressed — lands as
structured ``autoscale/*`` step gauges plus the /statusz ``autoscale``
section (action, reason, inputs, suppressions), so the loop is
debuggable from one curl. Default OFF (``rollout.autoscale.enabled``):
a run without the controller is bitwise-identical to one predating it.

Scheduling reference: the Adaptive Placement framework and MindSpeed
RL's dynamic-resource thesis (PAPERS.md).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque

log = logging.getLogger(__name__)

# degradation ladder (the /statusz tier table): the trainer's serving
# posture, derived from pool membership every tick
TIERS = ("remote", "colocated", "local")

# decision vocabulary: the autoscale/action step gauge is an index here
ACTIONS = ("none", "add", "drain")

# why the controller decided what it decided (autoscale/reason indexes
# this tuple). The reason is recorded even when the action was then
# suppressed — "what it wanted and why it didn't" is the debug surface.
REASONS = ("none", "below_min", "above_max", "saturating", "underloaded")

# rollout-bound critical-path segments (obs/critical_path.py SEGMENTS
# indices: generate=0, bubble=4): a step bottlenecked there is starving
# on rollout capacity — an add signal alongside the trend slopes
_ROLLOUT_BOUND_SEGMENTS = (0.0, 4.0)

# rate-limiter window: max_actions_per_hour counts actions inside this
_RATE_WINDOW_S = 3600.0


def _in_fleet(inst: dict) -> bool:
    """An engine the fleet counts: in the manager's routing set, or
    healthy and not draining. With a weight fabric the manager empties its
    routing set at every version bump and takes each engine back once its
    push lands, so right after a push (where the trainer ticks) a healthy
    fleet has no active engine at all; counting only ``active`` read that
    as a collapse (tier 2, envelope adds, the admission gate shut until
    the push landed). A joiner counts once its health check passed."""
    return bool(inst.get("active")) or (bool(inst.get("healthy"))
                                        and not inst.get("draining"))


@dataclasses.dataclass
class AutoscaleConfig:
    """``rollout.autoscale.*`` knobs (config.py RolloutSection).

    Default OFF everywhere: the controller is only constructed when
    ``enabled`` is true, so the default fit path is untouched."""
    enabled: bool = False
    # record intents (autoscale/intents_total + the statusz section)
    # without ever issuing a pool action
    dry_run: bool = False
    # fleet envelope, in engines (``_in_fleet``): below min is repaired by an
    # immediate add (bypassing trend hysteresis, not the cooldown/rate
    # limiter), above max by a proactive drain
    min_engines: int = 1
    max_engines: int = 4
    # trend hysteresis: add when fleet-mean occupancy is at/above the
    # high water AND the trainer-bubble slope is rising past
    # bubble_slope_add (or the critical path is rollout-bound); drain
    # when occupancy is at/below the low water with a non-rising bubble.
    # Either condition must hold for hold_steps CONSECUTIVE ticks.
    occupancy_high: float = 0.75
    occupancy_low: float = 0.30
    bubble_slope_add: float = 0.0
    hold_steps: int = 2
    # per-action cooldowns: a join needs the bootstrap push + gate to
    # settle before its effect is measurable; drains are rarer still
    cooldown_add_s: float = 30.0
    cooldown_drain_s: float = 60.0
    # sliding-window rate limiter over BOTH action kinds (flap guard)
    max_actions_per_hour: int = 12
    # admission backpressure (trainer/pipeline.py gate): how long a new
    # stream may hold while the fleet has no engine (``_in_fleet``). Always
    # releases at the deadline — finish_locally degrades the batch
    # instead of the gate deadlocking the run. 0 disables the gate.
    admission_max_wait_s: float = 30.0


class CapacityProvider:
    """Where scale-up capacity comes from. The controller never creates
    engines itself — it asks the provider for one ready endpoint per
    add decision. rollout/spotmarket.py implements this over a scripted
    offer trace; a production provider would front a VM/GPU allocator."""

    def acquire(self) -> str | None:
        """Pop one ready-to-join endpoint, or None if the market has
        nothing on offer right now (the add is then suppressed as
        ``no_capacity`` and retried on a later tick)."""
        raise NotImplementedError

    def on_step(self, step: int) -> int:
        """Optional step-paced event hook (the spot market's ``step``
        time base); returns the number of events fired so the caller
        knows to refresh its fleet view mid-tick."""
        return 0


class AutoscaleController:
    """The policy loop. Construct with the fleet control plane
    (:class:`PoolManager`), the trend source (:class:`BalanceEstimator`)
    and optionally a :class:`CapacityProvider` + the
    :class:`RemoteRollout` (for the ``finish_locally`` degrade signal);
    call :meth:`tick` once per finished trainer step and merge the
    returned ``autoscale/*`` gauges into the step record."""

    def __init__(self, pool, balance, cfg: AutoscaleConfig | None = None,
                 capacity: CapacityProvider | None = None, rollout=None,
                 clock=time.monotonic):
        self.pool = pool
        self.balance = balance
        self.cfg = cfg or AutoscaleConfig(enabled=True)
        self.capacity = capacity
        self.rollout = rollout
        self._clock = clock
        self._lock = threading.Lock()
        self._closed = threading.Event()
        # single-worker action executor: a drain blocks on its grace
        # window — off the trainer thread, one action in flight at most
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._inflight = threading.Event()
        # cumulative totals (step-record gauges)
        self.ticks = 0
        self.adds_total = 0
        self.drains_total = 0
        self.intents_total = 0
        self.suppressed_total = 0
        self.exec_failures = 0
        self.gate_wait_s_total = 0.0
        self.degrade_tier = 0
        # hysteresis + cooldown + rate-limit state
        self._hold_add = 0
        self._hold_drain = 0
        self._last_add_t = float("-inf")
        self._last_drain_t = float("-inf")
        self._action_times: deque[float] = deque()
        self._last_fallbacks = 0
        # last decision, for the /statusz autoscale section
        self._last: dict = {"step": -1, "action": "none", "reason": "none",
                            "inputs": {}, "suppressions": []}

    def close(self) -> None:
        self._closed.set()
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=10.0)
            self._worker = None

    # -- the policy tick ---------------------------------------------------

    def tick(self, step: int, *, fleet: dict | None = None,
             record: dict | None = None) -> dict[str, float]:
        """One policy evaluation. ``fleet`` is the just-fetched
        ``PoolManager.counters()`` dict (the trainer passes it in so the
        tick never re-sweeps what the step already swept); ``record``
        the previous step's record (for ``critpath/bottleneck``)."""
        cfg = self.cfg
        with self._lock:
            self.ticks += 1
        if self.capacity is not None and self.capacity.on_step(step):
            # step-paced market events just changed membership: refresh
            # so the decision sees the post-event fleet, not a stale one
            fleet = None
        if fleet is None:
            fleet = self.pool.counters()
        trends = self.balance.trends() if self.balance is not None else {}
        record = record or {}

        # the fleet's size from the same sweep as ``fleet`` (_in_fleet)
        active = float(sum(1 for i in self.pool.engines(refresh=False)
                           if _in_fleet(i)))
        occupancy = float(fleet.get("engine/occupancy", 0.0))
        trends_valid = bool(trends.get("balance_trends_valid", 0.0))
        bubble_slope = float(trends.get("bubble_slope", 0.0))
        bottleneck = float(record.get("critpath/bottleneck", -1.0))
        tier = self._compute_tier()
        inputs = {
            "active": active,
            "occupancy": occupancy,
            "occupancy_slope": float(trends.get("occupancy_slope", 0.0)),
            "bubble_slope": bubble_slope,
            "bottleneck": bottleneck,
            "trends_valid": trends_valid,
        }

        suppressions: list[str] = []
        if not cfg.enabled:
            want, reason = "none", "none"
            suppressions.append("disabled")
        else:
            want, reason = self._decide(active, occupancy, bubble_slope,
                                        bottleneck, trends_valid,
                                        suppressions)
        acted = "none"
        if want != "none":
            acted = self._issue(want, suppressions)

        with self._lock:
            self.suppressed_total += len(suppressions)
            self.degrade_tier = tier
            self._last = {"step": int(step), "action": acted,
                          "reason": reason, "inputs": inputs,
                          "suppressions": list(suppressions)}
            return {
                "autoscale/enabled": 1.0 if cfg.enabled else 0.0,
                "autoscale/dry_run": 1.0 if cfg.dry_run else 0.0,
                "autoscale/ticks": float(self.ticks),
                "autoscale/action": float(ACTIONS.index(acted)),
                "autoscale/reason": float(REASONS.index(reason)),
                "autoscale/adds_total": float(self.adds_total),
                "autoscale/drains_total": float(self.drains_total),
                "autoscale/intents_total": float(self.intents_total),
                "autoscale/suppressed_total": float(self.suppressed_total),
                "autoscale/exec_failures": float(self.exec_failures),
                "autoscale/degrade_tier": float(tier),
                "autoscale/trends_valid": 1.0 if trends_valid else 0.0,
                "autoscale/admission_gate_wait_s": float(
                    self.gate_wait_s_total),
            }

    def _decide(self, active: float, occupancy: float, bubble_slope: float,
                bottleneck: float, trends_valid: bool,
                suppressions: list[str]) -> tuple[str, str]:
        """Envelope repair first (structural, bypasses trend hysteresis),
        then the trend policy gated on a valid estimator window."""
        cfg = self.cfg
        if active < cfg.min_engines:
            self._hold_add = self._hold_drain = 0
            return "add", "below_min"
        if active > cfg.max_engines:
            self._hold_add = self._hold_drain = 0
            return "drain", "above_max"
        if not trends_valid:
            # cold estimator window: 1-2 point slopes are noise, not a
            # reason to move capacity (BalanceEstimator cold-window guard)
            suppressions.append("trends_invalid")
            self._hold_add = self._hold_drain = 0
            return "none", "none"
        rollout_bound = bottleneck in _ROLLOUT_BOUND_SEGMENTS
        want_add = (occupancy >= cfg.occupancy_high
                    and (bubble_slope > cfg.bubble_slope_add
                         or rollout_bound)
                    and active < cfg.max_engines)
        want_drain = (occupancy <= cfg.occupancy_low
                      and bubble_slope <= 0.0 and not rollout_bound
                      and active > cfg.min_engines)
        self._hold_add = self._hold_add + 1 if want_add else 0
        self._hold_drain = self._hold_drain + 1 if want_drain else 0
        if want_add and self._hold_add >= cfg.hold_steps:
            return "add", "saturating"
        if want_drain and self._hold_drain >= cfg.hold_steps:
            return "drain", "underloaded"
        if want_add or want_drain:
            suppressions.append("hold")
        return "none", "none"

    def _issue(self, kind: str, suppressions: list[str]) -> str:
        """Run a wanted action through the suppression gauntlet
        (in-flight / cooldown / rate limit / capacity / dry run) and, if
        it survives, hand it to the worker. Returns the action actually
        taken (``none`` when suppressed)."""
        cfg = self.cfg
        now = self._clock()
        if self._inflight.is_set():
            suppressions.append("action_in_flight")
            return "none"
        if kind == "add" and now - self._last_add_t < cfg.cooldown_add_s:
            suppressions.append("cooldown_add")
            return "none"
        if kind == "drain" and now - self._last_drain_t < cfg.cooldown_drain_s:
            suppressions.append("cooldown_drain")
            return "none"
        while self._action_times and now - self._action_times[0] > _RATE_WINDOW_S:
            self._action_times.popleft()
        if len(self._action_times) >= cfg.max_actions_per_hour:
            suppressions.append("rate_limited")
            return "none"
        if kind == "add":
            endpoint = self.capacity.acquire() \
                if self.capacity is not None else None
            if not endpoint:
                suppressions.append("no_capacity")
                return "none"
            if cfg.dry_run:
                suppressions.append("dry_run")
                with self._lock:
                    self.intents_total += 1
                return "none"
            self._last_add_t = now
            self._action_times.append(now)
            with self._lock:
                self.adds_total += 1
            log.info("autoscale: adding engine %s", endpoint)
            self._submit(lambda: self.pool.add_engine(endpoint=endpoint,
                                                      wait=False))
            return "add"
        target = self._drain_target()
        if not target:
            suppressions.append("no_drain_target")
            return "none"
        if cfg.dry_run:
            suppressions.append("dry_run")
            with self._lock:
                self.intents_total += 1
            return "none"
        self._last_drain_t = now
        self._action_times.append(now)
        with self._lock:
            self.drains_total += 1
        log.info("autoscale: proactively draining %s", target)
        self._submit(lambda: self.pool.preempt(target))
        return "drain"

    def _drain_target(self) -> str | None:
        """Least-loaded remote engine of the fleet, from the cached sweep (the
        tick's fleet counters just refreshed it). The colocated local
        engine is never a drain target — it is the degradation floor."""
        insts = self.pool.engines(refresh=False)
        cands = [i for i in insts
                 if _in_fleet(i) and not i.get("is_local")]
        if not cands:
            return None
        cands.sort(key=lambda i: (int(i.get("num_running_reqs", 0)),
                                  float(i.get("occupancy", 0.0))))
        return cands[0].get("endpoint") or None

    def _submit(self, fn) -> None:
        self._inflight.set()
        if self._worker is None:
            self._worker = threading.Thread(target=self._exec_loop,
                                            name="autoscale-exec",
                                            daemon=True)
            self._worker.start()
        self._q.put(fn)

    def _exec_loop(self) -> None:
        while not self._closed.is_set():
            try:
                fn = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a failed action is a
                # counter + log line, never a dead controller
                with self._lock:
                    self.exec_failures += 1
                log.exception("autoscale action failed")
            finally:
                if self._q.empty():
                    self._inflight.clear()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no action is executing (tests; returns False on
        timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self._inflight.is_set():
                return True
            time.sleep(0.02)
        return not self._inflight.is_set()

    # -- degradation tiers -------------------------------------------------

    def _compute_tier(self) -> int:
        """Serving posture from the cached membership sweep: remote(0)
        while any remote engine is in the fleet, colocated(1) when only the
        local time-sliced engine is left, local(2) when nothing is — or
        when a ``finish_locally`` degraded completion happened since the
        last tick (the fleet may look recovered by the time the step
        record is cut; the tier transition must still be visible)."""
        insts = self.pool.engines(refresh=False)
        active = [i for i in insts if _in_fleet(i)]
        if any(not i.get("is_local") for i in active):
            tier = 0
        elif active:
            tier = 1
        else:
            tier = 2
        if self.rollout is not None:
            fallbacks = int(getattr(self.rollout, "local_fallbacks", 0))
            if fallbacks > self._last_fallbacks:
                tier = 2
            self._last_fallbacks = fallbacks
        return tier

    def hold_admission(self) -> float:
        """Admission backpressure for the pipeline gate: block while the
        fleet has no engine (``_in_fleet``), up to ``admission_max_wait_s``.
        Always returns (never deadlocks) — past the deadline the stream
        proceeds and the ``finish_locally`` path degrades the batch.
        Returns the seconds waited."""
        cfg = self.cfg
        if not cfg.enabled or cfg.admission_max_wait_s <= 0:
            return 0.0
        t0 = self._clock()
        waited = 0.0
        while waited < cfg.admission_max_wait_s:
            try:
                if any(_in_fleet(i) for i in self.pool.engines()):
                    break
            except Exception:  # noqa: BLE001 — a mid-respawn manager
                break          # must not hold the gate shut
            if self._closed.wait(0.2):
                break
            waited = self._clock() - t0
        if waited:
            log.warning("autoscale admission gate held a stream %.2fs "
                        "(the fleet had no engine)", waited)
            with self._lock:
                self.gate_wait_s_total += waited
        return waited

    # -- /statusz ----------------------------------------------------------

    def statusz_section(self) -> dict:
        """The /statusz ``autoscale`` section: config echo, envelope,
        degradation tier, cumulative totals, and the last decision with
        its inputs and suppressions."""
        cfg = self.cfg
        with self._lock:
            return {
                "enabled": cfg.enabled,
                "dry_run": cfg.dry_run,
                "envelope": {"min": cfg.min_engines,
                             "max": cfg.max_engines},
                "degrade_tier": self.degrade_tier,
                "tier_name": TIERS[self.degrade_tier],
                "last": dict(self._last),
                "totals": {"ticks": self.ticks, "adds": self.adds_total,
                           "drains": self.drains_total,
                           "intents": self.intents_total,
                           "suppressed": self.suppressed_total,
                           "exec_failures": self.exec_failures,
                           "gate_wait_s": round(self.gate_wait_s_total, 3)},
            }
