"""The port's closed-loop autoscaling controller and spot market
(``polyrl_tpu_torch/rollout/autoscale.py``, ``rollout/spotmarket.py``)
against the JAX package's.

First the 23 cases of ``tests/test_autoscale.py`` run against the port:
controller decisions on stub pool and balance planes with an injected
clock (envelope repair, trend hysteresis, cooldowns, rate limit, capacity
miss, dry run, cold-window suppression, degradation tiers, the admission
gate and the trainer's hook), the pool's sweep-loop and dead-endpoint
satellites, and the spot market's trace plumbing. Then parity: one
scripted fleet/trend/record sequence driven through both packages'
controllers must give equal gauges and ``statusz_section()``s every tick
and the same pool calls in the same order; the same traces (the
example's included) through both markets in step mode must make the same
pool calls, kills and counters.
"""

import os
import time
from types import SimpleNamespace

import pytest

from polyrl_tpu.rollout import autoscale as j_autoscale
from polyrl_tpu.rollout import spotmarket as j_spotmarket
from polyrl_tpu_torch.rollout import autoscale as t_autoscale
from polyrl_tpu_torch.rollout import spotmarket as t_spotmarket
from polyrl_tpu_torch.rollout.autoscale import (ACTIONS, REASONS,
                                                AutoscaleConfig,
                                                AutoscaleController,
                                                CapacityProvider)
from polyrl_tpu_torch.rollout.faults import FaultInjectionConfig, FaultInjector
from polyrl_tpu_torch.rollout.pool import (BalanceEstimator, PoolConfig,
                                           PoolManager)
from polyrl_tpu_torch.rollout.spotmarket import (SpotMarket, SpotMarketConfig,
                                                 load_trace)


# -- stubs -------------------------------------------------------------------

def _remote(ep, running=0, occ=0.0, active=True):
    return {"endpoint": ep, "active": active, "healthy": active,
            "is_local": False, "num_running_reqs": running, "occupancy": occ}


def _local(ep, active=True):
    return {"endpoint": ep, "active": active, "healthy": active,
            "is_local": True, "num_running_reqs": 0, "occupancy": 0.0}


class _Pool:
    def __init__(self, instances=()):
        self.instances = list(instances)
        self.added: list[str] = []
        self.preempted: list[str] = []

    def engines(self, refresh=True):
        return list(self.instances)

    def active_count(self, refresh=True):
        return sum(1 for i in self.instances if i.get("active"))

    def counters(self, refresh=True):
        return {"pool/active": float(self.active_count())}

    def add_engine(self, server=None, endpoint="", wait=True, **_kw):
        self.added.append(endpoint)
        return endpoint

    def preempt(self, endpoint, grace_s=None):
        self.preempted.append(endpoint)
        return {}


class _Balance:
    def __init__(self, **trends):
        self._trends = trends

    def trends(self):
        return dict(self._trends)


_VALID = dict(balance_trends_valid=1.0, bubble_slope=0.0,
              occupancy_slope=0.0)


class _Capacity(CapacityProvider):
    def __init__(self, *eps):
        self.eps = list(eps)

    def acquire(self):
        return self.eps.pop(0) if self.eps else None


def _ctl(pool, balance=None, cfg=None, **kw):
    clk = kw.pop("clk", [0.0])
    ctl = AutoscaleController(pool, balance or _Balance(**_VALID),
                              cfg or AutoscaleConfig(enabled=True),
                              clock=lambda: clk[0], **kw)
    return ctl, clk


# -- envelope repair ---------------------------------------------------------

def test_below_min_adds_from_capacity():
    pool = _Pool([_remote("a:1")])
    ctl, _ = _ctl(pool, cfg=AutoscaleConfig(enabled=True, min_engines=2,
                                            max_engines=4),
                  capacity=_Capacity("new:1"))
    try:
        g = ctl.tick(0, fleet={"pool/active": 1.0})
        assert g["autoscale/action"] == ACTIONS.index("add")
        assert g["autoscale/reason"] == REASONS.index("below_min")
        assert ctl.wait_idle()
        assert pool.added == ["new:1"]
        assert g["autoscale/adds_total"] == 1.0
    finally:
        ctl.close()


def test_above_max_drains_least_loaded():
    pool = _Pool([_remote("a:1", running=4, occ=0.9),
                  _remote("b:1", running=1, occ=0.2),
                  _remote("c:1", running=2, occ=0.5),
                  _local("loc:1")])
    ctl, _ = _ctl(pool, cfg=AutoscaleConfig(enabled=True, min_engines=1,
                                            max_engines=2))
    try:
        g = ctl.tick(0, fleet={"pool/active": 4.0})
        assert g["autoscale/action"] == ACTIONS.index("drain")
        assert g["autoscale/reason"] == REASONS.index("above_max")
        assert ctl.wait_idle()
        # least loaded remote; the colocated local engine is never a target
        assert pool.preempted == ["b:1"]
    finally:
        ctl.close()


def test_no_capacity_suppresses_add():
    pool = _Pool([])
    ctl, _ = _ctl(pool, capacity=_Capacity())  # empty market
    try:
        g = ctl.tick(0, fleet={"pool/active": 0.0})
        assert g["autoscale/action"] == ACTIONS.index("none")
        assert pool.added == []
        assert "no_capacity" in ctl.statusz_section()["last"]["suppressions"]
    finally:
        ctl.close()


# -- trend policy ------------------------------------------------------------

def test_trends_invalid_suppresses_trend_actions():
    pool = _Pool([_remote("a:1"), _remote("b:1")])
    bal = _Balance(balance_trends_valid=0.0, bubble_slope=9.9)
    ctl, _ = _ctl(pool, balance=bal, capacity=_Capacity("new:1"))
    try:
        g = ctl.tick(0, fleet={"pool/active": 2.0, "engine/occupancy": 0.99})
        assert g["autoscale/action"] == ACTIONS.index("none")
        assert g["autoscale/trends_valid"] == 0.0
        assert "trends_invalid" in \
            ctl.statusz_section()["last"]["suppressions"]
        assert pool.added == []
    finally:
        ctl.close()


def test_saturating_add_waits_out_hysteresis():
    pool = _Pool([_remote("a:1"), _remote("b:1")])
    bal = _Balance(balance_trends_valid=1.0, bubble_slope=0.5)
    cfg = AutoscaleConfig(enabled=True, min_engines=1, max_engines=4,
                          hold_steps=2, cooldown_add_s=0.0)
    ctl, _ = _ctl(pool, balance=bal, cfg=cfg, capacity=_Capacity("new:1"))
    try:
        fleet = {"pool/active": 2.0, "engine/occupancy": 0.9}
        g1 = ctl.tick(0, fleet=fleet)
        assert g1["autoscale/action"] == ACTIONS.index("none")
        assert "hold" in ctl.statusz_section()["last"]["suppressions"]
        g2 = ctl.tick(1, fleet=fleet)
        assert g2["autoscale/action"] == ACTIONS.index("add")
        assert g2["autoscale/reason"] == REASONS.index("saturating")
        assert ctl.wait_idle()
        assert pool.added == ["new:1"]
    finally:
        ctl.close()


def test_rollout_bound_bottleneck_counts_as_add_signal():
    # bubble slope flat, but the previous step's critical path was
    # generate-bound (segment 0) — still an add signal
    pool = _Pool([_remote("a:1")])
    bal = _Balance(balance_trends_valid=1.0, bubble_slope=0.0)
    cfg = AutoscaleConfig(enabled=True, min_engines=1, max_engines=4,
                          hold_steps=1, cooldown_add_s=0.0)
    ctl, _ = _ctl(pool, balance=bal, cfg=cfg, capacity=_Capacity("new:1"))
    try:
        g = ctl.tick(0, fleet={"pool/active": 1.0, "engine/occupancy": 0.9},
                     record={"critpath/bottleneck": 0.0})
        assert g["autoscale/action"] == ACTIONS.index("add")
    finally:
        ctl.close()


def test_underloaded_drain_and_cooldown():
    pool = _Pool([_remote("a:1", running=1), _remote("b:1", running=0)])
    bal = _Balance(balance_trends_valid=1.0, bubble_slope=-0.1)
    cfg = AutoscaleConfig(enabled=True, min_engines=1, max_engines=4,
                          hold_steps=1, cooldown_drain_s=60.0)
    ctl, clk = _ctl(pool, balance=bal, cfg=cfg)
    try:
        fleet = {"pool/active": 2.0, "engine/occupancy": 0.1}
        g = ctl.tick(0, fleet=fleet)
        assert g["autoscale/action"] == ACTIONS.index("drain")
        assert g["autoscale/reason"] == REASONS.index("underloaded")
        assert ctl.wait_idle()
        assert pool.preempted == ["b:1"]
        # within the drain cooldown the same want is suppressed...
        clk[0] = 30.0
        g = ctl.tick(1, fleet=fleet)
        assert g["autoscale/action"] == ACTIONS.index("none")
        assert "cooldown_drain" in \
            ctl.statusz_section()["last"]["suppressions"]
        # ...and past it the drain issues again
        clk[0] = 61.0
        g = ctl.tick(2, fleet=fleet)
        assert g["autoscale/action"] == ACTIONS.index("drain")
    finally:
        ctl.close()


def test_rate_limiter_caps_actions():
    pool = _Pool([_remote("a:1"), _remote("b:1")])
    bal = _Balance(balance_trends_valid=1.0, bubble_slope=0.5)
    cfg = AutoscaleConfig(enabled=True, min_engines=1, max_engines=9,
                          hold_steps=1, cooldown_add_s=0.0,
                          max_actions_per_hour=1)
    ctl, clk = _ctl(pool, balance=bal, cfg=cfg,
                    capacity=_Capacity("n1:1", "n2:1"))
    try:
        fleet = {"pool/active": 2.0, "engine/occupancy": 0.9}
        assert ctl.tick(0, fleet=fleet)["autoscale/action"] == \
            ACTIONS.index("add")
        assert ctl.wait_idle()
        clk[0] = 10.0
        g = ctl.tick(1, fleet=fleet)
        assert g["autoscale/action"] == ACTIONS.index("none")
        assert "rate_limited" in ctl.statusz_section()["last"]["suppressions"]
        assert pool.added == ["n1:1"]
    finally:
        ctl.close()


def test_dry_run_records_intents_only():
    pool = _Pool([])
    cfg = AutoscaleConfig(enabled=True, dry_run=True, min_engines=1)
    ctl, _ = _ctl(pool, cfg=cfg, capacity=_Capacity("new:1"))
    try:
        g = ctl.tick(0, fleet={"pool/active": 0.0})
        assert g["autoscale/action"] == ACTIONS.index("none")
        assert g["autoscale/intents_total"] == 1.0
        assert g["autoscale/adds_total"] == 0.0
        assert pool.added == []
        assert "dry_run" in ctl.statusz_section()["last"]["suppressions"]
    finally:
        ctl.close()


def test_disabled_controller_never_acts():
    pool = _Pool([])
    ctl, _ = _ctl(pool, cfg=AutoscaleConfig(enabled=False, min_engines=2),
                  capacity=_Capacity("new:1"))
    try:
        g = ctl.tick(0, fleet={"pool/active": 0.0})
        assert g["autoscale/enabled"] == 0.0
        assert g["autoscale/action"] == ACTIONS.index("none")
        assert pool.added == []
        assert "disabled" in ctl.statusz_section()["last"]["suppressions"]
    finally:
        ctl.close()


# -- degradation tiers -------------------------------------------------------

def test_degrade_tier_ladder_follows_membership():
    pool = _Pool([])
    cfg = AutoscaleConfig(enabled=True, min_engines=0, max_engines=10)
    ctl, _ = _ctl(pool, balance=_Balance(balance_trends_valid=0.0), cfg=cfg)
    try:
        script = [
            ([_remote("r:1"), _local("l:1")], 0),   # remote-preferred
            ([_local("l:1")], 1),                   # colocated fallback
            ([], 2),                                # nothing left: local
            ([_remote("r:1")], 0),                  # recovered
        ]
        seen = []
        for step, (insts, _want) in enumerate(script):
            pool.instances = insts
            g = ctl.tick(step, fleet={"pool/active":
                                      float(len(insts))})
            seen.append(int(g["autoscale/degrade_tier"]))
        assert seen == [want for _, want in script]
        assert ctl.statusz_section()["tier_name"] == "remote"
    finally:
        ctl.close()


def test_finish_locally_forces_tier_two_for_one_tick():
    rollout = SimpleNamespace(local_fallbacks=0)
    pool = _Pool([_remote("r:1")])
    cfg = AutoscaleConfig(enabled=True, min_engines=0, max_engines=10)
    ctl, _ = _ctl(pool, balance=_Balance(balance_trends_valid=0.0), cfg=cfg,
                  rollout=rollout)
    try:
        fleet = {"pool/active": 1.0}
        assert ctl.tick(0, fleet=fleet)["autoscale/degrade_tier"] == 0.0
        # a degraded completion happened mid-step; the fleet looks fine by
        # record-cut time but the tier transition must still be visible
        rollout.local_fallbacks = 1
        assert ctl.tick(1, fleet=fleet)["autoscale/degrade_tier"] == 2.0
        assert ctl.tick(2, fleet=fleet)["autoscale/degrade_tier"] == 0.0
    finally:
        ctl.close()


def test_admission_gate_holds_while_pool_empty_then_releases():
    pool = _Pool([])
    cfg = AutoscaleConfig(enabled=True, admission_max_wait_s=0.5)
    ctl = AutoscaleController(pool, _Balance(**_VALID), cfg)
    try:
        t0 = time.monotonic()
        waited = ctl.hold_admission()
        wall = time.monotonic() - t0
        # held roughly the max wait, then RELEASED (never deadlocks)
        assert 0.3 <= waited <= 5.0
        assert wall < 5.0
        assert ctl.gate_wait_s_total >= waited
        # with active capacity the gate is pass-through
        pool.instances = [_remote("r:1")]
        assert ctl.hold_admission() == 0.0
    finally:
        ctl.close()


def test_admission_gate_noop_when_disabled():
    ctl = AutoscaleController(_Pool([]), _Balance(),
                              AutoscaleConfig(enabled=False))
    try:
        assert ctl.hold_admission() == 0.0
    finally:
        ctl.close()


def test_trainer_wait_pool_admission_hook():
    from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer

    # no controller: the pre-autoscale trainer never waits
    assert StreamRLTrainer._wait_pool_admission(
        SimpleNamespace(_autoscale=None)) == 0.0

    class _M:
        def __init__(self):
            self.g = {}

        def update_gauge(self, d):
            self.g.update(d)

    ctl = AutoscaleController(
        _Pool([]), _Balance(),
        AutoscaleConfig(enabled=True, admission_max_wait_s=0.3))
    try:
        m = _M()
        waited = StreamRLTrainer._wait_pool_admission(
            SimpleNamespace(_autoscale=ctl), m)
        assert waited > 0.0
        assert m.g["autoscale/admission_gate_wait_s"] == waited
    finally:
        ctl.close()


# -- BalanceEstimator cold-window guard --------------------------------------

def test_trends_cold_window_guard():
    be = BalanceEstimator(window=8)
    assert be.trends() == {}
    be.observe(step_time_s=1.0, trainer_bubble_s=0.1, throughput=10.0)
    be.observe(step_time_s=2.0, trainer_bubble_s=0.2, throughput=20.0)
    t = be.trends()
    # two points always fit a line exactly — noise, not a trend
    assert t["balance_trends_valid"] == 0.0
    assert t["step_time_slope"] == 0.0
    assert t["bubble_slope"] == 0.0
    assert t["window_steps"] == 2.0
    assert be.metrics()["pool/balance_trends_valid"] == 0.0
    be.observe(step_time_s=3.0, trainer_bubble_s=0.3, throughput=30.0)
    t = be.trends()
    assert t["balance_trends_valid"] == 1.0
    assert t["step_time_slope"] == pytest.approx(1.0)
    assert t["bubble_slope"] == pytest.approx(0.1)
    assert be.metrics()["pool/balance_trends_valid"] == 1.0


# -- PoolManager satellites --------------------------------------------------

class _FlakyMgr:
    """Stub manager whose status endpoint fails the first N calls."""

    def __init__(self, fail_times):
        self.calls = 0
        self.fail_times = fail_times

    def get_instances_status(self):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("transient manager 500")
        return {"pool": {"active": 1, "registered": 1},
                "instances": [{"endpoint": "e:1", "healthy": True,
                               "active": True}]}


def test_sweep_loop_survives_flaky_manager():
    mgr = _FlakyMgr(fail_times=3)
    pool = PoolManager(mgr, PoolConfig(sweep_interval_s=0.02))
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if mgr.calls > 5 and pool._last_status:
                break
            time.sleep(0.02)
        # the thread outlived every failure and kept sweeping
        assert pool._thread is not None and pool._thread.is_alive()
        assert pool.sweep_failures == 3
        assert pool.counters(refresh=False)["pool/sweep_failed"] == 3.0
        # and the membership view recovered after the manager did
        assert pool.active_count(refresh=False) == 1
    finally:
        pool.close()


class _DeregMgr:
    def __init__(self, raise_on_dereg=False):
        self.dereg: list[tuple[str, bool]] = []
        self.raise_on_dereg = raise_on_dereg

    def deregister_rollout_instance(self, endpoint, drained=True):
        self.dereg.append((endpoint, drained))
        if self.raise_on_dereg:
            raise RuntimeError("manager mid-respawn")


def test_preempt_dead_endpoint_falls_through_to_evict():
    mgr = _DeregMgr()
    # long grace would make a fall-through that still sleeps obvious
    pool = PoolManager(mgr, PoolConfig(drain_grace_s=5.0))
    dead = "127.0.0.1:1"  # nothing listens there: the drain POST fails
    t0 = time.monotonic()
    pool.preempt(dead)
    # no raise, no grace sleep (nothing to flush), eviction booked ONCE
    assert time.monotonic() - t0 < 4.0
    assert pool.preemptions == 1
    assert pool.hard_evictions == 1
    assert mgr.dereg == [(dead, False)]


def test_preempt_dead_endpoint_survives_dereg_failure_too():
    mgr = _DeregMgr(raise_on_dereg=True)
    pool = PoolManager(mgr, PoolConfig(drain_grace_s=0.0))
    pool.preempt("127.0.0.1:1")  # must not raise: heartbeat backstops
    assert pool.hard_evictions == 1
    assert len(mgr.dereg) == 1


# -- SpotMarket plumbing -----------------------------------------------------

def test_load_trace_parses_sorts_and_validates(tmp_path):
    p = tmp_path / "trace.jsonl"
    p.write_text("# capacity storm\n"
                 "\n"
                 '{"t": 3, "event": "kill", "target": "B"}\n'
                 '{"t": 1, "event": "offer", "name": "C"}\n'
                 '{"t": 1, "event": "notice", "target": "A"}\n')
    evs = load_trace(str(p))
    assert [e["event"] for e in evs] == ["offer", "notice", "kill"]
    assert [e["t"] for e in evs] == [1.0, 1.0, 3.0]

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"t": 0, "event": "meteor"}\n')
    with pytest.raises(ValueError, match="meteor"):
        load_trace(str(bad))


class _Handle:
    def __init__(self, ep):
        self.endpoint = ep
        self.killed = False
        self.stopped = False

    def kill(self):
        self.killed = True

    def stop(self):
        self.stopped = True


def test_spotmarket_step_mode_fires_in_order():
    pool = _Pool([_remote("a:1"), _remote("b:1")])
    a, b = _Handle("a:1"), _Handle("b:1")
    events = [
        {"t": 1, "event": "offer", "name": "C", "endpoint": "c:1"},
        {"t": 1, "event": "notice", "target": "A"},
        {"t": 3, "event": "kill", "target": "B"},
        {"t": 5, "event": "offer", "endpoint": "d:1", "auto_add": True},
    ]
    injector = FaultInjector(FaultInjectionConfig())
    market = SpotMarket(pool, SpotMarketConfig(enabled=True, grace_s=0.0,
                                               time_base="step"),
                        injector=injector, events=events)
    market.adopt("A", a)
    market.adopt("B", b)
    market.start()
    try:
        assert market.on_step(0) == 0
        assert market.acquire() is None
        # t=1: the offer lists first (same-t file order is preserved),
        # then the notice drains A through the pool and terminates it
        assert market.on_step(1) == 2
        assert market.acquire() == "c:1"
        assert market.acquire() is None
        assert pool.preempted == ["a:1"]
        assert a.killed
        assert market.first_disruption_t is not None
        assert not market.done.is_set()
        # t=3..5 both fire when the step jumps past them
        assert market.on_step(5) == 2
        assert b.killed
        assert pool.added == ["d:1"]  # auto_add bypasses acquire()
        assert market.done.is_set()
        assert (market.offers, market.notices, market.kills) == (2, 1, 1)
        # the injector hook merges spot counters into the fault record
        c = injector.counters()
        assert c["fault/spot_offers"] == 2.0
        assert c["fault/spot_notices"] == 1.0
        assert c["fault/spot_kills"] == 1.0
    finally:
        market.stop()


def test_spotmarket_wall_mode_replays_on_thread():
    pool = _Pool([])
    a = _Handle("a:1")
    events = [{"t": 0.0, "event": "notice", "target": "A",
               "terminate": False}]
    market = SpotMarket(pool, SpotMarketConfig(enabled=True, grace_s=0.0,
                                               time_scale=0.01),
                        events=events)
    market.adopt("A", a)
    market.start()
    try:
        assert market.done.wait(5.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not pool.preempted:
            time.sleep(0.01)  # the drain runs on its own notice thread
        assert pool.preempted == ["a:1"]
        assert not a.killed  # terminate: false leaves the instance up
    finally:
        market.stop()


def test_example_trace_in_repo_parses():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "examples", "spot_trace.jsonl")
    evs = load_trace(path)
    kinds = [e["event"] for e in evs]
    assert kinds.count("notice") >= 2
    assert kinds.count("kill") >= 1
    assert kinds.count("offer") >= 1


# -- parity with the JAX package ----------------------------------------------

class _RecordingPool(_Pool):
    """The stub pool, logging every pool call in order."""

    def __init__(self, instances=()):
        super().__init__(instances)
        self.calls: list[tuple] = []

    def add_engine(self, server=None, endpoint="", wait=True, **_kw):
        self.calls.append(("add", endpoint, wait))
        return super().add_engine(endpoint=endpoint)

    def preempt(self, endpoint, grace_s=None):
        self.calls.append(("preempt", endpoint, grace_s))
        return super().preempt(endpoint)


class _ScriptBalance:
    def __init__(self):
        self.now: dict = {}

    def trends(self):
        return dict(self.now)


_INVALID = dict(balance_trends_valid=0.0, bubble_slope=0.0,
                occupancy_slope=0.0)


def _tick(clock, insts, occ=0.0, trends=_VALID, record=None, fallbacks=0):
    return dict(clock=clock, insts=insts, occ=occ, trends=trends,
                record=record, fallbacks=fallbacks)


_PAIR = [_remote("a:1", running=2, occ=0.5), _remote("c1:1", running=1)]
_TRIO = _PAIR + [_remote("c2:1", running=0, occ=0.1)]
_HOT = dict(balance_trends_valid=1.0, bubble_slope=0.5, occupancy_slope=0.1)
_FLAT = dict(balance_trends_valid=1.0, bubble_slope=0.0, occupancy_slope=0.0)
_COOL = dict(balance_trends_valid=1.0, bubble_slope=-0.1,
             occupancy_slope=-0.1)

# envelope [2, 3], hold 2, cooldowns 10 / 20 s, at most 3 actions an hour
_SCRIPT = [
    _tick(0.0, [_remote("a:1")]),                     # below_min: add c1
    _tick(1.0, _PAIR, trends=_INVALID),               # trends_invalid
    _tick(2.0, _PAIR, occ=0.9, trends=_HOT),          # hold (1 of 2)
    _tick(5.0, _PAIR, occ=0.9, trends=_HOT),          # cooldown_add
    _tick(12.0, _PAIR, occ=0.9, trends=_HOT),         # saturating: add c2
    # at the envelope's top: a rollout-bound step is no add
    _tick(13.0, _TRIO, occ=0.9, trends=_FLAT,
          record={"critpath/bottleneck": 0.0}),
    _tick(13.5, _TRIO, occ=0.1, trends=_COOL),        # hold (drain)
    _tick(14.0, _TRIO, occ=0.1, trends=_COOL),        # underloaded: drain
    _tick(20.0, _TRIO, occ=0.1, trends=_COOL),        # cooldown_drain
    _tick(40.0, _TRIO, occ=0.1, trends=_COOL),        # rate_limited
    _tick(41.0, [_local("l:1")]),                     # tier 1, rate_limited
    _tick(42.0, []),                                  # tier 2
    _tick(43.0, _PAIR, fallbacks=1),                  # finish_locally: 2
    _tick(3700.0, [_remote("a:1")]),                  # window over: add c3
    _tick(3711.0, [_remote("a:1")]),                  # no_capacity
    _tick(3712.0, [_remote("a:1"), _remote("c3:1")],
          occ=0.5, trends=_FLAT, record={"critpath/bottleneck": 4.0}),
]


def _drive(mod, cfg_kw: dict, script: list) -> tuple[list, list, list]:
    """Drive ``script`` through package ``mod``'s controller; returns each
    tick's gauges and ``statusz_section()``, and the pool calls."""
    pool = _RecordingPool()
    balance = _ScriptBalance()
    rollout = SimpleNamespace(local_fallbacks=0)
    clk = [0.0]

    class Capacity(mod.CapacityProvider):
        eps = ["c1:1", "c2:1", "c3:1"]

        def acquire(self):
            return self.eps.pop(0) if self.eps else None

    ctl = mod.AutoscaleController(
        pool, balance, mod.AutoscaleConfig(**cfg_kw), capacity=Capacity(),
        rollout=rollout, clock=lambda: clk[0])
    gauges, sections = [], []
    try:
        for step, t in enumerate(script):
            clk[0] = t["clock"]
            pool.instances = list(t["insts"])
            balance.now = dict(t["trends"])
            rollout.local_fallbacks = t["fallbacks"]
            fleet = {"pool/active": float(pool.active_count()),
                     "engine/occupancy": t["occ"]}
            gauges.append(ctl.tick(step, fleet=fleet, record=t["record"]))
            assert ctl.wait_idle()
            sections.append(ctl.statusz_section())
    finally:
        ctl.close()
    return gauges, sections, pool.calls


@pytest.mark.parametrize("dry_run", [False, True], ids=["acting", "dry_run"])
def test_controllers_agree_on_a_scripted_sequence(dry_run):
    cfg = dict(enabled=True, dry_run=dry_run, min_engines=2, max_engines=3,
               hold_steps=2, cooldown_add_s=10.0, cooldown_drain_s=20.0,
               max_actions_per_hour=3)
    ours = _drive(t_autoscale, cfg, _SCRIPT)
    ref = _drive(j_autoscale, cfg, _SCRIPT)
    for step, (g, r) in enumerate(zip(ours[0], ref[0])):
        assert g == r, step
    for step, (s_, r) in enumerate(zip(ours[1], ref[1])):
        assert s_ == r, step
    assert ours[2] == ref[2]
    if dry_run:
        assert ours[2] == [] and ours[0][-1]["autoscale/intents_total"] > 0
    else:
        # the script reaches every branch it was written for
        assert ours[2] == [("add", "c1:1", False), ("add", "c2:1", False),
                           ("preempt", "c2:1", None), ("add", "c3:1", False)]
        seen = {x for s_ in ours[1] for x in s_["last"]["suppressions"]}
        assert {"trends_invalid", "hold", "cooldown_add", "cooldown_drain",
                "rate_limited", "no_capacity"} <= seen
        assert [int(g["autoscale/degrade_tier"]) for g in ours[0]][10:13] \
            == [1, 2, 2]


def test_disabled_controllers_agree():
    cfg = dict(enabled=False, min_engines=2, max_engines=3)
    ours = _drive(t_autoscale, cfg, _SCRIPT[:4])
    ref = _drive(j_autoscale, cfg, _SCRIPT[:4])
    assert ours == ref and ours[2] == []


class _Handles:
    """Engine handles made by a market's factory, and adopted ones; logs
    kills and stops in order."""

    def __init__(self):
        self.log: list[tuple] = []
        self.n = 0

    def make(self, ep=None):
        outer = self
        if ep is None:
            self.n += 1
            ep = f"f{self.n}:1"

        class H:
            endpoint = ep

            def kill(self):
                outer.log.append(("kill", ep))

            def stop(self):
                outer.log.append(("stop", ep))

        return H()


def _replay(mod, events: list, adopt: list[str], upto: int):
    pool = _RecordingPool()
    handles = _Handles()
    market = mod.SpotMarket(
        pool, mod.SpotMarketConfig(enabled=True, grace_s=0.0,
                                   time_base="step"),
        engine_factory=handles.make, events=[dict(e) for e in events])
    for i, name in enumerate(adopt):
        market.adopt(name, handles.make(f"live{i}:1"))
    market.start()
    fired, acquired = [], []
    for step in range(upto + 1):
        fired.append(market.on_step(step))
        acquired.append(market.acquire())
    market.stop()
    return (fired, acquired, pool.calls, handles.log, market.counters(),
            market.done.is_set())


_STORM = [
    {"t": 1, "event": "offer", "name": "C"},
    {"t": 1, "event": "notice", "target": "A"},
    {"t": 3, "event": "kill", "target": "B"},
    {"t": 3, "event": "offer", "name": "D", "endpoint": "d:1"},
    {"t": 5, "event": "notice", "target": "C", "terminate": False},
    {"t": 5, "event": "offer", "name": "E"},
    {"t": 7, "event": "offer", "name": "F", "auto_add": True},
    {"t": 8, "event": "kill", "target": "nobody"},
]


def test_markets_agree_on_a_storm():
    ours = _replay(t_spotmarket, _STORM, ["A", "B"], 9)
    assert ours == _replay(j_spotmarket, _STORM, ["A", "B"], 9)
    assert ours[4] == {"fault/spot_offers": 4.0, "fault/spot_notices": 2.0,
                       "fault/spot_kills": 1.0}
    assert ours[5]


def test_markets_agree_on_the_example_trace():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "examples", "spot_trace.jsonl")
    events = t_spotmarket.load_trace(path)
    assert events == j_spotmarket.load_trace(path)
    ours = _replay(t_spotmarket, events, ["E0", "E1"], 6)
    assert ours == _replay(j_spotmarket, events, ["E0", "E1"], 6)
    assert ours[4]["fault/spot_notices"] == 2.0 and ours[5]


def _pushing(ep):
    """An engine out of the routing set while its weight push lands."""
    return {"endpoint": ep, "active": False, "healthy": True,
            "updating_weight": True, "draining": False, "is_local": False,
            "num_running_reqs": 0, "occupancy": 0.0}


def test_push_window_is_no_collapse():
    """With a weight fabric the manager empties its routing set at every
    version bump until each push lands. The reference's controller reads
    that window, where the trainer ticks, as a collapse (an envelope add,
    tier 2, the admission gate shut); the port counts the healthy engines
    taking the push and does nothing. A draining engine still counts out.
    """
    fleet = [_pushing("a:1"), _pushing("b:1")]
    cfg = dict(enabled=True, min_engines=2, max_engines=2,
               admission_max_wait_s=0.3)
    got = {}
    for name, mod in (("torch", t_autoscale), ("jax", j_autoscale)):
        pool = _RecordingPool(fleet)
        ctl = mod.AutoscaleController(
            pool, _Balance(**_VALID), mod.AutoscaleConfig(**cfg),
            capacity=_Capacity("c:1"))
        try:
            g = ctl.tick(1, fleet={"pool/active": 0.0})
            assert ctl.wait_idle()
            got[name] = (g, pool.calls, ctl.hold_admission())
        finally:
            ctl.close()
    g, calls, waited = got["torch"]
    assert g["autoscale/action"] == ACTIONS.index("none")
    assert g["autoscale/degrade_tier"] == 0.0 and calls == [] and waited == 0
    g, calls, waited = got["jax"]
    assert g["autoscale/reason"] == REASONS.index("below_min")
    assert g["autoscale/degrade_tier"] == 2.0 and calls == [
        ("add", "c:1", False)] and waited > 0
    # a draining engine is leaving: one engine left is below the envelope
    pool = _RecordingPool([_pushing("a:1"), dict(_pushing("b:1"),
                                                  draining=True)])
    ctl = AutoscaleController(pool, _Balance(**_VALID),
                              AutoscaleConfig(**cfg), capacity=_Capacity())
    try:
        ctl.tick(1, fleet={"pool/active": 0.0})
        assert ctl.statusz_section()["last"]["inputs"]["active"] == 1.0
        assert "no_capacity" in ctl.statusz_section()["last"]["suppressions"]
    finally:
        ctl.close()
