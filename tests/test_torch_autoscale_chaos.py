"""Closed-loop autoscaling on the port's trainer (a copy of
``tests/test_autoscale_chaos.py`` on the port: its tiny f32 model, its
manager build and ``tests/fake_engine.py``), the same spot storm through
both packages' trainers, and a server that joins the pool by its
endpoint alone.

The storm: two preemption notices (grace-window drains), one kill
without notice (heartbeat eviction and the manager's continuation), and
offers the controller turns into adds; a last ``auto_add`` offer pushes
the fleet above the envelope to provoke a proactive drain. The fit must
finish with no dropped group, ``fault/suffix_resumes > 0``, at least one
add and one drain, and the pool back at its size. With the controller
disabled, a depth-0 fit is bitwise the fit without one.

Parity: the storm through the port's trainer and through the JAX
package's gives the same ``autoscale/*`` and ``fault/spot_*`` gauges step
by step. So that each tick sees a settled fleet in both runs, the market's
and the controller's adds wait for the join, a kill waits for the
manager's eviction, and each tick waits for the controller's last action.
Their tokens may differ: the fake engines generate them.

The endpoint join: ``PoolManager.add_engine(endpoint=)`` (the
controller's adds) registers an engine by its endpoint alone. A rollout
server started without a manager has no weight receiver, so the fabric
could never push it the current version and the manager's bootstrap gate
would hold it out of routing; the pool now asks it to attach one
(``POST /attach_receiver``), and it joins at the trainer's version with
the trainer's weights.
"""

import time

import jax
import jax.numpy as jnp
import torch

from polyrl_tpu.data.dataset import PromptDataLoader as JLoader
from polyrl_tpu.data.dataset import make_arithmetic_dataset as j_dataset
from polyrl_tpu.manager.client import ManagerClient as JManagerClient
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rewards.manager import load_reward_manager as j_load_rm
from polyrl_tpu.rollout import autoscale as j_autoscale
from polyrl_tpu.rollout import faults as j_faults
from polyrl_tpu.rollout import pool as j_pool
from polyrl_tpu.rollout import remote as j_remote
from polyrl_tpu.rollout import spotmarket as j_spotmarket
from polyrl_tpu.trainer import actor as j_actor
from polyrl_tpu.trainer import stream_trainer as j_st
from polyrl_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from polyrl_tpu_torch import train
from polyrl_tpu_torch.config import load_config
from polyrl_tpu_torch.data.dataset import (PromptDataLoader,
                                           make_arithmetic_dataset)
from polyrl_tpu_torch.manager.client import (ManagerClient,
                                             spawn_rollout_manager)
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.rollout.autoscale import (AutoscaleConfig,
                                                AutoscaleController)
from polyrl_tpu_torch.rollout.faults import FaultInjectionConfig, FaultInjector
from polyrl_tpu_torch.rollout.pool import PoolConfig, PoolManager
from polyrl_tpu_torch.rollout.remote import RemoteRollout
from polyrl_tpu_torch.rollout.serve import create_server
from polyrl_tpu_torch.rollout.spotmarket import SpotMarket, SpotMarketConfig
from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor
from polyrl_tpu_torch.trainer.stream_trainer import (StreamRLTrainer,
                                                     TrainerConfig)
from polyrl_tpu_torch.transfer.layout import flatten_with_names
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer
from tests.fake_engine import FakeEngine

_FAST_ARGS = ["--health-check-interval-s", "0.1",
              "--stats-poll-interval-s", "0.1",
              "--heartbeat-failures", "2",
              "--generate-timeout-ms", "10000",
              "--schedule-wait-timeout-ms", "5000"]

_TCFG = dict(
    train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
    micro_batch_size=4, min_stream_batch_size=4,
    max_prompt_length=16, max_response_length=8,
    adv_estimator="grpo", temperature=1.0)

# step-paced (t = trainer step, fired from the controller's tick): two
# notices, one kill, four offers (the last forced on, over the [2, 2]
# envelope, to provoke a proactive drain)
_STORM = [
    {"t": 1, "event": "offer", "name": "C"},
    {"t": 1, "event": "notice", "target": "A"},
    {"t": 3, "event": "kill", "target": "B"},
    {"t": 3, "event": "offer", "name": "D"},
    {"t": 5, "event": "notice", "target": "C"},
    {"t": 5, "event": "offer", "name": "E"},
    {"t": 7, "event": "offer", "name": "F", "auto_add": True},
]

_ENVELOPE = dict(enabled=True, min_engines=2, max_engines=2, hold_steps=1,
                 cooldown_add_s=0.0, cooldown_drain_s=0.0,
                 max_actions_per_hour=100, admission_max_wait_s=5.0)


def _fake():
    return FakeEngine(start_token=30, token_delay_s=0.005).start()


def test_autoscale_chaos_spot_storm_fit():
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=_FAST_ARGS)
    mgr = ManagerClient(f"127.0.0.1:{port}")
    eng_a = FakeEngine(start_token=30, token_delay_s=0.01).start()
    eng_b = FakeEngine(start_token=30, token_delay_s=0.005).start()
    # one worst-moment manager-stream kill: the client-side salvage
    # ledger runs (fault/suffix_resumes) on top of the storm
    injector = FaultInjector(FaultInjectionConfig(
        enabled=True, stream_kill_times=1, stream_kill_min_progress=1))
    pool = PoolManager(mgr, PoolConfig(drain_grace_s=0.1))
    market = SpotMarket(
        pool, SpotMarketConfig(enabled=True, grace_s=0.1, time_base="step"),
        engine_factory=_fake, injector=injector,
        events=[dict(e) for e in _STORM])
    market.adopt("A", eng_a)
    market.adopt("B", eng_b)
    market.start()
    ctl = None
    try:
        mgr.wait_healthy()
        for e in (eng_a, eng_b):
            mgr.register_rollout_instance(e.endpoint)
        pool.wait_for_size(2)

        tok = ByteTokenizer()
        cfg = decoder.get_config("tiny", dtype=torch.float32)
        params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
        remote = RemoteRollout(mgr, pad_token_id=tok.pad_token_id,
                               resume_budget=3, resume_wait_s=10.0,
                               fault_injector=injector, pool=pool)
        ctl = AutoscaleController(pool, remote.balance,
                                  AutoscaleConfig(**_ENVELOPE),
                                  capacity=market, rollout=remote)
        actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
        trainer = StreamRLTrainer(
            TrainerConfig(total_steps=9, **_TCFG), actor, remote, tok,
            load_reward_manager("naive", tok, num_workers=1),
            PromptDataLoader(make_arithmetic_dataset(48), 4),
            autoscale=ctl)
        history = trainer.fit()

        assert len(history) == 9
        # the storm cost throughput, never training data
        assert remote.dropped_groups == 0
        counters = remote.fault_counters()
        assert counters["fault/suffix_resumes"] >= 1
        assert counters["fault/dropped_groups"] == 0
        # the whole trace replayed: 2 notices, 1 kill, 4 offers
        assert market.done.is_set()
        assert (market.notices, market.kills, market.offers) == (2, 1, 4)
        # the loop closed: an add from an offer and a proactive drain
        last = history[-1]
        assert last["autoscale/adds_total"] >= 1.0
        assert last["autoscale/drains_total"] >= 1.0
        assert last["autoscale/ticks"] == 9.0
        assert last["autoscale/enabled"] == 1.0
        # the spot counters rode the fault plane into the record
        assert last["fault/spot_notices"] == 2.0
        assert last["fault/spot_kills"] == 1.0
        assert ctl.wait_idle()
        pool.wait_for_size(2, deadline_s=20.0)
        snap = trainer.statusz_snapshot()
        assert snap["schema"] == "polyrl/statusz/v8"
        assert snap["autoscale"]["totals"]["adds"] >= 1
        assert snap["autoscale"]["totals"]["drains"] >= 1
        assert snap["autoscale"]["envelope"] == {"min": 2, "max": 2}
        assert snap["gauges"]["autoscale/ticks"] == 9.0
    finally:
        if ctl is not None:
            ctl.close()
        market.stop()
        proc.kill()
        pool.close()
        for e in (eng_a, eng_b):
            e.stop()


def _serial_fit(mgr, pool, tok, cfg, autoscale=None):
    """One 2-step depth-0 fit from a fixed seed; returns its records and
    final parameters."""
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    remote = RemoteRollout(mgr, pad_token_id=tok.pad_token_id,
                           resume_budget=3, resume_wait_s=10.0, pool=pool)
    actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
    kwargs = {} if autoscale is None else {"autoscale": autoscale}
    trainer = StreamRLTrainer(
        TrainerConfig(total_steps=2, **_TCFG), actor, remote, tok,
        load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(32), 4), **kwargs)
    history = trainer.fit()
    return history, dict(flatten_with_names(actor.export_params()))


def test_autoscale_disabled_is_bitwise_identical():
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=_FAST_ARGS)
    mgr = ManagerClient(f"127.0.0.1:{port}")
    eng = FakeEngine(start_token=30).start()
    pool = PoolManager(mgr, PoolConfig(drain_grace_s=0.1))
    ctl = None
    try:
        mgr.wait_healthy()
        mgr.register_rollout_instance(eng.endpoint)
        pool.wait_for_size(1)
        tok = ByteTokenizer()
        cfg = decoder.get_config("tiny", dtype=torch.float32)

        hist_a, params_a = _serial_fit(mgr, pool, tok, cfg)
        ctl = AutoscaleController(pool, None, AutoscaleConfig(enabled=False))
        hist_b, params_b = _serial_fit(mgr, pool, tok, cfg, autoscale=ctl)

        assert params_a.keys() == params_b.keys()
        for name, t in params_a.items():
            assert torch.equal(t, params_b[name]), name
        # the default path carries no autoscale keys; the disabled
        # controller records its inert gauges and never acts
        assert not any(k.startswith("autoscale/")
                       for rec in hist_a for k in rec)
        assert hist_b[-1]["autoscale/enabled"] == 0.0
        assert hist_b[-1]["autoscale/adds_total"] == 0.0
        assert hist_b[-1]["autoscale/drains_total"] == 0.0
        assert pool.preemptions == 0
        assert pool.hard_evictions == 0
    finally:
        if ctl is not None:
            ctl.close()
        proc.kill()
        pool.close()
        eng.stop()


# -- the storm through both trainers -------------------------------------------


class _SettledPool:
    """A pool whose adds wait until the engine is in the routing set."""

    def __init__(self, pool):
        self._pool = pool

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def add_engine(self, server=None, endpoint="", wait=True, **kw):
        return self._pool.add_engine(server=server, endpoint=endpoint,
                                     wait=True, deadline_s=30.0)


class _EvictedOnKill:
    """An engine handle whose kill returns once the manager evicted it."""

    def __init__(self, eng, pool):
        self.eng, self.pool = eng, pool
        self.endpoint = eng.endpoint

    def kill(self):
        self.eng.kill()
        t0 = time.monotonic()
        while any(i.get("endpoint") == self.endpoint
                  and (i.get("active") or i.get("healthy"))
                  for i in self.pool.engines()):
            assert time.monotonic() - t0 < 30.0, "the kill was never evicted"
            time.sleep(0.05)

    def stop(self):
        self.eng.stop()


class _TickAfterIdle:
    """The controller, each tick waiting for its last action to finish."""

    def __init__(self, ctl):
        self._ctl = ctl

    def __getattr__(self, name):
        return getattr(self._ctl, name)

    def tick(self, *a, **kw):
        assert self._ctl.wait_idle(30.0)
        return self._ctl.tick(*a, **kw)


def _storm_fit(pkg: str) -> tuple[list, dict]:
    """The storm through one package's trainer on a fresh manager and fake
    engines; returns the records and the last fault counters."""
    if pkg == "torch":
        mods = dict(mc=ManagerClient, pool=PoolManager, pcfg=PoolConfig,
                    fi=FaultInjector, ficfg=FaultInjectionConfig,
                    market=SpotMarket, mcfg=SpotMarketConfig,
                    ctl=AutoscaleController, acfg=AutoscaleConfig,
                    remote=RemoteRollout)
    else:
        mods = dict(mc=JManagerClient, pool=j_pool.PoolManager,
                    pcfg=j_pool.PoolConfig, fi=j_faults.FaultInjector,
                    ficfg=j_faults.FaultInjectionConfig,
                    market=j_spotmarket.SpotMarket,
                    mcfg=j_spotmarket.SpotMarketConfig,
                    ctl=j_autoscale.AutoscaleController,
                    acfg=j_autoscale.AutoscaleConfig,
                    remote=j_remote.RemoteRollout)
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=_FAST_ARGS)
    mgr = mods["mc"](f"127.0.0.1:{port}")
    engines = [_fake(), _fake()]
    injector = mods["fi"](mods["ficfg"](
        enabled=True, stream_kill_times=1, stream_kill_min_progress=1))
    pool = mods["pool"](mgr, mods["pcfg"](drain_grace_s=0.1))
    settled = _SettledPool(pool)
    made: list = []

    def factory():
        h = _EvictedOnKill(_fake(), pool)
        made.append(h)
        return h

    market = mods["market"](
        settled, mods["mcfg"](enabled=True, grace_s=0.1, time_base="step"),
        engine_factory=factory, injector=injector,
        events=[dict(e) for e in _STORM])
    market.adopt("A", _EvictedOnKill(engines[0], pool))
    market.adopt("B", _EvictedOnKill(engines[1], pool))
    market.start()
    ctl = None
    try:
        mgr.wait_healthy()
        for e in engines:
            mgr.register_rollout_instance(e.endpoint)
        pool.wait_for_size(2)
        if pkg == "torch":
            tok = ByteTokenizer()
            cfg = decoder.get_config("tiny", dtype=torch.float32)
            actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False),
                                decoder.init_params(
                                    torch.Generator().manual_seed(0), cfg))
            trainer_cls, tcfg_cls = StreamRLTrainer, TrainerConfig
            rm = load_reward_manager("naive", tok, num_workers=1)
            loader = PromptDataLoader(make_arithmetic_dataset(48), 4)
        else:
            tok = JByteTokenizer()
            cfg = jdec.get_config("tiny", dtype=jnp.float32)
            actor = j_actor.StreamActor(
                cfg, j_actor.ActorConfig(lr=1e-4, remat=False),
                jdec.init_params(jax.random.PRNGKey(0), cfg))
            trainer_cls, tcfg_cls = j_st.StreamRLTrainer, j_st.TrainerConfig
            rm = j_load_rm("naive", tok, num_workers=1)
            loader = JLoader(j_dataset(48), 4)
        remote = mods["remote"](mgr, pad_token_id=tok.pad_token_id,
                                resume_budget=3, resume_wait_s=10.0,
                                fault_injector=injector, pool=pool)
        ctl = mods["ctl"](settled, remote.balance,
                          mods["acfg"](**_ENVELOPE), capacity=market,
                          rollout=remote)
        trainer = trainer_cls(tcfg_cls(total_steps=9, **_TCFG), actor,
                              remote, tok, rm, loader,
                              autoscale=_TickAfterIdle(ctl))
        history = trainer.fit()
        assert ctl.wait_idle()
        return history, remote.fault_counters()
    finally:
        if ctl is not None:
            ctl.close()
        market.stop()
        proc.kill()
        pool.close()
        for e in engines:
            e.stop()


def test_spot_storm_gauges_match_the_reference():
    ours, ours_faults = _storm_fit("torch")
    ref, ref_faults = _storm_fit("jax")
    assert len(ours) == len(ref) == 9

    def gauges(rec):
        return {k: v for k, v in rec.items()
                if k.startswith(("autoscale/", "fault/spot_"))}

    for step, (a, b) in enumerate(zip(ours, ref), 1):
        assert gauges(a) == gauges(b), step
        assert len(gauges(a)) == 16, sorted(gauges(a))
    assert ours[-1]["autoscale/adds_total"] == 3.0
    assert ours[-1]["autoscale/drains_total"] == 1.0
    assert ours[-1]["fault/spot_offers"] == 4.0
    for faults in (ours_faults, ref_faults):
        assert faults["fault/dropped_groups"] == 0
        assert faults["fault/suffix_resumes"] >= 1


# -- a server that joins by its endpoint ----------------------------------------


def test_endpoint_join_catches_up_to_the_trainers_version():
    proc, port = spawn_rollout_manager(
        "127.0.0.1:0", extra_args=["--health-check-interval-s", "0.1",
                                   "--stats-poll-interval-s", "0.2"])
    # a server with no manager: no receiver until the pool adds it
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=256, num_pages=64,
                        prompt_buckets=(16, 32))
    cleanup: list = []
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        ep = mgr.endpoint.replace("http://", "")
        cfg = load_config(None, [
            "device=cpu", "model.preset=tiny", "model.dtype=float32",
            "trainer.seed=3", "rollout.mode=disaggregated",
            f"rollout.manager_endpoint={ep}", "rollout.transfer_streams=2",
            "trainer.train_batch_size=4", "trainer.rollout_n=2",
            "trainer.ppo_mini_batch_size=8", "trainer.micro_batch_size=4",
            "trainer.min_stream_batch_size=4",
            "trainer.max_prompt_length=16", "trainer.max_response_length=8",
            "actor.remat=false", "data.arithmetic_size=16"])
        trainer = train.build_trainer(cfg, cleanup)
        params = trainer.actor.export_params()
        version = trainer.rollout.update_weights(params)
        assert srv.receiver is None and srv.engine.weight_version < version
        t0 = time.monotonic()
        trainer.rollout.pool.add_engine(endpoint=srv.endpoint, wait=True,
                                        deadline_s=30.0)
        joined_s = time.monotonic() - t0
        assert srv.receiver is not None
        assert srv.manager_endpoint == ep
        assert srv.engine.weight_version == version
        served = dict(flatten_with_names(srv.engine.params))
        for name, t in flatten_with_names(params):
            assert torch.equal(served[name], t), name
        assert joined_s < 30.0
        res = mgr.generate("joined", [5, 3, 9, 2],
                           {"temperature": 0.0, "max_new_tokens": 4})
        assert res.success and res.output_token_weight_versions == [version] * 4
    finally:
        for fn in reversed(cleanup):
            fn()
        proc.kill()
        proc.wait(timeout=10)
        srv.stop()


def test_a_departed_engine_does_not_hold_the_next_push():
    """A preempted engine can leave mid-push (the manager evicts a remote
    whose stream ends in an abort terminal and shuts it down). Its push
    then fails, and the sender drops it once the manager no longer lists
    it, so the next version reaches the survivor at once. Before, the
    round waited out the verify deadline and the retry budget (about 4
    minutes for a 3.4 GB tree on the card), holding every later push."""
    proc, port = spawn_rollout_manager(
        "127.0.0.1:0", extra_args=["--health-check-interval-s", "0.1",
                                   "--stats-poll-interval-s", "0.2"])
    servers: list = []
    cleanup: list = []
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        ep = mgr.endpoint.replace("http://", "")
        x_port = _free_port()
        cfg = load_config(None, [
            "device=cpu", "model.preset=tiny", "model.dtype=float32",
            "rollout.mode=disaggregated", f"rollout.manager_endpoint={ep}",
            "rollout.transfer_streams=2", "transfer.fault_injection.enabled=true",
            "transfer.fault_injection.stall_s=3.0",
            f"transfer.fault_injection.stall_instance=:{x_port}",
            "transfer.fault_injection.stall_after_attempts=1",
            "actor.remat=false", "data.arithmetic_size=16"])
        trainer = train.build_trainer(cfg, cleanup)
        remote = trainer.rollout
        for p_ in (x_port, 0):
            servers.append(create_server(
                "tiny", device="cpu", host="127.0.0.1", port=p_,
                dtype="float32", max_slots=4, page_size=8, max_seq_len=64,
                num_pages=32, prompt_buckets=(16,), manager_endpoint=ep,
                transfer_streams=2))
        x, y = servers
        params = trainer.actor.export_params()
        v1 = remote.update_weights(params)  # clean: both land it
        for s_ in servers:
            _wait_version(s_, v1)
        v2 = remote.update_weights(params)  # x's streams stall 3 s
        time.sleep(0.5)
        x.stop()  # x leaves mid-push, as the manager's /shutdown does
        mgr.deregister_rollout_instance(x.endpoint, drained=False)
        _wait_version(y, v2)
        t0 = time.monotonic()
        v3 = remote.update_weights(params)
        _wait_version(y, v3, deadline=60.0)
        took = time.monotonic() - t0
        sender = remote.transfer.sender
        assert took < 15.0, took
        assert sender.laggard_escalations == 0
        assert sender.push_failures >= 1
    finally:
        for fn in reversed(cleanup):
            fn()
        for s_ in servers:
            s_.stop()
        proc.kill()
        proc.wait(timeout=10)


def _free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def _wait_version(srv, version: int, deadline: float = 30.0) -> None:
    t0 = time.monotonic()
    while srv.engine.weight_version < version:
        assert time.monotonic() - t0 < deadline, (
            f"{srv.endpoint} at v{srv.engine.weight_version}, not v{version}")
        time.sleep(0.05)
