"""The port's engine-loop profiler (``obs/engine_profile.py``) on the CPU.

Mirrors ``tests/test_engine_profile.py``: the unit cases under an injected
clock, each run on the port's profiler and the JAX package's on the same
clock and held equal (a partition exact with nested phases, the residual
in ``other``, the flip window's device/host split, the taxonomy, a phase
on another thread); on the port's ``CBEngine`` (``tiny``, f32) the
attribution under completion and salvage-abort churn, the accounting
phases under 15% of the busy wall with every plane on, and
``loop_profile=False`` bitwise the same sampled outputs. Last, the
balancer feed: a disaggregated fit through the port's manager and a
``tiny`` server, whose step records carry the servers' ``occupancy`` and
``device_frac`` as ``engine/*`` and whose balance estimator sees them
(non-zero slopes; its cold-window guard zeroes every slope below three
steps, so the fit runs three).
"""

import threading

import pytest
import torch

from polyrl_tpu.obs import engine_profile as jprofile
from polyrl_tpu_torch import train
from polyrl_tpu_torch.config import load_config
from polyrl_tpu_torch.manager.client import ManagerClient, spawn_rollout_manager
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.obs.engine_profile import (ACCOUNTING_PHASES,
                                                 DEVICE_PHASES, PHASES,
                                                 EngineLoopProfiler)
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.serve import create_server, register_with_manager

from tests.torch_engine_util import abort_driven, drain, quiesce


class _FakeClock:
    """A monotonic clock the partition tests drive by hand."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt: float):
        self.t += dt


def _both(window_s: float = 1e9):
    """The port's and the reference's profiler, each on its own fake
    clock; ``script(prof, clock)`` runs on both."""
    out = []
    for cls in (EngineLoopProfiler, jprofile.EngineLoopProfiler):
        clock = _FakeClock()
        out.append((cls(window_s=window_s, clock=clock), clock))
    return out


def _same(ours, ref):
    assert ours.totals == ref.totals
    assert ours.counts == ref.counts
    assert (ours.iters, ours.wall_s) == (ref.iters, ref.wall_s)
    assert ours.window_fracs() == ref.window_fracs()
    assert ours.server_info_fields() == ref.server_info_fields()
    assert ours.snapshot() == ref.snapshot()


def _nested(prof, clock):
    with prof.iteration():
        with prof.phase("collect_wave"):
            clock.advance(1.0)
            with prof.phase("accounting"):
                clock.advance(0.5)
            clock.advance(0.25)
        with prof.phase("decode_dispatch_device"):
            clock.advance(2.0)
        with prof.phase("idle"):
            clock.advance(0.25)


def test_partition_exact_with_nested_phases():
    """Nested wall is charged to the nested phase only, every second
    lands somewhere, and attributed_frac is exactly 1.0."""
    (ours, c1), (ref, c2) = _both()
    _nested(ours, c1)
    _nested(ref, c2)
    _same(ours, ref)
    assert ours.wall_s == pytest.approx(4.0)
    assert ours.totals["collect_wave"] == pytest.approx(1.25)  # self-time
    assert ours.totals["accounting"] == pytest.approx(0.5)
    assert ours.totals["other"] == 0.0
    assert ours.attributed_frac() == pytest.approx(1.0)
    snap = ours.snapshot()
    assert sum(snap["phase_frac"].values()) == pytest.approx(1.0, abs=1e-3)
    assert snap["phase_n"]["accounting"] == 1
    assert snap["latency"]["decode_dispatch_device"]["count"] == 1.0


def _residual(prof, clock):
    with prof.iteration():
        with prof.phase("emit"):
            clock.advance(1.0)
        clock.advance(3.0)  # wall no phase claims


def test_unattributed_residual_lands_in_other():
    (ours, c1), (ref, c2) = _both()
    _residual(ours, c1)
    _residual(ref, c2)
    _same(ours, ref)
    assert ours.totals["other"] == pytest.approx(3.0)
    assert ours.attributed_frac() == pytest.approx(0.25)


def _flip(prof, clock):
    with prof.iteration():
        with prof.phase("decode_dispatch_device"):
            clock.advance(2.0)
        with prof.phase("idle"):
            clock.advance(1.0)
        with prof.phase("accounting"):
            clock.advance(1.0)
    with prof.iteration():
        with prof.phase("sample_fetch"):
            clock.advance(2.0)


def test_window_flip_and_device_host_split():
    (ours, c1), (ref, c2) = _both(window_s=8.0)  # flips at 4 s
    _flip(ours, c1)
    _flip(ref, c2)
    _same(ours, ref)
    w = ours.window_fracs()
    assert w["wall_s"] == pytest.approx(6.0)
    assert w["device_frac"] == pytest.approx(4.0 / 6.0)
    assert w["idle_frac"] == pytest.approx(1.0 / 6.0)
    assert w["accounting_frac"] == pytest.approx(1.0 / 6.0)
    assert w["device_frac"] + w["host_overhead_frac"] + w["idle_frac"] \
        == pytest.approx(1.0)
    fields = ours.server_info_fields()
    assert set(fields) == {"device_frac", "host_overhead_frac",
                           "accounting_frac", "loop_attributed_frac"}
    assert all("/" not in k for k in fields)


def test_phase_taxonomy():
    assert PHASES == jprofile.PHASES and PHASES[-1] == "other"
    assert DEVICE_PHASES == jprofile.DEVICE_PHASES < set(PHASES)
    assert ACCOUNTING_PHASES == jprofile.ACCOUNTING_PHASES < set(PHASES)
    assert not DEVICE_PHASES & ACCOUNTING_PHASES


def _cross_thread(prof, clock):
    def fetcher():
        with prof.phase("sample_fetch"):
            pass

    with prof.iteration():
        with prof.phase("emit"):
            clock.advance(1.0)
        t = threading.Thread(target=fetcher)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()


def test_cross_thread_phase_does_not_corrupt_iteration():
    (ours, c1), (ref, c2) = _both()
    _cross_thread(ours, c1)
    _cross_thread(ref, c2)
    _same(ours, ref)
    assert ours.counts["sample_fetch"] == 1
    assert ours.wall_s == pytest.approx(1.0)
    assert ours.attributed_frac() == pytest.approx(1.0)


# -- the port's engine --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, decoder.init_params(gen, cfg)


def _mk_engine(tiny, **kw):
    cfg, params = tiny
    defaults = dict(max_slots=4, page_size=8, max_seq_len=512,
                    prompt_buckets=(16, 32, 64), num_pages=128,
                    steps_per_dispatch=2, pipeline_depth=4,
                    kv_cache_dtype=torch.float32, device="cpu")
    defaults.update(kw)
    return CBEngine(cfg, params, **defaults)


def test_real_engine_attribution_under_churn(tiny):
    """On the port's engine under salvage-abort and completion churn the
    phases partition the loop wall (never double-counted) and the flat
    profiler fields ride server_info."""
    eng = _mk_engine(tiny)
    try:
        # driven on this thread, outside any loop iteration: its phases
        # count in the totals but not in the loop's wall
        abort_driven(eng, [7, 9, 11, 13] * 4)
        outside = sum(eng.profiler.totals.values())
        eng.start()
        sp = SamplingParams(temperature=0.0, max_new_tokens=8)
        for i in range(3):
            toks, _ = drain(eng.submit(f"p{i}", [i + 1] * 16, sp))
            assert len(toks) == 8
        quiesce(eng)
    finally:
        eng.stop()
    prof = eng.profiler
    assert prof is not None and prof.iters > 0
    # the exact partition is pinned by the fake-clock cases; here the
    # loop's own clocks run, and a loaded machine preempts between phases
    assert 0.90 <= prof.attributed_frac() <= 1.0 + 1e-6
    snap = eng.loop_profile_snapshot()
    assert snap["enabled"] is True
    assert (sum(prof.totals.values()) - outside
            <= snap["wall_s"] * 1.05 + 1e-6)
    assert snap["phase_n"]["collect_wave"] > 0
    assert snap["phase_n"]["decode_dispatch_device"] > 0
    info = eng.loop_profile_info()
    assert set(info) == {"device_frac", "host_overhead_frac",
                         "accounting_frac", "loop_attributed_frac"}
    assert info["device_frac"] > 0.0


def test_accounting_overhead_under_budget(tiny):
    """With every plane on (the defaults), the accounting phases take
    under 15% of the loop's busy wall (idle excluded)."""
    eng = _mk_engine(tiny, max_seq_len=128, num_pages=64,
                     steps_per_dispatch=8, pipeline_depth=16)
    assert eng.kvledger is not None and eng.kvspill is not None
    assert eng.profiler is not None
    eng.start()
    try:
        sp = SamplingParams(temperature=0.0, max_new_tokens=16)
        qs = [eng.submit(f"b{i}", [i + 1, i + 2, i + 3] * 3, sp)
              for i in range(8)]
        for q in qs:
            drain(q)
        quiesce(eng)
    finally:
        eng.stop()
    snap = eng.loop_profile_snapshot()
    busy = snap["wall_s"] - snap["phase_s"]["idle"]
    acct = sum(snap["phase_s"][p] for p in ACCOUNTING_PHASES)
    assert busy > 0.0
    assert acct / busy < 0.15, snap["phase_s"]


def test_loop_profile_off_is_bitwise_identical(tiny):
    """loop_profile=False removes only clocks: sampled outputs (which
    depend on the generator) are bitwise the same with the profiler on or
    off, and the off engine reports the disabled shapes."""
    sp = SamplingParams(temperature=0.8, top_p=0.9, max_new_tokens=12)
    prompts = [[5, 3, 9] * 4, [11, 4] * 8, [42] * 16]
    outs = {}
    for on in (True, False):
        eng = _mk_engine(tiny, loop_profile=on, seed=7)
        try:
            outs[on] = eng.generate(prompts, sp)
        finally:
            eng.stop()
        assert (eng.profiler is not None) == on
    assert eng.loop_profile_info() == {}
    assert eng.loop_profile_snapshot() == {"enabled": False}
    for a, b in zip(outs[True], outs[False]):
        assert a["token_ids"] == b["token_ids"]
        assert a["logprobs"] == b["logprobs"]
        assert a["finish_reason"] == b["finish_reason"]


# -- the balancer feed --------------------------------------------------------


def test_disaggregated_fit_feeds_occupancy_and_device_frac_to_the_balancer():
    """Three serial GRPO steps through ``build_trainer`` with
    ``rollout.mode=disaggregated`` (the port's manager, a ``tiny`` server
    on localhost): the manager forwards the server's ``occupancy`` and
    ``device_frac``, the pool aggregates them into each step record's
    ``engine/occupancy`` and ``engine/device_frac``, and the next step's
    balancer round passes them to the estimator, whose trends read
    non-zero slopes for both."""
    proc, port = spawn_rollout_manager(
        "127.0.0.1:0", extra_args=["--health-check-interval-s", "0.1",
                                   "--stats-poll-interval-s", "0.1"])
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=256, num_pages=128,
                        prompt_buckets=(16, 32))
    cleanup: list = []
    try:
        ep = f"127.0.0.1:{port}"
        ManagerClient(ep).wait_healthy()
        cfg = load_config(None, [
            "device=cpu", "model.preset=tiny", "model.dtype=float32",
            "rollout.mode=disaggregated", f"rollout.manager_endpoint={ep}",
            "rollout.transfer_streams=2", "trainer.train_batch_size=4",
            "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=8",
            "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
            "trainer.max_prompt_length=16", "trainer.max_response_length=8",
            "trainer.total_steps=3", "trainer.seed=1", "actor.lr=1e-3",
            "actor.remat=false", "data.arithmetic_size=16"])
        trainer = train.build_trainer(cfg, cleanup)
        register_with_manager(srv, ep, transfer_streams=2)
        trainer.rollout.pool.wait_for_member(srv.endpoint, 30.0, active=False)
        history = trainer.fit()
        assert len(history) == 3
        for rec in history:
            assert rec["engine/occupancy"] > 0.0
            assert rec["engine/device_frac"] > 0.0
        seen = list(trainer.rollout.balance._steps)
        assert [s["occupancy"] for s in seen] == \
            [0.0] + [rec["engine/occupancy"] for rec in history[:-1]]
        assert [s["device_frac"] for s in seen] == \
            [0.0] + [rec["engine/device_frac"] for rec in history[:-1]]
        trends = trainer.rollout.balance.trends()
        assert trends["balance_trends_valid"] == 1.0
        assert trends["occupancy_slope"] != 0.0
        assert trends["device_frac_slope"] != 0.0
    finally:
        for fn in reversed(cleanup):
            fn()
        proc.kill()
        proc.wait(timeout=10)
        srv.stop()
