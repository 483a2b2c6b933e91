"""The port's engine flight deck (``rollout/flightdeck.py``) on the CPU.

Mirrors ``tests/test_flight_deck.py``: the throughput EWMA, the deck's
reconciliation and dispatch bounds, then the deck against the JAX
package's on one event sequence (every count, ratio and gauge that does
not read the clock, exactly); on the port's ``CBEngine`` (``tiny``, f32)
the token reconciliation after completion and under abort-salvage churn
(the aborts driven on an unstarted engine, so nothing races) and the spec
acceptance gauge; and a ``tiny`` server whose ``/get_server_info``
carries ``occupancy`` and ``device_frac``, which the port's
``PoolManager`` aggregates into ``engine/occupancy`` and
``engine/device_frac``.
"""

import http.client
import json
import time

import numpy as np
import pytest
import torch

from polyrl_tpu.rollout import flightdeck as jdeck
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.flightdeck import EngineFlightDeck, ThroughputEWMA
from polyrl_tpu_torch.rollout.pool import PoolConfig, PoolManager
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.server import RolloutServer

from tests.torch_engine_util import abort_driven, drain, quiesce


# -- units --------------------------------------------------------------------


def test_throughput_ewma_seeds_and_smooths():
    ew = ThroughputEWMA(tau_s=5.0)
    assert ew.update(100.0, now=0.0) == 100.0  # the first sample seeds
    v = ew.update(1000.0, now=0.5)
    assert 100.0 < v < 200.0
    v = ew.update(1000.0, now=60.0)
    assert v > 990.0
    ew.reset()
    assert ew.value == 0.0 and ew.update(7.0, now=0.0) == 7.0


def test_deck_reconciliation_and_idempotent_finalize():
    deck = EngineFlightDeck(max_slots=4, num_pages=65, page_size=8)
    deck.on_admit(0, "r0", time.monotonic() - 0.5, prompt_tokens=10)
    deck.on_first_token(0)
    deck.on_emitted(1)
    for _ in range(3):
        deck.on_decode(0)
    deck.on_emitted(3)
    assert deck.attributed_frac() < 1.0  # in flight: not yet attributed
    deck.on_finalize(0)
    deck.on_finalize(0)  # a double finalize folds once
    assert deck.req_prefill_tokens == deck.sched_prefill_tokens == 10
    assert deck.req_decode_tokens == deck.sched_decode_tokens == 4
    assert deck.attributed_frac() == 1.0
    assert deck.requests_finished == 1
    for name in ("queue_wait_s", "ttft_s", "tpot_s"):
        assert deck.hists[name].count == 1
    assert deck.hists["queue_wait_s"].vmax >= 0.5


def test_deck_dispatch_bounds():
    deck = EngineFlightDeck(max_slots=8, num_pages=17, page_size=8)
    deck.on_dispatch(active=99, free_pages=0, cache_pages=3, run_ahead=5,
                     queued=2)
    assert deck.occupancy_last == 1.0 and deck.occupancy_ewma == 1.0
    assert deck.page_util_last == 1.0
    deck.on_dispatch(active=4, free_pages=16, cache_pages=0, run_ahead=0,
                     queued=0)
    assert deck.occupancy_last == 0.5
    assert deck.page_util_last == 0.0
    assert deck.page_util_peak == 1.0
    info = deck.server_info_fields()
    assert 0.0 <= info["occupancy"] <= 1.0
    assert info["page_util_peak"] == 1.0


# fields of server_info_fields that read the clock (latency percentiles)
TIMED = {"ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
         "queue_wait_p95_s"}


@pytest.mark.parametrize("seed", [0, 1])
def test_deck_matches_the_references(seed):
    rng = np.random.default_rng(seed)
    decks = [EngineFlightDeck(8, 33, 8), jdeck.EngineFlightDeck(8, 33, 8)]
    t0 = time.monotonic()
    for _ in range(300):
        kind = rng.integers(8)
        slot = int(rng.integers(8))
        args = {
            0: ("on_admit", (slot, f"r{slot}", t0, int(rng.integers(1, 64)),
                             int(rng.integers(0, 16)))),
            1: ("on_first_token", (slot,)),
            2: ("on_decode", (slot, int(rng.integers(1, 4)))),
            3: ("on_emitted", (int(rng.integers(0, 9)),)),
            4: ("on_finalize", (slot,)),
            5: ("on_dispatch", (int(rng.integers(0, 10)),
                                int(rng.integers(0, 33)),
                                int(rng.integers(0, 20)),
                                int(rng.integers(0, 16)),
                                int(rng.integers(0, 5)))),
            6: ("on_kv_read", (int(rng.integers(0, 50)),
                               int(rng.integers(50, 90)),
                               int(rng.integers(1, 9)))),
            7: ("on_admit_wave", (int(rng.integers(1, 9)),)),
        }[int(kind)]
        for d in decks:
            getattr(d, args[0])(*args[1])
        if rng.integers(10) == 0:
            for d in decks:
                d.on_salvage(slot)
    ours, ref = decks
    a, b = ours.server_info_fields(), ref.server_info_fields()
    assert {k: v for k, v in a.items() if k not in TIMED} \
        == {k: v for k, v in b.items() if k not in TIMED}
    for attr in ("req_prefill_tokens", "req_decode_tokens",
                 "sched_prefill_tokens", "sched_decode_tokens",
                 "cached_prompt_tokens", "requests_finished",
                 "requests_salvaged", "decode_dispatches", "admit_waves",
                 "occupancy_ewma", "page_util_peak", "kv_pages_streamed"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert ours.hists["occupancy"].buckets == ref.hists["occupancy"].buckets


# -- the port's engine --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, decoder.init_params(gen, cfg)


def _mk_engine(tiny, **kw):
    cfg, params = tiny
    defaults = dict(max_slots=4, page_size=8, max_seq_len=128,
                    prompt_buckets=(16, 32), num_pages=64,
                    kv_cache_dtype=torch.float32, device="cpu")
    defaults.update(kw)
    return CBEngine(cfg, params, **defaults)


def _assert_deck_invariants(engine):
    d = engine.deck
    assert (d.req_prefill_tokens + d.req_decode_tokens
            == d.sched_prefill_tokens + d.sched_decode_tokens)
    assert d.attributed_frac() == 1.0
    assert 0.0 <= d.occupancy_last <= 1.0
    assert 0.0 <= d.occupancy_ewma <= 1.0
    assert 0.0 <= d.page_util_peak <= 1.0
    assert d.hists["occupancy"].vmax <= 1.0
    assert d.hists["page_util"].vmax <= 1.0


def test_deck_reconciles_after_completion(tiny):
    engine = _mk_engine(tiny)
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    # 8 requests over 4 slots: the second wave queues
    outs = [engine.submit(f"r{i}", [3 + i, 7, 11], sp) for i in range(8)]
    engine.start()
    try:
        for q in outs:
            toks, reason = drain(q)
            assert reason == "length" and len(toks) == 6
        quiesce(engine)
    finally:
        engine.stop()
    d = engine.deck
    _assert_deck_invariants(engine)
    assert d.requests_finished == 8
    assert d.req_prefill_tokens == 8 * 3
    assert d.req_decode_tokens == 8 * 6
    assert d.hists["ttft_s"].count == 8
    assert d.hists["queue_wait_s"].count == 8
    assert d.decode_dispatches > 0
    assert d.admit_waves >= 2  # 8 requests cannot admit in one 4-slot wave
    info = d.server_info_fields()
    assert info["ttft_p95_s"] > 0.0
    assert info["attributed_frac"] == 1.0


def test_deck_reconciles_under_abort_salvage_churn(tiny):
    engine = _mk_engine(tiny, max_seq_len=512, num_pages=128,
                        prompt_buckets=(16, 32, 64), steps_per_dispatch=2,
                        pipeline_depth=4)
    try:
        for i in range(2):
            toks, reason = abort_driven(engine, [5 + i, 6, 7], rid=f"a{i}")
            assert reason == "abort" and toks
        engine.start()
        sp = SamplingParams(temperature=0.0, max_new_tokens=5)
        normal = [engine.submit(f"n{i}", [9 + i, 2], sp) for i in range(3)]
        for q in normal:
            toks, _ = drain(q)
            assert len(toks) == 5
        quiesce(engine)
    finally:
        engine.stop()
    d = engine.deck
    _assert_deck_invariants(engine)
    assert d.requests_finished == 5
    assert d.requests_salvaged == 2  # both aborts took the salvage path
    assert all(s is None for s in engine._slots)
    assert engine.allocator.free_count == engine.num_pages - 1


def test_spec_accept_rate_gauge(tiny):
    engine = _mk_engine(tiny, spec_tokens=2, spec_rounds=2)
    server = RolloutServer(engine, host="127.0.0.1", port=0)
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    outs = [engine.submit(f"s{i}", [3, 7, 11, 13], sp) for i in range(2)]
    engine.start()
    try:
        for q in outs:
            toks, _ = drain(q)
            assert len(toks) == 8
        quiesce(engine)
    finally:
        engine.stop()
    assert engine.spec_dispatches > 0
    assert engine.spec_token_ceiling >= engine.spec_emitted > 0
    assert 0.0 < engine.spec_accept_rate <= 1.0
    info = server.server_info()
    assert info["spec_accept_rate"] == round(engine.spec_accept_rate, 4)
    assert engine.deck.kv_read_tokens > 0
    _assert_deck_invariants(engine)


class _StubManagerClient:
    """get_instances_status from given instance rows (the manager's
    forwarding of server_info fields, without a manager)."""

    def __init__(self, instances):
        self.instances = instances

    def get_instances_status(self):
        return {"instances": self.instances,
                "pool": {"registered": len(self.instances),
                         "active": len(self.instances), "pending": 0,
                         "joins": len(self.instances), "evictions": 0,
                         "drain_departures": 0}}


def _get_server_info(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/get_server_info")
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


def test_server_reports_occupancy_and_device_frac_to_the_pool(tiny):
    """A tiny server's ``/get_server_info`` carries the deck's
    ``occupancy``, the profiler's ``device_frac`` and the memory plane's
    fields after it served; the port's ``PoolManager`` aggregates two such
    rows into ``engine/occupancy`` (mean) and ``engine/device_frac``
    (minimum)."""
    engine = _mk_engine(tiny)
    server = RolloutServer(engine, host="127.0.0.1", port=0).start()
    try:
        sp = SamplingParams(temperature=0.0, max_new_tokens=16)
        engine.generate([[3 + i, 7, 11] for i in range(4)], sp)
        quiesce(engine)
        info = _get_server_info(server.port)
    finally:
        server.stop()
    assert info["occupancy"] > 0.0 and info["device_frac"] > 0.0
    assert {"host_overhead_frac", "accounting_frac", "loop_attributed_frac",
            "kv_cold_page_frac", "kv_spilled_frac",
            "memory/attributed_frac"} <= set(info)
    rows = [{"endpoint": "a:1", "healthy": True, "active": True, **info},
            {"endpoint": "b:2", "healthy": True, "active": True,
             "occupancy": 0.25, "device_frac": 0.01}]
    pool = PoolManager(_StubManagerClient(rows), PoolConfig())
    try:
        c = pool.counters()
    finally:
        pool.close()
    assert c["engine/occupancy"] == pytest.approx(
        (info["occupancy"] + 0.25) / 2)
    assert c["engine/device_frac"] == pytest.approx(
        min(info["device_frac"], 0.01))
