"""The port's KV page ledger (``rollout/kvledger.py``) on the CPU.

The ledger itself against the JAX package's on one event sequence (role
counts, tiers, causes, histograms and the server_info fields other than
the HBM ones, exactly); then the port's ``CBEngine`` with the ledger on
(its default), mirroring ``tests/test_kv_ledger.py``: exact
reconciliation against the allocator free list and the prefix cache at
quiescence under completion, salvage-abort and flush churn and under a
plain abort, the flat memory fields in ``/get_server_info``, published
pages going cold within the budget, and ``kv_ledger=False`` bitwise the
same sampled outputs. The reference's churn and abort tests race the
abort against the stream's end; here the aborts are driven on an unstarted
engine and every check waits on quiescence (no active slot, nothing
pending or in flight, read under the dispatch lock), never on a sleep.
On ``tiny`` in f32.
"""

import numpy as np
import pytest
import torch

from polyrl_tpu.rollout import kvledger as jledger
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rollout import kvledger
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.pool import PoolManager
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.server import RolloutServer

from tests.torch_engine_util import abort_driven, drain, quiesce

HBM_KEYS = {"hbm_used_gb", "hbm_unaccounted_gb", "hbm_headroom_gb"}


# -- the ledger against the reference's ---------------------------------------


def _ledger_events(rng, num_pages: int, n: int):
    """A random sequence of ledger events over pages 1..num_pages-1 (the
    ledgers' guards make any order legal)."""
    causes = jledger.FREE_CAUSES
    for _ in range(n):
        kind = rng.choice(["alloc", "publish", "hold", "release", "free",
                           "spill", "restore", "drop", "dispatch"])
        pages = rng.choice(np.arange(1, num_pages), size=rng.integers(1, 6),
                           replace=False).tolist()
        if kind == "alloc":
            yield "on_alloc", (pages,), {"owner": f"r{rng.integers(4)}"}
        elif kind == "publish":
            yield "on_publish", (pages,), {}
        elif kind == "hold":
            yield "on_preref_hold", (pages,), {}
        elif kind == "release":
            yield "on_preref_release", (pages,), {}
        elif kind == "free":
            yield "on_free", (pages, str(rng.choice(causes))), {}
        elif kind == "spill":
            yield "on_spill", (pages,), {}
        elif kind == "restore":
            yield "on_restore", (pages,), {}
        elif kind == "drop":
            yield "on_spill_drop", (int(rng.integers(0, 3)),), {}
        else:
            yield "on_dispatch", (np.asarray(pages + [0]),), {}


def _hist_state(h):
    return (dict(h.buckets), h.count, h.total, h.vmin, h.vmax, h.zeros)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_ledger_matches_the_references(seed):
    rng = np.random.default_rng(seed)
    num_pages = 24
    ours = kvledger.PageLedger(num_pages, 8, cold_after_dispatches=8)
    ref = jledger.PageLedger(num_pages, 8, cold_after_dispatches=8)
    ours.page_bytes = ref.page_bytes = 4096
    for i, (name, args, kw) in enumerate(_ledger_events(rng, num_pages, 400)):
        getattr(ours, name)(*args, **kw)
        getattr(ref, name)(*args, **kw)
        if i % 25:
            continue
        assert ours.role_counts() == ref.role_counts()
        assert ours._tier_pages == ref._tier_pages
        assert ours.freed_by_cause == ref.freed_by_cause
        for k in ours.hists:
            assert _hist_state(ours.hists[k]) == _hist_state(ref.hists[k]), k
        free, cache = int(rng.integers(0, num_pages)), int(rng.integers(0, 30))
        a = ours.server_info_fields(free, cache, 1e6)
        b = ref.server_info_fields(free, cache, 1e6)
        assert {k: v for k, v in a.items() if k not in HBM_KEYS} \
            == {k: v for k, v in b.items() if k not in HBM_KEYS}
        sa, sb = ours.snapshot(free, cache, 1e6), ref.snapshot(free, cache, 1e6)
        sa.pop("hbm"), sb.pop("hbm")
        assert sa == sb
        assert ours.idle_age(3) == ref.idle_age(3)
    assert ours.page_frees > 0 and ours.pages_spilled > 0


def test_hbm_truth_is_empty_on_the_cpu():
    assert kvledger.hbm_truth(1e9, torch.device("cpu")) == {}
    assert kvledger.hbm_truth(1e9, None) == {}
    led = kvledger.PageLedger(8, 4, device=torch.device("cpu"))
    assert not HBM_KEYS & set(led.server_info_fields(7, 0, 0.0))


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


def test_ledger_reconciles_exactly_under_churn(tiny):
    """attributed_frac == 1.0 exactly at quiescence after salvage-abort
    churn, completion churn (finalize and publish) and a full flush; the
    free-cause taxonomy saw each class and every allocation was freed."""
    eng = _mk_engine(tiny, max_seq_len=512, num_pages=128,
                     prompt_buckets=(16, 32, 64), steps_per_dispatch=2,
                     pipeline_depth=4)
    try:
        toks, reason = abort_driven(eng, [7, 9, 11, 13] * 4)
        assert reason == "abort" and toks
        eng.start()
        sp = SamplingParams(temperature=0.0, max_new_tokens=8)
        for i in range(3):
            toks, _ = drain(eng.submit(f"fin{i}", [i + 1] * 16, sp))
            assert len(toks) == 8
        quiesce(eng)
        snap = eng.kv_memory_snapshot()
        rec = snap["reconcile"]
        assert rec["attributed_frac"] == 1.0
        assert rec["ledger_free"] == rec["pool_free"] \
            == eng.allocator.free_count
        assert rec["ledger_cache"] == rec["cache_pages"] \
            == eng.prefix_cache.num_entries
        assert rec["cache_pages"] > 0, "publish churn must leave residency"

        eng.flush_prefix_cache()
        quiesce(eng)
        snap = eng.kv_memory_snapshot()
        rec = snap["reconcile"]
        assert rec["attributed_frac"] == 1.0
        assert rec["ledger_free"] == eng.num_pages - 1  # page 0 reserved
        assert rec["ledger_cache"] == rec["cache_pages"] == 0
        by_cause = snap["churn"]["freed_by_cause"]
        assert by_cause["finalize"] > 0
        assert by_cause["salvage"] > 0
        assert by_cause["flush"] > 0
        assert snap["churn"]["page_allocs"] == snap["churn"]["page_frees"]
        assert snap["hists"]["page_lifetime_dispatches"]["count"] > 0
    finally:
        eng.stop()


def test_plain_abort_cause_reconciles(tiny):
    """salvage_partials=False: the fast abort frees with the ``abort``
    cause and still reconciles exactly."""
    eng = _mk_engine(tiny, salvage_partials=False, max_seq_len=512,
                     num_pages=128, prompt_buckets=(16, 32, 64),
                     steps_per_dispatch=2, pipeline_depth=4)
    try:
        _toks, reason = abort_driven(eng, [5, 6, 7])
        assert reason == "abort"
        quiesce(eng)
        snap = eng.kv_memory_snapshot()
        assert snap["churn"]["freed_by_cause"]["abort"] > 0
        assert snap["churn"]["freed_by_cause"]["salvage"] == 0
        assert snap["reconcile"]["attributed_frac"] == 1.0
        assert snap["reconcile"]["ledger_free"] == eng.num_pages - 1
    finally:
        eng.stop()


def test_memory_fields_ride_server_info(tiny):
    """The flat memory-plane fields and the cause-split cache evictions
    ride ``/get_server_info``; no HBM field on the CPU."""
    eng = _mk_engine(tiny)
    srv = RolloutServer(eng, host="127.0.0.1", port=0)
    try:
        eng.generate([[3] * 16], SamplingParams(temperature=0.0,
                                                max_new_tokens=4))
        quiesce(eng)
        eng.flush_prefix_cache()
        info = srv.server_info()
        assert {"kv_hot_page_frac", "kv_warm_page_frac", "kv_cold_page_frac",
                "kv_cold_bytes", "kv_spilled_frac", "kv_restore_rate",
                "memory/attributed_frac", "memory/page_allocs",
                "memory/page_frees", "memory/page_publishes"} <= set(info)
        assert not HBM_KEYS & set(info)
        assert info["memory/attributed_frac"] == 1.0
        assert info["memory/freed_finalize"] > 0
        assert {"prefix_cache/evict_capacity", "prefix_cache/evict_flush",
                "prefix_cache/evict_preref_ttl",
                "prefix_cache/evict_cold_first"} <= set(info)
        assert info["prefix_cache/evict_flush"] > 0
    finally:
        eng.stop()


def test_published_pages_go_cold_within_budget(tiny):
    """A finished request's published pages go from hot to cold within
    ``kv_cold_after_dispatches`` dispatches of unrelated traffic, and the
    fraction reaches the fleet's ``engine/kv_cold_page_frac``."""
    cold_after = 8
    eng = _mk_engine(tiny, kv_cold_after_dispatches=cold_after,
                     steps_per_dispatch=2)
    srv = RolloutServer(eng, host="127.0.0.1", port=0)
    try:
        sp = SamplingParams(temperature=0.0, max_new_tokens=8)
        eng.generate([[101] * 16], sp)
        quiesce(eng)
        assert eng.prefix_cache.num_entries > 0
        birth = eng.kvledger.dispatch
        info = srv.server_info()
        assert info["kv_cold_page_frac"] == 0.0, "fresh pages are not cold"
        i = 0
        while eng.kvledger.dispatch - birth <= cold_after:
            eng.generate([[7 + i, 9 + i, 11 + i, 13 + i]], sp)
            quiesce(eng)
            i += 1
            assert i < 64, "the dispatch clock does not advance"
        info = srv.server_info()
        assert info["kv_cold_page_frac"] > 0.0
        assert info["kv_cold_bytes"] > 0.0
        snap = eng.kv_memory_snapshot()
        assert snap["tiers"]["cold"] > 0
        assert snap["tiers"]["cold_after_dispatches"] == cold_after
        g = PoolManager._fleet_engine_gauges(
            [{"healthy": True, "occupancy": 0.0, **info}])
        assert g["engine/kv_cold_page_frac"] == info["kv_cold_page_frac"]
    finally:
        eng.stop()


def test_ledger_off_is_bitwise_identical(tiny):
    """kv_ledger=False removes only bookkeeping (and the spill tier with
    it): sampled outputs, which depend on the generator, are bitwise the
    same with the ledger on or off."""
    sp = SamplingParams(temperature=0.8, top_p=0.9, max_new_tokens=12)
    prompts = [[5, 3, 9] * 4, [11, 4] * 8, [42] * 16]
    on = _mk_engine(tiny, kv_ledger=True, seed=7)
    try:
        out_on = on.generate(prompts, sp)
    finally:
        on.stop()
    off = _mk_engine(tiny, kv_ledger=False, seed=7)
    try:
        out_off = off.generate(prompts, sp)
    finally:
        off.stop()
    assert on.kvledger is not None and on.kvspill is not None
    assert off.kvledger is None and off.kvspill is None
    assert off.kv_memory_info() == {} and off.kv_memory_snapshot() == {}
    for a, b in zip(out_on, out_off):
        assert a["token_ids"] == b["token_ids"]
        assert a["logprobs"] == b["logprobs"]
        assert a["finish_reason"] == b["finish_reason"]
