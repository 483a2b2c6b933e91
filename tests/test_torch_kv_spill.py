"""The port's host-RAM KV spill tier (``rollout/kvspill.py``) on the CPU.

Mirrors ``tests/test_kv_spill.py`` on the port's ``CBEngine`` (``tiny``,
f32): the ``HostSpillPool`` round trip; sessions spilled under a capped
pool and restored on their prefix hit against a big pool that never
spills (tokens bitwise, logprobs within the reference's 5e-4); a restore
at new physical pages, written in place into the live pool tensors (the
pools' ``data_ptr()``s unchanged, the restored pages bitwise the spilled
ones); a flush while spilled freeing both tiers; exact reconciliation with
the spilled pages counted; cold-first capacity eviction; a memory release
dropping the spilled entries; spill on against off; and the capped
spilling engine against the JAX engine on the same capped pool.

Spill on against off is held to equal tokens and logprobs within 5e-4,
not bitwise: with spill on a resumed session's prefix hit lands on
restored pages and attaches its suffix, with spill off the cold pages were
evicted and it runs a full prefill, and the two computations may round
differently (the reference's ``test_spill_off_is_bitwise_identical``
fails for this reason). Where both runs take the same route (spilled and
restored against never spilled) the tokens are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.kvspill import HostSpillPool
from polyrl_tpu_torch.rollout.sampling import SamplingParams

from tests.torch_engine_util import quiesce

LP_TOL = 5e-4
GEOM = dict(max_slots=2, page_size=8, max_seq_len=48, prompt_buckets=(32,),
            num_pages=20, kv_cold_after_dispatches=2)
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)


@pytest.fixture(scope="module")
def tree():
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))


def _mk_engine(tree, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu",
                    **{**GEOM, **kw})


def _prompts(n, length=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, length).tolist() for _ in range(n)]


def _sessions(eng, prompts):
    """Every prompt once (the sessions publish their pages), then each
    resumed alone with its own prompt (its prefix hit lands on pages the
    pressure spilled)."""
    first = eng.generate(prompts, GREEDY, timeout=120.0)
    resumed = [eng.generate([p], GREEDY, timeout=120.0)[0] for p in prompts]
    quiesce(eng)
    return first + resumed


# -- the host pool ------------------------------------------------------------


def test_host_pool_spill_load_drop_roundtrip():
    """Spilled pages come back bitwise through ``load``, in any order,
    buffers are reused after a drop, and capacity refuses what does not
    fit."""
    rng = np.random.default_rng(0)
    kv = torch.from_numpy(rng.normal(size=(3, 4, 2, 8, 16)).astype(np.float32))
    page_bytes = kv[0].numel() * kv[0].element_size()
    pool = HostSpillPool(page_bytes * 4, "cpu")
    try:
        assert pool.can_spill(3, page_bytes)
        handles = pool.spill(kv, page_bytes)
        assert len(handles) == 3 and pool.resident_pages == 3
        out = torch.empty_like(kv)
        pool.load(handles[::-1], out)
        assert torch.equal(out, kv.flip(0))
        assert not pool.can_spill(2, page_bytes)  # over capacity
        pool.drop(handles[:1], restored=True)
        pool.drop(handles[1:])
        s = pool.stats()
        assert pool.resident_pages == 0 and s["resident_bytes"] == 0
        assert s["bytes_spilled"] == 3 * page_bytes
        assert s["bytes_restored"] == page_bytes
        assert s["pinned_bytes"] == 3 * page_bytes
        assert s["d2h_s"] > 0.0 and s["h2d_s"] > 0.0  # the copies timed
        pool.spill(kv[:2], page_bytes)  # reuses two of the three buffers
        assert pool.stats()["pinned_bytes"] == 3 * page_bytes
    finally:
        pool.stop()


# -- spill, restore, decode ---------------------------------------------------


def test_spill_restore_decode_parity(tree):
    """Sessions resumed under a capped pool restore their spilled pages on
    the prefix hit; the greedy tokens are bitwise the big pool's that never
    spills, the logprobs within 5e-4."""
    prompts = _prompts(6)
    capped = _mk_engine(tree)
    try:
        got = _sessions(capped, prompts)
        info = capped.kv_memory_info()
    finally:
        capped.stop()
    big = _mk_engine(tree, num_pages=128, kv_spill=False)
    try:
        want = _sessions(big, prompts)
    finally:
        big.stop()
    assert info["memory/pages_spilled"] > 0, "pressure must spill"
    assert info["memory/pages_restored"] > 0, "resuming must restore"
    assert info["memory/attributed_frac"] == 1.0
    for a, b in zip(got, want):
        assert a["finish_reason"] == b["finish_reason"] == "length"
        assert a["token_ids"] == b["token_ids"]
        np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=LP_TOL)


def test_restore_lands_at_new_physical_pages_in_place(tree):
    """A restore allocates fresh pages (the freed indices are held here),
    writes them into the live pool tensors in place (every ``data_ptr()``
    unchanged: captured decode graphs replay from those addresses), and the
    restored pages are bitwise the spilled ones; greedy decode goes on
    bitwise."""
    eng = _mk_engine(tree, num_pages=32)
    try:
        [p] = _prompts(1)
        first = eng.generate([p], GREEDY, timeout=120.0)[0]
        quiesce(eng)
        kp, vp = eng._pools
        ptrs = [t.data_ptr() for t in kp + vp]
        entries = sorted(eng.prefix_cache.spill_candidates(),
                         key=lambda e: e.page)
        orig = [e.page for e in entries]
        assert orig, "finalize must publish the session's pages"
        before = [torch.stack([t[:, pg].clone() for t in kp + vp])
                  for pg in orig]
        n = eng._spill_pages(len(orig), cold_only=False)
        assert n == len(orig) and eng.kvledger.spilled_pages == n
        held = eng.allocator.alloc(len(orig))  # the freed indices
        assert held is not None
        with eng._pool_lock:
            assert eng._restore_entries(entries)
        assert [t.data_ptr() for t in kp + vp] == ptrs
        assert eng._pools[0] is kp and eng._pools[1] is vp
        assert not {e.page for e in entries} & set(orig)
        for e, want in zip(entries, before):
            got = torch.stack([t[:, e.page] for t in kp + vp])
            assert torch.equal(got, want)
        assert eng.kvledger.pages_restored == n
        resumed = eng.generate([p], GREEDY, timeout=120.0)[0]
        quiesce(eng)
        eng.allocator.free(held)
        assert resumed["token_ids"] == first["token_ids"]
        np.testing.assert_allclose(resumed["logprobs"], first["logprobs"],
                                   atol=LP_TOL)
    finally:
        eng.stop()


# -- both tiers freed ---------------------------------------------------------


def test_flush_while_spilled_frees_both_tiers(tree):
    eng = _mk_engine(tree, num_pages=32)
    try:
        eng.generate(_prompts(2), GREEDY, timeout=120.0)
        quiesce(eng)
        n = eng._spill_pages(64, cold_only=False)
        assert n > 0 and eng.kvspill.resident_pages == n
        eng.flush_prefix_cache()
        quiesce(eng)
        assert eng.kvspill.resident_pages == 0, "the host tier must free"
        assert eng.kvledger.spilled_pages == 0
        assert eng.kvledger.spill_drops == n
        snap = eng.kv_memory_snapshot()
        assert snap["reconcile"]["attributed_frac"] == 1.0
        assert snap["reconcile"]["ledger_free"] == eng.num_pages - 1
        assert snap["spill"]["spill_drops"] == n
    finally:
        eng.stop()


def test_release_memory_drops_spilled_and_reconciles_after_resume(tree):
    """release_memory's flush drops the spilled entries from both tiers
    (resident pages book as ``flush``), no spill runs while the pools are
    gone, and the ledger reconciles again after resume_memory."""
    eng = _mk_engine(tree, num_pages=32)
    try:
        eng.generate(_prompts(2), GREEDY, timeout=120.0)
        quiesce(eng)
        n = eng._spill_pages(2, cold_only=False)
        assert n == 2 and eng.prefix_cache.num_entries > n
        eng.release_memory()
        assert eng._pools is None
        assert eng.kvspill.resident_pages == 0
        assert eng.kvledger.spill_drops == n
        assert eng.kvledger.freed_by_cause["flush"] > 0
        assert eng._spill_pages(8, cold_only=False) == 0
        eng.resume_memory()
        snap = eng.kv_memory_snapshot()
        assert snap["reconcile"]["attributed_frac"] == 1.0
        assert snap["reconcile"]["ledger_free"] == eng.num_pages - 1
        out = eng.generate(_prompts(1, seed=3), GREEDY, timeout=120.0)[0]
        assert out["finish_reason"] == "length"
        quiesce(eng)
        assert eng.kv_memory_info()["memory/attributed_frac"] == 1.0
    finally:
        eng.stop()


def test_reconciles_exactly_with_spilled_counted(tree):
    """attributed_frac == 1.0 exactly at quiescence while pages sit in the
    host tier: resident published + pre-ref held + spilled equals the
    cache's entries, and the spilled pages' physical indices count free."""
    eng = _mk_engine(tree, num_pages=16)
    try:
        for p in _prompts(6):
            eng.generate([p], GREEDY, timeout=120.0)
        quiesce(eng)
        snap = eng.kv_memory_snapshot()
        assert snap["spill"]["spilled_pages"] > 0
        assert snap["roles"]["spilled"] == snap["spill"]["spilled_pages"]
        rec = snap["reconcile"]
        assert rec["attributed_frac"] == 1.0
        assert rec["ledger_free"] == rec["pool_free"] \
            == eng.allocator.free_count
        assert rec["ledger_cache"] == rec["cache_pages"] \
            == eng.prefix_cache.num_entries
        assert snap["spill"]["host"]["resident_pages"] \
            == snap["spill"]["spilled_pages"]
        assert eng.kv_memory_info()["kv_spilled_frac"] > 0.0
    finally:
        eng.stop()


class _CopyInFlight:
    """Stands in for a batch's landed event whose copy never lands."""

    def query(self) -> bool:
        return False


def test_full_copy_lane_spills_nothing_and_pressure_evicts(tree):
    """With ``lane_depth`` batches in flight the engine spills nothing, as
    the JAX engine does: the sweep and allocation pressure both get no
    page, each refusal is counted, and an admission under pressure evicts
    instead; once the lane drains, pages spill again."""
    eng = _mk_engine(tree, num_pages=16)
    try:
        eng.generate(_prompts(2), GREEDY, timeout=120.0)
        quiesce(eng)
        cached = eng.prefix_cache.num_entries
        assert cached > 0
        pool = eng.kvspill
        with pool._lock:
            pool._lane.extend(_CopyInFlight() for _ in range(pool.lane_depth))
        assert eng._spill_pages(4, cold_only=True) == 0
        assert eng._spill_pages(4, cold_only=False) == 0
        assert pool.stats()["lane_full"] == 2
        # 15 usable pages, `cached` of them held by the cache: two new
        # sessions need more than the free list
        out = eng.generate(_prompts(2, seed=5), GREEDY, timeout=120.0)
        assert all(o["finish_reason"] == "length" for o in out)
        quiesce(eng)
        assert eng.prefix_cache.evictions["capacity"] > 0
        assert eng.kvledger.pages_spilled == 0 and pool.resident_pages == 0
        assert eng.kv_memory_info()["memory/attributed_frac"] == 1.0
        with pool._lock:
            pool._lane.clear()
        assert eng._spill_pages(1, cold_only=False) == 1
    finally:
        eng.stop()


def test_capacity_eviction_prefers_cold_entries(tree):
    """With the ledger's idle age wired in, capacity eviction takes the
    coldest unreferenced entries first, and ``evict_cold_first`` books
    it."""
    eng = _mk_engine(tree, num_pages=64, kv_spill=False)
    try:
        pa, pb, filler = _prompts(3)
        eng.generate([pa], GREEDY, timeout=120.0)
        quiesce(eng)
        pages_a = {e.page for e in eng.prefix_cache.spill_candidates()}
        eng.generate([filler], GREEDY, timeout=120.0)
        eng.generate([pb], GREEDY, timeout=120.0)
        quiesce(eng)
        all_pages = {e.page for e in eng.prefix_cache.spill_candidates()}
        assert len(all_pages) > len(pages_a)
        with eng._pool_lock:
            freed = eng.prefix_cache.evict(len(pages_a))
        assert freed >= len(pages_a)
        left = {e.page for e in eng.prefix_cache.spill_candidates()}
        assert not left & pages_a, "the coldest must go first"
        assert eng.prefix_cache.stats()["prefix_cache/evict_cold_first"] > 0
    finally:
        eng.stop()


# -- spill on against off, and against the JAX engine -------------------------


def test_spill_on_against_off(tree):
    """The capped workload with spill on and off: equal tokens, logprobs
    within 5e-4 (the module docstring says why not bitwise); the off engine
    spills nothing, and ``kv_ledger=False`` has no spill tier at all."""
    assert _mk_engine(tree, kv_ledger=False).kvspill is None
    prompts = _prompts(6)
    outs = {}
    for spill in (True, False):
        eng = _mk_engine(tree, kv_spill=spill)
        try:
            outs[spill] = _sessions(eng, prompts)
            info = eng.kv_memory_info()
        finally:
            eng.stop()
        assert (info["memory/pages_spilled"] > 0) == spill
    for a, b in zip(outs[True], outs[False]):
        assert a["token_ids"] == b["token_ids"]
        np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=LP_TOL)
        assert a["finish_reason"] == b["finish_reason"]


def test_capped_spilling_engine_against_the_jax_engine(tree):
    """The same sessions on the same capped pool through the port's
    engine and the JAX engine: both spill and restore, the tokens are
    equal and the logprobs within 5e-4."""
    prompts = _prompts(6, seed=1)
    eng = _mk_engine(tree)
    try:
        ours = _sessions(eng, prompts)
        ours_info = eng.kv_memory_info()
    finally:
        eng.stop()
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32),
                   jax.tree_util.tree_map(jnp.asarray, tree),
                   kv_cache_dtype=jnp.float32, **GEOM)
    jsp = JSP(temperature=0.0, max_new_tokens=8)
    try:
        ref = jeng.generate(prompts, jsp, timeout=300.0)
        ref += [jeng.generate([p], jsp, timeout=300.0)[0] for p in prompts]
        ref_info = jeng.kv_memory_info()
    finally:
        jeng.stop()
    assert ours_info["memory/pages_spilled"] > 0
    assert ref_info["memory/pages_spilled"] > 0
    assert ours_info["memory/pages_restored"] > 0
    for a, b in zip(ours, ref):
        assert a["token_ids"] == list(b["token_ids"])
        np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=LP_TOL)
