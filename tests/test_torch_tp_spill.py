"""The host spill tier on tp shards (``rollout/kvspill.ShardedSpillPool``,
one copy lane a shard) on the CPU.

Mirrors ``tests/test_torch_kv_spill.py`` on a ``tp=2`` ``CBEngine``
(``tiny``, f32, two ``cpu`` shards): two lanes, each on its shard's
device, and a handle a page holding both shards' parts; a capped spilling
engine against a never-spilling one of the same shards, greedy and
seeded-sampled, bitwise (both engines drain every dispatch,
``pipeline_depth=0``, so that their dispatches and their draws from the
sampling generator are the same); the capped engine against the JAX
package's tp=2 mesh engine on the same capped pool (greedy tokens equal,
logprobs within the reference's 5e-4); one full lane stopping every
spill while pressure evicts; a flush and a memory release freeing both
tiers in both lanes; exact reconciliation with the spilled pages counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.parallel import mesh as jmesh
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.kvspill import ShardedSpillPool
from polyrl_tpu_torch.rollout.sampling import SamplingParams

from tests.torch_engine_util import quiesce

LP_TOL = 5e-4
TP = 2
GEOM = dict(max_slots=2, page_size=8, max_seq_len=48, prompt_buckets=(32,),
            num_pages=20, kv_cold_after_dispatches=2)
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
SAMPLED = SamplingParams(temperature=1.0, max_new_tokens=8)


@pytest.fixture(scope="module")
def tree():
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))


def _mk_engine(tree, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu", tp=TP,
                    **{**GEOM, **kw})


def _prompts(n, length=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, length).tolist() for _ in range(n)]


def _sessions(eng, prompts, sp=GREEDY):
    """Every prompt once (the sessions publish their pages), then each
    resumed alone with its own prompt (its prefix hit lands on pages the
    pressure spilled)."""
    first = eng.generate(prompts, sp, timeout=120.0)
    resumed = [eng.generate([p], sp, timeout=120.0)[0] for p in prompts]
    quiesce(eng)
    return first + resumed


def _lane_pages(eng) -> list[int]:
    return [lane.resident_pages for lane in eng.kvspill.lanes]


# -- lanes and handles --------------------------------------------------------


def test_one_lane_a_shard_and_a_handle_holds_every_part(tree):
    """A tp=2 engine's tier has two lanes, each on its shard's device; a
    spill puts each shard's rows of a page (``[2L, Hkv/2, ps, D]``) in its
    own lane under one handle; the tier's bytes are the lanes' summed, a
    page's bytes over both shards."""
    eng = _mk_engine(tree, num_pages=32)
    try:
        pool = eng.kvspill
        assert isinstance(pool, ShardedSpillPool) and len(pool.lanes) == TP
        assert [lane.device for lane in pool.lanes] == eng.tp_devices
        eng.generate(_prompts(1), GREEDY, timeout=120.0)
        quiesce(eng)
        n = eng._spill_pages(64, cold_only=False)
        assert n > 0 and pool.resident_pages == n and _lane_pages(eng) == [n] * TP
        handles = [e.spill_handle for e in eng.prefix_cache._map.values()
                   if e.spilled]
        assert len(handles) == n
        k0 = eng._pools[0][0][0]  # shard 0's layer-0 K pool [Hkv/2, N, ps, D]
        assert k0.shape[0] == eng.cfg.num_kv_heads // TP
        for h in handles:
            parts = pool._parts[h]
            assert len(parts) == TP
            for lane, part in zip(pool.lanes, parts):
                host = lane._entries[part].buf.host
                assert host.shape == ((2 * eng.cfg.num_layers,)
                                      + tuple(k0[:, 0].shape))
        s = pool.stats()
        page_bytes = eng.kvledger.page_bytes
        assert s["resident_pages"] == n and s["copy_batches"] == 1
        assert s["bytes_spilled"] == s["resident_bytes"] == n * page_bytes
        assert [ln["bytes_spilled"] for ln in s["lanes"]] == [n * page_bytes // TP] * TP
        assert eng.kv_memory_snapshot()["spill"]["host"]["resident_pages"] == n
    finally:
        eng.stop()


# -- spilling against never spilling, and against the JAX engine ---------------


@pytest.mark.parametrize("sp", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_capped_spilling_tp_engine_is_bitwise_a_never_spilling_one(tree, sp):
    """The capped tp=2 engine spills and restores through both lanes; its
    streams are bitwise those of a tp=2 engine of 128 pages that never
    spills (same seed, same dispatches)."""
    prompts = _prompts(6)
    capped = _mk_engine(tree, pipeline_depth=0)
    try:
        got = _sessions(capped, prompts, sp)
        info = capped.kv_memory_info()
        lanes = [ln["bytes_restored"] for ln in capped.kvspill.stats()["lanes"]]
    finally:
        capped.stop()
    big = _mk_engine(tree, num_pages=128, kv_spill=False, pipeline_depth=0)
    try:
        want = _sessions(big, prompts, sp)
    finally:
        big.stop()
    assert info["memory/pages_spilled"] > 0 and info["memory/pages_restored"] > 0
    assert all(b > 0 for b in lanes), "both lanes must restore"
    assert info["memory/attributed_frac"] == 1.0
    for a, b in zip(got, want):
        assert a["finish_reason"] == b["finish_reason"] == "length"
        assert a["token_ids"] == b["token_ids"]
        assert a["logprobs"] == b["logprobs"]


def test_capped_spilling_tp_engine_against_the_jax_tp_engine(tree, devices8):
    """The same sessions on the same capped pool through the port's tp=2
    engine and the JAX tp=2 mesh engine: both spill and restore, the tokens
    are equal and the logprobs within 5e-4."""
    prompts = _prompts(6, seed=1)
    eng = _mk_engine(tree)
    try:
        ours = _sessions(eng, prompts)
        ours_info = eng.kv_memory_info()
    finally:
        eng.stop()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(fsdp=1, tp=TP), devices8[:TP])
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32),
                   jax.tree_util.tree_map(jnp.asarray, tree), mesh=mesh,
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


# -- the lifecycle ------------------------------------------------------------


class _CopyInFlight:
    """Stands in for a batch's landed event whose copy never lands."""

    def query(self) -> bool:
        return False


def test_one_full_lane_spills_nothing_and_pressure_evicts(tree):
    """With one lane's ``lane_depth`` batches in flight the tier spills
    nothing on either shard (each refusal counted once), an admission under
    pressure evicts instead; once the lane drains, pages spill again."""
    eng = _mk_engine(tree, num_pages=16)
    try:
        eng.generate(_prompts(2), GREEDY, timeout=120.0)
        quiesce(eng)
        assert eng.prefix_cache.num_entries > 0
        pool = eng.kvspill
        lane = pool.lanes[1]
        with lane._lock:
            lane._lane.extend(_CopyInFlight() for _ in range(lane.lane_depth))
        assert not pool.can_spill(1, 1)
        assert eng._spill_pages(4, cold_only=True) == 0
        assert eng._spill_pages(4, cold_only=False) == 0
        assert pool.stats()["lane_full"] == 2
        out = eng.generate(_prompts(2, seed=5), GREEDY, timeout=120.0)
        assert all(o["finish_reason"] == "length" for o in out)
        quiesce(eng)
        assert eng.prefix_cache.evictions["capacity"] > 0
        assert eng.kvledger.pages_spilled == 0 and _lane_pages(eng) == [0, 0]
        assert eng.kv_memory_info()["memory/attributed_frac"] == 1.0
        with lane._lock:
            lane._lane.clear()
        assert eng._spill_pages(1, cold_only=False) == 1
        assert _lane_pages(eng) == [1, 1]
    finally:
        eng.stop()


@pytest.mark.parametrize("how", ["flush", "release_memory"])
def test_flush_and_release_free_both_tiers_in_both_lanes(tree, how):
    """A cache flush, or a memory release (whose flush drops the spilled
    entries), frees the spilled pages from the host tier of both lanes
    (their buffers back on the free lists) and the ledger's spilled count;
    the ledger reconciles after, and after a resume the engine serves."""
    eng = _mk_engine(tree, num_pages=32)
    try:
        eng.generate(_prompts(2), GREEDY, timeout=120.0)
        quiesce(eng)
        n = eng._spill_pages(64, cold_only=False)
        assert n > 0 and _lane_pages(eng) == [n, n]
        if how == "flush":
            eng.flush_prefix_cache()
        else:
            eng.release_memory()
            assert eng._pools is None
            assert eng._spill_pages(8, cold_only=False) == 0
            eng.resume_memory()
        quiesce(eng)
        assert eng.kvspill.resident_pages == 0 and _lane_pages(eng) == [0, 0]
        assert all(len(lane._free) == n for lane in eng.kvspill.lanes)
        assert eng.kvledger.spilled_pages == 0
        assert eng.kvledger.spill_drops == n
        snap = eng.kv_memory_snapshot()
        assert snap["reconcile"]["attributed_frac"] == 1.0
        assert snap["reconcile"]["ledger_free"] == eng.num_pages - 1
        out = eng.generate(_prompts(1, seed=3), GREEDY, timeout=120.0)[0]
        assert out["finish_reason"] == "length"
    finally:
        eng.stop()


def test_tp_reconciles_exactly_with_spilled_counted(tree):
    """attributed_frac == 1.0 exactly at quiescence while pages sit in both
    lanes: a page counts once, whatever the number of shards."""
    eng = _mk_engine(tree, num_pages=16)
    try:
        for p in _prompts(6):
            eng.generate([p], GREEDY, timeout=120.0)
        quiesce(eng)
        snap = eng.kv_memory_snapshot()
        spilled = snap["spill"]["spilled_pages"]
        assert spilled > 0 and snap["roles"]["spilled"] == spilled
        rec = snap["reconcile"]
        assert rec["attributed_frac"] == 1.0
        assert rec["ledger_free"] == rec["pool_free"] == eng.allocator.free_count
        host = snap["spill"]["host"]
        assert host["resident_pages"] == spilled
        assert [ln["resident_pages"] for ln in host["lanes"]] == [spilled] * TP
        assert eng.kv_memory_info()["kv_spilled_frac"] > 0.0
    finally:
        eng.stop()
