"""Engine parity: the port's CBEngine(device="cpu") against the JAX
CBEngine on ``tiny`` in f32 with the same weights.

Greedy tokens must be equal and logprobs within 5e-4, the JAX package's
own bound between its grouped and ungrouped engines
(``test_grouped_decode.py``, ``test_group_prefill.py``): the engines run
the same arithmetic in another reduction order.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams

GEOM = dict(max_slots=8, page_size=8, max_seq_len=96, prompt_buckets=(16, 32),
            num_pages=128)
LP_TOL = 5e-4


def _tree(seed):
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def tree():
    return _tree(0)


def _jax_engine(tree, **kw):
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   kv_cache_dtype=jnp.float32, **{**GEOM, **kw})


def _torch_engine(tree, **kw):
    cfg = tdec.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu", **{**GEOM, **kw})


def _collect(q, timeout=120):
    toks, lps, wvs, reason = [], [], [], ""
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_END or (not isinstance(item, dict)):
            break
        toks.extend(item["token_ids"])
        lps.extend(item["logprobs"])
        wvs.extend([item.get("weight_version", -1)] * len(item["token_ids"]))
        if item["finished"]:
            reason = item["finish_reason"]
    return toks, lps, wvs, reason


def _prompts(n, lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, lens[i % len(lens)]).tolist() for i in range(n)]


def _assert_same(res_t, res_j):
    for t, j in zip(res_t, res_j):
        assert t["token_ids"] == list(j["token_ids"])
        assert t["finish_reason"] == j["finish_reason"]
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0,
                                   atol=LP_TOL)


def test_greedy_parity_with_jax_engine(tree):
    """Mixed prompt lengths (under, on and over page boundaries, two
    prompt buckets), a stop token and a length-capped request."""
    prompts = _prompts(5, (5, 8, 13, 17, 24))
    sp_t = SamplingParams(temperature=0.0, max_new_tokens=12)
    sp_j = JSP(temperature=0.0, max_new_tokens=12)
    jeng = _jax_engine(tree)
    ref = jeng.generate(prompts, sp_j)
    jeng.stop()
    teng = _torch_engine(tree)
    out = teng.generate(prompts, sp_t)
    teng.stop()
    _assert_same(out, ref)
    assert all(len(r["token_ids"]) == 12 for r in out)
    assert teng.allocator.free_count == teng.num_pages - 1
    # a stop token taken from the reference's own greedy stream
    stop = ref[0]["token_ids"][4]
    teng = _torch_engine(tree)
    out = teng.generate(prompts[:1], SamplingParams(
        temperature=0.0, max_new_tokens=12, stop_token_ids=(stop,)))
    teng.stop()
    assert out[0]["finish_reason"] == "stop"
    assert out[0]["token_ids"][-1] == stop
    assert out[0]["token_ids"] == ref[0]["token_ids"][:len(out[0]["token_ids"])]


def _grouped_run(engine, prompt, n, rid):
    outs = [engine.submit(f"{rid}-{i}", prompt,
                          engine_sp(engine), group_id=rid, group_size=n)
            for i in range(n)]
    engine.start()
    return [_collect(q) for q in outs]


def engine_sp(engine):
    if isinstance(engine, CBEngine):
        return SamplingParams(temperature=0.0, max_new_tokens=10)
    return JSP(temperature=0.0, max_new_tokens=10)


def test_grouped_submissions_take_grouped_path(tree):
    """GRPO groups (group_size=4) prefill once, batch-attach the siblings
    and decode through the grouped kernel's path; tokens equal the
    ungrouped port engine and the JAX engine, logprobs within 5e-4."""
    prompt = _prompts(1, (21,), seed=3)[0]  # 2 full shared pages + tail
    on = _torch_engine(tree)
    res_on = _grouped_run(on, prompt, 4, "g")
    assert on.grouped_decode_dispatches > 0
    assert on.sibling_attach_dispatches >= 1 and on.group_forked_requests >= 3
    on.stop()
    assert on._decode_groups == {} and on._slot_decode_gid == {}
    assert on.allocator.free_count == on.num_pages - 1

    off = _torch_engine(tree, decode_group_share=False)
    res_off = _grouped_run(off, prompt, 4, "g")
    assert off.grouped_decode_dispatches == 0
    off.stop()

    jeng = _jax_engine(tree)
    res_j = _grouped_run(jeng, prompt, 4, "g")
    jeng.stop()
    for (t1, l1, _w1, r1), (t2, l2, _w2, r2), (t3, l3, _w3, r3) in zip(
            res_on, res_off, res_j):
        assert t1 == t2 == t3 and r1 == r2 == r3 == "length"
        np.testing.assert_allclose(l1, l2, rtol=0, atol=LP_TOL)
        np.testing.assert_allclose(l1, l3, rtol=0, atol=LP_TOL)


def test_update_weights_mid_run_and_after(tree):
    """A swap mid-request bumps the version seen on later tokens and the
    request completes; after the swap the engine decodes exactly like a
    fresh engine built on the new weights (the prefix cache was flushed:
    no KV of the old weights is reused). Tokens carry the version of the
    dispatch that sampled them, so the engine runs synchronously here
    (``pipeline_depth=0``): run ahead, it may have queued every dispatch
    of the request before the swap (``test_torch_cb_pipeline.py`` covers
    the deep pipeline)."""
    new_tree = _tree(1)
    prompt = _prompts(1, (19,), seed=5)[0]
    sp = SamplingParams(temperature=0.0, max_new_tokens=40)
    eng = _torch_engine(tree, steps_per_dispatch=2, pipeline_depth=0)
    q = eng.submit("long", prompt, sp)
    eng.start()
    first = q.get(timeout=60)
    assert first["weight_version"] == 0
    eng.update_weights(params_from_numpy(new_tree, "cpu", torch.float32))
    toks, _lps, wvs, reason = _collect(q)
    assert reason == "length" and len(toks) == 39
    assert wvs[-1] == 1 and eng.weight_version == 1
    after = eng.generate([prompt], SamplingParams(temperature=0.0,
                                                  max_new_tokens=10))
    eng.stop()
    fresh = _torch_engine(new_tree)
    ref = fresh.generate([prompt], SamplingParams(temperature=0.0,
                                                  max_new_tokens=10))
    fresh.stop()
    assert after[0]["token_ids"] == ref[0]["token_ids"]
    assert after[0]["weight_versions"] == [1] * 10
    with pytest.raises(ValueError):
        eng.update_weights({"embed": torch.zeros(3)})


def test_abort_frees_the_slot_and_survivors_finish(tree):
    prompts = _prompts(3, (9, 14, 6), seed=6)
    sp = SamplingParams(temperature=0.0, max_new_tokens=30)
    eng = _torch_engine(tree, steps_per_dispatch=2)
    ev = threading.Event()
    outs = [eng.submit("a0", prompts[0], sp, abort=ev),
            eng.submit("a1", prompts[1], sp), eng.submit("a2", prompts[2], sp)]
    eng.start()
    first = outs[0].get(timeout=60)
    assert first["token_ids"]
    ev.set()
    toks, _l, _w, reason = _collect(outs[0])
    assert reason == "abort"
    for q in outs[1:]:
        assert _collect(q)[3] == "length"
    # a request aborted while still queued never admits
    ev2 = threading.Event()
    ev2.set()
    q = eng.submit("queued", prompts[0], sp, abort=ev2)
    assert _collect(q)[3] == "abort"
    eng.stop()
    assert eng.allocator.free_count == eng.num_pages - 1
    assert not eng._active.any()


def test_sampled_requests_finish_with_valid_logprobs(tree):
    """Temperature/top-k/top-p rows in one engine: every stream finishes,
    logprobs are finite and <= 0, tokens stay in the vocabulary."""
    prompts = _prompts(4, (7, 12), seed=8)
    eng = _torch_engine(tree, seed=3)
    res = eng.generate(prompts, SamplingParams(temperature=0.9, top_k=20,
                                               top_p=0.9, max_new_tokens=9))
    eng.stop()
    for r in res:
        assert r["finish_reason"] == "length" and len(r["token_ids"]) == 9
        assert all(0 <= t < 512 for t in r["token_ids"])
        assert np.isfinite(r["logprobs"]).all() and max(r["logprobs"]) <= 0
