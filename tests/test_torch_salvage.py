"""Abort salvage in the port's CBEngine, on the CPU (the JAX engine's
default, ``salvage_partials=True``): an aborted slot stays active through
a full drain, so every token its dispatches in flight decoded reaches the
client before the ``abort`` terminal; its full pages go to the prefix
cache for a continuation; ``stop()`` drains the same way. On ``tiny`` in
f32 with the JAX weights carried across through numpy; the interrupt and
resume test mirrors ``tests/test_token_salvage.py``.
"""

import dataclasses
import threading

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
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams

LP_TOL = 5e-4
GEOM = dict(max_slots=4, page_size=8, max_seq_len=512,
            prompt_buckets=(16, 32, 64), num_pages=128, steps_per_dispatch=2,
            pipeline_depth=4)
PROMPT = [5, 6, 7, 9, 11]


@pytest.fixture(scope="module")
def tree():
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))


def _engine(tree, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu",
                    **{**GEOM, **kw})


def _drain(q, timeout=180):
    toks, lps, reason = [], [], ""
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_END:
            return toks, lps, reason
        toks += item["token_ids"]
        lps += item["logprobs"]
        if item.get("finished"):
            reason = item["finish_reason"]


def _drive(eng, prompt, n_dispatches, max_new=400, abort=None):
    """Admit one greedy request on an unstarted engine and queue
    ``n_dispatches`` decode dispatches with nothing emitted (the run-ahead
    window holds them all); returns its output queue."""
    q = eng.submit("r", prompt, SamplingParams(temperature=0.0,
                                               max_new_tokens=max_new),
                   abort=abort)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        for _ in range(n_dispatches):
            eng._step_once()
    assert eng._outstanding() == 1 + n_dispatches
    return q


def test_greedy_interrupt_resume_is_bitwise_identical(tree):
    """A greedy stream aborted with its first 5 tokens in flight: the
    salvaged prefix is bitwise the uninterrupted run's (nothing before the
    cut is decoded again), and resumed on another engine (prompt + partial, budget
    decremented) and on the same one (through the salvage-published
    pages) the stitched stream is the uninterrupted one. The uninterrupted
    run's tokens equal the JAX engine's, logprobs within 5e-4."""
    budget = 160
    sp = SamplingParams(temperature=0.0, max_new_tokens=budget)
    ref_eng = _engine(tree).start()
    ref = ref_eng.generate([PROMPT], sp, timeout=300.0)[0]
    ref_eng.stop()
    assert len(ref["token_ids"]) == budget
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32),
                   jax.tree_util.tree_map(jnp.asarray, tree),
                   kv_cache_dtype=jnp.float32, **GEOM)
    try:
        jref = jeng.generate([PROMPT], JSP(temperature=0.0,
                                           max_new_tokens=budget,
                                           stop_token_ids=()),
                             timeout=300.0)[0]
    finally:
        jeng.stop()
    assert ref["token_ids"] == list(jref["token_ids"])
    np.testing.assert_allclose(ref["logprobs"], jref["logprobs"], rtol=0,
                               atol=LP_TOL)

    # the abort comes with the run-ahead window known to be full: the
    # prefill's token and 2 decode dispatches' (5 tokens) await emission
    # on an unstarted engine, so salvage has tokens to deliver whatever
    # the machine's load
    eng1 = _engine(tree, pipeline_depth=16)
    ev = threading.Event()
    out = _drive(eng1, PROMPT, 2, max_new=budget, abort=ev)
    ev.set()
    with eng1._pool_lock:
        eng1._step_once()
    got_t, got_l, reason = _drain(out, timeout=5)
    k = len(got_t)
    assert reason == "abort" and k == 1 + 2 * eng1.steps_per_dispatch
    # tokens the fast path would have dropped: those the drain delivered
    assert 0 < eng1.tokens_salvaged <= k
    assert got_t == ref["token_ids"][:k]
    np.testing.assert_array_equal(np.asarray(got_l, np.float32),
                                  np.asarray(ref["logprobs"][:k], np.float32))

    sp2 = dataclasses.replace(sp, max_new_tokens=budget - k)
    eng2 = _engine(tree).start()
    res2 = eng2.generate([PROMPT + got_t], sp2, timeout=300.0)[0]
    eng2.stop()
    assert got_t + res2["token_ids"] == ref["token_ids"]
    np.testing.assert_allclose(got_l + res2["logprobs"], ref["logprobs"],
                               rtol=0, atol=LP_TOL)

    assert eng1.salvage_published_pages > 0
    eng1.start()
    hits = eng1.prefix_cache.hits
    res1 = eng1.generate([PROMPT + got_t], sp2, timeout=300.0)[0]
    assert eng1.prefix_cache.hits >= hits + eng1.salvage_published_pages
    assert got_t + res1["token_ids"] == ref["token_ids"]
    eng1.stop()
    assert eng1.allocator.free_count == eng1.num_pages - 1


@pytest.mark.parametrize("salvage", [True, False], ids=["salvage", "fast"])
def test_abort_with_the_window_full(tree, salvage):
    """An abort while 6 dispatches' outputs (the prefill's and 5 decode
    dispatches') await emission. With salvage every token they decoded
    reaches the client before the ``abort`` terminal and all but the
    first are counted in ``tokens_salvaged``; the fast path drops them.
    Either way the slot and every page come back."""
    eng = _engine(tree, salvage_partials=salvage, pipeline_depth=16)
    ev = threading.Event()
    q = _drive(eng, PROMPT, 5, abort=ev)
    ev.set()
    with eng._pool_lock:
        eng._step_once()
    assert eng.decode_dispatches == 5  # the abort came before a dispatch
    toks, _, reason = _drain(q, timeout=5)
    assert reason == "abort"
    if salvage:
        assert len(toks) == 1 + 5 * eng.steps_per_dispatch
        assert eng.tokens_salvaged == len(toks)
        assert eng.salvage_published_pages == (len(PROMPT) + len(toks) - 1) // 8
    else:
        assert toks == [] and eng.tokens_salvaged == 0
        assert eng.salvage_published_pages == 0
    eng.stop()
    assert all(s is None for s in eng._slots)
    assert eng.allocator.free_count == eng.num_pages - 1


@pytest.mark.parametrize("salvage", [True, False], ids=["salvage", "fast"])
def test_stop_flushes_partials(tree, salvage):
    """``stop()`` with 6 dispatches' outputs still queued: with salvage they
    stream out and the request ends in an ``abort`` partial; without it
    they are dropped and it ends in an ``error``."""
    eng = _engine(tree, salvage_partials=salvage, pipeline_depth=16)
    q = _drive(eng, PROMPT, 5)
    eng.stop()
    toks, _, reason = _drain(q, timeout=5)
    if salvage:
        assert reason == "abort"
        assert len(toks) == 1 + 5 * eng.steps_per_dispatch
    else:
        assert reason == "error" and toks == []
    assert eng._outstanding() == 0
    assert eng.allocator.free_count == eng.num_pages - 1


def test_salvage_publish_guards_and_page_accounting(tree):
    """Pages balance through salvage: after an abort the published pages
    sit in the prefix cache, unreferenced (free + cached is every page);
    a slot admitted under older weights publishes nothing; stop() gives
    every page back."""
    eng = _engine(tree, pipeline_depth=0)
    sp = SamplingParams(temperature=0.0, max_new_tokens=100)
    ev = threading.Event()
    q = eng.submit("p", PROMPT, sp, abort=ev)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        for _ in range(12):
            eng._step_once()
        ev.set()
        eng._step_once()
    toks, _, reason = _drain(q, timeout=5)
    assert reason == "abort" and len(toks) == 1 + 12 * 2
    n_seq = len(PROMPT) + len(toks)
    cached = int(eng.prefix_cache.stats()["prefix_cache/entries"])
    assert cached == (n_seq - 1) // 8
    assert eng.allocator.free_count + cached == eng.num_pages - 1

    eng.flush_prefix_cache()
    ev2 = threading.Event()
    q2 = eng.submit("v", PROMPT, sp, abort=ev2)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        for _ in range(12):
            eng._step_once()
    eng.update_weights(eng.params)  # a swap while the slot decodes
    published = eng.salvage_published_pages
    ev2.set()
    with eng._pool_lock:
        eng._step_once()
    assert _drain(q2, timeout=5)[2] == "abort"
    assert eng.salvage_published_pages == published  # stale KV not kept
    eng.stop()
    assert eng.allocator.free_count == eng.num_pages - 1
