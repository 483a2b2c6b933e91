"""Chunked prefill in the port's CBEngine, on the CPU: the tests of
``tests/test_cb_engine.py`` on chunking, on ``tiny`` in f32 with the JAX
weights carried across through numpy. A prompt longer than
``prefill_chunk`` fills its KV one chunk per loop iteration (an extend
dispatch through ``decoder.prefill_suffix_batch_into_pages``) and its last
chunk goes through the suffix admission.
"""

import threading
import time

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
GEOM = dict(pad_token_id=0, max_slots=4, page_size=8, max_seq_len=96,
            prompt_buckets=(8, 16, 64), num_pages=96)


@pytest.fixture(scope="module")
def tree():
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))


def _engine(tree, prefill_chunk=8, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu",
                    prefill_chunk=prefill_chunk, **{**GEOM, **kw})


def _collect(q, timeout=120):
    items = []
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_END:
            return items
        items.append(item)


def test_prefill_chunk_must_be_page_multiple(tree):
    for bad in (-8, 5, 12):
        with pytest.raises(ValueError, match="prefill_chunk"):
            _engine(tree, prefill_chunk=bad)


def test_chunked_prefill_matches_unchunked_and_jax(tree):
    """Two chunked prompts (3 and 5 chunks) and one direct: exactly the
    unchunked engine's greedy tokens, and the JAX chunked engine's, with
    logprobs within 5e-4."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 512, n).tolist() for n in (24, 40, 5)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    chunked = _engine(tree)
    try:
        got = chunked.generate(prompts, sp, timeout=180.0)
    finally:
        chunked.stop()
    assert chunked.chunk_dispatches == 2 + 4  # the mid chunks of 24 and 40
    assert chunked.allocator.free_count == chunked.num_pages - 1
    plain = _engine(tree, prefill_chunk=0)
    try:
        ref = plain.generate(prompts, sp, timeout=180.0)
    finally:
        plain.stop()
    assert [o["token_ids"] for o in got] == [o["token_ids"] for o in ref]
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32),
                   jax.tree_util.tree_map(jnp.asarray, tree),
                   kv_cache_dtype=jnp.float32, prefill_chunk=8, **GEOM)
    try:
        jref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=8,
                                          stop_token_ids=()), timeout=180.0)
    finally:
        jeng.stop()
    for t, j in zip(got, jref):
        assert t["token_ids"] == list(j["token_ids"])
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0,
                                   atol=LP_TOL)


def test_chunked_prefill_interleaves_with_decode(tree):
    """While a long prompt chunks in, a running stream keeps decoding: a
    decode dispatch runs between consecutive chunks, and both finish."""
    rng = np.random.default_rng(12)
    eng = _engine(tree, steps_per_dispatch=1)
    marks = []
    advance = eng._advance_chunk_job

    def recording():
        marks.append(eng.decode_dispatches)
        advance()

    eng._advance_chunk_job = recording
    eng.start()
    sp = SamplingParams(temperature=0.0, max_new_tokens=24)
    q1 = eng.submit("r1", rng.integers(1, 512, 5).tolist(), sp)
    assert q1.get(timeout=60)["token_ids"]  # admitted and decoding
    q2 = eng.submit("r2", rng.integers(1, 512, 40).tolist(), sp)
    toks = [sum(len(i["token_ids"]) for i in _collect(q)) for q in (q1, q2)]
    eng.stop()
    assert toks == [23, 24]
    assert len(marks) == 5  # 4 extend dispatches and the final chunk
    assert eng.chunk_dispatches == 4
    assert all(b > a for a, b in zip(marks, marks[1:])), marks


def _wait_chunks(eng, n, timeout=120):
    t0 = time.monotonic()
    while eng.chunk_dispatches < n:
        assert time.monotonic() - t0 < timeout, "no chunk dispatch"
        time.sleep(0.005)


def test_chunked_prefill_abort_frees_pages(tree):
    """An abort after a chunk ran ends the job (an ``abort`` terminal) and
    returns its slot, pages and cache refs."""
    rng = np.random.default_rng(13)
    eng = _engine(tree)
    free0 = eng.allocator.free_count
    abort = threading.Event()
    slow = eng._advance_chunk_job

    def paced():  # let the test act between chunks
        time.sleep(0.05)
        slow()

    eng._advance_chunk_job = paced
    eng.start()
    q = eng.submit("rA", rng.integers(1, 512, 40).tolist(),
                   SamplingParams(temperature=0.0, max_new_tokens=8),
                   abort=abort)
    _wait_chunks(eng, 1)
    abort.set()
    items = _collect(q)
    assert items[-1]["finish_reason"] == "abort"
    assert not any(i["token_ids"] for i in items)
    t0 = time.monotonic()
    while eng.allocator.free_count != free0 and time.monotonic() - t0 < 10:
        time.sleep(0.02)
    eng.stop()
    assert eng.allocator.free_count == free0
    assert all(s is None for s in eng._slots) and not eng._chunk_jobs


def test_chunked_prefill_aborts_on_weight_swap(tree):
    """A weight update mid-job aborts the job (its filled KV belongs to the
    old weights) and its pages come back; never an error."""
    rng = np.random.default_rng(14)
    eng = _engine(tree)
    free0 = eng.allocator.free_count
    slow = eng._advance_chunk_job
    swapped = threading.Event()

    def paced():
        # after the first chunk the loop holds still, with the pool lock
        # released, until the swap has run: the job cannot finish first
        slow()
        if not swapped.is_set():
            eng._pool_lock.release()
            try:
                assert swapped.wait(60), "no weight swap"
            finally:
                eng._pool_lock.acquire()

    eng._advance_chunk_job = paced
    eng.start()
    q = eng.submit("rW", rng.integers(1, 512, 40).tolist(),
                   SamplingParams(temperature=0.0, max_new_tokens=8))
    _wait_chunks(eng, 1)
    eng.update_weights(eng.params, version=99)
    swapped.set()
    items = _collect(q)
    assert items[-1]["finish_reason"] == "abort", items
    t0 = time.monotonic()
    while eng.allocator.free_count != free0 and time.monotonic() - t0 < 10:
        time.sleep(0.02)
    eng.stop()
    assert eng.allocator.free_count == free0


def test_group_siblings_wait_for_a_chunked_leader(tree):
    """Siblings of a prompt that is chunking in wait for its publish and
    attach to its pages: the prompt is prefilled once."""
    rng = np.random.default_rng(15)
    prompt = rng.integers(1, 512, 40).tolist()
    eng = _engine(tree)
    outs = [eng.submit(f"g{i}", prompt,
                       SamplingParams(temperature=0.0, max_new_tokens=6),
                       group_id="g", group_size=3) for i in range(3)]
    eng.start()
    res = [[t for i in _collect(q) for t in i["token_ids"]] for q in outs]
    eng.stop()
    assert res[0] == res[1] == res[2] and len(res[0]) == 6
    assert eng.chunk_dispatches == 4
    assert eng.group_forked_requests == 2
    assert eng.allocator.free_count == eng.num_pages - 1
