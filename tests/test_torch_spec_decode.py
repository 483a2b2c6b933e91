"""Prompt-lookup speculative decoding in the port's CBEngine, on the CPU.

Speculation must not show in the output: greedy decode is token-exact
against the plain engine (and the JAX engine), sampled decode keeps the
target distribution (held on the verify sampler, where the arithmetic
lives). Each test mirrors one of ``tests/test_spec_decode.py`` on ``tiny``
in f32 with the JAX weights carried across through numpy, plus the
proposer and the greedy verify sampler bit for bit against JAX, and the
token history surviving a device-state upload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.cb_engine import device_ngram_propose as j_propose
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu.rollout.sampling import spec_verify_sample_vec as j_verify
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.models.quant import quantize_params
from polyrl_tpu_torch.rollout.cb_engine import CBEngine, device_ngram_propose
from polyrl_tpu_torch.rollout.sampling import SamplingParams, spec_verify_sample_vec

LP_TOL = 5e-4
VOCAB = 128
GEOM = dict(max_slots=4, page_size=8, max_seq_len=128, prompt_buckets=(16, 32),
            num_pages=64)
REP = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]  # period-3 repetition


@pytest.fixture(scope="module")
def tree():
    cfg = jdec.get_config("tiny", dtype=jnp.float32, vocab_size=VOCAB)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))


def _cfg():
    return decoder.get_config("tiny", dtype=torch.float32, vocab_size=VOCAB)


def _engine(tree, spec_tokens, params=None, **kw):
    params = params or params_from_numpy(tree, "cpu", torch.float32)
    return CBEngine(_cfg(), params, pad_token_id=0, kv_cache_dtype=torch.float32,
                    device="cpu", spec_tokens=spec_tokens, **{**GEOM, **kw})


def _gen(engine, prompts, max_new, temperature, stops=()):
    sp = SamplingParams(temperature=temperature, max_new_tokens=max_new,
                        stop_token_ids=tuple(stops))
    try:
        outs = engine.generate(prompts, sp, timeout=300.0)
    finally:
        engine.stop()
    return [o["token_ids"] for o in outs], [o["logprobs"] for o in outs]


# -- the proposer and the verify sampler ----------------------------------------


def test_ngram_proposer_cases():
    """Trigram preferred over a later bigram, bigram fallback, self-match
    excluded, continuation past the history, short history (the JAX
    test's cases)."""
    buf = np.zeros((5, 16), np.int32)
    buf[0, :8] = [1, 2, 3, 9, 9, 1, 2, 3]
    buf[1, :4] = [4, 5, 6, 7]
    buf[2, :1] = [8]
    buf[3, :4] = [5, 6, 5, 6]
    buf[4, :11] = [1, 2, 3, 5, 7, 2, 3, 9, 1, 2, 3]
    out = device_ngram_propose(torch.from_numpy(buf),
                               torch.tensor([8, 4, 1, 4, 11]), 4).numpy()
    assert out[0].tolist() == [9, 9, 1, 2]
    assert out[1].tolist() == [7, 7, 7, 7]
    assert out[2].tolist() == [8, 8, 8, 8]
    assert out[3].tolist() == [5, 6, 6, 6]
    assert out[4].tolist() == [5, 7, 2, 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposer_bitwise_against_jax(seed):
    """Seeded buffers over a small alphabet (many matches), with history
    lengths 0, 1, 2, 3, the full row and random ones, and rows with no
    match at all: the JAX proposer's drafts exactly."""
    rng = np.random.default_rng(seed)
    s, length = 24, 40
    buf = rng.integers(1, 5, (s, length)).astype(np.int32)
    buf[-3:] = np.arange(1, length + 1, dtype=np.int32)  # no repeated n-gram
    hist = rng.integers(0, length + 1, s).astype(np.int32)
    hist[:5] = [0, 1, 2, 3, length]
    for n_draft in (1, 3, 6):
        want = np.asarray(j_propose(jnp.asarray(buf), jnp.asarray(hist), n_draft))
        got = device_ngram_propose(torch.from_numpy(buf),
                                   torch.from_numpy(hist), n_draft)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _verify_both(logits, draft, temps, top_ps, top_ks, use_filters, seed=0):
    j = j_verify(jnp.asarray(logits), jnp.asarray(draft), jax.random.PRNGKey(seed),
                 jnp.asarray(temps), jnp.asarray(top_ps), jnp.asarray(top_ks),
                 use_filters)
    t = spec_verify_sample_vec(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.Generator().manual_seed(seed), torch.from_numpy(temps),
        torch.from_numpy(top_ps), torch.from_numpy(top_ks), use_filters)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("use_filters", [False, True])
def test_verify_greedy_against_jax(use_filters):
    """Greedy rows: tokens and n_acc equal to JAX's, logprobs within 5e-4;
    drafts that match the argmax everywhere, up to one position, and
    nowhere."""
    s, m, v = 6, 5, 64
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((s, m, v)) * 2).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = greedy[:, :m - 1].astype(np.int32).copy()
    for row, wrong_at in ((1, 0), (2, 1), (3, 2), (4, 3)):
        draft[row, wrong_at] = (draft[row, wrong_at] + 1) % v
    draft[5] = (draft[5] + 7) % v
    temps = np.zeros((s,), np.float32)
    top_ps = np.full((s,), 0.9, np.float32)
    top_ks = np.full((s,), 8, np.int32)
    (jt, jl, jn), (tt, tl, tn) = _verify_both(logits, draft, temps, top_ps,
                                              top_ks, use_filters)
    assert tn.tolist() == jn.tolist() == [4, 0, 1, 2, 3, 0]
    np.testing.assert_array_equal(tt, jt)
    assert tt[0].tolist() == greedy[0].tolist()  # drafts + greedy bonus
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LP_TOL)
    assert (tl <= 0).all()


def test_verify_sampled_marginal_is_the_target():
    """The first emitted token's marginal equals softmax(logits[0])
    whatever the deterministic draft proposes."""
    v, m, n = 8, 3, 4000
    row = np.random.default_rng(1).normal(size=(v,)).astype(np.float32)
    target = np.exp(row) / np.exp(row).sum()
    logits = np.ascontiguousarray(np.broadcast_to(row, (n, m, v)))
    draft = np.full((n, m - 1), int(np.argmax(target)), np.int32)
    toks, _, _ = spec_verify_sample_vec(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.Generator().manual_seed(2), torch.ones(n), torch.ones(n),
        torch.zeros(n, dtype=torch.int32), use_filters=False)
    emp = np.bincount(toks[:, 0].numpy(), minlength=v) / n
    assert np.abs(emp - target).max() < 0.04, (emp, target)


def test_verify_respects_filters():
    """With top_k 2 every emitted token is in the top-2 set and a draft
    outside it is never accepted."""
    v, m, n = 16, 3, 256
    row = np.zeros((v,), np.float32)
    row[3], row[7] = 4.0, 3.5
    logits = np.ascontiguousarray(np.broadcast_to(row, (n, m, v)))
    draft = np.full((n, m - 1), 11, np.int32)
    toks, lps, n_acc = spec_verify_sample_vec(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.Generator().manual_seed(3), torch.ones(n), torch.ones(n),
        torch.full((n,), 2, dtype=torch.int32), use_filters=True)
    assert (n_acc == 0).all()
    assert np.isin(toks[:, 0].numpy(), [3, 7]).all()
    assert torch.isfinite(lps[:, 0]).all()


# -- the engine -------------------------------------------------------------------


def test_greedy_spec_token_exact_against_plain_and_jax(tree):
    """A repetitive prompt (high acceptance) and a random one (mostly
    rejected): the spec engine's greedy tokens equal the port's plain
    engine's and the JAX spec engine's, logprobs within 5e-4 of both; one
    round per dispatch gives the same tokens."""
    rnd = np.random.default_rng(4).integers(1, 100, 13).tolist()
    prompts = [REP, rnd]
    want_t, want_l = _gen(_engine(tree, 0), prompts, 24, 0.0)
    spec = _engine(tree, 4)
    got_t, got_l = _gen(spec, prompts, 24, 0.0)
    assert spec.spec_dispatches > 0
    # every token after the prefill's came from a spec dispatch, and the
    # repetitive prompt accepted drafts
    assert spec.spec_emitted == sum(len(t) for t in got_t) - 2
    assert spec.spec_emitted > spec.spec_dispatches * len(prompts)
    assert 0 < spec.spec_accept_rate <= 1
    assert got_t == want_t
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=0, atol=LP_TOL)
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32, vocab_size=VOCAB),
                   jax.tree_util.tree_map(jnp.asarray, tree), pad_token_id=0,
                   kv_cache_dtype=jnp.float32, spec_tokens=4, **GEOM)
    try:
        ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=24),
                            timeout=300.0)
    finally:
        jeng.stop()
    assert got_t == [list(r["token_ids"]) for r in ref]
    for g, r in zip(got_l, ref):
        np.testing.assert_allclose(g, r["logprobs"], rtol=0, atol=LP_TOL)
    one_round, _ = _gen(_engine(tree, 3, spec_rounds=1), [REP], 20, 0.0)
    assert one_round[0] == want_t[0][:20]


def test_spec_budget_and_stop_semantics(tree):
    """Budgets are exact under speculation (no overshoot), and a stop token
    inside an accepted draft ends the stream there."""
    prompts = [[9, 8, 9, 8, 9, 8, 9], [3, 4, 5, 6, 3, 4, 5, 6]]
    toks, lps = _gen(_engine(tree, 4), prompts, 17, 1.0)
    assert all(len(t) == 17 for t in toks)
    assert all(np.isfinite(lp).all() and (np.asarray(lp) <= 1e-6).all()
               for lp in lps)
    ref, _ = _gen(_engine(tree, 4), [prompts[0]], 8, 0.0)
    stop_tok = ref[0][2]
    out, _ = _gen(_engine(tree, 4), [prompts[0]], 8, 0.0, stops=(stop_tok,))
    first = ref[0].index(stop_tok)
    assert out[0] == ref[0][:first + 1]  # cut at the stop token
    assert out[0][-1] == stop_tok


def test_spec_with_chunked_prefill_greedy_parity(tree):
    """Long prompts admitted chunk by chunk while speculative dispatches
    run: greedy tokens equal the plain engine's (no chunking, no
    speculation)."""
    rng = np.random.default_rng(13)
    kw = dict(max_seq_len=96, prompt_buckets=(8, 16, 64), num_pages=96)
    base = rng.integers(1, VOCAB, 12).tolist()
    prompts = [base * 2, base * 3 + base[:4], base[:5]]  # 24/40/5 tokens
    ref, _ = _gen(_engine(tree, 0, **kw), prompts, 10, 0.0)
    eng = _engine(tree, 3, prefill_chunk=8, **kw)
    got, _ = _gen(eng, prompts, 10, 0.0)
    assert eng.spec_dispatches > 0 and eng.chunk_dispatches > 0
    assert got == ref
    assert eng.allocator.free_count == eng.num_pages - 1


def test_spec_int8_greedy_parity(tree):
    """Speculation over int8 weight-only serving: spec and plain int8
    engines give the same greedy tokens."""
    q = quantize_params(params_from_numpy(tree, "cpu", torch.float32))
    ref, _ = _gen(_engine(tree, 0, params=q), [REP], 16, 0.0)
    eng = _engine(tree, 4, params=q)
    got, _ = _gen(eng, [REP], 16, 0.0)
    assert eng.spec_dispatches > 0
    assert got == ref


def _spec_run(tree, reupload: bool):
    """A synchronous spec engine driven dispatch by dispatch on the
    repetitive prompt; with ``reupload`` the device state is marked stale
    (a host event) before every dispatch, so each one uploads it from the
    host mirrors, the token history included."""
    eng = _engine(tree, 4, pipeline_depth=0)
    q = eng.submit("r", REP, SamplingParams(temperature=0.0, max_new_tokens=40))
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        i = 0
        while eng._active.any():
            if reupload and i > 0:
                eng._drain_emit_q()
                eng._dev_stale = True
            eng._step_once()
            i += 1
        eng._drain_emit_q()
    toks = []
    while not q.empty():
        item = q.get()
        if isinstance(item, dict):
            toks += item["token_ids"]
    eng.stop()
    return toks, eng.spec_dispatches, eng.spec_emitted


def test_acceptance_survives_a_device_state_upload(tree):
    """An upload after a host event must carry the token history (a zeroed
    one keeps the tokens right and collapses acceptance): the uploaded
    rows are the slot's prompt and emitted tokens, as the device had them,
    and a run uploading before every dispatch gives the same tokens from
    the same number of dispatches as one that never uploads."""
    eng = _engine(tree, 4, pipeline_depth=0)
    eng.submit("r", REP, SamplingParams(temperature=0.0, max_new_tokens=40))
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._step_once()
        eng._drain_emit_q()
        slot = next(i for i, info in enumerate(eng._slots) if info is not None)
        hist = list(eng._hist[slot])
        assert hist[:len(REP)] == REP and len(hist) > len(REP) + 2
        before = eng._dev["tok_buf"][slot, :len(hist)].tolist()
        eng._dev_stale = True
        eng._ensure_dev_state()
        after = eng._dev["tok_buf"][slot, :len(hist)].tolist()
    eng.stop()
    assert after == before == hist

    toks0, disp0, emitted0 = _spec_run(tree, reupload=False)
    toks1, disp1, emitted1 = _spec_run(tree, reupload=True)
    assert toks1 == toks0 and len(toks0) == 40
    assert emitted1 == emitted0 == 39
    assert disp1 == disp0 < 39 // 2  # more than two tokens per dispatch
