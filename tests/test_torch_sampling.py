"""Sampling parity: the port's sampler against the JAX one on the CPU.

Greedy rows and the top-k/top-p filtered distributions must match the JAX
functions exactly; random draws come from different generators, so
sampled tokens are held to the filtered distribution by a chi-square test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from polyrl_tpu.rollout import sampling as jsamp
from polyrl_tpu_torch.rollout import sampling as tsamp


def _logits(seed, s=6, v=97):
    return np.random.default_rng(seed).standard_normal((s, v)).astype(np.float32) * 3


def test_greedy_tokens_and_logprobs_exact():
    logits = _logits(0)
    s = logits.shape[0]
    temps = np.zeros((s,), np.float32)
    ones = np.ones((s,), np.float32)
    ks = np.zeros((s,), np.int32)
    jt, jl = jsamp.sample_token_vec(logits, jax.random.PRNGKey(0), temps, ones, ks)
    tt, tl = tsamp.sample_token_vec(torch.from_numpy(logits),
                                    torch.Generator().manual_seed(0),
                                    torch.from_numpy(temps),
                                    torch.from_numpy(ones), torch.from_numpy(ks))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the same log-softmax formula; the two frameworks sum the exponentials
    # in another order, so the logprob may differ in its last f32 bit
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    assert tt.dtype == torch.int32


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (8, 0.5),
                                         (1, 0.9), (3, 0.3)])
def test_filtered_sets_equal(top_k, top_p):
    logits = _logits(1)
    s = logits.shape[0]
    temps = np.full((s,), 0.8, np.float32)
    temps[0] = 1.3
    tps = np.full((s,), top_p, np.float32)
    tks = np.full((s,), top_k, np.int32)
    j = np.asarray(jsamp._filtered_scaled(logits, temps, tps, tks, True))
    t = tsamp._filtered_scaled(torch.from_numpy(logits), torch.from_numpy(temps),
                               torch.from_numpy(tps), torch.from_numpy(tks),
                               True).numpy()
    neg = float(np.finfo(np.float32).min)
    np.testing.assert_array_equal(t == neg, j == neg)
    np.testing.assert_allclose(t[t != neg], j[j != neg], rtol=1e-6, atol=1e-6)
    if top_k:
        assert ((t != neg).sum(-1) <= top_k).all()


def test_unfiltered_is_temperature_scaling_only():
    """use_filters=False (no row filters): plain temperature scaling."""
    logits = _logits(1)
    temps = np.linspace(0.5, 1.5, logits.shape[0]).astype(np.float32)
    ones = np.ones_like(temps)
    zeros = np.zeros(temps.shape, np.int32)
    j = np.asarray(jsamp._filtered_scaled(logits, temps, ones, zeros, False))
    t = tsamp._filtered_scaled(torch.from_numpy(logits), torch.from_numpy(temps),
                               torch.from_numpy(ones), torch.from_numpy(zeros),
                               False).numpy()
    np.testing.assert_array_equal(t, j)


def test_sampled_logprob_is_the_filtered_logprob():
    logits = _logits(2)
    s = logits.shape[0]
    temps = np.full((s,), 0.9, np.float32)
    tps = np.full((s,), 0.8, np.float32)
    tks = np.full((s,), 10, np.int32)
    tt, tl = tsamp.sample_token_vec(
        torch.from_numpy(logits), torch.Generator().manual_seed(3),
        torch.from_numpy(temps), torch.from_numpy(tps), torch.from_numpy(tks))
    scaled = jsamp._filtered_scaled(logits, temps, tps, tks, True)
    ref = np.asarray(jax.nn.log_softmax(scaled, axis=-1))
    tok = tt.numpy()
    np.testing.assert_allclose(tl.numpy(), ref[np.arange(s), tok], rtol=1e-5,
                               atol=1e-5)
    assert (ref[np.arange(s), tok] > -1e30).all()  # never a filtered token


@pytest.mark.parametrize("top_k,top_p,temp", [(0, 1.0, 1.0), (6, 1.0, 0.7),
                                              (0, 0.8, 1.2)])
def test_sample_frequencies_chi_square(top_k, top_p, temp):
    """20k draws of one row: frequencies against the JAX filtered softmax
    (chi-square, p > 1e-3; fixed generator seed, so deterministic)."""
    v, n = 12, 20000
    row = _logits(4, s=1, v=v)
    logits = np.repeat(row, n, axis=0)
    temps = np.full((n,), temp, np.float32)
    tps = np.full((n,), top_p, np.float32)
    tks = np.full((n,), top_k, np.int32)
    tt, _ = tsamp.sample_token_vec(
        torch.from_numpy(logits), torch.Generator().manual_seed(7),
        torch.from_numpy(temps), torch.from_numpy(tps), torch.from_numpy(tks),
        use_filters=bool(top_k or top_p < 1.0))
    probs = np.asarray(jax.nn.softmax(jsamp._filtered_scaled(
        row, temps[:1], tps[:1], tks[:1], True), axis=-1))[0]
    counts = np.bincount(tt.numpy(), minlength=v)
    assert counts[probs < 1e-12].sum() == 0  # nothing outside the set
    keep = probs > 1e-12
    p = probs[keep].astype(np.float64)
    res = stats.chisquare(counts[keep], p / p.sum() * counts[keep].sum())
    assert res.pvalue > 1e-3, (counts, probs)


def test_sampling_params_from_dict_clamps_budget():
    sp = tsamp.SamplingParams.from_dict({"max_new_tokens": 0, "top_k": 3,
                                         "stop_token_ids": [2, 5]})
    assert sp.max_new_tokens == 1 and sp.top_k == 3 and sp.stop_token_ids == (2, 5)
    assert sp == tsamp.SamplingParams(**{f: getattr(sp, f) for f in (
        "temperature", "top_p", "top_k", "max_new_tokens", "stop_token_ids")})
    j = jsamp.SamplingParams.from_dict({"max_new_tokens": 0, "top_k": 3,
                                        "stop_token_ids": [2, 5]})
    assert (j.max_new_tokens, j.top_k, j.stop_token_ids) == (1, 3, (2, 5))
    assert jnp.finfo(jnp.float32).min == tsamp.NEG_INF
