"""core_algos parity: every ported function against the JAX package's on
the same numpy inputs, in f32. Tolerance rtol=atol=1e-5: the same
arithmetic in another reduction order. clip_cov runs on inputs without
ties (its top-k choice would otherwise be order-dependent)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.ops import core_algos as J
from polyrl_tpu_torch.ops import core_algos as P

TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 8, 12


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    lens = rng.integers(1, T + 1, B)
    for i, n in enumerate(lens):
        mask[i, n:] = 0
    return dict(
        rng=rng, mask=mask,
        rewards=(rng.standard_normal((B, T)) * mask).astype(np.float32),
        values=rng.standard_normal((B, T)).astype(np.float32),
        lp=-np.abs(rng.standard_normal((B, T))).astype(np.float32),
        old=-np.abs(rng.standard_normal((B, T))).astype(np.float32),
        ref=-np.abs(rng.standard_normal((B, T))).astype(np.float32),
        adv=rng.standard_normal((B, T)).astype(np.float32),
        gids=np.repeat(np.arange(B // 2), 2).astype(np.int32))


def _close(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("name", ["masked_sum", "masked_mean", "masked_var",
                                  "masked_whiten"])
def test_masked_stats(name):
    d = _inputs(1)
    _close(getattr(P, name)(*_t(d["values"], d["mask"])),
           getattr(J, name)(d["values"], d["mask"]))
    if name in ("masked_sum", "masked_mean"):
        _close(getattr(P, name)(*_t(d["values"], d["mask"]), axis=-1),
               getattr(J, name)(d["values"], d["mask"], axis=-1))


@pytest.mark.parametrize("est", ["gae", "grpo", "grpo_nostd", "rloo",
                                 "reinforce_plus_plus", "remax"])
def test_advantage_estimators(est):
    d = _inputs(2)
    r, m, g = d["rewards"], d["mask"], d["gids"]
    if est == "gae":
        got = P.compute_gae_advantage_return(*_t(r, d["values"], m), 0.99, 0.95)
        want = J.compute_gae_advantage_return(r, d["values"], m, 0.99, 0.95)
    elif est.startswith("grpo"):
        norm = est == "grpo"
        got = P.compute_grpo_outcome_advantage(*_t(r, m, g), norm_adv_by_std=norm,
                                               num_groups=4)
        want = J.compute_grpo_outcome_advantage(r, m, jnp.asarray(g),
                                                norm_adv_by_std=norm, num_groups=4)
    elif est == "rloo":
        got = P.compute_rloo_outcome_advantage(*_t(r, m, g), num_groups=4)
        want = J.compute_rloo_outcome_advantage(r, m, jnp.asarray(g), num_groups=4)
    elif est == "reinforce_plus_plus":
        got = P.compute_reinforce_plus_plus_outcome_advantage(*_t(r, m), 0.9)
        want = J.compute_reinforce_plus_plus_outcome_advantage(r, m, 0.9)
    else:
        base = d["rng"].standard_normal(B).astype(np.float32)
        got = P.compute_remax_outcome_advantage(*_t(r, base, m))
        want = J.compute_remax_outcome_advantage(r, base, m)
    _close(got, want)


@pytest.mark.parametrize("penalty", ["kl", "abs", "mse", "low_var_kl", "k3"])
def test_kl_penalty_and_apply(penalty):
    d = _inputs(3)
    _close(P.kl_penalty(*_t(d["lp"], d["ref"]), penalty),
           J.kl_penalty(d["lp"], d["ref"], penalty))
    _close(P.apply_kl_penalty(*_t(d["rewards"], d["lp"], d["ref"], d["mask"]),
                              0.05, penalty),
           J.apply_kl_penalty(d["rewards"], d["lp"], d["ref"], d["mask"], 0.05,
                              penalty))
    with pytest.raises(NotImplementedError):
        P.kl_penalty(*_t(d["lp"], d["ref"]), "bogus")


def test_importance_weights():
    d = _inputs(4)
    beh = d["old"] + 0.8 * d["rng"].standard_normal((B, T)).astype(np.float32)
    _close(P.truncated_importance_weights(*_t(d["old"], beh, d["mask"]), cap=1.5),
           J.truncated_importance_weights(d["old"], beh, d["mask"], cap=1.5))
    wv = d["rng"].integers(-1, 4, (B, T)).astype(np.int32)
    for versions in (wv, None):
        w, r, s = P.mixed_version_importance_weights(
            d["old"], beh, d["mask"], versions, current_version=3, cap=1.5)
        jw, jr, js = J.mixed_version_importance_weights(
            d["old"], beh, d["mask"], versions, current_version=3, cap=1.5)
        _close((w, r), (jw, jr))
        assert s.keys() == js.keys()
        for key in s:
            if key == "per_lag":
                assert s[key].keys() == js[key].keys()
                for lag in s[key]:
                    for f in ("tokens", "clipped"):
                        assert s[key][lag][f] == js[key][lag][f]
                    np.testing.assert_allclose(s[key][lag]["weight_sum"],
                                               js[key][lag]["weight_sum"], **TOL)
            else:
                np.testing.assert_allclose(s[key], js[key], **TOL)


@pytest.mark.parametrize("mode", ["token-mean", "seq-mean-token-sum",
                                  "seq-mean-token-mean",
                                  "seq-mean-token-sum-norm"])
def test_agg_loss_modes(mode):
    d = _inputs(5)
    _close(P.agg_loss(*_t(d["values"], d["mask"]), mode),
           J.agg_loss(d["values"], d["mask"], mode))


@pytest.mark.parametrize("name,kw", [
    ("vanilla", {}),
    ("vanilla", dict(clip_ratio_low=0.1, clip_ratio_high=0.3, clip_ratio_c=2.0,
                     loss_agg_mode="seq-mean-token-mean")),
    ("gpg", {}),
    ("clip_cov", dict(clip_cov_ratio=0.05, clip_cov_lb=0.0, clip_cov_ub=10.0)),
])
def test_policy_losses(name, kw):
    d = _inputs(6)
    # distinct ratios and advantages: no ties anywhere (clip_cov's top-k)
    lp = d["old"] + 0.5 * d["rng"].standard_normal((B, T)).astype(np.float32)
    pf, jf = P.get_policy_loss_fn(name), J.get_policy_loss_fn(name)
    _close(pf(*_t(d["old"], lp, d["adv"], d["mask"]), **kw),
           jf(d["old"], lp, d["adv"], d["mask"], **kw))


def test_policy_loss_gradients_match_jax():
    """The vanilla loss's gradient with respect to the logprobs."""
    import jax

    d = _inputs(7)
    lp = d["old"] + 0.3 * d["rng"].standard_normal((B, T)).astype(np.float32)
    tlp = torch.from_numpy(lp).requires_grad_(True)
    P.compute_policy_loss_vanilla(*_t(d["old"]), tlp, *_t(d["adv"], d["mask"]))[0].backward()
    jg = jax.grad(lambda x: J.compute_policy_loss_vanilla(
        d["old"], x, d["adv"], d["mask"])[0])(jnp.asarray(lp))
    _close(tlp.grad, jg)


def test_value_loss_entropy_logprobs():
    d = _inputs(8)
    vp = d["values"] + 0.7 * d["rng"].standard_normal((B, T)).astype(np.float32)
    ret = d["rng"].standard_normal((B, T)).astype(np.float32)
    _close(P.compute_value_loss(*_t(vp, ret, d["values"], d["mask"]), 0.3),
           J.compute_value_loss(vp, ret, d["values"], d["mask"], 0.3))
    logits = (3 * d["rng"].standard_normal((B, T, 17))).astype(np.float32)
    labels = d["rng"].integers(0, 17, (B, T)).astype(np.int32)
    _close(P.entropy_from_logits(*_t(logits)), J.entropy_from_logits(logits))
    _close(P.logprobs_from_logits(*_t(logits, labels)),
           J.logprobs_from_logits(logits, jnp.asarray(labels)))
    with pytest.raises(NotImplementedError):
        P.get_policy_loss_fn("bogus")
