"""Core RL algorithms: advantage estimators, policy/value losses, KL penalties.

Counterpart of ``polyrl_tpu/ops/core_algos.py``, on torch tensors. Every
function keeps the JAX name, arguments and arithmetic; ``mask`` is 1.0 for
response tokens and 0.0 for prompt/padding tokens, shapes are
``[batch, seq]`` unless noted. The reverse scans (GAE, REINFORCE++) are
Python loops over the time axis. ``mixed_version_importance_weights`` is
host numpy, as in the JAX package.
"""

from __future__ import annotations

import enum
from typing import Callable

import numpy as np
import torch

_EPS = 1e-8


class AdvantageEstimator(str, enum.Enum):
    GAE = "gae"
    GRPO = "grpo"
    REINFORCE_PLUS_PLUS = "reinforce_plus_plus"
    REMAX = "remax"
    RLOO = "rloo"


# -- masked statistics ---------------------------------------------------------


def masked_sum(x: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    return torch.sum(x * mask) if axis is None else torch.sum(x * mask, dim=axis)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    den = torch.sum(mask) if axis is None else torch.sum(mask, dim=axis)
    return masked_sum(x, mask, axis=axis) / (den + _EPS)


def masked_var(x: torch.Tensor, mask: torch.Tensor,
               unbiased: bool = True) -> torch.Tensor:
    mean = masked_mean(x, mask)
    var = masked_mean((x - mean) ** 2, mask)
    if unbiased:
        n = torch.sum(mask)
        var = var * n / torch.clamp(n - 1.0, min=1.0)
    return var


def masked_whiten(x: torch.Tensor, mask: torch.Tensor,
                  shift_mean: bool = True) -> torch.Tensor:
    mean = masked_mean(x, mask)
    var = masked_var(x, mask)
    whitened = (x - mean) * torch.rsqrt(var + _EPS)
    if not shift_mean:
        whitened = whitened + mean
    return whitened * mask


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,), dtype=x.dtype, device=x.device)
    return out.index_add_(0, ids.long(), x)


# -- advantage estimators -------------------------------------------------------


def _reverse_scan(xs: torch.Tensor, mask: torch.Tensor, coef: float) -> torch.Tensor:
    """carry_t = where(mask_t > 0, x_t + coef * carry_{t+1}, carry_{t+1}),
    scanned from the last position back; returns every carry [B, T]."""
    carry = torch.zeros_like(xs[:, 0])
    out = torch.empty_like(xs)
    for t in range(xs.shape[1] - 1, -1, -1):
        carry = torch.where(mask[:, t] > 0, xs[:, t] + coef * carry, carry)
        out[:, t] = carry
    return out


def compute_gae_advantage_return(token_level_rewards, values, response_mask,
                                 gamma: float = 1.0, lam: float = 1.0):
    """GAE over the response region; advantages whitened over the mask."""
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], -1)
    next_mask = torch.cat([response_mask[:, 1:],
                           torch.zeros_like(response_mask[:, :1])], -1)
    deltas = token_level_rewards + gamma * next_values * next_mask - values
    advantages = _reverse_scan(deltas, response_mask, gamma * lam)
    returns = advantages + values
    advantages = masked_whiten(advantages, response_mask)
    return advantages * response_mask, returns * response_mask


def compute_grpo_outcome_advantage(token_level_rewards, response_mask, group_ids,
                                   norm_adv_by_std: bool = True,
                                   num_groups: int | None = None):
    """Per-group reward z-score broadcast over the response tokens."""
    scores = masked_sum(token_level_rewards, response_mask, axis=-1)
    if num_groups is None:
        num_groups = int(scores.shape[0])
    group_count = _segment_sum(torch.ones_like(scores), group_ids, num_groups)
    group_sum = _segment_sum(scores, group_ids, num_groups)
    group_mean = group_sum / torch.clamp(group_count, min=1.0)
    gi = group_ids.long()
    centered = scores - group_mean[gi]
    if norm_adv_by_std:
        group_sqsum = _segment_sum(centered ** 2, group_ids, num_groups)
        group_std = torch.sqrt(group_sqsum / torch.clamp(group_count - 1.0, min=1.0))
        centered = centered / (group_std[gi] + _EPS)
    advantages = centered[:, None] * response_mask
    return advantages, advantages


def compute_rloo_outcome_advantage(token_level_rewards, response_mask, group_ids,
                                   num_groups: int | None = None):
    """Leave-one-out baseline within each prompt group."""
    scores = masked_sum(token_level_rewards, response_mask, axis=-1)
    if num_groups is None:
        num_groups = int(scores.shape[0])
    group_count = _segment_sum(torch.ones_like(scores), group_ids, num_groups)
    group_sum = _segment_sum(scores, group_ids, num_groups)
    gi = group_ids.long()
    n = group_count[gi]
    loo_baseline = (group_sum[gi] - scores) / torch.clamp(n - 1.0, min=1.0)
    adv = torch.where(n > 1, scores - loo_baseline, scores)
    advantages = adv[:, None] * response_mask
    return advantages, advantages


def compute_reinforce_plus_plus_outcome_advantage(token_level_rewards,
                                                  response_mask,
                                                  gamma: float = 1.0):
    """Discounted reward-to-go, globally whitened."""
    returns = _reverse_scan(token_level_rewards, response_mask, gamma) * response_mask
    advantages = masked_whiten(returns, response_mask)
    return advantages * response_mask, returns


def compute_remax_outcome_advantage(token_level_rewards, reward_baselines,
                                    response_mask):
    """Subtract the greedy-rollout baseline reward [batch]."""
    scores = masked_sum(token_level_rewards, response_mask, axis=-1)
    returns = (scores - reward_baselines)[:, None] * response_mask
    return returns, returns


# -- KL penalties ---------------------------------------------------------------


def kl_penalty(logprob, ref_logprob, penalty: str = "kl"):
    """Per-token KL penalty between policy and reference logprobs."""
    if penalty == "kl":
        return logprob - ref_logprob
    if penalty == "abs":
        return torch.abs(logprob - ref_logprob)
    if penalty == "mse":
        return 0.5 * (logprob - ref_logprob) ** 2
    if penalty in ("low_var_kl", "k3"):
        kl = ref_logprob - logprob
        ratio = torch.exp(torch.clamp(kl, -20.0, 20.0))
        return torch.clamp(ratio - kl - 1.0, -10.0, 10.0)
    raise NotImplementedError(f"unknown kl penalty: {penalty}")


def apply_kl_penalty(token_level_scores, logprob, ref_logprob, response_mask,
                     kl_coef: float, penalty: str = "kl"):
    """Fold a KL penalty into token-level rewards; returns (rewards, mean_kl)."""
    kld = kl_penalty(logprob, ref_logprob, penalty) * response_mask
    return token_level_scores - kl_coef * kld, masked_mean(kld, response_mask)


def truncated_importance_weights(old_log_probs, rollout_log_probs, response_mask,
                                 cap: float = 2.0):
    """``w = min(exp(old_lp - rollout_lp), cap)``; returns (weights,
    raw_ratio, mean_weight, clip_frac)."""
    ratio = torch.exp(torch.clamp(old_log_probs - rollout_log_probs, -20.0, 20.0))
    weights = torch.clamp(ratio, max=cap) * response_mask
    mean_w = masked_mean(weights, response_mask)
    clip_frac = masked_mean((ratio > cap).float(), response_mask)
    return weights, ratio, mean_w, clip_frac


def mixed_version_importance_weights(old_log_probs, rollout_log_probs,
                                     response_mask, weight_versions,
                                     current_version: int, cap: float = 2.0):
    """Per-token truncated IS for tokens sampled under different weight
    versions (host numpy, as in the JAX package): unknown-version tokens
    (-1) get weight 1.0 and are counted; per-lag clip statistics. Returns
    (weights, raw_ratio, stats)."""
    old = np.asarray(old_log_probs, np.float32)
    beh = np.asarray(rollout_log_probs, np.float32)
    mask = np.asarray(response_mask) > 0
    wv = (np.full(old.shape, -1, np.int32) if weight_versions is None
          else np.asarray(weight_versions, np.int32))
    ratio = np.exp(np.clip(old - beh, -20.0, 20.0)).astype(np.float32)
    known = mask & (wv >= 0)
    unknown = mask & (wv < 0)
    weights = np.where(known, np.minimum(ratio, np.float32(cap)),
                       np.float32(0.0)).astype(np.float32)
    weights[unknown] = 1.0
    clipped = known & (ratio > cap)
    n_known = int(known.sum())
    n_mask = int(mask.sum())
    per_lag: dict[int, dict] = {}
    max_lag = 0
    if n_known:
        lags = np.maximum(int(current_version) - wv, 0)
        for lag in np.unique(lags[known]):
            sel = known & (lags == lag)
            per_lag[int(lag)] = {"tokens": int(sel.sum()),
                                 "weight_sum": float(weights[sel].sum()),
                                 "clipped": int(clipped[sel].sum())}
        max_lag = int(lags[known].max())
    stats = {
        "mean_weight": float(weights[mask].mean()) if n_mask else 1.0,
        "clip_frac": float(clipped.sum()) / n_known if n_known else 0.0,
        "known_tokens": n_known,
        "unknown_tokens": int(unknown.sum()),
        "max_lag": max_lag,
        "per_lag": per_lag,
    }
    return weights, ratio, stats


# -- loss aggregation -------------------------------------------------------------


def agg_loss(loss_mat, loss_mask, loss_agg_mode: str = "token-mean"):
    """Aggregate a [B, T] per-token loss into a scalar."""
    if loss_agg_mode == "token-mean":
        return masked_mean(loss_mat, loss_mask)
    if loss_agg_mode == "seq-mean-token-sum":
        return torch.mean(masked_sum(loss_mat, loss_mask, axis=-1))
    if loss_agg_mode == "seq-mean-token-mean":
        return torch.mean(masked_mean(loss_mat, loss_mask, axis=-1))
    if loss_agg_mode == "seq-mean-token-sum-norm":
        return torch.sum(masked_sum(loss_mat, loss_mask, axis=-1)) / loss_mask.shape[-1]
    raise NotImplementedError(f"unknown loss_agg_mode: {loss_agg_mode}")


# -- policy losses ------------------------------------------------------------------


def compute_policy_loss_vanilla(old_log_prob, log_prob, advantages, response_mask,
                                clip_ratio: float = 0.2,
                                clip_ratio_low: float | None = None,
                                clip_ratio_high: float | None = None,
                                clip_ratio_c: float = 3.0,
                                loss_agg_mode: str = "token-mean"):
    """PPO clipped surrogate with dual-clip; returns (loss, clipfrac,
    approx_kl, clipfrac_lower)."""
    lo = clip_ratio_low if clip_ratio_low is not None else clip_ratio
    hi = clip_ratio_high if clip_ratio_high is not None else clip_ratio
    negative_approx_kl = torch.clamp(log_prob - old_log_prob, -20.0, 20.0)
    ratio = torch.exp(negative_approx_kl)
    approx_kl = masked_mean(-negative_approx_kl, response_mask)
    pg_losses1 = -advantages * ratio
    pg_losses2 = -advantages * torch.clamp(ratio, 1.0 - lo, 1.0 + hi)
    clip_pg_losses1 = torch.maximum(pg_losses1, pg_losses2)
    clipfrac = masked_mean((pg_losses2 > pg_losses1).float(), response_mask)
    pg_losses3 = -advantages * clip_ratio_c
    clip_pg_losses2 = torch.minimum(pg_losses3, clip_pg_losses1)
    clipfrac_lower = masked_mean(
        ((clip_pg_losses1 > pg_losses3) & (advantages < 0)).float(), response_mask)
    pg_losses = torch.where(advantages < 0, clip_pg_losses2, clip_pg_losses1)
    pg_loss = agg_loss(pg_losses, response_mask, loss_agg_mode)
    return pg_loss, clipfrac, approx_kl, clipfrac_lower


def compute_policy_loss_gpg(old_log_prob, log_prob, advantages, response_mask,
                            loss_agg_mode: str = "token-mean", **_: object):
    """Plain policy-gradient loss (no ratio, no clip)."""
    pg_loss = agg_loss(-log_prob * advantages, response_mask, loss_agg_mode)
    zero = torch.zeros((), dtype=pg_loss.dtype, device=pg_loss.device)
    return pg_loss, zero, zero, zero


def compute_policy_loss_clip_cov(old_log_prob, log_prob, advantages, response_mask,
                                 clip_ratio: float = 0.2,
                                 clip_ratio_low: float | None = None,
                                 clip_ratio_high: float | None = None,
                                 clip_cov_ratio: float = 0.0002,
                                 clip_cov_lb: float = 1.0,
                                 clip_cov_ub: float = 5.0,
                                 loss_agg_mode: str = "token-mean"):
    """Clip-Cov: the top ``clip_cov_ratio`` of in-band covariance tokens
    are exempted from the PPO clip."""
    lo = clip_ratio_low if clip_ratio_low is not None else clip_ratio
    hi = clip_ratio_high if clip_ratio_high is not None else clip_ratio
    negative_approx_kl = torch.clamp(log_prob - old_log_prob, -20.0, 20.0)
    ratio = torch.exp(negative_approx_kl)
    approx_kl = masked_mean(-negative_approx_kl, response_mask)
    pg_losses1 = -advantages * ratio
    pg_losses2 = -advantages * torch.clamp(ratio, 1.0 - lo, 1.0 + hi)

    centered_lp = log_prob - masked_mean(log_prob, response_mask)
    centered_adv = advantages - masked_mean(advantages, response_mask)
    cov = torch.where(response_mask > 0, centered_lp * centered_adv,
                      float("-inf"))
    in_band = (cov >= clip_cov_lb) & (cov <= clip_cov_ub)
    n_tokens = advantages.shape[0] * advantages.shape[1]
    k = max(int(n_tokens * clip_cov_ratio), 1)
    flat_cov = torch.where(in_band.reshape(-1), cov.reshape(-1), float("-inf"))
    topk_idx = torch.topk(flat_cov.detach(), k).indices
    corr = torch.ones_like(advantages).reshape(-1)
    corr = corr.index_fill(0, topk_idx, 0.0).reshape(advantages.shape)
    corr = torch.where(torch.isfinite(flat_cov.reshape(advantages.shape)), corr, 1.0)

    clipped = (pg_losses2 > pg_losses1).float() * corr
    clipfrac = masked_mean(clipped, response_mask)
    pg_losses = torch.maximum(pg_losses1, pg_losses2) * corr + pg_losses1 * (1.0 - corr)
    pg_loss = agg_loss(pg_losses, response_mask, loss_agg_mode)
    return pg_loss, clipfrac, approx_kl, torch.zeros_like(clipfrac)


POLICY_LOSS_FNS: dict[str, Callable] = {
    "vanilla": compute_policy_loss_vanilla,
    "gpg": compute_policy_loss_gpg,
    "clip_cov": compute_policy_loss_clip_cov,
}


def get_policy_loss_fn(name: str = "vanilla") -> Callable:
    try:
        return POLICY_LOSS_FNS[name]
    except KeyError:
        raise NotImplementedError(f"unknown policy loss: {name}") from None


# -- value loss, entropy, logprobs ----------------------------------------------


def compute_value_loss(vpreds, returns, values, response_mask,
                       cliprange_value: float = 0.5,
                       loss_agg_mode: str = "token-mean"):
    """Clipped value loss; returns (loss, clipfrac)."""
    vpredclipped = torch.clamp(vpreds, values - cliprange_value,
                               values + cliprange_value)
    vf_losses1 = (vpreds - returns) ** 2
    vf_losses2 = (vpredclipped - returns) ** 2
    vf_loss = 0.5 * agg_loss(torch.maximum(vf_losses1, vf_losses2),
                             response_mask, loss_agg_mode)
    vf_clipfrac = masked_mean((vf_losses2 > vf_losses1).float(), response_mask)
    return vf_loss, vf_clipfrac


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Token-level entropy of a categorical distribution from raw logits."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token logprob of ``labels`` under ``logits`` ([..., V] -> [...])."""
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return label_logits - logz
