"""Token sampling: temperature / top-k / top-p with per-row parameters.

Counterpart of ``polyrl_tpu/rollout/sampling.py``. Greedy rows, the
top-k/top-p filtered sets and the returned logprobs follow the JAX
functions exactly; random draws come from an explicit ``torch.Generator``
(Gumbel-max, the same construction ``jax.random.categorical`` uses), so
sampled tokens differ from JAX's while their distribution is the same.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    max_new_tokens: int = 128
    stop_token_ids: tuple[int, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "SamplingParams":
        return SamplingParams(
            temperature=float(d.get("temperature", 1.0)),
            top_p=float(d.get("top_p", 1.0)),
            top_k=int(d.get("top_k", 0)),
            # clamp: a 0/negative budget would leave the stream empty
            max_new_tokens=max(int(d.get("max_new_tokens", 128)), 1),
            stop_token_ids=tuple(d.get("stop_token_ids", ())),
        )


def _filtered_scaled(logits: torch.Tensor,  # [S, V] f32
                     temps: torch.Tensor,   # [S] f32
                     top_ps: torch.Tensor,  # [S] f32
                     top_ks: torch.Tensor,  # [S] int
                     use_filters: bool) -> torch.Tensor:
    """Temperature-scaled logits with per-row top-k/top-p masks applied:
    THE sampling distribution."""
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    if use_filters:
        v = logits.shape[-1]
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        idx_k = (top_ks.long() - 1).clamp(0, v - 1)
        thr_k = sorted_desc.gather(-1, idx_k[:, None])
        scaled = torch.where((top_ks[:, None] > 0) & (scaled < thr_k),
                             NEG_INF, scaled)
        sorted2 = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted2, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        kept = (cum - probs < top_ps[:, None]).sum(dim=-1, keepdim=True)
        thr_p = sorted2.gather(-1, (kept - 1).clamp(min=0))
        scaled = torch.where(scaled < thr_p, NEG_INF, scaled)
    return scaled


def sample_token_vec(logits: torch.Tensor,   # [S, V] f32
                     generator: torch.Generator,
                     temps: torch.Tensor,    # [S] f32; <= 0 = greedy
                     top_ps: torch.Tensor,   # [S] f32; 1 = disabled
                     top_ks: torch.Tensor,   # [S] int; 0 = disabled
                     use_filters: bool = True,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling. Returns (token [S] int32, logprob [S] f32): the
    logprob of the sampled token under the filtered, temperature-scaled
    distribution, or under the raw logits for greedy rows. Skip the two
    [S, V] sorts with ``use_filters=False`` when no row filters."""
    greedy_tok = logits.argmax(dim=-1)
    greedy_logp = torch.log_softmax(logits, dim=-1).gather(
        -1, greedy_tok[:, None])[:, 0]

    scaled = _filtered_scaled(logits, temps, top_ps, top_ks, use_filters)
    logp_all = torch.log_softmax(scaled, dim=-1)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32).clamp_(min=torch.finfo(torch.float32).tiny)
    tok = (scaled - torch.log(-torch.log(u))).argmax(dim=-1)
    logp = logp_all.gather(-1, tok[:, None])[:, 0]

    is_greedy = temps <= 0.0
    token = torch.where(is_greedy, greedy_tok, tok).to(torch.int32)
    logp = torch.where(is_greedy, greedy_logp, logp)
    return token, logp
