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

    def group_key(self) -> tuple:
        """Batching key of the step backend: requests differing only in
        max_new_tokens share one batch (per-row budgets)."""
        return (self.temperature, self.top_p, self.top_k, self.stop_token_ids)

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


def _top_k_masked(scaled: torch.Tensor,  # [S, V] f32
                  top_ks: torch.Tensor   # [S] int; 0 = disabled
                  ) -> torch.Tensor:
    """Each row with ``top_k > 0`` keeps its ``top_k`` largest entries
    (ties at the threshold kept)."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    thr_k = sorted_desc.gather(-1, (top_ks.long() - 1).clamp(0, v - 1)[:, None])
    return torch.where((top_ks[:, None] > 0) & (scaled < thr_k), NEG_INF, scaled)


def _top_p_masked(scaled: torch.Tensor,  # [S, V] f32
                  top_ps: torch.Tensor   # [S] f32
                  ) -> torch.Tensor:
    """Each row keeps its tokens while the exclusive cumulative probability
    is under ``top_p``; the top-1 always stays."""
    sorted2 = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kept = (cum - probs < top_ps[:, None]).sum(dim=-1, keepdim=True)
    thr_p = sorted2.gather(-1, (kept - 1).clamp(min=0))
    return torch.where(scaled < thr_p, NEG_INF, scaled)


def _filtered_scaled(logits: torch.Tensor,  # [S, V] f32
                     temps: torch.Tensor,   # [S] f32
                     top_ps: torch.Tensor,  # [S] f32
                     top_ks: torch.Tensor,  # [S] int
                     use_filters: bool) -> torch.Tensor:
    """Temperature-scaled logits with per-row top-k/top-p masks applied:
    THE sampling distribution."""
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    if use_filters:
        scaled = _top_p_masked(_top_k_masked(scaled, top_ks), top_ps)
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


def spec_verify_sample_vec(logits: torch.Tensor,  # [S, m, V] f32
                           draft: torch.Tensor,   # [S, m-1] int
                           generator: torch.Generator,
                           temps: torch.Tensor,   # [S] f32; <= 0 = greedy
                           top_ps: torch.Tensor,
                           top_ks: torch.Tensor,
                           use_filters: bool = True,
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative (prompt-lookup) verify sampling. ``logits[s, i]`` is the
    next-token distribution after draft token ``i-1`` (position 0 follows
    the slot's last real token). Returns ``(tokens [S, m] int32, logps
    [S, m] f32, n_acc [S] int32)``: per slot the first ``n_acc`` tokens are
    accepted drafts and position ``n_acc`` holds the replacement or bonus
    sample, so ``n_acc + 1`` tokens are emitted.

    Distribution-exact for a deterministic proposal: a draft ``d`` is
    accepted with probability ``p(d)``; a rejection resamples from ``p``
    with ``d`` masked out; the bonus position (after every draft was
    accepted) samples ``p`` unadjusted. Greedy rows accept iff the argmax
    equals the draft and replace with the argmax, so greedy speculation is
    token-exact against plain greedy decode. The logp reported is the
    filtered one for sampled rows and the raw log-softmax for greedy rows,
    as in ``sample_token_vec``. Two draws, both from ``generator`` and of
    fixed shape (capture-safe): the acceptance uniforms, then the
    replacement's Gumbel noise."""
    s, m, v = logits.shape
    flat = logits.reshape(s * m, v)
    rep = lambda a: a.repeat_interleave(m, dim=0)  # noqa: E731
    scaled = _filtered_scaled(flat, rep(temps), rep(top_ps), rep(top_ks),
                              use_filters).reshape(s, m, v)
    logp_all = torch.log_softmax(scaled, dim=-1)
    raw_logp = torch.log_softmax(logits, dim=-1)
    greedy_tok = logits.argmax(dim=-1)                          # [S, m]
    is_greedy = temps <= 0.0
    d = draft.long()

    p_draft = logp_all[:, :m - 1].gather(-1, d[:, :, None])[:, :, 0].exp()
    u = torch.rand((s, m - 1), generator=generator, device=logits.device,
                   dtype=torch.float32)
    acc = torch.where(is_greedy[:, None], greedy_tok[:, :m - 1] == d,
                      u < p_draft)
    n_acc = acc.int().cumprod(dim=-1).sum(dim=-1)                # [S]

    # the draft token masked out of each position's replacement draw; the
    # bonus position m-1 is unadjusted. In a greedy row a rejection means
    # argmax != draft, so the mask leaves the argmax alone.
    adj = scaled.clone()
    adj[:, :m - 1].scatter_(-1, d[:, :, None], NEG_INF)
    g = torch.rand((s, m, v), generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_(min=torch.finfo(torch.float32).tiny)
    repl = (adj - torch.log(-torch.log(g))).argmax(dim=-1)
    repl = torch.where(is_greedy[:, None], greedy_tok, repl)

    tokens = torch.cat([d, torch.zeros((s, 1), dtype=torch.long,
                                       device=logits.device)], dim=1)
    sel = n_acc.long()[:, None]
    at_sel = torch.arange(m, device=logits.device)[None] == sel
    tokens = torch.where(at_sel, repl.gather(1, sel), tokens)
    lp_f = logp_all.gather(-1, tokens[:, :, None])[:, :, 0]
    lp_g = raw_logp.gather(-1, tokens[:, :, None])[:, :, 0]
    logps = torch.where(is_greedy[:, None], lp_g, lp_f)
    return tokens.to(torch.int32), logps, n_acc.to(torch.int32)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    ks = torch.full(logits.shape[:1], k, dtype=torch.int32, device=logits.device)
    return _top_k_masked(logits, ks)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    ps = torch.full(logits.shape[:1], p, dtype=torch.float32,
                    device=logits.device)
    return _top_p_masked(logits, ps)


def sample_token(logits: torch.Tensor,  # [B, V] f32
                 generator: torch.Generator,
                 params: SamplingParams) -> tuple[torch.Tensor, torch.Tensor]:
    """One sampling config for the whole batch (the step backend):
    ``sample_token_vec`` with the config broadcast to every row. Returns
    (token [B] int32, the logprob of the sampled token under the
    temperature-scaled, filtered distribution; under the raw logits for
    greedy)."""
    b, dev = logits.shape[0], logits.device
    full = lambda v, dt: torch.full((b,), v, dtype=dt, device=dev)  # noqa: E731
    return sample_token_vec(
        logits, generator, full(params.temperature, torch.float32),
        full(params.top_p, torch.float32), full(params.top_k, torch.int32),
        use_filters=params.top_p < 1.0 or params.top_k > 0)
