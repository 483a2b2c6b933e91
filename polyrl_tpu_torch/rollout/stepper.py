"""Step-wise decode of the step backend: a prefill, then one token per call.

Counterpart of ``polyrl_tpu/rollout/stepper.py``. ``RolloutEngine.generate``
decodes a whole batch in one call; this stepper is the serving path of the
step backend: the host drives one step per token, so the HTTP server can
stream each token's logprob, honour a per-row abort between steps and let
a continuation see partial outputs. The dense cache is ``pb + nb`` long,
``nb`` the new-token bucket of the batch's largest budget; per-row budgets
(``row_limit``) end rows earlier.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rollout.common import next_bucket, pack_left_padded
from polyrl_tpu_torch.rollout.sampling import SamplingParams, sample_token


@dataclasses.dataclass
class StepState:
    """Device state between steps."""

    step: int
    done: torch.Tensor          # [bb] bool
    last_logits: torch.Tensor   # [bb, V] f32
    cache: tuple                # (k, v) each [L, bb, pb + nb, Hkv, D]
    cache_mask: torch.Tensor    # [bb, pb + nb]
    prompt_len: torch.Tensor    # [bb] int32


class StepDecoder:
    def __init__(self, engine, new_buckets: tuple[int, ...] = (
            64, 128, 256, 512, 1024, 2048, 4096)):
        self.engine = engine
        self.cfg = engine.cfg
        self.new_buckets = tuple(new_buckets)

    @torch.no_grad()
    def prefill(self, ids: np.ndarray, mask: np.ndarray, nb: int) -> StepState:
        """The left-padded batch's prefill into a fresh ``pb + nb`` cache."""
        eng, cfg = self.engine, self.cfg
        dev = eng.device
        bb, pb = ids.shape
        mask_t = torch.from_numpy(mask).to(dev)
        positions = (mask_t.cumsum(-1) - 1).clamp(min=0).to(torch.int32)
        cache = decoder.make_cache(cfg, bb, pb + nb, dtype=eng.kv_cache_dtype,
                                   device=dev)
        cache_mask = torch.cat(
            [mask_t, torch.zeros((bb, nb), dtype=mask_t.dtype, device=dev)],
            dim=-1)
        logits, cache = decoder.forward(
            eng.params, cfg, torch.from_numpy(ids).to(dev), positions,
            cache_mask, cache=cache, write_idx=0,
            logits_for=torch.full((bb,), pb - 1, dtype=torch.int32, device=dev))
        prompt_len = mask_t.sum(-1).to(torch.int32)
        return StepState(0, prompt_len == 0, logits, cache, cache_mask,
                         prompt_len)

    @torch.no_grad()
    def step(self, st: StepState, sp: SamplingParams, pb: int,
             abort_mask: torch.Tensor, row_limit: torch.Tensor,
             generator: torch.Generator):
        """Sample one token per row and write its KV: returns (state, token
        [bb] int32, logprob [bb], done [bb]). Rows done or aborted emit the
        pad token; a row is done on a stop token or at its limit."""
        eng = self.engine
        pad = eng.pad_token_id
        stop_ids = torch.tensor(sp.stop_token_ids or (-1,), dtype=torch.int32,
                                device=eng.device)
        done = st.done | abort_mask
        token, logp = sample_token(st.last_logits, generator, sp)
        token = torch.where(done, pad, token)
        logp = torch.where(done, 0.0, logp)
        new_done = (done | (token[:, None] == stop_ids[None]).any(dim=-1)
                    | (st.step + 1 >= row_limit))
        write_idx = pb + st.step
        st.cache_mask[:, write_idx] = torch.where(done, 0.0, 1.0)
        logits, cache = decoder.forward(
            eng.params, self.cfg, token[:, None], (st.prompt_len + st.step)[:, None],
            st.cache_mask, cache=st.cache, write_idx=write_idx)
        return (StepState(st.step + 1, new_done, logits[:, 0], cache,
                          st.cache_mask, st.prompt_len), token, logp, new_done)

    def generate_stream(self, prompt_ids: list[list[int]],
                        sampling: SamplingParams,
                        max_new: list[int] | None = None, rng=None,
                        abort_flags: list | None = None):
        """Yields one dict per row and step: ``{row, token, logprob, done,
        finish_reason}``. ``max_new`` gives per-row budgets (a continuation
        shrinks its budget); ``abort_flags`` are ``threading.Event``-likes
        read between steps: an aborted row yields ``token=None`` once and
        ends. The engine's lock is held for the whole batch, so that a
        weight update lands between batches."""
        eng = self.engine
        n = len(prompt_ids)
        bb = next_bucket(n, eng.batch_buckets)
        pb = next_bucket(max(len(p) for p in prompt_ids), eng.prompt_buckets)
        limits = max_new if max_new is not None else [sampling.max_new_tokens] * n
        nb = next_bucket(max(limits), self.new_buckets)
        ids, mask = pack_left_padded(prompt_ids, eng.pad_token_id, bb, pb)
        row_limit = np.zeros((bb,), np.int32)
        row_limit[:n] = limits
        gen = eng.generator(rng)
        stop_set = set(sampling.stop_token_ids)
        with eng.lock:
            state = self.prefill(ids, mask, nb)
            limit_t = torch.from_numpy(row_limit).to(eng.device)
            prev_done = np.zeros((bb,), bool)
            prev_done[n:] = True
            for _ in range(int(max(limits))):
                abort = np.zeros((bb,), bool)
                for i in range(n):
                    if abort_flags is not None and abort_flags[i] is not None:
                        abort[i] = abort_flags[i].is_set()
                state, token, logp, done = self.step(
                    state, sampling, pb, torch.from_numpy(abort).to(eng.device),
                    limit_t, gen)
                token_h, logp_h, done_h = (token.cpu().numpy(),
                                           logp.cpu().numpy(),
                                           done.cpu().numpy())
                for i in range(n):
                    if prev_done[i]:
                        continue
                    if abort[i]:
                        yield {"row": i, "token": None, "logprob": None,
                               "done": True, "finish_reason": "abort"}
                        continue
                    t = int(token_h[i])
                    fin = bool(done_h[i])
                    reason = ("stop" if t in stop_set else "length") if fin else ""
                    yield {"row": i, "token": t, "logprob": float(logp_h[i]),
                           "done": fin, "finish_reason": reason}
                prev_done = done_h | abort
                if prev_done.all():
                    break
