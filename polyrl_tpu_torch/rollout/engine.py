"""Rollout engine v0 (the step backend): bucketed batch decode over a dense
KV cache.

Counterpart of ``polyrl_tpu/rollout/engine.py``:

- prompts are left-padded to a prompt-length bucket and the batch to a
  batch bucket (``pack_left_padded``); the cache is ``[L, bb, pb +
  max_new, Hkv, D]`` from ``decoder.make_cache``;
- ``generate`` prefills the batch with ``decoder.forward``'s cache path and
  decodes one token per forward over the whole cache, through
  ``stepper.StepDecoder`` (dense attention: the JAX version is XLA, not
  Pallas, so no hand-written kernel is owed), with an early exit once
  every row has hit a stop token. The exit is read on
  the host every ``EXIT_CHECK_EVERY`` tokens, not after each one, so that
  the host does not wait on the device per token;
- ``update_weights`` copies a tree of the engine's names, shapes and dtypes
  into the engine's own tensors (the engine keeps a copy: a colocated
  actor updates its tensors in place); ``release_memory`` and
  ``resume_memory`` only flag the state, as in the reference (the cache
  lives for one call).

Eager PyTorch compiles nothing, so there is no executable cache to key; a
batch's shapes are ``(bb, pb, max_new)`` as in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from polyrl_tpu_torch.device import resolve_device
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.quant import named_leaves
from polyrl_tpu_torch.rollout.common import (  # noqa: F401 (re-exported)
    check_same_structure,
    next_bucket,
    pack_left_padded,
    params_copy,
)
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.stepper import StepDecoder

EXIT_CHECK_EVERY = 8  # tokens between the host's reads of "every row done"


@dataclasses.dataclass
class GenerationOutput:
    """One request's result: the fields the trainer reads from a rollout."""

    output_ids: np.ndarray             # [n_new] int32, truncated at stop
    output_token_logprobs: np.ndarray  # [n_new] f32
    finish_reason: str                 # "stop" | "length" | "abort"
    prompt_tokens: int
    completion_tokens: int
    # the weight version that sampled each token
    output_token_weight_versions: list | None = None


class RolloutEngine:
    """In-process bucketed rollout engine on one device."""

    def __init__(
        self,
        cfg: decoder.ModelConfig,
        params: dict,
        pad_token_id: int = 0,
        batch_buckets: tuple[int, ...] = (8, 16, 32, 64, 128, 256),
        prompt_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096),
        kv_cache_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_copy(params, self.device)
        self.pad_token_id = pad_token_id
        self.batch_buckets = tuple(batch_buckets)
        self.prompt_buckets = tuple(prompt_buckets)
        self.kv_cache_dtype = kv_cache_dtype or cfg.dtype
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # serializes a batch's decode against an in-place weight update
        self.lock = threading.Lock()
        self.weight_version = 0
        self._released = False
        self.num_running = 0
        self.num_queued = 0
        self.last_gen_throughput = 0.0

    # -- weights and memory ------------------------------------------------

    def update_weights(self, params: dict, version: int | None = None) -> None:
        """Copy ``params`` into the engine's tensors (between batches) and
        bump ``weight_version``."""
        check_same_structure(params, self.params)
        new = dict(named_leaves(params))
        with self.lock, torch.no_grad():
            for k, dst in named_leaves(self.params):
                dst.copy_(new[k])
            self.weight_version = (self.weight_version + 1 if version is None
                                   else int(version))

    def release_memory(self) -> None:
        """The cache lives for one call: nothing to free, the state is only
        flagged (the reference's v0 engine does the same)."""
        self._released = True

    def resume_memory(self) -> None:
        self._released = False

    # -- generate ------------------------------------------------------------

    def generator(self, rng) -> torch.Generator:
        """``rng`` when it is a ``torch.Generator`` (on the engine's device),
        else the engine's own sampling generator."""
        return rng if isinstance(rng, torch.Generator) else self._gen

    @torch.no_grad()
    def _decode(self, ids: np.ndarray, mask: np.ndarray, sp: SamplingParams,
                gen: torch.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Prefill the left-padded batch and decode up to
        ``sp.max_new_tokens`` tokens through ``StepDecoder``'s prefill and
        step (one code path with the streaming server); returns host [bb,
        max_new] tokens and logprobs (pad / 0 after a row's stop)."""
        bb, pb = ids.shape
        max_new = sp.max_new_tokens
        dec = StepDecoder(self)
        state = dec.prefill(ids, mask, max_new)
        no_abort = torch.zeros((bb,), dtype=torch.bool, device=self.device)
        limit = torch.full((bb,), max_new, dtype=torch.int32, device=self.device)
        out_tokens = torch.full((bb, max_new), self.pad_token_id,
                                dtype=torch.int32, device=self.device)
        out_logps = torch.zeros((bb, max_new), dtype=torch.float32,
                                device=self.device)
        for step in range(max_new):
            state, out_tokens[:, step], out_logps[:, step], done = dec.step(
                state, sp, pb, no_abort, limit, gen)
            if (step + 1) % EXIT_CHECK_EVERY == 0 and bool(done.all()):
                break
        return out_tokens.cpu().numpy(), out_logps.cpu().numpy()

    def generate(self, prompt_ids, sampling: SamplingParams,
                 rng=None) -> list[GenerationOutput]:
        """Batch-generate; one GenerationOutput per prompt. ``rng``: a
        ``torch.Generator`` for the draws, else the engine's own."""
        t0 = time.monotonic()
        n = len(prompt_ids)
        self.num_running = n
        bb = next_bucket(n, self.batch_buckets)
        pb = next_bucket(max(len(p) for p in prompt_ids), self.prompt_buckets)
        ids, mask = pack_left_padded(prompt_ids, self.pad_token_id, bb, pb)
        with self.lock:
            version = self.weight_version
            out_tokens, out_logps = self._decode(ids, mask, sampling,
                                                 self.generator(rng))
        stop_set = set(sampling.stop_token_ids)
        results, total_new = [], 0
        for i in range(n):
            toks, lps = out_tokens[i], out_logps[i]
            n_new, finish = sampling.max_new_tokens, "length"
            for j, t in enumerate(toks):
                if int(t) in stop_set:
                    n_new, finish = j + 1, "stop"  # the stop token is kept
                    break
            total_new += n_new
            results.append(GenerationOutput(
                output_ids=toks[:n_new].copy(),
                output_token_logprobs=lps[:n_new].copy(),
                finish_reason=finish, prompt_tokens=len(prompt_ids[i]),
                completion_tokens=n_new,
                output_token_weight_versions=[version] * n_new))
        dt = time.monotonic() - t0
        self.last_gen_throughput = total_new / dt if dt > 0 else 0.0
        self.num_running = 0
        return results
