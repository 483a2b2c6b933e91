"""Reward managers: turn generated token batches into token-level scores.

Counterpart of ``polyrl_tpu/rewards/manager.py``: the naive, batch, DAPO
and prime managers and ``load_reward_manager``. A manager decodes the
responses, calls the per-dataset scorer, and places the scalar outcome
reward on the LAST response token (outcome supervision). The remote
sandbox client (``rewards/sandbox.py``) is not ported yet; code scoring
runs in the local rlimit'd subprocess.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from polyrl_tpu_torch.data.batch import TensorBatch
from polyrl_tpu_torch.rewards.scorers import default_compute_score


@dataclass
class RewardResult:
    token_level_scores: np.ndarray  # [B, T_resp] f32
    scores: np.ndarray              # [B] sequence-level
    metrics: dict


class NaiveRewardManager:
    """Decode → score → scatter to last response token."""

    def __init__(
        self,
        tokenizer,
        compute_score: Callable = default_compute_score,
        num_workers: int = 4,
    ):
        self.tokenizer = tokenizer
        self.compute_score = compute_score
        self.num_workers = num_workers

    def __call__(self, batch: TensorBatch) -> RewardResult:
        responses = np.asarray(batch["responses"])          # [B, T]
        response_mask = np.asarray(batch["response_mask"])  # [B, T]
        ground_truth = batch["ground_truth"]                # non-tensor [B]
        data_sources = (
            batch["data_source"] if "data_source" in batch
            else np.array(["gsm8k"] * len(responses), dtype=object)
        )

        extras = (batch["extra_info"] if "extra_info" in batch
                  else [None] * len(responses))
        lengths = response_mask.sum(axis=-1).astype(np.int64)
        texts = self.tokenizer.batch_decode(
            [responses[i, : lengths[i]] for i in range(len(responses))],
            skip_special_tokens=True,
        )

        def score_one(i: int) -> float:
            return float(
                self.compute_score(str(data_sources[i]), texts[i],
                                   str(ground_truth[i]), extras[i])
            )

        if self.num_workers > 1 and len(texts) > 1:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
                scores = np.fromiter(ex.map(score_one, range(len(texts))), dtype=np.float32)
        else:
            scores = np.array([score_one(i) for i in range(len(texts))], dtype=np.float32)

        token_scores = np.zeros_like(response_mask, dtype=np.float32)
        for i, ln in enumerate(lengths):
            if ln > 0:
                token_scores[i, ln - 1] = scores[i]
        return RewardResult(
            token_level_scores=token_scores,
            scores=scores,
            metrics={"reward/mean": float(scores.mean()) if len(scores) else 0.0,
                     "reward/max": float(scores.max()) if len(scores) else 0.0,
                     "reward/min": float(scores.min()) if len(scores) else 0.0},
        )


class BatchRewardManager(NaiveRewardManager):
    """Scores the whole batch with ONE call — ``compute_score`` receives
    parallel lists and returns a list of floats (the reference's batch
    reward manager shape, for vectorized or service-backed scorers)."""

    def _score_batch(self, data_sources, texts, ground_truth, extras) -> np.ndarray:
        out = self.compute_score(
            [str(d) for d in data_sources], list(texts),
            [str(g) for g in ground_truth], list(extras))
        return np.asarray(out, dtype=np.float32)

    def __call__(self, batch: TensorBatch) -> RewardResult:
        responses = np.asarray(batch["responses"])
        response_mask = np.asarray(batch["response_mask"])
        ground_truth = batch["ground_truth"]
        data_sources = (batch["data_source"] if "data_source" in batch
                        else np.array([""] * len(responses), dtype=object))
        extras = (batch["extra_info"] if "extra_info" in batch
                  else [None] * len(responses))
        lengths = response_mask.sum(axis=-1).astype(np.int64)
        texts = self.tokenizer.batch_decode(
            [responses[i, : lengths[i]] for i in range(len(responses))],
            skip_special_tokens=True)
        scores = self._score_batch(data_sources, texts, ground_truth, extras)
        token_scores = np.zeros_like(response_mask, dtype=np.float32)
        for i, ln in enumerate(lengths):
            if ln > 0:
                token_scores[i, ln - 1] = scores[i]
        return RewardResult(
            token_level_scores=token_scores, scores=scores,
            metrics={"reward/mean": float(scores.mean()) if len(scores) else 0.0,
                     "reward/max": float(scores.max()) if len(scores) else 0.0,
                     "reward/min": float(scores.min()) if len(scores) else 0.0})


class DAPORewardManager(NaiveRewardManager):
    """Naive scoring + DAPO overlong soft penalty: responses inside the
    last ``overlong_buffer_len`` tokens before ``max_response_length`` get a
    linearly increasing penalty up to ``-penalty_factor`` (the reference's
    dapo manager; pairs with the ±1 math_dapo scorer)."""

    def __init__(self, tokenizer, compute_score=None, num_workers: int = 4,
                 max_response_length: int = 0, overlong_buffer_len: int = 0,
                 penalty_factor: float = 1.0):
        super().__init__(tokenizer, compute_score or default_compute_score,
                         num_workers)
        self.max_response_length = max_response_length
        self.overlong_buffer_len = overlong_buffer_len
        self.penalty_factor = penalty_factor

    def __call__(self, batch: TensorBatch) -> RewardResult:
        out = super().__call__(batch)
        if not (self.max_response_length and self.overlong_buffer_len):
            return out
        response_mask = np.asarray(batch["response_mask"])
        lengths = response_mask.sum(axis=-1).astype(np.int64)
        expected = self.max_response_length - self.overlong_buffer_len
        over = np.clip(lengths - expected, 0, self.overlong_buffer_len)
        penalty = -(over / self.overlong_buffer_len) * self.penalty_factor
        for i, ln in enumerate(lengths):
            if ln > 0 and penalty[i] < 0.0:
                out.token_level_scores[i, ln - 1] += penalty[i]
                out.scores[i] += penalty[i]
        out.metrics["reward/overlong_penalty_mean"] = float(penalty.mean())
        return out


class PrimeRewardManager(NaiveRewardManager):
    """Parallel scoring with per-sample timeout and zero-on-error — for
    slow/flaky scorers (code execution services; the reference's prime
    manager wraps sandbox-fusion with a semaphore, reward.py:95-150)."""

    def __init__(self, tokenizer, compute_score=None, num_workers: int = 8,
                 timeout_s: float = 30.0):
        super().__init__(tokenizer, compute_score or default_compute_score,
                         num_workers)
        self.timeout_s = timeout_s

    def __call__(self, batch: TensorBatch) -> RewardResult:
        responses = np.asarray(batch["responses"])
        response_mask = np.asarray(batch["response_mask"])
        ground_truth = batch["ground_truth"]
        data_sources = (batch["data_source"] if "data_source" in batch
                        else np.array([""] * len(responses), dtype=object))
        extras = (batch["extra_info"] if "extra_info" in batch
                  else [None] * len(responses))
        lengths = response_mask.sum(axis=-1).astype(np.int64)
        texts = self.tokenizer.batch_decode(
            [responses[i, : lengths[i]] for i in range(len(responses))],
            skip_special_tokens=True)

        def score_one(i: int) -> float:
            return float(self.compute_score(
                str(data_sources[i]), texts[i], str(ground_truth[i]), extras[i]))

        scores = np.zeros(len(texts), dtype=np.float32)
        n_err = 0
        # daemon worker threads, NOT ThreadPoolExecutor: executor workers
        # are non-daemon and joined by an atexit hook, so a permanently
        # wedged scorer would block interpreter shutdown; daemon threads are
        # truly abandonable. Overall deadline = timeout_s per wave.
        n = len(texts)
        work: "queue.Queue[int]" = queue.Queue()
        for i in range(n):
            work.put(i)
        done: "queue.Queue[tuple[int, float | None]]" = queue.Queue()

        def _worker() -> None:
            while True:
                try:
                    i = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    done.put((i, score_one(i)))
                except Exception:  # noqa: BLE001 — scorer crash
                    done.put((i, None))

        for _ in range(min(self.num_workers, max(n, 1))):
            threading.Thread(target=_worker, daemon=True).start()
        n_waves = max(1, -(-n // self.num_workers))
        deadline = time.monotonic() + self.timeout_s * n_waves
        collected = 0
        got = np.zeros(n, dtype=bool)
        while collected < n:
            try:
                i, s = done.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break  # deadline: drain what already finished, then give up
            got[i] = True
            collected += 1
            if s is None:
                n_err += 1
            else:
                scores[i] = s
        # drain results that landed right at the deadline (no busy wait)
        while True:
            try:
                i, s = done.get_nowait()
            except queue.Empty:
                break
            got[i] = True
            if s is not None:
                scores[i] = s
            else:
                n_err += 1
        n_err += int((~got).sum())  # abandoned (hung/unstarted) samples
        token_scores = np.zeros_like(response_mask, dtype=np.float32)
        for i, ln in enumerate(lengths):
            if ln > 0:
                token_scores[i, ln - 1] = scores[i]
        return RewardResult(
            token_level_scores=token_scores, scores=scores,
            metrics={"reward/mean": float(scores.mean()) if len(scores) else 0.0,
                     "reward/max": float(scores.max()) if len(scores) else 0.0,
                     "reward/min": float(scores.min()) if len(scores) else 0.0,
                     "reward/score_errors": float(n_err)})


def compute_reward_async(manager, batch: TensorBatch):
    """Run the manager off-thread; returns a Future (the reference's Ray
    compute_reward_async, reward.py:153-190 — reward overlaps the next
    ibatch's device work)."""
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(manager, batch)
    ex.shutdown(wait=False)
    return fut


REWARD_MANAGERS = {
    "naive": NaiveRewardManager,
    "batch": BatchRewardManager,
    "dapo": DAPORewardManager,
    "prime": PrimeRewardManager,
}


def load_reward_manager(name: str, tokenizer, compute_score=None, **kw):
    """Resolve a reward manager by name (reference reward.py:95-150)."""
    cls = REWARD_MANAGERS[name]
    return cls(tokenizer, compute_score=compute_score or default_compute_score, **kw)
