"""StreamRLTrainer: the streaming PPO/GRPO fit loop, colocated and serial.

Counterpart of ``polyrl_tpu/trainer/stream_trainer.py`` for the default
main path (``rollout.mode=colocated``, ``backend=cb``, ``pipeline_depth=0``):
per training batch an in-process engine generates every rollout, the batch
is cut into ibatches of ``min_stream_batch_size``, each ibatch flows
reward -> old logprob -> ref logprob -> (KL in reward) -> advantage (->
TIS), then the actor's micro forward/backward with gradient accumulation,
with the optimizer stepping where the cumulative trajectory count crosses
a minibatch boundary; after each step the weights go to the engine.

``TrainerConfig`` is the JAX one, validation included. Not ported yet,
each refused with a clear error: remote (disaggregated) rollout, the
pipelined loop, checkpoint/resume, validation, the critic and GAE, packed
rows, LoRA delta sync, profiling, the observability planes (tracing,
goodput, health ledger, flight recorder, statusz) and multi-host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from polyrl_tpu_torch.data.batch import TensorBatch
from polyrl_tpu_torch.ops import core_algos
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.utils.flops import FlopsCounter
from polyrl_tpu_torch.utils.metrics import MetricsTracker, marked_timer


class _ResultView:
    """An engine output dict as the fields the batch assembly reads; an
    empty ``weight_versions`` means unknown (tokens marked -1)."""

    __slots__ = ("output_ids", "output_token_logprobs",
                 "output_token_weight_versions")

    def __init__(self, res: dict):
        self.output_ids = np.asarray(res["token_ids"], np.int32)
        self.output_token_logprobs = np.asarray(res["logprobs"], np.float32)
        self.output_token_weight_versions = np.asarray(
            res.get("weight_versions") or [], np.int32)


@dataclasses.dataclass
class TrainerConfig:
    # batch accounting
    train_batch_size: int = 32            # prompts per step
    rollout_n: int = 4                    # samples per prompt
    ppo_mini_batch_size: int = 64         # trajectories per optimizer step
    micro_batch_size: int = 8             # trajectories per fwd/bwd
    min_stream_batch_size: int = 16       # ibatch granularity
    # lengths
    max_prompt_length: int = 128
    max_response_length: int = 128
    # packed-sequence (remove-padding) training: not ported yet
    use_remove_padding: bool = False
    pack_len: int = 0
    micro_token_budget: int = 0
    # algorithm
    adv_estimator: str = "grpo"           # grpo | gae | rloo | reinforce_plus_plus | remax
    gamma: float = 1.0
    lam: float = 1.0
    use_kl_in_reward: bool = False
    kl_coef: float = 0.001
    kl_penalty: str = "kl"
    norm_adv_by_std_in_grpo: bool = True
    weight_sync: str = "full"             # full | lora_delta (not ported)
    # pipelined rollout and bounded staleness: not ported yet (0 / 1 only)
    pipeline_depth: int = 0
    staleness_limit: int = 1
    # truncated importance-sampling correction of stale rollouts
    rollout_is_correction: bool = False
    rollout_is_cap: float = 2.0
    # run
    total_steps: int = 10
    seed: int = 0
    profile_steps: tuple = ()             # not ported yet
    profile_dir: str = "/tmp/polyrl_profile"
    # validation: not ported yet
    test_freq: int = 0
    val_before_train: bool = False
    val_temperature: float = 0.0
    val_max_response_length: int = 0
    rollout_data_dir: str = ""
    val_generations_to_log: int = 0
    # checkpoint/resume: not ported yet
    ckpt_dir: str | None = None
    save_freq: int = 0
    max_ckpt_keep: int = 3
    resume: str = "auto"
    esi_margin_s: float = 300.0
    # sampling
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.weight_sync not in ("full", "lora_delta"):
            raise ValueError(
                f"weight_sync must be 'full' or 'lora_delta', got "
                f"{self.weight_sync!r}")
        total = self.train_batch_size * self.rollout_n
        if total % self.ppo_mini_batch_size != 0:
            raise ValueError(
                f"total trajectories {total} not divisible by "
                f"ppo_mini_batch_size {self.ppo_mini_batch_size}")
        if self.ppo_mini_batch_size % self.micro_batch_size != 0:
            raise ValueError("mini batch not divisible by micro batch")
        if self.min_stream_batch_size % self.micro_batch_size != 0:
            raise ValueError("stream batch not divisible by micro batch")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {self.pipeline_depth}")
        if self.staleness_limit < 1:
            raise ValueError(
                f"staleness_limit must be >= 1, got {self.staleness_limit}")
        if self.staleness_limit > 1 and self.pipeline_depth == 0:
            raise ValueError(
                f"staleness_limit={self.staleness_limit} requires the "
                f"pipelined trainer (pipeline_depth >= 1): the serial loop "
                f"has no async push to bound")
        if self.staleness_limit > 1 and not self.rollout_is_correction:
            raise ValueError(
                f"staleness_limit={self.staleness_limit} without "
                f"rollout_is_correction: bounded-staleness rollouts train "
                f"up to {self.staleness_limit} weight versions off-policy "
                f"and MUST be importance-corrected — set "
                f"trainer.rollout_is_correction=true (and rollout_is_cap)")
        if self.rollout_is_cap <= 0:
            raise ValueError(
                f"rollout_is_cap must be > 0, got {self.rollout_is_cap}")
        if self.adv_estimator in ("grpo", "rloo") and (
                self.min_stream_batch_size % self.rollout_n != 0):
            raise ValueError(
                "min_stream_batch_size must be a multiple of rollout_n so prompt"
                " groups are never split across ibatches (group-relative"
                " advantages would silently use partial groups)")


def _unported(cfg: TrainerConfig, rollout, critic) -> str | None:
    """The first configured feature this port does not run yet, or None."""
    if critic is not None:
        return "the critic (PPO with GAE)"
    if not hasattr(rollout, "generate") or hasattr(rollout, "generate_stream"):
        return "remote (disaggregated) rollout"
    for bad, what in (
            (cfg.pipeline_depth > 0, "the pipelined trainer (pipeline_depth > 0)"),
            (cfg.use_remove_padding, "packed rows (use_remove_padding)"),
            (cfg.weight_sync != "full", "LoRA delta weight sync"),
            (bool(cfg.ckpt_dir), "checkpoint/resume (ckpt_dir)"),
            (cfg.test_freq > 0 or cfg.val_before_train, "validation"),
            (bool(cfg.profile_steps), "step profiling (profile_steps)")):
        if bad:
            return what
    return None


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class StreamRLTrainer:
    def __init__(self, cfg: TrainerConfig, actor, rollout, tokenizer,
                 reward_manager, dataloader, critic=None, ref_policy=None,
                 logger=None):
        if cfg.adv_estimator == "gae" and critic is None:
            raise ValueError("GAE requires a critic")
        missing = _unported(cfg, rollout, critic)
        if missing is not None:
            raise NotImplementedError(
                f"{missing} is not ported to polyrl_tpu_torch yet (ROADMAP A')")
        self.cfg = cfg
        self.actor = actor
        self.rollout = rollout
        self.tokenizer = tokenizer
        self.reward_manager = reward_manager
        self.dataloader = dataloader
        self.critic = None
        self.ref_policy = ref_policy
        self.logger = logger
        self.global_step = 0
        self._push_count = 0
        self._flops = FlopsCounter(actor.model_cfg, n_chips=1)

    # -- rollout -> TensorBatch -------------------------------------------

    def _prepare_prompts(self, records: list[dict]):
        """Unroll ``rollout_n`` samples per prompt."""
        cfg = self.cfg
        prompts, gts, sources = [], [], []
        for rec in records:
            ids = self.tokenizer.encode(rec["prompt"])[: cfg.max_prompt_length]
            for _ in range(cfg.rollout_n):
                prompts.append(ids)
                gts.append(rec.get("ground_truth", ""))
                sources.append(rec.get("data_source", ""))
        return prompts, gts, sources

    def _sampling(self) -> SamplingParams:
        cfg = self.cfg
        return SamplingParams(
            temperature=cfg.temperature, top_p=cfg.top_p, top_k=cfg.top_k,
            max_new_tokens=cfg.max_response_length,
            stop_token_ids=(self.tokenizer.eos_token_id,))

    def _assemble_batch(self, prompts, gts, sources, outs, group_ids) -> TensorBatch:
        """Fixed-shape arrays: prompts left-padded to ``max_prompt_length``,
        responses right-padded to ``max_response_length``."""
        cfg = self.cfg
        n = len(prompts)
        tp, tr = cfg.max_prompt_length, cfg.max_response_length
        pad = self.rollout.pad_token_id
        input_ids = np.full((n, tp + tr), pad, np.int32)
        attention_mask = np.zeros((n, tp + tr), np.float32)
        responses = np.full((n, tr), pad, np.int32)
        response_mask = np.zeros((n, tr), np.float32)
        rollout_log_probs = np.zeros((n, tr), np.float32)
        weight_versions = np.full((n, tr), -1, np.int32)
        for i, (p, o) in enumerate(zip(prompts, outs)):
            lp = len(p)
            input_ids[i, tp - lp: tp] = p
            attention_mask[i, tp - lp: tp] = 1.0
            r = np.asarray(o.output_ids[:tr])
            input_ids[i, tp: tp + len(r)] = r
            attention_mask[i, tp: tp + len(r)] = 1.0
            responses[i, : len(r)] = r
            response_mask[i, : len(r)] = 1.0
            rollout_log_probs[i, : len(r)] = np.asarray(
                o.output_token_logprobs[: len(r)])
            wv = np.asarray(getattr(o, "output_token_weight_versions", []))
            if len(wv) >= len(r) > 0:
                weight_versions[i, : len(r)] = wv[: len(r)]
        positions = np.maximum(attention_mask.cumsum(axis=-1) - 1, 0).astype(np.int32)
        return TensorBatch.from_dict(
            tensors={"input_ids": input_ids, "attention_mask": attention_mask,
                     "positions": positions, "responses": responses,
                     "response_mask": response_mask,
                     "rollout_log_probs": rollout_log_probs,
                     "rollout_weight_versions": weight_versions,
                     "group_ids": np.asarray(group_ids, np.int32)},
            non_tensors={"ground_truth": list(gts), "data_source": list(sources)},
            meta_info={"global_step": self.global_step})

    def _ibatch_iter(self, records: list[dict], rng, metrics: MetricsTracker):
        """Generate the whole batch with the colocated engine, then slice
        it into ibatches of ``min_stream_batch_size``."""
        cfg = self.cfg
        prompts, gts, sources = self._prepare_prompts(records)
        with marked_timer("gen", metrics):
            outs = [_ResultView(o) for o in
                    self.rollout.generate(prompts, self._sampling(), rng=rng)]
        group_ids = np.repeat(np.arange(len(records), dtype=np.int32),
                              cfg.rollout_n)
        batch = self._assemble_batch(prompts, gts, sources, outs, group_ids)
        yield from batch.split(cfg.min_stream_batch_size)

    def _push_weights(self) -> None:
        """Copy the actor's weights into the engine (a version bump)."""
        self.rollout.update_weights(self.actor.export_params())
        self._push_count += 1

    # -- per-ibatch pipeline ---------------------------------------------

    def _process_ibatch(self, ibatch: TensorBatch,
                        metrics: MetricsTracker) -> TensorBatch:
        """reward -> old logprob -> ref logprob -> advantage."""
        cfg = self.cfg
        with marked_timer("reward", metrics):
            reward_out = self.reward_manager(ibatch)
            token_level_scores = reward_out.token_level_scores
            metrics.update(reward_out.metrics)
        feed = {k: ibatch[k] for k in ("input_ids", "positions", "attention_mask",
                                       "responses", "response_mask")}
        with marked_timer("old_log_prob", metrics):
            old_lp, entropy = self.actor.compute_log_prob(feed)
            ibatch.tensors["old_log_probs"] = _host(old_lp)
            metrics.update({"actor/entropy_rollout": float(core_algos.masked_mean(
                _t(_host(entropy)), _t(ibatch["response_mask"])))})
        if self.ref_policy is not None:
            with marked_timer("ref_log_prob", metrics):
                ibatch.tensors["ref_log_probs"] = _host(
                    self.ref_policy.compute_log_prob(feed))

        with marked_timer("adv", metrics):
            mask = _t(ibatch["response_mask"])
            token_rewards = _t(token_level_scores)
            if cfg.use_kl_in_reward and "ref_log_probs" in ibatch:
                token_rewards, kl_mean = core_algos.apply_kl_penalty(
                    token_rewards, _t(ibatch["old_log_probs"]),
                    _t(ibatch["ref_log_probs"]), mask, cfg.kl_coef,
                    cfg.kl_penalty)
                metrics.update({"critic/kl_in_reward": float(kl_mean)})
            ibatch.tensors["token_level_rewards"] = token_rewards.numpy()
            gids = _t(ibatch["group_ids"])
            est = cfg.adv_estimator
            if est == "grpo":
                adv, ret = core_algos.compute_grpo_outcome_advantage(
                    token_rewards, mask, gids,
                    norm_adv_by_std=cfg.norm_adv_by_std_in_grpo,
                    num_groups=int(gids.max()) + 1)
            elif est == "rloo":
                adv, ret = core_algos.compute_rloo_outcome_advantage(
                    token_rewards, mask, gids, num_groups=int(gids.max()) + 1)
            elif est == "reinforce_plus_plus":
                adv, ret = core_algos.compute_reinforce_plus_plus_outcome_advantage(
                    token_rewards, mask, cfg.gamma)
            elif est == "remax":
                baselines = self._compute_remax_baselines(ibatch, metrics)
                adv, ret = core_algos.compute_remax_outcome_advantage(
                    token_rewards, _t(baselines), mask)
            else:
                raise NotImplementedError(est)
            ibatch.tensors["advantages"] = adv.numpy()
            ibatch.tensors["returns"] = ret.numpy()
            if cfg.rollout_is_correction:
                # per-token truncated importance weights of each token's own
                # behavior policy against the recomputed old logprobs
                tis_w, _ratio, tis_stats = \
                    core_algos.mixed_version_importance_weights(
                        ibatch["old_log_probs"], ibatch["rollout_log_probs"],
                        ibatch["response_mask"],
                        ibatch.tensors.get("rollout_weight_versions"),
                        current_version=int(getattr(self.rollout,
                                                    "weight_version", 0)),
                        cap=cfg.rollout_is_cap)
                ibatch.tensors["advantages"] = ibatch.tensors["advantages"] * tis_w
                metrics.update({"actor/tis_weight_mean": tis_stats["mean_weight"],
                                "actor/tis_clip_frac": tis_stats["clip_frac"]})
        return ibatch

    def _compute_remax_baselines(self, ibatch: TensorBatch,
                                 metrics: MetricsTracker) -> np.ndarray:
        """ReMax baseline: ONE greedy rollout per prompt group, scored by
        the same reward manager; its score is the group's baseline."""
        cfg = self.cfg
        group_ids = np.asarray(ibatch["group_ids"])
        tp = cfg.max_prompt_length
        input_ids = np.asarray(ibatch["input_ids"])
        attn = np.asarray(ibatch["attention_mask"])
        gts, sources = ibatch["ground_truth"], ibatch["data_source"]
        uniq, first_idx = np.unique(group_ids, return_index=True)
        prompts = [input_ids[i, :tp][attn[i, :tp] > 0].tolist() for i in first_idx]
        sampling = SamplingParams(
            temperature=0.0, top_p=1.0, top_k=0,
            max_new_tokens=cfg.max_response_length,
            stop_token_ids=(self.tokenizer.eos_token_id,))
        with marked_timer("remax_baseline", metrics):
            outs = [_ResultView(o) for o in self.rollout.generate(prompts, sampling)]
            base_batch = self._assemble_batch(
                prompts, [gts[i] for i in first_idx],
                [sources[i] for i in first_idx], outs, list(range(len(prompts))))
            base_scores = np.asarray(self.reward_manager(base_batch).scores,
                                     np.float32)
        metrics.update({
            "reward/remax_baseline_mean":
                float(np.mean(base_scores)) if len(base_scores) else 0.0,
            "reward/remax_baseline_failed": 0.0})
        group_to_score = {int(g): float(s) for g, s in zip(uniq, base_scores)}
        return np.asarray([group_to_score[int(g)] for g in group_ids], np.float32)

    # -- one training batch (stream -> micros -> opt steps) ---------------

    def _train_one_batch(self, ibatch_source: Callable,
                         metrics: MetricsTracker) -> dict:
        """Stream the step's ibatches through ``_process_ibatch`` and the
        update micros; the optimizer steps where the cumulative trajectory
        count crosses a minibatch boundary, and a short batch ending
        mid-minibatch flushes the accumulated gradients."""
        cfg = self.cfg
        msize = cfg.ppo_mini_batch_size
        state = {"processed": 0, "n_tokens": 0, "bubble": 0.0}

        def micro_stream():
            it = ibatch_source()
            while True:
                wait_t0 = time.monotonic()
                try:
                    ibatch = next(it)
                except StopIteration:
                    return
                state["bubble"] += time.monotonic() - wait_t0
                ibatch = self._process_ibatch(ibatch, metrics)
                state["n_tokens"] += int(np.asarray(ibatch["attention_mask"]).sum())
                for m in ibatch.split(cfg.micro_batch_size):
                    yield m, len(m)

        for micro, n_traj in micro_stream():
            prev = state["processed"]
            state["processed"] += n_traj
            is_opt = state["processed"] // msize > prev // msize
            feed = {k: micro[k] for k in (
                "input_ids", "positions", "attention_mask", "responses",
                "response_mask", "advantages", "old_log_probs")}
            if "ref_log_probs" in micro:
                feed["ref_log_probs"] = micro["ref_log_probs"]
            with marked_timer("update_actor", metrics):
                m = self.actor.update_stream(feed, is_opt,
                                             loss_scale=n_traj / msize)
                metrics.update({k: float(v) for k, v in m.items()})
        if state["processed"] % msize != 0 and state["processed"] > 0:
            metrics.update({k: float(v) for k, v in
                            self.actor.flush_opt_step().items()})
        return state

    # -- fit --------------------------------------------------------------

    def fit(self) -> list[dict]:
        """Run ``total_steps`` steps; returns the per-step metric dicts."""
        cfg = self.cfg
        history = []
        self._push_weights()  # bootstrap the engine with the actor's weights
        while self.global_step < cfg.total_steps:
            metrics = MetricsTracker()
            step_t0 = time.monotonic()
            records = next(self.dataloader)
            state = self._train_one_batch(
                lambda: self._ibatch_iter(records, None, metrics), metrics)
            with marked_timer("update_weight", metrics):
                self._push_weights()
            self.global_step += 1
            step_time = time.monotonic() - step_t0
            throughput = state["n_tokens"] / step_time if step_time else 0.0
            n_traj = max(state["processed"], 1)
            metrics.update({
                "training/global_step": self.global_step,
                "perf/step_time_s": step_time,
                "perf/trainer_bubble_s": state["bubble"],
                "perf/throughput_tokens_per_s": throughput,
                "perf/throughput_tok_s_per_chip": throughput,
                "perf/rollout_throughput_tok_s": self.rollout.last_gen_throughput,
            })
            metrics.update(self._flops.step_metrics(
                state["n_tokens"], state["n_tokens"] / n_traj, step_time))
            record = metrics.as_dict()
            history.append(record)
            if self.logger is not None:
                self.logger.log(record, step=self.global_step)
        return history
