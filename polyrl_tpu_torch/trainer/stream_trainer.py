"""StreamRLTrainer: the streaming PPO/GRPO fit loop.

Counterpart of ``polyrl_tpu/trainer/stream_trainer.py``. Per training
batch either an in-process engine generates every rollout and the batch is
cut into ibatches of ``min_stream_batch_size``, or (a remote rollout,
``RemoteRollout``: the disaggregated path) the manager streams whole
prompt groups back as the rollout servers finish them, at least
``min_stream_batch_size`` trajectories an ibatch, so training on early
ibatches overlaps generation of later ones. Each ibatch flows reward -> old logprob -> ref logprob -> values -> (KL in
reward) -> advantage (-> TIS), then the actor's (and the critic's) micro
forward/backward with gradient accumulation, with the optimizer stepping
where the cumulative trajectory count crosses a minibatch boundary; after
each step the weights go to the engine (in process), or through the weight
fabric to the rollout servers. With a remote rollout each step also feeds
the manager's balancer (its answer, the next local-generation budget, is
``training/max_local_gen_s``) and records the fault, transfer, pool and
manager gauges.

Ported: the serial loop and the pipelined one (``pipeline_depth >= 1``,
``trainer/pipeline.py``: generation up to ``depth`` steps ahead, the
bounded-staleness admission gate, truncated importance correction), PPO
with a critic and GAE (``trainer/critic.py``), packed rows
(``use_remove_padding``, ``data/packing.py``: the logprob, value and update
passes on ``[n_rows, pack_len]`` grids through K4 with segment ids),
checkpoint/resume (``utils/checkpoint.py``), validation, LoRA actors
(the push sends ``actor.export_params()``, the merged plain tree, so the
engine never holds a wrapper), optimizer offload after each step's push,
and step profiling (``profile_steps`` through ``torch.profiler``;
consecutive profiled steps share one trace under ``profile_dir``).

Not ported yet, each refused with a clear error: LoRA delta sync
(ROADMAP A' 7), the observability planes (goodput, health ledger, flight
recorder, statusz; ROADMAP A' 6) and multi-host.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.data.batch import TensorBatch
from polyrl_tpu_torch.ops import core_algos
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.utils import checkpoint as ckpt_lib
from polyrl_tpu_torch.utils.flops import FlopsCounter
from polyrl_tpu_torch.utils.metrics import MetricsTracker, marked_timer

log = logging.getLogger(__name__)

_PACK_KEYS = ("input_ids", "positions", "attention_mask", "segment_ids",
              "loss_mask")


class _ResultView:
    """An engine output dict (the CB engine's) or a remote
    ``GenerateResult`` as the fields the batch assembly reads; an empty
    weight-version list means unknown (tokens marked -1). The step
    backend's ``GenerationOutput`` has them already."""

    __slots__ = ("output_ids", "output_token_logprobs",
                 "output_token_weight_versions")

    def __init__(self, res):
        if isinstance(res, dict):
            ids, lps = res["token_ids"], res["logprobs"]
            wvs = res.get("weight_versions") or []
        else:
            ids, lps = res.output_token_ids, res.output_token_logprobs
            wvs = res.output_token_weight_versions
        self.output_ids = np.asarray(ids, np.int32)
        self.output_token_logprobs = np.asarray(lps, np.float32)
        self.output_token_weight_versions = np.asarray(wvs, np.int32)


_EMPTY = type("_Empty", (), {"output_ids": np.zeros(0, np.int32),
                             "output_token_logprobs": np.zeros(0, np.float32)})


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
    # packed-sequence (remove-padding) training: the logprob, value and
    # update passes run on fixed [n_rows, pack_len] packed grids instead of
    # [B, Tp+Tr] padded rows
    use_remove_padding: bool = False
    pack_len: int = 0                     # 0 -> max_prompt + max_response
    micro_token_budget: int = 0           # 0 -> micro_batch_size rows
    # algorithm
    adv_estimator: str = "grpo"           # grpo | gae | rloo | reinforce_plus_plus | remax
    gamma: float = 1.0
    lam: float = 1.0
    use_kl_in_reward: bool = False
    kl_coef: float = 0.001
    kl_penalty: str = "kl"
    norm_adv_by_std_in_grpo: bool = True
    weight_sync: str = "full"             # full | lora_delta (not ported)
    # pipelined rollout (trainer/pipeline.py): 0 = the serial loop; N >= 1
    # lets a background lane generate up to N steps ahead of training, so
    # rollouts arrive weight-version stale (see rollout_is_correction)
    pipeline_depth: int = 0
    # bounded-staleness admission gate: a prefetched stream may start while
    # up to staleness_limit - 1 weight pushes are in flight; 1 = the hard
    # wait_pushed() fence
    staleness_limit: int = 1
    # truncated importance-sampling correction of stale rollouts
    rollout_is_correction: bool = False
    rollout_is_cap: float = 2.0
    # run
    total_steps: int = 10
    seed: int = 0
    profile_steps: tuple = ()             # 1-based global steps to trace
    profile_dir: str = ""                 # "" -> <tempdir>/polyrl_profile
    # validation
    test_freq: int = 0                    # validate every N steps (0 = off)
    val_before_train: bool = False
    val_temperature: float = 0.0          # greedy by default
    val_max_response_length: int = 0      # 0 -> max_response_length
    rollout_data_dir: str = ""            # dump val generations as jsonl
    val_generations_to_log: int = 0       # echo the first K to the logger
    # checkpoint/resume
    ckpt_dir: str | None = None
    save_freq: int = 0                    # 0 = only the last step (+ESI)
    max_ckpt_keep: int = 3
    resume: str = "auto"                  # auto | disable
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


def _unported(cfg: TrainerConfig, rollout) -> str | None:
    """Why the trainer refuses this configuration, or None."""
    if cfg.weight_sync == "lora_delta":
        return ("weight_sync=lora_delta (adapter-only pushes to "
                "disaggregated rollout servers serving --lora-rank) is not "
                "ported to polyrl_tpu_torch yet (ROADMAP A' 7)")
    return None


def _remote(rollout) -> bool:
    """A remote rollout (``RemoteRollout``) streams; an engine generates."""
    return hasattr(rollout, "generate_stream")


def _views(outs) -> list:
    return [o if hasattr(o, "output_ids") else _ResultView(o) for o in outs]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _clone_tree(tree: dict) -> dict:
    return {k: (_clone_tree(v) if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}


def _pack_feed(pack) -> dict:
    return {k: pack[k] for k in _PACK_KEYS}


class StreamRLTrainer:
    def __init__(self, cfg: TrainerConfig, actor, rollout, tokenizer,
                 reward_manager, dataloader, critic=None, ref_policy=None,
                 logger=None, val_dataset=None):
        if cfg.adv_estimator == "gae" and critic is None:
            raise ValueError("GAE requires a critic")
        missing = _unported(cfg, rollout)
        if missing is not None:
            raise NotImplementedError(missing)
        if cfg.pipeline_depth > 0 and not cfg.rollout_is_correction:
            log.warning(
                "pipeline_depth=%d without rollout_is_correction: rollouts "
                "arrive up to one weight version stale and advantages are "
                "NOT importance-corrected", cfg.pipeline_depth)
        self.cfg = cfg
        self.actor = actor
        self.rollout = rollout
        self.tokenizer = tokenizer
        self.reward_manager = reward_manager
        self.dataloader = dataloader
        self.critic = critic
        self.ref_policy = ref_policy
        self.logger = logger
        self.val_dataset = val_dataset
        self.global_step = 0
        # weight pushes initiated so far; a prefetched stream records the
        # count at its generation start, so the gap at consume time is the
        # perf/weight_staleness gauge
        self._push_count = 0
        # the dataloader's position after the records of the step being
        # trained: what a checkpoint of that step saves (the pipeline's
        # producer may already have drawn the next step's records)
        self._loader_state: dict | None = None
        self._ckpt = (ckpt_lib.CheckpointManager(cfg.ckpt_dir,
                                                 max_to_keep=cfg.max_ckpt_keep)
                      if cfg.ckpt_dir else None)
        self._esi_expiry = ckpt_lib.esi_expiry_from_env()
        self._flops = FlopsCounter(actor.model_cfg, n_chips=1)
        # the balancer's local-generation budget (None until its first
        # answer: the manager's default applies)
        self._max_local_gen_s: float | None = None
        # the last step record: the balancer's fleet occupancy and device
        # fraction come from the pool's aggregation one step back
        self._last_record: dict = {}
        self._profiler = None  # the open torch.profiler trace, if any
        self._profiled: list[int] = []
        self.profile_traces: list[str] = []  # traces written so far

    # -- profiling (reference _profile_gate) -------------------------------

    def _profile_gate(self, about_to_run: int) -> None:
        """Start or stop a ``torch.profiler`` trace so that consecutive
        profiled steps share one trace; it is written on stop as
        ``<profile_dir>/trace_steps_<first>-<last>.json`` (Chrome format).
        ``about_to_run=-1`` closes an open trace."""
        cfg = self.cfg
        want = about_to_run in cfg.profile_steps
        if want and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.actor.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
            self._profiled = []
        elif not want and self._profiler is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profiler.stop()
            out_dir = cfg.profile_dir or os.path.join(tempfile.gettempdir(),
                                                      "polyrl_profile")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"trace_steps_{self._profiled[0]}-"
                                         f"{self._profiled[-1]}.json")
            self._profiler.export_chrome_trace(path)
            self.profile_traces.append(path)
            self._profiler = None
        if want:
            self._profiled.append(about_to_run)

    # -- checkpoint/resume -------------------------------------------------

    def _ckpt_state(self) -> dict:
        state = {"actor": self.actor.state_dict()}
        if self.critic is not None:
            state["critic"] = self.critic.state_dict()
        return state

    def _save_checkpoint(self) -> None:
        meta = {"global_step": self.global_step}
        if self._loader_state is not None:
            meta["dataloader"] = self._loader_state
        self._ckpt.save(self.global_step, self._ckpt_state(), meta)

    def _load_checkpoint(self) -> bool:
        """Restore the latest checkpoint if there is one; True on resume.
        Items restore independently, so an actor-only checkpoint resumes
        the actor of a trainer that has a critic (and vice versa)."""
        if self._ckpt is None or self.cfg.resume == "disable":
            return False
        out = self._ckpt.restore(targets=self._ckpt_state().keys())
        if out is None:
            return False
        items, meta = out
        if "actor" in items:
            self.actor.load_state_dict(items["actor"])
        if self.critic is not None and "critic" in items:
            self.critic.load_state_dict(items["critic"])
        self.global_step = int(meta.get("global_step", 0))
        if "dataloader" in meta and hasattr(self.dataloader, "load_state_dict"):
            self.dataloader.load_state_dict(meta["dataloader"])
            self._loader_state = meta["dataloader"]
        return True

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

    def _ibatch_iter_local(self, records: list[dict], rng,
                           metrics: MetricsTracker):
        """A remote rollout: yield each group-complete chunk of the stream
        as an ibatch as it arrives (group ids made dense per ibatch).
        Colocated: generate the whole batch, then slice it into ibatches of
        ``min_stream_batch_size``. ``rng`` is accepted for the JAX
        signature: the engine owns its sampling generator."""
        cfg = self.cfg
        prompts, gts, sources = self._prepare_prompts(records)
        if _remote(self.rollout):
            stream = self.rollout.generate_stream(
                prompts, self._sampling(), group_size=cfg.rollout_n,
                min_emit=cfg.min_stream_batch_size,
                max_local_gen_s=self._max_local_gen_s)
            for chunk in stream:
                idxs = [i for i, _ in chunk]
                outs = [_ResultView(r) for _, r in chunk]
                _, dense = np.unique([i // cfg.rollout_n for i in idxs],
                                     return_inverse=True)
                yield self._assemble_batch(
                    [prompts[i] for i in idxs], [gts[i] for i in idxs],
                    [sources[i] for i in idxs], outs, dense)
            return
        with marked_timer("gen", metrics):
            outs = _views(self.rollout.generate(prompts, self._sampling(),
                                                rng=rng))
        group_ids = np.repeat(np.arange(len(records), dtype=np.int32),
                              cfg.rollout_n)
        batch = self._assemble_batch(prompts, gts, sources, outs, group_ids)
        yield from batch.split(cfg.min_stream_batch_size)

    # one device: no multi-host fan-out around the local stream
    _ibatch_iter = _ibatch_iter_local

    def _push_weights(self, block: bool = True) -> None:
        """Push the actor's weights to the rollout (a version bump).

        ``block=False`` (pipelined mode) with a rollout that pushes
        asynchronously (``update_weights_async``): the rollout gets a
        device copy taken now, since the actor's next optimizer step
        updates its tensors in place, and the push completes in the
        background; the pipeline fences on ``_wait_pushed`` before its
        next stream. The colocated engine has no asynchronous push: its
        ``update_weights`` copies the weights into the engine's own
        tensors between dispatches (under its dispatch lock), which is the
        copy the JAX trainer hands it, and is ordered on the one CUDA
        stream after the optimizer step and before the next. A remote
        rollout's blocking push packs the live tensors device to host
        before it returns (``TransferInterface``), so the next optimizer
        step on this thread comes after the pack."""
        params = self.actor.export_params()
        if not block and hasattr(self.rollout, "update_weights_async"):
            self.rollout.update_weights_async(_clone_tree(params))
        else:
            self.rollout.update_weights(params)
        self._push_count += 1

    def _wait_pushed(self) -> None:
        """Fence on the last asynchronous push: returns when it has landed
        (a no-op for synchronous rollouts)."""
        fn = getattr(self.rollout, "wait_pushed", None)
        if fn is not None:
            fn()

    def _wait_push_headroom(self, max_lag: int) -> None:
        """Bounded-staleness admission gate (``staleness_limit > 1``):
        block until at most ``max_lag`` asynchronous pushes are in flight.
        Rollouts without a lag surface take the full fence."""
        fn = getattr(self.rollout, "wait_push_lag", None)
        if fn is not None:
            fn(max_lag)
        else:
            self._wait_pushed()

    def _push_lag(self) -> int:
        """Asynchronous pushes in flight (``perf/staleness_lag``)."""
        fn = getattr(self.rollout, "push_lag", None)
        return int(fn()) if fn is not None else 0

    # -- per-ibatch pipeline ---------------------------------------------

    def _process_ibatch(self, ibatch: TensorBatch,
                        metrics: MetricsTracker) -> TensorBatch:
        """reward -> old logprob -> ref logprob -> values -> advantage."""
        cfg = self.cfg
        with marked_timer("reward", metrics):
            reward_out = self.reward_manager(ibatch)
            token_level_scores = reward_out.token_level_scores
            metrics.update(reward_out.metrics)
        feed = {k: ibatch[k] for k in ("input_ids", "positions", "attention_mask",
                                       "responses", "response_mask")}
        if cfg.use_remove_padding:
            self._packed_logprob_pass(ibatch, metrics)
        else:
            with marked_timer("old_log_prob", metrics):
                old_lp, entropy = self.actor.compute_log_prob(feed)
                ibatch.tensors["old_log_probs"] = _host(old_lp)
                metrics.update({"actor/entropy_rollout": float(
                    core_algos.masked_mean(_t(_host(entropy)),
                                           _t(ibatch["response_mask"])))})
            if self.ref_policy is not None:
                with marked_timer("ref_log_prob", metrics):
                    ibatch.tensors["ref_log_probs"] = _host(
                        self.ref_policy.compute_log_prob(feed))
        if self.critic is not None:
            with marked_timer("values", metrics):
                if cfg.use_remove_padding:
                    # the values ride the logprob pass's packs and gather
                    # specs: no padded forward is built when the actor
                    # runs packed
                    vals = np.zeros((len(ibatch), cfg.max_response_length),
                                    np.float32)
                    for pack, spec in ibatch.meta_info["packs"]:
                        spec.gather_into(_host(self.critic.compute_values_packed(
                            _pack_feed(pack))), vals)
                    ibatch.tensors["values"] = vals
                else:
                    ibatch.tensors["values"] = _host(
                        self.critic.compute_values(feed))

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
            elif est == "gae":
                adv, ret = core_algos.compute_gae_advantage_return(
                    token_rewards, _t(ibatch["values"]), mask, cfg.gamma,
                    cfg.lam)
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

    # -- packed-sequence (remove-padding) path -----------------------------

    def _pack_geometry(self) -> tuple[int, int]:
        """(pack_len, rows per packed micro). On one device the JAX
        trainer's shard floors reduce to one row, and a token budget below
        one row raises rather than exceed the budget it guards."""
        cfg = self.cfg
        pack_len = cfg.pack_len or (cfg.max_prompt_length + cfg.max_response_length)
        if cfg.micro_token_budget <= 0:
            return pack_len, cfg.micro_batch_size
        if cfg.micro_token_budget < pack_len:
            raise ValueError(
                f"micro_token_budget={cfg.micro_token_budget} cannot fit one "
                f"packed row of pack_len={pack_len} tokens; raise the budget "
                f"or shrink pack_len")
        return pack_len, cfg.micro_token_budget // pack_len

    def _packed_logprob_pass(self, ibatch: TensorBatch,
                             metrics: MetricsTracker) -> None:
        """Old and ref logprobs and the entropy on the packed layout, then
        gathered back to [B, Tr] for the advantage math. The packs stay on
        the ibatch (``meta_info["packs"]``) for the value pass and the
        update micros."""
        from polyrl_tpu_torch.data import packing

        cfg = self.cfg
        pack_len, n_rows = self._pack_geometry()
        packs = list(packing.iter_packed_micros(
            ibatch, cfg.max_prompt_length, pack_len, n_rows,
            self.rollout.pad_token_id))
        ibatch.meta_info["packs"] = packs
        b, tr = len(ibatch), cfg.max_response_length
        old_lp = np.zeros((b, tr), np.float32)
        ent_num = ent_den = 0.0
        with marked_timer("old_log_prob", metrics):
            for pack, spec in packs:
                lp, ent = self.actor.compute_log_prob_packed(_pack_feed(pack))
                spec.gather_into(_host(lp), old_lp)
                lm = np.asarray(pack["loss_mask"])
                ent_num += float((_host(ent) * lm).sum())
                ent_den += float(lm.sum())
        ibatch.tensors["old_log_probs"] = old_lp
        metrics.update({"actor/entropy_rollout": ent_num / max(ent_den, 1.0)})
        if self.ref_policy is not None:
            ref_lp = np.zeros((b, tr), np.float32)
            with marked_timer("ref_log_prob", metrics):
                for pack, spec in packs:
                    spec.gather_into(_host(self.ref_policy.compute_log_prob_packed(
                        _pack_feed(pack))), ref_lp)
            ibatch.tensors["ref_log_probs"] = ref_lp

    def _packed_micros(self, ibatch: TensorBatch):
        """(packed feed, n_trajectories) update micros, with the advantages,
        old/ref logprobs, returns and values scattered into each pack's
        layout."""
        fields = [k for k in ("advantages", "old_log_probs", "ref_log_probs")
                  if k in ibatch]
        if self.critic is not None:
            fields += ["returns", "values"]
        for pack, spec in ibatch.meta_info["packs"]:
            feed = _pack_feed(pack)
            for k in fields:
                feed[k] = spec.scatter(np.asarray(ibatch[k]))
            yield feed, len(spec.orig_idx)

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
            outs, failed = self._generate_all(prompts, sampling, nested=True)
            base_batch = self._assemble_batch(
                prompts, [gts[i] for i in first_idx],
                [sources[i] for i in first_idx], outs, list(range(len(prompts))))
            base_scores = np.asarray(self.reward_manager(base_batch).scores,
                                     np.float32)
        if failed:
            # a baseline hole would silently become "baseline 0": those
            # groups fall back to their sampled-reward mean (RLOO-style)
            log.warning("REMAX: %d/%d greedy baselines failed; substituting "
                        "group sampled-reward means", len(failed), len(prompts))
            traj_scores = np.asarray(
                ibatch["token_level_rewards"].sum(-1)
                if "token_level_rewards" in ibatch else
                self.reward_manager(ibatch).scores, np.float32)
            for fi in failed:
                base_scores[fi] = float(
                    np.mean(traj_scores[group_ids == uniq[fi]]))
        metrics.update({
            "reward/remax_baseline_mean":
                float(np.mean(base_scores)) if len(base_scores) else 0.0,
            "reward/remax_baseline_failed": float(len(failed))})
        group_to_score = {int(g): float(s) for g, s in zip(uniq, base_scores)}
        return np.asarray([group_to_score[int(g)] for g in group_ids], np.float32)

    # -- validation ---------------------------------------------------------

    def _generate_all(self, prompts: list[list[int]], sampling: SamplingParams,
                      nested: bool = False):
        """Every prompt's output, in order, and the indices that failed (a
        remote request dropped by the manager: its slot holds an empty
        output). ``nested`` marks a remote stream issued while an outer one
        is active (the ReMax baselines)."""
        if not _remote(self.rollout):
            return _views(self.rollout.generate(prompts, sampling)), []
        outs: list = [None] * len(prompts)
        for chunk in self.rollout.generate_stream(
                prompts, sampling, group_size=1, min_emit=len(prompts),
                nested=nested):
            for i, res in chunk:
                outs[i] = _ResultView(res)
        failed = [i for i, o in enumerate(outs) if o is None]
        return [_EMPTY if o is None else o for o in outs], failed

    def _validate(self) -> dict:
        """Greedy (by default) evaluation over the validation set: the mean
        score per data source and overall; optionally the generations
        dumped as jsonl and echoed to the logger."""
        cfg = self.cfg
        records = list(self.val_dataset)
        sampling = SamplingParams(
            temperature=cfg.val_temperature, top_p=1.0, top_k=0,
            max_new_tokens=cfg.val_max_response_length or cfg.max_response_length,
            stop_token_ids=(self.tokenizer.eos_token_id,))
        per_source: dict[str, list[float]] = {}
        dump_rows: list[dict] = []
        n_failed = 0
        bs = max(cfg.train_batch_size, 1)
        for lo in range(0, len(records), bs):
            chunk = records[lo: lo + bs]
            prompts = [self.tokenizer.encode(r["prompt"])[: cfg.max_prompt_length]
                       for r in chunk]
            outs, failed = self._generate_all(prompts, sampling)
            n_failed += len(failed)
            gts = [r.get("ground_truth", "") for r in chunk]
            sources = [r.get("data_source", "") for r in chunk]
            batch = self._assemble_batch(prompts, gts, sources, outs,
                                         list(range(len(chunk))))
            reward_out = self.reward_manager(batch)
            for i, (src, sc) in enumerate(zip(sources, reward_out.scores)):
                # a failed generation is a hole, not a zero score
                # (val/num_failed counts them)
                if i not in failed:
                    per_source.setdefault(src or "default", []).append(
                        float(sc))
            if cfg.rollout_data_dir or cfg.val_generations_to_log:
                texts = self.tokenizer.batch_decode(
                    [np.asarray(o.output_ids) for o in outs],
                    skip_special_tokens=True)
                for r, txt, sc in zip(chunk, texts, reward_out.scores):
                    dump_rows.append({
                        "step": self.global_step, "prompt": r["prompt"],
                        "response": txt, "score": float(sc),
                        "ground_truth": r.get("ground_truth", ""),
                        "data_source": r.get("data_source", "")})
        metrics = {f"val/test_score/{src}": float(np.mean(v))
                   for src, v in per_source.items()}
        all_scores = [x for v in per_source.values() for x in v]
        metrics["val/test_score/mean"] = (float(np.mean(all_scores))
                                          if all_scores else 0.0)
        metrics["val/num_failed"] = float(n_failed)
        if cfg.rollout_data_dir and dump_rows:
            os.makedirs(cfg.rollout_data_dir, exist_ok=True)
            path = os.path.join(cfg.rollout_data_dir,
                                f"val_step{self.global_step}.jsonl")
            with open(path, "w") as f:
                for row in dump_rows:
                    f.write(json.dumps(row) + "\n")
        if cfg.val_generations_to_log and self.logger is not None and dump_rows:
            for row in dump_rows[: cfg.val_generations_to_log]:
                self.logger.log({"val/generation": 0.0, **{
                    k: v for k, v in row.items() if isinstance(v, float)}},
                    step=self.global_step)
        return metrics

    def _maybe_validate(self, metrics: MetricsTracker, *, force: bool = False) -> None:
        cfg = self.cfg
        if self.val_dataset is None:
            return
        due = force or (cfg.test_freq > 0 and self.global_step > 0
                        and self.global_step % cfg.test_freq == 0)
        if due:
            with marked_timer("testing", metrics):
                metrics.update(self._validate())

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
                if cfg.use_remove_padding:
                    yield from self._packed_micros(ibatch)
                else:
                    for m in ibatch.split(cfg.micro_batch_size):
                        yield m, len(m)

        for micro, n_traj in micro_stream():
            # boundary-crossing, not exact multiples: packed micros carry
            # ragged trajectory counts and may step over a multiple
            prev = state["processed"]
            state["processed"] += n_traj
            is_opt = state["processed"] // msize > prev // msize
            scale = n_traj / msize
            if isinstance(micro, dict):  # packed feed, actor- and critic-ready
                feed = cfeed = micro
            else:
                feed = {k: micro[k] for k in (
                    "input_ids", "positions", "attention_mask", "responses",
                    "response_mask", "advantages", "old_log_probs")}
                if "ref_log_probs" in micro:
                    feed["ref_log_probs"] = micro["ref_log_probs"]
                cfeed = ({k: micro[k] for k in (
                    "input_ids", "positions", "attention_mask", "responses",
                    "response_mask", "returns", "values")}
                    if self.critic is not None else None)
            with marked_timer("update_actor", metrics):
                m = self.actor.update_stream(feed, is_opt, loss_scale=scale)
                metrics.update({k: float(v) for k, v in m.items()})
            if self.critic is not None:
                with marked_timer("update_critic", metrics):
                    cm = self.critic.update_stream(cfeed, is_opt,
                                                   loss_scale=scale)
                    metrics.update({k: float(v) for k, v in cm.items()})
        if state["processed"] % msize != 0 and state["processed"] > 0:
            metrics.update({k: float(v) for k, v in
                            self.actor.flush_opt_step().items()})
            if self.critic is not None:
                metrics.update({k: float(v) for k, v in
                                self.critic.flush_opt_step().items()})
        return state

    # -- remote rollout: the balancer and the control-plane gauges ---------

    def _balancer_round(self, stats: dict) -> dict[str, float]:
        """Feed one step's stats to the manager's balancer; its answer is
        the next local-generation budget, which the next stream passes on
        as ``max_local_gen_s``. Returns the resulting gauges."""
        resp = self.rollout.update_metrics(**stats)
        if not resp.get("max_local_gen_s"):
            return {}
        self._max_local_gen_s = float(resp["max_local_gen_s"])
        return {"training/max_local_gen_s": self._max_local_gen_s,
                "training/num_rollout_instances":
                    float(resp.get("num_instances", 0))}

    def _remote_step_stats(self, metrics: MetricsTracker, pipeline, state,
                           step_time: float, throughput: float) -> None:
        """A remote rollout's per-step control plane: the cumulative fault
        and transfer gauges, the balancer round trip with this step's walls
        (on the pipeline's producer lane when pipelined, its gauges then
        landing in the next step's record), the manager's /metrics scrape,
        what the balance estimator saw and the pool's counters. The
        balancer's ``occupancy`` (fleet mean) and ``device_frac`` (fleet
        minimum of the engines' loop profilers) are the previous step
        record's ``engine/*`` aggregates."""
        metrics.update_gauge(self.rollout.fault_counters())
        timings = metrics.timings()
        last = self._last_record
        stats = dict(
            step_time_s=step_time, trainer_bubble_s=state["bubble"],
            throughput=throughput,
            generate_s=float(timings.get("gen", 0.0)),
            update_s=float(timings.get("update_actor", 0.0))
            + float(timings.get("update_critic", 0.0)),
            occupancy=float(last.get("engine/occupancy", 0.0)),
            device_frac=float(last.get("engine/device_frac", 0.0)))
        if pipeline is not None:
            pipeline.submit_step_stats(**stats)
        else:
            metrics.update_gauge(self.rollout.scrape_manager_metrics())
            metrics.update_gauge(self._balancer_round(stats))
        metrics.update_gauge(self.rollout.balance.metrics())
        if self.rollout.pool is not None:
            metrics.update_gauge(self.rollout.pool.counters())

    # -- fit --------------------------------------------------------------

    def fit(self) -> list[dict]:
        """Run the steps from ``global_step`` (after a resume) to
        ``total_steps``; returns the per-step metric dicts (plus a
        validation record first with ``val_before_train``)."""
        from polyrl_tpu_torch.trainer.pipeline import RolloutPipeline

        cfg = self.cfg
        history = []
        if self._load_checkpoint() and self.logger is not None:
            self.logger.log({"training/resumed_from_step": self.global_step},
                            step=self.global_step)
        self._push_weights()  # bootstrap the engine with the actor's weights
        if cfg.val_before_train and self.val_dataset is not None:
            pre = MetricsTracker()
            self._maybe_validate(pre, force=True)
            history.append(pre.as_dict())
            if self.logger is not None:
                self.logger.log(history[-1], step=self.global_step)
        # pipelined mode: a background lane generates up to depth steps
        # ahead while this thread trains
        pipeline = (RolloutPipeline(self, cfg.pipeline_depth).start(
            self.global_step, cfg.total_steps) if cfg.pipeline_depth > 0
            else None)
        try:
            while self.global_step < cfg.total_steps:
                self._profile_gate(self.global_step + 1)
                metrics = MetricsTracker()
                step_t0 = time.monotonic()
                if pipeline is None:
                    records = next(self.dataloader)
                    if hasattr(self.dataloader, "state_dict"):
                        self._loader_state = self.dataloader.state_dict()
                    source = lambda: self._ibatch_iter(  # noqa: E731
                        records, None, metrics)
                else:
                    step = self.global_step
                    source = lambda: pipeline.step_ibatches(  # noqa: E731
                        step, metrics)
                state = self._train_one_batch(source, metrics)
                with marked_timer("update_weight", metrics):
                    self._push_weights(block=cfg.pipeline_depth == 0)
                # free the optimizer's device memory for generation (a
                # no-op unless actor.cfg.offload_optimizer)
                self.actor.offload_opt_state()
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
                if _remote(self.rollout):
                    self._remote_step_stats(metrics, pipeline, state,
                                            step_time, throughput)
                self._maybe_validate(metrics,
                                     force=self.global_step >= cfg.total_steps)
                if self._ckpt is not None and ckpt_lib.should_save_checkpoint(
                        self.global_step, cfg.total_steps, cfg.save_freq,
                        esi_expiry_ts=self._esi_expiry,
                        esi_margin_s=cfg.esi_margin_s):
                    with marked_timer("save_checkpoint", metrics):
                        self._save_checkpoint()
                # distributions observed by components without a tracker
                # (fabric push and pack walls, manager round trips, the
                # remote stream's per-request latency) for this step
                metrics.merge_histograms(obs.drain_histograms())
                record = metrics.as_dict()
                self._last_record = record
                history.append(record)
                if self.logger is not None:
                    self.logger.log(record, step=self.global_step)
        finally:
            if pipeline is not None:
                pipeline.close()
            self._profile_gate(-1)  # close an open trace
        self._wait_pushed()  # the last push lands before fit returns
        if self._ckpt is not None:
            self._ckpt.wait()
        return history
