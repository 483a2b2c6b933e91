"""Trainer entry point: ``python -m polyrl_tpu_torch.train [--config run.yaml]
[section.field=value ...]``.

Counterpart of ``polyrl_tpu/train.py``: compose the config, build the
tokenizer, model (random weights from ``trainer.seed``, or a local Hugging
Face checkpoint with ``model.hf_path``), the rollout -- with
``rollout.mode=colocated`` an in-process engine (``rollout.backend=cb``,
the paged CB engine, or ``step``, the bucketed ``RolloutEngine``); with
``rollout.mode=disaggregated`` the rollout manager (spawned and
supervised, or ``rollout.manager_endpoint``), the weight fabric
(``TransferInterface``), the pool and ``RemoteRollout``, while the rollout
servers run as their own processes (``python -m
polyrl_tpu_torch.rollout.serve --manager host:port``) --, reward
manager, datasets (training and, with
``data.val_path``, validation), actor, the critic (with
``trainer.adv_estimator=gae``, from ``trainer.seed + 1``) and (with a KL
term) the reference policy, assemble the trainer (its checkpoint manager
with ``trainer.ckpt_dir``) and run ``fit``. ``device``
defaults to ``cuda`` and raises without a card; ``device=cpu`` runs the
same path on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import sys

import torch

from polyrl_tpu_torch.config import RunConfig, load_config, to_dict
from polyrl_tpu_torch.device import resolve_device

log = logging.getLogger("polyrl_tpu_torch.train")


def build_tokenizer(cfg: RunConfig):
    from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer, load_tokenizer

    if cfg.tokenizer.kind == "byte":
        return ByteTokenizer()
    return load_tokenizer(cfg.tokenizer.name_or_path)


def build_dataset(cfg: RunConfig, split: str = "train"):
    """The training or validation prompts (None without a path)."""
    from polyrl_tpu_torch.data.dataset import RLDataset, make_arithmetic_dataset

    path = cfg.data.train_path if split == "train" else cfg.data.val_path
    if not path:
        return None
    if path == "arithmetic":
        return make_arithmetic_dataset(cfg.data.arithmetic_size, seed=cfg.data.seed)
    if path.endswith(".jsonl"):
        return RLDataset.from_jsonl(path)
    if path.endswith(".parquet"):
        return RLDataset.from_parquet(path, prompt_key=cfg.data.prompt_key)
    raise ValueError(f"unsupported dataset path {path!r}")


def load_custom_score(path: str):
    """``compute_score`` from a user file."""
    spec = importlib.util.spec_from_file_location("polyrl_custom_reward", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compute_score


def _build_model(cfg: RunConfig, device: torch.device):
    from polyrl_tpu_torch.models import decoder

    if cfg.model.hf_path:
        from polyrl_tpu_torch.models.hf_loader import build_from_hf

        mcfg, params = build_from_hf(cfg.model.hf_path,
                                     dtype=getattr(torch, cfg.model.dtype),
                                     overrides=cfg.model.overrides,
                                     device=device)
        log.info("loaded pretrained weights from %s", cfg.model.hf_path)
        return mcfg, params
    mcfg = decoder.get_config(cfg.model.preset,
                              dtype=getattr(torch, cfg.model.dtype),
                              **cfg.model.overrides)
    gen = torch.Generator(device=device).manual_seed(cfg.trainer.seed)
    return mcfg, decoder.init_params(gen, mcfg)


def _build_remote(cfg: RunConfig, params, tokenizer, cleanup: list):
    """The disaggregated rollout: a ManagerClient (of a locally spawned,
    supervised manager unless ``rollout.manager_endpoint`` names one), the
    weight fabric, the pool control plane and ``RemoteRollout``. Rollout
    servers join the pool on their own (``serve --manager``); their weight
    receivers connect to the sender registered here, so start them after
    this returns."""
    from polyrl_tpu_torch.manager.client import ManagerClient
    from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
    from polyrl_tpu_torch.rollout.pool import PoolManager
    from polyrl_tpu_torch.rollout.remote import RemoteRollout
    from polyrl_tpu_torch.transfer import TransferInterface

    r = cfg.rollout
    fault = None
    if r.fault_injection.enabled:
        from polyrl_tpu_torch.rollout.faults import FaultInjector

        fault = FaultInjector(r.fault_injection)
        log.warning("rollout fault injection ENABLED: %s", r.fault_injection)
    if not r.manager_endpoint:
        # a locally spawned manager runs supervised: a crash or failed
        # health probe respawns it with backoff and replays its state
        # through /reconcile; the client re-resolves the fresh port
        supervisor = ManagerSupervisor(
            extra_args=list(r.manager_args),
            respawn_backoff_s=r.manager_respawn_backoff_s,
            respawn_backoff_max_s=r.manager_respawn_backoff_max_s).start()
        cleanup.append(supervisor.stop)
        mgr = supervisor.client()
        log.info("spawned supervised rollout manager on %s (log: %s)",
                 supervisor.endpoint, supervisor.log_path)
    else:
        mgr = ManagerClient(r.manager_endpoint)
    mgr.wait_healthy()
    transfer_fault = None
    if cfg.transfer.fault_injection.enabled:
        from polyrl_tpu_torch.rollout.faults import TransferFaultInjector

        transfer_fault = TransferFaultInjector(cfg.transfer.fault_injection)
        log.warning("transfer fault injection ENABLED: %s",
                    cfg.transfer.fault_injection)
    iface = TransferInterface(
        params, manager_client=mgr, num_streams=r.transfer_streams,
        advertise_host=r.advertise_host, sender_groups=r.sender_groups,
        sender_nic_cidr=r.sender_nic_cidr,
        groups_per_sender=r.groups_per_sender, cfg=cfg.transfer,
        fault=transfer_fault)
    cleanup.append(iface.close)
    # fleet control plane: membership sweeps, pool/* step gauges, join
    # gating and preemption drills; a receiver that exhausts its push
    # retry budget is drained and deregistered through it
    pool = PoolManager(mgr, r.pool)
    cleanup.append(pool.close)
    iface.set_laggard_callback(pool.escalate_laggard)
    pool.transfer_health_fn = iface.sync_health
    return RemoteRollout(mgr, transfer=iface, local_server=None,
                         pad_token_id=tokenizer.pad_token_id,
                         resume_budget=r.resume_budget,
                         resume_wait_s=r.resume_wait_s,
                         salvage_partials=r.salvage_partials,
                         fault_injector=fault,
                         balance_window=r.pool.balance_window, pool=pool)


def _build_rollout(cfg: RunConfig, mcfg, params, tokenizer, device,
                   cleanup: list | None = None):
    r = cfg.rollout
    if r.mode == "disaggregated":
        cleanup = [] if cleanup is None else cleanup
        if r.colocated_local:
            raise NotImplementedError(
                "rollout.colocated_local (an in-process engine time-sliced "
                "beside the remote pool) is not ported to polyrl_tpu_torch "
                "yet (ROADMAP A' 7)")
        return _build_remote(cfg, params, tokenizer, cleanup)
    if r.mode != "colocated":
        raise ValueError(f"unknown rollout.mode {r.mode!r} "
                         "(colocated or disaggregated)")
    if r.backend not in ("cb", "step"):
        raise ValueError(f"unknown rollout.backend {r.backend!r} (cb or step)")
    kv_dtype = getattr(torch, r.kv_cache_dtype or cfg.model.dtype)
    kwargs = {}
    if r.prompt_buckets:
        kwargs["prompt_buckets"] = tuple(r.prompt_buckets)
    if r.backend == "step":
        from polyrl_tpu_torch.rollout.engine import RolloutEngine

        if r.batch_buckets:
            kwargs["batch_buckets"] = tuple(r.batch_buckets)
        return RolloutEngine(mcfg, params, pad_token_id=tokenizer.pad_token_id,
                             kv_cache_dtype=kv_dtype, seed=cfg.trainer.seed,
                             device=device, **kwargs)
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    return CBEngine(
        mcfg, params, pad_token_id=tokenizer.pad_token_id,
        kv_cache_dtype=kv_dtype,
        max_slots=r.max_slots, page_size=r.page_size, max_seq_len=r.max_seq_len,
        num_pages=r.num_pages or None, steps_per_dispatch=r.steps_per_dispatch,
        prefill_chunk=r.prefill_chunk, spec_tokens=r.spec_tokens,
        spec_rounds=r.spec_rounds, salvage_partials=r.salvage_partials,
        admit_wave=r.admit_wave, admit_reorder_window=r.admit_reorder_window,
        group_share=r.group_share, decode_group_share=r.decode_group_share,
        group_preref_ttl_s=r.group_preref_ttl_s, kv_ledger=r.kv_ledger,
        kv_cold_after_dispatches=r.kv_cold_after_dispatches,
        kv_spill=r.kv_spill, kv_spill_host_gb=r.kv_spill_host_gb,
        kv_spill_high_watermark=r.kv_spill_high_watermark,
        kv_spill_low_watermark=r.kv_spill_low_watermark,
        loop_profile=r.loop_profile, seed=cfg.trainer.seed,
        device=device, **kwargs)


def build_trainer(cfg: RunConfig, cleanup: list | None = None,
                  compute_score=None):
    """Assemble the trainer from a RunConfig. ``cleanup`` collects teardown
    callables (the engine's loop thread; the spawned manager, the fabric
    and the pool of a disaggregated rollout); ``compute_score`` overrides the
    reward function (else ``reward.custom_score_path`` or the default
    per-dataset scorers)."""
    from polyrl_tpu_torch.data.dataset import PromptDataLoader
    from polyrl_tpu_torch.rewards.manager import load_reward_manager
    from polyrl_tpu_torch.trainer.actor import ReferencePolicy, StreamActor
    from polyrl_tpu_torch.trainer.critic import StreamCritic, init_critic_params
    from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer

    cleanup = [] if cleanup is None else cleanup
    device = resolve_device(cfg.device)
    tokenizer = build_tokenizer(cfg)
    mcfg, params = _build_model(cfg, device)
    # the engine copies the weights; the fabric packs them at each push
    rollout = _build_rollout(cfg, mcfg, params, tokenizer, device, cleanup)
    if hasattr(rollout, "stop"):
        cleanup.append(rollout.stop)
    if compute_score is None and cfg.reward.custom_score_path:
        compute_score = load_custom_score(cfg.reward.custom_score_path)
    reward_manager = load_reward_manager(cfg.reward.manager, tokenizer,
                                         compute_score=compute_score,
                                         num_workers=cfg.reward.num_workers)
    loader = PromptDataLoader(build_dataset(cfg),
                              cfg.trainer.train_batch_size,
                              shuffle=cfg.data.shuffle, seed=cfg.data.seed)
    ref_policy = (ReferencePolicy(mcfg, params)  # a copy, before training
                  if (cfg.trainer.use_kl_in_reward or cfg.actor.use_kl_loss)
                  else None)
    actor = StreamActor(mcfg, cfg.actor, params)  # takes the tensors as its own
    critic = None
    if cfg.trainer.adv_estimator == "gae":
        gen = torch.Generator(device=device).manual_seed(cfg.trainer.seed + 1)
        critic = StreamCritic(mcfg, cfg.critic, init_critic_params(gen, mcfg))
    if cfg.trainer.pipeline_depth > 0:
        log.info("pipelined rollout enabled: depth=%d, staleness_limit=%d "
                 "(%s), stale-rollout IS correction=%s (cap=%.2f)",
                 cfg.trainer.pipeline_depth, cfg.trainer.staleness_limit,
                 "hard wait_pushed fence" if cfg.trainer.staleness_limit <= 1
                 else "bounded-staleness admission gate",
                 "on" if cfg.trainer.rollout_is_correction else "OFF",
                 cfg.trainer.rollout_is_cap)
    return StreamRLTrainer(cfg.trainer, actor, rollout, tokenizer,
                           reward_manager, loader, critic=critic,
                           ref_policy=ref_policy, logger=_ConsoleLogger(),
                           val_dataset=build_dataset(cfg, "val"))


class _ConsoleLogger:
    """One line per step: wall, reward and policy loss."""

    KEYS = ("perf/step_time_s", "reward/mean", "actor/pg_loss",
            "critic/vf_loss", "val/test_score/mean",
            "training/resumed_from_step")

    def log(self, metrics: dict, step: int) -> None:
        brief = {k: round(metrics[k], 4) for k in self.KEYS if k in metrics}
        print(f"[step {step}] {brief}", flush=True)


def _dump(cfg: RunConfig) -> str:
    try:
        import yaml
    except ImportError:  # the config prints as JSON where PyYAML is absent
        return json.dumps(to_dict(cfg), indent=2)
    return yaml.safe_dump(to_dict(cfg), sort_keys=False)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m polyrl_tpu_torch.train",
        description="Streaming GRPO/PPO trainer on one CUDA device "
                    "(colocated, or with remote rollout servers)")
    parser.add_argument("--config", default=None, help="YAML run config")
    parser.add_argument("--print-config", action="store_true",
                        help="resolve the config, print it, exit")
    parser.add_argument("overrides", nargs="*",
                        help="dotted overrides: trainer.total_steps=100 ...")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config(args.config, args.overrides)
    if args.print_config:
        print(_dump(cfg))
        return 0
    cleanup: list = []
    try:
        trainer = build_trainer(cfg, cleanup)
        history = trainer.fit()
        if history:
            log.info("finished %d steps; final metrics: %s", trainer.global_step,
                     {k: round(v, 5) for k, v in sorted(history[-1].items())})
        return 0
    finally:
        for fn in reversed(cleanup):
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown must run to the end
                log.exception("cleanup failed")


if __name__ == "__main__":
    sys.exit(main())
