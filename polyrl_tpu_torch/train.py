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
polyrl_tpu_torch.rollout.serve --manager-endpoint host:port``), and with
``rollout.colocated_local`` an in-process engine on the trainer's card
serves beside them as a local, time-sliced instance --, reward
manager, datasets (training and, with
``data.val_path``, validation), actor, the critic (with
``trainer.adv_estimator=gae``, from ``trainer.seed + 1``) and (with a KL
term) the reference policy, the observability planes (``obs``: tracing,
the flight recorder, the health ledger, ``/statusz``) and the
``Tracking`` logger (``logging``), assemble the trainer (its checkpoint
manager with ``trainer.ckpt_dir``; with ``rollout.autoscale.enabled`` on
a disaggregated rollout the autoscaling controller, and with
``rollout.spot_market.enabled`` the spot market as its capacity) and run
``fit``. ``reward.sandbox_url`` sends code execution to a sandbox
service. With
``trainer.weight_sync=lora_delta`` each push carries only the LoRA
adapters, to servers started with the same ``--lora-rank``. ``device``
defaults to ``cuda`` and raises without a card; ``device=cpu`` runs the
same path on the CPU with the kernels' plain versions.

Multi-process (``torchrun --nproc-per-node N -m polyrl_tpu_torch.train
parallel.fsdp=N ...``): ``main`` joins the world first
(``parallel/distributed.py``, backend ``parallel.backend``), every rank
builds the mesh (``_build_mesh``), the model and its shards of the actor
and critic, rank 0 alone the rollout, the recorder and the ``/statusz``
exporter (the others a ``NullRollout``), and every rank runs ``fit``:
rank 0 broadcasts each ibatch and its rewards. With ``parallel.sp > 1``
the sequence splits over sp through Ulysses or ring attention
(``parallel.sp_mode``), packed rows included. With ``parallel.tp > 1``
(``torchrun ... -m polyrl_tpu_torch.train parallel.tp=2``) each rank
trains its tensor-parallel shard of the actor and critic
(``parallel/tensor.py``); the push to rank 0's engine gathers the whole
tree. ``parallel.pp=2`` runs the layer stack as a GPipe pipeline of
``parallel.pp_microbatches`` microbatches (``parallel/pipeline.py``), each
rank training its stage; ``parallel.ep=2`` splits a MoE model's experts
(``parallel/expert.py``). The push and the checkpoints gather every stage
and every expert block.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
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


def _check_weight_sync(cfg: RunConfig) -> None:
    """The delta-sync combinations the reference refuses, checked before
    any manager is spawned."""
    if cfg.trainer.weight_sync != "lora_delta":
        return
    if cfg.rollout.mode != "disaggregated":
        raise NotImplementedError(
            "weight_sync=lora_delta requires rollout.mode=disaggregated "
            "(a colocated in-process engine holds the plain tree; adapter "
            "pushes target servers started with --lora-rank)")
    if cfg.actor.lora_rank <= 0:
        raise ValueError(
            "trainer.weight_sync=lora_delta requires actor.lora_rank>0")
    if cfg.rollout.colocated_local:
        raise NotImplementedError(
            "weight_sync=lora_delta with colocated_local is not supported: "
            "the in-process engine serves the plain merged tree and cannot "
            "take adapter-only pushes")


def _cb_engine(cfg: RunConfig, mcfg, params, tokenizer, device):
    """The paged CB engine with the ``rollout`` section's settings (the
    colocated rollout, and the hybrid's local engine)."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    r = cfg.rollout
    kwargs = {}
    if r.prompt_buckets:
        kwargs["prompt_buckets"] = tuple(r.prompt_buckets)
    return CBEngine(
        mcfg, params, pad_token_id=tokenizer.pad_token_id,
        kv_cache_dtype=getattr(torch, r.kv_cache_dtype or cfg.model.dtype),
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


def _build_remote(cfg: RunConfig, mcfg, params, tokenizer, device,
                  cleanup: list):
    """The disaggregated rollout: a ManagerClient (of a locally spawned,
    supervised manager unless ``rollout.manager_endpoint`` names one), the
    weight fabric (its layout the adapter tree under lora_delta), with
    ``rollout.colocated_local`` the in-process engine behind a local
    ``RolloutServer``, the pool control plane and ``RemoteRollout``.
    Rollout servers join the pool on their own (``serve
    --manager-endpoint``); their weight receivers connect to the sender
    registered here, so start them after this returns."""
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
    template = params
    if cfg.trainer.weight_sync == "lora_delta":
        # the wire carries only the adapters (checked at the top)
        from polyrl_tpu_torch.models import lora

        template = lora.adapter_template(mcfg, cfg.actor.lora_rank)
    iface = TransferInterface(
        template, manager_client=mgr, num_streams=r.transfer_streams,
        advertise_host=r.advertise_host, sender_groups=r.sender_groups,
        sender_nic_cidr=r.sender_nic_cidr,
        groups_per_sender=r.groups_per_sender, cfg=cfg.transfer,
        fault=transfer_fault)
    cleanup.append(iface.close)
    local_server = None
    if r.colocated_local:
        # the hybrid: an in-process engine shares the trainer's card and
        # registers as a LOCAL instance, which the manager time-slices
        # (aborted after the balancer's window); RemoteRollout resumes its
        # KV before each generation phase and releases it after
        from polyrl_tpu_torch.rollout.server import RolloutServer

        eng = _cb_engine(cfg, mcfg, params, tokenizer, device)
        local_server = RolloutServer(eng, host="127.0.0.1", port=0).start()
        cleanup.append(local_server.stop)
        # through the trainer's own client: the supervisor then replays
        # the local endpoint after a manager respawn
        mgr.register_local_rollout_instances([local_server.endpoint])
        log.info("colocated local engine registered at %s",
                 local_server.endpoint)
    # fleet control plane: membership sweeps, pool/* step gauges, join
    # gating and preemption drills; a receiver that exhausts its push
    # retry budget is drained and deregistered through it
    pool = PoolManager(mgr, r.pool)
    cleanup.append(pool.close)
    iface.set_laggard_callback(pool.escalate_laggard)
    pool.transfer_health_fn = iface.sync_health
    return RemoteRollout(mgr, transfer=iface, local_server=local_server,
                         pad_token_id=tokenizer.pad_token_id,
                         resume_budget=r.resume_budget,
                         resume_wait_s=r.resume_wait_s,
                         salvage_partials=r.salvage_partials,
                         fault_injector=fault,
                         balance_window=r.pool.balance_window, pool=pool)


def _build_rollout(cfg: RunConfig, mcfg, params, tokenizer, device,
                   cleanup: list | None = None):
    r = cfg.rollout
    _check_weight_sync(cfg)
    if r.mode == "disaggregated":
        cleanup = [] if cleanup is None else cleanup
        return _build_remote(cfg, mcfg, params, tokenizer, device, cleanup)
    if r.mode != "colocated":
        raise ValueError(f"unknown rollout.mode {r.mode!r} "
                         "(colocated or disaggregated)")
    if r.backend not in ("cb", "step"):
        raise ValueError(f"unknown rollout.backend {r.backend!r} (cb or step)")
    if r.backend == "step":
        from polyrl_tpu_torch.rollout.engine import RolloutEngine

        kwargs = {}
        if r.prompt_buckets:
            kwargs["prompt_buckets"] = tuple(r.prompt_buckets)
        if r.batch_buckets:
            kwargs["batch_buckets"] = tuple(r.batch_buckets)
        return RolloutEngine(
            mcfg, params, pad_token_id=tokenizer.pad_token_id,
            kv_cache_dtype=getattr(torch, r.kv_cache_dtype or cfg.model.dtype),
            seed=cfg.trainer.seed, device=device, **kwargs)
    return _cb_engine(cfg, mcfg, params, tokenizer, device)


def _build_autoscale(cfg: RunConfig, rollout, cleanup: list):
    """The closed-loop autoscaling controller, with
    ``rollout.autoscale.enabled`` and a pool to act on (disaggregated);
    else None. With ``rollout.spot_market.enabled`` a started
    ``SpotMarket`` is its capacity provider (offers carry their endpoints:
    it has no engine factory here). The market stops and the controller
    closes on ``cleanup``."""
    if not (cfg.rollout.autoscale.enabled
            and getattr(rollout, "pool", None) is not None):
        return None
    from polyrl_tpu_torch.rollout.autoscale import AutoscaleController

    capacity = None
    if cfg.rollout.spot_market.enabled:
        from polyrl_tpu_torch.rollout.spotmarket import SpotMarket

        market = SpotMarket(rollout.pool, cfg.rollout.spot_market,
                            injector=rollout.fault_injector)
        market.start()
        cleanup.append(market.stop)
        capacity = market
    autoscale = AutoscaleController(
        rollout.pool, rollout.balance, cfg.rollout.autoscale,
        capacity=capacity, rollout=rollout)
    cleanup.append(autoscale.close)
    log.info("autoscale controller armed: envelope [%d, %d]%s",
             cfg.rollout.autoscale.min_engines,
             cfg.rollout.autoscale.max_engines,
             " (dry-run)" if cfg.rollout.autoscale.dry_run else "")
    return autoscale


def _build_mesh(cfg: RunConfig, device: torch.device):
    """The mesh when parallelism is configured or the run is
    multi-process; None on one process with every axis 1 (the actor then
    shards nothing)."""
    import torch.distributed as dist

    from polyrl_tpu_torch.parallel import distributed
    from polyrl_tpu_torch.parallel import mesh as meshlib

    p = cfg.parallel
    axes = (p.dp, p.fsdp, p.tp, p.sp, p.ep, p.pp)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and all(a == 1 for a in axes):
        return None
    fsdp = p.fsdp
    if all(a == 1 for a in axes):
        # multi-process with no axes configured: fsdp absorbs the world
        fsdp = -1
    mcfg = meshlib.MeshConfig(dp=p.dp, fsdp=fsdp, tp=p.tp, sp=p.sp,
                              pp=p.pp, ep=p.ep)
    mesh = distributed.make_hybrid_mesh(config=mcfg, device=device)
    log.info("mesh: %s over %d processes", mesh.shape, mesh.world)
    return mesh


def _sp_attention(cfg: RunConfig, mcfg, mesh):
    """(attn_fn, packed_attn_fn) of a mesh with sp > 1 (None, None
    otherwise, and under a pipeline, whose stages ring over sp), the
    combination checked before anything is spawned."""
    if mesh is None or mesh.shape.get("sp", 1) == 1:
        return None, None
    from polyrl_tpu_torch.parallel.sequence import make_sp_attention

    sp, mode = mesh.shape["sp"], cfg.parallel.sp_mode
    if mesh.shape.get("pp", 1) > 1:
        # sp x pp: the pipeline owns the layer loop, so the SP attention
        # lives inside its stages; the ring does (ring_attention_local on
        # this rank's columns), Ulysses' head all-to-all would reshard
        # every stage boundary and is not implemented there
        if mode != "ring":
            raise NotImplementedError(
                "parallel.sp > 1 with parallel.pp > 1 requires sp_mode=ring "
                "(stage attention rings over sp inside the pipeline); got "
                f"{mode!r}")
        t_total = cfg.trainer.max_prompt_length + cfg.trainer.max_response_length
        if t_total % sp:
            raise ValueError(f"sp x pp needs max_prompt+max_response "
                             f"({t_total}) divisible by sp ({sp})")
        return None, None
    if mode not in ("ulysses", "ring"):
        # the JAX package's "dense" lets GSPMD derive attention over the
        # split sequence; here each rank would attend its own slice only
        raise ValueError(f"parallel.sp > 1 needs sp_mode=ulysses or ring, "
                         f"got {mode!r}")
    # SP x TP: the SP attention sees this rank's tp heads, and Ulysses
    # all-to-alls those local heads over sp, so num_heads % (tp * sp) == 0;
    # the ring moves no heads and has no such rule
    tp = mesh.shape.get("tp", 1)
    if mode == "ulysses" and mcfg.num_heads % (sp * tp):
        raise ValueError(
            f"ulysses SP needs num_heads ({mcfg.num_heads}) divisible by "
            f"sp*tp ({sp}*{tp}); use sp_mode=ring or different axes")
    t_total = cfg.trainer.max_prompt_length + cfg.trainer.max_response_length
    if not cfg.trainer.use_remove_padding and t_total % sp:
        raise ValueError(f"sp needs max_prompt+max_response ({t_total}) "
                         f"divisible by sp ({sp})")
    packed = (make_sp_attention(mesh, mode, packed=True)
              if cfg.trainer.use_remove_padding else None)
    return make_sp_attention(mesh, mode), packed


def _pipeline_layers(cfg: RunConfig, mcfg, mesh):
    """(actor layers_fn, critic layers_fn) of a mesh with pp > 1 (None,
    None otherwise), and the pp and ep checks, before anything is
    spawned: ``num_layers % pp``, ``micro_batch_size % pp_microbatches``
    (0 -> ``2 * pp``), ``num_experts % ep`` on a MoE config."""
    if mesh is None:
        return None, None
    ep = mesh.shape.get("ep", 1)
    if ep > 1 and (not mcfg.num_experts or mcfg.num_experts % ep):
        raise ValueError(f"parallel.ep={ep} needs a MoE model whose "
                         f"num_experts ({mcfg.num_experts}) it divides")
    pp = mesh.shape.get("pp", 1)
    if pp == 1:
        return None, None
    from polyrl_tpu_torch.parallel.pipeline import make_pipeline_layers_fn

    if mcfg.num_layers % pp:
        raise ValueError(f"num_layers {mcfg.num_layers} not divisible by "
                         f"pp {pp}")
    n_micro = cfg.parallel.pp_microbatches or 2 * pp
    if cfg.trainer.micro_batch_size % n_micro:
        # the pipeline pads a ragged feed, but a micro that never fills
        # the microbatches wastes the pipeline's width every step
        raise ValueError(f"micro_batch_size {cfg.trainer.micro_batch_size} "
                         f"not divisible by pp_microbatches {n_micro}")
    sp_ring = mesh.shape.get("sp", 1) > 1
    return (make_pipeline_layers_fn(mesh, mcfg, n_micro, cfg.actor.remat,
                                    sp_ring),
            make_pipeline_layers_fn(mesh, mcfg, n_micro, cfg.critic.remat,
                                    sp_ring))


def build_trainer(cfg: RunConfig, cleanup: list | None = None,
                  compute_score=None):
    """Assemble the trainer from a RunConfig. ``cleanup`` collects teardown
    callables (the engine's loop thread; the spawned manager, the fabric
    and the pool of a disaggregated rollout); ``compute_score`` overrides the
    reward function (else ``reward.custom_score_path`` or the default
    per-dataset scorers). The observability planes are configured first,
    so that spans of the bring-up (manager spawn, fabric registration)
    land in the ring."""
    from polyrl_tpu_torch.data.dataset import PromptDataLoader
    from polyrl_tpu_torch.parallel import multihost
    from polyrl_tpu_torch.rewards.manager import load_reward_manager
    from polyrl_tpu_torch.trainer.actor import ReferencePolicy, StreamActor
    from polyrl_tpu_torch.trainer.critic import StreamCritic, init_critic_params
    from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer

    from polyrl_tpu_torch import obs
    from polyrl_tpu_torch.utils.metrics import Tracking

    cleanup = [] if cleanup is None else cleanup
    # the trace dir defaults next to the JSONL metrics
    trace_dir = cfg.obs.trace_dir
    if not trace_dir and cfg.obs.trace and cfg.logging.path:
        trace_dir = os.path.dirname(os.path.abspath(cfg.logging.path))
    obs.configure(trace=cfg.obs.trace, max_spans=cfg.obs.trace_buffer,
                  out_dir=trace_dir or None,
                  jax_annotations=cfg.obs.jax_annotations)
    device = resolve_device(cfg.device)
    tokenizer = build_tokenizer(cfg)
    mesh = _build_mesh(cfg, device)
    mcfg, params = _build_model(cfg, device)
    # SP attention, the pipeline and their checks first: a bad combination
    # fails before a manager or fabric is spawned
    attn_fn, packed_attn_fn = _sp_attention(cfg, mcfg, mesh)
    layers_fn, critic_layers_fn = _pipeline_layers(cfg, mcfg, mesh)
    if multihost.is_main():
        # the engine copies the weights; the fabric packs them at each push
        rollout = _build_rollout(cfg, mcfg, params, tokenizer, device, cleanup)
    else:
        # the other ranks open no manager or fabric connection: their
        # batches arrive through rank 0's broadcasts
        rollout = multihost.NullRollout(pad_token_id=tokenizer.pad_token_id)
    if hasattr(rollout, "stop"):
        cleanup.append(rollout.stop)
    if compute_score is None and cfg.reward.custom_score_path:
        compute_score = load_custom_score(cfg.reward.custom_score_path)
    if compute_score is None and cfg.reward.sandbox_url:
        # code execution goes to the sandbox service, bounded by a
        # concurrency semaphore (the local sandbox on a service failure)
        from polyrl_tpu_torch.rewards.sandbox import SandboxClient

        compute_score = SandboxClient(
            cfg.reward.sandbox_url,
            max_concurrent=cfg.reward.sandbox_max_concurrent,
            timeout_s=cfg.reward.sandbox_timeout_s,
            memory_limit_mb=cfg.reward.sandbox_memory_limit_mb,
        ).compute_score
    reward_manager = load_reward_manager(cfg.reward.manager, tokenizer,
                                         compute_score=compute_score,
                                         num_workers=cfg.reward.num_workers)
    loader = PromptDataLoader(build_dataset(cfg),
                              cfg.trainer.train_batch_size,
                              shuffle=cfg.data.shuffle, seed=cfg.data.seed)
    # the reference policy stays mesh-free: a whole copy on every rank,
    # fed the whole batch (as in the JAX package)
    ref_policy = (ReferencePolicy(mcfg, params)  # a copy, before training
                  if (cfg.trainer.use_kl_in_reward or cfg.actor.use_kl_loss)
                  else None)
    # takes the tensors as its own (on a mesh, its shards of them)
    actor = StreamActor(mcfg, cfg.actor, params, mesh=mesh, attn_fn=attn_fn,
                        layers_fn=layers_fn, packed_attn_fn=packed_attn_fn)
    del params
    critic = None
    if cfg.trainer.adv_estimator == "gae":
        gen = torch.Generator(device=device).manual_seed(cfg.trainer.seed + 1)
        critic = StreamCritic(mcfg, cfg.critic, init_critic_params(gen, mcfg),
                              mesh=mesh, attn_fn=attn_fn,
                              layers_fn=critic_layers_fn,
                              packed_attn_fn=packed_attn_fn)
    if cfg.trainer.pipeline_depth > 0:
        log.info("pipelined rollout enabled: depth=%d, staleness_limit=%d "
                 "(%s), stale-rollout IS correction=%s (cap=%.2f)",
                 cfg.trainer.pipeline_depth, cfg.trainer.staleness_limit,
                 "hard wait_pushed fence" if cfg.trainer.staleness_limit <= 1
                 else "bounded-staleness admission gate",
                 "on" if cfg.trainer.rollout_is_correction else "OFF",
                 cfg.trainer.rollout_is_cap)
    logger = Tracking(backends=tuple(cfg.logging.backends),
                      path=cfg.logging.path or None)
    cleanup.append(logger.close)
    recorder = None
    if cfg.obs.recorder and multihost.is_main():
        from polyrl_tpu_torch.obs.recorder import FlightRecorder

        rec_dir = (cfg.obs.recorder_dir
                   or (os.path.dirname(os.path.abspath(cfg.logging.path))
                       if cfg.logging.path else "polyrl_postmortem"))
        recorder = FlightRecorder(
            rec_dir, keep_steps=cfg.obs.recorder_keep_steps,
            z_threshold=cfg.obs.recorder_z, warmup=cfg.obs.recorder_warmup,
            max_bundles=cfg.obs.recorder_max_bundles)
        log.info("flight recorder armed: bundles -> %s/postmortem", rec_dir)
    health = (obs.TrainingHealthLedger(
        tail_steps=cfg.obs.rlhealth_tail,
        max_group_rows=cfg.obs.rlhealth_group_rows)
        if cfg.obs.rlhealth else False)
    autoscale = _build_autoscale(cfg, rollout, cleanup)
    trainer = StreamRLTrainer(cfg.trainer, actor, rollout, tokenizer,
                              reward_manager, loader, critic=critic,
                              ref_policy=ref_policy, logger=logger,
                              val_dataset=build_dataset(cfg, "val"),
                              recorder=recorder, health=health,
                              autoscale=autoscale)
    if cfg.obs.statusz and multihost.is_main():
        srv = trainer.start_statusz(port=cfg.obs.statusz_port,
                                    host=cfg.obs.statusz_host)
        cleanup.append(trainer.stop_statusz)
        log.info("trainer /statusz serving at http://%s/statusz",
                 srv.endpoint)
    return trainer


def _dump(cfg: RunConfig) -> str:
    try:
        import yaml
    except ImportError:  # the config prints as JSON where PyYAML is absent
        return json.dumps(to_dict(cfg), indent=2)
    return yaml.safe_dump(to_dict(cfg), sort_keys=False)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m polyrl_tpu_torch.train",
        description="Streaming GRPO/PPO trainer on CUDA devices "
                    "(colocated, or with remote rollout servers; under "
                    "torchrun, one process a device)")
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
    # multi-process bring-up before anything touches the card (a no-op on
    # one process): the world from the launcher's environment
    from polyrl_tpu_torch.parallel import distributed

    distributed.initialize(backend=cfg.parallel.backend, device=cfg.device)
    cleanup: list = [distributed.shutdown]
    try:
        trainer = build_trainer(cfg, cleanup)
        if trainer._recorder is not None:
            # SIGTERM (a timeout, a preemption) dumps a bundle first
            trainer._recorder.install_signal_handlers()
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
