"""Config system: dataclass tree + YAML + dotted CLI overrides.

Counterpart of ``polyrl_tpu/config.py`` for the sections this port runs:
model, tokenizer, data, the rollout (colocated, ``cb`` or ``step``, or
disaggregated: the manager, the weight fabric, the pool, its autoscaling
controller and the spot market), the weight fabric's supervision
(``transfer``), reward (with the remote code sandbox), trainer, actor and
critic, the trainer's ``logging`` backends and the ``obs`` planes
(tracing, the ``/statusz`` exporter, the flight recorder, the training
health ledger), the ``parallel`` mesh axes, plus the ``device`` every entry point takes (``cuda`` by
default; it raises without a card). Nested dataclasses are the schema and
the defaults, a YAML file overlays them, and ``key.sub=value`` dotted CLI
arguments overlay that (CLI > file > default). Unknown keys raise.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any

from polyrl_tpu_torch.rollout.autoscale import AutoscaleConfig
from polyrl_tpu_torch.rollout.faults import FaultInjectionConfig
from polyrl_tpu_torch.rollout.pool import PoolConfig
from polyrl_tpu_torch.rollout.spotmarket import SpotMarketConfig
from polyrl_tpu_torch.trainer.actor import ActorConfig
from polyrl_tpu_torch.trainer.critic import CriticConfig
from polyrl_tpu_torch.trainer.stream_trainer import TrainerConfig
from polyrl_tpu_torch.transfer.agents import TransferConfig


@dataclass
class ModelSection:
    preset: str = "tiny"                  # any decoder.PRESETS key
    dtype: str = "bfloat16"
    hf_path: str = ""                     # local HF checkpoint dir (overrides preset)
    overrides: dict = field(default_factory=dict)  # raw ModelConfig fields


@dataclass
class TokenizerSection:
    kind: str = "byte"                    # byte | hf
    name_or_path: str = ""


@dataclass
class DataSection:
    train_path: str = "arithmetic"        # .jsonl/.parquet path, or "arithmetic"
    val_path: str = ""                    # the same kinds; "" = no validation
    prompt_key: str = "prompt"
    shuffle: bool = True
    seed: int = 0
    arithmetic_size: int = 512


@dataclass
class RolloutSection:
    mode: str = "colocated"               # colocated | disaggregated
    backend: str = "cb"                   # cb (paged continuous batching) | step (bucketed)
    batch_buckets: tuple = ()             # step backend; () -> its defaults
    prompt_buckets: tuple = ()            # () -> the engine's default buckets
    max_slots: int = 64
    page_size: int = 64
    max_seq_len: int = 16384
    num_pages: int = 0                    # 0 -> the engine's default pool
    kv_cache_dtype: str = ""              # "" -> model dtype
    steps_per_dispatch: int = 8
    # chunked prefill (cb): prompts longer than this fill one chunk per
    # engine iteration, between decode dispatches; a multiple of
    # page_size, 0 = off
    prefill_chunk: int = 0
    # prompt-lookup speculative decoding (cb): draft tokens verified per
    # round, and rounds per decode dispatch (0 = off)
    spec_tokens: int = 0
    spec_rounds: int = 2
    # aborts and shutdown deliver the tokens in flight first (cb)
    salvage_partials: bool = True
    admit_wave: int = 8
    admit_reorder_window: int = 8
    group_share: bool = True
    decode_group_share: bool = True
    group_preref_ttl_s: float = 30.0
    # the CB engine's memory plane (rollout/kvledger.py): a per-page ledger
    # of role, owner, age and free cause, with hot/warm/cold residency
    # tiers (a page is cold after this many idle decode dispatches; warm
    # after a quarter of it). False: no accounting, the same outputs.
    kv_ledger: bool = True
    kv_cold_after_dispatches: int = 256
    # the host-RAM KV spill tier (rollout/kvspill.py): under page-use
    # pressure (the sweep arms at >= the high watermark and spills down
    # toward the low one) cold unreferenced published prefix-cache pages
    # go to pinned host memory, up to kv_spill_host_gb, and a prefix hit
    # restores them. Needs kv_ledger.
    kv_spill: bool = True
    kv_spill_host_gb: float = 4.0
    kv_spill_high_watermark: float = 0.92
    kv_spill_low_watermark: float = 0.80
    # the engine-loop profiler (obs/engine_profile.py): each loop
    # iteration's wall by phase, and the device_frac the balancer reads.
    # False: no clocks around the loop, the same outputs.
    loop_profile: bool = True
    # disaggregated plumbing: the rollout servers run as their own
    # processes (``python -m polyrl_tpu_torch.rollout.serve
    # --manager-endpoint``)
    manager_endpoint: str = ""            # "" -> spawn the C++ manager locally
    manager_args: tuple = ()              # extra CLI args for the spawned manager
    # a locally spawned manager runs supervised: respawned with backoff
    # (base doubling to max), its state replayed through /reconcile
    manager_respawn_backoff_s: float = 0.5
    manager_respawn_backoff_max_s: float = 10.0
    # mid-stream transport failures re-issue only the unfinished rids, at
    # most resume_budget times per batch, waiting up to resume_wait_s each
    # time for the manager to come back
    resume_budget: int = 3
    resume_wait_s: float = 60.0
    # fault-injection harness (rollout/faults.py) on the trainer's stream
    fault_injection: FaultInjectionConfig = field(
        default_factory=FaultInjectionConfig)
    transfer_streams: int = 4
    advertise_host: str = "127.0.0.1"
    # multi-NIC weight push (transfer/nic.py): >1 runs one sender agent per
    # CIDR-picked local interface and the manager partitions the pool
    sender_groups: int = 1
    sender_nic_cidr: str = ""             # e.g. "10.128.0.0/16,10.129.0.0/16"
    groups_per_sender: int = 1            # manager-side instance sharding
    # hybrid colocated + remote: an in-process engine on the trainer's
    # card, registered as a local instance the manager time-slices (aborted
    # after the balancer's max_local_gen_s window); its KV pool is released
    # after each generation phase and resumed before the next
    colocated_local: bool = False
    # elastic pool (rollout/pool.py): membership sweeps, join gating,
    # preemption drills and the balance estimator's window
    pool: PoolConfig = field(default_factory=PoolConfig)
    # closed-loop autoscaling (rollout/autoscale.py): adds from a capacity
    # provider and drains of the least-loaded engine, ticked once a step
    # under hysteresis, cooldowns, a fleet envelope and a rate limiter;
    # the degradation tier and the pipeline's admission gate. Off: the
    # trainer without it, bit for bit
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    # trace-driven spot market (rollout/spotmarket.py): scripted offers,
    # preemption notices and kills replayed against the pool; the
    # controller's capacity provider
    spot_market: SpotMarketConfig = field(default_factory=SpotMarketConfig)


@dataclass
class RewardSection:
    manager: str = "naive"
    custom_score_path: str = ""           # python file defining compute_score
    num_workers: int = 8
    # remote sandbox-service code execution (rewards/sandbox.py); "" = the
    # local rlimit'd subprocess sandbox
    sandbox_url: str = ""
    sandbox_max_concurrent: int = 64
    sandbox_timeout_s: float = 30.0
    sandbox_memory_limit_mb: int = 1024


@dataclass
class LoggingSection:
    backends: tuple = ("console",)        # console | jsonl | tensorboard | wandb
    path: str = ""                        # jsonl path / tensorboard dir


@dataclass
class ObsSection:
    """Observability knobs (the reference's ``obs`` section): span tracing
    with cross-process propagation and a Chrome-trace dump, the trainer's
    ``/statusz`` exporter, the anomaly flight recorder and the training
    health ledger."""
    trace: bool = False                   # span tracer on/off
    trace_dir: str = ""                   # spans.jsonl + trace.json dump dir
    trace_buffer: int = 4096              # ring-buffer span capacity
    # the reference's key: here torch.profiler.record_function ranges
    # around the trainer's phases, so that trainer.profile_steps traces
    # line up with the host spans
    jax_annotations: bool = False
    # the trainer serves GET /statusz and /metrics (port 0 = ephemeral)
    statusz: bool = False
    statusz_host: str = "127.0.0.1"
    statusz_port: int = 0
    # the anomaly flight recorder (obs/recorder.py): EWMA/z-score watch
    # over the step records; post-mortem bundles on anomaly, crash or
    # SIGTERM into recorder_dir
    recorder: bool = False
    recorder_dir: str = ""                # "" -> next to logging.path
    recorder_keep_steps: int = 64         # step records per bundle
    recorder_z: float = 4.0               # z-score anomaly threshold
    recorder_warmup: int = 5              # steps before detection arms
    recorder_max_bundles: int = 4         # bundle budget per run
    # the training health ledger (obs/rlhealth.py): training/* in every
    # step record, the /statusz training section, training.json bundles;
    # host numpy over arrays the step already copied to the host
    rlhealth: bool = True
    rlhealth_tail: int = 64               # per-step rows kept for bundles
    rlhealth_group_rows: int = 64         # group-table rows per step


@dataclass
class ParallelSection:
    """Mesh axes of the multi-process trainer (``parallel/mesh.py``). With
    every axis 1 and a single process no mesh is built (the one-device
    path); a multi-process world (``torchrun``) always builds one over its
    ranks. ``tp``, ``pp`` and ``ep`` above 1 are not ported yet."""
    dp: int = 1
    fsdp: int = 1                         # -1 absorbs remaining ranks
    tp: int = 1
    sp: int = 1
    pp: int = 1                           # pipeline parallel (layer stages)
    pp_microbatches: int = 0              # GPipe microbatches (0 -> 2*pp)
    ep: int = 1                           # expert parallel (MoE expert axis)
    # sequence-parallel attention flavor when sp > 1 (parallel/sequence.py):
    # ulysses (head all-to-all) | ring (K/V rotation)
    sp_mode: str = "ulysses"
    # the world's collective backend: nccl, or gloo (the CPU, or ranks
    # that share one card); never switched silently
    backend: str = "nccl"


@dataclass
class RunConfig:
    device: str = "cuda"
    model: ModelSection = field(default_factory=ModelSection)
    tokenizer: TokenizerSection = field(default_factory=TokenizerSection)
    data: DataSection = field(default_factory=DataSection)
    rollout: RolloutSection = field(default_factory=RolloutSection)
    # weight-push fabric supervision (transfer/agents.py TransferConfig):
    # bandwidth-keyed push deadlines, verify/resume, retry budget and
    # backoff, and the transfer-plane fault injector
    transfer: TransferConfig = field(default_factory=TransferConfig)
    parallel: ParallelSection = field(default_factory=ParallelSection)
    reward: RewardSection = field(default_factory=RewardSection)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    actor: ActorConfig = field(default_factory=ActorConfig)
    critic: CriticConfig = field(default_factory=CriticConfig)
    logging: LoggingSection = field(default_factory=LoggingSection)
    obs: ObsSection = field(default_factory=ObsSection)


# -- dict <-> dataclass -------------------------------------------------------


def _build(cls, data: dict):
    """Construct dataclass ``cls`` from a (possibly partial) dict, recursing
    into dataclass-typed fields. Unknown keys raise."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, value in data.items():
        ftype = hints.get(name, str)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[name] = _build(ftype, value)
        elif ftype is tuple or typing.get_origin(ftype) is tuple:
            kwargs[name] = tuple(value) if isinstance(value, (list, tuple)) else (value,)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def to_dict(cfg: Any) -> dict:
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return list(x)
        return x

    return clean(dataclasses.asdict(cfg))


# -- overrides ------------------------------------------------------------------


def _coerce(text: str, current: Any) -> Any:
    """Parse a CLI string by the type of the value it replaces."""
    if isinstance(current, bool):
        if text.lower() in ("true", "1", "yes"):
            return True
        if text.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"not a bool: {text!r}")
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    if isinstance(current, tuple):
        text = text.strip()
        if text[:1] == "[" and text[-1:] == "]":
            text = text[1:-1]
        if not text:
            return ()
        items = [t.strip() for t in text.split(",") if t.strip()]
        conv = int if all(i.lstrip("-").isdigit() for i in items) else str
        return tuple(conv(i) for i in items)
    if isinstance(current, dict):
        return json.loads(text)
    if current is None:
        if text.lower() in ("null", "none", ""):
            return None
        for conv in (int, float):
            try:
                return conv(text)
            except ValueError:
                pass
        return text
    return text


def _set_path(obj: Any, parts: list[str], raw: str, full: str) -> Any:
    """Return ``obj`` with the dotted path set; frozen dataclasses are
    rebuilt via ``dataclasses.replace`` instead of mutated."""
    name = parts[0]
    if not dataclasses.is_dataclass(obj) or not hasattr(obj, name):
        raise KeyError(f"no config field {name!r} in {full!r}")
    cur = getattr(obj, name)
    new = _coerce(raw, cur) if len(parts) == 1 else _set_path(cur, parts[1:], raw, full)
    try:
        setattr(obj, name, new)
        return obj
    except dataclasses.FrozenInstanceError:
        return dataclasses.replace(obj, **{name: new})


def apply_overrides(cfg: RunConfig, overrides: list[str]) -> RunConfig:
    """``a.b.c=value`` dotted assignments, validated against the schema."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        cfg = _set_path(cfg, key.strip().split("."), raw, key)
    return cfg


def load_config(path: str | None = None,
                overrides: list[str] | None = None) -> RunConfig:
    """YAML file (optional) overlaid on defaults, then dotted overrides;
    the trainer's validation re-runs on the final values."""
    data: dict = {}
    if path:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _build(RunConfig, data)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    cfg.trainer.__post_init__()
    return cfg
