"""Rollout server launcher: ``python -m polyrl_tpu_torch.rollout.serve``.

Counterpart of ``polyrl_tpu/rollout/serve.py`` for the knobs this slice
implements: ``--model`` names a preset (random weights from ``--seed``) or
a local Hugging Face checkpoint directory (``models/hf_loader.py``);
``--weight-quant int8`` serves int8 weight-only projections
(``models/quant.py``), and the server re-quantizes a bf16 weight push on
arrival (``RolloutServer.weight_preprocess``); then the engine --
``--backend cb`` (default) the paged continuous-batching engine, with
``--prefill-chunk``, ``--spec-tokens``/``--spec-rounds`` and ``--warmup``;
``--backend step`` the bucketed step engine driven by the server's batch
loop -- and the HTTP server. The CB engine's memory plane and loop
profiler are on by default, as in the reference: the page ledger
(``--no-kv-ledger``, ``--kv-cold-after-dispatches``), the host spill tier
(``--no-kv-spill``, ``--kv-spill-host-gb``) and the loop profiler
(``--no-loop-profile``). With ``--manager-endpoint host:port`` the server
registers with the rollout manager and attaches a weight receiver
(``ReceiverAgent``, ``--transfer-streams`` TCP streams) pointed at the
weight sender the manager assigns: the trainer's pushes then land through
the fabric (``RolloutServer.update_weights_from_agent``). ``--is-local``
registers the server as a local, time-sliced instance instead (no
receiver: a trainer in the same process hands it each push). With
``--lora-rank``/``--lora-alpha`` the server serves a LoRA-wrapped tree
(adapters drawn from a generator seeded ``7919 + rank``, as the trainer's
actor draws them; over an int8 base with ``--weight-quant int8``) and
takes delta pushes (``trainer.weight_sync=lora_delta``): the wire layout is
``lora.adapter_template`` and ``lora.apply_adapters`` copies each push's
``a``/``b`` into the live adapters. ``create_server(fault_injector=)``
attaches a ``FaultInjector`` to the server's admissions and stream lines.
A server started without ``--manager-endpoint`` can join the pool later by
its endpoint (``PoolManager.add_engine(endpoint=)``, the autoscaler's
adds), which attaches its receiver through ``POST /attach_receiver``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

log = logging.getLogger(__name__)


def create_server(model: str, device: str = "cuda", host: str = "0.0.0.0",
                  port: int = 0, advertise_host: str = "127.0.0.1",
                  dtype: str = "bfloat16", seed: int = 0,
                  prompt_buckets: tuple[int, ...] | None = None,
                  model_overrides: dict | None = None,
                  max_slots: int = 64, page_size: int = 64,
                  max_seq_len: int = 16384, num_pages: int | None = None,
                  steps_per_dispatch: int = 8,
                  pipeline_depth: int = 16,
                  admit_wave: int | None = None,
                  admit_reorder_window: int = 8,
                  group_share: bool = True,
                  decode_group_share: bool = True,
                  group_preref_ttl_s: float | None = None,
                  weight_quant: str = "",
                  backend: str = "cb",
                  batch_buckets: tuple[int, ...] | None = None,
                  warmup: bool = False,
                  prefill_chunk: int = 0,
                  spec_tokens: int = 0,
                  spec_rounds: int = 2,
                  salvage_partials: bool = True,
                  kv_ledger: bool = True,
                  kv_cold_after_dispatches: int = 256,
                  kv_spill: bool = True,
                  kv_spill_host_gb: float = 4.0,
                  loop_profile: bool = True,
                  manager_endpoint: str | None = None,
                  transfer_streams: int = 4,
                  is_local: bool = False,
                  lora_rank: int = 0, lora_alpha: float = 16.0,
                  fault_injector=None):
    """Build engine + server and start serving. ``model`` is a preset name
    (random weights from ``seed``) or a local HF checkpoint directory.
    ``backend="cb"`` serves with the paged continuous-batching engine
    (``warmup`` drives every admission variant and captures the ungrouped
    and spec decode graphs before the server starts); ``backend="step"`` with the bucketed
    ``RolloutEngine`` (``batch_buckets``) through the server's batch loop.
    ``weight_quant="int8"`` serves int8 weight-only projections: a
    checkpoint is quantized on the host as it loads, a preset is made in
    quantized form leaf by leaf on the device; weight pushes stay in the
    model dtype and are re-quantized on arrival. With ``manager_endpoint``
    the server registers with the manager and attaches its weight receiver
    (``register_with_manager``; ``is_local`` as a local, time-sliced
    instance). ``lora_rank > 0`` serves the base wrapped in adapters and
    takes adapter-only pushes. ``fault_injector`` (a ``FaultInjector``)
    becomes the server's ``fault``: it sees every admission and every
    outgoing stream line. ``device`` defaults to ``"cuda"`` and
    raises when CUDA is absent; pass ``"cpu"`` explicitly to serve from the
    CPU (tests)."""
    from polyrl_tpu_torch.device import resolve_device
    from polyrl_tpu_torch.models import decoder, quant
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.engine import RolloutEngine
    from polyrl_tpu_torch.rollout.server import RolloutServer

    if weight_quant not in ("", "int8"):
        raise ValueError(f"unknown weight_quant {weight_quant!r}")
    if backend not in ("cb", "step"):
        raise ValueError(f"unknown backend {backend!r} (cb or step)")
    dev = resolve_device(device)
    torch_dtype = getattr(torch, dtype)
    if os.path.isdir(model):
        from polyrl_tpu_torch.models.hf_loader import build_from_hf

        cfg, params = build_from_hf(model, dtype=torch_dtype,
                                    overrides=model_overrides,
                                    quantize=weight_quant, device=dev)
    else:
        cfg = decoder.get_config(model, dtype=torch_dtype,
                                 **(model_overrides or {}))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = (quant.init_quantized_params(gen, cfg) if weight_quant
                  else decoder.init_params(gen, cfg))
    if lora_rank > 0:
        # delta sync: the base (int8 with weight_quant: QLoRA serving)
        # never changes; each push replaces the adapters in place. The
        # trainer must run the same lora_rank and lora_alpha.
        from polyrl_tpu_torch.models import lora

        lgen = torch.Generator(device=dev).manual_seed(7919 + lora_rank)
        params = lora.wrap_lora(params, lgen, lora_rank, lora_alpha)
    buckets = (tuple(prompt_buckets) if prompt_buckets
               else (128, 256, 512, 1024, 2048, 4096))
    if backend == "cb":
        engine = CBEngine(
            cfg, params, pad_token_id=0, kv_cache_dtype=torch_dtype,
            max_slots=max_slots, page_size=page_size, max_seq_len=max_seq_len,
            num_pages=num_pages, steps_per_dispatch=steps_per_dispatch,
            pipeline_depth=pipeline_depth, prompt_buckets=buckets, seed=seed,
            admit_wave=admit_wave, admit_reorder_window=admit_reorder_window,
            group_share=group_share, decode_group_share=decode_group_share,
            group_preref_ttl_s=group_preref_ttl_s,
            prefill_chunk=prefill_chunk, spec_tokens=spec_tokens,
            spec_rounds=spec_rounds, salvage_partials=salvage_partials,
            kv_ledger=kv_ledger,
            kv_cold_after_dispatches=kv_cold_after_dispatches,
            kv_spill=kv_spill, kv_spill_host_gb=kv_spill_host_gb,
            loop_profile=loop_profile, device=dev)
        if warmup:
            t0 = time.monotonic()
            engine.warmup()
            log.info("warm-up took %.1f s", time.monotonic() - t0)
    else:
        kwargs = {"batch_buckets": tuple(batch_buckets)} if batch_buckets else {}
        engine = RolloutEngine(cfg, params, pad_token_id=0,
                               kv_cache_dtype=torch_dtype,
                               prompt_buckets=buckets, seed=seed, device=dev,
                               **kwargs)
    server = RolloutServer(engine, host=host, port=port,
                           advertise_host=advertise_host)
    if lora_rank > 0:
        # the wire carries the adapter tree, installed in place
        server.weight_template = lora.adapter_template(cfg, lora_rank)
        server.weight_apply = lora.apply_adapters
    elif weight_quant == "int8":
        # the wire carries the trainer's tree in the model dtype: its
        # layout comes from that tree's names, shapes and dtypes (meta
        # tensors), and each push is quantized on arrival
        server.weight_template = decoder.init_meta_params(cfg)
        server.weight_preprocess = quant.quantize_params
    server.fault = fault_injector
    server.start()
    if manager_endpoint:
        register_with_manager(server, manager_endpoint, is_local=is_local,
                              transfer_streams=transfer_streams)
    return server


def register_with_manager(server, manager_endpoint: str = "",
                          is_local: bool = False,
                          transfer_streams: int = 4,
                          client=None) -> None:
    """POST /register_rollout_instance, then start the receiver agent
    pointed at the weight sender the manager assigned (none is assigned
    while no trainer has registered a sender). ``is_local`` registers a
    local, time-sliced instance instead, with no receiver: its pushes come
    in process. Passing an existing ``client`` (``PoolManager.add_engine``
    does) registers through it, so that a bound supervisor records the
    membership for /reconcile replay."""
    from polyrl_tpu_torch.manager.client import ManagerClient

    if client is None:
        if not manager_endpoint:
            raise ValueError("register_with_manager needs an endpoint or "
                             "a client")
        client = ManagerClient(manager_endpoint)
    # the /preempt departure deregisters through this endpoint
    server.manager_endpoint = client.endpoint.replace("http://", "")
    if is_local:
        client.register_local_rollout_instances([server.endpoint])
        return
    out = client.register_rollout_instance(server.endpoint)
    sender_ep = out.get("weight_sender_endpoint") or ""
    if sender_ep:
        attach_receiver(server, sender_ep, transfer_streams)


def attach_receiver(server, sender_ep: str, transfer_streams: int = 4) -> bool:
    """Start the server's weight receiver, pointed at the weight sender
    ``sender_ep``: the fabric's idle poll then pushes it the current
    version. Returns False when the server has one already. Used by
    ``register_with_manager`` and by ``POST /attach_receiver``, through
    which ``PoolManager.add_engine(endpoint=)`` attaches the receiver of a
    server that joins by its endpoint alone."""
    from polyrl_tpu_torch.transfer.agents import ReceiverAgent
    from polyrl_tpu_torch.transfer.layout import build_layout, build_shard_spec

    if server.receiver is not None:
        return False
    # quantized and LoRA engines take another tree than their own
    template = (server.weight_template if server.weight_template
                is not None else server.engine.params)
    server.receiver = ReceiverAgent(
        build_layout(template), server.endpoint, sender_ep,
        num_streams=transfer_streams,
        advertise_host=server.endpoint.rsplit(":", 1)[0],
        shard_spec=build_shard_spec(template),
        pin_buffer=server.engine.device.type == "cuda")
    server.receiver.start()
    log.info("receiver agent attached to sender %s", sender_ep)
    return True


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="polyrl rollout server (PyTorch/CUDA)")
    p.add_argument("--model", default="qwen3-1.7b",
                   help="a preset name, or a local Hugging Face checkpoint "
                        "directory (config.json + safetensors)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=30000)
    p.add_argument("--advertise-host", default="127.0.0.1")
    p.add_argument("--manager-endpoint", default=None,
                   help="host:port of the rollout manager to register with "
                        "(and to take weight pushes through)")
    p.add_argument("--is-local", action="store_true",
                   help="register as a local, time-sliced instance (a "
                        "trainer in the same process pushes its weights)")
    p.add_argument("--transfer-streams", type=int, default=4,
                   help="parallel TCP streams of the weight receiver")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0,
                   help="random-init seed of the preset's weights")
    p.add_argument("--weight-quant", default="", choices=["", "int8"],
                   help="int8: serve int8 weight-only projections (weights "
                        "pushed in the model dtype are re-quantized)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="LoRA delta sync: serve base + adapters; pushes "
                        "carry only the adapters (match the trainer's rank)")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--max-slots", type=int, default=64)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--max-seq-len", type=int, default=16384)
    p.add_argument("--num-pages", type=int, default=None,
                   help="KV pool pages (default: half the slots at full length)")
    p.add_argument("--steps-per-dispatch", type=int, default=8,
                   help="fused decode steps per dispatch")
    p.add_argument("--pipeline-depth", type=int, default=16,
                   help="decode dispatches the engine may run ahead of "
                        "emission (0 = drain every dispatch); lower it for "
                        "tighter abort latency")
    p.add_argument("--prompt-buckets", type=int, nargs="+", default=None,
                   help="prompt-length padding buckets (default "
                        "128 256 512 1024 2048 4096)")
    p.add_argument("--admit-wave", type=int, default=None,
                   help="max admissions fused into one batched prefill (default 8)")
    p.add_argument("--admit-reorder-window", type=int, default=8,
                   help="blocked queue heads admission may skip past while "
                        "forming a wave (0 = strict FIFO)")
    p.add_argument("--no-group-share", action="store_true",
                   help="disable group-shared prefill (siblings admit alone)")
    p.add_argument("--no-decode-group-share", action="store_true",
                   help="disable shared-prefix grouped decode attention")
    p.add_argument("--group-preref-ttl-s", type=float, default=None,
                   help="sibling-wait pre-ref expiry (default 30)")
    p.add_argument("--backend", default="cb", choices=("cb", "step"),
                   help="cb = paged continuous batching, step = bucketed v0")
    p.add_argument("--warmup", action="store_true",
                   help="drive every admission variant and capture the "
                        "ungrouped and spec decode graphs at launch")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill: prompts longer than this prefill "
                        "one page-aligned chunk per engine iteration, "
                        "interleaved with decode (0 = off)")
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="prompt-lookup speculative decoding: verify this "
                        "many n-gram-proposed draft tokens per round, "
                        "distribution-exact (0 = off)")
    p.add_argument("--spec-rounds", type=int, default=2,
                   help="speculation rounds per decode dispatch")
    p.add_argument("--no-kv-ledger", action="store_true",
                   help="disable the per-page KV ledger (the memory fields "
                        "go absent from server_info; also disables the "
                        "spill tier; engine output is the same either way)")
    p.add_argument("--kv-cold-after-dispatches", type=int, default=256,
                   help="idle age (decode dispatches) past which a resident "
                        "KV page counts as cold")
    p.add_argument("--no-kv-spill", action="store_true",
                   help="disable the host-RAM KV spill tier (cold published "
                        "pages stay on the card and capacity eviction "
                        "destroys them)")
    p.add_argument("--kv-spill-host-gb", type=float, default=4.0,
                   help="host-side capacity of the KV spill tier, GB (pinned "
                        "as pages spill)")
    p.add_argument("--no-loop-profile", action="store_true",
                   help="disable the engine-loop profiler (device_frac and "
                        "the other loop fields go absent from server_info; "
                        "sampled output is the same either way)")
    return p.parse_args(argv)


def server_from_args(args: argparse.Namespace):
    """``create_server`` with the command line's settings."""
    return create_server(
        args.model, device=args.device, host=args.host, port=args.port,
        advertise_host=args.advertise_host, dtype=args.dtype, seed=args.seed,
        prompt_buckets=args.prompt_buckets, max_slots=args.max_slots,
        page_size=args.page_size, max_seq_len=args.max_seq_len,
        num_pages=args.num_pages, steps_per_dispatch=args.steps_per_dispatch,
        pipeline_depth=args.pipeline_depth, admit_wave=args.admit_wave,
        admit_reorder_window=args.admit_reorder_window,
        group_share=not args.no_group_share,
        decode_group_share=not args.no_decode_group_share,
        group_preref_ttl_s=args.group_preref_ttl_s,
        weight_quant=args.weight_quant, backend=args.backend,
        warmup=args.warmup, prefill_chunk=args.prefill_chunk,
        spec_tokens=args.spec_tokens, spec_rounds=args.spec_rounds,
        kv_ledger=not args.no_kv_ledger,
        kv_cold_after_dispatches=args.kv_cold_after_dispatches,
        kv_spill=not args.no_kv_spill, kv_spill_host_gb=args.kv_spill_host_gb,
        loop_profile=not args.no_loop_profile,
        manager_endpoint=args.manager_endpoint,
        transfer_streams=args.transfer_streams, is_local=args.is_local,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)


def main() -> None:
    args = parse_args()
    logging.basicConfig(level=logging.INFO)
    server = server_from_args(args)
    log.info("rollout server on %s (%s)", server.endpoint, server.engine.device)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
