#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``polyrl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero and prints no result
when CUDA is unavailable or any phase fails. Phases:

1. build   -- compile every kernel library from ``csrc/`` (K1-K4 and the
              fused decode prologue; one nvcc per source, all started
              together), and log each kernel's registers per thread and
              spill bytes from the compiler's ``-Xptxas -v`` report: a
              spill in a bf16 kernel fails.
2. kernels -- each kernel against its plain PyTorch version at the serving
              path's shapes (Hq 16, Hkv 8, D 128, page 64, 64 slots, bf16
              pools, lengths 1..4096, a G=8 group table with a padded -1
              seat): K1 bitwise; the fused decode prologue (qk-norm, RoPE
              and the K/V write in one kernel, K1 redesigned) with q and
              the written k rows within one bf16 ulp of each RoPE operand
              (``rope_operand_bound``), v rows and untouched rows bitwise,
              twice bitwise, a CUDA-graph replay bitwise the eager call,
              and failing with cos/sin one position late or k_norm left
              out; K2/K3 within rtol 1e-2 / atol 2e-3
              (outputs are rounded to bf16 once: one ulp is at most 2^-7
              of the value), K3 also against K2 on the full page tables,
              and K2 and K3 each twice on the same inputs, bitwise. The
              same calls with two slots missing their last page must fail
              that tolerance. K2 and K3 are also timed on the tables the
              serving phase gives them, K2 on those the train phase gives
              it, and each of their two launches (split, combine) on its
              own. K4 (training flash attention)
              through its wrapper ``flash_attention_train`` and autograd,
              forward and backward, against autograd through its plain
              version, at the train phase's shapes (B 4, T 512, Hq 16,
              Hkv 8, D 128, bf16) and at a long case (B 1, T 4096),
              with left- and right-padded rows and a row packed with 3
              segments: out within rtol 1e-2 / atol 2e-3, each of dq, dk,
              dv within a relative Frobenius error of 1e-2; the kernel
              with each row's first real token marked as pad must fail
              both; at the train shapes K4's backward run twice on the
              same inputs must give bitwise equal dq, dk, dv (no atomics,
              a fixed summation order). Times are device time per call:
              CUDA events around replays of a CUDA graph of back-to-back
              calls, median over several replays (backward passes through
              autograd -- the plain version's and SDPA's -- by CUDA events
              around back-to-back calls queued behind a spin kernel
              instead); K4's backward is also timed kernel by kernel.
3. serve   -- ``create_server("qwen3-1.7b", device="cuda")`` at full width
              and depth with random weights from a seed; over HTTP, the
              main path: two GRPO groups of 8 samples (temperature 1.0,
              64 new tokens) sharing a ~200-token prompt plus two
              ungrouped greedy requests of 128 new tokens (decode with a
              live group goes through K3, ungrouped decode through K2),
              then one greedy request sent twice alone (same tokens).
              Launch counts are zeroed just before the main path and read
              just after it: every kernel must have launched (the mix's
              own are reported apart: whether its greedy tail outlives
              the groups depends on admission). The greedy request's
              logprobs are held against the port's dense ``forward`` on the
              card; sent again with the engine's decode attention missing
              each slot's last page, it must fail that check. The main
              path must take the fused prologue, never the standalone K1.
              The engine runs up to 16 dispatches ahead of emission and
              replays each decode dispatch from its key's CUDA graph. Run
              ahead against synchronous: the mix again at
              pipeline_depth 0, whose greedy streams must give the same
              tokens and logprobs bitwise where both runs admitted them
              in waves of one kind, size and prompt bucket (within 1e-3
              nats elsewhere), then once more at depth 16 under
              torch.profiler for the device's busy share; dispatches,
              replays, captures and host ms per dispatch are logged.
              Then the decode step's A/B (``decode_ab``) at the serving
              tables on the served weights: the default (fused) route
              against ``kv_write_fn=paged_kv_write`` (eager qk-norm and
              RoPE, then K1: that kernel's path), log-softmax within 0.1
              nats from the same pools and inputs, and the fused route
              captured as a CUDA graph (``graph``, a replay bitwise the
              eager step); then 50 steps of each in turns: wall and
              device ms and kernels per step. Then the engine's dispatch
              graph against its eager body (``engine_graph_checks``) on
              an engine of the served weights that admitted a greedy
              group, a sampled group (filters on) and two greedy
              requests: for an ungrouped key (K2) and a grouped key (K3),
              a replay bitwise the eager body from one snapshot (tokens,
              logprobs, done, state, pools), every sampled token in its
              filtered set with its logprob the filtered log-softmax's
              within 1e-5, one generator state giving the same tokens
              twice and the next replay other ones; and the profiler's
              count of the port's kernels over 3 replays equal to what
              the replays credited to the launch counts.
4. memory  -- the engine's memory plane on ``qwen3-1.7b`` at full width
              and depth (bf16, weights from seed 0): a capped engine of 8
              slots and 96 pages (0.70 GB of KV; pages cold after 4 idle
              dispatches; a 2 GB host spill tier) serves 16 greedy
              sessions of 512 random tokens and 64 new ones in two rounds
              of 8, then resumes each alone with its own prompt, so that
              published pages spill to pinned host buffers (gather on the
              compute stream, device-to-host on a copy stream) and restore
              in place on the prefix hit. Gates: at least 32 pages spilled
              and 32 restored; the streams bitwise a never-spilling
              engine's (1,024 pages) on the same requests, or the break
              named with equal tokens and logprobs within 5e-4; the same
              capped run with ``kv_spill=False`` equal tokens, logprobs
              within 5e-4 (its evicted prefixes prefill again instead of
              attaching); at quiescence the ledger reconciled (1.0: its
              roles the allocator's free list plus the cache's entries,
              spilled ones included), the flight deck's tokens reconciled,
              the loop profiler's attribution <= 1 + 1e-6 and accounting
              plus spill sweep under 15% of the loop's busy wall; the
              pools at their addresses and no decode graph captured again
              after the restores; a grouped mix (2 GRPO groups of 8,
              greedy, on two spilled 7-page prefixes) against the
              never-spilling engine, tokens equal or parting at a logged
              near-tie, logprobs within 5e-4; the fused prologue, K2 and
              K3 launched. Logs spill and restore GB/s (forced, and the
              sessions' own copies timed by events on the card), spills
              refused on a full copy lane, peak pinned bytes,
              ``kv_spilled_frac``, ``kv_restore_rate``, HBM use and
              headroom, and the profiler's device/accounting/idle
              fractions beside torch.profiler's busy share. Then the serve
              phase's mix on its engine with every plane on against
              ``kv_ledger=False, loop_profile=False``, 5 runs each in
              turns: median and range of tok/s, of host ms per dispatch in
              the launch and in the whole decode pass less its drains, and
              the profiler's accounting ms per dispatch; and the device
              memory peak of one full spill sweep on that engine's 2,048
              pages.
5. train   -- ``build_trainer`` of ``polyrl_tpu_torch.train``:
              ``qwen3-1.7b`` at full width and depth in bf16, random
              weights from seed 0, the colocated CB engine (64 slots,
              page 64, 512 pages), 2 GRPO steps of 2 prompts x 8 samples
              at T = 64 + 448, KL loss against a reference policy, remat
              on, a reward that varies within a group (the response's
              byte length). Gates: finite losses and grad norms, no
              skipped updates, weight_version 3 and the engine's weights
              bitwise the actor's, K4 fwd/bwd, the fused prologue and K2
              launched (counted from zero just before the fit; graph
              replays credit their captured launches), the trainer's step-1 old
              logprobs (K4) against the engine's rollout logprobs (paged
              decode), and the full-model loss gradient of one micro of
              step 1 on step 1's weights (the update's own gradient)
              through K4 against the same through the plain attention
              (cosine >= 0.98 on the bf16 weights, >= 0.99 on an f32
              copy; norm ratio within 2%). Each must fail with K4 fed
              tile-local segment ids (every query loses the keys of
              earlier tiles). ``--grad-seeds 1,2,...`` then reads the
              gradient gate again after the same fit at each of those
              ``trainer.seed`` values and logs the spread (not gated).
6. ppo     -- ``build_trainer`` again, on the slice's other half: PPO
              with a critic (GAE) on packed rows (pack_len 1024, 4 rows
              per micro), pipelined one step ahead (staleness limit 1,
              truncated importance correction), validation before
              training and after every step (8 arithmetic prompts,
              greedy); ``qwen3-1.7b`` at full width and depth in bf16, 2
              steps of 2 prompts x 8 samples, responses of 256 tokens.
              Gates: the fused prologue, K2 and K4 (forward and
              backward) launched,
              counted from zero; most packed rows carry 2 or more
              segments; the step-1 packed old logprobs within 0.2 nats of
              a padded pass over the same trajectories, and the packed
              values within PACKED_VALUE_TOL of the padded ones, while the
              same packs with each row's segments collapsed into one
              must fail the logprob gate; finite losses and grad norms,
              both grad norms > 0, no skipped update; step 2's tokens at
              most ``staleness_limit`` versions behind the weights they
              are trained against, each trajectory's versions (the
              version of each token's dispatch) never decreasing,
              finite importance weights <= the cap,
              and the engine bitwise the actor after the fit; validation
              finite, and twice on the same weights equal. Then on a
              depth-2 copy of the same widths: save at step 1, a fresh
              trainer resumes (step, dataloader and every parameter and
              optimizer tensor of actor and critic bitwise) and trains
              step 2; the host snapshot pageable against pinned staging
              buffers in turns. K4 is then timed at the packed rows'
              shapes and segment ids. ``--ppo-ab`` also runs the
              configuration without validation, unpipelined against
              pipelined in turns, for their step walls.
7. hf      -- ``qwen3-1.7b`` at full width and depth from seed 0 written
              as a Hugging Face checkpoint (two bf16 safetensors shards,
              the index, ``config.json``) into a temp dir and loaded back
              by ``build_from_hf`` on the card: the config and every leaf
              bitwise; the int8 load's seconds and bytes;
              ``create_server(model=<dir>)`` serves greedy tokens equal
              to the preset's on the seeded tree.
8. quant   -- ``quant.quantize_tensor`` on the card bitwise the same call
              on the host (int8 entries and f32 scales) on every
              projection of the seeded tree (the hf phase's host int8
              load likewise); then
              ``create_server("qwen3-1.7b", weight_quant="int8")`` serves
              the serve phase's mix and then a greedy request twice alone
              over HTTP (the fused prologue, K2 and K3 launched, counted
              from zero over both); the greedy runs the same tokens, their
              logprobs within 0.15 nats of the dense f32
              forward on the dequantized weights; a bf16
              ``update_weights`` refused and the same tree re-quantized
              through the server's ``weight_preprocess`` serving the same
              tokens; the decode step by graph replay, bf16 against int8
              (each replay bitwise its eager step): kernels, device and
              wall ms, the graph pool's growth.
9. lora    -- the train phase's configuration with ``actor.lora_rank=16``
              (2 GRPO steps): frozen leaves bitwise, every ``b`` moved,
              the engine bitwise ``merge_lora(actor.params)`` after each
              push, old logprobs within 0.2 nats of the engine's, K4
              forward and backward launched; trainable count, optimizer
              bytes, step walls and peak. Then optimizer offload: two
              full-width AdamW steps with offload bitwise the same
              without it, and the train phase's fit with
              ``actor.offload_optimizer=true trainer.profile_steps=2``:
              memory each offload frees, offload and load seconds, and a
              torch.profiler trace of step 2 naming K4's kernels.
10. features -- the CB engine's serving features on ``qwen3-1.7b`` at full
              width and depth (bf16, weights from seed 0, 64 slots, page
              64, 2,048 pages, run-ahead depth 16). salvage: a greedy
              stream of budget 400 aborted after its 5th token delivers
              every token of the dispatches issued for it before the
              ``abort`` terminal (1 + 8 per dispatch), ``tokens_salvaged``
              is what the drain delivered, and prompt + partial
              resubmitted hits the salvage-published pages and stitches to
              the uninterrupted run up to its first near-tie (a top-2
              logit gap under 0.05 in the dense forward); abort-to-terminal
              latency with salvage on and off in turns. chunked: a
              3,000-token prompt with ``prefill_chunk`` 512 against 0,
              first-token logprobs within 0.05 nats and greedy tokens
              equal up to the first near-tie, the peak memory of each; with
              16 greedy streams decoding, a decode dispatch between
              consecutive chunks and the streams' tok/s over the
              admission. spec: ``spec_tokens`` 4, ``spec_rounds`` 2 on the
              serve mix plus a repetitive greedy prompt, in turns with the
              plain engine: greedy streams equal up to the first
              near-tie, within 0.15 nats of the dense f32 forward, launches
              from zero (the fused prologue and K2, no K3), the spec
              dispatch's replay bitwise its eager body, the sampled verify
              rows inside their filtered sets, acceptance, tok/s and
              device ms per dispatch against the plain 8-step dispatch.
              warmup/release: over HTTP, release frees at least 14 GB and
              the captured graphs, resume, ``warmup()`` captures every
              decode key up front (the mix then captures none; its TTFT
              against the serve phase's), and the same greedy request is
              bitwise the one before release; the allocator whole after
              ``stop()``.
11. step   -- the step backend: ``RolloutEngine.generate`` on 16 prompts of
              128 tokens x 256 new tokens, greedy, against ``CBEngine`` (one
              run each, in one call): the same tokens up to the first near-tie, logprobs
              within 0.15 nats of the dense f32 forward, tok/s of each; a
              ``backend="step"`` server streams what its engine's
              ``generate`` gives; 2 GRPO steps through ``build_trainer``
              with ``rollout.backend=step`` at the train phase's
              configuration (finite losses, grad norms > 0, K4 launched).
12. disagg -- the disaggregated rollout: the port's C++ manager (its copy
              of the sources, built by ``g++`` into the git-ignored build
              directory) spawned supervised; ``build_trainer`` with
              ``rollout.mode=disaggregated`` and the train phase's
              configuration (its weight sender registered first); then the
              rollout server as a subprocess (``python -m
              polyrl_tpu_torch.rollout.serve --model qwen3-1.7b
              --num-pages 512 --manager-endpoint ...``, bf16, on the card), whose
              receiver connects to that sender. 2 GRPO steps stream their
              groups back through the manager, each push goes over the TCP
              fabric (pack device to host, wire, install host to device,
              swap in place). Gates: finite losses, grad norms > 0; every
              push verified, none failed or retried; the server's
              ``weight_version`` at 1 + the steps; every streamed token
              tagged with its stream's version (staleness limit 1); a GRPO
              group of 8 on a 100-token prompt through the manager; after
              the last push a greedy request through the manager equal to
              an in-process ``CBEngine`` on the trainer's final parameters
              (or parting only at a near-tie), within 0.15 nats of the
              dense f32 forward; launches counted from zero: the fused
              prologue, K2 and K3 in the server process (its
              ``/get_server_info``), K4 forward and backward in the
              trainer's and no decode kernel there. Logs each push's
              split with GB/s, the version-raise latency, the step walls
              against the train phase's, the bubble, ``max_local_gen_s``,
              both processes' peak memory, and each step's generation as
              the server saw it (its ``/get_server_info`` polled every
              50 ms: the version's raise, the first admission, the first
              and last token, tok/s, graph captures). Then an int8 server
              (``--weight-quant int8``) joins and takes one push of the
              trainer's bf16 tree over the fabric, re-quantized on
              arrival: a greedy request on it equals an in-process int8
              ``CBEngine`` on ``quant.quantize_params`` of that tree (or
              parts only at a near-tie), within 0.15 nats of the dense f32
              forward on the dequantized weights. The balancer's feed: the
              server reports ``occupancy`` and ``device_frac`` (polled
              through the fit and logged), every step record carries the
              pool's ``engine/occupancy`` (> 0) and ``engine/device_frac``,
              the next step's balancer round passes them on, and a non-zero
              one of each reaches the estimator. Any failure (the
              manager's build, a server's death, a push) fails the smoke.
13. result -- the card's name and power limit, a ``{"kernels": [...]}``
              line (the launches of each kernel's paths: serve or the A/B,
              memory, train, and disagg), and last ``{"ok": true, "device":
              {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import http.client
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops import flash
from polyrl_tpu_torch.ops import norm_rope
from polyrl_tpu_torch.ops import paged_attention as pa

MODEL = "qwen3-1.7b"
HQ, HKV, D, PS, S = 16, 8, 128, 64, 64
P = 4096 // PS                 # page-table columns (max_seq_len 4096)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak, same source
# K2/K3 against their plain versions: both round their f32 result to bf16
# once, so they may differ by one bf16 ulp (at most 2^-7 of the value, under
# rtol); atol covers outputs near zero (half a bf16 ulp at 1 is 2^-9)
KERNEL_TOL = dict(rtol=1e-2, atol=2e-3)
# engine logprobs vs the dense forward with f32 weights and activations, in
# nats: the engine runs bf16 activations through 28 layers, and the bf16
# dense forward itself lands about 0.08 nats from f32 at the worst of 64
# tokens; the limit is about twice that
DENSE_LOGP_TOL = 0.15
# K4 against its plain version: out as K2/K3 (bf16 output rounded once);
# each gradient by relative Frobenius error, which a one-ulp bf16 rounding
# of every element keeps near 2^-9
FLASH_OUT_TOL = dict(rtol=1e-2, atol=2e-3)
FLASH_GRAD_TOL = 1e-2
# the fused decode prologue against its plain chain: q and the written k
# rows within one bf16 ulp (2^-7 of the value) of each RoPE operand and of
# the result (``rope_operand_bound``); v rows and untouched rows bitwise
FUSED_REL = 2.0 ** -7
# the decode step's two routes (fused prologue; eager qk-norm/RoPE + K1)
# from the same pools and inputs, log-softmax over the vocabulary of the
# live slots, in nats: both round q and k to bf16 at the same points, and
# differ where the sum of squares flips a rounding (one ulp), compounded
# through 28 layers
DECODE_AB_TOL = 0.1
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores, same source
REPLACES = {
    "paged_kv_write": "polyrl_tpu/ops/paged_attention.py:672",
    "paged_kv_write_fused": "polyrl_tpu/ops/paged_attention.py:672 with the "
                            "qk-norm and RoPE of polyrl_tpu/models/decoder.py:731-735",
    "paged_attention": "polyrl_tpu/ops/paged_attention.py:160",
    "grouped_paged_attention": "polyrl_tpu/ops/paged_attention.py:462",
    "flash_attention_fwd": "polyrl_tpu/ops/flash.py:60",
    "flash_attention_bwd": "polyrl_tpu/ops/flash.py:60",
}
# the kernels each phase's main path must launch (the standalone K1 is on
# the decode step's unfused route, driven by the serve phase's A/B)
SERVE_KERNELS = ("paged_kv_write_fused", "paged_attention",
                 "grouped_paged_attention")
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                 "paged_kv_write_fused", "paged_attention")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, inner: int = 1, warmup: int = 2) -> float:
    """Per-call device ms: a CUDA graph of ``inner`` back-to-back calls is
    replayed between CUDA events, elapsed / inner, median over ``reps``
    replays. The graph takes the host's launch cost out: a kernel of a few
    microseconds would otherwise be timed at the rate Python issues it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOPS
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels at the serving path's shapes ------------------------------


def kernel_case(dev):
    """Pools, per-slot page tables and a grouped table. Slots 0..30 sit in
    four GRPO groups (three of 8, one of 7 padded to 8 with a -1 seat)
    that share 32/16/8/4-page prompt chains; slots 31..63 are ungrouped."""
    rng = np.random.default_rng(0)
    groups = [(8, 32), (8, 16), (8, 8), (7, 4)]   # (members, prefix pages)
    lens, rows, pre_pages, seats = [], [], [], []
    next_page = 1

    def take(n):  # sequential ids here, shuffled over the pool below
        nonlocal next_page
        next_page += n
        return list(range(next_page - n, next_page))

    for g, n_pre in groups:
        chain = take(n_pre)
        pre_pages.append(chain)
        seat = []
        for _ in range(g):
            ln = n_pre * PS + int(rng.integers(1, 513))
            own = take(-(-ln // PS) - n_pre)
            seat.append(len(rows))
            rows.append(chain + own)
            lens.append(ln)
        seats.append(seat)
    while len(rows) < S:
        ln = int(rng.integers(1, 4097))
        rows.append(take(-(-ln // PS)))
        lens.append(ln)
    lens[31], lens[32], lens[33] = 1, 4096, 65   # edges: 1 token, full row
    rows[31], rows[32], rows[33] = take(1), take(64), take(2)
    n_pool = next_page
    perm = np.concatenate([[0], rng.permutation(np.arange(1, n_pool))])
    rows = [[int(perm[x]) for x in r] for r in rows]
    pre_pages = [[int(perm[x]) for x in r] for r in pre_pages]
    table = np.zeros((S, P), np.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    ng, gmax, p_pre = 4, 8, 32
    g_slots = np.full((ng, gmax), -1, np.int32)
    g_pages = np.zeros((ng, p_pre), np.int32)
    g_lens = np.zeros((ng,), np.int32)
    for i, (seat, chain) in enumerate(zip(seats, pre_pages)):
        g_slots[i, :len(seat)] = seat
        g_pages[i, :len(chain)] = chain
        g_lens[i] = len(chain) * PS
    gen = torch.Generator(device=dev).manual_seed(0)
    pool_shape = (HKV, n_pool, PS, D)
    kp = torch.randn(pool_shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(pool_shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((S, HQ, D), generator=gen, device=dev, dtype=torch.bfloat16)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(q=q, kp=kp, vp=vp, table=t(table),
                lens=t(np.asarray(lens, np.int32)), g_slots=t(g_slots),
                g_pages=t(g_pages), g_lens=t(g_lens), lens_np=np.asarray(lens),
                g_lens_np=g_lens, seats=seats)


def rope_operand_bound(n, cos, sin, ref, rel):
    """Elementwise limit for a RoPE output whose operands may each sit one
    ulp (``rel`` of their value) from the plain chain's: out1 = n1 cos -
    n2 sin and out2 = n2 cos + n1 sin move by at most rel * (|n1 cos| +
    |n2 sin|) (resp. |n2 cos| + |n1 sin|), and rounding the result adds
    rel * |out|. ``n`` [S, H, D] holds the operands (the normalised rows
    as the plain chain rounds them), ``cos``/``sin`` [S, D/2]. A limit of
    ``rel * |ref|`` alone fails a healthy kernel wherever the two products
    cancel and the f32 sum of squares, summed in another order, flips one
    bf16 rounding of an operand. 1e-6 covers values near 0."""
    h = n.shape[-1] // 2
    n1, n2 = n[..., :h].float().abs(), n[..., h:].float().abs()
    c, s = cos.float().abs()[:, None], sin.float().abs()[:, None]
    scale = torch.cat([n1 * c + n2 * s, n2 * c + n1 * s], dim=-1)
    return rel * (scale + ref.float().abs()) + 1e-6


def fused_inputs(dev, c) -> dict:
    """The fused prologue's operands at the kernel case: the projected q,
    k, v rows of 64 slots (bf16), qwen3-1.7b's qk-norm weights (1 + 0.1
    noise) and RoPE at each slot's position, written at that position in
    the slot's page row: at its last cached position, so every target is
    a row of its own. Slot 5 is inactive (page 0, offset 0); slots 6 and 7
    sit at offset 0 and PS - 1 of their last page."""
    cfg = decoder.get_config(MODEL)
    gen = torch.Generator(device=dev).manual_seed(3)
    pos = (c["lens"].long() - 1).clamp(min=0)
    start = pos[6:8] // PS * PS
    pos[6], pos[7] = start[0], start[1] + PS - 1
    page = c["table"][torch.arange(S, device=dev), pos // PS].int()
    off = (pos % PS).int()
    page[5], off[5] = 0, 0
    cos, sin = decoder.rope_cos_sin(cfg, pos[:, None])

    def r(*shape, scale=1.0, base=0.0):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (base + scale * x).to(torch.bfloat16)

    return dict(write_page=page, write_off=off, q=r(S, HQ * D), k=r(S, HKV * D),
                v=r(S, HKV * D), cos=cos[:, 0], sin=sin[:, 0],
                q_norm=r(D, scale=0.1, base=1.0), k_norm=r(D, scale=0.1, base=1.0),
                eps=cfg.rms_norm_eps, pos=pos)


def fused_gate(a: dict, out: tuple, ref: tuple, pools: tuple) -> dict:
    """``out`` and ``ref`` (q, k_pool, v_pool) of the fused prologue on
    ``a``, from the same ``pools``: q and the written k rows within
    ``rope_operand_bound`` (the ratio of |diff| to it must stay <= 1), the
    v pool bitwise, every other k row bitwise the original. Returns the
    readings and ``ok``."""
    q, kp, vp = out
    rq, rk, rv = ref
    s, hq, d = rq.shape
    hkv, n = kp.shape[:2]
    eps = a["eps"]
    n_q = norm_rope.rms_norm(a["q"].reshape(s, 1, hq, d), a["q_norm"], eps)[:, 0]
    n_k = norm_rope.rms_norm(a["k"].reshape(s, 1, hkv, d), a["k_norm"], eps)[:, 0]
    rows = ((torch.arange(hkv, device=q.device)[:, None] * n
             + a["write_page"].long()[None]) * PS + a["write_off"].long()[None])
    got_k = kp.view(-1, d)[rows].transpose(0, 1)   # [S, Hkv, D]
    ref_k = rk.view(-1, d)[rows].transpose(0, 1)
    err_q = (q.float() - rq.float()).abs()
    err_k = (got_k.float() - ref_k.float()).abs()
    ratio_q = (err_q / rope_operand_bound(n_q, a["cos"], a["sin"], rq,
                                          FUSED_REL)).max().item()
    ratio_k = (err_k / rope_operand_bound(n_k, a["cos"], a["sin"], ref_k,
                                          FUSED_REL)).max().item()
    plain_ulp = int((err_q > FUSED_REL * rq.float().abs() + 1e-6).sum()
                    + (err_k > FUSED_REL * ref_k.float().abs() + 1e-6).sum())
    untouched = torch.ones(kp.view(-1, d).shape[0], dtype=torch.bool,
                           device=kp.device)
    untouched[rows.reshape(-1)] = False
    rest_ok = torch.equal(kp.view(-1, d)[untouched], pools[0].view(-1, d)[untouched])
    v_ok = torch.equal(vp, rv)
    return dict(ok=ratio_q <= 1 and ratio_k <= 1 and rest_ok and v_ok,
                ratio_q=ratio_q, ratio_k=ratio_k, rest_ok=rest_ok, v_ok=v_ok,
                max_abs_err=max(err_q.max().item(), err_k.max().item()),
                plain_ulp=plain_ulp)


def check_fused(dev, c, empty: float) -> dict:
    """The fused decode prologue (K1 redesigned) at the kernel case,
    against its plain chain: the gate of ``fused_gate``, two calls bitwise
    equal, one replay of a CUDA-graph capture bitwise the eager call; the
    gate must fail with cos/sin of position + 1 and with k_norm left out.
    Times by graph replay: the kernel, its plain chain, and the decode
    step's unfused route (eager qk-norm and RoPE, then K1)."""
    a = fused_inputs(dev, c)
    base = (c["kp"], c["vp"])
    args = {k_: a[k_] for k_ in ("write_page", "write_off", "q", "k", "v",
                                 "cos", "sin", "q_norm", "k_norm", "eps")}

    def run(fn, **over):
        kp, vp = base[0].clone(), base[1].clone()
        q = fn(kp, vp, **dict(args, **over))
        return q, kp, vp

    ref = run(pa.paged_kv_write_fused_ref)
    out = run(pa.paged_kv_write_fused)
    torch.cuda.synchronize()
    g = fused_gate(a, out, ref, base)
    check(g["ok"], f"paged_kv_write_fused differs from its plain version: {g}")
    again = run(pa.paged_kv_write_fused)
    check(all(torch.equal(x, y) for x, y in zip(out, again)),
          "paged_kv_write_fused differs between two calls on the same inputs")
    del again
    gk, gv = base[0].clone(), base[1].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gq = pa.paged_kv_write_fused(gk, gv, **args)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(gq, out[0]) and torch.equal(gk, out[1])
          and torch.equal(gv, out[2]),
          "paged_kv_write_fused: a graph replay differs from the eager call")
    del graph, gq, gk, gv
    # the gate's power: RoPE one position late, and k not normalised
    cfg = decoder.get_config(MODEL)
    cos1, sin1 = decoder.rope_cos_sin(cfg, a["pos"][:, None] + 1)
    faults = {"cos/sin of position + 1": dict(cos=cos1[:, 0], sin=sin1[:, 0]),
              "k_norm left out": dict(k_norm=None)}
    fault_lines = []
    for label, over in faults.items():
        fg = fused_gate(a, run(pa.paged_kv_write_fused, **over), ref, base)
        check(not fg["ok"], f"the fused gate passes a planted fault: {label}")
        fault_lines.append(f"{label}: q {fg['ratio_q']:.3g}, k {fg['ratio_k']:.3g}")
    log(f"kernel paged_kv_write_fused: max_abs_err {g['max_abs_err']:.3g}; "
        f"|diff| / one-ulp-of-the-RoPE-operands limit: q {g['ratio_q']:.3f}, k "
        f"{g['ratio_k']:.3f} (<= 1); {g['plain_ulp']} elements beyond one ulp "
        f"of the result alone (RoPE cancellation); v rows and untouched rows "
        f"bitwise; twice bitwise; graph replay bitwise; planted faults (limit "
        f"ratios, must exceed 1): " + "; ".join(fault_lines))

    kp, vp = base[0].clone(), base[1].clone()
    ms = cuda_ms(lambda: pa.paged_kv_write_fused(kp, vp, **args), 20, inner=20)
    plain = cuda_ms(lambda: pa.paged_kv_write_fused_ref(kp, vp, **args), 20,
                    inner=20)
    q4 = a["q"].reshape(S, 1, HQ, D)
    k4 = a["k"].reshape(S, 1, HKV, D)
    v3 = a["v"].reshape(S, HKV, D)
    cos3, sin3 = a["cos"][:, None], a["sin"][:, None]

    def unfused():  # forward_paged_decode with kv_write_fn=paged_kv_write
        qn = norm_rope.rms_norm(q4, a["q_norm"], a["eps"])
        kn = norm_rope.rms_norm(k4, a["k_norm"], a["eps"])
        qr = norm_rope.apply_rope(qn, cos3, sin3)
        kr = norm_rope.apply_rope(kn, cos3, sin3)
        pa.paged_kv_write(kp, vp, a["write_page"], a["write_off"], kr[:, 0], v3)
        return qr

    route = cuda_ms(unfused, 20, inner=20)
    es = 2
    n_bytes = ((S * (HQ + 2 * HKV) * D + 2 * D) * es + S * D * 4 + 2 * S * 4
               + (S * HQ * D + 2 * S * HKV * D) * es)
    flops = 10.0 * S * (HQ + HKV) * D  # square-sum, scale, weight, rotate
    b, how = bound_ms(n_bytes, flops, F32_FLOPS)
    log(f"kernel paged_kv_write_fused: {ms:.5f} ms = {ms / empty:.2f} x the "
        f"empty kernel ({empty:.5f}); bound {b:.5f} ms ({how}, {n_bytes} B); "
        f"plain chain {plain:.5f} ms; the unfused route (eager qk-norm and "
        f"RoPE, then K1) {route:.5f} ms")
    return dict(name="paged_kv_write_fused", max_abs_err=g["max_abs_err"],
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=how,
                library_ms=None)


def check_kernels(dev) -> list[dict]:
    c = kernel_case(dev)
    q, kp, vp, table, lens = c["q"], c["kp"], c["vp"], c["table"], c["lens"]
    gargs = (c["g_slots"], c["g_pages"], c["g_lens"])
    lens_np = c["lens_np"]
    es = 2  # bf16 bytes
    rows = []

    # K1: one decode step's K/V rows into each slot's next position
    k_upd = torch.randn((S, HKV, D), device=dev, dtype=torch.bfloat16)
    v_upd = torch.randn_like(k_upd)
    pos = torch.clamp(lens, max=P * PS - 1)
    page = table[torch.arange(S, device=dev), (pos // PS).long()].int()
    off = (pos % PS).int()
    page[5] = 0  # an inactive slot routed to the null page
    off[5] = 0
    ref_k, ref_v = kp.clone(), vp.clone()
    pa.paged_kv_write_ref(ref_k, ref_v, page, off, k_upd, v_upd)
    out_k, out_v = kp.clone(), vp.clone()
    pa.paged_kv_write(out_k, out_v, page, off, k_upd, v_upd)
    torch.cuda.synchronize()
    check(torch.equal(out_k, ref_k) and torch.equal(out_v, ref_v),
          "paged_kv_write differs from its plain version")
    del ref_k, ref_v
    ms = cuda_ms(lambda: pa.paged_kv_write(out_k, out_v, page, off, k_upd,
                                           v_upd), 20, inner=20)
    plain = cuda_ms(lambda: pa.paged_kv_write_ref(out_k, out_v, page, off,
                                                  k_upd, v_upd), 20, inner=20)
    flat_k = out_k.view(-1, D)
    flat_v = out_v.view(-1, D)
    head_off = torch.arange(HKV, device=dev)[:, None] * (out_k.shape[1] * PS)
    idx = (head_off + (page.long() * PS + off.long())[None, :]).reshape(-1)
    rk = k_upd.transpose(0, 1).reshape(-1, D)
    rv = v_upd.transpose(0, 1).reshape(-1, D)
    lib = cuda_ms(lambda: (flat_k.index_copy_(0, idx, rk),
                           flat_v.index_copy_(0, idx, rv)), 20, inner=20)
    b, how = bound_ms(4 * S * HKV * D * es + 2 * S * 4, 0.0)
    rows.append(dict(name="paged_kv_write", max_abs_err=0.0, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=how, library_ms=lib))
    # K1's launch floor: the device time of an empty kernel (a spin of 0
    # cycles) and of a one-element add, timed as K1 is
    one = torch.zeros(1, device=dev)
    empty = cuda_ms(lambda: torch.cuda._sleep(0), 20, inner=20)
    add1 = cuda_ms(lambda: one.add_(1.0), 20, inner=20)
    log(f"kernel paged_kv_write: launch floor by CUDA-graph replay: empty "
        f"kernel {empty:.5f} ms, one-element add {add1:.5f} ms; K1 "
        f"{ms:.5f} ms = {ms / empty:.2f} x the empty kernel (bound {b:.5f})")
    del out_k, out_v
    rows.append(check_fused(dev, c, empty))

    # K2: decode attention over the full page rows
    out2 = pa.paged_attention(q, kp, vp, table, lens)
    ref2 = pa.paged_attention_ref(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    err2 = (out2.float() - ref2.float()).abs().max().item()
    check(torch.allclose(out2.float(), ref2.float(), **KERNEL_TOL),
          f"paged_attention differs from its plain version (max {err2})")
    check(torch.equal(out2, pa.paged_attention(q, kp, vp, table, lens)),
          "paged_attention differs between two calls on the same inputs")
    toks = int(np.maximum(lens_np, 1).sum())
    io = 2 * S * HQ * D * es + S * 4 + 4 * int(np.ceil(np.maximum(lens_np, 1) / PS).sum())
    b, how = bound_ms(io + 2 * HKV * D * es * toks, 4.0 * HQ * D * toks)
    rows.append(dict(
        name="paged_attention", max_abs_err=err2,
        ms=cuda_ms(lambda: pa.paged_attention(q, kp, vp, table, lens), 10,
                   inner=5),
        plain_ms=cuda_ms(lambda: pa.paged_attention_ref(q, kp, vp, table, lens), 5),
        bound_ms=b, bound_by=how, library_ms=None))

    # K3: grouped two-phase attention, against its plain version and K2
    out3 = pa.grouped_paged_attention(q, kp, vp, table, lens, *gargs)
    ref3 = pa.grouped_paged_attention_ref(q, kp, vp, table, lens, *gargs)
    torch.cuda.synchronize()
    err3 = (out3.float() - ref3.float()).abs().max().item()
    check(torch.allclose(out3.float(), ref3.float(), **KERNEL_TOL),
          f"grouped_paged_attention differs from its plain version (max {err3})")
    err32 = (out3.float() - out2.float()).abs().max().item()
    check(torch.allclose(out3.float(), out2.float(), **KERNEL_TOL),
          f"grouped_paged_attention differs from paged_attention (max {err32})")
    check(torch.equal(out3, pa.grouped_paged_attention(q, kp, vp, table, lens, *gargs)),
          "grouped_paged_attention differs between two calls on the same inputs")
    log("kernel paged_attention, grouped_paged_attention: two calls on the "
        "same inputs give bitwise equal outputs")
    # the tolerance's power: the full 4,096-token row (slot 32) and a grouped
    # slot each missing their last page must fail it
    cut = lens.clone()
    for i in (32, c["seats"][0][0]):
        cut[i] -= (cut[i] - 1) % PS + 1
    miss = []
    for name, fn, ref in (
            ("paged_attention", lambda: pa.paged_attention(
                q, kp, vp, table, cut), ref2),
            ("grouped_paged_attention", lambda: pa.grouped_paged_attention(
                q, kp, vp, table, cut, *gargs), ref3)):
        bad = fn().float()
        miss.append(f"{name} {(bad - ref.float()).abs().max().item():.3g}")
        check(not torch.allclose(bad, ref.float(), **KERNEL_TOL),
              f"{name}: the tolerance passes a missing page")
    del ref2, ref3
    pre_tok = sum(int(x) for x in c["g_lens_np"])
    own_tok = 0  # tokens each slot reads past its group's shared prefix
    for s in range(S):
        n_pre = 0
        for gi, seat in enumerate(c["seats"]):
            if s in seat:
                n_pre = int(c["g_lens_np"][gi])
        own_tok += int(max(lens_np[s], 1)) - n_pre
    io3 = io + 4 * (c["g_slots"].numel() + c["g_pages"].numel() + 4)
    b, how = bound_ms(io3 + 2 * HKV * D * es * (pre_tok + own_tok),
                      4.0 * HQ * D * toks)
    rows.append(dict(
        name="grouped_paged_attention", max_abs_err=err3,
        ms=cuda_ms(lambda: pa.grouped_paged_attention(q, kp, vp, table, lens,
                                                      *gargs), 10, inner=5),
        plain_ms=cuda_ms(lambda: pa.grouped_paged_attention_ref(
            q, kp, vp, table, lens, *gargs), 5),
        bound_ms=b, bound_by=how, library_ms=None))
    for r in rows:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
            f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']}")
    log(f"kernel grouped_paged_attention vs paged_attention: max_abs_err {err32:.3g}")
    log(f"kernel gate power: max_abs_err with two slots missing their last "
        f"page: {', '.join(miss)} (each fails the tolerance)")
    log("kernel case by launch: " + launch_times(q, kp, vp, table, lens, gargs))
    serving_times(dev, kp, vp)
    train_table_times(dev, kp, vp)
    return rows


def launch_times(q, kp, vp, table, lens, gargs) -> str:
    """Device ms of each of K2's and K3's two launches (split, combine),
    through the wrappers' launchers, which count no launches; K2 alone
    without ``gargs``."""
    parts = []
    cases = [("paged_attention", pa.paged_attention_launcher(q, kp, vp, table, lens))]
    if gargs is not None:
        cases.append(("grouped_paged_attention", pa.grouped_paged_attention_launcher(
            q, kp, vp, table, lens, *gargs)))
    for name, (out, run) in cases:
        run(1)
        ms = {part: cuda_ms(lambda: run(phases), 10, inner=10)
              for part, phases in (("split", 1), ("combine", 2))}
        parts.append(f"{name} split {ms['split']:.4f}, combine {ms['combine']:.4f}")
        del out
    return "; ".join(parts)


def serving_tables(dev):
    """The tables the serving phase gives K2 and K3 mid-decode: 64 slots;
    two GRPO groups of 8 on 200- and 203-token prompts (3 shared prefix
    pages, bucketed to 4) at 232 and 235 tokens; two greedy slots; 46 idle
    slots (length 0 on the null page). Returns (page table, lengths, group
    tables) on ``dev``."""
    table = np.zeros((S, P), np.int32)
    lens = np.zeros((S,), np.int32)
    g_slots = np.full((2, 8), -1, np.int32)
    g_pages = np.zeros((2, 4), np.int32)
    g_lens = np.full((2,), 3 * PS, np.int32)
    nxt, slot = 1, 0
    for g, n_tok in enumerate((232, 235)):
        g_pages[g, :3] = range(nxt, nxt + 3)
        for i in range(8):
            table[slot, :4] = [*g_pages[g, :3], nxt + 3 + i]
            lens[slot] = n_tok
            g_slots[g, i] = slot
            slot += 1
        nxt += 3 + 8
    for n_tok in (230, 237):
        table[slot, :4] = range(nxt, nxt + 4)
        lens[slot] = n_tok
        nxt, slot = nxt + 4, slot + 1
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(table), t(lens), (t(g_slots), t(g_pages), t(g_lens))


def serving_times(dev, kp, vp) -> None:
    """K2 and K3 on the serving tables (``serving_tables``)."""
    table, lens, gargs = serving_tables(dev)
    q = torch.randn((S, HQ, D), device=dev, dtype=torch.bfloat16)
    out2 = pa.paged_attention(q, kp, vp, table, lens)
    out3 = pa.grouped_paged_attention(q, kp, vp, table, lens, *gargs)
    for name, out, ref in (
            ("paged_attention", out2,
             pa.paged_attention_ref(q, kp, vp, table, lens)),
            ("grouped_paged_attention", out3, pa.grouped_paged_attention_ref(
                q, kp, vp, table, lens, *gargs)),
            ("grouped_paged_attention vs paged_attention", out3, out2)):
        check(torch.allclose(out.float(), ref.float(), **KERNEL_TOL),
              f"serving tables: {name} disagrees")
    ms2 = cuda_ms(lambda: pa.paged_attention(q, kp, vp, table, lens), 20,
                  inner=20)
    ms3 = cuda_ms(lambda: pa.grouped_paged_attention(q, kp, vp, table, lens,
                                                     *gargs), 20, inner=20)
    toks = int(np.maximum(lens.cpu().numpy(), 1).sum())
    b2, _ = bound_ms(2 * HKV * D * 2 * toks, 4.0 * HQ * D * toks)
    b3, _ = bound_ms(2 * HKV * D * 2 * (toks - 14 * 3 * PS),
                     4.0 * HQ * D * toks)
    log(f"kernel serving tables: paged_attention ms {ms2:.4f} (bound {b2:.4f}), "
        f"grouped_paged_attention ms {ms3:.4f} (bound {b3:.4f}); by launch: "
        + launch_times(q, kp, vp, table, lens, gargs))


def train_table_times(dev, kp, vp) -> None:
    """K2 on the tables the train phase gives it (64 slots, page 64,
    max_seq_len 512: 8 page-table columns; 16 live sequences at 64-512
    tokens, 48 idle slots), where it is launched 25,088 times a run."""
    rng = np.random.default_rng(2)
    p = 512 // PS
    table = np.zeros((S, p), np.int32)
    lens = np.zeros((S,), np.int32)
    lens[:16] = rng.integers(64, 513, 16)
    table[:16] = 1 + rng.permutation(kp.shape[1] - 1)[:16 * p].reshape(16, p)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    table, lens_t = t(table), t(lens)
    q = torch.randn((S, HQ, D), device=dev, dtype=torch.bfloat16)
    out = pa.paged_attention(q, kp, vp, table, lens_t)
    check(torch.allclose(out.float(), pa.paged_attention_ref(
        q, kp, vp, table, lens_t).float(), **KERNEL_TOL),
        "train tables: paged_attention disagrees")
    ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, table, lens_t), 20, inner=20)
    toks = int(np.maximum(lens, 1).sum())
    b, _ = bound_ms(2 * HKV * D * 2 * toks, 4.0 * HQ * D * toks)
    log(f"kernel train-phase tables: paged_attention ms {ms:.4f} (bound {b:.4f}, "
        f"{toks} tokens); by launch: {launch_times(q, kp, vp, table, lens_t, None)}")


# -- phase 2b: K4, training flash attention, forward and backward ---------------


def flash_inputs(dev, b: int, t: int, seed: int):
    """bf16 q/k/v/dout ([B, T, H, D], the model's layout) and f32 / int32
    [B, T] mask and segment ids. Row 0 is left-padded (prompt-style), the
    last row right-padded (response-style) and row 1 (or the only row)
    packs 3 segments followed by pads."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.float32)
    seg = np.ones((b, t), np.int32)
    if b > 1:
        mask[0, :t // 8] = 0
        mask[b - 1, t - t // 5:] = 0
    packed = 1 if b > 1 else 0
    cuts = (t // 5, t // 2, t - t // 16)
    seg[packed] = 0
    seg[packed, :cuts[0]], seg[packed, cuts[0]:cuts[1]] = 1, 2
    seg[packed, cuts[1]:cuts[2]] = 3
    mask[packed] = (seg[packed] > 0).astype(np.float32)
    for i in range(b):
        if i != packed:
            seg[i] = mask[i].astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev,  # noqa: E731
                                   dtype=torch.bfloat16)
    return dict(q=r(b, t, HQ, D), k=r(b, t, HKV, D), v=r(b, t, HKV, D),
                do=r(b, t, HQ, D), mask=torch.from_numpy(mask).to(dev),
                seg=torch.from_numpy(seg).to(dev))


def visible_pairs(seg: torch.Tensor) -> int:
    """(query, key) pairs the causal segment mask lets through, per head:
    what this input's work is (a causal kernel skips the tiles above the
    diagonal; what it then masks inside a tile is not work it needs)."""
    t = seg.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=seg.device).tril()
    same = seg[:, :, None] == seg[:, None, :]
    return int((same & causal).sum())


SPIN_CYCLES = 100_000_000  # about 50 ms of the SM clock


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    """Per-call device ms of back-to-back calls between CUDA events, for
    work a CUDA graph cannot capture (autograd backward passes). The calls
    are queued behind a spin kernel, so the device runs them back to back
    even where the host issues them slower than the device runs them
    (autograd's host cost can exceed a short backward's device time); a
    check fails if the host took longer to queue them than the spin
    lasted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    s = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    host_ms = (time.monotonic() - t0) * 1e3
    b.record()
    b.synchronize()
    check(host_ms < s.elapsed_time(a),
          f"events_ms: queueing took {host_ms:.1f} ms, longer than the "
          f"{s.elapsed_time(a):.1f} ms spin")
    return a.elapsed_time(b) / reps


def flash_bwd_parts_ms(q, k, v, seg, o, lse, do, reps: int, inner: int) -> dict:
    """Device ms of each of K4's three backward kernels, launched with the
    arguments ``flash.flash_bwd_cuda`` gives them (through the raw entry
    points, so they are not counted as launches)."""
    b, t, hq, d = q.shape
    code, scale = cuda_build.DTYPE_CODE[q.dtype], float(d ** -0.5)
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    shape = (code, b, t, hq, k.shape[2], d, 1, scale)

    def call(entry, *args):
        return lambda: cuda_build.launch(  # the stream is the capturing one
            "flash_attention_bwd", *args, cuda_build.stream_of(q.device),
            entry=f"polyrl_flash_attention_bwd_{entry}")

    calls = {"delta": call("delta", o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                           code, b, t, hq, d),
             "dq": call("dq", *ptrs, dq.data_ptr(), *shape),
             "dk/dv": call("dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *shape)}
    calls["delta"]()
    return {name: cuda_ms(fn, reps, inner) for name, fn in calls.items()}


def wrapper_grads(fn, q, k, v, mask, seg, do):
    """``fn(q, k, v, mask, segment_ids=seg)`` on fresh leaves, and the
    gradients of ``<out, do>``: (out, (dq, dk, dv))."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, mask, segment_ids=seg)
    return out.detach(), torch.autograd.grad(out, leaves, do)


def flash_case_check(dev, b: int, t: int, seed: int, label: str, reps: int,
                     repeat: bool = False, seg_np=None):
    """K4 through its public wrapper (``flash_attention_train`` and its
    autograd Function) against autograd through its plain version on one
    case; the planted fault (each row's first real token marked as pad)
    must fail both the output and the gradient tolerances; with
    ``repeat``, two backward calls on the same inputs must agree bitwise.
    ``seg_np`` ([b, t] int32) replaces the case's segment ids and mask
    (packed rows from the trainer). Returns (fwd row, bwd row) without
    launches."""
    c = flash_inputs(dev, b, t, seed)
    q, k, v, do, mask, seg = (c[x] for x in ("q", "k", "v", "do", "mask", "seg"))
    if seg_np is not None:
        seg = torch.from_numpy(np.ascontiguousarray(seg_np, np.int32)).to(dev)
        mask = (seg > 0).float()
    o, (dq, dk, dv) = wrapper_grads(flash.flash_attention_train, q, k, v, mask,
                                    seg, do)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref = flash.flash_attention_train_ref(*leaves, mask, segment_ids=seg)
    rdq, rdk, rdv = torch.autograd.grad(ref, leaves, do, retain_graph=True)
    torch.cuda.synchronize()

    def rel(g, rg):
        return ((g.float() - rg.float()).norm() / rg.float().norm()).item()

    err_o = (o.float() - ref.float()).abs().max().item()
    check(o.dtype == q.dtype and torch.allclose(o.float(), ref.float(),
                                                **FLASH_OUT_TOL),
          f"K4 forward ({label}) differs from its plain version (max {err_o})")
    grad_err = {}
    for name, g, rg, x in (("dq", dq, rdq, q), ("dk", dk, rdk, k),
                           ("dv", dv, rdv, v)):
        grad_err[name] = rel(g, rg)
        check(g.dtype == x.dtype and g.shape == x.shape
              and grad_err[name] <= FLASH_GRAD_TOL
              and torch.isfinite(g).all().item(),
              f"K4 backward ({label}) {name} relative error "
              f"{grad_err[name]:.3g} > {FLASH_GRAD_TOL}")
    err_g = max((g.float() - rg.float()).abs().max().item()
                for g, rg in ((dq, rdq), (dk, rdk), (dv, rdv)))
    # planted fault: each row's first real token marked as pad
    bad_seg = seg.clone()
    first = (seg > 0).int().argmax(dim=1)
    bad_seg[torch.arange(b, device=dev), first] = 0
    bo, bad_grads = wrapper_grads(flash.flash_attention_train, q, k, v, mask,
                                  bad_seg, do)
    torch.cuda.synchronize()
    bad_o = (bo.float() - ref.float()).abs().max().item()
    bad_g = {n: rel(g, rg) for n, g, rg in zip(("dq", "dk", "dv"), bad_grads,
                                                (rdq, rdk, rdv))}
    check(not torch.allclose(bo.float(), ref.float(), **FLASH_OUT_TOL),
          f"K4 ({label}): the output tolerance passes a missing first token")
    check(max(bad_g.values()) > FLASH_GRAD_TOL,
          f"K4 ({label}): the gradient tolerance passes a missing first token")
    log(f"kernel flash_attention ({label}, B {b} T {t}): out max_abs_err "
        f"{err_o:.3g}; grads relative error "
        + ", ".join(f"{n} {e:.3g}" for n, e in grad_err.items())
        + f"; planted fault (first real token as pad): out {bad_o:.3g}, "
        + ", ".join(f"{n} {e:.3g}" for n, e in bad_g.items())
        + " (fails the out and the gradient checks)")
    del bo, bad_grads

    _, lse = flash.flash_fwd_cuda(q, k, v, seg, True)
    if repeat:
        # determinism: the backward twice on the same inputs, bitwise
        first = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True)
        second = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip(first, second)),
              f"K4 backward ({label}) differs between two calls on the same inputs")
        log(f"kernel flash_attention ({label}): the backward twice on the "
            f"same inputs gives bitwise equal dq, dk, dv")
        del first, second

    # times: the kernels' launchers by graph replay (the backward needs the
    # forward's LSE); autograd backward passes by events
    inner = max(1, 2048 // t)
    ms_f = cuda_ms(lambda: flash.flash_fwd_cuda(q, k, v, seg, True), reps, inner)
    ms_b = cuda_ms(lambda: flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True),
                   reps, inner)
    parts = flash_bwd_parts_ms(q, k, v, seg, o, lse, do, reps, inner)
    plain_f = cuda_ms(lambda: flash.flash_attention_train_ref(
        q, k, v, mask, segment_ids=seg), reps)
    plain_b = events_ms(lambda: torch.autograd.grad(ref, leaves, do,
                                                    retain_graph=True), reps)
    del ref
    vis = ((seg[:, :, None] == seg[:, None, :])
           & torch.ones((t, t), dtype=torch.bool, device=dev).tril())[:, None]
    qt, kt_, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_f = cuda_ms(lambda: sdpa(qt, kt_, vt, attn_mask=vis, enable_gqa=True),
                    reps, inner)
    lleaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt_, vt)]
    lout = sdpa(*lleaves, attn_mask=vis, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_b = events_ms(lambda: torch.autograd.grad(lout, lleaves, dot,
                                                  retain_graph=True), reps)
    lerr = (lout.detach().transpose(1, 2).float() - o.float()).abs().max().item()
    del lout, lleaves

    pairs = visible_pairs(seg)
    es = 2
    io_f = (2 * q.numel() + k.numel() + v.numel()) * es + lse.numel() * 4 + seg.numel() * 4
    io_b = (4 * q.numel() + 2 * (k.numel() + v.numel())) * es + lse.numel() * 4 \
        + seg.numel() * 4
    bf, hf = bound_ms(io_f, 4.0 * D * HQ * pairs)
    bb, hb = bound_ms(io_b, 10.0 * D * HQ * pairs)
    log(f"kernel flash_attention ({label}): fwd ms {ms_f:.4f} (plain {plain_f:.4f}, "
        f"SDPA {lib_f:.4f}, bound {bf:.4f} by {hf}); bwd ms {ms_b:.4f} (plain "
        f"{plain_b:.4f}, SDPA {lib_b:.4f}, bound {bb:.4f} by {hb}); "
        f"bwd by kernel: " + ", ".join(f"{n} {ms:.4f}" for n, ms in parts.items())
        + f"; {pairs} visible pairs per head; SDPA vs K4 out max diff {lerr:.3g}; "
        f"plain and SDPA backward timed by CUDA events around {reps} "
        f"back-to-back autograd calls queued behind a spin kernel")
    fwd = dict(name="flash_attention_fwd", max_abs_err=err_o, ms=ms_f,
               plain_ms=plain_f, bound_ms=bf, bound_by=hf, library_ms=lib_f)
    bwd = dict(name="flash_attention_bwd", max_abs_err=err_g, ms=ms_b,
               plain_ms=plain_b, bound_ms=bb, bound_by=hb, library_ms=lib_b)
    return fwd, bwd


def check_flash(dev) -> list[dict]:
    """K4 at the train phase's shapes (its rows in the kernels line) and at
    the long case (logged)."""
    rows = flash_case_check(dev, 4, 512, 7, "train phase shapes", reps=10,
                            repeat=True)
    torch.cuda.empty_cache()
    flash_case_check(dev, 1, 4096, 8, "long case", reps=3)
    torch.cuda.empty_cache()
    return list(rows)


def build_report() -> None:
    """Each K2, K3, K4 and fused-prologue kernel's registers per thread
    and spill bytes, from the ``-Xptxas -v`` report of its library's
    build; the bf16 kernels (the serving and training paths) must not
    spill."""
    for name in ("paged_kv_write_fused", "paged_attention",
                 "grouped_paged_attention", "flash_attention_fwd",
                 "flash_attention_bwd"):
        rows = cuda_build.ptxas_report(name)
        check(rows, f"{name}: no ptxas report in its build log")
        log(f"build {name}: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, spill stores/loads "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in rows))
        for r in rows:
            check("bf16" not in r["kernel"] or r["spill_stores"] + r["spill_loads"] == 0,
                  f"{r['kernel']} spills {r['spill_stores']}/{r['spill_loads']} bytes")


# -- phase 3: the engine over HTTP -------------------------------------------------


def stream_generate(port: int, body: dict, out: dict) -> None:
    """POST /generate and record each NDJSON line with its arrival time."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    lines = []
    while True:
        raw = resp.readline()
        if not raw:
            break
        if raw.strip():
            lines.append((time.monotonic(), json.loads(raw)))
    conn.close()
    out.update(t0=t0, status=resp.status, lines=lines,
               tokens=[t for _, ln in lines for t in ln["token_ids"]],
               logprobs=[x for _, ln in lines for x in ln["logprobs"]],
               reason=lines[-1][1]["finish_reason"] if lines else "none")


def post(port: int, path: str, body: dict | None = None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    check(resp.status == 200, f"{path}: HTTP {resp.status}")
    return data


def run_requests(port: int, bodies: list[dict]) -> list[dict]:
    outs = [{} for _ in bodies]
    threads = [threading.Thread(target=stream_generate, args=(port, b, o))
               for b, o in zip(bodies, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        check(not t.is_alive(), "a /generate stream did not finish")
    for b, o in zip(bodies, outs):
        check(o.get("status") == 200, f"{b['rid']}: HTTP {o.get('status')}")
        want = b["sampling_params"]["max_new_tokens"]
        check(o["reason"] == "length" and len(o["tokens"]) == want,
              f"{b['rid']}: finish {o['reason']!r} after {len(o['tokens'])} tokens")
    return outs


@contextlib.contextmanager
def profiled(out_path: str | None):
    """With ``out_path``, trace the block with torch.profiler and print the
    device time by kernel (also written to ``out_path``)."""
    if not out_path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:25]
    lines = [f"profile: wall {wall_us / 1e3:.1f} ms, device busy "
             f"{busy / 1e3:.1f} ms ({busy / wall_us:.3f} of wall)"]
    lines += [f"profile: {dev_us(e) / 1e3:9.2f} ms {e.count:7d}x {e.key[:90]}"
              for e in top if dev_us(e) > 0]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for ln in lines:
        log(ln)


def serving_mix(vocab: int) -> tuple[list[dict], list[list[int]], list[int]]:
    """The serving main path's requests: two GRPO groups of 8 (temperature
    1.0, 64 new tokens) on 200- and 203-token prompts and two greedy
    requests of 128 tokens on 198- and 205-token prompts; with the greedy
    prompts and a 150-token warm-up prompt (all drawn from one seed)."""
    rng = np.random.default_rng(1)
    prompt = lambda n: rng.integers(1, vocab, n).tolist()  # noqa: E731
    group_prompts = [prompt(200), prompt(203)]
    greedy_prompts = [prompt(198), prompt(205)]
    bodies = []
    for g, gp in enumerate(group_prompts):
        bodies += [{"rid": f"g{g}-{i}", "input_ids": gp,
                    "group_id": f"grp{g}", "group_size": 8,
                    "sampling_params": {"temperature": 1.0,
                                        "max_new_tokens": 64}}
                   for i in range(8)]
    bodies += [{"rid": f"greedy{i}", "input_ids": gp,
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 128}}
               for i, gp in enumerate(greedy_prompts)]
    return bodies, greedy_prompts, prompt(150)


def serve_phase(dev, model: str = MODEL, profile: str | None = None) -> dict:
    from polyrl_tpu_torch.rollout.serve import create_server

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    server = create_server(model, device=str(dev), host="127.0.0.1", port=0,
                           max_slots=64, page_size=64, max_seq_len=4096,
                           num_pages=2048, steps_per_dispatch=8, seed=0)
    try:
        log(f"serve: {model} up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        port = server.port
        check(post(port, "/health", None)["status"] == "ok", "/health")
        cfg = server.engine.cfg
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)

        # one short request first: CUDA/cuBLAS initialise lazily, and that
        # one-time cost must not land in the measured TTFT
        run_requests(port, [{"rid": "warmup", "input_ids": warm,
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})

        # the main path: the mix, then one greedy request twice alone from
        # an empty prefix cache (identical inputs and batch shapes must give
        # identical tokens); counts zeroed just before it and read just
        # after. Whether the mix alone ends on an ungrouped dispatch (K2)
        # depends on when its greedy streams were admitted (one dispatch of
        # 17 in most runs, none in some); the lone request always does.
        info0 = post(port, "/get_server_info", None)
        cuda_build.reset_launch_counts()
        t_start = time.monotonic()
        with profiled(profile):
            outs = run_requests(port, bodies)
        wall = time.monotonic() - t_start
        mix_launches = dict(cuda_build.LAUNCHES)
        info = post(port, "/get_server_info", None)
        rep = []
        for i in range(2):
            post(port, "/flush_cache", {})
            rep.append(run_requests(port, [{
                "rid": f"repeat{i}", "input_ids": greedy_prompts[0],
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 64}}])[0])
        launches = dict(cuda_build.LAUNCHES)
        info_all = post(port, "/get_server_info", None)
        for name in SERVE_KERNELS:
            check(launches[name] > 0,
                  f"{name} was not launched on the serving path")
            check(info_all[f"kernel_launches/{name}"] == launches[name],
                  "server_info launch counts disagree")
        check(launches["paged_kv_write"] == 0,
              "the serving path took the unfused K/V write")
        delta = {k: info[k] - info0[k] for k in (
            "decode_dispatches", "grouped_decode_dispatches",
            "sibling_attach_dispatches")}
        log(f"serve: main path launches {json.dumps(launches)} (the mix's "
            f"{json.dumps(mix_launches)}); the mix: {json.dumps(delta)}; "
            + dispatch_line(info0, info))
        decode_tok_s = mix_tok_s(outs)
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0,
                  "non-finite or positive logprob")
            check(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                  "token outside the vocabulary")
        ttft = [o["lines"][0][0] - o["t0"] for o in outs]
        check(rep[0]["tokens"] == rep[1]["tokens"],
              "the same greedy request gave different tokens")
        single = (rep[0]["lines"][-1][0] - rep[0]["lines"][0][0]) / 63
        log(f"serve: one stream alone (twice): TTFT {(rep[0]['lines'][0][0] - rep[0]['t0']) * 1e3:.1f} ms, "
            f"{single * 1e3:.2f} ms per decode step (64 slots computed); "
            f"launches " + json.dumps({k_: launches[k_] - mix_launches[k_]
                                        for k_ in launches}))
        runahead = runahead_against_sync(port, server.engine, bodies, outs)
        log(f"serve: {len(outs)} streams, "
            f"{sum(len(o['tokens']) for o in outs)} tokens in {wall:.2f} s")
        # decode vs dense: the engine's greedy logprobs against the port's
        # dense forward over prompt + generated tokens, on the card, in f32
        # (the reference) and in bf16 (the same precision as the engine)
        n_p = len(greedy_prompts[0])

        def dense_logprobs(params, tokens):
            x = torch.tensor([greedy_prompts[0] + tokens], device=dev)
            pos = torch.arange(x.shape[1], device=dev)[None]
            logits, _ = decoder.forward(params, cfg, x, pos,
                                        torch.ones_like(x, dtype=torch.float32),
                                        attn_fn=flash.flash_attention_train_ref)
            return torch.log_softmax(logits[0, n_p - 1:-1].float(), dim=-1)

        params32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.float())
                    for k, v in server.engine.params.items()}

        def against_dense(out):
            """Max |engine - dense f32| logprob, the max f32 gap of the chosen
            tokens below the best, and the argmax agreement."""
            gen = torch.tensor(out["tokens"], device=dev)
            lsm32 = dense_logprobs(params32, out["tokens"])
            ref = lsm32.gather(-1, gen[:, None])[:, 0]
            err = (ref - torch.tensor(out["logprobs"], device=dev)).abs().max()
            return (err.item(), (lsm32.max(dim=-1).values - ref).max().item(),
                    (lsm32.argmax(dim=-1) == gen).float().mean().item(), ref)

        lp_err, gap, agree, ref_lp = against_dense(rep[0])
        gen = torch.tensor(rep[0]["tokens"], device=dev)
        lsm16 = dense_logprobs(server.engine.params, rep[0]["tokens"])
        bf16_err = (lsm16.gather(-1, gen[:, None])[:, 0] - ref_lp).abs().max().item()
        log(f"serve: decode vs dense f32: max |logprob diff| {lp_err:.4f} nats "
            f"(dense bf16 vs f32: {bf16_err:.4f}), max f32 gap of the chosen "
            f"token {gap:.4f}, argmax agreement {agree:.3f} "
            f"(tolerance {DENSE_LOGP_TOL})")
        check(lp_err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
              f"paged decode disagrees with the dense forward ({lp_err:.4f} "
              f"and {gap:.4f} nats, limit {DENSE_LOGP_TOL})")
        # the gate's power: the same request, with the engine's decode
        # attention missing each slot's last page, must fail it
        post(port, "/flush_cache", {})
        with missing_last_page(server.engine):
            bad = run_requests(port, [{
                "rid": "fault", "input_ids": greedy_prompts[0],
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 64}}])[0]
        bad_err, bad_gap, bad_agree, _ = against_dense(bad)
        log(f"serve: gate power: with each slot's last page missing, max "
            f"|logprob diff| {bad_err:.4f} nats, max gap {bad_gap:.4f}, "
            f"argmax agreement {bad_agree:.3f} (fails the tolerance)")
        check(max(bad_err, bad_gap) > DENSE_LOGP_TOL,
              "the dense gate passes a missing page")
        del params32
        ab = decode_ab(dev, server.engine.params, cfg)
        graphs = engine_graph_checks(dev, server.engine.params, cfg)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        log("serve: served " + engine_line(server.engine))
        log(f"serve: peak memory {peak_gb:.2f} GB (torch.cuda."
            f"max_memory_allocated, the served engine and the checks' own)")
        return dict(launches=launches, ttft=ttft, decode_tok_s=decode_tok_s,
                    wall=wall, ab_launches=ab, runahead=runahead, graphs=graphs,
                    peak_gb=peak_gb)
    finally:
        server.stop()


def mix_tok_s(outs: list[dict]) -> float:
    """Decode tokens per second over the mix: every token after each
    stream's first, from the first stream's first token to the last
    stream's last."""
    first = min(o["lines"][0][0] for o in outs)
    last = max(o["lines"][-1][0] for o in outs)
    n_tok = sum(len(o["tokens"]) for o in outs)
    return (n_tok - len(outs)) / max(last - first, 1e-9)


def dispatch_line(info0: dict, info: dict) -> str:
    """The engine's dispatch counters between two ``/get_server_info``
    reads: dispatches, graph replays, captures and their seconds, and the
    host ms per dispatch (queueing the replay or the eager body, and the
    copy of its outputs)."""
    d = {k: info[k] - info0[k] for k in (
        "decode_dispatches", "graph_replays", "graph_captures",
        "graph_capture_s", "decode_host_s")}
    n = max(d["decode_dispatches"], 1)
    return (f"{d['decode_dispatches']} dispatches, {d['graph_replays']} "
            f"replays, {d['graph_captures']} captures in "
            f"{d['graph_capture_s']:.2f} s, host ms per dispatch "
            f"{d['decode_host_s'] / n * 1e3:.3f} (captures included)")


# greedy logprobs of one stream at pipeline_depth 16 and 0, when the two
# runs admitted it in waves of another size or prompt bucket (another
# prefill batch shape may take another cuBLAS algorithm), in nats
RUNAHEAD_LP_TOL = 1e-3


def run_mix(port: int, bodies: list[dict], tag: str) -> tuple[list, dict, dict]:
    """The mix again from an empty prefix cache, with ``tag`` on every rid;
    returns the streams and the server info before and after."""
    post(port, "/flush_cache", {})
    info0 = post(port, "/get_server_info", None)
    outs = run_requests(port, [{**b, "rid": f"{b['rid']}-{tag}"} for b in bodies])
    return outs, info0, post(port, "/get_server_info", None)


def mix_wall_ms(outs: list[dict]) -> float:
    """From the first request's start to the last stream's last line."""
    return (max(o["lines"][-1][0] for o in outs)
            - min(o["t0"] for o in outs)) * 1e3


def runahead_against_sync(port: int, engine, bodies: list[dict],
                          outs: list[dict]) -> dict:
    """The mix's greedy streams with the engine running ahead (the main
    path, pipeline_depth 16) against the synchronous engine
    (pipeline_depth 0): the same token ids; logprobs bitwise where both
    runs admitted the stream in a wave of the same kind, size and prompt
    bucket, else within RUNAHEAD_LP_TOL. The mix at each depth in turns
    (16, 0, 0, 16) for decode tok/s and TTFT (a group-table shape the
    earlier runs did not meet is still captured; each line says so), then
    once more at depth 16 under torch.profiler for the device's busy share
    of the mix's wall."""
    depth = engine.pipeline_depth
    tok_s: dict = {depth: [], 0: []}
    sync = None
    try:
        for i, d in enumerate((depth, 0, 0, depth)):
            engine.pipeline_depth = d
            run, i0, i1 = run_mix(port, bodies, f"d{d}r{i}")
            tok_s[d].append(mix_tok_s(run))
            ttft = statistics.median(o["lines"][0][0] - o["t0"] for o in run)
            log(f"serve run-ahead: depth {d}: {tok_s[d][-1]:.1f} decode "
                f"tok/s, TTFT median {ttft * 1e3:.1f} ms; "
                + dispatch_line(i0, i1))
            if d == 0 and sync is None:
                sync, sync_tag = run, f"d{d}r{i}"
    finally:
        engine.pipeline_depth = depth
    waves = {rid: (kind, size, pb) for rid, kind, size, pb in engine.admissions}
    cases = []
    for b, a, o in zip(bodies, outs, sync):
        if b["sampling_params"]["temperature"] > 0:
            continue
        rid = b["rid"]
        check(a["tokens"] == o["tokens"],
              f"{rid}: depth {depth} and depth 0 gave other tokens")
        gap = float(np.abs(np.asarray(a["logprobs"])
                           - np.asarray(o["logprobs"])).max())
        w16, w0 = waves[rid], waves[f"{rid}-{sync_tag}"]
        same = w16 == w0
        cases.append(f"{rid}: admitted {w16} / {w0}, "
                     f"{'same waves: bitwise' if same else 'other waves'}, "
                     f"max |logprob diff| {gap:.2e}")
        check(gap == 0.0 if same else gap <= RUNAHEAD_LP_TOL,
              f"{rid}: depth {depth} against depth 0: {cases[-1]}")
    log("serve run-ahead: greedy streams, depth 16 (main path) against 0: "
        "same tokens; " + "; ".join(cases))
    res: dict = {}

    def profiled_mix():
        res["outs"], res["i0"], res["i1"] = run_mix(port, bodies, "busy")

    busy = device_profile(profiled_mix, 1)["device_ms"]
    wall = mix_wall_ms(res["outs"])
    med = {d: statistics.median(v) for d, v in tok_s.items()}
    log(f"serve run-ahead: decode tok/s median depth {depth} {med[depth]:.1f}, "
        f"depth 0 {med[0]:.1f} ({med[depth] / med[0]:.3f} x); the mix at "
        f"depth {depth} under torch.profiler: device busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall ({busy / wall:.3f}); "
        + dispatch_line(res["i0"], res["i1"]))
    return dict(tok_s=med[depth], sync_tok_s=med[0], busy_share=busy / wall)


AB_STEPS = 50   # decode steps per route in the serve phase's A/B
PROF_STEPS = 5  # of them traced by torch.profiler, per route


def device_profile(fn, calls: int) -> dict:
    """Per call of ``fn``, from a torch.profiler trace of ``calls`` calls:
    the device's kernels, its memory copies and sets, and the device ms
    they took (the sum of their durations: busy time, not wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    n_mem = sum(e.name.startswith(("Memcpy", "Memset")) for e in on_dev)
    return dict(kernels=(len(on_dev) - n_mem) / calls, copies=n_mem / calls,
                device_ms=sum(e.device_time_total for e in on_dev) / 1e3 / calls)


def decode_ab(dev, params, cfg) -> dict:
    """The decode step's three routes at the serving tables
    (``serving_tables``: 64 slots, 18 live), on the served model's
    weights and pools of random K/V: the default (the fused prologue),
    ``kv_write_fn=pa.paged_kv_write`` (eager qk-norm and RoPE, then the
    standalone K1), and ``graph``: the fused route captured in a CUDA graph
    and replayed. Gates: one step of the first two from the same pools and
    inputs, the live slots' log-softmax within DECODE_AB_TOL nats; a replay
    bitwise the eager fused step. Then AB_STEPS ``forward_paged_decode``
    steps per route in turns (fused, unfused, graph, graph, unfused,
    fused), each synchronised and timed on the host's clock, at fixed
    lengths (every step writes the same positions: the same work as a real
    step), with each turn's launch counts zeroed just before it and read
    just after (a replay credits what its capture recorded); and
    PROF_STEPS more per route under torch.profiler for kernels and device
    ms per step. Returns the launches by route."""
    table, lens, _ = serving_tables(dev)
    active = lens > 0
    pools = decoder.make_paged_pools(cfg, int(table.max()) + 1, PS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for p_ in pools[0] + pools[1]:
        p_.normal_(generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (S,), generator=gen, device=dev)
    kv_write = {"fused": None, "unfused": pa.paged_kv_write}

    def step(route, pools_=pools):
        return decoder.forward_paged_decode(
            params, cfg, tokens, lens, pools_, table, lens, active=active,
            kv_write_fn=kv_write[route])[0]

    lsm = {}
    for route in kv_write:
        copy = ([p_.clone() for p_ in pools[0]], [p_.clone() for p_ in pools[1]])
        lsm[route] = torch.log_softmax(step(route, copy)[active], dim=-1)
        del copy
    gap = (lsm["fused"] - lsm["unfused"]).abs().max().item()
    agree = (lsm["fused"].argmax(-1) == lsm["unfused"].argmax(-1)).float().mean()
    log(f"serve decode a/b: fused vs unfused route from the same pools and "
        f"inputs: max |log-softmax diff| over the {int(active.sum())} live "
        f"slots' vocabulary {gap:.4f} nats (tolerance {DECODE_AB_TOL}), "
        f"argmax agreement {agree.item():.3f}")
    check(gap <= DECODE_AB_TOL, f"the fused decode route differs from the "
          f"unfused one by {gap:.4f} nats (limit {DECODE_AB_TOL})")
    del lsm

    # the graph route: the fused step captured once (after a warm-up on the
    # capturing stream), its launches recorded for crediting at each replay
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager_logits = step("fused").clone()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with cuda_build.recording_launches() as graph_launches:
        with torch.cuda.graph(graph, stream=side):
            graph_logits = step("fused")
    graph.replay()
    torch.cuda.synchronize()
    # live slots only: idle slots all write the null page and read it back,
    # racing one another
    check(torch.equal(graph_logits[active], eager_logits[active]),
          "a replay of the captured fused step differs from the eager step")

    def replay():
        graph.replay()
        cuda_build.credit_launches(graph_launches)

    routes = {"fused": lambda: step("fused"), "unfused": lambda: step("unfused"),
              "graph": replay}
    walls = {r: [] for r in routes}
    launches = {r: dict.fromkeys(cuda_build.LAUNCHES, 0) for r in routes}
    for route in ("fused", "unfused", "graph", "graph", "unfused", "fused"):
        cuda_build.reset_launch_counts()
        for _ in range(AB_STEPS // 2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            routes[route]()
            torch.cuda.synchronize()
            walls[route].append((time.monotonic() - t0) * 1e3)
        for k_, n in cuda_build.LAUNCHES.items():
            launches[route][k_] += n
    n_l = cfg.num_layers * AB_STEPS
    for route in ("fused", "graph"):
        check(launches[route]["paged_kv_write_fused"] == n_l
              and launches[route]["paged_kv_write"] == 0,
              f"the {route} route's launches: {launches[route]}")
    check(launches["unfused"]["paged_kv_write"] == n_l
          and launches["unfused"]["paged_kv_write_fused"] == 0,
          f"the unfused route's launches: {launches['unfused']}")
    prof = {r: device_profile(fn, PROF_STEPS) for r, fn in routes.items()}
    for route in routes:
        w = sorted(walls[route])
        pr = prof[route]
        log(f"serve decode a/b {route}: wall ms per step median "
            f"{statistics.median(w):.2f} (min {w[0]:.2f}, p90 "
            f"{w[int(0.9 * len(w))]:.2f}, max {w[-1]:.2f}; {len(w)} steps), "
            f"{int(active.sum()) / statistics.median(w) * 1e3:.1f} live tok/s; "
            f"device ms per step {pr['device_ms']:.3f}, kernels per step "
            f"{pr['kernels']:.1f} (+ {pr['copies']:.1f} copies/sets; torch."
            f"profiler over {PROF_STEPS} steps); launches "
            + json.dumps({k_: n for k_, n in launches[route].items() if n}))
    del graph
    return launches


# -- the engine's decode dispatch: graph against eager --------------------------

# a sampled token's logprob against the filtered log-softmax recomputed from
# the same state (the same kernels on the same inputs: equal but for the
# order of a reduction, if any)
SAMPLED_LOGP_TOL = 1e-5


def engine_snapshot(eng) -> tuple:
    """The engine's device state, pools and sampling generator state."""
    return ({n: t.clone() for n, t in eng._dev.items()},
            [[p_.clone() for p_ in side] for side in eng._pools],
            eng._gen.get_state())


def engine_restore(eng, snap: tuple, generator: bool = True) -> None:
    for n, t in snap[0].items():
        eng._dev[n].copy_(t)
    for side, saved in zip(eng._pools, snap[1]):
        for p_, s_ in zip(side, saved):
            p_.copy_(s_)
    if generator:
        eng._gen.set_state(snap[2])


def engine_outputs(eng) -> tuple:
    """The last dispatch's [k, S] outputs and the state it left."""
    torch.cuda.synchronize()
    return tuple(o.clone() for o in eng._out), engine_snapshot(eng)


def graph_against_eager(eng, use_filters: bool, tables) -> dict:
    """One k-step dispatch of the engine (not started) at its current
    state, replayed from the graph of its key (captured first when new:
    the warm-up runs the dispatch, then the state is put back), and the
    same dispatch by the eager body from the same snapshot of pools,
    device state and generator. Returns both runs' outputs and end states
    and the snapshot; the engine is left at the snapshot."""
    snap = engine_snapshot(eng)
    if eng._graph_key(use_filters, tables) not in eng._graphs:
        eng._launch_decode(use_filters, tables)
        engine_restore(eng, snap)
    eng._launch_decode(use_filters, tables)
    graph_out, graph_state = engine_outputs(eng)
    engine_restore(eng, snap)
    eng._decode_body(use_filters, eng._group_tables(tables))
    eager_out, eager_state = engine_outputs(eng)
    engine_restore(eng, snap)
    return dict(graph=graph_out, graph_state=graph_state, eager=eager_out,
                eager_state=eager_state, snap=snap)


def states_equal(a: tuple, b: tuple) -> bool:
    """Device state and pools bitwise equal, but for the null page 0, which
    every inactive slot writes and which only inactive slots read (their
    writes race one another)."""
    return (all(torch.equal(a[0][n], b[0][n]) for n in a[0])
            and all(torch.equal(x[:, 1:], y[:, 1:])
                    for sa, sb in zip(a[1], b[1]) for x, y in zip(sa, sb)))


def sampled_row_checks(eng, use_filters: bool, tables, run: dict) -> dict:
    """The graph's sampled rows against the engine's own sampler, stepping
    the eager forward through the dispatch from the snapshot with the
    graph's tokens fed back: each sampled token lies in its row's filtered
    set (top-k, top-p), and its logprob is the filtered, temperature-scaled
    log-softmax at that token. Returns the worst error and the counts."""
    from polyrl_tpu_torch.rollout import sampling

    engine_restore(eng, run["snap"])
    st, gt = eng._dev, eng._group_tables(tables)
    attn = None
    if gt is not None:
        def attn(q, kp, vp, pt, ln):
            return pa.grouped_paged_attention(q, kp, vp, pt, ln, *gt)
    tok, lp, done = run["graph"]
    seq, last = st["seq_lens"].clone(), st["last_tokens"].clone()
    active = st["active"].clone()
    err, n_rows, outside = 0.0, 0, 0
    for i in range(eng.steps_per_dispatch):
        logits, _ = decoder.forward_paged_decode(
            eng.params, eng.cfg, last, seq, eng._pools, st["page_table"], seq,
            attn_fn=attn, active=active)
        scaled = sampling._filtered_scaled(logits, st["temps"], st["top_ps"],
                                           st["top_ks"], use_filters)
        rows = active & (st["temps"] > 0)
        t = tok[i].long()[:, None]
        kept = scaled.gather(-1, t)[:, 0] > sampling.NEG_INF
        outside += int((rows & ~kept).sum())
        ref = torch.log_softmax(scaled, dim=-1).gather(-1, t)[:, 0]
        if rows.any():
            err = max(err, (ref - lp[i])[rows].abs().max().item())
        n_rows += int(rows.sum())
        seq = seq + active.int()
        last = torch.where(active, tok[i], last)
        active = active & ~done[i]
    engine_restore(eng, run["snap"])
    return dict(err=err, rows=n_rows, outside=outside)


def profiled_port_kernels(fn, calls: int) -> dict:
    """Kernels of the port's own libraries in a torch.profiler trace of
    ``calls`` calls of ``fn``, by kernel name (the identifier before any
    template arguments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {r["kernel"].split("<")[0] for lib in cuda_build.KERNELS
             if cuda_build.lib_path(lib).exists()
             for r in cuda_build.ptxas_report(lib)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if re.search(rf"\b{n}\b", e.name):
                counts[n] = counts.get(n, 0) + 1
    return counts


def engine_graph_checks(dev, params, cfg) -> dict:
    """The engine's k-step decode dispatch (``rollout/cb_engine.py``) as a
    CUDA graph against its eager body, at the serving tables: an engine on
    the served weights (not started: driven through its internals) admits
    the serve mix -- a greedy GRPO group of 8, a sampled one (temperature
    1, top-p 0.9, top-k 50: filters on) and two greedy requests -- and
    takes one dispatch. Then for the ungrouped key (K2) and the grouped
    key (K3), each with filters on: a replay and the eager body from the
    same snapshot give bitwise equal tokens, logprobs, done flags, device
    state and pools; the sampled rows pass ``sampled_row_checks``; two
    replays from the same generator state give the same tokens, and a
    replay after another draws different ones. Each dispatch eager
    against replayed, synchronised, on the host's clock; the replay also
    by CUDA events. Launch credit: over a few replays under
    torch.profiler, the profiler's count of the port's kernels equals
    what ``LAUNCHES`` was credited."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                   num_pages=128, steps_per_dispatch=8, seed=3, device=dev)
    rng = np.random.default_rng(5)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=64)
    sampled = SamplingParams(temperature=1.0, top_p=0.9, top_k=50,
                             max_new_tokens=64)
    for g, (n_p, sp) in enumerate(((200, greedy), (203, sampled))):
        prompt = rng.integers(1, cfg.vocab_size, n_p).tolist()
        for i in range(8):
            eng.submit(f"g{g}-{i}", prompt, sp, group_id=f"grp{g}",
                       group_size=8)
    for i, n_p in enumerate((198, 205)):
        eng.submit(f"greedy{i}", rng.integers(1, cfg.vocab_size, n_p).tolist(),
                   greedy)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()  # mid-decode; captures the grouped key
        eng._drain_emit_q()
    tables = eng._decode_group_pack()
    check(tables is not None and int(eng._active.sum()) == 18,
          f"{int(eng._active.sum())} active slots, groups {tables is not None}")
    out = {}
    for label, tb in (("ungrouped (K2)", None), ("grouped (K3)", tables)):
        key = eng._graph_key(True, tb)
        run = graph_against_eager(eng, True, tb)
        same = [torch.equal(a, b) for a, b in zip(run["graph"], run["eager"])]
        pools_same = states_equal(run["graph_state"], run["eager_state"])
        check(all(same) and pools_same,
              f"{label}: the replayed dispatch differs from the eager body "
              f"(tokens/logprobs/done equal {same}, state and pools equal "
              f"{pools_same})")
        rows = sampled_row_checks(eng, True, tb, run)
        check(rows["rows"] > 0 and rows["outside"] == 0
              and rows["err"] <= SAMPLED_LOGP_TOL,
              f"{label}: sampled rows: {json.dumps(rows)}")
        # two replays from the same generator state, then one after another
        eng._launch_decode(True, tb)
        again, _ = engine_outputs(eng)
        engine_restore(eng, run["snap"], generator=False)
        eng._launch_decode(True, tb)
        later, _ = engine_outputs(eng)
        sampled_rows = (run["snap"][0]["active"]
                        & (run["snap"][0]["temps"] > 0))
        n_diff = int((later[0] != run["graph"][0])[:, sampled_rows].sum())
        check(torch.equal(again[0], run["graph"][0]),
              f"{label}: two replays from one generator state differ")
        check(n_diff > 0, f"{label}: a later replay drew the same tokens")
        # timing: eager body against replay, state put back before each
        walls = {"eager": [], "graph": []}
        dev_ms = []
        for route in ("eager", "graph", "graph", "eager"):
            for _ in range(3):
                engine_restore(eng, run["snap"])
                torch.cuda.synchronize()
                t0 = time.monotonic()
                if route == "eager":
                    eng._decode_body(True, eng._group_tables(tb))
                else:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    eng._launch_decode(True, tb)
                    b.record()
                torch.cuda.synchronize()
                walls[route].append((time.monotonic() - t0) * 1e3)
                if route == "graph":
                    dev_ms.append(a.elapsed_time(b))
        k = eng.steps_per_dispatch
        med = {r: statistics.median(w) for r, w in walls.items()}
        log(f"serve graph vs eager {label}: key {key}: {k}-step dispatch "
            f"replayed bitwise the eager body (tokens, logprobs, done, state, "
            f"pools); sampled rows {rows['rows']} in their filtered sets, "
            f"max |logprob - filtered log-softmax| {rows['err']:.2e} "
            f"(tolerance {SAMPLED_LOGP_TOL}); same generator state, same "
            f"tokens; next replay {n_diff} sampled tokens other; wall ms per "
            f"dispatch eager {med['eager']:.2f}, replay {med['graph']:.2f} "
            f"({med['eager'] / k:.2f} / {med['graph'] / k:.2f} per step), "
            f"replay device ms {statistics.median(dev_ms):.3f} (CUDA events)")
        engine_restore(eng, run["snap"])
        out[label] = med

    # a capture while another thread works the card (allocations, products,
    # host reads), as the pipelined trainer's does: thread-local capture.
    # Its draws come from a generator of its own: every capture registers
    # the default CUDA generator, which then refuses draws outside it
    busy_stop = threading.Event()
    n_busy = [0]
    busy_gen = torch.Generator(device=dev).manual_seed(1)

    def busy_thread():
        while not busy_stop.is_set():
            a = torch.randn((1024, 1024), device=dev, generator=busy_gen)
            n_busy[0] += int((a @ a).abs().sum().item() > 0)

    worker = threading.Thread(target=busy_thread, daemon=True)
    worker.start()
    try:
        n_before = len(eng._graphs)
        run = graph_against_eager(eng, False, tables)
    finally:
        busy_stop.set()
        worker.join(timeout=60)
    check(not worker.is_alive() and n_busy[0] > 0
          and len(eng._graphs) == n_before + 1, "no capture beside the busy thread")
    check(all(torch.equal(a, b) for a, b in zip(run["graph"], run["eager"]))
          and states_equal(run["graph_state"], run["eager_state"]),
          "a graph captured beside another thread's work differs from the eager body")
    log(f"serve graph vs eager: key {eng._graph_key(False, tables)} captured "
        f"while another thread ran {n_busy[0]} products with allocations and "
        f"host reads: replay bitwise the eager body; {engine_line(eng)}")

    # launch credit: the profiler's count of the port's kernels over a few
    # replays against what LAUNCHES was credited
    replays = 3

    def replay_grouped():
        engine_restore(eng, run["snap"])
        eng._launch_decode(True, tables)

    cuda_build.reset_launch_counts()
    seen = profiled_port_kernels(replay_grouped, replays)
    credited = dict(cuda_build.LAUNCHES)
    split = sum(n for name, n in seen.items() if name.startswith("paged_split"))
    want = {"paged_kv_write_fused_kernel": credited["paged_kv_write_fused"],
            "paged_split": credited["paged_attention"]
            + credited["grouped_paged_attention"],
            "paged_combine_kernel": credited["paged_attention"]
            + credited["grouped_paged_attention"]}
    got = {"paged_kv_write_fused_kernel": seen.get("paged_kv_write_fused_kernel", 0),
           "paged_split": split,
           "paged_combine_kernel": seen.get("paged_combine_kernel", 0)}
    log(f"serve launch credit: {replays} replays of the grouped key: "
        f"torch.profiler counted {json.dumps(seen)}; LAUNCHES credited "
        f"{json.dumps({k_: n for k_, n in credited.items() if n})}")
    check(got == want and credited["paged_kv_write_fused"]
          == replays * eng.steps_per_dispatch * cfg.num_layers,
          f"launch credit disagrees with the profiler: {got} against {want}")
    cuda_build.reset_launch_counts()
    del eng
    return out


@contextlib.contextmanager
def missing_last_page(engine):
    """Within the block the engine's decode attention runs K2/K3 with each
    slot's length cut back past its last page (a page-table fault that
    loses up to 64 recent tokens). The kernels still launch. The engine's
    graphs are dropped on the way in and out, so that its dispatches are
    captured again with the fault and then without it."""
    from polyrl_tpu_torch.rollout import cb_engine

    def cut(lens):
        return torch.clamp(lens - ((lens - 1) % PS + 1), min=0)

    k2, k3 = decoder.paged_attention, cb_engine.grouped_paged_attention
    decoder.paged_attention = lambda q, kp, vp, pt, lens, *a: k2(
        q, kp, vp, pt, cut(lens), *a)
    cb_engine.grouped_paged_attention = lambda q, kp, vp, pt, lens, *a: k3(
        q, kp, vp, pt, cut(lens), *a)
    engine._graphs.clear()
    try:
        yield
    finally:
        decoder.paged_attention, cb_engine.grouped_paged_attention = k2, k3
        engine._graphs.clear()


# -- phase 4: two GRPO steps through the trainer's entry point ------------------


TRAIN_OVERRIDES = [
    "device=cuda", f"model.preset={MODEL}", "model.dtype=bfloat16",
    "tokenizer.kind=byte", "data.train_path=arithmetic",
    "rollout.max_slots=64", "rollout.page_size=64", "rollout.num_pages=512",
    "rollout.max_seq_len=512", "rollout.prompt_buckets=64",
    "trainer.train_batch_size=2", "trainer.rollout_n=8",
    "trainer.ppo_mini_batch_size=16", "trainer.micro_batch_size=4",
    "trainer.min_stream_batch_size=16", "trainer.max_prompt_length=64",
    "trainer.max_response_length=448", "trainer.adv_estimator=grpo",
    "trainer.total_steps=2", "trainer.temperature=1.0", "trainer.seed=0",
    # lr 1e-4: Adam's first step moves a weight by about lr, and a bf16
    # weight of 0.02 only moves when that exceeds half an ulp (6e-5)
    "actor.use_kl_loss=true", "actor.remat=true", "actor.lr=1e-4",
    "reward.num_workers=1",
]
# step-1 old logprobs (trainer forward, K4) against the engine's sampling
# logprobs (paged decode, K1/K2), in nats over every response token: both
# run the same bf16 weights through other kernels and another bf16
# rounding order; the limit is about twice the largest gap measured on the
# card (0.105 nats over 7,168 tokens)
LOGP_AGREE_TOL = 0.2
# the flattened full-model gradient of one micro, K4 against the plain
# attention: on an f32 copy of the weights the kernel alone shows (cosine
# 1.000000 measured); on the bf16 weights both attentions' 1-ulp roundings
# compound through 28 random-init layers, so its limit sits between the
# two (H100, six seeds: 0.9987; the tile-local fault about 0.01). The micro
# is step 1's, read on step 1's weights: read after the fit instead, two
# updates stale, 78-82% of its tokens sit in the PPO clip and a one-ulp
# change of the attention output moves a few across a clip edge, which
# switches their policy-gradient term (3-9 of 1,792 tokens, cosine
# 0.973-0.993; with the clips off 0.9996)
GRAD_COS_MIN = 0.99
GRAD_COS_MIN_BF16 = 0.98
GRAD_NORM_RATIO_TOL = 0.02


def byte_length_score(data_source, text, ground_truth, extra_info) -> float:
    """A reward that varies within a GRPO group at random weights: the
    response's UTF-8 length (about 1 byte in 448 random tokens at vocab
    151,936), so the group-relative advantages are not all 0."""
    return float(len(text.encode("utf-8")))


def tile_local_attention(q, k, v, attn_mask):
    """K4 fed wrong segment ids, a planted fault for the train gates: every
    real token's segment is its 64-row tile, so each query loses the keys
    of all earlier tiles (the kernel still launches)."""
    t = attn_mask.shape[1]
    tile = torch.arange(t, device=attn_mask.device) // 64 + 1
    seg = (attn_mask.to(torch.int32) * tile[None].to(torch.int32)).contiguous()
    return flash.flash_attention_train(q, k, v, attn_mask, segment_ids=seg)


def _leaves(tree: dict, prefix: str = ""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, prefix + key + ".")
        else:
            yield prefix + key, val


@contextlib.contextmanager
def launches_apart(store: dict, names=None):
    """Run gate-only work without adding to the main path's counts: its
    launches of ``names`` (every kernel by default) go to ``store``. Name
    only the kernels the gate launches where another thread of the main
    path may launch others meanwhile."""
    names = tuple(cuda_build.LAUNCHES) if names is None else names
    before = {k_: cuda_build.LAUNCHES[k_] for k_ in names}
    try:
        yield
    finally:
        for k_ in names:
            store[k_] = store.get(k_, 0) + cuda_build.LAUNCHES[k_] - before[k_]
            cuda_build.LAUNCHES[k_] = before[k_]


def micro_loss_grads(actor, feed, attn_fn) -> list[torch.Tensor]:
    """The full-model gradient of the actor's loss on one micro with
    ``attn_fn`` as every layer's attention (the parameters are left as
    they are)."""
    keep = actor.attn_fn
    actor.attn_fn = attn_fn
    try:
        for _, p in _leaves(actor.params):
            p.grad = None
        with torch.enable_grad():
            loss, _ = actor._loss_fn(feed, 1.0)
            loss.backward()
        grads = [p.grad for _, p in _leaves(actor.params)]
        for _, p in _leaves(actor.params):
            p.grad = None
        return grads
    finally:
        actor.attn_fn = keep


def _tree_map(fn, tree: dict) -> dict:
    return {k_: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k_, v in tree.items()}


@contextlib.contextmanager
def params_swapped(actor, params: dict):
    """Within the block the actor computes with ``params`` (a tree of
    autograd leaves); its own come back after."""
    keep = actor.params
    actor.params = params
    try:
        yield
    finally:
        actor.params = keep


def host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def step1_weights(host: dict, dev) -> dict:
    """A host snapshot of the actor's weights back on ``dev`` as leaves."""
    return _tree_map(lambda t: t.to(dev).requires_grad_(True), host)


def _tree_map_f32(tree: dict) -> dict:
    """An f32 copy of a parameter tree, as autograd leaves."""
    return {k_: (_tree_map_f32(v) if isinstance(v, dict)
                 else v.detach().float().requires_grad_(True))
            for k_, v in tree.items()}


def grad_agreement(ga, gb) -> tuple[float, float]:
    """Cosine of the flattened gradients and the ratio of their norms."""
    dot = sum(torch.sum(a.float() * b.float()) for a, b in zip(ga, gb)).item()
    na = sum(torch.sum(a.float() ** 2) for a in ga).item() ** 0.5
    nb = sum(torch.sum(b.float() ** 2) for b in gb).item() ** 0.5
    return dot / (na * nb), na / nb


def gradient_readings(actor, micro) -> tuple[float, float, float, float]:
    """The micro's full-model gradient through K4, and through K4 fed
    tile-local segment ids, each against the same through the plain
    attention, on the actor's current parameters: (cosine, norm ratio) of
    K4, then of the fault."""
    g_plain = micro_loss_grads(actor, micro, plain_attention)
    g = micro_loss_grads(actor, micro, flash.auto_train_attention())
    cos, ratio = grad_agreement(g, g_plain)
    del g
    g = micro_loss_grads(actor, micro, tile_local_attention)
    bad_cos, bad_ratio = grad_agreement(g, g_plain)
    del g, g_plain
    return cos, ratio, bad_cos, bad_ratio


def gate_micro(feed: dict, dev) -> dict:
    """The gradient gate's micro: the 4 rows of step 1 with the largest
    positive advantages (same-sign terms: no cancellation in the policy
    gradient), on ``dev``."""
    from polyrl_tpu_torch.trainer.actor import _to_device

    rows = np.argsort(-feed["advantages"].sum(-1))[:4]
    return _to_device({k_: v[rows] for k_, v in feed.items()
                       if k_ != "rollout_log_probs"}, dev)


def both_precisions(actor, micro) -> dict:
    """``gradient_readings`` on the actor's bf16 weights and on an f32
    copy of them: {"bf16": readings, "f32": readings}."""
    out = {"bf16": gradient_readings(actor, micro)}
    with params_swapped(actor, _tree_map_f32(actor.params)):
        out["f32"] = gradient_readings(actor, micro)
    return out


def gradient_gate(readings: tuple, cos_min: float, label: str) -> str:
    """K4's ``gradient_readings`` must pass (cosine >= ``cos_min``, norm
    ratio within GRAD_NORM_RATIO_TOL) and the fault's must fail. Returns
    the log line's readings."""
    cos, ratio, bad_cos, bad_ratio = readings
    check(cos >= cos_min and abs(ratio - 1) <= GRAD_NORM_RATIO_TOL,
          f"K4 gradient on {label} weights disagrees with the plain "
          f"attention's (cosine {cos:.6f}, norm ratio {ratio:.5f})")
    check(bad_cos < cos_min or abs(bad_ratio - 1) > GRAD_NORM_RATIO_TOL,
          f"the gradient gate on {label} weights passes tile-local segment ids")
    return (f"{label} weights: cosine {cos:.6f}, norm ratio {ratio:.5f} "
            f"(limits >= {cos_min}, within {GRAD_NORM_RATIO_TOL}); with "
            f"tile-local segment ids: cosine {bad_cos:.4f}, norm ratio "
            f"{bad_ratio:.4f} (fails)")


def plain_attention(q, k, v, attn_mask):
    return flash.flash_attention_train_ref(q, k, v, attn_mask)


def train_phase(dev) -> dict:
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    cfg = load_config(None, TRAIN_OVERRIDES)
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor, engine = trainer.actor, trainer.rollout
        log(f"train: {MODEL} trainer up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        gate_launches: dict = {}
        step1: dict = {}
        process = trainer._process_ibatch

        def first_ibatch_gates(ibatch, metrics):
            """Step 1, after the old/ref passes and before any update: the
            logprob agreement and its planted fault, on the weights the
            engine sampled with."""
            out = process(ibatch, metrics)
            if step1:
                return out
            mask = np.asarray(out["response_mask"]) > 0
            gap = np.abs(np.asarray(out["old_log_probs"])
                         - np.asarray(out["rollout_log_probs"]))[mask]
            feed = {k_: np.array(out[k_]) for k_ in (
                "input_ids", "positions", "attention_mask", "responses",
                "response_mask", "advantages", "old_log_probs",
                "ref_log_probs", "rollout_log_probs")}
            with launches_apart(gate_launches):
                keep = actor.attn_fn
                actor.attn_fn = tile_local_attention
                try:
                    bad_lp, _ = actor.compute_log_prob(feed, compute_entropy=False)
                finally:
                    actor.attn_fn = keep
            bad_gap = np.abs(bad_lp.float().cpu().numpy()
                             - feed["rollout_log_probs"])[mask]
            step1.update(feed=feed, gap_max=float(gap.max()),
                         gap_mean=float(gap.mean()), bad_max=float(bad_gap.max()),
                         bad_mean=float(bad_gap.mean()), tokens=int(mask.sum()),
                         weights=_tree_map(host_copy, actor.params))
            return out

        trainer._process_ibatch = first_ibatch_gates
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        trainer._process_ibatch = process

        # gates on the run itself
        check(len(history) == 2, "the fit did not run 2 steps")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0, f"step {i}: zero gradient")
            check(rec["actor/nonfinite_skips"] == 0,
                  f"step {i}: a non-finite update was skipped")
        check(engine.weight_version == 3,
              f"weight_version {engine.weight_version} after 2 steps, not 3")
        for (name, a), (_, e) in zip(_leaves(actor.params), _leaves(engine.params)):
            check(torch.equal(a.detach(), e),
                  f"the engine's {name} differs from the actor's after the push")
        for name in TRAIN_KERNELS:
            check(launches[name] > 0, f"{name} was not launched in the train phase")
        moved = sum(int((a.detach() != r).sum()) for (_, a), (_, r) in
                    zip(_leaves(actor.params), _leaves(trainer.ref_policy.params)))
        n_params = sum(p.numel() for _, p in _leaves(actor.params))

        # logprob agreement on step 1, and its planted fault
        log(f"train: step-1 old logprobs (K4) vs the engine's rollout logprobs "
            f"over {step1['tokens']} response tokens: max {step1['gap_max']:.4f}, "
            f"mean {step1['gap_mean']:.5f} nats (tolerance {LOGP_AGREE_TOL}); "
            f"with tile-local segment ids: max {step1['bad_max']:.4f}, mean "
            f"{step1['bad_mean']:.4f} (must fail)")
        check(step1["gap_max"] <= LOGP_AGREE_TOL,
              f"old logprobs disagree with the engine's ({step1['gap_max']:.4f} "
              f"nats > {LOGP_AGREE_TOL})")
        check(step1["bad_max"] > LOGP_AGREE_TOL,
              "the logprob gate passes tile-local segment ids")

        # gradient gate: one micro of step 1, K4 against the plain
        # attention, on the weights step 1's old logprobs came from (its
        # update's own gradient; after the fit the micro is two updates
        # stale, most of its tokens sit in the PPO clip, and a one-ulp
        # change of the forward moves some across a clip edge: see
        # GRAD_COS_MIN), gated in bf16 (the kernel instance the main path
        # runs) and on an f32 copy (where the comparison sees the kernel's
        # error alone)
        micro = gate_micro(step1["feed"], dev)
        with launches_apart(gate_launches), params_swapped(
                actor, step1_weights(step1.pop("weights"), dev)):
            readings = both_precisions(actor, micro)
        bf16_line = gradient_gate(readings["bf16"], GRAD_COS_MIN_BF16, "bf16")
        f32_line = gradient_gate(readings["f32"], GRAD_COS_MIN, "f32")
        log(f"train: micro gradient at step 1's weights, K4 vs plain attention "
            f"on {f32_line}; on the {bf16_line}")

        for i, rec in enumerate(history, 1):
            log(f"train: step {i}: wall {rec['perf/step_time_s']:.2f} s; "
                + ", ".join(f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
                    "gen", "reward", "old_log_prob", "ref_log_prob", "adv",
                    "update_actor", "update_weight"))
                + f"; tokens/s {rec['perf/throughput_tokens_per_s']:.1f}, mfu "
                f"{rec['perf/mfu']:.5f}, pg_loss {rec['actor/pg_loss']:.5f}, "
                f"kl_loss {rec['actor/kl_loss']:.3g}, grad_norm "
                f"{rec['actor/grad_norm']:.4f}, reward/mean {rec['reward/mean']:.3f}")
        log("train: " + engine_line(engine))
        log(f"train: fit wall {fit_wall:.1f} s; peak memory {peak_gb:.2f} GB "
            f"(torch.cuda.max_memory_allocated); {moved} of {n_params} weights "
            f"moved from the reference copy; main-path launches "
            f"{json.dumps(launches)}; the gates' own launches "
            f"{json.dumps(gate_launches)}")
        return dict(launches=launches, history=history, peak_gb=peak_gb,
                    decode_dispatches=engine.decode_dispatches)
    finally:
        for fn in reversed(cleanup):
            fn()


def engine_line(engine) -> str:
    """The colocated engine's dispatch counters over its life."""
    n = max(engine.decode_dispatches, 1)
    return (f"engine (pipeline_depth {engine.pipeline_depth}): "
            f"{engine.decode_dispatches} decode dispatches, "
            f"{engine.graph_replays} graph replays, {engine.graph_captures} "
            f"captures in {engine.graph_capture_s:.2f} s (keys "
            f"{sorted(map(str, engine._graphs))}), host ms per dispatch "
            f"{engine.decode_host_s / n * 1e3:.3f} (captures included)")


class WrittenOutAttention(torch.autograd.Function):
    """The plain attention (f32 logits, softmax and products on bf16
    inputs, the output rounded once) with its backward written out, so
    that the softmax backward's delta = rowsum(dO * O) can be taken from
    the output as returned (``rounded``: bf16, the semantics of K4 and of
    the TPU kernel) or from the f32 output before rounding (what autograd
    through the plain attention computes, up to summation order). A probe
    of the gradient gate, never on a main path."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, rounded: bool):
        b, t, hq, d = q.shape
        seg = attn_mask.to(torch.int32)
        mask = ((seg[:, :, None] == seg[:, None, :])
                & torch.ones((t, t), dtype=torch.bool, device=q.device).tril())
        p, o32 = WrittenOutAttention._probs_out(q, k, v, mask)
        out = o32.reshape(b, t, hq, d).to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, out if rounded else o32)
        return out

    @staticmethod
    def _probs_out(q, k, v, mask):
        b, t, hq, d = q.shape
        hkv = k.shape[2]
        qg = q.reshape(b, t, hkv, hq // hkv, d).float()
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * d ** -0.5
        logits = torch.where(mask[:, None, None], logits, flash.MASK_VALUE)
        p = torch.softmax(logits, dim=-1)
        return p, torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, o = ctx.saved_tensors
        b, t, hq, d = q.shape
        hkv = k.shape[2]
        p, _ = WrittenOutAttention._probs_out(q, k, v, mask)
        do = dout.reshape(b, t, hkv, hq // hkv, d).float()
        delta = (do * o.reshape(do.shape).float()).sum(-1)  # [b, q, h, r]
        dp = torch.einsum("bqhrd,bkhd->bhrqk", do, v.float())
        ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * d ** -0.5
        qg = q.reshape(b, t, hkv, hq // hkv, d).float()
        dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, k.float()).reshape(q.shape)
        dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg)
        dv = torch.einsum("bhrqk,bqhrd->bkhd", p, do)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def written_out_attention(rounded: bool):
    return lambda q, k, v, attn_mask: WrittenOutAttention.apply(
        q, k, v, attn_mask, rounded)


def clip_branch(actor, micro, attn_fn):
    """Per response token of ``micro``, the branch its PPO loss term takes
    at the actor's weights with ``attn_fn``: 0 the ratio itself, 1 the
    clipped ratio, 2 the dual clip (vanilla loss, ``core_algos``); and the
    ratio."""
    keep = actor.attn_fn
    actor.attn_fn = attn_fn
    try:
        lp, _ = actor.compute_log_prob(micro, compute_entropy=False)
    finally:
        actor.attn_fn = keep
    c = actor.cfg
    lo = c.clip_ratio_low if c.clip_ratio_low is not None else c.clip_ratio
    hi = c.clip_ratio_high if c.clip_ratio_high is not None else c.clip_ratio
    adv = micro["advantages"]
    ratio = torch.exp(torch.clamp(lp.float() - micro["old_log_probs"], -20.0, 20.0))
    l1, l2 = -adv * ratio, -adv * torch.clamp(ratio, 1.0 - lo, 1.0 + hi)
    branch = (l2 > l1).int()
    dual = (adv < 0) & (torch.maximum(l1, l2) > -adv * c.clip_ratio_c)
    return torch.where(dual, 2, branch), ratio


def grad_gate_probes(actor, micro) -> dict:
    """On the bf16 weights, the cosine of the micro's full-model gradient
    between pairs of attentions: K4 and the plain attention (the gate);
    the plain attention and its written-out backward with delta from the
    f32 output (summation order alone: the bf16 model's noise floor) and
    from the bf16 output (K4's delta semantics); K4 and the latter; K4
    and the plain attention with the PPO clips switched off (a smooth
    loss). Also the response tokens whose clip branch differs between K4
    and the plain attention, and those within 1e-3 of a clip edge."""
    g = {name: micro_loss_grads(actor, micro, fn) for name, fn in (
        ("k4", flash.auto_train_attention()), ("plain", plain_attention),
        ("delta_f32", written_out_attention(False)),
        ("delta_bf16", written_out_attention(True)))}
    out = {f"{a} vs {b}": grad_agreement(g[a], g[b])[0] for a, b in (
        ("k4", "plain"), ("delta_f32", "plain"), ("delta_bf16", "plain"),
        ("k4", "delta_bf16"))}
    del g
    keep = actor.cfg
    actor.cfg = dataclasses.replace(keep, clip_ratio=1e9, clip_ratio_low=None,
                                    clip_ratio_high=None, clip_ratio_c=1e9)
    try:
        out["k4 vs plain, clips off"] = grad_agreement(
            micro_loss_grads(actor, micro, flash.auto_train_attention()),
            micro_loss_grads(actor, micro, plain_attention))[0]
    finally:
        actor.cfg = keep
    mask = micro["response_mask"] > 0
    bk, rk = clip_branch(actor, micro, flash.auto_train_attention())
    bp, _ = clip_branch(actor, micro, plain_attention)
    lo = keep.clip_ratio_low if keep.clip_ratio_low is not None else keep.clip_ratio
    hi = keep.clip_ratio_high if keep.clip_ratio_high is not None else keep.clip_ratio
    edge = torch.minimum((rk - (1 - lo)).abs(), (rk - (1 + hi)).abs()) < 1e-3
    out["tokens"] = int(mask.sum())
    out["clip branch differs"] = int(((bk != bp) & mask).sum())
    out["clipped (K4)"] = int(((bk > 0) & mask).sum())
    out["within 1e-3 of a clip edge"] = int((edge & mask).sum())
    return out


def grad_gate_sweep(dev, seeds: list[int]) -> None:
    """``--grad-seeds``: the train phase's micro gradient gate at other
    values of ``trainer.seed`` (the random weights and the sampling), each
    after the same 2-step fit on the same configuration: its readings on
    the step-1 weights (where the gate reads), and on the bf16 weights
    after the fit (where it read before), each with ``grad_gate_probes``.
    Logged, not gated: this measures the gate's spread against its limits
    (GRAD_COS_MIN_BF16, GRAD_COS_MIN), which stay as they are."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    keys = ("input_ids", "positions", "attention_mask", "responses",
            "response_mask", "advantages", "old_log_probs", "ref_log_probs")
    got: dict = {"bf16": [], "f32": [], "final": []}
    for seed in seeds:
        cfg = load_config(None, TRAIN_OVERRIDES + [f"trainer.seed={seed}"])
        cleanup: list = []
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        try:
            feed: dict = {}
            process = trainer._process_ibatch

            def keep_first(ibatch, metrics):
                out = process(ibatch, metrics)
                if not feed:
                    feed.update({k_: np.array(out[k_]) for k_ in keys})
                    feed["weights"] = _tree_map(host_copy,
                                                trainer.actor.params)
                return out

            trainer._process_ibatch = keep_first
            trainer.fit()
            actor = trainer.actor
            weights = step1_weights(feed.pop("weights"), dev)
            micro = gate_micro(feed, dev)
            with params_swapped(actor, weights):
                readings = both_precisions(actor, micro)
                probes1 = grad_gate_probes(actor, micro)
            del weights
            final = both_precisions(actor, micro)["bf16"]
            probes = grad_gate_probes(actor, micro)
        finally:
            for fn in reversed(cleanup):
                fn()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        for prec, (cos, ratio, bad_cos, bad_ratio) in readings.items():
            got[prec].append(cos)
            log(f"grad seeds: trainer.seed {seed}, step-1 {prec} weights (the "
                f"gate): cosine {cos:.6f}, norm ratio {ratio:.5f}; tile-local "
                f"fault cosine {bad_cos:.4f}, norm ratio {bad_ratio:.4f}")
        got["final"].append(final[0])
        for label, pr in (("step-1", probes1), ("final", probes)):
            log(f"grad seeds: trainer.seed {seed}, {label} bf16 weights, "
                "probes: " + ", ".join(
                    f"{k_} {v:.6f}" if isinstance(v, float) else f"{k_} {v}"
                    for k_, v in pr.items()))
    for prec, lim in (("bf16", GRAD_COS_MIN_BF16), ("f32", GRAD_COS_MIN),
                      ("final", GRAD_COS_MIN_BF16)):
        c = got[prec]
        log(f"grad seeds: {prec} cosine over seeds {seeds}: min {min(c):.6f}, "
            f"median {statistics.median(c):.6f}, max {max(c):.6f}; "
            f"{sum(x < lim for x in c)} of {len(c)} below the limit {lim}")


# -- phase 5: PPO with a critic on packed rows, pipelined, through the trainer --


PACK_LEN = 1024
PPO_RESPONSE = 256
VAL_RESPONSE = 64
PACK_KEYS = ("input_ids", "positions", "attention_mask", "segment_ids",
             "loss_mask")
K4_NAMES = ("flash_attention_fwd", "flash_attention_bwd")
PPO_KERNELS = ("paged_kv_write_fused", "paged_attention") + K4_NAMES
# the critic's packed values against its padded ones, by relative Frobenius
# error over the response tokens: both passes run the same bf16 weights
# through K4 in another layout (other matrix shapes, so other bf16 rounding
# orders) through 28 layers, which moves the logprobs by up to 0.1 nats in
# the same comparison; an H100 reads 0.027, and the packs with collapsed
# segments 1.08
PACKED_VALUE_TOL = 5e-2


def ppo_overrides(val_path: str) -> list[str]:
    """The phase's configuration: the train phase's model, engine and batch
    with the critic (GAE), packed rows of 1024 columns (4 per micro), the
    pipeline one step ahead with importance correction, and validation
    before training and after every step."""
    return [
        "device=cuda", f"model.preset={MODEL}", "model.dtype=bfloat16",
        "tokenizer.kind=byte", "data.train_path=arithmetic",
        f"data.val_path={val_path}",
        "rollout.max_slots=64", "rollout.page_size=64", "rollout.num_pages=512",
        "rollout.max_seq_len=512", "rollout.prompt_buckets=64",
        "trainer.train_batch_size=2", "trainer.rollout_n=8",
        "trainer.ppo_mini_batch_size=16", "trainer.micro_batch_size=4",
        "trainer.min_stream_batch_size=16", "trainer.max_prompt_length=64",
        f"trainer.max_response_length={PPO_RESPONSE}",
        "trainer.adv_estimator=gae", "trainer.use_remove_padding=true",
        f"trainer.pack_len={PACK_LEN}",
        f"trainer.micro_token_budget={4 * PACK_LEN}",
        "trainer.pipeline_depth=1", "trainer.staleness_limit=1",
        "trainer.rollout_is_correction=true",
        "trainer.val_before_train=true", "trainer.test_freq=1",
        "trainer.val_temperature=0.0",
        f"trainer.val_max_response_length={VAL_RESPONSE}",
        "trainer.total_steps=2", "trainer.temperature=1.0", "trainer.seed=0",
        "actor.remat=true", "actor.lr=1e-4", "critic.remat=true",
        "critic.lr=1e-4", "reward.num_workers=1",
    ]


def _host32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def packed_gates(actor, critic, ib) -> dict:
    """Step 1, after the packed old-logprob and value passes and before any
    update: those against a padded pass over the same trajectories (K4 on
    one trajectory a row), the same packs with each row's segments
    collapsed into one (the planted fault), and the packing itself."""
    from polyrl_tpu_torch.data import packing

    packs = ib.meta_info["packs"]
    mask = np.asarray(ib["response_mask"]) > 0
    feed = {k_: ib[k_] for k_ in ("input_ids", "positions", "attention_mask",
                                  "responses", "response_mask")}
    padded_lp = _host32(actor.compute_log_prob(feed, compute_entropy=False)[0])
    padded_v = _host32(critic.compute_values(feed))
    bad_lp, bad_v = np.zeros_like(padded_lp), np.zeros_like(padded_v)
    for pack, spec in packs:
        pf = {k_: np.array(pack[k_]) for k_ in PACK_KEYS}
        pf["segment_ids"] = (pf["segment_ids"] > 0).astype(np.int32)
        spec.gather_into(_host32(actor.compute_log_prob_packed(
            pf, compute_entropy=False)[0]), bad_lp)
        spec.gather_into(_host32(critic.compute_values_packed(pf)), bad_v)

    def rel(v):
        return float(np.linalg.norm((v - padded_v)[mask])
                     / np.linalg.norm(padded_v[mask]))

    gap = np.abs(np.asarray(ib["old_log_probs"]) - padded_lp)[mask]
    bad_gap = np.abs(bad_lp - padded_lp)[mask]
    segs = [int((spec.row == r).sum()) for _, spec in packs
            for r in range(spec.n_rows)]
    n_real = int(sum(np.asarray(p["attention_mask"]).sum() for p, _ in packs))
    return dict(
        gap_max=float(gap.max()), gap_mean=float(gap.mean()),
        bad_max=float(bad_gap.max()), bad_mean=float(bad_gap.mean()),
        v_rel=rel(np.asarray(ib["values"])), bad_v_rel=rel(bad_v),
        v_max=float(np.abs(np.asarray(ib["values"]) - padded_v)[mask].max()),
        v_scale=float(np.abs(padded_v[mask]).max()), tokens=int(mask.sum()),
        segs=segs, n_packs=len(packs),
        efficiency=packing.packing_efficiency([sp for _, sp in packs], n_real,
                                              packs[0][1].n_rows, PACK_LEN),
        seg_ids=np.array(packs[0][0]["segment_ids"]))


def step_line(rec: dict) -> str:
    return (f"wall {rec['perf/step_time_s']:.2f} s; " + ", ".join(
        f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
            "gen", "reward", "old_log_prob", "values", "adv", "update_actor",
            "update_critic", "update_weight", "testing", "save_checkpoint")))


def ppo_main_run(dev, cfg) -> dict:
    from polyrl_tpu_torch.ops import core_algos
    from polyrl_tpu_torch.train import build_trainer

    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor, critic, engine = trainer.actor, trainer.critic, trainer.rollout
        log(f"ppo: {MODEL} trainer with critic up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        gate_launches: dict = {}
        seen: list = []
        step1: dict = {}
        tis: list = []
        process = trainer._process_ibatch
        mixed_tis = core_algos.mixed_version_importance_weights

        def gated_process(ibatch, metrics):
            out = process(ibatch, metrics)
            seen.append(dict(versions=np.array(out["rollout_weight_versions"]),
                             mask=np.asarray(out["response_mask"]) > 0,
                             current=int(engine.weight_version)))
            if len(seen) == 1:  # the producer may be generating meanwhile:
                # set apart only K4, which it never launches
                with launches_apart(gate_launches, K4_NAMES):
                    step1.update(packed_gates(actor, critic, out))
            return out

        def recording_tis(*args, **kwargs):
            w, ratio, stats = mixed_tis(*args, **kwargs)
            tis.append((np.array(w), np.asarray(args[2]) > 0))
            return w, ratio, stats

        trainer._process_ibatch = gated_process
        core_algos.mixed_version_importance_weights = recording_tis
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        try:
            history = trainer.fit()
        finally:
            trainer._process_ibatch = process
            core_algos.mixed_version_importance_weights = mixed_tis
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        # the path and the run
        for name in PPO_KERNELS:
            check(launches[name] > 0, f"{name} was not launched in the ppo phase")
        check(len(history) == 3, f"{len(history)} records, not a validation "
              "record and 2 steps")
        check("val/test_score/mean" in history[0]
              and np.isfinite(history[0]["val/test_score/mean"]),
              "no finite validation score before training")
        for i, rec in enumerate(history[1:], 1):
            for key in ("actor/pg_loss", "critic/vf_loss", "actor/grad_norm",
                        "critic/grad_norm", "val/test_score/mean"):
                check(key in rec and np.isfinite(rec[key]),
                      f"ppo step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0 and rec["critic/grad_norm"] > 0,
                  f"ppo step {i}: a zero gradient")
            check(rec["actor/nonfinite_skips"] == 0,
                  f"ppo step {i}: a non-finite update was skipped")
        check(engine.weight_version == 3,
              f"weight_version {engine.weight_version} after 2 steps, not 3")
        trainer._wait_pushed()
        for (name, a), (_, e) in zip(_leaves(actor.params), _leaves(engine.params)):
            check(torch.equal(a.detach(), e),
                  f"the engine's {name} differs from the actor's after the fit")

        # packing, and packed against padded
        segs = step1["segs"]
        log(f"ppo: step 1 packed {len(seen[0]['mask'])} trajectories into "
            f"{step1['n_packs']} packs of 4 x {PACK_LEN}: segments per row "
            f"{segs}, packing_efficiency {step1['efficiency']:.4f}")
        check(sum(n >= 2 for n in segs) * 2 > len(segs),
              f"most packed rows should carry 2 or more segments: {segs}")
        log(f"ppo: step-1 packed old logprobs vs a padded pass over the same "
            f"{step1['tokens']} response tokens: max {step1['gap_max']:.4f}, "
            f"mean {step1['gap_mean']:.5f} nats (tolerance {LOGP_AGREE_TOL}); "
            f"each row's segments collapsed into one: max {step1['bad_max']:.4f}, "
            f"mean {step1['bad_mean']:.4f} nats, margin "
            f"{step1['bad_max'] - LOGP_AGREE_TOL:.4f} over the tolerance (must fail)")
        check(step1["gap_max"] <= LOGP_AGREE_TOL,
              f"packed old logprobs disagree with the padded pass "
              f"({step1['gap_max']:.4f} nats > {LOGP_AGREE_TOL})")
        check(step1["bad_max"] > LOGP_AGREE_TOL,
              "the packed logprob gate passes collapsed segment ids")
        log(f"ppo: step-1 packed values vs padded: relative error "
            f"{step1['v_rel']:.5f} (tolerance {PACKED_VALUE_TOL}), max "
            f"{step1['v_max']:.5f} of values up to {step1['v_scale']:.4f}; with "
            f"collapsed segments {step1['bad_v_rel']:.5f}")
        check(step1["v_rel"] <= PACKED_VALUE_TOL,
              f"packed values disagree with the padded pass ({step1['v_rel']:.5f})")

        # staleness and the importance weights
        lim = cfg.trainer.staleness_limit
        s2 = seen[1]
        v2 = s2["versions"][s2["mask"]]
        check((v2 >= 0).all(), "step 2 has tokens of unknown weight version")
        lags = s2["current"] - v2
        hist_lag = {int(x): int((lags == x).sum()) for x in np.unique(lags)}
        log(f"ppo: step 2 trained against weight version {s2['current']}; its "
            f"tokens' version lag (tokens per lag) {json.dumps(hist_lag)}; "
            f"staleness_limit {lim}")
        check(int(lags.max()) <= lim, f"step 2 tokens {int(lags.max())} versions "
              f"stale, limit {lim}")
        # each token carries the version of the dispatch that sampled it, so
        # a trajectory's versions never decrease
        for i, sv in enumerate(seen, 1):
            for row, m in zip(sv["versions"], sv["mask"]):
                check((np.diff(row[m]) >= 0).all(),
                      f"step {i}: a trajectory's weight versions decrease")
        n_mixed = sum(len(np.unique(row[m])) > 1 for row, m in
                      zip(s2["versions"], s2["mask"]))
        log(f"ppo: versions never decrease along a trajectory; {n_mixed} of "
            f"step 2's {len(s2['mask'])} span two versions; " + engine_line(engine))
        cap = cfg.trainer.rollout_is_cap
        w_all = np.concatenate([w[m] for w, m in tis])
        log(f"ppo: TIS weights over {len(w_all)} tokens in {len(tis)} ibatches: "
            f"min {w_all.min():.4f}, mean {w_all.mean():.4f}, max "
            f"{w_all.max():.4f} (cap {cap})")
        check(len(tis) == 2 and np.isfinite(w_all).all()
              and w_all.max() <= cap + 1e-6,
              "importance weights not finite or above the cap")

        # validation: repeatable on the same weights
        m1, m2 = trainer._validate(), trainer._validate()
        log(f"ppo: validation twice on the final weights: {json.dumps(m1)}; "
            f"{json.dumps(m2)}")
        check(m1 == m2, "two validations on the same weights disagree")

        for i, rec in enumerate(history[1:], 1):
            log(f"ppo: step {i}: {step_line(rec)}; tokens/s "
                f"{rec['perf/throughput_tokens_per_s']:.1f}, mfu "
                f"{rec['perf/mfu']:.5f}; pg_loss {rec['actor/pg_loss']:.5f}, "
                f"vf_loss {rec['critic/vf_loss']:.5f}, grad_norm actor "
                f"{rec['actor/grad_norm']:.4f} critic {rec['critic/grad_norm']:.4f}; "
                + ", ".join(f"{k_} {v:.4f}" for k_, v in sorted(rec.items())
                            if k_.startswith(("perf/pipeline_", "perf/staleness_",
                                              "perf/weight_staleness")))
                + f"; val/test_score/mean {rec['val/test_score/mean']:.4f}")
        log(f"ppo: validation before training took "
            f"{history[0]['timing_s/testing']:.2f} s; fit wall {fit_wall:.1f} s; "
            f"peak memory {peak_gb:.2f} GB; main-path launches "
            f"{json.dumps(launches)}; the gates' own K4 launches "
            f"{json.dumps(gate_launches)}")
        return dict(launches=launches, history=history, peak_gb=peak_gb,
                    fit_wall=fit_wall, seg_ids=step1["seg_ids"])
    finally:
        for fn in reversed(cleanup):
            fn()


def ppo_ab() -> None:
    """The phase's configuration without validation or gates, unpipelined
    (``pipeline_depth=0``) against pipelined, in turns (serial, pipelined,
    pipelined, serial), 3 steps each: their step walls and fit walls."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    walls: dict = {0: [], 1: []}
    for depth in (0, 1, 1, 0):
        cfg = load_config(None, ppo_overrides("") + [
            "trainer.val_before_train=false", "trainer.test_freq=0",
            f"trainer.pipeline_depth={depth}", "trainer.total_steps=3"])
        cleanup: list = []
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        try:
            t0 = time.monotonic()
            history = trainer.fit()
            torch.cuda.synchronize()
            fit_wall = time.monotonic() - t0
        finally:
            for fn in reversed(cleanup):
                fn()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        label = "pipelined" if depth else "serial"
        walls[depth] += [rec["perf/step_time_s"] for rec in history[1:]]
        for i, rec in enumerate(history, 1):
            log(f"ppo a/b {label}: step {i}: {step_line(rec)}; overlap "
                f"{rec.get('perf/pipeline_overlap_s', 0.0):.2f}")
        log(f"ppo a/b {label}: fit wall {fit_wall:.1f} s for 3 steps")
    med = {d: statistics.median(w) for d, w in walls.items()}
    log(f"ppo a/b: median wall of steps 2-3, serial {med[0]:.2f} s, pipelined "
        f"{med[1]:.2f} s ({med[1] / med[0]:.3f} x)")


def ppo_resume(tmp: str) -> None:
    """Save at step 1 on a depth-2 copy of the same widths; a fresh trainer
    resumes it (step, dataloader position, and every parameter and
    optimizer tensor of actor and critic bitwise the saved ones) and
    trains step 2 to finite values."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    ck = os.path.join(tmp, "ckpt")
    base = ppo_overrides("") + ['model.overrides={"num_layers": 2}',
                                f"trainer.ckpt_dir={ck}",
                                "trainer.val_before_train=false",
                                "trainer.test_freq=0"]
    cleanup: list = []
    try:
        ta = build_trainer(load_config(None, base + ["trainer.total_steps=1"]),
                           cleanup, compute_score=byte_length_score)
        ha = ta.fit()
        # the host snapshot: pageable copies (the save before pinned staging)
        # against the save's own pinned staging buffers (allocated by the
        # save above, reused here), in turns on the same state
        state = ta._ckpt_state()
        snaps: dict = {"pageable": [], "pinned": []}
        for kind in ("pageable", "pinned", "pinned", "pageable"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if kind == "pageable":
                copy = {n: {k_: v.detach().to("cpu", copy=True)
                            for k_, v in flat.items()} for n, flat in state.items()}
            else:
                copy = {n: ta._ckpt._host_copy(n, flat) for n, flat in state.items()}
            snaps[kind].append(time.monotonic() - t0)
            del copy
        del state
        step_dir = os.path.join(ck, "global_step_1")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        tb = build_trainer(load_config(None, base + ["trainer.total_steps=2"]),
                           cleanup, compute_score=byte_length_score)
        t0 = time.monotonic()
        check(tb._load_checkpoint(), "no checkpoint to resume")
        restore_s = time.monotonic() - t0
        check(tb.global_step == 1, f"resumed at step {tb.global_step}, not 1")
        check(tb.dataloader.consumed == ta.dataloader.consumed,
              "the resumed dataloader's position differs")
        n = 0
        for name, a, b in (("actor", ta.actor, tb.actor),
                           ("critic", ta.critic, tb.critic)):
            sa, sb = a.state_dict(), b.state_dict()
            check(sa.keys() == sb.keys(), f"{name}: other tensors after resume")
            for k_ in sa:
                check(torch.equal(sa[k_], sb[k_]),
                      f"{name} {k_} differs from the saved one after resume")
            n += len(sa)
        # the resumed trainer trains on without saving again (disk)
        tb._ckpt = None
        hb = tb.fit()
        check(len(hb) == 1 and tb.global_step == 2, "the resumed fit did not "
              "run step 2 alone")
        for key in ("actor/pg_loss", "critic/vf_loss", "actor/grad_norm",
                    "critic/grad_norm"):
            check(np.isfinite(hb[0][key]), f"resumed step 2: {key} not finite")
        log(f"ppo resume (2 layers, same widths): checkpoint of step 1 "
            f"{nbytes / 1e9:.3f} GB in {len(os.listdir(step_dir))} files; save: "
            f"host snapshot {ha[0]['timing_s/save_checkpoint']:.2f} s (pinned "
            f"staging, allocated by this first save: {ta._ckpt.last_snapshot_s:.2f}"
            f" s of it), write "
            f"{ta._ckpt.last_write_s:.2f} s; restore {restore_s:.2f} s; "
            f"{n} tensors of actor and critic bitwise equal; dataloader at "
            f"{tb.dataloader.consumed}; resumed step 2: pg_loss "
            f"{hb[0]['actor/pg_loss']:.5f}, vf_loss {hb[0]['critic/vf_loss']:.5f}, "
            f"wall {hb[0]['perf/step_time_s']:.2f} s")
        log(f"ppo snapshot a/b (the same state, in turns): pageable "
            f"{', '.join(f'{t:.2f}' for t in snaps['pageable'])} s; pinned "
            f"staging, buffers reused {', '.join(f'{t:.2f}' for t in snaps['pinned'])}"
            f" s")
    finally:
        for fn in reversed(cleanup):
            fn()


def ppo_phase(dev, ab: bool) -> dict:
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.data.dataset import make_arithmetic_dataset

    with tempfile.TemporaryDirectory(prefix="ppo-smoke-") as tmp:
        val_path = os.path.join(tmp, "val.jsonl")
        with open(val_path, "w") as f:
            for rec in make_arithmetic_dataset(8, seed=1).records:
                f.write(json.dumps(rec) + "\n")
        out = ppo_main_run(dev, load_config(None, ppo_overrides(val_path)))
        gc.collect()
        torch.cuda.empty_cache()
        if ab:
            ppo_ab()
        ppo_resume(tmp)
        gc.collect()
        torch.cuda.empty_cache()
    return out

# -- phase 6: a pretrained checkpoint in Hugging Face's layout (hf) ---------------

HF_TOKENS = 32  # greedy tokens compared between the checkpoint and the preset


def greedy_run(port: int, prompt: list[int], n: int, rid: str) -> dict:
    """One greedy request alone, from an empty prefix cache."""
    post(port, "/flush_cache", {})
    return run_requests(port, [{"rid": rid, "input_ids": prompt,
                                "sampling_params": {"temperature": 0.0,
                                                    "max_new_tokens": n}}])[0]


def hf_phase(dev) -> dict:
    """``qwen3-1.7b`` at full width and depth from ``init_params`` seed 0,
    written as a Hugging Face checkpoint (two bf16 safetensors shards,
    ``model.safetensors.index.json`` and a ``config.json`` in Qwen3's
    schema; ``hf_loader.save_hf_checkpoint``, the loader's map inverted)
    into a temp dir; ``build_from_hf`` on the card must give the config
    and every leaf of the seeded tree bitwise; the int8 load's bytes; then
    ``create_server(model=<dir>)`` must serve one greedy request with the
    tokens of ``create_server("qwen3-1.7b", seed=0)``."""
    from polyrl_tpu_torch.models import hf_loader, quant
    from polyrl_tpu_torch.rollout.serve import create_server

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    geom = dict(device=str(dev), host="127.0.0.1", port=0, max_slots=8,
                page_size=PS, max_seq_len=1024, num_pages=128, seed=0)
    prompt = serving_mix(cfg.vocab_size)[1][0]
    with tempfile.TemporaryDirectory(prefix="hf-smoke-") as tmp:
        params = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        t0 = time.monotonic()
        n_bytes = hf_loader.save_hf_checkpoint(tmp, params, cfg,
                                               model_type="qwen3", n_shards=2)
        write_s = time.monotonic() - t0
        files = sorted(os.listdir(tmp))
        check(files == ["config.json", "model-00001-of-00002.safetensors",
                        "model-00002-of-00002.safetensors",
                        "model.safetensors.index.json"], f"checkpoint files {files}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        cfg2, loaded = hf_loader.build_from_hf(tmp, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        check(cfg2 == cfg, f"config.json round trip: {cfg2} != {cfg}")
        want = dict(quant.named_leaves(params))
        got = dict(quant.named_leaves(loaded))
        check(got.keys() == want.keys(), "the loaded tree has other leaves")
        for k_ in want:
            check(torch.equal(got[k_], want[k_]),
                  f"the loaded {k_} differs from the seeded tree")
        del loaded, got
        t0 = time.monotonic()
        _, q = hf_loader.build_from_hf(tmp, dtype=torch.bfloat16, quantize="int8",
                                       device=dev)
        torch.cuda.synchronize()
        q_s = time.monotonic() - t0
        q_bytes = quant.weight_bytes(q)
        on_card = dict(quant.named_leaves(quant.quantize_params(params)))
        n_q = sum(t.numel() for k_, t in quant.named_leaves(q) if k_.endswith(".q"))
        n_diff = sum(int((t != on_card[k_]).sum())
                     for k_, t in quant.named_leaves(q) if k_.endswith(".q"))
        check(n_diff == 0, f"the host's int8 load differs from quantizing on "
              f"the card in {n_diff} of {n_q} entries")
        del q, on_card, want, params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"hf: wrote {MODEL} ({cfg.num_layers} layers) as 2 bf16 shards, "
            f"{n_bytes / 1e9:.3f} GB in {write_s:.2f} s; build_from_hf to the "
            f"card {load_s:.2f} s ({n_bytes / 1e9 / load_s:.2f} GB/s, from the "
            f"page cache), config and every leaf bitwise the seeded tree; int8 "
            f"load (quantized on the host) {q_s:.2f} s, {q_bytes / 1e9:.3f} GB "
            f"on the card; {n_diff} of {n_q} int8 entries differ from "
            f"quantizing the seeded tree on the card")
        server = create_server(tmp, **geom)
        try:
            hf_out = greedy_run(server.port, prompt, HF_TOKENS, "hf")
        finally:
            server.stop()
    server = create_server(MODEL, **geom)
    try:
        preset_out = greedy_run(server.port, prompt, HF_TOKENS, "preset")
    finally:
        server.stop()
    check(hf_out["tokens"] == preset_out["tokens"],
          "the checkpoint's server gave other greedy tokens than the preset's")
    log(f"hf: create_server(model=<dir>) served {HF_TOKENS} greedy tokens equal "
        f"to the preset engine's on the seeded tree")
    return dict(bytes=n_bytes, load_s=load_s, int8_bytes=q_bytes, int8_s=q_s)


# -- phase 7: int8 weight-only serving (quant) ---------------------------------------


def spec_bytes(cfg, nbytes: int = 2) -> float:
    """Bytes of the model's parameters at ``nbytes`` per entry."""
    def walk(specs):
        return sum(walk(v) if isinstance(v, dict) else int(np.prod(v[0]))
                   for v in specs.values())
    return walk(decoder.param_specs(cfg)) * nbytes


def dequantized_f32(tree):
    """An f32 copy of a (possibly int8) tree: ``q * scale`` per QuantWeight."""
    from polyrl_tpu_torch.models import quant

    if isinstance(tree, dict):
        return {k_: dequantized_f32(v) for k_, v in tree.items()}
    if isinstance(tree, quant.QuantWeight):
        return quant.dequantize(tree)
    return tree.float()


def quant_decode_ab(dev, cfg, trees: dict) -> dict:
    """The decode step (the fused route) captured as a CUDA graph once per
    weight tree (bf16, int8) at the serving tables, on the same pools of
    random K/V: each replay bitwise its eager step on the live slots, the
    capture's graph-pool growth logged; then AB_STEPS replays per tree in
    turns (bf16, int8, int8, bf16) with wall ms per step, and PROF_STEPS
    more per tree under torch.profiler for kernels and device ms."""
    table, lens, _ = serving_tables(dev)
    active = lens > 0
    pools = decoder.make_paged_pools(cfg, int(table.max()) + 1, PS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for p_ in pools[0] + pools[1]:
        p_.normal_(generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (S,), generator=gen, device=dev)
    graphs, outs = {}, {}
    for name, params in trees.items():
        def step(params=params):
            return decoder.forward_paged_decode(params, cfg, tokens, lens, pools,
                                                table, lens, active=active)[0]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = step().clone()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        graph = torch.cuda.CUDAGraph()
        with cuda_build.recording_launches() as rec:
            with torch.cuda.graph(graph, stream=side):
                out = step()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out[active], eager[active]),
              f"the {name} decode step's replay differs from its eager step")
        graphs[name] = (graph, rec,
                        (torch.cuda.max_memory_allocated(dev) - base) / 1e9)
        outs[name] = torch.log_softmax(out[active].float(), dim=-1)
    gap = (outs["int8"] - outs["bf16"]).abs().max().item()
    agree = (outs["int8"].argmax(-1) == outs["bf16"].argmax(-1)).float().mean().item()
    del outs

    def replay(name):
        graphs[name][0].replay()
        cuda_build.credit_launches(graphs[name][1])

    walls = {n: [] for n in trees}
    launches = {n: dict.fromkeys(cuda_build.LAUNCHES, 0) for n in trees}
    for name in ("bf16", "int8", "int8", "bf16"):
        cuda_build.reset_launch_counts()
        for _ in range(AB_STEPS // 2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            replay(name)
            torch.cuda.synchronize()
            walls[name].append((time.monotonic() - t0) * 1e3)
        for k_, n in cuda_build.LAUNCHES.items():
            launches[name][k_] += n
    out = {}
    for name in trees:
        check(launches[name]["paged_kv_write_fused"] == cfg.num_layers * AB_STEPS,
              f"the {name} replays' launches: {launches[name]}")
        pr = device_profile(lambda name=name: replay(name), PROF_STEPS)
        w = sorted(walls[name])
        out[name] = dict(wall_ms=statistics.median(w), device_ms=pr["device_ms"],
                         kernels=pr["kernels"], pool_gb=graphs[name][2])
        log(f"quant decode a/b {name} (graph replay): wall ms per step median "
            f"{out[name]['wall_ms']:.2f} (min {w[0]:.2f}, max {w[-1]:.2f}; "
            f"{len(w)} steps), device ms per step {pr['device_ms']:.3f}, kernels "
            f"per step {pr['kernels']:.1f} (+ {pr['copies']:.1f} copies/sets); "
            f"the capture grew the allocation by {graphs[name][2]:.3f} GB "
            f"(graph pool peak)")
    log(f"quant decode a/b: int8 against bf16 log-softmax of the live slots: "
        f"max |diff| {gap:.4f} nats, argmax agreement {agree:.3f} (quantization "
        f"error, not gated here)")
    del graphs
    return out


def quant_host_parity(dev) -> None:
    """``quant.quantize_tensor`` on the card against the same call on the
    host, on every projection of the seeded ``qwen3-1.7b`` tree: the int8
    entries and the f32 scales must be bitwise equal (the host path is
    pinned to the reference's numpy by the CPU tests). Also logs what the
    former divisor, the Python scalar 127.0, gives on the card (CUDA
    multiplies by its rounded reciprocal): the scales and entries that
    differ from the host's, the cause of the two paths' disagreement."""
    from polyrl_tpu_torch.models import quant

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    params = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    t0 = time.monotonic()
    n_q = n_dq = n_ds = n_old_s = n_old_q = 0
    projections = [(f"layers.{k_}", -2) for k_ in quant.QUANTIZED_LAYER_KEYS
                   if k_ in params["layers"]]
    if "lm_head" in params:
        projections.append(("lm_head", 0))
    leaves = dict(quant.named_leaves(params))
    for name, axis in projections:
        w = leaves[name]
        card = quant.quantize_tensor(w, contract_axis=axis)
        host = quant.quantize_tensor(w.cpu(), contract_axis=axis)
        n_q += card.q.numel()
        n_dq += int((card.q.cpu() != host.q).sum())
        n_ds += int((card.scale.cpu() != host.scale).sum())
        wf = w.float()
        old = wf.abs().amax(dim=axis) / 127.0 + 1e-12
        old_q = torch.clamp(torch.round(wf / old.unsqueeze(axis)), -127, 127)
        n_old_s += int((old.cpu() != host.scale).sum())
        n_old_q += int((old_q.to(torch.int8).cpu() != host.q).sum())
        del wf, old, old_q
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    log(f"quant: quantize_tensor card against host on {len(projections)} "
        f"projections: {n_dq} of {n_q} int8 entries and {n_ds} scales differ "
        f"({time.monotonic() - t0:.1f} s); with the divisor the Python scalar "
        f"127.0 on the card, {n_old_s} scales and {n_old_q} entries would")
    check(n_dq == 0 and n_ds == 0,
          "quantize_tensor on the card differs from the host's")


def quant_phase(dev) -> dict:
    """``create_server("qwen3-1.7b", weight_quant="int8")`` (the preset made
    int8 leaf by leaf on the card) at the serving geometry, over HTTP: the
    serving mix and then one greedy request twice alone, with launch
    counts zeroed just before and read just after (the fused prologue, K2
    and K3 must launch; K1 alone must not); the greedy request's two
    runs the same tokens; its logprobs within
    DENSE_LOGP_TOL of the dense f32 ``forward`` on the dequantized
    weights; a bf16 ``update_weights`` refused; the same bf16 tree pushed
    through the server's ``weight_preprocess`` (re-quantized) serving the
    first greedy tokens again; then ``quant_decode_ab``."""
    from polyrl_tpu_torch.models import quant
    from polyrl_tpu_torch.rollout.serve import create_server

    quant_host_parity(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    server = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                           max_slots=64, page_size=64, max_seq_len=4096,
                           num_pages=2048, steps_per_dispatch=8, seed=0,
                           weight_quant="int8")
    try:
        eng, port = server.engine, server.port
        cfg = eng.cfg
        int8_gb = quant.weight_bytes(eng.params) / 1e9
        bf16_gb = spec_bytes(cfg) / 1e9
        log(f"quant: {MODEL} int8 up in {time.monotonic() - t0:.1f} s; weights "
            f"{int8_gb:.3f} GB int8 (bf16 embedding and norms, f32 scales) "
            f"against {bf16_gb:.3f} GB bf16")
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)
        run_requests(port, [{"rid": "warmup", "input_ids": warm,
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})
        # the main path: the mix, then one greedy request twice alone;
        # counts zeroed just before and read just after. Whether the mix
        # alone ends on ungrouped dispatches (K2) depends on when its
        # greedy streams were admitted; the lone requests always do.
        info0 = post(port, "/get_server_info", None)
        cuda_build.reset_launch_counts()
        t_start = time.monotonic()
        outs = run_requests(port, bodies)
        wall = time.monotonic() - t_start
        mix_launches = dict(cuda_build.LAUNCHES)
        info = post(port, "/get_server_info", None)
        rep = [greedy_run(port, greedy_prompts[0], 64, f"qrep{i}") for i in range(2)]
        launches = dict(cuda_build.LAUNCHES)
        log(f"quant: main path launches {json.dumps(launches)} (the mix's "
            f"{json.dumps(mix_launches)}); the mix: " + dispatch_line(info0, info))
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"{name} was not launched serving int8: "
                  f"{json.dumps(launches)}")
        check(launches["paged_kv_write"] == 0,
              "the int8 serving path took the unfused K/V write")
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0,
                  "int8 serving: non-finite or positive logprob")
        tok_s = mix_tok_s(outs)
        ttft = [o["lines"][0][0] - o["t0"] for o in outs]
        check(rep[0]["tokens"] == rep[1]["tokens"],
              "int8 serving: the same greedy request gave different tokens")
        n_p = len(greedy_prompts[0])
        params32 = dequantized_f32(eng.params)
        x = torch.tensor([greedy_prompts[0] + rep[0]["tokens"]], device=dev)
        logits, _ = decoder.forward(params32, cfg, x,
                                    torch.arange(x.shape[1], device=dev)[None],
                                    torch.ones_like(x, dtype=torch.float32),
                                    attn_fn=flash.flash_attention_train_ref)
        lsm32 = torch.log_softmax(logits[0, n_p - 1:-1].float(), dim=-1)
        del logits, params32
        gen_t = torch.tensor(rep[0]["tokens"], device=dev)
        ref = lsm32.gather(-1, gen_t[:, None])[:, 0]
        lp_err = (ref - torch.tensor(rep[0]["logprobs"], device=dev)).abs().max().item()
        gap = (lsm32.max(dim=-1).values - ref).max().item()
        del lsm32
        log(f"quant: greedy decode vs the dense f32 forward on the dequantized "
            f"weights: max |logprob diff| {lp_err:.4f} nats, max f32 gap of the "
            f"chosen token {gap:.4f} (tolerance {DENSE_LOGP_TOL})")
        check(lp_err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
              f"int8 decode disagrees with the dense forward ({lp_err:.4f}, "
              f"{gap:.4f} nats)")
        bf = decoder.init_params(torch.Generator(device=dev).manual_seed(0),
                                 decoder.get_config(MODEL, dtype=torch.bfloat16))
        try:
            eng.update_weights(bf)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        check(bool(refused), "a bf16 update_weights into the int8 engine was accepted")
        v0 = eng.weight_version
        t0 = time.monotonic()
        server.update_weights(bf)
        torch.cuda.synchronize()
        push_s = time.monotonic() - t0
        check(eng.weight_version == v0 + 1, "the re-quantized push did not land")
        after = greedy_run(port, greedy_prompts[0], 64, "qpush")
        check(after["tokens"] == rep[0]["tokens"],
              "the re-quantized push (the same seed-0 weights) serves other tokens")
        log(f"quant: a bf16 update_weights refused ({refused[:90]}...); the same "
            f"tree through weight_preprocess (re-quantized on the card, "
            f"{push_s:.2f} s) installed as version {eng.weight_version} and served "
            f"the same greedy tokens")
        ab = quant_decode_ab(dev, cfg, {"bf16": bf, "int8": eng.params})
        del bf
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"quant: decode "
            f"{tok_s:.1f} tok/s over 18 streams (the serve phase's mix, its first "
            f"run with the capture), TTFT median "
            f"{statistics.median(ttft) * 1e3:.1f} ms; {wall:.2f} s; peak "
            f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)")
        return dict(launches=launches, tok_s=tok_s, peak_gb=peak_gb,
                    int8_gb=int8_gb, bf16_gb=bf16_gb, ab=ab)
    finally:
        server.stop()


# -- phase 8: LoRA training, optimizer offload, step profiling (lora) ----------------

LORA_RANK = 16
LORA_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


def lora_phase(dev, full_peak_gb: float) -> dict:
    """The train phase's configuration with ``actor.lora_rank=16
    lora_alpha=16``, 2 GRPO steps. Gates: finite losses and grad norms,
    the frozen leaves (every base, embed, norms) bitwise the reference
    policy's copy of the initial weights, every ``b`` moved from zero, the
    engine after each push bitwise ``merge_lora(actor.params)``, step 1's
    old logprobs within LOGP_AGREE_TOL of the engine's, K4 forward and
    backward launched (counted from zero). ``offload_checks`` follows it
    in ``main``, once this phase's trainer is gone."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.models import lora, quant
    from polyrl_tpu_torch.train import build_trainer

    cfg = load_config(None, TRAIN_OVERRIDES + [f"actor.lora_rank={LORA_RANK}",
                                               "actor.lora_alpha=16"])
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor, engine, ref = trainer.actor, trainer.rollout, trainer.ref_policy
        n_train = lora.num_trainable(actor.params)
        opt_bytes = sum(t.numel() * t.element_size()
                        for t in actor.opt_state.mu + actor.opt_state.nu)
        log(f"lora: trainer up in {time.monotonic() - t0:.1f} s; rank "
            f"{LORA_RANK}, {n_train} trainable parameters "
            f"({n_train / 1e6:.2f} M) in {len(actor._named)} tensors, optimizer "
            f"state {opt_bytes / 1e9:.4f} GB; "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        pushes: list[bool] = []
        push = trainer._push_weights

        def checked_push(block: bool = True) -> None:
            push(block)
            with torch.no_grad():
                merged = dict(quant.named_leaves(lora.merge_lora(actor.params)))
            pushes.append(all(torch.equal(e, merged[n].detach())
                              for n, e in quant.named_leaves(engine.params)))

        step1: dict = {}
        process = trainer._process_ibatch

        def first_ibatch_gate(ibatch, metrics):
            out = process(ibatch, metrics)
            if not step1:
                mask = np.asarray(out["response_mask"]) > 0
                gap = np.abs(np.asarray(out["old_log_probs"])
                             - np.asarray(out["rollout_log_probs"]))[mask]
                step1.update(gap_max=float(gap.max()), gap_mean=float(gap.mean()),
                             tokens=int(mask.sum()))
            return out

        trainer._push_weights = checked_push
        trainer._process_ibatch = first_ibatch_gate
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        trainer._push_weights, trainer._process_ibatch = push, process

        check(len(history) == 2, "the LoRA fit did not run 2 steps")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(np.isfinite(rec[key]), f"lora step {i}: {key} not finite")
            check(rec["actor/grad_norm"] > 0, f"lora step {i}: zero gradient")
            check(rec["actor/nonfinite_skips"] == 0, f"lora step {i}: skipped update")
        check(pushes == [True] * 3, f"the engine after each push equal to the "
              f"merge: {pushes}")
        check(engine.weight_version == 3, f"weight_version {engine.weight_version}")
        for k_, w in actor.params["layers"].items():
            want = ref.params["layers"][k_]
            if isinstance(w, quant.LoraWeight):
                check(torch.equal(w.base, want), f"the frozen base of {k_} moved")
                check(float(w.b.detach().abs().max()) > 0, f"{k_}.b stayed zero")
            else:
                check(torch.equal(w, want), f"the frozen {k_} moved")
        for k_ in ("embed", "final_norm"):
            check(torch.equal(actor.params[k_], ref.params[k_]), f"{k_} moved")
        for name in LORA_KERNELS:
            check(launches[name] > 0, f"{name} was not launched in the LoRA fit")
        check(step1["gap_max"] <= LOGP_AGREE_TOL,
              f"LoRA old logprobs disagree with the engine's ({step1['gap_max']:.4f})")
        log(f"lora: step-1 old logprobs (K4 through the wrapped projections) vs "
            f"the engine's over {step1['tokens']} tokens: max "
            f"{step1['gap_max']:.4f}, mean {step1['gap_mean']:.5f} nats "
            f"(tolerance {LOGP_AGREE_TOL}); the engine bitwise merge_lora(actor."
            f"params) after each of 3 pushes; frozen leaves bitwise; every b moved")
        for i, rec in enumerate(history, 1):
            log(f"lora: step {i}: wall {rec['perf/step_time_s']:.2f} s; "
                + ", ".join(f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
                    "gen", "old_log_prob", "ref_log_prob", "update_actor",
                    "update_weight"))
                + f"; pg_loss {rec['actor/pg_loss']:.5f}, grad_norm "
                f"{rec['actor/grad_norm']:.4f}")
        log(f"lora: fit wall {fit_wall:.1f} s; peak {peak_gb:.2f} GB against "
            f"{full_peak_gb:.2f} GB for the full fine-tune (train phase); "
            f"main-path launches {json.dumps(launches)}")
        return dict(launches=launches, peak_gb=peak_gb, n_train=n_train,
                    opt_bytes=opt_bytes, history=history)
    finally:
        for fn in reversed(cleanup):
            fn()


def offload_micro(dev, cfg, seed: int) -> dict:
    """A synthetic micro at the train phase's shapes (4 rows, 64 + 448
    tokens)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, tp, tr = 4, 64, 448
    ids = torch.randint(1, cfg.vocab_size, (b, tp + tr), generator=g, device=dev)
    return {"input_ids": ids,
            "positions": torch.arange(tp + tr, device=dev).expand(b, -1).int(),
            "attention_mask": torch.ones((b, tp + tr), device=dev),
            "responses": ids[:, tp:], "response_mask": torch.ones((b, tr), device=dev),
            "advantages": torch.randn((b, tr), generator=g, device=dev),
            "old_log_probs": -12.0 + 0.1 * torch.randn((b, tr), generator=g,
                                                       device=dev)}


def offload_checks(dev) -> dict:
    """Optimizer offload on the full fine-tune. (1) Two actors from the
    same seeded weights take two AdamW steps on the same micros, one with
    its moments offloaded after each step and loaded back before the next:
    every parameter bitwise the other's. (2) The train phase's fit with
    ``actor.offload_optimizer=true`` and ``trainer.profile_steps=2``: the
    device memory each offload frees and the seconds of each offload and
    load, the moments on the host after the fit, and a torch.profiler trace
    of step 2 under ``profile_dir`` naming K4's kernels."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.models import quant
    from polyrl_tpu_torch.train import build_trainer
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    mcfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    finals = []
    for offload in (False, True):
        actor = StreamActor(mcfg, ActorConfig(lr=1e-4, remat=True,
                                              offload_optimizer=offload),
                            decoder.init_params(torch.Generator(device=dev)
                                                .manual_seed(0), mcfg))
        for i in range(2):
            actor.update_stream(offload_micro(dev, mcfg, 30 + i), is_opt_step=True)
            actor.offload_opt_state()
        check(actor._opt_offloaded == offload, "offload state after the steps")
        finals.append(dict(quant.named_leaves(actor.params)))
        del actor
        gc.collect()
        torch.cuda.empty_cache()
    for k_, v in finals[0].items():
        check(torch.equal(v, finals[1][k_]),
              f"two steps with offload differ from the same without it at {k_}")
    del finals
    gc.collect()
    torch.cuda.empty_cache()
    log("lora offload: two full-width AdamW steps with the moments offloaded "
        "after each are bitwise the same steps without offload")

    with tempfile.TemporaryDirectory(prefix="offload-smoke-") as tmp:
        prof_dir = os.path.join(tmp, "prof")
        cfg = load_config(None, TRAIN_OVERRIDES + [
            "actor.offload_optimizer=true", "trainer.profile_steps=2",
            f"trainer.profile_dir={prof_dir}"])
        torch.cuda.reset_peak_memory_stats(dev)
        cleanup: list = []
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        try:
            actor = trainer.actor
            offloads, loads = [], []
            off, load = actor.offload_opt_state, actor.load_opt_state

            def timed_offload():
                torch.cuda.synchronize()
                before, t0 = torch.cuda.memory_allocated(dev), time.monotonic()
                off()
                torch.cuda.synchronize()
                offloads.append((time.monotonic() - t0,
                                 (before - torch.cuda.memory_allocated(dev)) / 1e9))

            def timed_load():
                if not actor._opt_offloaded:
                    return
                torch.cuda.synchronize()
                t0 = time.monotonic()
                load()
                torch.cuda.synchronize()
                loads.append(time.monotonic() - t0)

            actor.offload_opt_state, actor.load_opt_state = timed_offload, timed_load
            history = trainer.fit()
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            check(len(history) == 2, "the offload fit did not run 2 steps")
            check(actor._opt_offloaded and all(
                t.device.type == "cpu" and t.is_pinned()
                for t in actor.opt_state.mu + actor.opt_state.nu),
                "the moments are not in pinned host memory after the fit")
            for i, rec in enumerate(history, 1):
                check(np.isfinite(rec["actor/grad_norm"]) and rec["actor/grad_norm"] > 0,
                      f"offload step {i}: bad grad norm")
            check(len(offloads) == 2 and len(loads) == 1,
                  f"{len(offloads)} offloads and {len(loads)} loads in 2 steps")
            traces = trainer.profile_traces
            check(len(traces) == 1 and os.path.dirname(traces[0]) == prof_dir,
                  f"profile traces {traces}")
            with open(traces[0]) as f:
                text = f.read()
            k4 = [n for n in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                              "flash_dkv_bf16_kernel") if n in text]
            check(len(k4) == 3, f"the step-2 trace names K4's kernels {k4} only")
            log(f"lora offload: fit with actor.offload_optimizer: each offload "
                f"freed {', '.join(f'{g:.3f}' for _, g in offloads)} GB of device "
                f"memory in {', '.join(f'{s:.3f}' for s, _ in offloads)} s (the "
                f"copies out, to pinned buffers); the load before step 2 took "
                f"{loads[0]:.3f} s; step walls "
                + ", ".join(f"{r['perf/step_time_s']:.2f}" for r in history)
                + f" s; peak {peak_gb:.2f} GB; profile_steps=(2,) wrote "
                f"{os.path.basename(traces[0])} ({len(text) / 1e6:.1f} MB) naming "
                + ", ".join(k4))
            return dict(offloads=offloads, loads=loads, peak_gb=peak_gb,
                        history=history)
        finally:
            for fn in reversed(cleanup):
                fn()
            gc.collect()
            torch.cuda.empty_cache()




# -- main -----------------------------------------------------------------------


# -- phase 9: the engine's serving features (features) ------------------------

# a near-tie is an f32 top-2 logit gap under NEAR_TIE: two greedy runs may
# part at the reference's first one or later, and only where its gap is
# under PART_GAP: two bf16 runs that each choose tokens within
# DENSE_LOGP_TOL of the f32 best (the dense gate) can part only there (on
# an H100, correct runs parted at gaps of 0.054-0.099: bf16 moves the
# logits by more than NEAR_TIE)
NEAR_TIE = 0.05
PART_GAP = DENSE_LOGP_TOL
CHUNK_LP_TOL = 0.05    # first-token logprob, chunked against unchunked, nats
RELEASE_MIN_GB = 14.0  # the KV pool at 2,048 pages is 15.03 GB
SPEC_TOKENS, SPEC_ROUNDS = 4, 2
FEATURE_ENGINE = dict(max_slots=S, page_size=PS, max_seq_len=4096,
                      num_pages=2048, steps_per_dispatch=8, seed=0)
# the live streams' budget while the long prompt chunks in: 48 dispatches,
# so that decode dispatches are still being issued through the admission
LIVE_NEW = 384


def dense_f32_rows(params32, cfg, prompt, tokens, dev) -> torch.Tensor:
    """The dense f32 forward's log-softmax [len(tokens), V] over ``prompt``
    + ``tokens``: row ``j`` is the distribution that predicts
    ``tokens[j]``."""
    x = torch.tensor([list(prompt) + list(tokens)], device=dev)
    pos = torch.arange(x.shape[1], device=dev)[None]
    with torch.no_grad():
        h = decoder.forward_hidden(params32, cfg, x, pos,
                                   torch.ones_like(x, dtype=torch.float32),
                                   attn_fn=flash.flash_attention_train_ref)
        logits = decoder.unembed(h[0, len(prompt) - 1:-1],
                                 decoder.head_weight(params32, cfg)).float()
    return torch.log_softmax(logits, dim=-1)


def top2_gaps(params32, cfg, prompt, tokens, dev) -> np.ndarray:
    """The dense f32 forward's top-2 logit gap at each generated position
    of ``tokens`` after ``prompt``: where it is under ``NEAR_TIE``, another
    greedy run may take the other token."""
    top2 = dense_f32_rows(params32, cfg, prompt, tokens, dev).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def agrees_until_tie(got, ref, gaps) -> tuple[bool, int, int, float]:
    """(``got`` equals ``ref``, or parts from it no earlier than ``ref``'s
    first near-tie (``gaps``, ``ref``'s f32 top-2 gaps, under ``NEAR_TIE``)
    and where ``ref``'s gap is under ``PART_GAP``; the first mismatch; the
    first near-tie; the gap at the first mismatch, nan when none)."""
    n = min(len(got), len(ref))
    first = next((j for j in range(n) if got[j] != ref[j]), n)
    tie = next((j for j, g in enumerate(gaps) if g < NEAR_TIE), len(gaps))
    gap = float(gaps[first]) if first < n else float("nan")
    ok = (len(got) == len(ref) if first == n
          else first >= tie and gap < PART_GAP)
    return ok, first, tie, gap


def dense_f32_gate(params32, cfg, prompt, tokens, logprobs, dev) -> tuple:
    """The serve gate's reading for one greedy stream: max |engine - dense
    f32| logprob of the chosen tokens, and the max f32 gap of the chosen
    token below the best."""
    lsm = dense_f32_rows(params32, cfg, prompt, tokens, dev)
    gen = torch.tensor(list(tokens), device=dev)
    ref = lsm.gather(-1, gen[:, None])[:, 0]
    err = (ref - torch.tensor(list(logprobs), device=dev)).abs().max().item()
    return err, (lsm.max(dim=-1).values - ref).max().item()


def f32_copy(params: dict) -> dict:
    return {k: (f32_copy(v) if isinstance(v, dict) else v.float())
            for k, v in params.items()}


def stream_items(q, timeout: float = 600.0, into: list | None = None) -> list:
    """An engine output queue read to its end: (arrival time, line), each
    appended to ``into`` as it arrives."""
    from polyrl_tpu_torch.rollout.cb_engine import STREAM_END

    items = [] if into is None else into
    while (item := q.get(timeout=timeout)) is not STREAM_END:
        items.append((time.monotonic(), item))
    return items


def salvage_checks(eng, cfg, dev, params32) -> dict:
    """A greedy stream of budget 400 aborted after its 5th token, on the
    served engine (salvage on, the default): every token of the decode
    dispatches issued for it reaches the client before the ``abort``
    terminal, ``tokens_salvaged`` is what the fast path would have dropped
    (what the drain delivered), and prompt + partial resubmitted with the
    budget decremented hits the salvage-published pages; the stitched
    stream equals the uninterrupted run or parts from it at a near-tie,
    and its logprobs, the continuation's over the published pages
    included, hold against the dense f32 forward (``params32``). Then the
    abort-to-terminal latency with salvage on and off, in turns."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    rng = np.random.default_rng(21)
    # 120 tokens: one full page cached at admission, and any decode
    # dispatch completes the second (a page to salvage)
    prompt = rng.integers(1, cfg.vocab_size, 120).tolist()
    budget = 400
    sp = SamplingParams(temperature=0.0, max_new_tokens=budget)
    eng.flush_prefix_cache()
    ref = eng.generate([prompt], sp, timeout=600.0)[0]
    check(len(ref["token_ids"]) == budget, "the uninterrupted run fell short")
    gaps = top2_gaps(params32, cfg, prompt, ref["token_ids"], dev)

    def aborted_run(rid: str):
        ev = threading.Event()
        d0 = eng.decode_dispatches
        q = eng.submit(rid, prompt, sp, abort=ev)
        got, lps = [], []
        while len(got) < 5:
            item = q.get(timeout=600)
            got += item["token_ids"]
            lps += item["logprobs"]
        t_abort = time.monotonic()
        ev.set()
        items = stream_items(q)
        latency = items[-1][0] - t_abort
        got += [t for _, it in items for t in it["token_ids"]]
        lps += [x for _, it in items for x in it["logprobs"]]
        check(items[-1][1]["finish_reason"] == "abort",
              f"{rid}: ended {items[-1][1]['finish_reason']!r}")
        return got, lps, latency, eng.decode_dispatches - d0

    eng.flush_prefix_cache()
    seen: dict = {}
    orig = eng._abort_with_salvage

    def recording():
        seen["before"] = sum(len(i.emitted) for i in eng._slots
                             if i is not None and i.req.abort is not None
                             and i.req.abort.is_set())
        orig()

    eng._abort_with_salvage = recording
    salv0, pub0 = eng.tokens_salvaged, eng.salvage_published_pages
    try:
        got, got_lps, latency, n_disp = aborted_run("salvage")
    finally:
        eng._abort_with_salvage = orig
    k = len(got)
    salvaged = eng.tokens_salvaged - salv0
    published = eng.salvage_published_pages - pub0
    check(k == 1 + n_disp * eng.steps_per_dispatch,
          f"salvage: {k} tokens delivered, {n_disp} dispatches issued for the "
          f"stream decoded {1 + n_disp * eng.steps_per_dispatch}")
    check(salvaged == k - seen["before"] and salvaged > 0,
          f"salvage: tokens_salvaged {salvaged}, the drain delivered "
          f"{k - seen['before']}")
    ok, first, tie, gap = agrees_until_tie(got, ref["token_ids"][:k], gaps)
    check(ok, f"salvage: the partial parts from the uninterrupted run at "
              f"{first} (top-2 gap {gap:.4f}), first near-tie {tie}")
    hits0 = eng.prefix_cache.hits
    cont = eng.generate([prompt + got], dataclasses.replace(
        sp, max_new_tokens=budget - k), timeout=600.0)[0]
    hit_pages = eng.prefix_cache.hits - hits0
    check(published > 0 and hit_pages >= published,
          f"salvage: {published} pages published, the continuation hit "
          f"{hit_pages}")
    stitched = got + cont["token_ids"]
    ok, first, tie, gap = agrees_until_tie(stitched, ref["token_ids"], gaps)
    check(ok and len(stitched) == budget,
          f"salvage: the stitched stream parts from the uninterrupted run at "
          f"{first} (top-2 gap {gap:.4f}, first near-tie {tie}, "
          f"{len(stitched)} tokens)")
    err, worst_gap = dense_f32_gate(params32, cfg, prompt, stitched,
                                    got_lps + cont["logprobs"], dev)
    check(err <= DENSE_LOGP_TOL and worst_gap <= DENSE_LOGP_TOL,
          f"salvage: the stitched stream {err:.4f} / {worst_gap:.4f} nats "
          f"from the dense f32 forward")
    lat = {True: [], False: []}
    for flag in (True, False, True, False):
        eng.salvage_partials = flag
        eng.flush_prefix_cache()
        _, _, t_lat, _ = aborted_run(f"lat-{flag}-{len(lat[flag])}")
        lat[flag].append(t_lat)
    eng.salvage_partials = True
    return dict(k=k, salvaged=salvaged, published=published,
                hit_pages=hit_pages, first=first, tie=tie, gap=gap,
                dense=(err, worst_gap), n_disp=n_disp,
                latency_on=lat[True], latency_off=lat[False])


def timed_streams(qs: list) -> tuple[list, list]:
    """Read each queue on its own thread; returns (per-queue items, the
    threads), the items filling as the lines arrive."""
    outs = [[] for _ in qs]

    def read(q, out):
        stream_items(q, into=out)

    threads = [threading.Thread(target=read, args=(q, o), daemon=True)
               for q, o in zip(qs, outs)]
    for t in threads:
        t.start()
    return outs, threads


def chunk_checks(eng, cfg, dev, params32) -> dict:
    """A 3,000-token seeded prompt with ``prefill_chunk`` 512 against 0 on
    the served engine: first-token logprobs within ``CHUNK_LP_TOL``, greedy
    tokens equal or parting at a near-tie, the chunked run's logprobs
    against the dense f32 forward, the peak memory of each. Then
    the same admission while 16 greedy streams decode: at least one decode
    dispatch between consecutive chunks, and the live streams' tok/s over
    the admission, chunked against unchunked."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    rng = np.random.default_rng(22)
    long_prompt = rng.integers(1, cfg.vocab_size, 3000).tolist()
    sp = SamplingParams(temperature=0.0, max_new_tokens=32)
    res = {}
    for chunk in (512, 0):
        eng.prefill_chunk = chunk
        eng.flush_prefix_cache()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        c0 = eng.chunk_dispatches
        out = eng.generate([long_prompt], sp, timeout=600.0)[0]
        torch.cuda.synchronize(dev)
        res[chunk] = dict(out=out, chunks=eng.chunk_dispatches - c0,
                          peak_gb=(torch.cuda.max_memory_allocated(dev) - base) / 1e9)
    check(res[512]["chunks"] == 5 and res[0]["chunks"] == 0,
          f"chunk dispatches {res[512]['chunks']} / {res[0]['chunks']}")
    gaps = top2_gaps(params32, cfg, long_prompt, res[0]["out"]["token_ids"], dev)
    d_lp = abs(res[512]["out"]["logprobs"][0] - res[0]["out"]["logprobs"][0])
    check(d_lp <= CHUNK_LP_TOL,
          f"chunked: first-token logprob {d_lp:.4f} nats from unchunked")
    ok, first, tie, gap = agrees_until_tie(res[512]["out"]["token_ids"],
                                           res[0]["out"]["token_ids"], gaps)
    check(ok, f"chunked: greedy tokens part at {first} (top-2 gap {gap:.4f}), "
              f"first near-tie {tie}")
    err, worst_gap = dense_f32_gate(params32, cfg, long_prompt,
                                    res[512]["out"]["token_ids"],
                                    res[512]["out"]["logprobs"], dev)
    check(err <= DENSE_LOGP_TOL and worst_gap <= DENSE_LOGP_TOL,
          f"chunked: {err:.4f} / {worst_gap:.4f} nats from the dense f32 forward")
    live = {}
    for chunk in (512, 0):
        eng.prefill_chunk = chunk
        eng.flush_prefix_cache()
        qs = [eng.submit(f"live{chunk}-{i}",
                         rng.integers(1, cfg.vocab_size, 64).tolist(),
                         SamplingParams(temperature=0.0, max_new_tokens=LIVE_NEW))
              for i in range(16)]
        outs, threads = timed_streams(qs)
        t0 = time.monotonic()
        while min(len(o) for o in outs) < 8:
            check(time.monotonic() - t0 < 120, "live streams did not start")
            time.sleep(0.005)
        marks: list = []
        advance = eng._advance_chunk_job

        def recording():
            marks.append(eng.decode_dispatches)
            advance()

        eng._advance_chunk_job = recording
        try:
            t_sub = time.monotonic()
            first_line = stream_items(eng.submit(f"long{chunk}", long_prompt, sp))
        finally:
            eng._advance_chunk_job = advance
        t_first = first_line[0][0]
        for t in threads:
            t.join(timeout=600)
        n_live = sum(1 for o in outs for ts, _ in o if t_sub <= ts <= t_first)
        live[chunk] = dict(tok_s=n_live / max(t_first - t_sub, 1e-9),
                           admit_s=t_first - t_sub, marks=marks)
        if chunk:
            check(len(marks) == 6 and all(b > a for a, b in zip(marks, marks[1:])),
                  f"chunked: decode dispatches at each chunk {marks}")
    eng.prefill_chunk = 0
    return dict(d_lp=d_lp, first=first, tie=tie, gap=gap, dense=(err, worst_gap),
                peak_chunked=res[512]["peak_gb"], peak_whole=res[0]["peak_gb"],
                live=live)


def spec_probe_engine(dev, params, cfg, spec_tokens: int):
    """An engine of the served weights (not started: driven through its
    internals, with small pools) that has admitted a greedy GRPO group of
    8, a sampled one with filters (temperature 1, top-p 0.9, top-k 50), two
    greedy requests and the repetitive greedy prompt, and taken one decode
    dispatch."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                   num_pages=160, steps_per_dispatch=8, seed=3,
                   spec_tokens=spec_tokens, spec_rounds=SPEC_ROUNDS, device=dev)
    rng = np.random.default_rng(5)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=128)
    sampled = SamplingParams(temperature=1.0, top_p=0.9, top_k=50,
                             max_new_tokens=128)
    for g, (n_p, sp) in enumerate(((200, greedy), (203, sampled))):
        prompt = rng.integers(1, cfg.vocab_size, n_p).tolist()
        for i in range(8):
            eng.submit(f"g{g}-{i}", prompt, sp, group_id=f"grp{g}", group_size=8)
    for i, n_p in enumerate((198, 205)):
        eng.submit(f"greedy{i}", rng.integers(1, cfg.vocab_size, n_p).tolist(),
                   greedy)
    eng.submit("rep", rng.integers(1, cfg.vocab_size, 16).tolist() * 8, greedy)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._drain_emit_q()
    check(int(eng._active.sum()) == 19, f"{int(eng._active.sum())} active slots")
    return eng


def replay_ms(eng, key, reps: int = 10) -> float:
    """Device ms of one replay of ``key``'s graph (CUDA events, median),
    the engine put back where it was."""
    graph, _ = eng._graphs[key]
    snap = engine_snapshot(eng)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    engine_restore(eng, snap)
    return statistics.median(times)


def greedy_futures(eng, params32, cfg, dev, n_future: int) -> dict:
    """The dense f32 greedy continuation, ``n_future`` tokens, of each
    active greedy slot's history (its token buffer up to its length, then
    its last token) on the probe engine: the table [S, n_future], the
    history lengths [S] and the greedy slots [S] on the card, and per slot
    the continuation with its top-2 gaps."""
    st = eng._dev
    n_rows = st["tok_buf"].shape[0]
    buf = st["tok_buf"].cpu()
    seq, last = st["seq_lens"].tolist(), st["last_tokens"].tolist()
    greedy = (st["active"] & (st["temps"] <= 0)).tolist()
    table = torch.zeros((n_rows, n_future), dtype=torch.int32)
    hist_len = torch.zeros((n_rows,), dtype=torch.int32)
    cont: dict = {}
    per_slot = {}
    for s_ in (i for i in range(n_rows) if greedy[i]):
        hist = buf[s_, :seq[s_]].tolist() + [last[s_]]
        if tuple(hist) not in cont:
            toks, gaps = list(hist), []
            for _ in range(n_future):
                row = dense_f32_rows(params32, cfg, toks, [0], dev)[0]
                top2 = row.topk(2)
                gaps.append(float(top2.values[0] - top2.values[1]))
                toks.append(int(top2.indices[0]))
            cont[tuple(hist)] = (toks[len(hist):], np.array(gaps))
        per_slot[s_] = cont[tuple(hist)]
        table[s_] = torch.tensor(per_slot[s_][0], dtype=torch.int32)
        hist_len[s_] = len(hist)
    return dict(table=table.to(dev), hist_len=hist_len.to(dev),
                greedy=torch.tensor(greedy, device=dev), per_slot=per_slot)


def forced_verify_gates(seen, props, fut, params32, cfg, dev, m) -> dict:
    """The eager spec dispatch with the greedy slots' drafts forced to the
    dense f32 greedy continuation (``fut``). Gates: every round accepts
    drafts on the greedy slots; each verify row ``i`` (``0 <= i < m``:
    prompt + history + the first ``i`` drafts, so K2 reads the K/V that
    the fused prologue wrote for the same slot's earlier rows in that
    layer) holds its logprobs of the f32 best token and of the draft within
    ``DENSE_LOGP_TOL`` of the dense f32 forward, and each emitted token's
    f32 logprob is within it of the best; each greedy slot's emitted
    tokens over the rounds equal the f32 greedy continuation or part from
    it at a near-tie."""
    slots = sorted(fut["per_slot"])
    accepted, err, worst_gap = [], 0.0, 0.0
    emitted = {s_: [] for s_ in slots}
    dense: dict = {}
    for (logits, _t, _p, _k, _uf, toks, _lps, n_acc), (buf, hl, draft) in zip(seen, props):
        accepted.append(int(n_acc[slots].sum()))
        lsm_eng = torch.log_softmax(logits.float(), dim=-1)
        for s_ in slots:
            hist = buf[s_, :int(hl[s_])].tolist()
            d = draft[s_].tolist()
            key = tuple(hist + d)
            if key not in dense:
                dense[key] = dense_f32_rows(params32, cfg, hist, d + [0], dev)
            ref = dense[key]
            for i in range(m):
                want = [int(ref[i].argmax())] + d[i:i + 1]
                t = torch.tensor(want, device=dev)
                err = max(err, (lsm_eng[s_, i, t] - ref[i, t]).abs().max().item())
            for i in range(int(n_acc[s_]) + 1):
                tok = int(toks[s_, i])
                worst_gap = max(worst_gap, (ref[i].max() - ref[i, tok]).item())
                emitted[s_].append(tok)
    # a first round that accepts advances each slot by several tokens, whose
    # K/V the second round's rows read
    check(len(accepted) == SPEC_ROUNDS and accepted[0] > 0,
          f"spec: forced drafts accepted on the greedy slots per round {accepted}")
    check(err <= DENSE_LOGP_TOL and worst_gap <= DENSE_LOGP_TOL,
          f"spec: forced verify rows {err:.4f} / {worst_gap:.4f} nats from the "
          f"dense f32 forward")
    parts = []
    for s_ in slots:
        ref_toks, gaps = fut["per_slot"][s_]
        got = emitted[s_]
        ok, first, _tie, gap = agrees_until_tie(got, ref_toks[:len(got)], gaps)
        check(ok, f"spec: forced slot {s_} parts from the f32 greedy run at "
                  f"{first} (top-2 gap {gap:.4f})")
        parts.append((first, len(got)))
    return dict(accepted=accepted, ceiling=len(slots) * (m - 1), err=err,
                gap=worst_gap, parts=parts)


def spec_graph_checks(dev, params, cfg, params32) -> dict:
    """The spec dispatch (key ``("spec", True, 5, 2)``) on the probe engine,
    with the greedy slots' drafts forced to the dense f32 greedy
    continuation (at random weights prompt lookup proposes what the model
    rejects, and verify rows past the first would go unchecked): a replay
    bitwise its eager body from one snapshot (tokens, logprobs, done,
    emitted, state with the token buffer, pools); ``forced_verify_gates``
    on the eager run; the sampled rows' emitted tokens inside their
    filtered sets (the verify sampler's own logits, from the eager run);
    the device ms of a spec dispatch against the plain 8-step dispatch on a
    twin engine at the same state, and the tokens each emitted."""
    import polyrl_tpu_torch.rollout.cb_engine as cbe
    from polyrl_tpu_torch.rollout import sampling

    eng = spec_probe_engine(dev, params, cfg, SPEC_TOKENS)
    m = SPEC_TOKENS + 1
    key = eng._spec_key(True)
    body = lambda: eng._spec_body(True)  # noqa: E731
    n_future = SPEC_ROUNDS * m + 1
    fut = greedy_futures(eng, params32, cfg, dev, n_future)
    seen, props, rec = [], [], {"on": False}
    propose, verify = cbe.device_ngram_propose, cbe.spec_verify_sample_vec

    def forced(tok_buf, hist_len, n_draft):
        off = ((hist_len - fut["hist_len"]).long()[:, None]
               + torch.arange(n_draft, device=dev)[None])
        use = fut["greedy"][:, None] & (off >= 0) & (off < n_future)
        draft = torch.where(use, fut["table"].gather(1, off.clamp(0, n_future - 1)),
                            propose(tok_buf, hist_len, n_draft)).to(torch.int32)
        if rec["on"]:
            props.append((tok_buf.clone(), hist_len.clone(), draft.clone()))
        return draft

    def recording(logits, draft, gen, temps, top_ps, top_ks, use_filters=True):
        out = verify(logits, draft, gen, temps, top_ps, top_ks, use_filters)
        if rec["on"]:
            seen.append((logits, temps, top_ps, top_ks, use_filters) + out)
        return out

    cbe.device_ngram_propose = forced
    cbe.spec_verify_sample_vec = recording
    try:
        eng._graphs.pop(key, None)  # captured at setup with plain lookup
        snap = engine_snapshot(eng)
        eng._launch(key, body)  # the eager dispatch, then the capture
        engine_restore(eng, snap)
        eng._launch(key, body)
        graph_out, graph_state = engine_outputs(eng)
        engine_restore(eng, snap)
        rec["on"] = True
        eng._spec_body(True)
        rec["on"] = False
        eager_out, eager_state = engine_outputs(eng)
        engine_restore(eng, snap)
        same = [torch.equal(a, b) for a, b in zip(graph_out, eager_out)]
        check(all(same) and states_equal(graph_state, eager_state),
              f"spec: the replay differs from the eager body ({same})")
        forced_res = forced_verify_gates(seen, props, fut, params32, cfg, dev, m)
        spec_ms = replay_ms(eng, key)
    finally:
        cbe.device_ngram_propose = propose
        cbe.spec_verify_sample_vec = verify
    outside, rows = 0, 0
    for logits, temps, top_ps, top_ks, uf, toks, _lps, n_acc in seen:
        s, m_, v = logits.shape
        rep = lambda a: a.repeat_interleave(m_, dim=0)  # noqa: E731
        scaled = sampling._filtered_scaled(
            logits.reshape(s * m_, v), rep(temps), rep(top_ps), rep(top_ks),
            uf).reshape(s, m_, v)
        kept = scaled.gather(-1, toks.long()[:, :, None])[:, :, 0] > sampling.NEG_INF
        emitted = torch.arange(m_, device=dev)[None] <= n_acc[:, None]
        sampled_rows = (snap[0]["active"] & (temps > 0))[:, None] & emitted
        rows += int(sampled_rows.sum())
        outside += int((sampled_rows & ~kept).sum())
    check(rows > 0 and outside == 0,
          f"spec: {outside} of {rows} sampled tokens outside their filtered sets")
    emitted = int(graph_out[3].sum())
    del eng, seen, props
    plain = spec_probe_engine(dev, params, cfg, 0)
    tables = plain._decode_group_pack()
    pkey = plain._graph_key(True, tables)
    if pkey not in plain._graphs:
        psnap = engine_snapshot(plain)
        plain._launch_decode(True, tables)
        engine_restore(plain, psnap)
    plain_ms = replay_ms(plain, pkey)
    plain_tokens = int(plain._active.sum()) * plain.steps_per_dispatch
    del plain
    return dict(spec_ms=spec_ms, spec_tokens=emitted, plain_ms=plain_ms,
                plain_key=str(pkey), plain_tokens=plain_tokens, rows=rows,
                forced=forced_res)


def spec_checks(dev, s1, cfg, params32) -> dict:
    """``spec_tokens`` 4, ``spec_rounds`` 2 on the serve phase's mix plus a
    repetitive greedy prompt, through a second server; the mix in turns on
    both servers. Gates: greedy streams equal the plain engine's or part
    from it at a near-tie, within ``DENSE_LOGP_TOL`` of the dense f32
    forward (``params32``); launches from zero over the first spec run: the fused prologue and K2,
    no K3; then ``spec_graph_checks``."""
    from polyrl_tpu_torch.rollout.serve import create_server

    bodies, greedy_prompts, _ = serving_mix(cfg.vocab_size)
    rng = np.random.default_rng(24)
    rep_prompt = rng.integers(1, cfg.vocab_size, 16).tolist() * 8
    bodies = bodies + [{"rid": "rep", "input_ids": rep_prompt,
                        "sampling_params": {"temperature": 0.0,
                                            "max_new_tokens": 128}}]
    s2 = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                       spec_tokens=SPEC_TOKENS, spec_rounds=SPEC_ROUNDS,
                       **FEATURE_ENGINE)
    try:
        eng2 = s2.engine
        runs = {"spec": [], "plain": []}
        launches = None
        for turn, srv in (("spec", s2), ("plain", s1), ("spec", s2),
                          ("plain", s1)):
            e0 = (eng2.spec_emitted, eng2.spec_token_ceiling)
            if launches is None:
                cuda_build.reset_launch_counts()
            outs, info0, info = run_mix(srv.port, bodies, f"{turn}{len(runs[turn])}")
            if launches is None:
                launches = dict(cuda_build.LAUNCHES)
            accept = ((eng2.spec_emitted - e0[0])
                      / max(eng2.spec_token_ceiling - e0[1], 1))
            runs[turn].append(dict(outs=outs, tok_s=mix_tok_s(outs),
                                   ttft=[o["lines"][0][0] - o["t0"] for o in outs],
                                   accept=accept if turn == "spec" else None))
        check(launches["paged_kv_write_fused"] > 0 and launches["paged_attention"] > 0
              and launches["grouped_paged_attention"] == 0
              and launches["paged_kv_write"] == 0,
              f"spec: launches of the spec mix {json.dumps(launches)}")
        by_rid = lambda outs: {b["rid"]: o for b, o in zip(bodies, outs)}  # noqa: E731
        spec_o, plain_o = by_rid(runs["spec"][0]["outs"]), by_rid(runs["plain"][0]["outs"])
        worst = {}
        for rid, prompt in (("greedy0", greedy_prompts[0]),
                            ("greedy1", greedy_prompts[1]), ("rep", rep_prompt)):
            ref = plain_o[rid]["tokens"]
            gaps = top2_gaps(params32, cfg, prompt, ref, dev)
            ok, first, tie, tgap = agrees_until_tie(spec_o[rid]["tokens"], ref, gaps)
            check(ok, f"spec: {rid} parts from the plain engine at {first} "
                      f"(top-2 gap {tgap:.4f}), first near-tie {tie}")
            err, gap = dense_f32_gate(params32, cfg, prompt, spec_o[rid]["tokens"],
                                      spec_o[rid]["logprobs"], dev)
            check(err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
                  f"spec: {rid} {err:.4f} / {gap:.4f} nats from the dense f32 forward")
            worst[rid] = (round(err, 4), round(gap, 4), first, tie, round(tgap, 4))
        graphs = spec_graph_checks(dev, eng2.params, cfg, params32)
        return dict(runs=runs, launches=launches, worst=worst, graphs=graphs,
                    accept_all=eng2.spec_accept_rate,
                    spec_dispatches=eng2.spec_dispatches)
    finally:
        s2.stop()


def warm_release_checks(dev, s1, cfg, serve_ttft) -> dict:
    """Through the served engine's server: a greedy request; then
    ``/release_memory_occupation`` (at least ``RELEASE_MIN_GB`` freed) and
    ``/resume_memory_occupation``; ``warmup()`` on the resumed engine (the
    ungrouped decode graphs captured up front); the serve mix, which
    captures no ungrouped key (its GRPO groups' grouped keys are captured
    at their first dispatch, and logged); the greedy request again,
    bitwise the one before the release."""
    port, eng = s1.port, s1.engine
    bodies, greedy_prompts, _ = serving_mix(cfg.vocab_size)
    req = {"rid": "same", "input_ids": greedy_prompts[0],
           "sampling_params": {"temperature": 0.0, "max_new_tokens": 64}}
    post(port, "/flush_cache", {})
    before = run_requests(port, [req])[0]
    torch.cuda.synchronize(dev)
    m0 = torch.cuda.memory_allocated(dev)
    post(port, "/release_memory_occupation", {})
    torch.cuda.synchronize(dev)
    freed = (m0 - torch.cuda.memory_allocated(dev)) / 1e9
    check(freed >= RELEASE_MIN_GB and eng._graphs == {},
          f"release freed {freed:.2f} GB, {len(eng._graphs)} graphs kept")
    post(port, "/resume_memory_occupation", {})
    regained = (torch.cuda.memory_allocated(dev) - m0) / 1e9
    t0 = time.monotonic()
    eng.warmup()
    warm_s = time.monotonic() - t0
    warmed, capture_s = set(eng._graphs), eng.graph_capture_s
    outs, info0, info = run_mix(port, bodies, "warm")
    later = [k for k in eng._graphs if k not in warmed]
    check(all(k[2] is not None for k in later),
          f"the mix after warmup captured ungrouped keys {later}")
    post(port, "/flush_cache", {})
    after = run_requests(port, [dict(req, rid="same-again")])[0]
    check(after["tokens"] == before["tokens"]
          and after["logprobs"] == before["logprobs"],
          "the greedy request after resume differs from the one before release")
    ttft = [o["lines"][0][0] - o["t0"] for o in outs]
    return dict(freed_gb=freed, regained_gb=regained, warm_s=warm_s,
                warm_captures=len(warmed), later=[k[2] for k in later],
                later_s=eng.graph_capture_s - capture_s, ttft=ttft,
                serve_ttft=serve_ttft, tok_s=mix_tok_s(outs))


def features_phase(dev, serve_ttft: list) -> dict:
    """salvage, chunked prefill, speculation, warmup and release on
    ``qwen3-1.7b`` at full width and depth (bf16, weights from seed 0; 64
    slots, page 64, 2,048 pages, run-ahead depth 16), each step's wall
    logged."""
    from polyrl_tpu_torch.rollout.serve import create_server

    s1 = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                       **FEATURE_ENGINE)
    out: dict = {}
    try:
        cfg = s1.engine.cfg
        p32 = f32_copy(s1.engine.params)
        walls = {}
        for name, fn in (
                ("salvage", lambda: salvage_checks(s1.engine, cfg, dev, p32)),
                ("chunked", lambda: chunk_checks(s1.engine, cfg, dev, p32)),
                ("spec", lambda: spec_checks(dev, s1, cfg, p32)),
                ("warm_release", lambda: warm_release_checks(dev, s1, cfg,
                                                             serve_ttft))):
            t0 = time.monotonic()
            out[name] = fn()
            walls[name] = time.monotonic() - t0
            gc.collect()
            torch.cuda.empty_cache()
        out["walls"] = walls
    finally:
        s1.stop()
    eng = s1.engine
    check(eng.allocator.free_count == eng.num_pages - 1,
          f"{eng.num_pages - 1 - eng.allocator.free_count} pages held after stop()")
    return out


def features_lines(f: dict, smi: str) -> list[str]:
    s, c, sp, w = f["salvage"], f["chunked"], f["spec"], f["warm_release"]
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    lines = [
        f"features salvage ({smi}, this run): aborted after 5 tokens, "
        f"{s['k']} tokens delivered = 1 + {s['n_disp']} dispatches x 8; "
        f"tokens_salvaged {s['salvaged']}; {s['published']} pages published, "
        f"the continuation hit {s['hit_pages']}; stitched stream equal to the "
        f"uninterrupted run up to {s['first']} (top-2 f32 gap there "
        f"{s['gap']:.4f}; first near-tie {s['tie']}), vs dense f32 "
        f"{s['dense'][0]:.4f} / {s['dense'][1]:.4f} nats; "
        f"abort-to-terminal ms, in turns: salvage on "
        f"{[round(x * 1e3, 1) for x in s['latency_on']]}, off "
        f"{[round(x * 1e3, 1) for x in s['latency_off']]}",
        f"features chunked ({smi}, this run): 3000-token prompt, first-token "
        f"logprob chunked vs whole {c['d_lp']:.4f} nats, greedy equal up to "
        f"{c['first']} (top-2 f32 gap there {c['gap']:.4f}; first near-tie "
        f"{c['tie']}), chunked vs dense f32 {c['dense'][0]:.4f} / "
        f"{c['dense'][1]:.4f} nats; peak memory over the "
        f"admission chunked {c['peak_chunked']:.2f} GB, whole "
        f"{c['peak_whole']:.2f} GB; 16 live streams during the admission: "
        f"chunked {c['live'][512]['tok_s']:.1f} tok/s over "
        f"{c['live'][512]['admit_s'] * 1e3:.1f} ms (decode dispatches at the "
        f"chunks {c['live'][512]['marks']}), whole "
        f"{c['live'][0]['tok_s']:.1f} tok/s over "
        f"{c['live'][0]['admit_s'] * 1e3:.1f} ms",
        f"features spec ({smi}, this run): spec_tokens {SPEC_TOKENS}, rounds "
        f"{SPEC_ROUNDS}; mix of 19 streams in turns tok/s spec "
        f"{[round(r['tok_s'], 1) for r in sp['runs']['spec']]} vs plain "
        f"{[round(r['tok_s'], 1) for r in sp['runs']['plain']]}; acceptance "
        f"{[round(r['accept'], 4) for r in sp['runs']['spec']]} (all "
        f"{sp['accept_all']:.4f}); TTFT median spec "
        f"{med(sp['runs']['spec'][0]['ttft']):.1f} ms, plain "
        f"{med(sp['runs']['plain'][0]['ttft']):.1f} ms; greedy vs plain and "
        f"dense f32 (err, gap, first mismatch, first near-tie, top-2 f32 gap "
        f"at the mismatch) {json.dumps(sp['worst'])}; forced drafts (the f32 "
        f"greedy continuation) on the probe's greedy slots: accepted per "
        f"round {sp['graphs']['forced']['accepted']} of "
        f"{sp['graphs']['forced']['ceiling']}, verify rows vs dense f32 "
        f"{sp['graphs']['forced']['err']:.4f} / {sp['graphs']['forced']['gap']:.4f} "
        f"nats, (first mismatch, emitted) per slot "
        f"{sp['graphs']['forced']['parts']}; launches of the first spec mix "
        f"{json.dumps(sp['launches'])}; device ms per dispatch (19 live "
        f"slots): spec (forced drafts) {sp['graphs']['spec_ms']:.3f} ms for "
        f"{sp['graphs']['spec_tokens']} tokens, plain {sp['graphs']['plain_key']} "
        f"{sp['graphs']['plain_ms']:.3f} ms for {sp['graphs']['plain_tokens']} "
        f"tokens; sampled verify rows checked {sp['graphs']['rows']}",
        f"features warmup/release ({smi}, this run): release freed "
        f"{w['freed_gb']:.2f} GB, resume took back {w['regained_gb']:.2f} GB; "
        f"warmup {w['warm_s']:.1f} s, {w['warm_captures']} graphs captured, "
        f"the mix after it no ungrouped key, {len(w['later'])} grouped keys "
        f"{w['later']} in {w['later_s']:.2f} s, {w['tok_s']:.1f} tok/s, TTFT median "
        f"{med(w['ttft']):.1f} ms (serve phase {med(w['serve_ttft']):.1f} ms), "
        f"max {max(w['ttft']) * 1e3:.1f} ms (serve phase "
        f"{max(w['serve_ttft']) * 1e3:.1f} ms); greedy after resume bitwise",
        f"features walls ({smi}, this run): "
        + json.dumps({k: round(v, 1) for k, v in f["walls"].items()}),
    ]
    return lines


# -- phase 10: the step backend (step) ------------------------------------------

STEP_STREAMS, STEP_PROMPT, STEP_NEW = 16, 128, 256
STEP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


def step_phase(dev) -> dict:
    """``RolloutEngine.generate`` on 16 seeded prompts of 128 tokens x 256
    new tokens, greedy, against ``CBEngine`` on the same requests (in
    the same call): the same tokens up to the first near-tie, logprobs within
    ``DENSE_LOGP_TOL`` of the dense f32 forward, tok/s of each. A server
    with ``backend="step"`` streams the tokens its engine's ``generate``
    gives. Then 2 GRPO steps through ``build_trainer`` with
    ``rollout.backend=step`` at the train phase's configuration."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.engine import RolloutEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.serve import create_server
    from polyrl_tpu_torch.train import build_trainer

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = decoder.init_params(gen, cfg)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab_size, STEP_PROMPT).tolist()
               for _ in range(STEP_STREAMS)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=STEP_NEW)
    reng = RolloutEngine(cfg, params, batch_buckets=(STEP_STREAMS,),
                         prompt_buckets=(STEP_PROMPT,), device=dev)
    ceng = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                    num_pages=256, steps_per_dispatch=8, device=dev)
    walls = {"step": [], "cb": []}
    res = {}
    try:
        for name in ("step", "cb"):
            t0 = time.monotonic()
            if name == "step":
                got = reng.generate(prompts, sp)
                outs = [o.output_ids.tolist() for o in got]
                lps = [o.output_token_logprobs.tolist() for o in got]
            else:
                got = ceng.generate(prompts, sp, timeout=600.0)
                outs, lps = [o["token_ids"] for o in got], [o["logprobs"] for o in got]
            walls[name].append(time.monotonic() - t0)
            res[name] = (outs, lps)
    finally:
        ceng.stop()
    del ceng
    params32 = f32_copy(params)
    worst = (0.0, 0.0)
    ties = []
    for i, prompt in enumerate(prompts):
        gaps = top2_gaps(params32, cfg, prompt, res["cb"][0][i], dev)
        ok, first, tie, gap = agrees_until_tie(res["step"][0][i], res["cb"][0][i],
                                               gaps)
        check(ok, f"step: stream {i} parts from the CB engine at {first} "
                  f"(top-2 gap {gap:.4f}), first near-tie {tie}")
        ties.append((first, tie, round(gap, 4)))
        err, gap = dense_f32_gate(params32, cfg, prompt, res["step"][0][i],
                                  res["step"][1][i], dev)
        check(err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
              f"step: stream {i} {err:.4f} / {gap:.4f} nats from the dense f32 forward")
        worst = (max(worst[0], err), max(worst[1], gap))
    del params32, reng
    gc.collect()
    torch.cuda.empty_cache()

    srv = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                        backend="step", batch_buckets=(STEP_STREAMS,),
                        prompt_buckets=(STEP_PROMPT,), seed=0)
    try:
        body = {"rid": "step0", "input_ids": prompts[0],
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 64}}
        served = run_requests(srv.port, [body])[0]
        want = srv.engine.generate([prompts[0]], SamplingParams(
            temperature=0.0, max_new_tokens=64))[0]
        check(served["tokens"] == want.output_ids.tolist(),
              "step: the server's stream differs from the engine's generate")
        info = post(srv.port, "/get_server_info", None)
        check(info["backend"] == "step", "step: the server is not the step backend")
    finally:
        srv.stop()
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = load_config(None, TRAIN_OVERRIDES + ["rollout.backend=step",
                                                f"rollout.batch_buckets={STEP_STREAMS}"])
    cleanup: list = []
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = build_trainer(tcfg, cleanup, compute_score=byte_length_score)
    try:
        check(isinstance(trainer.rollout, RolloutEngine),
              "rollout.backend=step did not build the step engine")
        cuda_build.reset_launch_counts()
        history = trainer.fit()
        launches = dict(cuda_build.LAUNCHES)
    finally:
        for fn in cleanup:
            fn()
    check(len(history) == 2, "the step-backend fit did not run 2 steps")
    for i, rec in enumerate(history, 1):
        for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
            check(key in rec and np.isfinite(rec[key]),
                  f"step fit {i}: {key} missing or not finite")
        check(rec["actor/grad_norm"] > 0, f"step fit {i}: zero gradient")
    for name in STEP_KERNELS:
        check(launches[name] > 0, f"{name} was not launched in the step fit")
    check(trainer.rollout.weight_version == 3, "step fit: weight_version != 3")
    n_tok = STEP_STREAMS * STEP_NEW
    return dict(tok_s={k: [n_tok / w for w in v] for k, v in walls.items()},
                worst=worst, ties=ties, launches=launches,
                step_walls=[rec["perf/step_time_s"] for rec in history],
                gen_walls=[rec.get("timing_s/gen", float("nan")) for rec in history],
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


# the disagg phase: the rollout server's own KV pool (7.34 MB a page at
# full width: 3.76 GB), its geometry the train phase's engine's
DISAGG_PAGES = 512
DISAGG_SERVER = ["--max-slots", "64", "--page-size", "64", "--max-seq-len",
                 "512", "--prompt-buckets", "64", "128",
                 "--steps-per-dispatch", "8"]
DISAGG_GREEDY = 64
DISAGG_SERVER_DEADLINE_S = 300.0
# the int8 server that joins after the fit for one push: a small pool
DISAGG_INT8_PAGES = 64
# the rollout server's state polled through the fit, every this many s
TIMELINE_POLL_S = 0.05


def free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    with open(path, "rb") as f:
        return f.read()[-n:].decode(errors="replace")


def spawn_server(dev, mgr, manager_ep: str, extra: list[str],
                 procs: list) -> tuple[int, str, float]:
    """``python -m polyrl_tpu_torch.rollout.serve`` on ``MODEL`` as a
    subprocess registered through ``--manager-endpoint`` (appended to ``procs``
    at once, so teardown stops it), waited for until the manager reports
    it healthy. Returns its port, its log's path and the seconds it took."""
    port = free_port()
    endpoint = f"127.0.0.1:{port}"
    log_path = tempfile.NamedTemporaryFile(prefix="disagg-server-",
                                           suffix=".log", delete=False).name
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    with open(log_path, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "polyrl_tpu_torch.rollout.serve",
             "--model", MODEL, "--dtype", "bfloat16", "--device", dev.type,
             "--host", "127.0.0.1", "--port", str(port), "--seed", "0",
             "--manager-endpoint", manager_ep, "--transfer-streams", "4"]
            + DISAGG_SERVER + extra,
            cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT)
    procs.append((proc, port, log_path))
    while True:
        check(proc.poll() is None, "a rollout server exited "
              f"(rc {proc.returncode}): {_tail(log_path)}")
        if any(i["endpoint"] == endpoint and i["healthy"]
               for i in mgr.get_instances_status()["instances"]):
            return port, log_path, time.monotonic() - t0
        check(time.monotonic() - t0 < DISAGG_SERVER_DEADLINE_S,
              f"a rollout server never became healthy: {_tail(log_path)}")
        time.sleep(0.5)


def stream_timeline(streams: list, timeline: list, syncs: dict) -> list[dict]:
    """Each streamed step's generation as the server saw it: ``streams``
    holds (start, end, version) on the wall clock, ``timeline`` the
    server's (time, weight_version, running, queued, tokens served,
    graph captures, capture s, decode dispatches) polled through the fit,
    ``syncs`` its weight installs by version. Per stream: when the server
    raised the stream's version, admitted its first request, reached its
    most running requests, emitted its first and last token (to the
    poll's resolution), and the tokens, tok/s, decode dispatches and graph
    captures between; ``tail_s`` runs from the last token to the last
    chunk's arrival in the trainer."""
    out = []
    for s0, s1, v in streams:
        rows = [r for r in timeline if s0 - TIMELINE_POLL_S <= r[0] <= s1 + TIMELINE_POLL_S]
        if len(rows) < 2:
            out.append(dict(stream_s=s1 - s0, tokens=0))
            continue
        tok0, tok1 = rows[0][4], rows[-1][4]
        first_tok = next((r[0] for r in rows if r[4] > tok0), s1)
        last_tok = next((r[0] for r in rows if r[4] >= tok1), s1)
        admit = next((r[0] for r in rows if r[2] + r[3] > 0), first_tok)
        peak = max(r[2] for r in rows)
        full = next(r[0] for r in rows if r[2] == peak)
        busy = max(last_tok - first_tok, TIMELINE_POLL_S)
        out.append(dict(
            peak_running=peak, full_s=full - s0,
            dispatches=rows[-1][7] - rows[0][7],
            stream_s=s1 - s0,
            raised_s=syncs.get(v, {}).get("t_wall", float("nan")) - s0,
            admit_s=admit - s0, first_tok_s=first_tok - s0,
            last_tok_s=last_tok - s0, tail_s=s1 - last_tok,
            tokens=tok1 - tok0, tok_s=(tok1 - tok0) / busy,
            captures=rows[-1][5] - rows[0][5],
            capture_s=rows[-1][6] - rows[0][6]))
    return out


def disagg_phase(dev, trained: dict) -> dict:
    """The disaggregated rollout: the port's C++ manager built by ``g++``
    and spawned supervised; the rollout server a subprocess (``python -m
    polyrl_tpu_torch.rollout.serve`` on ``qwen3-1.7b``, bf16, 512 pages,
    registered through ``--manager-endpoint``); the trainer ``build_trainer`` with
    ``rollout.mode=disaggregated`` and the train phase's configuration.
    Gates: finite losses, grad norms > 0; every push verified (no push or
    verify failure, no retry) and the server's ``weight_version`` at 1 +
    the steps; every streamed token tagged with the version its stream
    started at (the serial trainer's staleness limit 1); a GRPO group of 8
    on a 64-token prompt through the manager; a greedy request through the
    manager after the last push equal to an in-process ``CBEngine`` on the
    trainer's final parameters (or parting only at a near-tie, as
    ``agrees_until_tie``), its logprobs within DENSE_LOGP_TOL of the dense
    f32 forward; launches counted from zero: the fused prologue, K2 and K3
    in the server process, K4 forward and backward in the trainer's, and
    no decode kernel in the trainer's. Logs each push split into pack,
    wire, install and swap, the version-raise latency, the step walls
    against the train phase's colocated ones, the bubble,
    ``max_local_gen_s`` and each process's peak memory, and each step's
    generation as the server saw it (its state polled every
    TIMELINE_POLL_S: the version's raise, the first admission, the first
    and last token, tok/s, graph captures). Then ``disagg_int8_push``."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.manager.client import GenerateProgress
    from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.train import build_trainer

    t0 = time.monotonic()
    sup = ManagerSupervisor(bind_addr="127.0.0.1:0", extra_args=[
        "--health-check-interval-s", "0.5", "--stats-poll-interval-s", "0.5"])
    sup.start()
    mgr_s = time.monotonic() - t0
    cleanup: list = [sup.stop]
    procs: list = []
    try:
        cfg = load_config(None, TRAIN_OVERRIDES + [
            "rollout.mode=disaggregated",
            f"rollout.manager_endpoint={sup.endpoint}",
            "rollout.transfer_streams=4", f"device={dev.type}"])
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        remote, iface = trainer.rollout, trainer.rollout.transfer
        # the server starts after the trainer registered its weight sender,
        # so the manager assigns it and its receiver connects there
        mgr = remote.manager
        port, server_log, server_up_s = spawn_server(
            dev, mgr, sup.endpoint, ["--num-pages", str(DISAGG_PAGES)], procs)
        proc = procs[0][0]
        info0 = post(port, "/get_server_info", None)
        log(f"disagg: manager built and supervised in {mgr_s:.1f} s; trainer "
            f"up; rollout server (a subprocess, {DISAGG_PAGES} pages) healthy "
            f"after {server_up_s:.1f} s; its launches before the fit "
            + json.dumps({k_: info0[f"kernel_launches/{k_}"] for k_ in SERVE_KERNELS}))

        # every streamed result, with the weight version at its stream's
        # start; each stream's start and its last chunk's arrival on the
        # wall clock (the trainer works on a chunk before it asks for the
        # next, so the generator's own end is later)
        streamed: list[tuple[int, object]] = []
        streams: list[list] = []
        inner = remote.generate_stream

        def recording_stream(*a, **kw):
            start = remote.weight_version
            span = [time.time(), time.time(), start]
            streams.append(span)
            for chunk in inner(*a, **kw):
                streamed.extend((start, r) for _, r in chunk)
                span[1] = time.time()
                yield chunk

        # the server's state through the fit, for each step's generation
        # as the server saw it
        timeline: list[tuple] = []
        # the server's flight-deck occupancy and loop-profiler device_frac
        # through the fit (what the manager's stats poll forwards)
        feed: list[tuple] = []
        poll_err: list[BaseException] = []
        polled = threading.Event()

        def poll_server():
            try:
                while not polled.is_set():
                    inf = post(port, "/get_server_info", None)
                    timeline.append((time.time(), inf["weight_version"],
                                     inf["num_running_reqs"], inf["num_queued_reqs"],
                                     inf["total_tokens_served"], inf["graph_captures"],
                                     inf["graph_capture_s"], inf["decode_dispatches"]))
                    feed.append((time.time(), inf.get("occupancy"),
                                 inf.get("device_frac")))
                    polled.wait(TIMELINE_POLL_S)
            except BaseException as exc:  # noqa: BLE001 -- checked below
                poll_err.append(exc)

        remote.generate_stream = recording_stream
        poller = threading.Thread(target=poll_server, name="disagg-poll", daemon=True)
        poller.start()
        cuda_build.reset_launch_counts()
        t2 = time.monotonic()
        try:
            history = trainer.fit()
        finally:
            polled.set()
            poller.join(timeout=30)
        fit_wall = time.monotonic() - t2
        remote.generate_stream = inner
        check(not poll_err, f"disagg: polling the server failed: {poll_err}")
        n_steps = cfg.trainer.total_steps
        check(len(history) == n_steps, "the disaggregated fit did not finish")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"disagg step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0, f"disagg step {i}: zero gradient")
            check("training/max_local_gen_s" in rec,
                  f"disagg step {i}: no balancer answer")
            # the servers' reports, aggregated by the pool
            check(rec.get("engine/occupancy", 0.0) > 0.0
                  and "engine/device_frac" in rec,
                  f"disagg step {i}: the pool has no engine/occupancy or "
                  f"engine/device_frac")
        check(all(o is not None and d is not None for _, o, d in feed),
              "disagg: the server does not report occupancy and device_frac")
        # what reached the balancer: each step's observation carries the
        # previous record's fleet aggregates (the first step's are 0)
        seen = list(remote.balance._steps)
        check([s_["occupancy"] for s_ in seen][1:]
              == [rec["engine/occupancy"] for rec in history[:-1]]
              and [s_["device_frac"] for s_ in seen][1:]
              == [rec["engine/device_frac"] for rec in history[:-1]],
              f"disagg: the balancer saw other occupancy/device_frac: {seen}")
        check(any(s_["occupancy"] > 0 for s_ in seen)
              and any(s_["device_frac"] > 0 for s_ in seen),
              f"disagg: no non-zero occupancy or device_frac reached the "
              f"balancer: {seen}")
        final = remote.weight_version
        check(final == 1 + n_steps, f"disagg: {final} pushes, not 1 + {n_steps}")
        t3 = time.monotonic()
        while post(port, "/get_server_info", None)["weight_version"] < final:
            check(proc.poll() is None, f"the rollout server exited: {_tail(server_log)}")
            check(time.monotonic() - t3 < 120, "the last push never landed")
            time.sleep(0.1)
        c = iface.counters()
        check(c["transfer/push_failures"] == 0 and c["transfer/verify_failures"] == 0
              and c["transfer/push_retries"] == 0,
              f"a push failed or was retried: {json.dumps(c)}")
        limit = cfg.trainer.staleness_limit
        stale = [(v0, r.output_token_weight_versions) for v0, r in streamed
                 if len(r.output_token_weight_versions) != len(r.output_token_ids)
                 or any(v < 0 or v0 - v > limit - 1 or v > v0
                        for v in r.output_token_weight_versions)]
        per_step = cfg.trainer.train_batch_size * cfg.trainer.rollout_n
        check(len(streamed) == n_steps * per_step and not stale,
              f"disagg: {len(streamed)} streamed results; untagged or stale "
              f"tokens in {len(stale)}")
        # a GRPO group through the manager on a full-page prompt (K3)
        rng = np.random.default_rng(2)
        vocab = trainer.actor.model_cfg.vocab_size
        # 100 tokens: one full page shared by the group (K3's prefix)
        group_prompt = rng.integers(1, vocab, 100).tolist()
        reqs = [{"rid": f"dg{i}", "input_ids": group_prompt, "group_id": "dgrp",
                 "group_size": 8, "sampling_params": {"temperature": 1.0,
                                                      "max_new_tokens": 64}}
                for i in range(8)]
        finals = [r for r in mgr.batch_generate_stream(reqs)
                  if not isinstance(r, GenerateProgress)]
        check(len(finals) == 8 and all(r.success and len(r.output_token_ids) == 64
                                       and set(r.output_token_weight_versions) == {final}
                                       for r in finals),
              "disagg: the GRPO group through the manager failed")
        greedy_prompt = rng.integers(1, vocab, 40).tolist()
        served = mgr.generate("dgreedy", greedy_prompt,
                              {"temperature": 0.0, "max_new_tokens": DISAGG_GREEDY})
        check(served.success, f"disagg greedy: {served.error}")
        info = post(port, "/get_server_info", None)
        server_launches = {k_: info[f"kernel_launches/{k_}"] - info0[f"kernel_launches/{k_}"]
                           for k_ in SERVE_KERNELS}
        trainer_launches = dict(cuda_build.LAUNCHES)
        for name in SERVE_KERNELS:
            check(server_launches[name] > 0,
                  f"{name} was not launched in the server process: "
                  f"{json.dumps(server_launches)}")
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            check(trainer_launches[name] > 0, f"{name} was not launched in the trainer")
        check(all(trainer_launches[k_] == 0 for k_ in SERVE_KERNELS),
              f"the trainer process decoded: {json.dumps(trainer_launches)}")
        trainer_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"disagg: {len(streamed)} streamed results, every token tagged "
            f"with its stream's version; the GRPO group through the manager "
            f"and the greedy request at v{final}")

        # the same greedy request on an in-process engine with the trainer's
        # final parameters
        params = trainer.actor.export_params()
        mcfg = trainer.actor.model_cfg
        eng = CBEngine(mcfg, params, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
                       max_slots=64, page_size=64, max_seq_len=512,
                       num_pages=DISAGG_PAGES, steps_per_dispatch=8,
                       prompt_buckets=(64, 128), seed=0, device=dev)
        try:
            local = eng.generate([greedy_prompt], SamplingParams(
                temperature=0.0, max_new_tokens=DISAGG_GREEDY))[0]
        finally:
            eng.stop()
        del eng
        params32 = f32_copy(params)
        gaps = top2_gaps(params32, mcfg, greedy_prompt, local["token_ids"], dev)
        ok, first, tie, gap = agrees_until_tie(served.output_token_ids,
                                               list(local["token_ids"]), gaps)
        check(ok, f"disagg greedy: served tokens part from the in-process "
              f"engine's at {first} (first near-tie {tie}, f32 gap {gap:.4f})")
        err, _ = dense_f32_gate(params32, mcfg, greedy_prompt,
                                served.output_token_ids,
                                served.output_token_logprobs, dev)
        check(err <= DENSE_LOGP_TOL, f"disagg greedy: {err:.4f} nats from the "
              "dense f32 forward")
        del params32
        lp_same = served.output_token_logprobs == list(local["logprobs"])
        check(set(served.output_token_weight_versions) == {final},
              "disagg greedy: tokens of another weight version")
        syncs = {s_["version"]: s_ for s_ in info.get("weight_syncs", [])}
        rounds = {r_["version"]: r_ for r_ in iface.sender.round_log}
        pushes = []
        for pl in iface.push_log:
            v = pl["version"]
            sy, rd = syncs.get(v, {}), rounds.get(v, {})
            pushes.append(dict(version=v, bytes=sy.get("bytes", rd.get("bytes", 0)),
                               pack_s=pl["pack_s"], wire_s=rd.get("push_s", float("nan")),
                               install_s=sy.get("install_s", float("nan")),
                               swap_s=sy.get("swap_s", float("nan")),
                               raise_s=sy.get("t_wall", float("nan")) - pl["t_wall"]))
        check(sorted(p_["version"] for p_ in pushes) == list(range(1, final + 1)),
              f"disagg: push log {pushes}")
        gen = stream_timeline(streams, timeline, syncs)
        check(len(gen) == n_steps, f"disagg: {len(gen)} streams for {n_steps} steps")
        int8 = disagg_int8_push(dev, remote, iface, sup.endpoint, params, mcfg,
                                procs)
        return dict(history=history, fit_wall=fit_wall, pushes=pushes,
                    gen=gen, int8=int8, feed=feed, streams=streams,
                    balance=dict(seen=seen, trends=remote.balance.trends()),
                    server_launches=server_launches,
                    trainer_launches=trainer_launches, trainer_peak=trainer_peak,
                    server_peak=info.get("peak_memory_bytes", 0) / 1e9,
                    greedy=dict(bitwise=served.output_token_ids == list(local["token_ids"]),
                                logprobs_bitwise=lp_same, first=first, tie=tie,
                                gap=gap, dense_err=err),
                    server_up_s=server_up_s, manager_s=mgr_s,
                    colocated=[rec["perf/step_time_s"] for rec in trained["history"]],
                    colocated_dispatches=trained["decode_dispatches"],
                    colocated_gen=[(rec.get("timing_s/gen", float("nan")),
                                    rec.get("perf/rollout_throughput_tok_s", float("nan")))
                                   for rec in trained["history"]])
    finally:
        for proc, port, _ in procs:
            if proc.poll() is not None:
                continue
            try:
                post(port, "/shutdown", {})
                proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 -- killed below
                pass
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for fn in reversed(cleanup):
            fn()


def disagg_int8_push(dev, remote, iface, manager_ep: str, params: dict, mcfg,
                     procs: list) -> dict:
    """An int8 server (``--weight-quant int8``) joins after the fit and
    takes one push of the trainer's final bf16 tree over the fabric: its
    receiver's layout comes from the bf16 template, and the push is
    re-quantized on arrival (``weight_preprocess``). Gates: the push
    verified and both servers at its version; a greedy request on the int8
    server equal to an in-process int8 ``CBEngine`` on
    ``quant.quantize_params`` of the same tree (or parting only at a
    near-tie of the dense f32 forward on the dequantized weights), within
    DENSE_LOGP_TOL of it."""
    from polyrl_tpu_torch.models import quant
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    port8, log8, up_s = spawn_server(
        dev, remote.manager, manager_ep,
        ["--weight-quant", "int8", "--num-pages", str(DISAGG_INT8_PAGES)], procs)
    port_bf16 = procs[0][1]
    v = remote.update_weights(params)
    t0 = time.monotonic()
    for p_ in (port8, port_bf16):
        # a server raises its version inside the swap and logs the install
        # just after it: wait for both
        while True:
            inf = post(p_, "/get_server_info", None)
            if inf["weight_version"] >= v and any(
                    s_["version"] >= v for s_ in inf.get("weight_syncs", [])):
                break
            check(all(pr.poll() is None for pr, _, _ in procs),
                  f"a rollout server exited: {_tail(log8)}")
            check(time.monotonic() - t0 < 120, "the int8 push never landed")
            time.sleep(0.1)
    c = iface.counters()
    check(c["transfer/push_failures"] == 0 and c["transfer/verify_failures"] == 0,
          f"the push into the int8 server failed: {json.dumps(c)}")
    info8 = post(port8, "/get_server_info", None)
    sy = {s_["version"]: s_ for s_ in info8.get("weight_syncs", [])}.get(v, {})
    rd = {r_["version"]: r_ for r_ in iface.sender.round_log}.get(v, {})
    pl = {p_["version"]: p_ for p_ in iface.push_log}.get(v, {})
    check(bool(sy), f"the int8 server logged no install of v{v}")
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, mcfg.vocab_size, 40).tolist()
    served = greedy_run(port8, prompt, DISAGG_GREEDY, "d8greedy")
    qparams = quant.quantize_params(params)
    eng = CBEngine(mcfg, qparams, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
                   max_slots=64, page_size=64, max_seq_len=512,
                   num_pages=DISAGG_INT8_PAGES, steps_per_dispatch=8,
                   prompt_buckets=(64, 128), seed=0, device=dev)
    try:
        local = eng.generate([prompt], SamplingParams(
            temperature=0.0, max_new_tokens=DISAGG_GREEDY))[0]
    finally:
        eng.stop()
    del eng
    params32 = dequantized_f32(qparams)
    del qparams
    gaps = top2_gaps(params32, mcfg, prompt, local["token_ids"], dev)
    ok, first, tie, gap = agrees_until_tie(served["tokens"],
                                           list(local["token_ids"]), gaps)
    check(ok, f"disagg int8: served tokens part from the in-process int8 "
          f"engine's at {first} (first near-tie {tie}, f32 gap {gap:.4f})")
    err, _ = dense_f32_gate(params32, mcfg, prompt, served["tokens"],
                            served["logprobs"], dev)
    del params32
    check(err <= DENSE_LOGP_TOL, f"disagg int8: {err:.4f} nats from the dense "
          "f32 forward on the dequantized weights")
    return dict(version=v, up_s=up_s, bytes=sy.get("bytes", 0),
                pack_s=pl.get("pack_s", float("nan")),
                wire_s=rd.get("push_s", float("nan")),
                install_s=sy.get("install_s", float("nan")),
                swap_s=sy.get("swap_s", float("nan")),
                raise_s=sy.get("t_wall", float("nan")) - pl.get("t_wall", float("nan")),
                bitwise=served["tokens"] == list(local["token_ids"]),
                logprobs_bitwise=served["logprobs"] == list(local["logprobs"]),
                first=first, tie=tie, gap=gap, dense_err=err,
                peak=info8.get("peak_memory_bytes", 0) / 1e9)


def disagg_lines(out: dict, smi: str) -> list[str]:
    lines = []
    for p_ in out["pushes"]:
        gb = p_["bytes"] / 1e9
        lines.append(
            f"disagg ({smi}, this run): push v{p_['version']}: {gb:.3f} GB; pack "
            f"(device to host) {p_['pack_s']:.3f} s ({gb / p_['pack_s']:.2f} GB/s), "
            f"wire (ready to verified, trailing the pack) {p_['wire_s']:.3f} s "
            f"({gb / p_['wire_s']:.2f} GB/s), install (host to device) "
            f"{p_['install_s']:.3f} s ({gb / p_['install_s']:.2f} GB/s), swap "
            f"{p_['swap_s']:.3f} s; version raised {p_['raise_s']:.3f} s after "
            f"the trainer bumped it")
    for i, rec in enumerate(out["history"], 1):
        lines.append(
            f"disagg ({smi}, this run): step {i}: wall {rec['perf/step_time_s']:.2f} s "
            f"(colocated train phase {out['colocated'][i - 1]:.2f} s); "
            + ", ".join(f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
                "reward", "old_log_prob", "ref_log_prob", "adv", "update_actor",
                "update_weight"))
            + f"; bubble {rec['perf/trainer_bubble_s']:.2f} s; max_local_gen_s "
            f"{rec['training/max_local_gen_s']:.1f}; pg_loss "
            f"{rec['actor/pg_loss']:.5f}, grad_norm {rec['actor/grad_norm']:.4f}")
        g_ = out["gen"][i - 1]
        co = out["colocated_gen"][i - 1]
        lines.append(
            f"disagg ({smi}, this run): step {i}: generation on the server: "
            f"stream to its last chunk {g_['stream_s']:.3f} s; from its start, the "
            f"version raised at {g_.get('raised_s', float('nan')):.3f} s, first "
            f"request admitted at {g_.get('admit_s', float('nan')):.3f} s, first "
            f"token at {g_.get('first_tok_s', float('nan')):.3f} s, the most "
            f"running ({g_.get('peak_running', 0)}) from "
            f"{g_.get('full_s', float('nan')):.3f} s, last token at "
            f"{g_.get('last_tok_s', float('nan')):.3f} s, the last chunk in the "
            f"trainer {g_.get('tail_s', float('nan')):.3f} s later; {g_['tokens']} tokens, "
            f"{g_.get('tok_s', float('nan')):.1f} tok/s between first and last "
            f"token; {g_.get('dispatches', 0)} decode dispatches; "
            f"{g_.get('captures', 0)} graph captures "
            f"({g_.get('capture_s', 0.0):.3f} s) (colocated train phase: gen "
            f"{co[0]:.3f} s, rollout gauge {co[1]:.1f} tok/s; its engine's "
            f"decode dispatches over both steps {out['colocated_dispatches']})")
        s0, s1, _v = out["streams"][i - 1]
        polled = [(o, d) for t_, o, d in out["feed"] if s0 <= t_ <= s1]
        lines.append(
            f"disagg ({smi}, this run): step {i}: the server's occupancy / "
            f"device_frac polled during its stream: "
            + (f"first {polled[0]}, last {polled[-1]}, max occupancy "
               f"{max(o for o, _ in polled):.4f}, max device_frac "
               f"{max(d for _, d in polled):.4f}" if polled else "none")
            + f"; the record's engine/occupancy {rec['engine/occupancy']:.4f}, "
            f"engine/device_frac {rec['engine/device_frac']:.4f}; the "
            f"balancer's observation {json.dumps(out['balance']['seen'][i - 1])}")
    tr = out["balance"]["trends"]
    lines.append(
        f"disagg ({smi}, this run): balance.trends() after the fit: "
        f"occupancy_slope {tr.get('occupancy_slope')}, device_frac_slope "
        f"{tr.get('device_frac_slope')}, valid {tr.get('balance_trends_valid')} "
        f"(the estimator zeroes every slope below three steps)")
    g = out["greedy"]
    lines.append(
        f"disagg ({smi}, this run): fit wall {out['fit_wall']:.1f} s; greedy "
        f"through the manager against the in-process engine: tokens "
        f"{'bitwise' if g['bitwise'] else 'part at %d (near-tie %d, f32 gap %.4f)' % (g['first'], g['tie'], g['gap'])}, "
        f"logprobs {'bitwise' if g['logprobs_bitwise'] else 'not bitwise'}; "
        f"{g['dense_err']:.4f} nats from dense f32; launches: server "
        + json.dumps(out["server_launches"]) + ", trainer "
        + json.dumps({k_: out["trainer_launches"][k_] for k_ in TRAIN_KERNELS})
        + f"; peak memory trainer {out['trainer_peak']:.2f} GB, server "
        f"{out['server_peak']:.2f} GB; server up in {out['server_up_s']:.1f} s, "
        f"manager built and up in {out['manager_s']:.1f} s")
    q = out["int8"]
    gb = q["bytes"] / 1e9
    lines.append(
        f"disagg ({smi}, this run): int8 server (up in {q['up_s']:.1f} s) took "
        f"push v{q['version']} of the bf16 tree: {gb:.3f} GB; pack "
        f"{q['pack_s']:.3f} s, wire {q['wire_s']:.3f} s ({gb / q['wire_s']:.2f} "
        f"GB/s), install {q['install_s']:.3f} s, swap with re-quantization "
        f"{q['swap_s']:.3f} s; raised {q['raise_s']:.3f} s after the bump; greedy "
        f"against the in-process int8 engine on quantize_params of the same "
        f"tree: tokens "
        f"{'bitwise' if q['bitwise'] else 'part at %d (near-tie %d, f32 gap %.4f)' % (q['first'], q['tie'], q['gap'])}, "
        f"logprobs {'bitwise' if q['logprobs_bitwise'] else 'not bitwise'}; "
        f"{q['dense_err']:.4f} nats from dense f32 on the dequantized weights; "
        f"int8 server peak {q['peak']:.2f} GB")
    return lines


# the memory phase: a capped engine whose sessions contend for 96 pages
# (0.70 GB of KV at qwen3-1.7b: 28 layers x K and V x 8 kv heads x 64 x 128
# x 2 B = 7,340,032 B a page), a never-spilling one of 1,024 pages
MEM_ENGINE = dict(max_slots=8, page_size=PS, max_seq_len=1024,
                  prompt_buckets=(64, 128, 256, 512), steps_per_dispatch=8,
                  seed=0, kv_cold_after_dispatches=4, kv_spill_host_gb=2.0)
MEM_PAGES = 97
MEM_BIG_PAGES = 1025
MEM_SESSIONS = 16        # two rounds of 8 (the slots), then each resumed
MEM_PROMPT = 512         # 7 full pages published a session (the 8th holds
MEM_NEW = 64             # the suffix's last token), 9 pages while decoding
MEM_MIN_PAGES = 32       # at least this many pages spilled, and restored
MEM_LP_TOL = 5e-4        # the reference's own bound, nats
MEM_GROUP_PREFIX = 448   # the grouped mix: 7 spilled pages + 16 new tokens
ACCOUNTING_BUDGET = 0.15  # accounting + spill_sweep over the loop's busy wall
MEM_AB_RUNS = 5          # planes on against off, in turns


def engine_quiet(eng, timeout: float = 120.0) -> None:
    """Wait until the engine is quiescent (no active slot, nothing
    pending, queued or in flight), read under its dispatch lock."""
    deadline = time.monotonic() + timeout
    while True:
        with eng._pool_lock:
            quiet = (not eng._active.any() and not eng._pending
                     and eng._queue.empty() and not eng._chunk_jobs
                     and eng._outstanding() == 0)
        if quiet:
            return
        check(time.monotonic() < deadline, "the engine did not go quiet")
        eng._idle.wait(0.05)


def engine_requests(eng, reqs: list[dict]) -> list[dict]:
    """Submit ``reqs`` (rid, input_ids, sampling, optional group hints) at
    once to a started engine and read every stream: tokens, logprobs,
    finish reason and each line's arrival time."""
    qs = [eng.submit(r["rid"], r["input_ids"], r["sampling"],
                     group_id=r.get("group_id", ""),
                     group_size=r.get("group_size", 0)) for r in reqs]
    outs, threads = timed_streams(qs)
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "an engine stream did not finish")
    res = []
    for r, o in zip(reqs, outs):
        res.append(dict(rid=r["rid"], t=[ts for ts, _ in o],
                        tokens=[x for _, it in o for x in it["token_ids"]],
                        logprobs=[x for _, it in o for x in it["logprobs"]],
                        reason=o[-1][1]["finish_reason"] if o else "none"))
        check(res[-1]["reason"] == "length",
              f"{r['rid']}: finish {res[-1]['reason']!r}")
    return res


def memory_sessions(eng, prompts: list, sp, between=None) -> list[dict]:
    """The sessions: two rounds of 8 fresh prompts (each round one wave,
    waited for), then each session resumed alone with its own prompt, so
    that its prefix hit lands on pages the pressure spilled; ``between()``
    runs once the first pass is quiet."""
    out = []
    for r in range(0, len(prompts), 8):
        out += engine_requests(eng, [
            {"rid": f"s{i}", "input_ids": prompts[i], "sampling": sp}
            for i in range(r, min(r + 8, len(prompts)))])
    engine_quiet(eng)
    if between is not None:
        between()
    for i, p in enumerate(prompts):
        out += engine_requests(eng, [{"rid": f"r{i}", "input_ids": p,
                                      "sampling": sp}])
    engine_quiet(eng)
    return out


def streams_gap(a: list[dict], b: list[dict]) -> tuple[bool, bool, float, list]:
    """(tokens equal everywhere, logprobs bitwise everywhere, the largest
    |logprob diff| where the tokens agree, the rids whose tokens part)."""
    toks = all(x["tokens"] == y["tokens"] for x, y in zip(a, b))
    bitwise = toks and all(x["logprobs"] == y["logprobs"] for x, y in zip(a, b))
    gap, parted = 0.0, []
    for x, y in zip(a, b):
        n = min(len(x["tokens"]), len(y["tokens"]))
        first = next((j for j in range(n) if x["tokens"][j] != y["tokens"][j]), n)
        if first < n:
            parted.append((x["rid"], first))
        if first:
            gap = max(gap, float(np.abs(np.asarray(x["logprobs"][:first])
                                        - np.asarray(y["logprobs"][:first])).max()))
    return toks, bitwise, gap, parted


def spilled_entries(eng) -> list:
    return [e for e in eng.prefix_cache._map.values() if e.spilled]


def timed_spill(eng, dev) -> tuple[list, float]:
    """Spill every unreferenced published page at once, the device idle
    before (so the copy lane is empty): (the entries, seconds from queueing
    the gather to the copies landing on the host)."""
    before = {id(e) for e in spilled_entries(eng)}
    torch.cuda.synchronize(dev)
    with eng._pool_lock:
        t0 = time.monotonic()
        eng._spill_pages(eng.num_pages, cold_only=False)
        eng.kvspill._copy_stream.synchronize()
        dt = time.monotonic() - t0
    return [e for e in spilled_entries(eng) if id(e) not in before], dt


def timed_restore(eng, dev, entries: list) -> float:
    """Restore ``entries`` at once: seconds from the host buffers to the
    pages written into the pools."""
    torch.cuda.synchronize(dev)
    with eng._pool_lock:
        t0 = time.monotonic()
        check(eng._restore_entries(entries), "the restore found no pages")
        torch.cuda.synchronize(dev)
        return time.monotonic() - t0


def memory_phase(dev) -> dict:
    """The engine's memory plane at ``qwen3-1.7b`` full width and depth
    (bf16, weights from seed 0) under a capped pool: 16 greedy sessions of
    512 random tokens and 64 new ones on 96 pages (two rounds of 8, then
    each resumed alone) spill published pages to pinned host buffers and
    restore them on their prefix hit. Gates: at least MEM_MIN_PAGES pages
    spilled and restored; the streams against a never-spilling engine of
    1,024 pages on the same requests, bitwise (else the break named, the
    floor equal tokens and logprobs within MEM_LP_TOL); the capped run with
    ``kv_spill=False`` equal tokens, logprobs within MEM_LP_TOL; at
    quiescence the ledger's attributed_frac 1.0 (its roles the allocator's
    free list plus the cache's entries, spilled ones included), the flight
    deck's 1.0, the loop profiler's at most 1 + 1e-6, accounting plus
    spill sweep under ACCOUNTING_BUDGET of the loop's busy wall; the pools
    at their addresses and no decode graph captured again after the
    restores; a grouped mix (2 GRPO groups of 8, greedy, on two spilled
    7-page prefixes plus 16 tokens) against the never-spilling engine,
    tokens equal (or parting at a logged near-tie) and logprobs within
    MEM_LP_TOL; K1 fused, K2 and K3 launched, counted from zero. Readings:
    spill (gather plus device-to-host) and restore (host-to-device plus
    ``index_copy_``) GB/s, peak pinned bytes, kv_spilled_frac,
    kv_restore_rate, HBM use and headroom, the profiler's fractions beside
    torch.profiler's busy share of the grouped mix. Then ``memory_ab``."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = decoder.init_params(gen, cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, MEM_PROMPT).tolist()
               for _ in range(MEM_SESSIONS)]
    greedy = SamplingParams(temperature=0.0, max_new_tokens=MEM_NEW)
    tails = [rng.integers(1, cfg.vocab_size, 16).tolist() for _ in range(2)]
    groups = [{"rid": f"g{g}-{i}",
               "input_ids": prompts[g][:MEM_GROUP_PREFIX] + tails[g],
               "sampling": greedy, "group_id": f"mgrp{g}", "group_size": 8}
              for g in range(2) for i in range(8)]

    def make(num_pages: int, **kw):
        return CBEngine(cfg, params, pad_token_id=0,
                        kv_cache_dtype=torch.bfloat16, num_pages=num_pages,
                        device=dev, **{**MEM_ENGINE, **kw}).start()

    out: dict = {}
    capped = make(MEM_PAGES)
    try:
        kp, vp = capped._pools
        ptrs = [t.data_ptr() for t in kp + vp]
        page_bytes = sum(t[:, 0].numel() * t.element_size() for t in kp + vp)
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        first: dict = {}

        def after_first_pass():
            first.update(captures=capped.graph_captures,
                         replays=capped.graph_replays,
                         spilled=capped.kvledger.pages_spilled)

        got = memory_sessions(capped, prompts, greedy, after_first_pass)
        out["sessions_s"] = time.monotonic() - t0
        torch.cuda.synchronize(dev)  # every copy landed, so timed
        info = capped.kv_memory_info()
        snap = capped.kv_memory_snapshot()
        host = snap["spill"]["host"]
        out["traffic"] = {k_: host[k_] for k_ in (
            "bytes_spilled", "d2h_s", "bytes_restored", "h2d_s",
            "copy_batches", "lane_full")}
        check(host["d2h_s"] > 0 and host["h2d_s"] > 0,
              f"memory: the sessions' copies were not timed: {out['traffic']}")
        out["pages"] = dict(spilled=info["memory/pages_spilled"],
                            spilled_first=first["spilled"],
                            restored=info["memory/pages_restored"],
                            drops=info["memory/spill_drops"],
                            evicted=capped.prefix_cache.evictions["capacity"],
                            spilled_frac=info["kv_spilled_frac"],
                            restore_rate=info["kv_restore_rate"],
                            hbm_used=info["hbm_used_gb"],
                            hbm_headroom=info["hbm_headroom_gb"],
                            behind=snap["spill"]["host"]["restores_behind_copy"])
        log(f"memory: sessions on {MEM_PAGES - 1} pages: "
            + json.dumps(out["pages"]) + f"; reconcile "
            + json.dumps(snap["reconcile"]) + f"; {out['sessions_s']:.1f} s")
        check(info["memory/pages_spilled"] >= MEM_MIN_PAGES
              and info["memory/pages_restored"] >= MEM_MIN_PAGES,
              f"memory: {info['memory/pages_spilled']} pages spilled and "
              f"{info['memory/pages_restored']} restored, under {MEM_MIN_PAGES}")
        rec = snap["reconcile"]
        check(rec["attributed_frac"] == 1.0
              and rec["ledger_free"] == rec["pool_free"] == capped.allocator.free_count
              and rec["ledger_cache"] == rec["cache_pages"]
              == capped.prefix_cache.num_entries,
              f"memory: the ledger does not reconcile: {json.dumps(rec)}")
        check(snap["roles"]["spilled"] == len(spilled_entries(capped))
              == capped.kvspill.resident_pages,
              "memory: spilled pages disagree between ledger, cache and host")
        check(capped.deck.attributed_frac() == 1.0,
              f"memory: the flight deck's tokens do not reconcile "
              f"({capped.deck.attributed_frac()})")
        check(capped.graph_captures == first["captures"]
              and capped.graph_replays > first["replays"],
              "memory: a decode graph was captured again after the restores")
        check([t.data_ptr() for t in kp + vp] == ptrs,
              "memory: the pools moved")
        prof = capped.loop_profile_snapshot()
        busy = prof["wall_s"] - prof["phase_s"]["idle"]
        acct = prof["phase_s"]["accounting"] + prof["phase_s"]["spill_sweep"]
        out["loop"] = dict(attributed=prof["attributed_frac"],
                           acct_frac=acct / busy, phase_s=prof["phase_s"])
        check(prof["attributed_frac"] <= 1.0 + 1e-6,
              f"memory: loop attribution {prof['attributed_frac']} > 1")
        check(acct / busy < ACCOUNTING_BUDGET,
              f"memory: accounting {acct:.3f} s of {busy:.3f} s busy")

        # the same requests on an engine that never spills
        big = make(MEM_BIG_PAGES)
        try:
            want = memory_sessions(big, prompts, greedy)
            check(big.kvledger.pages_spilled == 0, "the big pool spilled")
            toks, bitwise, gap, parted = streams_gap(got, want)
            out["big"] = dict(tokens=toks, bitwise=bitwise, gap=gap,
                              parted=parted)
            log(f"memory: capped spilling against never spilling: tokens "
                f"{'equal' if toks else 'part ' + str(parted)}, logprobs "
                f"{'bitwise' if bitwise else 'max |diff| %.3e' % gap}")
            check(toks and gap <= MEM_LP_TOL,
                  f"memory: capped against never spilling: {out['big']}")

            # spill and restore rates, then the grouped mix on two spilled
            # prefixes against the same mix on the big engine
            ents, dt_s = timed_spill(capped, dev)
            n_s = n_r = len(ents)
            dt_r = timed_restore(capped, dev, ents)
            ents2, dt_s2 = timed_spill(capped, dev)
            n_s2 = len(ents2)
            out["rates"] = dict(
                spill=(n_s, n_s * page_bytes / dt_s / 1e9),
                restore=(n_r, n_r * page_bytes / dt_r / 1e9),
                spill2=(n_s2, n_s2 * page_bytes / dt_s2 / 1e9),
                pinned=capped.kvspill.stats()["pinned_bytes"])
            check(n_s > 0 and n_s2 == n_s,
                  f"memory: the timed spills moved {n_s} and {n_s2} pages")
            launches0 = dict(cuda_build.LAUNCHES)
            res: dict = {}
            prof = capped.profiler

            def grouped():
                res["t0"] = time.monotonic()
                res["p0"] = (dict(prof.totals), prof.wall_s)
                res["out"] = engine_requests(capped, groups)
                engine_quiet(capped)
                res["p1"] = (dict(prof.totals), prof.wall_s)

            busy_ms = device_profile(grouped, 1)["device_ms"]
            wall_ms = (max(o["t"][-1] for o in res["out"]) - res["t0"]) * 1e3
            # the loop profiler over the same mix: its phases' growth over
            # the growth of the loop's wall
            (t0_, w0_), (t1_, w1_) = res["p0"], res["p1"]
            d_wall = w1_ - w0_
            d = {p_: t1_[p_] - t0_[p_] for p_ in t0_}
            mix_fracs = dict(
                device_frac=(d["prefill_dispatch"] + d["decode_dispatch_device"]
                             + d["sample_fetch"]) / d_wall,
                accounting_frac=(d["accounting"] + d["spill_sweep"]) / d_wall,
                idle_frac=d["idle"] / d_wall, restore_s=d["restore"])
            launched = {k_: cuda_build.LAUNCHES[k_] - launches0[k_]
                        for k_ in SERVE_KERNELS}
            check(launched["grouped_paged_attention"] > 0,
                  f"memory: the grouped mix did not take K3: {launched}")
            ref = engine_requests(big, groups)
            toks, bitwise, gap, parted = streams_gap(res["out"], ref)
            ties = []
            if not toks:
                p32 = f32_copy(params)
                for rid, first in parted:
                    o = next(x for x in ref if x["rid"] == rid)
                    prompt = next(g["input_ids"] for g in groups if g["rid"] == rid)
                    gaps = top2_gaps(p32, cfg, prompt, o["tokens"], dev)
                    mine = next(x for x in res["out"] if x["rid"] == rid)
                    ok, f_, tie, g_ = agrees_until_tie(mine["tokens"], o["tokens"], gaps)
                    ties.append((rid, f_, tie, round(g_, 4)))
                    check(ok, f"memory: grouped {rid} parts at {f_} before a "
                          f"near-tie ({tie}, f32 gap {g_:.4f})")
                del p32
            out["grouped"] = dict(tokens=toks, bitwise=bitwise, gap=gap,
                                  ties=ties, busy=busy_ms / wall_ms,
                                  launched=launched, fracs=mix_fracs)
            check(gap <= MEM_LP_TOL, f"memory: grouped mix {out['grouped']}")
        finally:
            big.stop()
        del big
        out["launches"] = dict(cuda_build.LAUNCHES)
        for name in SERVE_KERNELS:
            check(out["launches"][name] > 0,
                  f"{name} was not launched in the memory phase")
        out["info"] = capped.kv_memory_info()
        out["deck"] = capped.deck.attributed_frac()
    finally:
        capped.stop()
    del capped
    gc.collect()
    torch.cuda.empty_cache()

    # the capped run with the spill tier off: evicted prefixes prefill again
    off = make(MEM_PAGES, kv_spill=False)
    try:
        got_off = memory_sessions(off, prompts, greedy)
        check(off.kvspill is None and off.kvledger.pages_spilled == 0,
              "the spill-off engine spilled")
        evicted = off.prefix_cache.evictions["capacity"]
    finally:
        off.stop()
    del off
    toks, bitwise, gap, parted = streams_gap(got, got_off)
    out["off"] = dict(tokens=toks, bitwise=bitwise, gap=gap, parted=parted,
                      evicted=evicted)
    log(f"memory: spill on against off: tokens "
        f"{'equal' if toks else 'part ' + str(parted)}, logprobs "
        f"{'bitwise' if bitwise else 'max |diff| %.3e' % gap}; the off run "
        f"evicted {evicted} pages")
    check(toks and gap <= MEM_LP_TOL, f"memory: spill on against off: {out['off']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["ab"] = memory_ab(dev)
    return out


def step_host_timer(eng) -> dict:
    """Time the engine's decode passes on the instance: ``step_s`` sums the
    wall of every ``_step_once``, ``drain_s`` that of the output drains
    inside them (where the loop waits on the device). Their difference is
    the host's whole cost of the passes: the abort scan, the launch, the
    kernel-read accounting, the flight deck, the ledger's touch and tier
    sweep, the spill sweep and the profiler's phases."""
    acc = {"step_s": 0.0, "drain_s": 0.0}
    step, drain = eng._step_once, eng._drain_emit_q
    inside = threading.local()

    def timed_drain(*a, **kw):
        if not getattr(inside, "step", False):
            return drain(*a, **kw)
        t0 = time.perf_counter()
        try:
            return drain(*a, **kw)
        finally:
            acc["drain_s"] += time.perf_counter() - t0

    def timed_step():
        inside.step = True
        t0 = time.perf_counter()
        try:
            step()
        finally:
            inside.step = False
            acc["step_s"] += time.perf_counter() - t0

    eng._step_once, eng._drain_emit_q = timed_step, timed_drain
    return acc


def sweep_peak(eng, dev, vocab: int) -> dict:
    """Device memory around one full spill sweep at ``eng``'s pool: greedy
    one-token requests publish pages until the cache holds the sweep's
    target (the watermarks' gap times the pool), then one spill of that
    many pages, the device idle before it: the peak allocated above the
    level before, beside the gathered block's bytes."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    n = eng.num_pages - 1
    target = int(np.ceil((eng.kv_spill_high_watermark
                          - eng.kv_spill_low_watermark) * n))
    per = (MEM_PROMPT - 1) // PS  # full pages a prompt publishes
    rng = np.random.default_rng(11)
    one = SamplingParams(temperature=0.0, max_new_tokens=1)
    engine_requests(eng, [{"rid": f"fill{i}", "sampling": one,
                           "input_ids": rng.integers(1, vocab, MEM_PROMPT).tolist()}
                          for i in range(-(-target // per))])
    engine_quiet(eng)
    kp, vp = eng._pools
    page_bytes = sum(t[:, 0].numel() * t.element_size() for t in kp + vp)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with eng._pool_lock:
        t0 = time.monotonic()
        got = eng._spill_pages(target, cold_only=False)
        torch.cuda.synchronize(dev)
        dt = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(got == target, f"the sweep at {n} pages spilled {got} of {target}")
    return dict(pages=got, pool=n, block=got * page_bytes, peak=peak, s=dt)


def memory_ab(dev) -> dict:
    """The serve phase's 18-stream GRPO mix on the serve phase's engine
    (64 slots, 2,048 pages, bf16, seed 0) with every plane on (the
    defaults) against ``kv_ledger=False, loop_profile=False``, in turns
    (on, off, off, on, ...), MEM_AB_RUNS each after one warm run each: the
    median and range of decode tok/s, of the host ms per decode dispatch
    in the launch (``decode_host_s``) and in the whole decode pass less
    its drains (``step_host_timer``), and the planes-on engine's profiler
    ms of accounting and spill sweep per dispatch. Then ``sweep_peak`` on
    the planes-on engine."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = decoder.init_params(gen, cfg)
    bodies, _, _ = serving_mix(cfg.vocab_size)
    reqs = [{"rid": b["rid"], "input_ids": b["input_ids"],
             "sampling": SamplingParams(**b["sampling_params"]),
             "group_id": b.get("group_id", ""),
             "group_size": b.get("group_size", 0)} for b in bodies]
    engines, timers = {}, {}
    for name, kw in (("on", {}), ("off", dict(kv_ledger=False,
                                             loop_profile=False))):
        engines[name] = CBEngine(
            cfg, params, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
            max_slots=64, page_size=PS, max_seq_len=4096, num_pages=2048,
            steps_per_dispatch=8, seed=0, device=dev, **kw)
        timers[name] = step_host_timer(engines[name])
        engines[name].start()
    runs: dict = {"on": [], "off": []}
    try:
        order = ["on", "off"] + ["on", "off", "off", "on"] * (MEM_AB_RUNS // 2)
        order += ["on", "off"][:MEM_AB_RUNS % 2 * 2]
        for i, name in enumerate(order):
            eng, tm = engines[name], timers[name]
            eng.flush_prefix_cache()
            d0, h0 = eng.decode_dispatches, eng.decode_host_s
            s0 = tm["step_s"] - tm["drain_s"]
            prof = eng.profiler
            a0 = (prof.totals["accounting"] + prof.totals["spill_sweep"]
                  if prof is not None else 0.0)
            outs = engine_requests(eng, [{**r, "rid": f"{r['rid']}-{i}"}
                                         for r in reqs])
            engine_quiet(eng)
            first = min(o["t"][0] for o in outs)
            last = max(o["t"][-1] for o in outs)
            n_tok = sum(len(o["tokens"]) for o in outs) - len(outs)
            n_d = max(eng.decode_dispatches - d0, 1)
            acct = ((prof.totals["accounting"] + prof.totals["spill_sweep"]
                     - a0) / n_d * 1e3 if prof is not None else None)
            if i >= 2:  # the first run of each engine warms (captures)
                runs[name].append((n_tok / (last - first),
                                   (eng.decode_host_s - h0) / n_d * 1e3,
                                   (tm["step_s"] - tm["drain_s"] - s0)
                                   / n_d * 1e3, acct))
        peak = sweep_peak(engines["on"], dev, cfg.vocab_size)
    finally:
        for eng in engines.values():
            eng.stop()
    del engines, params
    gc.collect()
    torch.cuda.empty_cache()
    check(len(runs["on"]) == len(runs["off"]) == MEM_AB_RUNS,
          f"memory A/B: {len(runs['on'])} / {len(runs['off'])} runs")
    out = {k: dict(tok_s=[r[0] for r in v], host_ms=[r[1] for r in v],
                   step_ms=[r[2] for r in v], acct_ms=[r[3] for r in v])
           for k, v in runs.items()}
    out["sweep"] = peak
    return out


def memory_lines(m: dict, smi: str) -> list[str]:
    pg, r = m["pages"], m["rates"]
    g, tr, sw = m["grouped"], m["traffic"], m["ab"]["sweep"]
    lines = [
        f"memory ({smi}, this run): capped engine ({MEM_PAGES - 1} pages): "
        f"{pg['spilled']:.0f} pages spilled ({pg['spilled_first']:.0f} in the "
        f"first pass), {pg['restored']:.0f} restored, {pg['drops']:.0f} dropped, "
        f"{pg['evicted']} evicted; restores behind their copy {pg['behind']}; "
        f"kv_spilled_frac {pg['spilled_frac']}, kv_restore_rate "
        f"{pg['restore_rate']}; hbm_used_gb {pg['hbm_used']:.3f}, "
        f"hbm_headroom_gb {pg['hbm_headroom']:.3f} (the card's free memory); "
        f"the sessions took {m['sessions_s']:.1f} s; the phase's launches "
        + json.dumps({k_: m["launches"][k_] for k_ in SERVE_KERNELS}),
        f"memory ({smi}, this run): spill of {r['spill'][0]} pages (gather on "
        f"the compute stream + device-to-host on the copy stream) "
        f"{r['spill'][1]:.2f} GB/s, again {r['spill2'][1]:.2f} GB/s; restore "
        f"of {r['restore'][0]} pages (host-to-device + index_copy_) "
        f"{r['restore'][1]:.2f} GB/s; peak pinned {r['pinned'] / 1e9:.3f} GB",
        f"memory ({smi}, this run): the sessions' own spills and restores, "
        f"copies timed by events on the card: {tr['copy_batches']} spill "
        f"batches, {tr['bytes_spilled'] / 1e9:.3f} GB device-to-host in "
        f"{tr['d2h_s'] * 1e3:.2f} ms ({tr['bytes_spilled'] / tr['d2h_s'] / 1e9:.2f} "
        f"GB/s, the gather's end to the batch landed); "
        f"{tr['bytes_restored'] / 1e9:.3f} GB host-to-device in "
        f"{tr['h2d_s'] * 1e3:.2f} ms "
        f"({tr['bytes_restored'] / tr['h2d_s'] / 1e9:.2f} GB/s, the copies "
        f"alone); spills refused on a full copy lane {tr['lane_full']}",
        f"memory ({smi}, this run): one full sweep at the A/B engine's "
        f"{sw['pool']} pages: {sw['pages']} pages, block "
        f"{sw['block'] / 1e9:.3f} GB, device memory peak above the level "
        f"before {sw['peak'] / 1e9:.3f} GB ({sw['peak'] / sw['block']:.3f} x "
        f"the block), {sw['s'] * 1e3:.1f} ms to the copies landed",
        f"memory ({smi}, this run): capped against never spilling: "
        + json.dumps(m["big"]) + "; spill on against off: "
        + json.dumps(m["off"]),
        f"memory ({smi}, this run): grouped mix on spilled prefixes against "
        f"never spilling: tokens {'equal' if g['tokens'] else 'part ' + str(g['ties'])}, "
        f"logprobs {'bitwise' if g['bitwise'] else 'max |diff| %.3e' % g['gap']}; "
        f"launches {json.dumps(g['launched'])}; the loop profiler over the "
        f"mix: device_frac {g['fracs']['device_frac']:.3f} (host wall in "
        f"dispatch and fetch over loop wall), accounting_frac "
        f"{g['fracs']['accounting_frac']:.4f}, idle_frac "
        f"{g['fracs']['idle_frac']:.3f}, restore {g['fracs']['restore_s']:.4f} s; "
        f"torch.profiler's device busy share of the mix's wall "
        f"{g['busy']:.3f} (the device's own)",
        f"memory ({smi}, this run): loop attribution "
        f"{m['loop']['attributed']}, accounting + spill_sweep "
        f"{m['loop']['acct_frac']:.4f} of the busy wall; phase seconds "
        + json.dumps(m["loop"]["phase_s"]),
    ]
    for name in ("on", "off"):
        a = m["ab"][name]
        lines.append(
            f"memory A/B ({smi}, this run): planes {name}: decode tok/s median "
            f"{statistics.median(a['tok_s']):.1f} (range "
            f"{min(a['tok_s']):.1f}-{max(a['tok_s']):.1f}), host ms per decode "
            f"dispatch median {statistics.median(a['host_ms']):.3f} (range "
            f"{min(a['host_ms']):.3f}-{max(a['host_ms']):.3f}) in the launch, "
            f"{statistics.median(a['step_ms']):.3f} (range "
            f"{min(a['step_ms']):.3f}-{max(a['step_ms']):.3f}) in the whole "
            f"decode pass less its drains"
            + (f", the profiler's accounting + spill_sweep "
               f"{statistics.median(a['acct_ms']):.4f} (range "
               f"{min(a['acct_ms']):.4f}-{max(a['acct_ms']):.4f})"
               if a["acct_ms"][0] is not None else "")
            + "; runs " + json.dumps([round(x, 1) for x in a["tok_s"]]))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the main path's 18 streams with torch.profiler "
                         "and write its kernel table to PATH")
    ap.add_argument("--ppo-ab", action="store_true",
                    help="also run the ppo phase's configuration without "
                         "validation, unpipelined against pipelined in turns, "
                         "and log their step walls")
    ap.add_argument("--grad-seeds", metavar="N,N,...", default="",
                    help="before the phases, read the train phase's micro "
                         "gradient gate after its fit at each of these "
                         "trainer.seed values, with probes of which bf16 "
                         "rounding moves it, and log the spread (not gated)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.monotonic()
    secs = cuda_build.build()
    log(f"build: {time.monotonic() - t0:.1f} s wall, per kernel "
        + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    build_report()
    if args.grad_seeds:
        grad_gate_sweep(dev, [int(x) for x in args.grad_seeds.split(",")])

    rows = check_kernels(dev) + check_flash(dev)
    torch.cuda.empty_cache()
    served = serve_phase(dev, profile=args.profile)
    log(f"serve ({smi}, this run): decode {served['decode_tok_s']:.1f} tok/s "
        f"over 18 concurrent streams; TTFT median "
        f"{statistics.median(served['ttft']) * 1e3:.1f} ms, max "
        f"{max(served['ttft']) * 1e3:.1f} ms; again without captures: depth 16 "
        f"{served['runahead']['tok_s']:.1f} tok/s, depth 0 "
        f"{served['runahead']['sync_tok_s']:.1f}; device busy "
        f"{served['runahead']['busy_share']:.3f} of the profiled mix's wall; "
        f"peak {served['peak_gb']:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    memory = memory_phase(dev)
    for line in memory_lines(memory, smi):
        log(line)
    log(f"phase memory ({smi}, this run): {time.monotonic() - t0:.1f} s wall")
    trained = train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    ppo = ppo_phase(dev, args.ppo_ab)
    # K4 at the packed rows' shapes, with the packer's segment ids
    flash_case_check(dev, 4, PACK_LEN, 9, "ppo packed rows", reps=5,
                     seg_np=ppo["seg_ids"])
    torch.cuda.empty_cache()
    for name, phase in (("hf", lambda: hf_phase(dev)),
                        ("quant", lambda: quant_phase(dev)),
                        ("lora", lambda: lora_phase(dev, trained["peak_gb"])),
                        ("offload", lambda: offload_checks(dev))):
        t0 = time.monotonic()
        out = phase()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase {name} ({smi}, this run): {time.monotonic() - t0:.1f} s wall")
        if name == "quant":
            log(f"quant ({smi}, this run): launches of the int8 main path: "
                + json.dumps({k_: out["launches"][k_] for k_ in SERVE_KERNELS})
                + "; decode step by replay bf16 / int8: device ms "
                f"{out['ab']['bf16']['device_ms']:.3f} / "
                f"{out['ab']['int8']['device_ms']:.3f}, wall ms "
                f"{out['ab']['bf16']['wall_ms']:.2f} / {out['ab']['int8']['wall_ms']:.2f}")
        if name == "lora":
            log(f"lora ({smi}, this run): K4 launches "
                + json.dumps({k_: out["launches"][k_] for k_ in LORA_KERNELS})
                + f"; peak {out['peak_gb']:.2f} GB against the train phase's "
                f"{trained['peak_gb']:.2f}")

    t0 = time.monotonic()
    feats = features_phase(dev, served["ttft"])
    gc.collect()
    torch.cuda.empty_cache()
    for line in features_lines(feats, smi):
        log(line)
    log(f"phase features ({smi}, this run): {time.monotonic() - t0:.1f} s wall")
    t0 = time.monotonic()
    stepped = step_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"step ({smi}, this run): 16 x (128 + 256) greedy, tok/s "
        f"RolloutEngine {[round(x, 1) for x in stepped['tok_s']['step']]} vs "
        f"CBEngine {[round(x, 1) for x in stepped['tok_s']['cb']]}; vs dense f32 "
        f"worst {stepped['worst'][0]:.4f} / {stepped['worst'][1]:.4f} nats; "
        f"(first mismatch, first near-tie, top-2 f32 gap at the mismatch) vs "
        f"CBEngine {stepped['ties']}; "
        f"GRPO fit on rollout.backend=step: step walls "
        f"{[round(x, 2) for x in stepped['step_walls']]} s (gen "
        f"{[round(x, 2) for x in stepped['gen_walls']]} s), K4 launches "
        + json.dumps({k_: stepped["launches"][k_] for k_ in STEP_KERNELS})
        + f", peak {stepped['peak_gb']:.2f} GB")
    log(f"phase step ({smi}, this run): {time.monotonic() - t0:.1f} s wall")
    t0 = time.monotonic()
    disagg = disagg_phase(dev, trained)
    gc.collect()
    torch.cuda.empty_cache()
    for line in disagg_lines(disagg, smi):
        log(line)
    log(f"phase disagg ({smi}, this run): {time.monotonic() - t0:.1f} s wall")

    for r in rows:
        # K1's path is the decode step's unfused route (the serve phase's
        # A/B); K4's the train phase; the rest the serving path
        launches = (served["ab_launches"]["unfused"]
                    if r["name"] == "paged_kv_write" else
                    trained["launches"] if r["name"].startswith("flash")
                    else served["launches"])
        # plus the memory phase's and the disagg phase's paths: the server
        # process decodes, the trainer process runs K4
        extra = (0 if r["name"] == "paged_kv_write" else
                 disagg["trainer_launches"][r["name"]] if r["name"].startswith("flash")
                 else disagg["server_launches"][r["name"]]
                 + memory["launches"][r["name"]])
        r.update(route="cuda", source=f"polyrl_tpu_torch/csrc/{r['name']}.cu",
                 replaces=REPLACES[r["name"]],
                 launches=launches[r["name"]] + extra)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
