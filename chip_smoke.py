#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``polyrl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero and prints no result
when CUDA is unavailable or any phase fails. Phases:

1. build   -- compile every kernel of the serving path from ``csrc/``
              (one nvcc per source, all started together).
2. kernels -- each kernel against its plain PyTorch version at the serving
              path's shapes (Hq 16, Hkv 8, D 128, page 64, 64 slots, bf16
              pools, lengths 1..4096, a G=8 group table with a padded -1
              seat): K1 bitwise, K2/K3 within rtol 1e-2 / atol 2e-3
              (outputs are rounded to bf16 once: one ulp is at most 2^-7
              of the value), K3 also against K2 on the full page tables.
              The same calls with two slots missing their last page must
              fail that tolerance. K2 and K3 are also timed on the tables
              the serving phase gives them. Times are device time per
              call: CUDA events around replays of a CUDA graph of
              back-to-back calls, median over several replays.
3. serve   -- ``create_server("qwen3-1.7b", device="cuda")`` at full width
              and depth with random weights from a seed; over HTTP, the
              main path: two GRPO groups of 8 samples (temperature 1.0,
              64 new tokens) sharing a ~200-token prompt plus two
              ungrouped greedy requests of 128 new tokens, which outlive
              the groups (decode with a live group goes through K3, the
              greedy tail through K2). Launch counts are zeroed just
              before the main path and read just after it: every kernel
              must have launched. Then one greedy request sent twice
              alone (same tokens; its launches are reported apart), and
              its logprobs against the port's dense ``forward`` on the
              card; sent again with the engine's decode attention missing
              each slot's last page, it must fail that check.
4. result  -- the card's name and power limit, a ``{"kernels": [...]}``
              line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.ops import cuda_build
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
REPLACES = {
    "paged_kv_write": "polyrl_tpu/ops/paged_attention.py:671",
    "paged_attention": "polyrl_tpu/ops/paged_attention.py:160",
    "grouped_paged_attention": "polyrl_tpu/ops/paged_attention.py:462",
}


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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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
    del out_k, out_v

    # K2: decode attention over the full page rows
    out2 = pa.paged_attention(q, kp, vp, table, lens)
    ref2 = pa.paged_attention_ref(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    err2 = (out2.float() - ref2.float()).abs().max().item()
    check(torch.allclose(out2.float(), ref2.float(), **KERNEL_TOL),
          f"paged_attention differs from its plain version (max {err2})")
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
    serving_times(dev, kp, vp)
    return rows


def serving_times(dev, kp, vp) -> None:
    """K2 and K3 on the tables the serving phase gives them mid-decode: 64
    slots; two GRPO groups of 8 on 200- and 203-token prompts (3 shared
    prefix pages, bucketed to 4) at 232 and 235 tokens; two greedy slots;
    46 idle slots (length 0 on the null page)."""
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
    table, lens = t(table), t(lens)
    gargs = (t(g_slots), t(g_pages), t(g_lens))
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
        f"grouped_paged_attention ms {ms3:.4f} (bound {b3:.4f})")


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


def serve_phase(dev, model: str = MODEL, profile: str | None = None) -> dict:
    from polyrl_tpu_torch.rollout.serve import create_server

    t0 = time.monotonic()
    server = create_server(model, device=str(dev), host="127.0.0.1", port=0,
                           max_slots=64, page_size=64, max_seq_len=4096,
                           num_pages=2048, steps_per_dispatch=8, seed=0)
    try:
        log(f"serve: {model} up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        port = server.port
        check(post(port, "/health", None)["status"] == "ok", "/health")
        cfg = server.engine.cfg
        rng = np.random.default_rng(1)
        prompt = lambda n: rng.integers(1, cfg.vocab_size, n).tolist()  # noqa: E731
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

        # one short request first: CUDA/cuBLAS initialise lazily, and that
        # one-time cost must not land in the measured TTFT
        run_requests(port, [{"rid": "warmup", "input_ids": prompt(150),
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})

        # the main path: counts zeroed just before it and read just after
        info0 = post(port, "/get_server_info", None)
        pa.reset_launch_counts()
        t_start = time.monotonic()
        with profiled(profile):
            outs = run_requests(port, bodies)
        wall = time.monotonic() - t_start
        launches = dict(pa.LAUNCHES)
        info = post(port, "/get_server_info", None)
        for name in REPLACES:
            check(launches[name] > 0,
                  f"{name} was not launched on the serving path")
            check(info[f"kernel_launches/{name}"] == launches[name],
                  "server_info launch counts disagree")
        delta = {k: info[k] - info0[k] for k in (
            "decode_dispatches", "grouped_decode_dispatches",
            "sibling_attach_dispatches")}
        log(f"serve: main path launches {json.dumps(launches)}; "
            f"{json.dumps(delta)}")
        ttft = [o["lines"][0][0] - o["t0"] for o in outs]
        first = min(o["lines"][0][0] for o in outs)
        last = max(o["lines"][-1][0] for o in outs)
        n_tok = sum(len(o["tokens"]) for o in outs)
        decode_tok_s = (n_tok - len(outs)) / max(last - first, 1e-9)
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0,
                  "non-finite or positive logprob")
            check(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                  "token outside the vocabulary")
        # the same greedy request twice, alone, from an empty prefix cache:
        # identical inputs and batch shapes must give identical tokens
        rep = []
        pa.reset_launch_counts()
        for i in range(2):
            post(port, "/flush_cache", {})
            rep.append(run_requests(port, [{
                "rid": f"repeat{i}", "input_ids": greedy_prompts[0],
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 64}}])[0])
        check(rep[0]["tokens"] == rep[1]["tokens"],
              "the same greedy request gave different tokens")
        single = (rep[0]["lines"][-1][0] - rep[0]["lines"][0][0]) / 63
        log(f"serve: one stream alone (twice): TTFT {(rep[0]['lines'][0][0] - rep[0]['t0']) * 1e3:.1f} ms, "
            f"{single * 1e3:.2f} ms per decode step (64 slots computed); "
            f"launches {json.dumps(dict(pa.LAUNCHES))}")
        log(f"serve: {len(outs)} streams, {n_tok} tokens in {wall:.2f} s")
        # decode vs dense: the engine's greedy logprobs against the port's
        # dense forward over prompt + generated tokens, on the card, in f32
        # (the reference) and in bf16 (the same precision as the engine)
        n_p = len(greedy_prompts[0])

        def dense_logprobs(params, tokens):
            x = torch.tensor([greedy_prompts[0] + tokens], device=dev)
            pos = torch.arange(x.shape[1], device=dev)[None]
            logits, _ = decoder.forward(params, cfg, x, pos,
                                        torch.ones_like(x, dtype=torch.float32))
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
        with missing_last_page():
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

        return dict(launches=launches, ttft=ttft, decode_tok_s=decode_tok_s,
                    wall=wall, n_tok=n_tok)
    finally:
        server.stop()


@contextlib.contextmanager
def missing_last_page():
    """Within the block the engine's decode attention runs K2/K3 with each
    slot's length cut back past its last page (a page-table fault that
    loses up to 64 recent tokens). The kernels still launch."""
    from polyrl_tpu_torch.rollout import cb_engine

    def cut(lens):
        return torch.clamp(lens - ((lens - 1) % PS + 1), min=0)

    k2, k3 = decoder.paged_attention, cb_engine.grouped_paged_attention
    decoder.paged_attention = lambda q, kp, vp, pt, lens, *a: k2(
        q, kp, vp, pt, cut(lens), *a)
    cb_engine.grouped_paged_attention = lambda q, kp, vp, pt, lens, *a: k3(
        q, kp, vp, pt, cut(lens), *a)
    try:
        yield
    finally:
        decoder.paged_attention, cb_engine.grouped_paged_attention = k2, k3


# -- main -----------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the main path's 18 streams with torch.profiler "
                         "and write its kernel table to PATH")
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

    rows = check_kernels(dev)
    torch.cuda.empty_cache()
    served = serve_phase(dev, profile=args.profile)
    log(f"serve ({smi}, this run): decode {served['decode_tok_s']:.1f} tok/s "
        f"over 18 concurrent streams; TTFT median "
        f"{statistics.median(served['ttft']) * 1e3:.1f} ms, max "
        f"{max(served['ttft']) * 1e3:.1f} ms")

    for r in rows:
        r.update(route="cuda", source=f"polyrl_tpu_torch/csrc/{r['name']}.cu",
                 replaces=REPLACES[r["name"]],
                 launches=served["launches"][r["name"]])
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
