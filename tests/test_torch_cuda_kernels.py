"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need the card and skip without one. The file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX). The case helper
below is shared with ``test_torch_paged_attention.py``, which holds the
plain versions against the JAX oracles on the CPU.
"""

import numpy as np
import pytest
import torch

from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops import paged_attention as tpa
from polyrl_tpu_torch.ops.norm_rope import rms_norm
from chip_smoke import (engine_outputs, engine_restore, engine_snapshot,
                        graph_against_eager, rope_operand_bound, states_equal)

PAGE = 8


def grouped_case(rng, groups=((4, 2, (3, 9, 1, 5)),), hkv=2, rep=2, d=16,
                  ungrouped_lens=(11,), n_pool=128, page=PAGE):
    """Pools + per-slot FULL page tables where each group's members share
    one physical prefix chain followed by private suffix pages; ``groups``
    is a tuple of (g, n_pre_pages, suffix_lens). The group table is
    padded to powers of two with -1 seats, as the engine packs it. The
    page table has three columns more than the longest prefix, or as many
    as the longest row needs."""
    hq = hkv * rep
    k_pool = rng.standard_normal((hkv, n_pool, page, d)).astype(np.float32)
    v_pool = rng.standard_normal((hkv, n_pool, page, d)).astype(np.float32)
    free = list(range(1, n_pool))
    rng.shuffle(free)
    rows, lens, seats, g_pages, g_lens = [], [], [], [], []
    max_pre = max((n for _g, n, _s in groups), default=1)
    max_pages = max([max_pre + 3]
                    + [n + -(-x // page) for _g, n, sl in groups for x in sl]
                    + [-(-x // page) for x in ungrouped_lens])
    for g, n_pre, sfx_lens in groups:
        pre = [free.pop() for _ in range(n_pre)]
        seat_row = []
        for i in range(g):
            sfx = sfx_lens[i % len(sfx_lens)]
            own = [free.pop() for _ in range(-(-sfx // page))]
            row = np.zeros((max_pages,), np.int32)
            row[:n_pre] = pre
            row[n_pre:n_pre + len(own)] = own
            seat_row.append(len(rows))
            rows.append(row)
            lens.append(n_pre * page + sfx)
        seats.append(seat_row)
        g_pages.append(pre)
        g_lens.append(n_pre * page)
    for ln in ungrouped_lens:
        own = [free.pop() for _ in range(-(-ln // page))]
        row = np.zeros((max_pages,), np.int32)
        row[:len(own)] = own
        rows.append(row)
        lens.append(ln)

    def pow2(n):
        b = 1
        while b < n:
            b *= 2
        return b

    ng = pow2(max(1, len(seats)))
    gmax = pow2(max((len(sr) for sr in seats), default=1))
    group_slots = np.full((ng, gmax), -1, np.int32)
    group_prefix_pages = np.zeros((ng, pow2(max_pre)), np.int32)
    group_prefix_lens = np.zeros((ng,), np.int32)
    for i, sr in enumerate(seats):
        group_slots[i, :len(sr)] = sr
        group_prefix_pages[i, :len(g_pages[i])] = g_pages[i]
        group_prefix_lens[i] = g_lens[i]
    q = rng.standard_normal((len(rows), hq, d)).astype(np.float32)
    return (q, k_pool, v_pool, np.stack(rows), np.asarray(lens, np.int32),
            group_slots, group_prefix_pages, group_prefix_lens)


def _t(case, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in case]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """Each kernel against its plain version at real head widths (D=128,
    page 64): K1 bitwise; K2/K3 within 2e-5 in f32 (reduction order only)
    and rtol 1e-2 / atol 2e-3 in bf16 (outputs are rounded to bf16 once:
    one ulp is at most 2^-7 of the value)."""
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=2e-3))
    rng = np.random.default_rng(11)
    case = grouped_case(rng, groups=((8, 2, (3, 90, 1, 65)), (3, 1, (6, 2))),
                        hkv=4, rep=2, d=128, ungrouped_lens=(11, 0, 130),
                        page=64, n_pool=64)
    case[5][0, 5] = -1  # a finished sibling's seat mid-row
    case = _t(case, cuda_device)
    for i in (0, 1, 2):
        case[i] = case[i].to(dtype)
    cuda_build.reset_launch_counts()
    full = tpa.paged_attention(*case[:5])
    grouped = tpa.grouped_paged_attention(*case)
    torch.cuda.synchronize()
    cpu = [a.cpu() for a in case]
    torch.testing.assert_close(full.cpu().float(),
                               tpa.paged_attention_ref(*cpu[:5]).float(), **tol)
    torch.testing.assert_close(grouped.cpu().float(),
                               tpa.grouped_paged_attention_ref(*cpu).float(),
                               **tol)
    torch.testing.assert_close(grouped.float(), full.float(), **tol)

    kp, vp = case[1].clone(), case[2].clone()
    s = case[0].shape[0]
    page = torch.randperm(63, device=cuda_device)[:s].int() + 1
    page[1] = 0  # two inactive slots routed to the null page
    page[3] = 0
    off = torch.randint(0, 64, (s,), device=cuda_device, dtype=torch.int32)
    off[1] = off[3] = 0
    ku = torch.randn((s, kp.shape[0], 128), device=cuda_device).to(dtype)
    vu = torch.randn_like(ku)
    ku[3], vu[3] = ku[1], vu[1]
    tpa.paged_kv_write(kp, vp, page, off, ku, vu)
    rk, rv = tpa.paged_kv_write_ref(case[1].clone(), case[2].clone(), page, off,
                                    ku, vu)
    torch.cuda.synchronize()
    assert torch.equal(kp, rk) and torch.equal(vp, rv)
    assert {k: cuda_build.LAUNCHES[k] for k in (
        "paged_kv_write", "paged_attention", "grouped_paged_attention")} == {
        "paged_kv_write": 1, "paged_attention": 1, "grouped_paged_attention": 1}


def _tol(dtype):
    """K2/K3 against their plain versions: f32 differs by reduction order
    only; bf16 rounds its output once (one ulp is at most 2^-7 of the
    value; atol covers values near 0)."""
    return (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
            else dict(rtol=1e-2, atol=2e-3))


def _both_against_plain(case, dtype):
    """K2 and K3 on ``case`` (CUDA tensors), each twice, against their
    plain versions on the CPU and against each other; the two calls of
    each must be bitwise equal (no atomics, a fixed merge order)."""
    case = list(case)
    for i in (0, 1, 2):
        case[i] = case[i].to(dtype)
    full = tpa.paged_attention(*case[:5])
    grouped = tpa.grouped_paged_attention(*case)
    assert torch.equal(full, tpa.paged_attention(*case[:5]))
    assert torch.equal(grouped, tpa.grouped_paged_attention(*case))
    torch.cuda.synchronize()
    cpu = [a.cpu() for a in case]
    tol = _tol(dtype)
    torch.testing.assert_close(full.cpu().float(),
                               tpa.paged_attention_ref(*cpu[:5]).float(), **tol)
    torch.testing.assert_close(grouped.cpu().float(),
                               tpa.grouped_paged_attention_ref(*cpu).float(), **tol)
    torch.testing.assert_close(grouped.float(), full.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_split_rows_over_chunks(cuda_device, dtype):
    """Rows cut into chunks of 4 pages (256 positions at page 64, 8 kv
    heads, D 128): a 64-page row; rows of exactly 1 and 2 chunks and one
    token past each; prefixes of 6 and 8 pages (more than one chunk, the
    second ending on a chunk boundary) with suffixes of 1 to 257 tokens;
    idle length-0 slots and a -1 seat."""
    rng = np.random.default_rng(13)
    case = grouped_case(
        rng, groups=((3, 6, (1, 64, 200)), (4, 8, (5, 256, 257, 130))), hkv=8,
        rep=2, d=128, ungrouped_lens=(4096, 256, 257, 512, 513, 0, 0, 1),
        page=64, n_pool=200)
    case[5][1, 2] = -1  # a finished sibling's seat mid-row
    s, p = case[0].shape[0], case[3].shape[1]
    assert p == 64 and tpa.chunk_pages(s, 8, p, 64) == 4
    cuda_build.reset_launch_counts()
    _both_against_plain(_t(case, cuda_device), dtype)
    assert cuda_build.LAUNCHES["paged_attention"] == 2
    assert cuda_build.LAUNCHES["grouped_paged_attention"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_kernel_splits_wide_groups(cuda_device, dtype):
    """A group of 20 members (32 seats after padding) at rep 4 stacks 128
    query rows, which the prefix items take 16 rows at a time; the result
    still equals the plain version and paged attention."""
    rng = np.random.default_rng(12)
    case = grouped_case(rng, groups=((20, 2, (3, 70, 1, 64)),), hkv=2, rep=4,
                        d=128, ungrouped_lens=(5,), page=64, n_pool=64)
    _both_against_plain(_t(case, cuda_device), dtype)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q = torch.zeros((2, 4, 48), device=cuda_device)  # D not a multiple of 32
    pool = torch.zeros((2, 4, 64, 48), device=cuda_device)
    pt = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    lens = torch.ones((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pool, pool, pt, lens)
    q16 = torch.zeros((2, 4, 64), device=cuda_device, dtype=torch.float16)
    pool16 = torch.zeros((2, 4, 64, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):  # no kernel is built for float16
        tpa.paged_attention(q16, pool16, pool16, pt, lens)
    gargs = (torch.zeros((1, 2), dtype=torch.int32, device=cuda_device),
             torch.zeros((1, 1), dtype=torch.int32, device=cuda_device),
             torch.zeros((1,), dtype=torch.int32, device=cuda_device))
    for d in (96, 256):  # the bf16 (tensor-core) kernels take D 64 and 128
        qb = torch.zeros((2, 4, d), device=cuda_device, dtype=torch.bfloat16)
        poolb = torch.zeros((2, 4, 64, d), device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            tpa.paged_attention(qb, poolb, poolb, pt, lens)
        with pytest.raises(ValueError, match="head_dim"):
            tpa.grouped_paged_attention(qb, poolb, poolb, pt, lens, *gargs)
    # the f32 (CUDA-core) kernels still take any multiple of 32
    tpa.paged_attention(qb[..., :96].float().contiguous(),
                        poolb[..., :96].float().contiguous(),
                        poolb[..., :96].float().contiguous(), pt, lens)
    torch.cuda.synchronize()


# -- the fused decode prologue (K1 redesigned) ---------------------------------


def fused_case(rng, s=6, hq=4, hkv=2, d=64, n=16, page=PAGE, norm=True,
               theta=10000.0):
    """One decode token per slot for ``paged_kv_write_fused``, as numpy
    arrays: q [S, Hq*D], k and v [S, Hkv*D], pools [Hkv, N, page, D], norm
    weights [D] (None without qk-norm), cos and sin [S, D/2] at random
    positions, and each slot's target. Slot 1 is inactive (routed to page
    0, offset 0); slots 2 and 3 sit on a page boundary (offset 0 and
    page - 1)."""
    f32 = np.float32
    pos = rng.integers(0, 4096, s)
    ang = pos[:, None] * (1.0 / theta ** (np.arange(0, d, 2) / d))[None]
    page_ids = rng.permutation(np.arange(1, n))[:s].astype(np.int32)
    off = rng.integers(0, page, s).astype(np.int32)
    page_ids[1], off[1] = 0, 0
    off[2], off[3] = 0, page - 1

    def weight():
        return (1 + 0.1 * rng.standard_normal(d)).astype(f32) if norm else None

    return dict(
        k_pool=rng.standard_normal((hkv, n, page, d)).astype(f32),
        v_pool=rng.standard_normal((hkv, n, page, d)).astype(f32),
        write_page=page_ids, write_off=off,
        q=rng.standard_normal((s, hq * d)).astype(f32),
        k=rng.standard_normal((s, hkv * d)).astype(f32),
        v=rng.standard_normal((s, hkv * d)).astype(f32),
        cos=np.cos(ang).astype(f32), sin=np.sin(ang).astype(f32),
        q_norm=weight(), k_norm=weight())


def fused_operands(case, device, dtype, pool_dtype=None):
    """``fused_case`` as tensors on ``device``: q, k, v and the weights in
    ``dtype``, the pools in ``pool_dtype`` (``dtype`` by default), cos and
    sin in f32, the targets int32."""
    pool_dtype = pool_dtype or dtype
    out = {}
    for name, a in case.items():
        if a is None:
            out[name] = None
            continue
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if name in ("k_pool", "v_pool"):
            t = t.to(pool_dtype)
        elif name in ("q", "k", "v", "q_norm", "k_norm"):
            t = t.to(dtype)
        out[name] = t
    return out


def _rope_operands(x, w, eps):
    """The RoPE operands of ``x`` [S, H, D] as the plain chain makes them."""
    return x if w is None else rms_norm(x[:, None], w, eps)[:, 0]


def check_fused_against_plain(args, eps, rel):
    """``paged_kv_write_fused`` on CUDA tensors ``args`` (pools copied)
    against its plain version on CPU copies: q and the written k rows
    within ``rope_operand_bound``; the v rows and every pool row it must
    not touch bitwise. Returns the kernel's (q, k_pool, v_pool)."""
    dev = args["k_pool"].device
    kp, vp = args["k_pool"].clone(), args["v_pool"].clone()
    rest = {k_: v for k_, v in args.items() if k_ not in ("k_pool", "v_pool")}
    q = tpa.paged_kv_write_fused(kp, vp, **rest, eps=eps)
    cpu = {k_: (None if v is None else v.cpu()) for k_, v in args.items()}
    rk, rv = cpu["k_pool"].clone(), cpu["v_pool"].clone()
    rq = tpa.paged_kv_write_fused_ref(rk, rv, **{k_: cpu[k_] for k_ in rest},
                                      eps=eps)
    torch.cuda.synchronize()
    hkv, n, ps, d = kp.shape
    s = q.shape[0]
    cos, sin = cpu["cos"], cpu["sin"]
    assert q.dtype == cpu["q"].dtype and q.shape == rq.shape
    qn = _rope_operands(cpu["q"].reshape(s, -1, d), cpu["q_norm"], eps)
    assert ((q.cpu().float() - rq.float()).abs()
            <= rope_operand_bound(qn, cos, sin, rq, rel)).all()
    page, off = cpu["write_page"].long(), cpu["write_off"].long()
    written = torch.zeros((hkv, n, ps), dtype=torch.bool)
    written[:, page, off] = True
    got_k = kp.cpu()
    assert torch.equal(got_k[~written], rk[~written])
    assert torch.equal(vp.cpu(), rv)
    kn = _rope_operands(cpu["k"].reshape(s, hkv, d), cpu["k_norm"], eps)
    # slot order within the pools' [Hkv, S] rows
    ref_rows = rk[:, page, off].float()
    bound = rope_operand_bound(kn, cos, sin, ref_rows.transpose(0, 1),
                               rel).transpose(0, 1)
    assert ((got_k[:, page, off].float() - ref_rows).abs() <= bound).all()
    return q, kp, vp


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_prologue_matches_plain(cuda_device, dtype, d, norm):
    """The fused decode prologue against its plain chain (rms_norm,
    apply_rope, paged_kv_write_ref): bf16 within one bf16 ulp of each RoPE
    operand (2^-7), f32 within 1e-5 of them (the sum of squares and rsqrt
    differ in the last bits); v rows and untouched rows bitwise; two calls
    bitwise equal; one launch counted per call."""
    rng = np.random.default_rng(d + norm)
    case = fused_case(rng, s=12, hq=8, hkv=4, d=d, n=16, page=64, norm=norm)
    args = fused_operands(case, cuda_device, dtype)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    cuda_build.reset_launch_counts()
    q, kp, vp = check_fused_against_plain(args, 1e-6, rel)
    q2, kp2, vp2 = check_fused_against_plain(args, 1e-6, rel)
    assert torch.equal(q, q2) and torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert cuda_build.LAUNCHES["paged_kv_write_fused"] == 2
    assert cuda_build.LAUNCHES["paged_kv_write"] == 0


@pytest.mark.cuda
def test_cuda_fused_prologue_mixed_pool_dtype_and_wide_heads(cuda_device):
    """bf16 activations into f32 pools (``rollout.kv_cache_dtype``), D 256,
    and more head rows (Hq 48 + Hkv 8) than a block has warps."""
    rng = np.random.default_rng(7)
    for d, hq, pool in ((128, 16, torch.float32), (256, 4, torch.bfloat16),
                        (128, 48, torch.bfloat16)):
        case = fused_case(rng, s=5, hq=hq, hkv=8 if hq == 48 else 2, d=d,
                          n=8, page=16)
        check_fused_against_plain(
            fused_operands(case, cuda_device, torch.bfloat16, pool), 1e-6,
            2.0 ** -7)


@pytest.mark.cuda
def test_cuda_fused_prologue_graph_replay_equals_eager(cuda_device):
    """One replay of a CUDA-graph capture of the fused kernel gives the
    eager call's q and pools bitwise (nothing is read on the host)."""
    rng = np.random.default_rng(3)
    case = fused_case(rng, s=16, hq=16, hkv=8, d=128, n=32, page=64)
    args = fused_operands(case, cuda_device, torch.bfloat16)
    rest = {k_: v for k_, v in args.items() if k_ not in ("k_pool", "v_pool")}
    ek, ev = args["k_pool"].clone(), args["v_pool"].clone()
    eq = tpa.paged_kv_write_fused(ek, ev, **rest)
    gk, gv = args["k_pool"].clone(), args["v_pool"].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gq = tpa.paged_kv_write_fused(gk, gv, **rest)
    torch.cuda.synchronize()
    assert torch.equal(gk, args["k_pool"])  # capture runs nothing
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gq, eq) and torch.equal(gk, ek) and torch.equal(gv, ev)


@pytest.mark.cuda
def test_cuda_fused_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    rng = np.random.default_rng(4)
    args = fused_operands(fused_case(rng, d=64), cuda_device, torch.bfloat16)

    def call(**over):
        a = dict(args, **over)
        return tpa.paged_kv_write_fused(**a)

    with pytest.raises(ValueError, match="dtype"):  # no float16 instance
        call(q=args["q"].half(), k=args["k"].half(), v=args["v"].half())
    with pytest.raises(ValueError, match="dtype"):  # q, k, v in two types
        call(q=args["q"].float())
    with pytest.raises(ValueError):  # k is not [S, Hkv*D]
        call(k=args["k"][:, :-64].contiguous())
    with pytest.raises(ValueError):  # a weight of the wrong width
        call(k_norm=args["k_norm"][:32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(k_pool=args["k_pool"].transpose(1, 2))
    with pytest.raises(ValueError, match="cos"):
        call(cos=args["cos"].double())
    pool48 = torch.zeros((2, 16, PAGE, 48), device=cuda_device,
                         dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        call(k_pool=pool48, v_pool=pool48.clone(),
             q=args["q"][:, :4 * 48].contiguous(),
             k=args["k"][:, :2 * 48].contiguous(),
             v=args["v"][:, :2 * 48].contiguous(),
             cos=args["cos"][:, :24].contiguous(),
             sin=args["sin"][:, :24].contiguous(), q_norm=None, k_norm=None)
    torch.cuda.synchronize()


# -- K4: training flash attention, forward and backward --------------------------


def flash_case(rng, b=3, t=200, hq=8, hkv=2, d=128, pad=(0, 37, 0), tail=(0, 0, 23),
               packed=None):
    """q/k/v/dout from a numpy seed and a [B, T] mask: row i has ``pad[i]``
    left pads and ``tail[i]`` right pads; ``packed`` (a row index) gets
    segment ids 1/2/3 over three stretches instead (pads 0)."""
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        mask[i, :pad[i]] = 0
        if tail[i]:
            mask[i, t - tail[i]:] = 0
    seg = mask.astype(np.int32)
    if packed is not None:
        cuts = sorted(rng.choice(np.arange(8, t - 8), 2, replace=False))
        seg[packed] = np.concatenate([np.full(cuts[0], 1), np.full(cuts[1] - cuts[0], 2),
                                      np.full(t - cuts[1], 3)]).astype(np.int32)
        seg[packed, t - 5:] = 0  # pads after the last segment
    return q, k, v, do, mask, seg


def rel_err(a, b):
    """Relative Frobenius error ||a - b|| / ||b||."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _flash_both(case, device, dtype, causal=True):
    from polyrl_tpu_torch.ops import flash

    q, k, v, do, mask, seg = _t(case, device)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    outs = []
    for fn in (flash.flash_attention_train, flash.flash_attention_train_ref):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = fn(qq, kk, vv, mask, causal=causal, segment_ids=seg)
        o.backward(do)
        outs.append((o.detach(), qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,hkv", [(torch.float32, 128, 2),
                                         (torch.float32, 64, 8),
                                         (torch.bfloat16, 128, 4),
                                         (torch.bfloat16, 64, 2)])
def test_cuda_flash_matches_plain(cuda_device, dtype, d, hkv):
    """K4 forward and backward against the plain version (autograd through
    it, f32 softmax) at a T that tiles by no block (200), with left and
    right pads and a packed row of 3 segments. f32: out within 2e-4, each
    gradient within 1e-4 relative Frobenius error (reduction order only).
    bf16: out within rtol 1e-2 / atol 2e-3 (rounded to bf16 once, one ulp
    is at most 2^-7 of the value), gradients within 1e-2."""
    rng = np.random.default_rng(21)
    case = flash_case(rng, d=d, hkv=hkv, packed=0)
    cuda_build.reset_launch_counts()
    (o, dq, dk, dv), (ro, rdq, rdk, rdv) = _flash_both(case, cuda_device, dtype)
    assert cuda_build.LAUNCHES["flash_attention_fwd"] == 1
    assert cuda_build.LAUNCHES["flash_attention_bwd"] == 1
    tol = (dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32
           else dict(rtol=1e-2, atol=2e-3))
    gtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    for name, g, rg in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        assert rel_err(g, rg) <= gtol, (name, rel_err(g, rg))


def _tols(dtype):
    """(out tolerance, gradient relative-error limit) of K4 against its
    plain version: f32 differs by reduction order only; bf16 rounds its
    output once (one ulp is at most 2^-7 of the value) and, on the tensor
    cores, P and dS once each before their products."""
    if dtype == torch.float32:
        return dict(rtol=2e-4, atol=2e-4), 1e-4
    return dict(rtol=1e-2, atol=2e-3), 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_non_causal_and_long_rows(cuda_device, dtype):
    """Non-causal attention (every K/V tile) at T 130 and a row of 1,000
    tokens (16 tiles, the last ragged), in f32 (CUDA cores) and bf16
    (tensor cores)."""
    rng = np.random.default_rng(22)
    tol, gtol = _tols(dtype)
    for causal, t in ((False, 130), (True, 1000)):
        case = flash_case(rng, b=2, t=t, hq=4, hkv=2, d=64, pad=(5, 0),
                          tail=(0, 9), packed=1)
        (o, dq, dk, dv), (ro, rdq, rdk, rdv) = _flash_both(
            case, cuda_device, dtype, causal=causal)
        torch.testing.assert_close(o.float(), ro.float(), **tol)
        for g, rg in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert rel_err(g, rg) <= gtol, (causal, t, rel_err(g, rg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t", [(torch.float32, 193), (torch.bfloat16, 193),
                                     (torch.bfloat16, 513)])
def test_cuda_flash_one_row_past_the_tiles(cuda_device, dtype, t):
    """T = 64 k + 1: the last tile holds one real row and 63 zero-filled
    ones, with a right-padded row and a packed row beside it."""
    rng = np.random.default_rng(24)
    tol, gtol = _tols(dtype)
    case = flash_case(rng, b=3, t=t, hq=8, hkv=4, d=128, pad=(0, 11, 0),
                      tail=(0, 0, 17), packed=0)
    (o, dq, dk, dv), (ro, rdq, rdk, rdv) = _flash_both(case, cuda_device, dtype)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    for name, g, rg in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert rel_err(g, rg) <= gtol, (name, rel_err(g, rg))


@pytest.mark.cuda
def test_cuda_flash_backward_is_bitwise_repeatable(cuda_device):
    """Two backward calls on the same bf16 inputs give bitwise the same
    dq, dk and dv: every gradient element is summed by one block in a
    fixed order, with no atomics."""
    from polyrl_tpu_torch.ops import flash

    rng = np.random.default_rng(25)
    q, k, v, do, mask, seg = _t(flash_case(rng, b=2, t=300, hq=8, hkv=2,
                                           pad=(0, 20), tail=(0, 0), packed=1),
                                cuda_device)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = flash.flash_fwd_cuda(q, k, v, seg, True)
    first = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True)
    second = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_survives_checkpoint_recompute(cuda_device, dtype):
    """Under torch.utils.checkpoint (the decoder's remat) the forward runs
    twice and the gradients equal bitwise those of the same graph without
    remat: the recomputed forward and the backward are deterministic."""
    from torch.utils.checkpoint import checkpoint

    from polyrl_tpu_torch.ops import flash

    rng = np.random.default_rng(23)
    q, k, v, do, mask, _seg = _t(flash_case(rng, b=2, t=96, hq=4, hkv=2, d=64,
                                            pad=(3, 0), tail=(0, 4)), cuda_device)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    grads = []
    cuda_build.reset_launch_counts()
    for remat in (True, False):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))

        def f(a, b_, c):
            return flash.flash_attention_train(a * 1.5, b_, c, mask)
        o = checkpoint(f, qq, kk, vv, use_reentrant=False) if remat else f(qq, kk, vv)
        o.backward(do)
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["flash_attention_fwd"] == 3
    assert cuda_build.LAUNCHES["flash_attention_bwd"] == 2
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_flash_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    from polyrl_tpu_torch.ops import flash

    mask = torch.ones((1, 16), device=cuda_device)
    for d, dtype in ((96, torch.float32), (64, torch.float16)):
        x = torch.zeros((1, 16, 2, d), device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError):
            flash.flash_attention_train(x, x, x, mask)
    x = torch.zeros((1, 2, 16, 64), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):  # not contiguous
        flash.flash_attention_train(x, x, x, mask)
    flat = torch.zeros((16 * 2 * 64 + 1,), device=cuda_device, dtype=torch.bfloat16)
    x = flat[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off
        flash.flash_attention_train(x, x, x, mask)


def _small_engine(device, seed=0, int8=False, **kw):
    """A 2-layer bf16 qwen3-shaped model (head_dim 64, qk-norm, tied
    embeddings) behind a CBEngine on the card, not started; ``int8``
    serves its projections quantized (``quant.quantize_params``)."""
    from polyrl_tpu_torch.models import decoder, quant
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    cfg = decoder.ModelConfig(
        vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10000.0,
        use_qk_norm=True, tie_word_embeddings=True, rms_norm_eps=1e-6,
        max_position_embeddings=4096, dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(11)
    params = decoder.init_params(gen, cfg)
    if int8:
        params = quant.quantize_params(params)
    geom = dict(max_slots=16, page_size=16, max_seq_len=256,
                prompt_buckets=(32, 64), num_pages=64, steps_per_dispatch=4,
                seed=seed, device=device)
    return CBEngine(cfg, params, **{**geom, **kw}), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_engine_dispatch_graph_replay_equals_eager(cuda_device, int8):
    """The engine's captured k-step dispatch, replayed, gives the eager
    body's greedy tokens, logprobs, done flags, device state and pools
    bitwise, for an ungrouped key (K2) and a grouped one (K3), with bf16
    weights and with int8 ones (each product's dequantized copy allocated
    inside the graph's pool); each replay credits the launches its capture
    recorded."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng, cfg = _small_engine(cuda_device, int8=int8)
    rng = np.random.default_rng(8)
    sp = SamplingParams(temperature=0.0, max_new_tokens=40)
    prompt = rng.integers(1, cfg.vocab_size, 40).tolist()  # 2 shared pages
    for i in range(4):
        eng.submit(f"g{i}", prompt, sp, group_id="g", group_size=4)
    for i, n in enumerate((9, 27)):
        eng.submit(f"s{i}", rng.integers(1, cfg.vocab_size, n).tolist(), sp)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._drain_emit_q()
    tables = eng._decode_group_pack()
    assert tables is not None and int(eng._active.sum()) == 6
    for tb in (None, tables):
        run = graph_against_eager(eng, False, tb)
        for a, b in zip(run["graph"], run["eager"]):
            assert torch.equal(a, b)
        assert states_equal(run["graph_state"], run["eager_state"])
        assert (run["graph"][0][:, :6] != eng.pad_token_id).any()
    cuda_build.reset_launch_counts()
    eng._launch_decode(False, tables)
    torch.cuda.synchronize()
    per = eng.steps_per_dispatch * cfg.num_layers
    assert cuda_build.LAUNCHES["paged_kv_write_fused"] == per
    assert cuda_build.LAUNCHES["grouped_paged_attention"] == per
    assert cuda_build.LAUNCHES["paged_attention"] == 0
    assert eng.graph_captures == len(eng._graphs) == 2


@pytest.mark.cuda
def test_cuda_engines_with_one_seed_sample_alike(cuda_device):
    """Graph replays advance the engine's own generator: two engines with
    the same seed give the same sampled tokens, another seed others, and
    every stream runs to its budget."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 1024, n).tolist() for n in (5, 18, 33, 12)]
    sp = SamplingParams(temperature=1.0, top_k=20, top_p=0.9,
                        max_new_tokens=21)
    res = []
    for seed in (7, 7, 8):
        eng, _cfg = _small_engine(cuda_device, seed=seed)
        res.append([r["token_ids"] for r in eng.generate(prompts, sp)])
        eng.stop()
        assert eng.graph_replays > 0
    assert all(len(t) == 21 for t in res[0])
    assert res[0] == res[1] and res[0] != res[2]


@pytest.mark.cuda
def test_cuda_spec_dispatch_graph_replay_equals_eager(cuda_device):
    """A speculating engine's captured dispatch (``spec_rounds`` verify
    forwards over ``S * (spec_tokens + 1)`` rows through the fused prologue
    and K2), replayed, gives the eager body's tokens, logprobs, done and
    emitted flags, device state (the token buffer included) and pools
    bitwise, with sampled rows drawing from the registered generator;
    each replay credits one fused prologue and one K2 launch per layer
    and round, and never K3."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng, cfg = _small_engine(cuda_device, spec_tokens=3, spec_rounds=2)
    rng = np.random.default_rng(10)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=40)
    sampled = SamplingParams(temperature=1.0, top_k=20, top_p=0.9,
                             max_new_tokens=40)
    prompt = rng.integers(1, cfg.vocab_size, 40).tolist()
    for i in range(3):
        eng.submit(f"g{i}", prompt, sampled, group_id="g", group_size=3)
    eng.submit("rep", rng.integers(1, cfg.vocab_size, 8).tolist() * 4, greedy)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._drain_emit_q()
    assert int(eng._active.sum()) == 4
    key, body = eng._spec_key(True), (lambda: eng._spec_body(True))
    snap = engine_snapshot(eng)
    eng._launch(key, body)
    graph_out, graph_state = engine_outputs(eng)
    engine_restore(eng, snap)
    eng._spec_body(True)
    eager_out, eager_state = engine_outputs(eng)
    engine_restore(eng, snap)
    for a, b in zip(graph_out, eager_out):
        assert torch.equal(a, b)
    assert states_equal(graph_state, eager_state)
    assert int(graph_out[3].sum()) >= 2 * 4  # >= one token a round a slot
    cuda_build.reset_launch_counts()
    eng._launch(key, body)
    torch.cuda.synchronize()
    per = eng.spec_rounds * cfg.num_layers
    assert cuda_build.LAUNCHES["paged_kv_write_fused"] == per
    assert cuda_build.LAUNCHES["paged_attention"] == per
    assert cuda_build.LAUNCHES["grouped_paged_attention"] == 0


@pytest.mark.cuda
def test_cuda_spill_and_restore_while_decode_graphs_replay(cuda_device):
    """The host spill tier on the card, behind decode dispatches replayed
    from their CUDA graph on the compute stream: a published chain is
    spilled (gather on the compute stream, device-to-host on the copy
    stream), the gathered block's memory and the freed pages are
    overwritten at once, the chain is restored into fresh pages, spilled
    again into the same host buffers (the restore's copy still reading
    them) and restored once more; the pages come back bitwise, the pools
    keep their addresses and the decode graphs replay with no new
    capture."""
    from polyrl_tpu_torch.rollout.cb_engine import STREAM_END
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng, cfg = _small_engine(cuda_device, num_pages=96)
    rng = np.random.default_rng(5)
    q = eng.submit("pub", rng.integers(1, cfg.vocab_size, 64).tolist(),
                   SamplingParams(temperature=0.0, max_new_tokens=4))
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        while eng._active.any():
            eng._step_once()
        eng._drain_emit_q()
    items = []
    while (item := q.get(timeout=5)) is not STREAM_END:
        items.append(item)
    assert items[-1]["finish_reason"] == "length"
    entries = sorted(eng.prefix_cache.spill_candidates(), key=lambda e: e.page)
    assert len(entries) == 3  # the prompt's full pages
    kp, vp = eng._pools
    ptrs = [t.data_ptr() for t in kp + vp]
    want = [torch.stack([t[:, e.page] for t in kp + vp]).clone()
            for e in entries]
    sp = SamplingParams(temperature=0.0, max_new_tokens=200)
    for i in range(4):
        eng.submit(f"d{i}", rng.integers(1, cfg.vocab_size, 20).tolist(), sp)
    eng._drain_queue()
    torch.cuda.synchronize()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()  # captures the ungrouped key
        captures = eng.graph_captures
        for round_ in range(2):
            for _ in range(3):
                eng._step_once()  # replays queued ahead of the spill
            old = [e.page for e in entries]
            assert eng._spill_pages(3, cold_only=False) == 3
            assert all(e.spilled for e in entries)
            # what would corrupt the copies: the gathered block's memory
            # handed out again, and the freed pages written by a prefill
            junk = [torch.full((3, 2 * cfg.num_layers) + tuple(kp[0][:, 0].shape),
                               -3.0, dtype=kp[0].dtype, device=cuda_device)
                    for _ in range(4)]
            held = eng.allocator.alloc(3)
            idx = torch.tensor(held, device=cuda_device)
            for t in kp + vp:
                t.index_fill_(1, idx, 5.0)
            eng._step_once()
            assert eng._restore_entries(entries)
            eng.allocator.free(held)
            assert not {e.page for e in entries} & set(old)
            del junk
        eng._step_once()
        torch.cuda.synchronize()
        assert eng.graph_captures == captures
    assert [t.data_ptr() for t in kp + vp] == ptrs
    for e, w in zip(entries, want):
        assert torch.equal(torch.stack([t[:, e.page] for t in kp + vp]), w)
    stats = eng.kvspill.stats()
    assert stats["copy_batches"] == 2 and stats["resident_pages"] == 0
    assert stats["pinned_bytes"] == 3 * want[0].numel() * want[0].element_size()
    eng.stop()
