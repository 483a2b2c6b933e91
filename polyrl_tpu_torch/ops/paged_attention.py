"""Paged decode attention and the paged K/V write, for the decode hot path.

Counterpart of ``polyrl_tpu/ops/paged_attention.py``. For each of the three
TPU kernels of that module, and for the fused decode prologue that takes
K1's place on the decode step (qk-norm, RoPE and the K/V write in one
kernel), this file holds:

- the plain PyTorch version (``*_ref``), the same arithmetic as the JAX
  oracle: the CPU path and the yardstick the CUDA kernel is held to;
- the wrapper the model calls, which takes the plain version only for
  tensors on the CPU and otherwise launches the hand-written Hopper kernel
  (``csrc/*.cu``) or raises -- it never falls back for a CUDA tensor;
- a plain-integer launch count in ``cuda_build.LAUNCHES`` (the port's one
  counter) that the wrapper bumps where it launches its kernel and
  nowhere else.

Pools are head-major ``[Hkv, N_pages, page_size, D]`` with page 0 the null
page (the layout ``decoder.make_paged_pools`` allocates). ``NEG_INF`` is
the finite float32 minimum, as in the JAX code: with ``-inf`` an empty
row's ``exp(m_prev - m_new)`` would be NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops.norm_rope import apply_rope, rms_norm

NEG_INF = float(np.finfo(np.float32).min)

# -- plain versions ------------------------------------------------------------


def paged_attention_ref(q: torch.Tensor,           # [S, Hq, D]
                        k_pool: torch.Tensor,      # [Hkv, N, ps, D]
                        v_pool: torch.Tensor,
                        page_table: torch.Tensor,  # [S, P] page ids
                        seq_lens: torch.Tensor,    # [S] valid tokens
                        scale: float | None = None) -> torch.Tensor:
    """Gather + dense f32 softmax. Returns [S, Hq, D] in q.dtype."""
    s, hq, d = q.shape
    hkv, _n, ps, _ = k_pool.shape
    p = page_table.shape[1]
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    pt = page_table.long()
    k = k_pool[:, pt].reshape(hkv, s, p * ps, d)
    v = v_pool[:, pt].reshape(hkv, s, p * ps, d)
    qr = q.reshape(s, hkv, rep, d).float()
    logits = torch.einsum("shrd,hstd->shrt", qr, k.float()) * scale
    pos = torch.arange(p * ps, device=q.device)[None, :]
    valid = pos < seq_lens.clamp(min=1)[:, None]  # empty rows stay finite
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shrt,hstd->shrd", probs, v.float())
    return out.reshape(s, hq, d).to(q.dtype)


def _group_slot_maps(group_slots: torch.Tensor, group_prefix_lens: torch.Tensor,
                     s: int, page_size: int):
    """Invert the group table [NG, G] (-1 = empty seat) into per-slot maps:
    group row (-1 = ungrouped), seat column, and the number of leading
    page-table columns phase 1 covers.

    A -1 seat must never be used as an index: in PyTorch it would wrap to
    the last slot and silently overwrite it. Seats are masked to a dump
    index ``s`` one past the end, written into an ``s + 1`` buffer, and
    the dump entry is sliced off (the JAX ``mode="drop"`` scatter)."""
    ng, gmax = group_slots.shape
    dev = group_slots.device
    flat = group_slots.reshape(-1).long()
    gidx = torch.arange(ng, device=dev).repeat_interleave(gmax)
    gcol = torch.arange(gmax, device=dev).repeat(ng)
    tgt = torch.where(flat >= 0, flat, s)
    slot_grp = torch.full((s + 1,), -1, dtype=torch.long, device=dev)
    slot_grp.scatter_(0, tgt, gidx)
    slot_col = torch.zeros((s + 1,), dtype=torch.long, device=dev)
    slot_col.scatter_(0, tgt, gcol)
    slot_grp, slot_col = slot_grp[:s], slot_col[:s]
    pre_tok = group_prefix_lens.long()[slot_grp.clamp(0, ng - 1)]
    slot_npre = torch.where(slot_grp >= 0, pre_tok // page_size, 0)
    return slot_grp, slot_col, slot_npre


def grouped_paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens,
                                group_slots,         # [NG, G], -1 = empty seat
                                group_prefix_pages,  # [NG, P_pre]
                                group_prefix_lens,   # [NG] prefix tokens (page mult.)
                                scale: float | None = None) -> torch.Tensor:
    """Two-phase plain version: prefix/suffix split and LSE merge.

    Contract (what the engine guarantees): every seated slot's leading
    page-table columns equal its group's prefix pages and its seq_len
    exceeds the prefix length, so the result equals ``paged_attention_ref``
    on the full tables up to float reduction order."""
    s, hq, d = q.shape
    hkv, _n, ps, _ = k_pool.shape
    p = page_table.shape[1]
    ng = group_slots.shape[0]
    p_pre = group_prefix_pages.shape[1]
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device

    slot_grp, _col, slot_npre = _group_slot_maps(group_slots, group_prefix_lens,
                                                 s, ps)
    pre_tok = (slot_npre * ps)[:, None]
    qr = q.reshape(s, hkv, rep, d).float()

    # phase 1: every slot against its group's shared prefix
    gi = slot_grp.clamp(0, ng - 1)
    gpp = group_prefix_pages.long()
    kp = k_pool[:, gpp].reshape(hkv, ng, p_pre * ps, d)[:, gi]
    vp = v_pool[:, gpp].reshape(hkv, ng, p_pre * ps, d)[:, gi]
    logits1 = torch.einsum("shrd,hstd->shrt", qr, kp.float()) * scale
    valid1 = torch.arange(p_pre * ps, device=dev)[None, :] < pre_tok
    logits1 = torch.where(valid1[:, None, None, :], logits1, NEG_INF)
    m1 = logits1.amax(dim=-1)
    e1 = torch.exp(logits1 - m1[..., None])
    e1 = torch.where(valid1[:, None, None, :], e1, 0.0)
    l1 = e1.sum(dim=-1)
    acc1 = torch.einsum("shrt,hstd->shrd", e1, vp.float())
    grouped = (slot_grp >= 0)[:, None, None]
    m1 = torch.where(grouped, m1, NEG_INF)
    l1 = torch.where(grouped, l1, 0.0)
    acc1 = torch.where(grouped[..., None], acc1, 0.0)

    # phase 2: each slot's own pages past the prefix
    pt = page_table.long()
    k2 = k_pool[:, pt].reshape(hkv, s, p * ps, d)
    v2 = v_pool[:, pt].reshape(hkv, s, p * ps, d)
    logits2 = torch.einsum("shrd,hstd->shrt", qr, k2.float()) * scale
    pos2 = torch.arange(p * ps, device=dev)[None, :]
    valid2 = (pos2 >= pre_tok) & (pos2 < seq_lens.clamp(min=1)[:, None])
    logits2 = torch.where(valid2[:, None, None, :], logits2, NEG_INF)
    m2 = logits2.amax(dim=-1)
    e2 = torch.exp(logits2 - m2[..., None])
    e2 = torch.where(valid2[:, None, None, :], e2, 0.0)
    l2 = e2.sum(dim=-1)
    acc2 = torch.einsum("shrt,hstd->shrd", e2, v2.float())

    # LSE merge (finite NEG_INF keeps both alphas NaN-free)
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    l_tot = a1 * l1 + a2 * l2
    acc = a1[..., None] * acc1 + a2[..., None] * acc2
    out = acc / l_tot.clamp(min=1e-30)[..., None]
    return out.reshape(s, hq, d).to(q.dtype)


def paged_kv_write_ref(k_pool, v_pool, write_page, write_off, k_upd, v_upd):
    """Row scatter of one token's K/V per slot into the pools, in place
    (``_scatter_token_kv`` of the JAX decoder, applied to K and V)."""
    for pool, upd in ((k_pool, k_upd), (v_pool, v_upd)):
        hkv, n, ps, d = pool.shape
        s = write_page.shape[0]
        flat = pool.view(hkv * n * ps, d)
        head_off = torch.arange(hkv, device=pool.device)[:, None] * (n * ps)
        idx = (head_off + (write_page.long() * ps + write_off.long())[None, :])
        rows = upd.transpose(0, 1).reshape(hkv * s, d).to(pool.dtype)
        flat.index_copy_(0, idx.reshape(-1), rows)
    return k_pool, v_pool


def paged_kv_write_fused_ref(k_pool, v_pool, write_page, write_off, q, k, v,
                             cos, sin, q_norm=None, k_norm=None,
                             eps: float = 1e-6) -> torch.Tensor:
    """The decode step's prologue as the plain chain computes it: per-head
    RMSNorm of q and k (where a weight is given), RoPE of both, and the
    paged write of k and v (``paged_kv_write_ref``), in place. q is
    [S, Hq*D] or [S, Hq, D], k and v [S, Hkv*D] or [S, Hkv, D], cos and
    sin [S, D/2] f32. Returns q rotated, [S, Hq, D] in q's dtype."""
    hkv, _n, _ps, d = k_pool.shape
    s = write_page.shape[0]
    q = q.reshape(s, 1, -1, d)
    k = k.reshape(s, 1, hkv, d)
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
    if k_norm is not None:
        k = rms_norm(k, k_norm, eps)
    cos, sin = cos.reshape(s, 1, -1), sin.reshape(s, 1, -1)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    paged_kv_write_ref(k_pool, v_pool, write_page, write_off, k[:, 0],
                       v.reshape(s, hkv, d))
    return q[:, 0]


# -- wrappers ------------------------------------------------------------------


def _cuda_operand(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """Contiguous, 16-byte aligned tensor on ``device`` (cast to ``dtype``)."""
    if t.device != device:
        raise ValueError(f"operand on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _check_head_dim(d: int, name: str) -> None:
    if d % 32 or d > 256:
        raise ValueError(f"{name}: head_dim {d} unsupported by the CUDA kernel "
                         "(a multiple of 32, at most 256)")


# K2 and K3 split each page-table row into chunks of C columns, one work
# item per (chunk, slot, kv head) (csrc/paged_common.cuh)
CHUNK_POSITIONS = 256  # key positions one work item aims to cover; C stays
                       # within it, the kernels' kMaxCols columns
FILL_ITEMS = 4 * 132   # items the grid offers at least: 4 per SM of an H100


def chunk_pages(s: int, hkv: int, p: int, page_size: int) -> int:
    """Page-table columns per work item of K2/K3, from the shapes alone:
    ``seq_lens`` lives on the device and advances between the steps of a
    dispatch, so reading it here would stall the step and break CUDA-graph
    capture. About CHUNK_POSITIONS positions an item, halved while the
    ``s * hkv * ceil(p / C)`` items would not fill the card's SMs four
    times over."""
    c = max(1, min(p, CHUNK_POSITIONS // page_size))
    while c > 1 and s * hkv * -(-p // c) < FILL_ITEMS:
        c //= 2
    return c


def paged_kv_write(k_pool, v_pool, write_page, write_off, k_upd, v_upd):
    """Write one token's K/V per slot into the pools in place; returns the
    pools. K1 (``csrc/paged_kv_write.cu``) on CUDA tensors."""
    if cuda_build.on_cpu(k_pool):
        return paged_kv_write_ref(k_pool, v_pool, write_page, write_off,
                                  k_upd, v_upd)
    dev = k_pool.device
    hkv, n, ps, d = k_pool.shape
    if (v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype
            or not k_pool.is_contiguous() or not v_pool.is_contiguous()):
        raise ValueError("paged_kv_write: pools must be contiguous and alike")
    row_bytes = d * k_pool.element_size()
    if row_bytes % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_kv_write: rows must be 16-byte multiples/aligned")
    s = write_page.shape[0]
    k_upd = _cuda_operand(k_upd, dev, k_pool.dtype)
    v_upd = _cuda_operand(v_upd, dev, k_pool.dtype)
    if k_upd.shape != (s, hkv, d) or v_upd.shape != (s, hkv, d):
        raise ValueError(f"paged_kv_write: updates must be [{s}, {hkv}, {d}]")
    page = _cuda_operand(write_page, dev, torch.int32)
    off = _cuda_operand(write_off, dev, torch.int32)
    cuda_build.launch("paged_kv_write", k_pool.data_ptr(), v_pool.data_ptr(),
                      page.data_ptr(), off.data_ptr(), k_upd.data_ptr(),
                      v_upd.data_ptr(), s, hkv, n, ps, row_bytes,
                      cuda_build.stream_of(dev))
    cuda_build.count_launch("paged_kv_write")
    return k_pool, v_pool


def paged_kv_write_fused(k_pool, v_pool, write_page, write_off, q, k, v,
                         cos, sin, q_norm=None, k_norm=None,
                         eps: float = 1e-6) -> torch.Tensor:
    """qk-norm, RoPE and the paged K/V write of one decode token per slot;
    returns q rotated, [S, Hq, D]. Arguments as ``paged_kv_write_fused_ref``.
    On CUDA tensors one launch of ``csrc/paged_kv_write_fused.cu`` (K1
    redesigned): q, k, v and the weights in one type (f32 or bf16), the
    pools in one type (f32 or bf16), head_dim a multiple of 32 up to 256."""
    if cuda_build.on_cpu(k_pool):
        return paged_kv_write_fused_ref(k_pool, v_pool, write_page, write_off,
                                        q, k, v, cos, sin, q_norm, k_norm, eps)
    name = "paged_kv_write_fused"
    dev = k_pool.device
    hkv, n, ps, d = k_pool.shape
    s = write_page.shape[0]
    _check_head_dim(d, name)
    if (k_pool.dtype not in cuda_build.DTYPE_CODE or v_pool.shape != k_pool.shape
            or v_pool.dtype != k_pool.dtype or not k_pool.is_contiguous()
            or not v_pool.is_contiguous() or k_pool.device != v_pool.device):
        raise ValueError(f"{name}: pools must be contiguous, alike, f32 or bf16")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned")
    act = q.dtype
    if act not in cuda_build.DTYPE_CODE or k.dtype != act or v.dtype != act:
        raise ValueError(f"{name}: q, k, v must share one dtype, f32 or bf16")
    if (s == 0 or q.numel() % (s * d) or k.numel() != s * hkv * d
            or v.numel() != s * hkv * d):
        raise ValueError(f"{name}: q must be [{s}, Hq*{d}], k and v "
                         f"[{s}, {hkv * d}]")
    hq = q.numel() // (s * d)
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 or \
            cos.numel() != s * d // 2 or sin.numel() != s * d // 2:
        raise ValueError(f"{name}: cos and sin must be f32 [{s}, {d // 2}]")
    for w in (q_norm, k_norm):
        if w is not None and (w.dtype != act or w.numel() != d):
            raise ValueError(f"{name}: a norm weight must be [{d}] in {act}")
    # operands held by name until the launch (a cast or clone would
    # otherwise be freed under the kernel); a null weight skips that norm
    norms = [None if w is None else _cuda_operand(w, dev)
             for w in (q_norm, k_norm)]
    qc, kc, vc = (_cuda_operand(x, dev) for x in (q, k, v))
    cos, sin = _cuda_operand(cos, dev), _cuda_operand(sin, dev)
    page = _cuda_operand(write_page, dev, torch.int32)
    off = _cuda_operand(write_off, dev, torch.int32)
    out = torch.empty((s, hq, d), dtype=act, device=dev)
    cuda_build.launch(
        name, out.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        *(0 if w is None else w.data_ptr() for w in norms), cos.data_ptr(),
        sin.data_ptr(), page.data_ptr(), off.data_ptr(),
        cuda_build.DTYPE_CODE[act], cuda_build.DTYPE_CODE[k_pool.dtype], s, hq,
        hkv, n, ps, d, float(eps), cuda_build.stream_of(dev))
    cuda_build.count_launch(name)
    return out


def _attn_operands(name, q, k_pool, v_pool, page_table, seq_lens):
    dev = k_pool.device
    if (k_pool.dtype not in cuda_build.DTYPE_CODE
            or v_pool.dtype != k_pool.dtype):
        raise ValueError(f"{name}: pool dtype {k_pool.dtype} unsupported")
    if q.shape[1] % k_pool.shape[0]:
        raise ValueError(f"{name}: Hq must be a multiple of Hkv")
    _check_head_dim(q.shape[2], name)
    if k_pool.dtype == torch.bfloat16 and q.shape[2] not in (64, 128):
        raise ValueError(f"{name}: the bf16 kernel (tensor cores) takes head_dim "
                         f"64 or 128, not {q.shape[2]}")
    return (_cuda_operand(q, dev, k_pool.dtype), _cuda_operand(k_pool, dev),
            _cuda_operand(v_pool, dev),
            _cuda_operand(page_table, dev, torch.int32),
            _cuda_operand(seq_lens, dev, torch.int32))


def paged_attention_launcher(q, k_pool, v_pool, page_table, seq_lens, scale=None):
    """K2's checked operands, scratch and output for CUDA tensors: returns
    ``(out, run)``, where ``run(phases)`` launches the split kernel (1),
    the combine kernel (2) or both (3), and counts nothing. ``out`` is in
    the pools' dtype."""
    s, hq, d = q.shape
    hkv, n, ps, _ = k_pool.shape
    scale = scale if scale is not None else d ** -0.5
    qc, kp, vp, pt, lens = _attn_operands("paged_attention", q, k_pool, v_pool,
                                          page_table, seq_lens)
    p = pt.shape[1]
    c = chunk_pages(s, hkv, p, ps)
    stats = torch.empty((s * hkv * -(-p // c) * (hq // hkv) * (d + 2),),
                        dtype=torch.float32, device=q.device)
    out = torch.empty((s, hq, d), dtype=k_pool.dtype, device=q.device)

    def run(phases: int = 3) -> None:
        cuda_build.launch(
            "paged_attention", qc.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            pt.data_ptr(), lens.data_ptr(), stats.data_ptr(), out.data_ptr(),
            cuda_build.DTYPE_CODE[k_pool.dtype], s, hq, hkv, n, ps, d, p, c,
            phases, float(scale), cuda_build.stream_of(q.device))

    return out, run


def paged_attention(q, k_pool, v_pool, page_table, seq_lens, scale=None):
    """Decode attention over each slot's page row; [S, Hq, D] in q.dtype.
    K2 (``csrc/paged_attention.cu``: a split and a combine launch) on
    CUDA tensors; the f32 partial stats live in scratch allocated here."""
    if cuda_build.on_cpu(q):
        return paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens, scale)
    out, run = paged_attention_launcher(q, k_pool, v_pool, page_table, seq_lens,
                                        scale)
    run()
    cuda_build.count_launch("paged_attention")
    return out.to(q.dtype)


def grouped_paged_attention_launcher(q, k_pool, v_pool, page_table, seq_lens,
                                     group_slots, group_prefix_pages,
                                     group_prefix_lens, scale=None):
    """K3's checked operands, scratch and output for CUDA tensors, as
    ``paged_attention_launcher``."""
    s, hq, d = q.shape
    hkv, n, ps, _ = k_pool.shape
    ng, gmax = group_slots.shape
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qc, kp, vp, pt, lens = _attn_operands("grouped_paged_attention", q, k_pool,
                                          v_pool, page_table, seq_lens)
    dev = q.device
    gs = _cuda_operand(group_slots, dev, torch.int32)
    gpp = _cuda_operand(group_prefix_pages, dev, torch.int32)
    gpl = _cuda_operand(group_prefix_lens, dev, torch.int32)
    p, p_pre = pt.shape[1], gpp.shape[1]
    c = chunk_pages(s, hkv, p, ps)
    n_own = s * hkv * -(-p // c) * rep * (d + 2)
    n_pre = ng * hkv * -(-p_pre // c) * gmax * rep * (d + 2)
    stats = torch.empty((n_own + n_pre,), dtype=torch.float32, device=dev)
    out = torch.empty((s, hq, d), dtype=k_pool.dtype, device=dev)

    def run(phases: int = 3) -> None:
        cuda_build.launch(
            "grouped_paged_attention", qc.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            pt.data_ptr(), lens.data_ptr(), gs.data_ptr(), gpp.data_ptr(),
            gpl.data_ptr(), stats.data_ptr(), stats.data_ptr() + 4 * n_own,
            out.data_ptr(), cuda_build.DTYPE_CODE[k_pool.dtype], s, hq, hkv, n,
            ps, d, p, ng, gmax, p_pre, c, phases, float(scale),
            cuda_build.stream_of(dev))

    return out, run


def grouped_paged_attention(q, k_pool, v_pool, page_table, seq_lens,
                            group_slots, group_prefix_pages, group_prefix_lens,
                            scale=None):
    """Shared-prefix grouped decode attention; [S, Hq, D] in q.dtype.
    K3 (``csrc/grouped_paged_attention.cu``: a split launch holding the
    groups' prefix items and every slot's own items, and a combine launch)
    on CUDA tensors; the f32 partial stats live in scratch allocated
    here."""
    if cuda_build.on_cpu(q):
        return grouped_paged_attention_ref(
            q, k_pool, v_pool, page_table, seq_lens, group_slots,
            group_prefix_pages, group_prefix_lens, scale)
    out, run = grouped_paged_attention_launcher(
        q, k_pool, v_pool, page_table, seq_lens, group_slots,
        group_prefix_pages, group_prefix_lens, scale)
    run()
    cuda_build.count_launch("grouped_paged_attention")
    return out.to(q.dtype)


# -- tensor-parallel shards ------------------------------------------------------
#
# The counterparts of the reference's ``make_tp_paged_kv_write``,
# ``make_tp_paged_attention`` and ``make_tp_grouped_paged_attention``
# (``shard_map``s of its kernels over the head dim of a tp mesh). Here the
# shards of a one-process tensor-parallel engine each hold their own
# ``[Hkv/tp, N, ps, D]`` pools (allocated apart, so each is 16-byte
# aligned), and each function below runs the same kernel on every shard's
# heads, with the page table, the lengths and the group tables unsharded
# (moved to each shard's device; on one card that moves nothing). The
# ratio ``rep = Hq / Hkv`` is each shard's as the whole model's. They bring
# no kernel body; each launch counts as its kernel's.


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def make_tp_paged_kv_write_fused(eps: float = 1e-6):
    """``fn(k_pools, v_pools, write_page, write_off, qs, ks, vs, cos, sin,
    q_norms, k_norms) -> [q_s]``: the fused prologue (qk-norm, RoPE and the
    K/V write; K1 redesigned, the default decode route) on each shard's
    heads: the counterpart of the reference's ``make_tp_paged_kv_write``.
    ``q_norms``/``k_norms`` are one weight a shard (None: no qk-norm)."""

    def fn(k_pools, v_pools, write_page, write_off, qs, ks, vs, cos, sin,
           q_norms=None, k_norms=None):
        out = []
        for i, (kp, vp) in enumerate(zip(k_pools, v_pools)):
            dev = kp.device
            out.append(paged_kv_write_fused(
                kp, vp, _on(write_page, dev), _on(write_off, dev), qs[i], ks[i],
                vs[i], _on(cos, dev), _on(sin, dev),
                None if q_norms is None else q_norms[i],
                None if k_norms is None else k_norms[i], eps))
        return out

    return fn


def make_tp_paged_attention(scale=None):
    """``fn(qs, k_pools, v_pools, page_table, seq_lens) -> [out_s]``: K2
    on each shard's ``Hq/tp`` query heads against its ``Hkv/tp`` pools."""

    def fn(qs, k_pools, v_pools, page_table, seq_lens):
        return [paged_attention(q, kp, vp, _on(page_table, kp.device),
                                _on(seq_lens, kp.device), scale)
                for q, kp, vp in zip(qs, k_pools, v_pools)]

    return fn


def make_tp_grouped_paged_attention(group_slots, group_prefix_pages,
                                    group_prefix_lens, scale=None):
    """``fn(qs, k_pools, v_pools, page_table, seq_lens) -> [out_s]``: K3
    on each shard's heads, the group tables unsharded."""

    def fn(qs, k_pools, v_pools, page_table, seq_lens):
        out = []
        for q, kp, vp in zip(qs, k_pools, v_pools):
            dev = kp.device
            out.append(grouped_paged_attention(
                q, kp, vp, _on(page_table, dev), _on(seq_lens, dev),
                _on(group_slots, dev), _on(group_prefix_pages, dev),
                _on(group_prefix_lens, dev), scale))
        return out

    return fn
