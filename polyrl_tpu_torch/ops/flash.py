"""Flash attention for the TRAINING path (forward and backward, O(T) memory).

Counterpart of ``polyrl_tpu/ops/flash.py``. The JAX package trains with
JAX's bundled TPU flash kernel behind a wrapper; here the kernel is K4,
written by hand for Hopper (``csrc/flash_attention_{fwd,bwd}.cu``). Each of
its libraries holds one instance per dtype, chosen by the ``dtype``
argument of the same C entry points: bf16, the training path, runs on
Hopper's own instructions (``csrc/flash_wgmma.cuh``): a producer warp
copies 64-row tiles by TMA into an mbarrier ring, a consumer warpgroup
runs every product as ``wgmma`` with the shared-memory operands read by
descriptor and the probabilities (or their gradients) as the register
operand, and a (q tile, k tile) pair whose segment-id ranges are
disjoint is never copied nor computed. f32, used by gradient checks on an
f32 copy of the weights, keeps exact f32 products on CUDA cores
(``csrc/flash_f32.cuh``), since the tensor cores have no f32 mode without
TF32 and the port keeps TF32 off. Neither is a fallback of the other: a
launch that fails raises.

- ``flash_attention_train_ref``: the plain PyTorch version, the TPU
  kernel's semantics with f32 logits and softmax. The CPU path, and the
  yardstick the CUDA kernels are held to on the card.
- ``segment_tile_ranges`` / ``tile_pairs_run`` / ``tile_pairs_uniform``
  / ``tiles_run`` / ``dkv_splits`` / ``dkv_partials_ref``: plain versions
  of what the bf16 kernels decide on the device: each 64-row tile's
  (min, max) segment id, which tile pairs run and which need no mask, over
  how many blocks the backward spreads a kv head's q heads, and the
  fixed-order sum of the per-block dk/dv partials.
- ``FlashAttentionTrain``: the ``torch.autograd.Function`` whose forward
  launches the tile ranges (``tile_ranges``, which both launchers take)
  and the forward kernel and saves q, k, v, o, the f32 LSE ``[B, Hq, T]``
  and the ranges, and whose backward launches the backward kernels
  (delta, dq, dk/dv and, when split, the partials' sum). It survives
  ``torch.utils.checkpoint`` recompute.
- ``flash_attention_train`` / ``auto_train_attention``: the JAX signatures.
  CPU tensors go to the plain version; CUDA tensors go to the kernel, or
  the wrapper raises (unsupported head dim or dtype, non-contiguous or
  not 16-byte aligned input: TMA needs base and row stride on 16 bytes).
  There is no fallback, and unlike the TPU wrapper a T that does not
  tile is no reason to leave the kernel: the copies zero-fill past T and
  the kernels mask the ragged last tile themselves.

Semantics (the TPU kernel's): ``mask = causal & (seg_q == seg_k)`` with
``seg = attn_mask.to(int32)`` (pad 0, real 1) or the caller's
``segment_ids`` for packed rows. Pad rows attend pad keys, so no row is
fully masked; masked logits take the finite ``MASK_VALUE``. GQA reads kv
head ``h // rep`` in place; its gradient is the sum over the ``rep``
query heads (the VJP of the JAX wrapper's ``jnp.repeat``). ``sm_scale =
D ** -0.5``. Launches are counted per direction in ``cuda_build.LAUNCHES``
by the launchers ``flash_fwd_cuda`` and ``flash_bwd_cuda``, where they
launch: ``flash_attention_fwd`` once per forward (the tile ranges and the
attention kernel), ``flash_attention_bwd`` once per backward (all its
kernels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops.attention import causal_mask

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (64, 128)
TILE = 64  # rows of the bf16 kernels' q and k tiles
# the backward spreads a kv head's q heads until its dk/dv grid has this
# many blocks (one block an SM at D 128: about two waves on 132 SMs; at
# 512 the partials' extra pass cost more than the fuller grid gave, PERF.md)
DKV_MIN_BLOCKS = 256


def _segments(attn_mask: torch.Tensor, segment_ids) -> torch.Tensor:
    return (segment_ids if segment_ids is not None
            else attn_mask.to(torch.int32))


def flash_attention_train_ref(q, k, v, attn_mask, *, causal: bool = True,
                              segment_ids=None) -> torch.Tensor:
    """q [B,T,Hq,D], k/v [B,T,Hkv,D], attn_mask [B,T] (1 = valid) ->
    [B,T,Hq,D] in q.dtype. Plain PyTorch (differentiable by autograd),
    f32 logits and softmax."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    seg = _segments(attn_mask, segment_ids)
    mask = seg[:, :, None] == seg[:, None, :]              # [B, Tq, Tk]
    if causal:
        mask = mask & causal_mask(t, t, device=q.device)[None]
    qg = q.reshape(b, t, hkv, rep, d).float()
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * d ** -0.5
    logits = torch.where(mask[:, None, None], logits, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def segment_tile_ranges(seg: torch.Tensor) -> torch.Tensor:
    """[B, T] int32 segment ids -> [B, ceil(T / TILE), 2] int32: each
    tile's (min, max) id over its rows inside T. The plain version of
    ``flash_seg_ranges_kernel``."""
    b, t = seg.shape
    n = -(-t // TILE)
    info = torch.iinfo(torch.int32)
    pad = n * TILE - t
    lo = torch.nn.functional.pad(seg, (0, pad), value=info.max)
    hi = torch.nn.functional.pad(seg, (0, pad), value=info.min)
    return torch.stack([lo.view(b, n, TILE).amin(-1), hi.view(b, n, TILE).amax(-1)],
                       dim=-1).to(torch.int32)


def tile_pairs_run(ranges: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, n, 2] tile ranges -> [B, n_q, n_k] bool: the (q tile, k tile)
    pairs the bf16 kernels compute: below or on the diagonal when causal,
    and with ranges that meet. Any pair with a visible (query, key) pair
    runs: equal ids need ranges that meet."""
    lo, hi = ranges[..., 0], ranges[..., 1]
    meet = (lo[:, :, None] <= hi[:, None, :]) & (lo[:, None, :] <= hi[:, :, None])
    if causal:
        n = ranges.shape[1]
        meet = meet & torch.ones((n, n), dtype=torch.bool,
                                 device=ranges.device).tril()[None]
    return meet


def tile_pairs_uniform(ranges: torch.Tensor, t: int, causal: bool) -> torch.Tensor:
    """[B, n, 2] tile ranges -> [B, n_q, n_k] bool: the pairs the bf16
    kernels compute without a per-element mask (``tile_is_uniform``):
    both tiles full inside T, strictly below the diagonal when causal,
    one segment id throughout both."""
    n = ranges.shape[1]
    lo, hi = ranges[..., 0], ranges[..., 1]
    one = (lo == hi) & (torch.arange(n, device=ranges.device) < t // TILE)[None]
    same = one[:, :, None] & one[:, None, :] & (lo[:, :, None] == lo[:, None, :])
    if causal:
        same = same & torch.ones((n, n), dtype=torch.bool,
                                 device=ranges.device).tril(-1)[None]
    return same


def tiles_run(ranges: torch.Tensor, causal: bool = True) -> tuple[int, int]:
    """(tile pairs run, tile pairs skipped for disjoint segment ranges)
    per head over the batch, from a [B, n, 2] tile range table (the
    device's or ``segment_tile_ranges``): of the pairs causality allows
    (or all), those whose ranges meet run."""
    run = tile_pairs_run(ranges, causal)
    n = run.shape[1]
    allowed = ranges.shape[0] * (n * (n + 1) // 2 if causal else n * n)
    n_run = int(run.sum())
    return n_run, allowed - n_run


def dkv_splits(b: int, t: int, hq: int, hkv: int) -> int:
    """Over how many blocks the bf16 dk/dv kernel spreads a kv head's rep
    q heads: the least divisor of rep whose grid reaches
    ``DKV_MIN_BLOCKS`` blocks, else rep (one q head a block). A function
    of the shapes only, so the sum's order never changes from call to
    call."""
    rep = hq // hkv
    base = -(-t // TILE) * hkv * b
    for d in range(1, rep + 1):
        if rep % d == 0 and base * d >= DKV_MIN_BLOCKS:
            return d
    return rep


def dkv_partials_ref(q, k, v, seg, dout, n_split: int, causal: bool = True):
    """The plain model of the split backward's partials: f32 [2, n_split,
    B, T, Hkv, D], dk's then dv's, partial s summing over q heads
    ``hk * rep + s * rep / n_split + i`` of each kv head (autograd through
    ``flash_attention_train_ref`` on those heads alone)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    hpb = rep // n_split
    mask = (seg > 0).float()
    qg = q.reshape(b, t, hkv, rep, d)
    dg = dout.reshape(b, t, hkv, rep, d)
    parts = torch.zeros((2, n_split, b, t, hkv, d), dtype=torch.float32, device=q.device)
    for s in range(n_split):
        heads = slice(s * hpb, (s + 1) * hpb)
        qs = qg[:, :, :, heads].reshape(b, t, hkv * hpb, d).float()
        ks, vs = (x.detach().float().requires_grad_(True) for x in (k, v))
        out = flash_attention_train_ref(qs, ks, vs, mask, causal=causal, segment_ids=seg)
        gk, gv = torch.autograd.grad(
            out, (ks, vs), dg[:, :, :, heads].reshape(b, t, hkv * hpb, d).float())
        parts[0, s], parts[1, s] = gk, gv
    return parts


def dkv_sum_ref(parts: torch.Tensor):
    """(dk, dv) = the partials summed in split order, in f32, as
    ``flash_dkv_sum_kernel`` adds them before its one rounding to bf16."""
    acc = parts[:, 0].clone()
    for s in range(1, parts.shape[1]):
        acc += parts[:, s]
    return acc[0], acc[1]


def _check_cuda(q, k, v, seg) -> None:
    b, t, hq, d = q.shape
    if (q.dtype not in cuda_build.DTYPE_CODE or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"flash_attention_train: dtype {q.dtype} unsupported "
                         "by the CUDA kernel (float32 or bfloat16, all alike)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_train: head_dim {d} unsupported by "
                         f"the CUDA kernel ({HEAD_DIMS})")
    if (k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != d
            or hq % k.shape[2]):
        raise ValueError("flash_attention_train: k/v must be [B, T, Hkv, D] "
                         "with Hq a multiple of Hkv")
    if seg.shape != (b, t) or seg.dtype != torch.int32:
        raise ValueError("flash_attention_train: segment ids must be [B, T] "
                         "int32")
    for name, x in (("q", q), ("k", k), ("v", v), ("segment ids", seg)):
        if x.device != q.device:
            raise ValueError(f"flash_attention_train: {name} on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_train: {name} is not "
                             "contiguous")
        if x is not seg and x.data_ptr() % 16:
            raise ValueError(f"flash_attention_train: {name} is not "
                             "16-byte aligned (TMA copies need it)")


def segment_ranges_cuda(seg: torch.Tensor) -> torch.Tensor:
    """``segment_tile_ranges`` on the device by ``flash_seg_ranges_kernel``
    (the forward's library): [B, n, 2] int32."""
    b, t = seg.shape
    ranges = torch.empty((b, -(-t // TILE), 2), dtype=torch.int32, device=seg.device)
    cuda_build.launch("flash_attention_fwd", seg.data_ptr(), ranges.data_ptr(), b, t,
                      cuda_build.stream_of(seg.device),
                      entry="polyrl_flash_segment_ranges")
    return ranges


def tile_ranges(q: torch.Tensor, seg: torch.Tensor):
    """The tile ranges that ``flash_fwd_cuda`` and ``flash_bwd_cuda`` take
    for q's dtype: ``segment_ranges_cuda(seg)`` for the bf16 kernels, None
    for the f32 ones, which take none."""
    return segment_ranges_cuda(seg) if q.dtype == torch.bfloat16 else None


def _check_ranges(q, ranges) -> None:
    if (ranges is None) != (q.dtype != torch.bfloat16):
        raise ValueError("flash: the bf16 kernels take the tile ranges and the "
                         "f32 ones none (flash.tile_ranges(q, seg))")


def flash_fwd_cuda(q, k, v, seg, causal: bool, ranges):
    """Forward kernel: (o [B,T,Hq,D] in q.dtype, lse [B,Hq,T] f32).
    ``ranges``: ``tile_ranges(q, seg)``."""
    _check_ranges(q, ranges)
    b, t, hq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    cuda_build.launch(
        "flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr(), None if ranges is None else ranges.data_ptr(),
        o.data_ptr(), lse.data_ptr(), cuda_build.DTYPE_CODE[q.dtype], b, t, hq,
        k.shape[2], d, int(causal), float(d ** -0.5),
        cuda_build.stream_of(q.device), entry="polyrl_flash_attention_fwd")
    cuda_build.count_launch("flash_attention_fwd")
    return o, lse


def flash_bwd_cuda(q, k, v, seg, o, lse, dout, causal: bool, ranges):
    """Backward kernels (delta, dq, dk/dv and, when a kv head's bf16 q
    heads are split over blocks, the partials' sum): (dq, dk, dv) in
    q.dtype. ``ranges``: ``tile_ranges(q, seg)``, the forward's."""
    _check_ranges(q, ranges)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    code, scale = cuda_build.DTYPE_CODE[q.dtype], float(d ** -0.5)
    st = cuda_build.stream_of(q.device)
    lib = "flash_attention_bwd"
    rp = None if ranges is None else ranges.data_ptr()
    n_split = dkv_splits(b, t, hq, hkv) if q.dtype == torch.bfloat16 else 1
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    part = (torch.empty((2, n_split, b, t, hkv, d), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    cuda_build.launch(lib, o.data_ptr(), dout.data_ptr(), delta.data_ptr(), code,
                      b, t, hq, d, st, entry="polyrl_flash_attention_bwd_delta")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), rp)
    cuda_build.launch(lib, *ptrs, dq.data_ptr(), code, b, t, hq, hkv, d,
                      int(causal), scale, st, entry="polyrl_flash_attention_bwd_dq")
    cuda_build.launch(lib, *ptrs, dk.data_ptr(), dv.data_ptr(),
                      None if part is None else part.data_ptr(), code, b, t, hq,
                      hkv, d, int(causal), n_split, scale, st,
                      entry="polyrl_flash_attention_bwd_dkv")
    if part is not None:
        cuda_build.launch(lib, part.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t,
                          hkv, d, n_split, st,
                          entry="polyrl_flash_attention_bwd_dkv_sum")
    cuda_build.count_launch("flash_attention_bwd")
    return dq, dk, dv


class FlashAttentionTrain(torch.autograd.Function):
    """K4 with its backward: the forward saves q, k, v, o, the f32 LSE and
    the tile ranges."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal: bool):
        if not q.is_cuda:
            raise ValueError("FlashAttentionTrain launches the CUDA kernel; "
                             "CPU tensors take flash_attention_train_ref")
        _check_cuda(q, k, v, seg)
        # the tile ranges, made once for both directions
        ranges = tile_ranges(q, seg)
        o, lse = flash_fwd_cuda(q, k, v, seg, causal, ranges)
        ctx.save_for_backward(q, k, v, seg, o, lse, ranges)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, o, lse, ranges = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.dtype != q.dtype:
            dout = dout.to(q.dtype)
        if dout.data_ptr() % 16:  # a view into a larger gradient buffer
            dout = dout.clone()
        dq, dk, dv = flash_bwd_cuda(q, k, v, seg, o, lse, dout, ctx.causal, ranges)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, attn_mask, *, causal: bool = True,
                          segment_ids=None) -> torch.Tensor:
    """q [B,T,Hq,D], k/v [B,T,Hkv,D], attn_mask [B,T] (1 = valid) ->
    [B,T,Hq,D]. ``segment_ids`` [B,T] int32 overrides the mask-derived
    ids for packed rows. K4 on CUDA tensors (raises on what it cannot
    take), the plain version on CPU tensors."""
    if cuda_build.on_cpu(q):
        return flash_attention_train_ref(q, k, v, attn_mask, causal=causal,
                                         segment_ids=segment_ids)
    seg = _segments(attn_mask, segment_ids)
    return FlashAttentionTrain.apply(q, k, v, seg, bool(causal))


def auto_train_attention():
    """attn_fn for ``decoder.forward``'s no-cache path: K4 on the card,
    its plain version on the CPU. Signature: (q, k, v, attn_mask)."""
    return functools.partial(flash_attention_train, causal=True)
