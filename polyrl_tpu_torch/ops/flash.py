"""Flash attention for the TRAINING path (forward and backward, O(T) memory).

Counterpart of ``polyrl_tpu/ops/flash.py``. The JAX package trains with
JAX's bundled TPU flash kernel behind a wrapper; here the kernel is K4,
written by hand for Hopper (``csrc/flash_attention_{fwd,bwd}.cu``). Each of
its libraries holds one instance per dtype, chosen by the ``dtype``
argument of the same C entry points: bf16, the training path, runs its
products on the tensor cores (``mma.sync`` on bf16 tiles staged by
``cp.async``, probabilities kept in registers, ``csrc/flash_mma.cuh``);
f32, used by gradient checks on an f32 copy of the weights, keeps exact f32
products on CUDA cores (``csrc/flash_f32.cuh``), since the tensor cores
have no f32 mode without TF32 and the port keeps TF32 off. Neither is a
fallback of the other: a launch that fails raises.

- ``flash_attention_train_ref``: the plain PyTorch version, the TPU
  kernel's semantics with f32 logits and softmax. The CPU path, and the
  yardstick the CUDA kernels are held to on the card.
- ``FlashAttentionTrain``: the ``torch.autograd.Function`` whose forward
  launches the forward kernel and saves q, k, v, o and the f32 LSE
  ``[B, Hq, T]``, and whose backward launches the backward kernels
  (delta, dq, dk/dv). It survives ``torch.utils.checkpoint`` recompute.
- ``flash_attention_train`` / ``auto_train_attention``: the JAX signatures.
  CPU tensors go to the plain version; CUDA tensors go to the kernel, or
  the wrapper raises (unsupported head dim or dtype, non-contiguous or
  not 16-byte aligned input: the bf16 kernels copy rows 16 bytes at a
  time). There is no fallback, and unlike the TPU wrapper a T that does
  not tile is no reason to leave the kernel: it masks its ragged last
  tile itself.

Semantics (the TPU kernel's): ``mask = causal & (seg_q == seg_k)`` with
``seg = attn_mask.to(int32)`` (pad 0, real 1) or the caller's
``segment_ids`` for packed rows. Pad rows attend pad keys, so no row is
fully masked; masked logits take the finite ``MASK_VALUE``. GQA reads kv
head ``h // rep`` in place; its gradient is the sum over the ``rep``
query heads (the VJP of the JAX wrapper's ``jnp.repeat``). ``sm_scale =
D ** -0.5``. Launches are counted per direction in ``cuda_build.LAUNCHES``
by the launchers ``flash_fwd_cuda`` and ``flash_bwd_cuda``, where they
launch: ``flash_attention_fwd`` once per forward, ``flash_attention_bwd``
once per backward (its three kernels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops.attention import causal_mask

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (64, 128)


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
                             "16-byte aligned")


def flash_fwd_cuda(q, k, v, seg, causal: bool):
    """Forward kernel: (o [B,T,Hq,D] in q.dtype, lse [B,Hq,T] f32)."""
    b, t, hq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    cuda_build.launch(
        "flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        cuda_build.DTYPE_CODE[q.dtype], b, t, hq, k.shape[2], d, int(causal),
        float(d ** -0.5), cuda_build.stream_of(q.device))
    cuda_build.count_launch("flash_attention_fwd")
    return o, lse


def flash_bwd_cuda(q, k, v, seg, o, lse, dout, causal: bool):
    """Backward kernels (delta, dq, dk/dv): (dq, dk, dv) in q.dtype."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    code, scale = cuda_build.DTYPE_CODE[q.dtype], float(d ** -0.5)
    st = cuda_build.stream_of(q.device)
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    cuda_build.launch("flash_attention_bwd", o.data_ptr(), dout.data_ptr(),
                      delta.data_ptr(), code, b, t, hq, d, st,
                      entry="polyrl_flash_attention_bwd_delta")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    cuda_build.launch("flash_attention_bwd", *ptrs, dq.data_ptr(), code, b, t,
                      hq, hkv, d, int(causal), scale, st,
                      entry="polyrl_flash_attention_bwd_dq")
    cuda_build.launch("flash_attention_bwd", *ptrs, dk.data_ptr(),
                      dv.data_ptr(), code, b, t, hq, hkv, d, int(causal),
                      scale, st, entry="polyrl_flash_attention_bwd_dkv")
    cuda_build.count_launch("flash_attention_bwd")
    return dq, dk, dv


class FlashAttentionTrain(torch.autograd.Function):
    """K4 with its backward: the forward saves q, k, v, o and the f32 LSE."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal: bool):
        if not q.is_cuda:
            raise ValueError("FlashAttentionTrain launches the CUDA kernel; "
                             "CPU tensors take flash_attention_train_ref")
        _check_cuda(q, k, v, seg)
        o, lse = flash_fwd_cuda(q, k, v, seg, causal)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.dtype != q.dtype:
            dout = dout.to(q.dtype)
        if dout.data_ptr() % 16:  # a view into a larger gradient buffer
            dout = dout.clone()
        dq, dk, dv = flash_bwd_cuda(q, k, v, seg, o, lse, dout, ctx.causal)
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
