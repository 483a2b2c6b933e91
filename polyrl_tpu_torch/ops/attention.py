"""Dense GQA attention used by the prefill path.

Counterpart of ``polyrl_tpu/ops/attention.py``. The JAX package computes
this in XLA, outside any Pallas kernel, so plain tensor code is the port:
f32 logits, a finite ``finfo(f32).min`` mask fill, and probabilities cast
to ``v.dtype`` before the value product. Shapes stay [B, T, H, D].
"""

from __future__ import annotations

import torch

_F32_MIN = torch.finfo(torch.float32).min


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """[q_len, kv_len] bool mask; True = attend. Query i sits at absolute
    position ``q_offset + i``."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def attention(q: torch.Tensor,      # [B, Tq, Hq, D]
              k: torch.Tensor,      # [B, Tk, Hkv, D]
              v: torch.Tensor,      # [B, Tk, Hkv, D]
              mask: torch.Tensor | None = None,  # -> [B, Hq|1, Tq, Tk]
              scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA by head grouping.

    The q·kᵀ product runs on f32 copies of q and k: bf16 values are exact
    in f32, so this is the f32-accumulated product the JAX einsum asks for
    with ``preferred_element_type=f32``."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, tq, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if mask is not None:
        m = mask[:, :, None] if mask.dim() == 4 else mask
        logits = logits.masked_fill(~m, _F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, tq, hq, d)
