"""RMSNorm and rotary embedding, the elementwise halves of a layer.

Counterparts of ``rms_norm`` and ``apply_rope`` in
``polyrl_tpu/models/decoder.py``, with the same bf16 cast points: both run
in f32 and round back to the input's type once. They live under ``ops/``
because the fused decode prologue (``ops/paged_attention.py``) holds its
kernel against them, and ``models/decoder.py`` imports that module.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, D]; rotate-half convention (HF Llama/Qwen), in f32."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
