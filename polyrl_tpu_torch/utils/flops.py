"""FLOPs accounting and MFU.

Counterpart of ``polyrl_tpu/utils/flops.py``. Per-token transformer FLOPs:
about 6·P for the dense path (forward 2·P, backward 4·P) plus the
attention term 12·L·H·D·s per token at context length s (forward and
backward; a third of both for inference only). The peak is one NVIDIA
H100's dense bf16 tensor-core rate, 989 TFLOP/s (NVIDIA's data sheet, SXM
part, at its 700 W limit); ``POLYRL_PEAK_TFLOPS`` or the ``peak_tflops``
argument overrides it for another part or a lower power limit.
"""

from __future__ import annotations

import os
from typing import Any

DEFAULT_PEAK_TFLOPS = 989.0  # H100 SXM, dense bf16


def param_count(cfg: Any) -> int:
    """Decoder parameter count (embed + L·(attn + mlp + norms) + final norm
    + head); MoE configs count router + ALL experts."""
    d, L = cfg.hidden_size, cfg.num_layers
    hd = cfg.head_dim_
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    if getattr(cfg, "num_experts", 0):
        mlp = (d * cfg.num_experts
               + cfg.num_experts * 3 * d * cfg.moe_intermediate_size)
    else:
        mlp = 3 * d * cfg.intermediate_size
    norms = 2 * d
    embed = cfg.vocab_size * d
    head = 0 if cfg.tie_word_embeddings else cfg.vocab_size * d
    return embed + L * (q + kv + o + mlp + norms) + d + head


def _active_matmul_params(cfg: Any) -> int:
    """Matmul params a token touches (MoE: only the top-k routed experts)."""
    d, L = cfg.hidden_size, cfg.num_layers
    hd = cfg.head_dim_
    attn = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * d)
    if getattr(cfg, "num_experts", 0):
        mlp = (d * cfg.num_experts
               + cfg.num_experts_per_tok * 3 * d * cfg.moe_intermediate_size)
    else:
        mlp = 3 * d * cfg.intermediate_size
    head = 0 if cfg.tie_word_embeddings else cfg.vocab_size * d
    return L * (attn + mlp) + head


def flops_per_token(cfg: Any, context_len: float, *, training: bool = True,
                    include_embed: bool = False) -> float:
    p = _active_matmul_params(cfg)
    if include_embed:
        p += cfg.vocab_size * cfg.hidden_size
        if cfg.tie_word_embeddings:
            p += cfg.vocab_size * cfg.hidden_size
    elif cfg.tie_word_embeddings:
        p += cfg.vocab_size * cfg.hidden_size  # the tied head matmul runs
    dense = 2.0 * p
    attn = 4.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim_ * context_len
    fwd = dense + attn
    return 3.0 * fwd if training else fwd


class FlopsCounter:
    """Achieved TFLOP/s and MFU from token counts and wall time."""

    def __init__(self, model_cfg: Any, peak_tflops: float | None = None,
                 n_chips: int = 1):
        self.cfg = model_cfg
        env = os.environ.get("POLYRL_PEAK_TFLOPS", "")
        self.peak_tflops = (peak_tflops if peak_tflops is not None
                            else float(env) if env else DEFAULT_PEAK_TFLOPS)
        self.n_chips = max(n_chips, 1)
        self.params = param_count(model_cfg)

    def estimate_flops(self, n_tokens: int, mean_context_len: float,
                       *, training: bool = True) -> float:
        return n_tokens * flops_per_token(self.cfg, mean_context_len,
                                          training=training)

    def step_metrics(self, n_tokens: int, mean_context_len: float,
                     step_time_s: float, *, training: bool = True,
                     prefix: str = "perf") -> dict:
        if step_time_s <= 0 or n_tokens <= 0:
            return {}
        flops = self.estimate_flops(n_tokens, mean_context_len,
                                    training=training)
        achieved_tflops = flops / step_time_s / 1e12
        per_chip = achieved_tflops / self.n_chips
        return {
            f"{prefix}/tflops_all_chips": achieved_tflops,
            f"{prefix}/tflops_per_chip": per_chip,
            f"{prefix}/mfu": per_chip / self.peak_tflops,
        }
