"""Functional transformer decoder (Llama-3 / Qwen-3 families) in PyTorch.

Counterpart of ``polyrl_tpu/models/decoder.py``. Parameters are a plain
dict of tensors with the reference's names and stacked ``[L, ...]`` layer
leaves (``embed``, ``final_norm``, ``layers.{attn_norm, mlp_norm, wq, wk,
wv, wo, w_gate, w_up, w_down, q_norm, k_norm, bq, bk, bv}``, ``lm_head``),
so converting a JAX tree is a copy (``models/convert.py``).

bf16 cast points follow the reference: RMSNorm, RoPE and the MLP's SiLU
run in f32 and cast back; attention softmax runs in f32; the logits head
is an f32-output product (``unembed``).

Where the JAX code donates buffers, the port updates in place: the KV
cache of ``forward`` and the paged pools are written in place and
returned for symmetry. The no-cache ``forward`` (training and logprob
scoring) is differentiable, with per-layer rematerialisation
(``torch.utils.checkpoint``) in place of ``jax.checkpoint``; the cached
and paged serving paths run under ``torch.no_grad``.

Every projection goes through ``quant.mm`` and the logits head through
``unembed``, so a layer leaf may be a ``QuantWeight`` (int8 serving) or a
``LoraWeight`` (LoRA training; QLoRA over an int8 base), as in the
reference; ``layer_params`` slices wrappers like tensors. MoE is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from polyrl_tpu_torch.models.quant import mm, unembed_operands
from polyrl_tpu_torch.ops import flash
from polyrl_tpu_torch.ops.attention import attention
from polyrl_tpu_torch.ops.norm_rope import apply_rope, rms_norm
from polyrl_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_kv_write_fused)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """llama3-style NTK-by-parts frequency scaling."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int | None = None  # default hidden/heads
    rope_theta: float = 500000.0
    rope_scaling: RopeScaling | None = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    use_qk_norm: bool = False  # Qwen3
    attention_bias: bool = False  # Qwen2/2.5 family (qkv projection bias)
    max_position_embeddings: int = 131072
    num_experts: int = 0  # MoE presets are listed but not served yet
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


# -- presets (copied from polyrl_tpu/models/decoder.py) ----------------------

PRESETS: dict[str, ModelConfig] = {
    "tiny": ModelConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, rope_theta=10000.0,
        max_position_embeddings=512,
    ),
    "llama3-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        rope_scaling=RopeScaling(factor=8.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_position_embeddings=8192),
    ),
    "llama3.2-1b": ModelConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling=RopeScaling(factor=32.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_position_embeddings=8192),
    ),
    "llama3.2-3b": ModelConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling=RopeScaling(factor=32.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_position_embeddings=8192),
    ),
    "qwen3-1.7b": ModelConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=6144,
        num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, use_qk_norm=True, tie_word_embeddings=True,
    ),
    "qwen3-8b": ModelConfig(
        vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, use_qk_norm=True,
    ),
    "qwen2.5-0.5b": ModelConfig(
        vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_layers=24, num_heads=14, num_kv_heads=2, rope_theta=1000000.0,
        attention_bias=True, tie_word_embeddings=True,
        max_position_embeddings=32768,
    ),
    "qwen2.5-7b": ModelConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1000000.0,
        attention_bias=True, max_position_embeddings=131072,
    ),
    "qwen2.5-32b": ModelConfig(
        vocab_size=152064, hidden_size=5120, intermediate_size=27648,
        num_layers=64, num_heads=40, num_kv_heads=8, rope_theta=1000000.0,
        attention_bias=True, max_position_embeddings=131072,
    ),
    "llama3-70b": ModelConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, rope_theta=500000.0,
        rope_scaling=RopeScaling(factor=8.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0,
                                 original_max_position_embeddings=8192),
    ),
    "moe-tiny": ModelConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, rope_theta=10000.0,
        max_position_embeddings=512, use_qk_norm=True,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
    ),
    "qwen3-30b-a3b": ModelConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=6144,
        num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, use_qk_norm=True,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    ),
    "mixtral-8x7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1000000.0,
        rms_norm_eps=1e-5, max_position_embeddings=32768,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
    ),
}
PRESETS["deepseek-r1-distill-qwen-7b"] = dataclasses.replace(
    PRESETS["qwen2.5-7b"], rope_theta=10000.0)
PRESETS["deepseek-r1-distill-qwen-32b"] = PRESETS["qwen2.5-32b"]
PRESETS["deepseek-r1-distill-llama-8b"] = PRESETS["llama3-8b"]


def get_config(name: str, **overrides) -> ModelConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE models are not ported yet (dense SwiGLU only)")


# -- init -------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's structure: ``(shape, init)`` per leaf, init
    one of ``normal`` (Normal(0.02)), ``ones``, ``zeros``, in the order
    ``init_params`` draws them."""
    _check_dense(cfg)
    hd = cfg.head_dim_
    d, f, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    layers = {
        "attn_norm": ((n_l, d), "ones"),
        "mlp_norm": ((n_l, d), "ones"),
        "wq": ((n_l, d, hq * hd), "normal"),
        "wk": ((n_l, d, hkv * hd), "normal"),
        "wv": ((n_l, d, hkv * hd), "normal"),
        "wo": ((n_l, hq * hd, d), "normal"),
        "w_gate": ((n_l, d, f), "normal"),
        "w_up": ((n_l, d, f), "normal"),
        "w_down": ((n_l, f, d), "normal"),
    }
    if cfg.use_qk_norm:
        layers["q_norm"] = ((n_l, hd), "ones")
        layers["k_norm"] = ((n_l, hd), "ones")
    if cfg.attention_bias:
        layers["bq"] = ((n_l, hq * hd), "zeros")
        layers["bk"] = ((n_l, hkv * hd), "zeros")
        layers["bv"] = ((n_l, hkv * hd), "zeros")
    specs = {"embed": ((cfg.vocab_size, d), "normal"),
             "final_norm": ((d,), "ones"), "layers": layers}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = ((d, cfg.vocab_size), "normal")
    return specs


def init_params(generator: torch.Generator, cfg: ModelConfig,
                leaf_fn=None) -> dict:
    """Stacked-layer params, Normal(0.02) like the HF default, created on
    ``generator``'s device. A ``torch.Generator`` draws other numbers than
    ``jax.random`` from the same seed: tests convert a JAX tree instead
    (``models/convert.py``). ``leaf_fn(name, tensor)``, when given, maps
    each leaf as it is made (``quant.init_quantized_params``), so the
    unmapped tree never exists whole."""
    dev = generator.device

    def make(name, shape, init):
        if init == "normal":
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            w = (w * 0.02).to(cfg.dtype)
        else:
            w = (torch.ones if init == "ones" else torch.zeros)(
                shape, device=dev, dtype=cfg.dtype)
        return leaf_fn(name, w) if leaf_fn is not None else w

    def build(specs, prefix=""):
        return {k: (build(v, f"{prefix}{k}.") if isinstance(v, dict)
                    else make(prefix + k, *v)) for k, v in specs.items()}

    return build(param_specs(cfg))


def init_meta_params(cfg: ModelConfig) -> dict:
    """The parameter tree's names, shapes and dtypes as ``meta`` tensors
    (no memory): the template of a tree that arrives from elsewhere."""

    def build(specs):
        return {k: (build(v) if isinstance(v, dict) else
                    torch.empty(v[0], dtype=cfg.dtype, device="meta"))
                for k, v in specs.items()}

    return build(param_specs(cfg))


def layer_params(params: dict, layer: int) -> dict:
    """Views of one layer's slices of the stacked ``[L, ...]`` leaves (a
    wrapper slices each of its tensors)."""
    return {k: v[layer] for k, v in params["layers"].items()}


# -- building blocks --------------------------------------------------------


def _rope_freqs(cfg: ModelConfig) -> np.ndarray:
    hd = cfg.head_dim_
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    if cfg.rope_scaling:
        # llama3 NTK-by-parts frequency scaling (HF rope_scaling type="llama3")
        s = cfg.rope_scaling
        factor = s.factor
        low, high = s.low_freq_factor, s.high_freq_factor
        old_len = s.original_max_position_embeddings
        wavelen = 2 * np.pi / freqs
        ratio = old_len / wavelen
        smooth = np.clip((ratio - low) / (high - low), 0.0, 1.0)
        scaled = np.where(
            wavelen > old_len / low,  # low-frequency: fully scale
            freqs / factor,
            np.where(
                wavelen < old_len / high,  # high-frequency: keep
                freqs,
                (1 - smooth) * freqs / factor + smooth * freqs,
            ),
        )
        freqs = scaled
    return freqs.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """``_rope_freqs`` uploaded once per (config, device): a host-to-device
    copy from pageable memory waits for the stream, so re-uploading it each
    decode step would stall the host behind the device every step (the JAX
    version folds it into the compiled step as a constant)."""
    return torch.from_numpy(_rope_freqs(cfg)).to(device)


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> (cos, sin) [B, T, hd/2] in f32."""
    freqs = _rope_freqs_on(cfg, positions.device)
    angles = positions.float()[..., None] * freqs[None, None, :]
    return torch.cos(angles), torch.sin(angles)


def _mlp(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """Dense SwiGLU; SiLU in f32, cast back before the gate product."""
    gate = torch.nn.functional.silu(mm(h, lp["w_gate"]).float()).to(h.dtype)
    return mm(gate * mm(h, lp["w_up"]), lp["w_down"])


class _UnembedF32(torch.autograd.Function):
    """bf16/f16 operands, f32 accumulation and an f32 output on the card
    (``torch.mm(..., out_dtype=torch.float32)``), with its gradient written
    out: the f32 cotangent is rounded to the operands' type and each
    gradient product accumulates in f32, as a bf16 mixed-precision matmul's
    backward does. An int8 head (``scale`` given) is cast to the
    activations' type inside each product and its scale applied to the f32
    logits (and to the cotangent); it gets no gradient."""

    @staticmethod
    def forward(ctx, x2, head, scale):
        ctx.save_for_backward(x2, head, scale)
        if scale is None:
            return torch.mm(x2, head, out_dtype=torch.float32)
        return torch.mm(x2, head.to(x2.dtype), out_dtype=torch.float32).mul_(scale)

    @staticmethod
    def backward(ctx, g):
        x2, head, scale = ctx.saved_tensors
        if scale is not None:
            g, head = g * scale, head.to(x2.dtype)
        g = g.to(head.dtype)
        dx = dh = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, head.t(), out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dh = torch.mm(x2.t(), g, out_dtype=torch.float32).to(head.dtype)
        return dx, dh, None


def unembed(x: torch.Tensor, head) -> torch.Tensor:
    """Logits head ``x @ head`` with an f32 result ([..., d] -> [..., V]).

    On the card a bf16/f16 head goes through ``torch.mm(..., out_dtype=
    torch.float32)``: bf16 operands, f32 accumulation and an f32 output,
    which is the JAX ``preferred_element_type=f32`` product, without ever
    holding an f32 copy of the head (311M entries for qwen3's tied
    embedding would be 1.2 GB). An int8 head (a ``QuantWeight``: an untied
    ``lm_head``) takes the same product with ``q`` cast to the bf16/f16
    activations' type, and its per-vocabulary scale multiplies the f32
    logits, as the reference's ``quant.unembed`` does. Elsewhere (the CPU
    tests, f32 weights) the operands are upcast, which changes nothing for
    f32. All are differentiable in ``x`` (and in a plain head)."""
    head, scale = unembed_operands(head)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    half = (torch.bfloat16, torch.float16)
    if x2.is_cuda and (head.dtype in half if scale is None else x2.dtype in half):
        out = _UnembedF32.apply(x2, head, scale)
    else:
        out = x2.float() @ head.float()
        if scale is not None:
            out = out * scale
    return out.reshape(*shape[:-1], head.shape[-1])


def head_weight(params: dict, cfg: ModelConfig):
    """The [d, V] logits head: the tied embedding's transpose or lm_head
    (a tensor, or a ``QuantWeight`` for an int8 untied head)."""
    return params["embed"].t() if cfg.tie_word_embeddings else params["lm_head"]


def _qkv_proj(cfg: ModelConfig, x: torch.Tensor, lp: dict):
    """Projection half of ``_qkv``: norm, projections (+bias), split into
    heads. x [B, T, d] -> q [B, T, Hq, D], k/v [B, T, Hkv, D]."""
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = mm(h, lp["wq"]), mm(h, lp["wk"]), mm(h, lp["wv"])
    if cfg.attention_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (q.reshape(b, t, hq, hd), k.reshape(b, t, hkv, hd),
            v.reshape(b, t, hkv, hd))


def _qk_norm_rope(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  lp: dict, cos, sin):
    """Elementwise half of ``_qkv``: qk-norm (Qwen3), then RoPE."""
    if cfg.use_qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _qkv(cfg: ModelConfig, x: torch.Tensor, lp: dict, cos, sin):
    """Pre-attention half of a layer: norm, projections (+bias), qk-norm,
    RoPE. x [B, T, d] -> q [B, T, Hq, D], k/v [B, T, Hkv, D]."""
    q, k, v = _qkv_proj(cfg, x, lp)
    q, k = _qk_norm_rope(cfg, q, k, lp, cos, sin)
    return q, k, v


def _post_attn(cfg: ModelConfig, x: torch.Tensor, attn_out: torch.Tensor,
               lp: dict) -> torch.Tensor:
    """Output projection, residual, post-norm MLP, residual."""
    lead = attn_out.shape[:-2]
    x = x + mm(attn_out.reshape(*lead, -1), lp["wo"])
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(h, lp)


# -- forward ----------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed KV cache: (k, v) each [L, B, S, Hkv, D]."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def forward_hidden(params: dict, cfg: ModelConfig,
                   input_ids: torch.Tensor,   # [B, T]
                   positions: torch.Tensor,   # [B, T] absolute positions
                   attn_mask: torch.Tensor,   # [B, T] 1 = valid
                   remat: bool = False,
                   attn_fn=None) -> torch.Tensor:
    """Full-sequence forward up to the final RMSNorm: [B, T, d] hidden
    states, differentiable. ``attn_fn(q, k, v, attn_mask)`` is the layer
    attention, by default ``flash.auto_train_attention()`` (K4 on the
    card, its plain version on the CPU), as the JAX actor passes it.
    ``remat`` recomputes each layer in the backward
    (``checkpoint(..., use_reentrant=False)``, the JAX ``jax.checkpoint``
    of the scan body); it applies only while autograd records."""
    _check_dense(cfg)
    attn_fn = attn_fn or flash.auto_train_attention()
    x = params["embed"][input_ids]
    cos, sin = rope_cos_sin(cfg, positions)

    def layer(x, lp):
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        return _post_attn(cfg, x, attn_fn(q, k, v, attn_mask), lp)

    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = layer(x, lp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def forward(params: dict, cfg: ModelConfig,
            input_ids: torch.Tensor,   # [B, T]
            positions: torch.Tensor,   # [B, T] absolute positions
            attn_mask: torch.Tensor,   # [B, Tk] 1 = valid (Tk = T, or cache len)
            cache: tuple | None = None,  # (k, v) each [L, B, S, Hkv, D]
            write_idx: int = 0,
            logits_for: torch.Tensor | None = None,  # [B] — unembed only this position
            remat: bool = False,
            attn_fn=None,
            ) -> tuple[torch.Tensor, tuple | None]:
    """Returns (logits [B, T, V] f32 — or [B, V] with ``logits_for`` — and
    the cache or None).

    Without cache: full-sequence causal forward through ``attn_fn(q, k, v,
    attn_mask)`` (default K4 / its plain version, ``forward_hidden``),
    differentiable, with optional per-layer ``remat``. With cache (the
    prefill path, no grad): the chunk's KV is written IN PLACE at
    ``write_idx`` (the JAX version returns a new buffer) and dense
    attention runs over the whole cache buffer under ``attn_mask`` [B, S],
    which must mark the chunk's slots valid too."""
    _check_dense(cfg)
    b, t = input_ids.shape
    dev = input_ids.device
    if cache is None:
        x = forward_hidden(params, cfg, input_ids, positions, attn_mask,
                           remat=remat, attn_fn=attn_fn)
        if logits_for is not None:
            x = x[torch.arange(b, device=dev), logits_for.long()]
        return unembed(x, head_weight(params, cfg)), None

    with torch.no_grad():
        x = params["embed"][input_ids]
        cos, sin = rope_cos_sin(cfg, positions)
        valid = attn_mask > 0
        s = cache[0].shape[2]
        kv_pos = torch.arange(s, device=dev)[None, None, None, :]
        slot_written = kv_pos <= (write_idx + t - 1)
        causal = kv_pos <= (write_idx + torch.arange(t, device=dev)[None, None, :, None])
        mask = causal & slot_written & valid[:, None, None, :]
        for layer in range(cfg.num_layers):
            lp = layer_params(params, layer)
            q, k, v = _qkv(cfg, x, lp, cos, sin)
            kc, vc = cache[0][layer], cache[1][layer]
            kc[:, write_idx:write_idx + t] = k.to(kc.dtype)
            vc[:, write_idx:write_idx + t] = v.to(vc.dtype)
            x = _post_attn(cfg, x, attention(q, kc, vc, mask=mask), lp)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        if logits_for is not None:
            x = x[torch.arange(b, device=dev), logits_for.long()]
        return unembed(x, head_weight(params, cfg)), cache


# -- paged KV (continuous batching) -----------------------------------------


def make_paged_pools(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, device=None) -> tuple[list, list]:
    """Paged KV pool: (k, v), each a per-layer list of
    [Hkv, num_pages, page_size, D] tensors (head-major, the layout the
    decode kernels stream). Page 0 is the null page: inactive slots and
    padding write there and nothing ever attends it."""
    dtype = dtype or cfg.dtype
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim_)
    return ([torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(cfg.num_layers)],
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(cfg.num_layers)])


def _scatter_pages_kv(pool: torch.Tensor, page_ids: torch.Tensor,
                      upd: torch.Tensor) -> None:
    """Write whole pages into ``pool`` [Hkv, N, ps, D] in place; ``upd`` is
    [Hkv, n_pg, ps, D]. Repeated ids only ever name the null page 0
    (padding), whose content is never read."""
    pool.index_copy_(1, page_ids.long(), upd.to(pool.dtype))


def _to_pages(kv: torch.Tensor, n_pages: int, page_size: int) -> torch.Tensor:
    """[B, n_pages*ps, Hkv, D] chunk KV -> [Hkv, B*n_pages, ps, D]."""
    b, _t, hkv, hd = kv.shape
    return (kv.reshape(b * n_pages, page_size, hkv, hd)
            .permute(2, 0, 1, 3))


def _scatter_chunk(pools, k_new, v_new, page_ids: torch.Tensor,
                   page_size: int) -> None:
    """Scatter a prefill chunk's per-layer KV [L, B, pb, Hkv, D] into the
    pools at ``page_ids`` [B, pb // ps]."""
    flat = page_ids.reshape(-1)
    n_pg = page_ids.shape[1]
    for layer in range(len(pools[0])):
        _scatter_pages_kv(pools[0][layer], flat,
                          _to_pages(k_new[layer], n_pg, page_size))
        _scatter_pages_kv(pools[1][layer], flat,
                          _to_pages(v_new[layer], n_pg, page_size))


@torch.no_grad()
def prefill_batch_into_pages(params: dict, cfg: ModelConfig,
                             ids: torch.Tensor,          # [B, pb] right-padded
                             prompt_lens: torch.Tensor,  # [B]
                             pools: tuple,
                             page_ids: torch.Tensor,     # [B, pb // ps]
                             ) -> tuple[tuple, torch.Tensor]:
    """B prompts in one forward; their KV is scattered into the pools in
    place. Returns (pools, last-token logits [B, V] f32)."""
    page_size = pools[0][0].shape[2]
    b, pb = ids.shape
    dev = ids.device
    mask = (torch.arange(pb, device=dev)[None, :] < prompt_lens[:, None]).float()
    positions = torch.arange(pb, device=dev, dtype=torch.int32).expand(b, pb)
    cache = make_cache(cfg, b, pb, dtype=pools[0][0].dtype, device=dev)
    last_logits, (k_new, v_new) = forward(
        params, cfg, ids, positions, mask, cache=cache, write_idx=0,
        logits_for=(prompt_lens - 1).clamp(min=0))
    _scatter_chunk(pools, k_new, v_new, page_ids, page_size)
    return pools, last_logits


@torch.no_grad()
def prefill_suffix_batch_into_pages(params: dict, cfg: ModelConfig,
                                    ids: torch.Tensor,          # [B, pb] suffix tokens
                                    suffix_lens: torch.Tensor,  # [B]
                                    prefix_len: int,            # uniform cached tokens
                                    pools: tuple,
                                    prefix_page_ids: torch.Tensor,  # [B, n_pre]
                                    page_ids: torch.Tensor,     # [B, pb // ps]
                                    ) -> tuple[tuple, torch.Tensor]:
    """Prefix-cache prefill: compute KV only for each row's suffix while
    attending over its cached prefix pages (``prefix_len`` tokens, the
    same for every row, whole pages). Returns (pools, last logits [B, V])."""
    page_size = pools[0][0].shape[2]
    b, pb = ids.shape
    dev = ids.device
    n_pre = prefix_page_ids.shape[1]
    prefix_cap = n_pre * page_size
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    s_total = prefix_cap + pb
    cache = make_cache(cfg, b, s_total, dtype=pools[0][0].dtype, device=dev)
    pre = prefix_page_ids.long()
    for layer in range(cfg.num_layers):
        for side in (0, 1):
            # [Hkv, B, n_pre, ps, D] -> [B, prefix_cap, Hkv, D]
            g = pools[side][layer][:, pre]
            cache[side][layer, :, :prefix_cap] = (
                g.permute(1, 2, 3, 0, 4).reshape(b, prefix_cap, hkv, hd))
    positions = (prefix_len + torch.arange(pb, device=dev, dtype=torch.int32)
                 ).expand(b, pb)
    slot = torch.arange(s_total, device=dev)[None, :]
    valid = (slot < prefix_len) | ((slot >= prefix_len)
                                   & (slot < prefix_len + suffix_lens[:, None]))
    last_logits, (k_all, v_all) = forward(
        params, cfg, ids, positions, valid.float(), cache=cache,
        write_idx=prefix_len, logits_for=(suffix_lens - 1).clamp(min=0))
    k_sfx = k_all[:, :, prefix_len:prefix_len + pb]
    v_sfx = v_all[:, :, prefix_len:prefix_len + pb]
    _scatter_chunk(pools, k_sfx, v_sfx, page_ids, page_size)
    return pools, last_logits


@torch.no_grad()
def forward_paged_decode(params: dict, cfg: ModelConfig,
                         tokens: torch.Tensor,      # [S] one new token per slot
                         positions: torch.Tensor,   # [S] its absolute position
                         pools: tuple,              # (k, v) per-layer lists
                         page_table: torch.Tensor,  # [S, P] int32
                         seq_lens: torch.Tensor,    # [S] tokens already cached
                         attn_fn=None,
                         active: torch.Tensor | None = None,  # [S] bool
                         kv_write_fn=None,
                         ) -> tuple[torch.Tensor, tuple]:
    """One decode step for every slot: write the new token's KV into each
    slot's current page (inactive slots to the null page 0), then
    paged-attend over [0, seq_len]. Returns (logits [S, V] f32, pools).

    ``attn_fn(q, k_pool, v_pool, page_table, lens)`` is the seam the
    engine uses to route through the grouped kernel; it defaults to
    ``ops.paged_attention.paged_attention``. Without ``kv_write_fn`` each
    layer's qk-norm, RoPE and K/V write are one call of
    ``ops.paged_attention.paged_kv_write_fused`` (one kernel on the card);
    an explicit ``kv_write_fn(k_pool, v_pool, page, off, k, v)`` (the JAX
    step's seam, e.g. ``paged_kv_write``) takes the unfused route: the
    eager qk-norm and RoPE, then that write. On the CPU both routes run
    the same plain chain. Pools are updated in place."""
    _check_dense(cfg)
    attn_fn = attn_fn or paged_attention
    s = tokens.shape[0]
    page_size = pools[0][0].shape[2]
    n_cols = page_table.shape[1]

    x = params["embed"][tokens][:, None]  # [S, 1, d]
    cos, sin = rope_cos_sin(cfg, positions[:, None])
    # JAX gathers clamp out-of-range indices; torch indexing would fault
    col = (seq_lens // page_size).clamp(max=n_cols - 1).long()
    write_page = page_table[torch.arange(s, device=tokens.device), col]
    write_off = seq_lens % page_size
    if active is not None:
        write_page = torch.where(active, write_page, 0)
        write_off = torch.where(active, write_off, 0)
    write_page = write_page.to(torch.int32)
    write_off = write_off.to(torch.int32)
    attn_lens = (seq_lens + 1).to(torch.int32)

    k_pools, v_pools = pools
    for layer in range(cfg.num_layers):
        lp = layer_params(params, layer)
        q, k, v = _qkv_proj(cfg, x, lp)
        if kv_write_fn is None:
            q = paged_kv_write_fused(
                k_pools[layer], v_pools[layer], write_page, write_off,
                q[:, 0], k[:, 0], v[:, 0], cos[:, 0], sin[:, 0],
                lp["q_norm"] if cfg.use_qk_norm else None,
                lp["k_norm"] if cfg.use_qk_norm else None, cfg.rms_norm_eps)
        else:
            q, k = _qk_norm_rope(cfg, q, k, lp, cos, sin)
            kv_write_fn(k_pools[layer], v_pools[layer], write_page, write_off,
                        k[:, 0], v[:, 0])
            q = q[:, 0]
        attn_out = attn_fn(q, k_pools[layer], v_pools[layer],
                           page_table, attn_lens)  # [S, Hq, D]
        x = _post_attn(cfg, x, attn_out[:, None], lp)
    x = rms_norm(x[:, 0], params["final_norm"], cfg.rms_norm_eps)
    return unembed(x, head_weight(params, cfg)), pools
