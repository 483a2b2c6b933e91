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
reference; ``layer_params`` slices wrappers like tensors.

MoE models (``num_experts > 0``: Qwen3-MoE, Mixtral) replace every
layer's dense MLP with the reference's routed mixture (``_moe_mlp``):
``router [L, d, E]`` and stacked experts ``we_gate``/``we_up [L, E, d,
f]``, ``we_down [L, E, f, d]`` in place of ``w_gate``/``w_up``/
``w_down``; softmax over all experts, top-k, GShard fixed-capacity
dispatch over token groups. Every path passes the tokens' validity to it
(padding, inactive decode slots and speculation's rejected rows take no
expert capacity), and it reads nothing on the host, so that the engine's
decode graphs capture it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from polyrl_tpu_torch.models.quant import mm, moe_mm, unembed_operands
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
    # MoE (Qwen3-MoE / Mixtral-class): num_experts > 0 replaces every
    # layer's dense MLP with the routed mixture (``_moe_mlp``);
    # moe_capacity_factor sizes each expert's buffer per token group of
    # moe_group_size tokens (0: min(N, 512)); choices past capacity drop
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 2.0
    moe_group_size: int = 0
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


# -- init -------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's structure: ``(shape, init)`` per leaf, init
    one of ``normal`` (Normal(0.02)), ``layer_normal`` (Normal(0.02) drawn
    one layer at a time: the stacked experts, whose whole f32 draw would
    not fit beside the model), ``ones``, ``zeros``, in the order
    ``init_params`` draws them. A MoE config has ``router`` and the
    ``we_*`` experts in place of the dense ``w_*`` MLP leaves."""
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
    }
    if cfg.num_experts:
        e, fe = cfg.num_experts, cfg.moe_intermediate_size
        layers.update({
            "router": ((n_l, d, e), "normal"),
            "we_gate": ((n_l, e, d, fe), "layer_normal"),
            "we_up": ((n_l, e, d, fe), "layer_normal"),
            "we_down": ((n_l, e, fe, d), "layer_normal"),
        })
    else:
        layers.update({
            "w_gate": ((n_l, d, f), "normal"),
            "w_up": ((n_l, d, f), "normal"),
            "w_down": ((n_l, f, d), "normal"),
        })
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

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * 0.02).to(cfg.dtype)

    def make(name, shape, init):
        if init == "normal":
            w = normal(shape)
        elif init == "layer_normal":
            w = torch.empty(shape, device=dev, dtype=cfg.dtype)
            for layer in range(shape[0]):
                w[layer] = normal(shape[1:])
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


def layer_params(params: dict, layer: int):
    """Views of one layer's slices of the stacked ``[L, ...]`` leaves (a
    wrapper slices each of its tensors). When ``params["layers"]`` is not a
    dict but a per-layer source (``parallel/fsdp.py``'s sharded layers), a
    handle whose ``gather()`` gives that dict: the layer body calls it
    (``layer_weights``), so that a remat'd layer gathers again in its
    backward."""
    layers = params["layers"]
    if not isinstance(layers, dict):
        return layers.layer(layer)
    return {k: v[layer] for k, v in layers.items()}


def layer_weights(lp) -> dict:
    """``lp`` of ``layer_params``, its weights gathered if it is a handle."""
    return lp if isinstance(lp, dict) else lp.gather()


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


def _moe_mlp(cfg: ModelConfig, x: torch.Tensor, lp: dict,
             valid: torch.Tensor | None = None, ep=None,
             f32: bool = False) -> torch.Tensor:
    """Routed mixture MLP on flattened tokens ``x`` [N, d] -> [N, d], the
    reference's ``_moe_mlp``: softmax over all experts, top-k, the k
    probabilities renormalised with ``norm_topk_prob``; GShard dispatch
    with token groups of ``moe_group_size`` (0: min(N, 512)), each expert
    taking ``C = ceil(k * g * capacity_factor / E)`` slots per group.
    Within a group earlier tokens win capacity, and within a token its
    higher-probability choice; a choice past capacity loses that expert's
    contribution. ``valid`` [N] keeps tokens out of routing altogether.

    Top-k is a stable descending sort: on equal probabilities the lower
    expert index comes first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order), which decides both the experts a
    token takes and which of its choices wins capacity. The one-hots are
    comparisons with an ``arange`` and the capacity a Python int: nothing
    reads the host, so a CUDA graph captures the layer. Cast points are
    the reference's: the router product in the model dtype, then f32
    softmax and top-k; dispatch in the model dtype, combine in f32; SiLU in
    f32, cast back before ``gate * up``; the combine product in f32, cast
    back at the end. The expert products are batched einsums over the
    stacked experts (``quant.moe_mm``).

    ``ep`` (``parallel/expert.ExpertParallel``) runs this rank's expert
    block: the routing whole, the dispatch, products and combine of its
    ``E/ep`` experts (``lp``'s ``we_*`` are its block), the partial sums
    added over ep in f32 (``ep.reduce``), the input and the router through
    ``ep.copy``. On a tp shard ``lp``'s experts are this rank's slices of
    each expert's width, and the result is a partial sum for the caller
    to add. ``f32`` returns the f32 result before the cast (the engine's
    tp shards add their partials in f32 and round once)."""
    if ep is not None:
        x = ep.copy(x)
        lp = ep.shared(lp)
    n, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g = min(cfg.moe_group_size or 512, n)
    n_pad = -(-n // g) * g
    ng = n_pad // g
    dev = x.device

    valid = (torch.ones((n,), dtype=torch.float32, device=dev) if valid is None
             else valid.float())
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
        valid = torch.nn.functional.pad(valid, (0, n_pad - n))

    probs = torch.softmax(mm(x, lp["router"]).float(), dim=-1)       # [Np, E]
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    if cfg.norm_topk_prob:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    cap = int(np.ceil(k * g * cfg.moe_capacity_factor / e))
    cap = max(1, min(cap, g))

    # slot of each (token, choice) in its expert's buffer, token-major
    flat_e = top_i.reshape(ng, g * k)                                 # [G, g·k]
    vk = valid.reshape(ng, g).repeat_interleave(k, dim=1)             # [G, g·k]
    e_onehot = ((flat_e[..., None] == torch.arange(e, device=dev)).float()
                * vk[..., None])                                      # [G, g·k, E]
    pos_in_e = e_onehot.cumsum(dim=1) - e_onehot
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]               # [G, g·k]
    keep = (pos < cap).float() * vk
    cap_oh = ((pos.long()[..., None] == torch.arange(cap, device=dev)).float()
              * keep[..., None])                                      # [G, g·k, C]

    # dispatch/combine [G, g, E, C], contracting the k choices (a token
    # takes an expert once, so each entry is one term: exact in any order)
    eo = e_onehot.reshape(ng, g, k, e)
    co = cap_oh.reshape(ng, g, k, cap)
    dispatch = torch.einsum("gtke,gtkc->gtec", eo, co).to(x.dtype)
    combine = torch.einsum("gtke,gtkc->gtec",
                           eo * top_p.reshape(ng, g, k, 1), co).float()
    if ep is not None:
        first, count = ep.experts(e)
        dispatch = dispatch[:, :, first:first + count]
        combine = combine[:, :, first:first + count]

    xe = torch.einsum("gtd,gtec->gecd", x.reshape(ng, g, d), dispatch)
    gate = torch.nn.functional.silu(
        moe_mm("gecd,edf->gecf", xe, lp["we_gate"]).float()).to(x.dtype)
    up = moe_mm("gecd,edf->gecf", xe, lp["we_up"])
    ye = moe_mm("gecf,efd->gecd", gate * up, lp["we_down"])          # [G, E, C, d]
    out = torch.einsum("gecd,gtec->gtd", ye.float(), combine)
    if ep is not None:
        out = ep.reduce(out)
    out = out.reshape(n_pad, d)[:n]
    return out if f32 else out.to(x.dtype)


def _mlp_block(cfg: ModelConfig, h: torch.Tensor, lp: dict,
               valid: torch.Tensor | None = None, ep=None,
               f32: bool = False) -> torch.Tensor:
    """Post-norm MLP: dense SwiGLU (SiLU in f32, cast back before the
    gate product), or the routed mixture on a MoE config (``ep``, ``f32``
    as ``_moe_mlp`` takes them), over ``h``'s leading dims flattened into
    one token axis; ``valid`` matches those dims."""
    if cfg.num_experts:
        shape = h.shape
        v = valid.reshape(-1) if valid is not None else None
        return _moe_mlp(cfg, h.reshape(-1, shape[-1]), lp, v, ep,
                        f32).reshape(shape)
    return mm(_swiglu(h, lp), lp["w_down"])


def _swiglu(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """The dense MLP up to ``w_down``: SiLU of the gate in f32, cast back
    before the gate product."""
    gate = torch.nn.functional.silu(mm(h, lp["w_gate"]).float()).to(h.dtype)
    return gate * mm(h, lp["w_up"])


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
    return _heads_proj(cfg, rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps), lp)


def _heads_proj(cfg: ModelConfig, h: torch.Tensor, lp: dict):
    """``_qkv_proj`` after the norm: h [B, T, d] -> q, k, v by heads (a tp
    shard's config gives its own head counts)."""
    b, t, _ = h.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
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
               lp: dict, valid: torch.Tensor | None = None,
               ep=None) -> torch.Tensor:
    """Output projection, residual, post-norm MLP, residual. ``valid``
    (``x``'s leading dims) marks the tokens that route (MoE), ``ep`` is
    the expert-parallel seam (``_moe_mlp``)."""
    lead = attn_out.shape[:-2]
    x = x + mm(attn_out.reshape(*lead, -1), lp["wo"])
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp_block(cfg, h, lp, valid, ep)


def _tp_layer(cfg: ModelConfig, tp, x, lp, cos, sin, attn_fn, attn_mask,
              valid, ep=None):
    """One layer on a tp shard (``cfg`` its local config): the Megatron
    layout of ``_qkv`` + ``_post_attn``, the replicated weights that read
    this rank's heads or partial sums through ``tp.shared`` (their
    gradients summed over tp). A MoE layer's routed block is a partial
    sum over its experts' width slices, added by the same ``tp.reduce``
    as the dense ``w_down``'s."""
    eps = cfg.rms_norm_eps
    lp = tp.shared(lp)
    h = tp.copy(rms_norm(x, lp["attn_norm"], eps))
    q, k, v = _heads_proj(cfg, h, lp)
    q, k = _qk_norm_rope(cfg, q, k, lp, cos, sin)
    a = attn_fn(q, k, v, attn_mask)
    x = x + tp.reduce(mm(a.reshape(*a.shape[:-2], -1), lp["wo"]))
    h = tp.copy(rms_norm(x, lp["mlp_norm"], eps))
    return x + tp.reduce(_mlp_block(cfg, h, lp, valid, ep))


def layer_forward(cfg: ModelConfig, x: torch.Tensor, lp, cos, sin, attn_fn,
                  attn_mask, valid, tp=None, ep=None) -> torch.Tensor:
    """One training layer: ``lp`` of ``layer_params`` (gathered here,
    ``layer_weights``), ``attn_fn(q, k, v, attn_mask)`` its attention,
    ``valid`` the tokens that route (MoE); on a tp shard (``tp``) the
    Megatron layout with ``cfg`` the whole config, ``ep`` the
    expert-parallel seam. The body of ``forward_hidden``'s layer loop and
    of a pipeline stage's (``parallel/pipeline.py``)."""
    lp = layer_weights(lp)
    if tp is not None:
        return _tp_layer(tp.local_config(cfg), tp, x, lp, cos, sin, attn_fn,
                         attn_mask, valid, ep)
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    return _post_attn(cfg, x, attn_fn(q, k, v, attn_mask), lp, valid, ep)


def run_layers(cfg: ModelConfig, layers, x, cos, sin, attn_fn, attn_mask,
               remat: bool = False, tp=None, ep=None, count: int | None = None
               ) -> torch.Tensor:
    """``layer_forward`` over the first ``count`` (default every) layers
    of ``layers`` (``params["layers"]``: stacked leaves or a per-layer
    source), each under ``checkpoint`` when ``remat`` and autograd
    records."""
    params = {"layers": layers}
    valid = attn_mask > 0

    def layer(x, lp):
        return layer_forward(cfg, x, lp, cos, sin, attn_fn, attn_mask, valid,
                             tp, ep)

    for i in range(cfg.num_layers if count is None else count):
        lp = layer_params(params, i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = layer(x, lp)
    return x


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
                   attn_fn=None, tp=None, ep=None,
                   layers_fn=None) -> torch.Tensor:
    """Full-sequence forward up to the final RMSNorm: [B, T, d] hidden
    states, differentiable. ``attn_fn(q, k, v, attn_mask)`` is the layer
    attention, by default ``flash.auto_train_attention()`` (K4 on the
    card, its plain version on the CPU), as the JAX actor passes it.
    ``remat`` recomputes each layer in the backward
    (``checkpoint(..., use_reentrant=False)``, the JAX ``jax.checkpoint``
    of the scan body); it applies only while autograd records. Tokens
    with ``attn_mask`` 0 (padding, a packed row's tail) take no expert
    capacity (MoE).

    The layer body gathers its weights (``layer_weights``): under an fsdp
    mesh's per-layer source that is one layer's all-gather, inside the
    ``checkpoint`` so that the backward gathers again and no layer's
    gathered weights outlive it. ``tp`` (``parallel/tensor.TensorParallel``)
    runs this rank's tensor-parallel shard: its params are the tp blocks
    (``tensor.tp_dim``), the embedding is vocab-parallel, each layer's
    column-parallel products take ``tp.copy`` of their input and its
    row-parallel ``wo``/``w_down`` partials are summed by ``tp.reduce``,
    and ``attn_fn`` sees this rank's ``Hq/tp`` and ``Hkv/tp`` heads.
    ``ep`` (``parallel/expert.ExpertParallel``) runs this rank's expert
    blocks of every MoE layer (``_moe_mlp``).

    ``layers_fn(layers, x, cos, sin, attn_mask)``, when given, owns the
    layer loop, as the JAX ``forward``'s hook: a pipeline over ``pp``
    (``parallel/pipeline.make_pipeline_layers_fn``) that runs this rank's
    stage of ``params["layers"]`` with its own attention, microbatches
    and remat (``attn_fn`` and ``remat`` are then unused)."""
    if tp is None:
        x = params["embed"][input_ids]
    else:
        x = tp.embed(params["embed"], input_ids)
    cos, sin = rope_cos_sin(cfg, positions)
    if layers_fn is not None:
        x = layers_fn(params["layers"], x, cos, sin, attn_mask)
    else:
        x = run_layers(cfg, params["layers"], x, cos, sin,
                       attn_fn or flash.auto_train_attention(), attn_mask,
                       remat, tp, ep)
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
    which must mark the chunk's slots valid too; the chunk's own slice of
    it (at ``write_idx``) marks the tokens that route (MoE)."""
    b, t = input_ids.shape
    dev = input_ids.device
    if is_tp_shards(params):
        if cache is None:
            raise ValueError("tp shards run the cached (prefill) forward only")
        return _forward_cached_tp(params, cfg, input_ids, positions, attn_mask,
                                  cache, write_idx, logits_for)
    if cache is None:
        x = forward_hidden(params, cfg, input_ids, positions, attn_mask,
                           remat=remat, attn_fn=attn_fn)
        if logits_for is not None:
            x = x[torch.arange(b, device=dev), logits_for.long()]
        return unembed(x, head_weight(params, cfg)), None

    with torch.no_grad():
        x = params["embed"][input_ids]
        cos, sin = rope_cos_sin(cfg, positions)
        mask, chunk_valid = _cache_mask(attn_mask, write_idx, t, cache[0].shape[2])
        for layer in range(cfg.num_layers):
            lp = layer_params(params, layer)
            q, k, v = _qkv(cfg, x, lp, cos, sin)
            kc, vc = cache[0][layer], cache[1][layer]
            kc[:, write_idx:write_idx + t] = k.to(kc.dtype)
            vc[:, write_idx:write_idx + t] = v.to(vc.dtype)
            x = _post_attn(cfg, x, attention(q, kc, vc, mask=mask), lp,
                           chunk_valid)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        if logits_for is not None:
            x = x[torch.arange(b, device=dev), logits_for.long()]
        return unembed(x, head_weight(params, cfg)), cache


def _cache_mask(attn_mask: torch.Tensor, write_idx: int, t: int, s_len: int):
    """The cached forward's attention mask [B, 1, T, S] (causal from
    ``write_idx``, written slots, valid keys) and the chunk's own slice of
    ``attn_mask`` [B, T] (the tokens that route)."""
    dev = attn_mask.device
    valid = attn_mask > 0
    kv_pos = torch.arange(s_len, device=dev)[None, None, None, :]
    slot_written = kv_pos <= (write_idx + t - 1)
    causal = kv_pos <= (write_idx + torch.arange(t, device=dev)[None, None, :, None])
    return (causal & slot_written & valid[:, None, None, :],
            valid[:, write_idx:write_idx + t])


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
    b, pb = ids.shape
    dev = ids.device
    mask = (torch.arange(pb, device=dev)[None, :] < prompt_lens[:, None]).float()
    positions = torch.arange(pb, device=dev, dtype=torch.int32).expand(b, pb)
    shard_pools = pools if is_tp_shards(params) else [pools]
    page_size = shard_pools[0][0][0].shape[2]
    caches = [make_cache(_pool_cfg(cfg, sp), b, pb, dtype=sp[0][0].dtype,
                         device=sp[0][0].device) for sp in shard_pools]
    last_logits, out = forward(
        params, cfg, ids, positions, mask,
        cache=caches if is_tp_shards(params) else caches[0], write_idx=0,
        logits_for=(prompt_lens - 1).clamp(min=0))
    for sp, (k_new, v_new) in zip(shard_pools, out if is_tp_shards(params)
                                  else [out]):
        _scatter_chunk(sp, k_new, v_new, page_ids.to(sp[0][0].device), page_size)
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
    b, pb = ids.shape
    dev = ids.device
    tp = is_tp_shards(params)
    shard_pools = pools if tp else [pools]
    page_size = shard_pools[0][0][0].shape[2]
    n_pre = prefix_page_ids.shape[1]
    prefix_cap = n_pre * page_size
    hd = cfg.head_dim_
    s_total = prefix_cap + pb
    caches = []
    for sp in shard_pools:
        pdev = sp[0][0].device
        hkv = sp[0][0].shape[0]
        cache = make_cache(_pool_cfg(cfg, sp), b, s_total, dtype=sp[0][0].dtype,
                           device=pdev)
        pre = prefix_page_ids.long().to(pdev)
        for layer in range(cfg.num_layers):
            for side in (0, 1):
                # [Hkv, B, n_pre, ps, D] -> [B, prefix_cap, Hkv, D]
                g = sp[side][layer][:, pre]
                cache[side][layer, :, :prefix_cap] = (
                    g.permute(1, 2, 3, 0, 4).reshape(b, prefix_cap, hkv, hd))
        caches.append(cache)
    positions = (prefix_len + torch.arange(pb, device=dev, dtype=torch.int32)
                 ).expand(b, pb)
    slot = torch.arange(s_total, device=dev)[None, :]
    valid = (slot < prefix_len) | ((slot >= prefix_len)
                                   & (slot < prefix_len + suffix_lens[:, None]))
    last_logits, out = forward(
        params, cfg, ids, positions, valid.float(),
        cache=caches if tp else caches[0],
        write_idx=prefix_len, logits_for=(suffix_lens - 1).clamp(min=0))
    for sp, (k_all, v_all) in zip(shard_pools, out if tp else [out]):
        k_sfx = k_all[:, :, prefix_len:prefix_len + pb]
        v_sfx = v_all[:, :, prefix_len:prefix_len + pb]
        _scatter_chunk(sp, k_sfx, v_sfx, page_ids.to(sp[0][0].device),
                       page_size)
    return pools, last_logits


def _decode_writes(page_table: torch.Tensor, seq_lens: torch.Tensor,
                   page_size: int, active: torch.Tensor | None):
    """Where each slot's new token goes (its current page and offset, an
    inactive slot's to the null page 0) and the lengths it attends, int32:
    ``(write_page, write_off, attn_lens)`` [S] each."""
    s = seq_lens.shape[0]
    # JAX gathers clamp out-of-range indices; torch indexing would fault
    col = (seq_lens // page_size).clamp(max=page_table.shape[1] - 1).long()
    write_page = page_table[torch.arange(s, device=seq_lens.device), col]
    write_off = seq_lens % page_size
    if active is not None:
        write_page = torch.where(active, write_page, 0)
        write_off = torch.where(active, write_off, 0)
    return (write_page.to(torch.int32), write_off.to(torch.int32),
            (seq_lens + 1).to(torch.int32))


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
    the same plain chain. Pools are updated in place. Inactive slots
    route to no expert (MoE)."""
    if is_tp_shards(params):
        return _forward_paged_decode_tp(params, cfg, tokens, positions, pools,
                                        page_table, seq_lens, attn_fn, active,
                                        kv_write_fn)
    attn_fn = attn_fn or paged_attention
    x = params["embed"][tokens][:, None]  # [S, 1, d]
    cos, sin = rope_cos_sin(cfg, positions[:, None])
    write_page, write_off, attn_lens = _decode_writes(
        page_table, seq_lens, pools[0][0].shape[2], active)

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
        x = _post_attn(cfg, x, attn_out[:, None], lp, active)
    x = rms_norm(x[:, 0], params["final_norm"], cfg.rms_norm_eps)
    return unembed(x, head_weight(params, cfg)), pools


# -- one-process tensor parallelism (the engine's tp shards) ----------------
#
# ``serve --tp N`` runs N tensor-parallel shards in one process, as the
# reference's engine runs a tp mesh of its host's devices. Its weights are a
# list of N trees (``shard_tp``), shard s holding the tp blocks of
# ``parallel/tensor.tp_dim``: the column-split projections' and biases' s-th
# output block, the row-split ``wo``/``w_down``'s s-th input block, the
# vocabulary's s-th block of ``embed`` (and of ``lm_head``), the norms
# whole. Its KV pools are a list of N per-shard pools of ``Hkv/tp`` heads,
# each allocated apart (``make_tp_paged_pools``). A layer runs every
# shard's heads and MLP columns, and sums the row-parallel partials after
# ``wo`` and ``w_down`` onto the first shard's device in f32, rounded once
# (one process: no collective; ``_tp_partial``). A MoE layer's shard holds a
# ``1/N`` slice of every expert's width and the whole router: each shard
# routes the tokens whole, and its routed block's f32 partial joins the
# sum in place of ``w_down``'s. The vocabulary blocks' logits are concatenated before the
# sampler. Every op is a device op, so a decode dispatch over shards on one
# card is still one capturable stream; shards on several cards move their
# partials between devices inside the dispatch.


def is_tp_shards(params) -> bool:
    """True for the engine's tensor-parallel shard list."""
    return isinstance(params, (list, tuple))


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    from polyrl_tpu_torch.parallel.tensor import local_config

    return local_config(cfg, tp)


def _pool_cfg(cfg: ModelConfig, shard_pools) -> ModelConfig:
    """``cfg`` with the KV heads of one shard's pools (the dense prefill
    cache's)."""
    hkv = shard_pools[0][0].shape[0]
    return cfg if hkv == cfg.num_kv_heads else dataclasses.replace(
        cfg, num_kv_heads=hkv, head_dim=cfg.head_dim_)


def shard_tp(params: dict, tp: int, devices) -> list:
    """A whole tree (plain, int8 or LoRA) -> ``tp`` shard trees of new
    tensors on ``devices`` (``parallel/tensor.tp_dim``'s blocks)."""
    from polyrl_tpu_torch.models.quant import flatten, unflatten
    from polyrl_tpu_torch.parallel.tensor import tp_dim

    flat = flatten(params)
    out = []
    for s in range(tp):
        sub = {}
        for name, t in flat.items():
            d = None if t.dim() == 0 else tp_dim(name, t.shape)
            blk = t if d is None else t.chunk(tp, d)[s]
            sub[name] = (blk if t.dim() == 0 else
                         blk.to(devices[s], copy=True).contiguous())
        out.append(unflatten(sub))
    return out


@torch.no_grad()
def copy_into_tp_shards(shards: list, params: dict) -> None:
    """Copy a whole tree's tp blocks into the shard trees in place."""
    from polyrl_tpu_torch.models.quant import named_leaves
    from polyrl_tpu_torch.parallel.tensor import tp_dim

    tp = len(shards)
    whole = dict(named_leaves(params))
    for s, tree in enumerate(shards):
        for name, dst in named_leaves(tree):
            src = whole[name]
            d = tp_dim(name, src.shape)
            dst.copy_(src if d is None else src.chunk(tp, d)[s])


def make_tp_paged_pools(cfg: ModelConfig, tp: int, num_pages: int,
                        page_size: int, dtype=None, devices=None) -> list:
    """One ``make_paged_pools`` per shard, of ``Hkv/tp`` heads, on its
    device: every layer's pool a separate allocation (16-byte aligned, as
    K1-K3 check)."""
    lcfg = tp_local_config(cfg, tp)
    devices = devices or [None] * tp
    return [make_paged_pools(lcfg, num_pages, page_size, dtype=dtype,
                             device=devices[s]) for s in range(tp)]


def _tp_embed(shards: list, ids: torch.Tensor) -> torch.Tensor:
    """The vocab-split lookup: each shard's rows where it owns the id,
    summed on the first shard's device (exact: one owner per id)."""
    from polyrl_tpu_torch.parallel.tensor import vocab_lookup

    out = None
    for s, p in enumerate(shards):
        table = p["embed"]
        x = vocab_lookup(table, ids.to(table.device), s * table.shape[0])
        out = x if out is None else out + x.to(out.device)
    return out


def _tp_partial(x: torch.Tensor, w) -> torch.Tensor:
    """One shard's row-parallel partial ``x @ w`` with an f32 result: on
    the card a bf16/f16 plain weight's product accumulates in f32 and is
    not rounded (``torch.mm(..., out_dtype=torch.float32)``), so that the
    shards' partials add in f32 and round once, as one shard's whole
    product does; elsewhere (int8, LoRA, the CPU's f32) the product's own
    result, upcast."""
    half = (torch.bfloat16, torch.float16)
    if (isinstance(w, torch.Tensor) and x.is_cuda and x.dtype in half
            and w.dtype == x.dtype):
        shape = x.shape
        out = torch.mm(x.reshape(-1, shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*shape[:-1], w.shape[-1])
    return mm(x, w).float()


def _tp_sum(parts: list, device, dtype) -> torch.Tensor:
    """The row-parallel f32 partials summed on ``device`` in shard order,
    rounded once to ``dtype``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out.to(dtype)


def _tp_logits(shards: list, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then each shard's vocabulary block, concatenated."""
    x = rms_norm(x, shards[0]["final_norm"], cfg.rms_norm_eps)
    return torch.cat([unembed(x.to(p["embed"].device), head_weight(p, cfg)
                              ).to(x.device) for p in shards], dim=-1)


def _tp_mlp(shards, lcfg, layer, x, valid=None):
    """The post-norm MLP on each shard's columns and the residual: the
    dense ``_swiglu`` with the ``w_down`` partials summed
    (``_tp_partial``), or the routed mixture on each shard's expert
    width slices (``valid`` the tokens that route), its f32 partials
    summed the same way."""
    h = rms_norm(x, layer_params(shards[0], layer)["mlp_norm"], lcfg.rms_norm_eps)
    parts = []
    for p in shards:
        lp = layer_params(p, layer)
        hs = h.to(lp["mlp_norm"].device)
        if lcfg.num_experts:
            parts.append(_mlp_block(lcfg, hs, lp, None if valid is None
                                    else valid.to(hs.device), f32=True))
        else:
            parts.append(_tp_partial(_swiglu(hs, lp), lp["w_down"]))
    return x + _tp_sum(parts, x.device, x.dtype)


@torch.no_grad()
def _forward_cached_tp(shards, cfg, input_ids, positions, attn_mask, caches,
                       write_idx, logits_for):
    """``forward``'s cached (prefill) path on tp shards: ``caches`` one
    ``(k, v)`` a shard of its ``Hkv/tp`` heads, written in place."""
    lcfg = tp_local_config(cfg, len(shards))
    b, t = input_ids.shape
    dev = input_ids.device
    x = _tp_embed(shards, input_ids).to(dev)
    cos, sin = rope_cos_sin(cfg, positions)
    mask, chunk_valid = _cache_mask(attn_mask, write_idx, t,
                                    caches[0][0].shape[2])
    for layer in range(cfg.num_layers):
        h = rms_norm(x, layer_params(shards[0], layer)["attn_norm"],
                     cfg.rms_norm_eps)
        parts = []
        for p, cache in zip(shards, caches):
            lp = layer_params(p, layer)
            sdev = cache[0].device
            q, k, v = _heads_proj(lcfg, h.to(sdev), lp)
            q, k = _qk_norm_rope(lcfg, q, k, lp, cos.to(sdev), sin.to(sdev))
            kc, vc = cache[0][layer], cache[1][layer]
            kc[:, write_idx:write_idx + t] = k.to(kc.dtype)
            vc[:, write_idx:write_idx + t] = v.to(vc.dtype)
            a = attention(q, kc, vc, mask=mask.to(sdev))
            parts.append(_tp_partial(a.reshape(*a.shape[:-2], -1), lp["wo"]))
        x = x + _tp_sum(parts, dev, x.dtype)
        x = _tp_mlp(shards, lcfg, layer, x, chunk_valid)
    if logits_for is not None:
        x = x[torch.arange(b, device=dev), logits_for.long()]
    return _tp_logits(shards, cfg, x), caches


@torch.no_grad()
def _forward_paged_decode_tp(shards, cfg, tokens, positions, pools, page_table,
                             seq_lens, attn_fn, active, kv_write_fn):
    """``forward_paged_decode`` on tp shards: ``pools`` one ``(k, v)``
    per-layer list pair a shard. ``attn_fn(qs, k_pools, v_pools,
    page_table, lens)`` takes and returns one tensor a shard (default
    ``ops.paged_attention.make_tp_paged_attention()``: K2 on each shard's
    heads). The fused prologue writes each shard's K/V; the unfused route
    (``kv_write_fn``) is one shard's only."""
    from polyrl_tpu_torch.ops.paged_attention import (
        make_tp_paged_attention, make_tp_paged_kv_write_fused)

    if kv_write_fn is not None:
        raise ValueError("tp shards take the fused prologue's K/V write")
    tp = len(shards)
    lcfg = tp_local_config(cfg, tp)
    attn_fn = attn_fn or make_tp_paged_attention()
    fused = make_tp_paged_kv_write_fused(cfg.rms_norm_eps)
    s = tokens.shape[0]
    dev = tokens.device
    x = _tp_embed(shards, tokens)[:, None].to(dev)  # [S, 1, d]
    cos, sin = rope_cos_sin(cfg, positions[:, None])
    write_page, write_off, attn_lens = _decode_writes(
        page_table, seq_lens, pools[0][0][0].shape[2], active)

    for layer in range(cfg.num_layers):
        h = rms_norm(x, layer_params(shards[0], layer)["attn_norm"],
                     cfg.rms_norm_eps)
        lps = [layer_params(p, layer) for p in shards]
        kps = [sp[0][layer] for sp in pools]
        vps = [sp[1][layer] for sp in pools]
        qs, ks, vs = zip(*[[t[:, 0] for t in _heads_proj(lcfg, h.to(kp.device), lp)]
                           for lp, kp in zip(lps, kps)])
        qs = fused(kps, vps, write_page, write_off, list(qs), list(ks),
                   list(vs), cos[:, 0], sin[:, 0],
                   [lp["q_norm"] for lp in lps] if cfg.use_qk_norm else None,
                   [lp["k_norm"] for lp in lps] if cfg.use_qk_norm else None)
        outs = attn_fn(qs, kps, vps, page_table, attn_lens)   # [S, Hq/tp, D] each
        parts = [_tp_partial(o.reshape(s, 1, -1), lp["wo"])
                 for o, lp in zip(outs, lps)]
        x = x + _tp_sum(parts, dev, x.dtype)
        x = _tp_mlp(shards, lcfg, layer, x,
                    None if active is None else active[:, None])
    return _tp_logits(shards, cfg, x[:, 0]), pools
