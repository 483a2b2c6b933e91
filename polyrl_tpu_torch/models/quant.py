"""Int8 weight-only quantization and the LoRA weight wrapper, in PyTorch.

Counterpart of the dense half of ``polyrl_tpu/models/quant.py``:
``QuantWeight`` (int8 ``q`` with a per-output-channel f32 ``scale``),
``LoraWeight`` (a frozen ``base`` plus trainable ``a``/``b`` adapters and
a float ``alpha``), ``quantize_tensor``, ``mm`` (the product every
decoder projection goes through), ``unembed_operands`` (the logits head's
dispatch), ``quantize_params`` and ``init_quantized_params``.

The reference's wrappers are pytree nodes; here they are small classes
holding tensors, and ``tree_map`` / ``named_leaves`` walk a parameter
tree through dicts and wrappers alike. Slicing a wrapper (``w[layer]``)
slices each of its tensors, so ``decoder.layer_params`` works unchanged.
A wrapper's fields name its leaves: ``<path>.q`` and ``<path>.scale``;
``<path>.base``, ``<path>.a`` and ``<path>.b`` (``<path>.base.q`` ... over
an int8 base). ``flatten``/``unflatten`` add ``<path>.alpha`` so a flat
``{name: tensor}`` dict carries a wrapped tree whole (checkpoints).

The reference's products are XLA ops that fuse the int8 -> bf16 cast into
the matmul. Here ``mm`` casts ``q`` to the activations' type and then
multiplies: on the card that writes a bf16 copy of the weight before each
product (``PERF.md`` measures what it costs; a fused int8 weight-only
decode product is a ROADMAP item). The MoE half (``moe_mm``) waits for
the MoE port.
"""

from __future__ import annotations

import torch

# layer-stacked matmul weights that get quantized ([L, in, out]); embed
# stays in the model dtype (a gather, not a product), norms and biases are
# tiny
QUANTIZED_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class QuantWeight:
    """int8 weight ``q`` ([in, out] or stacked [L, in, out]) and its f32
    per-output-channel ``scale`` with the contraction axis reduced away
    ([out] or [L, out]): ``w ~= q * scale``."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q, self.scale = q, scale

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, i) -> "QuantWeight":
        return QuantWeight(self.q[i], self.scale[i])

    def fields(self) -> dict:
        return {"q": self.q, "scale": self.scale}

    def rebuild(self, f: dict) -> "QuantWeight":
        return QuantWeight(f["q"], f["scale"])

    def __repr__(self) -> str:
        return f"QuantWeight(q={tuple(self.q.shape)}, scale={tuple(self.scale.shape)})"


class LoraWeight:
    """A frozen ``base`` (a tensor or a ``QuantWeight``: QLoRA) and the
    adapters ``a`` [..., in, r] and ``b`` [..., r, out]:
    ``w ~= base + (alpha / r) * a @ b``."""

    __slots__ = ("base", "a", "b", "alpha")

    def __init__(self, base, a, b, alpha: float = 16.0):
        self.base, self.a, self.b, self.alpha = base, a, b, float(alpha)

    @property
    def shape(self):
        return self.base.shape

    def __getitem__(self, i) -> "LoraWeight":
        return LoraWeight(self.base[i], self.a[i], self.b[i], self.alpha)

    def fields(self) -> dict:
        return {"base": self.base, "a": self.a, "b": self.b}

    def rebuild(self, f: dict) -> "LoraWeight":
        return LoraWeight(f["base"], f["a"], f["b"], self.alpha)

    def __repr__(self) -> str:
        return (f"LoraWeight(base={self.base!r}, a={tuple(self.a.shape)}, "
                f"b={tuple(self.b.shape)}, alpha={self.alpha})")


WRAPPERS = (QuantWeight, LoraWeight)


# -- trees ----------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict whose nodes may be wrappers;
    the wrappers are rebuilt around the results (``alpha`` kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, WRAPPERS):
        return tree.rebuild({k: tree_map(fn, v) for k, v in tree.fields().items()})
    return fn(tree)


def named_leaves(tree, prefix: str = ""):
    """``(dotted name, tensor)`` of every leaf; dict keys sorted, a
    wrapper's fields in their fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, WRAPPERS):
        for k, v in tree.fields().items():
            yield from named_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def lora_alphas(tree, prefix: str = "") -> dict[str, float]:
    """``{"<path>.alpha": alpha}`` of every ``LoraWeight`` in ``tree``."""
    out: dict[str, float] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(lora_alphas(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, LoraWeight):
        out[f"{prefix}alpha"] = tree.alpha
    return out


def flatten(tree) -> dict[str, torch.Tensor]:
    """A wrapped tree as one flat ``{name: tensor}`` dict: its leaves
    (``named_leaves``) plus each LoRA ``alpha`` as a 0-d f64 tensor. A flat
    dict of tensors flattens to itself."""
    out = dict(named_leaves(tree))
    out.update({k: torch.tensor(a, dtype=torch.float64)
                for k, a in lora_alphas(tree).items()})
    return out


def unflatten(flat: dict[str, torch.Tensor]):
    """Inverse of ``flatten``: dotted names back into nested dicts, a node
    with the fields ``base``, ``a``, ``b`` and ``alpha`` into a
    ``LoraWeight`` and one with ``q`` and ``scale`` into a ``QuantWeight``
    (no decoder tree has dicts with those key sets)."""
    root: dict = {}
    for name, t in flat.items():
        node = root
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        node = {k: build(v) for k, v in node.items()}
        if set(node) == {"base", "a", "b", "alpha"}:
            return LoraWeight(node["base"], node["a"], node["b"],
                              float(node["alpha"]))
        if set(node) == {"q", "scale"}:
            return QuantWeight(node["q"], node["scale"])
        return node

    return build(root)


def detached(tree):
    return tree_map(lambda t: t.detach(), tree)


# -- quantization ---------------------------------------------------------------


def quantize_tensor(w, contract_axis: int = -2) -> QuantWeight:
    """Symmetric per-output-channel int8, as the reference rounds it:
    ``scale = max |w| / 127 + 1e-12`` over the contraction axis (f32),
    ``q = clip(round_half_even(w / scale), -127, 127)``. Runs on the
    tensor's own device (a CPU tensor stays on the host), with the same
    result on both: the divisor 127 is a tensor, since CUDA divides by a
    Python scalar as a product with its rounded reciprocal, which can put
    the scale one ulp off numpy's true quotient and flip ``q`` at ties."""
    w = torch.as_tensor(w)
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(wf / scale.unsqueeze(contract_axis)), -127, 127)
    return QuantWeight(q.to(torch.int8), scale)


def dequantize(w: QuantWeight, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype`` (the scale broadcasts over
    the contraction axis, -2)."""
    return (w.q.float() * w.scale.unsqueeze(-2)).to(dtype)


def quantize_params(params: dict) -> dict:
    """The decoder tree with its layer-stacked projections and an untied
    ``lm_head`` quantized; embed, norms and biases stay as they are (a
    tied head is the embedding and stays too)."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANTIZED_LAYER_KEYS:
        if k in layers:
            layers[k] = quantize_tensor(layers[k], contract_axis=-2)
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"], contract_axis=0)
    return out


def init_quantized_params(generator: torch.Generator, cfg) -> dict:
    """``quantize_params(decoder.init_params(generator, cfg))`` built one
    leaf at a time on ``generator``'s device: the same draws, and the
    model-dtype tree never exists whole (peak: one leaf in f32 and its
    int8 copy). Dense models only."""
    from polyrl_tpu_torch.models import decoder

    if cfg.num_experts:
        raise NotImplementedError(
            "init_quantized_params supports dense models only (the MoE half "
            "of quant.py waits for MoE, ROADMAP A' 8)")
    quantized = set(QUANTIZED_LAYER_KEYS) | {"lm_head"}

    def make(name, w):
        if name.rsplit(".", 1)[-1] in quantized:
            return quantize_tensor(w, contract_axis=-2)
        return w

    return decoder.init_params(generator, cfg, leaf_fn=make)


# -- products ---------------------------------------------------------------------


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with ``QuantWeight``/``LoraWeight`` dispatch. LoRA: the
    base is frozen (detached), ``(x @ a) @ b * alpha / r`` is added in the
    activations' type. int8: ``x @ q`` in the activations' type, then the
    scale in f32 and a cast back."""
    if isinstance(w, LoraWeight):
        rank = w.a.shape[-1]
        delta = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
        return mm(x, detached(w.base)) + delta * (w.alpha / rank)
    if isinstance(w, QuantWeight):
        y = x @ w.q.to(x.dtype)
        # bf16 * f32 promotes to f32: the product is the f32 epilogue, in
        # one kernel (the widening of y is exact)
        return (y * w.scale).to(x.dtype)
    return x @ w


def unembed_operands(head):
    """``(weight, scale or None)`` of a logits head: an int8 head's ``q``
    and its per-vocabulary scale, which multiplies the f32 logits."""
    if isinstance(head, QuantWeight):
        return head.q, head.scale
    if isinstance(head, LoraWeight):
        raise NotImplementedError("the logits head is never LoRA-wrapped")
    return head, None


def weight_bytes(tree) -> int:
    """Bytes of every tensor of a (wrapped) tree."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))
