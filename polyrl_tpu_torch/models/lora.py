"""LoRA adapters for RL post-training, in PyTorch.

Counterpart of ``polyrl_tpu/models/lora.py``. The adapter is a weight
wrapper (``quant.LoraWeight``), not a model rewrite: ``decoder`` runs every
projection through ``quant.mm``, which adds ``(x @ a) @ b * alpha / r`` to
the frozen base's product. Wrapping an int8 base (``quant.QuantWeight``)
is QLoRA with no extra code.

Training: only the ``a``/``b`` leaves are trainable (``lora_labels``); the
actor gives them, and only them, ``requires_grad``, optimizer state, the
clip norm and weight decay, as the reference's ``multi_transform`` with
``set_to_zero`` on every other leaf does. Serving: a push merges the
adapters into a plain tree (``merge_lora``), so the engine sees the
ordinary layout. ``extract_adapters`` / ``adapter_template`` /
``apply_adapters`` are the delta-sync wire of the reference (adapters,
``alpha`` and a fingerprint of the frozen base); the port's colocated
trainer does not use them yet (ROADMAP A' 7).
"""

from __future__ import annotations

import torch

from polyrl_tpu_torch.models.quant import (LoraWeight, QuantWeight, dequantize,
                                           named_leaves)

# default adapter targets: attention and dense MLP projections
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _adapter_dtype(w, dtype):
    dt = dtype or (w.q.dtype if isinstance(w, QuantWeight) else w.dtype)
    return torch.bfloat16 if dt == torch.int8 else dt


def wrap_lora(params: dict, generator: torch.Generator, rank: int,
              alpha: float = 16.0, targets=DEFAULT_TARGETS, dtype=None) -> dict:
    """Wrap each target layer weight [L, in, out] in a ``LoraWeight`` with
    ``a ~ N(0, 1/r)`` [L, in, r] drawn from ``generator`` (one target after
    another, in ``targets`` order) and ``b = 0`` [L, r, out]: the adapter
    starts as an exact no-op. The adapters take the base's dtype (bf16
    over an int8 base) unless ``dtype`` is given, and lie on the base's
    device. A ``torch.Generator`` draws other numbers than ``jax.random``:
    tests convert a JAX-wrapped tree instead."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in targets:
        if k not in layers:
            continue
        w = layers[k]
        n_l, d_in, d_out = w.shape
        dev = (w.q if isinstance(w, QuantWeight) else w).device
        dt = _adapter_dtype(w, dtype)
        a = torch.randn((n_l, d_in, rank), generator=generator,
                        dtype=torch.float32, device=dev)
        a = (a * rank ** -0.5).to(dt)
        b = torch.zeros((n_l, rank, d_out), dtype=dt, device=dev)
        layers[k] = LoraWeight(base=w, a=a, b=b, alpha=float(alpha))
    out["layers"] = layers
    return out


def merge_lora(params: dict) -> dict:
    """Fold the adapters into plain weights: ``base + (alpha / r) * a @ b``
    in f32, cast to the adapters' dtype. An int8 base dequantizes to the
    adapters' dtype first; untargeted leaves pass through (the same
    tensors)."""

    def merge(w):
        if not isinstance(w, LoraWeight):
            return w
        base = w.base
        if isinstance(base, QuantWeight):
            base = dequantize(base, w.a.dtype)
        rank = w.a.shape[-1]
        delta = (w.a.float() @ w.b.float()) * (w.alpha / rank)
        return (base.float() + delta).to(w.a.dtype)

    out = dict(params)
    out["layers"] = {k: merge(v) for k, v in params["layers"].items()}
    return out


def lora_labels(params: dict) -> dict[str, str]:
    """``{leaf name: "train" | "freeze"}``: only the adapters' ``a`` and
    ``b`` train; the base, embed, norms and heads are frozen (no
    gradient, no optimizer state, no decay)."""
    labels = {name: "freeze" for name, _ in named_leaves(params)}
    for k, v in params["layers"].items():
        if isinstance(v, LoraWeight):
            labels[f"layers.{k}.a"] = labels[f"layers.{k}.b"] = "train"
    return labels


def base_stats(params: dict) -> torch.Tensor:
    """Per target, mean |w| of the first and last layer slabs of each
    frozen base, [n_targets, 2] f32 (targets by name): a fingerprint of
    the checkpoint the adapters were trained against."""

    def slab(w):
        if isinstance(w, QuantWeight):
            w = dequantize(w)
        return torch.stack([w[0].float().abs().mean(), w[-1].float().abs().mean()])

    rows = [slab(v.base) for k, v in sorted(params["layers"].items())
            if isinstance(v, LoraWeight)]
    return torch.stack(rows)


def extract_adapters(params: dict) -> dict:
    """The adapter subtree alone: ``{"layers": {k: {"a", "b"}}, "alpha":
    f32 scalar, "base_stats": [n_targets, 2]}``, what a delta push puts on
    the wire."""
    out: dict = {}
    alpha = None
    for k, v in params["layers"].items():
        if isinstance(v, LoraWeight):
            out[k] = {"a": v.a, "b": v.b}
            alpha = v.alpha
    return {"layers": out, "alpha": torch.tensor(alpha or 0.0, dtype=torch.float32),
            "base_stats": base_stats(params)}


def adapter_template(model_cfg, rank: int, targets=DEFAULT_TARGETS,
                     dtype=None) -> dict:
    """The tree ``extract_adapters`` gives for a wrapped model, as
    ``meta`` tensors (shapes and dtypes, no data), from the config alone."""
    from polyrl_tpu_torch.models import decoder

    dt = dtype or model_cfg.dtype
    layers = decoder.param_specs(model_cfg)["layers"]
    out: dict = {}
    for k in targets:
        if k not in layers:
            continue
        n_l, d_in, d_out = layers[k][0]
        out[k] = {"a": torch.empty((n_l, d_in, rank), dtype=dt, device="meta"),
                  "b": torch.empty((n_l, rank, d_out), dtype=dt, device="meta")}
    return {"layers": out,
            "alpha": torch.empty((), dtype=torch.float32, device="meta"),
            "base_stats": torch.empty((len(out), 2), dtype=torch.float32,
                                      device="meta")}


def apply_adapters(wrapped: dict, adapters: dict) -> dict:
    """A new wrapped tree with the received ``a``/``b`` installed (each
    cast to its old leaf's dtype and device); the bases untouched. Refuses
    a base fingerprint more than 5% off this tree's, other target sets,
    an ``alpha`` that differs, and adapters for an unwrapped weight."""
    out = dict(wrapped)
    layers = dict(wrapped["layers"])
    if "base_stats" in adapters:
        mine = base_stats(wrapped).float().cpu()
        theirs = torch.as_tensor(adapters["base_stats"]).float().cpu()
        if mine.shape != theirs.shape:
            raise ValueError(
                "delta-sync base mismatch: trainer and worker wrapped "
                f"different LoRA target sets (fingerprint shapes "
                f"{tuple(mine.shape)} vs {tuple(theirs.shape)}); both sides "
                "must use the same checkpoint and target_modules")
        rel = (mine - theirs).abs() / (theirs.abs() + 1e-12)
        if float(rel.max()) > 0.05:
            raise ValueError(
                "delta-sync base mismatch: this worker's frozen base "
                f"weights differ from the trainer's (rel diff up to "
                f"{float(rel.max()):.3f}); both sides must load the same "
                "checkpoint")
    recv_alpha = float(adapters.get("alpha", 0.0))
    for k, ab in adapters["layers"].items():
        w = layers[k]
        if not isinstance(w, LoraWeight):
            raise ValueError(f"adapter push for unwrapped weight {k!r}")
        if recv_alpha and abs(recv_alpha - w.alpha) > 1e-6:
            raise ValueError(
                f"lora_alpha mismatch: trainer pushed {recv_alpha}, this "
                f"worker serves {w.alpha} — launch with --lora-alpha "
                f"{recv_alpha}")
        layers[k] = LoraWeight(
            base=w.base,
            a=torch.as_tensor(ab["a"]).to(device=w.a.device, dtype=w.a.dtype),
            b=torch.as_tensor(ab["b"]).to(device=w.b.device, dtype=w.b.dtype),
            alpha=w.alpha)
    out["layers"] = layers
    return out


def num_trainable(params: dict) -> int:
    """Adapter parameter count (what the optimizer updates)."""
    return sum(v.a.numel() + v.b.numel() for v in params["layers"].values()
               if isinstance(v, LoraWeight))
