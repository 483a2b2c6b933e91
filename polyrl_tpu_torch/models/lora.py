"""LoRA adapters for RL post-training, in PyTorch.

Counterpart of ``polyrl_tpu/models/lora.py``. The adapter is a weight
wrapper (``quant.LoraWeight``), not a model rewrite: ``decoder`` runs every
projection through ``quant.mm``, which adds ``(x @ a) @ b * alpha / r`` to
the frozen base's product. Wrapping an int8 base (``quant.QuantWeight``)
is QLoRA with no extra code.

Training: only the ``a``/``b`` leaves are trainable (``lora_labels``); the
actor gives them, and only them, ``requires_grad``, optimizer state, the
clip norm and weight decay, as the reference's ``multi_transform`` with
``set_to_zero`` on every other leaf does. Serving: a full push merges the
adapters into a plain tree (``merge_lora``), so the engine sees the
ordinary layout. With ``trainer.weight_sync=lora_delta`` a push carries
only ``extract_adapters`` of the wrapped tree (adapters, ``alpha`` and a
fingerprint of the frozen base; its wire layout is ``adapter_template``)
to servers that serve a wrapped tree (``serve --lora-rank``), and
``apply_adapters`` copies the received ``a``/``b`` into the live leaves in
place: the engine's captured decode graphs read those addresses, and the
frozen bases are never touched. A tp engine's shards (``decoder.shard_tp``)
take the same pushes: ``base_stats`` and ``apply_adapters`` accept the
list of shard trees, check the push against the whole tree and copy each
shard's ``parallel/tensor.tp_dim`` block of ``a``/``b`` into it.
"""

from __future__ import annotations

import torch

from polyrl_tpu_torch.models.quant import (LoraWeight, QuantWeight, dequantize,
                                           named_leaves)

# default adapter targets: attention and dense MLP projections (a MoE
# tree's expert stacks are not wrapped, as in the reference: their
# products go through ``quant.moe_mm``, not ``mm``; attention-only LoRA
# is the usual recipe for MoE fine-tuning)
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


def base_stats(params) -> torch.Tensor:
    """Per target, mean |w| of the first and last layer slabs of each
    frozen base, [n_targets, 2] f32 (targets by name): a fingerprint of
    the checkpoint the adapters were trained against. ``params`` may be a
    tp engine's list of shard trees: each shard holds an equal block of
    every base (an int8 block dequantized with its own block of the
    per-channel scale, or the whole scale where the split is on the
    contraction axis), so the whole tree's mean is the mean of the
    shards' means, on the CPU."""
    if isinstance(params, list):
        return torch.stack([base_stats(p).cpu() for p in params]).mean(0)

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


def _tp_block(adapters: dict, s: int, tp: int) -> dict:
    """Shard ``s``'s block of a whole adapter tree (views; the replicated
    leaves whole)."""
    from polyrl_tpu_torch.parallel.tensor import tp_dim

    def cut(k, f, t):
        t = torch.as_tensor(t)
        d = tp_dim(f"layers.{k}.{f}", t.shape)
        return t if d is None else t.chunk(tp, d)[s]

    out = dict(adapters)
    out["layers"] = {k: {f: cut(k, f, ab[f]) for f in ("a", "b")}
                     for k, ab in adapters["layers"].items()}
    return out


def _whole_shape(name: str, shape, tp: int) -> tuple:
    """The whole leaf's shape of a tp block ``shape``."""
    from polyrl_tpu_torch.parallel.tensor import tp_dim

    shape = list(shape)
    d = tp_dim(name, shape) if tp > 1 else None
    if d is not None:
        shape[d] *= tp
    return tuple(shape)


def apply_adapters(wrapped, adapters):
    """Install the received ``a``/``b`` into ``wrapped``'s live adapter
    tensors in place (each cast to its leaf's dtype and device) and return
    ``wrapped``: every leaf keeps its address, so a captured decode graph
    reads the new adapters at its next replay, and the bases are not
    touched (no copy of the model). The reference builds a new tree
    instead; its engines hold no graphs. Refuses, before copying anything,
    a base fingerprint more than 5% off this tree's, other target sets, an
    ``alpha`` that differs, adapters for an unwrapped weight, and adapter
    shapes that differ. The caller runs it between dispatches (the
    engine's dispatch lock) and flushes the prefix cache after.

    ``wrapped`` may be a tp engine's list of shard trees, the counterpart
    of the reference's leaves sharded on its tp mesh. ``adapters`` is then
    the whole pushed tree, cut here by ``parallel/tensor.tp_dim``, or the
    list of each shard's blocks that a sharded receiver landed. Every
    check is made on the whole tree (the fingerprint over every shard's
    block of each base, the shapes whole) before any shard changes."""
    shards = wrapped if isinstance(wrapped, list) else [wrapped]
    tp = len(shards)
    if isinstance(adapters, list):
        blocks, pushed_tp = adapters, tp
    else:
        blocks, pushed_tp = [adapters], 1
    head = blocks[0]
    layers = shards[0]["layers"]
    if "base_stats" in head:
        mine = base_stats(wrapped).float().cpu()
        theirs = torch.as_tensor(head["base_stats"]).float().cpu()
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
    recv_alpha = float(head.get("alpha", 0.0))
    for k, ab in head["layers"].items():
        w = layers[k]
        if not isinstance(w, LoraWeight):
            raise ValueError(f"adapter push for unwrapped weight {k!r}")
        if recv_alpha and abs(recv_alpha - w.alpha) > 1e-6:
            raise ValueError(
                f"lora_alpha mismatch: trainer pushed {recv_alpha}, this "
                f"worker serves {w.alpha} — launch with --lora-alpha "
                f"{recv_alpha}")
        for f in ("a", "b"):
            name = f"layers.{k}.{f}"
            got = _whole_shape(name, torch.as_tensor(ab[f]).shape, pushed_tp)
            want = _whole_shape(name, getattr(w, f).shape, tp)
            if got != want:
                raise ValueError(
                    f"adapter {k}.{f} is {got}, this worker serves {want} "
                    "(lora_rank mismatch)")
    if pushed_tp != tp:
        blocks = [_tp_block(head, s, tp) for s in range(tp)]
    with torch.no_grad():
        for shard, block in zip(shards, blocks):
            for k, ab in block["layers"].items():
                shard["layers"][k].a.copy_(torch.as_tensor(ab["a"]))
                shard["layers"][k].b.copy_(torch.as_tensor(ab["b"]))
    return wrapped


def num_trainable(params: dict) -> int:
    """Adapter parameter count (what the optimizer updates)."""
    return sum(v.a.numel() + v.b.numel() for v in params["layers"].values()
               if isinstance(v, LoraWeight))
