"""Load Hugging Face checkpoints (safetensors) into the decoder's tree.

Counterpart of ``polyrl_tpu/models/hf_loader.py``: ``config_from_hf``
(llama, qwen2 and qwen3 families, Qwen3-MoE and Mixtral, llama3 rope
scaling), ``load_hf_params``
and ``build_from_hf``, the shared recipe of the train and serve entry
points. The name map is the reference's (HF name -> tree path):

- ``model.embed_tokens.weight`` -> ``embed``; ``model.norm.weight`` ->
  ``final_norm``; ``lm_head.weight`` -> ``lm_head`` (transposed to
  [D, V]; absent when the embeddings are tied)
- ``model.layers.{i}.<suffix>`` -> ``layers.<key>[i]`` by ``_LAYER_MAP``;
  the projections are transposed (HF Linear stores [out, in], the decoder
  multiplies ``x @ W``)
- MoE: the router ``mlp.gate.weight`` (Mixtral ``block_sparse_moe.gate.
  weight``) -> ``layers.router[i]`` ([E, D] -> [D, E]); expert ``j``'s
  ``mlp.experts.{j}.{gate,up,down}_proj.weight`` (Mixtral
  ``block_sparse_moe.experts.{j}.{w1,w3,w2}.weight``) ->
  ``layers.we_{gate,up,down}[i, j]`` by ``_EXPERT_MAP``, transposed

Per-layer tensors are written into stacked ``[L, ...]`` (experts ``[L,
E, ...]``) leaves allocated on first sight, so the tree is never held
twice. ``quantize="int8"`` quantizes the projections, the experts (one
layer at a time, so that the f32 transient stays one layer's) and an
untied ``lm_head`` on the host from the checkpoint's own dtype, as the
reference does, and only the int8 data and scales go to the device; the
router stays in the model dtype.

The port reads safetensors itself (no ``safetensors`` or ``transformers``
package on the card): an 8-byte little-endian header length, a JSON
header of ``{name: {dtype, shape, data_offsets}}`` (and ``__metadata__``),
padded with spaces, then the raw little-endian data, read through
``numpy.memmap``. bf16 is read as ``uint16`` and viewed as
``torch.bfloat16``. Shards are read one at a time (``_shard_files``, from
``model.safetensors.index.json`` when there is one), so the host holds
about one shard's pages plus the tree.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.quant import (QUANTIZED_EXPERT_KEYS,
                                           QUANTIZED_LAYER_KEYS, QuantWeight,
                                           named_leaves, quantize_tensor)

_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "post_attention_layernorm.weight": "mlp_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "self_attn.q_proj.bias": "bq",  # Qwen2/2.5 attention bias
    "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.bias": "bv",
}
_TRANSPOSED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
# MoE: the router, and the expert projections (Qwen3-MoE
# model.layers.{i}.mlp.experts.{j}.<proj>, Mixtral
# model.layers.{i}.block_sparse_moe.experts.{j}.{w1,w3,w2})
_ROUTER_NAMES = ("mlp.gate.weight", "block_sparse_moe.gate.weight")
_EXPERT_PREFIXES = ("mlp.experts.", "block_sparse_moe.experts.")
_EXPERT_MAP = {
    "gate_proj.weight": "we_gate",
    "up_proj.weight": "we_up",
    "down_proj.weight": "we_down",
    "w1.weight": "we_gate",
    "w3.weight": "we_up",
    "w2.weight": "we_down",
}
# safetensors dtype -> (numpy storage dtype, torch dtype)
_ST_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "F64": (np.dtype("<f8"), torch.float64),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}


# -- safetensors -------------------------------------------------------------------


class SafetensorsFile:
    """One ``.safetensors`` file, read through a read-only ``numpy.memmap``:
    ``keys()`` and ``get_tensor(name)`` (a CPU tensor that owns its data)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n).decode("utf-8"))
        header.pop("__metadata__", None)
        self._header = header
        self._offset = 8 + n
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._mm = None

    def keys(self) -> list[str]:
        return list(self._header)

    def get_tensor(self, name: str) -> torch.Tensor:
        info = self._header[name]
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{self.path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        np_dt, t_dt = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        n_bytes = int(np.prod(shape, dtype=np.int64)) * np_dt.itemsize
        if end - start != n_bytes:
            raise ValueError(f"{self.path}: {name} spans {end - start} bytes, "
                             f"its shape and dtype need {n_bytes}")
        raw = self._mm[self._offset + start:self._offset + end]
        arr = np.array(raw.view(np_dt).reshape(shape))  # own, aligned copy
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t


def _shard_files(ckpt_dir: str) -> list[str]:
    index = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(ckpt_dir, v) for v in weight_map.values()})
    single = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no safetensors checkpoint under {ckpt_dir}")


# -- config ------------------------------------------------------------------------


def config_from_hf(ckpt_dir: str, dtype=torch.bfloat16) -> decoder.ModelConfig:
    """A ModelConfig from the checkpoint's ``config.json`` (llama, qwen2,
    qwen3, Qwen3-MoE and Mixtral architectures). llama3 rope scaling is
    read; other scaling types are refused (unscaled frequencies would be
    quietly wrong at long context), and so are MoE stacks with dense
    layers (``mlp_only_layers``, ``decoder_sparse_step`` other than 1),
    as in the reference. Mixtral routes ``softmax(top_k(logits))``, which
    is softmax over all experts, top-k and renormalisation:
    ``norm_topk_prob=True``, its experts of the dense intermediate size."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    rope_scaling = None
    rs = hf.get("rope_scaling") or {}
    rs_type = rs.get("rope_type", rs.get("type"))
    if rs_type == "llama3":
        rope_scaling = decoder.RopeScaling(
            factor=rs["factor"], low_freq_factor=rs["low_freq_factor"],
            high_freq_factor=rs["high_freq_factor"],
            original_max_position_embeddings=rs["original_max_position_embeddings"])
    elif rs_type not in (None, "default"):
        raise NotImplementedError(
            f"rope_scaling type {rs_type!r} is not supported (llama3 only)")
    moe: dict = {}
    if hf.get("num_experts"):  # Qwen3-MoE family
        if hf.get("mlp_only_layers") or hf.get("decoder_sparse_step", 1) != 1:
            raise NotImplementedError(
                "mixed dense/MoE layer stacks are not supported (uniform "
                "MoE keeps the scan-over-layers body a single trace)")
        moe = dict(num_experts=hf["num_experts"],
                   num_experts_per_tok=hf.get("num_experts_per_tok", 8),
                   moe_intermediate_size=hf["moe_intermediate_size"],
                   norm_topk_prob=bool(hf.get("norm_topk_prob", True)))
    elif hf.get("num_local_experts"):  # Mixtral family
        moe = dict(num_experts=hf["num_local_experts"],
                   num_experts_per_tok=hf.get("num_experts_per_tok", 2),
                   moe_intermediate_size=hf["intermediate_size"],
                   norm_topk_prob=True)
    return decoder.ModelConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        **moe,
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        use_qk_norm="qwen3" in hf.get("model_type", ""),
        attention_bias=bool(hf.get("attention_bias",
                                   hf.get("model_type") == "qwen2")),
        max_position_embeddings=hf.get("max_position_embeddings", 131072),
        dtype=dtype,
    )


# -- weights -----------------------------------------------------------------------


def expected_shapes(cfg: decoder.ModelConfig, quantize: str = "") -> dict:
    """``{leaf name: shape}`` of the tree ``load_hf_params`` must give."""
    out = {}
    for name, (shape, _init) in _flat_specs(decoder.param_specs(cfg)).items():
        key = name.rsplit(".", 1)[-1]
        if quantize == "int8" and (key in QUANTIZED_LAYER_KEYS + QUANTIZED_EXPERT_KEYS
                                   or name == "lm_head"):
            out[f"{name}.q"] = tuple(shape)
            out[f"{name}.scale"] = tuple(shape[:-2]) + (shape[-1],)
        else:
            out[name] = tuple(shape)
    return out


def _flat_specs(specs: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def load_hf_params(ckpt_dir: str, cfg: decoder.ModelConfig | None = None,
                   dtype: torch.dtype | None = None, quantize: str = "",
                   device="cuda") -> dict:
    """A safetensors checkpoint as the decoder tree on ``device`` (the card
    by default; ``"cpu"`` for the host). ``cfg`` defaults to
    ``config_from_hf(ckpt_dir)``, ``dtype`` to ``cfg.dtype``.
    ``quantize="int8"`` quantizes the projections, the experts (a layer
    at a time) and an untied ``lm_head`` on the host (from the
    checkpoint's dtype) and moves only the int8 tensors and scales. The
    structure and every shape are checked against ``cfg``; a mismatch
    raises ``ValueError``."""
    from polyrl_tpu_torch.device import resolve_device

    if quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = cfg or config_from_hf(ckpt_dir)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    n_layers = cfg.num_layers
    quantized = quantize == "int8"
    int8_keys = QUANTIZED_LAYER_KEYS + QUANTIZED_EXPERT_KEYS

    flat: dict[str, torch.Tensor] = {}
    stacked: dict[str, torch.Tensor] = {}
    filled: dict[str, set] = {}
    for path in _shard_files(ckpt_dir):
        with SafetensorsFile(path) as f:
            for name in f.keys():
                t = f.get_tensor(name)
                if name == "model.embed_tokens.weight":
                    flat["embed"] = t
                elif name == "model.norm.weight":
                    flat["final_norm"] = t
                elif name == "lm_head.weight":
                    flat["lm_head"] = t.t()               # [V, D] -> [D, V]
                elif name.startswith("model.layers."):
                    idx_s, suffix = name.split(".", 2)[2].split(".", 1)
                    index = (int(idx_s),)
                    lead = (n_layers,)
                    if suffix in _ROUTER_NAMES:
                        key, t = "router", t.t()          # [E, D] -> [D, E]
                    elif suffix.startswith(_EXPERT_PREFIXES):
                        j_s, proj = suffix.split(".", 3)[2:]
                        key = _EXPERT_MAP.get(proj)
                        if key is None:
                            raise KeyError(f"unmapped HF expert tensor {name}")
                        t = t.t()                         # [out, in] -> [in, out]
                        index += (int(j_s),)
                        lead += (cfg.num_experts,)
                    else:
                        key = _LAYER_MAP.get(suffix)
                        if key is None:
                            raise KeyError(f"unmapped HF layer tensor {name}")
                        if key in _TRANSPOSED:
                            t = t.t()                     # [out, in] -> [in, out]
                    if not all(0 <= x < n for x, n in zip(index, lead)):
                        raise ValueError(f"{name}: index {index} outside the "
                                         f"config's {lead}")
                    if key not in stacked:
                        # quantized leaves keep the checkpoint's dtype until
                        # they are quantized, as the reference's do
                        keep = quantized and key in int8_keys
                        stacked[key] = torch.empty((*lead, *t.shape),
                                                   dtype=t.dtype if keep else dtype)
                        filled[key] = set()
                    inner = tuple(stacked[key].shape[len(lead):])
                    if tuple(t.shape) != inner:
                        raise ValueError(
                            f"{name}: checkpoint shape {tuple(t.shape)} != "
                            f"the other layers' {inner}")
                    stacked[key][index].copy_(t)
                    filled[key].add(index)
                else:
                    raise KeyError(f"unmapped HF tensor {name}")

    def to_dev(t, dt=None):
        return t.to(device=dev, dtype=dt or t.dtype)

    layers = {}
    for key in list(stacked):
        host = stacked.pop(key)
        lead = host.shape[:2] if key in QUANTIZED_EXPERT_KEYS else host.shape[:1]
        missing = sorted({tuple(ix) for ix in np.ndindex(*lead)} - filled[key])
        if missing:
            what = missing if len(lead) == 1 else missing[:8]
            raise ValueError(f"layer tensors missing for {key}: "
                             f"{[ix[0] if len(ix) == 1 else ix for ix in what]}")
        if quantized and key in QUANTIZED_LAYER_KEYS:
            qw = quantize_tensor(host, contract_axis=-2)  # on the host
            layers[key] = QuantWeight(to_dev(qw.q), to_dev(qw.scale))
        elif quantized and key in QUANTIZED_EXPERT_KEYS:
            # one layer's experts at a time on the host
            q = torch.empty(host.shape, dtype=torch.int8)
            scale = torch.empty((*host.shape[:2], host.shape[-1]),
                                dtype=torch.float32)
            for i in range(n_layers):
                qw = quantize_tensor(host[i], contract_axis=-2)
                q[i], scale[i] = qw.q, qw.scale
            layers[key] = QuantWeight(to_dev(q), to_dev(scale))
        else:
            layers[key] = to_dev(host, dtype)
        del host
    missing = [k for k in ("embed", "final_norm") if k not in flat]
    if missing:
        raise ValueError(f"checkpoint structure != config: missing {missing}")
    params = {"embed": to_dev(flat.pop("embed"), dtype),
              "final_norm": to_dev(flat.pop("final_norm"), dtype),
              "layers": layers}
    if "lm_head" in flat:
        head = flat.pop("lm_head")
        if cfg.tie_word_embeddings:
            raise ValueError("checkpoint structure != config: unexpected "
                             "['lm_head'] (the config ties the embeddings)")
        if quantized:
            qw = quantize_tensor(head.contiguous(), contract_axis=0)
            params["lm_head"] = QuantWeight(to_dev(qw.q), to_dev(qw.scale))
        else:
            params["lm_head"] = to_dev(head, dtype)
    elif not cfg.tie_word_embeddings:
        raise ValueError("checkpoint has no lm_head but config does not "
                         "tie word embeddings")
    got = {k: tuple(v.shape) for k, v in named_leaves(params)}
    want = expected_shapes(cfg, quantize)
    if set(got) != set(want):
        raise ValueError(
            f"checkpoint structure != config: missing {sorted(set(want) - set(got))},"
            f" unexpected {sorted(set(got) - set(want))}")
    for k in got:
        if got[k] != want[k]:
            raise ValueError(
                f"{k}: checkpoint shape {got[k]} != config shape {want[k]}")
    return params


def build_from_hf(ckpt_dir: str, dtype=torch.bfloat16,
                  overrides: dict | None = None, quantize: str = "",
                  device="cuda"):
    """``(ModelConfig, params)`` from a local HF checkpoint directory."""
    import dataclasses

    cfg = config_from_hf(ckpt_dir, dtype=dtype)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, load_hf_params(ckpt_dir, cfg, quantize=quantize, device=device)


# -- writing (the inverse map) -----------------------------------------------------


def hf_tensors(params: dict, cfg: decoder.ModelConfig,
               model_type: str = "qwen3") -> dict[str, torch.Tensor]:
    """The inverse of the loader's map: a plain decoder tree as
    ``{HF name: tensor}`` (projections transposed back to [out, in], the
    stacked leaves split per layer and expert; views, no copies). A MoE
    tree takes Qwen3-MoE's names, or Mixtral's with ``model_type``
    ``"mixtral"``."""
    inv = {v: k for k, v in _LAYER_MAP.items()}
    mixtral = model_type == "mixtral"
    moe_prefix = "block_sparse_moe." if mixtral else "mlp."
    inv["router"] = moe_prefix + "gate.weight"
    inv_e = {v: k for k, v in _EXPERT_MAP.items()
             if k.startswith("w") == mixtral}
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    for key, w in params["layers"].items():
        for i in range(cfg.num_layers):
            t = w[i]
            if key in inv_e:
                for j in range(cfg.num_experts):
                    out[f"model.layers.{i}.{moe_prefix}experts.{j}."
                        f"{inv_e[key]}"] = t[j].t()
                continue
            out[f"model.layers.{i}.{inv[key]}"] = (
                t.t() if key in _TRANSPOSED or key == "router" else t)
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t()
    return out


_TORCH_TO_ST = {t: n for n, (_np, t) in _ST_DTYPES.items()}


def save_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> int:
    """Write ``tensors`` as one ``.safetensors`` file (header padded to 8
    bytes, data in name order); returns the bytes written."""
    header, offset, names = {}, 0, sorted(tensors)
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TORCH_TO_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.uint16)
            f.write(t.numpy().data)
    return 8 + len(blob) + offset


def save_hf_checkpoint(ckpt_dir: str, params: dict, cfg: decoder.ModelConfig,
                       model_type: str = "qwen3", n_shards: int = 1) -> int:
    """Write a plain tree as a Hugging Face checkpoint: ``config.json`` in
    the family's schema (a MoE config as ``qwen3_moe`` or ``mixtral``),
    ``n_shards`` safetensors shards (with ``model.safetensors.index.json``
    when more than one). Returns the bytes of the shards."""
    os.makedirs(ckpt_dir, exist_ok=True)
    hf_cfg = {
        "model_type": model_type, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
        "max_position_embeddings": cfg.max_position_embeddings,
        "torch_dtype": str(cfg.dtype).removeprefix("torch."),
    }
    if cfg.rope_scaling is not None:
        s = cfg.rope_scaling
        hf_cfg["rope_scaling"] = {
            "rope_type": "llama3", "factor": s.factor,
            "low_freq_factor": s.low_freq_factor,
            "high_freq_factor": s.high_freq_factor,
            "original_max_position_embeddings": s.original_max_position_embeddings}
    if cfg.num_experts and model_type == "mixtral":
        hf_cfg.update(num_local_experts=cfg.num_experts,
                      num_experts_per_tok=cfg.num_experts_per_tok,
                      intermediate_size=cfg.moe_intermediate_size)
    elif cfg.num_experts:
        hf_cfg.update(num_experts=cfg.num_experts,
                      num_experts_per_tok=cfg.num_experts_per_tok,
                      moe_intermediate_size=cfg.moe_intermediate_size,
                      norm_topk_prob=cfg.norm_topk_prob,
                      decoder_sparse_step=1, mlp_only_layers=[])
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    tensors = hf_tensors(params, cfg, model_type)
    names = sorted(tensors)
    if n_shards <= 1:
        return save_safetensors(os.path.join(ckpt_dir, "model.safetensors"),
                                tensors)
    # split by bytes into n_shards files of about equal size
    total = sum(tensors[n].numel() * tensors[n].element_size() for n in names)
    shards: list[list[str]] = [[]]
    acc = 0
    for name in names:
        if acc >= total * len(shards) / n_shards and len(shards) < n_shards:
            shards.append([])
        shards[-1].append(name)
        acc += tensors[name].numel() * tensors[name].element_size()
    weight_map, written = {}, 0
    for i, group in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        written += save_safetensors(os.path.join(ckpt_dir, fname),
                                    {n: tensors[n] for n in group})
        weight_map.update({n: fname for n in group})
    with open(os.path.join(ckpt_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return written
