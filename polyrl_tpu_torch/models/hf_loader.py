"""Load Hugging Face checkpoints (safetensors) into the decoder's tree.

Counterpart of ``polyrl_tpu/models/hf_loader.py``: ``config_from_hf``
(llama, qwen2 and qwen3 families, llama3 rope scaling), ``load_hf_params``
and ``build_from_hf``, the shared recipe of the train and serve entry
points. The name map is the reference's (HF name -> tree path):

- ``model.embed_tokens.weight`` -> ``embed``; ``model.norm.weight`` ->
  ``final_norm``; ``lm_head.weight`` -> ``lm_head`` (transposed to
  [D, V]; absent when the embeddings are tied)
- ``model.layers.{i}.<suffix>`` -> ``layers.<key>[i]`` by ``_LAYER_MAP``;
  the projections are transposed (HF Linear stores [out, in], the decoder
  multiplies ``x @ W``)

Per-layer tensors are written into stacked ``[L, ...]`` leaves allocated
on first sight, so the tree is never held twice. ``quantize="int8"``
quantizes the projections (and an untied ``lm_head``) on the host from the
checkpoint's own dtype, as the reference does, and only the int8 data and
scales go to the device. MoE checkpoints are refused (ROADMAP A' 8).

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
from polyrl_tpu_torch.models.quant import (QUANTIZED_LAYER_KEYS, QuantWeight,
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
_MOE_REFUSAL = ("MoE checkpoints are not ported yet (the MoE half of the "
                "decoder and of quant.py, ROADMAP A' 8)")


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
    """A ModelConfig from the checkpoint's ``config.json`` (llama, qwen2 and
    qwen3 architectures). llama3 rope scaling is read; other scaling types
    are refused (unscaled frequencies would be quietly wrong at long
    context), and so are MoE checkpoints."""
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
    if hf.get("num_experts") or hf.get("num_local_experts"):
        raise NotImplementedError(_MOE_REFUSAL)
    return decoder.ModelConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
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
        if quantize == "int8" and (key in QUANTIZED_LAYER_KEYS or name == "lm_head"):
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
    ``quantize="int8"`` quantizes the projections and an untied
    ``lm_head`` on the host (from the checkpoint's dtype) and moves only
    the int8 tensors and scales. The structure and every shape are checked
    against ``cfg``; a mismatch raises ``ValueError``."""
    from polyrl_tpu_torch.device import resolve_device

    if quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = cfg or config_from_hf(ckpt_dir)
    if cfg.num_experts:
        raise NotImplementedError(_MOE_REFUSAL)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    n_layers = cfg.num_layers
    quantized = quantize == "int8"

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
                    if (suffix.startswith(("mlp.experts.", "block_sparse_moe."))
                            or suffix == "mlp.gate.weight"):
                        raise NotImplementedError(_MOE_REFUSAL)
                    key = _LAYER_MAP.get(suffix)
                    if key is None:
                        raise KeyError(f"unmapped HF layer tensor {name}")
                    if key in _TRANSPOSED:
                        t = t.t()                         # [out, in] -> [in, out]
                    i = int(idx_s)
                    if not 0 <= i < n_layers:
                        raise ValueError(f"{name}: layer {i} outside the "
                                         f"config's {n_layers}")
                    if key not in stacked:
                        # quantized leaves keep the checkpoint's dtype until
                        # they are quantized, as the reference's do
                        keep = quantized and key in QUANTIZED_LAYER_KEYS
                        stacked[key] = torch.empty((n_layers, *t.shape),
                                                   dtype=t.dtype if keep else dtype)
                        filled[key] = set()
                    if tuple(t.shape) != tuple(stacked[key].shape[1:]):
                        raise ValueError(
                            f"{name}: checkpoint shape {tuple(t.shape)} != "
                            f"the other layers' {tuple(stacked[key].shape[1:])}")
                    stacked[key][i].copy_(t)
                    filled[key].add(i)
                else:
                    raise KeyError(f"unmapped HF tensor {name}")

    def to_dev(t, dt=None):
        return t.to(device=dev, dtype=dt or t.dtype)

    layers = {}
    for key in list(stacked):
        missing = sorted(set(range(n_layers)) - filled[key])
        if missing:
            raise ValueError(f"layer tensors missing for {key}: {missing}")
        host = stacked.pop(key)
        if quantized and key in QUANTIZED_LAYER_KEYS:
            qw = quantize_tensor(host, contract_axis=-2)  # on the host
            layers[key] = QuantWeight(to_dev(qw.q), to_dev(qw.scale))
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


def hf_tensors(params: dict, cfg: decoder.ModelConfig) -> dict[str, torch.Tensor]:
    """The inverse of the loader's map: a plain decoder tree as
    ``{HF name: tensor}`` (projections transposed back to [out, in], the
    stacked leaves split per layer; views, no copies)."""
    inv = {v: k for k, v in _LAYER_MAP.items()}
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    for key, w in params["layers"].items():
        for i in range(cfg.num_layers):
            t = w[i]
            out[f"model.layers.{i}.{inv[key]}"] = t.t() if key in _TRANSPOSED else t
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
    the family's schema, ``n_shards`` safetensors shards (with
    ``model.safetensors.index.json`` when more than one). Returns the
    bytes of the shards."""
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
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    tensors = hf_tensors(params, cfg)
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
