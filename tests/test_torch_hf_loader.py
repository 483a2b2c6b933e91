"""Hugging Face checkpoints (``polyrl_tpu_torch/models/hf_loader.py``) on
the CPU: the port's own safetensors reader against ``safetensors``
itself, the loader against the JAX package's loader leaf for leaf
(bitwise) and against ``transformers``' logits, and the train and serve
entry points on a local checkpoint directory.

Tiny HF models are built on the spot from a ``transformers`` config and
saved as safetensors, as ``tests/test_hf_loader.py`` does; no weights are
downloaded. Logits against ``transformers``: rtol = atol = 2e-4, the
reference test's bound.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import hf_loader as jhf
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models import hf_loader, quant

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _save_tiny_hf(tmp_path, arch: str, vocab: int = 128, tie: bool = False):
    common = dict(
        vocab_size=vocab, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, max_position_embeddings=256, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=tie, attention_bias=False)
    if arch == "qwen3":
        hf_cfg = transformers.Qwen3Config(**common)
    elif arch == "qwen2":
        common.pop("head_dim")
        common.pop("attention_bias")
        hf_cfg = transformers.Qwen2Config(**common)
    else:
        common.pop("head_dim")
        hf_cfg = transformers.LlamaConfig(**common)
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(hf_cfg).eval()
    with torch.no_grad():  # non-trivial norms and biases
        for layer in model.model.layers:
            layer.input_layernorm.weight.normal_(1.0, 0.1)
            if arch == "qwen2":
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.1)
    out_dir = tmp_path / f"{arch}-{vocab}-{tie}"
    model.save_pretrained(out_dir, safe_serialization=True)
    return model, str(out_dir)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_reader_matches_safe_open(tmp_path, dtype):
    """Every tensor bitwise what ``safetensors.safe_open`` reads, with an
    odd-length header (padding) and metadata; the port's writer read back
    by ``safe_open`` bitwise too."""
    from safetensors import safe_open

    g = torch.Generator().manual_seed(1)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b.weight": torch.randn(7, generator=g).to(dtype),
               "scalar": torch.randn((), generator=g).to(dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt", "k": "v1"})
    with hf_loader.SafetensorsFile(path) as f, safe_open(path, framework="pt") as ref:
        assert sorted(f.keys()) == sorted(ref.keys())
        for k in ref.keys():
            got, want = f.get_tensor(k), ref.get_tensor(k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert torch.equal(got.view(torch.uint8) if got.dim() else got,
                               want.view(torch.uint8) if want.dim() else want), k
    mine = str(tmp_path / "mine.safetensors")
    hf_loader.save_safetensors(mine, tensors)
    with safe_open(mine, framework="pt") as ref:
        for k, t in tensors.items():
            assert torch.equal(ref.get_tensor(k), t), k


def _port_np(params):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in quant.named_leaves(params)}


def _jax_np(params):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        # a QuantWeight's children come as flattened indices: q, then scale
        name = ".".join(("q", "scale")[p.key]
                        if isinstance(p, jax.tree_util.FlattenedIndexKey)
                        else str(p.key) for p in path)
        out[name] = np.asarray(leaf, np.float32 if np.asarray(leaf).dtype
                               != np.int8 else np.int8)
    return out


@pytest.mark.parametrize("arch", ["llama", "qwen3", "qwen2"])
def test_loader_matches_jax_loader(tmp_path, arch):
    """Leaf for leaf bitwise the JAX package's ``load_hf_params`` (same
    names, shapes, values), in f32 and in bf16."""
    _, ckpt = _save_tiny_hf(tmp_path, arch)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jcfg = jhf.config_from_hf(ckpt, dtype=jdt)
        tcfg = hf_loader.config_from_hf(ckpt, dtype=tdt)
        want = _jax_np(jhf.load_hf_params(ckpt, jcfg))
        got = _port_np(hf_loader.load_hf_params(ckpt, tcfg, device="cpu"))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_int8_load_matches_jax_loader(tmp_path):
    """``quantize="int8"``: the projections and the untied head quantized
    on the host as the reference does (q bitwise, scale within an f32
    ulp), norms and embed bitwise."""
    _, ckpt = _save_tiny_hf(tmp_path, "qwen3")
    jcfg = jhf.config_from_hf(ckpt, dtype=jnp.float32)
    want = _jax_np(jhf.load_hf_params(ckpt, jcfg, quantize="int8"))
    tp = hf_loader.load_hf_params(ckpt, hf_loader.config_from_hf(
        ckpt, dtype=torch.float32), quantize="int8", device="cpu")
    assert isinstance(tp["layers"]["w_gate"], quant.QuantWeight)
    assert isinstance(tp["lm_head"], quant.QuantWeight)
    got = _port_np(tp)
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(".scale"):
            ulp = np.spacing(np.abs(want[k]))
            assert np.all(np.abs(got[k] - want[k]) <= ulp), k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ["llama", "qwen3", "qwen2"])
def test_hf_logits_parity(tmp_path, arch):
    """The loaded tree's forward against ``transformers``' own."""
    model, ckpt = _save_tiny_hf(tmp_path, arch)
    cfg = hf_loader.config_from_hf(ckpt, dtype=torch.float32)
    assert cfg.num_layers == 2 and cfg.num_kv_heads == 2
    assert cfg.use_qk_norm == (arch == "qwen3")
    assert cfg.attention_bias == (arch == "qwen2")
    params = hf_loader.load_hf_params(ckpt, cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12))).long()
    with torch.no_grad():
        want = model(ids).logits.numpy()
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12)
    got, _ = tdec.forward(params, cfg, ids, pos, torch.ones(2, 12))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4)


def test_sharded_checkpoint_with_index(tmp_path):
    """A checkpoint in shards with ``model.safetensors.index.json`` (the
    port's writer, the inverse map) loads back bitwise, tied and untied."""
    for tie in (False, True):
        cfg = tdec.get_config("qwen3-1.7b", dtype=torch.bfloat16, num_layers=3,
                              vocab_size=96, hidden_size=32,
                              intermediate_size=48, num_heads=4,
                              num_kv_heads=2, head_dim=8,
                              tie_word_embeddings=tie)
        params = tdec.init_params(torch.Generator().manual_seed(2), cfg)
        d = tmp_path / f"sharded-{tie}"
        hf_loader.save_hf_checkpoint(str(d), params, cfg, n_shards=2)
        assert (d / "model.safetensors.index.json").exists()
        assert len(list(d.glob("model-*-of-00002.safetensors"))) == 2
        cfg2, back = hf_loader.build_from_hf(str(d), dtype=torch.bfloat16,
                                             device="cpu")
        assert cfg2 == cfg
        want = dict(quant.named_leaves(params))
        got = dict(quant.named_leaves(back))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_shape_mismatch_raises(tmp_path):
    _, ckpt = _save_tiny_hf(tmp_path, "llama")
    with pytest.raises((ValueError, KeyError)):
        hf_loader.load_hf_params(ckpt, tdec.get_config("tiny"), device="cpu")


def test_structure_mismatch_raises(tmp_path):
    """A qwen3 checkpoint (qk-norm weights) under a config without
    qk-norm, and an untied head under a tied config, both refuse."""
    import dataclasses

    _, ckpt = _save_tiny_hf(tmp_path, "qwen3")
    cfg = hf_loader.config_from_hf(ckpt, dtype=torch.float32)
    with pytest.raises(ValueError, match="unexpected"):
        hf_loader.load_hf_params(ckpt, dataclasses.replace(cfg, use_qk_norm=False),
                                 device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        hf_loader.load_hf_params(ckpt, dataclasses.replace(
            cfg, tie_word_embeddings=True), device="cpu")


def _write_config(d, **extra):
    cfg_json = {"vocab_size": 100, "hidden_size": 16, "intermediate_size": 32,
                "num_hidden_layers": 1, "num_attention_heads": 2,
                "num_key_value_heads": 1, "rope_theta": 500000.0,
                "model_type": "llama", "tie_word_embeddings": False, **extra}
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg_json))
    return str(d)


def test_config_from_hf_llama3_rope(tmp_path):
    d = _write_config(tmp_path / "l3", rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
    cfg = hf_loader.config_from_hf(d)
    want = jhf.config_from_hf(d)
    assert cfg.rope_scaling is not None and cfg.rope_scaling.factor == 8.0
    np.testing.assert_array_equal(
        tdec._rope_freqs(cfg),
        np.asarray(__import__("polyrl_tpu.models.decoder",
                              fromlist=["_rope_freqs"])._rope_freqs(want)))
    with pytest.raises(NotImplementedError, match="yarn"):
        hf_loader.config_from_hf(_write_config(
            tmp_path / "yarn", rope_scaling={"rope_type": "yarn", "factor": 4.0}))


def test_moe_checkpoint_refused(tmp_path):
    """A Qwen3-MoE or Mixtral config refuses, naming ROADMAP A' 8."""
    for i, extra in enumerate(({"num_experts": 4, "moe_intermediate_size": 8,
                                "model_type": "qwen3_moe"},
                               {"num_local_experts": 4, "model_type": "mixtral"})):
        d = _write_config(tmp_path / f"moe{i}", **extra)
        with pytest.raises(NotImplementedError, match="A' 8"):
            hf_loader.config_from_hf(d)


def test_train_build_model_from_hf(tmp_path):
    """``train._build_model`` with ``model.hf_path`` returns the
    checkpoint's architecture and weights (not the seeded init)."""
    from polyrl_tpu_torch import train as train_mod
    from polyrl_tpu_torch.config import load_config

    _, ckpt = _save_tiny_hf(tmp_path, "llama")
    cfg = load_config(None, [f"model.hf_path={ckpt}", "model.dtype=float32",
                             "device=cpu"])
    mcfg, params = train_mod._build_model(cfg, torch.device("cpu"))
    assert mcfg.vocab_size == 128 and mcfg.num_layers == 2
    rand = tdec.init_params(torch.Generator().manual_seed(0), mcfg)
    assert not torch.allclose(params["embed"], rand["embed"])


def test_train_cli_from_hf_path_on_cpu(tmp_path):
    """``python -m polyrl_tpu_torch.train model.hf_path=... device=cpu``
    trains two GRPO steps on a local checkpoint."""
    _, ckpt = _save_tiny_hf(tmp_path, "qwen3", vocab=512)
    args = [sys.executable, "-m", "polyrl_tpu_torch.train", "device=cpu",
            f"model.hf_path={ckpt}", "model.dtype=float32",
            "rollout.max_slots=16", "rollout.page_size=8",
            "rollout.num_pages=64", "rollout.max_seq_len=64",
            "rollout.prompt_buckets=16", "trainer.train_batch_size=2",
            "trainer.rollout_n=4", "trainer.ppo_mini_batch_size=8",
            "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=8",
            "trainer.max_prompt_length=16", "trainer.max_response_length=16",
            "trainer.total_steps=2", "reward.num_workers=1"]
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[step 2]" in out.stdout
    assert "loaded pretrained weights" in out.stderr


def test_serve_from_hf_dir_matches_preset_engine(tmp_path):
    """``create_server(model=<dir>)`` serves the checkpoint: greedy tokens
    equal to an engine built on the same tree in memory; with
    ``weight_quant="int8"`` it serves the int8 tree."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.serve import create_server

    cfg = tdec.get_config("tiny", dtype=torch.float32)
    params = tdec.init_params(torch.Generator().manual_seed(4), cfg)
    d = str(tmp_path / "tiny-hf")
    hf_loader.save_hf_checkpoint(d, params, cfg, model_type="llama")
    geom = dict(max_slots=4, page_size=8, max_seq_len=64, num_pages=64)
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    eng = CBEngine(cfg, params, device="cpu", prompt_buckets=(16,), **geom)
    want = eng.generate(prompt, sp)[0]["token_ids"]
    eng.stop()
    for wq in ("", "int8"):
        server = create_server(d, device="cpu", dtype="float32", port=0,
                               host="127.0.0.1", prompt_buckets=(16,),
                               weight_quant=wq, **geom)
        try:
            got = server.engine.generate(prompt, sp)[0]["token_ids"]
            wq_leaf = server.engine.params["layers"]["wq"]
            assert isinstance(wq_leaf, quant.QuantWeight) == (wq == "int8")
        finally:
            server.stop()
        if not wq:
            assert got == want
