"""Decoder parity: the PyTorch port against the JAX decoder on the CPU.

The same numpy weights (``models/convert.py``) and numpy inputs go through
``polyrl_tpu.models.decoder`` and ``polyrl_tpu_torch.models.decoder`` in
f32. Tolerance atol=rtol=1e-4 on logits: both sides compute exact f32
(JAX at "highest" matmul precision, see conftest) and differ only in
reduction order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2)

# name -> (preset, overrides): tiny itself, and small-width variants of
# qwen3 (qk-norm, tied embeddings, explicit head_dim), qwen2.5 (qkv bias)
# and llama3 (rope scaling)
CONFIGS = {
    "tiny": ("tiny", {}),
    "qwen3": ("qwen3-1.7b", dict(SMALL, head_dim=32)),
    "qwen2.5": ("qwen2.5-0.5b", SMALL),
    "llama3-rope": ("llama3-8b", SMALL),
}


def _configs(name):
    preset, over = CONFIGS[name]
    return (jdec.get_config(preset, dtype=jnp.float32, **over),
            tdec.get_config(preset, dtype=torch.float32, **over))


def _weights(jcfg, seed=0):
    """Numpy weight tree; norms and biases randomised so qk-norm and the
    qkv bias are really exercised (init leaves them at ones/zeros)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for k, v in tree["layers"].items():
        if k.endswith("norm") or k.startswith("b"):
            base = 1.0 if k.endswith("norm") else 0.0
            tree["layers"][k] = (base + 0.1 * rng.standard_normal(v.shape)
                                 ).astype(np.float32)
    return tree


def _both(name, seed=0):
    jcfg, tcfg = _configs(name)
    tree = _weights(jcfg, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_numpy(tree, "cpu", torch.float32)


def test_rope_freqs_identical():
    for name in CONFIGS:
        jcfg, tcfg = _configs(name)
        np.testing.assert_array_equal(jdec._rope_freqs(jcfg),
                                      tdec._rope_freqs(tcfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_full_sequence(name):
    jcfg, tcfg, jp, tp = _both(name)
    rng = np.random.default_rng(1)
    b, t = 2, 12
    ids = rng.integers(1, jcfg.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 9:] = 0  # right padding on row 1
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    jl, _ = jdec.forward(jp, jcfg, ids, pos, mask)
    tl, _ = tdec.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **TOL)
    np.testing.assert_allclose(tl.numpy()[1, :9], np.asarray(jl)[1, :9], **TOL)


def _pools_np(pools):
    return [np.stack([np.asarray(a) for a in side]) for side in pools]


def _prefill_both(name, ps=8, n_pages=32):
    """Batched prefill of two prompts into pages on both sides."""
    jcfg, tcfg, jp, tp = _both(name)
    rng = np.random.default_rng(2)
    lens = np.array([13, 7], np.int32)
    pb = 16
    ids = np.zeros((2, pb), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, jcfg.vocab_size, n)
    page_ids = np.array([[3, 5], [9, 0]], np.int32)
    jpools = jdec.make_paged_pools(jcfg, n_pages, ps, dtype=jnp.float32)
    tpools = tdec.make_paged_pools(tcfg, n_pages, ps, dtype=torch.float32)
    jpools, jl = jdec.prefill_batch_into_pages(jp, jcfg, ids, lens, jpools,
                                               page_ids)
    tpools, tl = tdec.prefill_batch_into_pages(
        tp, tcfg, torch.from_numpy(ids), torch.from_numpy(lens), tpools,
        torch.from_numpy(page_ids))
    return (jcfg, tcfg, jp, tp, jpools, tpools, np.asarray(jl), tl.numpy(),
            ids, lens)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_with_cache_into_pages(name):
    """``forward`` with a cache and ``logits_for`` (the prefill path):
    last-token logits and the KV scattered into the pools agree."""
    (_jc, _tc, _jp, _tp, jpools, tpools, jl, tl, _ids,
     _lens) = _prefill_both(name)
    np.testing.assert_allclose(tl, jl, **TOL)
    for a, b in zip(_pools_np(jpools), _pools_np(tpools)):
        np.testing.assert_allclose(b[:, :, 1:], a[:, :, 1:], **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_paged_decode_steps(name):
    """Three paged decode steps after the prefill (plain attention and
    KV-write versions on the CPU) match the JAX decode logits."""
    (jcfg, tcfg, jp, tp, jpools, tpools, _jl, _tl, _ids,
     lens) = _prefill_both(name)
    table = np.array([[3, 5, 6, 0], [9, 10, 0, 0]], np.int32)
    rng = np.random.default_rng(3)
    seq = lens.copy()
    for _ in range(3):
        tok = rng.integers(1, jcfg.vocab_size, 2).astype(np.int32)
        active = np.array([True, True])
        jl, jpools = jdec.forward_paged_decode(jp, jcfg, tok, seq, jpools,
                                               table, seq, active=active)
        tl, tpools = tdec.forward_paged_decode(
            tp, tcfg, torch.from_numpy(tok), torch.from_numpy(seq), tpools,
            torch.from_numpy(table), torch.from_numpy(seq),
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        seq = seq + 1
    for a, b in zip(_pools_np(jpools), _pools_np(tpools)):
        np.testing.assert_allclose(b[:, :, 1:], a[:, :, 1:], **TOL)


@pytest.mark.parametrize("name", ["tiny", "qwen3"])
def test_prefill_suffix_batch(name):
    """Suffix prefill over cached prefix pages (the sibling-attach path)."""
    (jcfg, tcfg, jp, tp, jpools, tpools, _jl, _tl, ids,
     _lens) = _prefill_both(name)
    rng = np.random.default_rng(4)
    sfx = np.zeros((2, 8), np.int32)
    sfx_lens = np.array([5, 3], np.int32)
    for i, n in enumerate(sfx_lens):
        sfx[i, :n] = rng.integers(1, jcfg.vocab_size, n)
    prefix_pages = np.array([[3], [3]], np.int32)  # row 0's first page
    sfx_pages = np.array([[20], [21]], np.int32)
    jpools, jl = jdec.prefill_suffix_batch_into_pages(
        jp, jcfg, sfx, sfx_lens, 8, jpools, prefix_pages, sfx_pages)
    tpools, tl = tdec.prefill_suffix_batch_into_pages(
        tp, tcfg, torch.from_numpy(sfx), torch.from_numpy(sfx_lens), 8, tpools,
        torch.from_numpy(prefix_pages), torch.from_numpy(sfx_pages))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(_pools_np(jpools), _pools_np(tpools)):
        np.testing.assert_allclose(b[:, :, 1:], a[:, :, 1:], **TOL)


def test_params_from_numpy_keeps_names_and_shapes():
    jcfg, tcfg = _configs("qwen3")
    tree = _weights(jcfg)
    tp = params_from_numpy(tree, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(0)
    native = tdec.init_params(gen, tcfg)

    def shapes(t):
        return {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))
                for k, v in t.items()}

    assert shapes(tp) == shapes(native)
    assert shapes(native) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), tree)


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the conversion defaults to the
    card and raises when CUDA is absent instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"embed": np.ones((4, 2), np.float32),
            "layers": {"w": np.zeros((2, 3), np.float32)}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree)
    tp = params_from_numpy(tree, "cpu")
    assert tp["layers"]["w"].device.type == "cpu" and tp["embed"].shape == (4, 2)
