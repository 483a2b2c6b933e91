"""int8 weight-only quantization (``polyrl_tpu_torch/models/quant.py``) on
the CPU against the JAX package's ``polyrl_tpu/models/quant.py``.

The same numpy weights go through both (``models/convert.py`` carries the
reference's ``QuantWeight`` across). Tolerances: ``quantize_tensor``'s
``q`` bitwise and its scale within one f32 ulp (the same f32 division and
round-half-even on both sides); products and logits within 5e-4, the JAX
package's own logprob bound between engines (another reduction order of
the same f32 arithmetic); greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.models import quant as jquant
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models import quant
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams

TOL = dict(rtol=5e-4, atol=5e-4)
GEOM = dict(max_slots=8, page_size=8, max_seq_len=96, prompt_buckets=(16, 32),
            num_pages=128)


def _np_tree(seed=0, **over):
    cfg = jdec.get_config("tiny", dtype=jnp.float32, **over)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), cfg))


def _jq(tree):
    """The reference's quantized tree of ``tree``, as numpy leaves."""
    return jax.tree_util.tree_map(
        np.asarray, jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree)))


def _ids(b, t, seed, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return ids, pos, np.ones((b, t), np.float32)


@pytest.mark.parametrize("shape,axis", [((32, 48), 0), ((3, 16, 8), -2),
                                        ((2, 64, 24), -2), ((40, 7), 0)],
                         ids=["2d", "stacked", "wide", "odd"])
def test_quantize_tensor_matches_jax(shape, axis):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w.flat[3] = 0.0  # a zero and an exact half step
    want = jquant.quantize_tensor(jnp.asarray(w), contract_axis=axis)
    got = quant.quantize_tensor(torch.from_numpy(w), contract_axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    ulp = np.spacing(np.abs(np.asarray(want.scale)))
    assert np.all(np.abs(got.scale.numpy() - np.asarray(want.scale)) <= ulp)
    assert int(got.q.abs().max()) <= 127


def test_quantize_tensor_rounds_half_to_even_and_clips():
    """Values on a half step round to even, as ``jnp.round``/``np.rint``."""
    w = torch.tensor([[127.0], [2.5], [-3.5], [0.5], [-127.0]])  # scale ~1
    qw = quant.quantize_tensor(w, contract_axis=0)
    want = jquant.quantize_tensor(w.numpy(), contract_axis=0)
    np.testing.assert_array_equal(qw.q.numpy(), np.asarray(want.q))


def test_quantize_tensor_scale_is_numpys_true_quotient():
    """The host path pinned to the reference's numpy path
    (``polyrl_tpu/models/quant.py:83-89``), bitwise, on column maxima where
    a product with the rounded reciprocal of 127 (what CUDA computes for a
    division by a Python scalar, the port's former divisor) rounds away
    from numpy's true quotient: the port divides by a tensor of 127s."""
    rng = np.random.default_rng(3)
    amax = rng.uniform(0.01, 3.0, 4096).astype(np.float32)
    recip = amax * (np.float32(1) / np.float32(127))
    sel = amax[recip != amax / np.float32(127)][:64]
    assert len(sel) == 64
    w = np.stack([sel, -0.5 * sel, 0.25 * sel])  # column maxima: sel
    want = jquant.quantize_tensor(w, contract_axis=0)  # the numpy branch
    got = quant.quantize_tensor(torch.from_numpy(w), contract_axis=0)
    np.testing.assert_array_equal(got.scale.numpy(), want.scale)
    np.testing.assert_array_equal(got.q.numpy(), want.q)
    assert (got.scale.numpy()
            != sel * (np.float32(1) / np.float32(127)) + np.float32(1e-12)).all()


def test_mm_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 5, 16)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((16, 8)) * 0.02).astype(np.float32)
    jw = jquant.quantize_tensor(jnp.asarray(w), contract_axis=0)
    want = jquant.mm(jnp.asarray(x), jw)
    tw = quant.QuantWeight(torch.from_numpy(np.array(jw.q)),
                           torch.from_numpy(np.array(jw.scale)))
    got = quant.mm(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_keeps_int8_and_f32_scale():
    _cfg, tree = _np_tree()
    t = params_from_numpy(_jq(tree), "cpu", torch.bfloat16)
    wq = t["layers"]["wq"]
    assert isinstance(wq, quant.QuantWeight)
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    assert t["embed"].dtype == torch.bfloat16
    assert isinstance(t["lm_head"], quant.QuantWeight)  # tiny is untied


@pytest.mark.parametrize("remat", [False, True])
def test_quantized_forward_matches_jax(remat):
    """The differentiable forward on the quantized tree, untied int8
    ``lm_head`` included, against the reference's."""
    cfg, tree = _np_tree()
    assert not cfg.tie_word_embeddings
    qtree = _jq(tree)
    ids, pos, mask = _ids(2, 12, 1)
    want, _ = jdec.forward(jax.tree_util.tree_map(jnp.asarray, qtree), cfg,
                           ids, pos, mask)
    tcfg = tdec.get_config("tiny", dtype=torch.float32)
    got, _ = tdec.forward(params_from_numpy(qtree, "cpu"), tcfg,
                          torch.from_numpy(ids), torch.from_numpy(pos),
                          torch.from_numpy(mask), remat=remat)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_quantized_cache_prefill_matches_jax():
    """The cached (prefill) forward on the quantized tree."""
    cfg, tree = _np_tree()
    qtree = _jq(tree)
    ids, pos, _ = _ids(1, 5, 3)
    mask = (np.arange(16) < 5).astype(np.float32)[None]
    want, _ = jdec.forward(jax.tree_util.tree_map(jnp.asarray, qtree), cfg,
                           ids, pos, mask, cache=jdec.make_cache(cfg, 1, 16),
                           write_idx=0)
    tcfg = tdec.get_config("tiny", dtype=torch.float32)
    got, _ = tdec.forward(params_from_numpy(qtree, "cpu"), tcfg,
                          torch.from_numpy(ids), torch.from_numpy(pos),
                          torch.from_numpy(mask),
                          cache=tdec.make_cache(tcfg, 1, 16), write_idx=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unembed_int8_head_bf16_activations():
    """An untied int8 head with bf16 activations: f32 logits equal to the
    f32 product of the bf16 activations with the dequantized head."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32)
                         ).to(torch.bfloat16)
    head = quant.quantize_tensor(torch.from_numpy(
        (rng.standard_normal((16, 40)) * 0.02).astype(np.float32)), contract_axis=0)
    got = tdec.unembed(x, head)
    assert got.dtype == torch.float32 and got.shape == (3, 40)
    want = x.float() @ head.q.float() * head.scale
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_init_quantized_params_equals_quantized_init():
    """Leaf-by-leaf quantized init draws what ``init_params`` draws."""
    for name in ("tiny", "qwen3-1.7b"):
        over = {} if name == "tiny" else dict(num_layers=1, vocab_size=256,
                                              hidden_size=64, intermediate_size=96)
        cfg = tdec.get_config(name, dtype=torch.bfloat16, **over)
        a = quant.quantize_params(tdec.init_params(
            torch.Generator().manual_seed(5), cfg))
        b = quant.init_quantized_params(torch.Generator().manual_seed(5), cfg)
        la, lb = dict(quant.named_leaves(a)), dict(quant.named_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert torch.equal(la[k], lb[k]), (name, k)
        assert ("lm_head.q" in la) == (not cfg.tie_word_embeddings)


def _engines(qtree):
    jcfg = jdec.get_config("tiny", dtype=jnp.float32)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, qtree),
                   kv_cache_dtype=jnp.float32, **GEOM)
    teng = CBEngine(tdec.get_config("tiny", dtype=torch.float32),
                    params_from_numpy(qtree, "cpu"),
                    kv_cache_dtype=torch.float32, device="cpu", **GEOM)
    return jeng, teng


def test_quantized_engine_greedy_matches_jax():
    """The port's CBEngine serving the int8 tree against the JAX engine
    serving the same tree: greedy tokens equal, logprobs within 5e-4."""
    _cfg, tree = _np_tree()
    qtree = _jq(tree)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 13, 24)]
    jeng, teng = _engines(qtree)
    try:
        ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=10))
        out = teng.generate(prompts, SamplingParams(temperature=0.0,
                                                    max_new_tokens=10))
    finally:
        jeng.stop()
        teng.stop()
    for t, j in zip(out, ref):
        assert t["token_ids"] == list(j["token_ids"])
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0,
                                   atol=5e-4)


def test_bf16_push_into_quantized_engine_is_refused():
    """``update_weights`` refuses a tree of other dtypes (``copy_`` would
    truncate bf16 into int8 silently) and other names; a re-quantized
    push installs and bumps the version."""
    _cfg, tree = _np_tree()
    qtree = _jq(tree)
    teng = CBEngine(tdec.get_config("tiny", dtype=torch.float32),
                    params_from_numpy(qtree, "cpu"),
                    kv_cache_dtype=torch.float32, device="cpu", **GEOM)
    plain = params_from_numpy(tree, "cpu")
    try:
        with pytest.raises(ValueError, match="re-quantized"):
            teng.update_weights(plain)  # names differ: w vs w.q / w.scale
        fake = quant.tree_map(lambda t: t, quant.quantize_params(plain))
        fake["layers"]["wq"] = quant.QuantWeight(
            fake["layers"]["wq"].q.to(torch.bfloat16), fake["layers"]["wq"].scale)
        with pytest.raises(ValueError, match="layers.wq.q"):
            teng.update_weights(fake)   # same names, a bf16 q
        assert teng.weight_version == 0
        teng.update_weights(quant.quantize_params(plain))
        assert teng.weight_version == 1
        for k, v in quant.named_leaves(teng.params):
            want = dict(quant.named_leaves(params_from_numpy(qtree, "cpu")))[k]
            assert torch.equal(v, want), k
    finally:
        teng.stop()


def test_int8_server_requantizes_a_push():
    """``create_server(weight_quant="int8")``: the preset made in int8, a
    greedy request served, and a push in the model dtype re-quantized by
    ``weight_preprocess`` before the swap."""
    from polyrl_tpu_torch.rollout.serve import create_server

    server = create_server("tiny", device="cpu", dtype="float32", port=0,
                           host="127.0.0.1", weight_quant="int8",
                           max_slots=4, page_size=8, max_seq_len=64,
                           num_pages=64, prompt_buckets=(16,))
    try:
        eng = server.engine
        assert isinstance(eng.params["layers"]["w_up"], quant.QuantWeight)
        sp = SamplingParams(temperature=0.0, max_new_tokens=6)
        a = eng.generate([[1, 2, 3, 4]], sp)[0]["token_ids"]
        cfg = tdec.get_config("tiny", dtype=torch.float32)
        bf = tdec.init_params(torch.Generator().manual_seed(0), cfg)
        server.update_weights(bf)
        assert eng.weight_version == 1
        b = eng.generate([[1, 2, 3, 4]], sp)[0]["token_ids"]
        assert a == b  # seed 0 again: the same int8 weights
        with pytest.raises(ValueError):
            eng.update_weights(bf)
    finally:
        server.stop()
