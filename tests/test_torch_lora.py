"""LoRA (``polyrl_tpu_torch/models/lora.py`` and the actor's LoRA path) on
the CPU against the JAX package's ``polyrl_tpu/models/lora.py``.

A ``torch.Generator`` draws other adapters than ``jax.random``, so the
parity tests convert the reference's wrapped tree (``models/convert.py``)
or copy its adapters into the port's actor. Tolerances: ``merge_lora``
1e-6 (the same f32 product and sum); the wrapped forward 5e-4 (the
engines' logprob bound); adapter gradients rtol 1e-4 / atol 1e-6;
adapters after one AdamW step atol 1e-6 (the actor parity bound).
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.models import lora as jlora
from polyrl_tpu.models import quant as jquant
from polyrl_tpu.trainer import actor as jactor
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models import lora, quant
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.trainer import actor as tactor
from polyrl_tpu_torch.utils import checkpoint as ckpt_lib

TOL = dict(rtol=5e-4, atol=5e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfgs():
    return (jdec.get_config("tiny", dtype=jnp.float32),
            tdec.get_config("tiny", dtype=torch.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jwrapped(quantized=False, rank=4, alpha=16.0, b_scale=0.01):
    """The reference's wrapped tiny tree (numpy leaves), ``b`` set to a
    non-zero pattern so the adapters matter."""
    jcfg, _ = _cfgs()
    params = jdec.init_params(jax.random.PRNGKey(0), jcfg)
    if quantized:
        params = jquant.quantize_params(params)
    # f32 adapters over the int8 base too (the reference's default there
    # is bf16; the conversion widens bf16 to f32)
    wrapped = jlora.wrap_lora(params, jax.random.PRNGKey(1), rank=rank,
                              alpha=alpha, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    layers = dict(wrapped["layers"])
    for k, w in layers.items():
        if isinstance(w, jquant.LoraWeight):
            b = (rng.standard_normal(w.b.shape) * b_scale).astype(np.float32)
            layers[k] = jquant.LoraWeight(w.base, w.a, jnp.asarray(b), w.alpha)
    wrapped["layers"] = layers
    return _np(wrapped)


def _ids(b=2, t=10, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (b, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return ids, pos, np.ones((b, t), np.float32)


def _jforward(tree, ids, pos, mask, remat=False):
    jcfg, _ = _cfgs()
    out, _ = jdec.forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                          ids, pos, mask, remat=remat)
    return np.asarray(out)


def _tforward(tree, ids, pos, mask, remat=False):
    _, tcfg = _cfgs()
    out, _ = tdec.forward(tree, tcfg, torch.from_numpy(ids),
                          torch.from_numpy(pos), torch.from_numpy(mask),
                          remat=remat)
    return out


def test_wrap_is_exact_noop_at_init():
    """b = 0: the wrapped model computes the base model; the adapters are
    drawn from the generator (seeded draws repeat) at N(0, 1/r)."""
    _, tcfg = _cfgs()
    params = tdec.init_params(torch.Generator().manual_seed(0), tcfg)
    w1 = lora.wrap_lora(params, torch.Generator().manual_seed(7), rank=4)
    w2 = lora.wrap_lora(params, torch.Generator().manual_seed(7), rank=4)
    assert isinstance(w1["layers"]["wq"], quant.LoraWeight)
    assert torch.equal(w1["layers"]["w_up"].a, w2["layers"]["w_up"].a)
    assert float(w1["layers"]["w_gate"].a.std()) == pytest.approx(0.5, rel=0.1)
    ids, pos, mask = _ids()
    ref = _tforward(params, ids, pos, mask)
    got = _tforward(w1, ids, pos, mask)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    n = lora.num_trainable(w1)
    total = sum(t.numel() for _, t in quant.named_leaves(params))
    L, d, f = tcfg.num_layers, tcfg.hidden_size, tcfg.intermediate_size
    hq, hkv, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim_
    ins_outs = [(d, hq * hd), (d, hkv * hd), (d, hkv * hd), (hq * hd, d),
                (d, f), (d, f), (f, d)]
    assert n == L * 4 * sum(i + o for i, o in ins_outs) and 0 < n < 0.2 * total


@pytest.mark.parametrize("quantized", [False, True], ids=["lora", "qlora"])
def test_merge_and_wrapped_forward_match_jax(quantized):
    """The converted wrapped tree: ``merge_lora`` within 1e-6 of the
    reference's, the wrapped forward within 5e-4 of the reference's, and
    the merged tree's forward within 5e-4 of the wrapped one's. Over an
    int8 base (QLoRA) the merge dequantizes."""
    jtree = _jwrapped(quantized)
    ttree = params_from_numpy(jtree, "cpu")
    wq = ttree["layers"]["wq"]
    assert isinstance(wq, quant.LoraWeight) and wq.alpha == 16.0
    assert isinstance(wq.base, quant.QuantWeight) == quantized
    jm = _np(jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, jtree)))
    tm = lora.merge_lora(ttree)
    assert not isinstance(tm["layers"]["wq"], quant.LoraWeight)
    for k, v in tm["layers"].items():
        np.testing.assert_allclose(v.numpy(), jm["layers"][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    ids, pos, mask = _ids()
    want = _jforward(jtree, ids, pos, mask)
    got = _tforward(ttree, ids, pos, mask).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    merged = _tforward(tm, ids, pos, mask).detach().numpy()
    np.testing.assert_allclose(merged, got, **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["lora", "qlora"])
@pytest.mark.parametrize("remat", [False, True])
def test_adapter_gradients_match_jax(quantized, remat):
    """The gradient of a loss over the wrapped forward with respect to
    every adapter, against ``jax.grad``; the base gets none (no
    ``requires_grad``, and ``mm`` detaches it even when it has one)."""
    jtree = _jwrapped(quantized)
    ids, pos, mask = _ids(seed=5)
    jcfg, tcfg = _cfgs()

    def jloss(p):  # the reference test's loss (tests/test_lora.py)
        logits, _ = jdec.forward(p, jcfg, ids, pos, mask, remat=remat)
        return jnp.mean(jax.nn.log_softmax(logits)[..., 1])

    jg = jax.grad(jloss, allow_int=True)(
        jax.tree_util.tree_map(jnp.asarray, jtree))
    ttree = params_from_numpy(jtree, "cpu")
    for k, w in ttree["layers"].items():
        if isinstance(w, quant.LoraWeight):
            w.a.requires_grad_(True)
            w.b.requires_grad_(True)
            if not quantized:
                w.base.requires_grad_(True)  # mm must still stop it
    logits = _tforward(ttree, ids, pos, mask, remat)
    torch.log_softmax(logits, -1)[..., 1].mean().backward()
    n = 0
    for k, w in ttree["layers"].items():
        if not isinstance(w, quant.LoraWeight):
            continue
        jw = jg["layers"][k]
        np.testing.assert_allclose(w.a.grad.numpy(), np.asarray(jw.a),
                                   err_msg=f"{k}.a", **GRAD_TOL)
        np.testing.assert_allclose(w.b.grad.numpy(), np.asarray(jw.b),
                                   err_msg=f"{k}.b", **GRAD_TOL)
        base_t = w.base.q if quantized else w.base
        assert base_t.grad is None, k
        n += 1
    assert n == 7


def _lora_batch(seed=0, b=4, tp=8, tr=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (b, tp + tr)).astype(np.int32)
    mask = np.ones((b, tp + tr), np.float32)
    resp_mask = np.ones((b, tr), np.float32)
    resp_mask[0, 4:] = 0
    mask[0, tp + 4:] = 0
    pos = np.maximum(mask.cumsum(-1) - 1, 0).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "attention_mask": mask,
            "responses": ids[:, tp:].copy(), "response_mask": resp_mask,
            "advantages": (rng.standard_normal((b, tr)) * resp_mask).astype(np.float32),
            "old_log_probs": (-6.2 + 0.1 * rng.standard_normal((b, tr))).astype(np.float32),
            "ref_log_probs": (-6.2 + 0.1 * rng.standard_normal((b, tr))).astype(np.float32)}


@pytest.mark.parametrize("remat", [False, True])
def test_lora_actor_update_matches_jax(remat):
    """Two micros and one AdamW step of a LoRA actor (KL loss, a clip that
    bites, weight decay): metrics, grad norm and every adapter after the
    step against the JAX actor's, frozen leaves bitwise unchanged, and
    only the adapters holding optimizer state."""
    jcfg, tcfg = _cfgs()
    tree = _np(jdec.init_params(jax.random.PRNGKey(0), jcfg))
    kw = dict(lr=1e-3, remat=remat, lora_rank=4, lora_alpha=8.0,
              use_kl_loss=True, kl_loss_coef=0.1, max_grad_norm=0.05,
              weight_decay=0.1)
    ja = jactor.StreamActor(jcfg, jactor.ActorConfig(**kw),
                            jax.tree_util.tree_map(jnp.asarray, tree))
    ta = tactor.StreamActor(tcfg, tactor.ActorConfig(**kw),
                            params_from_numpy(tree, "cpu"))
    with torch.no_grad():  # the reference's adapters into the port's actor
        for k, w in ta.params["layers"].items():
            if isinstance(w, quant.LoraWeight):
                w.a.copy_(torch.from_numpy(np.array(ja.params["layers"][k].a)))
    assert {n for n, _ in ta._named} == {
        f"layers.{k}.{ab}" for k in lora.DEFAULT_TARGETS for ab in "ab"}
    assert len(ta.opt_state.mu) == 14
    frozen0 = {n: p.clone() for n, p in ta._frozen}
    for i, is_opt in enumerate((False, True)):
        bt = _lora_batch(20 + i)
        jm = ja.update_stream(bt, is_opt_step=is_opt, loss_scale=0.5)
        tm = ta.update_stream(bt, is_opt_step=is_opt, loss_scale=0.5)
        for k in jm:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert tm["actor/grad_norm"] > 0.05  # the clip was exercised
    for k, w in ta.params["layers"].items():
        if isinstance(w, quant.LoraWeight):
            jw = ja.params["layers"][k]
            np.testing.assert_allclose(w.a.detach().numpy(), np.asarray(jw.a),
                                       rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(w.b.detach().numpy(), np.asarray(jw.b),
                                       rtol=0, atol=1e-6, err_msg=k)
            assert float(w.b.detach().abs().max()) > 0
    for n, p in ta._frozen:
        assert torch.equal(p, frozen0[n]), n
        assert p.grad is None and not p.requires_grad, n
    merged = ta.export_params()
    assert not any(isinstance(v, quant.LoraWeight)
                   for v in merged["layers"].values())


def test_lora_grpo_fit_on_cbengine():
    """A colocated GRPO fit with a LoRA actor on ``CBEngine(device="cpu")``
    (the reference's ``test_lora_grpo_e2e_fit_and_push``): the base
    bitwise unchanged, the adapters moved, and the engine after the push
    equal to ``merge_lora(actor.params)``, holding no wrapper."""
    from polyrl_tpu_torch.data.dataset import PromptDataLoader, make_arithmetic_dataset
    from polyrl_tpu_torch.rewards.manager import load_reward_manager
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.trainer.actor import ActorConfig, ReferencePolicy, StreamActor
    from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
    from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = tdec.get_config("tiny", dtype=torch.float32, vocab_size=512,
                          max_position_embeddings=128)
    params = tdec.init_params(torch.Generator().manual_seed(0), cfg)
    tok = ByteTokenizer()
    engine = CBEngine(cfg, params, pad_token_id=tok.pad_token_id, max_slots=8,
                      page_size=8, max_seq_len=32, prompt_buckets=(16,),
                      num_pages=64, kv_cache_dtype=torch.float32, device="cpu")
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4, max_prompt_length=16,
        max_response_length=8, adv_estimator="grpo", total_steps=1)
    ref = ReferencePolicy(cfg, params)
    actor = StreamActor(cfg, ActorConfig(lr=1e-2, remat=False, lora_rank=4,
                                         use_kl_loss=True, entropy_coeff=0.01),
                        params)
    base0 = actor.params["layers"]["wq"].base.clone()
    trainer = StreamRLTrainer(
        tcfg, actor, engine, tok, load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(32), tcfg.train_batch_size),
        ref_policy=ref)
    try:
        hist = trainer.fit()
    finally:
        engine.stop()
    assert len(hist) == 1 and np.isfinite(hist[0]["actor/pg_loss"])
    wq = actor.params["layers"]["wq"]
    assert isinstance(wq, quant.LoraWeight)
    assert torch.equal(wq.base, base0)
    assert float(wq.b.detach().abs().max()) > 0.0
    assert engine.weight_version == 2
    assert not any(isinstance(v, quant.WRAPPERS)
                   for v in engine.params["layers"].values())
    merged = lora.merge_lora(actor.params)
    for name, v in quant.named_leaves(engine.params):
        assert torch.equal(v, dict(quant.named_leaves(merged))[name].detach()), name


def test_lora_checkpoint_roundtrip(tmp_path):
    """A LoRA tree over an int8 base saved and restored: the wrapper
    types, ``alpha`` and the int8 base survive (the reference's
    ``test_lora_checkpoint_roundtrip``)."""
    _, tcfg = _cfgs()
    params = tdec.init_params(torch.Generator().manual_seed(0), tcfg)
    wrapped = lora.wrap_lora(quant.quantize_params(params),
                             torch.Generator().manual_seed(1), rank=4, alpha=24.0)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, {"actor": {"params": wrapped}})
    mgr.wait()
    items, _meta = mgr.restore(3)
    back = ckpt_lib.unflatten_tree(items["actor"])["params"]
    wq = back["layers"]["wq"]
    assert isinstance(wq, quant.LoraWeight) and wq.alpha == 24.0
    assert isinstance(wq.base, quant.QuantWeight) and wq.base.q.dtype == torch.int8
    assert isinstance(back["lm_head"], quant.QuantWeight)
    want = dict(quant.named_leaves(wrapped))
    got = dict(quant.named_leaves(back))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_lora_actor_state_roundtrip_checks_alpha():
    """The actor's state carries the frozen leaves, the adapters' moments
    and ``alpha``; loading it into an actor of another alpha raises."""
    _, tcfg = _cfgs()
    params = tdec.init_params(torch.Generator().manual_seed(0), tcfg)
    a = tactor.StreamActor(tcfg, tactor.ActorConfig(lora_rank=4, remat=False),
                           quant.tree_map(torch.clone, params))
    state = {k: v.clone() for k, v in a.state_dict().items()}
    assert "params.layers.wq.alpha" in state and "opt.mu.layers.wq.a" in state
    assert "opt.mu.layers.wq.base" not in state and "params.embed" in state
    b = tactor.StreamActor(tcfg, tactor.ActorConfig(lora_rank=4, remat=False),
                           quant.tree_map(torch.clone, params))
    b.load_state_dict(state)
    c = tactor.StreamActor(tcfg, tactor.ActorConfig(lora_rank=4, lora_alpha=32.0,
                                                    remat=False),
                           quant.tree_map(torch.clone, params))
    with pytest.raises(ValueError, match="alpha"):
        c.load_state_dict(state)


def _wrapped_pair():
    _, tcfg = _cfgs()
    params = tdec.init_params(torch.Generator().manual_seed(0), tcfg)
    return tcfg, params


def test_adapter_alpha_mismatch_rejected():
    _, params = _wrapped_pair()
    worker = lora.wrap_lora(params, torch.Generator().manual_seed(9), rank=4,
                            alpha=16.0)
    trainer = lora.wrap_lora(params, torch.Generator().manual_seed(9), rank=4,
                             alpha=32.0)
    with pytest.raises(ValueError, match="lora_alpha mismatch"):
        lora.apply_adapters(worker, lora.extract_adapters(trainer))


def test_adapter_base_mismatch_rejected():
    """A worker whose frozen base differs from the trainer's (the
    ``base_stats`` fingerprint) and one with other targets both refuse."""
    _, params = _wrapped_pair()
    other = dict(params, layers={k: (v * 2.0 if k == "wq" else v)
                                 for k, v in params["layers"].items()})
    worker = lora.wrap_lora(other, torch.Generator().manual_seed(9), rank=4)
    trainer = lora.wrap_lora(params, torch.Generator().manual_seed(9), rank=4)
    with pytest.raises(ValueError, match="base mismatch"):
        lora.apply_adapters(worker, lora.extract_adapters(trainer))
    fewer = lora.wrap_lora(params, torch.Generator().manual_seed(9), rank=4,
                           targets=("wq", "wk"))
    with pytest.raises(ValueError, match="target sets"):
        lora.apply_adapters(fewer, lora.extract_adapters(trainer))


def test_extract_apply_and_template_match_jax_layout():
    """``extract_adapters`` of a trained tree installs into a fresh
    wrapped tree over the same base (serving then equals the trainer's
    merge), and ``adapter_template`` has the reference's shapes."""
    tcfg, params = _wrapped_pair()
    trainer = lora.wrap_lora(params, torch.Generator().manual_seed(9), rank=4)
    trainer["layers"]["wq"].b.fill_(0.05)
    worker = lora.wrap_lora(params, torch.Generator().manual_seed(2), rank=4)
    served = lora.apply_adapters(worker, lora.extract_adapters(trainer))
    for k, v in lora.merge_lora(served)["layers"].items():
        assert torch.equal(v, lora.merge_lora(trainer)["layers"][k]), k
    jcfg, _ = _cfgs()
    jt = jlora.adapter_template(jcfg, 4)
    tt = lora.adapter_template(tcfg, 4)
    for k, ab in jt["layers"].items():
        for f in ("a", "b"):
            assert tuple(tt["layers"][k][f].shape) == tuple(ab[f].shape), (k, f)
    assert tuple(tt["base_stats"].shape) == tuple(jt["base_stats"].shape)
    np.testing.assert_allclose(
        lora.base_stats(params_from_numpy(_jwrapped(), "cpu")).numpy(),
        np.asarray(jlora.base_stats(jax.tree_util.tree_map(jnp.asarray, _jwrapped()))),
        rtol=1e-6)


# -- delta sync (trainer.weight_sync=lora_delta, serve --lora-rank) ----------


class _PortRx:
    """A receiver whose bytes have landed: the port's install streams each
    entry through ``on_tensor``."""

    def __init__(self, buf, layout):
        self.buffer, self.layout = buf, layout

    def wait_for_version(self, v, timeout=0.0, on_tensor=None):
        for e in self.layout.entries:
            on_tensor(e, self.buffer[e.offset: e.offset + e.nbytes])
        return v

    def health(self):
        return {}

    def stop(self):
        pass


def test_adapter_delta_sync_server_path():
    """One adapter push at the server boundary, both packages on the same
    QLoRA serving tree (int8 base, f32 adapters with ``b = 0``) and the
    same trained adapters: the wire carries only the adapter layout (a
    fifth of the full tree at most); the port's server copies ``a``/``b``
    into the live tensors (every leaf keeps its ``data_ptr()``, the int8
    base bitwise untouched, ``weight_version`` raised); afterwards the
    port server's greedy tokens equal the JAX server's, logprobs within
    5e-4, and differ from before the push."""
    from polyrl_tpu.models.lora import adapter_template as j_template
    from polyrl_tpu.models.lora import apply_adapters as j_apply
    from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP
    from polyrl_tpu.rollout.server import RolloutServer as JServer
    from polyrl_tpu.transfer import layout as jlayout
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.server import RolloutServer
    from polyrl_tpu_torch.transfer import layout as tlayout

    jcfg, tcfg = _cfgs()
    served_np = _jwrapped(quantized=True, b_scale=0.0)
    trained_np = _jwrapped(quantized=False, b_scale=0.05)
    geom = dict(pad_token_id=0, max_slots=4, page_size=8, max_seq_len=64,
                prompt_buckets=(8,), num_pages=64)
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5]]

    # the JAX server, as the reference's test drives it
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, served_np),
                   kv_cache_dtype=jnp.float32, **geom)
    jsrv = JServer(jeng, host="127.0.0.1", port=0)
    jtmpl = j_template(jcfg, rank=4, dtype=jnp.float32)
    jsrv.weight_template, jsrv.weight_apply = jtmpl, j_apply
    jl = jlayout.build_layout(jtmpl)
    jbuf = jlayout.alloc_buffer(jl)
    jlayout.pack_params(jlora.extract_adapters(
        jax.tree_util.tree_map(jnp.asarray, trained_np)), jl, jbuf)
    jsrv.receiver = types.SimpleNamespace(
        buffer=jbuf, layout=jl, stop=lambda: None,
        wait_for_version=lambda v, timeout=0.0: None)

    # the port's server
    teng = CBEngine(tcfg, params_from_numpy(served_np, "cpu"),
                    kv_cache_dtype=torch.float32, device="cpu", **geom)
    tsrv = RolloutServer(teng, host="127.0.0.1", port=0)
    ttmpl = lora.adapter_template(tcfg, 4, dtype=torch.float32)
    tsrv.weight_template, tsrv.weight_apply = ttmpl, lora.apply_adapters
    tl = tlayout.build_layout(ttmpl)
    assert tl.total_bytes < tlayout.build_layout(
        tdec.init_meta_params(tcfg)).total_bytes / 5
    assert tl.total_bytes == jl.total_bytes
    tbuf = tlayout.alloc_buffer(tl)
    tlayout.pack_params(lora.extract_adapters(
        params_from_numpy(trained_np, "cpu")), tl, tbuf)
    # the same wire: entries, and bytes but for the fingerprint's f32
    # means (another reduction order)
    assert [(e.name, tuple(e.shape), e.offset) for e in tl.entries] == [
        (e.name, tuple(e.shape), e.offset) for e in jl.entries]
    for e in tl.entries:
        if e.name != "base_stats":
            np.testing.assert_array_equal(
                tbuf[e.offset: e.offset + e.nbytes],
                jbuf[e.offset: e.offset + e.nbytes], err_msg=e.name)
    tsrv.receiver = _PortRx(tbuf, tl)
    try:
        jsrv.start()
        tsrv.start()
        sp = SamplingParams(temperature=0.0, max_new_tokens=6,
                            stop_token_ids=())
        jsp = JSP(temperature=0.0, max_new_tokens=6, stop_token_ids=())
        before = teng.generate(prompts, sp)
        ptrs = {n: t.data_ptr() for n, t in quant.named_leaves(teng.params)}
        base_q = teng.params["layers"]["wq"].base.q.clone()
        ok, err = tsrv.update_weights_from_agent(4)
        assert ok, err
        ok, err = jsrv.update_weights_from_agent(4)
        assert ok, err
        assert teng.weight_version == 4
        assert {n: t.data_ptr() for n, t in
                quant.named_leaves(teng.params)} == ptrs
        assert torch.equal(teng.params["layers"]["wq"].base.q, base_q)
        want = params_from_numpy(trained_np, "cpu")
        for k, w in teng.params["layers"].items():
            if isinstance(w, quant.LoraWeight):
                assert torch.equal(w.a, want["layers"][k].a), k
                assert torch.equal(w.b, want["layers"][k].b), k
        after = teng.generate(prompts, sp)
        ref = jeng.generate(prompts, jsp, timeout=120.0)
        assert [o["token_ids"] for o in after] != [o["token_ids"]
                                                   for o in before]
        for got, r in zip(after, ref):
            assert list(got["token_ids"]) == list(r["token_ids"])
            np.testing.assert_allclose(got["logprobs"], r["logprobs"],
                                       rtol=0, atol=5e-4)
    finally:
        tsrv.stop()
        jsrv.stop()


def test_lora_delta_config_guards():
    """The reference's delta-sync checks, before any manager is spawned:
    colocated rollout, ``lora_rank`` 0 and the hybrid are refused."""
    from polyrl_tpu_torch import train
    from polyrl_tpu_torch.config import load_config

    base = ["device=cpu", "model.dtype=float32",
            "trainer.weight_sync=lora_delta"]
    cases = [(["actor.lora_rank=4"], NotImplementedError, "disaggregated"),
             (["rollout.mode=disaggregated"], ValueError, "lora_rank>0"),
             (["rollout.mode=disaggregated", "actor.lora_rank=4",
               "rollout.colocated_local=true"], NotImplementedError,
              "colocated_local")]
    for extra, exc, match in cases:
        cleanup: list = []
        with pytest.raises(exc, match=match):
            train.build_trainer(load_config(None, base + extra), cleanup)
        assert cleanup == []  # nothing was spawned


def test_lora_delta_fit_through_the_fabric():
    """A LoRA trainer with ``weight_sync=lora_delta`` pushes only adapters
    over the fabric to a ``lora_rank`` server: each push's layout is the
    adapter tree's bytes; after the fit the server's ``a``/``b`` equal the
    actor's bitwise, its bases bitwise the seeded base, every leaf at its
    old address; greedy through the manager equals an in-process engine on
    the same wrapped tree, logprobs within 5e-4."""
    from polyrl_tpu_torch import train
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.manager.client import (ManagerClient,
                                                 spawn_rollout_manager)
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.serve import (create_server,
                                                register_with_manager)

    proc, port = spawn_rollout_manager(
        "127.0.0.1:0", extra_args=["--health-check-interval-s", "0.1",
                                   "--stats-poll-interval-s", "0.2"])
    geom = dict(max_slots=8, page_size=8, max_seq_len=256, num_pages=128,
                prompt_buckets=(16, 32))
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", seed=3, lora_rank=4,
                        lora_alpha=16.0, **geom)
    base = {n: t.clone() for n, t in quant.named_leaves(srv.engine.params)
            if not n.endswith((".a", ".b"))}
    ptrs = {n: t.data_ptr() for n, t in quant.named_leaves(srv.engine.params)}
    cleanup: list = []
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        ep = mgr.endpoint.replace("http://", "")
        cfg = load_config(None, [
            "device=cpu", "model.preset=tiny", "model.dtype=float32",
            "rollout.mode=disaggregated", f"rollout.manager_endpoint={ep}",
            "rollout.transfer_streams=2", "trainer.train_batch_size=4",
            "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=8",
            "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
            "trainer.max_prompt_length=16", "trainer.max_response_length=8",
            "trainer.total_steps=2", "trainer.seed=3",
            "trainer.weight_sync=lora_delta", "actor.lora_rank=4",
            "actor.lora_alpha=16", "actor.lr=1e-2", "actor.remat=false",
            "data.arithmetic_size=16"])
        trainer = train.build_trainer(
            cfg, cleanup, compute_score=lambda src, text, gt, extra: float(
                len(text.encode("utf-8"))))
        want_bytes = sum(t.numel() * t.element_size() for _, t in
                         quant.named_leaves(lora.adapter_template(
                             srv.engine.cfg, 4)))
        # the entries are the adapter tree's bytes (the layout pads each
        # entry's offset to an alignment)
        lay = trainer.rollout.transfer.layout
        assert sum(e.nbytes for e in lay.entries) == want_bytes
        assert lay.total_bytes < want_bytes + 64 * len(lay.entries)
        register_with_manager(srv, ep, transfer_streams=2)
        assert srv.receiver is not None
        assert srv.receiver.layout == lay
        trainer.rollout.pool.wait_for_member(srv.endpoint, 30.0, active=False)
        history = trainer.fit()
        assert len(history) == 2
        for h in history:
            assert np.isfinite(h["actor/pg_loss"]) and h["actor/grad_norm"] > 0
        final = trainer.rollout.weight_version
        deadline = time.monotonic() + 30
        while srv.engine.weight_version < final:
            assert time.monotonic() < deadline, "the last push never landed"
            time.sleep(0.05)
        live = dict(quant.named_leaves(srv.engine.params))
        assert {n: t.data_ptr() for n, t in live.items()} == ptrs
        for n, t in base.items():
            assert torch.equal(live[n], t), n
        moved = False
        for k, w in trainer.actor.params["layers"].items():
            if isinstance(w, quant.LoraWeight):
                sw = srv.engine.params["layers"][k]
                assert torch.equal(sw.a, w.a.detach()), k
                assert torch.equal(sw.b, w.b.detach()), k
                moved |= bool(w.b.detach().abs().sum() > 0)
        assert moved
        deadline = time.monotonic() + 30
        while not any(i["active"] for i in
                      mgr.get_instances_status()["instances"]):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        prompts = [[5, 6, 7, 8, 9], list(range(20, 33))]
        served = [mgr.generate(f"ld-{i}", p, {"temperature": 0.0,
                                              "max_new_tokens": 8})
                  for i, p in enumerate(prompts)]
        ref_eng = CBEngine(srv.engine.cfg, srv.engine.params, pad_token_id=0,
                           kv_cache_dtype=torch.float32, device="cpu", **geom)
        try:
            ref = ref_eng.generate(prompts, SamplingParams(
                temperature=0.0, max_new_tokens=8))
        finally:
            ref_eng.stop()
        for res, r in zip(served, ref):
            assert res.success, res.error
            assert res.output_token_ids == list(r["token_ids"])
            np.testing.assert_allclose(res.output_token_logprobs,
                                       r["logprobs"], rtol=0, atol=5e-4)
    finally:
        for fn in reversed(cleanup):
            fn()
        srv.stop()
        proc.kill()
        proc.wait(timeout=10)


def test_lora_server_over_an_int8_base():
    """``--weight-quant int8 --lora-rank``: the server serves adapters over
    an int8 base (QLoRA), takes the adapter tree as its wire layout and
    installs pushes in place, with no re-quantization step; ``--is-local``
    parses."""
    from polyrl_tpu_torch.rollout import serve

    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--dtype",
                             "float32", "--port", "0", "--weight-quant",
                             "int8", "--lora-rank", "4", "--lora-alpha", "8",
                             "--is-local", "--max-seq-len", "64",
                             "--page-size", "8", "--num-pages", "16",
                             "--prompt-buckets", "16"])
    assert args.is_local and args.lora_rank == 4
    srv = serve.server_from_args(args)
    try:
        wq = srv.engine.params["layers"]["wq"]
        assert isinstance(wq, quant.LoraWeight) and wq.alpha == 8.0
        assert isinstance(wq.base, quant.QuantWeight)
        # adapters over an int8 base are bf16, the reference's default; a
        # push in the model dtype is cast into them
        assert wq.base.q.dtype == torch.int8 and wq.a.dtype == torch.bfloat16
        assert srv.weight_apply is lora.apply_adapters
        assert srv.weight_preprocess is None
        tmpl = lora.adapter_template(srv.engine.cfg, 4)
        assert {n: tuple(t.shape) for n, t in quant.named_leaves(
            srv.weight_template)} == {n: tuple(t.shape) for n, t in
                                      quant.named_leaves(tmpl)}
    finally:
        srv.stop()
