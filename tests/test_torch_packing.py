"""Packed rows (remove padding) in the port, on the CPU: the packer against
the JAX package's (bitwise), the actor's packed logprob pass against the
JAX actor's and against the port's own padded pass, the packed update's
gradients against the JAX actor's, the trainer's pack geometry, and torch
copies of the JAX package's packed end-to-end tests.

Tolerances: packed logprobs 5e-4 against the JAX packed pass (the JAX
package's own logprob bound) and 1e-4 against the port's padded pass (the
same weights through another attention layout, f32); the packed update's
gradients 1e-4 relative (Frobenius) against the JAX actor's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.data import packing as jpacking
from polyrl_tpu.data.batch import TensorBatch as JBatch
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.trainer import actor as jactor
from polyrl_tpu_torch.data import packing
from polyrl_tpu_torch.data.batch import TensorBatch
from polyrl_tpu_torch.data.dataset import PromptDataLoader, make_arithmetic_dataset
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.trainer import actor as tactor
from polyrl_tpu_torch.trainer.critic import CriticConfig, StreamCritic, init_critic_params
from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

LENGTHS = [(5, 7), (3, 2), (16, 8), (1, 1), (8, 4), (2, 8)]
PACK_KEYS = ("input_ids", "positions", "attention_mask", "segment_ids", "loss_mask")


def _padded(rng, lengths, tp=16, tr=8, pad=0, vocab=200):
    """A padded [B, tp+tr] batch from (prompt_len, resp_len) pairs."""
    b = len(lengths)
    input_ids = np.full((b, tp + tr), pad, np.int32)
    attention_mask = np.zeros((b, tp + tr), np.float32)
    responses = np.full((b, tr), pad, np.int32)
    response_mask = np.zeros((b, tr), np.float32)
    for i, (pl, rl) in enumerate(lengths):
        p = rng.integers(1, vocab, pl)
        r = rng.integers(1, vocab, rl)
        input_ids[i, tp - pl:tp] = p
        attention_mask[i, tp - pl:tp] = 1.0
        input_ids[i, tp:tp + rl] = r
        attention_mask[i, tp:tp + rl] = 1.0
        responses[i, :rl] = r
        response_mask[i, :rl] = 1.0
    positions = np.maximum(attention_mask.cumsum(-1) - 1, 0).astype(np.int32)
    return {"input_ids": input_ids, "attention_mask": attention_mask,
            "positions": positions, "responses": responses,
            "response_mask": response_mask}


@pytest.mark.parametrize("pack_len,n_rows", [(24, 2), (24, 3), (40, 1)])
def test_pack_structure_and_roundtrip_match_jax(pack_len, n_rows):
    """The same TensorBatch through both packers: every pack's tensors and
    PackSpec fields bitwise equal; segments contiguous and 1-based with
    positions restarting at 0; loss_mask inside segments only; the
    scatter/gather round trip exact."""
    rng = np.random.default_rng(0)
    tensors = _padded(rng, LENGTHS)
    field = (rng.normal(size=(len(LENGTHS), 8)).astype(np.float32)
             * tensors["response_mask"])
    tensors["advantages"] = field
    tb = TensorBatch.from_dict(tensors={k: v.copy() for k, v in tensors.items()})
    jb = JBatch.from_dict(tensors={k: v.copy() for k, v in tensors.items()})
    kw = dict(pack_len=pack_len, n_rows=n_rows, pad_id=0,
              scatter_keys=("advantages",))
    got = list(packing.iter_packed_micros(tb, 16, **kw))
    want = list(jpacking.iter_packed_micros(jb, 16, **kw))
    assert len(got) == len(want) >= 1
    out = np.zeros_like(field)
    seen = []
    for (gp, gs), (wp, ws) in zip(got, want):
        assert set(gp.tensors) == set(wp.tensors)
        for k in wp.tensors:
            np.testing.assert_array_equal(np.asarray(gp[k]), np.asarray(wp[k]),
                                          err_msg=k)
            assert np.asarray(gp[k]).dtype == np.asarray(wp[k]).dtype, k
        for f in ("orig_idx", "row", "resp_start", "resp_len"):
            np.testing.assert_array_equal(getattr(gs, f), getattr(ws, f), err_msg=f)
        assert (gs.n_rows, gs.pack_len) == (ws.n_rows, ws.pack_len)
        seg, pos = np.asarray(gp["segment_ids"]), np.asarray(gp["positions"])
        for r in range(seg.shape[0]):
            for s in np.unique(seg[r][seg[r] > 0]):
                cols = np.flatnonzero(seg[r] == s)
                assert (np.diff(cols) == 1).all()
                np.testing.assert_array_equal(pos[r, cols], np.arange(len(cols)))
        assert ((np.asarray(gp["loss_mask"]) > 0) <= (seg > 0)).all()
        gs.gather_into(np.asarray(gp["advantages"]), out)
        seen += gs.orig_idx.tolist()
    assert sorted(seen) == list(range(len(LENGTHS)))  # each exactly once
    np.testing.assert_array_equal(out, field)
    specs = [s for _, s in got]
    n_real = int(tensors["attention_mask"].sum())
    assert packing.packing_efficiency(specs, n_real, n_rows, pack_len) == \
        jpacking.packing_efficiency([s for _, s in want], n_real, n_rows, pack_len)


def test_trajectory_too_long_raises():
    rng = np.random.default_rng(3)
    tb = TensorBatch.from_dict(tensors=_padded(rng, [(16, 8)]))
    with pytest.raises(ValueError):
        list(packing.iter_packed_micros(tb, 16, pack_len=16, n_rows=2, pad_id=0))


def _models(seed=0):
    jcfg = jdec.get_config("tiny", dtype=jnp.float32, vocab_size=256)
    tcfg = tdec.get_config("tiny", dtype=torch.float32, vocab_size=256)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdec.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, tree


def _packs(tensors, pack_len, n_rows, scatter_keys=()):
    tb = TensorBatch.from_dict(tensors=tensors)
    return list(packing.iter_packed_micros(tb, 16, pack_len=pack_len,
                                           n_rows=n_rows, pad_id=0,
                                           scatter_keys=scatter_keys))


def test_packed_logprobs_match_jax_and_padded():
    """compute_log_prob_packed (and the reference policy's) against the
    JAX actor's packed pass on the same packs, and gathered back against
    the port's own padded pass."""
    jcfg, tcfg, tree = _models()
    tensors = _padded(np.random.default_rng(1), LENGTHS)
    ja = jactor.StreamActor(jcfg, jactor.ActorConfig(remat=False),
                            jax.tree_util.tree_map(jnp.asarray, tree))
    ta = tactor.StreamActor(tcfg, tactor.ActorConfig(remat=False),
                            params_from_numpy(tree, "cpu", torch.float32))
    tref = tactor.ReferencePolicy(tcfg, params_from_numpy(tree, "cpu", torch.float32))
    rmask = tensors["response_mask"]
    want_lp, _ = ta.compute_log_prob(tensors)
    want_lp = want_lp.numpy() * rmask
    got = np.zeros_like(want_lp)
    packs = _packs(tensors, 24, 2)
    assert len(packs) >= 2
    for pack, spec in packs:
        feed = {k: np.asarray(pack[k]) for k in PACK_KEYS}
        jl, je = ja.compute_log_prob_packed(feed)
        tl, te = ta.compute_log_prob_packed(feed)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=5e-4, atol=5e-4)
        lm = feed["loss_mask"] == 0
        assert (tl.numpy()[lm] == 0).all() and (te.numpy()[lm] == 0).all()
        np.testing.assert_array_equal(tref.compute_log_prob_packed(feed).numpy(),
                                      tl.numpy())
        spec.gather_into(tl.numpy(), got)
    np.testing.assert_allclose(got * rmask, want_lp, rtol=1e-4, atol=1e-4)


def test_packed_logprobs_without_loss_mask_match_jax():
    """Without a loss_mask every column's predictor is unembedded, as in
    the JAX pass."""
    jcfg, tcfg, tree = _models()
    (pack, _spec), = _packs(_padded(np.random.default_rng(2), LENGTHS[:3]), 48, 1)
    feed = {k: np.asarray(pack[k]) for k in PACK_KEYS if k != "loss_mask"}
    ja = jactor.StreamActor(jcfg, jactor.ActorConfig(remat=False),
                            jax.tree_util.tree_map(jnp.asarray, tree))
    ta = tactor.StreamActor(tcfg, tactor.ActorConfig(remat=False),
                            params_from_numpy(tree, "cpu", torch.float32))
    jl, je = ja.compute_log_prob_packed(feed)
    tl, te = ta.compute_log_prob_packed(feed)
    # columns predicted from a real token (the two attentions differ only on
    # pad query rows, which no loss term reads)
    real = np.pad(feed["segment_ids"][:, :-1] > 0, ((0, 0), (1, 0)))
    assert real.sum() > 30
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(te.numpy()[real], np.asarray(je)[real],
                               rtol=5e-4, atol=5e-4)


def _grads_of(actor_params):
    return {k: v.grad.numpy().copy() for k, v in tactor._leaves(actor_params)}


@pytest.mark.parametrize("remat", [False, True])
def test_packed_update_gradients_match_jax(remat):
    """One packed micro's loss gradient (token-mean, KL loss and entropy
    bonus) against the JAX actor's on the same pack, leaf by leaf; the
    metrics agree too, and one packed step equals one padded step of the
    port on the same trajectories."""
    jcfg, tcfg, tree = _models()
    rng = np.random.default_rng(4)
    tensors = _padded(rng, LENGTHS[:4])
    rmask = tensors["response_mask"]
    tensors["advantages"] = rng.normal(size=rmask.shape).astype(np.float32) * rmask
    tensors["old_log_probs"] = (-5.5 + 0.1 * rng.normal(size=rmask.shape)
                                ).astype(np.float32) * rmask
    tensors["ref_log_probs"] = (-5.5 + 0.1 * rng.normal(size=rmask.shape)
                                ).astype(np.float32) * rmask
    (pack, _spec), = _packs(tensors, 24, 2, ("advantages", "old_log_probs",
                                             "ref_log_probs"))
    feed = {k: np.asarray(v) for k, v in pack.tensors.items()}
    kw = dict(lr=1e-4, remat=remat, use_kl_loss=True, kl_loss_coef=0.1,
              entropy_coeff=0.01)
    ja = jactor.StreamActor(jcfg, jactor.ActorConfig(**kw),
                            jax.tree_util.tree_map(jnp.asarray, tree))
    jm = ja.update_stream(feed, is_opt_step=False, loss_scale=1.0)
    ta = tactor.StreamActor(tcfg, tactor.ActorConfig(**kw),
                            params_from_numpy(tree, "cpu", torch.float32))
    tm = ta.update_stream(feed, is_opt_step=False, loss_scale=1.0)
    for k in jm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    got = _grads_of(ta.params)
    want = {}

    def flat(tree_, prefix=""):
        for k, v in tree_.items():
            if isinstance(v, dict):
                flat(v, prefix + k + ".")
            else:
                want[prefix + k] = np.asarray(v)

    flat(ja.accum_grads)
    assert got.keys() == want.keys()
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
        assert rel <= 1e-4, (k, rel)
    # the packed step and the padded step of the port agree
    m_pack = ta.flush_opt_step()
    tp = tactor.StreamActor(tcfg, tactor.ActorConfig(**kw),
                            params_from_numpy(tree, "cpu", torch.float32))
    m_pad = tp.update_stream(tensors, is_opt_step=True, loss_scale=1.0)
    np.testing.assert_allclose(m_pack["actor/grad_norm"], m_pad["actor/grad_norm"],
                               rtol=1e-4)
    for (k, a), (_, b) in zip(tactor._leaves(ta.params), tactor._leaves(tp.params)):
        assert float((a - b).detach().abs().max()) < 1e-5, k


def _trainer_parts(cfg_kw, critic=False, vocab=512):
    mcfg = tdec.get_config("tiny", dtype=torch.float32, vocab_size=vocab,
                           max_position_embeddings=128)
    params = tdec.init_params(torch.Generator().manual_seed(0), mcfg)
    tok = ByteTokenizer()
    engine = CBEngine(mcfg, params, pad_token_id=tok.pad_token_id, max_slots=8,
                      page_size=8, max_seq_len=32, prompt_buckets=(16,),
                      num_pages=64, kv_cache_dtype=torch.float32, device="cpu")
    tcfg = TrainerConfig(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
                         micro_batch_size=4, min_stream_batch_size=8,
                         max_prompt_length=16, max_response_length=8,
                         total_steps=1, temperature=1.0,
                         use_remove_padding=True, **cfg_kw)
    actor = tactor.StreamActor(mcfg, tactor.ActorConfig(lr=1e-4, remat=False),
                               params)
    crit = (StreamCritic(mcfg, CriticConfig(lr=1e-4, remat=False),
                         init_critic_params(torch.Generator().manual_seed(2), mcfg))
            if critic else None)
    trainer = StreamRLTrainer(
        tcfg, actor, engine, tok, load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size),
        critic=crit)
    return trainer, engine


def test_trainer_e2e_remove_padding():
    """Torch copy of the JAX package's packed end-to-end GRPO step (4 rows
    of 24 columns per micro)."""
    trainer, engine = _trainer_parts(dict(adv_estimator="grpo",
                                          micro_token_budget=96, pack_len=24))
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    assert len(history) == 1
    assert "actor/pg_loss" in history[0]
    assert "actor/entropy_rollout" in history[0]
    assert history[0]["training/global_step"] == 1


def test_trainer_e2e_remove_padding_gae_critic():
    """GAE with the packed critic end to end: values and returns ride the
    packed micros and the step completes with a finite value loss."""
    trainer, engine = _trainer_parts(dict(adv_estimator="gae",
                                          micro_token_budget=48), critic=True)
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    assert len(history) == 1
    assert "critic/vf_loss" in history[0] and "timing_s/update_critic" in history[0]
    assert np.isfinite(history[0]["critic/vf_loss"])
    assert history[0]["critic/grad_norm"] > 0


def test_pack_geometry_budget_below_one_row_raises():
    """The token budget sets the rows per micro; a budget below one row
    raises rather than exceed the budget it guards."""
    from types import SimpleNamespace

    def geometry(**kw):
        fake = SimpleNamespace(cfg=TrainerConfig(use_remove_padding=True, **kw))
        return StreamRLTrainer._pack_geometry(fake)

    assert geometry(micro_token_budget=256, pack_len=32) == (32, 8)
    assert geometry(micro_token_budget=0, pack_len=32) == (32, 8)
    assert geometry(max_prompt_length=16, max_response_length=8) == (24, 8)
    with pytest.raises(ValueError, match="micro_token_budget"):
        geometry(micro_token_budget=31, pack_len=32)
