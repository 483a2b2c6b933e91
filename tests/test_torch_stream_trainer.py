"""The port's colocated trainer on the CPU: a torch copy of the JAX
end-to-end GRPO test on ``CBEngine(device="cpu")``, the config checks,
the ReMax baseline semantics, one fixed ibatch through both packages'
``_process_ibatch``, and the engine's ownership of its weights.

Parity tolerance (old/ref logprobs, rewards, advantages): rtol=atol=1e-4,
exact f32 on both sides in another reduction order (the advantage is a
z-score of per-sequence rewards, which are equal on both sides).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.data.dataset import make_arithmetic_dataset as j_make_dataset
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rewards.manager import load_reward_manager as j_load_rm
from polyrl_tpu.trainer import actor as jactor
from polyrl_tpu.trainer import stream_trainer as jst
from polyrl_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from polyrl_tpu_torch.data.dataset import PromptDataLoader, make_arithmetic_dataset
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.trainer.actor import ActorConfig, ReferencePolicy, StreamActor
from polyrl_tpu_torch.trainer.critic import CriticConfig, StreamCritic, init_critic_params
from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
from polyrl_tpu_torch.utils.metrics import MetricsTracker
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)


def _tiny(seed=0):
    cfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                             max_position_embeddings=128)
    params = decoder.init_params(torch.Generator().manual_seed(seed), cfg)
    return cfg, params


def make_parts():
    cfg, params = _tiny()
    tok = ByteTokenizer()
    engine = CBEngine(cfg, params, pad_token_id=tok.pad_token_id, max_slots=8,
                      page_size=8, max_seq_len=32, prompt_buckets=(16,),
                      num_pages=64, kv_cache_dtype=torch.float32, device="cpu")
    return cfg, params, tok, engine


def _snapshot(tree):
    return {k: (_snapshot(v) if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_grpo_e2e_two_steps():
    cfg, params, tok, engine = make_parts()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="grpo", total_steps=2, temperature=1.0)
    params0 = _snapshot(params)
    actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False, use_kl_loss=True),
                        params)
    ref = ReferencePolicy(cfg, params)
    trainer = StreamRLTrainer(
        tcfg, actor, engine, tok, load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size),
        ref_policy=ref)
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    assert len(history) == 2
    for h in history:
        assert "actor/pg_loss" in h
        assert "reward/mean" in h
        assert h["perf/step_time_s"] > 0
        assert "timing_s/gen" in h and "timing_s/update_actor" in h
        assert "perf/mfu" in h and "actor/kl_loss" in h
    assert trainer.global_step == 2
    assert engine.weight_version == 3  # bootstrap + one push per step
    diff = sum(float((a - b.detach()).abs().sum()) for (_, a), (_, b) in
               zip(_leaves(params0), _leaves(actor.params)))
    assert diff > 0.0
    # the engine holds the actor's last weights, in its own storage
    for (name, a), (_, e) in zip(_leaves(actor.params), _leaves(engine.params)):
        assert torch.equal(a.detach(), e), name
        assert a.data_ptr() != e.data_ptr(), name


def test_config_validation():
    with pytest.raises(ValueError):
        TrainerConfig(train_batch_size=3, rollout_n=3, ppo_mini_batch_size=8)
    with pytest.raises(ValueError):  # group split across ibatches
        TrainerConfig(train_batch_size=8, rollout_n=3, ppo_mini_batch_size=24,
                      micro_batch_size=1, min_stream_batch_size=4)
    with pytest.raises(ValueError):
        TrainerConfig(staleness_limit=2)
    with pytest.raises(ValueError):
        TrainerConfig(weight_sync="bogus")


def test_gae_and_unported_features_are_refused():
    """GAE without a critic is a configuration error; a rollout with a
    streaming surface (remote rollout) constructs; the hybrid
    ``rollout.colocated_local`` builds (``test_torch_colocated_hybrid.py``),
    but not under ``weight_sync=lora_delta``, which is refused with the
    reference's message before any manager is spawned."""
    cfg, params, tok, engine = make_parts()
    actor = StreamActor(cfg, ActorConfig(remat=False), params)
    base = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
                micro_batch_size=4, min_stream_batch_size=4)
    with pytest.raises(ValueError):
        StreamRLTrainer(TrainerConfig(adv_estimator="gae", **base), actor, engine,
                        tok, None, None)

    class Remote:
        def generate(self, *a, **k):
            raise AssertionError

        def generate_stream(self, *a, **k):
            raise AssertionError

    trainer = StreamRLTrainer(TrainerConfig(**base), actor, Remote(), tok,
                              None, None)
    assert trainer.rollout is not engine
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import _build_rollout

    hybrid = load_config(None, ["device=cpu", "rollout.mode=disaggregated",
                                "rollout.colocated_local=true",
                                "trainer.weight_sync=lora_delta",
                                "actor.lora_rank=4"])
    with pytest.raises(NotImplementedError,
                       match="lora_delta with colocated_local"):
        # a spawned manager would show as a cleanup entry
        cleanup: list = []
        _build_rollout(hybrid, cfg, params, tok, torch.device("cpu"), cleanup)
    assert cleanup == []
    engine.stop()


@pytest.mark.parametrize("extra", [dict(weight_sync="lora_delta")],
                         ids=["lora_delta"])
def test_still_unported_trainer_features_are_refused(extra):
    """LoRA delta sync is ported: a LoRA trainer with
    ``weight_sync=lora_delta`` constructs, and each push carries only
    ``lora.extract_adapters`` of the actor's wrapped tree (its ``a``/``b``
    tensors, ``alpha`` and the base's fingerprint), no base weight."""
    from polyrl_tpu_torch.models import lora

    cfg, params, tok, engine = make_parts()
    engine.stop()
    actor = StreamActor(cfg, ActorConfig(remat=False, lora_rank=4), params)
    base = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
                micro_batch_size=4, min_stream_batch_size=4)
    pushed = []

    class Remote:
        weight_version = 0

        def generate_stream(self, *a, **k):
            raise AssertionError

        def update_weights(self, tree, version=None):
            pushed.append(tree)

    trainer = StreamRLTrainer(TrainerConfig(**base, **extra), actor, Remote(),
                              tok, None, None)
    trainer._push_weights()
    (tree,) = pushed
    want = lora.extract_adapters(actor.params)
    assert sorted(tree) == ["alpha", "base_stats", "layers"]
    assert sorted(tree["layers"]) == sorted(want["layers"])
    for k, ab in want["layers"].items():
        for f in ("a", "b"):
            assert tree["layers"][k][f] is getattr(actor.params["layers"][k], f)
            assert tuple(ab[f].shape) == tuple(tree["layers"][k][f].shape)
    assert float(tree["alpha"]) == 16.0
    torch.testing.assert_close(tree["base_stats"], want["base_stats"])


@pytest.mark.parametrize("extra", [dict(pipeline_depth=1, rollout_is_correction=True),
                                   dict(use_remove_padding=True),
                                   dict(ckpt_dir="CKPT"), dict(test_freq=2),
                                   dict(profile_steps=(1,))],
                         ids=["pipeline", "remove_padding", "ckpt", "validation",
                              "profile_steps"])
def test_features_that_were_refused_now_construct(extra, tmp_path):
    """The pipelined trainer, packed rows, checkpoints, validation and
    step profiling construct (each is exercised end to end in its own
    test)."""
    cfg, params, tok, engine = make_parts()
    if "ckpt_dir" in extra:
        extra = dict(ckpt_dir=str(tmp_path / "ck"))
    actor = StreamActor(cfg, ActorConfig(remat=False), params)
    base = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
                micro_batch_size=4, min_stream_batch_size=4)
    trainer = StreamRLTrainer(TrainerConfig(**base, **extra), actor, engine, tok,
                              None, None)
    assert trainer.cfg.pipeline_depth == extra.get("pipeline_depth", 0)
    engine.stop()


def test_ppo_gae_with_critic_step():
    """Torch copy of the JAX package's PPO + critic (GAE) step."""
    cfg, params, tok, engine = make_parts()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="gae", total_steps=1)
    actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
    critic = StreamCritic(cfg, CriticConfig(remat=False), init_critic_params(
        torch.Generator().manual_seed(1), cfg))
    critic0 = _snapshot(critic.params)
    trainer = StreamRLTrainer(
        tcfg, actor, engine, tok, load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size),
        critic=critic)
    try:
        history = trainer.fit()
    finally:
        engine.stop()
    assert "critic/vf_loss" in history[0]
    assert "timing_s/values" in history[0]
    assert "timing_s/update_critic" in history[0]
    assert np.isfinite(history[0]["critic/vf_loss"])
    assert history[0]["critic/grad_norm"] > 0
    assert any(not torch.equal(a.detach(), b) for (_, a), (_, b) in
               zip(_leaves(critic.params), _leaves(critic0)))


def test_remax_e2e_and_baseline_semantics():
    """advantages = (sampled reward - greedy-baseline reward) * mask, with
    ONE greedy rollout per prompt group."""
    cfg, params, tok, engine = make_parts()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=8,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="remax", total_steps=1, temperature=1.0)
    actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
    trainer = StreamRLTrainer(
        tcfg, actor, engine, tok, load_reward_manager(
            "naive", tok, compute_score=lambda ds, txt, gt, ex: float(len(txt)),
            num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size))
    try:
        records = make_arithmetic_dataset(8).records[:4]
        metrics = MetricsTracker()
        ibatch = next(trainer._ibatch_iter(records, None, metrics))
        out = trainer._process_ibatch(ibatch, metrics)
        adv = np.asarray(out["advantages"])
        mask = np.asarray(out["response_mask"])
        scores = np.asarray(out["token_level_rewards"]).sum(-1)
        gids = np.asarray(out["group_ids"])
        row_adv = np.where(mask.sum(-1) > 0,
                           adv.sum(-1) / np.maximum(mask.sum(-1), 1), 0.0)
        base = scores - row_adv
        for g in np.unique(gids):
            vals = base[gids == g]
            np.testing.assert_allclose(vals, vals[0], atol=1e-5)
        history = trainer.fit()
    finally:
        engine.stop()
    assert "reward/remax_baseline_mean" in history[0]
    assert "timing_s/remax_baseline" in history[0]


def _fake_outputs(rng, n, tr, vocab=256):
    outs = []
    for i in range(n):
        ln = int(rng.integers(1, tr + 1))
        outs.append({"token_ids": rng.integers(1, vocab, ln).tolist(),
                     "logprobs": (-5.5 + 0.3 * rng.standard_normal(ln)).tolist(),
                     "weight_versions": [1] * ln})
    return outs


class _StubRollout:
    """What ``_process_ibatch`` and the batch assembly read of a rollout."""

    pad_token_id = 256
    weight_version = 1
    last_gen_throughput = 0.0

    def generate(self, *a, **k):  # never called here
        raise AssertionError


def _process_both(est, **extra):
    """One fixed ibatch (prompts, sampled responses and their behavior
    logprobs) through both trainers' ``_process_ibatch``; with ``gae``
    each trainer has a critic holding the same converted JAX weights."""
    from polyrl_tpu.trainer import critic as jcritic

    jcfg = jdec.get_config("tiny", dtype=jnp.float32, vocab_size=512,
                           max_position_embeddings=128)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdec.init_params(jax.random.PRNGKey(3), jcfg))
    tcfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                              max_position_embeddings=128)
    kw = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
              micro_batch_size=4, min_stream_batch_size=8, max_prompt_length=16,
              max_response_length=8, adv_estimator=est, use_kl_in_reward=True,
              kl_coef=0.05, rollout_is_correction=True, rollout_is_cap=1.5,
              **extra)
    jcrit = tcrit = None
    if est == "gae":
        ctree = jax.tree_util.tree_map(np.asarray, jcritic.init_critic_params(
            jax.random.PRNGKey(5), jcfg))
        jcrit = jcritic.StreamCritic(jcfg, jcritic.CriticConfig(remat=False),
                                     jax.tree_util.tree_map(jnp.asarray, ctree))
        tcrit = StreamCritic(tcfg, CriticConfig(remat=False),
                             params_from_numpy(ctree, "cpu", torch.float32))

    def score(ds, txt, gt, ex):
        return float(len(txt)) + (1.0 if gt in txt else 0.0)

    jt = jst.StreamRLTrainer(
        jst.TrainerConfig(**kw),
        jactor.StreamActor(jcfg, jactor.ActorConfig(remat=False),
                           jax.tree_util.tree_map(jnp.asarray, tree)),
        _StubRollout(), JByteTokenizer(),
        j_load_rm("naive", JByteTokenizer(), compute_score=score, num_workers=1),
        None, critic=jcrit, ref_policy=jactor.ReferencePolicy(
            jcfg, jax.tree_util.tree_map(jnp.asarray, tree)), health=False)
    tp = params_from_numpy(tree, "cpu", torch.float32)
    tt = StreamRLTrainer(
        TrainerConfig(**kw), StreamActor(tcfg, ActorConfig(remat=False), tp),
        _StubRollout(), ByteTokenizer(),
        load_reward_manager("naive", ByteTokenizer(), compute_score=score,
                            num_workers=1),
        None, critic=tcrit, ref_policy=ReferencePolicy(
            tcfg, params_from_numpy(tree, "cpu", torch.float32)))
    records = j_make_dataset(8, seed=4).records[:4]
    rng = np.random.default_rng(5)
    outs = _fake_outputs(rng, 8, 8)
    jp, jg, js = jt._prepare_prompts(records)
    tp_, tg, ts = tt._prepare_prompts(records)
    assert jp == tp_ and jg == tg and js == ts
    gids = np.repeat(np.arange(4, dtype=np.int32), 2)
    jb = jt._assemble_batch(jp, jg, js, [jst._ResultView(o) for o in outs], gids)
    from polyrl_tpu_torch.trainer.stream_trainer import _ResultView
    tb = tt._assemble_batch(tp_, tg, ts, [_ResultView(o) for o in outs], gids)
    for k in jb.tensors:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    from polyrl_tpu.utils.metrics import MetricsTracker as JMetrics

    jm, tm = JMetrics(), MetricsTracker()
    jb = jt._process_ibatch(jb, jm)
    tb = tt._process_ibatch(tb, tm)
    for k in ("old_log_probs", "ref_log_probs", "token_level_rewards",
              "advantages", "returns"):
        np.testing.assert_allclose(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k,
                                   **TOL)
    if est == "gae":  # values on response tokens (pads are read by nothing)
        rm = np.asarray(tb["response_mask"])
        np.testing.assert_allclose(np.asarray(tb["values"]) * rm,
                                   np.asarray(jb["values"]) * rm, **TOL)
    jd, td = jm.as_dict(), tm.as_dict()
    for k in ("reward/mean", "reward/max", "actor/entropy_rollout",
              "critic/kl_in_reward", "actor/tis_weight_mean", "actor/tis_clip_frac"):
        np.testing.assert_allclose(td[k], jd[k], err_msg=k, **TOL)
    return jt, jb, tt, tb


@pytest.mark.parametrize("est", ["grpo", "rloo", "reinforce_plus_plus", "gae"])
def test_process_ibatch_matches_jax_trainer(est):
    """One fixed ibatch through both trainers' ``_process_ibatch``: rewards,
    old and ref logprobs, KL-in-reward, values (GAE), advantages and
    returns, and the TIS weights agree."""
    _process_both(est)


@pytest.mark.parametrize("est", ["grpo", "gae"])
def test_packed_process_ibatch_matches_jax_trainer(est):
    """The same on packed rows (``use_remove_padding``, 2 rows of 24 per
    micro): the packed logprob and value passes gathered back, then the
    update micros' packed feeds, field by field."""
    jt, jb, tt, tb = _process_both(est, use_remove_padding=True,
                                   micro_token_budget=48, pack_len=24)
    jmicros = list(jt._packed_micros(jb))
    tmicros = list(tt._packed_micros(tb))
    assert len(tmicros) == len(jmicros) >= 2
    for (jf, jn), (tf, tn) in zip(jmicros, tmicros):
        assert jn == tn and set(tf) <= set(jf)
        for k in tf:
            np.testing.assert_allclose(np.asarray(tf[k]), np.asarray(jf[k]),
                                       err_msg=k, **TOL)


def test_engine_owns_its_weights():
    """The engine copies its parameters at construction: an in-place
    change to the caller's tensors (a colocated actor's optimizer step)
    leaves the engine's weights alone; ``update_weights`` still copies
    and bumps ``weight_version``."""
    cfg, params, tok, engine = make_parts()
    before = engine.params["layers"]["wq"].clone()
    with torch.no_grad():
        params["layers"]["wq"].add_(1.0)
        params["embed"].mul_(2.0)
    assert torch.equal(engine.params["layers"]["wq"], before)
    assert engine.params["layers"]["wq"].data_ptr() != params["layers"]["wq"].data_ptr()
    v0 = engine.weight_version
    engine.update_weights(params)
    assert engine.weight_version == v0 + 1
    assert torch.equal(engine.params["layers"]["wq"], params["layers"]["wq"])
    assert engine.params["embed"].data_ptr() != params["embed"].data_ptr()
    with torch.no_grad():
        params["embed"].zero_()
    assert not torch.equal(engine.params["embed"], params["embed"])


def _fit_parts(total_steps=2, **tkw):
    cfg, params, tok, engine = make_parts()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="grpo", total_steps=total_steps, **tkw)
    return cfg, params, tok, engine, tcfg


def test_profile_steps_write_one_trace(tmp_path):
    """``profile_steps=(2,)`` traces step 2 only, through torch.profiler,
    and writes its trace under ``profile_dir`` (the reference's
    ``test_profiler_step_gating``); steps 2-3 profiled share one trace."""
    for steps, want in (((2,), "trace_steps_2-2.json"),
                        ((2, 3), "trace_steps_2-3.json")):
        cfg, params, tok, engine, tcfg = _fit_parts(
            total_steps=3, profile_steps=steps,
            profile_dir=str(tmp_path / f"prof{len(steps)}"))
        actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
        trainer = StreamRLTrainer(
            tcfg, actor, engine, tok,
            load_reward_manager("naive", tok, num_workers=1),
            PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size))
        try:
            trainer.fit()
        finally:
            engine.stop()
        assert trainer._profiler is None
        files = sorted(p.name for p in (tmp_path / f"prof{len(steps)}").iterdir())
        assert files == [want]
        trace = json.loads((tmp_path / f"prof{len(steps)}" / want).read_text())
        assert trace["traceEvents"], "empty trace"
        assert trainer.profile_traces == [str(tmp_path / f"prof{len(steps)}" / want)]


def test_offload_fit_matches_no_offload_and_moments_stay_on_host():
    """The colocated GRPO fit with ``offload_optimizer``: the moments are
    offloaded after each step's push and the run is bitwise the same
    without it (greedy sampling keeps both runs on the same tokens)."""
    outs = []
    for offload in (True, False):
        cfg, params, tok, engine, tcfg = _fit_parts(temperature=0.0)
        actor = StreamActor(cfg, ActorConfig(lr=1e-3, remat=False,
                                             use_kl_loss=True,
                                             offload_optimizer=offload), params)
        trainer = StreamRLTrainer(
            tcfg, actor, engine, tok,
            load_reward_manager("naive", tok, num_workers=1),
            PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size,
                             shuffle=False),
            ref_policy=ReferencePolicy(cfg, params))
        try:
            trainer.fit()
        finally:
            engine.stop()
        assert actor._opt_offloaded == offload
        outs.append({k: v.detach().clone() for k, v in _leaves(actor.params)})
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_grpo_fit_on_the_step_backend_matches_jax():
    """Two GRPO steps with ``rollout.backend=step`` (the bucketed
    ``RolloutEngine``) in both packages from the same weights, greedy
    rollouts: the same responses (lengths and rewards), and the actor's
    per-step readings (old logprobs' entropy, KL, losses, grad norm)
    within the file's tolerance; the engine ends at weight version 3 and
    holds the actor's weights."""
    from polyrl_tpu.data.dataset import PromptDataLoader as JLoader
    from polyrl_tpu.rollout.engine import RolloutEngine as JRollout
    from polyrl_tpu_torch.rollout.engine import RolloutEngine

    jcfg = jdec.get_config("tiny", dtype=jnp.float32, vocab_size=512,
                           max_position_embeddings=128)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdec.init_params(jax.random.PRNGKey(3), jcfg))
    tcfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                              max_position_embeddings=128)
    kw = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
              micro_batch_size=4, min_stream_batch_size=4,
              max_prompt_length=16, max_response_length=8,
              adv_estimator="grpo", total_steps=2, temperature=0.0)
    acfg = dict(lr=1e-4, remat=False, use_kl_loss=True)
    eng_kw = dict(pad_token_id=256, batch_buckets=(8,), prompt_buckets=(16,))

    def score(ds, txt, gt, ex):
        return float(len(txt)) + (1.0 if gt in txt else 0.0)

    jrollout = JRollout(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                        kv_cache_dtype=jnp.float32, **eng_kw)
    jt = jst.StreamRLTrainer(
        jst.TrainerConfig(**kw),
        jactor.StreamActor(jcfg, jactor.ActorConfig(**acfg),
                           jax.tree_util.tree_map(jnp.asarray, tree)),
        jrollout, JByteTokenizer(),
        j_load_rm("naive", JByteTokenizer(), compute_score=score, num_workers=1),
        JLoader(j_make_dataset(16, seed=4), 4, shuffle=False),
        ref_policy=jactor.ReferencePolicy(
            jcfg, jax.tree_util.tree_map(jnp.asarray, tree)), health=False)
    jhist = jt.fit()

    trollout = RolloutEngine(tcfg, params_from_numpy(tree, "cpu", torch.float32),
                             kv_cache_dtype=torch.float32, device="cpu", **eng_kw)
    tparams = params_from_numpy(tree, "cpu", torch.float32)
    actor = StreamActor(tcfg, ActorConfig(**acfg), tparams)
    tt = StreamRLTrainer(
        TrainerConfig(**kw), actor, trollout, ByteTokenizer(),
        load_reward_manager("naive", ByteTokenizer(), compute_score=score,
                            num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(16, seed=4), 4, shuffle=False),
        ref_policy=ReferencePolicy(tcfg, params_from_numpy(tree, "cpu",
                                                           torch.float32)))
    thist = tt.fit()
    assert len(thist) == len(jhist) == 2
    keys = [k for k in ("reward/mean", "response_length/mean",
                        "actor/entropy_rollout", "actor/pg_loss",
                        "actor/kl_loss", "actor/grad_norm")
            if k in jhist[0]]
    assert "reward/mean" in keys and len(keys) >= 4, sorted(jhist[0])
    for j, t in zip(jhist, thist):
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)
    assert trollout.weight_version == jrollout.weight_version == 3
    for (name, a), (_, e) in zip(_leaves(actor.params), _leaves(trollout.params)):
        assert torch.equal(a.detach(), e), name


def test_example_config_rollout_keys_load_and_step_backend_builds():
    """The colocated engine's keys of the shipped example config load in
    the port's config (prefill_chunk 512; salvage, speculation and batch
    buckets at the reference's defaults), and ``rollout.backend=step``
    builds the bucketed engine and trains through ``build_trainer``."""
    import pathlib

    import yaml

    from polyrl_tpu_torch.config import RolloutSection, load_config
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine as TEngine
    from polyrl_tpu_torch.rollout.engine import RolloutEngine
    from polyrl_tpu_torch.train import _build_rollout, build_trainer

    root = pathlib.Path(__file__).resolve().parent.parent
    data = yaml.safe_load(
        (root / "examples/configs/stream_grpo_qwen3_1p7b.yaml").read_text())
    engine_keys = {f for f in RolloutSection.__dataclass_fields__}
    rollout = {k: v for k, v in data["rollout"].items()
               if k in engine_keys and k != "mode"}
    assert {"prefill_chunk", "backend", "max_slots"} <= set(rollout)
    cfg = load_config(None, [f"rollout.{k}={v}" for k, v in rollout.items()])
    r = cfg.rollout
    assert r.prefill_chunk == 512 and r.salvage_partials is True
    assert (r.spec_tokens, r.spec_rounds, r.batch_buckets) == (0, 2, ())

    small = ["device=cpu", "model.preset=tiny", "model.dtype=float32",
             "rollout.prompt_buckets=16", "rollout.page_size=8",
             "rollout.max_seq_len=64", "rollout.num_pages=64",
             "rollout.max_slots=8", "trainer.train_batch_size=2",
             "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=4",
             "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
             "trainer.max_prompt_length=16", "trainer.max_response_length=8",
             "trainer.total_steps=1", "reward.num_workers=1"]
    cb_cfg = load_config(None, small + ["rollout.prefill_chunk=8",
                                        "rollout.spec_tokens=2",
                                        "rollout.salvage_partials=false"])
    cb = _build_rollout(cb_cfg, decoder.get_config("tiny", dtype=torch.float32),
                        _tiny()[1], ByteTokenizer(), torch.device("cpu"))
    assert isinstance(cb, TEngine)
    assert (cb.prefill_chunk, cb.spec_tokens, cb.salvage_partials) == (8, 2, False)
    cb.stop()
    step_cfg = load_config(None, small + ["rollout.backend=step",
                                          "rollout.batch_buckets=4"])
    cleanup = []
    trainer = build_trainer(step_cfg, cleanup)
    try:
        assert isinstance(trainer.rollout, RolloutEngine)
        assert trainer.rollout.batch_buckets == (4,)
        history = trainer.fit()
    finally:
        for fn in cleanup:
            fn()
    assert len(history) == 1 and trainer.rollout.weight_version == 2


def test_build_trainer_engine_runs_every_plane_by_default():
    """``build_trainer``'s colocated CB engine runs the page ledger, the
    spill tier, the flight deck and the loop profiler by default, as the
    reference's does, with the ``rollout`` section's knobs; the off
    switches reach it too."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    small = ["device=cpu", "model.preset=tiny", "model.dtype=float32",
             "rollout.prompt_buckets=16", "rollout.page_size=8",
             "rollout.max_seq_len=64", "rollout.num_pages=64",
             "rollout.max_slots=8", "trainer.train_batch_size=2",
             "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=4",
             "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
             "trainer.max_prompt_length=16", "trainer.max_response_length=8",
             "trainer.total_steps=1", "reward.num_workers=1"]
    for extra, off in (
            (["rollout.kv_cold_after_dispatches=32",
              "rollout.kv_spill_host_gb=0.25",
              "rollout.kv_spill_high_watermark=0.9",
              "rollout.kv_spill_low_watermark=0.5"], ()),
            (["rollout.kv_ledger=false", "rollout.loop_profile=false"],
             ("kvledger", "kvspill", "profiler"))):
        cleanup = []
        trainer = build_trainer(load_config(None, small + extra), cleanup)
        try:
            eng = trainer.rollout
            for plane in ("kvledger", "kvspill", "deck", "profiler"):
                assert (getattr(eng, plane) is None) == (plane in off), plane
            if not off:
                assert eng.kvledger.cold_after == 32
                assert eng.kvspill.capacity_bytes == int(0.25e9)
                assert (eng.kv_spill_high_watermark,
                        eng.kv_spill_low_watermark) == (0.9, 0.5)
        finally:
            eng.stop()
            for fn in reversed(cleanup):
                fn()

