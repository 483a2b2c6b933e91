"""The port's training health ledger held against the JAX package's on the
same arrays (``tests/test_training_health.py``, less ``health_report``):
the group diagnostics, per-token staleness, TIS and logprob-delta
distributions, the direction-aware watch, the /statusz ``training``
section, and a port fit whose every record carries ``training/*`` and
whose induced entropy collapse dumps exactly one bundle with
``training.json``.

Tolerance: ``finalize_step`` gauges within 1e-6 of the reference's (both
accumulate in float64 over the same numpy arrays); histograms bucket for
bucket.
"""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from polyrl_tpu.obs.rlhealth import TrainingHealthLedger as JLedger
from polyrl_tpu_torch.obs.histogram import Histogram
from polyrl_tpu_torch.obs.recorder import (DEFAULT_WATCH, AnomalyDetector,
                                           FlightRecorder)
from polyrl_tpu_torch.obs.rlhealth import TrainingHealthLedger


def _mk_ibatch(*, rewards, group_ids, lens, tr=8, adv=None, versions=None,
               sources=None):
    n = len(rewards)
    mask = np.zeros((n, tr), np.float32)
    advantages = np.zeros((n, tr), np.float32)
    wv = np.full((n, tr), -1, np.int32)
    for i, ln in enumerate(lens):
        mask[i, :ln] = 1.0
        if adv is not None:
            advantages[i, :ln] = adv[i]
        if versions is not None:
            wv[i, :ln] = versions[i]
    return dict(
        advantages=advantages, response_mask=mask,
        group_ids=np.asarray(group_ids, np.int32),
        traj_rewards=np.asarray(rewards, np.float64),
        data_sources=sources,
        weight_versions=wv if versions is not None else None)


def _random_ibatch(rng, n_groups=4, g=4, tr=12, cur=6):
    n = n_groups * g
    lens = rng.integers(0, tr + 1, n)
    rewards = np.round(rng.random(n) * 3) / 3.0
    rewards[:g] = 1.0  # one degenerate group
    batch = _mk_ibatch(rewards=rewards, group_ids=np.repeat(np.arange(n_groups), g),
                       lens=lens, tr=tr, adv=rng.normal(size=n),
                       versions=rng.integers(-1, cur + 1, n),
                       sources=[["gsm8k", "math", "Code/X"][i % 3]
                                for i in range(n)])
    mask = batch["response_mask"]
    old = rng.normal(size=(n, tr)) * 0.1
    beh = old + rng.normal(size=(n, tr)) * 0.05
    tis = np.minimum(np.exp(old - beh), 2.0) * mask
    stats = {"unknown_tokens": int(rng.integers(0, 5)),
             "per_lag": {0: {"tokens": 10, "weight_sum": 9.5, "clipped": 1},
                         2: {"tokens": 4, "weight_sum": 4.4, "clipped": 0}}}
    return dict(batch, old_log_probs=old, rollout_log_probs=beh,
                tis_weights=tis, tis_stats=stats, current_version=cur,
                max_response_length=tr)


class _Metrics:
    def __init__(self, d):
        self.d = d

    def get(self, key, default=0.0):
        return self.d.get(key, default)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_step_matches_reference(seed):
    """Two steps of random ibatches into both ledgers: equal gauges
    (within 1e-6), equal histograms, tails and group tables."""
    rng = np.random.default_rng(seed)
    mine, ref = TrainingHealthLedger(), JLedger()
    metrics = _Metrics({"actor/entropy": 1.25, "actor/approx_kl": 0.01,
                        "actor/grad_norm": 3.0})
    for step in (1, 2):
        for _ in range(2):
            batch = _random_ibatch(rng)
            mine.observe_ibatch(**batch)
            ref.observe_ibatch(**batch)
        (g1, h1), (g2, h2) = (mine.finalize_step(step, metrics),
                              ref.finalize_step(step, metrics))
        assert g1.keys() == g2.keys()
        for k in g1:
            assert g1[k] == pytest.approx(g2[k], rel=1e-6, abs=1e-6), k
        assert h1.keys() == h2.keys()
        for k in h1:
            assert h1[k].buckets == h2[k].buckets, k
            assert (h1[k].count, h1[k].zeros) == (h2[k].count, h2[k].zeros)
            assert h1[k].total == pytest.approx(h2[k].total, rel=1e-9)
    assert list(mine.tail) == list(ref.tail)
    assert mine.bundle_view() == ref.bundle_view()
    assert mine.snapshot() == ref.snapshot()


@pytest.mark.parametrize("cls", [TrainingHealthLedger, JLedger],
                         ids=["torch", "jax"])
def test_ledger_degenerate_group_math(cls):
    led = cls()
    led.observe_ibatch(
        **_mk_ibatch(rewards=[1.0, 1.0, 0.0, 2.0], group_ids=[0, 0, 1, 1],
                     lens=[8, 4, 0, 8], adv=[0.0, 0.0, -1.0, 1.0],
                     sources=["gsm8k", "gsm8k", "math", "math"]),
        max_response_length=8)
    gauges, hists = led.finalize_step(1)
    assert gauges["training/degenerate_group_frac"] == 0.5
    assert gauges["training/groups"] == 2.0
    assert gauges["training/effective_batch_frac"] == 0.25
    assert gauges["training/truncated_frac"] == 0.5
    assert gauges["training/empty_response_frac"] == 0.25
    assert gauges["training/reward_mean/gsm8k"] == 1.0
    assert gauges["training/reward_std/gsm8k"] == 0.0
    assert gauges["training/reward_mean/math"] == 1.0
    assert gauges["training/reward_std/math"] == pytest.approx(1.0)
    assert "training/adv_abs" in hists
    assert hists["training/response_len"].vmax == 8.0
    view = led.bundle_view()
    degen = {row["group"]: row["degenerate"] for row in view["last_groups"]}
    assert degen == {0: True, 1: False}
    assert view["last_groups"][0]["data_source"] == "gsm8k"


def test_ledger_staleness_mixed_version_batch():
    led = TrainingHealthLedger()
    led.observe_ibatch(
        **_mk_ibatch(rewards=[1.0, 0.0, 2.0, 1.0], group_ids=[0, 0, 1, 1],
                     lens=[4, 4, 4, 4], adv=[1.0, -1.0, 1.0, -1.0],
                     versions=[5, 4, 2, -1]),
        current_version=5, max_response_length=8)
    gauges, hists = led.finalize_step(1)
    assert gauges["training/staleness_known_frac"] == pytest.approx(12 / 16)
    assert gauges["training/staleness_frac_stale"] == pytest.approx(8 / 12)
    assert gauges["training/staleness_max"] == 3.0
    st = hists["training/staleness"]
    assert st.count == 12 and st.vmax == 3.0
    assert st.mean == pytest.approx((0 * 4 + 1 * 4 + 3 * 4) / 12)
    row = led.tail[-1]
    assert row["staleness_max"] == 3.0 and row["staleness_p95"] >= 2.0


def test_ledger_tis_and_logprob_delta_distributions():
    led = TrainingHealthLedger()
    n, tr = 2, 4
    led.observe_ibatch(
        advantages=np.ones((n, tr)), response_mask=np.ones((n, tr)),
        group_ids=np.asarray([0, 1]), traj_rewards=np.asarray([1.0, 0.0]),
        old_log_probs=np.zeros((n, tr)) + 0.5,
        rollout_log_probs=np.zeros((n, tr)),
        tis_weights=np.full((n, tr), 1.5), max_response_length=tr)
    gauges, hists = led.finalize_step(1)
    assert hists["training/tis_weight"].mean == pytest.approx(1.5)
    assert hists["training/logprob_delta_abs"].mean == pytest.approx(0.5)
    assert gauges["training/logprob_delta_mean"] == pytest.approx(0.5)


def test_histogram_observe_many_matches_observe():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.lognormal(0.0, 2.0, 500),
                           np.zeros(7), -rng.random(5)])
    a, b = Histogram(), Histogram()
    for v in vals:
        a.observe(float(v))
    b.observe_many(vals)
    assert a.buckets == b.buckets
    assert (a.count, a.zeros) == (b.count, b.zeros)
    assert a.total == pytest.approx(b.total)
    assert (a.vmin, a.vmax) == (b.vmin, b.vmax)
    for q in (50.0, 95.0, 99.0):
        assert a.percentile(q) == b.percentile(q)


def test_detector_collapse_fires_healthy_rise_does_not():
    det = AnomalyDetector(z_threshold=4.0, warmup=3, min_sigma_frac=0.1,
                          direction="low")
    for v in (2.0, 2.05, 1.95, 2.0):
        assert det.observe(v) is None
    assert det.observe(4.0) is None
    assert abs(det.mean - 2.0) < 0.1
    assert det.observe(2.0) is None
    z = det.observe(0.01)
    assert z is not None and z < -4.0
    det_hi = AnomalyDetector(z_threshold=4.0, warmup=3, min_sigma_frac=0.1,
                             direction="high")
    for v in (2.0, 2.05, 1.95, 2.0):
        det_hi.observe(v)
    assert det_hi.observe(0.01) is None
    assert det_hi.observe(40.0) is not None


def test_default_watch_directions_and_spec_forms(tmp_path):
    assert DEFAULT_WATCH["perf/step_time_s"] == "both"
    assert DEFAULT_WATCH["training/entropy"] == "low"
    assert DEFAULT_WATCH["training/approx_kl"] == "high"
    rec = FlightRecorder(str(tmp_path), watch=("perf/step_time_s",
                                               ("training/entropy", "low")))
    assert rec._detectors["perf/step_time_s"].direction == "both"
    assert rec._detectors["training/entropy"].direction == "low"


def test_statusz_v4_training_section_always_present():
    from polyrl_tpu_torch.obs import statusz

    assert statusz.SCHEMA == "polyrl/statusz/v8"
    for role in ("trainer", "rollout"):
        snap = statusz.build_snapshot(role)
        for section in statusz.REQUIRED_SECTIONS:
            assert section in snap, f"{role} missing {section}"
        assert snap["training"] == {}
    led = TrainingHealthLedger()
    led.observe_ibatch(**_mk_ibatch(rewards=[1.0, 0.0], group_ids=[0, 0],
                                    lens=[2, 2], adv=[1.0, -1.0]),
                       max_response_length=4)
    led.finalize_step(1)
    snap = statusz.build_snapshot("trainer", training=led.snapshot())
    assert snap["training"]["steps"] == 1
    assert snap["training"]["tail"][-1]["step"] == 1
    assert "training/degenerate_group_frac" in snap["training"]["last"]


# -- a port fit ---------------------------------------------------------------


class _FakeStaleRollout:
    """Engine-shaped stub whose tokens alternate between the current push
    version and the one before."""

    def __init__(self):
        self.pad_token_id = 0
        self.weight_version = 0
        self.last_gen_throughput = 0.0

    def generate(self, prompts, sampling, rng=None, **kw):
        out = []
        for i, p in enumerate(prompts):
            n = (sampling.max_new_tokens if i % 2
                 else max(sampling.max_new_tokens // 2, 1))
            out.append({
                "token_ids": [1 + (len(p) + j) % 200 for j in range(n)],
                "logprobs": [-0.5] * n,
                "weight_versions": [max(self.weight_version - (j % 2), 0)
                                    for j in range(n)]})
        return out

    def update_weights(self, params, version=None):
        self.weight_version += 1


def _tiny_actor():
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    mcfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                              max_position_embeddings=128)
    params = decoder.init_params(torch.Generator().manual_seed(0), mcfg)
    return StreamActor(mcfg, ActorConfig(lr=1e-4, remat=False), params)


def test_e2e_fit_training_records_and_entropy_collapse_bundle(tmp_path):
    from polyrl_tpu_torch.data.dataset import (PromptDataLoader,
                                               make_arithmetic_dataset)
    from polyrl_tpu_torch.rewards.manager import load_reward_manager
    from polyrl_tpu_torch.trainer.stream_trainer import (StreamRLTrainer,
                                                         TrainerConfig)
    from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="grpo", total_steps=7, rollout_is_correction=True)
    actor = _tiny_actor()
    script = {4: 4.0, 6: 0.01}
    box = []
    orig_update = actor.update_stream

    def scripted_update(feed, is_opt, loss_scale=1.0):
        m = dict(orig_update(feed, is_opt, loss_scale=loss_scale))
        m["actor/entropy"] = script.get(box[0].global_step, 2.0)
        return m

    actor.update_stream = scripted_update
    recorder = FlightRecorder(str(tmp_path), keep_steps=16, z_threshold=4.0,
                              warmup=3, min_sigma_frac=0.1,
                              watch={"training/entropy": "low"})
    trainer = StreamRLTrainer(
        tcfg, actor, _FakeStaleRollout(), tok,
        load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(64), 4), recorder=recorder)
    box.append(trainer)
    srv = trainer.start_statusz()
    try:
        history = trainer.fit()
        assert len(history) == 7
        for rec in history:
            for k in ("training/degenerate_group_frac",
                      "training/effective_batch_frac", "training/entropy",
                      "training/adv_abs/p50", "training/response_len/max",
                      "training/tis_weight/mean", "training/staleness/p95"):
                assert k in rec, k
            assert rec["training/staleness_known_frac"] == 1.0
        assert history[-1]["training/staleness_max"] >= 1.0
        assert history[-1]["training/staleness_frac_stale"] > 0.0
        assert history[3]["training/entropy"] == 2.0
        assert history[4]["training/entropy"] == 4.0
        assert recorder.anomalies == 1 and len(recorder.bundle_paths) == 1
        bundle = recorder.bundle_paths[0]
        counters = json.load(open(os.path.join(bundle, "counters.json")))
        assert counters["reason"] == "anomaly"
        assert "training/entropy" in counters["detail"]
        training = json.load(open(os.path.join(bundle, "training.json")))
        assert training["steps"] == 7 and len(training["tail"]) == 7
        assert training["tail"][-1]["entropy"] == pytest.approx(0.01)
        assert training["last_groups"] and all(
            "reward_mean" in g and "degenerate" in g
            for g in training["last_groups"])
        with urllib.request.urlopen(f"http://{srv.endpoint}/statusz",
                                    timeout=10.0) as r:
            snap = json.loads(r.read())
        assert snap["schema"] == "polyrl/statusz/v8"
        assert snap["training"]["steps"] == 7
        assert snap["training"]["last"][
            "training/entropy"] == pytest.approx(0.01)
        assert snap["gauges"]["training/staleness_max"] >= 1.0
    finally:
        trainer.stop_statusz()


def test_health_ledger_can_be_disabled():
    from polyrl_tpu_torch.trainer.stream_trainer import (StreamRLTrainer,
                                                         TrainerConfig)
    from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

    class _R:
        pad_token_id = 0
        weight_version = 0
        last_gen_throughput = 0.0

    tcfg = TrainerConfig(train_batch_size=4, rollout_n=2,
                         ppo_mini_batch_size=8, micro_batch_size=4,
                         min_stream_batch_size=4, total_steps=1)
    trainer = StreamRLTrainer(tcfg, _tiny_actor(), _R(), ByteTokenizer(),
                              None, None, health=False)
    assert trainer._health is None
    assert trainer.statusz_snapshot()["training"] == {}
