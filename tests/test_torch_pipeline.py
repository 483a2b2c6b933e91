"""The port's pipelined trainer (``trainer/pipeline.py``) on the CPU:
``pipeline_depth=0`` equal to a hand-rolled serial loop, depth 1 with
overlap and staleness within the limit and equal to the serial loop when
the fence holds, depth 2 with the bounded-staleness admission gate, a
mid-stream error that drains cleanly, the ``wait_pushed`` fence before
the next generation, and the truncated importance weights against numpy.

The rollout is a deterministic engine-shaped fake (tokens a function of
prompt length and position, optional delays and failure injection, the
asynchronous push surface the pipelined trainer fences on), as in the JAX
package's own pipeline tests, so the tests isolate scheduling from the
engine. Comparisons are bitwise: f32 on the CPU, the same operations in
the same order.
"""

import threading
import time

import numpy as np
import pytest
import torch

from polyrl_tpu_torch.data.dataset import PromptDataLoader, make_arithmetic_dataset
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.ops import core_algos
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor, _leaves
from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
from polyrl_tpu_torch.utils.metrics import MetricsTracker
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer


class FakeRollout:
    """Deterministic engine-shaped stub with the asynchronous push surface
    (``update_weights_async``, ``wait_pushed``, ``wait_push_lag``,
    ``push_lag``). ``stamp_versions`` tags each token with the version
    current when its generation started."""

    def __init__(self, gen_delay_s: float = 0.0, push_delay_s: float = 0.0,
                 fail_on_call: int = -1, stamp_versions: bool = False):
        self.pad_token_id = 0
        self.weight_version = 0
        self.last_gen_throughput = 0.0
        self.gen_delay_s = gen_delay_s
        self.push_delay_s = push_delay_s
        self.fail_on_call = fail_on_call
        self.stamp_versions = stamp_versions
        self.generate_calls = 0
        self.async_pushes = 0
        self.fence_waits = 0
        self.violations: list[str] = []
        self.gen_versions: list[int] = []
        self._lock = threading.Lock()
        self._in_flight: list[threading.Thread] = []

    def generate(self, prompts, sampling, rng=None, **kw):
        self.generate_calls += 1
        if self.generate_calls == self.fail_on_call:
            raise RuntimeError("injected mid-stream generation failure")
        self.gen_versions.append(self.weight_version)
        version = self.weight_version
        if self.gen_delay_s:
            time.sleep(self.gen_delay_s)
        n = sampling.max_new_tokens
        return [{"token_ids": [1 + (len(p) + i) % 200 for i in range(n)],
                 "logprobs": [-0.5] * n,
                 "weight_versions": [version] * n if self.stamp_versions else []}
                for p in prompts]

    def update_weights(self, params, version=None):
        self.weight_version += 1

    def update_weights_async(self, params, version=None):
        self.weight_version += 1
        self.async_pushes += 1

        def finish():
            if self.push_delay_s:
                time.sleep(self.push_delay_s)

        t = threading.Thread(target=finish, name="weight-push", daemon=True)
        with self._lock:
            self._in_flight.append(t)
        t.start()
        return self.weight_version

    def push_lag(self) -> int:
        with self._lock:
            self._in_flight = [t for t in self._in_flight if t.is_alive()]
            return len(self._in_flight)

    def wait_push_lag(self, max_lag: int) -> None:
        self.fence_waits += 1
        while self.push_lag() > max_lag:
            time.sleep(0.005)

    def wait_pushed(self, timeout=None):
        self.fence_waits += 1
        with self._lock:
            threads = list(self._in_flight)
        self.fenced = threads
        for t in threads:
            t.join(timeout)


class FencedRollout(FakeRollout):
    """Flags a generation not preceded by a fence since the last one, or
    started while a push begun before that fence is still in flight (a
    push the foreground begins after the fence may overlap the stream: a
    half-landed push is the rollout's to hide)."""

    fenced: list = []
    _fences_seen = 0

    def generate(self, prompts, sampling, rng=None, **kw):
        n = self.generate_calls + 1
        if self.fence_waits == self._fences_seen:
            self.violations.append(f"generate #{n} without a fence before it")
        self._fences_seen = self.fence_waits
        if any(t.is_alive() for t in self.fenced):
            self.violations.append(
                f"generate #{n} started during a fenced weight push")
        return super().generate(prompts, sampling, rng, **kw)


def make_trainer(rollout, total_steps=2, depth=0, **cfg_kw):
    mcfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                              max_position_embeddings=128)
    params = decoder.init_params(torch.Generator().manual_seed(0), mcfg)
    tok = ByteTokenizer()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="grpo", total_steps=total_steps,
        pipeline_depth=depth, **cfg_kw)
    actor = StreamActor(mcfg, ActorConfig(lr=1e-4, remat=False), params)
    return StreamRLTrainer(
        tcfg, actor, rollout, tok,
        load_reward_manager("naive", tok,
                            compute_score=lambda ds, txt, gt, ex: float(len(txt) % 7),
                            num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size))


def _deterministic(record: dict) -> dict:
    """Drop the wall-clock keys (phase timings, perf, and the goodput
    split of the step's wall); what is left must replay bitwise."""
    return {k: v for k, v in record.items()
            if not k.startswith(("timing_s/", "perf/", "goodput/"))}


def _same_params(a, b) -> bool:
    return all(torch.equal(x.detach(), y.detach()) for (_, x), (_, y) in
               zip(_leaves(a.actor.params), _leaves(b.actor.params)))


def _records_agree(hist_a, hist_b) -> None:
    assert len(hist_a) == len(hist_b)
    for rec_a, rec_b in zip(hist_a, hist_b):
        det_a, det_b = _deterministic(rec_a), _deterministic(rec_b)
        shared = set(det_a) & set(det_b)
        assert {"actor/pg_loss", "reward/mean", "actor/entropy_rollout",
                "training/global_step"} <= shared
        for k in sorted(shared):
            assert det_a[k] == det_b[k], f"{k}: {det_a[k]!r} != {det_b[k]!r}"


def test_depth0_identical_to_serial_reference():
    """pipeline_depth=0 is the serial loop: a hand-rolled composition of
    the fit body (records -> _ibatch_iter -> _train_one_batch -> blocking
    push) and fit() agree bitwise on parameters and on every metric that
    is not a wall-clock reading, and the serial loop grows no pipeline
    keys."""
    t_fit = make_trainer(FakeRollout(), total_steps=2, depth=0)
    hist_fit = t_fit.fit()

    t_ref = make_trainer(FakeRollout(), total_steps=2, depth=0)
    t_ref._push_weights()
    hist_ref = []
    while t_ref.global_step < t_ref.cfg.total_steps:
        metrics = MetricsTracker()
        records = next(t_ref.dataloader)
        t_ref._train_one_batch(
            lambda: t_ref._ibatch_iter(records, None, metrics), metrics)
        t_ref._push_weights()
        t_ref.global_step += 1
        metrics.update({"training/global_step": t_ref.global_step})
        hist_ref.append(metrics.as_dict())

    _records_agree(hist_fit, hist_ref)
    for rec in hist_fit:
        assert "perf/pipeline_overlap_s" not in rec
        assert "perf/weight_staleness" not in rec
    assert _same_params(t_fit, t_ref)
    assert t_fit.rollout.async_pushes == 0


def test_depth1_overlap_and_staleness():
    """depth=1: each record carries the overlap and the staleness and
    queue gauges; from step 2 on the stream was produced while the
    previous step trained (overlap > 0), and its tokens are at most one
    version behind the weights they are trained against."""
    rollout = FakeRollout(gen_delay_s=0.15, stamp_versions=True)
    trainer = make_trainer(rollout, total_steps=3, depth=1,
                           rollout_is_correction=True)
    hist = trainer.fit()
    assert len(hist) == 3
    for rec in hist:
        assert rec["perf/pipeline_overlap_s"] >= 0.0
        assert rec["perf/weight_staleness"] >= 0.0
        assert "perf/pipeline_queue_depth" in rec
        assert "timing_s/prefetch_fence" in rec and "timing_s/gen" in rec
        assert rec["perf/staleness_limit"] == 1.0
        assert "actor/tis_weight_mean" in rec
        assert 0.0 <= rec["actor/tis_clip_frac"] <= 1.0
    assert any(rec["perf/pipeline_overlap_s"] > 0.0 for rec in hist[1:])
    assert any(rec["perf/weight_staleness"] >= 1.0 for rec in hist[1:])
    # generation i started at version >= i (bootstrap is version 1), so
    # each step's tokens trail the trained weights by at most one version
    for step, v in enumerate(rollout.gen_versions):
        assert step + 1 - v <= 1, (step, v)
    assert rollout.weight_version == 4
    assert not any(t.name == "rollout-pipeline" and t.is_alive()
                   for t in threading.enumerate())


def test_depth1_limit1_fenced_equals_serial():
    """staleness_limit=1 takes the full fence before every stream; with a
    fake whose token versions are unknown, the truncated importance
    weights are 1, and the depth-1 fit agrees bitwise with the serial
    loop on parameters and every non-wall-clock metric."""
    r_async = FencedRollout(push_delay_s=0.05)
    t_async = make_trainer(r_async, total_steps=2, depth=1,
                           rollout_is_correction=True)
    hist_async = t_async.fit()
    assert r_async.violations == []
    assert r_async.fence_waits >= 2 and r_async.async_pushes == 2
    t_serial = make_trainer(FakeRollout(), total_steps=2,
                            rollout_is_correction=True)
    hist_serial = t_serial.fit()
    _records_agree(hist_async, hist_serial)
    for rec in hist_async:
        assert rec["actor/tis_weight_mean"] == 1.0
        assert rec["actor/tis_clip_frac"] == 0.0
    assert _same_params(t_async, t_serial)


def test_depth2_admission_gate_holds_the_limit():
    """depth=2, staleness_limit=2: a stream may start with one push in
    flight but never two (``perf/staleness_lag`` <= limit - 1 at every
    stream start), and the fit's end drains every push."""
    rollout = FakeRollout(gen_delay_s=0.1, push_delay_s=0.25,
                          stamp_versions=True)
    trainer = make_trainer(rollout, total_steps=4, depth=2, staleness_limit=2,
                           rollout_is_correction=True)
    hist = trainer.fit()
    assert len(hist) == 4
    lags = [h["perf/staleness_lag"] for h in hist]
    assert all(lag <= 1 for lag in lags)
    assert all(h["perf/staleness_limit"] == 2.0 for h in hist)
    assert rollout.push_lag() == 0 and rollout.violations == []


def test_depth1_mid_stream_error_drains_cleanly():
    """A generation failure on the producer lane surfaces as the original
    exception on the foreground, and the producer thread is gone after."""
    trainer = make_trainer(FakeRollout(fail_on_call=2), total_steps=3, depth=1)
    with pytest.raises(RuntimeError, match="injected mid-stream"):
        trainer.fit()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            t.name == "rollout-pipeline" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "rollout-pipeline" and t.is_alive()
                   for t in threading.enumerate())


def test_consumer_error_closes_the_producer():
    """A failure on the foreground (here the reward) closes the pipeline:
    the producer, parked on the credit gate or the queue, exits."""
    trainer = make_trainer(FakeRollout(gen_delay_s=0.05), total_steps=3,
                           depth=1)

    def boom(batch):
        raise ValueError("reward failed")

    trainer.reward_manager = boom
    with pytest.raises(ValueError, match="reward failed"):
        trainer.fit()
    assert not any(t.name == "rollout-pipeline" and t.is_alive()
                   for t in threading.enumerate())


def test_wait_pushed_fences_next_generation():
    """No generation starts while an asynchronous push is in flight: the
    producer takes the ``wait_pushed`` fence first, and fit drains the
    last push before it returns."""
    rollout = FencedRollout(push_delay_s=0.2)
    trainer = make_trainer(rollout, total_steps=3, depth=1)
    trainer.fit()
    assert rollout.violations == []
    assert rollout.async_pushes == 3
    assert rollout.fence_waits >= 3
    assert rollout.push_lag() == 0


def test_async_push_hands_over_a_snapshot():
    """The asynchronous push receives a copy of the actor's weights taken
    when the push starts: the next in-place optimizer step does not change
    what the rollout got."""
    got = []

    class Recording(FakeRollout):
        def update_weights_async(self, params, version=None):
            got.append(params)
            return super().update_weights_async(params, version)

    trainer = make_trainer(Recording(), total_steps=2, depth=1)
    trainer.fit()
    first = dict(_leaves(got[0]))
    last = dict(_leaves(trainer.actor.params))
    assert any(not torch.equal(first[k], last[k].detach()) for k in first)
    for k, v in _leaves(got[-1]):
        assert torch.equal(v, last[k].detach()) and v.data_ptr() != last[k].data_ptr()


def test_tis_weights_match_numpy_reference():
    rng = np.random.default_rng(7)
    old = rng.normal(scale=0.7, size=(5, 9)).astype(np.float32)
    beh = rng.normal(scale=0.7, size=(5, 9)).astype(np.float32)
    mask = (rng.random((5, 9)) > 0.3).astype(np.float32)
    cap = 1.5
    w, raw, mean_w, clip_frac = core_algos.truncated_importance_weights(
        torch.from_numpy(old), torch.from_numpy(beh), torch.from_numpy(mask),
        cap=cap)
    ratio = np.exp(np.clip(old - beh, -20.0, 20.0))
    w_ref = np.minimum(ratio, cap) * mask
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(raw.numpy(), ratio, rtol=1e-5)
    denom = mask.sum()
    np.testing.assert_allclose(float(mean_w), w_ref.sum() / denom, rtol=1e-4)
    np.testing.assert_allclose(float(clip_frac),
                               ((ratio > cap) * mask).sum() / denom, rtol=1e-4)
    assert float(w.max()) <= cap + 1e-6
    # the mixed-version weights the trainer applies: per token, unknown
    # versions excluded (weight 1), the rest the same truncated ratio
    wv = rng.integers(-1, 3, size=(5, 9)).astype(np.int32)
    wm, _, stats = core_algos.mixed_version_importance_weights(
        old, beh, mask, wv, current_version=2, cap=cap)
    known, unknown = (mask > 0) & (wv >= 0), (mask > 0) & (wv < 0)
    want = np.where(known, np.minimum(ratio, cap), 0.0)
    want[unknown] = 1.0
    np.testing.assert_allclose(wm, want.astype(np.float32), rtol=1e-6, atol=1e-7)
    assert stats["max_lag"] <= 2 and np.isfinite(wm).all()


def test_config_validation():
    base = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
                micro_batch_size=4, min_stream_batch_size=4)
    with pytest.raises(ValueError, match="pipeline_depth"):
        TrainerConfig(pipeline_depth=-1, **base)
    with pytest.raises(ValueError, match="rollout_is_cap"):
        TrainerConfig(rollout_is_cap=0.0, **base)
    with pytest.raises(ValueError, match="staleness_limit"):
        TrainerConfig(pipeline_depth=1, staleness_limit=2, **base)
