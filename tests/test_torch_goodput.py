"""The port's goodput ledger, anomaly detector, flight recorder, /statusz
exporter, Prometheus rendering and scrape degradation, held against the
JAX package's on the same inputs (``tests/test_goodput.py``, less its
``tools/`` tests).

The one difference kept on purpose: the port's ``account()`` nets the
``manager/rtt_s`` round trips that fell inside the stream wait out of
``bubble`` (``rtt_in_bubble_s``), and keeps those inside the push or
before the step out of ``manager_rtt`` (``rtt_elsewhere_s``), where the
reference counts them twice.
Without such round trips both ledgers give equal dicts; with them the
port's ``attributed_frac`` stays <= 1.05 where the reference's exceeds it.
"""

import json
import os
import types
import urllib.error
import urllib.request

import pytest
import torch

from polyrl_tpu.obs import goodput as j_goodput
from polyrl_tpu.obs import recorder as j_recorder
from polyrl_tpu.obs import statusz as j_statusz
from polyrl_tpu.obs.histogram import Histogram as JHistogram
from polyrl_tpu_torch import obs
from polyrl_tpu_torch.obs import goodput, recorder, statusz
from polyrl_tpu_torch.obs.histogram import Histogram
from polyrl_tpu_torch.obs.trace import is_clock_anchor

PKGS = {"jax": (j_goodput, j_recorder, j_statusz, JHistogram),
        "torch": (goodput, recorder, statusz, Histogram)}


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return json.loads(r.read())


def _hist(cls, *vals):
    h = cls()
    for v in vals:
        h.observe(v)
    return h


STEP = dict(
    step_time_s=4.0,
    timings={"gen": 0.5, "broadcast": 0.1, "reward": 0.2,
             "old_log_prob": 0.3, "adv": 0.1, "update_actor": 0.8,
             "update_critic": 0.2, "update_weight": 0.25,
             "prefetch_fence": 0.05, "testing": 0.4, "save_checkpoint": 0.1},
    bubble_s=1.0, overlap_s=0.7, n_tokens=2000, mean_context_len=128.0,
    n_chips=2)


def _account(pkg, rtt_vals=(0.15, 0.05), **kw):
    mod, _, _, hcls = PKGS[pkg]
    step = dict(STEP, **kw)
    hists = {"manager/rtt_s": _hist(hcls, *rtt_vals),
             "rollout/resume_wait_s": _hist(hcls, 0.3),
             "rollout/latency_s": _hist(hcls, 0.15)}  # not a phase
    return mod.GoodputLedger().account(histograms=hists, **step)


# -- attribution ledger ------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ledger_phases_are_exhaustive_and_nonoverlapping(pkg):
    mod = PKGS[pkg][0]
    out = _account(pkg)
    assert sum(out[f"goodput/{p}_s"] for p in mod.PHASES) == pytest.approx(4.0)
    assert out["goodput/bubble_s"] == pytest.approx(1.0 - 0.5 - 0.1)
    assert out["goodput/generate_s"] == pytest.approx(0.5)
    assert out["goodput/process_s"] == pytest.approx(0.7)
    assert out["goodput/update_s"] == pytest.approx(1.0)
    assert out["goodput/weight_push_s"] == pytest.approx(0.3)
    assert out["goodput/housekeeping_s"] == pytest.approx(0.5)
    assert out["goodput/manager_rtt_s"] == pytest.approx(0.2)
    assert out["goodput/salvage_resume_s"] == pytest.approx(0.3)
    assert out["goodput/overlap_credit_s"] == pytest.approx(0.7)
    assert 0.0 < out["goodput/attributed_frac"] <= 1.0
    assert out["goodput/tok_s_per_chip"] == pytest.approx(2000 / 4.0 / 2)
    led = mod.GoodputLedger()
    led.account(**dict(STEP, n_tokens=0))
    led.account(step_time_s=2.0, timings={"update_actor": 1.0})
    snap = led.snapshot()
    assert snap["steps"] == 2 and snap["wall_s"] == pytest.approx(6.0)
    assert snap["phase_s"]["update"] == pytest.approx(2.0)
    assert sum(snap["phase_frac"].values()) == pytest.approx(1.0, abs=1e-3)


def test_account_equals_reference_without_rtt_inside_the_bubble():
    """With no round trip inside the wait (``rtt_in_bubble_s`` 0) the
    port's ledger is the reference's, key for key, bit for bit."""
    assert _account("torch") == _account("jax")
    snaps = []
    for pkg in ("jax", "torch"):
        mod, _, _, hcls = PKGS[pkg]
        led = mod.GoodputLedger()
        led.account(histograms={"manager/rtt_s": _hist(hcls, 0.1)}, **STEP)
        led.account(step_time_s=1.5, timings={"update_actor": 0.5},
                    bubble_s=0.25)
        snap = led.snapshot()
        snap["last"].pop("goodput/mfu", None)
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_rtt_inside_the_bubble_is_counted_once():
    """A disaggregated step: the stream's manager round trips run while
    the trainer waits on it, so the wait (bubble) already holds them. The
    reference adds the rtt total on top and overshoots the wall; the port
    nets them out of the bubble and stays within 1.05."""
    step = dict(step_time_s=10.0, timings={"reward": 0.5,
                                          "old_log_prob": 1.0,
                                          "update_actor": 2.0,
                                          "update_weight": 2.0},
                bubble_s=4.0, overlap_s=0.0, n_tokens=0)
    rtts = (0.3,) * 4  # 1.2 s of round trips, all inside the 4 s wait
    ref = _account("jax", rtt_vals=rtts, **step)
    port = _account("torch", rtt_vals=rtts, rtt_in_bubble_s=1.2, **step)
    assert ref["goodput/attributed_frac"] > 1.05
    assert port["goodput/attributed_frac"] <= 1.05
    assert port["goodput/bubble_s"] == pytest.approx(4.0 - 1.2)
    assert port["goodput/manager_rtt_s"] == ref["goodput/manager_rtt_s"]
    assert (sum(port[f"goodput/{p}_s"] for p in goodput.PHASES)
            == pytest.approx(10.0))
    # the net never goes below zero
    over = _account("torch", rtt_vals=rtts, rtt_in_bubble_s=9.0, **step)
    assert over["goodput/bubble_s"] == 0.0
    # round trips inside the push (weight_push holds them) or before the
    # step stay out of manager_rtt
    push = _account("torch", rtt_vals=rtts + (0.5,), rtt_in_bubble_s=1.2,
                    rtt_elsewhere_s=0.5, **step)
    assert push["goodput/manager_rtt_s"] == pytest.approx(1.2)
    assert push["goodput/attributed_frac"] == pytest.approx(
        port["goodput/attributed_frac"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ledger_overflow_is_visible_not_negative(pkg):
    out = PKGS[pkg][0].GoodputLedger().account(
        step_time_s=1.0, timings={"update_actor": 0.9, "reward": 0.8})
    assert out["goodput/other_s"] == 0.0
    assert out["goodput/attributed_frac"] == pytest.approx(1.7)


def test_ledger_mfu_from_model_flops():
    """MFU over the port's ``FlopsCounter`` (the H100's bf16 peak by
    default) equals the reference's on the same model shapes and peak."""
    import jax.numpy as jnp

    from polyrl_tpu.models import decoder as jdec
    from polyrl_tpu.utils.flops import FlopsCounter as JFlops
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.utils.flops import FlopsCounter

    tcfg = decoder.get_config("tiny", dtype=torch.float32)
    jcfg = jdec.get_config("tiny", dtype=jnp.float32)
    outs = [mod.GoodputLedger(flops=fc(cfg, n_chips=1, peak_tflops=100.0))
            .account(step_time_s=1.0, timings={}, n_tokens=1000,
                     mean_context_len=64.0)
            for mod, fc, cfg in ((goodput, FlopsCounter, tcfg),
                                 (j_goodput, JFlops, jcfg))]
    assert outs[0]["goodput/mfu"] > 0.0
    assert outs[0]["goodput/tflops_per_chip"] == pytest.approx(
        outs[0]["goodput/mfu"] * 100.0)
    assert outs[0]["goodput/mfu"] == pytest.approx(outs[1]["goodput/mfu"],
                                                   rel=1e-6)
    assert FlopsCounter(tcfg).peak_tflops == pytest.approx(989.0)


# -- anomaly detector --------------------------------------------------------


SERIES = {
    "cold_start": ([20.0, 1.0, 1.1, 1.05, 5.0, 1.0], dict(warmup=3)),
    "sigma_floor": ([1.0, 1.0, 1.0, 1.2, 3.0], dict(warmup=3)),
    "collapse": ([10.0, 10.0, 10.1, 0.5, 10.0], dict(warmup=3)),
    "low_only": ([5.0, 5.0, 5.1, 12.0, 0.5], dict(warmup=3,
                                                 direction="low")),
    "ewma": ([1.0, 1.2, 0.9, 1.1, 1.0, 1.3, 0.95, 1.6, 4.0, 1.0],
             dict(warmup=4, alpha=0.3)),
}


@pytest.mark.parametrize("case", sorted(SERIES))
def test_detector_matches_reference(case):
    """Same samples, same z-scores (None where quiet), same state."""
    vals, kw = SERIES[case]
    dets = [recorder.AnomalyDetector(**kw), j_recorder.AnomalyDetector(**kw)]
    for v in vals:
        zs = [d.observe(v) for d in dets]
        assert zs[0] == zs[1], (case, v, zs)
    assert dets[0].state() == dets[1].state()


def test_detector_median_warmup_survives_cold_start_outlier():
    det = recorder.AnomalyDetector(z_threshold=4.0, warmup=3)
    for v in (20.0, 1.0, 1.1):
        assert det.observe(v) is None
    assert det.mean == pytest.approx(1.1)
    assert det.observe(1.05) is None
    z = det.observe(5.0)
    assert z is not None and z > 4.0
    assert det.observe(1.0) is None


def test_direction_violates_matches_reference():
    for d in recorder.DIRECTIONS:
        for x in (-1.0, 0.0, 2.0):
            assert (recorder.direction_violates(d, x)
                    == j_recorder.direction_violates(d, x))
    with pytest.raises(ValueError):
        recorder.direction_violates("up", 1.0)
    assert recorder.DEFAULT_WATCH == j_recorder.DEFAULT_WATCH


# -- flight recorder ---------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_recorder_one_stall_one_bundle(pkg, tmp_path):
    """One injected stall: one anomaly, one bundle of the reference's
    files (trace ring with its clock anchor, step records, stacks,
    counters); no CUDA memory snapshot without a card."""
    mod = PKGS[pkg][1]
    tobs = obs if pkg == "torch" else __import__("polyrl_tpu.obs",
                                                 fromlist=["span"])
    tobs.configure(trace=True, reset=True)
    try:
        with tobs.span("trainer/step", step=1):
            pass
        rec = mod.FlightRecorder(str(tmp_path), keep_steps=8, warmup=3,
                                 z_threshold=4.0,
                                 watch=("perf/step_time_s",))
        rec.counters_fn = lambda: {"fault/stream_resumes": 2.0}
        for i, v in enumerate([1.0, 1.05, 0.95, 1.0, 6.0, 1.0, 0.9, 1.1]):
            rec.record_step(i + 1, {"perf/step_time_s": v,
                                    "actor/pg_loss": 0.1})
        assert rec.anomalies == 1 and len(rec.bundle_paths) == 1
        bundle = rec.bundle_paths[0]
        assert sorted(os.listdir(bundle)) == [
            "counters.json", "spans.jsonl", "stacks.txt", "steps.jsonl"]
        spans = [json.loads(ln) for ln in
                 open(os.path.join(bundle, "spans.jsonl"))]
        assert is_clock_anchor(spans[0])
        assert any(s.get("name") == "trainer/step" for s in spans)
        steps = [json.loads(ln) for ln in
                 open(os.path.join(bundle, "steps.jsonl"))]
        assert len(steps) <= 8 and steps[-1]["perf/step_time_s"] == 6.0
        counters = json.load(open(os.path.join(bundle, "counters.json")))
        assert counters["reason"] == "anomaly"
        assert counters["fault_counters"]["fault/stream_resumes"] == 2.0
        assert counters["detectors"]["perf/step_time_s"]["warmed"]
        assert rec.counters() == {"obs/anomalies": 1.0, "obs/bundles": 1.0}
    finally:
        tobs.configure(trace=False, reset=True)


def test_recorder_bundle_budget_and_crash_dump(tmp_path):
    rec = recorder.FlightRecorder(str(tmp_path), warmup=2, max_bundles=2,
                                  watch=("perf/step_time_s",))
    assert rec.dump("crash-RuntimeError", detail="boom") is not None
    assert rec.dump("sigterm") is not None
    assert rec.dump("anomaly") is None
    assert rec.bundles_dropped == 1 and len(rec.bundle_paths) == 2
    assert recorder.FlightRecorder("/proc/not-writable").dump("crash") is None


def test_recorder_memory_snapshot_is_best_effort(tmp_path, monkeypatch):
    """With a card the bundle gains ``memory_snapshot.pickle`` (the caching
    allocator's snapshot); a failure there costs only that file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.memory, "_snapshot",
                        lambda: {"segments": [], "device_traces": []})
    rec = recorder.FlightRecorder(str(tmp_path / "a"))
    path = rec.dump("manual")
    import pickle

    with open(os.path.join(path, recorder.MEMORY_SNAPSHOT), "rb") as f:
        assert pickle.load(f) == {"segments": [], "device_traces": []}

    def boom():
        raise RuntimeError("allocator snapshot failed")

    monkeypatch.setattr(torch.cuda.memory, "_snapshot", boom)
    rec = recorder.FlightRecorder(str(tmp_path / "b"))
    path = rec.dump("manual")
    assert sorted(os.listdir(path)) == [
        "counters.json", "spans.jsonl", "stacks.txt", "steps.jsonl"]


# -- /statusz exporter -------------------------------------------------------


def _snap(mod):
    return mod.build_snapshot(
        "trainer", step=7, goodput={"phase_s": {"update": 1.5}},
        histograms=mod.nest_histograms({"rollout/latency_s/p50": 0.2,
                                        "rollout/latency_s/count": 4.0,
                                        "perf/step_time_s": 1.0}),
        counters={"fault/dropped_groups": 0.0},
        gauges={"perf/weight_staleness": 1.0},
        queues={"running": 2.0}, weights={"version": 3.0})


def test_snapshot_schema_and_prometheus_match_reference():
    """The same schema, sections and Prometheus text as the reference's
    (the process fields aside)."""
    assert statusz.SCHEMA == j_statusz.SCHEMA
    assert statusz.REQUIRED_SECTIONS == j_statusz.REQUIRED_SECTIONS
    mine, ref = _snap(statusz), _snap(j_statusz)
    for s in (mine, ref):
        for k in ("time_unix_s", "uptime_s"):
            s.pop(k)
    assert mine == ref
    assert statusz.prometheus_text(mine) == j_statusz.prometheus_text(ref)
    rec = {"a/p50": 1.0, "a/count": 2.0, "b/max": 3.0, "c/p99": 4.0,
           "c/count": 1.0}
    assert statusz.nest_histograms(rec) == j_statusz.nest_histograms(rec)


def test_statusz_server_and_prometheus():
    srv = statusz.StatuszServer(lambda: _snap(statusz)).start()
    try:
        got = _get_json(f"http://{srv.endpoint}/statusz")
        assert got["schema"] == "polyrl/statusz/v8"
        assert got["role"] == "trainer" and got["step"] == 7
        for section in statusz.REQUIRED_SECTIONS:
            assert section in got
        assert set(got["histograms"]) == {"rollout/latency_s"}
        text = urllib.request.urlopen(
            f"http://{srv.endpoint}/metrics", timeout=10.0).read().decode()
        assert "polyrl_statusz_goodput_phase_s_update 1.5" in text
        assert "polyrl_statusz_weights_version 3" in text
        assert obs.parse_prometheus_text(text)[
            "polyrl_statusz_weights_version"] == 3.0
        assert _get_json(f"http://{srv.endpoint}/health")["status"] == "ok"
    finally:
        srv.stop()


def test_statusz_provider_failure_is_a_500_not_a_crash():
    def bad_provider():
        raise RuntimeError("trainer mid-teardown")

    srv = statusz.StatuszServer(bad_provider).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"http://{srv.endpoint}/statusz",
                                   timeout=10.0)
        assert exc_info.value.code == 500
        assert "trainer mid-teardown" in json.loads(
            exc_info.value.read())["error"]
    finally:
        srv.stop()


def test_prometheus_text_skips_non_numeric():
    snap = {"role": "trainer", "x": {"y": 2.0, "z": True, "s": "str"}}
    text = statusz.prometheus_text(snap)
    assert text == j_statusz.prometheus_text(snap)
    assert "polyrl_statusz_x_y 2" in text
    assert "role" not in text and "_z" not in text and "_s " not in text


# -- scrape failure degradation ----------------------------------------------


class _FlakyManager:
    def __init__(self, fail_times: int):
        self.fail_times = fail_times
        self.calls = 0

    def metrics_text(self, timeout: float = 5.0):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise ConnectionError("manager respawning")
        return "polyrl_mgr_running_reqs 3\n"

    def update_metrics(self, **stats):
        return {"max_local_gen_s": 1.5, "num_instances": 2}


def test_scrape_failure_bumps_counter_never_raises():
    from polyrl_tpu_torch.rollout.remote import RemoteRollout

    rr = RemoteRollout(_FlakyManager(fail_times=2))
    assert rr.scrape_manager_metrics() == {}
    assert rr.scrape_manager_metrics() == {}
    assert rr.scrape_manager_metrics() == {"manager/running_reqs": 3.0}
    assert rr.scrape_failures == 2
    assert rr.fault_counters()["obs/scrape_failed"] == 2.0


def test_scrape_failure_never_kills_the_pipeline_lane():
    from polyrl_tpu_torch.trainer.pipeline import RolloutPipeline
    from polyrl_tpu_torch.trainer.stream_trainer import TrainerConfig
    from polyrl_tpu_torch.utils.metrics import MetricsTracker

    class _RaisingRollout:
        def scrape_manager_metrics(self):
            raise ConnectionError("scrape exploded")

        def update_metrics(self, **stats):
            raise AssertionError("must not be reached after scrape raise")

    trainer = types.SimpleNamespace(cfg=TrainerConfig(),
                                    rollout=_RaisingRollout(),
                                    _max_local_gen_s=None)
    pipe = RolloutPipeline(trainer, depth=1)
    pipe.submit_step_stats(step_time_s=1.0, trainer_bubble_s=0.1,
                           throughput=10.0)
    pipe._drain_stats()
    sink = MetricsTracker()
    pipe._fold_gauges(sink)
    assert sink.as_dict() == {}


# -- the trainer's feed ---------------------------------------------------------


class _TailStream:
    """A remote-shaped rollout whose stream ends ``tail_s`` after its last
    chunk (a remote stream's tail; the hybrid's local engine handing its
    KV back at the stream's end)."""

    pad_token_id = 0
    weight_version = 0
    last_gen_throughput = 0.0
    pool = None

    def __init__(self, tail_s: float):
        self.tail_s = tail_s
        self.balance = types.SimpleNamespace(metrics=dict)

    def generate_stream(self, prompts, sampling, group_size, min_emit,
                        max_local_gen_s=None, nested=False):
        yield [(i, {"token_ids": [5 + i % 7] * 4, "logprobs": [-0.5] * 4})
               for i in range(len(prompts))]
        import time

        time.sleep(self.tail_s)

    def update_weights(self, params, version=None):
        self.weight_version += 1

    def fault_counters(self):
        return {}

    def scrape_manager_metrics(self):
        return {}

    def update_metrics(self, **stats):
        return {}


def test_the_wait_that_ends_the_stream_is_bubble():
    """The trainer counts the wait that ends a stream (here a 0.5 s tail)
    as bubble, so the step's wall stays attributed; the reference drops
    that wait and its goodput leaves it in ``other``."""
    from polyrl_tpu_torch.data.dataset import (PromptDataLoader,
                                               make_arithmetic_dataset)
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.rewards.manager import load_reward_manager
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor
    from polyrl_tpu_torch.trainer.stream_trainer import (StreamRLTrainer,
                                                         TrainerConfig)
    from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

    mcfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                              max_position_embeddings=128)
    actor = StreamActor(mcfg, ActorConfig(lr=1e-4, remat=False),
                        decoder.init_params(torch.Generator().manual_seed(0),
                                            mcfg))
    tok = ByteTokenizer()
    tcfg = TrainerConfig(train_batch_size=4, rollout_n=2,
                         ppo_mini_batch_size=8, micro_batch_size=4,
                         min_stream_batch_size=8, max_prompt_length=16,
                         max_response_length=8, total_steps=1)
    trainer = StreamRLTrainer(
        tcfg, actor, _TailStream(0.5), tok,
        load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(16), 4))
    (rec,) = trainer.fit()
    assert rec["perf/trainer_bubble_s"] >= 0.5
    assert rec["goodput/bubble_s"] >= 0.5
    assert 0.95 <= rec["goodput/attributed_frac"] <= 1.05
