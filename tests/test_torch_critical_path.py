"""The port's critical-path extractor held against the JAX package's on the
same span records (``tests/test_critical_path.py``'s pure tests and its
two traced fits; its ``tools/`` tests stay with the reference).

Every synthetic case runs through both extractors and must give the same
``to_dict()`` and ``metrics()``; the traced fits (the port's pipelined
trainer over a fake engine) check the bottleneck flip and that the port's
path over the port's own span ring equals the reference extractor's over
the same records (the ring read after the fit: a step's record was
made before the producer lane's next span closed).
"""

import time

import pytest
import torch

from polyrl_tpu.obs import critical_path as jcp
from polyrl_tpu_torch import obs
from polyrl_tpu_torch.obs.critical_path import (SEGMENTS, classify,
                                                extract_critical_path)

from test_torch_pipeline import FakeRollout, make_trainer


def _span(name, t0_us, dur_us, *, pid=100, tid=1, trace_id="tr",
          span_id="s0", **attrs):
    return {"name": name, "pid": pid, "tid": tid, "trace_id": trace_id,
            "span_id": span_id, "parent_id": "", "ts_us": t0_us,
            "ts_mono_us": t0_us, "dur_us": dur_us, "attrs": attrs}


def _both(recs, **kw):
    """The port's path, after checking it equals the reference's."""
    mine = extract_critical_path(recs, **kw)
    ref = jcp.extract_critical_path(recs, **kw)
    if mine is None or ref is None:
        assert mine is None and ref is None
        return None
    assert mine.to_dict() == ref.to_dict()
    assert mine.metrics() == ref.metrics()
    return mine


def test_no_root_returns_none():
    assert _both([]) is None
    assert _both([_span("trainer/gen", 0, 100)]) is None
    recs = [_span("trainer/step", 0, 100, step=3)]
    assert _both(recs, step=7) is None
    assert _both(recs, step=3) is not None


def test_classify_taxonomy():
    names = ("trainer/gen", "trainer/update_actor", "trainer/update_weight",
             "trainer/prefetch", "rollout/stream", "manager/scrape",
             "transfer/push", "trainer/ibatch_wait", "unknown/span",
             "trainer/testing", "engine/generate")
    for n in names:
        assert classify(n) == jcp.classify(n), n
    assert classify("trainer/prefetch") == "generate"
    assert classify("trainer/ibatch_wait") is None
    assert SEGMENTS == jcp.SEGMENTS


def test_sequential_step_partitions_wall():
    us = 1_000_000
    recs = [
        _span("trainer/step", us, 1_000_000, span_id="root", step=5),
        _span("trainer/gen", us, 400_000, span_id="g"),
        _span("trainer/update_actor", us + 400_000, 500_000, span_id="u"),
    ]
    cp = _both(recs, step=5, wall_s=1.0)
    assert cp.critical_s["generate"] == pytest.approx(0.4)
    assert cp.critical_s["update"] == pytest.approx(0.5)
    assert cp.critical_s["other"] == pytest.approx(0.1)
    assert sum(cp.critical_s.values()) == pytest.approx(cp.wall_s)
    assert cp.bottleneck == "update"
    assert cp.slack_s == pytest.approx(0.6)
    assert cp.headroom_s == pytest.approx(0.05)
    m = cp.metrics()
    assert sum(m[f"critpath/{s}_frac"] for s in SEGMENTS) == pytest.approx(1.0)


def test_hidden_producer_lane_outranks_foreground():
    recs = [
        _span("trainer/step", 0, 500_000, span_id="root", step=1),
        _span("trainer/update_actor", 0, 500_000, span_id="u"),
        _span("trainer/prefetch", 0, 780_000, tid=2, trace_id="lane",
              span_id="p", step=2),
    ]
    cp = _both(recs, step=1, wall_s=0.8)
    assert cp.hidden_s["generate"] == pytest.approx(0.78)
    assert cp.bottleneck == "generate"


@pytest.mark.parametrize("with_lane", [True, False])
def test_wait_covered_by_lane_is_generate_else_bubble(with_lane):
    recs = [
        _span("trainer/step", 0, 1_000_000, span_id="root", step=1),
        _span("trainer/ibatch_wait", 0, 600_000, span_id="w"),
        _span("trainer/update_actor", 600_000, 400_000, span_id="u"),
    ]
    if with_lane:
        recs.append(_span("trainer/prefetch", 0, 550_000, tid=2,
                          trace_id="lane", span_id="p", step=2))
    cp = _both(recs, step=1, wall_s=1.0)
    seg = "generate" if with_lane else "bubble"
    assert cp.critical_s[seg] == pytest.approx(0.6)
    assert cp.bottleneck == seg


def test_nested_generation_inside_wait_attributes_generate():
    recs = [
        _span("trainer/step", 0, 1_000_000, span_id="root", step=1),
        _span("trainer/ibatch_wait", 0, 700_000, span_id="w"),
        _span("trainer/gen", 100_000, 500_000, span_id="g"),
        _span("trainer/update_actor", 700_000, 300_000, span_id="u"),
    ]
    cp = _both(recs, step=1, wall_s=1.0)
    assert cp.critical_s["generate"] == pytest.approx(0.5)
    assert cp.critical_s["bubble"] == pytest.approx(0.2)
    assert cp.critical_s["update"] == pytest.approx(0.3)


def test_step_selection_last_root_wins():
    recs = [
        _span("trainer/step", 0, 1_000_000, span_id="r1", step=1),
        _span("trainer/gen", 0, 900_000, span_id="g1"),
        _span("trainer/step", 2_000_000, 1_000_000, span_id="r2", step=2),
        _span("trainer/update_actor", 2_000_000, 900_000, span_id="u2"),
    ]
    assert _both(recs, step=1).bottleneck == "generate"
    assert _both(recs, step=2).bottleneck == "update"
    assert _both(recs).step == 2


def test_remote_spans_join_on_trace_id():
    recs = [
        _span("trainer/step", 0, 1_000_000, span_id="root", step=1),
        _span("engine/generate", 100_000, 600_000, pid=999, tid=9,
              trace_id="tr", span_id="e1"),
        _span("engine/generate", 100_000, 600_000, pid=999, tid=9,
              trace_id="unrelated", span_id="e2"),
    ]
    cp = _both(recs, step=1, wall_s=1.0)
    assert [r["span_id"] for r in cp.remote] == ["e1"]
    assert sum(cp.critical_s.values()) == pytest.approx(1.0)


# -- traced fits of the port ---------------------------------------------------


def _instant_model(actor) -> None:
    """Logprob and update passes that do no model work, so that no phase
    of the fit can outgrow the fake engine's generation however loaded
    the host is."""
    def log_prob(feed, compute_entropy=True):
        shape = tuple(torch.as_tensor(feed["responses"]).shape)
        return torch.zeros(shape), torch.zeros(shape)

    actor.compute_log_prob = log_prob
    actor.update_stream = (
        lambda feed, is_opt, loss_scale=1.0: {"actor/pg_loss": 0.0})


def _traced_fit(rollout, *, slow_update_s=0.0, total_steps=3,
                instant_model=False):
    obs.configure(trace=True, max_spans=4096, reset=True)
    try:
        trainer = make_trainer(rollout, total_steps=total_steps, depth=1,
                               rollout_is_correction=True)
        if instant_model:
            _instant_model(trainer.actor)
        if slow_update_s:
            orig = trainer.actor.update_stream

            def slow_update(*a, **kw):
                time.sleep(slow_update_s)
                return orig(*a, **kw)

            trainer.actor.update_stream = slow_update
        hist = trainer.fit()
        records = obs.get_tracer().records()
        return trainer, hist, records
    finally:
        obs.configure(trace=False, reset=True)


def _check_reconciliation(hist, records):
    for step, rec in enumerate(hist, start=1):
        assert "critpath/wall_s" in rec, "traced step lost its critpath"
        assert sum(rec[f"critpath/{s}_frac"] for s in SEGMENTS) == \
            pytest.approx(1.0, abs=1e-6)
        wall = rec["goodput/step_wall_s"]
        assert abs(rec["critpath/wall_s"] - wall) <= 0.05 * wall
        # both extractors over the port's whole span ring, after the fit
        assert _both(records, step=step, wall_s=wall) is not None


def test_traced_fit_generate_bound():
    """A slow fake engine (0.6 s a generate) on the pipelined trainer whose
    model passes do no work: the lane-covered wait makes the settled step
    generation-bound; the paths reach the recorder view and the statusz
    rail."""
    trainer, hist, records = _traced_fit(FakeRollout(gen_delay_s=0.6),
                                         instant_model=True)
    _check_reconciliation(hist, records)
    last = hist[-1]
    assert SEGMENTS[int(last["critpath/bottleneck"])] == "generate"
    assert last["critpath/generate_frac"] > 0.5
    assert last["critpath/headroom_s"] >= 0.0
    view = trainer._critical_path_view()
    assert view["count"] == len(hist)
    assert view["paths"][-1]["bottleneck"] == "generate"
    ts = trainer._timeseries.section()
    assert ts["keys"]["critpath/bottleneck_frac"]["count"] == len(hist)
    assert ts["keys"]["training/global_step"]["slope"] == pytest.approx(1.0)
    assert any(r["name"] == "trainer/prefetch" for r in records)


def test_traced_fit_flips_to_update_bound():
    _, hist, records = _traced_fit(FakeRollout(gen_delay_s=0.0),
                                   slow_update_s=0.25)
    _check_reconciliation(hist, records)
    last = hist[-1]
    assert SEGMENTS[int(last["critpath/bottleneck"])] == "update"
    assert last["critpath/update_frac"] > last["critpath/generate_frac"]
