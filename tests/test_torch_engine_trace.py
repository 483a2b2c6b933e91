"""The CB engine's phase trace on the port, on the CPU: the counterparts of
``tests/test_cb_engine.py::test_chunked_prefill_interleaves_with_decode``
(``POLYRL_CB_TRACE=1`` shows chunk dispatches and decode dispatches
interleaved) and ``tests/test_engine_profile.py``'s legacy counters, the
server's ``polyrl_engine_*`` counters on ``/metrics`` and the
``POLYRL_CB_PIPELINE`` default depth.

The trace is host clocks around calls the engine makes anyway: with it
off, ``trace_report()`` is empty and the outputs are bitwise those of an
engine with it on. Weights are ``tiny``'s in f32 from the JAX package,
carried across through numpy.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.obs import engine_profile as jprofile
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.obs.engine_profile import EngineLoopProfiler
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.server import RolloutServer

GEOM = dict(pad_token_id=0, max_slots=4, page_size=8, max_seq_len=96,
            prompt_buckets=(8, 16, 64), num_pages=96)
# the reference's legacy keys (``polyrl_tpu/rollout/cb_engine.py``)
TRACE_KEYS = {"warmup_step", "warmup_prefill", "chunk_prefill",
              "prefill_dispatch", "fetch", "upload", "step_dispatch",
              "spec_dispatch"}


@pytest.fixture(scope="module")
def tree():
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))


def _engine(tree, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu",
                    **{**GEOM, **kw})


def _drain(q, timeout=120.0):
    toks, lps = [], []
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_END:
            return toks, lps
        toks += item.get("token_ids", [])
        lps += item.get("logprobs", [])


@pytest.mark.parametrize("loop_profile", [True, False])
def test_chunked_prefill_interleaves_with_decode(tree, monkeypatch,
                                                 loop_profile):
    """While a long prompt chunks in, a running stream keeps decoding:
    under ``POLYRL_CB_TRACE=1`` the trace shows five chunk dispatches of
    the 40-token prompt and decode dispatches beside them, kept by the
    profiler when it is on and by the engine's locked dict when off."""
    monkeypatch.setenv("POLYRL_CB_TRACE", "1")
    engine = _engine(tree, prefill_chunk=8, loop_profile=loop_profile)
    rng = np.random.default_rng(12)
    sp = SamplingParams(temperature=0.0, max_new_tokens=24,
                        stop_token_ids=())
    engine.start()
    try:
        q1 = engine.submit("r1", rng.integers(1, 512, 5).tolist(), sp)
        time.sleep(0.3)  # r1 admits and decodes while r2 chunks in
        q2 = engine.submit("r2", rng.integers(1, 512, 40).tolist(), sp)
        toks = {name: len(_drain(q)[0]) for name, q in (("r1", q1),
                                                        ("r2", q2))}
        rep = engine.trace_report()
    finally:
        engine.stop()
    assert toks == {"r1": 24, "r2": 24}
    assert rep.get("n_chunk_prefill", 0) >= 5, rep
    assert rep.get("n_step_dispatch", 0) >= 3, rep
    assert set(k for k in rep if not k.startswith("n_")) <= TRACE_KEYS
    for k, v in rep.items():
        if not k.startswith("n_"):
            assert v >= 0.0 and rep["n_" + k] >= 1, (k, rep)


def test_trace_marks_warmup_spec_and_fetch(tree):
    """An explicit ``trace=True`` (no environment) marks the warm-up's
    prefills and decode launches, the uploads, the spec dispatches and the
    fetcher's landings."""
    engine = _engine(tree, spec_tokens=2, trace=True)
    engine.warmup(batch_sizes=(2,), filter_variants=(False,), suffix=False)
    engine.start()
    try:
        _drain(engine.submit("s", [3, 7, 11, 13, 3, 7, 11],
                             SamplingParams(temperature=0.0,
                                            max_new_tokens=8)))
        rep = engine.trace_report()
    finally:
        engine.stop()
    for key in ("warmup_prefill", "warmup_step", "prefill_dispatch",
                "upload", "spec_dispatch", "fetch"):
        assert rep.get("n_" + key, 0) >= 1, (key, rep)
    assert "n_step_dispatch" not in rep  # a speculating engine's decode


def test_trace_off_is_empty_and_bitwise_the_same(tree, monkeypatch):
    """With the trace off (no environment, or an explicit ``trace=False``
    over ``POLYRL_CB_TRACE=1``) ``trace_report()`` is empty, and greedy
    and sampled outputs are bitwise those of a traced engine."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 12, 30)]
    greedy = SamplingParams(temperature=0.0, max_new_tokens=12)
    sampled = SamplingParams(temperature=1.0, top_p=0.9, max_new_tokens=12)

    def run(monkey_env, **kw):
        if monkey_env:
            monkeypatch.setenv("POLYRL_CB_TRACE", "1")
        else:
            monkeypatch.delenv("POLYRL_CB_TRACE", raising=False)
        engine = _engine(tree, prefill_chunk=8, seed=5, **kw)
        engine.start()
        try:
            outs = [_drain(engine.submit(f"g{i}", p, greedy))
                    for i, p in enumerate(prompts)]
            outs += [_drain(engine.submit(f"s{i}", p, sampled))
                     for i, p in enumerate(prompts)]
            return outs, engine.trace_report()
        finally:
            engine.stop()

    off, rep_off = run(False)
    forced_off, rep_forced = run(True, trace=False)
    on, rep_on = run(True)
    assert rep_off == {} and rep_forced == {}
    assert rep_on.get("n_step_dispatch", 0) >= 1
    assert off == on == forced_off


def test_profiler_legacy_counters_match_the_reference():
    """``mark_legacy``/``legacy_report`` keep the reference's
    ``{key: seconds, n_<key>: count}`` shape, value for value."""
    port, ref = EngineLoopProfiler(), jprofile.EngineLoopProfiler()
    for key, dt in (("fetch", 0.5), ("fetch", 0.25), ("dispatch", 0.1)):
        port.mark_legacy(key, dt)
        ref.mark_legacy(key, dt)
    assert port.legacy_report() == ref.legacy_report()
    assert port.legacy_report()["n_fetch"] == 2


def test_metrics_export_engine_counters(tree):
    """``/metrics`` carries each trace entry as a sorted
    ``polyrl_engine_<key>`` counter, and none with the trace off."""
    traced = _engine(tree, trace=True)
    plain = _engine(tree, trace=False)
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    for engine in (traced, plain):
        engine.start()
        try:
            _drain(engine.submit("m", [5, 6, 7, 8, 9], sp))
        finally:
            engine.stop()
    text = RolloutServer(traced, host="127.0.0.1", port=0).metrics_text()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("polyrl_engine_")]
    rep = traced.trace_report()
    assert [ln.split()[0] for ln in lines] == [
        f"polyrl_engine_{k}" for k in sorted(rep)]
    for k in rep:
        assert f"# TYPE polyrl_engine_{k} counter" in text
    assert float(dict(ln.split() for ln in lines)[
        "polyrl_engine_n_step_dispatch"]) == rep["n_step_dispatch"]
    plain_text = RolloutServer(plain, host="127.0.0.1", port=0).metrics_text()
    assert "polyrl_engine_" not in plain_text


def test_pipeline_depth_reads_the_environment(tree, monkeypatch):
    """``pipeline_depth=None`` reads ``POLYRL_CB_PIPELINE``, else 16, as
    the reference's engine; an explicit depth wins."""
    monkeypatch.delenv("POLYRL_CB_PIPELINE", raising=False)
    assert _engine(tree).pipeline_depth == 16
    monkeypatch.setenv("POLYRL_CB_PIPELINE", "3")
    assert _engine(tree).pipeline_depth == 3
    assert _engine(tree, pipeline_depth=0).pipeline_depth == 0
