"""The rollout server's /statusz and /metrics and the trainer's ``Tracking``
logger on the port: the statusz sections of the reference's
``tests/test_kv_ledger.py``, ``tests/test_flight_deck.py`` and
``tests/test_engine_profile.py`` (the memory section, the engine
section's conformance, the ``engine.loop`` block on both planes, and the
recorder's ``memory.json``/``engine.json``/``engine_profile.json``), the
rollout plane's snapshot against the JAX server's on the same weights and
request (the same sections and keys), and
``tests/test_observability.py``'s ``test_tracking_wandb_gated`` and
``test_server_metrics_endpoint``.
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu.rollout.server import RolloutServer as JServer
from polyrl_tpu_torch import obs
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.obs import statusz
from polyrl_tpu_torch.obs.engine_profile import PHASES
from polyrl_tpu_torch.obs.recorder import DEFAULT_WATCH, FlightRecorder
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.server import RolloutServer
from polyrl_tpu_torch.utils.metrics import Tracking

GEOM = dict(pad_token_id=0, max_slots=4, page_size=8, max_seq_len=64,
            prompt_buckets=(16,), num_pages=64)


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return json.loads(r.read())


def _np_params():
    jcfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jcfg, jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), jcfg))


def _mk_engine(**kw):
    from polyrl_tpu_torch.models import decoder

    cfg = decoder.get_config("tiny", dtype=torch.float32)
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    return CBEngine(cfg, params, kv_cache_dtype=torch.float32, device="cpu",
                    **GEOM, **kw)


def test_statusz_v6_memory_section_both_planes():
    assert statusz.SCHEMA == "polyrl/statusz/v8"
    assert "memory" in statusz.REQUIRED_SECTIONS
    fleet = {"fleet": {"engines_reporting": 1, "kv_cold_page_frac_max": 0.5}}
    srv = statusz.StatuszServer(
        lambda: statusz.build_snapshot("trainer", step=3, memory=fleet)).start()
    try:
        assert _get_json(f"http://{srv.endpoint}/statusz")["memory"] == fleet
    finally:
        srv.stop()
    assert statusz.build_snapshot("trainer", step=3)["memory"] == {}
    eng = _mk_engine()
    server = RolloutServer(eng, host="127.0.0.1", port=0).start()
    try:
        eng.generate([[5] * 16], SamplingParams(temperature=0.0,
                                                max_new_tokens=4))
        snap = _get_json(f"http://127.0.0.1:{server.port}/statusz")
        assert snap["schema"] == "polyrl/statusz/v8"
        mem = snap["memory"]
        assert sum(mem["roles"].values()) == eng.num_pages - 1
        assert mem["reconcile"]["attributed_frac"] == 1.0
        assert {"hot", "warm", "cold"} <= set(mem["tiers"])
        assert mem["churn"]["page_allocs"] > 0
        assert mem["accounted_bytes"] > 0
        assert "spill" in mem
    finally:
        server.stop()


def test_statusz_v4_conformance_both_planes():
    srv = statusz.StatuszServer(
        lambda: statusz.build_snapshot("trainer", step=3)).start()
    try:
        snap = _get_json(f"http://{srv.endpoint}/statusz")
        for section in statusz.REQUIRED_SECTIONS:
            assert section in snap, f"trainer plane missing {section}"
    finally:
        srv.stop()
    engine = _mk_engine()
    server = RolloutServer(engine, host="127.0.0.1", port=0).start()
    try:
        engine.generate([[5, 3, 9]], SamplingParams(temperature=0.0,
                                                    max_new_tokens=4))
        snap = _get_json(f"http://127.0.0.1:{server.port}/statusz")
        for section in statusz.REQUIRED_SECTIONS:
            assert section in snap, f"rollout plane missing {section}"
        eng = snap["engine"]
        assert eng["tokens"]["attributed_frac"] == 1.0
        assert eng["requests"]["finished"] == 1
        assert 0.0 <= eng["occupancy"]["last"] <= 1.0
        assert eng["pages"]["util"] <= 1.0
        assert "ttft_s" in eng["latency"]
        assert snap["timeseries"]["keys"]["engine/weight_version"]["count"] >= 1
    finally:
        server.stop()


def test_statusz_v8_loop_block_both_planes():
    from polyrl_tpu_torch.rollout.pool import PoolConfig, PoolManager

    eng = _mk_engine()
    server = RolloutServer(eng, host="127.0.0.1", port=0).start()
    try:
        eng.generate([[5] * 16], SamplingParams(temperature=0.0,
                                                max_new_tokens=4))
        loop = _get_json(f"http://127.0.0.1:{server.port}/statusz")[
            "engine"]["loop"]
        assert loop["enabled"] is True
        assert loop["attributed_frac"] >= 0.8
        assert set(loop["phase_frac"]) == set(PHASES)
        assert {"device_frac", "host_overhead_frac", "accounting_frac",
                "idle_frac"} <= set(loop["window"])
    finally:
        server.stop()
    off = _mk_engine(loop_profile=False)
    srv_off = RolloutServer(off, host="127.0.0.1", port=0)
    assert srv_off.statusz_snapshot()["engine"]["loop"] == {"enabled": False}
    off.stop()
    pm = PoolManager(manager=None, cfg=PoolConfig(sweep_interval_s=0))
    try:
        pm._last_status = {"instances": [
            {"endpoint": "a:1", "healthy": True, "occupancy": 0.5,
             "device_frac": 0.8, "accounting_frac": 0.05},
            {"endpoint": "b:2", "healthy": True, "occupancy": 0.5,
             "device_frac": 0.4, "accounting_frac": 0.2}]}
        loop = statusz.build_snapshot("trainer", step=3,
                                      engine=pm.engine_section())["engine"]["loop"]
        assert loop == {
            "enabled": True, "engines_reporting": 2, "device_frac_min": 0.4,
            "accounting_frac_max": 0.2,
            "engines": [{"endpoint": "a:1", "device_frac": 0.8,
                         "accounting_frac": 0.05},
                        {"endpoint": "b:2", "device_frac": 0.4,
                         "accounting_frac": 0.2}]}
    finally:
        pm.close()


def test_rollout_statusz_matches_the_jax_server():
    """The same weights and request on both packages' servers: the same
    schema, sections and section keys; the same engine counters."""
    jcfg, tree = _np_params()
    from polyrl_tpu_torch.models import decoder

    tcfg = decoder.get_config("tiny", dtype=torch.float32)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   kv_cache_dtype=jnp.float32, **GEOM)
    teng = CBEngine(tcfg, params_from_numpy(tree, "cpu"),
                    kv_cache_dtype=torch.float32, device="cpu", **GEOM)
    jsrv = JServer(jeng, host="127.0.0.1", port=0).start()
    tsrv = RolloutServer(teng, host="127.0.0.1", port=0).start()
    try:
        prompts = [[5] * 16, [3, 1, 4, 1, 5]]
        jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=4))
        teng.generate(prompts, SamplingParams(temperature=0.0,
                                              max_new_tokens=4))
        js = _get_json(f"http://{jsrv.endpoint}/statusz")
        ts = _get_json(f"http://{tsrv.endpoint}/statusz")
        assert ts["schema"] == js["schema"] and ts["role"] == "rollout"
        assert set(ts) == set(js)
        for sec in ("engine", "memory", "queues", "weights"):
            assert set(ts[sec]) == set(js[sec]), sec
        assert set(ts["engine"]["loop"]) == set(js["engine"]["loop"])
        assert set(ts["engine"]["group"]) == set(js["engine"]["group"])
        for k in ("total_tokens_served", "prefill_dispatches"):
            assert ts["counters"][k] == js["counters"][k], k
        assert ts["engine"]["requests"] == js["engine"]["requests"]
    finally:
        tsrv.stop()
        jsrv.stop()


@pytest.mark.parametrize("key,fn_name,fname,series", [
    ("engine/kv_cold_page_frac", "memory_fn", "memory.json", (0.05, 0.9)),
    ("engine/occupancy", "engine_fn", "engine.json", (0.9, 0.05)),
    ("engine/device_frac", "engine_profile_fn", "engine_profile.json",
     (0.9, 0.05)),
])
def test_recorder_bundles_the_engine_views(tmp_path, key, fn_name, fname,
                                           series):
    """An anomaly on a watched engine gauge dumps one bundle with the view
    its hook returns; an empty view leaves no file."""
    assert key in DEFAULT_WATCH
    view = {"fleet": {"engines_reporting": 1}, "engines": [{"endpoint": "a:1"}]}
    for empty in (False, True):
        rec = FlightRecorder(str(tmp_path / str(empty)), warmup=3,
                             z_threshold=4.0)
        setattr(rec, fn_name, dict if empty else (lambda: view))
        for s in range(6):
            assert rec.record_step(s, {key: series[0]}) is None
        path = rec.record_step(7, {key: series[1]})
        assert path is not None
        if empty:
            assert fname not in os.listdir(path)
        else:
            with open(os.path.join(path, fname)) as f:
                assert json.load(f) == view
        assert len(os.listdir(os.path.join(str(tmp_path / str(empty)),
                                           "postmortem"))) == 1


def test_tracking_wandb_gated(tmp_path):
    """wandb is absent here: the backend fails once at open, is counted in
    ``log_errors`` (the ``obs/log_errors`` gauge) and the other backends
    keep logging."""
    t = Tracking(backends=("jsonl", "wandb"), path=str(tmp_path / "m.jsonl"))
    assert t._wandb is None and t.log_errors == 1
    t.log({"a": 1.0}, step=1)
    t.close()
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().split(
        "\n") if x]
    assert rows == [{"step": 1, "a": 1.0}]


def test_tracking_counts_a_failing_backend(tmp_path, capsys):
    t = Tracking(backends=("console", "jsonl"), path=str(tmp_path / "m.jsonl"))
    t._file.close()  # a write now raises
    t.log({"perf/step_time_s": 1.5}, step=2)
    assert t.log_errors == 1
    assert "[step 2] {'perf/step_time_s': 1.5}" in capsys.readouterr().out


def test_server_metrics_endpoint():
    engine = _mk_engine()
    server = RolloutServer(engine, host="127.0.0.1", port=0).start()
    try:
        with urllib.request.urlopen(f"http://{server.endpoint}/metrics",
                                    timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert "# TYPE polyrl_num_running_reqs gauge" in body, body
        assert "polyrl_weight_version" in body
        parsed = obs.parse_prometheus_text(body)
        assert parsed["polyrl_weight_version"] == 0.0
        assert parsed["polyrl_total_tokens_served"] == 0.0
    finally:
        server.stop()
