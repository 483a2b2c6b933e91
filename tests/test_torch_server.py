"""The port's HTTP rollout server on the CPU: /generate NDJSON round trip
with GRPO group hints, /health, /get_server_info, /abort_request, and a
clean stop."""

import http.client
import json
import threading

import pytest
import torch

from polyrl_tpu_torch.rollout.serve import create_server


def _post(port, path, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _generate(port, body):
    status, data = _post(port, "/generate", body)
    assert status == 200
    lines = [json.loads(x) for x in data.decode().splitlines() if x.strip()]
    toks = [t for ln in lines for t in ln["token_ids"]]
    return toks, lines


@pytest.fixture
def server():
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=96, num_pages=128, prompt_buckets=(16, 32),
                        steps_per_dispatch=2)
    yield srv
    srv.stop()


def test_generate_round_trip_with_group_hints(server):
    port = server.port
    assert _get(port, "/health") == (200, {"status": "ok"})
    assert _get(port, "/health_generate")[0] == 200
    prompt = list(range(3, 24))
    results = [None] * 4

    def run(i):
        results[i] = _generate(port, {
            "rid": f"r{i}", "input_ids": prompt, "group_id": "grp",
            "group_size": 4,
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 6}})

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for toks, lines in results:
        assert len(toks) == 6
        assert toks == results[0][0]  # greedy: every sample identical
        assert lines[-1]["finished"] and lines[-1]["finish_reason"] == "length"
        assert all(len(ln["logprobs"]) == len(ln["token_ids"]) for ln in lines)
        assert all(ln["weight_version"] == 0 for ln in lines)
    status, info = _get(port, "/get_server_info")
    assert status == 200
    assert info["weight_version"] == 0 and info["num_running_reqs"] == 0
    assert info["num_queued_reqs"] == 0 and "last_gen_throughput" in info
    assert info["device"] == "cpu" and info["total_tokens_served"] == 24
    assert info["group_forked_requests"] >= 1
    # the CPU path runs the plain versions: no CUDA kernel launched
    assert all(info[f"kernel_launches/{k}"] == 0 for k in (
        "paged_kv_write", "paged_attention", "grouped_paged_attention"))
    assert _post(port, "/flush_cache", {})[0] == 200
    assert _post(port, "/abort_request", {"rid": "nobody"})[0] == 200


def test_abort_request_ends_stream_with_abort(server):
    port = server.port
    out = {}

    def run():
        out["res"] = _generate(port, {
            "rid": "long", "input_ids": list(range(5, 15)),
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 80}})

    t = threading.Thread(target=run)
    t.start()
    while not server._aborts:
        threading.Event().wait(0.01)
    _post(port, "/abort_request", {"rid": ""})
    t.join(timeout=120)
    toks, lines = out["res"]
    assert lines[-1]["finish_reason"] in ("abort", "length")
    assert len(toks) <= 80


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        create_server("tiny", port=0)


def test_memory_endpoints_release_and_resume(server):
    """/release_memory_occupation frees the engine's KV pools and
    /resume_memory_occupation builds them again; the same greedy request
    then streams the same tokens and logprobs."""
    port = server.port
    body = {"rid": "m", "input_ids": list(range(4, 20)),
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 10}}
    before = _generate(port, body)
    assert _post(port, "/release_memory_occupation", {})[0] == 200
    assert server.engine._pools is None
    assert _post(port, "/resume_memory_occupation", {})[0] == 200
    assert server.engine._pools is not None
    _post(port, "/flush_cache", {})
    after = _generate(port, dict(body, rid="m2"))
    assert after[0] == before[0]
    assert [ln["logprobs"] for ln in after[1]] == [ln["logprobs"] for ln in before[1]]


def test_spec_and_salvage_fields_in_server_info():
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=4, page_size=8,
                        max_seq_len=96, num_pages=64, prompt_buckets=(16, 32),
                        spec_tokens=3, spec_rounds=2, prefill_chunk=16)
    try:
        toks, _ = _generate(srv.port, {
            "rid": "s", "input_ids": [5, 6, 7, 5, 6, 7, 5, 6, 7, 5],
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 12}})
        assert len(toks) == 12
        info = _get(srv.port, "/get_server_info")[1]
    finally:
        srv.stop()
    assert info["backend"] == "cb"
    assert info["spec_tokens"] == 3 and info["spec_rounds"] == 2
    assert info["spec_dispatches"] > 0 and info["spec_emitted"] == 11
    assert 0 < info["spec_accept_rate"] <= 1
    assert info["prefill_chunk"] == 16
    assert info["tokens_salvaged"] == 0 and "salvage_published_pages" in info


def test_step_backend_round_trip():
    """``backend="step"``: the server's batch loop groups requests of one
    sampling group and streams each token; greedy tokens equal the
    engine's ``generate`` on the same prompt; an abort ends a stream with
    an ``abort`` line; the memory endpoints answer."""
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", backend="step", batch_buckets=(4, 8),
                        prompt_buckets=(16, 32))
    try:
        port = srv.port
        prompts = [list(range(3, 12)), list(range(7, 20)), [9, 8, 7]]
        results = [None] * 3

        def run(i):
            results[i] = _generate(port, {
                "rid": f"s{i}", "input_ids": prompts[i],
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 6 + i}})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        from polyrl_tpu_torch.rollout.sampling import SamplingParams

        for i, (toks, lines) in enumerate(results):
            want = srv.engine.generate(
                [prompts[i]], SamplingParams(temperature=0.0,
                                             max_new_tokens=6 + i))[0]
            assert toks == want.output_ids.tolist()
            assert lines[-1]["finish_reason"] == "length"
            assert all(ln["weight_version"] == 0 for ln in lines)
        status, info = _get(port, "/get_server_info")
        assert status == 200 and info["backend"] == "step"
        assert info["batch_buckets"] == [4, 8] and info["num_running_reqs"] == 0
        out = {}

        def long_run():
            out["res"] = _generate(port, {
                "rid": "long", "input_ids": [5, 6, 7],
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 60}})

        t = threading.Thread(target=long_run)
        t.start()
        while not srv._aborts:
            threading.Event().wait(0.01)
        _post(port, "/abort_request", {"rid": "long"})
        t.join(timeout=120)
        assert out["res"][1][-1]["finish_reason"] in ("abort", "length")
        assert _post(port, "/release_memory_occupation", {})[0] == 200
        assert _post(port, "/resume_memory_occupation", {})[0] == 200
        again = _generate(port, {"rid": "again", "input_ids": prompts[0],
                                 "sampling_params": {"temperature": 0.0,
                                                     "max_new_tokens": 6}})
        assert again[0] == results[0][0]
    finally:
        srv.stop()


@pytest.mark.parametrize("flags,off", [
    ((), ()),
    (("--no-kv-spill",), ("kvspill",)),
    (("--no-kv-ledger",), ("kvledger", "kvspill")),
    (("--no-loop-profile",), ("profiler",)),
], ids=["defaults", "no-kv-spill", "no-kv-ledger", "no-loop-profile"])
def test_serve_plane_flags(flags, off):
    """``serve`` runs the page ledger, the spill tier, the flight deck and
    the loop profiler by default, as the reference does; each ``--no-*``
    flag turns its plane off (``--no-kv-ledger`` the spill tier too), and
    the ledger's knobs reach the engine."""
    from polyrl_tpu_torch.rollout import serve

    args = serve.parse_args(
        ["--model", "tiny", "--device", "cpu", "--dtype", "float32",
         "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--page-size", "8", "--max-seq-len", "64", "--num-pages", "16",
         "--prompt-buckets", "16", "--kv-cold-after-dispatches", "12",
         "--kv-spill-host-gb", "0.5"] + list(flags))
    srv = serve.server_from_args(args)
    try:
        eng = srv.engine
        for plane in ("kvledger", "kvspill", "deck", "profiler"):
            assert (getattr(eng, plane) is None) == (plane in off), plane
        if eng.kvledger is not None:
            assert eng.kvledger.cold_after == 12
        if eng.kvspill is not None:
            assert eng.kvspill.capacity_bytes == int(0.5e9)
        info = srv.server_info()
        assert ("device_frac" in info) == ("profiler" not in off)
        assert ("kv_cold_page_frac" in info) == ("kvledger" not in off)
        assert "occupancy" in info
    finally:
        srv.stop()



# -- the server-side fault hooks (RolloutServer.fault) ------------------------


def _faulty_server(**fault):
    from polyrl_tpu_torch.rollout.faults import (FaultInjectionConfig,
                                                 FaultInjector)

    inj = FaultInjector(FaultInjectionConfig(enabled=True, **fault))
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=96, num_pages=128,
                        prompt_buckets=(16, 32), steps_per_dispatch=2,
                        pipeline_depth=0, fault_injector=inj)
    assert srv.fault is inj
    return srv, inj


def _fault_counters(port):
    status, snap = _get(port, "/statusz")
    assert status == 200
    return {k: v for k, v in snap["counters"].items()
            if k.startswith("fault/")}


def test_on_submit_drain_aborts_the_admission():
    """``drain_after_requests=1``: the first admission drains the server
    through ``on_submit``; the request ends in an ``abort`` terminal (a
    salvageable partial), later ones are refused the same way, and the
    drain is counted in the server's ``/statusz``."""
    srv, inj = _faulty_server(drain_after_requests=1)
    try:
        body = {"rid": "d1", "input_ids": list(range(5, 15)),
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 40}}
        toks, lines = _generate(srv.port, body)
        assert lines[-1]["finished"]
        assert lines[-1]["finish_reason"] == "abort" and len(toks) < 40
        _, lines2 = _generate(srv.port, dict(body, rid="d2"))
        assert [ln["finish_reason"] for ln in lines2] == ["abort"]
        assert _get(srv.port, "/health_generate")[0] == 503
        assert inj.drains == 1
        c = _fault_counters(srv.port)
        assert c["fault/injected_drains"] == 1.0
        assert c["fault/injected_kills"] == 0.0
    finally:
        srv.stop()


@pytest.mark.parametrize("fault,counter", [
    (dict(corrupt_after_tokens=3), "fault/injected_corruptions"),
    (dict(kill_after_tokens=3), "fault/injected_kills"),
], ids=["corrupt", "kill"])
def test_on_line_replaces_or_aborts_a_stream(fault, counter):
    """Every outgoing line passes ``on_line``: a corruption replaces the
    line that reaches 3 tokens with an unparseable one (the manager's
    decode-error path); a kill trips the request's abort event there, and
    the stream ends early in an ``abort`` terminal."""
    srv, inj = _faulty_server(**fault)
    try:
        status, data = _post(srv.port, "/generate", {
            "rid": "f1", "input_ids": list(range(5, 15)),
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 24}})
        assert status == 200
        raw = [x for x in data.decode().splitlines() if x.strip()]
        bad = [x for x in raw if "corrupted-by-fault-injection" in x]
        if "corrupt_after_tokens" in fault:
            assert len(bad) == 1 and inj.corruptions == 1
            lines = [json.loads(x) for x in raw if x not in bad]
            assert lines[-1]["finish_reason"] == "length"
        else:
            assert not bad and inj.kills == 1
            lines = [json.loads(x) for x in raw]
            toks = [t for ln in lines for t in ln["token_ids"]]
            assert lines[-1]["finish_reason"] == "abort"
            assert 3 <= len(toks) < 24
        assert _fault_counters(srv.port)[counter] == 1.0
    finally:
        srv.stop()


def test_server_without_injector_keeps_its_lines():
    """No injector: ``fault`` is None, lines are plain JSON and /statusz
    carries no fault counters."""
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=96, num_pages=128, prompt_buckets=(16,))
    try:
        assert srv.fault is None
        toks, lines = _generate(srv.port, {
            "rid": "p", "input_ids": list(range(5, 15)),
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 6}})
        assert len(toks) == 6 and lines[-1]["finish_reason"] == "length"
        assert _fault_counters(srv.port) == {}
    finally:
        srv.stop()
