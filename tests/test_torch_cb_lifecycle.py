"""The port's CBEngine serving lifecycle on the CPU: ``release_memory`` /
``resume_memory`` (mirroring ``tests/test_cb_engine.py``'s test, plus the
captured-graph table emptied on release and the same greedy stream after
resume), ``warmup`` (live slots and the pools' pages left as they were,
every decode key captured up front so that serving captures nothing) and
``reset_throughput_window``. On ``tiny`` in f32; a stand-in takes the
CUDA graph's place where the graph path is driven.
"""

import threading
import time

import numpy as np
import pytest
import torch

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams

GEOM = dict(max_slots=4, page_size=8, max_seq_len=96, prompt_buckets=(16, 32),
            num_pages=64, steps_per_dispatch=2)
SP = SamplingParams(temperature=0.0, max_new_tokens=12)


@pytest.fixture(scope="module")
def params():
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return decoder.init_params(torch.Generator().manual_seed(0), cfg)


def _engine(params, **kw):
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params, kv_cache_dtype=torch.float32, device="cpu",
                    **{**GEOM, **kw})


class _StandInGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _stand_in_graphs(eng):
    """The engine's graph path with a stand-in: a capture runs the body
    once with the device state, pools, outputs and generator put back
    after it (a capture computes nothing), and a replay runs the body."""
    eng._use_graphs = True

    def capture(body):
        snap = ({n: t.clone() for n, t in eng._dev.items()},
                [[p.clone() for p in side] for side in eng._pools],
                [o.clone() for o in eng._out], eng._gen.get_state())
        body()
        for n, t in snap[0].items():
            eng._dev[n].copy_(t)
        for side, saved in zip(eng._pools, snap[1]):
            for p, s in zip(side, saved):
                p.copy_(s)
        for o, s in zip(eng._out, snap[2]):
            o.copy_(s)
        eng._gen.set_state(snap[3])
        return _StandInGraph(body)

    eng._capture = capture


def test_release_resume_memory(params):
    """Release frees the pools and forgets every captured graph; resume
    builds the pools again and the same greedy request gives the same
    stream (tokens and logprobs bitwise)."""
    eng = _engine(params)
    _stand_in_graphs(eng)
    before = eng.generate([[1, 2, 3]], SP)[0]
    assert eng.graph_captures == len(eng._graphs) == 1
    eng.release_memory()
    assert eng._pools is None
    assert eng._graphs == {} and eng._graph_pool is None
    eng.resume_memory()
    assert eng._pools is not None
    after = eng.generate([[1, 2, 3]], SP)[0]
    eng.stop()
    assert after["token_ids"] == before["token_ids"]
    assert after["logprobs"] == before["logprobs"]
    assert eng.graph_captures == 2  # captured again after the release
    assert eng.allocator.free_count == eng.num_pages - 1


def test_requests_wait_out_a_release(params):
    """A request submitted while the memory is released is served after
    resume; release waits for the running requests to finish."""
    eng = _engine(params).start()
    eng.generate([[4, 5, 6]], SP)
    eng.release_memory()
    assert eng._pools is None
    q = eng.submit("late", [4, 5, 6], SP)
    time.sleep(0.2)
    assert q.empty()
    eng.resume_memory()
    items = []
    while (item := q.get(timeout=60)) is not STREAM_END:
        items.append(item)
    eng.stop()
    assert sum(len(i["token_ids"]) for i in items) == 12
    assert items[-1]["finish_reason"] == "length"


def test_release_finishes_the_running_requests(params):
    """``release_memory`` while a request decodes (the hybrid's window
    timer after a request reached the engine past the manager's abort):
    the paused engine admits nothing new but decodes the running request
    to its end, then frees the pools; the request's stream is whole. The
    reference froze it, with the pools kept, until the next resume."""
    eng = _engine(params).start()
    sp = SamplingParams(temperature=0.0, max_new_tokens=60)
    q = eng.submit("running", [7, 8, 9], sp)
    deadline = time.monotonic() + 60
    while not eng._active.any():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    eng.release_memory()
    assert eng._pools is None
    items = []
    while (item := q.get(timeout=60)) is not STREAM_END:
        items.append(item)
    late = eng.submit("late", [7, 8, 9], SP)  # waits for the resume
    time.sleep(0.2)
    assert late.empty()
    eng.resume_memory()
    while late.get(timeout=60) is not STREAM_END:
        pass
    eng.stop()
    assert sum(len(i["token_ids"]) for i in items) == 60
    assert items[-1]["finish_reason"] == "length"
    assert eng.allocator.free_count == eng.num_pages - 1


def test_warmup_leaves_live_slots_and_pools_unchanged(params):
    """``warmup`` in the middle of a greedy request: the device state and
    every page but the null page are bitwise as before, and the request
    finishes with the tokens of an engine never warmed."""
    ref_eng = _engine(params, pipeline_depth=0)
    ref = ref_eng.generate([[7, 8, 9, 10]], SP)[0]
    ref_eng.stop()

    eng = _engine(params, pipeline_depth=0)
    q = eng.submit("w", [7, 8, 9, 10], SP)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._step_once()
        eng._drain_emit_q()
    state = {n: t.clone() for n, t in eng._dev.items()}
    pages = [[p[:, 1:].clone() for p in side] for side in eng._pools]
    eng.warmup(batch_sizes=(2,))
    for n, t in eng._dev.items():
        assert torch.equal(t, state[n]), n
    for side, saved in zip(eng._pools, pages):
        for p, s in zip(side, saved):
            assert torch.equal(p[:, 1:], s)
    with eng._pool_lock:
        while eng._active.any():
            eng._step_once()
        eng._drain_emit_q()
    toks = []
    while (item := q.get(timeout=5)) is not STREAM_END:
        toks += item["token_ids"]
    eng.stop()
    assert toks == ref["token_ids"]


def test_warmup_captures_every_decode_key_up_front(params):
    """Through the graph path: warmup captures the ungrouped decode key of
    each filter variant, as the JAX engine precompiles its step, and the
    requests that follow (greedy, sampled with filters, a group of 2)
    capture no ungrouped key, only the grouped key of the live group's
    shape, at its first dispatch; a speculating engine captures its spec
    keys instead."""
    eng = _engine(params)
    _stand_in_graphs(eng)
    prompt = list(range(3, 15))  # one full page: a decode group of 2
    eng.warmup(batch_sizes=(2,))
    warmed = [(False, 2, None), (True, 2, None)]
    assert sorted(map(str, eng._graphs)) == sorted(map(str, warmed))
    outs = [eng.submit(f"g{i}", prompt, SP, group_id="g", group_size=2)
            for i in range(2)]
    outs.append(eng.submit("s", [3, 4], SamplingParams(
        temperature=0.8, top_k=5, max_new_tokens=6)))
    eng.start()
    for q in outs:
        while q.get(timeout=60) is not STREAM_END:
            pass
    eng.stop()
    assert eng.grouped_decode_dispatches > 0 and eng.graph_replays > 0
    later = [k for k in eng._graphs if k not in warmed]
    assert later and all(k[2] is not None for k in later), later
    assert eng.graph_captures == len(warmed) + len(later)

    spec = _engine(params, spec_tokens=3)
    _stand_in_graphs(spec)
    spec.warmup(batch_sizes=(2,), filter_variants=(False,))
    assert list(spec._graphs) == [("spec", False, 4, 2)]
    res = spec.generate([[5, 6, 7, 5, 6, 7, 5]], SP)[0]
    spec.stop()
    assert spec.graph_captures == 1 and len(res["token_ids"]) == 12


def test_reset_throughput_window(params):
    eng = _engine(params)
    eng.generate([[1, 2, 3]], SP)
    eng._count_tokens(5)
    eng.last_gen_throughput = 12.5
    assert len(eng._tok_window) > 0
    eng.reset_throughput_window()
    assert eng.last_gen_throughput == 0.0
    assert len(eng._tok_window) == 0
    assert eng._tput_ewma.value == 0.0 and eng._tput_ewma._t_last is None
    eng.stop()


def test_release_aborts_chunk_jobs(params):
    """A mid-chunk prefill job loses its filled KV with the pools: release
    aborts it and its pages come back."""
    eng = _engine(params, prefill_chunk=8, max_seq_len=96,
                  prompt_buckets=(8, 16, 64), num_pages=96)
    ev = threading.Event()
    q = eng.submit("c", list(range(1, 41)), SP, abort=ev)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._advance_chunk_job()
    assert eng.chunk_dispatches == 1 and eng._chunk_jobs
    eng.release_memory()
    items = []
    while (item := q.get(timeout=5)) is not STREAM_END:
        items.append(item)
    assert items[-1]["finish_reason"] == "abort"
    assert eng._pools is None and not eng._chunk_jobs
    assert eng.allocator.free_count == eng.num_pages - 1
    eng.resume_memory()
    eng.stop()
    assert np.all(eng._active == 0)
