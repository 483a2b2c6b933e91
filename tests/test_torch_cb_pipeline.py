"""The engine's run-ahead pipeline: device-resident state, the emission
queue, the fetcher thread and the k-step dispatch, on the CPU.

Each test ports one of the JAX engine's pipeline tests
(``tests/test_cb_engine.py``) to the port's CBEngine(device="cpu") on
``tiny`` in f32, with weights carried across through numpy. On the CPU
the same queue and fetcher run over eager dispatches; a stand-in takes the
CUDA graph's place in the launch-crediting test. Greedy tokens must equal
the JAX engine's and logprobs stay within its own 5e-4 bound
(``test_torch_cb_engine.py``).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams

GEOM = dict(max_slots=8, page_size=8, max_seq_len=96, prompt_buckets=(16, 32),
            num_pages=128)
LONG = dict(max_seq_len=512, num_pages=256)
LP_TOL = 5e-4


def _tree(seed):
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def tree():
    return _tree(0)


def _engine(tree, **kw):
    cfg = tdec.get_config("tiny", dtype=torch.float32)
    return CBEngine(cfg, params_from_numpy(tree, "cpu", torch.float32),
                    kv_cache_dtype=torch.float32, device="cpu",
                    **{**GEOM, **kw})


def _prompts(n, lens, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, lens[i % len(lens)]).tolist()
            for i in range(n)]


def _collect(q, timeout=120):
    items = []
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_END:
            return items
        items.append(item)


def _tokens(items):
    return [t for it in items for t in it["token_ids"]]


def _versions(items):
    return [it["weight_version"] for it in items for _ in it["token_ids"]]


@pytest.mark.parametrize("depth", [16, 0])
def test_greedy_parity_with_jax_engine(tree, depth):
    """Run ahead 16 dispatches or drain each one: the same greedy tokens as
    the JAX engine, logprobs within 5e-4, every page back."""
    prompts = _prompts(5, (5, 8, 13, 17, 24))
    jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32),
                   jax.tree_util.tree_map(jnp.asarray, tree),
                   kv_cache_dtype=jnp.float32, **GEOM)
    ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=12))
    jeng.stop()
    eng = _engine(tree, pipeline_depth=depth, steps_per_dispatch=4)
    assert eng.pipeline_depth == depth
    out = eng.generate(prompts, SamplingParams(temperature=0.0,
                                               max_new_tokens=12))
    eng.stop()
    for t, j in zip(out, ref):
        assert t["token_ids"] == list(j["token_ids"])
        assert t["finish_reason"] == j["finish_reason"] == "length"
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0,
                                   atol=LP_TOL)
    assert eng.allocator.free_count == eng.num_pages - 1
    assert eng._outstanding() == 0 and not eng._active.any()


@pytest.mark.parametrize("salvage", [True, False], ids=["salvage", "fast"])
def test_abort_mid_generation_with_the_window_outstanding(tree, salvage):
    """The budget exceeds the run-ahead window (16 dispatches of 8 tokens),
    and the fetcher holds every decode output until the window is full:
    the abort terminal still arrives, and the slot and its pages come
    back. With salvage (the default) every token the window's dispatches
    decoded is delivered before it."""
    eng = _engine(tree, **LONG, pipeline_depth=16, salvage_partials=salvage)
    land, held = CBEngine._land, threading.Event()

    def held_land(entry):
        if entry[0] == "step":
            held.wait(timeout=120)
        return land(entry)

    eng._land = held_land
    ev = threading.Event()
    q = eng.submit("abort-me", [5, 6, 7],
                   SamplingParams(temperature=0.0, max_new_tokens=400),
                   abort=ev)
    eng.start()
    assert q.get(timeout=60)["token_ids"]  # the prefill's output
    t0 = time.monotonic()
    while eng._outstanding() <= eng.pipeline_depth:
        assert time.monotonic() - t0 < 120, "the run-ahead window never filled"
        time.sleep(0.01)
    assert eng.decode_dispatches == eng.pipeline_depth + 1
    ev.set()
    held.set()
    items = _collect(q)
    assert items[-1]["finish_reason"] == "abort"
    assert len(_tokens(items)) < 399
    if salvage:
        assert len(_tokens(items)) == (
            eng.decode_dispatches * eng.steps_per_dispatch)
    eng.stop()
    assert all(s is None for s in eng._slots)
    assert eng.allocator.free_count == eng.num_pages - 1


def test_slot_reuse_stale_emit_guard(tree):
    """ABA: a queued step output dispatched for an old request must never
    emit into a new request admitted into the same slot after the old one
    finished on the device-done path (which leaves the device state valid,
    so admission does not drain the queue)."""
    eng = _engine(tree, max_slots=1, pipeline_depth=8, steps_per_dispatch=2)
    sp = SamplingParams(temperature=0.0, max_new_tokens=2, stop_token_ids=())
    qa = eng.submit("a", [5, 3, 9], sp)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()      # prefill A queued; budget 2: one decode step left
        eng._step_once()  # step 1: done on the device
        # a stop-token-style early finish: the host mirror still sees
        # budget, so the tail cutoff lets the next dispatch through
        eng._budgets[0] = 100
        eng._step_once()  # step 2: a stale dispatch for slot 0
    assert len(eng._emit_q) == 3
    eng._drain_emit_q(keep=1)
    assert eng._slots[0] is None and len(eng._emit_q) == 1
    assert not eng._dev_stale  # device-done: no upload, no drain
    assert len(_tokens(_collect(qa, timeout=1))) == 2

    qb = eng.submit("b", [7, 1], sp)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
    assert eng._slots[0] is not None and len(eng._emit_q) == 2
    eng._drain_emit_q()  # the stale step 2 drains first and is skipped
    first = qb.get_nowait()
    assert len(first["token_ids"]) == 1
    assert not (first["token_ids"][0] == eng.pad_token_id
                and first["logprobs"][0] == 0.0)
    assert int(eng._n_generated[0]) == 1  # B's prefill token only
    assert int(eng._seq_lens[0]) == 2     # B's prompt length, un-bumped
    eng.stop()


def test_fetcher_failure_recovers_and_serving_continues(tree):
    """A fetch failure reported by the fetcher routes through _recover (the
    in-flight request fails) and the engine keeps serving."""
    eng = _engine(tree, **LONG)
    eng.start()
    sp = SamplingParams(temperature=0.0, max_new_tokens=300, stop_token_ids=())
    q = eng.submit("victim", [5, 3, 9], sp)
    assert q.get(timeout=60)["token_ids"]
    with eng._fetch_cv:
        eng._fetch_exc = RuntimeError("injected fetch failure")
        eng._fetch_cv.notify_all()
    items = _collect(q)
    assert items[-1]["finish_reason"] in ("error", "abort")
    assert len(_tokens(items)) < 299
    out = eng.generate([[7, 1, 4]], SamplingParams(
        temperature=0.0, max_new_tokens=8, stop_token_ids=()), timeout=60.0)
    assert len(out[0]["token_ids"]) == 8
    eng.stop()
    assert all(s is None for s in eng._slots)
    assert eng.allocator.free_count == eng.num_pages - 1


def test_weight_swap_mid_generation_with_pipeline(tree):
    """update_weights while a long stream runs under the deep pipeline: the
    stream completes exactly, its versions never decrease, and a request
    after the swap decodes as a fresh engine on the new weights."""
    new_tree = _tree(99)
    eng = _engine(tree, **LONG)
    eng.start()
    q = eng.submit("mid", [5, 3, 9], SamplingParams(
        temperature=0.0, max_new_tokens=300, stop_token_ids=()))
    first = q.get(timeout=60)
    assert first["token_ids"] and first["weight_version"] == 0
    eng.update_weights(params_from_numpy(new_tree, "cpu", torch.float32),
                       version=3)
    items = [first] + _collect(q)
    vers = _versions(items)
    assert len(_tokens(items)) == 300 and items[-1]["finish_reason"] == "length"
    assert vers == sorted(vers) and set(vers) <= {0, 3}
    assert eng.weight_version == 3
    sp = SamplingParams(temperature=0.0, max_new_tokens=8, stop_token_ids=())
    got = eng.generate([[7, 1, 4]], sp)[0]
    eng.stop()
    fresh = _engine(new_tree)
    want = fresh.generate([[7, 1, 4]], sp)[0]
    fresh.stop()
    assert got["token_ids"] == want["token_ids"]
    assert got["weight_versions"] == [3] * 8


def test_tokens_carry_the_version_of_their_dispatch(tree):
    """Dispatches queued before a swap carry the old version even when they
    are emitted after it; those after carry the new one. Driven step by
    step with the loop unstarted, so the queue holds them."""
    k = 2
    eng = _engine(tree, steps_per_dispatch=k, pipeline_depth=16)
    q = eng.submit("v", [4, 8, 15], SamplingParams(
        temperature=0.0, max_new_tokens=1 + 5 * k, stop_token_ids=()))
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        for _ in range(3):
            eng._step_once()
    assert eng._outstanding() == 4  # nothing emitted yet
    eng.update_weights(params_from_numpy(_tree(7), "cpu", torch.float32))
    with eng._pool_lock:
        for _ in range(2):
            eng._step_once()
        eng._drain_emit_q()
    vers = _versions(_collect(q, timeout=1))
    assert vers == [0] * (1 + 3 * k) + [1] * (2 * k)
    eng.stop()


@pytest.mark.parametrize("depth", [16, 0])
def test_tail_cutoff_dispatch_count(tree, depth):
    """A budget-bound stream makes exactly ceil((budget - 1) / k) decode
    dispatches however far the loop may run ahead: the first token comes
    from the prefill, and no dispatch is issued past the budget."""
    k, budget = 4, 23
    eng = _engine(tree, steps_per_dispatch=k, pipeline_depth=depth)
    out = eng.generate([[9, 2, 6, 5]], SamplingParams(
        temperature=0.0, max_new_tokens=budget, stop_token_ids=()))[0]
    eng.stop()
    assert len(out["token_ids"]) == budget
    assert eng.decode_dispatches == -(-(budget - 1) // k)


def test_same_seed_same_sampled_tokens(tree):
    """Two engines with the same seed draw the same uniforms: the same
    sampled tokens, at depth 16 and at 0 alike (budget-bound streams admit
    in one wave and make the same dispatches)."""
    prompts = _prompts(4, (6, 11), seed=2)
    sp = SamplingParams(temperature=1.0, top_k=40, top_p=0.9,
                        max_new_tokens=10)
    res = []
    for depth in (16, 16, 0):
        eng = _engine(tree, seed=5, pipeline_depth=depth, steps_per_dispatch=3)
        res.append(eng.generate(prompts, sp))
        eng.stop()
    for a, b, c in zip(*res):
        assert a["token_ids"] == b["token_ids"] == c["token_ids"]
        assert a["logprobs"] == b["logprobs"] == c["logprobs"]
    other = _engine(tree, seed=6, steps_per_dispatch=3)
    diff = other.generate(prompts, sp)
    other.stop()
    assert [r["token_ids"] for r in diff] != [r["token_ids"] for r in res[0]]


def _counting(fn, name):
    """``fn`` that counts a launch of ``name`` per call, as its kernel
    wrapper does on the card."""
    def wrapped(*a, **kw):
        cuda_build.count_launch(name)
        return fn(*a, **kw)
    return wrapped


class _StandInGraph:
    """Takes a CUDA graph's place: ``replay`` runs the captured body, whose
    wrapper calls count nothing (a real replay runs no wrapper)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        with cuda_build.recording_launches():
            self.body()


def test_graph_replays_credit_their_captured_launches(tree, monkeypatch):
    """The engine's graph path with a stand-in for the CUDA graph: one
    capture per (use_filters, k, group shape) key, whose pass runs the
    wrappers but launches nothing (the state is put back, and its launches
    are recorded, not counted), then replays that credit the recording.
    LAUNCHES then reads what launching every step eagerly would, and the
    tokens are the eager engine's."""
    monkeypatch.setattr(tdec, "paged_attention",
                        _counting(tdec.paged_attention, "paged_attention"))
    monkeypatch.setattr(tdec, "paged_kv_write_fused", _counting(
        tdec.paged_kv_write_fused, "paged_kv_write_fused"))
    prompt = _prompts(1, (21,), seed=3)[0]
    k, n_layers = 2, 2
    sp = SamplingParams(temperature=0.0, max_new_tokens=9)
    sp_solo = SamplingParams(temperature=0.0, max_new_tokens=15)

    def run(graphs: bool):
        # synchronous, so the group's last dispatch is emitted before the
        # next is packed: the solo's tail takes the ungrouped key
        eng = _engine(tree, steps_per_dispatch=k, pipeline_depth=0)
        eng._use_graphs = graphs
        captured = []

        def capture(body):
            snap = ({n: t.clone() for n, t in eng._dev.items()},
                    [[p.clone() for p in side] for side in eng._pools],
                    [o.clone() for o in eng._out], eng._gen.get_state())
            body()  # a capture pass: Python runs, the device does not
            for n, t in snap[0].items():
                eng._dev[n].copy_(t)
            for side, saved in zip(eng._pools, snap[1]):
                for p, s in zip(side, saved):
                    p.copy_(s)
            for o, s in zip(eng._out, snap[2]):
                o.copy_(s)
            eng._gen.set_state(snap[3])
            captured.append(body)
            return _StandInGraph(body)

        eng._capture = capture
        cuda_build.reset_launch_counts()
        outs = [eng.submit(f"g{i}", prompt, sp, group_id="g", group_size=3)
                for i in range(3)]
        # outlives the group: its last dispatches take the ungrouped key
        outs.append(eng.submit("solo", _prompts(1, (7,), seed=4)[0], sp_solo))
        eng.start()
        res = [_tokens(_collect(q)) for q in outs]
        eng.stop()
        return eng, res, dict(cuda_build.LAUNCHES), len(captured)

    try:
        eager, res_e, launches_e, _ = run(False)
        graph, res_g, launches_g, n_capt = run(True)
    finally:
        cuda_build.reset_launch_counts()
    assert res_g == res_e and [len(r) for r in res_g] == [9, 9, 9, 15]
    assert eager.graph_captures == eager.graph_replays == 0
    # the tail cutoff fixes the dispatch count: ceil((15 - 1) / k)
    assert graph.decode_dispatches == eager.decode_dispatches == 7
    # both keys: grouped while the group decodes, then ungrouped
    assert 0 < graph.grouped_decode_dispatches < graph.decode_dispatches
    assert n_capt == graph.graph_captures == len(graph._graphs) == 2
    assert graph.graph_replays == graph.decode_dispatches - n_capt
    per_dispatch = k * n_layers
    for launches, eng in ((launches_e, eager), (launches_g, graph)):
        assert launches["paged_kv_write_fused"] == (
            eng.decode_dispatches * per_dispatch)
        assert launches["paged_attention"] == (
            eng.decode_dispatches - eng.grouped_decode_dispatches) * per_dispatch


def test_recording_launches_is_per_thread_and_credited_per_replay():
    """A capture's launches go to its record, not to LAUNCHES; another
    thread's launches meanwhile still count; each replay credits the
    record."""
    cuda_build.reset_launch_counts()
    try:
        with cuda_build.recording_launches() as rec:
            cuda_build.count_launch("paged_attention")
            cuda_build.count_launch("paged_attention")
            t = threading.Thread(
                target=cuda_build.count_launch, args=("flash_attention_fwd",))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with pytest.raises(RuntimeError):
                with cuda_build.recording_launches():
                    pass
        assert rec == {"paged_attention": 2}
        assert cuda_build.LAUNCHES["paged_attention"] == 0
        assert cuda_build.LAUNCHES["flash_attention_fwd"] == 1
        for _ in range(3):
            cuda_build.credit_launches(rec)
        assert cuda_build.LAUNCHES["paged_attention"] == 6
    finally:
        cuda_build.reset_launch_counts()


def test_dev_state_upload_matches_the_host_mirrors(tree):
    """After a host event (an abort) the device state is stale; the next
    dispatch drains, then uploads the mirrors: the device tensors equal
    them, row for row."""
    eng = _engine(tree, pipeline_depth=4, steps_per_dispatch=2)
    ev = threading.Event()
    qa = eng.submit("a", [3, 1, 4], SamplingParams(temperature=0.0,
                                                   max_new_tokens=40),
                    abort=ev)
    qb = eng.submit("b", [2, 7, 1, 8], SamplingParams(
        temperature=0.7, top_p=0.9, top_k=5, max_new_tokens=40,
        stop_token_ids=(3, 4)))
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        ev.set()
        eng._abort_fast()  # full drain, slot back, state stale
        assert eng._dev_stale and eng._outstanding() == 0
        eng._ensure_dev_state()
    st = eng._dev
    for name, host in (("page_table", eng._page_table),
                       ("seq_lens", eng._seq_lens),
                       ("last_tokens", eng._last_tokens),
                       ("n_generated", eng._n_generated),
                       ("budgets", eng._budgets), ("active", eng._active),
                       ("temps", eng._temps), ("top_ps", eng._top_ps),
                       ("top_ks", eng._top_ks),
                       ("stop_table", eng._stop_table)):
        np.testing.assert_array_equal(st[name].numpy(), host, err_msg=name)
    assert _collect(qa, timeout=1)[-1]["finish_reason"] == "abort"
    eng.stop()
    assert _collect(qb, timeout=1)[-1]["finish_reason"] == "abort"
