"""The hybrid rollout's short window against a request that reaches the
local engine after the window timer released it.

The window timer of ``RemoteRollout.generate_stream`` calls the local
engine's ``release_memory``; a request routed to the local instance that
arrives after that must not wait for a ``resume_memory`` that its own
stream never reaches. The released engine ends it at once as ``abort``
with no tokens, and the manager's continuation carries it to the remote
instance, as it does after the window's own abort. Without that the
stream waits out the manager client's read timeout (set short here).
"""

import threading
import time

import pytest
import torch

from polyrl_tpu_torch.manager.client import ManagerClient, spawn_rollout_manager
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.remote import RemoteRollout
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.serve import register_with_manager
from polyrl_tpu_torch.rollout.server import RolloutServer
from tests.fake_engine import FakeEngine

MGR_ARGS = ["--health-check-interval-s", "0.1", "--stats-poll-interval-s",
            "0.2", "--initial-local-gen-s", "8"]
READ_TIMEOUT_S = 8.0  # the manager client's read timeout (600 s by default)


def _engine():
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    params = decoder.init_params(torch.Generator().manual_seed(1), cfg)
    return CBEngine(cfg, params, pad_token_id=0, kv_cache_dtype=torch.float32,
                    max_slots=8, page_size=8, max_seq_len=256,
                    prompt_buckets=(16, 32), device="cpu")


def test_a_released_engine_aborts_a_late_request_in_the_hybrid_window():
    eng = _engine()
    local_srv = RolloutServer(eng, host="127.0.0.1", port=0).start()
    remote = FakeEngine(token_delay_s=0.02, start_token=300).start()
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=MGR_ARGS)
    # every request routed to the local engine reaches it only after the
    # window timer has released it
    submit, late = eng.submit, []

    def late_submit(*a, **kw):
        deadline = time.monotonic() + 30
        while not eng._paused.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        late.append(a[0])
        return submit(*a, **kw)

    eng.submit = late_submit
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}", timeout_s=READ_TIMEOUT_S)
        mgr.wait_healthy()
        register_with_manager(local_srv, mgr.endpoint.replace("http://", ""),
                              is_local=True)
        mgr.register_rollout_instance(remote.endpoint)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10:
            st = mgr.get_instances_status()
            if sum(1 for i in st["instances"] if i["healthy"]) >= 2:
                break
            time.sleep(0.1)
        rollout = RemoteRollout(mgr, local_server=local_srv, pad_token_id=0,
                                resume_wait_s=1.0)
        t0 = time.monotonic()
        chunks = list(rollout.generate_stream(
            [[7, 1, 4, 2]] * 8, SamplingParams(temperature=0.0,
                                               max_new_tokens=16),
            group_size=2, min_emit=8, max_local_gen_s=0.05))
        wall = time.monotonic() - t0
    finally:
        eng.submit = submit
        proc.kill()
        proc.wait(timeout=10)
        remote.stop()
        local_srv.stop()
    assert late, "no request was routed to the local engine"
    got = sorted(i for c in chunks for i, _ in c)
    assert got == list(range(8))
    for c in chunks:
        for _, res in c:
            assert len(res.output_token_ids) == 16
    assert rollout.dropped_groups == 0
    # the window (1.05 s to the release) plus the remote's 16 tokens, far
    # from the read timeout that a stalled request waits out
    assert wall < READ_TIMEOUT_S / 2, wall
    assert eng._pools is None


def test_release_with_abort_new_ends_queued_requests_at_once():
    """``release_memory(abort_new=True)``: a request submitted while
    released, and one already queued, end at once as ``abort`` with no
    tokens; ``resume_memory`` serves again. The running request still
    decodes to its end before the pools go."""
    eng = _engine().start()
    try:
        sp = SamplingParams(temperature=0.0, max_new_tokens=40)
        running = eng.submit("running", [7, 8, 9], sp)
        deadline = time.monotonic() + 60
        while not eng._active.any():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        done = threading.Event()
        threading.Thread(target=lambda: (eng.release_memory(abort_new=True),
                                         done.set()), daemon=True).start()
        items = []
        while (item := running.get(timeout=60)) is not STREAM_END:
            items.append(item)
        assert done.wait(60) and eng._pools is None
        assert sum(len(i["token_ids"]) for i in items) == 40
        late = eng.submit("late", [7, 8, 9], sp)
        first = late.get(timeout=5)
        assert first["finish_reason"] == "abort" and first["token_ids"] == []
        assert late.get(timeout=5) is STREAM_END
        eng.resume_memory()
        again = eng.generate([[7, 8, 9]], SamplingParams(temperature=0.0,
                                                         max_new_tokens=4))
        assert len(again[0]["token_ids"]) == 4
    finally:
        eng.stop()
