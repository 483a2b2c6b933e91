"""The pipelined push fence and generation in the port's goodput split,
on the CPU.

With ``pipeline_depth >= 1`` the producer lane waits on the last push
(``prefetch_fence``) before it starts the next stream, while the
foreground waits on that stream. The reference adds the whole fence to
``weight_push`` on top of a bubble that already holds its part inside the
wait, and its fence time from before the step's wall began as well, so a
push that lands late reads ``attributed_frac`` above 1 (1.0540 on the
card, an autoscale step whose receiver retried for 0.87 s). The port
counts the fence's part inside the foreground's stream waits once, as
``weight_push``, and nothing of the rest. Pipelined generation is the
same: the reference counts the producer's whole ``gen`` as ``generate``,
its part before the step's wall too (a PPO step on the card read
``attributed_frac`` 1.50 with 1.80 s of its 1.80 s generation before its
2.00 s wall); the port counts its part inside the waits.

The trainer is the pipelined one on the ``tiny`` preset in f32 with a fake
rollout whose asynchronous push blocks for 0.87 s before it lands.

Manager round trips are counted the same way, serial and pipelined: a sum
of them, taken as they end, overlaps itself when several threads call at
once and the wall before the wait when one began there (an autoscale step
on an NVIDIA H100 80GB HBM3 at 700.00 W read ``attributed_frac`` 1.1216,
manager_rtt 2.36 s of a 2.52 s wall beside 0.37 s of update). The port counts the seconds of the
waits that their intervals cover, once.
"""

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from polyrl_tpu.obs import goodput as j_goodput
from polyrl_tpu_torch.manager.client import (ManagerClient,
                                             ManagerTransportError,
                                             spawn_rollout_manager)
from polyrl_tpu_torch.obs import goodput
from polyrl_tpu_torch.obs.histogram import Histogram
from polyrl_tpu_torch.rollout.remote import RemoteRollout
from tests.fake_engine import FakeEngine
from tests.test_torch_pipeline import FakeRollout, make_trainer

# the retry of the push that failed the autoscale step on the card
PUSH_LAND_S = 0.87
# seconds each pipelined generation sleeps in the producer lane
GEN_S = 0.3
# attributed_frac of a step whose phases are all inside its wall: the
# phases are disjoint intervals of the wall, less the host work between
# them, so only float rounding can take the sum past it, whether the
# producer's fence and generation fall inside the waits or before them
ATTRIBUTED_TOL = 1e-6
# seconds: the ledger's sums against the record's raw readings
EPS = 1e-9


def _fence_part(rec: dict) -> float:
    """The fence seconds that ``weight_push`` holds on top of the push."""
    return rec["goodput/weight_push_s"] - rec["timing_s/update_weight"]


class LandsInStep2(FakeRollout):
    """Push 0 (made at the end of step 0) lands PUSH_LAND_S after the
    trainer enters step 2, whatever the host's speed; the others at once.
    Step 1's stream was made before push 0 began, so step 2's is the
    first that the producer holds on a push: from step 1's start, when
    the producer got its credit, to push 0's landing."""

    trainer = None

    def update_weights_async(self, params, version=None):
        first = self.async_pushes == 0
        self.weight_version += 1
        self.async_pushes += 1

        def land():
            if first:
                while self.trainer.global_step < 2:
                    time.sleep(0.005)
                time.sleep(PUSH_LAND_S)

        t = threading.Thread(target=land, name="weight-push", daemon=True)
        with self._lock:
            self._in_flight.append(t)
        t.start()
        return self.weight_version


def _slow_first_update(trainer, step: int, secs: float) -> None:
    """Make the first update micro of ``step`` take ``secs`` longer."""
    update = trainer.actor.update_stream
    slowed = []

    def slow(*a, **kw):
        if trainer.global_step == step and not slowed:
            slowed.append(True)
            time.sleep(secs)
        return update(*a, **kw)

    trainer.actor.update_stream = slow


def _pipelined(slow_update_step: int | None = None) -> list[dict]:
    """Three pipelined steps at depth 1. By default push 0 lands inside
    step 2's wait (``LandsInStep2``). With ``slow_update_step`` push 0
    lands PUSH_LAND_S after it starts and that step's first update micro
    takes 0.33 s longer: the fence for step 2 then ends inside that update,
    before step 2's wait."""
    if slow_update_step is None:
        rollout = LandsInStep2()
        trainer = rollout.trainer = make_trainer(rollout, total_steps=3,
                                                 depth=1)
    else:
        rollout = FakeRollout(push_delay_s=PUSH_LAND_S)
        trainer = make_trainer(rollout, total_steps=3, depth=1)
        _slow_first_update(trainer, slow_update_step, PUSH_LAND_S + 0.33)
    history = trainer.fit()
    assert rollout.async_pushes == 3
    return history


def test_fence_inside_the_wait_is_counted_once():
    """Step 2's stream waits on push 0 landing: the fence began in step
    1 and ends in step 2's wait. Its part in the wait is weight_push, not
    bubble too, and none of its time in step 1 is counted: the split
    stays within the wall."""
    history = _pipelined()
    rec = history[2]
    gate = rec["perf/staleness_gate_wait_s"]
    fence = _fence_part(rec)
    assert PUSH_LAND_S / 2 < fence <= gate + EPS
    # the fence seconds inside the wait are not bubble as well
    assert (rec["goodput/bubble_s"] + fence
            <= rec["perf/trainer_bubble_s"] + EPS)
    # the raw gate stays readable
    assert rec["timing_s/prefetch_fence"] == pytest.approx(gate)
    for r in history:
        assert r["goodput/attributed_frac"] <= 1.0 + ATTRIBUTED_TOL
        assert (sum(r[f"goodput/{p}_s"] for p in goodput.PHASES)
                == pytest.approx(r["goodput/step_wall_s"]))


def test_fence_inside_the_update_adds_nothing():
    """Step 1's first update micro outlasts push 0's landing, so the
    producer's fence for step 2 ends inside that update: step 2's wait
    holds none of it, and weight_push holds the push alone."""
    history = _pipelined(slow_update_step=1)
    rec = history[2]
    assert rec["perf/staleness_gate_wait_s"] >= PUSH_LAND_S / 2
    assert rec["goodput/weight_push_s"] == rec["timing_s/update_weight"]
    for r in history:
        assert r["goodput/attributed_frac"] <= 1.0 + ATTRIBUTED_TOL


def test_generation_before_the_step_adds_nothing():
    """Step 1's first update micro outlasts step 2's generation, which the
    producer ran from step 1's start: step 2's wait holds none of it, so
    its generate and bubble together are at most that wait, where the
    reference's generate alone is the whole generation. Step 0 waits on
    its own generation, which counts as generate."""
    trainer = make_trainer(FakeRollout(gen_delay_s=GEN_S), total_steps=3,
                           depth=1)
    _slow_first_update(trainer, 1, GEN_S + 0.5)
    history = trainer.fit()
    rec = history[2]
    # the raw time stays readable, and all of it predates step 2's wall
    assert rec["timing_s/gen"] >= GEN_S
    assert rec["perf/pipeline_overlap_s"] >= GEN_S
    assert (rec["goodput/generate_s"] + rec["goodput/bubble_s"]
            + _fence_part(rec) <= rec["perf/trainer_bubble_s"] + EPS)
    assert rec["perf/trainer_bubble_s"] < GEN_S / 2
    assert history[0]["goodput/generate_s"] > GEN_S / 2
    for r in history:
        assert r["goodput/attributed_frac"] <= 1.0 + ATTRIBUTED_TOL
        assert r["goodput/generate_s"] <= r["timing_s/gen"] + EPS


# seconds of each manager round trip that the tests below make
RTT_S = 0.4


class _SlowManager(BaseHTTPRequestHandler):
    """Answers ``POST /sleep {"s": x}`` with ``{}`` x seconds after the
    server's ``release`` event is set."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.server.release.wait()
        time.sleep(float(body["s"]))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture
def manager():
    """A ``ManagerClient`` on a local server whose calls take as long as
    they ask."""
    server = ThreadingHTTPServer(("127.0.0.1", 0), _SlowManager)
    server.release = threading.Event()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield ManagerClient(f"127.0.0.1:{server.server_address[1]}"), \
            server.release
    finally:
        server.release.set()
        server.shutdown()
        server.server_close()
        thread.join()


def _round_trip(client, secs: float) -> threading.Thread:
    t = threading.Thread(target=client._call, args=("POST", "/sleep"),
                         kwargs={"payload": {"s": secs}}, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("case", ["concurrent", "begun_before_the_wait"])
def test_round_trips_inside_the_wait_are_counted_once(manager, depth, case):
    """Step 2's stream waits on manager round trips made by other
    threads. ``concurrent``: two of RTT_S seconds at once, inside the
    first wait. ``begun_before_the_wait``: one that begins in the first
    update micro, which takes RTT_S longer, and ends RTT_S into the second
    wait. Either way their sum is at least twice the wait seconds they
    cover: manager_rtt holds those seconds once, net of the bubble, and
    the split stays within the wall."""
    client, release = manager
    trainer = make_trainer(FakeRollout(), total_steps=3, depth=depth)
    calls: list[threading.Thread] = []
    fanout = trainer._ibatch_fanout

    def waited(*a, **kw):
        for n, item in enumerate(fanout(*a, **kw)):
            if trainer.global_step == 1:
                if case == "concurrent" and n == 0:
                    calls.extend(_round_trip(client, RTT_S)
                                 for _ in range(2))
                if calls:
                    release.set()
                for t in calls:
                    t.join()
            yield item

    trainer._ibatch_fanout = waited
    if case == "begun_before_the_wait":
        update = trainer.actor.update_stream

        def slow(*a, **kw):
            if trainer.global_step == 1 and not calls:
                calls.append(_round_trip(client, RTT_S))
                time.sleep(RTT_S)
            return update(*a, **kw)

        trainer.actor.update_stream = slow
    history = trainer.fit()
    rec = history[1]
    assert rec["manager/rtt_s/count"] == len(calls)
    assert (rec["manager/rtt_s/mean"] * rec["manager/rtt_s/count"]
            >= 2 * RTT_S)
    # the seconds the round trips cover inside the waits, once
    assert RTT_S / 2 < rec["goodput/manager_rtt_s"] <= 1.5 * RTT_S
    assert (rec["goodput/manager_rtt_s"] + rec["goodput/bubble_s"]
            <= rec["perf/trainer_bubble_s"] + EPS)
    for r in history:
        assert r["goodput/attributed_frac"] <= 1.0 + ATTRIBUTED_TOL
        assert (sum(r[f"goodput/{p}_s"] for p in goodput.PHASES)
                == pytest.approx(r["goodput/step_wall_s"]))


# seconds the manager's /health fails after the stream breaks
DOWN_S = 1.0


class _BreaksOnce:
    """A ``ManagerClient`` whose ``at_call``-th stream breaks before its
    first result and whose ``/health`` then fails for ``DOWN_S`` seconds,
    as a manager that dies and is respawned: ``RemoteRollout`` waits for
    it inside the stream and resumes the pending rids."""

    def __init__(self, client: ManagerClient, at_call: int):
        self._client = client
        self.at_call = at_call
        self.calls = 0
        self.down_until = 0.0

    def __getattr__(self, name):
        return getattr(self._client, name)

    def health(self) -> bool:
        return time.monotonic() >= self.down_until and self._client.health()

    def batch_generate_stream(self, requests, max_local_gen_s=None):
        self.calls += 1
        if self.calls == self.at_call:
            self.down_until = time.monotonic() + DOWN_S
            raise ManagerTransportError("injected: the manager went away")
        return self._client.batch_generate_stream(
            requests, max_local_gen_s=max_local_gen_s)


@pytest.fixture(scope="module")
def fleet():
    """A manager with one fake engine (token ids inside ``tiny``'s vocab)."""
    eng = FakeEngine(start_token=300, token_delay_s=0.005).start()
    proc, port = spawn_rollout_manager(
        "127.0.0.1:0", extra_args=["--health-check-interval-s", "0.1",
                                   "--stats-poll-interval-s", "0.1"])
    try:
        client = ManagerClient(f"127.0.0.1:{port}")
        client.wait_healthy()
        client.register_rollout_instance(eng.endpoint)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any(
                i["healthy"] for i in client.get_instances_status()[
                    "instances"]):
            time.sleep(0.1)
        yield client
    finally:
        proc.kill()
        proc.wait(timeout=10)
        eng.stop()


@pytest.mark.parametrize("depth", [0, 1])
def test_resume_wait_inside_the_wait_is_counted_once(fleet, depth):
    """Step 2's stream breaks and the manager answers no ``/health`` for
    DOWN_S seconds: the reader thread waits for it inside the stream
    while the trainer waits on the stream. ``salvage_resume`` holds the
    seconds of the waits that the resume wait covers, once, net of the
    bubble; the reference adds the whole wait on top of a bubble that
    holds it (``attributed_frac`` about 1 + DOWN_S / wall). Pipelined,
    the part before the step's wall adds nothing."""
    mgr = _BreaksOnce(fleet, at_call=2)
    rollout = RemoteRollout(mgr, pad_token_id=0, resume_budget=2,
                            resume_wait_s=10.0)
    history = make_trainer(rollout, total_steps=3, depth=depth).fit()
    assert rollout.stream_resumes == 1
    waited = [r for r in history if r.get("rollout/resume_wait_s/count")]
    assert len(waited) == 1
    total = (waited[0]["rollout/resume_wait_s/mean"]
             * waited[0]["rollout/resume_wait_s/count"])
    assert total >= DOWN_S
    rec = waited[0]
    assert rec["goodput/salvage_resume_s"] <= total + EPS
    if depth == 0:
        # serial, the whole resume wait lies inside the step's stream wait
        assert rec["goodput/salvage_resume_s"] > DOWN_S / 2
    assert (rec["goodput/salvage_resume_s"] + rec["goodput/bubble_s"]
            <= rec["perf/trainer_bubble_s"] + EPS)
    for r in history:
        assert r["goodput/attributed_frac"] <= 1.0 + ATTRIBUTED_TOL
        assert (sum(r[f"goodput/{p}_s"] for p in goodput.PHASES)
                == pytest.approx(r["goodput/step_wall_s"]))


# seconds the first optimizer offload takes here: on the card it
# allocates the AdamW moments' pinned host buffers (1.7 s for 7.7 GB at
# llama3-8b's width and 4 layers, NVIDIA H100 80GB HBM3 at 700.00 W)
FIRST_OFFLOAD_S = 0.5


@pytest.mark.parametrize("depth", [0, 1])
def test_first_offload_is_counted_as_update(depth):
    """``offload_optimizer``: the step's offload after its push is timed
    with the update, so the first one, which allocates the host buffers,
    lands in ``update`` and not in ``other`` (the reference leaves it
    untimed: ``attributed_frac`` 0.82 on step 1 of the llama3-8b recipe on
    the card)."""
    trainer = make_trainer(FakeRollout(), total_steps=2, depth=depth)
    actor = trainer.actor
    actor.cfg = dataclasses.replace(actor.cfg, offload_optimizer=True)
    offload = actor.offload_opt_state

    def first_is_slow():
        if actor._opt_host is None:
            time.sleep(FIRST_OFFLOAD_S)
        offload()

    actor.offload_opt_state = first_is_slow
    history = trainer.fit()
    assert actor._opt_offloaded
    assert history[0]["goodput/update_s"] >= FIRST_OFFLOAD_S
    for r in history:
        assert r["goodput/other_s"] < FIRST_OFFLOAD_S / 2
        assert r["goodput/attributed_frac"] <= 1.0 + ATTRIBUTED_TOL


@pytest.mark.parametrize("spans,within,minus,want", [
    ([(0, 2), (1, 3)], [(0, 10)], [], 3.0),            # overlapping, once
    ([(0, 2), (0, 2)], [(1, 5)], [], 1.0),             # the same call twice
    ([(0, 4)], [(1, 2), (3, 5)], [], 2.0),             # two waits
    ([(0, 4)], [(0, 4)], [(1, 2), (1.5, 3)], 2.0),     # less what is held
    ([(0, 1)], [(2, 3)], [], 0.0),                     # outside the waits
    ([], [(0, 1)], [], 0.0),
])
def test_seconds_inside_counts_each_second_once(spans, within, minus, want):
    assert goodput.seconds_inside(spans, within, minus) == pytest.approx(want)


def test_serial_records_are_the_references_split():
    """pipeline_depth 0 has no fence: the trainer hands the ledger no
    fence and its raw timings, and the reference's ledger on the same
    inputs gives the record's split bit for bit."""
    seen = []
    trainer = make_trainer(FakeRollout(push_delay_s=PUSH_LAND_S),
                           total_steps=2, depth=0)
    account = trainer._goodput.account

    def spy(**kw):
        seen.append(dict(kw))
        return account(**kw)

    trainer._goodput.account = spy
    history = trainer.fit()
    assert len(seen) == len(history) == 2
    for kw, rec in zip(seen, history):
        assert kw.pop("fence_in_bubble_s") == 0.0
        assert "prefetch_fence" not in kw["timings"]
        assert kw.pop("rtt_in_bubble_s") == 0.0
        assert kw.pop("rtt_elsewhere_s") == 0.0
        assert kw.pop("resume_in_bubble_s") == 0.0
        assert kw.pop("resume_elsewhere_s") == 0.0
        ref = j_goodput.GoodputLedger().account(**kw)
        for k, v in ref.items():
            assert rec[k] == v, k


STEP = dict(
    step_time_s=4.0,
    timings={"gen": 0.5, "reward": 0.2, "old_log_prob": 0.3,
             "update_actor": 0.8, "update_weight": 0.25,
             "prefetch_fence": 0.6, "testing": 0.4},
    bubble_s=1.5, overlap_s=0.7, n_tokens=2000, mean_context_len=128.0,
    n_chips=2)


def _hists(cls) -> dict:
    out = {}
    for name, vals in (("manager/rtt_s", (0.15, 0.05)),
                       ("rollout/resume_wait_s", (0.3,))):
        h = out[name] = cls()
        for v in vals:
            h.observe(v)
    return out


def test_account_equals_reference_with_no_fence_inside_the_bubble():
    """With ``fence_in_bubble_s`` and the two ``resume_*`` inputs 0
    (serial steps, or a fence that lies outside the wait; no stream
    resumed) the port's ledger is the reference's, key for key, bit for
    bit, the per-step split and the cumulative snapshot."""
    from polyrl_tpu.obs.histogram import Histogram as JHistogram

    port_led, ref_led = goodput.GoodputLedger(), j_goodput.GoodputLedger()
    for step in (STEP, dict(STEP, timings={"update_actor": 0.5},
                            bubble_s=0.25, step_time_s=1.5)):
        port = port_led.account(histograms=_hists(Histogram),
                                fence_in_bubble_s=0.0,
                                resume_in_bubble_s=0.0,
                                resume_elsewhere_s=0.0, **step)
        ref = ref_led.account(histograms=_hists(JHistogram), **step)
        assert port == ref
    assert port_led.snapshot() == ref_led.snapshot()


@pytest.mark.parametrize("fence_in", [0.6, 0.25, 2.0])
def test_fence_inside_the_bubble_is_netted_from_it(fence_in):
    """The trainer passes the fence's part inside the wait as the
    ``prefetch_fence`` timing and as ``fence_in_bubble_s``: weight_push
    holds it once, the bubble is net of it (never below zero), and every
    other phase is the reference's."""
    step = dict(STEP, timings=dict(STEP["timings"], prefetch_fence=fence_in))
    port = goodput.GoodputLedger().account(
        histograms=_hists(Histogram), fence_in_bubble_s=fence_in, **step)
    ref = goodput.GoodputLedger().account(histograms=_hists(Histogram),
                                          **step)
    assert port["goodput/weight_push_s"] == pytest.approx(0.25 + fence_in)
    assert port["goodput/bubble_s"] == pytest.approx(
        max(0.0, 1.5 - 0.5 - fence_in))
    for p in goodput.PHASES:
        if p not in ("bubble", "other"):
            assert port[f"goodput/{p}_s"] == ref[f"goodput/{p}_s"], p
    assert port["goodput/attributed_frac"] <= ref["goodput/attributed_frac"]
    assert (sum(port[f"goodput/{p}_s"] for p in goodput.PHASES)
            == pytest.approx(max(4.0, sum(
                port[f"goodput/{p}_s"] for p in goodput.PHASES
                if p != "other"))))
    assert np.isfinite(port["goodput/attributed_frac"])
