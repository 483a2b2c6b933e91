"""The port's control plane on the CPU: its own build of the C++ manager,
its ``ManagerClient`` and ``ManagerSupervisor``, and the port's HTTP
rollout server behind them.

Mirrors a subset of ``tests/test_manager.py`` (register, route
``/generate``, the batch stream), ``tests/test_control_plane_ft.py`` (the
client's retries and typed errors, the supervisor's respawn and
``/reconcile`` replay) and ``tests/test_pool.py`` (drain and preemption),
with a real ``tiny`` f32 server on localhost (``device="cpu"``) in place
of the reference's fake engine. Greedy tokens through the manager must
equal those the server gives directly, exactly; every token carries the
weight version that sampled it. One module-scoped manager and server are
shared; every wait has its own deadline and every process is killed in
teardown.
"""

import http.client
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.manager import client as mclient
from polyrl_tpu_torch.manager.client import (GenerateProgress, GenerateResult,
                                             ManagerClient,
                                             ManagerTransportError,
                                             spawn_rollout_manager)
from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
from polyrl_tpu_torch.rollout.pool import PoolManager
from polyrl_tpu_torch.rollout.serve import create_server, register_with_manager

FAST_ARGS = ["--health-check-interval-s", "0.1", "--stats-poll-interval-s",
             "0.2", "--generate-timeout-ms", "20000"]
GREEDY = {"temperature": 0.0, "max_new_tokens": 6}
PROMPT = list(range(3, 20))


def _server():
    return create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                         dtype="float32", max_slots=8, page_size=8,
                         max_seq_len=128, num_pages=128,
                         prompt_buckets=(16, 32), steps_per_dispatch=2)


def _wait(pred, deadline=15.0, msg="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.05)


def _instance(client, endpoint):
    for inst in client.get_instances_status()["instances"]:
        if inst["endpoint"] == endpoint:
            return inst
    return None


def _direct_generate(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    lines = [json.loads(x) for x in conn.getresponse().read().decode()
             .splitlines() if x.strip()]
    conn.close()
    return lines


@pytest.fixture(scope="module")
def stack():
    """The port's manager and one tiny CPU server registered with it (no
    weight fabric: the instance goes straight into the routing set)."""
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=FAST_ARGS)
    srv = _server()
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        register_with_manager(srv, client=mgr)
        _wait(lambda: (_instance(mgr, srv.endpoint) or {}).get("active"),
              msg="the server in the routing set")
        yield mgr, srv, proc
    finally:
        proc.kill()
        proc.wait(timeout=10)
        srv.stop()


def test_manager_builds_into_the_port_build_dir():
    path = mclient.build_manager()
    build_dir = os.path.join(os.path.dirname(mclient.__file__), "..", "build")
    assert os.path.dirname(path) == os.path.normpath(build_dir)
    assert os.path.basename(path).startswith("polyrl-manager-")
    assert os.access(path, os.X_OK)
    assert mclient.build_manager() == path  # the digest reuses the binary
    # the JAX package's tree is never built into
    ref_cpp = os.path.join(os.path.dirname(mclient.__file__), "..", "..",
                           "polyrl_tpu", "manager", "cpp")
    assert not any(n.endswith(".tmp") for n in os.listdir(ref_cpp))


def test_generate_through_the_manager_equals_the_server(stack):
    mgr, srv, _ = stack
    res = mgr.generate("m-g1", PROMPT, GREEDY)
    assert res.success, res.error
    direct = _direct_generate(srv.port, {"rid": "d-g1", "input_ids": PROMPT,
                                         "sampling_params": GREEDY})
    assert res.output_token_ids == [t for ln in direct for t in ln["token_ids"]]
    assert res.output_token_logprobs == [x for ln in direct
                                         for x in ln["logprobs"]]
    assert res.finish_reason == "length" and len(res.output_token_ids) == 6
    assert res.output_token_weight_versions == [srv.engine.weight_version] * 6


def test_batch_stream_carries_progress_and_weight_versions(stack):
    mgr, srv, _ = stack
    reqs = [{"rid": f"b{i}", "input_ids": PROMPT[: 10 + i],
             "sampling_params": GREEDY} for i in range(4)]
    items = list(mgr.batch_generate_stream(reqs))
    finals = [r for r in items if isinstance(r, GenerateResult)]
    progress = [r for r in items if isinstance(r, GenerateProgress)]
    assert sorted(r.rid for r in finals) == [f"b{i}" for i in range(4)]
    for r in finals:
        assert r.success and len(r.output_token_ids) == 6
        assert r.output_token_weight_versions == [0] * 6
        streamed = [t for p in progress if p.rid == r.rid for t in p.token_ids]
        assert streamed == r.output_token_ids[: len(streamed)]


def test_server_info_has_what_the_manager_polls(stack):
    mgr, srv, _ = stack
    info = srv.server_info()
    for key in ("num_running_reqs", "num_queued_reqs", "last_gen_throughput",
                "weight_version", "draining"):
        assert key in info
    assert info["draining"] is False
    time.sleep(0.5)  # a few stats polls
    inst = _instance(mgr, srv.endpoint)
    assert inst["healthy"] and inst["heartbeat_misses"] == 0
    assert not inst["draining"]
    assert inst["last_gen_throughput"] == pytest.approx(
        srv.server_info()["last_gen_throughput"], abs=1e3)


def test_trace_context_reaches_the_engine_span(stack):
    """The client sends X-Trace-Id/X-Span-Id, the manager forwards them in
    the request body, and the server's ``engine/generate`` span adopts the
    trainer's trace (server and client share this process's tracer)."""
    mgr, _, _ = stack
    tracer = obs.configure(trace=True, reset=True)
    try:
        with obs.span("trainer/step") as step_span:
            trace_id = tracer.current()[0]
            assert mgr.generate("t1", PROMPT, GREEDY).success
        # the server's handler closes its span after the last line it
        # writes, so the record may land just after the client returns
        _wait(lambda: any(r["name"] == "engine/generate"
                          for r in tracer.records()),
              msg="the engine/generate span")
        recs = tracer.records()
        eng = [r for r in recs if r["name"] == "engine/generate"]
        assert eng and eng[0]["trace_id"] == trace_id
        mgr_span = [r for r in recs if r["name"] == "manager/generate"]
        assert mgr_span and mgr_span[0]["parent_id"] == step_span
        assert eng[0]["parent_id"] == mgr_span[0]["span_id"]
    finally:
        obs.configure(trace=False, reset=True)


def test_drain_refuses_new_requests_and_leaves_the_routing_set(stack):
    mgr, _, _ = stack
    srv = _server()
    try:
        pool = PoolManager(mgr)
        pool.add_engine(endpoint=srv.endpoint, deadline_s=15.0)
        assert pool.probe(srv.endpoint)
        assert srv.drain()["draining"] is True
        assert not pool.probe(srv.endpoint)  # /health_generate 503
        # the stats poll reads the announcement off /get_server_info
        _wait(lambda: (_instance(mgr, srv.endpoint) or {}).get("draining"),
              msg="the manager to see the drain")
        assert not _instance(mgr, srv.endpoint)["active"]
        lines = _direct_generate(srv.port, {"rid": "late", "input_ids": PROMPT,
                                            "sampling_params": GREEDY})
        assert lines[-1]["finish_reason"] == "abort"
        out = pool.preempt(srv.endpoint, grace_s=0.1)
        assert out["draining"] is True
        _wait(lambda: _instance(mgr, srv.endpoint) is None,
              msg="the drained server deregistered")
        assert pool.counters()["pool/preemption_drills"] == 1
    finally:
        srv.stop()


# -- the client's fault tolerance (a scripted stub) ---------------------------


class _FlakyStub:
    """'drop' closes the connection before answering, '500' answers 500,
    otherwise a canned JSON body."""

    def __init__(self, script):
        self.script = list(script)
        self.requests = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _behave(self):
                n = int(self.headers.get("Content-Length", 0))
                if n:
                    self.rfile.read(n)
                outer.requests += 1
                mode = outer.script.pop(0) if outer.script else "ok"
                if mode == "drop":
                    self.connection.close()
                    return
                body = (b'{"error":"scripted"}' if mode == "500" else
                        json.dumps({"status": "ok", "instances": []}).encode())
                self.send_response(500 if mode == "500" else 200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = do_PUT = _behave

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.endpoint = f"127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("fault", ["500", "drop"])
def test_idempotent_calls_retry_and_others_fail_fast(fault):
    stub = _FlakyStub([fault, fault])
    try:
        client = ManagerClient(stub.endpoint, backoff_base_s=0.01,
                               backoff_max_s=0.05)
        assert client.get_instances_status()["status"] == "ok"
        assert client.retry_count == 2 and stub.requests == 3
        stub.script = ["drop"] * 3
        with pytest.raises(ManagerTransportError):
            client.generate("r1", [1, 2], {"max_new_tokens": 2})
        assert client.retry_count == 2  # no retry of a non-idempotent call
    finally:
        stub.stop()


# -- an abort from a remote engine is a preemption --------------------------


class _FakeEngine:
    """A scripted remote engine. In mode 'abort' it answers a first
    attempt (input ``PROMPT``) with two tokens and then an ``abort``
    terminal that carries one more; a continuation (a longer input) runs
    to its budget. In mode 'drop' it closes the stream after one token.
    Token ``i`` of a completion is ``100 + i`` wherever it is decoded."""

    def __init__(self):
        self.mode = "abort"
        self.generates = []  # input lengths of the /generate calls
        self.shutdowns = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, obj):
                body = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/get_server_info":
                    self._json({"num_running_reqs": 0, "num_queued_reqs": 0,
                                "last_gen_throughput": 0.0})
                else:
                    self._json({"status": "ok"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/shutdown":
                    outer.shutdowns += 1
                    return self._json({"status": "ok"})
                if self.path != "/generate":
                    return self._json({"status": "ok"})
                ids = body["input_ids"]
                outer.generates.append(len(ids))
                done = len(ids) - len(PROMPT)
                budget = body["sampling_params"]["max_new_tokens"]
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Connection", "close")
                self.end_headers()

                def line(toks, **kw):
                    self.wfile.write((json.dumps(
                        {"token_ids": toks, "logprobs": [-0.5] * len(toks),
                         **kw}) + "\n").encode())
                    self.wfile.flush()

                if outer.mode == "drop":
                    line([100 + done])
                    self.connection.shutdown(2)
                    return
                if done == 0:
                    line([100, 101])
                    line([102], finished=False, finish_reason="abort")
                    return
                line([100 + done + i for i in range(budget)], finished=True,
                     finish_reason="length")

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.endpoint = f"127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def test_remote_abort_resumes_elsewhere_and_a_drop_still_evicts():
    engines = [_FakeEngine(), _FakeEngine()]
    # an emptied pool answers at once instead of waiting for a newcomer
    proc, port = spawn_rollout_manager(
        "127.0.0.1:0",
        extra_args=FAST_ARGS + ["--schedule-wait-timeout-ms", "500"])
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        for e in engines:
            mgr.register_rollout_instance(e.endpoint)
        _wait(lambda: all((_instance(mgr, e.endpoint) or {}).get("active")
                          for e in engines), msg="both fakes routed")
        res = mgr.generate("m-abort", PROMPT, {"max_new_tokens": 8})
        assert res.success, res.error
        # the abort carried token 102; the resume decodes 103..107 whole
        assert list(res.output_token_ids) == list(range(100, 108))
        first = [e for e in engines if len(PROMPT) in e.generates]
        assert len(first) == 1
        other = engines[1 - engines.index(first[0])]
        assert other.generates == [len(PROMPT) + 3]  # resumed elsewhere
        assert first[0].generates == [len(PROMPT)]
        time.sleep(0.5)  # an eviction's /shutdown is sent from a thread
        status = mgr.get_instances_status()
        assert status["pool"]["evictions"] == 0
        assert all(_instance(mgr, e.endpoint)["active"] for e in engines)
        assert [e.shutdowns for e in engines] == [0, 0]
        # a transport failure still evicts, and sends /shutdown
        for e in engines:
            e.mode = "drop"
        res = mgr.generate("m-drop", PROMPT, {"max_new_tokens": 8})
        assert not res.success or len(res.output_token_ids) < 8
        _wait(lambda: all(e.shutdowns == 1 for e in engines),
              msg="/shutdown to both dropping fakes")
        status = mgr.get_instances_status()
        assert status["pool"]["evictions"] == 2
        assert status["instances"] == []
    finally:
        proc.kill()
        proc.wait(timeout=10)
        for e in engines:
            e.stop()


# -- the supervisor -------------------------------------------------------------


def test_supervisor_respawns_and_replays_the_pool(stack):
    """A killed manager is respawned on a fresh port; the registered
    server and the weight version come back through /reconcile, and a
    request routes again."""
    _, srv, _ = stack
    sup = ManagerSupervisor(bind_addr="127.0.0.1:0", extra_args=FAST_ARGS,
                            health_interval_s=0.2, health_failures=2,
                            respawn_backoff_s=0.1,
                            respawn_backoff_max_s=0.5).start()
    try:
        client = sup.client()
        client.wait_healthy()
        client.register_rollout_instance(srv.endpoint)
        _wait(lambda: (_instance(client, srv.endpoint) or {}).get("active"),
              msg="the server active")
        assert client.update_weight_version() == 1
        assert client.update_weight_version() == 2
        old = sup.endpoint
        os.kill(sup.proc.pid, signal.SIGKILL)
        _wait(lambda: sup.restarts >= 1, msg="the respawn")
        client.wait_healthy(15.0)
        assert sup.endpoint != old or sup.restarts >= 1
        st = client.get_instances_status()
        assert [i["endpoint"] for i in st["instances"]] == [srv.endpoint]
        assert st["weight_version"] == 2
        _wait(lambda: (_instance(client, srv.endpoint) or {}).get("healthy"),
              msg="the replayed server healthy")
        assert client.generate("sv1", PROMPT, GREEDY).success
    finally:
        sup.stop()


# -- serve's flag -------------------------------------------------------------

SERVE_ARGS = ["--model", "tiny", "--device", "cpu", "--dtype", "float32",
              "--host", "127.0.0.1", "--port", "0", "--max-slots", "4",
              "--page-size", "8", "--max-seq-len", "128", "--num-pages", "64",
              "--prompt-buckets", "16", "32"]


@pytest.mark.parametrize("flag", ["--manager-endpoint", "--manager"])
def test_serve_registers_with_either_spelling_of_the_flag(flag):
    """``serve --manager-endpoint host:port`` (the reference's flag, as its
    launcher passes it) registers with the manager, and so does
    ``--manager`` (argparse's prefix of the one flag); the server's engine
    runs every plane by default."""
    from polyrl_tpu_torch.rollout import serve

    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=FAST_ARGS)
    srv = None
    try:
        ep = f"127.0.0.1:{port}"
        mgr = ManagerClient(ep)
        mgr.wait_healthy()
        args = serve.parse_args([flag, ep] + SERVE_ARGS)
        assert args.manager_endpoint == ep
        srv = serve.server_from_args(args)
        assert srv.manager_endpoint == ep
        _wait(lambda: _instance(mgr, srv.endpoint) is not None,
              msg="the server registered")
        eng = srv.engine
        for plane in ("kvledger", "kvspill", "deck", "profiler"):
            assert getattr(eng, plane) is not None, plane
    finally:
        if srv is not None:
            srv.stop()
        proc.kill()
        proc.wait(timeout=10)
