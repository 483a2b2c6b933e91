"""HTTP rollout server over the port's engines.

Counterpart of ``polyrl_tpu/rollout/server.py``, speaking the same wire
protocol for the routes this slice serves:

- POST /generate        streaming NDJSON (chunked), one line per emitted
                        token: token_ids, logprobs, finished,
                        finish_reason, weight_version; optional
                        ``group_id``/``group_size`` GRPO hints
- GET  /health, /health_generate, /get_server_info
- POST /abort_request   one rid, or every request when rid is empty
- POST /release_memory_occupation, /resume_memory_occupation
- POST /flush_cache, /shutdown

Two backends: a ``CBEngine`` admits requests itself (continuous batching);
a ``RolloutEngine`` (the step backend) is driven through
``StepDecoder.generate_stream`` by this server's batch loop, which groups
queued requests of one sampling group into a batch.
``get_server_info`` also reports each CUDA kernel's launch count, so a
client can see that decoding went through the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from polyrl_tpu_torch.ops.cuda_build import LAUNCHES
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END
from polyrl_tpu_torch.rollout.flightdeck import ThroughputEWMA
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.stepper import StepDecoder

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _PendingRequest:
    rid: str
    input_ids: list[int]
    sampling: SamplingParams
    out: queue.Queue
    abort: threading.Event


class RolloutServer:
    """Wraps a CBEngine, or a RolloutEngine through a StepDecoder, behind
    the manager protocol."""

    BATCH_WAIT_S = 0.01  # the step backend's wait for more of a batch

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 0,
                 advertise_host: str = "127.0.0.1"):
        self.engine = engine
        # a CBEngine admits requests itself; the step backend's engine is
        # driven by this server's batch loop, up to its largest batch bucket
        self.cb = hasattr(engine, "submit")
        self.stepper = None if self.cb else StepDecoder(engine)
        self.max_batch = None if self.cb else max(engine.batch_buckets)
        self._tput_ewma = ThroughputEWMA()
        self._queue: "queue.Queue[_PendingRequest]" = queue.Queue()
        self._paused = threading.Event()  # release_memory_occupation
        self._loop_thread: threading.Thread | None = None
        # maps an arriving weight tree to the engine's layout before the
        # swap: ``quant.quantize_params`` on an int8 engine (the pushed tree
        # stays in the model dtype), None otherwise
        self.weight_preprocess = None
        self._aborts: dict[str, threading.Event] = {}
        self._aborts_lock = threading.Lock()
        self._serve_thread: threading.Thread | None = None
        self._stopped = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/health", "/health_generate"):
                    self._json(200, {"status": "ok"})
                elif self.path == "/get_server_info":
                    self._json(200, outer.server_info())
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/generate":
                    self._generate(body)
                elif self.path == "/abort_request":
                    outer.abort_request(body.get("rid"))
                    self._json(200, {"success": True})
                elif self.path == "/flush_cache":
                    if outer.cb:
                        outer.engine.flush_prefix_cache()
                    self._json(200, {"success": True})
                elif self.path == "/release_memory_occupation":
                    outer.release_memory()
                    self._json(200, {"success": True})
                elif self.path == "/resume_memory_occupation":
                    outer.resume_memory()
                    self._json(200, {"success": True})
                elif self.path == "/shutdown":
                    self._json(200, {"success": True})
                    threading.Thread(target=outer.stop, daemon=True).start()
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _generate(self, body: dict) -> None:
                rid = str(body.get("rid", f"req-{time.monotonic_ns()}"))
                input_ids = [int(t) for t in body.get("input_ids", [])]
                sp = SamplingParams.from_dict(body.get("sampling_params", {}))
                out_q, abort_ev = outer.submit(
                    rid, input_ids, sp,
                    group_id=str(body.get("group_id", "") or ""),
                    group_size=int(body.get("group_size", 0) or 0))
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    done = False
                    while not done:
                        # one chunked write per burst: a fused dispatch
                        # delivers k lines at once
                        items = [out_q.get()]
                        try:
                            while True:
                                items.append(out_q.get_nowait())
                        except queue.Empty:
                            pass
                        for i, it in enumerate(items):
                            if it is STREAM_END:
                                items, done = items[:i], True
                                break
                        if items:
                            data = "".join(json.dumps(it) + "\n"
                                           for it in items).encode()
                            self.wfile.write(f"{len(data):x}\r\n".encode()
                                             + data + b"\r\n")
                            self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    outer.abort_request(rid)
                finally:
                    outer._drop_abort(rid, abort_ev)

        server_cls = type("_RolloutHTTPServer", (ThreadingHTTPServer,),
                          {"request_queue_size": 1024})
        self._http = server_cls((host, port), Handler)
        self.port = self._http.server_address[1]
        self.endpoint = f"{advertise_host}:{self.port}"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "RolloutServer":
        if self.cb:
            self.engine.start()
        else:
            self._loop_thread = threading.Thread(
                target=self._batch_loop, name="rollout-batch", daemon=True)
            self._loop_thread.start()
        self._serve_thread = threading.Thread(
            target=self._http.serve_forever, name="rollout-http", daemon=True)
        self._serve_thread.start()
        return self

    def stop(self) -> None:
        """Stop the engine (open streams get their terminal line) and the
        HTTP listener; joins both threads. Idempotent."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self.cb:
            self.engine.stop()
        else:
            self.abort_request(None)
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=60.0)
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req.out.put({"token_ids": [], "logprobs": [], "finished": True,
                             "finish_reason": "error",
                             "error": "engine shutdown"})
                req.out.put(STREAM_END)
        if self._serve_thread is not None:
            self._http.shutdown()
            self._serve_thread.join(timeout=10.0)
        self._http.server_close()

    # -- requests -----------------------------------------------------------

    def submit(self, rid: str, input_ids: list[int], sp: SamplingParams,
               group_id: str = "", group_size: int = 0
               ) -> tuple[queue.Queue, threading.Event]:
        """Admit one request; returns (output queue, abort event). A
        duplicate in-flight rid is refused with an error line."""
        out: queue.Queue = queue.Queue()
        abort = threading.Event()
        with self._aborts_lock:
            if rid in self._aborts:
                out.put({"token_ids": [], "logprobs": [], "finished": True,
                         "finish_reason": "error",
                         "error": f"duplicate rid {rid!r} in flight"})
                out.put(STREAM_END)
                return out, abort
            self._aborts[rid] = abort
        if self.cb:
            self.engine.submit(rid, input_ids, sp, out=out, abort=abort,
                               group_id=group_id, group_size=group_size)
        else:
            self._queue.put(_PendingRequest(rid, input_ids, sp, out, abort))
        return out, abort

    def update_weights(self, params: dict, version: int | None = None) -> None:
        """Install a weight push: ``weight_preprocess`` first (re-quantize
        for an int8 engine), then the engine's in-place swap, which refuses
        a tree of other names, shapes or dtypes (between batches on the
        step backend)."""
        if self.weight_preprocess is not None:
            params = self.weight_preprocess(params)
        self.engine.update_weights(params, version)

    def release_memory(self) -> None:
        """Yield the engine's KV memory to a colocated trainer: requests
        wait until ``resume_memory``."""
        self._paused.set()
        self.engine.release_memory()

    def resume_memory(self) -> None:
        self.engine.resume_memory()
        self._paused.clear()

    # -- the step backend's batch loop ---------------------------------------

    def _batch_loop(self) -> None:
        """Group queued requests of one sampling group (up to
        ``max_batch``, waiting ``BATCH_WAIT_S`` for more) and run each batch
        to its end. Requests of another group wait in ``held`` and are
        served first next round, so that no group starves."""
        held: list[_PendingRequest] = []
        while not self._stopped.is_set():
            if held:
                first = held.pop(0)
            else:
                try:
                    first = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
            if self._paused.is_set():
                held.insert(0, first)
                time.sleep(0.05)
                continue
            batch = [first]
            key = first.sampling.group_key()
            matched = [r for r in held if r.sampling.group_key() == key]
            held = [r for r in held if r.sampling.group_key() != key]
            batch += matched[:self.max_batch - 1]
            held = matched[self.max_batch - 1:] + held
            deadline = time.monotonic() + self.BATCH_WAIT_S
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    req = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                (batch if req.sampling.group_key() == key else held).append(req)
            try:
                self._run_batch(batch)
            except Exception as exc:  # noqa: BLE001 -- fail the batch only
                log.exception("batch failed")
                for req in batch:
                    req.out.put({"token_ids": [], "logprobs": [],
                                 "finished": True, "finish_reason": "error",
                                 "error": str(exc)})
                    req.out.put(STREAM_END)
        for req in held:
            req.out.put({"token_ids": [], "logprobs": [], "finished": True,
                         "finish_reason": "error", "error": "engine shutdown"})
            req.out.put(STREAM_END)

    def _run_batch(self, batch: list[_PendingRequest]) -> None:
        """One batch through ``StepDecoder.generate_stream``: each token to
        its request's queue as it is sampled, tagged with the weight
        version of the batch (weights change only between batches)."""
        eng = self.engine
        t0 = time.monotonic()
        eng.num_running = len(batch)
        wv = eng.weight_version
        total = 0
        closed = [False] * len(batch)
        stream = self.stepper.generate_stream(
            [r.input_ids for r in batch], batch[0].sampling,
            max_new=[r.sampling.max_new_tokens for r in batch],
            abort_flags=[r.abort for r in batch])
        for ev in stream:
            req = batch[ev["row"]]
            if ev["token"] is None:  # aborted before this step's token
                req.out.put({"token_ids": [], "logprobs": [], "finished": True,
                             "finish_reason": "abort"})
            else:
                total += 1
                req.out.put({"token_ids": [ev["token"]],
                             "logprobs": [ev["logprob"]],
                             "finished": ev["done"],
                             "finish_reason": ev["finish_reason"],
                             "weight_version": wv})
            if ev["done"]:
                req.out.put(STREAM_END)
                closed[ev["row"]] = True
        for req, done in zip(batch, closed):
            if not done:  # every handler must see its terminal line
                req.out.put({"token_ids": [], "logprobs": [], "finished": True,
                             "finish_reason": "error",
                             "error": "stream ended without completion"})
                req.out.put(STREAM_END)
        dt = time.monotonic() - t0
        eng.last_gen_throughput = self._tput_ewma.update(
            total / dt if dt > 0 else 0.0)
        eng.num_running = 0

    def abort_request(self, rid: str | None) -> None:
        """Abort one request, or ALL running requests when rid is empty."""
        with self._aborts_lock:
            evs = ([self._aborts[rid]] if rid and rid in self._aborts
                   else [] if rid else list(self._aborts.values()))
        for ev in evs:
            ev.set()

    def _drop_abort(self, rid: str, ev: threading.Event) -> None:
        with self._aborts_lock:
            if self._aborts.get(rid) is ev:
                self._aborts.pop(rid, None)

    def server_info(self) -> dict:
        eng = self.engine
        info = {
            "num_running_reqs": eng.num_running,
            "num_queued_reqs": (eng.num_queued if self.cb
                                else self._queue.qsize()),
            "last_gen_throughput": eng.last_gen_throughput,
            "weight_version": eng.weight_version,
            "device": str(eng.device),
            "backend": "cb" if self.cb else "step",
        }
        for name, n in LAUNCHES.items():
            info[f"kernel_launches/{name}"] = n
        if not self.cb:
            info["batch_buckets"] = list(eng.batch_buckets)
            return info
        info.update({
            "admit_wave": eng.admit_wave,
            "admit_reorder_window": eng.admit_reorder_window,
            "group_share": eng.group_share,
            "decode_group_share": eng.decode_group_share,
            "prefill_dispatches": eng.prefill_dispatches,
            "sibling_attach_dispatches": eng.sibling_attach_dispatches,
            "group_forked_requests": eng.group_forked_requests,
            "decode_dispatches": eng.decode_dispatches,
            "grouped_decode_dispatches": eng.grouped_decode_dispatches,
            "pipeline_depth": eng.pipeline_depth,
            "graph_captures": eng.graph_captures,
            "graph_capture_s": eng.graph_capture_s,
            "graph_replays": eng.graph_replays,
            "decode_host_s": eng.decode_host_s,
            "total_tokens_served": eng.total_tokens_served,
            "prefill_chunk": eng.prefill_chunk,
            "chunk_dispatches": eng.chunk_dispatches,
        })
        if eng.prefix_cache is not None:
            info.update(eng.prefix_cache.stats())
        if eng.salvage_partials:
            info["tokens_salvaged"] = eng.tokens_salvaged
            info["salvage_published_pages"] = eng.salvage_published_pages
        if eng.spec_tokens:
            # emitted tokens per dispatch against the spec_tokens + 1
            # ceiling: whether the lookup pays
            info["spec_tokens"] = eng.spec_tokens
            info["spec_rounds"] = eng.spec_rounds
            info["spec_emitted"] = eng.spec_emitted
            info["spec_dispatches"] = eng.spec_dispatches
            info["spec_accept_rate"] = round(eng.spec_accept_rate, 4)
        return info
