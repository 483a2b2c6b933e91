"""HTTP rollout server over the port's engines.

Counterpart of ``polyrl_tpu/rollout/server.py``, speaking the same wire
protocol for the routes this slice serves:

- POST /generate        streaming NDJSON (chunked), one line per emitted
                        token: token_ids, logprobs, finished,
                        finish_reason, weight_version; optional
                        ``group_id``/``group_size`` GRPO hints
- GET  /health, /health_generate (503 while draining), /get_server_info
- POST /abort_request   one rid, or every request when rid is empty
- POST /update_weights_from_agent   install a weight push the server's
                        ``ReceiverAgent`` landed (``serve.register_with_manager``)
- POST /drain           graceful preemption: refuse new requests, abort the
                        running ones into salvageable partials
- POST /preempt         drain, then deregister from the manager
- POST /release_memory_occupation, /resume_memory_occupation
- POST /flush_cache, /shutdown

A ``/generate`` body may carry the trainer's ``trace_id``/``parent_span``
(the manager injects them from the ``X-Trace-Id``/``X-Span-Id`` headers),
and the request's ``engine/generate`` span adopts that context.

A weight push lands in the receiver's (pinned) host buffer; the install
copies each entry to a staging tree on the engine's device, and the engine
then copies the staging tree into its live tensors in place, between
dispatches, and raises ``weight_version`` (``update_weights_from_agent``).
The live tensors are never rebound: the engine's CUDA graphs replay from
their addresses.

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

from polyrl_tpu_torch import obs
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
        # the tree a weight push carries, when it is not the engine's own
        # (an int8 engine receives the trainer's bf16 tree: a tree of
        # ``meta`` tensors with its names, shapes and dtypes); None = the
        # engine's params
        self.weight_template = None
        # graceful preemption (POST /drain): running requests abort into
        # partials and new ones are refused with an abort terminal, so that
        # the manager's continuation re-routes them; one way
        self._draining = threading.Event()
        self.drain_count = 0
        # the manager this server registered with (serve.register_with_
        # manager); /preempt deregisters there. "" = never registered
        self.manager_endpoint = ""
        self.receiver = None  # ReceiverAgent, attached by serve.py
        # the receive timeout of an install: a streamed round's clock
        # starts before the trainer's pack
        self.weight_sync_timeout_s = 3600.0
        self._weight_lock = threading.Lock()
        # the device staging tree of weight installs ({name: tensor}, kept
        # across pushes) and the event after the engine's last copy out of
        # it, which the next install's copies wait on
        self._staging: dict = {}
        self._staging_free = None
        # the last installs, oldest first: version, seconds to land the
        # entries on the device (install) and to copy them into the live
        # tensors (swap), bytes, and the wall time the version was raised
        self.weight_syncs: list[dict] = []
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
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/health_generate":
                    # a draining server is alive but must not pass the
                    # manager's serving health gate
                    if outer._draining.is_set():
                        self._json(503, {"status": "draining"})
                    else:
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
                elif self.path == "/update_weights_from_agent":
                    ok, err = outer.update_weights_from_agent(
                        int(body.get("weight_version", -1)))
                    self._json(200 if ok else 500,
                               {"success": ok, "error": err})
                elif self.path == "/drain":
                    self._json(200, outer.drain())
                elif self.path == "/preempt":
                    # preemption notice: ack first, then drain and leave
                    # off the handler thread
                    self._json(200, {"success": True, "draining": True})
                    threading.Thread(target=outer.leave, daemon=True).start()
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
                # cross-process trace adoption: the manager injects the
                # trainer's (trace_id, span_id) into the forwarded request,
                # so this engine span joins the trainer's trace
                ctx = None
                if body.get("trace_id"):
                    ctx = (str(body["trace_id"]),
                           str(body.get("parent_span") or ""))
                tracer = obs.get_tracer()
                rid = str(body.get("rid", f"req-{time.monotonic_ns()}"))
                with tracer.adopt(ctx), tracer.span("engine/generate", rid=rid):
                    self._stream_generate(rid, body)

            def _stream_generate(self, rid: str, body: dict) -> None:
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
        if self.receiver is not None:
            self.receiver.stop()
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
        if self._draining.is_set():
            # graceful preemption: refuse with a partial-abort terminal,
            # which the manager's continuation re-routes
            out.put({"token_ids": [], "logprobs": [], "finished": True,
                     "finish_reason": "abort"})
            out.put(STREAM_END)
            return out, abort
        with self._aborts_lock:
            if rid in self._aborts:
                out.put({"token_ids": [], "logprobs": [], "finished": True,
                         "finish_reason": "error",
                         "error": f"duplicate rid {rid!r} in flight"})
                out.put(STREAM_END)
                return out, abort
            self._aborts[rid] = abort
        if self._draining.is_set():
            # the drain landed between the check above and the event's
            # registration, so its abort sweep missed this request
            abort.set()
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

    def update_weights_from_agent(self, version: int) -> tuple[bool, str]:
        """Install weights ``version`` (or a newer one that superseded it)
        from the receiver: each entry goes host to device into the staging
        tree as its bytes land (``layout.make_incremental_installer``),
        then ``update_weights`` copies the staging tree into the engine's
        tensors in place and raises ``weight_version``. Returns once that
        copy has run on the device, so the manager re-admits this engine
        only when the new weights serve. Without a receiver (an in-process
        update) the version is only acknowledged."""
        if self.receiver is None:
            self.engine.weight_version = version
            return True, ""
        from polyrl_tpu_torch.transfer.layout import (
            make_incremental_installer, unflatten_names)

        try:
            with self._weight_lock:
                t0 = time.monotonic()
                install, staging = make_incremental_installer(
                    self.receiver.layout, self.engine.device, self._staging,
                    after=self._staging_free)
                # the version actually landed: a superseding round's bytes
                # may have replaced the requested one
                installed = self.receiver.wait_for_version(
                    version, timeout=self.weight_sync_timeout_s,
                    on_tensor=install)
                self._staging = staging
                t1 = time.monotonic()
                self.update_weights(unflatten_names(staging), installed)
                if self.engine.device.type == "cuda":
                    import torch

                    ev = torch.cuda.Event()
                    ev.record()
                    self._staging_free = ev
                    ev.synchronize()
                t2 = time.monotonic()
                self.weight_syncs.append({
                    "version": int(installed), "install_s": t1 - t0,
                    "swap_s": t2 - t1, "t_wall": time.time(),
                    "bytes": int(self.receiver.layout.total_bytes)})
                del self.weight_syncs[:-16]
            return True, ""
        except Exception as exc:  # noqa: BLE001 — reported to the manager
            log.exception("weight load failed")
            return False, str(exc)

    def drain(self) -> dict:
        """POST /drain — graceful preemption: stop admitting (new requests
        get an immediate partial-abort terminal), fail the serving health
        gate, and abort every running request. The engine's salvage flushes
        the tokens decoded so far as a partial, so the manager's
        continuation (or the trainer's salvage ledger) resumes them on
        another instance from the last token."""
        self._draining.set()
        with self._aborts_lock:
            n = len(self._aborts)
        self.drain_count += n
        self.abort_request(None)
        return {"success": True, "draining": True, "aborted": n}

    def leave(self, grace_s: float = 0.5) -> None:
        """Graceful departure (POST /preempt): drain, wait ``grace_s`` for
        the partials to flush through their open streams, then deregister
        from the manager so that the routing set shrinks now rather than
        at the next heartbeat. The notify is best effort: the heartbeat
        evicts an engine that stops answering anyway."""
        self.drain()
        time.sleep(grace_s)
        if not self.manager_endpoint:
            return
        try:
            import urllib.request

            req = urllib.request.Request(
                f"http://{self.manager_endpoint}/deregister_rollout_instance",
                data=json.dumps({"endpoint": self.endpoint,
                                 "drained": True}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5.0):
                pass
        except Exception:  # noqa: BLE001 — heartbeat eviction backstops
            log.warning("deregister with manager %s failed",
                        self.manager_endpoint, exc_info=True)

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
            # preemption announcement: the manager's heartbeat reads this
            # and takes a draining engine out of the routing set
            "draining": self._draining.is_set(),
            "device": str(eng.device),
            "backend": "cb" if self.cb else "step",
        }
        if self.drain_count:
            info["drained_requests"] = self.drain_count
        for name, n in LAUNCHES.items():
            info[f"kernel_launches/{name}"] = n
        if self.receiver is not None:
            # weight-sync health: control-channel reconnects, rejected CRC
            # frames, verify failures, resumed bytes
            info.update(self.receiver.health())
        if self.weight_syncs:
            info["weight_syncs"] = list(self.weight_syncs)
        if eng.device.type == "cuda":
            import torch

            info["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                eng.device)
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
        # the flight deck (occupancy, page pressure, TTFT/TPOT tails, token
        # reconciliation), the loop profiler's device/host split ({} when
        # off) and the memory plane's tiers, spill and HBM truth ({} with
        # the ledger off): flat keys the manager's stats poller forwards
        info.update(eng.deck.server_info_fields())
        info.update(eng.loop_profile_info())
        info.update(eng.kv_memory_info())
        return info
