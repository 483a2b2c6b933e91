"""HTTP rollout server over the port's CBEngine.

Counterpart of ``polyrl_tpu/rollout/server.py``, speaking the same wire
protocol for the routes this slice serves:

- POST /generate        streaming NDJSON (chunked), one line per emitted
                        token: token_ids, logprobs, finished,
                        finish_reason, weight_version; optional
                        ``group_id``/``group_size`` GRPO hints
- GET  /health, /health_generate, /get_server_info
- POST /abort_request   one rid, or every request when rid is empty
- POST /flush_cache, /shutdown

``get_server_info`` also reports each CUDA kernel's launch count, so a
client can see that decoding went through the hand-written kernels.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from polyrl_tpu_torch.ops.cuda_build import LAUNCHES
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END
from polyrl_tpu_torch.rollout.sampling import SamplingParams

log = logging.getLogger(__name__)


class RolloutServer:
    """Wraps a CBEngine behind the manager protocol."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 0,
                 advertise_host: str = "127.0.0.1"):
        self.engine = engine
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
                    outer.engine.flush_prefix_cache()
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
        self.engine.start()
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
        self.engine.stop()
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
        self.engine.submit(rid, input_ids, sp, out=out, abort=abort,
                           group_id=group_id, group_size=group_size)
        return out, abort

    def update_weights(self, params: dict, version: int | None = None) -> None:
        """Install a weight push: ``weight_preprocess`` first (re-quantize
        for an int8 engine), then the engine's in-place swap, which refuses
        a tree of other names, shapes or dtypes."""
        if self.weight_preprocess is not None:
            params = self.weight_preprocess(params)
        self.engine.update_weights(params, version)

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
            "num_queued_reqs": eng.num_queued,
            "last_gen_throughput": eng.last_gen_throughput,
            "weight_version": eng.weight_version,
            "device": str(eng.device),
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
        }
        if eng.prefix_cache is not None:
            info.update(eng.prefix_cache.stats())
        for name, n in LAUNCHES.items():
            info[f"kernel_launches/{name}"] = n
        return info
