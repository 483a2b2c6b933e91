"""ManagerClient + launcher — Python side of the rollout control plane (a
copy of ``polyrl_tpu/manager/client.py``).

Plays the roles of the reference's trainer-side HTTP calls
(``stream_batch_iter.py`` streaming batch iterator, C7;
``launcher.py:32-49`` spawn_rollout_manager; registration/metrics calls in
``stream_ray_trainer.py:691-704`` and ``sglang_http_async_engine.py:102-113``)
against the C++ ``polyrl-manager`` binary. The port builds its own copy of
the manager's sources (``polyrl_tpu_torch/manager/cpp/``) with ``g++`` into
the git-ignored ``polyrl_tpu_torch/build/`` (``build_manager``).

Fault tolerance: idempotent JSON calls retry with capped exponential
backoff + jitter on transport errors and 5xx responses; non-idempotent
calls fail fast with a typed :class:`ManagerTransportError` so the caller
decides (re-running ``/generate`` or a version bump is not safe to do
blindly). When the client is bound to a
:class:`~polyrl_tpu_torch.manager.supervisor.ManagerSupervisor`, the
endpoint re-resolves through it on every attempt — a respawned manager
binds a fresh ephemeral port and the next retry simply lands there.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import random
import socket
import subprocess
import tempfile
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Iterator

from polyrl_tpu_torch import obs

_CPP_DIR = os.path.join(os.path.dirname(__file__), "cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
_SOURCES = ("main.cc", "balance.h", "config.h", "http.h", "json.h", "pool.h",
            "state.h", "utils.h")


class ManagerError(RuntimeError):
    """Base class for control-plane client errors."""


class ManagerTransportError(ManagerError):
    """The manager could not be reached (connection error / timeout /
    truncated response). Raised immediately for non-idempotent calls and
    after the retry budget for idempotent ones."""


class ControlPlaneDown(ManagerError):
    """The manager stayed unreachable past the stream resume budget and no
    local fallback could finish the batch (rollout/remote.py)."""


def build_manager() -> str:
    """Build the C++ manager from ``manager/cpp/`` into
    ``polyrl_tpu_torch/build/polyrl-manager-<digest>`` and return its
    path. The digest covers the sources, so an unchanged tree reuses its
    binary and a changed one builds anew. The command is the manager's
    one build line, ``g++ -O2 -std=c++17 -pthread -o <out> main.cc``; it
    writes to a temporary name first, so that concurrent builders never
    run a half-written binary. Raises if ``g++`` fails."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CPP_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    out = os.path.join(_BUILD_DIR, f"polyrl-manager-{h.hexdigest()[:16]}")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-pthread", "-o", tmp, "main.cc"],
        cwd=_CPP_DIR, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the manager failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def spawn_rollout_manager(bind_addr: str = "0.0.0.0:0",
                          config_file: str | None = None,
                          extra_args: list[str] | None = None,
                          log_path: str | None = None):
    """Start the manager subprocess; returns (Popen, port). Reads the
    'LISTENING <port>' line the binary prints (supports ephemeral ports).

    stderr (the manager's own log lines) is teed to ``log_path`` — default
    a per-spawn file under the temp dir — so chaos-test and CI failures are
    debuggable instead of vanishing into DEVNULL. The path is recorded on
    the returned Popen as ``manager_log_path``."""
    binary = build_manager()
    cmd = [binary, "--bind-addr", bind_addr]
    if config_file:
        cmd += ["--config-file", config_file]
    cmd += extra_args or []
    if log_path is None:
        log_path = os.path.join(
            tempfile.gettempdir(),
            f"polyrl-manager-{os.getpid()}-{time.monotonic_ns()}.log")
    log_f = open(log_path, "ab")
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log_f,
                                text=True)
    finally:
        log_f.close()  # the child inherited the fd
    proc.manager_log_path = log_path
    line = proc.stdout.readline().strip()
    if not line.startswith("LISTENING"):
        proc.kill()
        tail = ""
        try:
            with open(log_path, "rb") as f:
                tail = f.read()[-2048:].decode(errors="replace").strip()
        except OSError:
            pass
        raise RuntimeError(
            f"manager failed to start: {line!r} (log {log_path}): {tail}")
    port = int(line.split()[1])
    return proc, port


@dataclass
class GenerateResult:
    rid: str
    success: bool
    output_token_ids: list[int]
    output_token_logprobs: list[float]
    finish_reason: str
    error: str = ""
    # per-token engine weight version (token-level continuation: a resume
    # stitched across a weight push carries tokens sampled under different
    # policies). Empty when the manager/engine predates the field; -1 for
    # tokens whose engine did not report one.
    output_token_weight_versions: list[int] = field(default_factory=list)


@dataclass
class GenerateProgress:
    """One token-level progress chunk forwarded by the manager mid-stream
    (``{"type":"progress"}`` NDJSON lines): the salvage ledger's feed.
    Tokens reported here are NOT final — the terminal
    :class:`GenerateResult` for the rid repeats them authoritatively."""
    rid: str
    token_ids: list[int]
    logprobs: list[float]
    weight_version: int = -1


# transport-level failures worth retrying (connection refused/reset,
# timeouts, truncated chunked bodies). urllib.error.HTTPError subclasses
# URLError and must be handled FIRST (it is a status, not a transport fault).
_TRANSPORT_ERRORS = (urllib.error.URLError, http.client.HTTPException,
                     ConnectionError, TimeoutError, socket.timeout, OSError)


class ManagerClient:
    def __init__(self, endpoint: str = "", timeout_s: float = 600.0,
                 supervisor=None, retry_deadline_s: float = 30.0,
                 max_retries: int = 8, backoff_base_s: float = 0.2,
                 backoff_max_s: float = 2.0):
        if not endpoint and supervisor is None:
            raise ValueError("ManagerClient needs an endpoint or a supervisor")
        self._endpoint = (endpoint if not endpoint or endpoint.startswith("http")
                          else f"http://{endpoint}")
        self.supervisor = supervisor
        self.timeout_s = timeout_s
        self.retry_deadline_s = retry_deadline_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.retry_count = 0  # cumulative, surfaced as fault/client_retries

    @property
    def endpoint(self) -> str:
        """Current manager base URL; re-resolves through the supervisor (a
        respawned manager binds a fresh ephemeral port)."""
        if self.supervisor is not None:
            ep = self.supervisor.endpoint
            if ep:
                return ep if ep.startswith("http") else f"http://{ep}"
        return self._endpoint

    # -- plain JSON calls --------------------------------------------------

    def _call_once(self, method: str, path: str, payload: dict | None = None,
                   timeout: float | None = None) -> dict:
        data = json.dumps(payload or {}).encode()
        headers = {"Content-Type": "application/json"}
        # cross-process trace propagation: the manager echoes the pair in
        # its request log/response and forwards it to the engines it routes
        # to, so one request is followable trainer→manager→engine
        headers.update(obs.trace_headers())
        req = urllib.request.Request(
            self.endpoint + path, data=data, method=method, headers=headers)
        t0 = time.monotonic()
        with urllib.request.urlopen(req, timeout=timeout or self.timeout_s) as r:
            out = json.loads(r.read() or b"{}")
        obs.observe("manager/rtt_s", time.monotonic() - t0, t0=t0)
        return out

    def _call(self, method: str, path: str, payload: dict | None = None,
              timeout: float | None = None, idempotent: bool = False) -> dict:
        with obs.span("manager" + path):
            return self._call_retrying(method, path, payload, timeout,
                                       idempotent)

    def _call_retrying(self, method: str, path: str,
                       payload: dict | None = None,
                       timeout: float | None = None,
                       idempotent: bool = False) -> dict:
        attempt = 0
        deadline = time.monotonic() + self.retry_deadline_s
        while True:
            try:
                return self._call_once(method, path, payload, timeout)
            except urllib.error.HTTPError as exc:
                # status errors (4xx: bad request / ACL 403) are the
                # caller's problem; only a 5xx on an idempotent call retries
                if not idempotent or exc.code < 500:
                    raise
                err: Exception = exc
            except _TRANSPORT_ERRORS as exc:
                if not idempotent:
                    raise ManagerTransportError(
                        f"{method} {path} failed: {exc}") from exc
                err = exc
            attempt += 1
            self.retry_count += 1
            left = deadline - time.monotonic()
            if attempt > self.max_retries or left <= 0:
                raise ManagerTransportError(
                    f"{method} {path} failed after {attempt} attempts: "
                    f"{err}") from err
            # capped exponential backoff with jitter in [0.5x, 1.5x]
            sleep = min(self.backoff_base_s * 2 ** (attempt - 1),
                        self.backoff_max_s) * (0.5 + random.random())
            time.sleep(min(sleep, max(left, 0.0)))

    def health(self) -> bool:
        # single probe, no internal retry: wait_healthy/supervisor loops own
        # the retry cadence and want a fast, honest answer
        try:
            return self._call_once("GET", "/health",
                                   timeout=3.0).get("status") == "ok"
        except Exception:
            return False

    def wait_healthy(self, deadline_s: float = 30.0) -> None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            if self.health():
                return
            time.sleep(0.1)
        raise TimeoutError("manager not healthy")

    def get_instances_status(self) -> dict:
        return self._call("GET", "/get_instances_status", idempotent=True)

    def register_rollout_instance(self, instance_endpoint: str) -> dict:
        out = self._call("POST", "/register_rollout_instance",
                         {"endpoint": instance_endpoint}, idempotent=True)
        if self.supervisor is not None:
            self.supervisor.record_remote_instances([instance_endpoint])
        return out

    def register_local_rollout_instances(self, endpoints: list[str]) -> dict:
        out = self._call("POST", "/register_local_rollout_instances",
                         {"endpoints": endpoints}, idempotent=True)
        if self.supervisor is not None:
            self.supervisor.record_local_instances(endpoints)
        return out

    def deregister_rollout_instance(self, endpoint: str,
                                    drained: bool = False) -> dict:
        """Graceful leave (scale-down drill): remove one engine from the
        pool. ``drained=True`` books it as a drain departure (the engine
        flushed its partials first) rather than an eviction. Idempotent —
        deregistering an already-forgotten endpoint is a no-op."""
        out = self._call("POST", "/deregister_rollout_instance",
                         {"endpoint": endpoint, "drained": drained},
                         idempotent=True)
        if self.supervisor is not None:
            self.supervisor.forget_instance(endpoint)
        return out

    def generate(self, rid: str, input_ids: list[int], sampling_params: dict) -> GenerateResult:
        out = self._call("POST", "/generate", {
            "rid": rid, "input_ids": input_ids, "sampling_params": sampling_params})
        return self._to_result(out)

    def update_weight_version(self) -> int:
        v = int(self._call("POST", "/update_weight_version")["weight_version"])
        if self.supervisor is not None:
            self.supervisor.record_weight_version(v)
        return v

    def get_receive_instances(self, sender: str = "") -> dict:
        # NOT idempotent: the manager CAS-marks returned instances as
        # updating — a retry after a lost response would strand the first
        # claim until abort_weight_update
        return self._call("POST", "/get_receive_instances", {"sender": sender})

    def update_weights(self, instances: list[str], weight_version: int | None = None) -> dict:
        payload: dict[str, Any] = {"instances": instances}
        if weight_version is not None:
            payload["weight_version"] = weight_version
        return self._call("POST", "/update_weights", payload)

    def abort_weight_update(self, instances: list[str]) -> dict:
        return self._call("POST", "/abort_weight_update", {"instances": instances})

    def update_weight_senders(self, senders: list[str], groups_per_sender: int = 1) -> dict:
        out = self._call("PUT", "/update_weight_senders",
                         {"senders": senders,
                          "groups_per_sender": groups_per_sender},
                         idempotent=True)
        if self.supervisor is not None:
            self.supervisor.record_weight_senders(senders, groups_per_sender)
        return out

    def update_metrics(self, **stats) -> dict:
        return self._call("POST", "/update_metrics", stats, idempotent=True)

    def metrics_text(self, timeout: float = 5.0) -> str:
        """Raw Prometheus text from GET /metrics (the trainer scrapes this
        once per step and merges it into the step record as manager/*).
        No internal retry: a scrape miss degrades gracefully at the caller
        (RemoteRollout skips the merge and counts obs/scrape_failed) —
        retrying telemetry inside a step would trade step latency for a
        metric merge nobody is blocked on."""
        with obs.span("manager/metrics"):
            req = urllib.request.Request(self.endpoint + "/metrics",
                                         method="GET")
            t0 = time.monotonic()
            with urllib.request.urlopen(req, timeout=timeout) as r:
                text = r.read().decode()
            obs.observe("manager/scrape_s", time.monotonic() - t0)
            return text

    def shutdown_instances(self, skip_if_updating_weights: bool = False) -> dict:
        return self._call("POST", "/shutdown_instances",
                          {"skip_if_updating_weights": skip_if_updating_weights})

    def abort_local_requests(self) -> dict:
        return self._call("POST", "/abort_local_requests")

    def resume_local_instances(self) -> dict:
        return self._call("POST", "/resume_local_instances", idempotent=True)

    def reconcile(self, remote_endpoints: list[str], local_endpoints: list[str],
                  senders: list[str], groups_per_sender: int,
                  weight_version: int,
                  instance_versions: dict[str, int] | None = None) -> dict:
        """Idempotent bulk re-registration (supervisor replay after a
        manager respawn): already-known endpoints are kept as-is and the
        weight version is only ever raised, never reset.
        ``instance_versions`` replays pool membership's per-engine
        last-known weight versions so a respawned manager re-admits a
        healthy, caught-up fleet instead of orphaning it behind a
        redundant weight bootstrap."""
        return self._call("POST", "/reconcile", {
            "remote_endpoints": remote_endpoints,
            "local_endpoints": local_endpoints,
            "senders": senders,
            "groups_per_sender": groups_per_sender,
            "weight_version": weight_version,
            "instance_versions": dict(instance_versions or {}),
        }, idempotent=True)

    # -- streaming batch (the C7 StreamingBatchIterator role) -------------

    def batch_generate_stream(self, requests: list[dict],
                              max_local_gen_s: float | None = None
                              ) -> Iterator[GenerateResult]:
        """POST /batch_generate_requests; yields results as NDJSON lines
        arrive. The first 'notifier' line is consumed internally (it signals
        batch acceptance — reference stream_batch_iter.py:41-43). Transport
        failures (manager died mid-stream, truncated chunk) raise a typed
        :class:`ManagerTransportError` so RemoteRollout's stream-resume
        layer can re-issue only the unfinished rids."""
        payload: dict[str, Any] = {"requests": requests}
        if max_local_gen_s is not None:
            payload["max_local_gen_s"] = max_local_gen_s
        headers = {"Content-Type": "application/json"}
        headers.update(obs.trace_headers())
        req = urllib.request.Request(
            self.endpoint + "/batch_generate_requests",
            data=json.dumps(payload).encode(), method="POST",
            headers=headers)
        try:
            with obs.span("manager/batch_generate_requests",
                          n=len(requests)), \
                    urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                for raw in r:
                    line = raw.decode().strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError as exc:
                        # a line cut mid-byte by a dying manager is a
                        # transport fault, not a protocol error
                        raise ManagerTransportError(
                            f"truncated stream line: {exc}") from exc
                    if obj.get("type") == "notifier":
                        continue
                    if obj.get("type") == "progress":
                        # token-level progress: feed for the caller's
                        # salvage ledger (rollout/remote.py). Not terminal.
                        yield GenerateProgress(
                            rid=obj.get("rid", ""),
                            token_ids=[int(t) for t in
                                       obj.get("token_ids", [])],
                            logprobs=[float(x) for x in
                                      obj.get("logprobs", [])],
                            weight_version=int(obj.get("weight_version",
                                                       -1)))
                        continue
                    yield self._to_result(obj)
        except urllib.error.HTTPError:
            raise
        except _TRANSPORT_ERRORS as exc:
            raise ManagerTransportError(
                f"batch stream failed: {exc}") from exc

    @staticmethod
    def _to_result(out: dict) -> GenerateResult:
        return GenerateResult(
            rid=out.get("rid", ""),
            success=bool(out.get("success", False)),
            output_token_ids=[int(t) for t in out.get("output_token_ids", [])],
            output_token_logprobs=[float(x) for x in out.get("output_token_logprobs", [])],
            finish_reason=out.get("finish_reason", ""),
            error=out.get("error", ""),
            output_token_weight_versions=[
                int(v) for v in out.get("output_token_weight_versions", [])],
        )
