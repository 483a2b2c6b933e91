"""Remote sandbox-service code execution for pod-scale code RL (a copy
of ``polyrl_tpu/rewards/sandbox.py``).

The equivalent of the sandbox-fusion reward path
(``rlboost/verl_stream/trainer/ppo/reward.py:95-150``: a shared service URL
plus a concurrency semaphore handed into ``default_compute_score``). One
training host scoring a stream batch can need hundreds of code executions
per reward call; a single VM's local subprocess sandbox
(``scorers._run_sandboxed``) serializes on its own cores, while a sandbox
service horizontally scales the untrusted execution AND keeps it off the
training hosts.

Design differences from the sandbox-fusion path:

- threads + ``threading.Semaphore`` instead of a multiprocessing.Manager
  semaphore — the reward managers here score with thread pools
  (``manager.py``), not Ray actor processes, so process-shared state is
  unnecessary.
- graceful degradation is built in: any service failure (connect error,
  HTTP 5xx, malformed body) falls back to the local rlimit'd sandbox for
  that one run (bounded by ``fallback_local``), so reward computation
  survives a sandbox outage instead of zeroing a training batch.

Protocol: POST ``{url}/run_code`` with
``{"code", "language": "python", "stdin", "run_timeout", "memory_limit_MB"}``
returning ``{"status": "Success", "run_result": {"return_code": 0,
"stdout": ..., "stderr": ...}}`` — the sandbox-fusion wire shape the
reference's scorer speaks.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request

from polyrl_tpu_torch.rewards.scorers import _run_sandboxed, default_compute_score

log = logging.getLogger(__name__)


class SandboxClient:
    """Bounded-concurrency client for a remote code-execution service.

    ``run()`` matches the ``run_fn(code, stdin, timeout_s) -> (ok, stdout)``
    seam in ``scorers.compute_score_code``, so a client instance plugs
    straight into the scoring dispatch.
    """

    def __init__(
        self,
        url: str,
        max_concurrent: int = 64,
        timeout_s: float = 30.0,
        memory_limit_mb: int = 1024,
        fallback_local: bool = True,
    ):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self.memory_limit_mb = memory_limit_mb
        self.fallback_local = fallback_local
        # the semaphore bounds in-flight requests ACROSS reward-manager
        # worker threads (reference: max_concurrent=64, reward.py:137)
        self._sem = threading.Semaphore(max_concurrent)
        self._lock = threading.Lock()
        self.remote_runs = 0
        self.remote_failures = 0
        self.local_fallbacks = 0

    # -- execution ----------------------------------------------------------

    def run(self, code: str, stdin: str = "",
            timeout_s: float | None = None) -> tuple[bool, str]:
        """Execute ``code`` remotely; (ok, stdout). Service failure (NOT a
        failing program — that's a real score of 0) falls back locally."""
        t = timeout_s if timeout_s is not None else self.timeout_s
        payload = json.dumps({
            "code": code,
            "language": "python",
            "stdin": stdin,
            "run_timeout": t,
            "memory_limit_MB": self.memory_limit_mb,
        }).encode()
        req = urllib.request.Request(
            self.url + "/run_code", data=payload, method="POST",
            headers={"Content-Type": "application/json"})
        with self._sem:
            try:
                # service-side run_timeout plus headroom for queueing
                with urllib.request.urlopen(req, timeout=t + 10.0) as r:
                    body = json.loads(r.read())
                with self._lock:
                    self.remote_runs += 1
            except (urllib.error.URLError, OSError, ValueError,
                    TimeoutError) as exc:
                with self._lock:
                    self.remote_failures += 1
                    self.local_fallbacks += self.fallback_local
                log.warning("sandbox service error (%s): %s", self.url, exc)
                if self.fallback_local:
                    return _run_sandboxed(code, stdin, t)
                return False, f"sandbox service error: {exc}"
        run = body.get("run_result") or {}
        status = body.get("status", "")
        if status and status != "Success":
            # SandboxError / compile failure: treat like a non-zero exit
            return False, str(body.get("message", status))[:500]
        ok = run.get("return_code", 1) == 0 and run.get("status", "Finished") \
            in ("Finished", "Success")
        return ok, str(run.get("stdout", ""))

    # -- scoring ------------------------------------------------------------

    def compute_score(self, data_source: str, solution_str: str,
                      ground_truth: str, extra_info: dict | None = None
                      ) -> float:
        """Drop-in ``compute_score`` with code execution routed here
        (what the reference builds with functools.partial,
        reward.py:138-143)."""
        return default_compute_score(data_source, solution_str, ground_truth,
                                     extra_info, run_fn=self.run)

    def stats(self) -> dict:
        with self._lock:
            return {"remote_runs": self.remote_runs,
                    "remote_failures": self.remote_failures,
                    "local_fallbacks": self.local_fallbacks}
