"""/statusz — the live health plane (a copy of ``polyrl_tpu/obs/statusz.py``:
the same schema and sections).

One ``curl :port/statusz`` answers "what is this plane doing right now":
both the trainer and the rollout server serve the SAME JSON schema
(:func:`build_snapshot`), so a pool-wide sweep needs one parser. The
trainer mounts a standalone :class:`StatuszServer` (it has no HTTP surface
of its own); the rollout server mounts ``/statusz`` as a route on its
existing listener (rollout/server.py).

Schema (``polyrl/statusz/v8`` — additive evolution only; v2 added the
``engine`` section, v3 the ``training`` section, v4 the ``timeseries``
section, v5 the ``autoscale`` section, v6 the ``memory`` section, v7 the
``spill`` block inside ``memory`` (host-RAM KV spill tier), v8 the
``loop`` block inside ``engine`` (engine-loop profiler)):

- ``role``      — ``trainer`` | ``rollout``
- ``pid`` / ``time_unix_s`` / ``uptime_s``
- ``step``      — current training step (trainer; null on rollout)
- ``goodput``   — cumulative phase attribution (GoodputLedger.snapshot)
- ``histograms``— latest-window quantiles ``{name: {p50,p95,p99,max,
  mean,count}}``
- ``counters``  — cumulative fault/salvage/anomaly counters
- ``gauges``    — scalar last-values (weight staleness, queue depth, ...)
- ``queues``    — engine/pipeline queue depths
- ``weights``   — weight version / push count / staleness
- ``pool``      — elastic-pool membership (engines + lifecycle counts;
  trainer role with a PoolManager attached, empty elsewhere)
- ``engine``    — the engine flight deck (rollout/flightdeck.py): request
  lifecycle tails (TTFT/TPOT/queue wait), slot occupancy, page-pool
  utilization, token-accounting reconciliation. Rollout role serves its
  own ledger; trainer role serves the fleet aggregate from PoolManager
  sweeps; empty elsewhere. Since v8 it ALWAYS carries a ``loop`` block
  (obs/engine_profile.py): exhaustive per-iteration phase attribution of
  the engine loop's wall (``attributed_frac`` pinned to 1.0,
  goodput-ledger style), per-phase log2 latency summaries, and the
  windowed device-vs-host split (``device_frac`` /
  ``host_overhead_frac`` / ``accounting_frac`` / ``idle_frac``).
  ``{"enabled": false}`` when ``rollout.loop_profile`` is off or the
  engine has no loop profiler; the trainer's is the fleet view keyed by
  instance.
- ``training``  — the training health plane (obs/rlhealth.py): last
  finalized ``training/*`` gauges (entropy/KL mirrors, degenerate-group
  fraction, per-token weight-version staleness) plus a short per-step
  trend tail. Trainer role with a TrainingHealthLedger attached (the
  default); empty on the rollout plane.
- ``timeseries`` — the fleet time-series rail (obs/timeseries.py):
  windowed per-key aggregates (last/mean/p95/min/max + least-squares
  slope) over the recent step snapshots — goodput phase walls, pool and
  fleet ``engine/*`` gauges, ``training/*`` and ``critpath/*`` scalars.
  The trainer windows its step records; the rollout server windows its
  ``server_info`` samples (one per manager stats poll / statusz hit).
- ``autoscale`` — the closed-loop autoscaling plane (rollout/autoscale.py):
  last decision (action, reason, inputs, suppressions), the degradation
  tier, the fleet envelope, and cumulative action totals. Trainer role
  with an AutoscaleController attached; empty elsewhere (including the
  rollout plane — the controller lives trainer-side).
- ``memory``    — the KV memory plane (rollout/kvledger.py): per-page
  role counts (free / active-decode / published / preref-held),
  hot/warm/cold residency tiers, churn + free-cause counters,
  page-lifetime histograms, the ledger↔pool ``attributed_frac``
  reconciliation block, and HBM truth (used/headroom/unaccounted).
  Since v7 it also carries a ``spill`` block when the host-RAM KV spill
  tier is on (rollout/kvspill.py): spilled page/byte totals, cumulative
  spill/restore traffic, the windowed restore rate (thrash signal), and
  the host pool's lane/capacity stats. Rollout role serves its engine's
  ledger; trainer role serves the fleet worst-case aggregate from
  PoolManager sweeps; empty elsewhere (and with
  ``rollout.kv_ledger=false``).

Every v8 section is ALWAYS present on both planes (conformance-tested) so
consumers never need existence checks.

``GET /metrics`` on the same listener renders the snapshot's numeric
leaves as Prometheus text (``polyrl_statusz_*`` gauges) for real scrapers.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

log = logging.getLogger(__name__)

SCHEMA = "polyrl/statusz/v8"
_PROC_T0 = time.monotonic()
_HIST_SUFFIXES = ("p50", "p95", "p99", "max", "mean", "count")

# every key the schema guarantees on EVERY snapshot, both planes — the
# conformance contract consumers (and the conformance test) rely on
REQUIRED_SECTIONS = ("schema", "role", "pid", "time_unix_s", "uptime_s",
                     "step", "goodput", "histograms", "counters", "gauges",
                     "queues", "weights", "pool", "engine", "training",
                     "timeseries", "autoscale", "memory")


def build_snapshot(role: str, *, step: int | None = None,
                   goodput: dict | None = None,
                   histograms: dict | None = None,
                   counters: dict | None = None,
                   gauges: dict | None = None,
                   queues: dict | None = None,
                   weights: dict | None = None,
                   pool: dict | None = None,
                   engine: dict | None = None,
                   training: dict | None = None,
                   timeseries: dict | None = None,
                   autoscale: dict | None = None,
                   memory: dict | None = None) -> dict:
    """The shared statusz schema; every section present (empty when the
    plane has nothing for it) so consumers never need existence checks."""
    return {
        "schema": SCHEMA,
        "role": role,
        "pid": os.getpid(),
        "time_unix_s": round(time.time(), 3),
        "uptime_s": round(time.monotonic() - _PROC_T0, 3),
        "step": step,
        "goodput": goodput or {},
        "histograms": histograms or {},
        "counters": counters or {},
        "gauges": gauges or {},
        "queues": queues or {},
        "weights": weights or {},
        "pool": pool or {},
        "engine": engine or {},
        "training": training or {},
        "timeseries": timeseries or {},
        "autoscale": autoscale or {},
        "memory": memory or {},
    }


def nest_histograms(record: dict) -> dict:
    """Flat step-record histogram keys (``name/p50`` ... ``name/count``) →
    the statusz nested form ``{name: {p50: v, ...}}``."""
    out: dict[str, dict[str, float]] = {}
    for key, value in record.items():
        base, _, suffix = key.rpartition("/")
        if base and suffix in _HIST_SUFFIXES:
            out.setdefault(base, {})[suffix] = value
    # a genuine histogram emits the full summary; a lone */max gauge (say)
    # is not one — require the count marker the summary always carries
    return {k: v for k, v in out.items() if "count" in v}


def prometheus_text(snapshot: dict, prefix: str = "polyrl_statusz") -> str:
    """Numeric leaves of the snapshot as Prometheus gauges (full precision;
    path segments joined by ``_`` with non-metric chars squashed)."""
    lines: list[str] = []

    def emit(path: str, value) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        name = re.sub(r"[^a-zA-Z0-9_]", "_", f"{prefix}_{path}")
        lines.append(f"# TYPE {name} gauge")
        val = (str(int(value)) if float(value).is_integer()
               else repr(float(value)))
        lines.append(f"{name} {val}")

    def walk(path: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}_{k}" if path else str(k), v)
        else:
            emit(path, node)

    walk("", snapshot)
    return "\n".join(lines) + "\n"


class StatuszServer:
    """Tiny stdlib HTTP exporter: ``provider()`` is called per request and
    must return a :func:`build_snapshot` dict. A provider failure answers
    500 with the error — the exporter must never take the plane down."""

    def __init__(self, provider: Callable[[], dict],
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?", 1)[0] in ("/statusz", "/"):
                    code, snap = outer._snapshot()
                    self._send(code, json.dumps(snap).encode(),
                               "application/json")
                elif self.path == "/metrics":
                    code, snap = outer._snapshot()
                    self._send(code, prometheus_text(snap).encode(),
                               "text/plain; version=0.0.4")
                elif self.path == "/health":
                    self._send(200, b'{"status": "ok"}', "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": f"no route {self.path}"}).encode(),
                        "application/json")

        self._provider = provider
        self._http = ThreadingHTTPServer((host, port), Handler)
        self.port = self._http.server_address[1]
        self.endpoint = f"{host}:{self.port}"
        self._thread: threading.Thread | None = None

    def _snapshot(self) -> tuple[int, dict]:
        try:
            return 200, self._provider()
        except Exception as exc:  # noqa: BLE001 — exporter never kills a run
            log.exception("statusz provider failed")
            return 500, {"schema": SCHEMA, "error": repr(exc)}

    def start(self) -> "StatuszServer":
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="statusz", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
